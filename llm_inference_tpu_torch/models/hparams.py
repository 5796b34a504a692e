"""Model hyperparameters from GGUF metadata.

Mirrors the reference's ``load_hparams`` key-by-key including its
optional-key fallbacks and deliberate quirks (reference model.cpp:58-167):
rope_freq_scale is forced to 1.0, and gemma4 uses attention scale 1.0.
Frozen (hashable), as in llm_inference_tpu, whose copy this is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class HParams:
    architecture: str
    block_count: int
    embedding_length: int
    feed_forward_length: int
    n_head: int
    n_head_kv: int
    rms_eps: float
    rope_freq_base: float
    rope_freq_scale: float
    n_embd_head_k: int
    n_embd_head_k_swa: int
    n_embd_head_v: int
    n_embd_head_v_swa: int
    f_attention_scale: float
    f_max_alibi_bias: float
    attn_soft_cap: float
    swa_layers: tuple[bool, ...]
    sliding_window: int  # window SIZE in tokens; 0 = none recorded
    final_logit_softcap: float
    embedding_length_per_layer: int
    n_layer_kv_from_start: int  # -1 => every layer has its own KV
    vocab_size: int

    def is_swa_layer(self, i: int) -> bool:
        """Per-layer SWA flag: explicit pattern array, else the Gemma-3
        default 5-local:1-global pattern (reference model.cpp:723-728)."""
        if i < len(self.swa_layers):
            return self.swa_layers[i]
        return i % 6 < 5

    def rope_base_for_layer(self, i: int) -> float:
        """SWA layers use base 10000 (reference model.cpp:731-732)."""
        return 10000.0 if self.is_swa_layer(i) else self.rope_freq_base

    def swa_window(self, i: int) -> int:
        """Sliding-window size for layer i under REAL windowing
        (LLMI_SWA_MASK=1): the recorded window on SWA layers, 0 (no
        window) on global layers or when the checkpoint records none.
        The parity default ignores this — the reference parses the SWA
        pattern but never applies a window mask (model.cpp:727-748)."""
        return self.sliding_window if self.is_swa_layer(i) else 0

    def layer_has_kv(self, i: int) -> bool:
        """Shared-KV: trailing layers compute no K/V (reference model.cpp:774-777)."""
        if self.n_layer_kv_from_start < 0:
            return True
        return i < self.n_layer_kv_from_start

    def kv_source_layer(self, i: int) -> int:
        """Cache index a shared-KV layer reads (reference model.cpp:832-835)."""
        if self.layer_has_kv(i):
            return i
        return self.n_layer_kv_from_start - (2 if self.is_swa_layer(i) else 1)

    @property
    def n_kv_layers(self) -> int:
        return self.block_count if self.n_layer_kv_from_start < 0 else self.n_layer_kv_from_start


def load_hparams(metadata: Mapping[str, Any]) -> HParams:
    arch = metadata["general.architecture"]

    def opt(key: str, default: Any) -> Any:
        return metadata.get(f"{arch}.{key}", default)

    def req(key: str) -> Any:
        full = f"{arch}.{key}"
        if full not in metadata:
            raise KeyError(f"missing required GGUF metadata key {full}")
        return metadata[full]

    embedding_length = int(req("embedding_length"))
    n_head = int(req("attention.head_count"))
    n_embd_head_k = int(opt("attention.key_length", embedding_length // n_head))
    n_embd_head_v = int(opt("attention.value_length", n_embd_head_k))

    f_attention_scale = 1.0 / math.sqrt(float(n_embd_head_k))
    if arch == "gemma4":
        f_attention_scale = 1.0  # reference model.cpp:120-123

    swa_raw = opt("attention.sliding_window_pattern", None)
    swa_layers = tuple(bool(v) for v in swa_raw) if isinstance(swa_raw, (list, tuple)) else ()

    block_count = int(req("block_count"))
    shared_kv = opt("attention.shared_kv_layers", None)
    n_layer_kv_from_start = block_count - int(shared_kv) if shared_kv is not None else -1

    eplv = opt("embedding_length_per_layer", None)
    if eplv is None:
        eplv = opt("embedding_length_per_layer_input", 0)

    vocab = metadata.get("tokenizer.ggml.tokens", [])

    return HParams(
        architecture=arch,
        block_count=block_count,
        embedding_length=embedding_length,
        feed_forward_length=int(req("feed_forward_length")),
        n_head=n_head,
        n_head_kv=int(req("attention.head_count_kv")),
        rms_eps=float(req("attention.layer_norm_rms_epsilon")),
        rope_freq_base=float(req("rope.freq_base")),
        # Forced to 1.0 — a deliberate reference hack (model.cpp:87-92).
        rope_freq_scale=1.0,
        n_embd_head_k=n_embd_head_k,
        n_embd_head_k_swa=int(opt("attention.key_length_swa", n_embd_head_k)),
        n_embd_head_v=n_embd_head_v,
        n_embd_head_v_swa=int(opt("attention.value_length_swa", n_embd_head_v)),
        f_attention_scale=f_attention_scale,
        f_max_alibi_bias=float(opt("attention.max_alibi_bias", 0.0)),
        attn_soft_cap=float(opt("attention.logit_softcapping", 0.0)),
        swa_layers=swa_layers,
        sliding_window=int(opt("attention.sliding_window", 0)),
        final_logit_softcap=float(opt("attention.final_logit_softcapping", 0.0)),
        embedding_length_per_layer=int(eplv),
        n_layer_kv_from_start=n_layer_kv_from_start,
        vocab_size=len(vocab),
    )
