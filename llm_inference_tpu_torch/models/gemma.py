"""Gemma-3 and gemma4 serve-mode forward: prefill over T tokens, decode one token per call.

Counterpart of the serve part of llm_inference_tpu/models/gemma.py
(reference model.cpp:706-1049): the stacked bf16 KV cache, the masked cache
write, the fused masked-softmax attention, ``forward`` over per-layer or stacked
weights (the JAX package's unrolled forward and ``_forward_scan``: in eager
PyTorch one layer loop, over per-layer views of stacked weights) and the
dispatch of single-token decode to the whole-step kernel
(gemma.py:432-480), and the batched server's per-op decode steps over
dense lanes (``forward_batched_decode``) and over a shared page pool
(``forward_batched_decode_paged``). PyTorch runs eagerly, so
``pos``/``n_valid`` of a prefill are host ints; caches are updated in place
(the JAX version returns new ones) and returned for the same call shape.

On CUDA a T = 1 step over stacked weights runs a whole-step CUDA kernel,
in the JAX package's order (gemma.py:445-479): the per-row int8 one
(ops/kernels/fused_decode.py), for group-scaled weights the lossless one
(ops/kernels/fused_decode_q.py) behind its gate (``decode_q_enabled``), then
the capacity one (ops/kernels/fused_decode_stream.py, ``decode_stream_enabled``),
which alone takes a flat cache (``init_cache(flat=True)``); on the CPU the
same dispatch runs the kernels' plain twins, so the CPU tests cover the
card's path.

gemma4 (reference model.cpp:568-704, 774-835, 927-977) runs through the
same functions: the per-layer inputs (``_per_layer_inputs``) and their
epilogue after each layer's FFN, the unweighted V norm, the per-layer
``out_scale``, and shared-KV layers, which read ``hp.kv_source_layer(i)``'s
cache and write none. Over ``stack_layers_gemma4``'s stack a shared layer's
projection is the Q rows of its zero-padded QKV (``shared_q_view``), so the
prefill needs no second, unstacked weight copy (the JAX engine keeps one,
engine.py:217-237). Per-layer head dims, taps and the parity attention are
later slices.
"""

from __future__ import annotations

import dataclasses
import math
import os
from functools import partial

import numpy as np
import torch

from ..ops.kernels import flash_decode, fused_decode, fused_decode_q, fused_decode_stream, kv_insert
from ..ops.linear import embed_rows
from ..ops.linear import matmul as _matmul
from ..ops.numerics import gelu_tanh, rms_norm, rope, softcap
from .hparams import HParams
from .weights import LayerWeights, ModelWeights, layer_view, shared_q_view

KV_DTYPE = torch.bfloat16  # serve caches (engine.py of the JAX package)


@dataclasses.dataclass
class KVCache:
    """Stacked caches: k [n_kv_layers, S, Hkv, dk], v [n_kv_layers, S, Hkv, dv],
    or flat (``init_cache(flat=True)``): [n_kv_layers, S, Hkv * d]."""

    k: torch.Tensor
    v: torch.Tensor


def init_cache(hp: HParams, max_seq: int, *, device="cpu", dtype=KV_DTYPE,
               flat: bool = False) -> KVCache:
    """Zeroed stacked caches for every layer that owns KV storage (uniform
    head dims, as the stacked layout needs). ``flat=True`` gives the
    capacity step's layout [L, S, Hkv * d] (llm_inference_tpu/models/
    gemma.py:62-85): the same bytes as [L, S, Hkv, d], which every kernel
    addresses alike; the prefill views it 4-D per layer."""
    if hp.n_embd_head_k != hp.n_embd_head_k_swa or hp.n_embd_head_v != hp.n_embd_head_v_swa:
        raise NotImplementedError("per-layer head dims need the per-layer cache of a later "
                                  "slice (ROADMAP.md queue 1, item 7)")
    L, Hkv = hp.n_kv_layers, hp.n_head_kv
    heads = lambda d: (Hkv * d,) if flat else (Hkv, d)  # noqa: E731
    k = torch.zeros((L, max_seq, *heads(hp.n_embd_head_k)), dtype=dtype, device=device)
    v = torch.zeros((L, max_seq, *heads(hp.n_embd_head_v)), dtype=dtype, device=device)
    return KVCache(k=k, v=v)


def _alibi_slopes(n_head: int, max_bias: float) -> torch.Tensor:
    """Per-head ALiBi slopes (reference model.cpp:492-499)."""
    n_head_log2 = 1 << int(math.floor(math.log2(n_head)))
    m0 = 2.0 ** (-max_bias / n_head_log2)
    m1 = 2.0 ** (-(max_bias / 2.0) / n_head_log2)
    return torch.tensor(
        [m0 ** (h + 1) if h < n_head_log2 else m1 ** (2 * (h - n_head_log2) + 1)
         for h in range(n_head)], dtype=torch.float32)


def _norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm + weight multiply (reference run_norm, model.cpp:361-386)."""
    return rms_norm(x, eps) * weight.float()


def _write_cache(cache: torch.Tensor, new: torch.Tensor, pos: int, n_valid: int) -> None:
    """Masked append in place: new[t] goes to slot pos+t for t < n_valid;
    padded rows, and rows past the cache end, are dropped."""
    n = max(0, min(n_valid, new.shape[0], cache.shape[0] - pos))
    cache[pos : pos + n] = new[:n].to(cache.dtype)


def swa_mask_enabled() -> bool:
    """LLMI_SWA_MASK=1 turns on real sliding-window attention on SWA layers;
    the default reproduces the reference, which parses the SWA pattern but
    never applies a window mask (reference model.cpp:727-748)."""
    return os.environ.get("LLMI_SWA_MASK", "0") == "1"


def decode_q_enabled(hp: HParams, w: ModelWeights) -> bool:
    """The lossless whole-step gate (llm_inference_tpu/models/gemma.py
    ``_megakernel_q_enabled``, :595-611): off under LLMI_NO_FUSED_DECODE=1
    and under LLMI_FORCE_CAPACITY=1 (the capacity step takes the token);
    otherwise ``decode_q_supported``."""
    if os.environ.get("LLMI_NO_FUSED_DECODE", "0") == "1":
        return False
    if os.environ.get("LLMI_FORCE_CAPACITY", "0") == "1":
        return False
    return fused_decode_q.decode_q_supported(hp, w)


def decode_stream_enabled(hp: HParams, w: ModelWeights, *, max_seq: int | None = None) -> bool:
    """The capacity step's gate (llm_inference_tpu/models/gemma.py
    ``_megakernel_stream_enabled``, :614-628): off under
    LLMI_NO_FUSED_DECODE=1, otherwise ``decode_stream_supported``."""
    if os.environ.get("LLMI_NO_FUSED_DECODE", "0") == "1":
        return False
    return fused_decode_stream.decode_stream_supported(hp, w, max_seq=max_seq)


def _masked_scores(q: torch.Tensor, k_cache: torch.Tensor, *, pos: int, hp: HParams,
                   window: int = 0):
    """Serve-mode QK scores + softcap + ALiBi + causal/window mask (reference
    model.cpp:501-518). q [T, H, Dk] f32, k_cache [S', Hkv, Dk]. Returns
    (scores [T, Hkv, group, S'] f32 with -inf at masked slots, valid [T, S'])."""
    T, H, Dk = q.shape
    S, Hkv, _ = k_cache.shape
    group = H // Hkv
    qg = q.float().reshape(T, Hkv, group, Dk)
    scores = torch.einsum("tkgd,skd->tkgs", qg, k_cache.float())
    scores = softcap(scores, hp.attn_soft_cap)

    dev = q.device
    q_pos = pos + torch.arange(T, dtype=torch.int64, device=dev)
    key_pos = torch.arange(S, dtype=torch.int64, device=dev)
    if hp.f_max_alibi_bias > 0.0:
        slopes = _alibi_slopes(H, hp.f_max_alibi_bias).to(dev).reshape(Hkv, group)
        bias = (key_pos[None, :] - q_pos[:, None]).float()
        scores = scores + slopes[None, :, :, None] * bias[:, None, None, :]
    valid = key_pos[None, :] <= q_pos[:, None]
    if window > 0:
        valid = valid & (key_pos[None, :] > q_pos[:, None] - window)
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    return scores, valid


def _attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, *, pos: int,
               hp: HParams, window: int = 0) -> torch.Tensor:
    """Fused masked-softmax attention (reference run_attn, model.cpp:478-548),
    f32. q [T, H, Dk] already scaled; caches [S, Hkv, D]. Returns [T, H*Dv].
    Reads only slots [0, pos + T): later slots are masked and would add
    exact zeros."""
    T, H, _ = q.shape
    live = min(pos + T, k_cache.shape[0])
    k_cache, v_cache = k_cache[:live], v_cache[:live]
    scores, _ = _masked_scores(q, k_cache, pos=pos, hp=hp, window=window)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("tkgs,skd->tkgd", probs, v_cache.float())
    return out.reshape(T, H * v_cache.shape[-1])


def _per_layer_inputs(hp: HParams, w: ModelWeights, tokens: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor | None:
    """gemma4's per-layer inputs (llm_inference_tpu/models/gemma.py:379-394,
    reference model.cpp:568-704): the tokens' per-layer embedding rows times
    sqrt(P), plus the RMS-normed projection of the scaled embedding ``x``,
    over sqrt(2). [T, L, P] f32, or None for a model without them. The
    projection takes the default dispatch on every route, the batched
    server's included, as the JAX package's does (a W8A8 product only at
    16384 rows or more)."""
    if w.token_embd_per_layer is None:
        return None
    L, P = hp.block_count, hp.embedding_length_per_layer
    inp = embed_rows(w.token_embd_per_layer, tokens).reshape(-1, L, P) * torch.tensor(
        math.sqrt(P), dtype=torch.float32)
    if w.per_layer_model_proj is None:
        return inp
    proj = _matmul(w.per_layer_model_proj, x) * torch.tensor(
        1.0 / math.sqrt(hp.embedding_length), dtype=torch.float32)
    proj = _norm(proj.reshape(-1, L, P), w.per_layer_proj_norm, hp.rms_eps)
    return (proj + inp) * torch.tensor(1.0 / math.sqrt(2.0), dtype=torch.float32)


def _ffn_and_epilogue(hp: HParams, lw: LayerWeights, x, pl_inp, matmul):
    """Residual + FFN block, then gemma4's per-layer-input epilogue
    (gemma.py:557-564) and ``out_scale`` (:566-568) where the layer has them."""
    h2 = _norm(x, lw.ffn_norm, hp.rms_eps)
    if lw.w_gate_up is not None:
        gu = matmul(lw.w_gate_up, h2)
        n_ff = gu.shape[-1] // 2
        gate, up = gu[..., :n_ff], gu[..., n_ff:]
    else:
        gate, up = matmul(lw.w_gate, h2), matmul(lw.w_up, h2)
    ffn = matmul(lw.w_down, gelu_tanh(gate) * up)
    if lw.post_ffw_norm is not None:
        ffn = _norm(ffn, lw.post_ffw_norm, hp.rms_eps)
    x = x + ffn
    if pl_inp is not None:
        g = gelu_tanh(matmul(lw.per_layer_inp_gate, x)) * pl_inp
        x = x + _norm(matmul(lw.per_layer_proj, g), lw.per_layer_post_norm, hp.rms_eps)
    if lw.out_scale is not None:
        x = x * lw.out_scale.float().reshape(())
    return x


def _project_qkv(hp: HParams, lw: LayerWeights, h, has_kv: bool, matmul):
    """q, k, v flat projections of ``h`` (k and v None for a shared-KV layer)."""
    dk = hp.n_embd_head_k
    if lw.wqkv is not None:  # load-time fusion (fuse_projections)
        rq, rk = hp.n_head * dk, hp.n_head_kv * dk
        qkv = matmul(lw.wqkv, h)
        return qkv[..., :rq], qkv[..., rq : rq + rk], qkv[..., rq + rk :]
    if not has_kv:
        return matmul(lw.wq, h), None, None
    return matmul(lw.wq, h), matmul(lw.wk, h), matmul(lw.wv, h)


def _layer(hp: HParams, lw: LayerWeights, x, k_c, v_c, *, pos: int, n_valid: int,
           rope_base: float, window: int, mm_impl: str = "auto", has_kv: bool = True,
           pl_inp=None):
    """One transformer layer over T tokens (serve numerics), writing the
    layer's cache in place (a shared-KV layer, ``has_kv`` False, only reads
    its source layer's ``k_c``/``v_c``). ``pl_inp`` [T, P]: the layer's
    gemma4 per-layer input. Returns the new residual stream."""
    matmul = partial(_matmul, mm_impl=mm_impl)
    T = x.shape[0]
    dk, dv = hp.n_embd_head_k, hp.n_embd_head_v
    pos_vec = pos + torch.arange(T, dtype=torch.int64, device=x.device)
    h = _norm(x, lw.attn_norm, hp.rms_eps)
    q_flat, k_flat, v_flat = _project_qkv(hp, lw, h, has_kv, matmul)
    q = q_flat.reshape(T, hp.n_head, dk)
    if lw.q_norm is not None:
        q = _norm(q, lw.q_norm, hp.rms_eps)
    q = rope(q, n_rot=dk, freq_base=rope_base, freq_scale=hp.rope_freq_scale, pos=pos_vec)
    q = q * torch.tensor(hp.f_attention_scale, dtype=torch.float32)

    if has_kv:
        k = k_flat.reshape(T, hp.n_head_kv, dk)
        if lw.k_norm is not None:
            k = _norm(k, lw.k_norm, hp.rms_eps)
        k = rope(k, n_rot=dk, freq_base=rope_base, freq_scale=hp.rope_freq_scale, pos=pos_vec)
        v = v_flat.reshape(T, hp.n_head_kv, dv)
        if hp.architecture == "gemma4":
            v = rms_norm(v, hp.rms_eps)  # the unweighted V norm (model.cpp:812-827)
        _write_cache(k_c, k, pos, n_valid)
        _write_cache(v_c, v, pos, n_valid)

    attn = matmul(lw.wo, _attention(q, k_c, v_c, pos=pos, hp=hp, window=window))
    if lw.post_attn_norm is not None:
        attn = _norm(attn, lw.post_attn_norm, hp.rms_eps)
    return _ffn_and_epilogue(hp, lw, x + attn, pl_inp, matmul)


def _logits(hp: HParams, w: ModelWeights, x: torch.Tensor, n_valid: int,
            mm_impl: str = "auto") -> torch.Tensor:
    """Final norm + tied-embedding logits of the last valid token."""
    last = _norm(x[n_valid - 1], w.output_norm, hp.rms_eps)
    return softcap(_matmul(w.token_embd, last, mm_impl=mm_impl), hp.final_logit_softcap)


def _layers(hp: HParams, w: ModelWeights) -> list:
    """Per-layer weights: the unrolled tuple, or views of the stacked
    layers (a shared-KV layer of ``stack_layers_gemma4``'s stack as its Q
    rows)."""
    layers = w.layers
    if not isinstance(layers, LayerWeights):
        return list(layers)
    views = [layer_view(layers, i) for i in range(hp.block_count)]
    return [v if hp.layer_has_kv(i) else shared_q_view(hp, v) for i, v in enumerate(views)]


def forward(hp: HParams, w: ModelWeights, cache: KVCache, tokens: torch.Tensor, pos,
            n_valid: int | None = None, *, consts=None,
            mm_impl: str = "auto") -> tuple[torch.Tensor, KVCache]:
    """One serve-mode forward step over T tokens. Returns (logits [vocab] f32
    of the last valid token, the cache, updated in place).

    T = 1 over stacked weights that ``fused_decode.decode_supported``,
    ``decode_q_enabled`` or ``decode_stream_enabled`` accepts runs that
    whole-step kernel (a flat cache only the last); ``tokens`` (int64) and
    ``pos`` (int32, one element) may then stay on the device.
    ``consts`` are the step constants of that kernel module's ``prepare``
    (built here when None).
    ``mm_impl="xla"`` (the batched server's prefill) takes the per-op path
    with W8A8 projections on CUDA (ops/linear.py)."""
    T = tokens.shape[0]
    if mm_impl == "auto" and isinstance(w.layers, LayerWeights) and T == 1:
        step = None
        flat = cache.k.dim() == 3
        if not flat and fused_decode.decode_supported(hp, w):
            step, mod = fused_decode.decode_step, fused_decode
        elif not flat and decode_q_enabled(hp, w):
            step, mod = fused_decode_q.decode_step_q, fused_decode_q
        elif decode_stream_enabled(hp, w, max_seq=cache.k.shape[1]):
            step, mod = fused_decode_stream.decode_step_stream, fused_decode_stream
        if step is not None:
            if consts is None:
                consts = mod.prepare(hp, tokens.device, swa_mask=swa_mask_enabled(),
                                     max_seq=cache.k.shape[1])
            dev = tokens.device
            tok = tokens.reshape(1).to(torch.int64)
            p = torch.as_tensor(pos, device=dev).reshape(1).to(torch.int32)
            logits = step(hp, w, cache, tok, p, consts)
            return softcap(logits, hp.final_logit_softcap), cache
    pos = int(pos)
    n_valid = T if n_valid is None else int(n_valid)
    x = embed_rows(w.token_embd, tokens) * torch.tensor(math.sqrt(hp.embedding_length),
                                                         dtype=torch.float32)
    pl_inp = _per_layer_inputs(hp, w, tokens, x)
    swa = swa_mask_enabled()
    S, Hkv = cache.k.shape[1], hp.n_head_kv
    # stacked weights: the JAX package's _forward_scan, over layer views
    for i, lw in enumerate(_layers(hp, w)):
        src = hp.kv_source_layer(i)
        # a flat cache's layer, viewed 4-D (gemma.py:1009-1016)
        k_c = cache.k[src].view(S, Hkv, hp.n_embd_head_k)
        v_c = cache.v[src].view(S, Hkv, hp.n_embd_head_v)
        x = _layer(hp, lw, x, k_c, v_c, pos=pos, n_valid=n_valid,
                   rope_base=hp.rope_base_for_layer(i), window=hp.swa_window(i) if swa else 0,
                   mm_impl=mm_impl, has_kv=hp.layer_has_kv(i),
                   pl_inp=None if pl_inp is None else pl_inp[:, i])
    return _logits(hp, w, x, n_valid, mm_impl), cache


# -- batched decode (continuous batching over dense lanes) ---------------------


def swa_active(hp: HParams) -> bool:
    """True when real windowing is both requested (LLMI_SWA_MASK=1) and
    applicable (a recorded window and SWA layers). The batched server's
    whole-step route keeps the reference's no-mask contract and is not
    taken then (llm_inference_tpu/models/gemma.py:175-183)."""
    if not swa_mask_enabled() or hp.sliding_window <= 0:
        return False
    return any(hp.is_swa_layer(i) for i in range(hp.block_count))


@dataclasses.dataclass
class BatchedKVCache:
    """Stacked batched caches: k [n_kv_layers, B, S, Hkv, dk], v [.., dv].
    The JAX server keeps one [B, S, Hkv, d] array a layer and stacks them
    around each kernel chunk (serving.py:290-305); one stacked tensor needs
    neither copy, and lane ``b`` of every layer is the view ``k[:, b]``."""

    k: torch.Tensor
    v: torch.Tensor

    def lane(self, b: int) -> KVCache:
        """Lane ``b`` as a single-stream cache (views: writes go through)."""
        return KVCache(k=self.k[:, b], v=self.v[:, b])


def init_batched_cache(hp: HParams, max_batch: int, max_seq: int, *, device="cpu",
                       dtype=KV_DTYPE) -> BatchedKVCache:
    """Zeroed batched caches for every layer that owns KV storage."""
    one = init_cache(hp, max_seq, device="meta", dtype=dtype)  # shapes only
    L, S, Hkv, dk = one.k.shape
    dv = one.v.shape[-1]
    return BatchedKVCache(
        k=torch.zeros((L, max_batch, S, Hkv, dk), dtype=dtype, device=device),
        v=torch.zeros((L, max_batch, S, Hkv, dv), dtype=dtype, device=device))


def batched_cache_from_arrays(k_layers, v_layers, *, device="cpu",
                              dtype=KV_DTYPE) -> BatchedKVCache:
    """The port's stacked batched cache from the JAX server's per-layer
    caches, given as numpy arrays ([B, S, Hkv, d] each, any float dtype):
    both packages can then start from the same state."""
    def stack(arrs):
        return torch.stack([torch.from_numpy(np.asarray(a, dtype=np.float32)) for a in arrs]).to(
            device=device, dtype=dtype)

    return BatchedKVCache(k=stack(k_layers), v=stack(v_layers))


def _batched_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       pos: torch.Tensor, *, hp: HParams, window: int = 0) -> torch.Tensor:
    """Per-lane masked-softmax attention over the whole lane cache, the JAX
    package's vmapped ``_attention`` (gemma.py:744-748), as the plain
    flash-decode attention over slots (pos - window, pos] with ALiBi: q
    [B, H, Dk] f32 scaled, caches [B, S, Hkv, D], ``pos`` [B] (clamped into
    the cache by the caller). Returns [B, H * Dv] f32."""
    lengths = pos.to(torch.int32) + 1
    starts = torch.clamp(lengths - window, min=0) if window > 0 else None
    slopes = (_alibi_slopes(q.shape[1], hp.f_max_alibi_bias).to(q.device)
              if hp.f_max_alibi_bias > 0.0 else None)
    out = flash_decode.flash_decode_plain(q, k_cache, v_cache, lengths, starts,
                                          softcap=hp.attn_soft_cap or 0.0, alibi_slopes=slopes)
    return out.reshape(q.shape[0], -1)


def _batched_step(hp: HParams, w: ModelWeights, tokens: torch.Tensor, pos: torch.Tensor,
                  attend) -> torch.Tensor:
    """The per-op batched decode step's layer loop (llm_inference_tpu/
    models/gemma.py:631-780 and :783-971 share it): every projection one
    W8A8 product over the B lanes (``mm_impl="xla"``), q/k norms and RoPE
    at each lane's position. ``attend(i, q, k, v)`` stores layer ``i``'s
    new K/V rows and returns its attention output [B, H * dv] f32. Returns
    the logits [B, V] f32. gemma4: a shared-KV layer ``i`` calls
    ``attend(i, q, None, None)`` and reads ``hp.kv_source_layer(i)``'s cache;
    the per-layer inputs, V norm and out_scale as in ``forward``
    (gemma.py:631-781)."""
    mm = partial(_matmul, mm_impl="xla")
    B = tokens.shape[0]
    dk, dv = hp.n_embd_head_k, hp.n_embd_head_v
    tokens = tokens.long()
    x = embed_rows(w.token_embd, tokens) * torch.tensor(math.sqrt(hp.embedding_length),
                                                        dtype=torch.float32)
    pl_inp = _per_layer_inputs(hp, w, tokens, x)
    for i, lw in enumerate(_layers(hp, w)):
        rope_base = hp.rope_base_for_layer(i)
        has_kv = hp.layer_has_kv(i)
        h = _norm(x, lw.attn_norm, hp.rms_eps)
        q_flat, k_flat, v_flat = _project_qkv(hp, lw, h, has_kv, mm)
        q = q_flat.reshape(B, hp.n_head, dk)
        if lw.q_norm is not None:
            q = _norm(q, lw.q_norm, hp.rms_eps)
        q = rope(q, n_rot=dk, freq_base=rope_base, freq_scale=hp.rope_freq_scale, pos=pos)
        q = q * torch.tensor(hp.f_attention_scale, dtype=torch.float32)
        k = v = None
        if has_kv:
            k = k_flat.reshape(B, hp.n_head_kv, dk)
            if lw.k_norm is not None:
                k = _norm(k, lw.k_norm, hp.rms_eps)
            k = rope(k, n_rot=dk, freq_base=rope_base, freq_scale=hp.rope_freq_scale, pos=pos)
            v = v_flat.reshape(B, hp.n_head_kv, dv)
            if hp.architecture == "gemma4":
                v = rms_norm(v, hp.rms_eps)
        attn = mm(lw.wo, attend(i, q, k, v))
        if lw.post_attn_norm is not None:
            attn = _norm(attn, lw.post_attn_norm, hp.rms_eps)
        x = _ffn_and_epilogue(hp, lw, x + attn, None if pl_inp is None else pl_inp[:, i], mm)
    x = _norm(x, w.output_norm, hp.rms_eps)
    return softcap(mm(w.token_embd, x), hp.final_logit_softcap)


def forward_batched_decode(hp: HParams, w: ModelWeights, cache: BatchedKVCache,
                           tokens: torch.Tensor, pos: torch.Tensor) -> tuple[torch.Tensor,
                                                                            BatchedKVCache]:
    """One decode step for B lanes as one batched program, the per-op route
    of the batched server (llm_inference_tpu/models/gemma.py:631-780):
    ``_batched_step``'s projections; each lane's K/V row goes in place to
    (layer, b, pos[b]) through ``insert_kv_rows``, one launch a layer for
    K and V (parked lanes, pos >= S, drop), and attention is the ragged
    ``flash_decode`` when S % 256 == 0 and no ALiBi, else the per-lane
    masked softmax. ``tokens`` [B] and
    ``pos`` [B] int32 stay on the device. Returns (logits [B, V] f32, the
    cache updated in place)."""
    B = tokens.shape[0]
    S = cache.k.shape[2]
    pos = pos.to(torch.int32)
    lanes = torch.arange(B, dtype=torch.int32, device=tokens.device)
    use_flash = hp.f_max_alibi_bias == 0.0 and S % 256 == 0
    swa = swa_mask_enabled()
    # one drop rule for every layer: parked or negative positions write nothing
    rowidx = torch.where((pos >= 0) & (pos < S), lanes * S + pos,
                         torch.full_like(pos, B * S)).to(torch.int32)
    lengths = torch.where(pos >= S, torch.zeros_like(pos), pos + 1).to(torch.int32)

    def attend(i, q, k, v):
        kc, vc = cache.k[hp.kv_source_layer(i)], cache.v[hp.kv_source_layer(i)]  # [B, S, Hkv, d]
        if k is not None:  # one launch: both rows rounded to the pools' bf16 in the kernel
            kv_insert.insert_kv_rows(kc.view(B * S, *kc.shape[2:]), vc.view(B * S, *vc.shape[2:]),
                                     k, v, rowidx)
        win = hp.swa_window(i) if swa else 0
        if not use_flash:
            return _batched_attention(q, kc, vc, torch.clamp(pos, max=S - 1), hp=hp, window=win)
        starts = (torch.clamp(lengths - win, min=0) if win > 0
                  else torch.zeros_like(lengths)).to(torch.int32)
        attn = flash_decode.flash_decode(q, kc, vc, lengths, starts,
                                         softcap=hp.attn_soft_cap or 0.0)
        return attn.reshape(B, -1)

    return _batched_step(hp, w, tokens, pos, attend), cache


# -- batched decode over a shared page pool (paged serving) -------------------------


@dataclasses.dataclass
class PagedKVCache:
    """Shared page pools, one per KV layer: ``k[i]`` [rows_i, PAGE, Hkv, dk],
    ``v[i]`` [rows_i, PAGE, Hkv, dv] (llm_inference_tpu/serving.py:397-414).
    A plain layer has the server's ``kv_pages`` rows (plus the trash row on
    the paged kernel route); a sliding-window ring layer ``max_batch * ring``.
    When every layer has the same rows, ``k_all``/``v_all`` hold them as one
    stacked [L, rows, PAGE, Hkv, d] tensor and ``k[i]``, ``v[i]`` are its
    views (the paged whole step reads the stack, the per-op route the
    views); otherwise they are None. The TPU package's split-d pools
    ([rows, PAGE, d / 128, 128] for one KV head) are the same bytes as
    [rows, PAGE, 1, d]: the port keeps that one layout."""

    k: list
    v: list
    k_all: torch.Tensor | None = None
    v_all: torch.Tensor | None = None

    @property
    def page(self) -> int:
        return self.k[0].shape[1]


def _paged(k_layers: list, v_layers: list) -> PagedKVCache:
    """Pools of per-layer tensors, stacked into one when their shapes agree."""
    if len({tuple(t.shape) for t in k_layers}) == 1 and \
            len({tuple(t.shape) for t in v_layers}) == 1:
        k_all, v_all = torch.stack(k_layers), torch.stack(v_layers)
        return PagedKVCache(k=list(k_all.unbind(0)), v=list(v_all.unbind(0)), k_all=k_all,
                            v_all=v_all)
    return PagedKVCache(k=list(k_layers), v=list(v_layers))


def init_paged_cache(hp: HParams, rows: int, page: int, *, rings=None, max_batch: int = 0,
                     device="cpu", dtype=KV_DTYPE) -> PagedKVCache:
    """Zeroed pools of ``rows`` pages of ``page`` slots for every KV layer;
    a layer in ``rings`` ({layer: ring pages}) gets ``max_batch * ring``
    rows instead."""
    rings = rings or {}
    dk, dv, Hkv = hp.n_embd_head_k, hp.n_embd_head_v, hp.n_head_kv
    if not rings:
        k = torch.zeros((hp.n_kv_layers, rows, page, Hkv, dk), dtype=dtype, device=device)
        v = torch.zeros((hp.n_kv_layers, rows, page, Hkv, dv), dtype=dtype, device=device)
        return PagedKVCache(k=list(k.unbind(0)), v=list(v.unbind(0)), k_all=k, v_all=v)

    def pool(i, d):
        n = max_batch * rings[i] if i in rings else rows
        return torch.zeros((n, page, Hkv, d), dtype=dtype, device=device)

    return PagedKVCache(k=[pool(i, dk) for i in range(hp.n_kv_layers)],
                        v=[pool(i, dv) for i in range(hp.n_kv_layers)])


def pools_from_arrays(hp: HParams, k_layers, v_layers, *, device="cpu",
                      dtype=KV_DTYPE) -> PagedKVCache:
    """The port's pools from the JAX server's per-layer pools, given as
    numpy arrays ([rows, PAGE, Hkv, d], or the split-d [rows, PAGE, d / 128,
    128] of one KV head; any float dtype): each re-viewed to [rows, PAGE,
    Hkv, d], the same bytes in the same order."""
    def conv(a, d):
        t = torch.from_numpy(np.asarray(a, dtype=np.float32))
        return t.reshape(t.shape[0], t.shape[1], hp.n_head_kv, d).to(device=device, dtype=dtype)

    return _paged([conv(a, hp.n_embd_head_k) for a in k_layers],
                  [conv(a, hp.n_embd_head_v) for a in v_layers])


def ring_pages(hp: HParams, page: int) -> dict[int, int]:
    """Sliding-window rings (llm_inference_tpu/serving.py:323-337): under
    real windowing a windowed layer only ever reads its last ``window``
    keys, so its pool shrinks to a per-lane ring of ceil(window / page) + 1
    pages. {layer: ring pages}; empty without real windowing."""
    if not swa_active(hp) or hp.n_layer_kv_from_start >= 0:
        return {}
    rings = {}
    for i in range(hp.n_kv_layers):
        win = hp.swa_window(i)
        if win > 0:
            rings[i] = -(-win // page) + 1
    return rings


def forward_batched_decode_paged(hp: HParams, w: ModelWeights, pools: PagedKVCache,
                                 table: torch.Tensor, tokens: torch.Tensor, pos: torch.Tensor, *,
                                 ring_layers=(), nb_cap: int | None = None
                                 ) -> tuple[torch.Tensor, PagedKVCache]:
    """One decode step for B lanes over a shared page pool, the per-op paged
    route of the batched server (llm_inference_tpu/models/gemma.py:783-971).
    The projections are ``forward_batched_decode``'s (W8A8 on CUDA,
    ``mm_impl="xla"``). ``table`` [B, NB] int32 maps each lane's blocks of
    PAGE slots to pool rows; ids at or past a pool's rows are unassigned.
    Lane b's new K/V row goes in place to slot ``pos % PAGE`` of page
    ``table[b, min(pos // PAGE, NB - 1)]`` through ``insert_kv_rows``; a parked
    lane (pos >= NB * PAGE) maps to the drop sentinel, as do ids outside the
    pool. A layer in ``ring_layers`` is a sliding-window ring of ``ring``
    pages a lane (rows B * ring): block j of lane b lives at row
    ``b * ring + j % ring`` (:857-871). Attention is ``paged_flash_decode``
    over each lane's live window (at most ``nb_cap`` blocks), or, with
    ALiBi, the per-lane masked softmax over the lane's gathered pages
    (:929-939). ``tokens`` and ``pos`` [B] int32 stay on the device.
    Returns (logits [B, V] f32, the pools updated in place)."""
    B = tokens.shape[0]
    dev = tokens.device
    page = pools.page
    nb = table.shape[1]
    pos = pos.to(torch.int32)
    table = table.to(torch.int32)
    lanes = torch.arange(B, dtype=torch.int32, device=dev)
    parked = pos >= nb * page
    blk = torch.clamp(torch.div(pos, page, rounding_mode="floor"), max=nb - 1)
    off = pos % page
    lengths = torch.where(parked, torch.zeros_like(pos), pos + 1)
    use_flash = hp.f_max_alibi_bias == 0.0
    swa = swa_mask_enabled()

    def row_ids(page_i, rows):
        # one drop rule: ids outside the pool, parked lanes included, write nothing
        page_i = torch.where(parked, torch.full_like(page_i, rows), page_i)
        return torch.where((page_i >= 0) & (page_i < rows), page_i * page + off,
                           torch.full_like(page_i, rows * page)).to(torch.int32)

    # the plain layers' ids are the same in every layer: once a step
    page_of = table[lanes.long(), blk.long()]
    plain_ids = {r: row_ids(page_of, r) for r in
                 {pools.k[j].shape[0] for j in range(len(pools.k)) if j not in ring_layers}}

    def attend(i, q, k, v):
        src = hp.kv_source_layer(i)
        kc, vc = pools.k[src], pools.v[src]  # [rows, PAGE, Hkv, d]
        rows = kc.shape[0]
        win = hp.swa_window(i) if swa else 0
        if src in ring_layers:
            ring = -(-win // page) + 1
            if win <= 0 or rows != B * ring:
                raise ValueError(f"layer {i}: a ring pool needs a window and {B} x {ring} rows")
            table_i = (lanes[:, None] * ring
                       + torch.arange(nb, dtype=torch.int32, device=dev)[None, :] % ring)
            idx = row_ids(lanes * ring + blk % ring, rows)
        else:
            table_i, idx = table, plain_ids[rows]
        if k is not None:  # one launch: both rows rounded to the pools' bf16 in the kernel
            kv_insert.insert_kv_rows(kc.view(rows * page, *kc.shape[2:]),
                                     vc.view(rows * page, *vc.shape[2:]), k, v, idx)
        if not use_flash:
            # gather-to-dense: each lane's pages as a dense lane of NB * PAGE slots
            tbl = table_i.long().clamp(0, rows - 1)
            kd = kc[tbl].reshape(B, nb * page, *kc.shape[2:])
            vd = vc[tbl].reshape(B, nb * page, *vc.shape[2:])
            return _batched_attention(q, kd, vd, torch.clamp(pos, max=nb * page - 1), hp=hp,
                                      window=win)
        starts = (torch.clamp(lengths - win, min=0) if win > 0
                  else torch.zeros_like(lengths)).to(torch.int32)
        attn = flash_decode.paged_flash_decode(q, kc, vc, table_i.contiguous(), lengths, starts,
                                               softcap=hp.attn_soft_cap or 0.0, nb_cap=nb_cap)
        return attn.reshape(B, -1)

    return _batched_step(hp, w, tokens, pos, attend), pools
