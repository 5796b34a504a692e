"""Gemma-3 and gemma4 forward: prefill over T tokens, decode one token per call.

Counterpart of llm_inference_tpu/models/gemma.py
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
engine.py:217-237). Per-layer head dims are a later slice.

``forward(exact=True)`` is the parity mode (gemma.py:196-373, :483-576 of
the JAX package): every product through the exact contract (ops/linear.py),
Q rounded through f16 before the QK dot, the scores in f64 on the CPU and
in true f32 on CUDA (``_masked_scores``), the reference's online softmax
with its f16 V accumulator (``_attention_parity``), an f16 cache
(``PARITY_KV_DTYPE``). In both modes the forward taps the JAX forward's
named values in its order (trace.py). Serve single-stream decode may
attend through ``flash_decode`` on CUDA under LLMI_FLASH_DECODE=1
(``_attention``).

Sharded (parallel/sharding.py): every function here takes weights with
``ShardedTensor`` matmul weights (ops/linear.py runs their ranks) and,
where ``init_cache(sharding=...)`` or ``init_batched_cache(sharding=...)``
split the KV heads over the 'model' ranks, a ``ShardedKVCache``: rank r
writes its KV heads [r Hkv/n, (r+1) Hkv/n) and attends with its query
heads [r H/n, (r+1) H/n) on its own device (``_over_heads``; the batched
step through ``insert_kv_rows`` and ``flash_decode`` on the rank's shard),
and the ranks' outputs are joined in rank order on the activations'
device. The batched server's lanes split over a mesh's data rows as
``LaneRows``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from functools import partial

import numpy as np
import torch

from ..ops.kernels import flash_decode, fused_decode, fused_decode_q, fused_decode_stream, kv_insert
from ..ops.linear import embed_rows, require_true_f32
from ..ops.linear import matmul as _matmul
from ..ops.numerics import f16_round, gelu_tanh, rms_norm, rope, softcap
from ..parallel.sharding import CacheSharding
from ..trace import tap
from .hparams import HParams
from .weights import LayerWeights, ModelWeights, layer_view, shared_q_view

KV_DTYPE = torch.bfloat16  # serve caches (engine.py of the JAX package)
PARITY_KV_DTYPE = torch.float16  # the parity mode's: the reference's f16 stores (model.cpp:442-459)


@dataclasses.dataclass
class KVCache:
    """Stacked caches: k [n_kv_layers, S, Hkv, dk], v [n_kv_layers, S, Hkv, dv],
    or flat (``init_cache(flat=True)``): [n_kv_layers, S, Hkv * d]."""

    k: torch.Tensor
    v: torch.Tensor


@dataclasses.dataclass
class ShardedKVCache:
    """A cache whose KV heads split over the tensor-parallel ranks of one
    data row of a mesh: ``shards[r]`` is rank r's ``KVCache`` or
    ``BatchedKVCache`` of KV heads [r Hkv/n, (r+1) Hkv/n), on
    ``mesh.devices[data_row, r]`` (None for a rank of another process)."""

    shards: list
    mesh: object
    data_row: int = 0

    def lane(self, b: int) -> "ShardedKVCache":
        """Lane ``b`` of batched shards (views: writes go through)."""
        return ShardedKVCache([None if c is None else c.lane(b) for c in self.shards], self.mesh,
                              self.data_row)

    @property
    def local(self):
        return next(c for c in self.shards if c is not None)


def _heads_split(sharding: CacheSharding | None, dim: int) -> int:
    """The ranks a cache sharding splits the heads (``dim``) over; 1 if none."""
    if sharding is None or sharding.axis_of(dim) is None:
        return 1
    return sharding.mesh.shape[sharding.axis_of(dim)]


def init_cache_splits_heads(sharding: CacheSharding) -> bool:
    """Whether ``init_cache(sharding=sharding)`` splits the KV heads."""
    return _heads_split(sharding, 1) > 1


def init_cache(hp: HParams, max_seq: int, *, device="cpu", dtype=KV_DTYPE,
               flat: bool = False, sharding: CacheSharding | None = None):
    """Zeroed stacked caches for every layer that owns KV storage (uniform
    head dims, as the stacked layout needs). ``flat=True`` gives the
    capacity step's layout [L, S, Hkv * d] (llm_inference_tpu/models/
    gemma.py:62-85): the same bytes as [L, S, Hkv, d], which every kernel
    addresses alike; the prefill views it 4-D per layer.

    ``sharding`` (parallel/sharding.py ``kv_cache_sharding``, a spec over
    [S, Hkv, d]): a ``ShardedKVCache`` over this process's first data row
    when it splits the heads; otherwise one copy, on that row's first
    device in place of ``device``."""
    n = _heads_split(sharding, 1)
    if sharding is not None:
        mesh = sharding.mesh
        row = mesh.local_rows()[0]
        if n > 1:
            if flat:
                raise ValueError("init_cache: a flat cache (the capacity step's) is not sharded")
            shard = lambda r: _zero_cache(hp, max_seq, hp.n_head_kv // n, dtype,  # noqa: E731
                                          mesh.devices[row, r], False)
            return ShardedKVCache([shard(r) if mesh.is_local(row, r) else None for r in range(n)],
                                  mesh, row)
        device = mesh.home(row)
    return _zero_cache(hp, max_seq, hp.n_head_kv, dtype, device, flat)


def _zero_cache(hp: HParams, max_seq: int, Hkv: int, dtype, device, flat: bool) -> KVCache:
    if hp.n_embd_head_k != hp.n_embd_head_k_swa or hp.n_embd_head_v != hp.n_embd_head_v_swa:
        raise NotImplementedError("per-layer head dims need the per-layer cache of a later "
                                  "slice (ROADMAP.md queue 1, item 7)")
    L = hp.n_kv_layers
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


def _mm(exact: bool, mm_impl: str):
    """A layer's matmul: the parity contract (``exact``), or the serve
    dispatch with ``mm_impl`` (ops/linear.py)."""
    return partial(_matmul, exact=True) if exact else partial(_matmul, mm_impl=mm_impl)


def _masked_scores(q: torch.Tensor, k_cache: torch.Tensor, *, pos: int, hp: HParams,
                   window: int = 0, exact: bool = False, f64_scores: bool = True,
                   head0: int = 0):
    """QK scores + softcap + ALiBi + causal/window mask (reference
    model.cpp:501-518). q [T, H, Dk] f32, k_cache [S', Hkv, Dk]; ``head0``:
    the model head of q's first (a rank's query heads; ALiBi's slopes are
    per model head). Returns (scores [T, Hkv, group, S'] f32 with -inf at
    masked slots, valid [T, S']).

    ``exact`` (the parity mode, llm_inference_tpu/models/gemma.py:196-253):
    Q rounds through f16 before the dot (model.cpp:504-509). The reference
    sums each score in a C++ double; on the CPU the scores sum in f64 too,
    as the JAX package's do there, unless ``f64_scores`` is False (the
    batched server's decode, which the JAX package vmaps in f32) or
    ``LLMI_EXACT_F32_SCORES=1``. On CUDA they sum in true f32, as the JAX
    package's do on the TPU (``Precision.HIGHEST``): CUDA stands where the
    TPU stands (ops/linear.py), so the card keeps the parity mode on the
    card; the f32 sums differ from the f64 ones only by f32 rounding
    (tests/test_torch_parity.py holds them within 1e-6 of the largest
    score)."""
    T, H, Dk = q.shape
    S, Hkv, _ = k_cache.shape
    group = H // Hkv
    qg = (f16_round(q.float()) if exact else q.float()).reshape(T, Hkv, group, Dk)
    k = k_cache.float()
    if (exact and f64_scores and not q.is_cuda
            and os.environ.get("LLMI_EXACT_F32_SCORES", "0") != "1"):
        scores = torch.einsum("tkgd,skd->tkgs", qg.double(), k.double()).float()
    else:
        if exact:
            require_true_f32(q)
        scores = torch.einsum("tkgd,skd->tkgs", qg, k)
    scores = softcap(scores, hp.attn_soft_cap)

    dev = q.device
    q_pos = pos + torch.arange(T, dtype=torch.int64, device=dev)
    key_pos = torch.arange(S, dtype=torch.int64, device=dev)
    if hp.f_max_alibi_bias > 0.0:
        slopes = _alibi_slopes(hp.n_head, hp.f_max_alibi_bias)[head0 : head0 + H]
        slopes = slopes.to(dev).reshape(Hkv, group)
        bias = (key_pos[None, :] - q_pos[:, None]).float()
        scores = scores + slopes[None, :, :, None] * bias[:, None, None, :]
    valid = key_pos[None, :] <= q_pos[:, None]
    if window > 0:
        valid = valid & (key_pos[None, :] > q_pos[:, None] - window)
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    return scores, valid


def _attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, *, pos: int,
               hp: HParams, window: int = 0, head0: int = 0) -> torch.Tensor:
    """Fused masked-softmax attention (reference run_attn, model.cpp:478-548),
    f32. q [T, H, Dk] already scaled; caches [S, Hkv, D]. Returns [T, H*Dv].
    Reads only slots [0, pos + T): later slots are masked and would add
    exact zeros. Under LLMI_FLASH_DECODE=1 (opt-in, as in
    llm_inference_tpu/models/gemma.py:277-301) one token on CUDA, with no
    ALiBi and S % 256 == 0, attends through ``flash_decode`` from the
    window's start; the CPU keeps the masked softmax, as the JAX package
    does off the TPU."""
    T, H, _ = q.shape
    S = k_cache.shape[0]
    if (T == 1 and q.is_cuda and hp.f_max_alibi_bias == 0.0 and S % 256 == 0
            and os.environ.get("LLMI_FLASH_DECODE", "0") == "1"):
        length = pos + 1
        start = max(length - window, 0) if window > 0 else 0
        # device fills, not host copies: nothing here waits for the stream
        lengths = torch.full((1,), length, dtype=torch.int32, device=q.device)
        starts = torch.full((1,), start, dtype=torch.int32, device=q.device)
        out = flash_decode.flash_decode(q, k_cache[None], v_cache[None], lengths, starts,
                                        softcap=hp.attn_soft_cap or 0.0)
        return out.reshape(T, -1)
    live = min(pos + T, S)
    k_cache, v_cache = k_cache[:live], v_cache[:live]
    scores, _ = _masked_scores(q, k_cache, pos=pos, hp=hp, window=window, head0=head0)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("tkgs,skd->tkgd", probs, v_cache.float())
    return out.reshape(T, H * v_cache.shape[-1])


def _attention_parity(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                      pos: int, hp: HParams, window: int = 0,
                      f64_scores: bool = True, head0: int = 0) -> torch.Tensor:
    """The reference's online-softmax attention with its f16 V accumulator
    (model.cpp:501-548; vec_scale_f16 / vec_mad_f16, ops.cpp:1084-1099), as
    llm_inference_tpu/models/gemma.py:316-373 emulates it: slot by slot, the
    accumulator rounds to f16 after every scale and after every mad. Scores
    from ``_masked_scores(exact=True)``. Returns [T, H * Dv] f32.

    The JAX scan walks all S slots, and a masked slot leaves its carry as
    it was; slots past pos + T - 1, and before the window of the first
    query, are masked for every query, so the loop here walks only the
    others and gives the same bits. A Python loop over slots, each step
    vectorised over T, heads and d: a validation path, slow by design."""
    T, H, _ = q.shape
    S, Hkv, Dv = v_cache.shape
    group = H // Hkv
    live = min(pos + T, S)
    first = max(0, pos - window + 1) if window > 0 else 0
    scores, valid = _masked_scores(q, k_cache[:live], pos=pos, hp=hp, window=window, exact=True,
                                   f64_scores=f64_scores, head0=head0)
    v_all = v_cache[:live].float()
    dev = q.device
    max_s = torch.full((T, Hkv, group), float("-inf"), dtype=torch.float32, device=dev)
    s_acc = torch.zeros((T, Hkv, group), dtype=torch.float32, device=dev)
    v_acc = torch.zeros((T, Hkv, group, Dv), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    for s in range(first, live):
        score_s = scores[..., s]  # [T, Hkv, g]
        gt = score_s > max_s
        new_max = torch.where(gt, score_s, max_s)
        score_exp = torch.where(gt, one, torch.exp(score_s - new_max))
        prev_exp = torch.where(gt, torch.exp(max_s - new_max), one)
        va = f16_round(v_acc * prev_exp[..., None])
        va = f16_round(va + v_all[s][None, :, None, :] * score_exp[..., None])
        new_s = s_acc * prev_exp + score_exp
        keep = valid[:, s][:, None, None]  # [T, 1, 1]
        max_s = torch.where(keep, new_max, max_s)
        s_acc = torch.where(keep, new_s, s_acc)
        v_acc = torch.where(keep[..., None], va, v_acc)
    nz = s_acc != 0.0
    # tensor over tensor: one rounding (a Python 1.0 over it would be two)
    s_inv = torch.where(nz, one / torch.where(nz, s_acc, one), torch.zeros_like(s_acc))
    return (f16_round(v_acc) * s_inv[..., None]).reshape(T, H * Dv)


def _per_layer_inputs(hp: HParams, w: ModelWeights, tokens: torch.Tensor,
                      x: torch.Tensor, exact: bool = False) -> torch.Tensor | None:
    """gemma4's per-layer inputs (llm_inference_tpu/models/gemma.py:379-394,
    reference model.cpp:568-704): the tokens' per-layer embedding rows times
    sqrt(P), plus the RMS-normed projection of the scaled embedding ``x``,
    over sqrt(2). [T, L, P] f32, or None for a model without them. The
    projection takes the exact contract in the parity mode and the default
    dispatch otherwise, on every route, the batched server's included, as
    the JAX package's does (a W8A8 product only at 16384 rows or more)."""
    if w.token_embd_per_layer is None:
        return None
    L, P = hp.block_count, hp.embedding_length_per_layer
    inp = embed_rows(w.token_embd_per_layer, tokens).reshape(-1, L, P) * torch.tensor(
        math.sqrt(P), dtype=torch.float32)
    if w.per_layer_model_proj is None:
        return inp
    proj = _mm(exact, "auto")(w.per_layer_model_proj, x) * torch.tensor(
        1.0 / math.sqrt(hp.embedding_length), dtype=torch.float32)
    proj = _norm(proj.reshape(-1, L, P), w.per_layer_proj_norm, hp.rms_eps)
    return (proj + inp) * torch.tensor(1.0 / math.sqrt(2.0), dtype=torch.float32)


def _ffn_and_epilogue(hp: HParams, lw: LayerWeights, x, pl_inp, matmul, i: int):
    """FFN block on the residual ``x`` of layer ``i``, then gemma4's
    per-layer-input epilogue (gemma.py:557-564) and ``out_scale``
    (:566-568) where the layer has them, tapped as the JAX forward taps
    them (:537-576)."""
    h2 = tap(f"ffn_norm-{i}", _norm(x, lw.ffn_norm, hp.rms_eps))
    if lw.w_gate_up is not None:
        gu = matmul(lw.w_gate_up, h2)
        n_ff = gu.shape[-1] // 2
        gate, up = gu[..., :n_ff], gu[..., n_ff:]
    else:
        gate = tap(f"ffn_gate-{i}", matmul(lw.w_gate, h2))
        up = tap(f"ffn_up-{i}", matmul(lw.w_up, h2))
    ffn = tap(f"ffn_out-{i}", matmul(lw.w_down, tap(f"ffn_geglu-{i}", gelu_tanh(gate) * up)))
    if lw.post_ffw_norm is not None:
        ffn = tap(f"ffn_post_norm-{i}", _norm(ffn, lw.post_ffw_norm, hp.rms_eps))
    x = x + ffn
    if pl_inp is not None:
        x = tap(f"pe_in-{i}", x)
        g = gelu_tanh(matmul(lw.per_layer_inp_gate, x)) * pl_inp
        x = tap(f"per_layer_embd_out-{i}",
                x + _norm(matmul(lw.per_layer_proj, g), lw.per_layer_post_norm, hp.rms_eps))
    if lw.out_scale is not None:
        x = tap(f"out_scaled-{i}", x * lw.out_scale.float().reshape(()))
    return tap(f"l_out-{i}", x)


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


def _layer(hp: HParams, lw: LayerWeights, x, attend, *, pos: int, rope_base: float,
           mm_impl: str = "auto", has_kv: bool = True, pl_inp=None, i: int = 0,
           exact: bool = False):
    """Layer ``i`` over T tokens. ``attend(q, k, v)`` (``_single_attend``)
    writes the layer's K/V rows into its cache in place and returns the
    attention output [T, H * dv]; a shared-KV layer (``has_kv`` False) gives
    it k = v = None and only reads its source layer's cache. ``pl_inp`` [T,
    P]: the layer's gemma4 per-layer input. ``exact``: the parity contract
    (``ops/linear.py`` exact matmuls and ``_attention_parity``); otherwise
    serve numerics. Taps every value the JAX forward taps, by the same
    names, in the same order (llm_inference_tpu/models/gemma.py:483-576).
    Returns the new residual stream."""
    matmul = _mm(exact, mm_impl)
    T = x.shape[0]
    dk, dv = hp.n_embd_head_k, hp.n_embd_head_v
    pos_vec = pos + torch.arange(T, dtype=torch.int64, device=x.device)
    h = tap(f"attn_norm-{i}", _norm(x, lw.attn_norm, hp.rms_eps))
    q_flat, k_flat, v_flat = _project_qkv(hp, lw, h, has_kv, matmul)
    q = tap(f"Qcur-{i}", q_flat).reshape(T, hp.n_head, dk)
    if lw.q_norm is not None:
        q = tap(f"Qcur_normed-{i}", _norm(q, lw.q_norm, hp.rms_eps))
    q = tap(f"Qcur-{i} (post rope)", rope(q, n_rot=dk, freq_base=rope_base,
                                          freq_scale=hp.rope_freq_scale, pos=pos_vec))
    q = tap(f"node_9-{i} (post scale)", q * torch.tensor(hp.f_attention_scale,
                                                          dtype=torch.float32))
    k = v = None
    if has_kv:
        k = tap(f"Kcur-{i}", k_flat).reshape(T, hp.n_head_kv, dk)
        if lw.k_norm is not None:
            k = tap(f"Kcur_normed-{i}", _norm(k, lw.k_norm, hp.rms_eps))
        k = tap(f"Kcur-{i} (post rope)", rope(k, n_rot=dk, freq_base=rope_base,
                                              freq_scale=hp.rope_freq_scale, pos=pos_vec))
        v = tap(f"Vcur-{i}", v_flat).reshape(T, hp.n_head_kv, dv)
        if hp.architecture == "gemma4":  # the unweighted V norm (model.cpp:812-827)
            v = tap(f"Vcur_normed-{i}", rms_norm(v, hp.rms_eps))
    attn = matmul(lw.wo, tap(f"kqv_out-{i}", attend(q, k, v)))
    if lw.post_attn_norm is not None:
        attn = tap(f"attn_post_norm-{i}", _norm(attn, lw.post_attn_norm, hp.rms_eps))
    return _ffn_and_epilogue(hp, lw, tap(f"sa_out-{i}", x + attn), pl_inp, matmul, i)


def _logits(hp: HParams, w: ModelWeights, x: torch.Tensor, n_valid: int,
            mm_impl: str = "auto", exact: bool = False) -> torch.Tensor:
    """Final norm + tied-embedding logits of the last valid token."""
    last = tap("result_norm", _norm(x[n_valid - 1], w.output_norm, hp.rms_eps))
    return tap("result_output",
               softcap(_mm(exact, mm_impl)(w.token_embd, last), hp.final_logit_softcap))


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
            n_valid: int | None = None, *, consts=None, mm_impl: str = "auto",
            exact: bool = False, f64_scores: bool = True) -> tuple[torch.Tensor, KVCache]:
    """One forward step over T tokens. Returns (logits [vocab] f32 of the
    last valid token, the cache, updated in place).

    ``exact=True`` is the parity mode, the reference's numeric contract
    (exact matmuls of exactly dequantized weights with the activation
    contracts, the f16 rounding points, ``_attention_parity``; give it an
    f16 cache, ``init_cache(dtype=PARITY_KV_DTYPE)``); ``f64_scores``:
    ``_masked_scores``. ``exact=False`` is serve numerics. Either way the
    values the JAX forward taps are tapped (trace.py).

    In serve numerics, T = 1 over stacked weights that
    ``fused_decode.decode_supported``, ``decode_q_enabled`` or
    ``decode_stream_enabled`` accepts runs that whole-step kernel (a flat
    cache only the last); ``tokens`` (int64) and ``pos`` (int32, one
    element) may then stay on the device. ``consts`` are the step constants
    of that kernel module's ``prepare`` (built here when None).
    ``mm_impl="xla"`` (the batched server's prefill) takes the per-op path
    with W8A8 projections on CUDA (ops/linear.py)."""
    T = tokens.shape[0]
    if not exact and mm_impl == "auto" and isinstance(w.layers, LayerWeights) and T == 1:
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
    x = tap("imp_embed", embed_rows(w.token_embd, tokens))
    x = tap("inp_scaled", x * torch.tensor(math.sqrt(hp.embedding_length), dtype=torch.float32))
    pl_inp = _per_layer_inputs(hp, w, tokens, x, exact)
    swa = swa_mask_enabled()
    # stacked weights: the JAX package's _forward_scan, over layer views
    for i, lw in enumerate(_layers(hp, w)):
        attend = _single_attend(hp, cache, hp.kv_source_layer(i), pos=pos, n_valid=n_valid,
                                window=hp.swa_window(i) if swa else 0, exact=exact,
                                f64_scores=f64_scores)
        x = _layer(hp, lw, x, attend, pos=pos, rope_base=hp.rope_base_for_layer(i),
                   mm_impl=mm_impl, has_kv=hp.layer_has_kv(i),
                   pl_inp=None if pl_inp is None else pl_inp[:, i], i=i, exact=exact)
    return _logits(hp, w, x, n_valid, mm_impl, exact), cache


def _over_heads(cache: ShardedKVCache, q, k, v, fn) -> torch.Tensor:
    """``fn(shard, q_r, k_r, v_r, head0)`` on each of this process's ranks of
    a head-sharded cache: rank r's query heads [r H/n, (r+1) H/n) and new
    K/V heads [r Hkv/n, (r+1) Hkv/n) (views, moved to its device; k = v =
    None for a shared-KV layer), ``head0`` = r H/n. The ranks' outputs [...,
    H/n * dv] are joined in rank order on q's device."""
    n = len(cache.shards)
    hq = q.shape[-2] // n
    parts = [None] * n
    for r, c in enumerate(cache.shards):
        if c is None:
            continue
        dev, hk = c.k.device, c.k.shape[-2]
        k_r, v_r = ((None, None) if k is None else
                    (t[..., r * hk:(r + 1) * hk, :].to(dev) for t in (k, v)))
        parts[r] = fn(c, q[..., r * hq:(r + 1) * hq, :].to(dev), k_r, v_r, r * hq)
    return torch.cat(cache.mesh.gather(parts, cache.data_row, q.device), dim=-1)


def _single_attend(hp: HParams, cache, src: int, *, pos: int, n_valid: int, window: int,
                   exact: bool, f64_scores: bool):
    """``attend(q, k, v)`` of a layer reading cache layer ``src``: the new
    K/V rows written at ``pos`` (``n_valid`` of them; none when k is None),
    then ``_attention`` or, in the parity mode, ``_attention_parity`` over
    the cache; over a ``ShardedKVCache`` each rank on its heads."""
    def one(c, q, k, v, head0):
        S = c.k.shape[1]
        Hkv = c.k.shape[2] if c.k.dim() == 4 else c.k.shape[2] // hp.n_embd_head_k
        # a flat cache's layer, viewed 4-D (gemma.py:1009-1016)
        kc = c.k[src].view(S, Hkv, hp.n_embd_head_k)
        vc = c.v[src].view(S, Hkv, hp.n_embd_head_v)
        if k is not None:
            _write_cache(kc, k, pos, n_valid)
            _write_cache(vc, v, pos, n_valid)
        if exact:
            return _attention_parity(q, kc, vc, pos=pos, hp=hp, window=window,
                                     f64_scores=f64_scores, head0=head0)
        return _attention(q, kc, vc, pos=pos, hp=hp, window=window, head0=head0)

    if isinstance(cache, ShardedKVCache):
        return lambda q, k, v: _over_heads(cache, q, k, v, one)
    return lambda q, k, v: one(cache, q, k, v, 0)


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


@dataclasses.dataclass
class LaneRows:
    """Dense lanes split over a mesh's data rows (``init_batched_cache``
    with a sharding): ``rows[d]`` holds lanes [d B/D, (d+1) B/D), a
    ``BatchedKVCache`` on the row's first device or, heads split, a
    ``ShardedKVCache`` of them over the row's ranks (None for a row of
    another process)."""

    rows: list
    lanes: int  # lanes a row

    def lane(self, slot: int):
        d, b = divmod(slot, self.lanes)
        return self.rows[d].lane(b)


def init_batched_cache(hp: HParams, max_batch: int, max_seq: int, *, device="cpu",
                       dtype=KV_DTYPE, sharding: CacheSharding | None = None):
    """Zeroed batched caches for every layer that owns KV storage.

    ``sharding`` (parallel/sharding.py ``batched_kv_cache_sharding``, a spec
    over [B, S, Hkv, d]) gives ``LaneRows``: the lanes split over the data
    rows where the spec names an axis for dim 0 (``max_batch`` must divide),
    else all on the first row; each row's KV heads split over its ranks
    where it names one for dim 2."""
    one = init_cache(hp, max_seq, device="meta", dtype=dtype)  # shapes only
    L, S, Hkv, dk = one.k.shape
    dv = one.v.shape[-1]

    def lanes(B, heads, dev):
        return BatchedKVCache(
            k=torch.zeros((L, B, S, heads, dk), dtype=dtype, device=dev),
            v=torch.zeros((L, B, S, heads, dv), dtype=dtype, device=dev))

    if sharding is None:
        return lanes(max_batch, Hkv, device)
    if len(sharding.spec) not in (0, 4):
        raise ValueError(f"batched cache sharding: a spec over [B, S, Hkv, d], got "
                         f"{sharding.spec}")
    mesh = sharding.mesh
    D, n = _heads_split(sharding, 0), _heads_split(sharding, 2)
    if max_batch % D:
        raise ValueError(f"max_batch {max_batch} does not split over {D} data rows")
    B = max_batch // D
    rows = []
    for d in range(D):
        if d not in mesh.local_rows():
            rows.append(None)
        elif n == 1:
            rows.append(lanes(B, Hkv, mesh.home(d)))
        else:
            rows.append(ShardedKVCache([lanes(B, Hkv // n, mesh.devices[d, r])
                                        if mesh.is_local(d, r) else None for r in range(n)],
                                       mesh, d))
    return LaneRows(rows, B)


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
                       pos: torch.Tensor, *, hp: HParams, window: int = 0,
                       head0: int = 0) -> torch.Tensor:
    """Per-lane masked-softmax attention over the whole lane cache, the JAX
    package's vmapped ``_attention`` (gemma.py:744-748), as the plain
    flash-decode attention over slots (pos - window, pos] with ALiBi: q
    [B, H, Dk] f32 scaled, caches [B, S, Hkv, D], ``pos`` [B] (clamped into
    the cache by the caller); ``head0`` as in ``_masked_scores``. Returns
    [B, H * Dv] f32."""
    lengths = pos.to(torch.int32) + 1
    starts = torch.clamp(lengths - window, min=0) if window > 0 else None
    slopes = (_alibi_slopes(hp.n_head, hp.f_max_alibi_bias)[head0 : head0 + q.shape[1]].to(
        q.device) if hp.f_max_alibi_bias > 0.0 else None)
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
        x = _ffn_and_epilogue(hp, lw, x + attn, None if pl_inp is None else pl_inp[:, i], mm, i)
    x = _norm(x, w.output_norm, hp.rms_eps)
    return softcap(mm(w.token_embd, x), hp.final_logit_softcap)


def forward_batched_decode(hp: HParams, w: ModelWeights, cache, tokens: torch.Tensor,
                           pos: torch.Tensor) -> tuple[torch.Tensor, object]:
    """One decode step for B lanes as one batched program, the per-op route
    of the batched server (llm_inference_tpu/models/gemma.py:631-780):
    ``_batched_step``'s projections; each lane's K/V row goes in place to
    (layer, b, pos[b]) through ``insert_kv_rows``, one launch a layer for
    K and V (parked lanes, pos >= S, drop), and attention is the ragged
    ``flash_decode`` when S % 256 == 0 and no ALiBi, else the per-lane
    masked softmax. ``tokens`` [B] and
    ``pos`` [B] int32 stay on the device. ``cache`` is a ``BatchedKVCache``
    or, heads split over ranks, a ``ShardedKVCache`` of them, each rank's
    append and attention on its own shard. Returns (logits [B, V] f32, the
    cache updated in place)."""
    B = tokens.shape[0]
    S = (cache.local if isinstance(cache, ShardedKVCache) else cache).k.shape[2]
    pos = pos.to(torch.int32)
    lanes = torch.arange(B, dtype=torch.int32, device=tokens.device)
    use_flash = hp.f_max_alibi_bias == 0.0 and S % 256 == 0
    swa = swa_mask_enabled()
    # one drop rule for every layer: parked or negative positions write nothing
    rowidx = torch.where((pos >= 0) & (pos < S), lanes * S + pos,
                         torch.full_like(pos, B * S)).to(torch.int32)
    lengths = torch.where(pos >= S, torch.zeros_like(pos), pos + 1).to(torch.int32)

    def lanes_attend(i, c, q, k, v, head0):
        kc, vc = c.k[hp.kv_source_layer(i)], c.v[hp.kv_source_layer(i)]  # [B, S, Hkv, d]
        dev = kc.device
        if k is not None:  # one launch: both rows rounded to the pools' bf16 in the kernel
            kv_insert.insert_kv_rows(kc.view(B * S, *kc.shape[2:]), vc.view(B * S, *vc.shape[2:]),
                                     k, v, rowidx.to(dev))
        win = hp.swa_window(i) if swa else 0
        if not use_flash:
            return _batched_attention(q, kc, vc, torch.clamp(pos, max=S - 1).to(dev), hp=hp,
                                      window=win, head0=head0)
        starts = (torch.clamp(lengths - win, min=0) if win > 0
                  else torch.zeros_like(lengths)).to(torch.int32)
        attn = flash_decode.flash_decode(q, kc, vc, lengths.to(dev), starts.to(dev),
                                         softcap=hp.attn_soft_cap or 0.0)
        return attn.reshape(B, -1)

    def attend(i, q, k, v):
        if isinstance(cache, ShardedKVCache):
            return _over_heads(cache, q, k, v, partial(lanes_attend, i))
        return lanes_attend(i, cache, q, k, v, 0)

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
