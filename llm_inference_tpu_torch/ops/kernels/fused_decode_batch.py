"""Batched whole-step decode: the CUDA kernels (csrc/fused_decode_batch.cu) and the plain twin.

Replaces llm_inference_tpu/ops/pallas/fused_decode_batch.py::
decode_step_megakernel_batch for a Gemma-3 checkpoint: one call computes a
decode step for B lanes over the stacked per-row int8 weights and the
stacked batched cache (``k``/``v`` [L, B, S, Hkv, d] bf16), writing each
lane's K/V rows in place at its position, and returns the tied-embedding
logits [B, V] f32 (final softcap left to the caller) or, with
``greedy=True``, each lane's argmax [B] int32 (lowest id on ties). Lanes
parked at a position outside [0, S) are clamped to row 0, as the TPU
wrapper does; token ids are clamped into the vocabulary so a parked lane's
id never reads out of bounds. The source note in
csrc/fused_decode_batch.cu says what bounds the step on the H100 and how
its kernels answer that.

``decode_step_batch`` launches the step for CUDA tensors (or raises) and
runs ``decode_step_batch_plain`` for CPU tensors. Tokens and positions are
[B] int32 device tensors, so a decode loop never syncs the host per step.
``launches`` counts launched steps.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ...quant.device import QuantTensor
from . import _build, fused_decode
# the single-stream twin's rounding helpers; its row-scaled dot takes [B, C] too
from .fused_decode import _bf16r, _mixed_dot, _rms

launches = 0

_LANE = 128
_MAX_LANES = 64      # csrc kMaxLanes: four m16 tiles
_MAX_GROUP = 8       # csrc kMaxGroup
_MAX_DIM = 256       # csrc kMaxDim
_CHUNK = 64          # csrc kChunk
_DEPTH = 4           # csrc kDepth
_ROWS_PER_BLOCK = 64
_STAGE_LIMIT = 96 * 1024  # staged activation bytes a split block aims to stay under
_PTR_FIELDS = 35
_DIM_FIELDS = 20


def batch_supported(hp, w, *, batch: int, max_seq: int) -> bool:
    """Eligibility: llm_inference_tpu's ``megakernel_batch_supported``
    without its VMEM budget and the TPU's vocabulary tiling: stacked Gemma-3
    layers, per-row int8 weights everywhere, q/k norms, no ALiBi, uniform
    head dims, 128-aligned widths, the fused QKV layout, ``max_seq % 16 ==
    0``; and this kernel's own limits: at most 64 lanes, at most 8 q heads
    per KV head, head dims of at most 256."""
    from ...models.weights import LayerWeights

    lw = w.layers
    if not isinstance(lw, LayerWeights) or hp.architecture != "gemma3":
        return False
    if hp.f_max_alibi_bias > 0.0 or hp.embedding_length_per_layer:
        return False
    parts = [lw.wqkv, lw.wo, lw.w_gate_up, lw.w_down, w.token_embd]
    if not all(isinstance(p, QuantTensor) and p.groups == 1 for p in parts):
        return False  # a grouped weight would lose its group scales here
    if lw.q_norm is None or lw.k_norm is None:
        return False
    if hp.n_embd_head_k != hp.n_embd_head_k_swa or hp.n_embd_head_v != hp.n_embd_head_v_swa:
        return False
    D, F, A = hp.embedding_length, lw.w_down.cols, lw.wo.cols
    dk, dv = hp.n_embd_head_k, hp.n_embd_head_v
    if any(v % _LANE for v in (D, F, A, dk, dv)) or dk > _MAX_DIM or dv > _MAX_DIM:
        return False
    if hp.n_head % hp.n_head_kv or hp.n_head // hp.n_head_kv > _MAX_GROUP:
        return False
    if A != hp.n_head * dv or lw.wqkv.rows != hp.n_head * dk + hp.n_head_kv * (dk + dv):
        return False
    if lw.w_gate_up.rows != 2 * F or lw.w_down.rows != D or lw.wo.rows != D:
        return False
    return 1 <= batch <= _MAX_LANES and max_seq % 16 == 0


def splits_for(rows: int, cols: int, sms: int, lanes: int) -> int:
    """Blocks a projection's contraction splits over: enough for about two
    blocks an SM, at least ``_DEPTH`` 64-column chunks a split (the chunks a
    lane keeps in flight), and few enough staged columns that a block's
    activations stay under 96 KB."""
    row_blocks = -(-rows // _ROWS_PER_BLOCK)
    n_chunks = cols // _CHUNK
    s = max(1, min(-(-2 * sms // row_blocks), n_chunks // _DEPTH))
    mt = -(-lanes // 16)
    while s < n_chunks and mt * 16 * (-(-n_chunks // s) * _CHUNK + 8) * 2 > _STAGE_LIMIT:
        s += 1
    return s


@dataclasses.dataclass
class BatchConsts:
    """Per-server constants of a batched step, built once: the rope base
    index per layer and the inverse-frequency rows (as
    ``fused_decode.prepare``), and on CUDA the plan and scratch of the
    step's kernels for ``batch`` lanes and ``max_seq`` slots."""

    base_idx: torch.Tensor  # [L] int32
    inv_freq: torch.Tensor  # [n_bases, dk // 2] f32
    batch: int = 0
    max_seq: int = 0
    plan: dict | None = None
    scratch: dict | None = None


def _lib():
    lib = _build.library("fused_decode_batch")
    lib.fused_decode_batch_logits_grid.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fused_decode_batch_step.argtypes = [ctypes.c_void_p] * 4
    lib.fused_decode_batch_paged_step.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                                  + [ctypes.c_void_p])
    for name in ("fused_decode_batch_logits_grid", "fused_decode_batch_slot_chunk",
                 "fused_decode_batch_step", "fused_decode_batch_paged_step"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def prepare_batch(hp, device, *, batch: int, max_seq: int) -> BatchConsts:
    """The step constants on ``device`` (and, on CUDA, the kernels' plan and
    scratch)."""
    base = fused_decode.prepare(hp, "cpu", swa_mask=False)
    device = torch.device(device)
    consts = BatchConsts(base.base_idx.to(device), base.inv_freq.to(device), batch, max_seq)
    if device.type != "cuda":
        return consts
    lib = _lib()
    B, S = batch, max_seq
    D, F = hp.embedding_length, hp.feed_forward_length
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
    A, Rq = H * dv, H * dk + Hkv * (dk + dv)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = {"V": hp.vocab_size, "sms": sms, "sq": splits_for(Rq, D, sms, B),
            "so": splits_for(D, A, sms, B), "sd": splits_for(D, F, sms, B),
            "ldh": -(-max(D, A) // 8) * 8}
    with torch.cuda.device(device):
        plan["logits_grid"] = lib.fused_decode_batch_logits_grid(hp.vocab_size, sms)
        slot_chunk = lib.fused_decode_batch_slot_chunk()
    nch = -(-S // slot_chunk)
    plan["part_cap"] = max(plan["sq"] * B * Rq, plan["so"] * B * D, plan["sd"] * B * D)
    f32 = dict(dtype=torch.float32, device=device)
    bf16 = dict(dtype=torch.bfloat16, device=device)
    consts.plan = plan
    consts.scratch = {
        "x": torch.empty((B, D), **f32),
        "h": torch.empty((B, plan["ldh"]), **bf16),
        "act": torch.empty((B, F), **bf16),
        "part": torch.empty(plan["part_cap"], **f32),
        "qb": torch.empty((B, H * dk), **bf16),
        "scores": torch.empty((B, H, S), **f32),
        "cmax": torch.empty((B, H, nch), **f32),
        "pl": torch.empty((B, H, nch), **f32),
        "pacc": torch.empty((B, H, nch, dv), **f32),
        "best_v": torch.empty(plan["logits_grid"] * B, **f32),
        "best_i": torch.empty(plan["logits_grid"] * B, dtype=torch.int32, device=device),
    }
    return consts


def clamp_positions(pos: torch.Tensor, max_seq: int) -> torch.Tensor:
    """Parked lanes (positions outside [0, S)) go to row 0."""
    return torch.where((pos < 0) | (pos >= max_seq), torch.zeros_like(pos), pos)


def decode_step_batch_plain(hp, w, cache, tokens, pos, consts: BatchConsts, *,
                            greedy: bool = False) -> torch.Tensor:
    """Plain torch version of the step, with the kernels' rounding points."""
    B, S = tokens.shape[0], cache.k.shape[2]
    p = clamp_positions(pos, S).long()
    lanes = torch.arange(B, device=tokens.device)

    def kv(l, k, v, n):
        cache.k[l, lanes, p] = k.to(cache.k.dtype)
        cache.v[l, lanes, p] = v.to(cache.v.dtype)
        return cache.k[l, :, :n], cache.v[l, :, :n]

    return step_plain(hp, w, tokens, p, consts, kv, greedy=greedy)


def step_plain(hp, w, tokens, p, consts: BatchConsts, kv, *, greedy: bool) -> torch.Tensor:
    """The step's arithmetic for lanes at clamped positions ``p`` (int64
    [B]); ``kv(l, k, v, n)`` writes layer ``l``'s new K/V rows (roped k,
    v) at each lane's position and returns every lane's first ``n`` slots of
    that layer, [B, n, Hkv, d] each, wherever the cache keeps them."""
    lw = w.layers
    L = lw.wqkv.q.shape[0]
    B = tokens.shape[0]
    D, H, Hkv = hp.embedding_length, hp.n_head, hp.n_head_kv
    dk, dv, eps = hp.n_embd_head_k, hp.n_embd_head_v, hp.rms_eps
    G, half, F = H // Hkv, dk // 2, lw.w_down.cols
    emb = w.token_embd
    tok = tokens.long().clamp(0, emb.rows - 1)
    x = emb.q[tok].float() * emb.scale[tok] * torch.tensor(math.sqrt(D), dtype=torch.float32)
    n = int(p.max()) + 1  # the live prefix of the deepest lane
    valid = torch.arange(n, device=tokens.device)[None, :] <= p[:, None]  # [B, n]
    for l in range(L):
        h = _bf16r(_rms(x, eps) * lw.attn_norm[l])
        qkv = _mixed_dot(h, lw.wqkv.q[l], lw.wqkv.scale[l])
        q = _rms(qkv[:, : H * dk].reshape(B, H, dk), eps) * lw.q_norm[l]
        k = _rms(qkv[:, H * dk : (H + Hkv) * dk].reshape(B, Hkv, dk), eps) * lw.k_norm[l]
        v = qkv[:, (H + Hkv) * dk :].reshape(B, Hkv, dv)
        ang = p.float()[:, None] * consts.inv_freq[int(consts.base_idx[l])][None, :] / torch.tensor(
            hp.rope_freq_scale, dtype=torch.float32)
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]

        def rope(t):
            t0, t1 = t[..., :half], t[..., half:]
            return torch.cat([t0 * cos - t1 * sin, t0 * sin + t1 * cos], dim=-1)

        qb = _bf16r(rope(q) * torch.tensor(hp.f_attention_scale, dtype=torch.float32))
        kl, vl = kv(l, rope(k), v, n)
        kk = kl.float()  # [B, n, Hkv, dk]
        # a lane's slots past its position are masked; zeroed here, so a stale
        # row (a reused page) cannot reach the sum even as a non-finite value
        vv = torch.where(valid[:, :, None, None], vl.float(), 0.0)
        s = torch.einsum("bkgd,bnkd->bkgn", qb.reshape(B, Hkv, G, dk), kk)
        if hp.attn_soft_cap and hp.attn_soft_cap > 0.0:
            s = hp.attn_soft_cap * torch.tanh(s / hp.attn_soft_cap)
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
        pr = torch.exp(s - s.amax(dim=-1, keepdim=True))
        den = pr.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bkgn,bnkd->bkgd", _bf16r(pr), vv)
        attn = _bf16r((pv / den).reshape(B, H * dv))
        y = _mixed_dot(attn, lw.wo.q[l], lw.wo.scale[l])
        if lw.post_attn_norm is not None:
            y = _rms(y, eps) * lw.post_attn_norm[l]
        x = x + y
        h2 = _bf16r(_rms(x, eps) * lw.ffn_norm[l])
        gu = _mixed_dot(h2, lw.w_gate_up.q[l], lw.w_gate_up.scale[l])
        g_, u = gu[:, :F], gu[:, F:]
        c = torch.tensor(0.7978845608028654, dtype=torch.float32)
        a = _bf16r(0.5 * g_ * (1.0 + torch.tanh(c * (g_ + 0.044715 * g_ * g_ * g_))) * u)
        y3 = _mixed_dot(a, lw.w_down.q[l], lw.w_down.scale[l])
        if lw.post_ffw_norm is not None:
            y3 = _rms(y3, eps) * lw.post_ffw_norm[l]
        x = x + y3
    h = _bf16r(_rms(x, eps) * w.output_norm)
    logits = _mixed_dot(h, emb.q, emb.scale)
    return torch.argmax(logits, dim=-1).to(torch.int32) if greedy else logits


def _need(t: torch.Tensor, name: str, dtype, shape, device) -> torch.Tensor:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"batched step kernel: {name} must be contiguous {dtype} "
                         f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")
    return t


def decode_step_batch(hp, w, cache, tokens: torch.Tensor, pos: torch.Tensor,
                      consts: BatchConsts, *, greedy: bool = False) -> torch.Tensor:
    """One decode step for B lanes. ``tokens`` and ``pos`` are [B] int32 on
    the weights' device. Writes the K/V rows in place; returns logits
    [B, V] f32 (final softcap not applied) or, with ``greedy``, the lanes'
    argmax ids [B] int32."""
    if not tokens.is_cuda:
        return decode_step_batch_plain(hp, w, cache, tokens, pos, consts, greedy=greedy)
    global launches
    B, S = consts.batch, consts.max_seq
    L, Hkv = w.layers.wqkv.q.shape[0], hp.n_head_kv
    kshape = (L, B, S, Hkv, hp.n_embd_head_k)
    vshape = (L, B, S, Hkv, hp.n_embd_head_v)
    out, ptrs, dims, scalars = step_args("decode_step_batch", hp, w, cache.k, cache.v, kshape,
                                         vshape, tokens, pos, consts, greedy)
    err = _lib().fused_decode_batch_step(ptrs, dims, scalars, _build.stream_of(tokens))
    _build.check("fused_decode_batch", err, "decode_step_batch launch")
    launches += 1
    return out


def step_args(what: str, hp, w, kc, vc, kshape, vshape, tokens, pos, consts: BatchConsts,
              greedy: bool):
    """Check the step's CUDA inputs and lay out the C entry's arguments: the
    output tensor and the pointer, int and float arrays. ``kc``/``vc`` are
    the stacked caches or pools of shapes ``kshape``/``vshape``."""
    if consts.scratch is None:
        raise ValueError(f"{what} kernel: consts were prepared without CUDA scratch")
    dev = tokens.device
    lw = w.layers
    L, Rq, D = lw.wqkv.q.shape
    F, A = lw.w_down.cols, lw.wo.cols
    V = w.token_embd.rows
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
    B, S = consts.batch, consts.max_seq
    sc, plan = consts.scratch, consts.plan
    if V != plan["V"]:
        raise ValueError(f"{what} kernel: prepared for {plan['V']} logits rows, the embedding "
                         f"has {V}")
    if tokens.shape != (B,):
        raise ValueError(f"{what} kernel: prepared for {B} lanes, got tokens "
                         f"{tuple(tokens.shape)}")
    f32, i8, i32 = torch.float32, torch.int8, torch.int32
    pa, pf = lw.post_attn_norm, lw.post_ffw_norm
    nb = consts.inv_freq.shape[0]
    out = (torch.empty(B, dtype=i32, device=dev) if greedy
           else torch.empty((B, V), dtype=f32, device=dev))
    tensors = [
        _need(tokens, "tokens", i32, (B,), dev),
        _need(pos, "pos", i32, (B,), dev),
        _need(consts.base_idx, "base_idx", i32, (L,), dev),
        _need(consts.inv_freq, "inv_freq", f32, (nb, dk // 2), dev),
        _need(lw.attn_norm, "attn_norm", f32, (L, D), dev),
        _need(lw.ffn_norm, "ffn_norm", f32, (L, D), dev),
        _need(lw.q_norm, "q_norm", f32, (L, dk), dev),
        _need(lw.k_norm, "k_norm", f32, (L, dk), dev),
        _need(w.output_norm, "output_norm", f32, (D,), dev),
        None if pa is None else _need(pa, "post_attn_norm", f32, (L, D), dev),
        None if pf is None else _need(pf, "post_ffw_norm", f32, (L, D), dev),
        _need(lw.wqkv.q, "wqkv.q", i8, (L, Rq, D), dev),
        _need(lw.wqkv.scale, "wqkv.scale", f32, (L, Rq, 1), dev),
        _need(lw.wo.q, "wo.q", i8, (L, D, A), dev),
        _need(lw.wo.scale, "wo.scale", f32, (L, D, 1), dev),
        _need(lw.w_gate_up.q, "w_gate_up.q", i8, (L, 2 * F, D), dev),
        _need(lw.w_gate_up.scale, "w_gate_up.scale", f32, (L, 2 * F, 1), dev),
        _need(lw.w_down.q, "w_down.q", i8, (L, D, F), dev),
        _need(lw.w_down.scale, "w_down.scale", f32, (L, D, 1), dev),
        _need(w.token_embd.q, "token_embd.q", i8, (V, D), dev),
        _need(w.token_embd.scale, "token_embd.scale", f32, (V, 1), dev),
        _need(kc, "K cache", torch.bfloat16, kshape, dev),
        _need(vc, "V cache", torch.bfloat16, vshape, dev),
        out, sc["x"], sc["h"], sc["act"], sc["part"], sc["qb"], sc["scores"], sc["cmax"],
        sc["pl"], sc["pacc"], sc["best_v"], sc["best_i"],
    ]
    assert len(tensors) == _PTR_FIELDS
    # 16-byte loads read these from their base
    for t in (lw.wqkv.q, lw.wo.q, lw.w_gate_up.q, lw.w_down.q, w.token_embd.q, kc, vc):
        if t.data_ptr() % 16:
            raise ValueError(f"{what} kernel: weights and caches must start on a 16-byte "
                             "boundary")
    ptrs = (ctypes.c_void_p * _PTR_FIELDS)(*[None if t is None else t.data_ptr()
                                              for t in tensors])
    dims = (ctypes.c_int * _DIM_FIELDS)(
        L, B, D, F, A, Rq, V, S, H, Hkv, dk, dv, plan["ldh"], plan["part_cap"], plan["sq"],
        plan["so"], plan["sd"], plan["sms"], int(greedy), plan["logits_grid"] * B)
    scalars = (ctypes.c_float * 5)(hp.rms_eps, hp.f_attention_scale, hp.attn_soft_cap or 0.0,
                                   hp.rope_freq_scale, math.sqrt(D))
    return out, ptrs, dims, scalars
