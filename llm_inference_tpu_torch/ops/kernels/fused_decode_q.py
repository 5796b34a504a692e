"""Lossless whole-step decode: the CUDA kernel (csrc/fused_decode_q.cu) and
its plain twin.

Replaces llm_inference_tpu/ops/pallas/fused_decode_q.py::
decode_step_megakernel_q for a Gemma-3 checkpoint served in serve-q or
serve-q4: one call runs the entire single-token forward over the stacked
group-scaled layer weights (int8 ``QuantTensor`` or nibble ``Q4Tensor``,
each projection in its own format and group size) and the dense bf16 tied
embedding, returns the logits [V] (f32, final softcap left to the caller)
and writes the token's bf16 K/V rows in place at slot ``pos`` of the stacked
cache. The weights stay in the port's one layout (quant/device.py): no
masked-dot repack. The source note in csrc/fused_decode_q.cu says what
bounds it on the H100 and how the design answers that; the persistent
cooperative skeleton is csrc/decode_step.cuh, shared with the per-row int8
step (ops/kernels/fused_decode.py).

Numerics (fused_decode_q.py:22-26, :209-223): each GEMV row is
sum_g s[g] * sum_{c in g} bf16(x_c) * q[c] - off[g] * sum_{c in g} bf16(x_c),
exact f32 scales on f32 group partials; ``decode_step_q_plain`` mirrors it.

``decode_step_q`` launches the kernel for CUDA tensors (or raises) and runs
``decode_step_q_plain`` for CPU tensors. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...quant.device import DenseTensor, Q4Tensor, QuantTensor
from . import _build
from .fused_decode import (DecodeConsts, PROFILE_MARKS, _need, prepare as _prepare, step_lib,
                           step_plain)

launches = 0

KERNEL = "fused_decode_q"
_LANE = 128
_MAX_GROUP = 4  # q heads per KV head (csrc/decode_step.cuh kMaxGroup)
_MAX_REG_COLS = 1536  # widest activation a lane holds in registers (kMaxRegCols)
_STAGE_BYTES = 36864  # one weight-stream stage (kStageBytes)
GROUP_SIZES = (16, 32)  # a lane's 16 columns lie in one group
_FMT = {QuantTensor: 0, Q4Tensor: 1, DenseTensor: 2}


def _row_bytes(p) -> int:
    """Stream bytes of one weight row: its quants, scales and offsets."""
    q = p.cols if isinstance(p, QuantTensor) else p.cols // 2
    return q + 4 * p.groups * (2 if p.offset is not None else 1)


def decode_q_supported(hp, w) -> bool:
    """Eligibility of the lossless whole step, the counterpart of
    llm_inference_tpu's ``megakernel_q_supported`` (fused_decode_q.py:102-152)
    without its VMEM budget: stacked Gemma-3 layers whose four fused
    projections are group-scaled (an int8 ``QuantTensor`` with more than
    one group a row, or a ``Q4Tensor``) with groups of 16 or 32 columns, a
    dense bf16 tied embedding, q/k norms, no ALiBi, uniform head dims of 128
    or 256. The port's own limits, where the JAX package has a VMEM budget:
    D and H * dv at most 1536 (a lane holds the activation in registers),
    at most four q heads per KV head, 128-aligned widths, a whole number of
    4-group scale rows (the bulk copies move 16-byte multiples) and one
    weight row of each phase (gate/up: a pair) within a 36 KB stream stage."""
    from ...models.weights import LayerWeights

    lw = w.layers
    if not isinstance(lw, LayerWeights) or hp.architecture != "gemma3":
        return False
    if hp.f_max_alibi_bias > 0.0 or hp.embedding_length_per_layer:
        return False
    parts = [lw.wqkv, lw.wo, lw.w_gate_up, lw.w_down]
    for p in parts:
        if not (isinstance(p, Q4Tensor) or (isinstance(p, QuantTensor) and p.groups > 1)):
            return False
        if p.group_size not in GROUP_SIZES or p.cols % (4 * p.group_size):
            return False
    emb = w.token_embd
    if not (isinstance(emb, DenseTensor) and emb.w.dtype == torch.bfloat16):
        return False
    if lw.q_norm is None or lw.k_norm is None:
        return False
    if hp.n_embd_head_k != hp.n_embd_head_k_swa or hp.n_embd_head_v != hp.n_embd_head_v_swa:
        return False
    D, F, A = hp.embedding_length, lw.w_down.cols, lw.wo.cols
    dk, dv = hp.n_embd_head_k, hp.n_embd_head_v
    if D % _LANE or F % _LANE or A % _LANE or dk not in (128, 256) or dv not in (128, 256):
        return False
    if D > _MAX_REG_COLS or A > _MAX_REG_COLS or emb.cols != D:
        return False
    if hp.n_head % hp.n_head_kv or hp.n_head // hp.n_head_kv > _MAX_GROUP or A != hp.n_head * dv:
        return False
    if lw.w_gate_up.rows != 2 * F or lw.w_down.rows != D or lw.wo.rows != D:
        return False
    if any(_row_bytes(p) * (2 if p is lw.w_gate_up else 1) > _STAGE_BYTES for p in parts):
        return False
    return lw.wqkv.rows == hp.n_head * dk + hp.n_head_kv * (dk + dv)


def prepare(hp, device, *, swa_mask: bool, max_seq: int = 0) -> DecodeConsts:
    """The step constants on ``device`` (on CUDA with this kernel's scratch)."""
    return _prepare(hp, device, swa_mask=swa_mask, max_seq=max_seq, kernel=KERNEL)


def _group_dot(t, l, h: torch.Tensor) -> torch.Tensor:
    """The lossless GEMV of layer ``l`` (the embedding for None) on the
    bf16-rounded activation ``h`` [C]: exact f32 scales on f32 group
    partials, minus the offsets times the activation's group sums."""
    from ...models.weights import weight_layer

    if isinstance(t, DenseTensor):
        return h @ t.w.float().T
    t = weight_layer(t, l)
    q = t.quants() if isinstance(t, Q4Tensor) else t.q
    q = q.float().unflatten(-1, (t.groups, t.group_size))  # [R, G, gs]
    hg = h.reshape(t.groups, t.group_size)
    y = torch.einsum("rgs,gs->rg", q, hg) * t.scale
    if t.offset is not None:
        y = y - t.offset * hg.sum(dim=-1)
    return y.sum(dim=-1)


def _dense_embed(emb, tok: int) -> torch.Tensor:
    return emb.w[tok].float()


def decode_step_q_plain(hp, w, cache, token, pos, consts: DecodeConsts) -> torch.Tensor:
    """Plain torch version of the kernel, with the same rounding points."""
    return step_plain(hp, w, cache, token, pos, consts, _group_dot, _dense_embed)


def decode_step_q(hp, w, cache, token: torch.Tensor, pos: torch.Tensor,
                  consts: DecodeConsts, profile: torch.Tensor | None = None) -> torch.Tensor:
    """One lossless single-token decode step. ``token`` (int64) and ``pos``
    (int32) are one-element tensors on the weights' device; ``consts`` come
    from ``prepare``. Writes the K/V rows in place; returns logits [V] f32
    (final softcap not applied). ``profile`` as in
    ``fused_decode.decode_step``."""
    if not token.is_cuda:
        return decode_step_q_plain(hp, w, cache, token, pos, consts)
    global launches
    if consts.scratch is None:
        raise ValueError("decode_step_q kernel: consts were prepared without CUDA scratch")
    if not decode_q_supported(hp, w):
        raise ValueError("decode_step_q kernel: the weights are not eligible (decode_q_supported)")
    dev = token.device
    lw = w.layers
    L = lw.attn_norm.shape[0]
    D, F, A, Rq = hp.embedding_length, lw.w_down.cols, lw.wo.cols, lw.wqkv.rows
    V = w.token_embd.rows
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
    S = cache.k.shape[1]
    if -(-S // consts.grid) > consts.max_chunk:
        raise ValueError(f"decode_step_q kernel: cache of {S} slots exceeds the prepared scratch")
    f32, i32 = torch.float32, torch.int32
    pa, pf = lw.post_attn_norm, lw.post_ffw_norm
    sc = consts.scratch
    nb = consts.inv_freq.shape[0]
    logits = torch.empty(V, dtype=f32, device=dev)
    if profile is not None:
        _need(profile, "profile", torch.int64, (L * PROFILE_MARKS + 3,), dev)
    step = [
        _need(token, "token", torch.int64, (1,), dev),
        _need(pos, "pos", i32, (1,), dev),
        _need(consts.base_idx, "base_idx", i32, (L,), dev),
        _need(consts.windows, "windows", i32, (L,), dev),
        _need(consts.inv_freq, "inv_freq", f32, (nb, dk // 2), dev),
        _need(lw.attn_norm, "attn_norm", f32, (L, D), dev),
        _need(lw.ffn_norm, "ffn_norm", f32, (L, D), dev),
        _need(lw.q_norm, "q_norm", f32, (L, dk), dev),
        _need(lw.k_norm, "k_norm", f32, (L, dk), dev),
        _need(w.output_norm, "output_norm", f32, (D,), dev),
        None if pa is None else _need(pa, "post_attn_norm", f32, (L, D), dev),
        None if pf is None else _need(pf, "post_ffw_norm", f32, (L, D), dev),
        _need(cache.k, "cache.k", torch.bfloat16, (L, S, Hkv, dk), dev),
        _need(cache.v, "cache.v", torch.bfloat16, (L, S, Hkv, dv), dev),
        logits, sc["qkv"], sc["part"], sc["y_attn"], sc["act"], sc["y_ffn"], sc["barrier"],
        profile,
    ]
    wts, info = [], []
    for name, t in (("wqkv", lw.wqkv), ("wo", lw.wo), ("w_gate_up", lw.w_gate_up),
                    ("w_down", lw.w_down), ("token_embd", w.token_embd)):
        lead = () if name == "token_embd" else (L,)
        if isinstance(t, DenseTensor):
            wts += [_need(t.w, name, torch.bfloat16, (t.rows, t.cols), dev), None, None]
            info += [_FMT[DenseTensor], 0, 0]
            continue
        q4 = isinstance(t, Q4Tensor)
        q = _need(t.packed, f"{name}.packed", torch.uint8, (*lead, t.rows, t.cols // 2), dev) \
            if q4 else _need(t.q, f"{name}.q", torch.int8, (*lead, t.rows, t.cols), dev)
        gshape = (*lead, t.rows, t.groups)
        wts += [q, _need(t.scale, f"{name}.scale", f32, gshape, dev),
                None if t.offset is None else _need(t.offset, f"{name}.offset", f32, gshape, dev)]
        info += [_FMT[type(t)], t.group_size, int(q4 and t.centered)]
    # bulk copies and 16-byte loads read these from their base
    if any(t is not None and t.data_ptr() % 16 for t in wts + [cache.k, cache.v]):
        raise ValueError("decode_step_q kernel: weights and caches must start on a 16-byte "
                         "boundary")
    ptrs = (ctypes.c_void_p * len(step))(*[None if t is None else t.data_ptr() for t in step])
    wptrs = (ctypes.c_void_p * len(wts))(*[None if t is None else t.data_ptr() for t in wts])
    dims = (ctypes.c_int * 12)(L, D, F, A, Rq, V, S, H, Hkv, dk, dv, consts.max_chunk)
    scalars = (ctypes.c_float * 5)(hp.rms_eps, hp.f_attention_scale,
                                   hp.attn_soft_cap or 0.0, hp.rope_freq_scale, math.sqrt(D))
    winfo = (ctypes.c_int * len(info))(*info)
    fn = step_lib(KERNEL).fused_decode_q_step
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    err = fn(ptrs, dims, scalars, wptrs, winfo, consts.grid, _build.stream_of(token))
    _build.check(KERNEL, err, "decode_step_q launch")
    launches += 1
    return logits
