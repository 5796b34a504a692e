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
bounds it on the H100 and how the design answers that: the step body of
csrc/whole_step.cuh, shared with every whole step (the rowq8 ones, the
capacity step and the tensor-parallel ones), streams every GEMV phase as
row x column-slab tiles on the tensor cores (csrc/tile_stream.cuh), cut by
``fused_decode_stream.plan`` (a pure function of the shapes, the formats
and the grid) at first launch and kept in the prepared scratch.

Numerics (fused_decode_q.py:22-26, :209-223): each GEMV row is
sum_g s[g] * sum_{c in g} bf16(x_c) * q[c] - off[g] * sum_{c in g} bf16(x_c),
exact f32 scales on f32 group partials; ``decode_step_q_plain`` mirrors it.

``decode_step_q`` launches the kernel for CUDA tensors (or raises) and runs
``decode_step_q_plain`` for CPU tensors. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from ...quant.device import DenseTensor, Q4Tensor, QuantTensor
from . import fused_decode
from .fused_decode import DecodeConsts, step_plain

launches = 0

KERNEL = "fused_decode_q"
_LANE = 128
_MAX_GROUP = 4  # q heads per KV head (csrc/decode_step.cuh kMaxGroup)
_MAX_COLS = 1536  # widest D and H * dv the whole step takes (wider: the capacity step)
_STAGE_BYTES = 36864  # the largest tile stage (fused_decode_stream.plan)
GROUP_SIZES = (16, 32)  # a lane's 16 columns lie in one group


def _row_bytes(p) -> int:
    """Stream bytes of one weight row: its quants, scales (f32, or raw f16)
    and offsets."""
    q = p.cols if isinstance(p, QuantTensor) else p.cols // 2
    return q + p.groups * (p.scale.element_size() + (4 if p.offset is not None else 0))


def decode_q_supported(hp, w) -> bool:
    """Eligibility of the lossless whole step, the counterpart of
    llm_inference_tpu's ``megakernel_q_supported`` (fused_decode_q.py:102-152)
    without its VMEM budget: stacked Gemma-3 layers whose four fused
    projections are group-scaled (an int8 ``QuantTensor`` with more than
    one group a row, or a ``Q4Tensor``) with groups of 16 or 32 columns, a
    dense bf16 tied embedding, q/k norms, no ALiBi, uniform head dims of 128
    or 256. The port's own limits, where the JAX package has a VMEM budget:
    D and H * dv at most 1536 (wider layers take the capacity step, the
    same kernel body at their widths, fused_decode_stream.py),
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
    if not all(isinstance(p, Q4Tensor) or (isinstance(p, QuantTensor) and p.groups > 1)
               for p in parts):
        return False
    emb = w.token_embd
    if not (isinstance(emb, DenseTensor) and emb.w.dtype == torch.bfloat16):
        return False
    if lw.q_norm is None or lw.k_norm is None:
        return False
    if hp.n_embd_head_k != hp.n_embd_head_k_swa or hp.n_embd_head_v != hp.n_embd_head_v_swa:
        return False
    D, F, A = hp.embedding_length, lw.w_down.cols, lw.wo.cols
    if emb.cols != D or lw.w_gate_up.rows != 2 * F or lw.w_down.rows != D or lw.wo.rows != D:
        return False
    return whole_step_fits(hp, D=D, F=F, A=A, Rq=lw.wqkv.rows,
                           parts=[(_row_bytes(p), p.group_size, p.cols) for p in parts])


def step_geometry_fits(hp, *, D: int, F: int, A: int, Rq: int, parts) -> bool:
    """The limits the lossless and capacity steps share (the stream stage,
    the attention registers), from shapes alone: 128-aligned widths, head
    dims of 128 or 256, at most four q heads per KV head, groups of 16 or
    32 columns in whole 4-group scale rows (the bulk copies move 16-byte
    multiples), and one weight row of each phase (gate/up: a pair) within a
    36 KB stage. ``parts``: per phase (QKV, Wo, gate/up, down) the bytes of
    one stream row, its group size and its columns."""
    dk, dv = hp.n_embd_head_k, hp.n_embd_head_v
    if D % _LANE or F % _LANE or A % _LANE or dk not in (128, 256) or dv not in (128, 256):
        return False
    if hp.n_head_kv < 1 or hp.n_head % hp.n_head_kv or hp.n_head // hp.n_head_kv > _MAX_GROUP \
            or A != hp.n_head * dv:
        return False
    for i, (row, gs, cols) in enumerate(parts):
        if gs not in GROUP_SIZES or cols % (4 * gs) or row * (2 if i == 2 else 1) > _STAGE_BYTES:
            return False
    return Rq == hp.n_head * dk + hp.n_head_kv * (dk + dv)


def whole_step_fits(hp, *, D: int, F: int, A: int, Rq: int, parts) -> bool:
    """The geometric limits of ``decode_q_supported``, from shapes alone: the
    counterpart of llm_inference_tpu's ``whole_layer_fits``
    (fused_decode_q.py:64-72), which the engine's capacity decision asks
    from a tensor directory before any load: the shared limits, and D and
    H * dv within 1536 columns (the split between the whole step and the
    capacity step)."""
    return D <= _MAX_COLS and A <= _MAX_COLS and step_geometry_fits(
        hp, D=D, F=F, A=A, Rq=Rq, parts=parts)


def prepare(hp, device, *, swa_mask: bool, max_seq: int = 0) -> DecodeConsts:
    """The step constants on ``device`` (on CUDA with this kernel's scratch
    for caches of up to ``max_seq`` slots)."""
    return fused_decode.prepare(hp, device, swa_mask=swa_mask, max_seq=max_seq, kernel=KERNEL)


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
    y = torch.einsum("rgs,gs->rg", q, hg) * t.scale.float()
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
    from .fused_decode_stream import launch_tiled

    if not decode_q_supported(hp, w):
        raise ValueError("decode_step_q kernel: the weights are not eligible (decode_q_supported)")
    logits = launch_tiled(KERNEL, hp, w, cache, token, pos, consts, profile)
    launches += 1
    return logits
