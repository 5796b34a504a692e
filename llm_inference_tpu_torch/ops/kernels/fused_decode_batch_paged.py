"""Paged batched whole-step decode: the CUDA kernels and the plain twin.

Replaces llm_inference_tpu/ops/pallas/fused_decode_batch_paged.py::
decode_step_megakernel_batch_paged for a Gemma-3 checkpoint: the batched
step of fused_decode_batch.py (same weights, rounding points and in-kernel
argmax) over K/V kept in a shared page pool instead of dense lanes. The
pools are stacked ``[L, P1, PAGE, Hkv, d]`` bf16 whose last row ``P1 - 1``
is the trash page; ``table`` ``[B, NB]`` int32 maps each lane's blocks of
``PAGE`` slots to pool rows, unmapped entries holding the trash row's id.

The TPU wrapper's rules (fused_decode_batch_paged.py:563-571) hold: a lane
parked at a position outside ``[0, NB * PAGE)`` runs at position 0, table
entries are clipped into ``[0, P1 - 1]`` (so a parked lane's row write lands
in the trash page), and a lane reads its blocks up to ``pos // PAGE``. The
kernels are csrc/fused_decode_batch.cu's, instantiated with paged row
addressing (its source note says how); the per-step row clip happens there,
not as a host op.

``decode_step_batch_paged`` launches the step for CUDA tensors (or raises)
and runs ``decode_step_batch_paged_plain`` for CPU tensors; ``launches``
counts launched steps. The step's constants come from
``fused_decode_batch.prepare_batch`` with ``max_seq = NB * PAGE``.
"""

from __future__ import annotations

import torch

from . import _build, fused_decode_batch
from .fused_decode_batch import BatchConsts, clamp_positions, step_plain

launches = 0


def batch_paged_supported(hp, w, *, batch: int, nb: int, page: int) -> bool:
    """Eligibility: the dense batched step's (``batch_supported``: stacked
    rowq8 Gemma-3 layers, at most 64 lanes, ...) over ``nb * page`` slots a
    lane, a page a positive multiple of 16 and at least one block. The
    TPU kernel's VMEM budget for whole lane buffers has no counterpart: the
    kernels read pool rows in place."""
    if page <= 0 or page % 16 or nb < 1:
        return False
    return fused_decode_batch.batch_supported(hp, w, batch=batch, max_seq=nb * page)


def _pool_rows(table: torch.Tensor, p1: int, page: int, slots: torch.Tensor) -> torch.Tensor:
    """Flat pool rows of each lane's ``slots`` ([B, n] int64), table ids
    clipped into the pool."""
    blk = torch.gather(table.long(), 1, torch.div(slots, page, rounding_mode="floor"))
    return blk.clamp(0, p1 - 1) * page + slots % page


def decode_step_batch_paged_plain(hp, w, kpool, vpool, table, tokens, pos,
                                  consts: BatchConsts, *, greedy: bool = False) -> torch.Tensor:
    """Plain torch version of the paged step, with the kernels' rounding
    points: the dense twin's arithmetic reading and writing pool rows."""
    L, p1, page = kpool.shape[:3]
    B, nb = table.shape
    p = clamp_positions(pos, nb * page).long()
    kflat = kpool.view(L, p1 * page, *kpool.shape[3:])
    vflat = vpool.view(L, p1 * page, *vpool.shape[3:])
    wrow = _pool_rows(table, p1, page, p[:, None])[:, 0]
    n = int(p.max()) + 1
    rows = _pool_rows(table, p1, page, torch.arange(n, device=tokens.device).expand(B, n))

    def kv(l, k, v, n_):
        kflat[l, wrow] = k.to(kflat.dtype)
        vflat[l, wrow] = v.to(vflat.dtype)
        return kflat[l, rows], vflat[l, rows]

    return step_plain(hp, w, tokens, p, consts, kv, greedy=greedy)


def decode_step_batch_paged(hp, w, kpool: torch.Tensor, vpool: torch.Tensor, table: torch.Tensor,
                            tokens: torch.Tensor, pos: torch.Tensor, consts: BatchConsts, *,
                            greedy: bool = False) -> torch.Tensor:
    """One decode step for B lanes over paged K/V. ``tokens``, ``pos`` [B]
    and ``table`` [B, NB] are int32 on the weights' device. Writes each
    lane's K/V row into its page in place; returns logits [B, V] f32 (final
    softcap not applied) or, with ``greedy``, the lanes' argmax ids [B]
    int32."""
    if kpool.ndim != 5 or vpool.shape[:3] != kpool.shape[:3] or table.ndim != 2:
        raise ValueError(f"decode_step_batch_paged: pools {tuple(kpool.shape)}, "
                         f"{tuple(vpool.shape)}, table {tuple(table.shape)}")
    if not tokens.is_cuda:
        return decode_step_batch_paged_plain(hp, w, kpool, vpool, table, tokens, pos, consts,
                                             greedy=greedy)
    global launches
    L, p1, page = kpool.shape[:3]
    B, nb = table.shape
    if consts.batch != B or consts.max_seq != nb * page:
        raise ValueError(f"decode_step_batch_paged kernel: prepared for {consts.batch} lanes of "
                         f"{consts.max_seq} slots, the table holds {B} lanes of {nb} x {page}")
    if table.dtype != torch.int32 or table.device != tokens.device or not table.is_contiguous():
        raise ValueError("decode_step_batch_paged kernel: table must be contiguous int32 on "
                         f"{tokens.device}")
    Hkv = hp.n_head_kv
    kshape = (L, p1, page, Hkv, hp.n_embd_head_k)
    vshape = (L, p1, page, Hkv, hp.n_embd_head_v)
    out, ptrs, dims, scalars = fused_decode_batch.step_args(
        "decode_step_batch_paged", hp, w, kpool, vpool, kshape, vshape, tokens, pos, consts,
        greedy)
    lib = fused_decode_batch._lib()
    err = lib.fused_decode_batch_paged_step(ptrs, dims, scalars, _build.ptr(table), nb, page, p1,
                                            _build.stream_of(tokens))
    _build.check("fused_decode_batch", err, "decode_step_batch_paged launch")
    launches += 1
    return out
