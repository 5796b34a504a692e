"""Tensor-parallel lossless whole-step decode: the CUDA kernel
(csrc/fused_decode_q_tp.cu) and its plain twin.

Replaces llm_inference_tpu/ops/pallas/fused_decode_q_tp.py::
decode_step_megakernel_q_tp for a Gemma-3 checkpoint served in serve-q or
serve-q4: the ranks of fused_decode_tp.py (the same mesh, all-reduces,
cache replicas and launch) running the single-chip lossless step's tiled
body (each rank streams its shards as tiles of its own plan,
``fused_decode_stream.plan`` over the rank's widths and blocks) over shards
of the lossless weights
(``shard_lossless_for_tp``): int8 ``QuantTensor`` or nibble ``Q4Tensor``
parts with their f32 group scales and Q4_K offsets, in the port's one
logical-order layout, and V / n rows of the dense bf16 embedding. The
numerics are the single-chip lossless step's (fused_decode_q.py).

The contraction shards of Wo and w_down cut whole groups of 16 or 32
columns (their scales and offsets with them), where the TPU kernel, over
its masked-dot layout, cuts whole contraction blocks.

``decode_step_q_tp`` launches the kernel for CUDA tensors (or raises) and
runs ``decode_step_q_tp_plain`` for CPU tensors; ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from .fused_decode_q import (_dense_embed, _group_dot, _row_bytes, decode_q_supported,
                             step_geometry_fits)
from .fused_decode_tp import (LANE, TPConsts, TPWeights, prepare as _prepare, run_tp, shard_for_tp,
                              split_ok, tp_step_plain)

launches = 0

KERNEL = "fused_decode_q_tp"
_LOGITS_TILE = 4096  # the TPU kernel's logits tile (its fused_decode.py _LOGITS_TILE)


def tp_decode_q_supported(hp, w, n: int) -> bool:
    """Eligibility, the counterpart of llm_inference_tpu's
    ``tp_megakernel_q_supported`` (fused_decode_q_tp.py:58-99): the
    single-chip lossless step's (``fused_decode_q.decode_q_supported``) and
    the TPU gate's splits: fused_decode_tp.split_ok, Hl * dk lanes a
    multiple of 128, Fl = F / n a multiple of 128, V / n a multiple of 128
    and of the TPU kernel's 4096-row logits tile where above it. Where the
    TPU gate asks Wo's and w_down's contraction shards (Hl * dv, Fl
    columns) to cut whole masked-dot blocks, this one asks whole groups,
    in whole 4-group scale rows (csrc/tile_stream.cuh's tensor copies): the port
    has no masked-dot repack. Each rank's shard must also fit the step's
    stream stage (``fused_decode_q.step_geometry_fits``)."""
    if not decode_q_supported(hp, w):
        return False
    lw = w.layers
    F, V = lw.w_down.cols, w.token_embd.rows
    if not split_ok(hp, V, F, n):
        return False
    H, dk, dv = hp.n_head, hp.n_embd_head_k, hp.n_embd_head_v
    Hl, Fl, Vl = H // n, F // n, V // n
    if (Hl * dk) % LANE or Fl % LANE:
        return False
    if (Hl * dv) % (4 * lw.wo.group_size) or Fl % (4 * lw.w_down.group_size):
        return False
    if Vl > _LOGITS_TILE and Vl % _LOGITS_TILE:
        return False
    A = H * dv
    rows = [_row_bytes(lw.wqkv), _row_bytes(lw.wo) // n, _row_bytes(lw.w_gate_up),
            _row_bytes(lw.w_down) // n]
    cols = (hp.embedding_length, Hl * dv, hp.embedding_length, Fl)
    parts = [(r, t.group_size, c) for r, t, c in zip(
        rows, (lw.wqkv, lw.wo, lw.w_gate_up, lw.w_down), cols)]
    return step_geometry_fits(hp, D=hp.embedding_length, F=Fl, A=A, Rq=lw.wqkv.rows, parts=parts)


# the counterpart of the JAX package's shard_maskdot_for_tp
# (fused_decode_q_tp.py:125-197), in the port's logical order: Wo and
# w_down columns on whole groups, their scales and offsets with them
shard_lossless_for_tp = shard_for_tp


def prepare(hp, tw: TPWeights, *, swa_mask: bool, max_seq: int = 0) -> TPConsts:
    """The step constants of each rank (on CUDA with this kernel's scratch
    for caches of up to ``max_seq`` slots)."""
    return _prepare(hp, tw, swa_mask=swa_mask, max_seq=max_seq, kernel=KERNEL)


def decode_step_q_tp_plain(hp, tw: TPWeights, caches: list, token, pos,
                           consts: TPConsts) -> torch.Tensor:
    """Plain torch version of the kernel, with the same rounding points."""
    return tp_step_plain(hp, tw, caches, token, pos, consts, _group_dot, _dense_embed)


def decode_step_q_tp(hp, tw: TPWeights, caches: list, token: torch.Tensor, pos: torch.Tensor,
                     consts: TPConsts, profile: torch.Tensor | None = None) -> torch.Tensor:
    """One tensor-parallel lossless single-token decode step, as
    ``fused_decode_tp.decode_step_tp``."""
    if not token.is_cuda:
        return decode_step_q_tp_plain(hp, tw, caches, token, pos, consts)
    global launches
    logits = run_tp(hp, tw, caches, token, pos, consts, KERNEL, profile)
    launches += len(consts.groups)
    return logits


__all__ = ["decode_step_q_tp", "decode_step_q_tp_plain", "prepare", "shard_lossless_for_tp",
           "tp_decode_q_supported"]
