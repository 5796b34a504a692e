"""Device-resident weights for the serve-q8 path: per-row int8 + f32 scales.

Counterpart of llm_inference_tpu/quant/device.py, first part: the rowwise
``QuantTensor`` (one scale group per row, so the group-strided column
order of the JAX class is the identity), ``DenseTensor`` and
``requantize_rowwise``.

    W[r, c] ~= scale[r] * q[r, c]        q int8 [rows, cols], scale f32 [rows, 1]

``requantize_rowwise`` reproduces the JAX package's default route
(quant/device.py:253-294 with the native ``dequant_bf16``): the exact f32
dequant of the checkpoint's blocks, rounded to bf16 (round-to-nearest-even),
then amax/127 per row, ``rint`` and clip to [-127, 127]. The whole chain
runs with torch ops on the target device where the format has a torch
decoder here (F32/F16/BF16/Q4_0/Q8_0): ``torch.round`` rounds half to even
like ``np.rint`` and IEEE f32 division is correctly rounded on both, so the
result is bit-equal to the host route while a 1B checkpoint loads in
seconds. Other formats decode on the host with quant/layouts.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..gguf.constants import GGMLType
from . import layouts


@dataclasses.dataclass
class QuantTensor:
    """Per-row int8 weight (``requantize_rowwise``): ``q`` int8 [rows, cols],
    ``scale`` f32 [rows, 1]. One group per row."""

    q: torch.Tensor
    scale: torch.Tensor
    fmt: GGMLType
    rows: int
    cols: int

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        """[rows, cols] in ``dtype``: q * scale in f32, then cast."""
        return (self.q.float() * self.scale).to(dtype)


@dataclasses.dataclass
class DenseTensor:
    """Unquantized 2-D weight (F16/BF16/F32) in its native dtype."""

    w: torch.Tensor
    fmt: GGMLType
    rows: int
    cols: int


_DENSE_DTYPE = {
    GGMLType.F16: torch.float16,
    GGMLType.BF16: torch.bfloat16,
    GGMLType.F32: torch.float32,
}


def _f16_field(b: torch.Tensor, lo: int) -> torch.Tensor:
    """Little-endian f16 at byte offset ``lo`` of each block, as f32."""
    return b[..., lo : lo + 2].contiguous().view(torch.float16)[..., 0].float()


def _dequant_torch(raw: torch.Tensor, fmt: GGMLType, rows: int, cols: int):
    """Exact f32 dequant with torch ops on ``raw``'s device, for the formats
    that have a torch decoder here; None otherwise. Same values as
    quant/layouts.py (each product of a small integer and an f16 scale is
    exact in f32)."""
    if fmt in _DENSE_DTYPE:
        return raw.view(_DENSE_DTYPE[fmt]).reshape(rows, cols).float()
    if fmt == GGMLType.Q4_0:
        b = raw.reshape(rows, cols // 32, 18)
        qs = b[..., 2:].to(torch.int16)
        q = torch.cat([qs & 0x0F, qs >> 4], dim=-1) - 8
        return (q.float() * _f16_field(b, 0)[..., None]).reshape(rows, cols)
    if fmt == GGMLType.Q8_0:
        b = raw.reshape(rows, cols // 32, 34)
        q = b[..., 2:].contiguous().view(torch.int8)
        return (q.float() * _f16_field(b, 0)[..., None]).reshape(rows, cols)
    return None


def requantize_rowwise(
    fmt: GGMLType, raw: np.ndarray, rows: int, cols: int, *, device="cpu"
) -> QuantTensor:
    """Requantize any GGUF weight to per-row int8 on ``device``:
    W[r, c] ~= row_scale[r] * q8[r, c] (serve-mode trade, never parity)."""
    fmt = GGMLType(fmt)
    device = torch.device(device)
    raw_t = torch.from_numpy(np.array(raw, dtype=np.uint8)).to(device)  # mmap views are read-only
    w = _dequant_torch(raw_t, fmt, rows, cols)
    if w is None:
        w = torch.from_numpy(layouts.dequantize(raw, fmt, rows, cols)).to(device)
    del raw_t
    w = w.to(torch.bfloat16).float()  # the native route's RNE bf16 rounding
    amax = w.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    w.div_(scale[:, None]).round_().clamp_(-127, 127)
    return QuantTensor(q=w.to(torch.int8), scale=scale[:, None].contiguous(),
                       fmt=fmt, rows=rows, cols=cols)
