"""Rowwise quantized matmul: the CUDA kernel (csrc/qmatmul.cu) and its plain twin.

Replaces llm_inference_tpu/ops/pallas/qmatmul.py::quant_matmul, rowwise
branch: y[T, R] = (bf16(x) . q^T, f32 accumulation) * scale, T <= 64, for a
per-row int8 ``QuantTensor``. The source note in csrc/qmatmul.cu says what
bounds it on the H100 and how the design answers that.

``quant_matmul`` launches the kernel for a CUDA tensor (or raises) and runs
``quant_matmul_plain`` for a CPU tensor. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...quant.device import QuantTensor
from . import _build

MAX_T = 64
_LANE = 128
_ROWS_PER_BLOCK = 64  # csrc/qmatmul.cu kRowsPerBlock
_CHUNK = 64           # csrc/qmatmul.cu kChunk
_BLOCKS_PER_SM = 4    # blocks the C split aims for, so every SM streams weights

launches = 0


def _splits(rows: int, cols: int, sms: int) -> int:
    """Blocks to split C over: enough for ``_BLOCKS_PER_SM`` blocks an SM,
    at least two 64-column chunks a split."""
    row_blocks = -(-rows // _ROWS_PER_BLOCK)
    want = -(-_BLOCKS_PER_SM * sms // row_blocks)
    return max(1, min(want, cols // (2 * _CHUNK)))


def supports_kernel(qt: QuantTensor, t: int) -> bool:
    """Can the kernel take this weight and token count? (the CUDA twin of
    llm_inference_tpu's ``supports_pallas`` for the rowwise branch)."""
    return isinstance(qt, QuantTensor) and 1 <= t <= MAX_T and qt.cols % _LANE == 0


def quant_matmul_plain(qt: QuantTensor, x: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the same products and f32 sums, another order."""
    xb = x.float().to(torch.bfloat16).float()
    return (xb @ qt.q.float().T) * qt.scale[:, 0][None, :]


def quant_matmul(qt: QuantTensor, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W^T over a rowwise QuantTensor. x: [T, C] -> [T, R] f32."""
    if x.ndim != 2 or x.shape[-1] != qt.cols:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} vs weight cols {qt.cols}")
    if not x.is_cuda:
        return quant_matmul_plain(qt, x)
    global launches
    T = x.shape[0]
    if not supports_kernel(qt, T):
        raise ValueError(f"quant_matmul kernel: T={T} (max {MAX_T}), cols={qt.cols} "
                         f"(multiple of {_LANE})")
    for name, t, dtype in (("q", qt.q, torch.int8), ("scale", qt.scale, torch.float32)):
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"quant_matmul kernel: {name} must be contiguous {dtype} "
                             f"on {x.device}")
    if qt.q.shape != (qt.rows, qt.cols) or qt.scale.shape != (qt.rows, 1):
        raise ValueError("quant_matmul kernel: weight shapes disagree with rows/cols")
    x = x.float().contiguous()
    if qt.q.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("quant_matmul kernel: q and x must start on a 16-byte boundary")
    R, C = qt.rows, qt.cols
    splits = _splits(R, C, torch.cuda.get_device_properties(x.device).multi_processor_count)
    y = torch.empty((T, R), dtype=torch.float32, device=x.device)
    part = torch.empty((splits, T, R), dtype=torch.float32, device=x.device) if splits > 1 else None
    lib = _build.library("qmatmul")
    fn = lib.qmatmul_rowwise
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_build.ptr(x), _build.ptr(qt.q), _build.ptr(qt.scale), _build.ptr(y),
             None if part is None else _build.ptr(part), T, R, C, splits, _build.stream_of(x))
    _build.check("qmatmul", err, "quant_matmul launch")
    launches += 1
    return y
