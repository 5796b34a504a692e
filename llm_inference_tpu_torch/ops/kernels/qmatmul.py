"""Quantized matmul: the CUDA kernels (csrc/qmatmul.cu) and their plain twins.

Replaces llm_inference_tpu/ops/pallas/qmatmul.py, T <= 64:

  - ``quant_matmul`` over a per-row int8 ``QuantTensor`` (the rowwise branch
    of the TPU kernel): y[T, R] = (bf16(x) . q^T, f32 accumulation) * scale;
  - ``quant_matmul`` over a grouped int8 ``QuantTensor`` (its grouped branch,
    qmatmul.py:65-94) and ``q4_matmul`` over a nibble-packed ``Q4Tensor``
    (qmatmul.py:143-210): the weight dequantized in bf16 as the TPU kernels
    form it, bf16(bf16(q) * bf16(scale)) - bf16(offset), rounded to bf16,
    then y = bf16(x) . w^T with f32 accumulation.

The source note in csrc/qmatmul.cu says what bounds them on the H100 and how
the design answers that. A grouped weight never reaches the rowwise
kernel: ``quant_matmul`` dispatches on ``groups``.

``quant_matmul``/``q4_matmul`` launch a kernel for a CUDA tensor (or raise)
and run the plain twin for a CPU tensor. ``launches`` counts the rowwise
kernel's launches, ``grouped_launches`` the grouped int8 one's and
``q4_launches`` the nibble one's.
"""

from __future__ import annotations

import ctypes

import torch

from ...quant.device import Q4Tensor, QuantTensor
from . import _build

MAX_T = 64
_LANE = 128
_ROWS_PER_BLOCK = 64  # csrc/qmatmul.cu kRowsPerBlock
_CHUNK = 64           # csrc/qmatmul.cu kChunk
_BLOCKS_PER_SM = 4    # blocks the C split aims for, so every SM streams weights
GROUP_SIZES = (16, 32)  # a lane's 16 columns lie in one group

launches = 0
grouped_launches = 0
q4_launches = 0


def _splits(rows: int, cols: int, sms: int) -> int:
    """Blocks to split C over: enough for ``_BLOCKS_PER_SM`` blocks an SM,
    at least two 64-column chunks a split."""
    row_blocks = -(-rows // _ROWS_PER_BLOCK)
    want = -(-_BLOCKS_PER_SM * sms // row_blocks)
    return max(1, min(want, cols // (2 * _CHUNK)))


def supports_kernel(qt, t: int) -> bool:
    """Can a kernel take this weight and token count? (the CUDA twin of
    llm_inference_tpu's ``supports_pallas``, without its VMEM budget)."""
    if not isinstance(qt, (QuantTensor, Q4Tensor)) or not 1 <= t <= MAX_T or qt.cols % _LANE:
        return False
    return (isinstance(qt, QuantTensor) and qt.groups == 1) or qt.group_size in GROUP_SIZES


def _bf16r(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).float()


def dequant_bf16_tpu(q: torch.Tensor, qt) -> torch.Tensor:
    """The grouped TPU kernels' bf16 weight [R, C]: bf16(bf16(q) * bf16(s))
    - bf16(off), each step rounded to bf16 (qmatmul.py:85-87, :152-160)."""
    s = qt.scale.to(torch.bfloat16)
    w = q.to(torch.bfloat16).unflatten(-1, (qt.groups, qt.group_size)) * s[..., None]
    if qt.offset is not None:
        w = w - qt.offset.to(torch.bfloat16)[..., None]
    return w.flatten(-2)


def quant_matmul_plain(qt: QuantTensor, x: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the same products and f32 sums, another order."""
    xb = _bf16r(x.float())
    if qt.groups == 1:
        return (xb @ qt.q.float().T) * qt.scale[:, 0][None, :]
    return xb @ dequant_bf16_tpu(qt.q, qt).float().T


def q4_matmul_plain(qt: Q4Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the nibble kernel."""
    return _bf16r(x.float()) @ dequant_bf16_tpu(qt.quants(), qt).float().T


def _check(name: str, qt, x: torch.Tensor, fields) -> int:
    """Raise unless the kernel takes these arguments; the device's SM count."""
    T = x.shape[0]
    if not supports_kernel(qt, T):
        raise ValueError(f"{name} kernel: T={T} (max {MAX_T}), cols={qt.cols} (multiple of "
                         f"{_LANE}), group size {qt.group_size} (one row or {GROUP_SIZES})")
    for fname, t, dtype, shape in fields:
        if t is None:
            continue
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(f"{name} kernel: {fname} must be contiguous {dtype} {shape} "
                             f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def _launch(qt, x: torch.Tensor, qdata: torch.Tensor, sms: int, *, nibble: bool) -> torch.Tensor:
    T, (R, C) = x.shape[0], (qt.rows, qt.cols)
    if qdata.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("quant_matmul kernel: the quants and x must start on a 16-byte boundary")
    splits = _splits(R, C, sms)
    y = torch.empty((T, R), dtype=torch.float32, device=x.device)
    part = torch.empty((splits, T, R), dtype=torch.float32, device=x.device) if splits > 1 else None
    part_p = None if part is None else _build.ptr(part)
    lib = _build.library("qmatmul")
    if qt.groups == 1 and isinstance(qt, QuantTensor):
        fn = lib.qmatmul_rowwise
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(_build.ptr(x), _build.ptr(qdata), _build.ptr(qt.scale), _build.ptr(y), part_p,
                 T, R, C, splits, _build.stream_of(x))
    else:
        fn = lib.qmatmul_grouped
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        off = None if qt.offset is None else _build.ptr(qt.offset)
        err = fn(_build.ptr(x), _build.ptr(qdata), _build.ptr(qt.scale), off, _build.ptr(y),
                 part_p, T, R, C, qt.group_size, int(nibble), int(getattr(qt, "centered", False)),
                 splits, _build.stream_of(x))
    _build.check("qmatmul", err, "quant_matmul launch")
    return y


def quant_matmul(qt: QuantTensor, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W^T over a per-row or grouped int8 QuantTensor. x: [T, C] ->
    [T, R] f32."""
    if x.ndim != 2 or x.shape[-1] != qt.cols:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} vs weight cols {qt.cols}")
    if not x.is_cuda:
        return quant_matmul_plain(qt, x)
    global launches, grouped_launches
    R, C, G = qt.rows, qt.cols, qt.groups
    fields = [("q", qt.q, torch.int8, (R, C)), ("scale", qt.scale, torch.float32, (R, G)),
              ("offset", qt.offset, torch.float32, (R, G))]
    sms = _check("quant_matmul", qt, x, fields)
    y = _launch(qt, x.float().contiguous(), qt.q, sms, nibble=False)
    if G == 1:
        launches += 1
    else:
        grouped_launches += 1
    return y


def q4_matmul(qt: Q4Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W^T over a nibble-packed Q4Tensor. x: [T, C] -> [T, R] f32."""
    if x.ndim != 2 or x.shape[-1] != qt.cols:
        raise ValueError(f"q4_matmul: x {tuple(x.shape)} vs weight cols {qt.cols}")
    if not x.is_cuda:
        return q4_matmul_plain(qt, x)
    global q4_launches
    R, C, G = qt.rows, qt.cols, qt.groups
    fields = [("packed", qt.packed, torch.uint8, (R, C // 2)),
              ("scale", qt.scale, torch.float32, (R, G)),
              ("offset", qt.offset, torch.float32, (R, G))]
    sms = _check("q4_matmul", qt, x, fields)
    y = _launch(qt, x.float().contiguous(), qt.packed, sms, nibble=True)
    q4_launches += 1
    return y
