"""In-place KV row insertion: the CUDA kernel (csrc/kv_insert.cu) and its plain twin.

Replaces llm_inference_tpu/ops/pallas/kv_insert.py::insert_rows:
``dst[rowidx[b]] = rows[b]`` in place, ids < 0 or >= R dropped (parked
lanes). ``dst`` is [R, H, d], ``rows`` [B, H, d] of the same dtype,
``rowidx`` [B] int32. Each serving lane owns its rows, so ids are distinct.

``insert_rows`` launches the kernel for CUDA tensors (or raises) and runs
``insert_rows_plain`` for CPU tensors; ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0


def _check(dst: torch.Tensor, rows: torch.Tensor, rowidx: torch.Tensor) -> None:
    if dst.ndim != 3 or rows.ndim != 3 or tuple(rows.shape[1:]) != tuple(dst.shape[1:]):
        raise ValueError(f"insert_rows: dst {tuple(dst.shape)} and rows {tuple(rows.shape)} "
                         "must be [R, H, d] and [B, H, d]")
    if rows.dtype != dst.dtype:
        raise ValueError(f"insert_rows: rows dtype {rows.dtype} != dst dtype {dst.dtype}")
    if tuple(rowidx.shape) != (rows.shape[0],):
        raise ValueError(f"insert_rows: rowidx {tuple(rowidx.shape)} vs {rows.shape[0]} rows")


def insert_rows_plain(dst: torch.Tensor, rows: torch.Tensor, rowidx: torch.Tensor) -> torch.Tensor:
    """Plain torch version: a masked index_put, the scatter's mode="drop"."""
    _check(dst, rows, rowidx)
    keep = (rowidx >= 0) & (rowidx < dst.shape[0])
    dst[rowidx[keep].long()] = rows[keep]
    return dst


def insert_rows(dst: torch.Tensor, rows: torch.Tensor, rowidx: torch.Tensor) -> torch.Tensor:
    """Write ``rows[b]`` into ``dst[rowidx[b]]`` in place; returns ``dst``."""
    if not dst.is_cuda:
        return insert_rows_plain(dst, rows, rowidx)
    global launches
    _check(dst, rows, rowidx)
    for name, t in (("dst", dst), ("rows", rows), ("rowidx", rowidx)):
        if t.device != dst.device or not t.is_contiguous():
            raise ValueError(f"insert_rows kernel: {name} must be contiguous on {dst.device}")
    if rowidx.dtype != torch.int32:
        raise ValueError("insert_rows kernel: rowidx must be int32")
    row_bytes = rows[0].numel() * rows.element_size()
    if row_bytes % 16 or dst.data_ptr() % 16 or rows.data_ptr() % 16:
        raise ValueError("insert_rows kernel: rows must be 16-byte multiples on 16-byte "
                         "boundaries")
    fn = _build.library("kv_insert").kv_insert_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_build.ptr(rows), _build.ptr(rowidx), _build.ptr(dst), dst.shape[0],
             rows.shape[0], row_bytes, _build.stream_of(dst))
    _build.check("kv_insert", err, "insert_rows launch")
    launches += 1
    return dst
