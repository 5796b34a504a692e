"""In-place KV row insertion: the CUDA kernel (csrc/kv_insert.cu) and its plain twins.

Replaces llm_inference_tpu/ops/pallas/kv_insert.py::insert_rows:
``dst[rowidx[b]] = rows[b]`` in place, ids < 0 or >= R dropped (parked
lanes). ``dst`` is [R, H, d], ``rows`` [B, H, d] of the same dtype,
``rowidx`` [B] int32. Each serving lane owns its rows, so ids are distinct.

``insert_kv_rows`` is the per-op batched routes' K/V append of one layer
in one launch (the JAX routes' ``insert_rows(pool, k.astype(pool.dtype),
idx)`` for K, then for V): f32 or bf16 sources, each row's [H, d] packed
but rows at any 16-byte stride, rounded to the bf16 pools in the kernel.

``insert_rows`` and ``insert_kv_rows`` launch the kernel for CUDA tensors
(or raise) and run their plain twins for CPU tensors; ``launches`` counts
kernel launches, one a call.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0
_entry = None


def _shapes(dst: torch.Tensor, rows: torch.Tensor, rowidx: torch.Tensor, what: str) -> None:
    if dst.ndim != 3 or rows.ndim != 3 or tuple(rows.shape[1:]) != tuple(dst.shape[1:]):
        raise ValueError(f"{what}: dst {tuple(dst.shape)} and rows {tuple(rows.shape)} "
                         "must be [R, H, d] and [B, H, d]")
    if tuple(rowidx.shape) != (rows.shape[0],):
        raise ValueError(f"{what}: rowidx {tuple(rowidx.shape)} vs {rows.shape[0]} rows")


def _check(dst: torch.Tensor, rows: torch.Tensor, rowidx: torch.Tensor) -> None:
    _shapes(dst, rows, rowidx, "insert_rows")
    if rows.dtype != dst.dtype:
        raise ValueError(f"insert_rows: rows dtype {rows.dtype} != dst dtype {dst.dtype}")


def _check_pair(kdst, vdst, k, v, rowidx) -> None:
    if kdst.shape[0] != vdst.shape[0] or kdst.device != vdst.device:
        raise ValueError(f"insert_kv_rows: K pool of {kdst.shape[0]} rows on {kdst.device}, V "
                         f"pool of {vdst.shape[0]} on {vdst.device}: one set of ids needs one "
                         "row count and one device")
    for name, dst, src in (("K", kdst, k), ("V", vdst, v)):
        _shapes(dst, src, rowidx, f"insert_kv_rows ({name})")
        if dst.dtype != torch.bfloat16:
            raise ValueError(f"insert_kv_rows: the {name} pool is {dst.dtype}; the port's "
                             "caches are bfloat16")
        if src.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"insert_kv_rows: {name} rows are {src.dtype}, not float32 or "
                             "bfloat16")


def insert_rows_plain(dst: torch.Tensor, rows: torch.Tensor, rowidx: torch.Tensor) -> torch.Tensor:
    """Plain torch version: a masked index_put, the scatter's mode="drop"."""
    _check(dst, rows, rowidx)
    keep = (rowidx >= 0) & (rowidx < dst.shape[0])
    dst[rowidx[keep].long()] = rows[keep]
    return dst


def insert_kv_rows_plain(kdst: torch.Tensor, vdst: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, rowidx: torch.Tensor) -> None:
    """Plain torch version: each source cast to its pool's dtype, then
    ``insert_rows_plain`` into K's pool and into V's."""
    _check_pair(kdst, vdst, k, v, rowidx)
    insert_rows_plain(kdst, k.to(kdst.dtype), rowidx)
    insert_rows_plain(vdst, v.to(vdst.dtype), rowidx)


def _fn():
    """The library's ``kv_insert_pairs``, its argument types set once."""
    global _entry
    if _entry is None:
        fn = _build.library("kv_insert").kv_insert_pairs
        pair = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        fn.argtypes = pair * 2 + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def _pair_args(dst: torch.Tensor, src: torch.Tensor, what: str) -> list:
    """(source, row stride in bytes, f32, destination, 16-byte words a row)
    for the kernel, or raise on a layout it does not take."""
    H, d = dst.shape[1:]
    if src.device != dst.device or not dst.is_contiguous():
        raise ValueError(f"{what} kernel: the pool must be contiguous and the rows on {dst.device}")
    if src.stride(2) != 1 or (H > 1 and src.stride(1) != d):
        raise ValueError(f"{what} kernel: each source row's [H, d] must be packed "
                         f"(strides {src.stride()})")
    row_bytes = H * d * dst.element_size()
    stride = src.stride(0) * src.element_size() if src.shape[0] > 1 else 0
    if row_bytes % 16 or stride % 16 or dst.data_ptr() % 16 or src.data_ptr() % 16:
        raise ValueError(f"{what} kernel: rows must be 16-byte multiples on 16-byte boundaries "
                         f"({row_bytes} bytes a row, stride {stride})")
    f32 = src.dtype != dst.dtype
    return [_build.ptr(src), stride, int(f32), _build.ptr(dst), row_bytes // 16]


def _launch(kargs: list, vargs: list, dst: torch.Tensor, rowidx: torch.Tensor, what: str) -> None:
    global launches
    if rowidx.device != dst.device or rowidx.dtype != torch.int32 or not rowidx.is_contiguous():
        raise ValueError(f"{what} kernel: rowidx must be contiguous int32 on {dst.device}")
    err = _fn()(*kargs, *vargs, _build.ptr(rowidx), dst.shape[0], rowidx.shape[0],
                _build.stream_of(dst))
    _build.check("kv_insert", err, f"{what} launch")
    launches += 1


def insert_rows(dst: torch.Tensor, rows: torch.Tensor, rowidx: torch.Tensor) -> torch.Tensor:
    """Write ``rows[b]`` into ``dst[rowidx[b]]`` in place (a byte copy of
    any dtype); returns ``dst``."""
    if not dst.is_cuda:
        return insert_rows_plain(dst, rows, rowidx)
    _check(dst, rows, rowidx)
    _launch(_pair_args(dst, rows, "insert_rows"), [None, 0, 0, None, 0], dst, rowidx,
            "insert_rows")
    return dst


def insert_kv_rows(kdst: torch.Tensor, vdst: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   rowidx: torch.Tensor) -> None:
    """One layer's K/V append in place: ``kdst[rowidx[b]] = k[b]`` and
    ``vdst[rowidx[b]] = v[b]``, each rounded to the bf16 pool, ids < 0 or
    >= R dropped. ``kdst`` [R, Hkv, dk], ``vdst`` [R, Hkv, dv] (bf16),
    ``k`` [B, Hkv, dk], ``v`` [B, Hkv, dv] (f32 or bf16; rows may be
    strided, a row's [Hkv, d] packed), ``rowidx`` [B] int32."""
    if not kdst.is_cuda:
        return insert_kv_rows_plain(kdst, vdst, k, v, rowidx)
    _check_pair(kdst, vdst, k, v, rowidx)
    _launch(_pair_args(kdst, k, "insert_kv_rows"), _pair_args(vdst, v, "insert_kv_rows"), kdst,
            rowidx, "insert_kv_rows")
