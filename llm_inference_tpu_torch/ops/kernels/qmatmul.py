"""Quantized matmul: the CUDA kernels (csrc/qmatmul.cu) and their plain twins.

Replaces llm_inference_tpu/ops/pallas/qmatmul.py, T <= 64:

  - ``quant_matmul`` over a per-row int8 ``QuantTensor`` (the rowwise branch
    of the TPU kernel): y[T, R] = (bf16(x) . q^T, f32 accumulation) * scale;
  - ``quant_matmul`` over a grouped int8 ``QuantTensor`` (its grouped branch,
    qmatmul.py:65-94) and ``q4_matmul`` over a nibble-packed ``Q4Tensor``
    (qmatmul.py:143-210): the weight dequantized in bf16 as the TPU kernels
    form it, bf16(bf16(q) * bf16(scale)) - bf16(offset), rounded to bf16,
    then y = bf16(x) . w^T with f32 accumulation. A centered ``Q4Tensor``
    without offsets may carry raw f16 scales (the capacity load's;
    quant/device.py ``f16_scale_plane``): the kernel streams them at 2
    bytes a group and widens each to f32 before bf16(scale), so the
    product is bit-equal to the f32 scales'. Other weights refuse f16
    scales.

The source note in csrc/qmatmul.cu says what bounds them on the H100 and how
the design answers that: one kernel, a template instance a format
(``quant_matmul`` picks the rowwise or the grouped int8 one on ``groups``).

``quant_matmul``/``q4_matmul`` launch a kernel for a CUDA tensor (or raise)
and run the plain twin for a CPU tensor. ``launches`` counts the rowwise
kernel's launches, ``grouped_launches`` the grouped int8 one's and
``q4_launches`` the nibble one's.

Every format takes one launch a call: ``plan``, a pure function of the
weight's shape, T, the format and the SM count
(tests/test_torch_qmatmul_plan.py), picks its C split, ring and shared
memory; the splits of a row tile meet in the kernel through arrival
counters kept per stream (``_build.stream_counters``). ``_launch(...,
prof=)`` records the kernel's per-block profile (tools/qmatmul_profile.py).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ...quant.device import Q4Tensor, QuantTensor, check_f16_scales
from . import _build

MAX_T = 64
_LANE = 128
GROUP_SIZES = (16, 32)  # a stage's columns hold whole groups

# The kernel (csrc/qmatmul.cu qmatmul_grouped_kernel)
ROW_TILE = 128            # weight rows a block: two consumer warpgroups of 64
RING = 4                  # ring stages a block
STAGE_QBYTES = ROW_TILE * 128  # a stage's quants: 128 rows x 128 bytes
N_INSTANCES = (8, 16, 32, 64)  # wgmma N: T rounded up
SMEM_MAX = 232448         # a block's most dynamic shared memory on the H100 (227 KB)

launches = 0
grouped_launches = 0
q4_launches = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's launch: ``row_tile``-row tiles (``row_tiles`` of
    them), C split over ``splits`` blocks on whole stages of ``stage_cols``
    columns (``row_stages`` along a row), a ring of ``stages`` stages, x of
    at most ``x_stages`` stages a block, ``smem`` bytes of dynamic shared
    memory (one block an SM) and the wgmma N instance ``n_inst``."""

    row_tile: int
    splits: int
    stage_cols: int
    stages: int
    x_stages: int
    smem: int
    n_inst: int
    row_tiles: int
    row_stages: int

    def split_columns(self, cols: int) -> list[tuple[int, int]]:
        """Each split's column range, as the kernel cuts them (whole stages)."""
        k = [s * self.row_stages // self.splits for s in range(self.splits + 1)]
        return [(k[s] * self.stage_cols, min(k[s + 1] * self.stage_cols, cols))
                for s in range(self.splits)]


def plan(rows: int, cols: int, t: int, nibble: bool, gs: int | None, offsets: bool,
         sms: int, scale_bytes: int = 4) -> Plan:
    """The kernel's plan for a [rows, cols] weight (int8, or nibbles) in
    groups of ``gs`` (with offsets or not; f32 scales, or with
    ``scale_bytes`` 2 f16 ones), or ``gs`` None for int8 with one scale a
    row (rowwise), at ``t`` tokens on ``sms`` SMs.

    A stage is 128 rows x 128 quant bytes (128 int8 or 256 nibble columns)
    and those rows' group scales (and offsets), if any; x sits beside the ring as bf16,
    N = t rounded up to an instance, for the block's whole split. A block
    takes an SM's shared memory. C splits as far as the SMs hold one block
    each (``sms // row tiles``, at most one split a stage: a second block on
    an SM doubles that SM's share and the call's time) and at least as far
    as x must to fit beside the ring (beside a ring of f32 scales, so f16
    ones split alike and sum alike)."""
    rowwise = gs is None
    if not 1 <= t <= MAX_T or cols % _LANE or (gs not in GROUP_SIZES and not rowwise) or (
            rowwise and (nibble or offsets)) or scale_bytes not in (2, 4) or (
            scale_bytes == 2 and not (nibble and not offsets)):
        raise ValueError(f"quant_matmul kernel plan: T={t}, cols={cols}, group size {gs}, "
                         f"nibbles {nibble}, offsets {offsets}, {scale_bytes}-byte scales")
    sc = 256 if nibble else 128
    n = next(v for v in N_INSTANCES if v >= t)
    row_stages = -(-cols // sc)
    row_tiles = -(-rows // ROW_TILE)

    def ring_bytes(sbytes):
        stage_scales = 0 if rowwise else ROW_TILE * (sc // gs) * sbytes
        return RING * (STAGE_QBYTES + stage_scales * (2 if offsets else 1)) + 2 * RING * 8 + 16

    fixed = ring_bytes(scale_bytes)
    x_stage = (sc // 16) * (32 * n + 16)  # a stage's k16 slices of x, each 32N + 16 bytes
    fill = max(1, min(row_stages, sms // row_tiles))
    # the split of f32 scales, whatever the scales' width: the same splits
    # give the same sums, bit for bit
    splits = max(fill, -(-row_stages // ((SMEM_MAX - ring_bytes(4)) // x_stage)))
    x_stages = -(-row_stages // splits)
    return Plan(ROW_TILE, splits, sc, RING, x_stages, fixed + x_stages * x_stage, n, row_tiles,
                row_stages)


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
    s = qt.scale.float().to(torch.bfloat16)
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


_lib = None


def _library():
    """The kernel library, its entry points' argument types bound once."""
    global _lib
    if _lib is None:
        lib = _build.library("qmatmul")
        lib.qmatmul_grouped.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 14
                                        + [ctypes.c_void_p])
        lib.qmatmul_grouped.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, qt, x: torch.Tensor, fields) -> int:
    """Raise unless the kernel takes these arguments (its tensor maps need
    the quants on a 16-byte boundary, and the group scales and offsets; f16
    scales only a centered ``Q4Tensor``'s without offsets, in an f16 scale
    plane); the device's SM count."""
    T = x.shape[0]
    rowwise = isinstance(qt, QuantTensor) and qt.groups == 1
    if not supports_kernel(qt, T):
        raise ValueError(f"{name} kernel: T={T} (max {MAX_T}), cols={qt.cols} (multiple of "
                         f"{_LANE}), group size {qt.group_size} (one row or {GROUP_SIZES})")
    for fname, t, dtype, shape in fields:
        if t is None:
            continue
        if fname == "scale" and t.dtype == torch.float16:
            check_f16_scales(qt, shape, x.device, f"{name} kernel")
            continue
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous() \
                or tuple(t.shape) != shape or (t.data_ptr() % 16 and (fname == "q" or not rowwise)):
            raise ValueError(f"{name} kernel: {fname} must be contiguous {dtype} {shape} "
                             f"on {x.device}, 16-byte aligned, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    return _build.sm_count(x.device)


def _launch(qt, x: torch.Tensor, qdata: torch.Tensor, sms: int, *, nibble: bool,
            prof: torch.Tensor | None = None) -> torch.Tensor:
    """One launch; ``prof`` (or None): an int64 tensor of 8 stamps a block,
    the kernel's profile (csrc/qmatmul.cu)."""
    T, (R, C) = x.shape[0], (qt.rows, qt.cols)
    if x.data_ptr() % 16:
        raise ValueError("quant_matmul kernel: x must start on a 16-byte boundary")
    y = torch.empty((T, R), dtype=torch.float32, device=x.device)
    rowwise = qt.groups == 1 and isinstance(qt, QuantTensor)
    gs = None if rowwise else qt.group_size
    sbytes = qt.scale.element_size()
    p = plan(R, C, T, nibble, gs, qt.offset is not None, sms, sbytes)
    part = counters = None
    if p.splits > 1:
        part = torch.empty(p.splits * p.row_tiles * p.n_inst * ROW_TILE, dtype=torch.float32,
                           device=x.device)
        counters = _build.stream_counters("qmatmul", x, p.row_tiles)
    err = _library().qmatmul_grouped(
        _build.ptr(x), _build.ptr(qdata), _build.ptr(qt.scale),
        None if qt.offset is None else _build.ptr(qt.offset), _build.ptr(y),
        None if part is None else _build.ptr(part),
        None if counters is None else _build.ptr(counters),
        None if prof is None else _build.ptr(prof), T, R, C, gs or 0,
        int(nibble), int(getattr(qt, "centered", False)), sbytes, p.row_tile, p.splits,
        p.stage_cols, p.stages, p.x_stages, p.smem, p.n_inst, _build.stream_of(x))
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
