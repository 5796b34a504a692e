"""Device-resident quantized weights: int8 or nibble quants with f32 scales.

Counterpart of llm_inference_tpu/quant/device.py: ``QuantTensor`` (per-row,
``requantize_rowwise``, or per-group, ``from_gguf_bytes``), ``Q4Tensor``
(nibble-packed 4-bit, ``pack_q4_host``/``pack_q4``/``unpack_q4_to_quant``)
and ``DenseTensor``.

    W[r, g*gs + j] == scale[r, g] * q[r, g*gs + j] - offset[r, g]     (exactly)

The group size is the format's finest scale granularity: 32 for Q4_0, Q5_0,
Q8_0 and Q4_K, 16 for Q6_K; a per-row weight has one group of ``cols``.

Layout. The port keeps every quant in LOGICAL column order, ``q [R, C]``
int8 with ``scale``/``offset`` ``[R, G]`` f32, and packs nibbles in
consecutive pairs (byte j holds columns 2j in its low nibble and 2j + 1 in
its high one). The JAX package stores two other layouts, each for a
constraint of Mosaic on the TPU:

  - the group-strided column order (its quant/device.py:60-103), so that a
    lane-tiled ``pltpu.repeat`` expands the group scales, Mosaic's only
    cheap [R, G] -> [R, C] broadcast (its ops/pallas/qmatmul.py:5-11);
  - the transposed, block-padded, sign-hi nibble layout of the masked-dot
    whole step (``TQuantTensor``/``TQ4Tensor``), because Mosaic has no
    sub-32-bit shifts and no cheap group broadcast (its
    ops/pallas/fused_decode_q.py:10-26, quant/device.py:494-535).

Neither constraint holds on Hopper: a lane that holds 16 consecutive
columns holds one group, reads its scale once, and unpacks nibbles with
register bit operations. So one stacked layout serves the per-op kernels
(csrc/qmatmul.cu), the whole step (csrc/fused_decode_q.cu) and the
prefill's dequant, with no masked-dot repack and no transient weight copy.
``models/weights.py from_jax_arrays`` converts all four JAX layouts to it.

``requantize_rowwise`` reproduces the JAX package's default route
(quant/device.py:253-294 with the native ``dequant_bf16``): the exact f32
dequant of the checkpoint's blocks, rounded to bf16 (round-to-nearest-even),
then amax/127 per row, ``rint`` and clip to [-127, 127]. Where the format has
a torch decoder here (F32/F16/BF16/Q4_0/Q8_0) the decode runs with torch ops
on the target device, bit-equal to the host route (``torch.round`` rounds
half to even like ``np.rint``; IEEE f32 division is correctly rounded on
both), so a 1B checkpoint loads in seconds; other formats decode on the
host with quant/layouts.py.

Each weight's ``act_quant`` is the reference's activation contract for its
encoding (``ACT_QUANT``, the JAX package's quant/device.py:41-50): what the
parity mode's exact matmul does to the activation before the product
(ops/linear.py ``contract_activations``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..gguf.constants import GGMLType
from . import layouts

# Activation contract per weight encoding (what the reference GEMV does to x):
# reference ops.cpp:210, 627, 721, 800; the f16 downcast at :471-475; none
# for Q5_0 (a float dot, :840-893).
ACT_QUANT = {
    GGMLType.Q4_0: "q8_0",
    GGMLType.Q8_0: "q8_0",
    GGMLType.Q4_K: "q8_k",
    GGMLType.Q6_K: "q8_k",
    GGMLType.Q5_0: "none",
    GGMLType.F16: "f16",
    GGMLType.BF16: "none",
    GGMLType.F32: "none",
}


@dataclasses.dataclass
class QuantTensor:
    """Int8 quants in logical column order with per-group f32 scales:
    ``q`` [..., rows, cols], ``scale`` and ``offset`` (Q4_K's min term, or
    None) [..., rows, groups]. ``group_size`` defaults to ``cols``: one
    group a row, the per-row layout of ``requantize_rowwise``. A leading
    axis is the stacked [n_layers] axis (models/weights.py)."""

    q: torch.Tensor
    scale: torch.Tensor
    fmt: GGMLType
    rows: int
    cols: int
    offset: Optional[torch.Tensor] = None
    group_size: int = 0

    def __post_init__(self):
        if not self.group_size:
            self.group_size = self.cols

    @property
    def act_quant(self) -> str:
        return ACT_QUANT[self.fmt]

    @property
    def groups(self) -> int:
        return self.cols // self.group_size

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        """[..., rows, cols] in ``dtype``: q * scale - offset in f32, then cast."""
        return _dequant(self.q.float(), self, dtype)


@dataclasses.dataclass
class Q4Tensor:
    """Nibble-packed 4-bit quants (Q4_0, Q4_K), lossless: ``packed`` uint8
    [..., rows, cols // 2], byte j holding column 2j in its low nibble and
    2j + 1 in its high one; ``scale``/``offset`` as in ``QuantTensor``.
    ``centered`` (Q4_0): a nibble u stands for u - 8; otherwise (Q4_K) for
    u, with the min offset."""

    packed: torch.Tensor
    scale: torch.Tensor
    fmt: GGMLType
    rows: int
    cols: int
    offset: Optional[torch.Tensor] = None
    group_size: int = 32
    centered: bool = False

    @property
    def act_quant(self) -> str:
        return ACT_QUANT[self.fmt]

    @property
    def groups(self) -> int:
        return self.cols // self.group_size

    def quants(self) -> torch.Tensor:
        """The integer quants [..., rows, cols] int8, logical order."""
        p = self.packed
        q = torch.stack([p & 0x0F, p >> 4], dim=-1).flatten(-2).to(torch.int8)
        return q - 8 if self.centered else q

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        return _dequant(self.quants().float(), self, dtype)


@dataclasses.dataclass
class DenseTensor:
    """Unquantized 2-D weight (F16/BF16/F32) in its native dtype."""

    w: torch.Tensor
    fmt: GGMLType
    rows: int
    cols: int

    @property
    def act_quant(self) -> str:
        return ACT_QUANT[self.fmt]

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        return self.w.to(dtype)


_LEAVES = {QuantTensor: ("q", "scale", "offset"), Q4Tensor: ("packed", "scale", "offset"),
           DenseTensor: ("w",)}


@dataclasses.dataclass
class ShardedTensor:
    """A weight split over the tensor-parallel ranks of one data row of a
    mesh (parallel/sharding.py): ``shards[r]`` is rank r's ``QuantTensor``,
    ``Q4Tensor`` or ``DenseTensor`` in the one weight layout above, on
    ``mesh.devices[data_row, r]`` (None for a rank of another process).

    ``dim`` 0 (row-parallel): shard r holds rows [r R/n, (r+1) R/n) of each
    part; ``dim`` 1 (col-parallel): columns [r C/n, (r+1) C/n), whole groups.
    ``rows`` and ``cols`` are the whole weight's. A leaf whose target dim
    does not divide n (rowq8's [R, 1] scale under the col policy) is whole in
    every shard. ``parts``: the row counts of a row-concatenated weight
    (models/weights.py ``fuse_projections``): rank r's shard is its slice
    of each part, one after the other, so a rank's fused QKV is
    ``[q_r; k_r; v_r]``, and the join puts each part's ranks back together."""

    shards: list
    dim: int
    rows: int
    cols: int
    fmt: GGMLType
    mesh: object
    data_row: int = 0
    parts: tuple = ()

    @property
    def n(self) -> int:
        return len(self.shards)

    @property
    def act_quant(self) -> str:
        return ACT_QUANT[self.fmt]

    @property
    def local(self):
        """This process's first shard (every shard has its class and format)."""
        return next(s for s in self.shards if s is not None)

    def ranks(self) -> list:
        """(rank, shard) for this process's ranks."""
        return [(r, s) for r, s in enumerate(self.shards) if s is not None]

    def join_rows(self, ys: list) -> torch.Tensor:
        """The ranks' row-parallel outputs ``ys[r]`` [..., rows / n], all on one
        device, as the whole weight's [..., rows]: each part's ranks in rank
        order, exactly."""
        if not self.parts:
            return torch.cat(ys, dim=-1)
        out, lo = [], 0
        for p in self.parts:
            k = p // self.n
            out += [y[..., lo : lo + k] for y in ys]
            lo += k
        return torch.cat(out, dim=-1)


def shard_weight(w, sharding, data_row: int = 0) -> ShardedTensor:
    """``w`` split by a ``parallel.sharding._LeafSharding``: each leaf sliced
    along ``sharding.dim`` where it divides (``for_array``), else whole, and
    placed on its rank's device of ``data_row`` (this process's ranks
    only). A row slice on the device it came from is a view; a column slice
    is copied contiguous."""
    mesh, n, dim = sharding.mesh, sharding.n, sharding.dim
    rows, cols = (w.rows // n, w.cols) if dim == 0 else (w.rows, w.cols // n)
    shards = []
    for r in range(n):
        if not mesh.is_local(data_row, r):
            shards.append(None)
            continue
        dev = mesh.devices[data_row, r]
        kw = {}
        for f in _LEAVES[type(w)]:
            t = getattr(w, f)
            if t is not None:
                if sharding.for_array(t):
                    size = t.shape[dim] // n
                    t = t.narrow(dim, r * size, size)
                t = t.to(dev).contiguous()
            kw[f] = t
        shard = dataclasses.replace(w, rows=rows, cols=cols, **kw)
        if isinstance(w, QuantTensor) and w.groups == 1:
            shard.group_size = cols  # per-row: still one group a row
        shards.append(shard)
    return ShardedTensor(shards=shards, dim=dim, rows=w.rows, cols=w.cols, fmt=w.fmt, mesh=mesh,
                         data_row=data_row)


def place_weight(w, mesh, data_row: int):
    """A weight, vector or ``ShardedTensor`` of one data row placed on
    ``data_row``'s devices: each shard on its rank's device there, anything
    else on the row's first device. A tensor already on its device is the
    same tensor (no copy), so rows that share devices share weights."""
    if w is None:
        return None
    if isinstance(w, ShardedTensor):
        shards = [None if s is None else _moved(s, mesh.devices[data_row, r])
                  for r, s in enumerate(w.shards)]
        return dataclasses.replace(w, shards=shards, data_row=data_row)
    if isinstance(w, torch.Tensor):
        return w.to(mesh.home(data_row))
    return _moved(w, mesh.home(data_row))


def _moved(w, dev):
    return dataclasses.replace(w, **{f: None if getattr(w, f) is None else getattr(w, f).to(dev)
                                     for f in _LEAVES[type(w)]})


def _dequant(qf: torch.Tensor, t, dtype) -> torch.Tensor:
    w = qf.unflatten(-1, (t.groups, t.group_size)) * t.scale[..., None]
    if t.offset is not None:
        w = w - t.offset[..., None]
    return w.flatten(-2).to(dtype)


_DENSE_DTYPE = {
    GGMLType.F16: torch.float16,
    GGMLType.BF16: torch.bfloat16,
    GGMLType.F32: torch.float32,
}


# -- decoding raw GGUF blocks into (quants, scales, offsets) ------------------


def _plan_q5_0(raw, rows, cols):
    f = layouts.decode_q5_0(raw, rows, cols)
    qs = f["qs"].astype(np.uint32)
    qh = f["qh"][..., None]
    high = ((qh >> np.arange(32, dtype=np.uint32)) & 1) << 4
    low = np.concatenate([qs & 0x0F, qs >> 4], axis=-1)
    q = ((low | high).astype(np.int16) - 16).astype(np.int8)
    return q, f["d"].astype(np.float32), None, 32


def _plan_q4_k(raw, rows, cols):
    f = layouts.decode_q4_k(raw, rows, cols)
    sc, m = layouts._q4k_scale_min(f["scales"])  # [R, NB, 8]
    q = layouts._q4k_expand(f["qs"]).astype(np.int8)  # [R, NB, 256] in 0..15
    d = f["d"].astype(np.float32)[..., None]
    dmin = f["dmin"].astype(np.float32)[..., None]
    scale = (d * sc.astype(np.float32)).reshape(rows, -1)  # one a 32-column group
    offset = (dmin * m.astype(np.float32)).reshape(rows, -1)
    return q, scale, offset, 32


def _plan_q6_k(raw, rows, cols):
    f = layouts.decode_q6_k(raw, rows, cols)
    q = layouts._q6k_expand(f["ql"], f["qh"]).astype(np.int8)  # centered
    d = f["d"].astype(np.float32)[..., None]
    scale = (d * f["scales"].astype(np.float32)).reshape(rows, -1)  # one a 16-column group
    return q, scale, None, 16


# The JAX package's _PLANAR table (quant/device.py:136-184): raw blocks ->
# (q int8 logical order, scale [R, G], offset [R, G] or None, group size).
# Q4_0 and Q8_0 decode with torch ops on the target device (_torch_planar).
_PLANAR = {
    GGMLType.Q5_0: _plan_q5_0,
    GGMLType.Q4_K: _plan_q4_k,
    GGMLType.Q6_K: _plan_q6_k,
}


def _f16_field(b: torch.Tensor, lo: int) -> torch.Tensor:
    """Little-endian f16 at byte offset ``lo`` of each block, as f32."""
    return b[..., lo : lo + 2].contiguous().view(torch.float16)[..., 0].float()


_TORCH_PLANAR = (GGMLType.Q4_0, GGMLType.Q8_0)


def _raw_tensor(raw: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(raw, dtype=np.uint8)).to(device)  # mmap views are read-only


def _torch_planar(raw_t: torch.Tensor, fmt: GGMLType, rows: int, cols: int):
    """(q int8 [R, C], scale [R, C / 32] f32) of Q4_0/Q8_0 blocks with torch
    ops on ``raw_t``'s device: the block's integers and its f16 scale."""
    if fmt == GGMLType.Q4_0:
        b = raw_t.reshape(rows, cols // 32, 18)
        qs = b[..., 2:].contiguous()  # contiguous element ops: several times faster on a CPU
        q = torch.empty((rows, cols // 32, 32), dtype=torch.uint8, device=raw_t.device)
        q[..., :16] = qs & 0x0F
        q[..., 16:] = qs >> 4
        q = q.view(torch.int8) - 8
    else:
        b = raw_t.reshape(rows, cols // 32, 34)
        q = b[..., 2:].contiguous().view(torch.int8)
    return q.reshape(rows, cols), _f16_field(b, 0).contiguous()


def _planar(raw: np.ndarray, fmt: GGMLType, rows: int, cols: int, device):
    """(q int8 [R, C], scale [R, G] f32, offset or None, group size) on
    ``device``."""
    if fmt in _TORCH_PLANAR:
        return (*_torch_planar(_raw_tensor(raw, device), fmt, rows, cols), None, 32)
    q, scale, offset, gs = _PLANAR[fmt](np.asarray(raw), rows, cols)

    def put(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return put(np.asarray(q).reshape(rows, cols)), put(scale), put(offset), gs


def dequant_f32(raw: np.ndarray, fmt: GGMLType, rows: int, cols: int, *, device="cpu"):
    """The exact f32 dequant [rows, cols] of any GGUF weight, on ``device``:
    float encodings and Q4_0/Q8_0 with torch ops there, the same values as
    quant/layouts.py (each product of a small integer and an f16 scale is
    exact in f32); the other formats on the host with quant/layouts.py."""
    if fmt in _DENSE_DTYPE:
        return _raw_tensor(raw, device).view(_DENSE_DTYPE[fmt]).reshape(rows, cols).float()
    if fmt in _TORCH_PLANAR:
        q, scale = _torch_planar(_raw_tensor(raw, device), fmt, rows, cols)
        return QuantTensor(q=q, scale=scale, fmt=fmt, rows=rows, cols=cols, group_size=32).dequant()
    return torch.from_numpy(layouts.dequantize(raw, fmt, rows, cols)).to(device)


def from_gguf_bytes(raw: np.ndarray, fmt: GGMLType, rows: int, cols: int, *,
                    device="cpu"):
    """Raw GGUF tensor bytes -> a device weight, lossless: quantized
    encodings become a grouped ``QuantTensor``, float encodings a
    ``DenseTensor`` in their native dtype."""
    fmt = GGMLType(fmt)
    if fmt in _DENSE_DTYPE:
        w = dequant_f32(raw, fmt, rows, cols, device=device).to(_DENSE_DTYPE[fmt])
        return DenseTensor(w=w, fmt=fmt, rows=rows, cols=cols)
    if fmt not in _PLANAR and fmt not in _TORCH_PLANAR:
        raise ValueError(f"unsupported weight encoding {fmt!r}")
    q, scale, offset, gs = _planar(raw, fmt, rows, cols, torch.device(device))
    return QuantTensor(q=q, scale=scale, offset=offset, fmt=fmt, rows=rows, cols=cols,
                       group_size=gs)


_REQUANT_SLICE_BYTES = 1 << 28  # f32 bytes of one row slice's dequant


def requantize_rowwise(
    fmt: GGMLType, raw: np.ndarray, rows: int, cols: int, *, device="cpu"
) -> QuantTensor:
    """Requantize any GGUF weight to per-row int8 on ``device``:
    W[r, c] ~= row_scale[r] * q8[r, c] (serve-mode trade, never parity).
    Every row is requantized on its own, so a large table (gemma4's
    per-layer embedding, 262144 x 6144) goes through in row slices of at
    most 256 MB of f32: the load's transient memory stays that small
    instead of twice the table in f32."""
    fmt = GGMLType(fmt)
    step = max(1, _REQUANT_SLICE_BYTES // (4 * cols))
    if rows <= step:
        q, scale = _requant_rows(raw, fmt, rows, cols, device)
        return QuantTensor(q=q, scale=scale, fmt=fmt, rows=rows, cols=cols)
    by_row = np.asarray(raw).reshape(rows, -1)
    q = torch.empty((rows, cols), dtype=torch.int8, device=device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=device)
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        q[r0:r1], scale[r0:r1] = _requant_rows(by_row[r0:r1].reshape(-1), fmt, r1 - r0, cols,
                                                device)
    return QuantTensor(q=q, scale=scale, fmt=fmt, rows=rows, cols=cols)


def _requant_rows(raw, fmt: GGMLType, rows: int, cols: int, device):
    w = dequant_f32(raw, fmt, rows, cols, device=device)
    w = w.to(torch.bfloat16).float()  # the native route's RNE bf16 rounding
    amax = w.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    w.div_(scale[:, None]).round_().clamp_(-127, 127)
    return w.to(torch.int8), scale[:, None].contiguous()


# -- nibble packing --------------------------------------------------------------


def pack_nibbles(u: torch.Tensor) -> torch.Tensor:
    """Values 0..15 [..., C] -> uint8 [..., C // 2], consecutive pairs."""
    u = u.to(torch.uint8)
    return (u[..., 0::2] | (u[..., 1::2] << 4)).contiguous()


def pack_q4(qt: QuantTensor) -> Optional[Q4Tensor]:
    """Nibble-pack a Q4_0/Q4_K ``QuantTensor`` losslessly; None for other
    formats or an odd column count."""
    if qt.fmt not in (GGMLType.Q4_0, GGMLType.Q4_K) or qt.cols % 2:
        return None
    centered = qt.fmt == GGMLType.Q4_0
    u = qt.q.to(torch.int16) + (8 if centered else 0)
    return Q4Tensor(packed=pack_nibbles(u), scale=qt.scale, offset=qt.offset, fmt=qt.fmt,
                    rows=qt.rows, cols=qt.cols, group_size=qt.group_size, centered=centered)


def pack_q4_host(raw: np.ndarray, fmt: GGMLType, rows: int, cols: int, *,
                 device="cpu") -> Optional[Q4Tensor]:
    """A ``Q4Tensor`` straight from raw Q4_0/Q4_K blocks (None for other
    formats): decoded and packed on ``device``, so only the packed bytes and
    the scales stay there."""
    fmt = GGMLType(fmt)
    if fmt not in (GGMLType.Q4_0, GGMLType.Q4_K) or cols % 2:
        return None
    if fmt == GGMLType.Q4_0:
        # the block's bytes hold columns j (low nibble) and j + 16 (high):
        # pairs (2k, 2k + 1) repack from two bytes with byte operations
        b = _raw_tensor(raw, torch.device(device)).reshape(rows, cols // 32, 18)
        qs = b[..., 2:].contiguous()
        lo, hi = qs[..., 0::2], qs[..., 1::2]
        packed = torch.cat([(lo & 0x0F) | (hi << 4), (lo >> 4) | (hi & 0xF0)], dim=-1)
        return Q4Tensor(packed=packed.reshape(rows, cols // 2), scale=_f16_field(b, 0).contiguous(),
                        fmt=fmt, rows=rows, cols=cols, group_size=32, centered=True)
    q, scale, offset, gs = _planar(raw, fmt, rows, cols, torch.device(device))
    return pack_q4(QuantTensor(q=q, scale=scale, offset=offset, fmt=fmt, rows=rows,
                               cols=cols, group_size=gs))


def unpack_q4_to_quant(q4: Q4Tensor) -> QuantTensor:
    """The int8 ``QuantTensor`` of a ``Q4Tensor`` (exact)."""
    return QuantTensor(q=q4.quants(), scale=q4.scale, offset=q4.offset, fmt=q4.fmt,
                       rows=q4.rows, cols=q4.cols, group_size=q4.group_size)


def dense_bf16(raw: np.ndarray, fmt: GGMLType, rows: int, cols: int, *,
               device="cpu") -> DenseTensor:
    """Any GGUF weight dequantized to bf16 (exact f32, then RNE): the JAX
    package's ``bf16`` load mode (models/weights.py ``_load_w``)."""
    w = dequant_f32(raw, GGMLType(fmt), rows, cols, device=device).to(torch.bfloat16)
    return DenseTensor(w=w, fmt=GGMLType.BF16, rows=rows, cols=cols)
