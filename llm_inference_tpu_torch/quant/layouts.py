"""GGUF block-quant layouts: raw bytes <-> structured numpy field arrays.

Each supported encoding gets:

  decode_<fmt>(raw, n_rows, n_cols)  -> dict of per-field numpy arrays
  encode_<fmt>(w)                    -> raw row-major block bytes
  dequant_<fmt>(raw, n_rows, n_cols) -> float32 [n_rows, n_cols]

Bit-level semantics mirror the reference engine / ggml exactly (dequant is
the parity-critical direction; the *encoders* here only need to produce
well-formed blocks for fixtures — the numerical contract is defined by
decode). Reference points:

  Q4_0  scalar path   reference ops.cpp:400-436   (low nibbles = cols 0-15)
  Q5_0                reference ops.cpp:862-875
  Q8_0                reference ops.cpp:1045-1059
  Q4_K  superblocks   reference ops.cpp:958-1003  (get_scale_min_k4 6-bit unpack)
  Q6_K  superblocks   reference ops.cpp:1020-1036
  f16 conversions     reference gguf.cpp:40-95    (IEEE binary16, == np.float16)

All decoded "fields" views keep weights in their packed dtype so they can be
shipped to device memory compact; the dequantized f32 path is for loading
small tensors (norm weights), CPU-side golden tests, and the plain torch path.
"""

from __future__ import annotations

import numpy as np

from ..gguf.constants import GGMLType, QK, QK_K, block_geometry

# ---------------------------------------------------------------------------
# helpers


def _blocks(raw: np.ndarray, n_rows: int, n_cols: int, fmt: GGMLType) -> np.ndarray:
    """View raw bytes as [n_rows, n_blocks, bytes_per_block] uint8."""
    elems, nbytes = block_geometry(fmt)
    if n_cols % elems:
        raise ValueError(f"{fmt.name}: n_cols {n_cols} not a multiple of {elems}")
    nb = n_cols // elems
    expect = n_rows * nb * nbytes
    if raw.size != expect:
        raise ValueError(f"{fmt.name}: got {raw.size} bytes, want {expect}")
    return raw.reshape(n_rows, nb, nbytes)


def _f16(view: np.ndarray) -> np.ndarray:
    """Reinterpret little-endian byte pairs as float16."""
    return np.ascontiguousarray(view).view(np.float16).reshape(view.shape[:-1])


def nearest_int(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even, the semantics of the reference's magic-number
    ``nearest_int`` (reference ops.cpp:107-113: adding 2^23+2^22 in f32
    rounds at integer granularity under the default FP rounding mode)."""
    return np.rint(x).astype(np.int32)


# ---------------------------------------------------------------------------
# Q4_0: 32 elems/block = f16 d + 16 bytes of nibbles.
# Column c of block: c < 16 -> low nibble of byte c; else high nibble of c-16.
# value = (q - 8) * d.


def decode_q4_0(raw: np.ndarray, n_rows: int, n_cols: int) -> dict[str, np.ndarray]:
    b = _blocks(raw, n_rows, n_cols, GGMLType.Q4_0)
    return {"d": _f16(b[..., 0:2]), "qs": np.ascontiguousarray(b[..., 2:18])}


def dequant_q4_0(raw: np.ndarray, n_rows: int, n_cols: int) -> np.ndarray:
    f = decode_q4_0(raw, n_rows, n_cols)
    qs = f["qs"].astype(np.int32)
    q = np.concatenate([qs & 0x0F, qs >> 4], axis=-1) - 8  # [R, NB, 32]
    out = q.astype(np.float32) * f["d"].astype(np.float32)[..., None]
    return out.reshape(n_rows, n_cols)


def encode_q4_0(w: np.ndarray) -> np.ndarray:
    n_rows, n_cols = w.shape
    nb = n_cols // QK
    x = w.reshape(n_rows, nb, QK).astype(np.float32)
    amax = np.abs(x).max(axis=-1)
    scale = np.where(amax < 1e-8, 1e-8, amax / 7.0).astype(np.float32)
    q = np.clip(nearest_int(x / scale[..., None]), -8, 7) + 8
    packed = (q[..., :16] | (q[..., 16:] << 4)).astype(np.uint8)
    out = np.empty((n_rows, nb, 18), dtype=np.uint8)
    out[..., 0:2] = scale.astype(np.float16)[..., None].view(np.uint8)
    out[..., 2:] = packed
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Q8_0: 32 elems/block = f16 d + 32 int8. value = q * d.


def decode_q8_0(raw: np.ndarray, n_rows: int, n_cols: int) -> dict[str, np.ndarray]:
    b = _blocks(raw, n_rows, n_cols, GGMLType.Q8_0)
    return {"d": _f16(b[..., 0:2]), "qs": np.ascontiguousarray(b[..., 2:34]).view(np.int8)}


def dequant_q8_0(raw: np.ndarray, n_rows: int, n_cols: int) -> np.ndarray:
    f = decode_q8_0(raw, n_rows, n_cols)
    out = f["qs"].astype(np.float32) * f["d"].astype(np.float32)[..., None]
    return out.reshape(n_rows, n_cols)


def encode_q8_0(w: np.ndarray) -> np.ndarray:
    n_rows, n_cols = w.shape
    nb = n_cols // QK
    x = w.reshape(n_rows, nb, QK).astype(np.float32)
    amax = np.abs(x).max(axis=-1)
    d = (amax / 127.0).astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    q = np.clip(nearest_int(x * inv[..., None]), -128, 127).astype(np.int8)
    out = np.empty((n_rows, nb, 34), dtype=np.uint8)
    out[..., 0:2] = d.astype(np.float16)[..., None].view(np.uint8)
    out[..., 2:] = q.view(np.uint8)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Q5_0: 32 elems/block = f16 d + 4 bytes qh (5th bits) + 16 bytes nibbles.
# col i<16:  q = (qs[i] & 0xF) | (bit i of qh) << 4
# col i>=16: q = (qs[i-16] >> 4) | (bit i of qh) << 4      value = (q-16)*d.


def decode_q5_0(raw: np.ndarray, n_rows: int, n_cols: int) -> dict[str, np.ndarray]:
    b = _blocks(raw, n_rows, n_cols, GGMLType.Q5_0)
    qh = np.ascontiguousarray(b[..., 2:6]).view(np.uint32).reshape(b.shape[:2])
    return {"d": _f16(b[..., 0:2]), "qh": qh, "qs": np.ascontiguousarray(b[..., 6:22])}


def dequant_q5_0(raw: np.ndarray, n_rows: int, n_cols: int) -> np.ndarray:
    f = decode_q5_0(raw, n_rows, n_cols)
    qs = f["qs"].astype(np.uint32)
    qh = f["qh"][..., None]  # [R, NB, 1]
    bits = np.arange(32, dtype=np.uint32)
    high = ((qh >> bits) & 1) << 4  # [R, NB, 32]
    low = np.concatenate([qs & 0x0F, qs >> 4], axis=-1)
    q = (low | high).astype(np.int32) - 16
    out = q.astype(np.float32) * f["d"].astype(np.float32)[..., None]
    return out.reshape(n_rows, n_cols)


def encode_q5_0(w: np.ndarray) -> np.ndarray:
    n_rows, n_cols = w.shape
    nb = n_cols // QK
    x = w.reshape(n_rows, nb, QK).astype(np.float32)
    amax = np.abs(x).max(axis=-1)
    d = np.where(amax < 1e-8, 1e-8, amax / 15.0).astype(np.float32)
    q = (np.clip(nearest_int(x / d[..., None]), -16, 15) + 16).astype(np.uint32)
    low = q & 0x0F
    high = (q >> 4) & 1
    bits = np.arange(32, dtype=np.uint32)
    qh = (high << bits).sum(axis=-1, dtype=np.uint64).astype(np.uint32)
    packed = (low[..., :16] | (low[..., 16:] << 4)).astype(np.uint8)
    out = np.empty((n_rows, nb, 22), dtype=np.uint8)
    out[..., 0:2] = d.astype(np.float16)[..., None].view(np.uint8)
    out[..., 2:6] = qh[..., None].view(np.uint8)
    out[..., 6:] = packed
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Q4_K: 256-elem superblock = f16 d, f16 dmin, 12 bytes of 6-bit scales/mins,
# 128 bytes of nibbles. Eight 32-element groups; group g reads nibble
# half (g odd -> high) of bytes [32*(g//2) : 32*(g//2)+32].
# value = d*sc[g]*q - dmin*m[g].


def _q4k_scale_min(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte 6-bit scale/min table -> (sc, m) uint8 [..., 8].

    Mirrors get_scale_min_k4 (reference ops.cpp:633-641)."""
    s = scales.astype(np.uint8)
    sc = np.empty(s.shape[:-1] + (8,), dtype=np.uint8)
    m = np.empty_like(sc)
    for j in range(4):
        sc[..., j] = s[..., j] & 63
        m[..., j] = s[..., j + 4] & 63
    for j in range(4, 8):
        sc[..., j] = (s[..., j + 4] & 0x0F) | ((s[..., j - 4] >> 6) << 4)
        m[..., j] = (s[..., j + 4] >> 4) | ((s[..., j] >> 6) << 4)
    return sc, m


def _q4k_pack_scales(sc: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Inverse of _q4k_scale_min for 6-bit sc/m in [0, 63]."""
    out = np.zeros(sc.shape[:-1] + (12,), dtype=np.uint8)
    for j in range(4):
        out[..., j] = (sc[..., j] & 63) | ((sc[..., j + 4] >> 4) << 6)
        out[..., j + 4] = (m[..., j] & 63) | ((m[..., j + 4] >> 4) << 6)
        out[..., j + 8] = (sc[..., j + 4] & 0x0F) | ((m[..., j + 4] & 0x0F) << 4)
    return out


def decode_q4_k(raw: np.ndarray, n_rows: int, n_cols: int) -> dict[str, np.ndarray]:
    b = _blocks(raw, n_rows, n_cols, GGMLType.Q4_K)
    return {
        "d": _f16(b[..., 0:2]),
        "dmin": _f16(b[..., 2:4]),
        "scales": np.ascontiguousarray(b[..., 4:16]),
        "qs": np.ascontiguousarray(b[..., 16:144]),
    }


def _q4k_expand(qs: np.ndarray) -> np.ndarray:
    """Nibble-expand Q4_K qs [..., 128] -> q [..., 256] in superblock column order."""
    q = np.empty(qs.shape[:-1] + (QK_K,), dtype=np.int32)
    for g in range(8):
        chunk = qs[..., 32 * (g // 2) : 32 * (g // 2) + 32].astype(np.int32)
        q[..., 32 * g : 32 * g + 32] = (chunk >> 4) if g % 2 else (chunk & 0x0F)
    return q


def dequant_q4_k(raw: np.ndarray, n_rows: int, n_cols: int) -> np.ndarray:
    f = decode_q4_k(raw, n_rows, n_cols)
    sc, m = _q4k_scale_min(f["scales"])  # [R, NB, 8]
    q = _q4k_expand(f["qs"])  # [R, NB, 256]
    d = f["d"].astype(np.float32)[..., None]
    dmin = f["dmin"].astype(np.float32)[..., None]
    scale = (d * sc.astype(np.float32))[..., :, None]  # [R, NB, 8, 1]
    mins = (dmin * m.astype(np.float32))[..., :, None]
    qg = q.reshape(q.shape[:-1] + (8, 32)).astype(np.float32)
    out = qg * scale - mins
    return out.reshape(n_rows, n_cols)


def encode_q4_k(w: np.ndarray) -> np.ndarray:
    n_rows, n_cols = w.shape
    nb = n_cols // QK_K
    x = w.reshape(n_rows, nb, 8, 32).astype(np.float32)
    gmax = x.max(axis=-1)
    gmin = x.min(axis=-1)
    s_g = np.maximum(gmax - np.minimum(gmin, 0.0), 1e-8) / 15.0  # per-group scale
    o_g = np.maximum(-np.minimum(gmin, 0.0), 0.0)  # per-group min offset
    d = np.maximum(s_g.max(axis=-1), 1e-8) / 63.0
    dmin = np.maximum(o_g.max(axis=-1), 1e-10) / 63.0
    sc = np.clip(nearest_int(s_g / d[..., None]), 1, 63).astype(np.uint8)
    m = np.clip(nearest_int(o_g / dmin[..., None]), 0, 63).astype(np.uint8)
    eff_scale = d[..., None] * sc
    eff_min = dmin[..., None] * m
    q = np.clip(nearest_int((x + eff_min[..., None]) / eff_scale[..., None]), 0, 15)
    packed = np.empty((n_rows, nb, 128), dtype=np.uint8)
    for p in range(4):
        packed[..., 32 * p : 32 * p + 32] = (q[..., 2 * p, :] | (q[..., 2 * p + 1, :] << 4)).astype(np.uint8)
    out = np.empty((n_rows, nb, 144), dtype=np.uint8)
    out[..., 0:2] = d.astype(np.float16)[..., None].view(np.uint8)
    out[..., 2:4] = dmin.astype(np.float16)[..., None].view(np.uint8)
    out[..., 4:16] = _q4k_pack_scales(sc, m)
    out[..., 16:] = packed
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Q6_K: 256-elem superblock = 128B ql + 64B qh + 16 int8 scales + f16 d.
# Two 128-column chunks; within a chunk (ql 64B, qh 32B):
#   col  0-31 : (ql[l]    & 0xF) | ((qh[l] >> 0 & 3) << 4)
#   col 32-63 : (ql[l+32] & 0xF) | ((qh[l] >> 2 & 3) << 4)
#   col 64-95 : (ql[l]    >> 4 ) | ((qh[l] >> 4 & 3) << 4)
#   col 96-127: (ql[l+32] >> 4 ) | ((qh[l] >> 6 & 3) << 4)
# value = d * sc[col // 16] * (q - 32).


def decode_q6_k(raw: np.ndarray, n_rows: int, n_cols: int) -> dict[str, np.ndarray]:
    b = _blocks(raw, n_rows, n_cols, GGMLType.Q6_K)
    return {
        "ql": np.ascontiguousarray(b[..., 0:128]),
        "qh": np.ascontiguousarray(b[..., 128:192]),
        "scales": np.ascontiguousarray(b[..., 192:208]).view(np.int8),
        "d": _f16(b[..., 208:210]),
    }


def _q6k_expand(ql: np.ndarray, qh: np.ndarray) -> np.ndarray:
    """Assemble Q6_K 6-bit quants [..., 256] (centered: minus 32 applied)."""
    shape = ql.shape[:-1]
    qlc = ql.reshape(shape + (2, 64)).astype(np.int32)
    qhc = qh.reshape(shape + (2, 32)).astype(np.int32)
    q = np.empty(shape + (2, 128), dtype=np.int32)
    q[..., 0:32] = (qlc[..., 0:32] & 0x0F) | (((qhc >> 0) & 3) << 4)
    q[..., 32:64] = (qlc[..., 32:64] & 0x0F) | (((qhc >> 2) & 3) << 4)
    q[..., 64:96] = (qlc[..., 0:32] >> 4) | (((qhc >> 4) & 3) << 4)
    q[..., 96:128] = (qlc[..., 32:64] >> 4) | (((qhc >> 6) & 3) << 4)
    return q.reshape(shape + (QK_K,)) - 32


def dequant_q6_k(raw: np.ndarray, n_rows: int, n_cols: int) -> np.ndarray:
    f = decode_q6_k(raw, n_rows, n_cols)
    q = _q6k_expand(f["ql"], f["qh"])  # [R, NB, 256]
    sc = f["scales"].astype(np.float32)  # [R, NB, 16] per 16-col group
    d = f["d"].astype(np.float32)[..., None, None]
    qg = q.reshape(q.shape[:-1] + (16, 16)).astype(np.float32)
    with np.errstate(invalid="ignore"):  # arbitrary bytes may hold inf/nan f16 scales
        out = d * sc[..., None] * qg
    return out.reshape(n_rows, n_cols)


def encode_q6_k(w: np.ndarray) -> np.ndarray:
    n_rows, n_cols = w.shape
    nb = n_cols // QK_K
    x = w.reshape(n_rows, nb, 16, 16).astype(np.float32)
    s_g = np.maximum(np.abs(x).max(axis=-1), 1e-8) / 31.0
    d = np.maximum(s_g.max(axis=-1), 1e-8) / 127.0
    sc = np.clip(nearest_int(s_g / d[..., None]), 1, 127).astype(np.int8)
    eff = d[..., None, None] * sc.astype(np.float32)[..., None]
    q = (np.clip(nearest_int(x / eff), -32, 31) + 32).reshape(n_rows, nb, QK_K)
    qc = q.reshape(n_rows, nb, 2, 128)
    ql = np.empty((n_rows, nb, 2, 64), dtype=np.uint8)
    qh = np.empty((n_rows, nb, 2, 32), dtype=np.uint8)
    ql[..., 0:32] = (qc[..., 0:32] & 0x0F) | ((qc[..., 64:96] & 0x0F) << 4)
    ql[..., 32:64] = (qc[..., 32:64] & 0x0F) | ((qc[..., 96:128] & 0x0F) << 4)
    qh[..., :] = (
        (qc[..., 0:32] >> 4)
        | ((qc[..., 32:64] >> 4) << 2)
        | ((qc[..., 64:96] >> 4) << 4)
        | ((qc[..., 96:128] >> 4) << 6)
    ).astype(np.uint8)
    out = np.empty((n_rows, nb, 210), dtype=np.uint8)
    out[..., 0:128] = ql.reshape(n_rows, nb, 128)
    out[..., 128:192] = qh.reshape(n_rows, nb, 64)
    out[..., 192:208] = sc.view(np.uint8)
    out[..., 208:210] = d.astype(np.float16)[..., None].view(np.uint8)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# F16 / BF16 / F32


def dequant_f16(raw: np.ndarray, n_rows: int, n_cols: int) -> np.ndarray:
    return np.ascontiguousarray(raw).view(np.float16).astype(np.float32).reshape(n_rows, n_cols)


def dequant_bf16(raw: np.ndarray, n_rows: int, n_cols: int) -> np.ndarray:
    u16 = np.ascontiguousarray(raw).view(np.uint16).astype(np.uint32) << 16
    return u16.view(np.float32).reshape(n_rows, n_cols)


def dequant_f32(raw: np.ndarray, n_rows: int, n_cols: int) -> np.ndarray:
    return np.ascontiguousarray(raw).view(np.float32).reshape(n_rows, n_cols).copy()


def encode_f16(w: np.ndarray) -> np.ndarray:
    return w.astype(np.float16).reshape(-1).view(np.uint8)


def encode_bf16(w: np.ndarray) -> np.ndarray:
    bits = w.astype(np.float32).reshape(-1).view(np.uint32)
    # round-to-nearest-even truncation to bf16
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)
    return rounded.view(np.uint8)


def encode_f32(w: np.ndarray) -> np.ndarray:
    return w.astype(np.float32).reshape(-1).view(np.uint8)


# ---------------------------------------------------------------------------
# dispatch tables

DEQUANT = {
    GGMLType.F32: dequant_f32,
    GGMLType.F16: dequant_f16,
    GGMLType.BF16: dequant_bf16,
    GGMLType.Q4_0: dequant_q4_0,
    GGMLType.Q5_0: dequant_q5_0,
    GGMLType.Q8_0: dequant_q8_0,
    GGMLType.Q4_K: dequant_q4_k,
    GGMLType.Q6_K: dequant_q6_k,
}

ENCODE = {
    GGMLType.F32: encode_f32,
    GGMLType.F16: encode_f16,
    GGMLType.BF16: encode_bf16,
    GGMLType.Q4_0: encode_q4_0,
    GGMLType.Q5_0: encode_q5_0,
    GGMLType.Q8_0: encode_q8_0,
    GGMLType.Q4_K: encode_q4_k,
    GGMLType.Q6_K: encode_q6_k,
}

DECODE_FIELDS = {
    GGMLType.Q4_0: decode_q4_0,
    GGMLType.Q5_0: decode_q5_0,
    GGMLType.Q8_0: decode_q8_0,
    GGMLType.Q4_K: decode_q4_k,
    GGMLType.Q6_K: decode_q6_k,
}


def dequantize(raw: np.ndarray, fmt: GGMLType, n_rows: int, n_cols: int) -> np.ndarray:
    """Dequantize raw row-major block bytes to float32 [n_rows, n_cols]."""
    fn = DEQUANT.get(GGMLType(fmt))
    if fn is None:
        raise ValueError(f"dequantize: unsupported format {fmt}")
    return fn(raw, n_rows, n_cols)


def encode(w: np.ndarray, fmt: GGMLType) -> np.ndarray:
    """Quantize a float [n_rows, n_cols] array to raw block bytes."""
    fn = ENCODE.get(GGMLType(fmt))
    if fn is None:
        raise ValueError(f"encode: unsupported format {fmt}")
    return np.asarray(fn(np.asarray(w)), dtype=np.uint8)
