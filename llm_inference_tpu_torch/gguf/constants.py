"""GGUF container constants and type enums.

Semantics follow the GGUF v3 spec as implemented by the reference engine
(reference gguf.h:10-46); values are part of the on-disk format, not
reference-specific.
"""

from __future__ import annotations

import enum

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
GGUF_VERSION = 3
GGUF_ALIGNMENT = 32  # reference gguf.cpp:302 hardcodes 32-byte data alignment


class GGUFValueType(enum.IntEnum):
    """Metadata value types (reference gguf.h:14-28)."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    """Tensor data encodings (reference gguf.h:30-46)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    BF16 = 30


# Block geometry per encoding: (elements per block, bytes per block).
# Layouts follow ggml; see quant/layouts.py for the bit-level unpacking.
QK = 32  # small-block quant group size
QK_K = 256  # K-quant superblock size
K_SCALE_SIZE = 12

BLOCK_GEOMETRY: dict[GGMLType, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.Q4_0: (QK, 2 + 16),          # f16 scale + 32 nibbles
    GGMLType.Q5_0: (QK, 2 + 4 + 16),      # f16 scale + 32 high bits + nibbles
    GGMLType.Q8_0: (QK, 2 + 32),          # f16 scale + 32 int8
    GGMLType.Q4_K: (QK_K, 2 + 2 + K_SCALE_SIZE + QK_K // 2),
    GGMLType.Q6_K: (QK_K, QK_K // 2 + QK_K // 4 + QK_K // 16 + 2),
}


def type_name(t: int) -> str:
    try:
        return GGMLType(t).name
    except ValueError:
        return f"UNKNOWN ({t})"


def block_geometry(t: GGMLType) -> tuple[int, int]:
    """Return (elements_per_block, bytes_per_block) for tensor type ``t``."""
    try:
        return BLOCK_GEOMETRY[GGMLType(t)]
    except KeyError:
        raise ValueError(f"unsupported tensor type {type_name(t)}") from None


def row_size_bytes(t: GGMLType, n_cols: int) -> int:
    """Bytes of one row of ``n_cols`` elements stored as type ``t``."""
    elems, nbytes = block_geometry(t)
    if n_cols % elems != 0:
        raise ValueError(f"row of {n_cols} not divisible by {elems}-block of {type_name(t)}")
    return n_cols // elems * nbytes
