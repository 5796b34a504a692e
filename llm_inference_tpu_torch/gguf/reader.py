"""Zero-copy GGUF v3 container reader.

Counterpart of the reference's mmap reader (reference gguf.cpp:115-304),
a copy of llm_inference_tpu's reader, so both packages parse a checkpoint
identically: the file is memory-mapped once, metadata and the tensor
directory are parsed eagerly, and tensor payloads are exposed as zero-copy
numpy views over the mapped bytes so the quant layer can reinterpret block
layouts without materializing anything. A bytes/bytearray constructor makes
hermetic in-memory tests possible (the reference's buffer ctor,
gguf.cpp:265-270, is what its whole test strategy hangs on).
"""

from __future__ import annotations

import dataclasses
import mmap
import struct
from typing import Any, BinaryIO, Union

import numpy as np

from .constants import (
    GGUF_ALIGNMENT,
    GGUF_MAGIC,
    GGUFValueType,
    GGMLType,
    block_geometry,
    row_size_bytes,
    type_name,
)

_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


@dataclasses.dataclass(frozen=True)
class GGUFHeader:
    magic: int
    version: int
    tensor_count: int
    metadata_kv_count: int


@dataclasses.dataclass
class TensorInfo:
    """Directory entry for one tensor (reference gguf.h:81-87).

    ``shape`` is in GGUF order: shape[0] is the fastest-varying (column /
    input-feature) dimension, shape[1] the row / output dimension.
    """

    name: str
    shape: tuple[int, ...]
    tensor_type: GGMLType
    offset: int  # relative to the data section start

    @property
    def total_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def n_cols(self) -> int:
        return self.shape[0] if self.shape else 1

    @property
    def n_rows(self) -> int:
        n = 1
        for d in self.shape[1:]:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.n_rows * row_size_bytes(self.tensor_type, self.n_cols)


class _Cursor:
    """Sequential little-endian decoder over a buffer."""

    def __init__(self, buf: Union[bytes, bytearray, memoryview, mmap.mmap]):
        self.buf = buf
        self.pos = 0

    def read_fmt(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        if self.pos + size > len(self.buf):
            raise ValueError("GGUF: read beyond end of buffer")
        (value,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return value

    def read_string(self) -> str:
        length = self.read_fmt("<Q")
        if self.pos + length > len(self.buf):
            raise ValueError("GGUF: string length exceeds buffer")
        s = bytes(self.buf[self.pos : self.pos + length]).decode("utf-8", errors="replace")
        self.pos += length
        return s

    def read_value(self, vtype: GGUFValueType) -> Any:
        if vtype == GGUFValueType.STRING:
            return self.read_string()
        if vtype == GGUFValueType.ARRAY:
            elem_type = GGUFValueType(self.read_fmt("<I"))
            count = self.read_fmt("<Q")
            return [self.read_value(elem_type) for _ in range(count)]
        fmt = _SCALAR_FMT.get(vtype)
        if fmt is None:
            raise ValueError(f"GGUF: unsupported value type {vtype}")
        return self.read_fmt(fmt)


class GGUFFile:
    """Parsed GGUF container with zero-copy tensor payload access.

    Construct from a file path (memory-mapped read-only) or from an
    in-memory ``bytes``/``bytearray`` buffer.
    """

    def __init__(self, source: Union[str, bytes, bytearray]):
        self._file: BinaryIO | None = None
        self._mmap: mmap.mmap | None = None
        if isinstance(source, str):
            self._file = open(source, "rb")
            self._mmap = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
            self._data: Union[bytes, mmap.mmap] = self._mmap
        elif isinstance(source, (bytes, bytearray)):
            self._data = bytes(source)
        else:
            raise TypeError(f"GGUFFile: unsupported source {type(source)}")
        self._load()

    # -- parsing ------------------------------------------------------------

    def _load(self) -> None:
        cur = _Cursor(self._data)
        magic = cur.read_fmt("<I")
        if magic != GGUF_MAGIC:
            raise ValueError("GGUF: invalid magic number")
        version = cur.read_fmt("<I")
        tensor_count = cur.read_fmt("<Q")
        metadata_kv_count = cur.read_fmt("<Q")
        self.header = GGUFHeader(magic, version, tensor_count, metadata_kv_count)

        self.metadata: dict[str, Any] = {}
        for _ in range(metadata_kv_count):
            key = cur.read_string()
            vtype = GGUFValueType(cur.read_fmt("<I"))
            self.metadata[key] = cur.read_value(vtype)

        self.tensors: dict[str, TensorInfo] = {}
        self.tensor_infos: list[TensorInfo] = []
        for _ in range(tensor_count):
            name = cur.read_string()
            n_dims = cur.read_fmt("<I")
            shape = tuple(cur.read_fmt("<Q") for _ in range(n_dims))
            ttype = cur.read_fmt("<I")
            offset = cur.read_fmt("<Q")
            info = TensorInfo(name=name, shape=shape, tensor_type=GGMLType(ttype), offset=offset)
            self.tensor_infos.append(info)
            self.tensors[name] = info

        # Data section starts at the next 32-byte boundary after the directory
        # (reference gguf.cpp:301-303; general.alignment metadata is ignored
        # there, and we mirror that for format parity).
        self.data_section_start = (cur.pos + GGUF_ALIGNMENT - 1) & ~(GGUF_ALIGNMENT - 1)

    # -- tensor access ------------------------------------------------------

    def tensor_bytes(self, info: TensorInfo) -> np.ndarray:
        """Zero-copy uint8 view of a tensor's raw (possibly quantized) payload."""
        start = self.data_section_start + info.offset
        end = start + info.nbytes
        if end > len(self._data):
            raise ValueError(f"GGUF: tensor {info.name} extends beyond end of file")
        return np.frombuffer(self._data, dtype=np.uint8, count=info.nbytes, offset=start)

    def tensor_row_bytes(self, info: TensorInfo, row: int) -> np.ndarray:
        """Zero-copy uint8 view of one row's payload (for gather-style loads)."""
        rb = row_size_bytes(info.tensor_type, info.n_cols)
        start = self.data_section_start + info.offset + row * rb
        return np.frombuffer(self._data, dtype=np.uint8, count=rb, offset=start)

    def tensor_f32(self, info: TensorInfo) -> np.ndarray:
        """Raw F32 tensor as a float32 view shaped [rows, cols] (1-D stays 1-D)."""
        if info.tensor_type != GGMLType.F32:
            raise ValueError(f"{info.name} is {type_name(info.tensor_type)}, not F32")
        flat = self.tensor_bytes(info).view(np.float32)
        if len(info.shape) == 1:
            return flat
        return flat.reshape(info.n_rows, info.n_cols)

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    def close(self) -> None:
        if self._mmap is not None:
            self._mmap.close()
            self._mmap = None
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "GGUFFile":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
