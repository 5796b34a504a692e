"""GGUF v3 container writer — the fixture generator for hermetic tests.

The reference's entire test strategy hangs on synthesizing byte-exact GGUF
buffers in memory (reference model_test.cpp:125-391, gguf_test.cpp:24-61);
this is the port's copy of llm_inference_tpu's writer (both produce
identical bytes), a reusable library instead of ad-hoc memcpy code. It
writes containers that both this framework and the reference C++ engine
parse identically, which is what makes the
cross-engine parity harness possible.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Sequence, Union

import numpy as np

from .constants import GGUF_ALIGNMENT, GGUF_MAGIC, GGUF_VERSION, GGUFValueType, GGMLType


def _pack_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


_SCALAR_PACK = {
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


def _infer_type(value: Any) -> GGUFValueType:
    if isinstance(value, bool):
        return GGUFValueType.BOOL
    if isinstance(value, int):
        return GGUFValueType.UINT32 if 0 <= value < 2**32 else GGUFValueType.INT64
    if isinstance(value, float):
        return GGUFValueType.FLOAT32
    if isinstance(value, str):
        return GGUFValueType.STRING
    if isinstance(value, (list, tuple)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF type for {type(value)}")


def _pack_value(value: Any, vtype: GGUFValueType) -> bytes:
    if vtype == GGUFValueType.STRING:
        return _pack_string(value)
    if vtype == GGUFValueType.ARRAY:
        if len(value) == 0:
            raise ValueError("GGUF writer: cannot infer element type of empty array")
        elem_type = _infer_type(value[0])
        out = struct.pack("<I", int(elem_type)) + struct.pack("<Q", len(value))
        return out + b"".join(_pack_value(v, elem_type) for v in value)
    return struct.pack(_SCALAR_PACK[vtype], value)


class GGUFWriter:
    """Builds a GGUF v3 byte buffer from metadata and (auto-quantized) tensors."""

    def __init__(self) -> None:
        self._metadata: list[tuple[str, Any, GGUFValueType]] = []
        # (name, GGUF shape, format, payload size, payload or a callable giving it)
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, int,
                                  Union[bytes, Callable[[], Any]]]] = []

    def add_metadata(self, key: str, value: Any, vtype: GGUFValueType | None = None) -> "GGUFWriter":
        self._metadata.append((key, value, vtype or _infer_type(value)))
        return self

    def add_tensor(
        self,
        name: str,
        data: np.ndarray,
        fmt: GGMLType,
        shape: Sequence[int] | None = None,
        raw: bool = False,
    ) -> "GGUFWriter":
        """Add a tensor.

        ``data`` is either a float array (quantized here via quant.layouts
        encoders) or, with ``raw=True``, pre-encoded block bytes.
        ``shape`` is the GGUF shape (shape[0] = columns); defaults to the
        reversed numpy shape of a 2-D float input so that a numpy
        ``[rows, cols]`` array round-trips naturally.
        """
        if raw:
            payload = np.asarray(data, dtype=np.uint8).tobytes()
            if shape is None:
                raise ValueError("raw tensors need an explicit shape")
            gshape = tuple(int(d) for d in shape)
        else:
            arr = np.asarray(data, dtype=np.float32)
            if shape is None:
                gshape = tuple(int(d) for d in reversed(arr.shape))
            else:
                gshape = tuple(int(d) for d in shape)
            flat2d = arr.reshape(-1, gshape[0]) if len(gshape) > 1 else arr.reshape(1, -1)
            # lazy import: quant.layouts imports gguf.constants, so a
            # top-level import here would make gguf <-> quant circular
            from ..quant.layouts import encode

            payload = encode(flat2d, fmt).tobytes()
        self._tensors.append((name, gshape, fmt, len(payload), payload))
        return self

    def add_tensor_stream(self, name: str, shape: Sequence[int], fmt: GGMLType, nbytes: int,
                          produce: Callable[[], Any]) -> "GGUFWriter":
        """Add a tensor whose ``nbytes`` of encoded blocks ``produce()``
        returns (any buffer) when the container is written, so that
        ``write`` streams a checkpoint larger than memory. ``shape`` is the
        GGUF shape (shape[0] = columns)."""
        self._tensors.append((name, tuple(int(d) for d in shape), fmt, int(nbytes), produce))
        return self

    @staticmethod
    def _payload(entry) -> memoryview:
        name, _, _, nbytes, payload = entry
        data = payload() if callable(payload) else payload
        data = memoryview(data).cast("B")
        if len(data) != nbytes:
            raise ValueError(f"GGUF writer: {name} gave {len(data)} bytes, not {nbytes}")
        return data

    def _header(self) -> bytes:
        out = bytearray()
        out += struct.pack(
            "<IIQQ", GGUF_MAGIC, GGUF_VERSION, len(self._tensors), len(self._metadata)
        )
        for key, value, vtype in self._metadata:
            out += _pack_string(key)
            out += struct.pack("<I", int(vtype))
            out += _pack_value(value, vtype)

        data_offset = 0
        for name, gshape, fmt, nbytes, _ in self._tensors:
            out += _pack_string(name)
            out += struct.pack("<I", len(gshape))
            for d in gshape:
                out += struct.pack("<Q", d)
            out += struct.pack("<I", int(fmt))
            out += struct.pack("<Q", data_offset)
            data_offset += nbytes

        pad = (-len(out)) % GGUF_ALIGNMENT
        out += b"\x00" * pad
        return bytes(out)

    def build(self) -> bytes:
        return self._header() + b"".join(bytes(self._payload(t)) for t in self._tensors)

    def write(self, path: str) -> None:
        """Write the container to ``path``, one tensor's payload at a time."""
        with open(path, "wb") as f:
            f.write(self._header())
            for t in self._tensors:
                f.write(self._payload(t))
