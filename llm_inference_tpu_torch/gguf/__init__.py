from .constants import (
    GGUF_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    block_geometry,
    row_size_bytes,
    type_name,
)
from .reader import GGUFFile, GGUFHeader, TensorInfo
from .writer import GGUFWriter

__all__ = [
    "GGUF_ALIGNMENT",
    "GGUF_MAGIC",
    "GGUF_VERSION",
    "GGMLType",
    "GGUFValueType",
    "GGUFFile",
    "GGUFHeader",
    "GGUFWriter",
    "TensorInfo",
    "block_geometry",
    "row_size_bytes",
    "type_name",
]
