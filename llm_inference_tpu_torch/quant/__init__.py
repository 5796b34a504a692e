from . import layouts
from .layouts import dequantize, encode

__all__ = ["layouts", "dequantize", "encode"]
