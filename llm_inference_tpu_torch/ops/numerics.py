"""Core numerics: RMS norm, NeoX RoPE, tanh GELU, softcap, f16 rounding points.

Counterpart of llm_inference_tpu/ops/numerics.py (reference ops.cpp:28-113,
model.cpp:504-541). Plain torch on the trailing axis, in f32. ``f16_round``
and ``nearest_int`` are the parity mode's rounding points; both round to
nearest, ties to even, as the reference and the JAX package do.
"""

from __future__ import annotations

import math

import torch


def f16_round(x: torch.Tensor) -> torch.Tensor:
    """Round through IEEE binary16 and back, to nearest even (the
    reference's f32_to_f16 / f16_to_f32 pair, gguf.cpp:40-97): the parity
    mode's K/V stores, the Q downcast before the QK dot (model.cpp:504-509),
    the f16 activation contract and the q8_0 scale's storage."""
    return x.to(torch.float16).to(x.dtype)


def nearest_int(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest, ties to even, as int32: the reference's
    magic-number ``nearest_int`` (ops.cpp:107-113) adds 2^23 + 2^22 in f32,
    which rounds ties to even like ``torch.round``."""
    return torch.round(x).to(torch.int32)


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """x / sqrt(mean(x^2) + eps) over the trailing axis (reference
    ops.cpp:28-43); the caller multiplies the weight."""
    x = x.float()
    mean_sq = torch.mean(x * x, dim=-1, keepdim=True)
    return x / torch.sqrt(mean_sq + eps)


def rope(x: torch.Tensor, *, n_rot: int, freq_base: float, freq_scale: float,
         pos: torch.Tensor) -> torch.Tensor:
    """NeoX-style split-half rotary embedding (reference ops.cpp:67-95).

    ``x`` is [..., T, H, D] with D >= n_rot; pair (i, i + n_rot/2) rotates by
    angle pos * base^(-2i/n_rot) / freq_scale. ``pos`` holds the absolute
    position of each of the T tokens, shape [T] (or a scalar)."""
    half = n_rot // 2
    i = torch.arange(half, dtype=torch.float32, device=x.device)
    # a Python scalar base: no host-to-device copy (which would wait for the stream)
    freq = 1.0 / torch.pow(float(freq_base), 2.0 * i / n_rot)  # [half]
    pos = torch.as_tensor(pos, device=x.device).to(torch.float32)
    if pos.ndim == 0:
        pos = pos[None]
    val = pos[:, None] * freq[None, :] / torch.tensor(freq_scale, dtype=torch.float32)
    cos = torch.cos(val)[:, None, :]  # [T, 1, half]
    sin = torch.sin(val)[:, None, :]

    x = x.float()
    x0 = x[..., :half]
    x1 = x[..., half : 2 * half]
    r0 = x0 * cos - x1 * sin
    r1 = x0 * sin + x1 * cos
    if x.shape[-1] > 2 * half:
        return torch.cat([r0, r1, x[..., 2 * half :]], dim=-1)
    return torch.cat([r0, r1], dim=-1)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximated GELU (reference model.cpp:884-889)."""
    x = x.float()
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """cap * tanh(x / cap) (reference model.cpp:511-513, 1036-1041);
    ``cap`` <= 0 disables."""
    if cap is None or cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)
