"""Activation quantizers: the q8_0 and q8_K contracts of the parity mode.

Counterpart of llm_inference_tpu/ops/actquant.py. The reference quantizes
the f32 activation on the fly before every integer GEMV (reference
ops.cpp:116-178); the parity mode's exact matmul (ops/linear.py) rounds the
activation through the same contract and contracts it with the exactly
dequantized weight in f32, which equals the reference's integer dot with
its bsums min-correction (ops.cpp:614-706).

  q8_0 (blocks of 32, for Q4_0 and Q8_0 weights, ops.cpp:116-139):
      d  = amax / 127, stored through f16
      q  = nearest_int(x * (1 / d))        (the inverse of the unrounded d)
      x' = q * f32(f16(d))
  q8_K (blocks of 256, for Q4_K and Q6_K weights, ops.cpp:142-178):
      iscale = -127 / max   (max: the signed value of the first largest |x|)
      q      = clamp(nearest_int(iscale * x), -128, 127)
      d      = 1 / iscale, kept in f32
      bsums  = sums of q over 16-element runs
"""

from __future__ import annotations

import torch

from .numerics import f16_round, nearest_int


# A Python number over a tensor is, in torch, the tensor's reciprocal times
# that number: two roundings. Every quotient here divides tensor by tensor,
# one correctly rounded division, as in the reference and the JAX package.


def _to_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    if x.shape[-1] % block:
        raise ValueError(f"activation length {x.shape[-1]} not a multiple of {block}")
    return x.unflatten(-1, (x.shape[-1] // block, block))


def quantize_q8_0(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., N] -> (d [..., N/32] f32 holding f16 values, q [..., N/32, 32]
    int32)."""
    xb = _to_blocks(x.float(), 32)
    d = xb.abs().amax(dim=-1) / 127.0
    one = torch.ones_like(d)
    inv = torch.where(d > 0, one / torch.where(d > 0, d, one), torch.zeros_like(d))
    q = nearest_int(xb * inv[..., None])
    return f16_round(d), q


def roundtrip_q8_0(x: torch.Tensor) -> torch.Tensor:
    """Quantize and dequantize activations through the q8_0 contract."""
    d, q = quantize_q8_0(x)
    return (q.float() * d[..., None]).reshape(x.shape)


def quantize_q8_k(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., N] -> (d [..., N/256] f32, q [..., N/256, 256] int32,
    bsums [..., N/256, 16] int32)."""
    xb = _to_blocks(x.float(), 256)
    absx = xb.abs()
    idx = torch.argmax(absx, dim=-1, keepdim=True)  # the first of equal maxima
    amax = torch.take_along_dim(absx, idx, dim=-1)[..., 0]
    smax = torch.take_along_dim(xb, idx, dim=-1)[..., 0]
    nonzero = amax > 0
    one, zero = torch.ones_like(amax), torch.zeros_like(amax)
    iscale = torch.where(nonzero, torch.full_like(smax, -127.0) / torch.where(nonzero, smax, one),
                         zero)
    q = torch.clamp(nearest_int(iscale[..., None] * xb), -128, 127)
    q = torch.where(nonzero[..., None], q, torch.zeros_like(q))
    d = torch.where(nonzero, one / torch.where(nonzero, iscale, one), zero)
    bsums = q.unflatten(-1, (16, 16)).sum(dim=-1, dtype=torch.int32)
    return d, q, bsums


def roundtrip_q8_k(x: torch.Tensor) -> torch.Tensor:
    """Quantize and dequantize activations through the q8_K contract."""
    d, q, _ = quantize_q8_k(x)
    return (q.float() * d[..., None]).reshape(x.shape)
