"""Serve-mode linear layers: y = x @ W^T for per-row int8 and dense weights.

Counterpart of the serve branch (``exact=False``) of
llm_inference_tpu/ops/linear.py, with its dispatch (linear.py:94-124). The
tensor's device stands where ``jax.default_backend() == "tpu"`` stands:

  CUDA, per-row int8 ``QuantTensor``:
    - rows >= 16384 (the tied-vocab logits): W8A8 ``int8_rowwise_matmul``,
      plain torch as it was plain XLA;
    - T <= 64 and cols % 128 == 0: the ``quant_matmul`` CUDA kernel
      (ops/kernels/qmatmul.py);
    - otherwise: dequantize to bf16 and one plain f32 product.
  CPU: the JAX package's own CPU route, dequantize to bf16 and contract in
  f32, so the CPU tests compare like with like.
"""

from __future__ import annotations

import torch

from ..quant.device import DenseTensor, QuantTensor
from .kernels.qmatmul import quant_matmul, supports_kernel

_W8A8_MIN_ROWS = 16384
# Largest contraction chunk whose int8 x int8 partial sums stay exact in f32:
# |xq * q| <= 127 * 127, and 1024 * 127^2 < 2^24.
_EXACT_CHUNK = 1024


def matmul(w, x: torch.Tensor) -> torch.Tensor:
    """y[..., r] = sum_c W[r, c] * x[..., c], f32 out (serve numerics).
    ``x`` is [..., cols]."""
    if x.shape[-1] != w.cols:
        raise ValueError(f"matmul: x has {x.shape[-1]} features, weight expects {w.cols}")
    lead = x.shape[:-1]
    t = 1
    for d in lead:
        t *= d
    x2 = x.reshape(t, w.cols)
    if isinstance(w, QuantTensor):
        if x.is_cuda and w.rows >= _W8A8_MIN_ROWS:
            y = int8_rowwise_matmul(w, x2)
        elif x.is_cuda and supports_kernel(w, t):
            y = quant_matmul(w, x2)
        else:
            y = _dense_matmul(w.dequant(torch.bfloat16), x2)
    else:
        y = _dense_matmul(w.w, x2)
    return y.reshape(*lead, w.rows)


def _dense_matmul(wd: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """x cast to the weight's dtype, f32 products and sums (XLA's
    ``preferred_element_type=f32`` dot)."""
    return x2.to(wd.dtype).float() @ wd.float().T


def int8_rowwise_matmul(w: QuantTensor, x: torch.Tensor) -> torch.Tensor:
    """W8A8: per-row int8 weight x per-row int8 activation, one exact integer
    contraction, rescaled by both scales. x: [T, C] -> [T, R].

    ``torch._int_mm`` needs more than 16 rows of x, and a single f32 product
    of the int8 values is not exact once its sums pass 2^24. So the
    contraction runs in f32 over column chunks of at most 1024, where every
    partial sum is an integer below 2^24 and hence exact in any order
    (TF32 too: int8 values are exact in its 10-bit mantissa), and the chunk
    results add up in int32."""
    x2 = x.float()
    amax = x2.abs().amax(dim=-1, keepdim=True)
    d = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    xq = torch.clamp(torch.round(x2 / d), -127, 127)
    acc = torch.zeros((x2.shape[0], w.rows), dtype=torch.int32, device=x2.device)
    for c0 in range(0, w.cols, _EXACT_CHUNK):
        c1 = min(c0 + _EXACT_CHUNK, w.cols)
        acc += (xq[:, c0:c1] @ w.q[:, c0:c1].float().T).to(torch.int32)
    return acc.float() * d * w.scale[:, 0][None, :]


def embed_rows(w, token_ids: torch.Tensor) -> torch.Tensor:
    """Gather + dequantize embedding rows [..., cols] f32 (reference
    embed_tokens, model.cpp:240-334): only the touched rows dequantize."""
    if isinstance(w, DenseTensor):
        return w.w[token_ids].float()
    return w.q[token_ids].float() * w.scale[token_ids]
