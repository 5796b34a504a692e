"""Linear layers: y = x @ W^T for quantized and dense weights.

Counterpart of llm_inference_tpu/ops/linear.py. ``exact=True`` (the parity
mode, linear.py:41-80) is the reference's numeric contract: the activation
rounds through its weight's contract (``contract_activations``: q8_0, q8_K,
the f16 downcast or none, by the weight's ``act_quant``), the weight
dequantizes to its exact f32 values, and one true-f32 product contracts
them. The JAX package asks the TPU for ``Precision.HIGHEST``; on CUDA the
product must not run at TF32, so it raises unless
``torch.backends.cuda.matmul.allow_tf32`` is off and
``torch.get_float32_matmul_precision()`` is "highest" (the defaults).

``exact=False`` is the serve branch, with its dispatch (linear.py:87-124).
The tensor's device stands where ``jax.default_backend() == "tpu"`` stands:

  CUDA, per-row int8 ``QuantTensor`` (one group a row):
    - rows >= 16384 (the tied-vocab logits), or ``mm_impl="xla"`` (the
      batched server's prefill and per-op decode, linear.py:98-114): W8A8
      ``int8_rowwise_matmul``, plain torch as it was plain XLA;
  CUDA, any ``QuantTensor`` or ``Q4Tensor``, ``mm_impl="auto"``:
    - T <= 64 and cols % 128 == 0: the ``quant_matmul`` or ``q4_matmul``
      CUDA kernel (ops/kernels/qmatmul.py);
    - otherwise: dequantize to bf16 and one plain f32 product.
  CPU: the JAX package's own CPU route, dequantize to bf16 and contract in
  f32, so the CPU tests compare like with like.

A ``ShardedTensor`` (quant/device.py; parallel/sharding.py) runs its ranks
one after the other, each on its own device, from the activations on the
data row's first device (``_sharded_matmul``): a row-parallel weight joins
the ranks' outputs in rank order, a col-parallel one adds the ranks'
partial sums in rank order, and both come back to the activations' device.
The W8A8 decision is the whole weight's; the kernel decision is each
shard's (``supports_kernel`` at the shard's shape). The parity contract and
the W8A8 activation scale are taken over the whole row before it is split
over columns, as the JAX package's global amax and block contracts are: a
shard's columns alone would give another scale. The W8A8 col-parallel sum
adds the ranks' int32 partials, exactly, before the rescale.
"""

from __future__ import annotations

import torch

from ..quant.device import DenseTensor, Q4Tensor, QuantTensor, ShardedTensor
from .actquant import roundtrip_q8_0, roundtrip_q8_k
from .kernels.qmatmul import q4_matmul, quant_matmul, supports_kernel
from .numerics import f16_round

_W8A8_MIN_ROWS = 16384
# Largest contraction chunk whose int8 x int8 partial sums stay exact in f32:
# |xq * q| <= 127 * 127, and 1024 * 127^2 < 2^24.
_EXACT_CHUNK = 1024
_INT_MM_MIN_ROWS = 32  # torch._int_mm on CUDA takes more than 16 rows


def require_true_f32(t: torch.Tensor) -> None:
    """Raise when an f32 product on ``t``'s device would not be true f32:
    on CUDA, TF32 allowed for matmuls or a float32 matmul precision below
    "highest"."""
    if t.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the parity mode's exact products need true f32 on CUDA: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def contract_activations(x: torch.Tensor, act_quant: str) -> torch.Tensor:
    """Round activations through a weight encoding's contract (f32 out)."""
    if act_quant == "q8_0":
        return roundtrip_q8_0(x)
    if act_quant == "q8_k":
        return roundtrip_q8_k(x)
    if act_quant == "f16":
        return f16_round(x.float())
    return x.float()


def matmul(w, x: torch.Tensor, *, exact: bool = False, mm_impl: str = "auto") -> torch.Tensor:
    """y[..., r] = sum_c W[r, c] * x[..., c], f32 out. ``x`` is [..., cols].

    ``exact=True``: the parity contract (the module's notes); ``mm_impl`` is
    then ignored, as in the JAX package. ``exact=False``: serve numerics;
    ``mm_impl="xla"`` sends every per-row int8 weight to the W8A8 product on
    CUDA (the JAX package's name for "no kernel grids"), ``"auto"`` is the
    single-stream dispatch."""
    if x.shape[-1] != w.cols:
        raise ValueError(f"matmul: x has {x.shape[-1]} features, weight expects {w.cols}")
    if mm_impl not in ("auto", "xla"):
        raise ValueError(f"unknown mm_impl {mm_impl!r}")
    if isinstance(w, ShardedTensor):
        return _sharded_matmul(w, x, exact, mm_impl)
    if exact:
        require_true_f32(x)
        return contract_activations(x, w.act_quant) @ w.dequant(torch.float32).T
    lead = x.shape[:-1]
    t = 1
    for d in lead:
        t *= d
    x2 = x.reshape(t, w.cols)
    if isinstance(w, (QuantTensor, Q4Tensor)):
        if _w8a8(w, x, mm_impl):
            y = int8_rowwise_matmul(w, x2)
        elif x.is_cuda and mm_impl == "auto" and supports_kernel(w, t):
            y = q4_matmul(w, x2) if isinstance(w, Q4Tensor) else quant_matmul(w, x2)
        else:
            y = _dense_matmul(w.dequant(torch.bfloat16), x2)
    else:
        y = _dense_matmul(w.w, x2)
    return y.reshape(*lead, w.rows)


def _w8a8(w, x: torch.Tensor, mm_impl: str) -> bool:
    """Whether a per-row int8 weight (``w`` whole, or the whole of a sharded
    one) takes the W8A8 product: on CUDA, at the tied vocab's rows or under
    ``mm_impl="xla"``."""
    qt = w.local if isinstance(w, ShardedTensor) else w
    rowwise = isinstance(qt, QuantTensor) and qt.groups == 1
    return x.is_cuda and rowwise and (w.rows >= _W8A8_MIN_ROWS or mm_impl == "xla")


def _sharded_matmul(w: ShardedTensor, x: torch.Tensor, exact: bool,
                    mm_impl: str) -> torch.Tensor:
    """``matmul`` over the ranks of a ``ShardedTensor`` (the module's notes):
    f32 [..., rows] on x's device."""
    home = x.device
    lead = x.shape[:-1]
    x2 = x.reshape(-1, w.cols)
    cols = w.cols // w.n if w.dim == 1 else w.cols

    def xs(r, s, xr):  # rank r's activations: its columns under the col policy
        return (xr[:, r * cols:(r + 1) * cols] if w.dim == 1 else xr).contiguous().to(
            _device_of(s))

    parts = [None] * w.n
    if exact:
        require_true_f32(x)
        xc = contract_activations(x2, w.act_quant)  # the whole row's blocks
        for r, s in w.ranks():
            parts[r] = xs(r, s, xc) @ s.dequant(torch.float32).T
    elif _w8a8(w, x, mm_impl):
        xq, d = quantize_rows(x2)  # the whole row's scale (XLA's global amax)
        for r, s in w.ranks():
            acc = int8_dot(xs(r, s, xq), s.q)
            if w.dim == 0:
                acc = acc.float() * d.to(acc.device) * s.scale[:, 0][None, :]
            parts[r] = acc
        if w.dim == 1:  # int32 partials: an exact sum, then the rescale
            acc = _rank_sum(w.mesh.gather(parts, w.data_row, home))
            return (acc.float() * d * w.local.scale.to(home)[:, 0][None, :]).reshape(*lead, w.rows)
    else:
        for r, s in w.ranks():
            parts[r] = matmul(s, xs(r, s, x2), mm_impl=mm_impl)
    ys = w.mesh.gather(parts, w.data_row, home)
    y = w.join_rows(ys) if w.dim == 0 else _rank_sum(ys)
    return y.reshape(*lead, w.rows)


def _device_of(w) -> torch.device:
    return (w.w if isinstance(w, DenseTensor) else w.scale).device


def _rank_sum(parts: list) -> torch.Tensor:
    """The ranks' partial sums added in rank order (tp.cuh's all-reduce
    order): deterministic, the same on every device that computes it."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _dense_matmul(wd: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """x cast to the weight's dtype, f32 products and sums (XLA's
    ``preferred_element_type=f32`` dot)."""
    return x2.to(wd.dtype).float() @ wd.float().T


def int8_rowwise_matmul(w: QuantTensor, x: torch.Tensor) -> torch.Tensor:
    """W8A8: per-row int8 weight x per-row int8 activation, one exact integer
    contraction, rescaled by both scales. x: [T, C] -> [T, R].

    On CUDA the contraction is ``torch._int_mm`` (int8 in, int32 sums, the
    counterpart of the JAX package's XLA int8 dot); it needs more than 16
    rows of x, so x is padded with zero rows to at least 32. Elsewhere, a
    single f32 product of the int8 values is not exact once its sums pass
    2^24, so the contraction runs in f32 over column chunks of at most 1024,
    where every partial sum is an integer below 2^24 and hence exact in any
    order, and the chunk results add up in int32. Both are exact, so both
    give the same numbers."""
    if w.groups != 1:
        raise ValueError("int8_rowwise_matmul takes a per-row weight; a grouped one would lose "
                         "its group scales")
    xq, d = quantize_rows(x)
    return int8_dot(xq, w.q).float() * d * w.scale[:, 0][None, :]


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 activations: (xq int8 [T, C], d f32 [T, 1])
    with x ~= xq * d, d = amax / 127 (1 for an all-zero row)."""
    x2 = x.float()
    amax = x2.abs().amax(dim=-1, keepdim=True)
    d = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(x2 / d), -127, 127).to(torch.int8), d


def int8_dot(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact int32 sums of int8 products: xq [T, C] . q[R, C]^T -> [T, R]."""
    T, C = xq.shape
    R = q.shape[0]
    if xq.is_cuda and C % 8 == 0 and R % 8 == 0:
        xi = torch.zeros((max(_INT_MM_MIN_ROWS, -(-T // 8) * 8), C), dtype=torch.int8,
                         device=xq.device)
        xi[:T] = xq
        return torch._int_mm(xi, q.t())[:T]
    xf = xq.float()
    acc = torch.zeros((T, R), dtype=torch.int32, device=xq.device)
    for c0 in range(0, C, _EXACT_CHUNK):
        c1 = min(c0 + _EXACT_CHUNK, C)
        acc += (xf[:, c0:c1] @ q[:, c0:c1].float().T).to(torch.int32)
    return acc


def embed_rows(w, token_ids: torch.Tensor) -> torch.Tensor:
    """Gather + dequantize embedding rows [..., cols] f32 (reference
    embed_tokens, model.cpp:240-334): only the touched rows dequantize.

    Over a vocab-sharded ``ShardedTensor`` each rank gathers the ids in its
    row range (an id outside it reads a clamped row, which is dropped), and
    the ranks' rows meet in rank order on the ids' device. Exactly one rank holds an
    id, so the sum is exact; it is taken as that rank's pick (``where``),
    which keeps even a zero's sign."""
    if isinstance(w, ShardedTensor):
        if w.dim != 0:
            raise ValueError("embed_rows: an embedding shards its rows (the vocabulary)")
        per = w.rows // w.n
        parts = [None] * w.n
        for r, s in w.ranks():
            ids = token_ids.to(_device_of(s)) - r * per
            parts[r] = embed_rows(s, ids.clamp(0, per - 1))
        ys = w.mesh.gather(parts, w.data_row, token_ids.device)
        out = ys[0]
        for r in range(1, w.n):
            out = torch.where((token_ids >= r * per)[..., None], ys[r], out)
        return out
    if isinstance(w, DenseTensor):
        return w.w[token_ids].float()
    rows = w.q[token_ids].float().unflatten(-1, (w.groups, w.group_size))
    rows = rows * w.scale[token_ids][..., None]
    if w.offset is not None:
        rows = rows - w.offset[token_ids][..., None]
    return rows.flatten(-2)
