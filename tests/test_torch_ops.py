"""The port's numerics, embedding gather, serve matmuls and the plain
``quant_matmul`` against llm_inference_tpu's, on the CPU.

Inputs come from numpy seeds and go through both packages. Tolerances:
the numerics are the same f32 formulas (1e-6 relative: libm and XLA may
differ in an ulp); the embedding gather and the W8A8 product are exact
integer/one-multiply arithmetic (bit-equal); the plain ``quant_matmul``
and the dequant-route matmul compute exact products and differ from the
JAX kernel / XLA dot only in f32 summation order (1e-5 * max(1, max|y|))."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_inference_tpu.gguf import GGMLType as JGGMLType
from llm_inference_tpu.ops import linear as jlinear
from llm_inference_tpu.ops import numerics as jnum
from llm_inference_tpu.quant.device import DenseTensor as JDenseTensor
from llm_inference_tpu.ops.pallas import quant_matmul as jax_quant_matmul
from llm_inference_tpu.quant.device import requantize_rowwise as jax_requantize_rowwise
from llm_inference_tpu_torch.gguf import GGMLType
from llm_inference_tpu_torch.ops import linear, numerics
from llm_inference_tpu_torch.ops.kernels import qmatmul
from llm_inference_tpu_torch.quant import layouts
from llm_inference_tpu_torch.quant.device import DenseTensor, requantize_rowwise

from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)


def _rowq8(seed, rows, cols, fmt="Q4_0"):
    w = (np.random.default_rng(seed).standard_normal((rows, cols)) * 0.3).astype(np.float32)
    raw = layouts.encode(w, GGMLType[fmt])
    return (requantize_rowwise(GGMLType[fmt], raw, rows, cols),
            jax_requantize_rowwise(JGGMLType[fmt], raw, rows, cols))


def _close(got, ref, rel):
    got, ref = np.asarray(got, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(1.0, np.abs(ref).max()))


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("name", ["rms_norm", "gelu_tanh", "softcap", "rope_pos_vector",
                                  "rope_scalar_pos_partial"])
def test_numerics_match_jax(name):
    x = _x(0, 5, 4, 128, scale=2.0)
    if name == "rms_norm":
        got, ref = numerics.rms_norm(torch.from_numpy(x), 1e-6), jnum.rms_norm(jnp.asarray(x), 1e-6)
    elif name == "gelu_tanh":
        got, ref = numerics.gelu_tanh(torch.from_numpy(x)), jnum.gelu_tanh(jnp.asarray(x))
    elif name == "softcap":
        got, ref = numerics.softcap(torch.from_numpy(x), 3.0), jnum.softcap(jnp.asarray(x), 3.0)
        np.testing.assert_array_equal(numerics.softcap(torch.from_numpy(x), 0.0).numpy(), x)
    elif name == "rope_pos_vector":
        pos = np.array([0, 3, 17, 1000, 4095], dtype=np.int32)
        got = numerics.rope(torch.from_numpy(x), n_rot=128, freq_base=1e6, freq_scale=1.0,
                            pos=torch.from_numpy(pos))
        ref = jnum.rope(jnp.asarray(x), n_rot=128, freq_base=1e6, freq_scale=1.0,
                        pos=jnp.asarray(pos))
    else:
        got = numerics.rope(torch.from_numpy(x[:1]), n_rot=64, freq_base=1e4, freq_scale=1.0,
                            pos=torch.tensor(7))
        ref = jnum.rope(jnp.asarray(x[:1]), n_rot=64, freq_base=1e4, freq_scale=1.0, pos=7)
    _close(got.numpy(), ref, 1e-6 if "rope" not in name else 2e-6)


def test_embed_rows_bit_equal():
    t, j = _rowq8(1, 64, 256, "Q8_0")
    ids = np.array([0, 5, 5, 63, 17], dtype=np.int32)
    np.testing.assert_array_equal(linear.embed_rows(t, torch.from_numpy(ids).long()).numpy(),
                                  np.asarray(jlinear.embed_rows(j, jnp.asarray(ids))))


@pytest.mark.parametrize("T,C", [(1, 256), (3, 2048), (20, 1152)])
def test_int8_rowwise_matmul_matches_jax(T, C):
    """W8A8 is an exact integer contraction on both sides (the port chunks C
    so its f32 partial sums stay exact, below 2^24): bit-equal."""
    t, j = _rowq8(2, 96, C)
    x = _x(3, T, C, scale=3.0)
    got = linear.int8_rowwise_matmul(t, torch.from_numpy(x)).numpy()
    ref = np.asarray(jlinear.int8_rowwise_matmul(j, jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)


def test_int8_rowwise_matmul_exact_beyond_f32_integers():
    """Saturated int8 operands over C = 4096: the integer sums pass 2^24, where
    one f32 dot would round; the chunked contraction stays exact."""
    C = 4096
    q = torch.full((2, C), 127, dtype=torch.int8)
    q[1, ::2] = -127
    qt = qmatmul.QuantTensor(q=q, scale=torch.ones(2, 1), fmt=None, rows=2, cols=C)
    x = torch.full((1, C), 1.0)
    x[0, 1] = 1.0 + 2 ** -9  # quantizes to 127 like its neighbours
    y = linear.int8_rowwise_matmul(qt, x)
    d = float(x.abs().max()) / 127.0
    np.testing.assert_array_equal(y.numpy(), np.float32([[127 * 127 * C, 0]]) * np.float32(d))


@pytest.mark.parametrize("T", [1, 8, 64])
def test_plain_quant_matmul_matches_jax_kernel(T):
    """The plain twin of the CUDA kernel against the Pallas kernel in
    interpret mode (tests/test_pallas_qmatmul.py's way of running it)."""
    t, j = _rowq8(4, 256, 512)
    x = _x(5, T, 512)
    got = qmatmul.quant_matmul(t, torch.from_numpy(x))  # CPU tensor: the plain twin
    ref = np.asarray(jax_quant_matmul(j, jnp.asarray(x), interpret=True))
    _close(got.numpy(), ref, 1e-5)


@pytest.mark.parametrize("lead", [(), (1,), (4,), (2, 3)])
def test_matmul_cpu_route_matches_jax(lead):
    """On the CPU both packages dequantize to bf16 and contract in f32."""
    t, j = _rowq8(6, 128, 256)
    x = _x(7, *lead, 256)
    got = linear.matmul(t, torch.from_numpy(x))
    ref = jlinear.matmul(j, jnp.asarray(x), exact=False)
    assert tuple(got.shape) == tuple(ref.shape)
    _close(got.numpy(), ref, 1e-5)


def test_kernel_dispatch_rules():
    t, _ = _rowq8(8, 64, 256)
    assert qmatmul.supports_kernel(t, 1) and qmatmul.supports_kernel(t, 64)
    assert not qmatmul.supports_kernel(t, 65)
    t2, _ = _rowq8(8, 64, 96)  # cols not a multiple of 128
    assert not qmatmul.supports_kernel(t2, 1)
    with pytest.raises(ValueError):
        qmatmul.quant_matmul(t, torch.zeros(2, 128))
    # the rowwise format's plan: C split on whole 128-column stages, and at
    # the 1B shapes as far as the 132 SMs hold one block of each row tile
    for R, C in ((1536, 1152), (1152, 1024), (13824, 1152), (1152, 6912), (100, 128)):
        p = qmatmul.plan(R, C, 32, False, None, False, 132)
        assert 1 <= p.splits <= max(1, C // 128) == p.row_stages
        assert p.row_tiles * p.splits >= min(132 - p.row_tiles + 1, p.row_tiles * (C // 128))


@pytest.mark.parametrize("fmt", ["F32", "F16", "BF16"])
def test_dense_matmul_and_embed_match_jax(fmt):
    """A weight kept in its native dtype: the activation cast to that dtype,
    exact products, f32 sums in another order (1e-5 * max(1, max|y|)); the
    embedding gather is a cast (bit-equal)."""
    dtype = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}[fmt]
    w = torch.from_numpy(_x(9, 48, 256)).to(dtype)
    t = DenseTensor(w=w, fmt=GGMLType[fmt], rows=48, cols=256)
    j = JDenseTensor(w=jnp.asarray(w.float().numpy()).astype(
        {"F32": jnp.float32, "F16": jnp.float16, "BF16": jnp.bfloat16}[fmt]),
        fmt=JGGMLType[fmt], rows=48, cols=256)
    x = _x(10, 3, 256)
    _close(linear.matmul(t, torch.from_numpy(x)).numpy(),
           jlinear.matmul(j, jnp.asarray(x), exact=False), 1e-5)
    ids = np.array([0, 47, 3], dtype=np.int32)
    np.testing.assert_array_equal(linear.embed_rows(t, torch.from_numpy(ids).long()).numpy(),
                                  np.asarray(jlinear.embed_rows(j, jnp.asarray(ids))))
