"""The port's block codecs and per-row int8 requant against llm_inference_tpu's.

Bar: bit-equal. The codecs are copies of the JAX package's numpy code and
must stay so; ``requantize_rowwise`` must reproduce the JAX package's
default (native bf16 dequant) route exactly, because its int8 values decide
the serve-q8 greedy stream."""

import numpy as np
import pytest

from llm_inference_tpu import native
from llm_inference_tpu.gguf import GGMLType as JGGMLType
from llm_inference_tpu.quant import layouts as jlayouts
from llm_inference_tpu.quant.device import requantize_rowwise as jax_requantize_rowwise
from llm_inference_tpu_torch.gguf import GGMLType
from llm_inference_tpu_torch.quant import layouts
from llm_inference_tpu_torch.quant.device import requantize_rowwise

from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

FORMATS = ["F32", "F16", "BF16", "Q4_0", "Q5_0", "Q8_0", "Q4_K", "Q6_K"]
QUANT = ["Q4_0", "Q5_0", "Q8_0", "Q4_K", "Q6_K"]


def _weights(seed, rows=16, cols=512, scale=0.3):
    return (np.random.default_rng(seed).standard_normal((rows, cols)) * scale).astype(np.float32)


@pytest.mark.parametrize("fmt", FORMATS)
def test_encode_dequant_bit_equal(fmt):
    w = _weights(1)
    raw = layouts.encode(w, GGMLType[fmt])
    np.testing.assert_array_equal(raw, jlayouts.encode(w, JGGMLType[fmt]))
    np.testing.assert_array_equal(layouts.dequantize(raw, GGMLType[fmt], 16, 512),
                                  jlayouts.dequantize(raw, JGGMLType[fmt], 16, 512))


@pytest.mark.parametrize("fmt", QUANT)
def test_decode_fields_bit_equal_on_random_bytes(fmt):
    """Arbitrary block bytes (not just encoder output) decode identically."""
    elems, nbytes = layouts.block_geometry(GGMLType[fmt])
    raw = np.random.default_rng(2).integers(0, 256, size=4 * (512 // elems) * nbytes,
                                            dtype=np.uint8)
    a = layouts.DECODE_FIELDS[GGMLType[fmt]](raw, 4, 512)
    b = jlayouts.DECODE_FIELDS[JGGMLType[fmt]](raw, 4, 512)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    with np.errstate(invalid="ignore", over="ignore"):
        np.testing.assert_array_equal(layouts.dequantize(raw, GGMLType[fmt], 4, 512),
                                      jlayouts.dequantize(raw, JGGMLType[fmt], 4, 512))


@pytest.mark.parametrize("fmt", FORMATS)
def test_requantize_rowwise_matches_jax_default_route(fmt):
    w = _weights(3, rows=64, cols=512)
    w[5] = 0.0  # an all-zero row takes scale 1
    raw = layouts.encode(w, GGMLType[fmt])
    assert native.get_lib() is not None, "the JAX default route needs the native helper"
    ref = jax_requantize_rowwise(JGGMLType[fmt], raw, 64, 512)
    got = requantize_rowwise(GGMLType[fmt], raw, 64, 512)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert got.q.shape == (64, 512) and got.scale.shape == (64, 1)
    assert got.rows == ref.rows and got.cols == ref.cols


def test_requantize_no_native_route_within_one(monkeypatch):
    """The JAX package without its native helper (no g++, LLMI_NO_NATIVE=1)
    skips the bf16 rounding of the dequantized weights; its int8 values may
    then differ from the default route, and so from the port, by 1
    (ROADMAP.md)."""
    w = _weights(4, rows=256, cols=512)
    raw = layouts.encode(w, GGMLType.Q4_K)
    monkeypatch.setattr(native, "dequant_bf16", lambda *a: None)
    q_exact = np.asarray(jax_requantize_rowwise(JGGMLType.Q4_K, raw, 256, 512).q)
    got = requantize_rowwise(GGMLType.Q4_K, raw, 256, 512).q.numpy()
    diff = np.abs(got.astype(np.int32) - q_exact.astype(np.int32))
    assert diff.max() == 1  # the routes do differ on this checkpoint, by one step at most


def test_dequant_matches_scale_times_q():
    w = _weights(5, rows=8, cols=256)
    raw = layouts.encode(w, GGMLType.Q8_0)
    qt = requantize_rowwise(GGMLType.Q8_0, raw, 8, 256)
    deq = qt.dequant().numpy()
    np.testing.assert_array_equal(deq, qt.q.numpy().astype(np.float32) * qt.scale.numpy())
    # per-row int8 error: half a step of amax/127 plus the bf16 rounding,
    # together below one step
    src = layouts.dequantize(raw, GGMLType.Q8_0, 8, 256)
    step = np.abs(src).max(axis=1, keepdims=True) / 127.0
    assert np.all(np.abs(deq - src) <= step)
