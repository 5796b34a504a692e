"""The capacity route's raw f16 group scales on the CPU, against
llm_inference_tpu and against the port's own f32 scales.

The port's capacity load always keeps a serve-q4 checkpoint's Q4_0 group
scales as the checkpoint's f16 ``d``; the JAX package does so under
``LLMI_CAP_SCALE_F16=1`` (engine.py:172-184, quant/device.py:826-834).
f16 -> f32 is exact, so nothing numeric changes. The f32 twins below are
the same weights with their scales widened (``_f32_scales``). Bars, on
tests/test_torch_capacity.py's stream fixture:

- the capacity load: a centered Q4_0 nibble part's scales are an f16 scale
  plane equal to the standard load's f32 scales when widened; Q4_K
  nibbles, Q8_0 and serve-q's int8 keep f32; every other tensor bit-equal
  to the standard load; the JAX raw16 load carried across by
  ``from_jax_arrays`` equal to it;
- the plain capacity step over f16 scales against the JAX streamed kernel's
  raw16 branch in interpret mode (tests/test_torch_capacity.py's bars), and
  bit-equal to the port's own step over f32 scales;
- the capacity ``Engine`` under ``LLMI_FORCE_CAPACITY=1``: the JAX capacity
  ``Engine``'s greedy stream under ``LLMI_CAP_SCALE_F16=1``, and prefill
  and decode logits bit-equal to the same engine over f32 scales;
- the plain ``q4_matmul`` over f16 scales bit-equal to f32 scales, and the
  weights, plans and kernel checks that must refuse f16 scales refusing
  them.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_inference_tpu.engine import Engine as JEngine
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.models import init_cache as jax_init_cache
from llm_inference_tpu.models.weights import load_maskdot_stacked
from llm_inference_tpu.ops.pallas import fused_decode_stream as jfds
from llm_inference_tpu_torch.engine import Engine
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.models.weights import from_jax_arrays, load_capacity_stacked
from llm_inference_tpu_torch.ops.kernels import qmatmul
from llm_inference_tpu_torch.ops.kernels import fused_decode_stream as fds
from llm_inference_tpu_torch.quant.device import (Q4Tensor, check_f16_scales, f16_scales,
                                                  is_f16_scale_plane)

from test_torch_capacity import (PARTS, _capacity_threads, _f32_scales, _no_stop, _standard,
                                 _stream_buf, _windows)
from test_torch_lossless import _close, _flatten
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

FIELDS = ("packed", "q", "scale", "offset")


@pytest.mark.parametrize("fmt,q4", [("Q4_0", True), ("Q4_K", True), ("Q8_0", True),
                                    ("Q4_0", False)])
def test_f16_capacity_load(fmt, q4):
    buf = _stream_buf(fmt)
    hp, w16 = load_capacity_stacked(GGUFFile(buf), q4=q4, device="cpu")
    hp0, w32 = _standard(buf, q4)
    assert hp == hp0 and not _capacity_threads()
    raw = fmt == "Q4_0" and q4  # centered nibbles without offsets: the raw d stays f16
    for f in PARTS:
        got, want = getattr(w16.layers, f), getattr(w32.layers, f)
        assert type(got) is type(want)
        for k in FIELDS:
            a, b = getattr(got, k, None), getattr(want, k, None)
            if k == "scale" and raw:
                assert a.dtype == torch.float16 and is_f16_scale_plane(a), f
                assert a.shape == b.shape and torch.equal(a.float(), b), f
            elif a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), (f, k)
    for f in ("attn_norm", "ffn_norm", "q_norm", "k_norm", "post_attn_norm", "post_ffw_norm"):
        assert torch.equal(getattr(w16.layers, f), getattr(w32.layers, f)), f
    assert torch.equal(w16.token_embd.w, w32.token_embd.w)
    assert torch.equal(w16.output_norm, w32.output_norm)
    # the JAX capacity load with raw f16 scales, carried across: the same tensors
    jhp, jw = load_maskdot_stacked(JGGUFFile(buf), q4=q4, scale_f16=True)
    assert (jw.layers.wqkv.sT.dtype == jnp.float16) == raw
    _, wj = from_jax_arrays(dataclasses.asdict(jhp), _flatten(jw))
    for f in PARTS:
        got, want = getattr(wj.layers, f), getattr(w16.layers, f)
        assert type(got) is type(want) and got.scale.dtype == want.scale.dtype, f
        assert torch.equal(got.dequant(), want.dequant()), f
        if raw:
            assert is_f16_scale_plane(got.scale) and torch.equal(got.scale, want.scale), f
            assert torch.equal(got.packed, want.packed), f


@pytest.mark.parametrize("window", [False, True])
def test_plain_stream_step_with_f16_scales_matches_jax_raw16(window, monkeypatch):
    """One step at position 20 over seeded K/V rows (tests/test_torch_capacity.py's
    test_plain_stream_step_matches_jax_interpret): the JAX streamed kernel's
    raw16 branch in interpret mode against the port's plain step over the
    same f16 scales (carried across), which is bit-equal to the port's step
    over its own f32 load."""
    monkeypatch.setattr(jfds, "_TILE_TARGET", 80 * 1024)
    buf = _stream_buf("Q4_0")
    jhp, jw = load_maskdot_stacked(JGGUFFile(buf), q4=True, scale_f16=True)
    assert jw.layers.w_down.sT.dtype == jnp.float16
    hp, w = from_jax_arrays(dataclasses.asdict(jhp), _flatten(jw))
    assert w.layers.wqkv.scale.dtype == torch.float16
    _, w32 = load_capacity_stacked(GGUFFile(buf), q4=True, device="cpu")
    w32 = _f32_scales(w32)
    L, S, pos, tok = jhp.block_count, 64, 20, 9
    rng = np.random.default_rng(16)
    k = (rng.standard_normal((L, S, 2 * 128)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((L, S, 2 * 128)) * 0.5).astype(np.float32)
    k[:, pos:] = v[:, pos:] = 0.0
    jcache = jax_init_cache(jhp, S, stacked=True, flat=True, dtype=jnp.bfloat16)
    jcache = dataclasses.replace(jcache, k=jnp.asarray(k, dtype=jnp.bfloat16),
                                 v=jnp.asarray(v, dtype=jnp.bfloat16))
    wins = _windows(L, window)
    ref, kc, _ = jfds.decode_step_megakernel_stream(jhp, jw, jcache, jnp.int32(tok),
                                                    jnp.int32(pos), windows=wins, interpret=True)
    outs = []
    for weights in (w, w32):
        cache = gemma.init_cache(hp, S, flat=True)
        cache.k.copy_(torch.from_numpy(np.array(jcache.k, dtype=np.float32)))
        cache.v.copy_(torch.from_numpy(np.array(jcache.v, dtype=np.float32)))
        consts = fds.prepare(hp, "cpu", swa_mask=False, max_seq=S)
        consts.windows = torch.from_numpy(wins)
        outs.append((fds.decode_step_stream(hp, weights, cache, torch.tensor([tok]),
                                            torch.tensor([pos], dtype=torch.int32), consts),
                     cache))
    (got, cache), (got32, cache32) = outs
    assert torch.equal(got, got32) and torch.equal(cache.k, cache32.k)
    ref = np.asarray(ref)
    _close(got.numpy(), ref, 1.5e-2)
    assert int(got.argmax()) == int(ref.argmax())
    want = np.asarray(kc, dtype=np.float32)[:, pos]
    row = cache.k[:, pos].float().numpy()
    assert np.all(np.abs(row - want) <= 2 ** -7 * np.abs(want) + 1e-6)


@pytest.fixture(scope="module")
def q4_0_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("cap_f16") / "m.gguf"
    path.write_bytes(_stream_buf("Q4_0"))
    return str(path)


def test_capacity_engine_f16_scales(q4_0_path, monkeypatch):
    """Under LLMI_FORCE_CAPACITY=1 both engines take their capacity paths
    with raw f16 scales (the JAX one under LLMI_CAP_SCALE_F16=1, which the
    port does not need): the port's stream equals the JAX one; the prefill
    and the first decode step's logits equal the same engine's over f32
    scales bit for bit. serve-q keeps f32."""
    monkeypatch.setenv("LLMI_FORCE_CAPACITY", "1")
    monkeypatch.setenv("LLMI_FUSED_INTERPRET", "1")
    monkeypatch.setenv("LLMI_CAP_SCALE_F16", "1")
    prompt = [2, 40, 41, 42, 43]
    ref = _no_stop(JEngine(q4_0_path, max_seq=64, mode="serve-q4", decode_chunk=4))
    assert ref._capacity and ref.weights.layers.wqkv.sT.dtype == jnp.float16
    want = ref.generate_from_ids(prompt, n_predict=8)
    monkeypatch.delenv("LLMI_CAP_SCALE_F16")
    eng = _no_stop(Engine(q4_0_path, max_seq=64, mode="serve-q4", decode_chunk=4, device="cpu"))
    assert eng.decode_route == "capacity" and eng._prefill_w is eng.weights
    assert all(is_f16_scale_plane(getattr(eng.weights.layers, f).scale) for f in PARTS)
    assert eng.generate_from_ids(prompt, n_predict=8) == want
    logits = []
    for w in (eng.weights, _f32_scales(eng.weights)):
        cache = eng.new_cache()
        a, cache = gemma.forward(eng.hparams, w, cache, torch.tensor(prompt), 0)
        b, cache = gemma.forward(eng.hparams, w, cache, a.argmax().reshape(1), len(prompt))
        logits.append((a, b, cache.k.clone()))
    for x, y in zip(*logits):
        assert torch.equal(x, y)
    eng = Engine(q4_0_path, max_seq=64, mode="serve-q", device="cpu")
    assert eng.decode_route == "capacity"
    assert eng.weights.layers.wqkv.scale.dtype == torch.float32


def test_q4_matmul_plain_f16_scales_and_refusals():
    """The plain twin over f16 scales equals f32 scales bit for bit (rows of
    36 groups, padded to 40); f16 scales are refused on Q4_K nibbles, by
    the kernel plan for int8 or offsets, and by the whole steps' launch
    checks outside an f16 scale plane."""
    rng = np.random.default_rng(5)
    R, C = 48, 1152
    u = torch.from_numpy(rng.integers(0, 16, (R, C // 2)).astype(np.uint8))
    s = torch.from_numpy((rng.random((R, C // 32)) * 0.01 + 1e-3).astype(np.float16))
    q16 = Q4Tensor(packed=u, scale=f16_scales(s), fmt=None, rows=R, cols=C, centered=True)
    q32 = dataclasses.replace(q16, scale=s.float())
    assert q16.scale.stride() == (40, 1) and is_f16_scale_plane(q16.scale)
    assert not is_f16_scale_plane(s) and not is_f16_scale_plane(s.float())
    x = torch.from_numpy(rng.standard_normal((5, C)).astype(np.float32))
    assert torch.equal(qmatmul.q4_matmul(q16, x), qmatmul.q4_matmul(q32, x))
    assert torch.equal(q16.dequant(), q32.dequant())
    with pytest.raises(ValueError, match="Q4_K keeps f32"):
        dataclasses.replace(q16, centered=False)
    with pytest.raises(ValueError, match="2-byte scales"):
        qmatmul.plan(R, C, 8, False, 32, False, 132, scale_bytes=2)
    assert qmatmul.plan(R, C, 8, True, 32, False, 132, scale_bytes=2).smem < \
        qmatmul.plan(R, C, 8, True, 32, False, 132).smem
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="f16 scale plane"):
        check_f16_scales(dataclasses.replace(q16, scale=s), (R, C // 32), cpu, "wqkv")
    with pytest.raises(ValueError, match="centered Q4Tensor"):  # int8 quants: f32 only
        check_f16_scales(SimpleNamespace(scale=q16.scale), (R, C // 32), cpu, "wqkv")
    assert check_f16_scales(q16, (R, C // 32), cpu, "wqkv") is q16.scale
