"""The port's lossless serve-q / serve-q4 path on the CPU against llm_inference_tpu's.

Same seeded checkpoints through both packages. Bars, each with its reason:

- weight formats (``from_gguf_bytes``, ``pack_q4_host``, ``from_jax_arrays``
  from all four JAX layouts): dequant bit-equal, the port keeps the same
  integers, scales and offsets in another column order;
- the plain twins of the per-op kernels against the JAX kernels in
  interpret mode: 1e-4 * max(1, max|y|), the same bf16 weights and products,
  sums in another order;
- the plain twin of the lossless whole step against the JAX serve forward
  at T = 1: logits within 1.5e-2 * max(1, max|logits|) with equal argmax
  (tests/test_fused_decode_q.py's bar: the step applies exact f32 scales
  to f32 group partials, the per-op path rounds the dequantized weights to
  bf16), cache rows within 4e-2 + 2^-6 * |row| (that test's 4e-2, plus two
  bf16 steps of the value: the written rows are bf16, and without post
  norms they reach |v| ~ 6, where one bf16 step is 0.031; measured 0.047 at
  |v| ~ 6 there, one step and a half, on layer 0 already, so the K/V
  projection's own rounding, not drift);
- the port's ``Engine``: tests/test_torch_lossless_engine.py."""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llm_inference_tpu.gguf import GGMLType as JGGMLType
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.models import forward as jax_forward
from llm_inference_tpu.models import init_cache as jax_init_cache
from llm_inference_tpu.models import load_weights as jax_load_weights
from llm_inference_tpu.models.weights import fuse_projections as jax_fuse
from llm_inference_tpu.models.weights import maskdot_layers as jax_maskdot_layers
from llm_inference_tpu.models.weights import stack_layers as jax_stack
from llm_inference_tpu.ops.linear import embed_rows as jax_embed_rows
from llm_inference_tpu.ops.pallas import q4_matmul as jax_q4_matmul
from llm_inference_tpu.ops.pallas import quant_matmul as jax_quant_matmul
from llm_inference_tpu.quant import layouts as jlayouts
from llm_inference_tpu.quant.device import from_gguf_bytes as jax_from_gguf_bytes
from llm_inference_tpu.quant.device import pack_q4_host as jax_pack_q4_host
from llm_inference_tpu_torch.gguf import GGMLType, GGUFFile
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.models.weights import (fuse_projections, from_jax_arrays,
                                                    load_weights, stack_layers)
from llm_inference_tpu_torch.ops import linear
from llm_inference_tpu_torch.ops.kernels import fused_decode, fused_decode_batch, fused_decode_q
from llm_inference_tpu_torch.ops.kernels import qmatmul
from llm_inference_tpu_torch.quant.device import (DenseTensor, Q4Tensor, QuantTensor,
                                                  from_gguf_bytes, pack_q4, pack_q4_host,
                                                  unpack_q4_to_quant)

from fixtures import build_gemma3_gguf
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

QUANT = ["Q4_0", "Q5_0", "Q8_0", "Q4_K", "Q6_K"]
VOCAB = [f"t{i}" for i in range(256)]
VOCAB[1], VOCAB[2], VOCAB[3] = "<eos>", "<bos>", "<unk>"
WIDE = dict(n_layers=3, n_embd=256, n_ff=512, n_head=4, n_head_kv=2, head_dim=128, vocab=VOCAB)
MODES = {"serve-q": "packed-serve", "serve-q4": "packed-q4"}


def _raw(fmt: str, rows=16, cols=512, seed=1):
    w = (np.random.default_rng(seed).standard_normal((rows, cols)) * 0.3).astype(np.float32)
    return jlayouts.encode(w, JGGMLType[fmt])


def _checkpoint(fmt="Q4_0", **kw):
    args = dict(WIDE, weight_fmt=JGGMLType[fmt])
    args.update(kw)
    return build_gemma3_gguf(**args)


def _close(got, ref, rel):
    got, ref = np.asarray(got, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(1.0, np.abs(ref).max()))


# -- weight formats ---------------------------------------------------------------


@pytest.mark.parametrize("fmt", QUANT)
def test_from_gguf_bytes_matches_jax(fmt):
    raw = _raw(fmt)
    jt = jax_from_gguf_bytes(raw, JGGMLType[fmt], 16, 512)
    qt = from_gguf_bytes(raw, GGMLType[fmt], 16, 512)
    assert isinstance(qt, QuantTensor) and qt.group_size == jt.group_size
    assert qt.groups == jt.groups and qt.groups > 1
    np.testing.assert_array_equal(qt.dequant().numpy(), np.asarray(jt.dequant(jnp.float32)))
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(jt.q_grouped()).reshape(16, 512))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(jt.scale))
    assert (qt.offset is None) == (jt.offset is None)
    # the same tensor from the torch fast path or the numpy plan
    raw2 = _raw(fmt, rows=8, cols=256, seed=3)
    a, b = from_gguf_bytes(raw2, GGMLType[fmt], 8, 256), jax_from_gguf_bytes(
        raw2, JGGMLType[fmt], 8, 256)
    np.testing.assert_array_equal(a.dequant().numpy(), np.asarray(b.dequant()))


@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_K"])
def test_pack_q4_host_matches_jax(fmt):
    raw = _raw(fmt)
    j4 = jax_pack_q4_host(raw, JGGMLType[fmt], 16, 512)
    q4 = pack_q4_host(raw, GGMLType[fmt], 16, 512)
    assert isinstance(q4, Q4Tensor) and q4.centered == j4.centered == (fmt == "Q4_0")
    assert q4.packed.dtype == torch.uint8 and q4.packed.shape == (16, 256)
    np.testing.assert_array_equal(q4.dequant().numpy(), np.asarray(j4.dequant()))
    # nibble pairs: byte j holds columns 2j (low) and 2j + 1 (high)
    u = q4.quants().to(torch.int16) + (8 if q4.centered else 0)
    assert torch.equal(q4.packed, (u[:, 0::2] | (u[:, 1::2] << 4)).to(torch.uint8))
    qt = from_gguf_bytes(raw, GGMLType[fmt], 16, 512)
    assert torch.equal(unpack_q4_to_quant(q4).q, qt.q)
    assert torch.equal(pack_q4(qt).packed, q4.packed)
    assert pack_q4_host(_raw("Q8_0"), GGMLType.Q8_0, 16, 512) is None


def _flatten(tree, prefix=""):
    """A JAX ModelWeights as {field path: numpy array}, with the weights'
    metadata (fmt, group_size, bg, mp, centered) as ints."""
    out = {}
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if f.name in ("fmt", "group_size", "bg", "mp", "centered"):
                out[prefix + f.name] = np.int32(int(v))
            elif v is not None and f.name not in ("rows", "cols"):
                out.update(_flatten(v, f"{prefix}{f.name}."))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_K"])
@pytest.mark.parametrize("layout", ["QuantTensor", "Q4Tensor", "TQuantTensor", "TQ4Tensor"])
def test_from_jax_arrays_gives_bit_equal_dequant(fmt, layout):
    """Every JAX layout converts to the port's, with the same f32 values
    (the sign-hi TQ4 folding undone exactly as the JAX package undoes it)."""
    buf = _checkpoint(fmt)
    jhp, jw = jax_load_weights(JGGUFFile(buf), mode="packed-q4" if "Q4T" in layout
                               else "packed-serve")
    jw = jax_fuse(jw)
    jw = dataclasses.replace(jw, layers=jax_stack(jw.layers))
    if layout.startswith("T"):
        jw = jax_maskdot_layers(jw, q4=layout == "TQ4Tensor")
    assert type(jw.layers.wqkv).__name__ == layout
    hp, w = from_jax_arrays(dataclasses.asdict(jhp), _flatten(jw))
    want_type = Q4Tensor if "Q4" in layout else QuantTensor
    for f in ("wqkv", "wo", "w_gate_up", "w_down"):
        got, ref = getattr(w.layers, f), getattr(jw.layers, f)
        assert isinstance(got, want_type), f
        for l in range(jhp.block_count):  # the planar JAX classes dequantize one layer
            ref_l = jax.tree_util.tree_map(lambda a: a[l], ref)
            np.testing.assert_array_equal(got.dequant()[l].numpy(),
                                          np.asarray(ref_l.dequant(jnp.float32)), err_msg=f)
    assert isinstance(w.token_embd, DenseTensor) and w.token_embd.w.dtype == torch.bfloat16
    # the carried weights are the ones the port loads itself
    hp2, w2 = load_weights(GGUFFile(buf), mode="packed-q4" if "Q4T" in layout else "packed-serve")
    w2 = fuse_projections(w2)
    assert hp == hp2
    if not layout.startswith("T"):
        w2 = dataclasses.replace(w2, layers=stack_layers(w2.layers))
        assert torch.equal(w.layers.wqkv.scale, w2.layers.wqkv.scale)
    assert torch.equal(w.token_embd.w, w2.token_embd.w)


# -- the per-op kernels' plain twins and the dispatch ---------------------------


def _interpret_bar(t: int) -> float:
    """The bar of a per-op plain twin against the JAX kernel in interpret
    mode, relative to max(1, max|y|). The twin forms the TPU kernel's bf16
    weight, bf16(bf16(q) * bf16(s)) - bf16(off) with both roundings; so does
    XLA:CPU at T = 8 (measured within 2e-7), so only the summation order
    differs: 1e-4. At T = 1 XLA:CPU runs the same bf16 arithmetic with f32
    excess precision and skips those roundings (measured up to 6.4e-4 on
    these weights, Q4_K), so the bar there is the weight's bf16 rounding:
    2e-3."""
    return 2e-3 if t == 1 else 1e-4


@pytest.mark.parametrize("fmt", QUANT)
@pytest.mark.parametrize("t", [1, 8])
def test_plain_quant_matmul_matches_jax_interpret(fmt, t):
    raw = _raw(fmt, rows=64)
    jt = jax_from_gguf_bytes(raw, JGGMLType[fmt], 64, 512)
    qt = from_gguf_bytes(raw, GGMLType[fmt], 64, 512)
    x = np.random.default_rng(t).standard_normal((t, 512)).astype(np.float32)
    ref = np.asarray(jax_quant_matmul(jt, jnp.asarray(x), interpret=True))
    got = qmatmul.quant_matmul(qt, torch.from_numpy(x))  # CPU: the plain twin
    _close(got.numpy(), ref, _interpret_bar(t))
    assert qmatmul.supports_kernel(qt, t) and qmatmul.grouped_launches == 0


@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_K"])
@pytest.mark.parametrize("t", [1, 8])
def test_plain_q4_matmul_matches_jax_interpret(fmt, t):
    raw = _raw(fmt, rows=64)
    j4 = jax_pack_q4_host(raw, JGGMLType[fmt], 64, 512)
    q4 = pack_q4_host(raw, GGMLType[fmt], 64, 512)
    x = np.random.default_rng(t).standard_normal((t, 512)).astype(np.float32)
    ref = np.asarray(jax_q4_matmul(j4, jnp.asarray(x), interpret=True))
    got = qmatmul.q4_matmul(q4, torch.from_numpy(x))
    _close(got.numpy(), ref, _interpret_bar(t))
    assert qmatmul.q4_launches == 0


def test_grouped_weights_never_reach_the_rowwise_paths():
    """A grouped weight routes to the grouped kernel (or the CPU dequant
    route), never to a per-row one: the W8A8 product and the rowq8 whole
    steps refuse it."""
    qt = from_gguf_bytes(_raw("Q4_0", rows=64), GGMLType.Q4_0, 64, 512)
    with pytest.raises(ValueError, match="per-row"):
        linear.int8_rowwise_matmul(qt, torch.zeros(2, 512))
    x = torch.randn(3, 512)
    y = linear.matmul(qt, x)  # CPU: the JAX package's CPU route, bf16 dequant
    want = x.to(torch.bfloat16).float() @ qt.dequant(torch.bfloat16).float().T
    assert torch.equal(y, want)
    assert qmatmul.supports_kernel(qt, 64) and not qmatmul.supports_kernel(qt, 65)
    rowwise = QuantTensor(q=qt.q, scale=torch.ones(64, 1), fmt=None, rows=64, cols=512)
    assert rowwise.groups == 1 and qmatmul.supports_kernel(rowwise, 1)
    # quant_matmul dispatches on groups: the grouped twin, not the rowwise one
    assert torch.allclose(qmatmul.quant_matmul(qt, x), qmatmul.quant_matmul_plain(qt, x))
    assert not torch.allclose(qmatmul.quant_matmul(qt, x),
                              qmatmul.quant_matmul_plain(dataclasses.replace(
                                  qt, scale=qt.scale[:, :1], group_size=512), x))
    hp, w = _port_model(_checkpoint(), "serve-q")
    assert not fused_decode.decode_supported(hp, w)
    assert not fused_decode_batch.batch_supported(hp, w, batch=2, max_seq=64)
    assert fused_decode_q.decode_q_supported(hp, w)


@pytest.mark.parametrize("fmt", ["Q8_0", "Q6_K", "Q4_K"])
def test_embed_rows_of_a_grouped_embedding_match_jax(fmt):
    raw = _raw(fmt, rows=32)
    jt = jax_from_gguf_bytes(raw, JGGMLType[fmt], 32, 512)
    qt = from_gguf_bytes(raw, GGMLType[fmt], 32, 512)
    ids = np.array([[3, 0, 31], [7, 7, 2]])
    np.testing.assert_array_equal(linear.embed_rows(qt, torch.from_numpy(ids)).numpy(),
                                  np.asarray(jax_embed_rows(jt, jnp.asarray(ids))))


# -- the lossless whole step's plain twin ---------------------------------------


def _port_model(buf, mode, stacked=True):
    hp, w = load_weights(GGUFFile(buf), mode=MODES[mode])
    w = fuse_projections(w)
    if stacked:
        w = dataclasses.replace(w, layers=stack_layers(w.layers))
    return hp, w


def _run_both(buf, mode, prompt, n_steps):
    jhp, jw = jax_load_weights(JGGUFFile(buf), mode=MODES[mode])
    jw = jax_fuse(jw)
    hp, w = _port_model(buf, mode)
    assert fused_decode_q.decode_q_supported(hp, w)
    jcache = jax_init_cache(jhp, 64, dtype=jnp.bfloat16)
    cache = gemma.init_cache(hp, 64)
    jfwd = jax.jit(partial(jax_forward, jhp, exact=False, mm_impl="xla"))
    jl, jcache = jfwd(jw, jcache, jnp.asarray(prompt, dtype=jnp.int32), 0)
    tl, cache = gemma.forward(hp, w, cache, torch.tensor(prompt), 0)
    _close(tl.numpy(), jl, 1e-4)  # the same per-op math, another summation order
    consts = fused_decode_q.prepare(hp, "cpu", swa_mask=gemma.swa_mask_enabled(), max_seq=64)
    pos = len(prompt)
    for step in range(n_steps):
        tok = 9 + step
        jl, jcache = jfwd(jw, jcache, jnp.asarray([tok], dtype=jnp.int32), pos)
        tl, cache = gemma.forward(hp, w, cache, torch.tensor([tok]), torch.tensor([pos]),
                                  consts=consts)
        pos += 1
        jl = np.asarray(jl)
        _close(tl.numpy(), jl, 1.5e-2)
        assert int(tl.argmax()) == int(jl.argmax()), f"step {step}"
    for ours, theirs in ((cache.k, jcache.k), (cache.v, jcache.v)):
        ref = np.stack([np.asarray(k, dtype=np.float32) for k in theirs])[:, :pos]
        np.testing.assert_allclose(ours[:, :pos].float().numpy(), ref, atol=4e-2, rtol=2 ** -6)
    assert not cache.k[:, pos:].any()  # nothing written past the last position
    return hp, w


@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_K"])
@pytest.mark.parametrize("mode", ["serve-q", "serve-q4"])
@pytest.mark.parametrize("post_norms", [True, False])
def test_plain_lossless_step_matches_jax_serve_forward(fmt, mode, post_norms, monkeypatch):
    calls = []
    real = fused_decode_q.decode_step_q_plain
    monkeypatch.setattr(fused_decode_q, "decode_step_q_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    launches = fused_decode_q.launches
    hp, w = _run_both(_checkpoint(fmt, with_post_norms=post_norms), mode, [2, 7, 8], 3)
    assert len(calls) == 3  # every CPU decode step took the kernel's plain twin
    assert fused_decode_q.launches == launches  # and no kernel launch
    want = Q4Tensor if mode == "serve-q4" else QuantTensor
    assert isinstance(w.layers.wqkv, want) and (w.layers.wqkv.offset is not None) == (fmt == "Q4_K")


@pytest.mark.parametrize("mode", ["serve-q", "serve-q4"])
def test_plain_lossless_step_applies_sliding_window(mode, monkeypatch):
    """LLMI_SWA_MASK=1: layer 0 keeps an 8-token window over a 12-token
    prompt, so the window mask bites during decode."""
    monkeypatch.setenv("LLMI_SWA_MASK", "1")
    buf = _checkpoint("Q4_K", n_layers=2, sliding_window=8, swa_pattern=[True, False])
    prompt = [2, 7, 8, 9, 4, 5, 6, 3, 8, 7, 2, 9]
    hp, w = _run_both(buf, mode, prompt, 2)
    cache = gemma.init_cache(hp, 64)
    gemma.forward(hp, w, cache, torch.tensor(prompt), 0)
    args = (hp, w, cache, torch.tensor([9]), torch.tensor([12], dtype=torch.int32))
    win = fused_decode_q.decode_step_q_plain(*args, fused_decode_q.prepare(hp, "cpu", swa_mask=True))
    nowin = fused_decode_q.decode_step_q_plain(*args, fused_decode_q.prepare(hp, "cpu",
                                                                             swa_mask=False))
    assert (win - nowin).abs().max() > 1e-4  # the window reaches the step


def test_decode_q_supported_rules():
    hp, w = _port_model(_checkpoint(), "serve-q")
    assert fused_decode_q.decode_q_supported(hp, w)
    hp4, w4 = _port_model(_checkpoint("Q4_K"), "serve-q4")
    assert fused_decode_q.decode_q_supported(hp4, w4)
    _, wu = _port_model(_checkpoint(), "serve-q", stacked=False)
    assert not fused_decode_q.decode_q_supported(hp, wu)  # not stacked
    hp8, w8 = load_weights(GGUFFile(_checkpoint()), mode="rowq8")
    w8 = fuse_projections(w8)
    w8 = dataclasses.replace(w8, layers=stack_layers(w8.layers))
    assert not fused_decode_q.decode_q_supported(hp8, w8)  # per-row int8
    # a Q8_0 embedding stays quantized in serve-q: the step needs dense bf16
    hpe, we = _port_model(_checkpoint(embd_fmt=JGGMLType.Q8_0), "serve-q")
    assert isinstance(we.token_embd, QuantTensor) and not fused_decode_q.decode_q_supported(hpe, we)
    hps, ws = _port_model(build_gemma3_gguf(n_layers=2), "serve-q")  # head_dim 16
    assert not fused_decode_q.decode_q_supported(hps, ws)
    bad = dataclasses.replace(w, layers=dataclasses.replace(
        w.layers, w_down=dataclasses.replace(w.layers.w_down, group_size=64)))
    assert not fused_decode_q.decode_q_supported(hp, bad)  # groups of 16 or 32 only


@pytest.mark.slow
def test_plain_lossless_step_matches_interpret_megakernel(monkeypatch):
    """The plain twin against the Pallas lossless step itself, in interpret
    mode on the same weights (maskdot layout on the JAX side) and cache
    (minutes of CPU emulation, hence slow)."""
    monkeypatch.setenv("LLMI_FUSED_INTERPRET", "1")
    from llm_inference_tpu.ops.pallas.fused_decode_q import decode_step_megakernel_q

    buf = _checkpoint("Q4_K", with_post_norms=True)
    jhp, jw = jax_load_weights(JGGUFFile(buf), mode="packed-q4")
    jw = jax_fuse(jw)
    jw = jax_maskdot_layers(dataclasses.replace(jw, layers=jax_stack(jw.layers)), q4=True)
    hp, w = _port_model(buf, "serve-q4")
    rng = np.random.default_rng(11)
    k = (rng.standard_normal((3, 64, 2, 128)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((3, 64, 2, 128)) * 0.5).astype(np.float32)
    k[:, 20:] = v[:, 20:] = 0.0
    jcache = jax_init_cache(jhp, 64, stacked=True, dtype=jnp.bfloat16)
    jcache = dataclasses.replace(jcache, k=jnp.asarray(k, dtype=jnp.bfloat16),
                                 v=jnp.asarray(v, dtype=jnp.bfloat16))
    cache = gemma.init_cache(hp, 64)
    cache.k.copy_(torch.from_numpy(k))
    cache.v.copy_(torch.from_numpy(v))
    ref, kc, _ = decode_step_megakernel_q(jhp, jw, jcache, jnp.int32(9), jnp.int32(20),
                                          interpret=True)
    got = fused_decode_q.decode_step_q_plain(hp, w, cache, torch.tensor([9]), torch.tensor([20]),
                                             fused_decode_q.prepare(hp, "cpu", swa_mask=False))
    ref = np.asarray(ref)
    _close(got.numpy(), ref, 1.5e-2)
    assert int(got.argmax()) == int(ref.argmax())
    np.testing.assert_allclose(cache.k[:, 20].float().numpy(),
                               np.asarray(kc, dtype=np.float32)[:, 20], atol=4e-2)
