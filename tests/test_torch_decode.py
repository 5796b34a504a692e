"""The port's serve forward on the CPU against llm_inference_tpu's.

Same seeded rowq8 checkpoint through both packages. The JAX side runs its
plain XLA serve forward (``exact=False, mm_impl="xla"``, unrolled per op);
the port prefills through its layer loop over stacked weights and decodes
through the plain twin of the whole-step CUDA kernel (the CPU leg of the
card's dispatch). Bars, those of tests/test_fused_decode.py: decode logits
within 1.5e-2 * max(1, max|logits|) with equal argmax (the kernel's bf16
rounding points differ from the per-op path's f32 attention), cache rows
within 4e-2. The prefill logits run the same per-op math on both sides and
differ only in summation order: 1e-4 * max(1, max|logits|)."""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.models import forward as jax_forward
from llm_inference_tpu.models import init_cache as jax_init_cache
from llm_inference_tpu.models import load_weights as jax_load_weights
from llm_inference_tpu.models.weights import fuse_projections as jax_fuse
from llm_inference_tpu.models.weights import stack_layers as jax_stack
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.models.weights import fuse_projections, load_weights, stack_layers
from llm_inference_tpu_torch.ops.kernels import fused_decode

from fixtures import build_gemma3_gguf
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

VOCAB = [f"t{i}" for i in range(256)]
VOCAB[1], VOCAB[2], VOCAB[3] = "<eos>", "<bos>", "<unk>"


def _checkpoint(**kw):
    args = dict(n_layers=3, n_embd=256, n_ff=512, n_head=4, n_head_kv=2, head_dim=128,
                vocab=VOCAB)
    args.update(kw)
    return build_gemma3_gguf(**args)


def _port_model(buf):
    hp, w = load_weights(GGUFFile(buf), mode="rowq8")
    w = fuse_projections(w)
    return hp, dataclasses.replace(w, layers=stack_layers(w.layers))


def _jax_model(buf):
    hp, w = jax_load_weights(JGGUFFile(buf), mode="rowq8")
    return hp, jax_fuse(w)


def _close(got, ref, rel):
    got, ref = np.asarray(got, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(1.0, np.abs(ref).max()))


def _run_both(buf, prompt, n_steps, spy=None):
    jhp, jw = _jax_model(buf)
    hp, w = _port_model(buf)
    assert fused_decode.decode_supported(hp, w)
    jcache = jax_init_cache(jhp, 64, dtype=jnp.bfloat16)
    cache = gemma.init_cache(hp, 64)
    jfwd = jax.jit(partial(jax_forward, jhp, exact=False, mm_impl="xla"))

    jl, jcache = jfwd(jw, jcache, jnp.asarray(prompt, dtype=jnp.int32), 0)
    tl, cache = gemma.forward(hp, w, cache, torch.tensor(prompt), 0)
    _close(tl.numpy(), jl, 1e-4)
    consts = fused_decode.prepare(hp, "cpu", swa_mask=gemma.swa_mask_enabled(), max_seq=64)
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
    k_ref = np.stack([np.asarray(k, dtype=np.float32) for k in jcache.k])[:, :pos]
    np.testing.assert_allclose(cache.k[:, :pos].float().numpy(), k_ref, atol=4e-2)
    v_ref = np.stack([np.asarray(v, dtype=np.float32) for v in jcache.v])[:, :pos]
    np.testing.assert_allclose(cache.v[:, :pos].float().numpy(), v_ref, atol=4e-2)
    assert not cache.k[:, pos:].any()  # nothing written past the last position


@pytest.mark.parametrize("with_post_norms", [True, False])
def test_plain_decode_step_matches_jax_serve_forward(with_post_norms, monkeypatch):
    calls = []
    real = fused_decode.decode_step_plain
    monkeypatch.setattr(fused_decode, "decode_step_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    launches = fused_decode.launches
    _run_both(_checkpoint(with_post_norms=with_post_norms), [2, 7, 8], 3)
    assert len(calls) == 3  # every CPU decode step took the kernel's plain twin
    assert fused_decode.launches == launches  # and no kernel launch


def test_plain_decode_step_applies_sliding_window(monkeypatch):
    """LLMI_SWA_MASK=1: layer 0 keeps an 8-token window over a 12-token
    prompt, so the window mask bites during decode."""
    monkeypatch.setenv("LLMI_SWA_MASK", "1")
    buf = _checkpoint(n_layers=2, sliding_window=8, swa_pattern=[True, False])
    _run_both(buf, [2, 7, 8, 9, 4, 5, 6, 3, 8, 7, 2, 9], 2)

    hp, w = _port_model(buf)
    assert list(fused_decode.window_array(hp, True)) == [8, 0]
    cache = gemma.init_cache(hp, 64)
    gemma.forward(hp, w, cache, torch.tensor([2, 7, 8, 9, 4, 5, 6, 3, 8, 7, 2, 9]), 0)
    args = (hp, w, cache, torch.tensor([9]), torch.tensor([12], dtype=torch.int32))
    win = fused_decode.decode_step_plain(*args, fused_decode.prepare(hp, "cpu", swa_mask=True))
    nowin = fused_decode.decode_step_plain(*args, fused_decode.prepare(hp, "cpu", swa_mask=False))
    assert (win - nowin).abs().max() > 1e-4  # the window reaches the step


def test_prefill_with_alibi_matches_jax():
    """The serve scores' ALiBi bias (no Gemma checkpoint sets it; the whole-step
    kernel refuses it, so prefill and per-op decode carry it): same per-op
    math on both sides, summation order only (1e-4 * max(1, max|logits|))."""
    buf = _checkpoint(n_layers=2)
    jhp, jw = _jax_model(buf)
    hp, w = _port_model(buf)
    jhp = dataclasses.replace(jhp, f_max_alibi_bias=8.0)
    hp = dataclasses.replace(hp, f_max_alibi_bias=8.0)
    assert not fused_decode.decode_supported(hp, w)
    prompt = [2, 7, 8, 9, 4, 5]
    jl, _ = jax_forward(jhp, jw, jax_init_cache(jhp, 32, dtype=jnp.bfloat16),
                        jnp.asarray(prompt, dtype=jnp.int32), 0, exact=False, mm_impl="xla")
    tl, _ = gemma.forward(hp, w, gemma.init_cache(hp, 32), torch.tensor(prompt), 0)
    _close(tl.numpy(), jl, 1e-4)
    no_bias, _ = gemma.forward(dataclasses.replace(hp, f_max_alibi_bias=0.0), w,
                               gemma.init_cache(hp, 32), torch.tensor(prompt), 0)
    assert (tl - no_bias).abs().max() > 1e-3  # the bias reaches the logits


def test_write_cache_drops_padding_and_overflow():
    cache = torch.zeros(8, 1, 4, dtype=torch.bfloat16)
    new = torch.arange(1, 17, dtype=torch.float32).reshape(4, 1, 4)
    gemma._write_cache(cache, new, pos=2, n_valid=3)  # row 3 is padding
    assert torch.equal(cache[2:5], new[:3].to(torch.bfloat16))
    assert not cache[5:].any() and not cache[:2].any()
    gemma._write_cache(cache, new, pos=6, n_valid=4)  # rows past the end drop
    assert torch.equal(cache[6:8], new[:2].to(torch.bfloat16))


def test_decode_supported_rules():
    hp, w = _port_model(_checkpoint())
    assert fused_decode.decode_supported(hp, w)
    hp_u, w_u = load_weights(GGUFFile(_checkpoint()), mode="rowq8")
    assert not fused_decode.decode_supported(hp_u, fuse_projections(w_u))  # not stacked
    hp_s, w_s = _port_model(build_gemma3_gguf(n_layers=2))  # head_dim 16: not 128-aligned
    assert not fused_decode.decode_supported(hp_s, w_s)


@pytest.mark.slow
def test_plain_decode_step_matches_interpret_megakernel(monkeypatch):
    """The plain twin against the Pallas whole-step kernel itself, run in
    interpret mode on the same rowq8 weights and cache (minutes of CPU
    emulation, hence slow)."""
    monkeypatch.setenv("LLMI_FUSED_INTERPRET", "1")
    from llm_inference_tpu.ops.pallas.fused_decode import decode_step_megakernel

    buf = _checkpoint(with_post_norms=True)
    jhp, jw = _jax_model(buf)
    jw = dataclasses.replace(jw, layers=jax_stack(jw.layers))
    hp, w = _port_model(buf)
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
    ref, kc, _ = decode_step_megakernel(jhp, jw, jcache, jnp.int32(9), jnp.int32(20),
                                        interpret=True)
    got = fused_decode.decode_step_plain(hp, w, cache, torch.tensor([9]), torch.tensor([20]),
                                         fused_decode.prepare(hp, "cpu", swa_mask=False))
    ref = np.asarray(ref)
    _close(got.numpy(), ref, 1.5e-2)
    assert int(got.argmax()) == int(ref.argmax())
    np.testing.assert_allclose(cache.k[:, 20].float().numpy(),
                               np.asarray(kc, dtype=np.float32)[:, 20], atol=4e-2)
