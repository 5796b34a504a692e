"""The port's batched decode pieces on the CPU against llm_inference_tpu's.

Same seeded inputs through both packages:

  - the plain ``insert_rows`` against the Pallas kernel in interpret mode
    (tests/test_kv_insert.py's cases): bit-equal;
  - the plain ``flash_decode`` against the Pallas kernel in interpret mode
    (tests/test_flash_decode.py's cases): rtol = atol = 2e-3;
  - the port's ``forward_batched_decode`` (per-op route) and the plain twin
    of the batched whole-step kernel against the JAX
    ``forward_batched_decode`` over three steps with ragged positions and a
    parked lane (tests/test_fused_decode_batch.py's bars): logits within
    1.5e-2 * max(1, max|logits|) per lane with equal argmax, cache rows within
    4e-2. The per-op route differs from the JAX one only in summation order;
    the whole-step twin rounds activations and probabilities to bf16 where
    the TPU kernel does, which the per-op path does not.
"""

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
from llm_inference_tpu.models.gemma import KVCache as JKVCache
from llm_inference_tpu.models.gemma import forward_batched_decode as jax_batched_decode
from llm_inference_tpu.models.weights import fuse_projections as jax_fuse
from llm_inference_tpu.ops.pallas.flash_decode import flash_decode as jax_flash_decode
from llm_inference_tpu.ops.pallas.kv_insert import insert_rows as jax_insert_rows
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.models.weights import fuse_projections, load_weights, stack_layers
from llm_inference_tpu_torch.ops.kernels import flash_decode, fused_decode_batch, kv_insert

from fixtures import build_gemma3_gguf
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

VOCAB = [f"t{i}" for i in range(256)]
VOCAB[1], VOCAB[2], VOCAB[3] = "<eos>", "<bos>", "<unk>"
PROMPTS = [[2, 7, 8], [2, 9], [2, 5, 6, 7, 11]]


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 values (as f32), so both packages hold the same."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


# -- insert_rows ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["scatter", "all_dropped", "degenerate_layout"])
def test_plain_insert_rows_matches_jax_kernel(case):
    rng = np.random.default_rng(0)
    if case == "scatter":
        R, H, C = 48, 2, 256
        idx = np.array([3, 17, R, 47, R + 9], np.int32)
    elif case == "all_dropped":
        R, H, C = 16, 1, 128
        idx = np.array([R, R + 5, -2], np.int32)
    else:  # the 1B model's [rows, 1, 256] rows
        R, H, C = 32, 1, 256
        idx = np.array([5, R, 0, 31], np.int32)
    dst = _bf16(rng.normal(size=(R, H, C)))
    rows = _bf16(rng.normal(size=(len(idx), H, C)))
    want = jax_insert_rows(jnp.asarray(dst, jnp.bfloat16), jnp.asarray(rows, jnp.bfloat16),
                           jnp.asarray(idx), interpret=True)
    got = torch.from_numpy(dst).to(torch.bfloat16)
    launches = kv_insert.launches
    out = kv_insert.insert_rows(got, torch.from_numpy(rows).to(torch.bfloat16),
                                torch.from_numpy(idx))
    assert out is got and kv_insert.launches == launches  # in place, the plain twin
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_insert_rows_rejects_mismatched_inputs():
    dst = torch.zeros(4, 1, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        kv_insert.insert_rows(dst, torch.zeros(2, 1, 8), torch.tensor([0, 1], dtype=torch.int32))
    with pytest.raises(ValueError):
        kv_insert.insert_rows(dst, torch.zeros(2, 2, 8, dtype=torch.bfloat16),
                              torch.tensor([0, 1], dtype=torch.int32))


# -- flash_decode -----------------------------------------------------------------


def _flash_inputs(seed, B, S, hkv, group, D, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, hkv * group, D)) * q_scale).astype(np.float32)
    k = _bf16(rng.standard_normal((B, S, hkv, D)))
    v = _bf16(rng.standard_normal((B, S, hkv, D)))
    return q, k, v


def _both_flash(q, k, v, lengths, starts=None, softcap=0.0):
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
                            jnp.asarray(v, jnp.bfloat16), jnp.asarray(lengths),
                            None if starts is None else jnp.asarray(starts),
                            block=128, softcap=softcap, interpret=True)
    got = flash_decode.flash_decode(
        torch.from_numpy(q), torch.from_numpy(k).to(torch.bfloat16),
        torch.from_numpy(v).to(torch.bfloat16), torch.from_numpy(lengths),
        None if starts is None else torch.from_numpy(starts), softcap=softcap)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("hkv,group", [(1, 4), (2, 2)])
def test_plain_flash_decode_matches_jax_kernel(hkv, group):
    q, k, v = _flash_inputs(1, 3, 512, hkv, group, 128)
    got, want = _both_flash(q, k, v, np.array([1, 130, 512], np.int32))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("case", ["softcap", "zero_length", "swa_starts", "head_dim_256"])
def test_plain_flash_decode_cases_match_jax_kernel(case):
    if case == "softcap":
        q, k, v = _flash_inputs(2, 1, 256, 1, 2, 128, q_scale=3.0)
        got, want = _both_flash(q, k, v, np.array([200], np.int32), softcap=30.0)
    elif case == "zero_length":
        q, k, v = _flash_inputs(3, 2, 256, 1, 2, 128)
        got, want = _both_flash(q, k, v, np.array([0, 50], np.int32))
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got[0], 0.0)
    elif case == "swa_starts":
        q, k, v = _flash_inputs(4, 3, 512, 2, 2, 128)
        lengths = np.array([300, 512, 40], np.int32)
        starts = np.maximum(lengths - 160, 0).astype(np.int32)
        got, want = _both_flash(q, k, v, lengths, starts)
    else:  # the 1B model's single KV head of 256, four q heads
        q, k, v = _flash_inputs(5, 4, 512, 1, 4, 256)
        got, want = _both_flash(q, k, v, np.array([1, 257, 0, 512], np.int32))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


# -- the batched model step ---------------------------------------------------------


def _buf(n_layers=3, **kw):
    return build_gemma3_gguf(n_layers=n_layers, n_embd=256, n_ff=512, n_head=4, n_head_kv=2,
                             head_dim=128, vocab=VOCAB, with_post_norms=True, **kw)


def _models(buf):
    jhp, jw = jax_load_weights(JGGUFFile(buf), mode="rowq8")
    jw = jax_fuse(jw)
    hp, w = load_weights(GGUFFile(buf), mode="rowq8")
    w = fuse_projections(w)
    return jhp, jw, hp, dataclasses.replace(w, layers=stack_layers(w.layers))


def _prefill_lanes(jhp, jw, prompts, S, B):
    """JAX per-lane prefill into the per-layer [B, S, Hkv, d] caches (lanes
    past the prompts stay zero); returns numpy caches and positions."""
    fwd = jax.jit(partial(jax_forward, jhp, exact=False, mm_impl="xla"))
    ks = [np.zeros((B, S, jhp.n_head_kv, jhp.n_embd_head_k), np.float32)
          for _ in range(jhp.n_kv_layers)]
    vs = [np.zeros((B, S, jhp.n_head_kv, jhp.n_embd_head_v), np.float32)
          for _ in range(jhp.n_kv_layers)]
    for b, ids in enumerate(prompts):
        cache = jax_init_cache(jhp, S, dtype=jnp.bfloat16)
        _, cache = fwd(jw, cache, jnp.asarray(ids, dtype=jnp.int32), 0)
        for i in range(jhp.n_kv_layers):
            ks[i][b] = np.asarray(cache.k[i], np.float32)
            vs[i][b] = np.asarray(cache.v[i], np.float32)
    return ks, vs


def _lanes_close(got, want, live, step):
    for b in live:
        scale = max(1.0, np.abs(want[b]).max())
        np.testing.assert_allclose(got[b], want[b], rtol=0, atol=1.5e-2 * scale,
                                   err_msg=f"step {step} lane {b}")
        assert int(got[b].argmax()) == int(want[b].argmax()), (step, b)


def _run_three_steps(S, port_step, B=4, alibi=0.0):
    """Lanes 0-2 hold PROMPTS, lane 3 is parked (pos = S). Three steps through
    the JAX forward_batched_decode and ``port_step``; the JAX argmax feeds
    both. ``alibi`` > 0 sets both models' ALiBi max bias. Returns the two
    final caches (numpy) and the positions."""
    jhp, jw, hp, w = _models(_buf())
    if alibi:
        jhp = dataclasses.replace(jhp, f_max_alibi_bias=alibi)
        hp = dataclasses.replace(hp, f_max_alibi_bias=alibi)
    ks, vs = _prefill_lanes(jhp, jw, PROMPTS, S, B)
    jcache = JKVCache(k=tuple(jnp.asarray(k, jnp.bfloat16) for k in ks),
                      v=tuple(jnp.asarray(v, jnp.bfloat16) for v in vs))
    cache = gemma.batched_cache_from_arrays(ks, vs)
    pos = np.array([len(p) for p in PROMPTS] + [S], np.int32)
    tokens = np.array([9, 12, 14, 3], np.int32)
    fwd = jax.jit(partial(jax_batched_decode, jhp))
    for step in range(3):
        jl, jcache = fwd(jw, jcache, jnp.asarray(tokens), jnp.asarray(pos))
        jl = np.asarray(jl)
        got = port_step(hp, w, cache, torch.from_numpy(tokens), torch.from_numpy(pos))
        _lanes_close(got, jl, range(3), step)
        tokens = jl.argmax(axis=1).astype(np.int32)
        pos = pos.copy()
        pos[:3] += 1
    k_ref = np.stack([np.asarray(k, np.float32) for k in jcache.k])
    v_ref = np.stack([np.asarray(v, np.float32) for v in jcache.v])
    return cache, k_ref, v_ref, pos


@pytest.mark.parametrize("S", [64, 256])
def test_forward_batched_decode_matches_jax(S, monkeypatch):
    """S = 256 takes flash_decode, S = 64 the per-lane masked softmax (the
    plain attention, called directly)."""
    calls = {"insert": 0, "flash": 0}
    real_insert, real_flash = kv_insert.insert_kv_rows_plain, flash_decode.flash_decode
    monkeypatch.setattr(kv_insert, "insert_kv_rows_plain",
                        lambda *a: calls.__setitem__("insert", calls["insert"] + 1)
                        or real_insert(*a))
    monkeypatch.setattr(flash_decode, "flash_decode",
                        lambda *a, **k: calls.__setitem__("flash", calls["flash"] + 1)
                        or real_flash(*a, **k))

    def step(hp, w, cache, tokens, pos):
        logits, _ = gemma.forward_batched_decode(hp, w, cache, tokens, pos)
        return logits.numpy()

    cache, k_ref, v_ref, pos = _run_three_steps(S, step)
    assert calls == {"insert": 3 * 3, "flash": 3 * 3 if S % 256 == 0 else 0}
    # the per-op route drops the parked lane's writes, as the JAX scatter
    np.testing.assert_allclose(cache.k.float().numpy(), k_ref, rtol=0, atol=4e-2)
    np.testing.assert_allclose(cache.v.float().numpy(), v_ref, rtol=0, atol=4e-2)
    assert not cache.k[:, 3].any()


def test_forward_batched_decode_with_alibi_matches_jax():
    """ALiBi keeps the per-op route off flash_decode: the per-lane masked
    softmax adds the bias in the plain attention."""
    def step(hp, w, cache, tokens, pos):
        assert hp.f_max_alibi_bias == 8.0
        logits, _ = gemma.forward_batched_decode(hp, w, cache, tokens, pos)
        return logits.numpy()

    cache, k_ref, v_ref, _ = _run_three_steps(256, step, alibi=8.0)
    np.testing.assert_allclose(cache.k.float().numpy(), k_ref, rtol=0, atol=4e-2)
    np.testing.assert_allclose(cache.v.float().numpy(), v_ref, rtol=0, atol=4e-2)


def test_plain_batched_step_matches_jax_batched_decode():
    hp_ = {}

    def step(hp, w, cache, tokens, pos):
        if "c" not in hp_:
            hp_["c"] = fused_decode_batch.prepare_batch(hp, "cpu", batch=4, max_seq=64)
        return fused_decode_batch.decode_step_batch(hp, w, cache, tokens, pos,
                                                    hp_["c"]).numpy()

    launches = fused_decode_batch.launches
    cache, k_ref, v_ref, pos = _run_three_steps(64, step)
    assert fused_decode_batch.launches == launches  # the CPU takes the plain twin
    for b in range(3):
        np.testing.assert_allclose(cache.k[:, b, : pos[b]].float().numpy(),
                                   k_ref[:, b, : pos[b]], rtol=0, atol=4e-2)
        np.testing.assert_allclose(cache.v[:, b, : pos[b]].float().numpy(),
                                   v_ref[:, b, : pos[b]], rtol=0, atol=4e-2)
    # the parked lane writes its (garbage) row 0, as the TPU kernel's clamp,
    # and nothing else
    assert not cache.k[:, 3, 1:].any() and cache.k[:, 3, 0].any()


def _step_setup(B=3, S=64):
    jhp, jw, hp, w = _models(_buf())
    ks, vs = _prefill_lanes(jhp, jw, PROMPTS[:B], S, B)
    consts = fused_decode_batch.prepare_batch(hp, "cpu", batch=B, max_seq=S)
    return hp, w, ks, vs, consts


def test_plain_batched_step_greedy_and_parked_lane():
    """greedy=True gives the argmax of the logits; a parked lane leaves the
    live lanes' logits bit-equal and changes only its own row 0."""
    hp, w, ks, vs, consts = _step_setup()
    toks = torch.tensor([9, 12, 14], dtype=torch.int32)
    live = torch.tensor([3, 2, 5], dtype=torch.int32)
    c1 = gemma.batched_cache_from_arrays(ks, vs)
    logits = fused_decode_batch.decode_step_batch(hp, w, c1, toks, live, consts)
    c2 = gemma.batched_cache_from_arrays(ks, vs)
    ids = fused_decode_batch.decode_step_batch(hp, w, c2, toks, live, consts, greedy=True)
    assert ids.dtype == torch.int32
    assert torch.equal(ids, torch.argmax(logits, dim=-1).to(torch.int32))
    assert torch.equal(c1.k, c2.k) and torch.equal(c1.v, c2.v)

    parked = torch.tensor([3, 64, 5], dtype=torch.int32)
    c3 = gemma.batched_cache_from_arrays(ks, vs)
    lp = fused_decode_batch.decode_step_batch(hp, w, c3, toks, parked, consts)
    assert torch.equal(lp[0], logits[0]) and torch.equal(lp[2], logits[2])
    orig = gemma.batched_cache_from_arrays(ks, vs)
    assert torch.equal(c3.k[:, 1, 1:], orig.k[:, 1, 1:])
    assert not torch.equal(c3.k[:, 1, 0], orig.k[:, 1, 0])


def test_batch_supported_rules():
    _, _, hp, w = _models(_buf())
    assert fused_decode_batch.batch_supported(hp, w, batch=4, max_seq=64)
    assert fused_decode_batch.batch_supported(hp, w, batch=64, max_seq=1024)
    assert not fused_decode_batch.batch_supported(hp, w, batch=65, max_seq=64)  # 4 m16 tiles
    assert not fused_decode_batch.batch_supported(hp, w, batch=4, max_seq=60)   # max_seq % 16
    unstacked = dataclasses.replace(w, layers=tuple(gemma.layer_view(w.layers, i)
                                                    for i in range(hp.block_count)))
    assert not fused_decode_batch.batch_supported(hp, unstacked, batch=4, max_seq=64)
    assert not fused_decode_batch.batch_supported(
        dataclasses.replace(hp, f_max_alibi_bias=8.0), w, batch=4, max_seq=64)
    hp_s, w_s = load_weights(GGUFFile(build_gemma3_gguf(n_layers=2)), mode="rowq8")
    w_s = fuse_projections(w_s)  # head_dim 16: not 128-aligned
    w_s = dataclasses.replace(w_s, layers=stack_layers(w_s.layers))
    assert not fused_decode_batch.batch_supported(hp_s, w_s, batch=4, max_seq=64)


@pytest.mark.parametrize("B,C", [(32, 1152), (8, 6912), (64, 6912), (3, 256)])
def test_split_plan_bounds(B, C):
    """Splits stay within the chunks there are and keep a block's staged
    activations under 96 KB; the 1B plan at B = 32 keeps at least four
    64-column chunks (what a lane has in flight) a split."""
    for rows in (1152, 1536, 64):
        s = fused_decode_batch.splits_for(rows, C, 132, B)
        assert 1 <= s <= C // 64
        mt = -(-B // 16)
        staged = mt * 16 * (-(-(C // 64) // s) * 64 + 8) * 2
        assert staged <= 96 * 1024 or s == C // 64
    assert [fused_decode_batch.splits_for(r, c, 132, 32)
            for r, c in ((1536, 1152), (1152, 1024), (1152, 6912))] == [4, 4, 15]


@pytest.mark.slow
def test_plain_batched_step_matches_interpret_megakernel(monkeypatch):
    """The plain twin against the Pallas batched kernel itself, in interpret
    mode (minutes of CPU emulation, hence slow)."""
    monkeypatch.setenv("LLMI_FUSED_INTERPRET", "1")
    from llm_inference_tpu.models.weights import stack_layers as jax_stack
    from llm_inference_tpu.ops.pallas.fused_decode_batch import decode_step_megakernel_batch

    hp, w, ks, vs, consts = _step_setup()
    jhp, jw = jax_load_weights(JGGUFFile(_buf()), mode="rowq8")
    jw = jax_fuse(jw)
    jw = dataclasses.replace(jw, layers=jax_stack(jw.layers))
    jcache = JKVCache(k=jnp.asarray(np.stack(ks), jnp.bfloat16),
                      v=jnp.asarray(np.stack(vs), jnp.bfloat16))
    toks = np.array([9, 12, 14], np.int32)
    pos = np.array([3, 2, 5], np.int32)
    ref, kc, _ = decode_step_megakernel_batch(jhp, jw, jcache, jnp.asarray(toks),
                                              jnp.asarray(pos), interpret=True)
    cache = gemma.batched_cache_from_arrays(ks, vs)
    got = fused_decode_batch.decode_step_batch(hp, w, cache, torch.from_numpy(toks),
                                               torch.from_numpy(pos), consts)
    _lanes_close(got.numpy(), np.asarray(ref), range(3), 0)
    np.testing.assert_allclose(cache.k.float().numpy(), np.asarray(kc, np.float32),
                               rtol=0, atol=4e-2)
