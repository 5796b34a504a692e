"""The port's stochastic sampling on the CPU against llm_inference_tpu.

Inputs come from numpy seeds; the JAX references run jitted, as the JAX
package samples (inside jit XLA turns the division by the temperature into
a product with its reciprocal: the port does the same). Bars:

  - keys (``PRNGKey``, nested ``fold_in``) and random words bit-equal to
    ``jax.random`` (threefry2x32, partitionable counters);
  - ``uniform`` bit-equal; ``-log(u)`` within 1 ulp (torch's and XLA's
    ``log`` differ in the last bit); ``gumbel`` within 1 ulp of
    max(|g|, 1): the outer log of a value near 1 turns that last-bit
    difference into many ulps of a result near 0, never more than one
    ulp of the noise's scale;
  - ``sample`` ids identical to the JAX package's over the grid (the full
    product at widths 4 and 1000, a pairwise-covering set at 262144), and
    tests/test_fusion.py's cases;
  - a chi-square test (scipy, p > 1e-4) of 20000 batched draws against
    softmax(masked logits / T), and no draw outside the mask;
  - end to end, on tests/test_torch_serving.py's WIDE checkpoint: the
    port's ``Engine`` and ``BatchedServer`` streams identical to the JAX
    package's (so the Engine's ``p + 1`` and the server's ``(slot, p)``
    keys are each held), the same seed giving the same streams, another
    seed others, the stochastic server on the per-op routes.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import llm_inference_tpu.serving as jserving
from llm_inference_tpu.engine import Engine as JEngine
from llm_inference_tpu.sampling import SamplingConfig as JSamplingConfig
from llm_inference_tpu.sampling import sample as jax_sample
from llm_inference_tpu_torch import random
from llm_inference_tpu_torch.engine import Engine
from llm_inference_tpu_torch.parallel import make_mesh
from llm_inference_tpu_torch.sampling import SamplingConfig, gumbel, pick_batch, sample, uniform
from llm_inference_tpu_torch.serving import BatchedServer

from fixtures import build_gemma3_gguf
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

TINY = float(np.finfo(np.float32).tiny)
TEMPERATURES = (0.7, 1.0, 1.5)
TOP_KS = (0, 1, 2, 40, 1 << 20)  # the last one >= every vocabulary here
TOP_PS = (1.0, 0.9, 0.5)
FULL = list(itertools.product(TEMPERATURES, TOP_KS, TOP_PS))
# every pair of (temperature, top_k), (temperature, top_p) and (top_k, top_p) once
PAIRWISE = [(TEMPERATURES[(i + j) % 3], k, p)
            for i, k in enumerate(TOP_KS) for j, p in enumerate(TOP_PS)]


def _jax_key(words) -> jax.Array:
    return jax.random.wrap_key_data(jnp.asarray(words, dtype=jnp.uint32))


def test_jax_uses_the_partitionable_threefry():
    """The port copies JAX 0.9's default generator; a JAX that changes it
    fails here first."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31, 2**32 - 1])
def test_keys_bit_equal(seed):
    key = jax.random.PRNGKey(seed)
    assert (np.asarray(jax.random.key_data(key)) == random.PRNGKey(seed)).all()
    data = [0, 1, 5, 2**31, 2**32 - 1]
    for d in data:
        jk = jax.random.fold_in(key, d)
        pk = random.fold_in(random.PRNGKey(seed), d)
        assert (np.asarray(jax.random.key_data(jk)) == pk).all()
        for e in data[:3]:  # nested, as the server's lane keys
            assert (np.asarray(jax.random.key_data(jax.random.fold_in(jk, e)))
                    == random.fold_in(pk, e)).all()
    # batched: keys [3, 2] under data [4, 3] broadcast, as a server chunk's
    lanes = random.fold_in(random.PRNGKey(seed), np.arange(3))
    got = random.fold_in(lanes[None], np.arange(12).reshape(4, 3))
    for i, j in np.ndindex(4, 3):
        want = jax.random.fold_in(_jax_key(lanes[j]), 3 * i + j)
        assert (np.asarray(jax.random.key_data(want)) == got[i, j]).all()


@pytest.mark.parametrize("n", [1, 1000, 262144])
def test_random_bits_bit_equal(n):
    keys = random.fold_in(random.PRNGKey(3), np.array([0, 9, 2**32 - 1]))
    got = random.random_bits(random.to_device(keys, "cpu"), n)  # batched over 3 lanes
    assert got.shape == (3, n) and got.dtype == torch.int64
    bits = jax.jit(jax.vmap(lambda k: jax.random.bits(jax.random.wrap_key_data(k), (n,),
                                                      jnp.uint32)))
    want = np.asarray(bits(jnp.asarray(keys))).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_uniform_and_gumbel_within_an_ulp():
    n = 262144
    key = random.fold_in(random.PRNGKey(3), 5)
    tk = random.to_device(key, "cpu")
    jk = _jax_key(key)
    u_jax = np.asarray(jax.jit(lambda k: jax.random.uniform(k, (n,), minval=TINY))(jk))
    u = uniform(tk, n, minval=TINY).numpy()
    np.testing.assert_array_equal(u, u_jax)
    assert u.min() >= TINY and u.max() < 1.0
    inner_jax = np.asarray(jax.jit(lambda k: -jnp.log(jax.random.uniform(k, (n,), minval=TINY)))(jk))
    inner = (-torch.log(torch.from_numpy(u))).numpy()
    assert np.abs(inner.view(np.int32).astype(np.int64) - inner_jax.view(np.int32)).max() <= 1
    g_jax = np.asarray(jax.jit(lambda k: jax.random.gumbel(k, (n,)))(jk)).astype(np.float64)
    g = gumbel(tk, n).numpy().astype(np.float64)
    ulp = np.spacing(np.maximum(np.abs(g_jax), 1.0).astype(np.float32)).astype(np.float64)
    assert (np.abs(g - g_jax) <= ulp).all()


def _grid_ids(logits: np.ndarray, dtype: str, cfgs, keys: np.ndarray):
    """(port ids, JAX ids), each [len(cfgs), len(keys)], of ``logits`` under
    every config and key; JAX's in one jit over all configs."""
    jl = jnp.asarray(logits)
    tl = torch.from_numpy(logits)
    if dtype == "bf16":
        jl, tl = jl.astype(jnp.bfloat16), tl.to(torch.bfloat16)
    run = jax.jit(lambda lg, ks: jnp.stack([
        jax.vmap(lambda k: jax_sample(lg, JSamplingConfig(*c), jax.random.wrap_key_data(k)))(ks)
        for c in cfgs]))
    want = np.asarray(run(jl, jnp.asarray(keys)))
    tk = random.to_device(keys, "cpu")
    rows = tl[None].expand(len(keys), -1)
    got = np.stack([pick_batch(rows, SamplingConfig(*c), tk).numpy() for c in cfgs])
    return got, want


@pytest.mark.parametrize("vocab,dtype", [(4, "f32"), (4, "bf16"), (1000, "f32"), (1000, "bf16"),
                                         (262144, "f32"), (262144, "bf16")])
def test_sample_ids_match_jax(vocab, dtype):
    rng = np.random.default_rng(vocab)
    logits = (rng.standard_normal(vocab) * (1 if vocab == 4 else 3)).astype(np.float32)
    wide = vocab > 1000
    keys = random.fold_in(random.PRNGKey(11), np.arange(2 if wide else 8))
    cfgs = PAIRWISE if wide else FULL
    got, want = _grid_ids(logits, dtype, cfgs, keys)
    bad = [(cfgs[i], j, got[i, j], want[i, j]) for i, j in zip(*np.nonzero(got != want))]
    assert not bad, f"ids differ from JAX's (config, key, port, jax): {bad[:5]}"
    assert len(np.unique(got[[i for i, c in enumerate(cfgs) if c[1] != 1]])) > 1  # it samples


def test_fusion_cases_match_jax():
    """tests/test_fusion.py's cases: top-2 keeps ids 1 and 3; p(1) ~ 0.52
    covers the 0.5 nucleus alone."""
    logits = torch.tensor([0.1, 5.0, -1.0, 4.9])
    key = random.to_device(random.PRNGKey(0), "cpu")
    assert int(sample(logits, SamplingConfig())) == 1
    top2 = int(sample(logits, SamplingConfig(temperature=0.7, top_k=2), key))
    nucleus = int(sample(logits, SamplingConfig(temperature=1.0, top_p=0.5), key))
    assert top2 in (1, 3) and nucleus == 1
    got, want = _grid_ids(logits.numpy(), "f32", [(0.7, 2, 1.0), (1.0, 0, 0.5)],
                          random.PRNGKey(0)[None])
    np.testing.assert_array_equal(got, want)
    assert got[:, 0].tolist() == [top2, nucleus]


def test_sample_needs_a_key_and_keeps_greedy():
    logits = torch.tensor([[0.0, 3.0, 3.0], [float("nan"), 1.0, 2.0]])
    cfg = SamplingConfig(temperature=0.9)
    with pytest.raises(ValueError, match="keys"):
        pick_batch(logits, cfg)
    with pytest.raises(ValueError, match="keys"):
        sample(logits[0], cfg)
    keys = random.to_device(random.fold_in(random.PRNGKey(1), np.arange(2)), "cpu")
    # greedy ignores keys: torch.argmax, its NaN rule included
    assert pick_batch(logits, SamplingConfig(), keys).tolist() == [1, 0]
    assert int(sample(logits[0], SamplingConfig(), keys[0])) == 1


@pytest.mark.parametrize("cfg", [(1.0, 0, 1.0), (0.8, 5, 1.0), (1.3, 0, 0.8), (0.6, 6, 0.9)])
def test_draws_follow_the_masked_softmax(cfg):
    """20000 draws (one batched call, a key each) against softmax(masked
    logits / T), the mask computed here in float64 by the JAX package's
    rules: top-k keeps ties at the k-th value; top-p keeps the smallest
    sorted prefix whose mass reaches p."""
    t, k, p = cfg
    logits = np.array([1.2, -0.3, 0.8, 2.0, 0.0, -1.5, 1.9, 0.5], np.float32)
    x = logits.astype(np.float64) / t
    keep = np.ones(len(x), bool)
    if k:
        keep &= x >= np.sort(x)[::-1][k - 1]
    if p < 1.0:
        s = np.sort(np.where(keep, x, -np.inf))[::-1]
        cum = np.cumsum(np.exp(s - s[0]) / np.exp(s - s[0]).sum())
        keep &= x >= s[min(int((cum < p).sum()), len(x) - 1)]
    prob = np.where(keep, np.exp(x - x.max()), 0.0)
    prob /= prob.sum()
    n = 20000
    keys = random.to_device(random.fold_in(random.PRNGKey(2024), np.arange(n)), "cpu")
    ids = pick_batch(torch.from_numpy(logits)[None].expand(n, -1), SamplingConfig(*cfg), keys)
    counts = np.bincount(ids.numpy(), minlength=len(x))
    assert counts[~keep].sum() == 0
    assert stats.chisquare(counts[keep], n * prob[keep]).pvalue > 1e-4


# -- end to end ---------------------------------------------------------------------

VOCAB = [f"t{i}" for i in range(256)]
VOCAB[1], VOCAB[2], VOCAB[3] = "<eos>", "<bos>", "<unk>"
# tests/test_torch_serving.py's WIDE: streams that wander over the vocabulary
WIDE = dict(n_layers=3, n_embd=256, n_ff=512, n_head=4, n_head_kv=2, head_dim=128, vocab=VOCAB,
            weight_std=0.15)
CFG = (0.8, 40, 0.95)
PROMPT, N_PREDICT, SEED = [2, 7, 8], 12, 5
# tests/test_serving.py:179-200's case (serve, two lanes)
SERVE_REQS, SERVE_SEED = [([2, 7, 8, 9], 8), ([2, 12, 9], 8)], 7
# more requests than slots: slots are reused at new positions
MORE, MORE_SEED = [([2, 7, 8], 9), ([2, 9], 3), ([2, 5, 6], 6), ([2, 11], 8), ([2, 4, 13, 7], 5)], 3
PAGE = 16


def _no_stop(x):
    x.tokenizer.eos_id = -1
    x.tokenizer.end_of_turn_id = -1
    return x


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = tmp_path_factory.mktemp("ckpt") / "wide.gguf"
    p.write_bytes(build_gemma3_gguf(**WIDE))
    return str(p)


@pytest.fixture(scope="module")
def jax_streams(path):
    """The JAX package's stochastic streams: its Engine in serve-q8 (per op
    on the CPU) and parity; its server in serve (two lanes, dense) and in
    serve-q8 paged with more requests than slots."""
    cfg = JSamplingConfig(*CFG)
    out = {}
    for mode in ("serve-q8", "parity"):
        eng = _no_stop(JEngine(path, max_seq=64, mode=mode, decode_chunk=4, sampling=cfg,
                               seed=SEED))
        out[mode] = eng.generate_from_ids(PROMPT, n_predict=N_PREDICT)
    out["server serve"] = jserving.BatchedServer(
        path, max_seq=64, max_batch=2, mode="serve", decode_chunk=4, sampling=cfg,
        seed=SERVE_SEED).run(SERVE_REQS)
    old, jserving.PAGE = jserving.PAGE, PAGE
    try:
        out["server paged"] = jserving.BatchedServer(
            path, max_seq=64, max_batch=2, mode="serve-q8", decode_chunk=3, kv_pages=8,
            sampling=cfg, seed=MORE_SEED).run(MORE)
    finally:
        jserving.PAGE = old
    return out


def _engine(path, mode="serve-q8", seed=SEED, cfg=CFG, **kw):
    return _no_stop(Engine(path, max_seq=64, mode=mode, decode_chunk=4, device="cpu",
                           sampling=SamplingConfig(*cfg), seed=seed, **kw))


@pytest.mark.parametrize("mode,route", [("serve-q8", "kernel"), ("serve-q8", "per-op"),
                                        ("serve-q8", "tp"), ("parity", "per-op")])
def test_engine_streams_match_jax(path, jax_streams, mode, route, monkeypatch):
    """Every decode step draws under fold_in(key, p + 1): the prefill under
    the prompt's length, then the chunks' steps. The tensor-parallel route
    (two CPU ranks) has the kernel route's numbers."""
    if route == "per-op":
        monkeypatch.setenv("LLMI_NO_FUSED_DECODE", "1")
    mesh = make_mesh(model=2, devices=[torch.device("cpu")] * 2) if route == "tp" else None
    eng = _engine(path, mode, tp_mesh=mesh)
    assert eng.decode_route == route
    out = eng.generate_from_ids(PROMPT, n_predict=N_PREDICT)
    assert out == jax_streams[mode]
    assert len(set(out)) > 4  # a sampled stream, not a repeated token


@pytest.mark.parametrize("mode", ["serve-q", "serve-q4"])
def test_capacity_route_samples(path, mode, monkeypatch):
    """The capacity route (forced) draws as the lossless kernel route does:
    the same whole-step numbers, the same keys."""
    kernel = _engine(path, mode)
    assert kernel.decode_route == "kernel"
    monkeypatch.setenv("LLMI_FORCE_CAPACITY", "1")
    cap = _engine(path, mode)
    assert cap.decode_route == "capacity"
    out = cap.generate_from_ids(PROMPT, n_predict=N_PREDICT)
    assert out == kernel.generate_from_ids(PROMPT, n_predict=N_PREDICT) and len(set(out)) > 4


def test_engine_seeds(path):
    eng = _engine(path)
    a = eng.generate_from_ids(PROMPT, n_predict=N_PREDICT)
    assert eng.generate_from_ids(PROMPT, n_predict=N_PREDICT) == a  # the same engine again
    assert _engine(path).generate_from_ids(PROMPT, n_predict=N_PREDICT) == a
    assert _engine(path, seed=SEED + 1).generate_from_ids(PROMPT, n_predict=N_PREDICT) != a
    greedy = _no_stop(Engine(path, max_seq=64, mode="serve-q8", decode_chunk=4, device="cpu"))
    assert greedy.generate_from_ids(PROMPT, n_predict=N_PREDICT) != a


def _server(path, seed, mode="serve-q8", **kw):
    return BatchedServer(path, max_seq=64, max_batch=2, mode=mode, device="cpu",
                         sampling=SamplingConfig(*CFG), seed=seed, **kw)


@pytest.mark.parametrize("paged", [False, True])
def test_server_streams_match_jax(path, jax_streams, paged, monkeypatch):
    """Lane keys fold_in(fold_in(key, slot), p) at each step's input
    position p (n_prompt at the prefill), dense and paged alike."""
    monkeypatch.setenv("LLMI_PAGE", str(PAGE))
    pages = dict(kv_pages=8) if paged else {}
    srv = _server(path, SERVE_SEED, mode="serve", decode_chunk=4, **pages)
    assert srv.decode_route == ("paged-per-op" if paged else "per-op")
    assert srv.run(SERVE_REQS) == jax_streams["server serve"]
    srv = _server(path, MORE_SEED, decode_chunk=3, **pages)
    assert srv.decode_route == ("paged-per-op" if paged else "per-op")
    out = srv.run(MORE)
    assert out == jax_streams["server paged"]
    assert sum(len(set(o)) for o in out) > 12


def test_server_routes_seeds_and_refusals(path, monkeypatch):
    """A stochastic server leaves the kernel routes (its argmax is in the
    kernel) for the per-op ones; the same seed gives the same streams,
    another seed others, greedy others again; parity stays greedy."""
    greedy = BatchedServer(path, max_seq=64, max_batch=2, mode="serve-q8", decode_chunk=3,
                           device="cpu")
    assert greedy.decode_route == "kernel"
    monkeypatch.setenv("LLMI_PAGE", str(PAGE))
    monkeypatch.setenv("LLMI_PAGED_MEGAKERNEL", "1")
    assert _server(path, 0, decode_chunk=3, kv_pages=8).decode_route == "paged-per-op"
    a = _server(path, MORE_SEED, decode_chunk=3).run(MORE)
    assert _server(path, MORE_SEED, decode_chunk=3).run(MORE) == a
    assert _server(path, MORE_SEED + 1, decode_chunk=3).run(MORE) != a
    assert greedy.run(MORE) != a
    with pytest.raises(ValueError, match="greedy"):
        _server(path, 0, mode="parity")
