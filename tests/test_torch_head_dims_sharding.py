"""Per-layer head dims on the port's sharded per-op path, on the CPU, against
llm_inference_tpu.

The checkpoints are tests/test_torch_head_dims.py's (``build_head_dims_gguf``:
global heads of 64, sliding heads of 32, gemma4 with shared-KV layers and
Gemma-3), served over meshes of repeated CPU devices by the port and over
conftest.py's 8 virtual CPU devices by the JAX package's GSPMD path.

Bars:
  - the sharded ``Engine`` (``sharding_fn`` and ``cache_sharding`` together,
    or either alone) in serve-q8 and a lossless mode: the JAX engine's
    sharded greedy stream and the port's unsharded one, token for token;
    ``decode_route`` "sharded", and a head-sharded cache whose every rank
    holds one tensor a KV layer at that layer's widths;
  - the DP x TP server (lanes over the 'data' rows, KV heads over the
    'model' ranks) and the paged server with sharded weights (whole
    pools): the JAX servers' sharded streams;
  - each rank's per-layer cache shard bit-equal to the data of JAX's
    addressable shard on the same mesh place, after the same K/V rows are
    written (the port through its sharded attention, ``_over_heads``), and
    each rank's batched lanes of the shape of JAX's shard.
The routes that still refuse per-layer head dims are
tests/test_torch_head_dims.py's ``test_closed_routes_raise``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_inference_tpu import serving as jax_serving
from llm_inference_tpu.engine import Engine as JEngine
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.models import gemma as jgemma
from llm_inference_tpu.models.hparams import load_hparams as jax_load_hparams
from llm_inference_tpu.parallel import batched_kv_cache_sharding as jax_batched_sharding
from llm_inference_tpu.parallel import gemma_sharding_fn as jax_sharding_fn
from llm_inference_tpu.parallel import kv_cache_sharding as jax_kv_sharding
from llm_inference_tpu.serving import BatchedServer as JServer
from llm_inference_tpu_torch.engine import Engine
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.models.hparams import load_hparams
from llm_inference_tpu_torch.parallel import (batched_kv_cache_sharding, gemma_sharding_fn,
                                              kv_cache_sharding)
from llm_inference_tpu_torch.quant.device import ShardedTensor
from llm_inference_tpu_torch.serving import BatchedServer

from test_torch_head_dims import PREFILL, build_head_dims_gguf
from test_torch_sharding import cpu_mesh, jax_mesh
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

REQUESTS = [([2, 7, 8], 7), ([2, 9], 5), ([2, 5, 6, 30], 6), ([2, 11], 5)]
SERVER = dict(max_seq=64, max_batch=4, mode="serve-q8", decode_chunk=4)


@pytest.fixture(scope="module")
def bufs():
    return {arch: build_head_dims_gguf(arch) for arch in ("gemma4", "gemma3")}


def _no_stop(x):
    x.tokenizer.eos_id = -1
    x.tokenizer.end_of_turn_id = -1
    return x


def _rank_widths(cache) -> list:
    """Per rank of a head-sharded cache: each KV layer's (heads, dk, dv)."""
    return [[(k.shape[-2], k.shape[-1], v.shape[-1]) for k, v in zip(c.k, c.v)]
            for c in cache.shards]


# (arch, mode, which shardings): gemma4's shared-KV layers and Gemma-3's
# every-layer caches, in serve-q8 and a lossless mode, and each sharding alone
ENGINE_CASES = [("gemma4", "serve-q8", "both"), ("gemma4", "serve-q4", "both"),
                ("gemma3", "serve-q8", "both"), ("gemma3", "serve-q", "both"),
                ("gemma4", "serve-q8", "sharding_fn"), ("gemma3", "serve-q8", "cache_sharding")]


@pytest.mark.parametrize("arch,mode,which", ENGINE_CASES)
def test_sharded_engine_streams_match_jax(bufs, arch, mode, which):
    buf = bufs[arch]
    m, jm = cpu_mesh(2), jax_mesh(2)
    hkv = load_hparams(GGUFFile(buf).metadata).n_head_kv
    kw, jkw = {}, {}
    if which in ("both", "sharding_fn"):
        kw["sharding_fn"], jkw["sharding_fn"] = gemma_sharding_fn(m), jax_sharding_fn(jm)
    if which in ("both", "cache_sharding"):
        kw["cache_sharding"], jkw["cache_sharding"] = (kv_cache_sharding(m, hkv),
                                                       jax_kv_sharding(jm, hkv))
    eng = _no_stop(Engine(GGUFFile(buf), max_seq=64, mode=mode, decode_chunk=4, device="cpu",
                          **kw))
    single = _no_stop(Engine(GGUFFile(buf), max_seq=64, mode=mode, decode_chunk=4, device="cpu"))
    jeng = _no_stop(JEngine(JGGUFFile(buf), max_seq=64, mode=mode, decode_chunk=4, **jkw))
    got = eng.generate_from_ids(PREFILL, n_predict=8)
    assert got == jeng.generate_from_ids(PREFILL, n_predict=8)
    assert got == single.generate_from_ids(PREFILL, n_predict=8)
    assert eng.decode_route == "sharded"
    assert isinstance(eng.weights.layers[0].wqkv, ShardedTensor) == ("sharding_fn" in kw)
    cache = eng.new_cache()
    if "cache_sharding" in kw:
        hp = eng.hparams
        want = [(hkv // 2, *gemma.head_dims(hp, i)) for i in range(hp.n_kv_layers)]
        assert isinstance(cache, gemma.ShardedKVCache)
        assert _rank_widths(cache) == [want, want]
        assert len({k.shape[-1] for k in cache.shards[0].k}) == 2  # two widths
    else:
        assert isinstance(cache.k, tuple)


def _jax_shard(leaf, device) -> np.ndarray:
    return np.asarray(next(sh for sh in leaf.addressable_shards if sh.device == device).data)


@pytest.mark.parametrize("arch", ["gemma4", "gemma3"])
def test_cache_shards_bit_equal_to_jax(bufs, arch):
    """The same K/V rows (seeded numpy, bf16-exact) written at positions 3-7
    of every KV layer: the port through ``_single_attend`` over its
    ``ShardedKVCache`` (each rank's heads, at the layer's widths), JAX
    through its cache write on per-layer arrays device-put with its cache
    sharding; then each rank's layer shard bit-equal to JAX's addressable
    shard on that rank's device. The batched caches: each row's ranks'
    lanes of the shape of JAX's shard."""
    buf = bufs[arch]
    hp = load_hparams(GGUFFile(buf).metadata)
    jhp = jax_load_hparams(JGGUFFile(buf).metadata)
    m, jm = cpu_mesh(2), jax_mesh(2)
    cache = gemma.init_cache(hp, 16, sharding=kv_cache_sharding(m, hp.n_head_kv))
    jcache = jgemma.init_cache(jhp, 16, sharding=jax_kv_sharding(jm, hp.n_head_kv),
                               dtype=jnp.bfloat16)
    rng = np.random.default_rng(19)
    pos, n = 3, 5
    for i in range(hp.n_kv_layers):
        dk, dv = gemma.head_dims(hp, i)
        q = torch.from_numpy(rng.standard_normal((n, hp.n_head, dk)).astype(np.float32))
        k, v = (rng.standard_normal((n, hp.n_head_kv, d)).astype(np.float32) for d in (dk, dv))
        k, v = (torch.from_numpy(a).bfloat16().float() for a in (k, v))
        gemma._single_attend(hp, cache, i, pos=pos, n_valid=n, window=0, exact=False,
                             f64_scores=False)(q, k, v)
        for side, new in ((jcache.k, k), (jcache.v, v)):
            ja = jgemma._write_cache(side[i], jnp.asarray(new.numpy()), pos, n)
            for r in range(2):
                got = (cache.shards[r].k if side is jcache.k else cache.shards[r].v)[i]
                want = _jax_shard(ja, jm.devices[0, r])
                assert tuple(got.shape) == want.shape == (16, hp.n_head_kv // 2, new.shape[-1])
                np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                              want.view(np.int16), (i, r))
                assert got[pos:pos + n].abs().sum() > 0
    m4, jm4 = cpu_mesh(2, 2), jax_mesh(2, 2)
    lanes = gemma.init_batched_cache(hp, 4, 16,
                                     sharding=batched_kv_cache_sharding(m4, hp.n_head_kv))
    jsh = jax_batched_sharding(jm4, hp.n_head_kv)
    import jax

    for i in range(hp.n_kv_layers):
        dk, _ = gemma.head_dims(hp, i)
        ja = jax.device_put(jnp.zeros((4, 16, hp.n_head_kv, dk), jnp.bfloat16), jsh)
        for d, row in enumerate(lanes.rows):
            for r, c in enumerate(row.shards):
                assert tuple(c.k[i].shape) == _jax_shard(ja, jm4.devices[d, r]).shape


@pytest.mark.parametrize("arch,paged", [("gemma4", False), ("gemma3", False), ("gemma4", True)])
def test_sharded_servers_match_jax(bufs, arch, paged, monkeypatch):
    """The DP x TP server over data 2 x model 2 (per-layer lanes of a KV
    head a rank), or the paged server with weights over 2 ranks and whole
    per-layer pools: the JAX servers' streams and the port's unsharded
    server's."""
    buf = bufs[arch]
    hkv = load_hparams(GGUFFile(buf).metadata).n_head_kv
    kw = {}
    if paged:
        monkeypatch.setenv("LLMI_PAGE", "16")
        monkeypatch.setattr(jax_serving, "PAGE", 16)
        kw["kv_pages"] = 12
        m, jm = cpu_mesh(2), jax_mesh(2)
    else:
        m, jm = cpu_mesh(2, 2), jax_mesh(2, 2)
    single = _no_stop(BatchedServer(GGUFFile(buf), device="cpu", **SERVER, **kw))
    srv = _no_stop(BatchedServer(GGUFFile(buf), device="cpu", **SERVER, **kw,
                                 sharding_fn=gemma_sharding_fn(m),
                                 cache_sharding=batched_kv_cache_sharding(m, hkv)))
    jsrv = _no_stop(JServer(JGGUFFile(buf), **SERVER, **kw, sharding_fn=jax_sharding_fn(jm),
                            cache_sharding=jax_batched_sharding(jm, hkv)))
    got = srv.run(REQUESTS)
    assert got == jsrv.run(REQUESTS) == single.run(REQUESTS)
    assert srv.decode_route == ("paged-sharded" if paged else "sharded")
    hp = srv.hparams
    if paged:
        assert [t.shape[-1] for t in srv._caches.k] == [gemma.head_dims(hp, i)[0]
                                                         for i in range(hp.n_kv_layers)]
        assert all(t.shape[-2] == hkv for t in srv._caches.k)  # whole pools
    else:
        assert len(srv._caches.rows) == 2 and srv._caches.lanes == 2
        want = [(hkv // 2, *gemma.head_dims(hp, i)) for i in range(hp.n_kv_layers)]
        for row in srv._caches.rows:
            assert [[(k.shape[0], k.shape[-2], k.shape[-1], v.shape[-1])
                     for k, v in zip(c.k, c.v)] for c in row.shards] == \
                [[(2, *w) for w in want]] * 2
