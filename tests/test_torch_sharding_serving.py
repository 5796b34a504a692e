"""The port's sharded ``BatchedServer`` on the CPU against llm_inference_tpu.

The JAX side runs its GSPMD path on conftest.py's 8 virtual CPU devices,
the port its ranks op by op over meshes of repeated CPU devices
(tests/test_torch_sharding.py holds the layouts, shards and logits,
tests/test_torch_sharding_engine.py the ``Engine``). Bars: greedy streams
equal token for token to the JAX package's sharded streams and to the
port's single-device streams:

  - the tensor-parallel server (tests/test_parallel.py:96-114), the DP x TP
    server over data 2 x model 4 (lanes on the 'data' rows, KV heads on
    the 'model' ranks; tests/test_parallel.py:116-141) and the paged server
    with sharded weights (whole pools);
  - the refusals the JAX package makes, and the port's own.
"""

import dataclasses

import numpy as np
import pytest

from llm_inference_tpu import serving as jax_serving
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.parallel import batched_kv_cache_sharding as jax_batched_sharding
from llm_inference_tpu.parallel import gemma_sharding_fn as jax_sharding_fn
from llm_inference_tpu.serving import BatchedServer as JServer
from llm_inference_tpu_torch.engine import Engine
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.models.gemma import BatchedKVCache, LaneRows, ShardedKVCache
from llm_inference_tpu_torch.parallel import (batched_kv_cache_sharding, gemma_sharding_fn,
                                              kv_cache_sharding)
from llm_inference_tpu_torch.quant.device import ShardedTensor
from llm_inference_tpu_torch.sampling import SamplingConfig
from llm_inference_tpu_torch.serving import BatchedServer

from fixtures import build_gemma3_gguf
from test_torch_sharding import VOCAB, cpu_mesh, jax_mesh
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

REQUESTS = [([2, 7, 8], 5), ([2, 90, 12], 5), ([2, 5, 6, 7], 5), ([2, 11], 5)]


@pytest.fixture(scope="module")
def bufs():
    return {
        # the test_parallel.py geometry with a 512-token vocabulary (so the
        # embedding shards too) and weights whose greedy streams wander
        "wide": build_gemma3_gguf(n_layers=2, n_embd=256, n_ff=512, n_head=8, n_head_kv=8,
                                  vocab=VOCAB, seed=3, weight_std=0.2),
        "dp": build_gemma3_gguf(n_layers=2, n_embd=128, n_ff=256, n_head=4, n_head_kv=4,
                                vocab=VOCAB, seed=3, weight_std=0.2),
    }


def _no_stop(x):
    x.tokenizer.eos_id = -1
    x.tokenizer.end_of_turn_id = -1
    return x


def _servers(buf, model, data, **kw):
    """(port single, port sharded server, JAX sharded) over REQUESTS."""
    single = _no_stop(BatchedServer(GGUFFile(buf), max_seq=64, max_batch=4, mode="serve-q8",
                                    decode_chunk=4, device="cpu", **kw))
    hkv = single.hparams.n_head_kv
    m, jm = cpu_mesh(model, data), jax_mesh(model, data)
    srv = _no_stop(BatchedServer(GGUFFile(buf), max_seq=64, max_batch=4, mode="serve-q8",
                                 decode_chunk=4, device="cpu", sharding_fn=gemma_sharding_fn(m),
                                 cache_sharding=batched_kv_cache_sharding(m, hkv), **kw))
    jsrv = _no_stop(JServer(JGGUFFile(buf), max_seq=64, max_batch=4, mode="serve-q8",
                            decode_chunk=4, sharding_fn=jax_sharding_fn(jm),
                            cache_sharding=jax_batched_sharding(jm, hkv), **kw))
    return [s.run(REQUESTS) for s in (single, srv, jsrv)], srv


def test_tp_server_matches(bufs):
    (single, got, want), srv = _servers(bufs["wide"], 8, 1)
    assert got == want == single
    assert srv.decode_route == "sharded"
    rows = srv._caches.rows
    assert isinstance(srv._caches, LaneRows) and len(rows) == 1 and len(rows[0].shards) == 8


def test_dp_x_tp_server_matches(bufs):
    (single, got, want), srv = _servers(bufs["dp"], 4, 2)
    assert got == want == single
    assert any(len(set(o)) > 1 for o in got)
    caches, mesh = srv._caches, srv._mesh
    assert caches.lanes == 2 and len(caches.rows) == 2  # lanes over 'data'
    for d, row in enumerate(caches.rows):
        assert isinstance(row, ShardedKVCache) and row.data_row == d
        assert [c.k.shape[1:4] for c in row.shards] == [(2, 64, 1)] * 4  # a KV head a rank
        assert all(c.k.device == mesh.devices[d, r] for r, c in enumerate(row.shards))
    assert srv._row_weights[1].layers[0].wqkv.data_row == 1
    # a device that two rows share holds their weights once
    assert srv._row_weights[1].layers[0].w_down.shards[0].q is \
        srv._row_weights[0].layers[0].w_down.shards[0].q


def test_paged_server_with_sharded_weights_matches(bufs, monkeypatch):
    monkeypatch.setenv("LLMI_PAGE", "16")
    monkeypatch.setattr(jax_serving, "PAGE", 16)
    (single, got, want), srv = _servers(bufs["dp"], 2, 2, kv_pages=12)
    assert got == want == single
    assert srv.decode_route == "paged-sharded"
    assert isinstance(srv.weights.layers[0].wqkv, ShardedTensor)
    assert srv._caches.k_all is not None and srv._caches.k_all.shape[3] == 4  # whole pools


def test_sharded_parity_and_sampled_servers(bufs):
    m = cpu_mesh(2, 2)
    for kw in (dict(mode="parity"), dict(mode="serve", sampling=SamplingConfig(temperature=0.8),
                                         seed=3)):
        single = _no_stop(BatchedServer(GGUFFile(bufs["dp"]), max_seq=64, max_batch=4,
                                        decode_chunk=4, device="cpu", **kw))
        srv = _no_stop(BatchedServer(GGUFFile(bufs["dp"]), max_seq=64, max_batch=4,
                                     decode_chunk=4, device="cpu",
                                     sharding_fn=gemma_sharding_fn(m),
                                     cache_sharding=batched_kv_cache_sharding(m, 4), **kw))
        assert srv.decode_route == "sharded"
        assert srv.run(REQUESTS) == single.run(REQUESTS)


def test_sharded_refusals(bufs):
    m = cpu_mesh(2, 2)
    path = GGUFFile(bufs["dp"])
    with pytest.raises(ValueError, match="does not split"):
        BatchedServer(path, max_seq=64, max_batch=3, mode="serve-q8", device="cpu",
                      cache_sharding=batched_kv_cache_sharding(m, 4))
    with pytest.raises(ValueError, match="one mesh"):
        Engine(path, max_seq=64, device="cpu", sharding_fn=gemma_sharding_fn(m),
               cache_sharding=kv_cache_sharding(cpu_mesh(2), 4))
    with pytest.raises(ValueError, match="gemma_sharding_fn"):
        Engine(path, max_seq=64, device="cpu", sharding_fn=lambda *a: None)
    with pytest.raises(ValueError, match=r"\[B, S, Hkv, d\]"):
        BatchedServer(path, max_seq=64, max_batch=4, mode="serve-q8", device="cpu",
                      cache_sharding=kv_cache_sharding(m, 4))
    # a mesh across processes (rank 1 another process's): the server runs in one
    spread = dataclasses.replace(m, processes=np.array([[0, 1], [0, 1]]), groups=(None, None))
    with pytest.raises(ValueError, match="one process"):
        BatchedServer(path, max_seq=64, max_batch=4, mode="serve-q8", device="cpu",
                      sharding_fn=gemma_sharding_fn(spread))
    # no whole step under sharding_fn: the kernel routes stay off
    srv = BatchedServer(path, max_seq=64, max_batch=4, mode="serve-q8", device="cpu",
                        sharding_fn=gemma_sharding_fn(m))
    assert not srv.use_kernel and isinstance(srv._caches, BatchedKVCache)
    assert np.array_equal(np.asarray(srv._caches.k.shape[1:4]), [4, 64, 4])
