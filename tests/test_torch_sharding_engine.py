"""The port's sharded ``Engine`` on the CPU against llm_inference_tpu.

The JAX engine runs its GSPMD path on conftest.py's 8 virtual CPU devices,
the port's its ranks op by op over meshes of repeated CPU devices
(tests/test_torch_sharding.py holds the layouts, shards and logits,
tests/test_torch_sharding_serving.py the servers). Bars: greedy streams
equal token for token to the JAX engine's sharded streams and to the
port's single-device streams, for the ``Engine`` in all five modes at n =
2 and 8 ranks (weights and KV heads sharded), gemma4 in serve-q8, one
sampled stream (temperature 0.8, top-k 40), and ``sharding_fn`` or
``cache_sharding`` alone; ``decode_route`` "sharded", the weights and the
cache split as the module says.
"""

import pytest

from llm_inference_tpu.engine import Engine as JEngine
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.parallel import gemma_sharding_fn as jax_sharding_fn
from llm_inference_tpu.parallel import kv_cache_sharding as jax_kv_sharding
from llm_inference_tpu.sampling import SamplingConfig as JSamplingConfig
from llm_inference_tpu_torch.engine import Engine
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.models.gemma import ShardedKVCache
from llm_inference_tpu_torch.parallel import gemma_sharding_fn, kv_cache_sharding
from llm_inference_tpu_torch.quant.device import ShardedTensor
from llm_inference_tpu_torch.sampling import SamplingConfig

from fixtures import build_gemma3_gguf, build_gemma4_gguf
from test_torch_sharding import VOCAB, cpu_mesh, jax_mesh
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

MODES = ("serve", "serve-q8", "serve-q", "serve-q4", "parity")
PROMPT, N_PREDICT = [2, 70, 300, 8], 10


@pytest.fixture(scope="module")
def bufs():
    return {
        # the test_parallel.py geometry with a 512-token vocabulary (so the
        # embedding shards too) and weights whose greedy streams wander
        "wide": build_gemma3_gguf(n_layers=2, n_embd=256, n_ff=512, n_head=8, n_head_kv=8,
                                  vocab=VOCAB, seed=3, weight_std=0.2),
        "gemma4": build_gemma4_gguf(n_layers=4, n_embd=256, n_ff=512, n_head=4, n_head_kv=2,
                                    n_embd_per_layer=128, shared_kv_layers=1),
    }


def _no_stop(x):
    x.tokenizer.eos_id = -1
    x.tokenizer.end_of_turn_id = -1
    return x


def _engines(buf, mode, n, prompt=PROMPT, **kw):
    """(port single, port sharded, JAX sharded) streams of ``prompt``."""
    single = _no_stop(Engine(GGUFFile(buf), max_seq=64, mode=mode, decode_chunk=4, device="cpu",
                             **kw))
    m, jm = cpu_mesh(n), jax_mesh(n)
    hkv = single.hparams.n_head_kv
    sharded = _no_stop(Engine(GGUFFile(buf), max_seq=64, mode=mode, decode_chunk=4, device="cpu",
                              sharding_fn=gemma_sharding_fn(m),
                              cache_sharding=kv_cache_sharding(m, hkv), **kw))
    jkw = {k: JSamplingConfig(**vars(v)) if k == "sampling" else v for k, v in kw.items()}
    jeng = _no_stop(JEngine(JGGUFFile(buf), max_seq=64, mode=mode, decode_chunk=4,
                            sharding_fn=jax_sharding_fn(jm),
                            cache_sharding=jax_kv_sharding(jm, hkv), **jkw))
    return ([e.generate_from_ids(prompt, n_predict=N_PREDICT) for e in (single, sharded, jeng)],
            sharded)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [2, 8])
def test_engine_streams_match(bufs, mode, n):
    (single, got, want), eng = _engines(bufs["wide"], mode, n)
    assert got == want == single
    assert len(set(got)) > 3  # a stream that wanders
    assert eng.decode_route == "sharded"
    assert isinstance(eng.weights.token_embd, ShardedTensor)
    lw = eng.weights.layers[0]
    qkv = lw.wq if lw.wqkv is None else lw.wqkv
    assert isinstance(qkv, ShardedTensor) and qkv.n == n and lw.w_down.dim == 1
    cache = eng.new_cache()
    assert isinstance(cache, ShardedKVCache) and len(cache.shards) == n


def test_gemma4_engine_stream_matches(bufs):
    (single, got, want), eng = _engines(bufs["gemma4"], "serve-q8", 2, prompt=[2, 7, 8])
    assert got == want == single
    assert eng.decode_route == "sharded"
    assert isinstance(eng.weights.layers[0].per_layer_inp_gate, ShardedTensor)


def test_sampled_engine_stream_matches(bufs):
    (single, got, want), _ = _engines(bufs["wide"], "serve-q8", 2,
                                      sampling=SamplingConfig(temperature=0.8, top_k=40), seed=7)
    assert got == want == single
    greedy = _engines(bufs["wide"], "serve-q8", 2)[0][0]
    assert got != greedy


@pytest.mark.parametrize("which", ["sharding_fn", "cache_sharding"])
def test_engine_one_sharding_alone(bufs, which):
    m = cpu_mesh(4)
    single = _no_stop(Engine(GGUFFile(bufs["wide"]), max_seq=64, mode="serve-q8", decode_chunk=4,
                             device="cpu"))
    kw = (dict(sharding_fn=gemma_sharding_fn(m)) if which == "sharding_fn"
          else dict(cache_sharding=kv_cache_sharding(m, 8)))
    eng = _no_stop(Engine(GGUFFile(bufs["wide"]), max_seq=64, mode="serve-q8", decode_chunk=4,
                          device="cpu", **kw))
    assert eng.decode_route == "sharded"
    assert isinstance(eng.new_cache(), ShardedKVCache) == (which == "cache_sharding")
    assert isinstance(eng.weights.layers[0].wqkv, ShardedTensor) == (which == "sharding_fn")
    assert eng.generate_from_ids(PROMPT, n_predict=N_PREDICT) == single.generate_from_ids(
        PROMPT, n_predict=N_PREDICT)
