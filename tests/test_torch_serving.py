"""The port's BatchedServer on the CPU against llm_inference_tpu's.

Bars: greedy streams identical to the JAX ``BatchedServer`` and ``Engine``
(mode serve-q8) on the same checkpoint, on both decode routes; the
scheduling cases of tests/test_serving.py (batched vs single stream, more
requests than slots, slot reuse, grouped vs serial admission, rejected
requests and modes). On the CPU every kernel runs its plain twin, through
the same dispatch as on the card; the route is chosen by the JAX server's
rule."""

import pytest
import torch

from llm_inference_tpu.engine import Engine as JEngine
from llm_inference_tpu.serving import BatchedServer as JBatchedServer
from llm_inference_tpu_torch.ops.kernels import flash_decode, fused_decode_batch, kv_insert
from llm_inference_tpu_torch.sampling import SamplingConfig, pick_batch
from llm_inference_tpu_torch.serving import BatchedServer

from fixtures import build_gemma3_gguf
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

VOCAB = [f"t{i}" for i in range(256)]
VOCAB[1], VOCAB[2], VOCAB[3] = "<eos>", "<bos>", "<unk>"
WIDE = dict(n_layers=3, n_embd=256, n_ff=512, n_head=4, n_head_kv=2, head_dim=128, vocab=VOCAB,
            weight_std=0.15)  # streams that wander over the vocabulary
PROMPTS = [[2, 7, 8], [2, 10, 11, 9], [2, 12]]
N_PREDICT = [6, 5, 7]
MORE = [([2, 7, 8], 9), ([2, 9], 3), ([2, 5, 6], 6), ([2, 11], 8), ([2, 4, 13, 7], 5)]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    out = {}
    for name, buf in {
        "wide": build_gemma3_gguf(**WIDE),
        "swa": build_gemma3_gguf(sliding_window=4, swa_pattern=[True, False, True], **WIDE),
        "tiny": build_gemma3_gguf(n_layers=2, seed=99),  # head_dim 16: no kernel route
    }.items():
        (d / f"{name}.gguf").write_bytes(buf)
        out[name] = str(d / f"{name}.gguf")
    return out


def _server(path, route=None, monkeypatch=None, **kw):
    args = dict(max_seq=64, max_batch=4, mode="serve-q8", decode_chunk=4, device="cpu")
    args.update(kw)
    if route == "per-op":
        monkeypatch.setenv("LLMI_NO_FUSED_DECODE", "1")
    srv = BatchedServer(path, **args)
    if monkeypatch is not None:
        monkeypatch.delenv("LLMI_NO_FUSED_DECODE", raising=False)
    if route is not None:
        assert srv.decode_route == route
    return srv


@pytest.fixture(scope="module")
def jax_streams(paths):
    """The JAX package's streams of the scheduling cases: its Engine one
    request at a time, its BatchedServer (per-op route on the CPU)."""
    eng = JEngine(paths["wide"], max_seq=64, mode="serve-q8", decode_chunk=4)
    single = [eng.generate_from_ids(p, n_predict=n) for p, n in zip(PROMPTS, N_PREDICT)]
    more_single = [eng.generate_from_ids(p, n_predict=n) for p, n in MORE]
    srv = JBatchedServer(paths["wide"], max_seq=64, max_batch=4, mode="serve-q8", decode_chunk=4)
    batched = srv.run(list(zip(PROMPTS, N_PREDICT)))
    srv2 = JBatchedServer(paths["wide"], max_seq=64, max_batch=2, mode="serve-q8",
                          decode_chunk=3)
    more = srv2.run(MORE)
    return {"single": single, "batched": batched, "more_single": more_single, "more": more}


@pytest.mark.parametrize("route", ["kernel", "per-op"])
def test_batched_matches_jax_server_and_engine(paths, jax_streams, route, monkeypatch):
    assert jax_streams["batched"] == jax_streams["single"]
    srv = _server(paths["wide"], route, monkeypatch)
    assert srv.run(list(zip(PROMPTS, N_PREDICT))) == jax_streams["single"]


@pytest.mark.parametrize("route", ["kernel", "per-op"])
def test_more_requests_than_slots(paths, jax_streams, route, monkeypatch):
    """Five requests through two slots of mismatched lengths: lanes park and
    re-admit across chunks."""
    assert jax_streams["more"] == jax_streams["more_single"]
    srv = _server(paths["wide"], route, monkeypatch, max_batch=2, decode_chunk=3)
    assert srv.run(MORE) == jax_streams["more_single"]


@pytest.mark.parametrize("route", ["kernel", "per-op"])
def test_slot_reuse_is_clean(paths, route, monkeypatch):
    srv = _server(paths["wide"], route, monkeypatch, max_batch=1)
    first = srv.run([([2, 7, 8], 5)])[0]
    second = srv.run([([2, 7, 8], 5)])[0]
    assert first == second and len(first) == 5


def test_grouped_admission_matches_serial(paths):
    reqs = [([2, 7, 8], 5), ([2, 10, 11], 5), ([2, 12], 5)]
    serial = _server(paths["wide"], max_admit_per_step=1).run(reqs)
    grouped = _server(paths["wide"], max_admit_per_step=4).run(reqs)
    assert grouped == serial


def test_routes_give_the_same_streams_and_take_their_kernels(paths, monkeypatch):
    """The kernel route calls the batched step once a decode step; the
    per-op route calls insert_kv_rows (K and V in one call) and flash_decode
    once a layer and step (max_seq 256: the flash route). On the CPU every call takes the
    plain twin: no kernel launches."""
    counts = {"step": 0, "insert": 0, "flash": 0}

    def spy(mod, name, key):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, **k: counts.__setitem__(key, counts[key] + 1)
                            or real(*a, **k))

    spy(fused_decode_batch, "decode_step_batch_plain", "step")
    spy(kv_insert, "insert_kv_rows_plain", "insert")
    spy(flash_decode, "flash_decode_plain", "flash")
    launches = (fused_decode_batch.launches, kv_insert.launches, flash_decode.launches)
    reqs = [([2, 7, 8], 9), ([2, 10, 11, 9], 6), ([2, 12], 7)]
    streams = {}
    for route in ("kernel", "per-op"):
        srv = _server(paths["wide"], route, monkeypatch, max_seq=256)
        for k in counts:
            counts[k] = 0
        streams[route] = srv.run(reqs)
        steps = srv.stats.decode_steps
        assert steps > 0 and steps % 4 == 0
        if route == "kernel":
            assert counts == {"step": steps, "insert": 0, "flash": 0}
        else:
            assert counts == {"step": 0, "insert": 3 * steps, "flash": 3 * steps}
    assert streams["kernel"] == streams["per-op"]
    assert (fused_decode_batch.launches, kv_insert.launches, flash_decode.launches) == launches


def test_route_rule(paths, monkeypatch):
    assert _server(paths["wide"]).decode_route == "kernel"
    assert _server(paths["tiny"]).decode_route == "per-op"  # ineligible widths
    assert _server(paths["swa"]).decode_route == "kernel"   # windows parsed, not applied
    monkeypatch.setenv("LLMI_SWA_MASK", "1")
    srv = _server(paths["swa"])
    assert srv.decode_route == "per-op"  # real sliding windows: the JAX server's rule
    prompt = [2, 7, 8, 9, 4, 5, 6]
    want = JEngine(paths["swa"], max_seq=64, mode="serve-q8",
                   decode_chunk=4).generate_from_ids(prompt, n_predict=8)
    assert srv.run([(prompt, 8)]) == [want]


def test_tiny_checkpoint_per_op_matches_jax_server(paths):
    reqs = [([2, 7, 8], 6), ([2, 12], 6)]
    want = JBatchedServer(paths["tiny"], max_seq=64, max_batch=2, mode="serve-q8",
                          decode_chunk=4).run(reqs)
    assert _server(paths["tiny"], max_batch=2).run(reqs) == want


def test_overlong_request_rejected(paths):
    srv = _server(paths["wide"], max_batch=1)
    with pytest.raises(ValueError, match="max_seq"):
        srv.submit([2] * 60, n_predict=10)
    with pytest.raises(ValueError, match="max_seq"):
        srv.submit([2] * 3, n_predict=64)
    with pytest.raises(ValueError, match="prompt ids"):
        srv.submit([2, 256], n_predict=4)


def test_modes_and_options(paths, monkeypatch):
    """What the server still refuses: sharding (paged or not). serve,
    parity (dense), serve-q, serve-q4 and kv_pages are served
    (tests/test_torch_serve.py, tests/test_torch_parity.py,
    tests/test_torch_paged.py), on the per-op route; so is stochastic
    sampling (tests/test_torch_sampling.py), dense and paged."""
    with pytest.raises(ValueError, match="supported"):
        _server(paths["wide"], mode="serve-q9")
    for mode in ("serve", "parity"):
        assert _server(paths["wide"], mode=mode).decode_route == "per-op"
    for kw in (dict(sharding_fn=lambda *a: None), dict(cache_sharding=object())):
        for paged in ({}, dict(kv_pages=8)):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                _server(paths["wide"], **kw, **paged)
    monkeypatch.setenv("LLMI_PAGE", "16")
    for paged, route in (({}, "per-op"), (dict(kv_pages=8), "paged-per-op")):
        assert _server(paths["wide"], sampling=SamplingConfig(temperature=0.7),
                       **paged).decode_route == route
    monkeypatch.delenv("LLMI_PAGE")
    for mode in ("serve-q", "serve-q4"):
        assert _server(paths["wide"], mode=mode).decode_route == "per-op"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedServer(paths["wide"], max_seq=64)


def test_stats_and_ttft(paths):
    srv = _server(paths["wide"])
    reqs = [srv.submit(p, n) for p, n in zip(PROMPTS, N_PREDICT)]
    while srv.step():
        pass
    assert [len(r.out) for r in reqs] == N_PREDICT and all(r.done for r in reqs)
    assert all(r.ttft_s > 0 for r in reqs)
    assert srv.stats.tokens_emitted == sum(N_PREDICT)
    assert srv.stats.prefill_seconds > 0 and srv.stats.decode_seconds > 0


def test_pick_batch_is_argmax_on_nan_and_ties():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0],
                           [1.0, float("nan"), 5.0, float("nan")],
                           [-1.0, -1.0, -2.0, -3.0]])
    ids = pick_batch(logits, SamplingConfig())
    assert ids.dtype == torch.int32
    assert ids.tolist() == [1, 1, 0]  # lowest id at the max; a NaN row gives a valid id
    assert ids.tolist() == torch.argmax(logits, dim=-1).tolist()
    assert all(0 <= i < logits.shape[1] for i in ids.tolist())
    with pytest.raises(ValueError, match="keys"):  # stochastic sampling draws under keys
        pick_batch(logits, SamplingConfig(temperature=1.0))
