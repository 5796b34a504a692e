"""gemma4's Engine and BatchedServer through the port on the CPU against llm_inference_tpu.

The checkpoints and helpers are tests/test_torch_gemma4.py's (its
``paths``: one and two shared-KV layers, and sliding windows). Bars:
identical greedy streams of the ``Engine`` in serve-q8 (both routes),
serve-q and serve-q4, and of ``BatchedServer`` dense and paged (owner
layers only in the caches and pools), against the JAX package's; the
prefill's projection count and the CLI on a gemma4 checkpoint.
"""

import pytest

import llm_inference_tpu.serving as jserving
from llm_inference_tpu.engine import Engine as JEngine
from llm_inference_tpu_torch import cli
from llm_inference_tpu_torch.engine import Engine
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.models.weights import LayerWeights
from llm_inference_tpu_torch.ops.kernels import flash_decode, fused_decode, kv_insert
from llm_inference_tpu_torch.serving import BatchedServer

from test_torch_gemma4 import MODES, PAGE, REQS, SERVER, _no_stop
from test_torch_gemma4 import paths  # noqa: F401  (a fixture: the checkpoints)
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)


@pytest.mark.parametrize("mode,route", [("serve-q8", "kernel"), ("serve-q8", "per-op"),
                                        ("serve-q", "per-op"), ("serve-q4", "per-op")])
@pytest.mark.parametrize("name", ["shared1", "shared2"])
def test_engine_stream_matches_jax_engine(paths, name, mode, route, monkeypatch):
    if route == "per-op" and mode == "serve-q8":
        monkeypatch.setenv("LLMI_NO_FUSED_DECODE", "1")
    prompt = [2, 40, 41, 42, 43]
    ref = _no_stop(JEngine(paths[name], max_seq=64, mode=mode, decode_chunk=4))
    want = ref.generate_from_ids(prompt, n_predict=9)
    eng = _no_stop(Engine(paths[name], max_seq=64, mode=mode, decode_chunk=4, device="cpu"))
    assert eng.decode_route == route
    assert isinstance(eng.weights.layers, LayerWeights) == (route == "kernel")
    launches = fused_decode.launches
    assert eng.generate_from_ids(prompt, n_predict=9) == want
    assert fused_decode.launches == launches  # the CPU runs the plain twins


@pytest.mark.parametrize("swa", [False, True])
def test_engine_stream_with_windows(paths, swa, monkeypatch):
    if swa:
        monkeypatch.setenv("LLMI_SWA_MASK", "1")
    prompt = [2, 7, 8, 9, 4, 5, 6, 30, 8, 7, 2, 9]
    ref = _no_stop(JEngine(paths["window"], max_seq=64, mode="serve-q8", decode_chunk=4))
    eng = _no_stop(Engine(paths["window"], max_seq=64, mode="serve-q8", decode_chunk=4,
                          device="cpu"))
    assert eng.decode_route == "kernel"
    assert eng.generate_from_ids(prompt, n_predict=8) == ref.generate_from_ids(prompt, n_predict=8)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("paged", [False, True])
def test_server_streams_match_jax_server(paths, mode, paged, monkeypatch):
    """Dense and paged ``BatchedServer`` on the per-op route, owner layers
    only in the caches and pools (plain pools, no rings), against the JAX
    server; four requests over three slots (slot reuse). Each decode step
    appends K/V once for each owner layer (one ``insert_kv_rows`` call for
    both pools) and never for a shared-KV layer."""
    appends = []
    real_append = kv_insert.insert_kv_rows_plain
    monkeypatch.setattr(kv_insert, "insert_kv_rows_plain",
                        lambda *a: appends.append(a[0].shape) or real_append(*a))
    kw = dict(SERVER, mode=mode)
    if paged:
        kw["kv_pages"] = 8
        monkeypatch.setattr(jserving, "PAGE", PAGE)
        monkeypatch.setenv("LLMI_PAGE", str(PAGE))
    want = jserving.BatchedServer(paths["shared2"], **kw).run(REQS)
    counts = (kv_insert.launches, flash_decode.launches)
    srv = BatchedServer(paths["shared2"], device="cpu", **kw)
    assert srv.decode_route == ("paged-per-op" if paged else "per-op")
    hp = srv.hparams
    if paged:
        assert srv._caches.k_all is not None and srv._caches.k_all.shape[0] == hp.n_kv_layers
    else:
        assert srv._caches.k.shape[0] == hp.n_kv_layers
    assert srv.run(REQS) == want
    assert (kv_insert.launches, flash_decode.launches) == counts  # plain twins on the CPU
    assert len(appends) == hp.n_kv_layers * srv.stats.decode_steps > 0


def test_server_matches_engine_with_windows(paths, monkeypatch):
    """Under LLMI_SWA_MASK=1 the shared-KV server keeps plain pools (no
    rings) and gives each request its single-stream Engine stream."""
    monkeypatch.setenv("LLMI_SWA_MASK", "1")
    monkeypatch.setenv("LLMI_PAGE", str(PAGE))
    reqs = [([2, 7, 8, 9, 4, 5, 6, 30, 8, 7, 2, 9], 8), ([2, 9], 5)]
    eng = _no_stop(Engine(paths["window"], max_seq=64, mode="serve-q8", decode_chunk=4,
                          device="cpu"))
    want = [eng.generate_from_ids(p, n_predict=n) for p, n in reqs]
    for kv_pages in (None, 8):
        srv = BatchedServer(paths["window"], mode="serve-q8", device="cpu", kv_pages=kv_pages,
                            **SERVER)
        srv.tokenizer.eos_id = srv.tokenizer.end_of_turn_id = -1
        if kv_pages:
            assert srv._rings == {} and srv._caches.k_all is not None
        assert srv.run(reqs) == want


def test_prefill_launch_count_and_cli(paths, capsys):
    """The gemma4 prefill's projections: 6 a layer (QKV or a shared layer's
    Q, Wo, gate/up, down, per-layer gate, per-layer proj) and the per-layer
    model projection, on one weight copy (counted through the per-op
    dispatch's CPU leg); and a gemma4 checkpoint runs through the CLI."""
    eng = Engine(paths["shared2"], max_seq=64, mode="serve-q8", decode_chunk=4, device="cpu")
    seen = []
    real = gemma._matmul
    gemma._matmul = lambda w, x, **kw: seen.append(w.rows) or real(w, x, **kw)
    try:
        eng.generate_from_ids([2, 7, 8], n_predict=1)
    finally:
        gemma._matmul = real
    hp = eng.hparams
    assert len(seen) == 6 * hp.block_count + 2  # + the model projection and the logits
    rq = hp.n_head * hp.n_embd_head_k
    rqkv = rq + hp.n_head_kv * (hp.n_embd_head_k + hp.n_embd_head_v)
    # each layer's first projection: QKV, or a shared layer's Q rows alone
    assert [seen[1 + 6 * i] for i in range(hp.block_count)] == (
        [rqkv] * hp.n_kv_layers + [rq] * (hp.block_count - hp.n_kv_layers))
    rc = cli.main(["-m", paths["shared1"], "-p", "ab", "-n", "4", "--no-cnv", "--max-seq", "64",
                   "--device", "cpu", "-v"])
    assert rc == 0
    cap = capsys.readouterr()
    assert "arch=gemma4" in cap.err and "tok/s decode" in cap.out
