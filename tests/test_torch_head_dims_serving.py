"""Per-layer head dims: the servers, parity taps and CLI on the CPU against llm_inference_tpu.

The checkpoints are tests/test_torch_head_dims.py's (``build_head_dims_gguf``:
global heads of 64, sliding heads of 32; gemma4 with shared-KV layers and
Gemma-3). Bars, with LLMI_SWA_MASK unset and =1: identical greedy streams
of ``BatchedServer`` with dense lanes and paged pools (under
LLMI_SWA_MASK=1 the Gemma-3 pools of sliding layers are rings of their own
width) against the JAX server's, and the dense lanes' equal to the
single-stream Engine's; the parity forward's taps at each layer's width
against the JAX parity forward's, and the CLI's ``--trace``. The Engine's
streams in five modes are in tests/test_torch_head_dims.py (two files, so
that two test workers share the time).
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import llm_inference_tpu.models.gemma as jgemma
import llm_inference_tpu.serving as jserving
from llm_inference_tpu import trace as jtrace
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.models import load_weights as jax_load_weights
from llm_inference_tpu_torch import cli, trace
from llm_inference_tpu_torch.engine import Engine
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.models.weights import load_weights
from llm_inference_tpu_torch.ops.kernels import flash_decode, kv_insert
from llm_inference_tpu_torch.serving import BatchedServer

from test_torch_gemma4 import _no_stop
from test_torch_head_dims import PAGE, PREFILL, REQS, SERVER, _swa
from test_torch_head_dims import paths  # noqa: F401  (a fixture: the checkpoints)
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

@pytest.mark.parametrize("arch,paged,swa", [
    ("gemma4", False, False), ("gemma4", True, False), ("gemma4", False, True),
    ("gemma4", True, True),
    ("gemma3", True, True),  # the sliding-window rings: every Gemma-3 layer owns its K/V
])
def test_server_streams_match_jax_server(paths, arch, paged, swa, monkeypatch):
    """Dense and paged ``BatchedServer`` (serve-q8, the per-op routes): four
    requests over three slots against the JAX server; one ``insert_kv_rows``
    a KV layer and step at the layer's width (the kernels' plain twins on
    the CPU); under LLMI_SWA_MASK=1 the Gemma-3 server's sliding layers are
    rings of their own width. The dense server's streams also equal the
    single-stream Engine's."""
    _swa(monkeypatch, swa)
    appends = []
    real_append = kv_insert.insert_kv_rows_plain
    monkeypatch.setattr(kv_insert, "insert_kv_rows_plain",
                        lambda *a: appends.append((a[0].shape[-1], a[1].shape[-1]))
                        or real_append(*a))
    kw = dict(SERVER, mode="serve-q8")
    if paged:
        kw["kv_pages"] = 8
        monkeypatch.setattr(jserving, "PAGE", PAGE)
        monkeypatch.setenv("LLMI_PAGE", str(PAGE))
    jsrv = jserving.BatchedServer(paths[arch], **kw)
    jsrv.tokenizer.eos_id = jsrv.tokenizer.end_of_turn_id = -1
    want = jsrv.run(REQS)
    counts = (kv_insert.launches, flash_decode.launches, flash_decode.paged_launches)
    srv = BatchedServer(paths[arch], device="cpu", **kw)
    srv.tokenizer.eos_id = srv.tokenizer.end_of_turn_id = -1
    assert srv.decode_route == ("paged-per-op" if paged else "per-op")
    if paged:
        assert bool(srv._rings) == (swa and arch == "gemma3")
        ring = {i: srv._caches.k[i].shape[0] for i in srv._rings}
        assert all(r == SERVER["max_batch"] * srv._rings[i] for i, r in ring.items())
    assert srv.run(REQS) == want
    assert (kv_insert.launches, flash_decode.launches, flash_decode.paged_launches) == counts
    hp = srv.hparams
    steps = srv.stats.decode_steps
    assert appends == [gemma.head_dims(hp, i) for i in range(hp.n_kv_layers)] * steps
    if not paged:
        eng = _no_stop(Engine(paths[arch], max_seq=64, mode="serve-q8", decode_chunk=4,
                              device="cpu"))
        assert [eng.generate_from_ids(p, n_predict=n) for p, n in REQS] == want


def test_parity_taps_and_cli_trace(paths, tmp_path, capsys):
    """The parity forward's taps carry each layer's widths and match the JAX
    parity forward's (jitted, its taps through debug callbacks) by name,
    shape and sum; the CLI runs the checkpoint and its ``--trace`` writes
    those taps."""
    from llm_inference_tpu_torch import parity
    from llm_inference_tpu import parity as jparity

    path = paths["gemma4"]
    toks = PREFILL[:5]
    jhp, jw = jax_load_weights(JGGUFFile(path))
    session = jtrace.enable_trace("unused.npz")
    try:
        jax.jit(partial(jgemma.forward, jhp))(jw, jgemma.init_cache(jhp, 16),
                                              jnp.asarray(toks, dtype=jnp.int32), 0)
    finally:
        jtrace.disable_trace()
    jrecs = session.records
    hp, w = load_weights(GGUFFile(path), mode="packed")
    mine = trace.enable_trace("unused.npz")
    try:
        gemma.forward(hp, w, gemma.init_cache(hp, 16, dtype=gemma.PARITY_KV_DTYPE),
                      torch.tensor(toks), 0, exact=True)
    finally:
        trace.disable_trace()
    recs = mine.records
    jtaps = dict(jrecs)  # jit's callbacks come in no fixed order: match by name
    assert len(jtaps) == len(jrecs) == len(recs) and {n for n, _ in recs} == set(jtaps)
    assert all(v.shape == jtaps[n].shape for n, v in recs)
    taps = dict(recs)
    assert taps["Qcur-0"].shape[-1] == hp.n_head * 32 and taps["Qcur-3"].shape[-1] == hp.n_head * 64
    ref = [jparity.DumpRecord(n, v.shape, float(np.sum(jtaps[n], dtype=np.float64)), [])
           for n, v in recs]
    assert parity.compare_sums(ref, recs, rel_tol=1e-3) == []
    out = tmp_path / "trace.npz"
    rc = cli.main(["-m", path, "-p", "ab", "-n", "2", "--no-cnv", "--max-seq", "64",
                   "--device", "cpu", "--trace", str(out)])
    assert rc == 0 and trace.current() is None
    assert "activation trace written to" in capsys.readouterr().err
    with np.load(out) as z:
        q = {k.split("|", 1)[1]: z[k].shape for k in z.keys()}
        assert all(np.isfinite(z[k]).all() for k in z.keys())
    assert q["Qcur-4"][-1] == hp.n_head * 32 and q["Qcur-5"][-1] == hp.n_head * 64
