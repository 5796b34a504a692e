"""The port's group prefill on the CPU against llm_inference_tpu's vmapped one.

The JAX server admits a same-bucket group of two or more in one vmapped
prefill (serving.py:179-193, :483-540); the port runs one pass over the
group's G x bucket rows (models/gemma.py ``forward_prefill_group``) and
``BatchedServer._admit`` sends every serve-mode group there, one of one too.
Same seeded tokens ([3, 32], ragged prompt lengths 5, 32 and 17) through
both packages, over the Gemma-3 fixture, gemma4 (shared KV, per-layer
inputs), per-layer head dims (tests/test_torch_head_dims.py's checkpoint)
and real sliding windows (LLMI_SWA_MASK=1), in serve, serve-q, serve-q4 and
serve-q8, each on the server's own weights. Bars:

  - against JAX's ``jax.vmap`` of ``forward`` (``mm_impl="xla"``,
    ``exact=False``): each member's logits within the suite's 1.5e-2 *
    max(1, max|logits|) with equal argmax, and the K/V rows [0, n_valid) of
    every KV layer within the same bar (measured up to 1.2e-2). The
    per-layer head dims fixture's bar is 3e-2: on its 32-token member the
    port's lone ``forward`` itself sits 2.3e-2 of max|logits| from JAX's
    lone ``forward`` in serve-q8 (measured; rounding flips compound over
    its six random layers, which tests/test_torch_head_dims.py holds op by
    op at 1e-4), and the group pass 2.5e-2 from the vmapped one;
  - against the port's own lone ``forward``, member by member: equal
    argmax, logits within 1e-5 of max|logits| (measured 1.6e-7) and the
    K/V rows [0, n_valid) within 1e-5 of max|rows| (measured 0: bit-equal);
    a group of one equal to the lone ``forward`` bit for bit;
  - one group admission calls the matmul dispatch as often as one lone
    prefill, for G = 2, 3 and 4, in every serve mode, dense, paged, and
    sharded (one pass a data row the group spans); a parity group
    prefills member by member; a request alone is a group pass
    of one; a failing group pass fails the admission with no
    member-by-member fallback.

The servers' streams against the JAX server's are
tests/test_torch_group_prefill_serving.py's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llm_inference_tpu.models import forward as jax_forward
from llm_inference_tpu.models import init_cache as jax_init_cache
from llm_inference_tpu.serving import BatchedServer as JServer
from llm_inference_tpu_torch import serving
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.parallel import batched_kv_cache_sharding, gemma_sharding_fn
from llm_inference_tpu_torch.serving import BatchedServer

from fixtures import build_gemma3_gguf, build_gemma4_gguf
from test_torch_head_dims import build_head_dims_gguf
from test_torch_sharding import cpu_mesh
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

VOCAB = [f"t{i}" for i in range(256)]
VOCAB[1], VOCAB[2], VOCAB[3] = "<eos>", "<bos>", "<unk>"
WIDE = dict(n_layers=3, n_embd=256, n_ff=512, n_head=4, n_head_kv=2, head_dim=128, vocab=VOCAB,
            weight_std=0.15)
MODES = ["serve", "serve-q", "serve-q4", "serve-q8"]
FIXTURES = ["gemma3", "gemma4", "head_dims", "swa"]
N_VALIDS = [5, 32, 17]
BUCKET = 32
BAR = 1.5e-2
JAX_BAR = {"head_dims": 3e-2}  # the module's notes


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("group")
    bufs = {
        "gemma3": build_gemma3_gguf(**WIDE),
        "gemma4": build_gemma4_gguf(n_layers=4, n_embd=128, n_ff=256, n_head=4, n_head_kv=2,
                                    n_embd_per_layer=32, shared_kv_layers=1, vocab=VOCAB),
        "head_dims": build_head_dims_gguf("gemma4"),
        "swa": build_gemma3_gguf(sliding_window=4, swa_pattern=[True, False, True], **WIDE),
    }
    out = {}
    for name, buf in bufs.items():
        (d / f"{name}.gguf").write_bytes(buf)
        out[name] = str(d / f"{name}.gguf")
    return out


def _tokens() -> np.ndarray:
    """[3, BUCKET] prompts of N_VALIDS tokens ([2] then seeded ids), zero-padded."""
    rng = np.random.default_rng(21)
    toks = np.zeros((len(N_VALIDS), BUCKET), np.int64)
    for g, n in enumerate(N_VALIDS):
        toks[g, :n] = np.concatenate([[2], rng.integers(4, len(VOCAB), n - 1)])
    return toks


def _group(paths, name, mode, monkeypatch):
    """The server's hparams and weights, and its group pass over _tokens()."""
    if name == "swa":
        monkeypatch.setenv("LLMI_SWA_MASK", "1")
    srv = BatchedServer(paths[name], mode=mode, max_seq=64, max_batch=4, device="cpu")
    logits, scratch = gemma.forward_prefill_group(srv.hparams, srv.weights,
                                                  torch.from_numpy(_tokens()), N_VALIDS)
    assert logits.shape == (len(N_VALIDS), len(VOCAB)) and logits.dtype == torch.float32
    assert scratch.k[0].shape[:2] == (len(N_VALIDS), BUCKET)  # [G, max(bucket, 16), Hkv, d]
    return srv.hparams, srv.weights, logits, scratch


def _rows_err(got, ref) -> float:
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", FIXTURES)
def test_group_pass_matches_jax_vmap(paths, name, mode, monkeypatch):
    hp, _, logits, scratch = _group(paths, name, mode, monkeypatch)
    jsrv = JServer(paths[name], mode=mode, max_seq=64, max_batch=4)
    jhp, jw = jsrv.hparams, jsrv.weights

    def one(toks, nv):
        cache = jax_init_cache(jhp, BUCKET, dtype=jnp.bfloat16)
        return jax_forward(jhp, jw, cache, toks, 0, nv, exact=False, mm_impl="xla")

    jl, jc = jax.jit(jax.vmap(one))(jnp.asarray(_tokens(), jnp.int32),
                                    jnp.asarray(N_VALIDS, jnp.int32))
    jl = np.asarray(jl)
    for g in range(len(N_VALIDS)):
        assert _rows_err(logits[g].numpy(), jl[g]) <= JAX_BAR.get(name, BAR), g
    assert logits.argmax(-1).tolist() == jl.argmax(-1).tolist()
    assert len(scratch.k) == len(jc.k) == hp.n_kv_layers
    for mine, theirs in ((scratch.k, jc.k), (scratch.v, jc.v)):
        for i in range(hp.n_kv_layers):
            ref = np.asarray(theirs[i], np.float32)
            for g, n in enumerate(N_VALIDS):
                got = mine[i][g, :n].float().numpy()
                assert _rows_err(got, ref[g, :n].reshape(got.shape)) <= BAR, (i, g)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", FIXTURES)
def test_group_pass_matches_lone_forward(paths, name, mode, monkeypatch):
    hp, w, logits, scratch = _group(paths, name, mode, monkeypatch)
    toks = torch.from_numpy(_tokens())
    for g, n in enumerate(N_VALIDS):
        cache = gemma.init_cache(hp, BUCKET)
        lone, cache = gemma.forward(hp, w, cache, toks[g], 0, n, mm_impl="xla")
        one, alone = gemma.forward_prefill_group(hp, w, toks[g:g + 1], [n])
        assert torch.equal(one[0], lone)  # a group of one is the lone prefill, bit for bit
        assert all(torch.equal(alone.k[i][0, :n], cache.k[i][:n])
                   for i in range(hp.n_kv_layers))
        assert int(lone.argmax()) == int(logits[g].argmax())
        assert (lone - logits[g]).abs().max() <= 1e-5 * lone.abs().max()
        for mine, ref in ((scratch.k, cache.k), (scratch.v, cache.v)):
            for i in range(hp.n_kv_layers):
                want = ref[i][:n].float()
                assert (mine[i][g, :n].float() - want).abs().max() <= 1e-5 * want.abs().max()


# -- the server's admission ------------------------------------------------------------


def _counting(monkeypatch) -> dict:
    """Count every call of the forward's matmul dispatch (ops/linear.py
    ``matmul``, as models/gemma.py calls it), the group passes and the
    member-by-member (parity) prefills."""
    n = {"matmul": 0, "group": 0, "lone": 0}
    real_mm, real_group, real_lone = gemma._matmul, serving.forward_prefill_group, \
        BatchedServer._prefill

    def mm(*a, **k):
        n["matmul"] += 1
        return real_mm(*a, **k)

    def group(*a, **k):
        n["group"] += 1
        return real_group(*a, **k)

    def lone(*a, **k):
        n["lone"] += 1
        return real_lone(*a, **k)

    monkeypatch.setattr(gemma, "_matmul", mm)
    monkeypatch.setattr(serving, "forward_prefill_group", group)
    monkeypatch.setattr(BatchedServer, "_prefill", lone)
    return n


def _admit(srv, prompts, n: dict) -> dict:
    for key in n:
        n[key] = 0
    reqs = [srv.submit(p, 4) for p in prompts]
    srv._admit()
    assert all(r.slot >= 0 for r in reqs) and not srv._queue
    got = dict(n, rows=len({srv._row_of(r.slot) for r in reqs}))
    for slot in list(srv._active):
        srv._retire(slot)
    return got


PROMPTS = [[2, 7, 8], [2, 10, 11, 9, 4], [2, 12], [2, 5, 6, 30, 8, 7]]


@pytest.mark.parametrize("layout", ["dense", "paged", "tp", "dp_x_tp"])
@pytest.mark.parametrize("G", [2, 3, 4])
def test_group_admission_calls_matmul_as_one_lone_prefill(paths, layout, G, monkeypatch):
    """A serve-mode group of G same-bucket requests: one group pass (one a
    data row it spans: the DP x TP server's lanes 0-1 are row 0's, 2-3 row
    1's), as many matmul calls as one lone prefill (a pass), and no lone
    prefill; a request alone is a group pass of one, with the single-stream
    ``forward``'s matmul calls on unsharded weights."""
    monkeypatch.setenv("LLMI_PAGE", "16")
    n = _counting(monkeypatch)
    for mode in MODES:
        kw = {}
        if layout == "paged":
            kw = dict(kv_pages=8)
        elif layout != "dense":
            m = cpu_mesh(2, 2 if layout == "dp_x_tp" else 1)
            kw = dict(sharding_fn=gemma_sharding_fn(m),
                      cache_sharding=batched_kv_cache_sharding(m, 2))
        srv = BatchedServer(paths["gemma3"], mode=mode, max_seq=64, max_batch=4, decode_chunk=4,
                            device="cpu", **kw)
        alone = _admit(srv, PROMPTS[:1], n)
        assert alone["group"] == 1 and alone["lone"] == 0 and alone["matmul"] > 0
        if layout in ("dense", "paged"):
            n["matmul"] = 0
            hp, toks = srv.hparams, torch.tensor(PROMPTS[0])
            gemma.forward(hp, srv.weights, gemma.init_cache(hp, 16), toks, 0, len(toks),
                          mm_impl="xla")
            assert n["matmul"] == alone["matmul"], mode
        group = _admit(srv, PROMPTS[:G], n)
        rows = group["rows"]
        assert rows == 1 or layout == "dp_x_tp"
        assert group == {"matmul": rows * alone["matmul"], "group": rows, "lone": 0,
                         "rows": rows}, mode
    if layout == "dp_x_tp" and G > 2:
        assert rows == 2  # a group over both data rows


def test_parity_groups_and_failures_take_no_group_fallback(paths, monkeypatch):
    """A parity group prefills member by member (the JAX server's exact
    path); a serve-mode group pass that raises fails the admission and no
    member falls back to a lone prefill."""
    n = _counting(monkeypatch)
    srv = BatchedServer(paths["gemma3"], mode="parity", max_seq=64, max_batch=4, device="cpu")
    got = _admit(srv, PROMPTS[:3], n)
    assert (got["group"], got["lone"]) == (0, 3)

    def boom(*a, **k):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(serving, "forward_prefill_group", boom)
    srv = BatchedServer(paths["gemma3"], mode="serve-q8", max_seq=64, max_batch=4, device="cpu")
    for key in n:
        n[key] = 0
    srv.submit(PROMPTS[0], 4)
    srv.submit(PROMPTS[1], 4)
    with pytest.raises(RuntimeError, match="out of memory"):
        srv._admit()
    assert n["lone"] == 0 and not srv._active
