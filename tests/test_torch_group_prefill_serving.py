"""The port's BatchedServer with group admission against llm_inference_tpu's.

Every case admits at least one same-bucket group of two or more requests
in one ``forward_prefill_group`` pass (a spy counts the passes and their
sizes) and its streams must equal the JAX server's, which admits the same
group through its vmapped ``_prefill_group`` / ``_prefill_paged_group``
(serving.py:179-193, :483-540), token for token:

  - dense lanes and paged pools (LLMI_PAGE=16, and 64: a page wider than
    the bucket), plain and sliding-window rings (LLMI_SWA_MASK=1, prompts
    past the window);
  - greedy, and sampled (temperature 0.8, top_k 40, top_p 0.95, a fixed
    seed: each member's first id drawn under fold_in(fold_in(key, slot),
    n_prompt));
  - gemma4 (shared KV, per-layer inputs) and per-layer head dims, dense and
    paged;
  - a DP x TP server (data 2 x model 2 over CPU devices, the JAX side on
    conftest.py's virtual devices) whose one group spans both data rows,
    one pass a row.

The group pass itself against JAX's vmap and the port's lone forward, and
the matmul-call counts, are tests/test_torch_group_prefill.py's.
"""

import pytest

import llm_inference_tpu.serving as jserving
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.parallel import batched_kv_cache_sharding as jax_batched_sharding
from llm_inference_tpu.parallel import gemma_sharding_fn as jax_sharding_fn
from llm_inference_tpu.sampling import SamplingConfig as JSamplingConfig
from llm_inference_tpu_torch import serving
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.parallel import batched_kv_cache_sharding, gemma_sharding_fn
from llm_inference_tpu_torch.sampling import SamplingConfig
from llm_inference_tpu_torch.serving import BatchedServer

from fixtures import build_gemma3_gguf, build_gemma4_gguf
from test_torch_head_dims import build_head_dims_gguf
from test_torch_sharding import cpu_mesh, jax_mesh
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

VOCAB = [f"t{i}" for i in range(256)]
VOCAB[1], VOCAB[2], VOCAB[3] = "<eos>", "<bos>", "<unk>"
WIDE = dict(n_layers=3, n_embd=256, n_ff=512, n_head=4, n_head_kv=2, head_dim=128, vocab=VOCAB,
            weight_std=0.15)
CFG = (0.8, 40, 0.95)
SEED = 2021
# four same-bucket requests (one group on an idle server of four lanes),
# then a fifth that waits for a free lane
REQS = [([2, 7, 8], 7), ([2, 10, 11, 9, 4], 5), ([2, 12], 8), ([2, 5, 6, 30, 8, 7], 6),
        ([2, 9, 4], 5)]
# past the swa fixture's 4-token window: rings hold only each member's live blocks
LONG = [([2, 7, 8, 9, 4, 5, 6, 3, 8, 7, 2] * 2, 6), ([2, 12, 9, 4, 5], 7),
        ([2, 5, 6, 30, 8, 7, 9, 11, 4, 13, 12, 10, 8, 6, 4, 2, 3, 9], 5)]
CASES = {  # name: (checkpoint, mode, kv_pages, sampled, requests, swa)
    "dense": ("gemma3", "serve-q8", None, False, REQS, False),
    "dense_serve_q4": ("gemma3", "serve-q4", None, False, REQS, False),
    "paged": ("gemma3", "serve-q8", 12, False, REQS, False),
    "rings": ("swa", "serve-q8", 12, False, LONG, True),
    "dense_sampled": ("gemma3", "serve", None, True, REQS, False),
    "paged_sampled": ("gemma3", "serve-q8", 12, True, REQS, False),
    "gemma4_dense": ("gemma4", "serve-q8", None, False, REQS, False),
    "gemma4_paged": ("gemma4", "serve-q", 12, False, REQS, False),
    "head_dims_dense": ("head_dims", "serve-q8", None, False, REQS, False),
    "head_dims_paged": ("head_dims", "serve", 12, False, REQS, True),
    "paged_page64": ("gemma3", "serve-q8", 12, False, REQS, False),
    "rings_page64": ("swa", "serve-q8", 12, False, LONG, True),
}
# a page wider than the 32-token bucket: each member's scratch is one
# partial block, rows [0, bucket) of it copied (LLMI_PAGE=16 elsewhere)
PAGE = {"paged_page64": 64, "rings_page64": 64}
SERVER = dict(max_seq=64, max_batch=4, decode_chunk=4)


@pytest.fixture(scope="module")
def bufs():
    return {
        "gemma3": build_gemma3_gguf(**WIDE),
        "swa": build_gemma3_gguf(sliding_window=4, swa_pattern=[True, False, True], **WIDE),
        "gemma4": build_gemma4_gguf(n_layers=4, n_embd=128, n_ff=256, n_head=4, n_head_kv=2,
                                    n_embd_per_layer=32, shared_kv_layers=1, vocab=VOCAB,
                                    seed=5),
        "head_dims": build_head_dims_gguf("gemma4"),
        # tests/test_torch_sharding_serving.py's DP x TP geometry
        "dp": build_gemma3_gguf(n_layers=2, n_embd=128, n_ff=256, n_head=4, n_head_kv=4,
                                vocab=VOCAB, seed=3, weight_std=0.2),
    }


def _no_stop(x):
    x.tokenizer.eos_id = -1
    x.tokenizer.end_of_turn_id = -1
    return x


def _spy(monkeypatch) -> list:
    """The sizes of the group passes the port's server runs."""
    sizes = []
    real = serving.forward_prefill_group

    def group(hp, w, tokens, *a, **k):
        sizes.append(tokens.shape[0])
        return real(hp, w, tokens, *a, **k)

    monkeypatch.setattr(serving, "forward_prefill_group", group)
    return sizes


@pytest.mark.parametrize("case", list(CASES))
def test_group_admission_streams_match_jax_server(bufs, case, monkeypatch):
    name, mode, pages, sampled, reqs, swa = CASES[case]
    if swa:
        monkeypatch.setenv("LLMI_SWA_MASK", "1")
    monkeypatch.setenv("LLMI_PAGE", str(PAGE.get(case, 16)))
    monkeypatch.setattr(jserving, "PAGE", PAGE.get(case, 16))
    kw = dict(SERVER, mode=mode, kv_pages=pages)
    jkw, pkw = dict(kw), dict(kw)
    if sampled:
        jkw.update(sampling=JSamplingConfig(*CFG), seed=SEED)
        pkw.update(sampling=SamplingConfig(*CFG), seed=SEED)
    want = _no_stop(jserving.BatchedServer(JGGUFFile(bufs[name]), **jkw)).run(reqs)
    sizes = _spy(monkeypatch)
    srv = _no_stop(BatchedServer(GGUFFile(bufs[name]), device="cpu", **pkw))
    assert srv.decode_route.startswith("paged-" if pages else "")
    assert bool(srv._rings if pages else False) == case.startswith("rings")
    assert srv.run(reqs) == want
    assert sizes and max(sizes) >= 2  # a group pass ran
    assert any(len(set(o)) > 1 for o in want)  # streams that move
    if pages:
        assert sorted(srv._free_pages) == list(range(pages)) and (srv._table == pages).all()


def test_group_spanning_two_data_rows_matches_jax_server(bufs, monkeypatch):
    """DP x TP (data 2 x model 2): the idle server's four lanes split two a
    data row, so its one group of four takes one pass on each row, each
    rank's lanes its KV heads, and the fifth request a pass of one on the
    row of the lane it finds free; the streams equal the JAX server's and
    the port's unsharded server's."""
    sizes = _spy(monkeypatch)
    m, jm = cpu_mesh(2, 2), jax_mesh(2, 2)
    kw = dict(SERVER, mode="serve-q8")
    single = _no_stop(BatchedServer(GGUFFile(bufs["dp"]), device="cpu", **kw)).run(REQS)
    assert sizes == [4, 1]
    sizes.clear()
    srv = _no_stop(BatchedServer(GGUFFile(bufs["dp"]), device="cpu",
                                 sharding_fn=gemma_sharding_fn(m),
                                 cache_sharding=batched_kv_cache_sharding(m, 4), **kw))
    got = srv.run(REQS)
    assert srv.decode_route == "sharded" and sizes == [2, 2, 1]
    want = _no_stop(jserving.BatchedServer(JGGUFFile(bufs["dp"]),
                                           sharding_fn=jax_sharding_fn(jm),
                                           cache_sharding=jax_batched_sharding(jm, 4),
                                           **kw)).run(REQS)
    assert got == want == single
    assert any(len(set(o)) > 1 for o in got)
