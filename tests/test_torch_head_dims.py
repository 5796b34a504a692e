"""Per-layer head dims through the port on the CPU against llm_inference_tpu.

A checkpoint whose ``attention.key_length_swa`` / ``value_length_swa``
differ from ``key_length`` / ``value_length`` (Gemma 4's sliding heads are
narrower than its global ones). ``build_head_dims_gguf`` writes it with the
port's own GGUF writer: 6 layers, sliding-window pattern
[T, T, T, F, T, F], global heads of 64, sliding heads of 32, an 8-token
window, Q8_0 layer weights; as gemma4 with 2 shared-KV layers (layer
n_kv - 1 = 3 global and n_kv - 2 = 2 sliding, the sources
``kv_source_layer`` gives shared layers 5 and 4), and as Gemma-3, whose
every layer owns its K/V (so the paged server's sliding-window rings come
into play under LLMI_SWA_MASK=1).

Bars, against the same JAX routes, with LLMI_SWA_MASK unset and =1:
  - bit-equal: hparams, the per-layer shapes of the single-stream cache,
    the dense lanes and the paged pools (rings included), and the weights
    in every load mode carried across by ``from_jax_arrays``;
  - prefill and per-op decode steps op by op at 1e-4 * max(1, max|ref|)
    (the port's forward re-synchronised to the JAX forward's named taps at
    each bf16 rounding, as tests/test_torch_gemma4.py does), and the
    prefill end to end at the suite's 1.5e-2 * max(1, max|logits|) with
    equal argmax;
  - the routes that need uniform head dims (the tensor-parallel step, the
    capacity route's flat cache) raise ``NotImplementedError`` naming
    ROADMAP.md queue 1 item 7, and every whole step's gate says no (the
    sharded per-op path takes them: tests/test_torch_head_dims_sharding.py).
  - identical greedy streams of the ``Engine`` in serve, serve-q8, serve-q,
    serve-q4 and parity (each on the per-op route).
The dense and paged servers' streams, the parity taps and the CLI are
tests/test_torch_head_dims_serving.py's (a file of its own, so that two
test workers share the time).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import llm_inference_tpu.serving as jserving
from llm_inference_tpu.engine import Engine as JEngine
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.models import forward as jax_forward
from llm_inference_tpu.models import init_cache as jax_init_cache
from llm_inference_tpu.models import load_weights as jax_load_weights
from llm_inference_tpu.models.hparams import load_hparams as jax_load_hparams
from llm_inference_tpu.models.weights import fuse_projections as jax_fuse
from llm_inference_tpu_torch.engine import Engine
from llm_inference_tpu_torch.gguf import GGMLType, GGUFFile, GGUFWriter
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.models.hparams import load_hparams
from llm_inference_tpu_torch.models.weights import (fuse_projections, from_jax_arrays,
                                                    layers_stackable, load_weights, stack_layers,
                                                    stack_layers_gemma4)
from llm_inference_tpu_torch.ops.kernels import (fused_decode, fused_decode_batch,
                                                 fused_decode_batch_paged, fused_decode_q,
                                                 fused_decode_stream, fused_decode_tp)
from llm_inference_tpu_torch.parallel import make_mesh
from llm_inference_tpu_torch.serving import BatchedServer

from fixtures import build_gemma3_gguf
from test_torch_gemma4 import _assert_same, _close, _flatten, _no_stop
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

VOCAB = [f"t{i}" for i in range(256)]
VOCAB[1], VOCAB[2], VOCAB[3] = "<eos>", "<bos>", "<unk>"
PATTERN = (True, True, True, False, True, False)
PAGE = 16
SERVER = dict(max_seq=64, max_batch=3, decode_chunk=4)
REQS = [([2, 7, 8], 9), ([2, 9], 5), ([2, 5, 6, 30], 7), ([2, 11], 6)]
PREFILL = [2, 7, 8, 9, 4, 5, 6, 30, 8, 7, 2, 9]
ITEM7 = "ROADMAP.md queue 1, item 7"


def build_head_dims_gguf(arch: str = "gemma4", *, n_layers=6, shared_kv_layers=2, n_embd=128,
                         n_ff=256, n_head=4, n_head_kv=2, n_embd_per_layer=32, dims=(64, 64),
                         swa_dims=(32, 32), sliding_window=8, pattern=PATTERN, weight_std=0.1,
                         seed=1818) -> bytes:
    """A gemma4 (or Gemma-3) checkpoint with per-layer head dims: layer i's
    Q/K/V/O projections and q/k norms at ``swa_dims`` (key, value) where
    ``pattern[i]`` flags it sliding, at ``dims`` elsewhere; Q8_0 layer
    weights, F16 embeddings, F32 norms, written by the port's writer. The
    gemma4 tensors are tests/fixtures.py's build_gemma4_gguf's."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return (rng.standard_normal(shape) * weight_std).astype(np.float32)

    q8, f16, f32 = GGMLType.Q8_0, GGMLType.F16, GGMLType.F32
    g4 = arch == "gemma4"
    w = GGUFWriter()
    meta = [("general.architecture", arch), (f"{arch}.block_count", n_layers),
            (f"{arch}.embedding_length", n_embd), (f"{arch}.feed_forward_length", n_ff),
            (f"{arch}.attention.head_count", n_head),
            (f"{arch}.attention.head_count_kv", n_head_kv),
            (f"{arch}.attention.layer_norm_rms_epsilon", 1e-6), (f"{arch}.rope.freq_base", 1e6),
            (f"{arch}.attention.key_length", dims[0]), (f"{arch}.attention.value_length", dims[1]),
            (f"{arch}.attention.key_length_swa", swa_dims[0]),
            (f"{arch}.attention.value_length_swa", swa_dims[1]),
            (f"{arch}.attention.sliding_window", sliding_window),
            (f"{arch}.attention.sliding_window_pattern", list(pattern))]
    if g4:
        meta += [(f"{arch}.embedding_length_per_layer", n_embd_per_layer),
                 (f"{arch}.attention.shared_kv_layers", shared_kv_layers)]
    meta += [("tokenizer.ggml.tokens", VOCAB), ("tokenizer.ggml.bos_token_id", 2),
             ("tokenizer.ggml.eos_token_id", 1), ("tokenizer.ggml.unk_token_id", 3)]
    for key, val in meta:
        w.add_metadata(key, val)
    P = n_embd_per_layer
    w.add_tensor("token_embd.weight", rand(len(VOCAB), n_embd), f16)
    w.add_tensor("output_norm.weight", rand(n_embd) + 1.0, f32)
    if g4:
        w.add_tensor("token_embd_per_layer.weight", rand(len(VOCAB), n_layers * P), f16)
        w.add_tensor("per_layer_model_proj.weight", rand(n_layers * P, n_embd), q8)
        w.add_tensor("per_layer_proj_norm.weight", rand(P) + 1.0, f32)
    n_kv = n_layers - shared_kv_layers if g4 else n_layers
    for i in range(n_layers):
        dk, dv = swa_dims if pattern[i] else dims
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", rand(n_embd) + 1.0, f32)
        w.add_tensor(p + "attn_q_norm.weight", rand(dk) + 1.0, f32)
        w.add_tensor(p + "attn_k_norm.weight", rand(dk) + 1.0, f32)
        w.add_tensor(p + "attn_q.weight", rand(n_head * dk, n_embd), q8)
        if i < n_kv:
            w.add_tensor(p + "attn_k.weight", rand(n_head_kv * dk, n_embd), q8)
            w.add_tensor(p + "attn_v.weight", rand(n_head_kv * dv, n_embd), q8)
        w.add_tensor(p + "attn_output.weight", rand(n_embd, n_head * dv), q8)
        w.add_tensor(p + "ffn_norm.weight", rand(n_embd) + 1.0, f32)
        w.add_tensor(p + "ffn_gate.weight", rand(n_ff, n_embd), q8)
        w.add_tensor(p + "ffn_up.weight", rand(n_ff, n_embd), q8)
        w.add_tensor(p + "ffn_down.weight", rand(n_embd, n_ff), q8)
        w.add_tensor(p + "post_attention_norm.weight", rand(n_embd) + 1.0, f32)
        w.add_tensor(p + "post_ffw_norm.weight", rand(n_embd) + 1.0, f32)
        if g4:
            w.add_tensor(p + "per_layer_inp_gate.weight", rand(P, n_embd), q8)
            w.add_tensor(p + "per_layer_proj.weight", rand(n_embd, P), q8)
            w.add_tensor(p + "per_layer_post_norm.weight", rand(n_embd) + 1.0, f32)
            w.add_tensor(p + "out_scale.weight", np.asarray([0.9], dtype=np.float32), f32)
    return w.build()


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("head_dims")
    out = {}
    for arch in ("gemma4", "gemma3"):
        (d / f"{arch}.gguf").write_bytes(build_head_dims_gguf(arch))
        out[arch] = str(d / f"{arch}.gguf")
    return out


def _swa(monkeypatch, on: bool) -> None:
    if on:
        monkeypatch.setenv("LLMI_SWA_MASK", "1")
    else:
        monkeypatch.delenv("LLMI_SWA_MASK", raising=False)


def _shapes(ts) -> list:
    return [tuple(np.shape(t)) for t in ts]


# -- hparams, caches, weights ----------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma4", "gemma3"])
def test_hparams_and_cache_shapes_bit_equal(paths, arch, monkeypatch):
    """hparams equal the JAX package's; the single-stream cache, the dense
    lanes and the paged pools (under LLMI_SWA_MASK=1 the Gemma-3 pools are
    sliding-window rings) have the JAX package's per-layer shapes, each KV
    layer at its own widths."""
    hp = load_hparams(GGUFFile(paths[arch]).metadata)
    jhp = jax_load_hparams(JGGUFFile(paths[arch]).metadata)
    assert dataclasses.asdict(hp) == dataclasses.asdict(jhp)
    assert (hp.n_embd_head_k, hp.n_embd_head_k_swa) == (64, 32) and not gemma.uniform_head_dims(hp)
    assert [gemma.head_dims(hp, i) for i in range(6)] == [
        (32, 32), (32, 32), (32, 32), (64, 64), (32, 32), (64, 64)]
    if arch == "gemma4":
        assert hp.n_kv_layers == 4 and [hp.kv_source_layer(i) for i in (4, 5)] == [2, 3]
    cache, jcache = gemma.init_cache(hp, 64), jax_init_cache(jhp, 64)
    assert _shapes(cache.k) == _shapes(jcache.k) and _shapes(cache.v) == _shapes(jcache.v)
    assert isinstance(cache.k, tuple) and cache.k[0].dtype == torch.bfloat16
    for swa in (False, True):
        _swa(monkeypatch, swa)
        jdense = jserving.BatchedServer(paths[arch], mode="serve-q8", **SERVER)
        lanes = gemma.init_batched_cache(hp, SERVER["max_batch"], SERVER["max_seq"])
        assert _shapes(lanes.k) == _shapes(jdense._caches.k)
        assert _shapes(lanes.v) == _shapes(jdense._caches.v)
        assert _shapes(lanes.lane(1).k) == _shapes(cache.k)
        monkeypatch.setattr(jserving, "PAGE", PAGE)
        monkeypatch.setenv("LLMI_PAGE", str(PAGE))
        jpaged = jserving.BatchedServer(paths[arch], mode="serve-q8", kv_pages=8, **SERVER)
        srv = BatchedServer(paths[arch], mode="serve-q8", kv_pages=8, device="cpu", **SERVER)
        assert srv._rings == jpaged._rings
        assert bool(srv._rings) == (swa and arch == "gemma3")
        assert _shapes(srv._caches.k) == _shapes(jpaged._caches.k)
        assert _shapes(srv._caches.v) == _shapes(jpaged._caches.v)
        assert srv._caches.k_all is None  # per-layer widths: no stacked pool
        pools = gemma.pools_from_arrays(hp, [np.asarray(t, np.float32) for t in jpaged._caches.k],
                                        [np.asarray(t, np.float32) for t in jpaged._caches.v])
        assert _shapes(pools.k) == _shapes(srv._caches.k)
        back = gemma.batched_cache_from_arrays([np.asarray(t, np.float32)
                                                for t in jdense._caches.k],
                                               [np.asarray(t, np.float32)
                                                for t in jdense._caches.v])
        assert isinstance(back.k, tuple) and _shapes(back.v) == _shapes(lanes.v)


@pytest.mark.parametrize("mode", ["bf16", "rowq8", "packed-serve", "packed-q4", "packed"])
@pytest.mark.parametrize("arch", ["gemma4", "gemma3"])
def test_weights_bit_equal_in_every_load_mode(paths, arch, mode):
    """The port's load of per-layer Q/K/V/O shapes equals the JAX package's,
    carried across by ``from_jax_arrays`` (fused as the serve modes fuse);
    neither stacking takes such layers, as the JAX gates do not."""
    jhp, jw = jax_load_weights(JGGUFFile(paths[arch]), mode=mode)
    hp, w = load_weights(GGUFFile(paths[arch]), mode=mode)
    if mode != "packed":  # parity keeps its projections unfused
        jw, w = jax_fuse(jw), fuse_projections(w)
        dk, dv = gemma.head_dims(hp, 0)
        assert w.layers[0].wqkv.rows == hp.n_head * dk + hp.n_head_kv * (dk + dv)
        assert w.layers[3].wqkv.rows == hp.n_head * 64 + hp.n_head_kv * 128
    assert w.layers[0].wo.cols == hp.n_head * 32 and w.layers[3].wo.cols == hp.n_head * 64
    hp2, w2 = from_jax_arrays(dataclasses.asdict(jhp), _flatten(jw))
    assert hp2 == hp
    _assert_same(w2, w)
    assert not layers_stackable(hp, w.layers)
    assert stack_layers_gemma4(hp, w) is None


def _models(path, mode="rowq8"):
    jhp, jw = jax_load_weights(JGGUFFile(path), mode=mode)
    hp, w = load_weights(GGUFFile(path), mode=mode)
    return jhp, jax_fuse(jw), hp, fuse_projections(w)


# -- the forward: prefill op by op, end to end, decode ---------------------------------


@pytest.mark.parametrize("arch,swa", [("gemma4", False), ("gemma4", True), ("gemma3", False),
                                      ("gemma3", True)])
def test_prefill_and_decode_match_jax_op_by_op(paths, arch, swa, monkeypatch):
    """The port's ``forward`` against the JAX package's at 1e-4 * max(1,
    max|ref|), op by op (tests/test_torch_gemma4.py's method), over the
    prefill and two per-op decode steps: each projection's input, each new
    K/V row at its layer's width, each layer's output and the logits
    against the JAX forward's named taps, the port re-synchronised to them
    (so the two caches stay equal). Covers both widths, the shared-KV
    layers' sources and (LLMI_SWA_MASK=1) the windows of the narrow
    layers."""
    from llm_inference_tpu import trace

    _swa(monkeypatch, swa)
    jhp, jw, hp, w = _models(paths[arch])
    worst = {}
    taps = {}

    def sync(key, mine):
        ref = taps[key].reshape(mine.shape)
        err = float(np.abs(mine.float().numpy() - ref).max()) / max(1.0, float(np.abs(ref).max()))
        assert err <= 1e-4, (key, err)
        worst[key.split("-")[0]] = max(worst.get(key.split("-")[0], 0.0), err)
        return torch.tensor(ref)

    roles = {}
    layer = {"i": -1, "writes": 0}
    real_mm, real_layer, real_write = gemma._matmul, gemma._layer, gemma._write_cache
    vkey = "Vcur_normed" if arch == "gemma4" else "Vcur"

    def matmul(wt, x, **kw):
        key = roles.get(id(wt))
        return real_mm(wt, x if key is None else sync(key, x), **kw)

    def write_cache(cache, new, pos, n_valid):
        i = layer["i"]
        assert new.shape[-1] == gemma.head_dims(hp, i)[layer["writes"]]  # the layer's width
        key = f"Kcur-{i} (post rope)" if layer["writes"] == 0 else f"{vkey}-{i}"
        layer["writes"] += 1
        real_write(cache, sync(key, new), pos, n_valid)

    def one_layer(hp_, lw, x, *a, **kw):
        i = layer["i"] = layer["i"] + 1
        layer["writes"] = 0
        for f, key in (("wqkv", "attn_norm"), ("wq", "attn_norm"), ("wo", "kqv_out"),
                       ("w_gate_up", "ffn_norm"), ("w_down", "ffn_geglu"),
                       ("per_layer_inp_gate", "pe_in")):
            if getattr(lw, f) is not None:
                roles[id(getattr(lw, f))] = f"{key}-{i}"
        if i > 0:
            x = sync(f"l_out-{i - 1}", x)
        out = real_layer(hp_, lw, x, *a, **kw)
        if i == hp.block_count - 1:
            sync(f"l_out-{i}", out)
        return out

    if w.per_layer_model_proj is not None:
        roles[id(w.per_layer_model_proj)] = "inp_scaled"
    roles[id(w.token_embd)] = "result_norm"
    monkeypatch.setattr(gemma, "_matmul", matmul)
    monkeypatch.setattr(gemma, "_write_cache", write_cache)
    monkeypatch.setattr(gemma, "_layer", one_layer)
    jcache, cache = jax_init_cache(jhp, 64, dtype=jnp.bfloat16), gemma.init_cache(hp, 64)
    pos = 0
    for tokens in (PREFILL, [9], [10]):
        recorder = trace.enable_trace("unused.npz")
        try:
            jl, jcache = jax_forward(jhp, jw, jcache, jnp.asarray(tokens, dtype=jnp.int32), pos,
                                     exact=False, mm_impl="xla")
        finally:
            trace.disable_trace()
        taps.clear()
        taps.update({k: np.asarray(v, dtype=np.float32) for k, v in recorder.records})
        layer["i"] = -1
        p = pos if len(tokens) > 1 else torch.tensor([pos], dtype=torch.int32)
        tl, cache = gemma.forward(hp, w, cache, torch.tensor(tokens), p)
        assert layer["i"] == hp.block_count - 1
        _close(tl.numpy(), jl, 1e-4)
        assert int(tl.argmax()) == int(np.asarray(jl).argmax())
        pos += len(tokens)
    want = {"attn_norm", "Kcur", vkey, "kqv_out", "ffn_norm", "ffn_geglu", "l_out", "result_norm"}
    if arch == "gemma4":
        want |= {"inp_scaled", "pe_in"}
    assert set(worst) == want
    for mine, theirs in ((cache.k, jcache.k), (cache.v, jcache.v)):
        assert len(mine) == len(theirs) == hp.n_kv_layers
        for m, t in zip(mine, theirs):  # equal: every row written was synchronised
            assert torch.equal(m.float(), torch.from_numpy(np.asarray(t, dtype=np.float32)))


@pytest.mark.parametrize("arch,swa", [("gemma4", False), ("gemma4", True), ("gemma3", True)])
def test_prefill_matches_jax_end_to_end(paths, arch, swa, monkeypatch):
    """The prefill through both packages, unsynchronised: logits at 1.5e-2 *
    max(1, max|logits|) with equal argmax (measured 3e-3 to 9.3e-3; later
    per-op decode steps reach 1.65e-2 on the gemma4 fixture as bf16
    re-rounding flips of f32 order noise compound, so the decode steps are
    held op by op above and by the identical streams of
    tests/test_torch_head_dims_serving.py); each owner layer's cache rows at
    its own width within the logits' bar relative to the rows, nothing
    written past the prompt."""
    _swa(monkeypatch, swa)
    jhp, jw, hp, w = _models(paths[arch])
    jl, jcache = jax_forward(jhp, jw, jax_init_cache(jhp, 64, dtype=jnp.bfloat16),
                             jnp.asarray(PREFILL, dtype=jnp.int32), 0, exact=False, mm_impl="xla")
    tl, cache = gemma.forward(hp, w, gemma.init_cache(hp, 64), torch.tensor(PREFILL), 0)
    _close(tl.numpy(), jl, 1.5e-2)
    assert int(tl.argmax()) == int(np.asarray(jl).argmax())
    pos = len(PREFILL)
    for mine, theirs in ((cache.k, jcache.k), (cache.v, jcache.v)):
        assert len(mine) == len(theirs) == hp.n_kv_layers
        for i, (m, t) in enumerate(zip(mine, theirs)):
            ref = np.asarray(t, dtype=np.float32)[:pos]
            assert m.shape[-1] == ref.shape[-1] in (32, 64)
            np.testing.assert_allclose(m[:pos].float().numpy(), ref,
                                       atol=1.5e-2 * max(1.0, np.abs(ref).max()), err_msg=str(i))
            assert not m[pos:].any()


# -- the Engine's streams ---------------------------------------------------------------


MODES = ("serve", "serve-q8", "serve-q", "serve-q4", "parity")


@pytest.mark.parametrize("swa", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_engine_stream_matches_jax_engine(paths, mode, swa, monkeypatch):
    """The gemma4 checkpoint in each mode: the per-op route (no whole step's
    gate takes per-layer head dims, as in the JAX engine), a per-layer cache
    of each KV layer's widths, and the JAX Engine's greedy stream."""
    _swa(monkeypatch, swa)
    want = _no_stop(JEngine(paths["gemma4"], max_seq=64, mode=mode,
                            decode_chunk=4)).generate_from_ids(PREFILL, n_predict=8)
    eng = _no_stop(Engine(paths["gemma4"], max_seq=64, mode=mode, decode_chunk=4, device="cpu"))
    assert eng.decode_route == "per-op"
    assert [t.shape[-1] for t in eng.new_cache().k] == [32, 32, 32, 64]
    assert eng.generate_from_ids(PREFILL, n_predict=8) == want



# -- routes that stay closed, and the whole steps' gates ---------------------------------


def test_closed_routes_raise(paths, monkeypatch):
    """The tensor-parallel step and the capacity route (its flat cache; a
    forced capacity load) raise ``NotImplementedError`` naming ROADMAP.md
    queue 1 item 7, before anything loads; without LLMI_FORCE_CAPACITY the
    capacity route's directory check refuses and the per-op route follows,
    as in the JAX engine. (The sharded per-op path takes per-layer head
    dims: tests/test_torch_head_dims_sharding.py.)"""
    g4, g3 = paths["gemma4"], paths["gemma3"]
    hp = load_hparams(GGUFFile(g3).metadata)
    mesh = make_mesh(model=2, devices=[torch.device("cpu")] * 2)
    closed = [
        lambda: Engine(g3, mode="serve-q8", max_seq=64, device="cpu", tp_mesh=mesh),
        lambda: Engine(g3, mode="serve-q", max_seq=64, device="cpu", tp_mesh=mesh),
        lambda: gemma.init_cache(hp, 64, flat=True),
    ]
    for make in closed:
        with pytest.raises(NotImplementedError, match=ITEM7):
            make()
    for mode in ("serve-q", "serve-q4"):
        gguf = GGUFFile(g3)
        assert not fused_decode_stream.stream_supported_from_directory(gguf, hp, q4=True,
                                                                       max_seq=64)
        assert Engine(g3, mode=mode, max_seq=64, device="cpu").decode_route == "per-op"
        monkeypatch.setenv("LLMI_FORCE_CAPACITY", "1")
        with pytest.raises(NotImplementedError, match=ITEM7):
            Engine(g3, mode=mode, max_seq=64, device="cpu")
        monkeypatch.delenv("LLMI_FORCE_CAPACITY")


def test_whole_step_gates_refuse_per_layer_dims():
    """Every whole step's gate, given stacked weights the step takes, says
    no once the sliding layers' head dims differ (the JAX gates'
    decision, ops/pallas/fused_decode.py:163, fused_decode_q.py:125,
    fused_decode_stream.py:182/:274, fused_decode_batch.py:103,
    fused_decode_batch_paged.py:103): a route decision before any launch."""
    vocab = [f"t{i}" for i in range(512)]
    buf = build_gemma3_gguf(n_layers=2, n_embd=256, n_ff=512, n_head=4, n_head_kv=1,
                            head_dim=128, vocab=vocab, weight_fmt=GGMLType.Q8_0)
    gguf = GGUFFile(buf)
    hp = load_hparams(gguf.metadata)
    narrow = dataclasses.replace(hp, n_embd_head_k_swa=64, n_embd_head_v_swa=64)
    w8 = fuse_projections(load_weights(gguf, hp, mode="rowq8")[1])
    w8 = dataclasses.replace(w8, layers=stack_layers(w8.layers))
    wq = fuse_projections(load_weights(gguf, hp, mode="packed-serve")[1])
    wq = dataclasses.replace(wq, layers=stack_layers(wq.layers))
    checks = [
        lambda h: fused_decode.decode_supported(h, w8),
        lambda h: fused_decode_batch.batch_supported(h, w8, batch=4, max_seq=256),
        lambda h: fused_decode_batch_paged.batch_paged_supported(h, w8, batch=4, nb=2, page=128),
        lambda h: fused_decode_tp.tp_decode_supported(h, w8, 2),
        lambda h: fused_decode_q.decode_q_supported(h, wq),
        lambda h: fused_decode_stream.decode_stream_supported(h, wq, max_seq=256),
    ]
    for i, ok in enumerate(checks):
        assert ok(hp), i  # the uniform checkpoint takes every step
        assert not ok(narrow), i
