"""gemma4 through the port on the CPU against llm_inference_tpu.

The checkpoint is tests/fixtures.py's ``build_gemma4_gguf`` at the geometry
of tests/test_fused_decode.py:142-151 (4 layers, D 512, F 512, 4 heads over
2 KV heads of 128, P 128), with one and two shared-KV layers, plus a
checkpoint writer local to this file for sliding windows (layer n_kv - 1 global,
layer n_kv - 2 windowed, so a shared layer reads each kind of source).

Bars:
  - bit-equal: hparams, the chat template, and the weights in the three load
    modes (``load_weights`` + ``fuse_projections``, ``stack_layers_gemma4``,
    ``from_jax_arrays`` of the JAX package's loads);
  - prefill against JAX ``forward(exact=False, mm_impl="xla")`` at 1e-4 *
    max(1, max|ref|), op by op: every projection's input, every new K/V
    row, each layer's output and the logits, where the port's forward is
    re-synchronised to the JAX forward's value (its named taps) at each bf16
    rounding point, so that a rounding flip of f32 summation-order noise
    (1e-7) does not carry into later ops (measured at most 3.8e-6, at the
    attention output; a bf16 rounding added to the residual or to the
    per-layer input reads 1e-3);
  - prefill end to end, logits at 1.5e-2 * max(1, max|logits|) with equal
    argmax: on these random fixtures the flips carry and compound (the
    post norms rescale small branch outputs to unit RMS), measured 1e-3 to
    1.4e-2;
  - decode: the whole-step kernel's plain twin against the JAX serve
    forward at 1.5e-2 * max(1, max|logits|) with equal argmax (the bar of
    tests/test_fused_decode.py: the kernel's bf16 rounding points differ
    from the per-op path's f32 attention); owner cache rows within 4e-2;
    the cache holds the owner layers only and nothing past the last
    position is written;
  - identical greedy streams: the ``Engine`` in serve-q8 (both routes),
    serve-q and serve-q4, and ``BatchedServer`` dense and paged, against
    the JAX package's: tests/test_torch_gemma4_serving.py, on this file's
    checkpoints (a file of its own, so that two test workers share the
    time).
"""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import llm_inference_tpu.serving as jserving
from llm_inference_tpu.engine import Engine as JEngine
from llm_inference_tpu.gguf import GGMLType, GGUFWriter
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.models import forward as jax_forward
from llm_inference_tpu.models import init_cache as jax_init_cache
from llm_inference_tpu.models import load_weights as jax_load_weights
from llm_inference_tpu.models.hparams import load_hparams as jax_load_hparams
from llm_inference_tpu.models.weights import fuse_projections as jax_fuse
from llm_inference_tpu.models.weights import stack_layers_gemma4 as jax_stack_g4
from llm_inference_tpu.tokenizer import Tokenizer as JTokenizer
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.models.hparams import load_hparams
from llm_inference_tpu_torch.models.weights import (LayerWeights, fuse_projections,
                                                    from_jax_arrays, layers_stackable,
                                                    load_weights, stack_layers_gemma4)
from llm_inference_tpu_torch.ops.kernels import fused_decode
from llm_inference_tpu_torch.ops.kernels import fused_decode_stream as fds
from llm_inference_tpu_torch.quant.device import DenseTensor, Q4Tensor, QuantTensor
from llm_inference_tpu_torch.serving import BatchedServer
from llm_inference_tpu_torch.tokenizer import Tokenizer

from fixtures import build_gemma4_gguf
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

VOCAB = [f"t{i}" for i in range(256)]
VOCAB[1], VOCAB[2], VOCAB[3] = "<eos>", "<bos>", "<unk>"
GEOM = dict(n_layers=4, n_embd=512, n_ff=512, n_head=4, n_head_kv=2, n_embd_per_layer=128)
MODES = {"serve-q8": "rowq8", "serve-q": "packed-serve", "serve-q4": "packed-q4"}
PAGE = 16
SERVER = dict(max_seq=64, max_batch=3, decode_chunk=4)
REQS = [([2, 7, 8], 9), ([2, 9], 5), ([2, 5, 6, 30], 7), ([2, 11], 6)]


def _windowed_gguf(*, n_layers=6, shared_kv_layers=2, n_embd=512, n_ff=512, n_head=4,
                   n_head_kv=2, n_embd_per_layer=128, sliding_window=8,
                   pattern=(True, True, True, False, True, False), weight_std=0.1,
                   seed=4242) -> bytes:
    """A gemma4 checkpoint with a sliding window: ``pattern`` flags the
    windowed layers (here layer n_kv - 1 = 3 global and n_kv - 2 = 2
    windowed, so shared layer 4 reads the windowed source and layer 5 the
    global one). The tensors of tests/fixtures.py's build_gemma4_gguf."""
    head_dim = n_embd // n_head
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return (rng.standard_normal(shape) * weight_std).astype(np.float32)

    q4, f16, f32 = GGMLType.Q4_0, GGMLType.F16, GGMLType.F32
    w = GGUFWriter()
    for key, val in (("general.architecture", "gemma4"), ("gemma4.block_count", n_layers),
                     ("gemma4.embedding_length", n_embd), ("gemma4.feed_forward_length", n_ff),
                     ("gemma4.attention.head_count", n_head),
                     ("gemma4.attention.head_count_kv", n_head_kv),
                     ("gemma4.attention.layer_norm_rms_epsilon", 1e-6),
                     ("gemma4.rope.freq_base", 1000000.0),
                     ("gemma4.embedding_length_per_layer", n_embd_per_layer),
                     ("gemma4.attention.shared_kv_layers", shared_kv_layers),
                     ("gemma4.attention.sliding_window", sliding_window),
                     ("gemma4.attention.sliding_window_pattern", list(pattern)),
                     ("tokenizer.ggml.tokens", VOCAB), ("tokenizer.ggml.bos_token_id", 2),
                     ("tokenizer.ggml.eos_token_id", 1), ("tokenizer.ggml.unk_token_id", 3)):
        w.add_metadata(key, val)
    P = n_embd_per_layer
    w.add_tensor("token_embd.weight", rand(len(VOCAB), n_embd), f16)
    w.add_tensor("output_norm.weight", rand(n_embd) + 1.0, f32)
    w.add_tensor("per_layer_token_embd.weight", rand(len(VOCAB), n_layers * P), f16)  # alias
    w.add_tensor("per_layer_model_proj.weight", rand(n_layers * P, n_embd), q4)
    w.add_tensor("per_layer_proj_norm.weight", rand(P) + 1.0, f32)
    for i in range(n_layers):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", rand(n_embd) + 1.0, f32)
        w.add_tensor(p + "attn_q_norm.weight", rand(head_dim) + 1.0, f32)
        w.add_tensor(p + "attn_k_norm.weight", rand(head_dim) + 1.0, f32)
        w.add_tensor(p + "attn_q.weight", rand(n_head * head_dim, n_embd), q4)
        if i < n_layers - shared_kv_layers:
            w.add_tensor(p + "attn_k.weight", rand(n_head_kv * head_dim, n_embd), q4)
            w.add_tensor(p + "attn_v.weight", rand(n_head_kv * head_dim, n_embd), q4)
        w.add_tensor(p + "attn_output.weight", rand(n_embd, n_head * head_dim), q4)
        w.add_tensor(p + "ffn_norm.weight", rand(n_embd) + 1.0, f32)
        w.add_tensor(p + "ffn_gate.weight", rand(n_ff, n_embd), q4)
        w.add_tensor(p + "ffn_up.weight", rand(n_ff, n_embd), q4)
        w.add_tensor(p + "ffn_down.weight", rand(n_embd, n_ff), q4)
        w.add_tensor(p + "post_attention_norm.weight", rand(n_embd) + 1.0, f32)
        w.add_tensor(p + "post_ffw_norm.weight", rand(n_embd) + 1.0, f32)
        # the aliases of model.cpp:193-236 for half the layers
        alias = i % 2
        w.add_tensor(p + ("inp_gate.weight" if alias else "per_layer_inp_gate.weight"),
                     rand(P, n_embd), q4)
        w.add_tensor(p + ("proj.weight" if alias else "per_layer_proj.weight"), rand(n_embd, P),
                     q4)
        w.add_tensor(p + ("post_norm.weight" if alias else "per_layer_post_norm.weight"),
                     rand(n_embd) + 1.0, f32)
        w.add_tensor(p + ("layer_output_scale.weight" if alias else "out_scale.weight"),
                     np.asarray([0.9 + 0.05 * i], dtype=np.float32), f32)
    return w.build()


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("g4")
    out = {}
    for name, buf in {
        "shared1": build_gemma4_gguf(shared_kv_layers=1, vocab=VOCAB, **GEOM),
        "shared2": build_gemma4_gguf(shared_kv_layers=2, vocab=VOCAB, seed=778, **GEOM),
        "window": _windowed_gguf(),
    }.items():
        (d / f"{name}.gguf").write_bytes(buf)
        out[name] = str(d / f"{name}.gguf")
    return out


def _flatten(tree, prefix=""):
    """A JAX ModelWeights as {field path: numpy array}, with the weights'
    metadata (fmt, group_size, centered) as ints."""
    out = {}
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if f.name in ("fmt", "group_size", "bg", "mp", "centered"):
                out[prefix + f.name] = np.int32(int(v))
            elif v is not None and f.name not in ("rows", "cols"):
                out.update(_flatten(v, f"{prefix}{f.name}."))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _assert_same(a, b, where=""):
    """Two port weight trees hold the same tensors, bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, (QuantTensor, Q4Tensor, DenseTensor)):
        assert type(a) is type(b), where
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}.{i}")
    else:
        assert a == b, (where, a, b)


def _close(got, ref, rel):
    got, ref = np.asarray(got, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(1.0, np.abs(ref).max()))


def _no_stop(engine):
    engine.tokenizer.eos_id = -1
    engine.tokenizer.end_of_turn_id = -1
    return engine


# -- hparams, template, weights ---------------------------------------------------


@pytest.mark.parametrize("name", ["shared1", "shared2", "window"])
def test_hparams_bit_equal(paths, name):
    hp = load_hparams(GGUFFile(paths[name]).metadata)
    jhp = jax_load_hparams(JGGUFFile(paths[name]).metadata)
    assert dataclasses.asdict(hp) == dataclasses.asdict(jhp)
    assert hp.architecture == "gemma4" and hp.n_kv_layers < hp.block_count
    assert [hp.kv_source_layer(i) for i in range(hp.block_count)] == [
        jhp.kv_source_layer(i) for i in range(jhp.block_count)]
    if name == "window":  # shared layer 4 reads the windowed layer 2, layer 5 the global 3
        assert [hp.kv_source_layer(i) for i in (4, 5)] == [2, 3]
        assert hp.swa_window(2) == 8 and hp.swa_window(3) == 0


def test_chat_template_matches_jax():
    """The gemma4 template of tests/test_gemma4.py:46, through both tokenizers."""
    meta = GGUFFile(build_gemma4_gguf()).metadata
    tok, jtok = Tokenizer(meta, "gemma4"), JTokenizer(meta, "gemma4")
    for text in ("ab", "fact c"):
        res, ref = tok.encode(text, apply_chat_template=True), jtok.encode(text, True)
        assert res.ids == ref.ids and res.prefilled_thinking and ref.prefilled_thinking
    toks = [tok.id_to_token[i] for i in tok.encode("ab", apply_chat_template=True).ids]
    assert toks[0] == "<bos>" and "<|turn>" in toks and "<|channel>thought" in toks


@pytest.mark.parametrize("mode", list(MODES.values()))
@pytest.mark.parametrize("name", ["shared1", "shared2", "window"])
def test_weights_bit_equal_in_every_load_mode(paths, name, mode):
    """The port's load of every gemma4 tensor (aliases included) equals the
    JAX package's, carried across by ``from_jax_arrays``; rowq8 also
    through both packages' ``stack_layers_gemma4``."""
    jhp, jw = jax_load_weights(JGGUFFile(paths[name]), mode=mode)
    jw = jax_fuse(jw)
    hp, w = load_weights(GGUFFile(paths[name]), mode=mode)
    w = fuse_projections(w)
    assert w.token_embd_per_layer is not None and w.per_layer_model_proj is not None
    assert w.layers[-1].wq is not None and w.layers[-1].wqkv is None  # shared: Q alone
    assert all(lw.out_scale is not None and lw.per_layer_post_norm is not None
               for lw in w.layers)
    assert not layers_stackable(hp, w.layers)  # only stack_layers_gemma4 stacks gemma4
    hp2, w2 = from_jax_arrays(dataclasses.asdict(jhp), _flatten(jw))
    assert hp2 == hp
    _assert_same(w2, w)
    if mode != "rowq8":
        assert stack_layers_gemma4(hp, w) is None  # rowq8 only, as in JAX
        return
    g4, jg4 = stack_layers_gemma4(hp, w), jax_stack_g4(jhp, jw)
    assert isinstance(g4.layers, LayerWeights) and g4.layers.wqkv.q.shape[0] == hp.block_count
    _, g4_from_jax = from_jax_arrays(dataclasses.asdict(jhp), _flatten(jg4))
    _assert_same(g4_from_jax, g4)
    rq = hp.n_head * hp.n_embd_head_k
    for i in range(hp.n_kv_layers, hp.block_count):  # zero K/V rows and scales
        assert not g4.layers.wqkv.q[i, rq:].any() and not g4.layers.wqkv.scale[i, rq:].any()
        assert torch.equal(g4.layers.wqkv.q[i, :rq], w.layers[i].wq.q)
    assert fused_decode.decode_supported(hp, g4)
    assert not fused_decode.decode_supported(hp, w)  # unstacked


def test_decode_supported_rules(paths):
    hp, w = load_weights(GGUFFile(paths["shared1"]), mode="rowq8")
    g4 = stack_layers_gemma4(hp, fuse_projections(w))
    assert fused_decode.decode_supported(hp, g4)
    # the step's shared memory (the plan's layout): one KV group's PV
    # partials beside the activation, and a ring of two full stages
    D, H, Hkv, d = hp.embedding_length, hp.n_head, hp.n_head_kv, hp.n_embd_head_k
    dims = dict(D=D, F=512, A=H * d, Rq=H * d + 2 * Hkv * d)
    assert fused_decode.fits_shared_memory(hp, **dims)
    assert fds.plan_smem(*dims.values(), H, Hkv, d, d, 36864, 2) <= 232448 - 1024
    bad = dataclasses.replace(g4, token_embd_per_layer=None)
    assert not fused_decode.decode_supported(hp, bad)
    assert not fused_decode.decode_supported(dataclasses.replace(hp, embedding_length_per_layer=64),
                                             g4)  # P % 128
    # one owner layer: the windowed shared layers' source would be layer -1
    assert not fused_decode.decode_supported(dataclasses.replace(hp, n_layer_kv_from_start=1), g4)
    grouped = load_weights(GGUFFile(paths["shared1"]), mode="packed-serve")[1]
    assert stack_layers_gemma4(hp, fuse_projections(grouped)) is None
    # D 2048 (bench.py's GEOM_G4) fits: its ring holds at least two full
    # stages beside the step's arrays
    wide = dataclasses.replace(hp, embedding_length=2048)
    dims = dict(D=2048, F=4096, A=H * d, Rq=H * d + 2 * Hkv * d)
    assert fused_decode.fits_shared_memory(wide, **dims)
    assert fds.plan_smem(*dims.values(), H, Hkv, d, d, 36864, 2) <= 232448 - 1024


# -- the forward: prefill, decode ---------------------------------------------------


def _models(path):
    jhp, jw = jax_load_weights(JGGUFFile(path), mode="rowq8")
    jw = jax_fuse(jw)
    hp, w = load_weights(GGUFFile(path), mode="rowq8")
    return jhp, jw, hp, stack_layers_gemma4(hp, fuse_projections(w))


def _run_both(path, prompt, n_steps, *, stacked=True, kv_rel=False):
    """Prefill and ``n_steps`` decode steps through both packages. Cache
    rows within 4e-2 (the JAX suite's bar), or with ``kv_rel`` within the
    logits' bar relative to the rows' largest value (the chip smoke's rule
    for deep layers: a six-layer model's last owner layer carries five
    layers of the two paths' bf16 re-rounding noise, 3 bf16 steps of 0.047
    at step 1 under LLMI_SWA_MASK=1)."""
    jhp, jw, hp, g4 = _models(path)
    w = g4 if stacked else fuse_projections(load_weights(GGUFFile(path), mode="rowq8")[1])
    jcache = jax_init_cache(jhp, 64, dtype=jnp.bfloat16)
    cache = gemma.init_cache(hp, 64)
    assert cache.k.shape[0] == hp.n_kv_layers  # owner layers only
    jfwd = jax.jit(partial(jax_forward, jhp, exact=False, mm_impl="xla"))
    jl, jcache = jfwd(jw, jcache, jnp.asarray(prompt, dtype=jnp.int32), 0)
    tl, cache = gemma.forward(hp, w, cache, torch.tensor(prompt), 0)
    _close(tl.numpy(), jl, 1.5e-2)  # the same per-op math, bf16 re-roundings (docstring)
    assert int(tl.argmax()) == int(jl.argmax())
    consts = fused_decode.prepare(hp, "cpu", swa_mask=gemma.swa_mask_enabled(), max_seq=64)
    pos = len(prompt)
    for step in range(n_steps):
        tok = 9 + step
        jl, jcache = jfwd(jw, jcache, jnp.asarray([tok], dtype=jnp.int32), pos)
        tl, cache = gemma.forward(hp, w, cache, torch.tensor([tok]), torch.tensor([pos]),
                                  consts=consts)
        pos += 1
        jl = np.asarray(jl)
        _close(tl.numpy(), jl, 1.5e-2)
        assert int(tl.argmax()) == int(jl.argmax()), f"step {step}"
    for mine, theirs in ((cache.k, jcache.k), (cache.v, jcache.v)):
        ref = np.stack([np.asarray(t, dtype=np.float32) for t in theirs])[:, :pos]
        atol = 1.5e-2 * max(1.0, np.abs(ref).max()) if kv_rel else 4e-2
        np.testing.assert_allclose(mine[:, :pos].float().numpy(), ref, atol=atol)
        assert not mine[:, pos:].any()  # nothing written past the last position


PREFILL = [2, 7, 8, 9, 4, 5, 6, 30, 8, 7, 2, 9]


@pytest.mark.parametrize("name,swa", [("shared1", False), ("shared2", False), ("window", False),
                                      ("window", True)])
def test_prefill_matches_jax_op_by_op(paths, name, swa, monkeypatch):
    """The port's prefill ``forward`` against the JAX package's at 1e-4 *
    max(1, max|ref|), op by op (the module docstring): the JAX forward runs
    with its named taps recorded; the port's runs with its projections,
    cache writes and layers wrapped so that each input is checked against
    the JAX value and then replaced by it. Covers the per-layer inputs, the
    shared-KV layers' source caches, the V norm, the epilogue, out_scale and
    (``window``) both window kinds, under LLMI_SWA_MASK=1 and without."""
    from llm_inference_tpu import trace

    if swa:
        monkeypatch.setenv("LLMI_SWA_MASK", "1")
    jhp, jw, hp, g4 = _models(paths[name])
    recorder = trace.enable_trace("unused.npz")
    try:
        jl, _ = jax_forward(jhp, jw, jax_init_cache(jhp, 64, dtype=jnp.bfloat16),
                            jnp.asarray(PREFILL, dtype=jnp.int32), 0, exact=False, mm_impl="xla")
    finally:
        trace.disable_trace()
    taps = {k: np.asarray(v, dtype=np.float32) for k, v in recorder.records}
    worst = {}

    def sync(key, mine):
        """``mine`` against the JAX tap ``key`` (the bar), then the tap."""
        ref = taps[key].reshape(mine.shape)
        err = float(np.abs(mine.float().numpy() - ref).max()) / max(1.0, float(np.abs(ref).max()))
        assert err <= 1e-4, (key, err)
        worst[key.split("-")[0]] = max(worst.get(key.split("-")[0], 0.0), err)
        return torch.tensor(ref)

    roles = {}  # id(weight) -> the tap of its input (None: not tapped)
    layer = {"i": -1, "writes": 0}
    real_mm, real_layer, real_write = gemma._matmul, gemma._layer, gemma._write_cache

    def matmul(w, x, **kw):
        key = roles[id(w)]
        return real_mm(w, x if key is None else sync(key, x), **kw)

    def write_cache(cache, new, pos, n_valid):
        i = layer["i"]
        key = f"Kcur-{i} (post rope)" if layer["writes"] == 0 else f"Vcur_normed-{i}"
        layer["writes"] += 1
        real_write(cache, sync(key, new), pos, n_valid)

    def one_layer(hp_, lw, x, *a, **kw):
        i = layer["i"] = layer["i"] + 1
        layer["writes"] = 0
        for f, key in (("wqkv", "attn_norm"), ("wq", "attn_norm"), ("wo", "kqv_out"),
                       ("w_gate_up", "ffn_norm"), ("w_down", "ffn_geglu"),
                       ("per_layer_inp_gate", "pe_in"), ("per_layer_proj", None)):
            if getattr(lw, f) is not None:
                roles[id(getattr(lw, f))] = None if key is None else f"{key}-{i}"
        if i > 0:
            x = sync(f"l_out-{i - 1}", x)
        out = real_layer(hp_, lw, x, *a, **kw)
        if i == hp.block_count - 1:
            sync(f"l_out-{i}", out)
        return out

    roles[id(g4.per_layer_model_proj)] = "inp_scaled"
    roles[id(g4.token_embd)] = "result_norm"
    monkeypatch.setattr(gemma, "_matmul", matmul)
    monkeypatch.setattr(gemma, "_write_cache", write_cache)
    monkeypatch.setattr(gemma, "_layer", one_layer)
    tl, cache = gemma.forward(hp, g4, gemma.init_cache(hp, 64), torch.tensor(PREFILL), 0)
    assert layer["i"] == hp.block_count - 1
    assert set(worst) == {"inp_scaled", "attn_norm", "Kcur", "Vcur_normed", "kqv_out",
                          "ffn_norm", "ffn_geglu", "pe_in", "l_out", "result_norm"}
    _close(tl.numpy(), jl, 1e-4)
    assert int(tl.argmax()) == int(np.asarray(jl).argmax())


@pytest.mark.parametrize("name", ["shared1", "shared2"])
def test_plain_decode_step_matches_jax_serve_forward(paths, name, monkeypatch):
    calls = []
    real = fused_decode.decode_step_plain
    monkeypatch.setattr(fused_decode, "decode_step_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    launches = fused_decode.launches
    _run_both(paths[name], [2, 7, 8, 30, 31], 3)
    assert len(calls) == 3 and fused_decode.launches == launches


def test_per_op_decode_matches_jax_serve_forward(paths):
    """Unstacked weights: every step per op on both sides (the prefill's bar)."""
    _run_both(paths["shared2"], [2, 7, 8], 2, stacked=False)


@pytest.mark.parametrize("swa", [False, True])
def test_plain_decode_step_with_windows(paths, swa, monkeypatch):
    """Both sources of kv_source_layer, with LLMI_SWA_MASK=1 (layer 2's
    8-token window bites over a 12-token prompt, and reaches shared layer 4)
    and without."""
    if swa:
        monkeypatch.setenv("LLMI_SWA_MASK", "1")
    prompt = [2, 7, 8, 9, 4, 5, 6, 30, 8, 7, 2, 9]
    _run_both(paths["window"], prompt, 3, kv_rel=True)
    jhp, jw, hp, g4 = _models(paths["window"])
    assert list(fused_decode.window_array(hp, True)) == [8, 8, 8, 0, 8, 0]
    cache = gemma.init_cache(hp, 64)
    gemma.forward(hp, g4, cache, torch.tensor(prompt), 0)
    args = (hp, g4, cache, torch.tensor([9]), torch.tensor([12], dtype=torch.int32))
    win = fused_decode.decode_step_plain(*args, fused_decode.prepare(hp, "cpu", swa_mask=True))
    nowin = fused_decode.decode_step_plain(*args, fused_decode.prepare(hp, "cpu", swa_mask=False))
    assert (win - nowin).abs().max() > 1e-4  # the window reaches the step


def test_shared_layer_reads_its_source(paths):
    """A shared layer's attention reads its source layer's cache: planting a
    fault in source layer 1's cached V (shared layer 3 reads layer 1,
    layer 3 being windowed by the reference's default pattern) moves the
    logits, and the step never writes a row for the shared layer."""
    _, _, hp, g4 = _models(paths["shared1"])
    assert hp.kv_source_layer(3) == 1
    cache = gemma.init_cache(hp, 32)
    gemma.forward(hp, g4, cache, torch.tensor([2, 7, 8, 9]), 0)
    consts = fused_decode.prepare(hp, "cpu", swa_mask=False)
    args = (torch.tensor([5]), torch.tensor([4], dtype=torch.int32), consts)
    ref = fused_decode.decode_step_plain(hp, g4, gemma.KVCache(cache.k.clone(), cache.v.clone()),
                                         *args)
    faulty = gemma.KVCache(cache.k.clone(), cache.v.clone())
    faulty.v[1, :4] = 0
    got = fused_decode.decode_step_plain(hp, g4, faulty, *args)
    assert (got - ref).abs().max() > 1e-3


@pytest.mark.slow
@pytest.mark.parametrize("name", ["shared1", "window"])
def test_plain_decode_step_matches_interpret_megakernel(paths, name, monkeypatch):
    """The plain twin against the Pallas whole-step kernel with its gemma4
    features, in interpret mode, on the same rowq8 stack and cache
    (minutes of CPU emulation, hence slow)."""
    monkeypatch.setenv("LLMI_FUSED_INTERPRET", "1")
    from llm_inference_tpu.ops.pallas.fused_decode import decode_step_megakernel

    jhp, jw, hp, g4 = _models(paths[name])
    jg4 = jax_stack_g4(jhp, jw)
    rng = np.random.default_rng(12)
    n_kv, S, Hkv, dk = hp.n_kv_layers, 64, hp.n_head_kv, hp.n_embd_head_k
    k = (rng.standard_normal((n_kv, S, Hkv, dk)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((n_kv, S, Hkv, dk)) * 0.5).astype(np.float32)
    k[:, 20:] = v[:, 20:] = 0.0
    jcache = jax_init_cache(jhp, S, stacked=True, dtype=jnp.bfloat16)
    jcache = dataclasses.replace(jcache, k=jnp.asarray(k, dtype=jnp.bfloat16),
                                 v=jnp.asarray(v, dtype=jnp.bfloat16))
    cache = gemma.init_cache(hp, S)
    cache.k.copy_(torch.from_numpy(k))
    cache.v.copy_(torch.from_numpy(v))
    ref, kc, _ = decode_step_megakernel(jhp, jg4, jcache, jnp.int32(9), jnp.int32(20),
                                        interpret=True)
    got = fused_decode.decode_step_plain(hp, g4, cache, torch.tensor([9]), torch.tensor([20]),
                                         fused_decode.prepare(hp, "cpu", swa_mask=False))
    ref = np.asarray(ref)
    _close(got.numpy(), ref, 1.5e-2)
    assert int(got.argmax()) == int(ref.argmax())
    np.testing.assert_allclose(cache.k[:, 20].float().numpy(),
                               np.asarray(kc, dtype=np.float32)[:, 20], atol=4e-2)


def _bake_tool():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "bake_golden_gemma4.py"
    spec = importlib.util.spec_from_file_location("bake_golden_gemma4", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["shared1", "window"])
def test_golden_reference_matches_jax_engine(paths, name):
    """tools/bake_golden_gemma4.py's Reference (the plain serve-q8 per-op
    forward that bakes tests/golden/gemma4_g4_tame.json) against the JAX
    serve-q8 Engine: identical greedy streams, prefill logits within the
    prefill bar of this file."""
    tool = _bake_tool()
    prompt = [2, 40, 41, 42, 43, 7, 8]
    jeng = _no_stop(JEngine(paths[name], max_seq=64, mode="serve-q8", decode_chunk=4))
    want = jeng.generate_from_ids(prompt, n_predict=9)
    jl, _ = jax_forward(jeng.hparams, jeng.weights,
                        jax_init_cache(jeng.hparams, 64, dtype=jnp.bfloat16),
                        jnp.asarray(prompt, dtype=jnp.int32), 0, exact=False, mm_impl="xla")
    with torch.no_grad():
        ref = tool.Reference(paths[name], max_seq=64)
        _close(ref.forward(prompt, 0).numpy(), jl, 1.5e-2)
        ref = tool.Reference(paths[name], max_seq=64)
        assert ref.greedy(prompt, 9) == want


def test_golden_reference_w8a8_matches_jax_server(paths, monkeypatch):
    """The reference's W8A8 mode (the server_tokens stream) against the JAX
    package's per-op BatchedServer with its device dispatch forced on the
    CPU: its matmul takes the W8A8 integer dot (``int8_rowwise_matmul``)
    for a per-row int8 weight called with mm_impl="xla" or of 16384 rows or
    more, the branch it takes on its device (linear.py:97-115); the
    per-layer model projection (mm_impl="auto", few rows) keeps bf16
    activations. The prefill and two decode steps' logits through JAX
    ``forward(mm_impl="xla")`` at 1e-4 * max(1, max|logits|) (measured at
    most 4.9e-7: exact integer sums; W8A8 in the per-layer projection too
    reads 6e-3 to 1.4e-2, bf16 activations throughout 1.4e-2 to 4.2e-2),
    and identical greedy streams."""
    import llm_inference_tpu.models.gemma as jgemma
    from llm_inference_tpu.ops import linear as jlinear
    from llm_inference_tpu.quant.device import QuantTensor as JQuantTensor

    real = jgemma.matmul
    used = []

    def device_dispatch(w, x, *, exact=True, mm_impl="auto"):
        if (not exact and isinstance(w, JQuantTensor) and w.groups == 1
                and (w.rows >= 16384 or mm_impl == "xla")):
            used.append(w.rows)
            t = 1 if x.ndim == 1 else int(np.prod(x.shape[:-1]))
            y = jlinear.int8_rowwise_matmul(w, x.reshape(t, w.cols))
            return y.reshape(x.shape[:-1] + (w.rows,))
        return real(w, x, exact=exact, mm_impl=mm_impl)

    monkeypatch.setattr(jgemma, "matmul", device_dispatch)
    tool = _bake_tool()
    reqs = [([2, 40, 41, 42, 43, 7, 8], 9), ([2, 9, 30], 6)]
    prompt = [2, 40, 41, 42, 43, 7, 8]
    for name in ("shared1", "shared2", "window"):
        jhp, jw, _, _ = _models(paths[name])
        jl, jcache = jax_forward(jhp, jw, jax_init_cache(jhp, 64, dtype=jnp.bfloat16),
                                 jnp.asarray(prompt, dtype=jnp.int32), 0, exact=False,
                                 mm_impl="xla")
        with torch.no_grad():
            ref = tool.Reference(paths[name], max_seq=64, w8a8=True)
            _close(ref.forward(prompt, 0).numpy(), jl, 1e-4)
            for pos, tok in ((7, 9), (8, 30)):
                jl, jcache = jax_forward(jhp, jw, jcache, jnp.asarray([tok], dtype=jnp.int32),
                                         pos, exact=False, mm_impl="xla")
                _close(ref.forward([tok], pos).numpy(), jl, 1e-4)
    for name in ("shared2", "window"):
        srv = jserving.BatchedServer(paths[name], mode="serve-q8", **SERVER)
        srv.tokenizer.eos_id = srv.tokenizer.end_of_turn_id = -1
        got = srv.run(reqs)
        assert used, "the JAX server never took the W8A8 branch"
        with torch.no_grad():
            want = [tool.Reference(paths[name], max_seq=64, w8a8=True).greedy(p, n)
                    for p, n in reqs]
        assert got == want, name


def test_golden_reference_w8a8_matches_the_server_route(paths, monkeypatch):
    """The reference's W8A8 mode (the server_tokens stream) against the
    port's per-op BatchedServer with the W8A8 products its CUDA dispatch
    takes (ops/linear.py ``int8_rowwise_matmul``, held against the JAX
    package's in tests/test_torch_ops.py), here forced on the CPU:
    identical greedy streams."""
    from llm_inference_tpu_torch.ops import linear

    real = gemma._matmul

    def w8a8(w, x, *, mm_impl="auto"):
        if mm_impl == "xla" and isinstance(w, QuantTensor) and w.groups == 1:
            return linear.int8_rowwise_matmul(w, x.reshape(-1, w.cols)).reshape(
                *x.shape[:-1], w.rows)
        return real(w, x, mm_impl=mm_impl)

    monkeypatch.setattr(gemma, "_matmul", w8a8)
    tool = _bake_tool()
    reqs = [([2, 40, 41, 42, 43, 7, 8], 9), ([2, 9, 30], 6)]
    srv = BatchedServer(paths["shared2"], mode="serve-q8", device="cpu", **SERVER)
    srv.tokenizer.eos_id = srv.tokenizer.end_of_turn_id = -1
    got = srv.run(reqs)
    with torch.no_grad():
        want = [tool.Reference(paths["shared2"], max_seq=64, w8a8=True).greedy(p, n)
                for p, n in reqs]
    assert got == want
