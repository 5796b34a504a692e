"""The port's capacity route on the CPU against llm_inference_tpu's.

Same seeded checkpoints through both packages. Bars, each with its reason:

- the capacity load (``load_capacity_stacked``): bit-equal to the port's
  standard load + fuse + stack, but for the raw f16 scales it keeps for
  Q4_0 nibbles (equal when widened), and, carried across with
  ``from_jax_arrays``, to the JAX ``load_maskdot_stacked`` in dequantized
  values (the two layouts hold the same integers, scales and offsets);
- ``layer_bytes_estimate``: equal to the JAX ``maskdot_layer_bytes_estimate``
  and to the bytes the load puts in a layer with f32 scales (f16 ones take
  less);
- the capacity step's plain twin against the JAX Pallas kernel in interpret
  mode, on the JAX stream tests' fixture with the tile target cut so the JAX
  kernel streams several tiles: logits within 1.5e-2 * max(1, max|logits|)
  with equal argmax (tests/test_fused_decode_stream.py's bar: the kernel
  sums masked MXU partials in another order), the written K/V rows within
  one bf16 step (2^-7 relative: the same f32 values rounded once);
- the capacity ``Engine``: greedy streams identical to the JAX ``Engine``'s
  capacity path (``LLMI_FORCE_CAPACITY=1``, ``LLMI_FUSED_INTERPRET=1``)."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_inference_tpu.engine import Engine as JEngine
from llm_inference_tpu.gguf import GGMLType as JGGMLType
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.gguf import GGUFWriter as JGGUFWriter
from llm_inference_tpu.models import init_cache as jax_init_cache
from llm_inference_tpu.models.weights import load_maskdot_stacked, maskdot_layer_bytes_estimate
from llm_inference_tpu.ops.pallas import fused_decode_stream as jfds
from llm_inference_tpu_torch.engine import Engine
from llm_inference_tpu_torch.gguf import GGMLType, GGUFFile
from llm_inference_tpu_torch.gguf.reader import TensorInfo
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.models.hparams import load_hparams
from llm_inference_tpu_torch.models.weights import (CAPACITY_THREAD, fuse_projections,
                                                    from_jax_arrays, layer_bytes_estimate,
                                                    load_capacity_stacked, load_weights,
                                                    stack_layers, weight_layer)
from llm_inference_tpu_torch.ops.kernels import fused_decode_q
from llm_inference_tpu_torch.ops.kernels import fused_decode_stream as fds
from llm_inference_tpu_torch.quant.device import Q4Tensor, QuantTensor, is_f16_scale_plane

from fixtures import build_gemma3_gguf, build_gemma4_gguf
from test_torch_lossless import VOCAB, _close, _flatten
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

FORMATS = ["Q4_0", "Q4_K", "Q8_0", "Q6_K"]
# the JAX stream tests' fixture (tests/test_fused_decode_stream.py:_buf)
STREAM = dict(n_layers=3, n_embd=256, n_ff=512, n_head=4, n_head_kv=2, head_dim=128,
              vocab=VOCAB, with_post_norms=True)
PARTS = ("wqkv", "wo", "w_gate_up", "w_down")
NORMS = ("attn_norm", "ffn_norm", "q_norm", "k_norm", "post_attn_norm", "post_ffw_norm")


def _stream_buf(fmt="Q4_0", **kw):
    return build_gemma3_gguf(**dict(STREAM, weight_fmt=JGGMLType[fmt], **kw))


def _standard(buf, q4):
    hp, w = load_weights(GGUFFile(buf), mode="packed-q4" if q4 else "packed-serve")
    w = fuse_projections(w)
    return hp, dataclasses.replace(w, layers=stack_layers(w.layers))


def _f32_scales(w):
    """``w`` with its raw f16 scale planes widened to dense f32: the same
    numbers in the layout of an f32 load."""
    lw = w.layers
    return dataclasses.replace(w, layers=dataclasses.replace(lw, **{
        f: dataclasses.replace(t, scale=t.scale.float()) for f in PARTS
        if (t := getattr(lw, f)).scale.dtype == torch.float16}))


def _capacity_threads():
    return [t for t in threading.enumerate() if t.name.startswith(CAPACITY_THREAD)]


# -- the capacity load ----------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("q4", [False, True])
def test_capacity_load_is_bit_equal(fmt, q4):
    buf = _stream_buf(fmt)
    hp, w = load_capacity_stacked(GGUFFile(buf), q4=q4, device="cpu")
    hp0, w0 = _standard(buf, q4)
    assert hp == hp0 and not _capacity_threads()
    nibble = q4 and fmt in ("Q4_0", "Q4_K")
    for f in PARTS:  # centered nibbles without offsets keep the checkpoint's f16 d
        s = getattr(w.layers, f).scale
        assert is_f16_scale_plane(s) if q4 and fmt == "Q4_0" else s.dtype == torch.float32, f
    w = _f32_scales(w)
    for f in PARTS:
        got, want = getattr(w.layers, f), getattr(w0.layers, f)
        assert type(got) is type(want) is (Q4Tensor if nibble else QuantTensor), f
        assert dataclasses.replace(got, **{k: None for k in ("q", "packed", "scale", "offset")
                                           if hasattr(got, k)}) == \
            dataclasses.replace(want, **{k: None for k in ("q", "packed", "scale", "offset")
                                         if hasattr(want, k)}), f
        for k in ("q", "packed", "scale", "offset"):
            a, b = getattr(got, k, None), getattr(want, k, None)
            assert (a is None) == (b is None), (f, k)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), (f, k)
    for f in NORMS:
        assert torch.equal(getattr(w.layers, f), getattr(w0.layers, f)), f
    assert torch.equal(w.token_embd.w, w0.token_embd.w)
    assert torch.equal(w.output_norm, w0.output_norm)
    # the JAX capacity load, carried across, dequantizes to the same values
    jhp, jw = load_maskdot_stacked(JGGUFFile(buf), q4=q4)
    _, wj = from_jax_arrays(dataclasses.asdict(jhp), _flatten(jw))
    for f in PARTS:
        got, want = getattr(w.layers, f), getattr(wj.layers, f)
        assert type(got) is type(want), f
        assert torch.equal(got.dequant(), want.dequant()), f
    assert torch.equal(w.token_embd.w, wj.token_embd.w)


def _splice(base: bytes, other: bytes, layer: int) -> bytes:
    """``base`` with layer ``layer``'s tensors taken from ``other``."""
    a, b = JGGUFFile(base), JGGUFFile(other)
    w = JGGUFWriter()
    for key, value in a.metadata.items():
        w.add_metadata(key, value)
    b_infos = {i.name: i for i in b.tensor_infos}
    for info in a.tensor_infos:
        src, f = (b, b_infos[info.name]) if info.name.startswith(f"blk.{layer}.") else (a, info)
        w.add_tensor(info.name, np.asarray(src.tensor_bytes(f)), f.tensor_type,
                     shape=f.shape, raw=True)
    return w.build()


def test_capacity_load_refuses_and_joins_its_thread():
    """A layer in another format (layer 2 of 4: the producer is decoding
    layer 3 when the loader refuses), a missing tensor and a gemma4
    checkpoint give None (the caller takes the standard load), and no
    producer thread outlives the call."""
    mixed = _splice(_stream_buf("Q4_0", n_layers=4), _stream_buf("Q8_0", n_layers=4), layer=2)
    g = GGUFFile(mixed)
    assert not fds.stream_supported_from_directory(g, load_hparams(g.metadata), q4=True,
                                                   max_seq=64)
    for q4 in (False, True):
        assert load_capacity_stacked(GGUFFile(mixed), q4=q4, device="cpu") is None
        assert not _capacity_threads()
    # the standard load still takes it (per-layer formats)
    assert len(load_weights(GGUFFile(mixed), mode="packed-serve")[1].layers) == 4
    a = JGGUFFile(_stream_buf())
    w = JGGUFWriter()
    for key, value in a.metadata.items():
        w.add_metadata(key, value)
    for info in a.tensor_infos:
        if info.name != "blk.1.ffn_up.weight":
            w.add_tensor(info.name, np.asarray(a.tensor_bytes(info)), info.tensor_type,
                         shape=info.shape, raw=True)
    assert load_capacity_stacked(GGUFFile(w.build()), q4=True, device="cpu") is None
    assert load_capacity_stacked(GGUFFile(build_gemma4_gguf()), q4=True, device="cpu") is None
    assert not _capacity_threads()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("q4", [False, True])
def test_layer_bytes_estimate_matches_jax(fmt, q4):
    buf = _stream_buf(fmt)
    est = layer_bytes_estimate(GGUFFile(buf), q4=q4)
    assert est == maskdot_layer_bytes_estimate(JGGUFFile(buf), q4=q4)
    _, w = load_capacity_stacked(GGUFFile(buf), q4=q4, device="cpu")

    def layer0(w):
        return sum(getattr(t, k).numel() * getattr(t, k).element_size()
                   for t in (weight_layer(getattr(w.layers, f), 0) for f in PARTS)
                   for k in ("q", "packed", "scale", "offset") if getattr(t, k, None) is not None)

    assert est == layer0(_f32_scales(w))  # JAX's estimate counts f32 scales
    assert layer0(w) < est if q4 and fmt == "Q4_0" else layer0(w) == est


# -- eligibility ------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("q4", [False, True])
def test_directory_precheck_agrees_with_postload(fmt, q4):
    buf = _stream_buf(fmt)
    g = GGUFFile(buf)
    hp = load_hparams(g.metadata)
    pre = fds.stream_supported_from_directory(g, hp, q4=q4, max_seq=64)
    hp2, w = load_capacity_stacked(GGUFFile(buf), q4=q4, device="cpu")
    post = fds.decode_stream_supported(hp2, w, max_seq=64)
    assert pre == post == True  # noqa: E712
    # a cache past the kernel's int32 positions is refused by both
    assert not fds.stream_supported_from_directory(g, hp, q4=q4, max_seq=1 << 31)
    assert not fds.decode_stream_supported(hp2, w, max_seq=1 << 31)
    # the JAX package agrees on its own loads
    jg = JGGUFFile(buf)
    assert jfds.stream_supported_from_directory(jg, hp, q4=q4, max_seq=64)


def _directory(geom: dict, fmt: GGMLType, vocab: int = 262144):
    """A GGUF tensor directory (names, shapes, formats; no data) and the
    hparams of a Gemma-3 geometry."""
    L, D, F = geom["n_layers"], geom["n_embd"], geom["n_ff"]
    H, Hkv, hd = geom["n_head"], geom["n_head_kv"], geom["head_dim"]
    infos = [TensorInfo("token_embd.weight", (D, vocab), GGMLType.F16, 0),
             TensorInfo("output_norm.weight", (D,), GGMLType.F32, 0)]
    for l in range(L):
        p = f"blk.{l}."
        for name, shape, t in (("attn_q", (D, H * hd), fmt), ("attn_k", (D, Hkv * hd), fmt),
                               ("attn_v", (D, Hkv * hd), fmt), ("attn_output", (H * hd, D), fmt),
                               ("ffn_gate", (D, F), fmt), ("ffn_up", (D, F), fmt),
                               ("ffn_down", (F, D), fmt), ("attn_q_norm", (hd,), GGMLType.F32),
                               ("attn_k_norm", (hd,), GGMLType.F32),
                               ("attn_norm", (D,), GGMLType.F32), ("ffn_norm", (D,), GGMLType.F32)):
            infos.append(TensorInfo(p + name + ".weight", shape, t, 0))
    hp = load_hparams({
        "general.architecture": "gemma3", "gemma3.block_count": L,
        "gemma3.embedding_length": D, "gemma3.feed_forward_length": F,
        "gemma3.attention.head_count": H, "gemma3.attention.head_count_kv": Hkv,
        "gemma3.attention.layer_norm_rms_epsilon": 1e-6, "gemma3.rope.freq_base": 1e6,
        "gemma3.attention.key_length": hd, "gemma3.attention.value_length": hd,
        "tokenizer.ggml.tokens": ["t"] * vocab})
    return type("Directory", (), {"tensor_infos": infos})(), hp


# the real Gemma-3 geometries (tools/capacity_demo.py GEOMS, the model cards)
GEOMETRIES = {
    "1b": dict(n_layers=26, n_embd=1152, n_ff=6912, n_head=4, n_head_kv=1, head_dim=256),
    "4b": dict(n_layers=34, n_embd=2560, n_ff=10240, n_head=8, n_head_kv=4, head_dim=256),
    "12b": dict(n_layers=48, n_embd=3840, n_ff=15360, n_head=16, n_head_kv=8, head_dim=256),
    "27b": dict(n_layers=62, n_embd=5376, n_ff=21504, n_head=32, n_head_kv=16, head_dim=128),
}


@pytest.mark.parametrize("geom", ["1b", "4b", "12b", "27b"])
@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_K", "Q6_K"])
@pytest.mark.parametrize("q4", [False, True])
def test_real_geometries_from_the_directory(geom, fmt, q4):
    """The 4B, 12B and 27B geometries take the capacity step and not the
    whole-layer one, decided from a tensor directory with no data; the 1B
    takes both (the engine then keeps the whole-layer step)."""
    d, hp = _directory(GEOMETRIES[geom], GGMLType[fmt])
    assert fds.stream_supported_from_directory(d, hp, q4=q4, max_seq=8192)
    g = fds.directory_geometry(d, hp, q4=q4, layers=1)
    assert fused_decode_q.whole_step_fits(hp, **g) == (geom == "1b")


# -- the capacity step's plain twin against the JAX kernel ------------------------------


def _windows(L: int, on: bool) -> np.ndarray:
    return np.array([8 if on and l != 1 else 0 for l in range(L)], dtype=np.int32)


@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_K"])
@pytest.mark.parametrize("q4", [False, True])
@pytest.mark.parametrize("window", [False, True])
def test_plain_stream_step_matches_jax_interpret(fmt, q4, window, monkeypatch):
    """One step at position 20 over seeded K/V rows 0..19: the JAX streamed
    kernel in interpret mode (several tiles a part: _TILE_TARGET at 80 KB)
    against ``decode_step_stream_plain`` on the same weights (carried across
    by ``from_jax_arrays``) and the same flat cache (by reshape)."""
    monkeypatch.setattr(jfds, "_TILE_TARGET", 80 * 1024)
    buf = _stream_buf(fmt)
    jhp, jw = load_maskdot_stacked(JGGUFFile(buf), q4=q4)
    plans = jfds._plan([jw.layers.wqkv, jw.layers.wo, jw.layers.w_gate_up, jw.layers.w_down])
    assert max(m["nt"] for m in plans) > 1  # the JAX kernel streams several tiles
    hp, w = from_jax_arrays(dataclasses.asdict(jhp), _flatten(jw))
    L, S, pos, tok = jhp.block_count, 64, 20, 9
    rng = np.random.default_rng(11)
    k = (rng.standard_normal((L, S, 2 * 128)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((L, S, 2 * 128)) * 0.5).astype(np.float32)
    k[:, pos:] = v[:, pos:] = 0.0
    jcache = jax_init_cache(jhp, S, stacked=True, flat=True, dtype=jnp.bfloat16)
    jcache = dataclasses.replace(jcache, k=jnp.asarray(k, dtype=jnp.bfloat16),
                                 v=jnp.asarray(v, dtype=jnp.bfloat16))
    wins = _windows(L, window)
    ref, kc, vc = jfds.decode_step_megakernel_stream(jhp, jw, jcache, jnp.int32(tok),
                                                     jnp.int32(pos), windows=wins,
                                                     interpret=True)
    cache = gemma.init_cache(hp, S, flat=True)
    cache.k.copy_(torch.from_numpy(np.array(jcache.k, dtype=np.float32)))
    cache.v.copy_(torch.from_numpy(np.array(jcache.v, dtype=np.float32)))
    consts = fds.prepare(hp, "cpu", swa_mask=False, max_seq=S)
    consts.windows = torch.from_numpy(wins)
    got = fds.decode_step_stream(hp, w, cache, torch.tensor([tok]),
                                 torch.tensor([pos], dtype=torch.int32), consts)
    assert fds.launches == 0  # the CPU runs the plain twin
    ref = np.asarray(ref)
    _close(got.numpy(), ref, 1.5e-2)
    assert int(got.argmax()) == int(ref.argmax())
    for ours, theirs in ((cache.k, kc), (cache.v, vc)):
        want = np.asarray(theirs, dtype=np.float32)
        row = ours[:, pos].float().numpy()
        assert np.all(np.abs(row - want[:, pos]) <= 2 ** -7 * np.abs(want[:, pos]) + 1e-6)
        np.testing.assert_array_equal(ours[:, :pos].float().numpy(), want[:, :pos])


# -- the Engine ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stream_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("capacity") / "m.gguf"
    path.write_bytes(_stream_buf("Q4_0"))
    return str(path)


def _no_stop(engine):
    engine.tokenizer.eos_id = -1
    engine.tokenizer.end_of_turn_id = -1
    return engine


@pytest.mark.parametrize("mode", ["serve-q", "serve-q4"])
def test_capacity_engine_matches_jax_engine(stream_path, mode, monkeypatch):
    """Under LLMI_FORCE_CAPACITY=1 both engines take their capacity paths;
    the port's 8-token stream equals the JAX one (its streamed kernel in
    interpret mode), and the flat cache holds what the prefill wrote."""
    monkeypatch.setenv("LLMI_FORCE_CAPACITY", "1")
    monkeypatch.setenv("LLMI_FUSED_INTERPRET", "1")
    prompt = [2, 40, 41, 42, 43]
    ref = _no_stop(JEngine(stream_path, max_seq=64, mode=mode, decode_chunk=4))
    assert ref._capacity
    want = ref.generate_from_ids(prompt, n_predict=8)
    eng = _no_stop(Engine(stream_path, max_seq=64, mode=mode, decode_chunk=4, device="cpu"))
    assert eng.decode_route == "capacity"
    assert isinstance(eng.weights.layers.wqkv, Q4Tensor if mode == "serve-q4" else QuantTensor)
    assert eng._prefill_w is eng.weights  # no bf16 operand cache
    cache = eng.new_cache()
    assert cache.k.shape == (3, 64, 256)
    assert eng.generate_from_ids(prompt, n_predict=8) == want
    # the flat cache's rows are the 4-D cache's bytes: the standard route's
    # prefill writes the same K/V
    monkeypatch.delenv("LLMI_FORCE_CAPACITY")
    std = Engine(stream_path, max_seq=64, mode=mode, decode_chunk=4, device="cpu")
    c4 = std.new_cache()
    gemma.forward(std.hparams, std._prefill_w, c4, torch.tensor(prompt), 0)
    gemma.forward(eng.hparams, eng._prefill_w, cache, torch.tensor(prompt), 0)
    _close(cache.k.view(c4.k.shape).float().numpy(), c4.k.float().numpy(), 2e-2)


def test_wide_checkpoint_takes_the_capacity_route(tmp_path):
    """D = 2048 is past the whole-layer step's 1536 columns: serve-q and
    serve-q4 take the capacity route with no variable set, and give the
    per-op route's stream."""
    path = tmp_path / "wide.gguf"
    path.write_bytes(build_gemma3_gguf(n_layers=1, n_embd=2048, n_ff=256, n_head=2, n_head_kv=1,
                                       head_dim=128, vocab=VOCAB, weight_fmt=JGGMLType.Q4_K))
    for mode in ("serve-q", "serve-q4"):
        eng = _no_stop(Engine(str(path), max_seq=64, mode=mode, decode_chunk=4, device="cpu"))
        assert eng.decode_route == "capacity"
        got = eng.generate_from_ids([2, 7, 8], n_predict=6)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("LLMI_NO_FUSED_DECODE", "1")
            per_op = _no_stop(Engine(str(path), max_seq=64, mode=mode, decode_chunk=4,
                                     device="cpu"))
        assert per_op.decode_route == "per-op"
        assert got == per_op.generate_from_ids([2, 7, 8], n_predict=6)


def test_capacity_gate_and_dispatch(stream_path, monkeypatch):
    """LLMI_FORCE_CAPACITY=1 turns the lossless whole step's gate off (the
    capacity step takes the token); LLMI_NO_FUSED_DECODE=1 turns both off;
    a flat cache reaches only the capacity step."""
    hp, w = _standard(_stream_buf(), q4=True)
    assert gemma.decode_q_enabled(hp, w) and gemma.decode_stream_enabled(hp, w, max_seq=64)
    monkeypatch.setenv("LLMI_FORCE_CAPACITY", "1")
    assert not gemma.decode_q_enabled(hp, w) and gemma.decode_stream_enabled(hp, w)
    monkeypatch.setenv("LLMI_NO_FUSED_DECODE", "1")
    assert not gemma.decode_stream_enabled(hp, w)
    monkeypatch.delenv("LLMI_NO_FUSED_DECODE")
    monkeypatch.delenv("LLMI_FORCE_CAPACITY")
    calls = []
    real = fds.decode_step_stream_plain
    monkeypatch.setattr(fds, "decode_step_stream_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for flat in (False, True):
        cache = gemma.init_cache(hp, 64, flat=flat)
        gemma.forward(hp, w, cache, torch.tensor([2, 7, 8]), 0)
        gemma.forward(hp, w, cache, torch.tensor([9]), torch.tensor([3]))
    assert len(calls) == 1  # the 4-D cache took the whole-layer step, the flat one this
