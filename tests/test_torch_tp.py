"""The port's tensor-parallel decode (``Engine(tp_mesh=...)``) on the CPU against llm_inference_tpu.

Meshes of repeated CPU devices (``make_mesh(model=n, devices=[cpu] * n)``,
the counterpart of the JAX tests' virtual 8-device mesh) run the
tensor-parallel steps' plain twins. Bars: the mesh and its refusals as the
JAX ``make_mesh``'s; the rowq8 shards bit-equal to the JAX package's
``shard_rowq8_for_tp`` (zero padding included); the lossless shards
concatenating back to the unsharded parts bit-equal; the eligibility gates
equal to the JAX gates on the fixtures for n in {1, 2, 3, 4} (where the
JAX lossless gate asks whole masked-dot blocks of Wo's and w_down's
contraction shards, the port's asks whole groups: the JAX package picks its
block size per shard count, and on these fixtures both agree); the TP
twins against the single-chip twins over four steps at the JAX tests'
rtol = atol = 2e-5, every cache replica equal to the single-chip cache;
``Engine(tp_mesh=...)`` streams identical to the single-device kernel
route's and to the JAX ``Engine``'s; the JAX engine's refusals, and gemma4
(the JAX TP gate admits a gemma4 stack its kernel cannot run: ROADMAP.md
section 3)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from llm_inference_tpu.engine import Engine as JEngine
from llm_inference_tpu.gguf import GGMLType as JGGMLType
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.models import load_weights as jax_load_weights
from llm_inference_tpu.models.weights import fuse_projections as jax_fuse
from llm_inference_tpu.models.weights import maskdot_layers as jax_maskdot
from llm_inference_tpu.models.weights import stack_layers as jax_stack
from llm_inference_tpu.models.weights import stack_layers_gemma4 as jax_stack_g4
from llm_inference_tpu.ops.pallas.fused_decode_q_tp import tp_megakernel_q_supported
from llm_inference_tpu.ops.pallas.fused_decode_tp import (shard_rowq8_for_tp as jax_shard,
                                                          tp_megakernel_supported)
from llm_inference_tpu.parallel import make_mesh as jax_make_mesh
from llm_inference_tpu_torch.engine import Engine
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.models.weights import (fuse_projections, load_weights, stack_layers,
                                                    stack_layers_gemma4)
from llm_inference_tpu_torch.ops.kernels import (fused_decode, fused_decode_q, fused_decode_q_tp,
                                                 fused_decode_tp)
from llm_inference_tpu_torch.parallel import gemma_sharding_fn, kv_cache_sharding, make_mesh

from fixtures import build_gemma3_gguf, build_gemma4_gguf
from test_torch_lossless import _checkpoint
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

VOCAB = [f"t{i}" for i in range(512)]
VOCAB[1], VOCAB[2], VOCAB[3] = "<eos>", "<bos>", "<unk>"
# the JAX TP kernels' test geometry (tests/test_fused_decode_tp.py:32-40)
TP_GEOM = dict(n_layers=2, n_embd=256, n_ff=512, n_head=4, n_head_kv=1, head_dim=128,
               vocab=[f"t{i}" for i in range(512)], seed=21)
MODES = {"serve-q8": "rowq8", "serve-q": "packed-serve", "serve-q4": "packed-q4"}
CPU = torch.device("cpu")


def _cpu_mesh(n):
    return make_mesh(model=n, devices=[CPU] * n)


def _port(buf, load_mode):
    hp, w = load_weights(GGUFFile(buf), mode=load_mode)
    w = fuse_projections(w)
    return hp, dataclasses.replace(w, layers=stack_layers(w.layers))


def _jax(buf, load_mode):
    hp, w = jax_load_weights(JGGUFFile(buf), mode=load_mode)
    w = jax_fuse(w)
    return hp, dataclasses.replace(w, layers=jax_stack(w.layers))


def _no_stop(engine):
    engine.tokenizer.eos_id = -1
    engine.tokenizer.end_of_turn_id = -1
    return engine


# -- the mesh ----------------------------------------------------------------------


@pytest.mark.parametrize("model,data,n_dev", [(2, 1, 2), (4, 1, 4), (None, 1, 4), (None, 2, 4),
                                              (2, 2, 4)])
def test_make_mesh_shapes_match_jax(model, data, n_dev):
    got = make_mesh(model, data, devices=[CPU] * n_dev)
    want = jax_make_mesh(model, data, devices=jax.devices()[:n_dev])
    assert got.shape == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    assert got.model_devices == [CPU] * got.shape["model"]


@pytest.mark.parametrize("model,data,n_dev", [(3, 1, 2), (2, 2, 3), (8, 1, 4)])
def test_make_mesh_refusals_match_jax(model, data, n_dev):
    with pytest.raises(ValueError) as got:
        make_mesh(model, data, devices=[CPU] * n_dev)
    with pytest.raises(ValueError) as want:
        jax_make_mesh(model, data, devices=jax.devices()[:n_dev])
    assert str(got.value) == str(want.value)


# -- shards --------------------------------------------------------------------------


@pytest.mark.parametrize("n_ff,n", [(512, 2), (512, 4), (640, 2), (640, 4)])
def test_rowq8_shards_bit_equal_to_jax(n_ff, n):
    """n_ff 640: F / n of 320 and 160 zero-padded to 384 and 256 rows."""
    buf = build_gemma3_gguf(**{**TP_GEOM, "n_ff": n_ff})
    hp, w = _port(buf, "rowq8")
    jhp, jw = _jax(buf, "rowq8")
    assert fused_decode_tp.tp_decode_supported(hp, w, n) and tp_megakernel_supported(jhp, jw, n)
    packed, geom = jax_shard(jhp, jw, n)
    tw = fused_decode_tp.shard_rowq8_for_tp(hp, w, n)
    assert tw.geom == geom and (n_ff == 512) == (geom["Flp"] == geom["Fl"])
    for r, rw in enumerate(tw.ranks):
        lw = rw.layers
        pairs = [(lw.wqkv.q, packed["wqkv_q"][r]), (lw.wqkv.scale[..., 0], packed["wqkv_s"][r, :, 0]),
                 (lw.wo.q, packed["wo_q"][r]), (lw.wo.scale[..., 0], packed["wo_s"][r, :, 0]),
                 (lw.w_gate_up.q, packed["gu_q"][r]),
                 (lw.w_gate_up.scale[..., 0], packed["gu_s"][r, :, 0]),
                 (lw.w_down.q, packed["wd_q"][r]), (lw.w_down.scale[..., 0], packed["wd_s"][r, :, 0]),
                 (rw.token_embd.q, packed["emb_q"][r]),
                 (rw.token_embd.scale[:, 0], packed["emb_s"][r, 0])]
        for got, want in pairs:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _data(t):
    return t.packed if hasattr(t, "packed") else t.q


@pytest.mark.parametrize("fmt,mode", [("Q4_0", "serve-q"), ("Q4_0", "serve-q4"),
                                      ("Q4_K", "serve-q"), ("Q4_K", "serve-q4")])
@pytest.mark.parametrize("n", [2, 4])
def test_lossless_shards_concatenate_back(fmt, mode, n):
    buf = build_gemma3_gguf(**TP_GEOM, weight_fmt=JGGMLType[fmt])
    hp, w = _port(buf, MODES[mode])
    assert fused_decode_q_tp.tp_decode_q_supported(hp, w, n)
    tw = fused_decode_q_tp.shard_lossless_for_tp(hp, w, n)
    lw, ranks = w.layers, [rw.layers for rw in tw.ranks]
    H, dk = hp.n_head, hp.n_embd_head_k
    Hl, F = H // n, lw.w_down.cols
    fields = ["scale"] + (["offset"] if lw.wqkv.offset is not None else [])
    assert (fmt == "Q4_K") == (lw.wqkv.offset is not None)
    assert (mode == "serve-q4") == hasattr(lw.wqkv, "packed")

    def arrays(t):
        return [_data(t)] + [getattr(t, f) for f in fields]

    for whole, parts in zip(arrays(lw.wqkv), zip(*[arrays(r.wqkv) for r in ranks])):
        assert torch.equal(torch.cat([p[:, : Hl * dk] for p in parts], 1), whole[:, : H * dk])
        for p in parts:  # every rank holds every K/V row
            assert torch.equal(p[:, Hl * dk :], whole[:, H * dk :])
    for name in ("wo", "w_down"):  # contraction shards: whole groups, their scales with them
        for whole, parts in zip(arrays(getattr(lw, name)),
                                zip(*[arrays(getattr(r, name)) for r in ranks])):
            assert torch.equal(torch.cat(parts, -1), whole)
    for whole, parts in zip(arrays(lw.w_gate_up), zip(*[arrays(r.w_gate_up) for r in ranks])):
        half = parts[0].shape[1] // 2
        assert torch.equal(torch.cat([p[:, :half] for p in parts], 1), whole[:, :F])
        assert torch.equal(torch.cat([p[:, half:] for p in parts], 1), whole[:, F:])
    assert torch.equal(torch.cat([rw.token_embd.w for rw in tw.ranks]), w.token_embd.w)


# -- gates ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_rowq8_gate_matches_jax(n):
    buf = build_gemma3_gguf(**TP_GEOM)
    hp, w = _port(buf, "rowq8")
    jhp, jw = _jax(buf, "rowq8")
    assert fused_decode_tp.tp_decode_supported(hp, w, n) == tp_megakernel_supported(jhp, jw, n)
    assert fused_decode_tp.tp_decode_supported(hp, w, n) == (n in (2, 4))


@pytest.mark.parametrize("fmt,mode", [("Q4_0", "serve-q"), ("Q4_0", "serve-q4"),
                                      ("Q4_K", "serve-q4")])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_lossless_gate_matches_jax(fmt, mode, n):
    buf = build_gemma3_gguf(**TP_GEOM, weight_fmt=JGGMLType[fmt])
    hp, w = _port(buf, MODES[mode])
    jhp, jw = _jax(buf, MODES[mode])
    jmd = jax_maskdot(jw, q4=mode == "serve-q4", shard=max(n, 1))
    want = jmd is not None and tp_megakernel_q_supported(jhp, jmd, n)
    assert fused_decode_q_tp.tp_decode_q_supported(hp, w, n) == want == (n in (2, 4))


def test_gemma4_gate_is_the_reference_fault():
    """The JAX TP gate admits a gemma4 stack (fused_decode_tp.py:76 through
    megakernel_supported) though _run_step_tp has none of gemma4's
    features; the port refuses it (tests/test_fused_decode.py's
    _gemma4_model geometry)."""
    buf = build_gemma4_gguf(n_layers=4, n_embd=512, n_ff=512, n_head=4, n_head_kv=2,
                            n_embd_per_layer=128, shared_kv_layers=1,
                            vocab=[f"t{i}" for i in range(256)])
    jhp, jw = jax_load_weights(JGGUFFile(buf), mode="rowq8")
    assert tp_megakernel_supported(jhp, jax_stack_g4(jhp, jax_fuse(jw)), 2)
    hp, w = load_weights(GGUFFile(buf), mode="rowq8")
    g4 = stack_layers_gemma4(hp, fuse_projections(w))
    assert fused_decode.decode_supported(hp, g4)  # the single-chip step takes it
    assert not fused_decode_tp.tp_decode_supported(hp, g4, 2)


# -- the plain twins -----------------------------------------------------------------


@pytest.mark.parametrize("fmt,mode", [("Q4_0", "serve-q8"), ("Q4_0", "serve-q"),
                                      ("Q4_0", "serve-q4"), ("Q4_K", "serve-q4")])
@pytest.mark.parametrize("n", [2, 4])
def test_tp_twin_matches_single_chip_twin(fmt, mode, n):
    """JAX's tokens and positions (tests/test_fused_decode_tp.py:58-91)."""
    hp, w = _port(build_gemma3_gguf(**TP_GEOM, weight_fmt=JGGMLType[fmt]), MODES[mode])
    q8 = mode == "serve-q8"
    single, tp = (fused_decode, fused_decode_tp) if q8 else (fused_decode_q, fused_decode_q_tp)
    plain1 = fused_decode.decode_step_plain if q8 else fused_decode_q.decode_step_q_plain
    plain_n = fused_decode_tp.decode_step_tp_plain if q8 else \
        fused_decode_q_tp.decode_step_q_tp_plain
    mesh = _cpu_mesh(n)
    tw = tp.shard_for_tp(hp, w, n, mesh.model_devices)
    c1 = single.prepare(hp, CPU, swa_mask=False, max_seq=32)
    cn = tp.prepare(hp, tw, swa_mask=False, max_seq=32)
    cache = gemma.init_cache(hp, 32)
    caches = [gemma.init_cache(hp, 32) for _ in range(n)]
    for tok, pos in zip([2, 7, 150, 511], [3, 4, 5, 6]):
        t, p = torch.tensor([tok]), torch.tensor([pos], dtype=torch.int32)
        want = plain1(hp, w, cache, t, p, c1)
        got = plain_n(hp, tw, caches, t, p, cn)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    for c in caches:
        assert torch.equal(c.k, cache.k) and torch.equal(c.v, cache.v)


def test_planted_fault_leaves_the_bar():
    """A rank's partial left out of one layer's all-reduce (its Wo scales
    zeroed) moves the twin's logits past the kernels' 1.5e-2 bar, as
    chip_smoke.py's phase 17 requires on the card."""
    hp, w = _port(build_gemma3_gguf(**TP_GEOM), "rowq8")
    tw = fused_decode_tp.shard_rowq8_for_tp(hp, w, 2)
    consts = fused_decode_tp.prepare(hp, tw, swa_mask=False, max_seq=32)
    t, p = torch.tensor([7]), torch.tensor([4], dtype=torch.int32)
    ref = fused_decode_tp.decode_step_tp_plain(
        hp, tw, [gemma.init_cache(hp, 32) for _ in range(2)], t, p, consts)
    rw = tw.ranks[1]
    wo = dataclasses.replace(rw.layers.wo, scale=rw.layers.wo.scale.clone())
    wo.scale[1].zero_()
    bad = dataclasses.replace(tw, ranks=[tw.ranks[0], dataclasses.replace(
        rw, layers=dataclasses.replace(rw.layers, wo=wo))])
    got = fused_decode_tp.decode_step_tp_plain(
        hp, bad, [gemma.init_cache(hp, 32) for _ in range(2)], t, p, consts)
    assert (got - ref).abs().max() > 1.5e-2 * max(1.0, ref.abs().max())


# -- the engine ----------------------------------------------------------------------


# (checkpoint, mode, n): test_torch_lossless_engine.py's wide fixtures
# (weight_std 0.15 without post norms: streams that wander), "q4_k" that file's
# own, "q4_0" with a 512-token vocabulary (a 4-way shard needs V / 4 a
# multiple of 128). The single-device kernel routes round as the whole steps
# do, which can flip a near tie against the JAX per-op stream (that file's
# note; with this 512-token vocabulary, seeds 7-11 flip in 1, 4 and 5 of the
# five in serve-q8, serve-q and serve-q4 on Q4_K, and 2, 1 and 1 on Q4_0):
# every case holds the TP stream to the single-device kernel route's, and
# these fixtures, whose kernel routes give the JAX stream, to JAX's too.
ENGINE_CASES = [("q4_0", "serve-q8", 2), ("q4_0", "serve-q8", 4), ("q4_0", "serve-q", 2),
                ("q4_0", "serve-q4", 2), ("q4_k", "serve-q", 2), ("q4_k", "serve-q4", 2)]
PROMPT, N_PREDICT = [2, 40, 41, 42, 43], 12
_JAX_STREAMS = {}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    wide = dict(n_layers=3, n_embd=256, n_ff=512, n_head=4, n_head_kv=2, head_dim=128,
                vocab=VOCAB)
    out = {}
    for name, buf in {
        "q4_0": build_gemma3_gguf(weight_fmt=JGGMLType.Q4_0, weight_std=0.15, seed=7, **wide),
        "q4_k": _checkpoint("Q4_K", weight_std=0.15, seed=7),
        "gemma4": build_gemma4_gguf(n_layers=4, n_embd=512, n_ff=512, n_head=4, n_head_kv=2,
                                    n_embd_per_layer=128, shared_kv_layers=1,
                                    vocab=[f"t{i}" for i in range(256)]),
    }.items():
        (d / f"{name}.gguf").write_bytes(buf)
        out[name] = str(d / f"{name}.gguf")
    return out


def _jax_stream(path, mode):
    if (path, mode) not in _JAX_STREAMS:
        ref = _no_stop(JEngine(path, max_seq=128, mode=mode, decode_chunk=4))
        _JAX_STREAMS[(path, mode)] = ref.generate_from_ids(PROMPT, n_predict=N_PREDICT)
    return _JAX_STREAMS[(path, mode)]


@pytest.mark.parametrize("name,mode,n", ENGINE_CASES)
def test_tp_engine_streams_match(paths, name, mode, n):
    single = _no_stop(Engine(paths[name], max_seq=128, mode=mode, decode_chunk=4, device="cpu"))
    assert single.decode_route == "kernel"
    eng = _no_stop(Engine(paths[name], max_seq=128, mode=mode, decode_chunk=4, device="cpu",
                          tp_mesh=_cpu_mesh(n)))
    assert eng.decode_route == "tp" and eng._tp.n == n and eng.device == CPU
    assert eng._prefill_w is eng.weights  # no bf16 operand cache on the TP route, as in JAX
    out = eng.generate_from_ids(PROMPT, n_predict=N_PREDICT)
    assert out == single.generate_from_ids(PROMPT, n_predict=N_PREDICT)
    assert out == _jax_stream(paths[name], mode)
    assert len(set(out)) > 1  # the stream wanders


def test_tp_engine_refusals(paths, monkeypatch):
    """The JAX engine's refusals (engine.py:83-114, :300-337), each where
    the JAX engine raises it too, and the port's own: gemma4. ``sharding_fn``
    and ``cache_sharding`` alone are accepted, on the per-op route."""
    jmesh = jax_make_mesh(2, devices=jax.devices()[:2])
    mesh = _cpu_mesh(2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        Engine(paths["q4_0"], max_seq=64, mode="serve-q8", device="cpu", tp_mesh=mesh,
               sharding_fn=lambda *a: a)
    with pytest.raises(ValueError, match="mutually exclusive"):
        JEngine(paths["q4_0"], max_seq=64, mode="serve-q8", tp_mesh=jmesh, sharding_fn=lambda *a: a)
    for mode in ("parity", "serve"):
        with pytest.raises(ValueError, match="tp_mesh requires mode"):
            Engine(paths["q4_0"], max_seq=64, mode=mode, device="cpu", tp_mesh=mesh)
        with pytest.raises(ValueError, match="tp_mesh requires mode"):
            JEngine(paths["q4_0"], max_seq=64, mode=mode, tp_mesh=jmesh)
    with pytest.raises(ValueError, match="not eligible"):  # 3 ranks cannot split 4 heads
        Engine(paths["q4_0"], max_seq=64, mode="serve-q8", device="cpu", tp_mesh=_cpu_mesh(3))
    with pytest.raises(ValueError, match="not eligible"):
        JEngine(paths["q4_0"], max_seq=64, mode="serve-q8",
                tp_mesh=jax_make_mesh(3, devices=jax.devices()[:3]))
    with pytest.raises(ValueError, match="gemma4"):
        Engine(paths["gemma4"], max_seq=64, mode="serve-q8", device="cpu", tp_mesh=mesh)
    # the JAX engine's sharding_fn and cache_sharding, without tp_mesh, take the
    # per-op sharded route (tests/test_torch_sharding_serving.py holds its streams)
    assert Engine(paths["q4_0"], max_seq=64, device="cpu",
                  sharding_fn=gemma_sharding_fn(mesh)).decode_route == "sharded"
    eng = Engine(paths["q4_0"], max_seq=64, mode="serve-q8", device="cpu",
                 cache_sharding=kv_cache_sharding(mesh, 1))
    assert eng.decode_route == "kernel"  # one KV head: a whole cache, the whole step takes it
    assert isinstance(eng.new_cache(), gemma.KVCache)
    monkeypatch.setenv("LLMI_FORCE_CAPACITY", "1")  # the capacity route: JAX's `not self._capacity`
    assert Engine(paths["q4_0"], max_seq=64, mode="serve-q", device="cpu").decode_route == \
        "capacity"
    with pytest.raises(ValueError, match="not eligible"):
        Engine(paths["q4_0"], max_seq=64, mode="serve-q", device="cpu", tp_mesh=mesh)
