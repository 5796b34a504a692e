"""The port's parity mode, tracing and parity harness on the CPU against llm_inference_tpu.

Bars, each stated where it is checked:
  - bit-equal: ``f16_round`` and ``nearest_int``; the q8_0 and q8_K
    quantizers (d, q, bsums) and round trips, zero blocks and +-amax ties
    included; the ``bf16`` load's bytes and the ``packed`` load's exact f32
    dequant for Q4_0, Q4_K, Q5_0, Q6_K, Q8_0 and F16; every weight's
    ``act_quant``; ``parity.py``'s parsers and reports on the same dump text;
  - the exact ``matmul`` within 1e-6 of the output's max |y| (the same
    contracted activation and weight, only the f32 summation order differs);
  - ``_masked_scores(exact=True)`` and ``_attention_parity`` within 1e-5 on
    the same q, k and v, with windows, ALiBi and the attention softcap;
    ``LLMI_EXACT_F32_SCORES=1`` within 1e-6 (of max |score|) of the f64 scores;
  - the eager ``forward(exact=True)`` with tracing on: the same tap names in
    the same order, ``compare_sums`` at rel_tol 1e-3, logits within
    1.5e-2 * max(1, max |logits|) with equal argmax (tests/test_fused_decode.py's
    bar: a q8 round trip may flip one element by a step where the f32 sums'
    order differs);
  - greedy streams identical to the JAX ``Engine`` (gemma3 and gemma4) and
    ``BatchedServer`` (dense lanes) in the parity mode;
  - the refusals (paged parity, a stochastic sampler in parity), and the
    CLI's ``--trace`` .npz holding the eager forward's taps.
The exact matmul's TF32 refusal is a CUDA case (tests/test_torch_cuda.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_tpu import parity as jparity
from llm_inference_tpu import serving as jserving
from llm_inference_tpu import trace as jtrace
from llm_inference_tpu.engine import Engine as JEngine
from llm_inference_tpu.gguf import GGMLType
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.models import gemma as jgemma
from llm_inference_tpu.models import load_weights as jax_load_weights
from llm_inference_tpu.ops import actquant as jactquant
from llm_inference_tpu.ops import linear as jlinear
from llm_inference_tpu.ops import numerics as jnumerics
from llm_inference_tpu_torch import cli, parity, trace
from llm_inference_tpu_torch.engine import Engine
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.models.hparams import HParams
from llm_inference_tpu_torch.models.weights import from_jax_arrays, load_weights
from llm_inference_tpu_torch.ops import actquant, linear, numerics
from llm_inference_tpu_torch.sampling import SamplingConfig
from llm_inference_tpu_torch.serving import BatchedServer

from fixtures import build_gemma3_gguf, build_gemma4_gguf
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

FORMATS = [GGMLType.Q4_0, GGMLType.Q4_K, GGMLType.Q5_0, GGMLType.Q6_K, GGMLType.Q8_0,
           GGMLType.F16]
# Q4_K and Q6_K take 256-column blocks: every projection's columns are 256
WIDE = dict(n_layers=1, n_embd=256, n_ff=256, n_head=2, n_head_kv=1, head_dim=128)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    out = {}
    for name, buf in {
        "g3": build_gemma3_gguf(n_layers=2, with_post_norms=True),
        "g4": build_gemma4_gguf(n_layers=4, shared_kv_layers=1),
    }.items():
        (d / f"{name}.gguf").write_bytes(buf)
        out[name] = str(d / f"{name}.gguf")
    return out


def _no_stop(engine):
    engine.tokenizer.eos_id = -1
    engine.tokenizer.end_of_turn_id = -1
    return engine


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy()


# -- rounding points and activation quantizers ---------------------------------------


def test_f16_round_and_nearest_int_bit_equal():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 3,
        np.arange(-8, 8, 0.5, dtype=np.float32),           # ties of nearest_int
        np.array([65504, 65520, 7e4, -7e4, 1e-8, -6e-8, 3e-5, 0.0, -0.0], np.float32),
        (rng.standard_normal(256) * 1e-5).astype(np.float32),  # f16 subnormals
    ])
    got = _np(numerics.f16_round(torch.from_numpy(x)))
    want = np.asarray(jnumerics.f16_round(jnp.asarray(x)))
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    xi = x[np.abs(x) < 1e6]
    got = _np(numerics.nearest_int(torch.from_numpy(xi)))
    want = np.asarray(jnumerics.nearest_int(jnp.asarray(xi)))
    assert got.dtype == np.int32 and np.array_equal(got, want)


def _act_inputs() -> np.ndarray:
    """[6, 512] activations: random rows, a zero row (zero blocks), and rows
    whose largest |x| appears with both signs (the q8_K sign tie)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 512)).astype(np.float32)
    x[1] = 0.0
    x[2, 5], x[2, 9] = -4.0, 4.0      # -amax first in its block
    x[2, 300], x[2, 260] = 4.5, -4.5  # +amax later, -amax earlier
    x[3, :32] = 0.0                   # one zero q8_0 block
    x[4] *= 1e-3
    x[5, ::2] = 2.5                   # many equal maxima, and x * inv ties
    return x


def test_q8_0_quantizer_bit_equal():
    x = _act_inputs()
    d, q = actquant.quantize_q8_0(torch.from_numpy(x))
    jd, jq = jactquant.quantize_q8_0(jnp.asarray(x))
    assert _np(d).tobytes() == np.asarray(jd).tobytes()
    assert np.array_equal(_np(q), np.asarray(jq)) and q.dtype == torch.int32
    got = _np(actquant.roundtrip_q8_0(torch.from_numpy(x)))
    assert got.tobytes() == np.asarray(jactquant.roundtrip_q8_0(jnp.asarray(x))).tobytes()


def test_q8_k_quantizer_bit_equal():
    x = _act_inputs()
    d, q, bsums = actquant.quantize_q8_k(torch.from_numpy(x))
    jd, jq, jb = jactquant.quantize_q8_k(jnp.asarray(x))
    assert _np(d).tobytes() == np.asarray(jd).tobytes()
    assert np.array_equal(_np(q), np.asarray(jq)) and np.array_equal(_np(bsums), np.asarray(jb))
    got = _np(actquant.roundtrip_q8_k(torch.from_numpy(x)))
    assert got.tobytes() == np.asarray(jactquant.roundtrip_q8_k(jnp.asarray(x))).tobytes()
    assert (_np(q)[1] == 0).all() and (_np(d)[1] == 0).all()  # the zero row


# -- load modes, act_quant and the exact matmul -------------------------------------------


@pytest.fixture(scope="module")
def wide_loads(tmp_path_factory):
    """{fmt: (port bf16, JAX bf16, port packed, JAX packed)} of a one-layer
    checkpoint whose every matmul weight (the embedding too) is in fmt."""
    out = {}
    for fmt in FORMATS:
        buf = build_gemma3_gguf(weight_fmt=fmt, embd_fmt=fmt, **WIDE)
        out[fmt] = (load_weights(GGUFFile(buf), mode="bf16")[1],
                    jax_load_weights(JGGUFFile(buf), mode="bf16")[1],
                    load_weights(GGUFFile(buf), mode="packed")[1],
                    jax_load_weights(JGGUFFile(buf), mode="packed")[1])
    return out


def _weights(mw) -> dict:
    lw = mw.layers[0]
    return {"token_embd": mw.token_embd, **{f: getattr(lw, f) for f in (
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}}


def _flatten(tree, prefix="", keep_fmt=True):
    """A JAX ModelWeights as {field path: numpy array} (the test side of
    ``from_jax_arrays``)."""
    out = {}
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if f.name == "fmt":
                if keep_fmt:
                    out[prefix + "fmt"] = np.int32(int(v))
            elif f.name == "group_size":
                out[prefix + "group_size"] = np.int32(v)
            elif v is not None and f.name not in ("rows", "cols"):
                out.update(_flatten(v, f"{prefix}{f.name}.", keep_fmt))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}.", keep_fmt))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


@pytest.mark.parametrize("fmt", FORMATS, ids=[f.name for f in FORMATS])
def test_load_modes_and_act_quant_bit_equal(wide_loads, fmt):
    pb, jb, pp, jp = wide_loads[fmt]
    for name, w in _weights(pb).items():
        jw = _weights(jb)[name]
        assert w.w.dtype == torch.bfloat16 and w.fmt == GGMLType.BF16 == jw.fmt
        assert _np(w.w.view(torch.int16)).tobytes() == np.asarray(jw.w).view(np.int16).tobytes()
    for name, w in _weights(pp).items():
        jw = _weights(jp)[name]
        assert w.fmt == jw.fmt == fmt and w.act_quant == jw.act_quant, name
        assert _np(w.dequant(torch.float32)).tobytes() == \
            np.asarray(jw.dequant(jnp.float32)).tobytes(), name
    if fmt == GGMLType.F16:  # dense tensors keep their dtype in the packed mode
        assert pp.token_embd.w.dtype == torch.float16 and pp.token_embd.act_quant == "f16"
    # carried across: the contract survives, for a dense weight from its dtype alone
    for keep_fmt in (True, False):
        if not keep_fmt and fmt != GGMLType.F16:
            continue
        arrays = _flatten(jp, keep_fmt=keep_fmt)
        hp = dataclasses.asdict(jax_load_weights(JGGUFFile(build_gemma3_gguf(
            weight_fmt=fmt, embd_fmt=fmt, **WIDE)), mode="packed")[0])
        _, cw = from_jax_arrays(hp, arrays)
        for name, w in _weights(cw).items():
            assert w.act_quant == _weights(jp)[name].act_quant, (name, keep_fmt)


@pytest.mark.parametrize("fmt", FORMATS, ids=[f.name for f in FORMATS])
def test_exact_matmul_matches_jax(wide_loads, fmt):
    _, _, pp, jp = wide_loads[fmt]
    x = np.random.default_rng(2).standard_normal((3, 256)).astype(np.float32)
    for name, w in _weights(pp).items():
        jw = _weights(jp)[name]
        got = _np(linear.matmul(w, torch.from_numpy(x), exact=True))
        want = np.asarray(jlinear.matmul(jw, jnp.asarray(x), exact=True))
        # the same contracted x and exact W; only the f32 summation order differs
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max(), err_msg=name)
        xr = _np(linear.contract_activations(torch.from_numpy(x), w.act_quant))
        assert xr.tobytes() == np.asarray(jlinear.contract_activations(
            jnp.asarray(x), jw.act_quant)).tobytes()
    # a 1-D activation, as the logits take it
    y = linear.matmul(pp.token_embd, torch.from_numpy(x[0]), exact=True)
    assert y.shape == (pp.token_embd.rows,)


# -- attention ---------------------------------------------------------------------------


def _hps(path, **kw):
    jhp = jax_load_weights(JGGUFFile(path), mode="packed")[0]
    jhp = dataclasses.replace(jhp, **kw)
    d = dataclasses.asdict(jhp)
    d["swa_layers"] = tuple(bool(v) for v in d["swa_layers"])
    return HParams(**d), jhp


ATTN_CASES = {
    "decode": dict(T=1, pos=9, window=0, kw={}),
    "prefill_window": dict(T=4, pos=5, window=3, kw={}),
    "alibi": dict(T=3, pos=7, window=0, kw=dict(f_max_alibi_bias=8.0)),
    "softcap_window": dict(T=1, pos=12, window=5, kw=dict(attn_soft_cap=20.0)),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_parity_matches_jax(paths, case):
    c = ATTN_CASES[case]
    hp, jhp = _hps(paths["g3"], n_head=4, n_head_kv=2, **c["kw"])
    rng = np.random.default_rng(3)
    S, Dk, T = 16, 8, c["T"]
    q = rng.standard_normal((T, 4, Dk)).astype(np.float32)
    k = rng.standard_normal((S, 2, Dk)).astype(np.float16)
    v = rng.standard_normal((S, 2, Dk)).astype(np.float16)
    args = dict(pos=c["pos"], window=c["window"])
    s, valid = gemma._masked_scores(torch.from_numpy(q), torch.from_numpy(k), hp=hp, exact=True,
                                    **args)
    js, jvalid = jax.jit(lambda q, k, p: jgemma._masked_scores(
        q, k, hp=jhp, exact=True, pos=p, window=c["window"]))(
        jnp.asarray(q), jnp.asarray(k), jnp.int32(c["pos"]))
    assert np.array_equal(_np(valid), np.asarray(jvalid))
    np.testing.assert_allclose(_np(s), np.asarray(js), rtol=0, atol=1e-5)
    out = gemma._attention_parity(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  hp=hp, **args)
    jout = jax.jit(lambda q, k, v, p: jgemma._attention_parity(
        q, k, v, hp=jhp, pos=p, window=c["window"]))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(c["pos"]))
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=0, atol=1e-5)


def test_exact_f32_scores_env(paths, monkeypatch):
    hp, _ = _hps(paths["g3"])
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((3, 2, 16)).astype(np.float32) * 4)
    k = torch.from_numpy(rng.standard_normal((20, 1, 16)).astype(np.float16))
    f64, _ = gemma._masked_scores(q, k, pos=10, hp=hp, exact=True)
    monkeypatch.setenv("LLMI_EXACT_F32_SCORES", "1")
    f32, _ = gemma._masked_scores(q, k, pos=10, hp=hp, exact=True)
    fin = torch.isfinite(f64)
    assert torch.equal(fin, torch.isfinite(f32))
    # the same products summed in f32 instead of f64
    np.testing.assert_allclose(_np(f32[fin]), _np(f64[fin]), rtol=0,
                               atol=1e-6 * float(f64[fin].abs().max()))


# -- the eager forward with tracing on --------------------------------------------------


def _traced(fn):
    """(records, result) of ``fn()`` with the port's tracing on."""
    session = trace.enable_trace("unused.npz")
    try:
        return session.records, fn()
    finally:
        trace.disable_trace()


@pytest.mark.parametrize("name", ["g3", "g4"])
def test_eager_forward_taps_match_jax(paths, name):
    toks = [2, 7, 8, 9, 11]
    jhp, jw = jax_load_weights(JGGUFFile(paths[name]))  # the JAX default load: packed
    session = jtrace.enable_trace("unused.npz")
    try:
        jc = jgemma.init_cache(jhp, 16)
        jl, jc = jgemma.forward(jhp, jw, jc, jnp.asarray(toks[:4], dtype=jnp.int32), 0)
        jl2, _ = jgemma.forward(jhp, jw, jc, jnp.asarray(toks[4:], dtype=jnp.int32), 4)
    finally:
        jtrace.disable_trace()
    jrecs = session.records

    hp, w = load_weights(GGUFFile(paths[name]), mode="packed")

    def run():
        cache = gemma.init_cache(hp, 16, dtype=gemma.PARITY_KV_DTYPE)
        logits, cache = gemma.forward(hp, w, cache, torch.tensor(toks[:4]), 0, exact=True)
        logits2, _ = gemma.forward(hp, w, cache, torch.tensor(toks[4:]), 4, exact=True)
        return logits, logits2

    recs, (l1, l2) = _traced(run)
    assert [n for n, _ in recs] == [n for n, _ in jrecs]
    assert [v.shape for _, v in recs] == [v.shape for _, v in jrecs]
    ref = [jparity.DumpRecord(n, v.shape, float(np.sum(v, dtype=np.float64)), [])
           for n, v in jrecs]
    assert parity.compare_sums(ref, recs, rel_tol=1e-3) == []
    for got, want in ((l1, jl), (l2, jl2)):
        want = np.asarray(want)
        scale = max(1.0, np.abs(want).max())
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1.5e-2 * scale)
        assert int(got.argmax()) == int(want.argmax())
    assert trace.current() is None
    x = torch.ones(3)
    assert trace.tap("off", x) is x  # tracing off: the argument, nothing recorded


# -- the parity harness ------------------------------------------------------------------


def _print_tensor(name: str, v: np.ndarray, callback: bool) -> str:
    """A dump block in the reference printer's format (tensor.h:22-85), or
    llama-eval-callback's, with its corner values and sum."""
    shape = list(v.shape[::-1]) + [1] * (4 - v.ndim)
    dims = ", ".join(str(d) for d in shape)
    if callback:
        head = f"ggml_debug: {name} = (f32) MUL_MAT(a{{{dims}}}, b) = {{{dims}}}"
    else:
        head = f"{name} = {{{dims}}}"
    flat = parity.corner_sample(v)
    rows = [flat[i : i + 6] for i in range(0, len(flat), 6)]
    body = "\n".join("      [" + ", ".join(f"{x:10.4f}" for x in r) + "]," for r in rows)
    return f"{head}\n{body}\n      sum = {float(np.sum(v)):.6f}\n"


def test_parity_harness_matches_jax(paths):
    hp, w = load_weights(GGUFFile(paths["g3"]), mode="packed")
    recs, _ = _traced(lambda: gemma.forward(hp, w, gemma.init_cache(hp, 8, dtype=torch.float16),
                                            torch.tensor([2, 7, 8]), 0, exact=True))
    for callback in (False, True):
        text = "".join(_print_tensor(n, v, callback) for n, v in recs)
        parse = "parse_eval_callback_dump" if callback else "parse_reference_dump"
        got, want = getattr(parity, parse)(text), getattr(jparity, parse)(text)
        assert len(got) == len(recs) and [dataclasses.astuple(r) for r in got] == \
            [dataclasses.astuple(r) for r in want]
        cmp, jcmp = parity.compare_values(got, recs), jparity.compare_values(want, recs)
        assert [dataclasses.astuple(c) for c in cmp] == [dataclasses.astuple(c) for c in jcmp]
        assert parity.format_comparison_report(cmp) == jparity.format_comparison_report(jcmp)
        assert parity.mse_logplot(cmp) == jparity.mse_logplot(jcmp)
        assert parity.compare_sums(got, recs) == jparity.compare_sums(want, recs) == []
    for v in (np.arange(24.0).reshape(2, 3, 4), np.arange(80.0).reshape(8, 10), np.float32(3)):
        assert np.array_equal(parity.corner_sample(v), jparity.corner_sample(v))


# -- the parity Engine, server and CLI ----------------------------------------------------


@pytest.mark.parametrize("name", ["g3", "g4"])
def test_engine_parity_stream_matches_jax(paths, name):
    prompt = [2, 7, 8, 9, 10]
    want = _no_stop(JEngine(paths[name], max_seq=64, mode="parity",
                            decode_chunk=4)).generate_from_ids(prompt, n_predict=7)
    eng = _no_stop(Engine(paths[name], max_seq=64, mode="parity", decode_chunk=4, device="cpu"))
    assert eng.decode_route == "per-op" and eng.new_cache().k.dtype == torch.float16
    lw = eng.weights.layers[0]
    assert lw.wqkv is None and lw.w_gate_up is None  # unfused: a tap on every projection
    assert eng.generate_from_ids(prompt, n_predict=7) == want


def test_server_parity_matches_jax(paths, monkeypatch):
    reqs = [([2, 7, 8], 6), ([2, 9], 4), ([2, 5, 6, 10], 5)]
    kw = dict(max_seq=64, max_batch=2, decode_chunk=3, mode="parity")
    want = jserving.BatchedServer(paths["g3"], **kw).run(reqs)
    srv = BatchedServer(paths["g3"], device="cpu", **kw)
    assert srv.decode_route == "per-op" and srv._caches.k.dtype == torch.float16
    from llm_inference_tpu_torch.ops.kernels import kv_insert

    monkeypatch.setattr(kv_insert, "insert_kv_rows", None)  # f16 lanes never reach it
    assert srv.run(reqs) == want
    with pytest.raises(ValueError, match="serve-mode"):
        BatchedServer(paths["g3"], kv_pages=4, device="cpu", **kw)
    with pytest.raises(ValueError, match="greedy"):
        BatchedServer(paths["g3"], device="cpu", sampling=SamplingConfig(temperature=0.7), **kw)


def test_cli_trace_writes_the_eager_taps(paths, tmp_path, capsys):
    out = tmp_path / "trace.npz"
    rc = cli.main(["-m", paths["g3"], "-p", "ab", "-n", "2", "--no-cnv", "--max-seq", "64",
                   "--device", "cpu", "--trace", str(out)])
    assert rc == 0 and trace.current() is None
    err = capsys.readouterr().err
    assert f"activation trace written to {out}" in err and "l_out-1 shape=" in err
    keys = sorted(np.load(out).keys())
    names = [k.split("|", 1)[1] for k in keys]
    eng = Engine(paths["g3"], max_seq=64, mode="parity", device="cpu")
    ids = eng.tokenizer.encode("ab", False).ids
    hp, w = eng.hparams, eng.weights
    recs, _ = _traced(lambda: gemma.forward(
        hp, w, eng.new_cache(), torch.tensor(ids + [0] * (32 - len(ids))), 0, len(ids),
        exact=True))
    n = len(recs)
    assert names[:n] == [r[0] for r in recs]  # the prefill, then the decode steps'
    assert len(names) > n and names[n:2 * n] == [r[0] for r in recs]
    with np.load(out) as z:
        assert all(np.isfinite(z[k]).all() for k in keys)
