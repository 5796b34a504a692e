"""The port's greedy-parity, reference-comparison and roofline tools
(tools/torch_greedy_parity.py, torch_compare_with_reference.py,
torch_roofline.py) against the JAX tools on the CPU.

Greedy parity: the tool's streams equal a golden JSON written from the JAX
``Engine``'s streams in all five modes (the JAX tool's settings: max_seq
512, decode_chunk 16, stop ids off); a golden with one token changed is
reported at that step, and the exit code follows the JAX tool's rule (a
divergence fails only ``parity``; an error fails any mode). Comparison: a
dump of the JAX package's taps in the reference printer's format gives
PARITY OK, and on a planted fault (one tensor's values x 1.1 in the dump)
the port's tool and the JAX tool exit 1 naming the same tensors. Roofline:
``matmul_params`` equals the JAX tool's on each load mode's weights (a
stacked weight counts all its layers, where the JAX tool counts one), every
``__global__`` kernel of csrc/ maps to a named op class, the step's bytes
equal chip_smoke's rowq8 step formula (the per-op route's weights hold the
kernel route's bytes), the device time is the union of the kernel
intervals (overlapping kernels count once) and the busy share that of the
traced window, and a ``--device cpu`` run prints every section."""

import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
import compare_with_reference as jcompare  # noqa: E402
import roofline as jroofline  # noqa: E402
import torch_compare_with_reference as compare  # noqa: E402
import torch_greedy_parity as parity_tool  # noqa: E402
import torch_roofline as roofline  # noqa: E402
from fixtures import build_gemma3_gguf, build_gemma4_gguf  # noqa: E402
from llm_inference_tpu import trace as jtrace  # noqa: E402
from llm_inference_tpu.engine import Engine as JEngine  # noqa: E402
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile  # noqa: E402
from llm_inference_tpu.models import gemma as jgemma  # noqa: E402
from llm_inference_tpu.models import load_weights as jax_load_weights  # noqa: E402
from llm_inference_tpu.models.weights import fuse_projections as jax_fuse  # noqa: E402
from llm_inference_tpu.models.weights import stack_layers as jax_stack  # noqa: E402
from llm_inference_tpu.tokenizer import Tokenizer as JTokenizer  # noqa: E402
from llm_inference_tpu_torch import parity  # noqa: E402
from llm_inference_tpu_torch.engine import Engine  # noqa: E402
from llm_inference_tpu_torch.gguf import GGUFFile  # noqa: E402
from llm_inference_tpu_torch.models.weights import (fuse_projections, load_weights,  # noqa: E402
                                                    stack_layers)
from torch_jax_native import jax_native  # noqa: E402,F401  (autouse: the JAX default route)

VOCAB = [f"t{i}" for i in range(256)]
VOCAB[1], VOCAB[2], VOCAB[3] = "<eos>", "<bos>", "<unk>"
WIDE = dict(n_layers=2, n_embd=256, n_ff=512, n_head=4, n_head_kv=2, head_dim=128, vocab=VOCAB,
            weight_std=0.15)  # streams that wander over the vocabulary
PROMPT = [2, 7, 8, 9, 10]
STEPS = 12
MODES = ["parity", "serve", "serve-q", "serve-q4", "serve-q8"]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    out = {}
    for name, buf in {"g3": build_gemma3_gguf(**WIDE),
                      "g3post": build_gemma3_gguf(**WIDE, with_post_norms=True),
                      "g4": build_gemma4_gguf(n_layers=4, shared_kv_layers=1)}.items():
        (d / f"{name}.gguf").write_bytes(bytes(buf))
        out[name] = str(d / f"{name}.gguf")
    return out


@pytest.fixture(scope="module")
def goldens(paths, tmp_path_factory):
    """A golden JSON a mode, from the JAX Engine's stream with the JAX
    tool's settings."""
    d = tmp_path_factory.mktemp("goldens")
    out = {}
    for mode in MODES:
        eng = JEngine(paths["g3"], max_seq=512, mode=mode, decode_chunk=16)
        eng.tokenizer.eos_id = -1
        eng.tokenizer.end_of_turn_id = -1
        toks = eng.generate_from_ids(list(PROMPT), n_predict=STEPS)
        assert len(toks) == STEPS
        out[mode] = dict(prompt=PROMPT, steps=STEPS, tokens=toks, checkpoint={})
        (d / f"{mode}.json").write_text(json.dumps(out[mode]))
    return d


def _greedy(args, capsys):
    rc = parity_tool.main(args + ["--device", "cpu"])
    return rc, capsys.readouterr().out


# -- greedy parity ---------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_greedy_parity_matches_the_jax_streams(paths, goldens, mode, capsys, tmp_path):
    out_file = tmp_path / "parity.md"
    rc, out = _greedy(["-m", paths["g3"], "--golden", str(goldens / f"{mode}.json"),
                       "--modes", mode, "--out", str(out_file)], capsys)
    assert rc == 0, out
    assert f"| {mode} | {parity_tool.DESCR[mode]} | {STEPS}/{STEPS} | — (identical stream) |" \
        in out
    assert "device cpu" in out and out_file.read_text() == out.rstrip("\n") + "\n"


@pytest.mark.parametrize("mode,rc_want", [("serve-q8", 0), ("parity", 1)])
def test_greedy_parity_reports_a_changed_token(paths, goldens, mode, rc_want, capsys, tmp_path):
    golden = json.loads((goldens / f"{mode}.json").read_text())
    k = 5
    golden["tokens"][k] = (golden["tokens"][k] + 1) % len(VOCAB)
    g = tmp_path / "changed.json"
    g.write_text(json.dumps(golden))
    rc, out = _greedy(["-m", paths["g3"], "--golden", str(g), "--modes", mode], capsys)
    assert rc == rc_want
    got = json.loads((goldens / f"{mode}.json").read_text())["tokens"][k]
    assert f"| {k}/{STEPS} | step {k}: ref {golden['tokens'][k]} vs {got} |" in out


def test_greedy_parity_errors_and_the_missing_reference(paths, goldens, capsys, monkeypatch):
    rc, out = _greedy(["-m", paths["g3"], "--golden", str(goldens / "serve.json"), "--modes",
                       "serve", "nonsense"], capsys)
    assert rc == 1 and "| nonsense |  | ERROR | unknown engine mode" in out
    assert f"| serve | {parity_tool.DESCR['serve']} | {STEPS}/{STEPS} |" in out
    monkeypatch.delenv("LLMI_REFERENCE_DIR", raising=False)
    rc = parity_tool.main(["-m", paths["g3"], "--golden", str(goldens / "serve.json"),
                           "--reference", "--device", "cpu"])
    assert rc == 2 and "LLMI_REFERENCE_DIR" in capsys.readouterr().err
    assert parity_tool.matched([1, 2, 3], [1, 2, 3]) == (3, "— (identical stream)")
    assert parity_tool.matched([1, 2], [1, 2, 3]) == (2, "step 2: ref 3 vs EOS")


# -- the reference comparison --------------------------------------------------------------


def _jax_records(path: str, prompt: str) -> list:
    """The JAX tool's own taps: the default (packed) load, exact forward."""
    gguf = JGGUFFile(path)
    hp, w = jax_load_weights(gguf)
    ids = JTokenizer(gguf.metadata, hp.architecture).encode(prompt, False).ids
    session = jtrace.enable_trace("unused.npz")
    try:
        import jax.numpy as jnp

        jgemma.forward(hp, w, jgemma.init_cache(hp, max(64, 2 * len(ids))),
                       jnp.asarray(ids, dtype=jnp.int32), 0)
    finally:
        jtrace.disable_trace()
    return [(n, np.asarray(v)) for n, v in session.records]


def _offenders(text: str) -> list[str]:
    tail = text.split("top offenders:", 1)[1]
    return re.findall(r"^  (.+?)\s+ref=", tail, flags=re.M)


def test_compare_with_reference_matches_the_jax_tool(paths, tmp_path, capsys, monkeypatch):
    name = "g3"
    prompt = "t7t8t9 t12"
    recs = _jax_records(paths[name], prompt)
    dump = tmp_path / "ref.txt"
    dump.write_text(parity.format_reference_dump(recs))
    rc = compare.main(["-m", paths[name], "-p", prompt, "--ref-dump", str(dump), "--device",
                       "cpu", "--out", str(tmp_path / "report.txt")])
    out = capsys.readouterr().out
    assert rc == 0 and "PARITY OK" in out and "device cpu" in out
    assert (tmp_path / "report.txt").read_text().startswith("device cpu")
    # plant a fault: the tensor whose sum carries most of its magnitude, x 1.1
    ratio = [abs(v.sum()) / max(np.abs(v).sum(), 1e-30) for _, v in recs]
    j = int(np.argmax(ratio))
    assert ratio[j] > 0.05  # its sum moves by more than 4e-3 of its magnitude
    faulted = [(n, v * np.float32(1.1) if i == j else v) for i, (n, v) in enumerate(recs)]
    dump.write_text(parity.format_reference_dump(faulted))
    rc = compare.main(["-m", paths[name], "-p", prompt, "--ref-dump", str(dump), "--device",
                       "cpu"])
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["compare_with_reference.py", "-m", paths[name], "-p",
                                      prompt, "--ref-dump", str(dump)])
    jrc = jcompare.main()
    theirs = capsys.readouterr().out
    assert rc == jrc == 1
    assert _offenders(ours) == _offenders(theirs) == [recs[j][0]]


def test_compare_without_a_reference_names_the_variable(paths, capsys, monkeypatch):
    monkeypatch.delenv("LLMI_REFERENCE_DIR", raising=False)
    assert compare.main(["-m", paths["g3"], "--device", "cpu"]) == 2
    assert "LLMI_REFERENCE_DIR" in capsys.readouterr().err


# -- the roofline --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["bf16", "rowq8", "packed-serve", "packed-q4", "packed"])
def test_matmul_params_match_the_jax_tool(paths, mode):
    for name in ("g3", "g4"):
        jhp, jw = jax_load_weights(JGGUFFile(paths[name]), mode=mode)
        hp, w = load_weights(GGUFFile(paths[name]), mode=mode, device="cpu")
        want = jroofline.matmul_params(jw)
        assert roofline.matmul_params(w) == want > 0
        if mode == "packed" or name == "g4":
            continue
        jf, f = jax_fuse(jw), fuse_projections(w)
        assert roofline.matmul_params(f) == jroofline.matmul_params(jf) == want
        # stacked: the port counts every layer; the JAX tool counts one layer's rows x cols
        stacked = roofline.matmul_params(
            type(f)(token_embd=f.token_embd, output_norm=f.output_norm,
                    layers=stack_layers(f.layers)))
        jstacked = jroofline.matmul_params(
            type(jf)(token_embd=jf.token_embd, output_norm=jf.output_norm,
                     layers=jax_stack(jf.layers)))
        emb = jroofline.matmul_params(type(jf)(token_embd=jf.token_embd,
                                               output_norm=jf.output_norm, layers=()))
        assert stacked == want
        assert jstacked - emb == (want - emb) // hp.block_count


def _globals() -> set[str]:
    names = set()
    for f in sorted((ROOT / "llm_inference_tpu_torch" / "csrc").glob("*.cu*")):
        text = re.sub(r"//[^\n]*", "", f.read_text())
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                                text))
    return names


def test_every_port_kernel_has_a_named_class():
    names = _globals()
    assert len(names) >= 15 and names == set(roofline.PORT_KERNELS)
    for k in names:
        cls = roofline.op_class(f"void (anonymous namespace)::{k}<2, 4>(Args)")
        assert cls == roofline.PORT_KERNELS[k] and cls != "other"
        assert roofline.port_kernel(f"{k}(Args)") == k
    assert roofline.op_class("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<"
                             "float, at::native::ArgMaxOps<float>, unsigned int, long, 4> >"
                             "(at::native::ReduceOp<float>)") == "sampler (argmax, sort, top-k)"
    assert roofline.op_class("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"
                             ) == "torch GEMM"
    assert roofline.op_class("Memcpy HtoD (Pageable -> Device)") == "copies / casts / indexing"
    assert roofline.op_class("void at::native::vectorized_elementwise_kernel<4, at::native::"
                             "CUDAFunctor_add<float> >(int)") == "elementwise / reductions"
    assert roofline.op_class("aten::mm") == "torch GEMM"
    assert roofline.op_class("aten::mul") == "elementwise / reductions"


def test_launch_check_catches_a_miscount():
    tr = roofline.Trace({"void qmatmul_grouped_kernel<1>(P)": (10.0, 3),
                         "void decode_step_kernel(A)": (5.0, 2)},
                        {"quant_matmul": 1, "q4_matmul": 2, "decode_step": 1}, 1.0)
    assert tr.launch_rows() == [("qmatmul_grouped_kernel", 3, 3),
                                ("decode_step_kernel + decode_step_g4_kernel", 2, 1)]
    with pytest.raises(RuntimeError, match="decode_step_kernel"):
        roofline.check_launches({"launch_rows": tr.launch_rows()})


def test_step_bytes_are_the_smoke_formula(paths, monkeypatch):
    eng = Engine(paths["g3post"], max_seq=64, mode="serve-q8", decode_chunk=4, device="cpu")
    assert eng.decode_route == "kernel"
    hp, cache = eng.hparams, eng.new_cache()
    work = roofline.step_work(hp, eng.weights, roofline.kv_row_bytes(cache.k, cache.v, 1))
    for pos in (0, 37):
        assert work([pos]) == chip_smoke.rowq8_step_work(hp, pos)
    monkeypatch.setenv("LLMI_NO_FUSED_DECODE", "1")
    per_op = Engine(paths["g3post"], max_seq=64, mode="serve-q8", decode_chunk=4,
                    device="cpu")
    assert per_op.decode_route == "per-op"
    assert sum(roofline.weight_bytes(per_op.weights).values()) == \
        sum(roofline.weight_bytes(eng.weights).values())


def test_device_time_is_the_union_of_the_intervals(paths):
    """Kernels that overlap (programmatic dependent launch) count once in
    the device time, the busy share and the bound's share; the busy share
    is of the traced window (the untraced run is another run); the class
    and top-kernel tables keep the summed durations."""
    assert roofline.union_us([]) == 0.0
    assert roofline.union_us([(20.0, 25.0), (0.0, 10.0), (4.0, 12.0), (21.0, 22.0)]) == 17.0
    eng = Engine(paths["g3"], max_seq=64, mode="serve-q8", decode_chunk=4, device="cpu")
    # one step: a 10 us kernel and an 8 us one that starts 4 us into it, busy 12 us
    # in a traced window of 24 us; the untraced run took 10 us a step
    tr = roofline.Trace({"void decode_step_kernel(A)": (10.0, 1), "void gemm_kernel(B)": (8.0, 1)},
                        {"decode_step": 1}, 24e-6,
                        busy_us=roofline.union_us([(0.0, 10.0), (4.0, 12.0)]))
    lines, info = roofline._step_lines("t", eng.weights, tr, 1, 1, 10e-6, [(3.35e4, 0.0, 0.0)],
                                       0.0, 5)
    assert info["device_ms"] == pytest.approx(0.012) and info["summed_ms"] == pytest.approx(0.018)
    assert info["wall_ms"] == pytest.approx(0.010) and info["traced_ms"] == pytest.approx(0.024)
    assert info["busy"] == pytest.approx(0.5) and info["bound_ms"] == pytest.approx(1e-5)
    assert "- device time a step: 0.0120 ms" in "\n".join(lines)
    assert "(the bound is 0.1% of it); summed kernel durations 0.0180 ms" in "\n".join(lines)
    assert sum(info["classes"].values()) == pytest.approx(18.0)


def test_roofline_cpu_run_prints_every_section(paths, tmp_path, capsys):
    out = tmp_path / "roofline.md"
    rc = roofline.main(["-m", paths["g3"], "--device", "cpu", "--max-seq", "128", "--chunks",
                        "1", "--decode-chunk", "4", "--out", str(out)])
    text = capsys.readouterr().out
    assert rc == 0
    for section in ("device cpu", "# Roofline: the PyTorch port, mode=serve-q8, kernel route",
                    "- weight bytes a step:", "- live K/V bytes a step", "- bound a step:",
                    "- device time a step:", "- wall time a step:", "## By op class",
                    "## Top kernels", "No port kernel launched", "## Prefill",
                    "| 32 |", "| 64 |", "| 128 |"):
        assert section in text, section
    assert out.read_text() == text
    for extra, route in ((["--batch", "2"], "kernel route, B=2"),
                         (["--batch", "2", "--paged"], "paged-per-op route, B=2, max_seq=256, "
                                                       "2 pages of 256"),
                         (["--per-op"], "per-op route")):
        rc = roofline.main(["-m", paths["g3"], "--device", "cpu", "--max-seq", "256",
                            "--chunks", "1", "--decode-chunk", "4", "--no-prefill", *extra])
        text = capsys.readouterr().out
        assert rc == 0 and route in text and "## Top kernels" in text, text[:300]
    assert os.environ.get("LLMI_NO_FUSED_DECODE") is None
