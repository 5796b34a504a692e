"""The port's serve-q8 Engine, CLI and weight carry-over on the CPU.

Bars: greedy token streams identical to llm_inference_tpu's serve-q8 Engine
on the same checkpoint; ``from_jax_arrays`` weights bit-equal to the
GGUF-loaded ones, so their logits are identical. The port package and
chip_smoke.py must import neither ``jax`` nor ``llm_inference_tpu``."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from llm_inference_tpu.engine import Engine as JEngine
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.models import load_weights as jax_load_weights
from llm_inference_tpu.models.weights import fuse_projections as jax_fuse
from llm_inference_tpu.models.weights import stack_layers as jax_stack
from llm_inference_tpu_torch import cli
from llm_inference_tpu_torch.engine import Engine, GenerationStats, prefill_bucket
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.models.weights import (
    LayerWeights, fuse_projections, from_jax_arrays, load_weights, stack_layers)
from llm_inference_tpu_torch.sampling import SamplingConfig

from fixtures import build_gemma3_gguf, build_gemma4_gguf
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

ROOT = Path(__file__).resolve().parents[1]
VOCAB = [f"t{i}" for i in range(256)]
VOCAB[1], VOCAB[2], VOCAB[3] = "<eos>", "<bos>", "<unk>"
WIDE = dict(n_layers=3, n_embd=256, n_ff=512, n_head=4, n_head_kv=2, head_dim=128, vocab=VOCAB)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    out = {}
    for name, buf in {
        "wide_post_norms": build_gemma3_gguf(with_post_norms=True, **WIDE),
        "wide_seed7": build_gemma3_gguf(seed=7, **WIDE),
        "tiny_default": build_gemma3_gguf(n_layers=2),  # head_dim 16: the per-op decode path
        "gemma4": build_gemma4_gguf(n_layers=4),
    }.items():
        (d / f"{name}.gguf").write_bytes(buf)
        out[name] = str(d / f"{name}.gguf")
    return out


def _no_stop(engine):
    engine.tokenizer.eos_id = -1
    engine.tokenizer.end_of_turn_id = -1
    return engine


@pytest.mark.parametrize("name,prompt,n,chunk", [
    ("wide_post_norms", [2, 7, 8], 12, 4),
    ("wide_seed7", [2, 40, 41, 42, 43, 44, 45, 46, 47, 48], 9, 3),
    ("tiny_default", [2, 7, 8, 9], 6, 4),
])
def test_greedy_stream_matches_jax_engine(paths, name, prompt, n, chunk):
    ref = _no_stop(JEngine(paths[name], max_seq=128, mode="serve-q8", decode_chunk=chunk))
    eng = _no_stop(Engine(paths[name], max_seq=128, mode="serve-q8", decode_chunk=chunk,
                          device="cpu"))
    stats = GenerationStats()
    out = eng.generate_from_ids(prompt, n_predict=n, stats=stats)
    assert out == ref.generate_from_ids(prompt, n_predict=n)
    assert len(out) == n and stats.generated_tokens == n and stats.prompt_tokens == len(prompt)
    assert stats.decode_steps % chunk == 0 and stats.decode_steps >= n - 1


def test_no_fused_decode_takes_the_per_op_route(paths, monkeypatch):
    """LLMI_NO_FUSED_DECODE=1 keeps serve-q8 off the whole step too, as the
    JAX engine's rule has it (llm_inference_tpu/engine.py:211-215)."""
    prompt = [2, 7, 8]
    ref = _no_stop(JEngine(paths["wide_post_norms"], max_seq=128, mode="serve-q8", decode_chunk=4))
    want = ref.generate_from_ids(prompt, n_predict=8)
    assert Engine(paths["wide_post_norms"], max_seq=128, mode="serve-q8",
                  device="cpu").decode_route == "kernel"
    monkeypatch.setenv("LLMI_NO_FUSED_DECODE", "1")
    eng = _no_stop(Engine(paths["wide_post_norms"], max_seq=128, mode="serve-q8", decode_chunk=4,
                          device="cpu"))
    assert eng.decode_route == "per-op" and not isinstance(eng.weights.layers, LayerWeights)
    assert eng.generate_from_ids(prompt, n_predict=8) == want


def test_generate_with_template_and_stop_matches_jax_engine(paths):
    """Chat template, tokenizer and stop-token handling, with stops on."""
    ref = JEngine(paths["tiny_default"], max_seq=128, mode="serve-q8", decode_chunk=4)
    eng = Engine(paths["tiny_default"], max_seq=128, mode="serve-q8", decode_chunk=4, device="cpu")
    assert eng.generate("ab c", n_predict=10) == ref.generate("ab c", n_predict=10)
    assert eng.generate_text("fact", n_predict=5) == ref.generate_text("fact", n_predict=5)


def _flatten(tree, prefix=""):
    """A JAX ModelWeights as {field path: numpy array} (the test side of the
    carry-over, so the port never imports JAX)."""
    out = {}
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if f.name == "fmt":
                out[prefix + "fmt"] = np.int32(int(v))
            elif v is not None and f.name not in ("rows", "cols", "group_size", "offset"):
                out.update(_flatten(v, f"{prefix}{f.name}."))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


@pytest.mark.parametrize("stacked", [True, False])
def test_from_jax_arrays_gives_gguf_loaded_logits(paths, stacked):
    jhp, jw = jax_load_weights(JGGUFFile(paths["wide_post_norms"]), mode="rowq8")
    jw = jax_fuse(jw)
    if stacked:
        jw = dataclasses.replace(jw, layers=jax_stack(jw.layers))
    hp, w = from_jax_arrays(dataclasses.asdict(jhp), _flatten(jw))

    hp2, w2 = load_weights(GGUFFile(paths["wide_post_norms"]), mode="rowq8")
    w2 = fuse_projections(w2)
    if stacked:
        w2 = dataclasses.replace(w2, layers=stack_layers(w2.layers))
    assert hp == hp2
    assert torch.equal(w.token_embd.q, w2.token_embd.q)
    assert w.token_embd.fmt == w2.token_embd.fmt

    toks = torch.tensor([2, 7, 8, 9])
    a, ca = gemma.forward(hp, w, gemma.init_cache(hp, 32), toks, 0)
    b, cb = gemma.forward(hp2, w2, gemma.init_cache(hp2, 32), toks, 0)
    assert torch.equal(a, b) and torch.equal(ca.k, cb.k)
    a, _ = gemma.forward(hp, w, ca, torch.tensor([5]), torch.tensor([4]))
    b, _ = gemma.forward(hp2, w2, cb, torch.tensor([5]), torch.tensor([4]))
    assert torch.equal(a, b)


def test_cli_runs_on_cpu(paths, capsys):
    rc = cli.main(["-m", paths["tiny_default"], "-p", "ab", "-n", "4", "--no-cnv",
                   "--max-seq", "64", "--device", "cpu", "-v"])
    assert rc == 0
    cap = capsys.readouterr()
    assert "Prompt: ab" in cap.out and "tok/s decode" in cap.out
    assert "Top 10 most likely tokens:" in cap.err and "GGUF File Information:" in cap.err
    assert "device=cpu" in cap.err


def test_cli_rejects_trace(paths):
    """``--trace`` takes the path of its .npz (tests/test_torch_parity.py
    runs it); without one the CLI exits with argparse's usage error."""
    with pytest.raises(SystemExit) as e:
        cli.main(["-m", paths["tiny_default"], "--device", "cpu", "--trace"])
    assert e.value.code == 2


def test_default_device_needs_cuda(paths, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(paths["tiny_default"], max_seq=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-m", paths["tiny_default"], "-n", "2", "--max-seq", "64"])


@pytest.mark.parametrize("mode", ["serve", "parity"])
def test_other_modes_are_not_ported_yet(paths, mode):
    """The serve and parity modes load (bf16; the checkpoint's quants,
    unfused) and decode per op: neither has a whole-step kernel
    (tests/test_torch_serve.py and tests/test_torch_parity.py hold them
    against the JAX package)."""
    eng = Engine(paths["wide_post_norms"], max_seq=64, mode=mode, device="cpu")
    assert eng.decode_route == "per-op" and not isinstance(eng.weights.layers, LayerWeights)
    assert (eng.weights.layers[0].wqkv is None) == (mode == "parity")
    assert len(eng.generate_from_ids([2, 7, 8], n_predict=2)) <= 2


def test_unsupported_inputs_raise(paths):
    # gemma4 is ported (tests/test_torch_gemma4.py): this head_dim-16 one
    # loads and takes the per-op route
    assert Engine(paths["gemma4"], mode="serve-q8", device="cpu").decode_route == "per-op"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(paths["tiny_default"], device="cpu", sampling=SamplingConfig(temperature=0.7))
    with pytest.raises(ValueError):
        Engine(paths["tiny_default"], mode="nonsense", device="cpu")
    eng = Engine(paths["tiny_default"], max_seq=16, mode="serve-q8", decode_chunk=4, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate_from_ids([2] * 8, n_predict=8)
    for bad in ([], [2, 256], [-1]):  # the fixture's vocabulary has 27 ids
        with pytest.raises(ValueError, match="prompt ids"):
            eng.generate_from_ids(bad, n_predict=2)
    assert [prefill_bucket(n) for n in (1, 32, 33, 100)] == [32, 32, 64, 128]


def _imports(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
    return mods


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "llm_inference_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for m in _imports(f):
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "llm_inference_tpu", "fixtures"), (f, m)
    assert "jax" in jax.__name__  # the tests themselves do import both
