"""The port's lossless serve-q / serve-q4 ``Engine`` on the CPU against llm_inference_tpu's.

The port's ``Engine`` on both decode routes against the JAX ``Engine``
(which takes its per-op dequant route on the CPU): identical greedy
streams. The kernel route rounds as the whole step does, so a near tie can
flip a token against the JAX per-op stream: of ten seeded fixtures tried
(std 0.12 and 0.15, five seeds, 12 tokens, both formats, both modes), two
flip on Q4_0 in both modes; the fixtures here do not. Each JAX stream is
made once and shared by the two routes' tests."""

import pytest
import torch

from llm_inference_tpu.engine import Engine as JEngine
from llm_inference_tpu.gguf import GGMLType as JGGMLType
from llm_inference_tpu_torch.engine import Engine, prefill_operands
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.quant.device import DenseTensor, QuantTensor
from llm_inference_tpu_torch.serving import BatchedServer

from fixtures import build_gemma3_gguf
from test_torch_lossless import _checkpoint, _port_model
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

_JAX_STREAMS = {}


def _jax_stream(path, mode, prompt, n):
    """The JAX ``Engine``'s greedy ids, made once per checkpoint, mode and prompt."""
    key = (path, mode, tuple(prompt), n)
    if key not in _JAX_STREAMS:
        ref = _no_stop(JEngine(path, max_seq=128, mode=mode, decode_chunk=4))
        _JAX_STREAMS[key] = ref.generate_from_ids(prompt, n_predict=n)
    return _JAX_STREAMS[key]


# -- the engine ---------------------------------------------------------------------


def _no_stop(engine):
    engine.tokenizer.eos_id = -1
    engine.tokenizer.end_of_turn_id = -1
    return engine


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    out = {}
    # weight_std 0.15 without post norms: streams that wander
    for name, buf in {
        "q4_0": _checkpoint("Q4_0", weight_std=0.15, seed=7),
        "q4_k": _checkpoint("Q4_K", weight_std=0.15, seed=7),
        "q8_embd": _checkpoint("Q4_0", embd_fmt=JGGMLType.Q8_0, weight_std=0.15),
        "tiny": build_gemma3_gguf(n_layers=2),
    }.items():
        (d / f"{name}.gguf").write_bytes(buf)
        out[name] = str(d / f"{name}.gguf")
    return out


@pytest.mark.parametrize("name", ["q4_0", "q4_k"])
@pytest.mark.parametrize("mode", ["serve-q", "serve-q4"])
@pytest.mark.parametrize("route", ["kernel", "per-op"])
def test_greedy_stream_matches_jax_engine(paths, name, mode, route, monkeypatch):
    want = _jax_stream(paths[name], mode, [2, 40, 41, 42, 43], 12)
    if route == "per-op":
        monkeypatch.setenv("LLMI_NO_FUSED_DECODE", "1")
    eng = _no_stop(Engine(paths[name], max_seq=128, mode=mode, decode_chunk=4, device="cpu"))
    assert eng.decode_route == route
    assert eng.generate_from_ids([2, 40, 41, 42, 43], n_predict=12) == want
    assert len(set(want)) > 2  # the stream wanders


def test_engine_on_an_ineligible_checkpoint_takes_the_per_op_route(paths):
    """A Q8_0 embedding keeps serve-q off the whole step (it needs dense
    bf16) and goes through embed_rows and the grouped dispatch instead;
    serve-q4 dequantizes every non-layer weight to bf16, so it stays eligible."""
    eng = _no_stop(Engine(paths["q8_embd"], max_seq=128, mode="serve-q", decode_chunk=4,
                          device="cpu"))
    assert eng.decode_route == "per-op" and isinstance(eng.weights.token_embd, QuantTensor)
    assert eng.generate_from_ids([2, 7, 8], n_predict=8) == _jax_stream(paths["q8_embd"],
                                                                         "serve-q", [2, 7, 8], 8)
    eng4 = Engine(paths["q8_embd"], max_seq=128, mode="serve-q4", device="cpu")
    assert eng4.decode_route == "kernel" and isinstance(eng4.weights.token_embd, DenseTensor)
    tiny = Engine(paths["tiny"], max_seq=64, mode="serve-q4", device="cpu")
    assert tiny.decode_route == "per-op"  # head_dim 16


def test_prefill_operand_cache(paths, monkeypatch):
    """The kernel route's prefill reads bf16 copies of the dequantized layer
    weights, the same values the per-op route forms; over budget, or with
    LLMI_PREFILL_BF16=0, it reads the quantized weights."""
    eng = Engine(paths["q4_k"], max_seq=64, mode="serve-q4", device="cpu")
    lw, pw = eng.weights.layers, eng._prefill_w.layers
    for f in ("wqkv", "wo", "w_gate_up", "w_down"):
        assert isinstance(getattr(pw, f), DenseTensor)
        assert torch.equal(getattr(pw, f).w, getattr(lw, f).dequant(torch.bfloat16))
    monkeypatch.setenv("LLMI_PREFILL_BF16_BUDGET", "1000")
    assert prefill_operands(eng.weights) is eng.weights
    monkeypatch.delenv("LLMI_PREFILL_BF16_BUDGET")
    monkeypatch.setenv("LLMI_PREFILL_BF16", "0")
    assert prefill_operands(eng.weights) is eng.weights


def test_capacity_and_server_modes_raise(paths, monkeypatch):
    """LLMI_FORCE_CAPACITY=1 takes the capacity route (the whole-layer gate
    gives way to the capacity step); the per-op route and the server never
    ask for it, and the server still refuses the serve mode."""
    monkeypatch.setenv("LLMI_FORCE_CAPACITY", "1")
    eng = Engine(paths["q4_0"], max_seq=64, mode="serve-q", device="cpu")
    assert eng.decode_route == "capacity" and eng.new_cache().k.dim() == 3
    hp, w = _port_model(_checkpoint(), "serve-q")
    assert not gemma.decode_q_enabled(hp, w) and gemma.decode_stream_enabled(hp, w)
    monkeypatch.setenv("LLMI_NO_FUSED_DECODE", "1")  # the per-op route never asks for capacity
    assert Engine(paths["q4_0"], max_seq=64, mode="serve-q", device="cpu").decode_route == "per-op"
    assert not gemma.decode_q_enabled(hp, w) and not gemma.decode_stream_enabled(hp, w)
    # the server runs serve-q / serve-q4 per op (the JAX server's rule): it
    # never asks for the capacity step, and still refuses the serve mode
    monkeypatch.delenv("LLMI_NO_FUSED_DECODE")
    for mode in ("serve-q", "serve-q4"):
        srv = BatchedServer(paths["q4_0"], mode=mode, max_seq=64, device="cpu")
        assert srv.decode_route == "per-op"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BatchedServer(paths["q4_0"], mode="serve", max_seq=64, device="cpu")
