"""The port's serve mode (bf16 weights, per-op decode) and the engine defaults on the CPU.

Bars: the serve forward's logits within 1.5e-2 * max(1, max |logits|) of
the JAX serve forward's with equal argmax (tests/test_fused_decode.py's bar:
bf16 activations round at the same points, the f32 sums' order may tip a
rounding); greedy streams identical to the JAX ``Engine`` (gemma3 and
gemma4) and ``BatchedServer`` (dense and paged lanes) in the serve mode;
``LLMI_FLASH_DECODE=1`` on the CPU the masked softmax and the same stream
(the kernel is CUDA's: tests/test_torch_cuda.py); the defaults of
``Engine``, ``BatchedServer`` and the CLI equal the JAX package's; the
tensor-parallel engine refuses serve and parity, as the JAX one does."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_inference_tpu.cli as jcli
import llm_inference_tpu.engine as jengine
from llm_inference_tpu import serving as jserving
from llm_inference_tpu import trace as jtrace
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.models import gemma as jgemma
from llm_inference_tpu.models import load_weights as jax_load_weights
from llm_inference_tpu.models.weights import fuse_projections as jax_fuse
from llm_inference_tpu_torch import cli, trace
from llm_inference_tpu_torch import engine as port_engine
from llm_inference_tpu_torch.engine import Engine
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.models.weights import fuse_projections, load_weights
from llm_inference_tpu_torch.ops.kernels import flash_decode, kv_insert
from llm_inference_tpu_torch.parallel import make_mesh
from llm_inference_tpu_torch.quant.device import DenseTensor
from llm_inference_tpu_torch.serving import BatchedServer

from fixtures import build_gemma3_gguf, build_gemma4_gguf
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

VOCAB = [f"t{i}" for i in range(256)]
VOCAB[1], VOCAB[2], VOCAB[3] = "<eos>", "<bos>", "<unk>"
WIDE = dict(n_layers=2, n_embd=256, n_ff=512, n_head=4, n_head_kv=2, head_dim=128, vocab=VOCAB,
            weight_std=0.15)  # streams that wander over the vocabulary
PAGE = 16
SERVER = dict(max_seq=64, max_batch=2, decode_chunk=3)
REQS = [([2, 7, 8], 9), ([2, 9], 3), ([2, 5, 6], 6), ([2, 11], 8)]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    out = {}
    for name, buf in {
        "g3": build_gemma3_gguf(**WIDE),
        "g4": build_gemma4_gguf(n_layers=4, shared_kv_layers=1),
    }.items():
        (d / f"{name}.gguf").write_bytes(buf)
        out[name] = str(d / f"{name}.gguf")
    return out


def _no_stop(engine):
    engine.tokenizer.eos_id = -1
    engine.tokenizer.end_of_turn_id = -1
    return engine


@pytest.mark.parametrize("name", ["g3", "g4"])
def test_serve_logits_match_jax(paths, name):
    """The bf16 load fused, prefill and three decode steps."""
    jhp, jw = jax_load_weights(JGGUFFile(paths[name]), mode="bf16")
    jw = jax_fuse(jw)
    hp, w = load_weights(GGUFFile(paths[name]), mode="bf16")
    w = fuse_projections(w)
    assert isinstance(w.token_embd, DenseTensor) and w.token_embd.w.dtype == torch.bfloat16
    jc = jgemma.init_cache(jhp, 32, dtype=jnp.bfloat16)
    cache = gemma.init_cache(hp, 32)
    jforward = jax.jit(lambda w, c, t, p: jgemma.forward(jhp, w, c, t, p, exact=False))
    steps = [([2, 7, 8, 9], 0), ([10], 4), ([11], 5), ([12], 6)]
    for toks, pos in steps:
        want, jc = jforward(jw, jc, jnp.asarray(toks, dtype=jnp.int32), jnp.int32(pos))
        got, cache = gemma.forward(hp, w, cache, torch.tensor(toks), pos)
        want = np.asarray(want)
        scale = max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1.5e-2 * scale)
        assert int(got.argmax()) == int(want.argmax())


PROMPTS = {"g3": [2, 40, 41, 42, 43], "g4": [2, 7, 8, 9]}


@pytest.fixture(scope="module")
def jax_serve_streams(paths):
    """The JAX serve Engine's greedy stream of each checkpoint's prompt."""
    return {name: _no_stop(jengine.Engine(paths[name], max_seq=64, mode="serve", decode_chunk=4))
            .generate_from_ids(prompt, n_predict=9) for name, prompt in PROMPTS.items()}


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("name", ["g3", "g4"])
def test_engine_serve_stream_matches_jax(paths, jax_serve_streams, name, flash, monkeypatch):
    if flash:  # on the CPU the masked softmax, as the JAX package off the TPU
        monkeypatch.setenv("LLMI_FLASH_DECODE", "1")
        monkeypatch.setattr(flash_decode, "flash_decode", None)
    prompt, want = PROMPTS[name], jax_serve_streams[name]
    eng = _no_stop(Engine(paths[name], max_seq=64, decode_chunk=4, device="cpu"))
    assert eng.mode == "serve" and eng.decode_route == "per-op"
    assert eng.new_cache().k.dtype == torch.bfloat16
    lw = eng.weights.layers[0]
    assert isinstance(lw.wqkv, DenseTensor) and lw.wqkv.w.dtype == torch.bfloat16
    assert eng.generate_from_ids(prompt, n_predict=9) == want


@pytest.mark.parametrize("paged", [False, True])
def test_server_serve_matches_jax(paths, paged, monkeypatch):
    """Dense and paged lanes on the per-op route, through the kernels' plain
    twins on the CPU (one ``insert_kv_rows`` a layer and step)."""
    appends = []
    real = kv_insert.insert_kv_rows_plain
    monkeypatch.setattr(kv_insert, "insert_kv_rows_plain",
                        lambda *a: appends.append(1) or real(*a))
    kw = dict(SERVER, mode="serve")
    if paged:
        kw["kv_pages"] = 3
        monkeypatch.setattr(jserving, "PAGE", PAGE)
        monkeypatch.setenv("LLMI_PAGE", str(PAGE))
    want = jserving.BatchedServer(paths["g3"], **kw).run(REQS)
    srv = BatchedServer(paths["g3"], device="cpu", **kw)
    assert srv.decode_route == ("paged-per-op" if paged else "per-op")
    counts = (kv_insert.launches, flash_decode.launches, flash_decode.paged_launches)
    assert srv.run(REQS) == want
    assert (kv_insert.launches, flash_decode.launches, flash_decode.paged_launches) == counts
    assert len(appends) == srv.hparams.n_kv_layers * srv.stats.decode_steps > 0
    if paged:
        assert sorted(srv._free_pages) == [0, 1, 2]


def test_defaults_equal_jax(paths, monkeypatch):
    """``serve`` is the default of the Engine, the server and the CLI, in
    both packages; the CLI takes ``parity`` under --trace."""
    def default(fn):
        return inspect.signature(fn).parameters["mode"].default

    assert default(Engine) == default(jengine.Engine) == "serve"
    assert default(BatchedServer) == default(jserving.BatchedServer) == "serve"
    seen = []

    class Stop(Exception):
        pass

    def record(*a, mode, **kw):
        seen.append(mode)
        raise Stop

    monkeypatch.setattr(port_engine, "Engine", record)
    monkeypatch.setattr(jengine, "Engine", record)
    try:
        for main in (cli.main, jcli.main):
            for extra in ([], ["--trace", "unused.npz"]):
                with pytest.raises(Stop):
                    main(["-m", paths["g3"], "-n", "1"] + extra)
    finally:
        jtrace.disable_trace()  # the JAX CLI leaves its session on when the engine raises
    assert seen == ["serve", "parity"] * 2
    assert trace.current() is None


def test_tp_mesh_refuses_serve_and_parity(paths):
    mesh = make_mesh(model=2, devices=[torch.device("cpu")] * 2)
    for mode in ("serve", "parity"):
        with pytest.raises(ValueError, match="tp_mesh"):
            Engine(paths["g3"], max_seq=64, mode=mode, device="cpu", tp_mesh=mesh)
