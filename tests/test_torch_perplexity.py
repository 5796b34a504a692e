"""The port's perplexity tool (tools/torch_perplexity.py) against the JAX
one (tools/perplexity.py) on the CPU.

Bar: the same number of scored positions, and a mean NLL and each
position's log-prob within 3e-2 * max(1, max|logits|) of the JAX tool's
(twice the suite's logit bar of tests/test_fused_decode.py: a log-softmax
entry moves by at most twice its inputs' largest change), in serve,
serve-q, serve-q4 and serve-q8 on the route each package takes on the CPU,
and in serve-q8 on a gemma4 fixture. On the Gemma-3 fixture both packages
do the same f32 arithmetic on the CPU, so each position's log-prob is also
held within 1e-5 * max(1, max|logits|) (4.8e-7 seen). The JAX tool's
per-position log-probs come from its own run in chunks of one position,
each recovered from the running mean its progress callback reports.
The JAX tests' two properties hold for the port (the model's own stream
beats a shuffled one; serve and serve-q8 within 5%), and the port refuses a
stream longer than its cache, which the JAX tool scores without complaint
and with another result than a cache that fits."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import perplexity as jtool  # noqa: E402
import torch_perplexity as tool  # noqa: E402
from fixtures import build_gemma3_gguf, build_gemma4_gguf  # noqa: E402
from llm_inference_tpu.engine import Engine as JEngine  # noqa: E402
from llm_inference_tpu_torch.engine import Engine  # noqa: E402
from torch_jax_native import jax_native  # noqa: E402,F401  (autouse: the JAX default route)

CHUNK = 8


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("ppl")
    out = {}
    for name, buf in {"g3": build_gemma3_gguf(n_layers=2, seed=33, weight_std=0.05),
                      "g4": build_gemma4_gguf(n_layers=4, shared_kv_layers=1)}.items():
        (d / f"{name}.gguf").write_bytes(bytes(buf))
        out[name] = str(d / f"{name}.gguf")
    return out


def _stream(n: int = 41, seed: int = 1) -> list[int]:
    rng = np.random.default_rng(seed)
    return [2] + rng.integers(4, 25, size=n - 1).tolist()


def _no_stop(eng):
    eng.tokenizer.eos_id = -1
    eng.tokenizer.end_of_turn_id = -1
    return eng


def _port(path, mode, max_seq=128):
    return Engine(path, max_seq=max_seq, mode=mode, decode_chunk=CHUNK, device="cpu")


def _jax_logprobs(eng, ids) -> np.ndarray:
    """tools/perplexity.py's log p of each of ids[1:]: one position a chunk,
    each recovered from the running mean NLL its progress reports."""
    means = []
    jtool.perplexity(eng, ids, chunk=1, progress=lambda n, m: means.append((n, m)))
    return -np.diff([0.0] + [n * m for n, m in means])


@pytest.mark.parametrize("name,mode", [("g3", "serve"), ("g3", "serve-q"), ("g3", "serve-q4"),
                                       ("g3", "serve-q8"), ("g4", "serve-q8")])
def test_perplexity_matches_jax(paths, name, mode):
    ids = _stream()
    jeng = JEngine(paths[name], max_seq=128, mode=mode, decode_chunk=CHUNK)
    _, want_nll, want_n = jtool.perplexity(jeng, ids, chunk=CHUNK)
    want_lps = _jax_logprobs(jeng, ids)
    eng = _port(paths[name], mode)
    lps, amax = tool.token_logprobs(eng, ids, chunk=CHUNK, with_max=True)
    ppl, nll, n = tool.perplexity(eng, ids, chunk=CHUNK)
    assert n == want_n == len(ids) - 1 == lps.size == want_lps.size
    assert nll == pytest.approx(float(-lps.astype(np.float64).mean()), abs=1e-6)
    assert ppl == pytest.approx(np.exp(nll))
    assert want_nll == pytest.approx(float(-want_lps.mean()), abs=1e-6)
    scale = max(1.0, float(amax.max()))
    assert abs(nll - want_nll) <= 3e-2 * scale, (mode, nll, want_nll)
    gap = np.abs(lps.astype(np.float64) - want_lps)
    assert np.all(gap <= 3e-2 * np.maximum(1.0, amax)), (mode, gap.max())
    if name == "g3":
        assert gap.max() <= 1e-5 * scale, (mode, gap.max())


def test_perplexity_own_stream_beats_shuffled(paths):
    eng = _no_stop(_port(paths["g3"], "serve"))
    prompt = [2, 7, 8]
    stream = prompt + eng.generate_from_ids(list(prompt), n_predict=24)
    ppl_own, _, n = tool.perplexity(eng, stream, chunk=CHUNK)
    assert n == len(stream) - 1
    rng = np.random.default_rng(0)
    shuffled = [2] + rng.integers(4, 20, size=len(stream) - 1).tolist()
    ppl_rand, _, _ = tool.perplexity(eng, shuffled, chunk=CHUNK)
    assert ppl_own < ppl_rand, (ppl_own, ppl_rand)


def test_perplexity_bitwidths_agree(paths):
    ids = _stream()
    _, nll1, _ = tool.perplexity(_port(paths["g3"], "serve"), ids, chunk=CHUNK)
    _, nll2, _ = tool.perplexity(_port(paths["g3"], "serve-q8"), ids, chunk=CHUNK)
    assert abs(nll1 - nll2) / max(nll1, 1e-6) < 0.05, (nll1, nll2)


def test_stream_past_the_cache_is_the_reference_fault(paths):
    """tools/perplexity.py:108 sizes the cache to max(256, 2 * chunk) and
    perplexity() calls forward directly: positions past max_seq go through
    XLA's clamped cache update with no error and another result. The port
    refuses such a stream; with a cache that fits it agrees with JAX."""
    ids = _stream()  # 40 scored positions
    small = JEngine(paths["g3"], max_seq=16, mode="serve-q8", decode_chunk=CHUNK)
    _, clamped, n = jtool.perplexity(small, ids, chunk=CHUNK)
    _, fits, _ = jtool.perplexity(JEngine(paths["g3"], max_seq=64, mode="serve-q8",
                                          decode_chunk=CHUNK), ids, chunk=CHUNK)
    assert n == 40 and np.isfinite(clamped) and clamped != fits
    with pytest.raises(ValueError, match="max_seq"):
        tool.perplexity(_port(paths["g3"], "serve-q8", max_seq=16), ids, chunk=CHUNK)
    with pytest.raises(ValueError, match="at least 2"):
        tool.perplexity(_port(paths["g3"], "serve-q8", max_seq=16), [2], chunk=CHUNK)
    _, nll, _ = tool.perplexity(_port(paths["g3"], "serve-q8", max_seq=64), ids, chunk=CHUNK)
    assert abs(nll - fits) <= 3e-2 * max(1.0, abs(fits))


def test_cli_sizes_the_cache_to_the_stream(paths, tmp_path, capsys):
    ids = _stream(300, seed=3)
    (tmp_path / "ids.txt").write_text(" ".join(map(str, ids)))
    out = tmp_path / "ppl.txt"
    rc = tool.main(["-m", paths["g3"], "--token-file", str(tmp_path / "ids.txt"), "--mode",
                    "serve-q8", "--chunk", "64", "--max-tokens", "290", "--device", "cpu",
                    "--out", str(out)])
    assert rc == 0
    text = capsys.readouterr()
    assert "max_seq 512" in text.err  # 289 scored positions: JAX's CLI would size 256
    assert "perplexity:" in text.out and "289 tokens" in text.out and "device cpu" in text.out
    assert out.read_text().splitlines()[-1] == text.out.splitlines()[-1]
    assert [tool.cache_for(n) for n in (2, 257, 258, 600)] == [256, 256, 512, 768]
