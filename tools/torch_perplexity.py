#!/usr/bin/env python3
"""Perplexity of a GGUF checkpoint under the PyTorch port, on a CUDA GPU
(counterpart of tools/perplexity.py, which runs the JAX package):

    python tools/torch_perplexity.py -m model.gguf -t corpus.txt --mode serve-q8
    python tools/torch_perplexity.py -m model.gguf --token-file ids.txt --device cpu

Teacher forcing: the stream's tokens ``ids[:-1]`` go through the engine's
decode path one position at a time, each position one
``models.gemma.forward`` call over one token (the T = 1 dispatch: the
whole-step kernel on the kernel route, the per-op kernels under
``LLMI_NO_FUSED_DECODE=1``), and the log-probability of the next token
``ids[1:]`` is gathered on the device from an f32 log-softmax. The
positions go in chunks of ``--chunk``; only a chunk's floats cross to the
host, in one copy. ppl = exp(-mean log p). The JAX tool's scan pads the
last chunk to a fixed shape and drops the padded tail; eager PyTorch runs
the last chunk's live positions only.

Every scored position must fit the engine's cache: ``perplexity`` raises
for a stream longer than ``engine.max_seq`` (the JAX tool's positions past
its cache are written through a clamped update with no error, and its CLI
sizes the cache to max(256, 2 * chunk) whatever ``--max-tokens`` is), and
this CLI sizes ``max_seq`` to the scored tokens. It runs on ``cuda``
unless given ``--device cpu`` and prints the card's name and power limit
with the result; ``--out PATH`` also writes the result there.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MODES = ("serve", "serve-q", "serve-q4", "serve-q8")


def token_logprobs(engine, token_ids, *, chunk: int = 64, progress=None,
                   with_max: bool = False):
    """log p(ids[i + 1] | ids[: i + 1]) for every i, as f32 numpy [n - 1];
    with ``with_max`` also each position's max|logits| (a second row of the
    chunk's one host copy). Raises when the stream does not fit the cache."""
    from llm_inference_tpu_torch.models.gemma import forward

    if getattr(engine, "_tp", None) is not None:
        raise ValueError("perplexity scores on one device: build the Engine without tp_mesh")
    ids = np.asarray(token_ids, dtype=np.int64)
    if ids.ndim != 1 or ids.size < 2:
        raise ValueError("need at least 2 tokens to score")
    vocab = engine.weights.token_embd.rows
    if ids.min() < 0 or ids.max() >= vocab:
        raise ValueError(f"token ids must lie in [0, {vocab})")
    n = ids.size - 1
    if n > engine.max_seq:
        raise ValueError(f"the stream feeds {n} positions but the engine's cache holds "
                         f"max_seq = {engine.max_seq}; build it with max_seq >= {n}")
    dev = engine.device
    feed = torch.from_numpy(ids[:-1]).to(dev)
    tgt = torch.from_numpy(ids[1:]).to(dev)
    positions = torch.arange(n, dtype=torch.int32, device=dev)
    hp, w = engine.hparams, engine.weights
    cache = engine.new_cache()
    rows = 2 if with_max else 1
    out = np.empty((rows, n), dtype=np.float32)
    for lo in range(0, n, chunk):
        k = min(chunk, n - lo)
        got = torch.empty((rows, k), dtype=torch.float32, device=dev)
        for i in range(lo, lo + k):
            logits, cache = forward(hp, w, cache, feed[i : i + 1], positions[i : i + 1],
                                    consts=engine._consts, exact=engine.exact)
            logits = logits.float()
            got[0, i - lo] = torch.log_softmax(logits, dim=-1)[tgt[i]]
            if with_max:
                got[1, i - lo] = logits.abs().max()
        out[:, lo : lo + k] = got.cpu().numpy()
        if progress:
            progress(lo + k, float(-out[0, : lo + k].astype(np.float64).mean()))
    return (out[0], out[1]) if with_max else out[0]


def perplexity(engine, token_ids, *, chunk: int = 64, progress=None):
    """exp(-mean log p) of ``token_ids[1:]`` under teacher forcing.

    Returns (ppl, mean_nll, n_scored)."""
    lps = token_logprobs(engine, token_ids, chunk=chunk, progress=progress)
    mean_nll = float(-lps.astype(np.float64).mean())
    return math.exp(mean_nll), mean_nll, int(lps.size)


def cache_for(n_tokens: int) -> int:
    """The CLI's ``max_seq`` for a stream of ``n_tokens``: its scored
    positions, rounded up to a multiple of 256 (the kernels' cache tiles)."""
    return max(256, -(-(n_tokens - 1) // 256) * 256)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-t", "--text", help="UTF-8 text file to score")
    ap.add_argument("--token-file", help="whitespace-separated token ids (skips the tokenizer)")
    ap.add_argument("--mode", default="serve-q8", choices=MODES)
    ap.add_argument("--max-tokens", type=int, default=2048)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the result line to this file")
    args = ap.parse_args(argv)

    from llm_inference_tpu_torch.card import card_line
    from llm_inference_tpu_torch.engine import Engine
    from llm_inference_tpu_torch.gguf.reader import GGUFFile
    from llm_inference_tpu_torch.models.hparams import load_hparams
    from llm_inference_tpu_torch.tokenizer import Tokenizer

    gguf = GGUFFile(args.model)
    if args.token_file:
        ids = [int(x) for x in Path(args.token_file).read_text().split()]
    elif args.text:
        hp = load_hparams(gguf.metadata)
        text = Path(args.text).read_text(encoding="utf-8")
        ids = Tokenizer(gguf.metadata, hp.architecture).encode(text, False).ids
    else:
        print("need -t/--text or --token-file", file=sys.stderr)
        return 2
    ids = ids[: args.max_tokens]
    if len(ids) < 2:
        print(f"need at least 2 tokens to score, got {len(ids)}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    eng = Engine(gguf, max_seq=cache_for(len(ids)), mode=args.mode, decode_chunk=args.chunk,
                 device=args.device)
    print(f"loaded {args.model} ({args.mode}, {eng.decode_route} route, max_seq "
          f"{eng.max_seq}) in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(f"scoring {len(ids)} tokens", file=sys.stderr)

    def prog(n, nll):
        print(f"  {n} positions, running ppl {math.exp(nll):.3f}", file=sys.stderr)

    t0 = time.perf_counter()
    ppl, nll, n = perplexity(eng, ids, chunk=args.chunk, progress=prog)
    secs = time.perf_counter() - t0
    lines = [card_line(eng.device),
             f"perplexity: {ppl:.4f} (mean nll {nll:.4f}, {n} tokens, mode {args.mode}, "
             f"{eng.decode_route} route, {secs:.2f} s)"]
    print("\n".join(lines))
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
