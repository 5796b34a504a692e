#!/usr/bin/env python3
"""Greedy-stream parity of the PyTorch port on a CUDA GPU (counterpart of
tools/greedy_parity.py, which runs the JAX package):

    python tools/torch_greedy_parity.py [--steps 100] [--modes serve-q8 serve-q4 ...]
    python tools/torch_greedy_parity.py --golden tests/golden/gemma4_g4_tame.json
    python tools/torch_greedy_parity.py -m model.gguf --golden g.json --device cpu
    LLMI_REFERENCE_DIR=... python tools/torch_greedy_parity.py --reference

Each mode's ``Engine`` (max_seq 512, decode_chunk 16, stop ids off, as the
JAX tool builds it) streams greedily from the golden's prompt, and the
stream is compared token by token with the golden JSON's ``tokens``:
``tests/golden/parity_1b_tame.json`` by default, on the tame Gemma-3-1B
checkpoint that ``chip_smoke.tame_checkpoint`` writes with the port's
writer; ``gemma4_g4_tame.json`` takes ``chip_smoke.gemma4_checkpoint``'s
(``-m`` names another checkpoint). With ``--reference`` the golden stream
is instead the reference C++ engine's, through tests/oracle_harness.py,
built from the sources under ``LLMI_REFERENCE_DIR``; without them the
tool stops with an error that names the variable.

Prints the JAX tool's table (mode, weights, tokens matched, first
divergence) with the card's name and power limit; ``--out PATH`` also
writes it there. Exits as the JAX tool does: 1 on an error in any mode or
a divergence in ``parity`` (the reference's numeric contract), else 0.
Runs on ``cuda`` unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

ALL_MODES = ["parity", "serve", "serve-q", "serve-q4", "serve-q8"]
DESCR = {
    "parity": "exact dequant, reference numeric contract",
    "serve": "bf16 dequantized",
    "serve-q": "int8 + exact group scales (lossless repack)",
    "serve-q4": "nibble-packed 4-bit, lossless repack",
    "serve-q8": "per-row int8 requant (lossy, <=0.8% weight err)",
}
GOLDEN = ROOT / "tests" / "golden" / "parity_1b_tame.json"


def checkpoint_for(golden: dict) -> Path:
    """The synthetic checkpoint a golden was recorded on, written by
    chip_smoke's builders (cached in the temp directory)."""
    import chip_smoke as c

    if golden["checkpoint"].get("writer") == "chip_smoke.gemma4_checkpoint":
        path = c.gemma4_checkpoint()
        if c.sha256_of(path) != golden["checkpoint"]["sha256"]:
            raise RuntimeError(f"{path} is not the checkpoint the golden was recorded on")
        return path
    return c.tame_checkpoint()


def reference_stream(path, prompt_ids: list[int], steps: int) -> list[int]:
    """The reference C++ engine's greedy stream (tests/oracle_harness.py),
    from the sources under LLMI_REFERENCE_DIR."""
    ref_dir = os.environ.get("LLMI_REFERENCE_DIR")
    if not ref_dir or not Path(ref_dir).is_dir():
        raise RuntimeError("the C++ leg needs the reference sources: set LLMI_REFERENCE_DIR to "
                           "their directory (gguf.cpp, ops.cpp, model.cpp)")
    sys.path.insert(0, str(ROOT / "tests"))
    from oracle_harness import OracleModel

    from llm_inference_tpu_torch.gguf.reader import GGUFFile
    from llm_inference_tpu_torch.models.hparams import load_hparams

    vocab = load_hparams(GGUFFile(str(path)).metadata).vocab_size
    ref = OracleModel(Path(path).read_bytes())
    try:
        logits = ref.forward(list(prompt_ids), 0, vocab)
        out, pos = [], len(prompt_ids)
        for _ in range(steps):
            out.append(int(logits.argmax()))
            logits = ref.forward([out[-1]], pos, vocab)
            pos += 1
    finally:
        ref.close()
    return out


def engine_stream(path, mode: str, prompt_ids: list[int], steps: int, device) -> list[int]:
    from llm_inference_tpu_torch.engine import Engine

    t0 = time.perf_counter()
    eng = Engine(str(path), max_seq=512, mode=mode, decode_chunk=16, device=device)
    eng.tokenizer.eos_id = -1
    eng.tokenizer.end_of_turn_id = -1
    out = eng.generate_from_ids(list(prompt_ids), n_predict=steps)
    print(f"{mode}: {len(out)} tokens on the {eng.decode_route} route in "
          f"{time.perf_counter() - t0:.1f} s (with the load)", file=sys.stderr)
    return out


def matched(got: list[int], golden: list[int]) -> tuple[int, str]:
    """Tokens matched before the first divergence, and the table's cell for it."""
    n = 0
    for a, b in zip(got, golden):
        if a != b:
            break
        n += 1
    if n == len(golden):
        return n, "— (identical stream)"
    return n, f"step {n}: ref {golden[n]} vs {got[n] if n < len(got) else 'EOS'}"


def run(path, modes, prompt_ids: list[int], golden: list[int],
        device) -> tuple[list[str], bool, dict]:
    """The table's rows for ``modes``, whether the exit rule passes, and
    each mode's (matched, stream) (None where the mode raised)."""
    rows, ok, got = [], True, {}
    for mode in modes:
        try:
            out = engine_stream(path, mode, prompt_ids, len(golden), device)
        except Exception as e:  # record, keep going
            rows.append(f"| {mode} | {DESCR.get(mode, '')} | ERROR | {e} |")
            got[mode] = None
            ok = False
            continue
        n, first = matched(out, golden)
        if n < len(golden) and mode == "parity":
            ok = False
        rows.append(f"| {mode} | {DESCR.get(mode, '')} | {n}/{len(golden)} | {first} |")
        got[mode] = (n, out)
        print(f"{mode}: matched {n}/{len(golden)}", file=sys.stderr)
    return rows, ok, got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=None, help="default: the golden's")
    ap.add_argument("--modes", nargs="*", default=ALL_MODES)
    ap.add_argument("--golden", default=str(GOLDEN))
    ap.add_argument("-m", "--model", default=None,
                    help="the checkpoint (default: the golden's synthetic one)")
    ap.add_argument("--reference", action="store_true",
                    help="compare with the C++ engine's stream (LLMI_REFERENCE_DIR)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the table to this file")
    args = ap.parse_args(argv)

    from llm_inference_tpu_torch.card import card_line

    golden = json.loads(Path(args.golden).read_text())
    prompt = golden["prompt"]
    steps = args.steps or golden["steps"]
    path = Path(args.model) if args.model else checkpoint_for(golden)
    if args.reference:
        try:
            want = reference_stream(path, prompt, steps)
        except RuntimeError as e:
            print(f"torch_greedy_parity: {e}", file=sys.stderr)
            return 2
        source = "the reference C++ engine (tests/oracle_harness.py)"
    else:
        want = golden["tokens"][:steps]
        if len(want) < steps:
            print(f"the golden holds {len(want)} tokens, fewer than --steps {steps}",
                  file=sys.stderr)
            return 2
        source = f"the golden {Path(args.golden).name}"
    rows, ok, _ = run(path, args.modes, prompt, want, args.device)
    lines = [
        f"# Greedy-stream parity of the PyTorch port ({card_line(args.device)})",
        "",
        f"Reference: {source}, {steps} greedy tokens from its {len(prompt)}-token prompt on "
        f"{path.name}.",
        "",
        "| mode | weights | tokens matched | first divergence |",
        "|---|---|---|---|",
        *rows,
    ]
    out = "\n".join(lines) + "\n"
    print(out)
    if args.out:
        Path(args.out).write_text(out)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
