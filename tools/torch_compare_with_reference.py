#!/usr/bin/env python3
"""Cross-engine activation diff of the PyTorch port against a reference dump
(counterpart of tools/compare_with_reference.py, which runs the JAX
package):

    python tools/torch_compare_with_reference.py -m model.gguf -p "prompt" --ref-dump dump.txt
    python tools/torch_compare_with_reference.py -m model.gguf --ref-dump cb.txt --dump-format eval-callback
    LLMI_REFERENCE_DIR=... python tools/torch_compare_with_reference.py -m model.gguf -p "prompt"

The port's exact forward (the parity mode's numeric contract: the
checkpoint's quants, exact products, the parity attention, an f16 cache)
runs over the prompt's tokens with the named taps of
``llm_inference_tpu_torch/trace.py`` on. The reference is a saved dump in
the reference printer's format or llama.cpp eval-callback's
(``--ref-dump``, ``--dump-format``), or, without ``--ref-dump``, the
reference C++ engine's verbose dump through tests/oracle_harness.py, built
from the sources under ``LLMI_REFERENCE_DIR`` (the tool stops with an
error naming the variable when they are absent). Tensors align by name and
occurrence (``parity.compare_values``); the report gives each one's
checksum divergence, the top offenders and the log-MSE plot, and
``parity.compare_sums`` decides: exit 0 and ``PARITY OK`` when no tensor's
sum is off by more than ``--rel-tol``, else exit 1 with the offenders
named. The JAX tool forces the CPU; this one runs on ``cuda`` (the parity
mode runs there with TF32 off, torch's default) unless given ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))


def port_records(model, ids: list[int], device) -> list[tuple]:
    """The taps of the port's exact forward over ``ids`` from position 0, in
    order: [(name, f32 numpy array)]."""
    from llm_inference_tpu_torch import trace
    from llm_inference_tpu_torch.engine import resolve_device
    from llm_inference_tpu_torch.gguf.reader import GGUFFile
    from llm_inference_tpu_torch.models.gemma import PARITY_KV_DTYPE, forward, init_cache
    from llm_inference_tpu_torch.models.weights import load_weights

    device = resolve_device(device)
    hp, w = load_weights(GGUFFile(str(model)), mode="packed", device=device)
    cache = init_cache(hp, max(64, len(ids) * 2), device=device, dtype=PARITY_KV_DTYPE)
    session = trace.enable_trace(os.devnull)
    try:
        forward(hp, w, cache, torch.tensor(ids, dtype=torch.int64, device=device), 0,
                exact=True)
    finally:
        trace.disable_trace()
    return session.records


def oracle_dump(model, ids: list[int], vocab: int) -> str:
    """The reference C++ engine's verbose dump of a forward over ``ids``."""
    ref_dir = os.environ.get("LLMI_REFERENCE_DIR")
    if not ref_dir or not Path(ref_dir).is_dir():
        raise RuntimeError("the C++ leg needs the reference sources: set LLMI_REFERENCE_DIR to "
                           "their directory (gguf.cpp, ops.cpp, model.cpp), or give --ref-dump")
    sys.path.insert(0, str(ROOT / "tests"))
    from oracle_harness import OracleModel, get_oracle

    lib = get_oracle()
    lib.oracle_set_verbose.argtypes = [ctypes.c_int]
    ref = OracleModel(Path(model).read_bytes())
    lib.oracle_set_verbose(1)
    try:
        with tempfile.TemporaryFile(mode="w+") as tf:
            saved = os.dup(1)
            sys.stdout.flush()
            os.dup2(tf.fileno(), 1)
            try:
                ref.forward(ids, 0, vocab)
            finally:
                sys.stdout.flush()
                os.dup2(saved, 1)
                os.close(saved)
            tf.seek(0)
            return tf.read()
    finally:
        lib.oracle_set_verbose(0)
        ref.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default="One sentence fact about silicon")
    ap.add_argument("--chat", action="store_true", help="apply the chat template")
    ap.add_argument("--rel-tol", type=float, default=1e-3)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--ref-dump", default=None,
                    help="use a saved verbose dump FILE as the reference instead of running "
                         "the compiled reference engine, e.g. llama.cpp's "
                         "llama-eval-callback output")
    ap.add_argument("--dump-format", choices=["reference", "eval-callback"],
                    default="reference",
                    help="format of --ref-dump: the reference engine's -v print_tensor dump, "
                         "or llama.cpp eval-callback")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="also write the comparison report (incl. the log-MSE plot) here")
    args = ap.parse_args(argv)

    from llm_inference_tpu_torch import parity
    from llm_inference_tpu_torch.card import card_line
    from llm_inference_tpu_torch.gguf.reader import GGUFFile
    from llm_inference_tpu_torch.models.hparams import load_hparams
    from llm_inference_tpu_torch.tokenizer import Tokenizer

    gguf = GGUFFile(args.model)
    hp = load_hparams(gguf.metadata)
    ids = Tokenizer(gguf.metadata, hp.architecture).encode(args.prompt, args.chat).ids
    print(f"tokens: {ids}", file=sys.stderr)

    if args.ref_dump:
        parse = (parity.parse_eval_callback_dump if args.dump_format == "eval-callback"
                 else parity.parse_reference_dump)
        ref_records = parse(Path(args.ref_dump).read_text())
    else:
        try:
            ref_records = parity.parse_reference_dump(oracle_dump(args.model, ids,
                                                                  hp.vocab_size))
        except RuntimeError as e:
            print(f"torch_compare_with_reference: {e}", file=sys.stderr)
            return 2
    print(f"reference: {len(ref_records)} named tensors", file=sys.stderr)
    records = port_records(args.model, ids, args.device)
    print(f"port ({args.device}): {len(records)} named tensors", file=sys.stderr)

    comps = parity.compare_values(ref_records, records)
    report = (card_line(args.device) + "\n" + parity.format_comparison_report(comps, top=args.top)
              + "\n\n" + parity.mse_logplot(comps))
    print(report)
    if args.out:
        Path(args.out).write_text(report + "\n")
        print(f"\nreport -> {args.out}", file=sys.stderr)

    div = parity.compare_sums(ref_records, records, rel_tol=args.rel_tol)
    if not div:
        print(f"\nPARITY OK: no per-tensor divergence above rel_tol={args.rel_tol}")
        return 0
    div.sort(key=lambda d: -d.rel_diff)
    print(f"\n{len(div)} tensors above rel_tol={args.rel_tol}; top offenders:")
    for d in div[: args.top]:
        print(f"  {d.name:36s} ref={d.ref_sum:14.6f} ours={d.our_sum:14.6f} rel={d.rel_diff:.3e}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
