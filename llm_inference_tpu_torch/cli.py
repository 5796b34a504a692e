"""Command-line entry point: greedy decode with streaming output and tok/s reporting.

Counterpart of llm_inference_tpu/cli.py (reference main.cpp:27-241): the
same flags (-m/-p/-n/-t/-v/--no-cnv/--max-seq), greedy argmax, stop on
<end_of_turn>/<turn|>/EOS, the thinking-mode display switch, ▁ -> space
detokenization and the closing tok/s line, plus ``--device`` (default
``cuda``; ``cpu`` runs the plain twins of the kernels). The engine mode is
``serve``, or with ``--trace PATH`` ``parity``: its forward taps the
reference's named activations (trace.py), which are saved to PATH (.npz)
at the end, their summary printed to stderr. ``-t`` is accepted for
interface parity and ignored.
"""

from __future__ import annotations

import argparse
import sys
import time

DIM = "\x1b[90m"
RESET = "\x1b[0m"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="llm-inference-tpu-torch",
                                description="GGUF LLM inference on a CUDA GPU (PyTorch port)")
    p.add_argument("-m", "--model", required=True, help="Path to the GGUF model file")
    p.add_argument("-p", "--prompt", default="One sentence fact about silicon")
    p.add_argument("-n", "--predict", type=int, default=100, help="Tokens to predict")
    p.add_argument("-t", "--threads", type=int, default=0, help="(accepted; ignored)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--no-cnv", action="store_true", help="Do not apply chat template")
    p.add_argument("--max-seq", type=int, default=4096, help="KV cache capacity")
    p.add_argument("--trace", metavar="PATH", default=None,
                   help="Dump named activations (parity harness) to PATH")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from .gguf.reader import GGUFFile

    gguf = GGUFFile(args.model)
    if args.verbose:
        # container dump (reference main.cpp:73-84, gguf.cpp:306-327)
        h = gguf.header
        print("GGUF File Information:", file=sys.stderr)
        print(f"Version: {h.version}", file=sys.stderr)
        print(f"Tensor count: {h.tensor_count}", file=sys.stderr)
        print(f"Metadata KV count: {h.metadata_kv_count}", file=sys.stderr)
        print("\nTensors:\n", file=sys.stderr)
        for info in gguf.tensor_infos:
            shape = ", ".join(str(d) for d in info.shape)
            print(f"{info.name}: shape = [{shape}], elements = {info.total_elements}, "
                  f"type = {info.tensor_type.name}, offset = {info.offset}", file=sys.stderr)
        print("\nMetadata:\n", file=sys.stderr)
        for key, value in gguf.metadata.items():
            sv = str(value)
            if len(sv) > 200:  # token lists etc.
                sv = sv[:200] + f"... ({len(value) if hasattr(value, '__len__') else ''} items)"
            print(f"{key} = {sv}", file=sys.stderr)

    from .trace import current, disable_trace, enable_trace

    if args.trace:
        enable_trace(args.trace)
    try:
        _generate(args, gguf)
        if args.trace:
            session = current()
            session.save()
            print(session.summary(), file=sys.stderr)
            print(f"activation trace written to {args.trace}", file=sys.stderr)
    finally:
        if args.trace:
            disable_trace()
    return 0


def _generate(args, gguf) -> None:
    """Build the engine, stream the generated text, print the tok/s line."""
    from .engine import Engine, GenerationStats

    # tracing needs the parity mode's tappable, unfused per-op forward
    engine = Engine(gguf, max_seq=args.max_seq, mode="parity" if args.trace else "serve",
                    device=args.device)
    tok = engine.tokenizer

    if args.verbose:
        hp = engine.hparams
        print(f"arch={hp.architecture} layers={hp.block_count} d_model={hp.embedding_length} "
              f"heads={hp.n_head}/{hp.n_head_kv} vocab={hp.vocab_size} "
              f"device={engine.device}", file=sys.stderr)

    print(f"Prompt: {args.prompt}\n")

    enc = tok.encode(args.prompt, not args.no_cnv)
    state = {"thinking": enc.prefilled_thinking}
    if state["thinking"]:
        print(f"{DIM}[Start thinking]")

    def on_token(tid: int) -> None:
        # thinking-token display switch (reference main.cpp:205-213)
        if tid == tok.think_id:
            state["thinking"] = True
            print(f"{DIM}\n[Start thinking]")
        elif tid == tok.channel_id:
            state["thinking"] = False
            print(f"{RESET}\n[End thinking]\n")
        else:
            print(tok.piece(tid), end="", flush=True)

    stats = GenerationStats()
    t0 = time.perf_counter()
    engine.generate(args.prompt, n_predict=args.predict, apply_chat_template=not args.no_cnv,
                    on_token=on_token, stats=stats)
    wall = time.perf_counter() - t0

    if args.verbose and stats.first_logits is not None:
        # top-10 first-step logits (reference main.cpp:175-190)
        first_logits = stats.first_logits.float().cpu().numpy()
        order = first_logits.argsort()[::-1][:10]
        print("\nTop 10 most likely tokens:", file=sys.stderr)
        for tid in order:
            print(f"{tok.piece(int(tid))}: {first_logits[tid]:.4f} {int(tid)}", file=sys.stderr)

    if state["thinking"]:
        print(RESET, end="")
    print()
    print(f"\nGenerated {stats.generated_tokens} tokens in {wall:.3f} s "
          f"({stats.decode_tok_per_s:.2f} tok/s decode, "
          f"prefill {stats.prompt_tokens} tokens in {stats.prefill_seconds:.3f} s)")


if __name__ == "__main__":
    raise SystemExit(main())
