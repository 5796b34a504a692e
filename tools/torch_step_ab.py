#!/usr/bin/env python3
"""Time the port's single-stream whole-step kernels of two checkouts in
turns on one NVIDIA GPU, so that two versions are compared on one card in
one run:

    python tools/torch_step_ab.py DIR_A DIR_B
    python tools/torch_step_ab.py --batched DIR_A DIR_B

Each of DIR_A, DIR_B, DIR_B, DIR_A (a checkout of the repo each, e.g. the
parent unpacked with ``git archive`` into an ignored directory) runs in its
own process, from its own chip_smoke.py: the per-row int8 step's phase 4
(its kernel-vs-plain check at the Gemma-3-1B shapes, the time a step at
position 300, the depth sweep and the per-phase profile), then, where the
checkout has the lossless step, that step's time on chip_smoke's random
serve-q int8 and serve-q4 nibble weights (the same seeds in every
checkout). With ``--batched`` each process times the dense batched whole
step instead (csrc/fused_decode_batch.cu): B = 32 lanes of 1024 slots
ragged over positions 0..1000 and four parked (chip_smoke's phase 6
lanes), chip_smoke's random 1B int8 weights, the device time of a greedy
step through a CUDA graph, three times. The lines are prefixed with the
checkout; the last is the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys

PROBE = r"""
import torch
import chip_smoke as c

c.phase_device()
c.phase_build()
c.phase_decode_step()
if hasattr(c, "_random_lossless_model"):
    from llm_inference_tpu_torch.models.gemma import init_cache
    from llm_inference_tpu_torch.ops.kernels import fused_decode_q

    hp = c._hp_1b()
    dev = torch.device("cuda")
    S, pos = 1024, 300
    cache = init_cache(hp, S, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
    token = torch.tensor([12345], dtype=torch.int64, device=dev)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    for label, nibble in (("serve-q int8", False), ("serve-q4 nibble+offsets", True)):
        w = c._random_lossless_model(hp, seed=7, nibble=nibble)
        consts = fused_decode_q.prepare(hp, dev, swa_mask=False, max_seq=S)
        ms = c.time_ms(lambda i=0: fused_decode_q.decode_step_q(hp, w, cache, token, p, consts), 50)
        c.log(f"decode_step_q random {label} 1B pos={pos}: kernel {ms:.4f} ms")
        del w
"""

PROBE_BATCHED = r"""
import torch
import chip_smoke as c
from llm_inference_tpu_torch.models.gemma import init_batched_cache
from llm_inference_tpu_torch.ops.kernels import fused_decode_batch

c.phase_device()
c.phase_build()
hp = c._hp_1b()
dev = torch.device("cuda")
B, S = c.BATCH, c.BATCH_SEQ
w = c._random_model(hp, seed=2)
g = torch.Generator(device=dev).manual_seed(4)
cache = init_batched_cache(hp, B, S, device=dev)
cache.k.copy_(torch.randn(cache.k.shape, device=dev, generator=g))
cache.v.copy_(torch.randn(cache.v.shape, device=dev, generator=g))
pos = torch.tensor(c._batch_positions(S), dtype=torch.int32, device=dev)
tokens = torch.randint(0, c.VOCAB_SIZE, (B,), device=dev, generator=g, dtype=torch.int32)
consts = fused_decode_batch.prepare_batch(hp, dev, batch=B, max_seq=S)
for _ in range(3):
    ms = c.graph_ms(lambda i=0: fused_decode_batch.decode_step_batch(
        hp, w, cache, tokens, pos, consts, greedy=True), 4, replays=10)
    c.log(f"decode_step_batch random 1B B={B} ragged: device {ms:.4f} ms")
"""

KEEP = ("1B pos=300", "depth sweep", "phases", "1B B=", "FAIL")


def run(checkout: str, probe: str) -> None:
    out = subprocess.run([sys.executable, "-c", probe], cwd=checkout, capture_output=True,
                         text=True)
    for line in (out.stdout + out.stderr).splitlines():
        if any(k in line for k in KEEP):
            print(f"{checkout}: {line}", flush=True)
    if out.returncode != 0:
        print(f"{checkout}: exit {out.returncode}", flush=True)


def main() -> int:
    args = sys.argv[1:]
    batched = args[:1] == ["--batched"]
    args = args[1:] if batched else args
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = args
    for checkout in (a, b, b, a):
        run(checkout, PROBE_BATCHED if batched else PROBE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
