#!/usr/bin/env python3
"""Time the port's single-stream whole-step kernels of two checkouts in
turns on one NVIDIA GPU, so that two versions are compared on one card in
one run:

    python tools/torch_step_ab.py DIR_A DIR_B

Each of DIR_A, DIR_B, DIR_B, DIR_A (a checkout of the repo each, e.g. the
parent unpacked with ``git archive`` into an ignored directory) runs in its
own process, from its own chip_smoke.py: the per-row int8 step's phase 4
(its kernel-vs-plain check at the Gemma-3-1B shapes, the time a step at
position 300, the depth sweep and the per-phase profile), then, where the
checkout has the lossless step, that step's time on chip_smoke's random
serve-q int8 and serve-q4 nibble weights (the same seeds in every
checkout). The lines are prefixed with the checkout; the last is the
card's name and power limit.
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

KEEP = ("1B pos=300", "depth sweep", "phases", "FAIL")


def run(checkout: str) -> None:
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=checkout, capture_output=True,
                         text=True)
    for line in (out.stdout + out.stderr).splitlines():
        if any(k in line for k in KEEP):
            print(f"{checkout}: {line}", flush=True)
    if out.returncode != 0:
        print(f"{checkout}: exit {out.returncode}", flush=True)


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = sys.argv[1:]
    for checkout in (a, b, b, a):
        run(checkout)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
