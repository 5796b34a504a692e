#!/usr/bin/env python3
"""Where the grouped quant_matmul / q4_matmul kernel (csrc/qmatmul.cu) spends
its time, on one NVIDIA GPU:

    python tools/qmatmul_profile.py [--sweep]

For the four Gemma-3-1B layer shapes (and the four 12B ones) at T = 1 and
T = 32, on chip_smoke's Q4_0-like int8 and Q4_0 nibble weights, it prints
the call's device time (CUDA graph over cold weight copies, as chip_smoke
times it) and one launch's per-block globaltimer profile: the blocks' span
from the first block's entry to the last block's end, how far their entries
spread (a second wave starts late), the SMs holding two blocks, and the
mean and the largest per block of x's staging (from the block's entry),
the further wait for the first weight stage, the stage loop (and per
stage), and the epilogue (the last split's reduction included). With
``--sweep`` it also times each 1B shape over ring depths and C splits
around the plan's (``qmatmul.plan`` replaced for the sweep), beside
torch.matmul on the pre-dequantized bf16 weights. The last line is the
card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402

SHAPES = {"1B": c.layer_shapes(c.GEOM_1B), "12B": c.layer_shapes(c.GEOM_12B)}
VARIANTS = {"int8 Q4_0": (False, 32, (-8, 7), False), "nibble Q4_0": (True, 32, (-8, 7), False)}


def weights(R, C, nibble, gs, lo, hi, off, g):
    qbytes = R * C // (2 if nibble else 1) + 4 * R * (C // gs) * (2 if off else 1)
    return [c._grouped_weight(R, C, nibble, gs, lo, hi, off, g)
            for _ in range(max(1, math.ceil(100e6 / qbytes)))]


def profile(qt, x, nibble):
    import torch

    from llm_inference_tpu_torch.ops.kernels import qmatmul

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = qmatmul.plan(qt.rows, qt.cols, x.shape[0], nibble, qt.group_size, qt.offset is not None,
                     sms)
    prof = torch.zeros((p.row_tiles * p.splits, 8), dtype=torch.int64, device=x.device)
    qmatmul._launch(qt, x, qt.packed if nibble else qt.q, sms, nibble=nibble, prof=prof)
    torch.cuda.synchronize()
    m = prof.cpu().double()
    t0 = m[:, 0].min()
    entry, xs, first, loop, end, sm, prod, nk = (m[:, i] for i in range(8))
    two = int((torch.bincount(sm.long()) >= 2).sum())
    per_stage = ((loop - first) / (nk - 1).clamp(min=1))[nk > 1]

    def ms(d):
        return f"{d.mean() / 1e3:.2f} / {d.max() / 1e3:.2f} us"

    return (f"plan splits {p.splits} blocks {p.row_tiles * p.splits} ({two} SMs held two) "
            f"smem {p.smem}: span {(end.max() - t0) / 1e3:.2f} us, "
            f"entries spread {(entry.max() - t0) / 1e3:.2f} us; a block (mean / max): x "
            f"{ms(xs - entry)}, first stage {ms(first - xs)}, loop {ms(loop - first)} "
            f"({per_stage.mean() / 1e3 if len(per_stage) else 0:.3f} a stage), epilogue "
            f"{ms(end - loop)}, producer done {ms(prod - entry)}")


def sweep(qts, x, nibble, lib_ms):
    import torch

    from llm_inference_tpu_torch.ops.kernels import qmatmul

    fn = qmatmul.q4_matmul if nibble else qmatmul.quant_matmul
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    qt = qts[0]
    base = qmatmul.plan(qt.rows, qt.cols, x.shape[0], nibble, qt.group_size, False, sms)
    plan = qmatmul.plan
    out = []
    try:
        for ring in (4, 6, 8):
            for splits in sorted({max(1, base.splits // 2), base.splits, 2 * base.splits}):
                if splits > base.row_stages:
                    continue
                x_stages = -(-base.row_stages // splits)
                scale_bytes = qmatmul.ROW_TILE * (base.stage_cols // qt.group_size) * 4
                smem = (ring * (qmatmul.STAGE_QBYTES + scale_bytes) + 16 * ring + 16
                        + x_stages * (base.stage_cols // 16) * (32 * base.n_inst + 16))
                if smem > qmatmul.SMEM_MAX:
                    continue
                p = dataclasses.replace(base, stages=ring, splits=splits, x_stages=x_stages,
                                        smem=smem)
                qmatmul.plan = lambda *a, p=p: p
                ms = c.graph_ms(lambda i: fn(qts[i % len(qts)], x), len(qts))
                out.append(f"ring {ring} splits {splits} smem {smem}: {ms * 1e3:.2f} us")
    finally:
        qmatmul.plan = plan
    return "; ".join(out) + f"; torch.matmul bf16 {lib_ms * 1e3:.2f} us"


def main() -> int:
    import torch

    from llm_inference_tpu_torch.ops.kernels import _build, qmatmul

    do_sweep = "--sweep" in sys.argv[1:]
    c.phase_device()
    _build.build_all(("qmatmul",))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    for geom, shapes in SHAPES.items():
        for vname, (nibble, gs, (lo, hi), off) in VARIANTS.items():
            fn = qmatmul.q4_matmul if nibble else qmatmul.quant_matmul
            for T in (1, 32):
                total = 0.0
                for name, (R, C) in shapes.items():
                    qts = weights(R, C, nibble, gs, lo, hi, off, g)
                    x = torch.randn((T, C), device=dev, generator=g)
                    ms = c.graph_ms(lambda i: fn(qts[i % len(qts)], x), len(qts))
                    total += ms
                    print(f"{geom} {vname} {name} {R}x{C} T={T}: {ms * 1e3:.2f} us; "
                          f"{profile(qts[0], x, nibble)}", flush=True)
                    if do_sweep and geom == "1B":
                        wds = [qt.dequant(torch.bfloat16) for qt in qts[:2]]
                        xb = x.to(torch.bfloat16)
                        lib = c.graph_ms(lambda i: torch.matmul(xb, wds[i % 2].T), 2)
                        print(f"  sweep: {sweep(qts, x, nibble, lib)}", flush=True)
                        del wds
                    del qts
                print(f"{geom} {vname} T={T}: {total * 1e3:.2f} us over the four shapes",
                      flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
