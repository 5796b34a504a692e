#!/usr/bin/env python3
"""Where the capacity step's weight stream (csrc/fused_decode_stream.cu) spends
its tiles, on one NVIDIA GPU:

    python tools/stream_profile.py

It builds a copy of csrc/fused_decode_stream.cu with %globaltimer stamps
written into it (text substitutions on the source; the tool fails if the
source no longer has the places it stamps) and runs it at chip_smoke's
phase 13 inputs (Gemma-3-12B width and depth, position 300, random serve-q
int8 and serve-q4 nibbles with Q4_K offsets). For block 0 and every tile of
one step it records when the tile's copies were issued, when warp 0 began
to wait for it and got it, when each warp released its stage and when the
last one did; it prints, per GEMV phase over the layers, the mean of:
issue to arrival as warp 0 saw it, warp 0's wait, the tile's consumption
(arrival to the last release), the period between consecutive last
releases, the spread of the warps' releases and each warp's busy time a
tile (its release less the later of the arrival and its previous
release), with the step's device time beside. The last line is the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402

PRELUDE = r"""
__device__ unsigned long long* g_prof = nullptr;
__device__ __forceinline__ void stamp(int k, int col) {
  if (g_prof != nullptr && blockIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_prof[24 * (size_t)k + col] = t;
  }
}
"""
STAMPS = (  # (anchor, what replaces it)
    ("  int slot;\n  uint32_t parity;\n  __device__ void next(int stages) {",
     "  int slot;\n  uint32_t parity;\n  int idx = 0;  // the tile's index in the stream\n"
     "  __device__ void next(int stages) {\n    ++idx;"),
    ("  const TSeg& g = sc.seg[cur.kind];\n  const Part& pt = p.parts[cur.kind];",
     "  stamp(sc.total - cur.left, 0);\n"
     "  if (g_prof != nullptr && blockIdx.x == 0) g_prof[24 * (size_t)(sc.total - cur.left) + 4] = "
     "cur.kind;\n  const TSeg& g = sc.seg[cur.kind];\n  const Part& pt = p.parts[cur.kind];"),
    ("      mbar_wait(rg.full + k.slot, k.parity);",
     "      if (warp == 0 && lane == 0) stamp(k.idx, 1);\n"
     "      mbar_wait(rg.full + k.slot, k.parity);\n"
     "      if (warp == 0 && lane == 0) stamp(k.idx, 2);"),
    ("      release_tile(p, f, mp, sc, rg, cur);",
     "      if (lane == 0) stamp(k.idx, 5 + warp);\n      release_tile(p, f, mp, sc, rg, cur);\n"
     "      if (threadIdx.x == kIssuer) stamp(k.idx, 3);"),
)
PHASES = ("QKV", "Wo", "gate/up", "down", "logits")


def stamped_source() -> str:
    s = (ROOT / "llm_inference_tpu_torch/csrc/fused_decode_stream.cu").read_text()
    s = s.replace("namespace {\n", PRELUDE + "namespace {\n", 1)
    for anchor, stamped in STAMPS:
        if s.count(anchor) != 1:
            raise SystemExit(f"stream_profile: the kernel source changed: {anchor!r}")
        s = s.replace(anchor, stamped)
    s = s.replace("const char* fused_decode_stream_error_string",
                  "int stream_set_prof(void* ptr) {\n"
                  "  return (int)cudaMemcpyToSymbol(g_prof, &ptr, sizeof(ptr));\n}\n\n"
                  "const char* fused_decode_stream_error_string", 1)
    return s


def build(src: Path) -> ctypes.CDLL:
    from llm_inference_tpu_torch.ops.kernels import _build

    out = src.with_suffix(".so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                        str(out), str(src)], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.fused_decode_stream_grid.argtypes = [ctypes.c_int]
    lib.fused_decode_stream_smem.argtypes = [ctypes.c_int] * 10
    lib.fused_decode_stream_step.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int,
                                                                     ctypes.c_void_p]
    for fn in ("grid", "smem", "step"):
        getattr(lib, f"fused_decode_stream_{fn}").restype = ctypes.c_int
    lib.stream_set_prof.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    import torch

    from llm_inference_tpu_torch.models.gemma import init_cache
    from llm_inference_tpu_torch.ops.kernels import fused_decode_stream as fds

    c.phase_device()
    src = ROOT / "build" / "stream_profile" / "fused_decode_stream_stamped.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(stamped_source())
    lib = build(src)
    fds._lib = lambda: lib
    hp = c.hp_gemma3(**c.GEOM_12B, sliding_window=1024)
    dev = torch.device("cuda")
    S, pos = c.STREAM_SEQ, c.STREAM_POS
    g = torch.Generator(device=dev).manual_seed(13)
    cache = init_cache(hp, S, device=dev, flat=True)
    cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
    token = torch.tensor([200001], dtype=torch.int64, device=dev)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    for label, nibble in (("serve-q int8", False), ("serve-q4 nibble+offsets", True)):
        w = c._random_lossless_model(hp, seed=17, nibble=nibble)
        consts = fds.prepare(hp, dev, swa_mask=False, max_seq=S)
        ms = c.time_ms(lambda i=0: fds.decode_step_stream(hp, w, cache, token, p, consts), 10)
        (plan, _), = consts.scratch["plans"].values()
        prof = torch.zeros((20000, 24), dtype=torch.int64, device=dev)
        lib.stream_set_prof(ctypes.c_void_p(prof.data_ptr()))
        fds.decode_step_stream(hp, w, cache, token, p, consts)
        torch.cuda.synchronize()
        lib.stream_set_prof(None)
        m = prof.cpu().double()
        m = m[m[:, 3] > 0]  # the block's tiles
        period = torch.cat([torch.zeros(1, dtype=torch.float64), m[1:, 3] - m[:-1, 3]])
        out = []
        for k, name in enumerate(PHASES):
            sel = (m[:, 4] == k) & (m[:, 0] > 0)
            sel[0] = False
            x = m[sel]
            if not len(x):
                continue
            arrive = (x[:, 2] - x[:, 0]).mean() / 1e3
            wait = (x[:, 2] - x[:, 1]).mean() / 1e3
            consume = (x[:, 3] - x[:, 2]).mean() / 1e3
            per = period[sel].mean() / 1e3
            rel = x[:, 5:21]  # each warp's release
            skew = (rel.max(dim=1).values - rel.min(dim=1).values).mean() / 1e3
            prev = m[sel.nonzero().flatten() - 1][:, 5:21]
            busy = (rel - torch.maximum(prev, x[:, 2:3])).clamp(min=0).mean(dim=0) / 1e3
            out.append(f"{name} ({int(sel.sum())} tiles): issue->arrival {arrive:.2f}, warp-0 wait "
                       f"{wait:.2f}, consumption {consume:.2f}, period {per:.2f}, release skew "
                       f"{skew:.2f}, per-warp busy " + " ".join(f"{v:.2f}" for v in busy.tolist()))
        c.log(f"stream_profile 12B {label}: {ms:.4f} ms a step; plan {plan}; block 0, mean us a "
              "tile: " + "; ".join(out))
        del w, consts
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
