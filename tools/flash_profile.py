#!/usr/bin/env python3
"""Where the flash-decode kernel (csrc/flash_decode.cu) spends a call, on one
NVIDIA GPU:

    python tools/flash_profile.py

It builds a copy of csrc/flash_decode.cu with %globaltimer stamps written
into it (text substitutions on the source; the tool fails if the source no
longer has the places it stamps), once as it is and once with the K/V
copies left out (-DNOCOPY: the barriers complete at once, the kernel
computes on whatever shared memory holds), and runs both at chip_smoke's
phase 6 lanes (q [32, 4, 256], one KV head, 1024 slots, lanes ragged over
0..1000, four parked): the call's device time, cold over 26 layers' caches
through a CUDA graph, then one cold call's per-CTA profile: for the live
CTAs the mean and the largest time of each phase (setup to the first
barrier, the first K tile's wait, the first tile's scores, softmax, V wait
and P.V, the later tiles, the arrival, the last range's combine) and the
span from the first CTA's entry to the last CTA's end. The last line is the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402

STAMPS = (  # (anchor, text put before it): stamps 0-5 and 8-11
    ("  const int len = min(lengths[b], p.S);", "  STAMP(0);\n"),
    ("  // scores: a group of SUB lanes", "  STAMP(1);\n  PROF_SM();\n"),
    ("    for (int h0 = 0; h0 < G; h0 += 4) {", "    if (t == t0) STAMP(2);\n"),
    ("    // online softmax: warp w takes heads w", "    if (t == t0) STAMP(8);\n"),
    ("    mbar_wait(bars + p.stages + s, par);", "    if (t == t0) STAMP(9);\n"),
    ("    if (pv) {\n#pragma unroll\n      for (int i = 0; i < G4; ++i) {",
     "    if (t == t0) STAMP(10);\n"),
    ("    if (warp == 0 && t + p.stages < t1) {", "    if (t == t0) STAMP(11);\n"),
    ("  // the slot groups' sums, in group order", "  STAMP(3);\n"),
    ("  if (!*last) return;", "  STAMP(4);\n"),
    ("}\n\ntemplate <int SUB, int G4, bool PAGED>\nint launch_sub(", "  STAMP(5);\n"),
)
PRELUDE = r"""
__device__ unsigned long long* g_prof = nullptr;
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PIDX (16 * (((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x))
#define STAMP(k) \
  do { if (g_prof && threadIdx.x == 0) g_prof[PIDX + (k)] = now_ns(); } while (0)
#define PROF_SM()                                          \
  do {                                                     \
    if (g_prof && threadIdx.x == 0) {                      \
      unsigned int sm;                                     \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));      \
      g_prof[PIDX + 6] = sm;                               \
    }                                                      \
  } while (0)
"""
NOCOPY = (  # -DNOCOPY: complete both barriers without any copy
    ("    mbar_expect_tx(kbar, (uint32_t)(n * p.Dk * 2));\n"
     "    mbar_expect_tx(vbar, (uint32_t)(n * p.Dv * 2));\n",
     "#ifdef NOCOPY\n    mbar_expect_tx(kbar, 0u);\n    mbar_expect_tx(vbar, 0u);\n#else\n",
     "#endif\n"),
    ("  if (run > 0) {\n    const size_t row", "#ifdef NOCOPY\n  run = 0;\n#endif\n", ""),
)


def stamped_source() -> str:
    s = (ROOT / "llm_inference_tpu_torch/csrc/flash_decode.cu").read_text()
    s = s.replace("namespace {\n", PRELUDE + "namespace {\n", 1)
    for anchor, before in STAMPS:
        if s.count(anchor) != 1:
            raise SystemExit(f"flash_profile: the kernel source changed: {anchor!r}")
        s = s.replace(anchor, before + anchor)
    for anchor, before, after in NOCOPY:
        if s.count(anchor) != 1:
            raise SystemExit(f"flash_profile: the kernel source changed: {anchor!r}")
        i = s.index(anchor)
        s = s[:i] + before + anchor + after + s[i + len(anchor):]
    s = s.replace("const char* flash_decode_error_string",
                  "int flash_set_prof(void* ptr) {\n"
                  "  return (int)cudaMemcpyToSymbol(g_prof, &ptr, sizeof(ptr));\n}\n\n"
                  "const char* flash_decode_error_string", 1)
    return s


def build(src: Path, extra: list[str]) -> ctypes.CDLL:
    from llm_inference_tpu_torch.ops.kernels import _build

    out = src.with_suffix(f".{'nocopy' if extra else 'copy'}.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-I", str(_build.CSRC),
                        "-o", str(out), str(src)], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.flash_decode_fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                                     + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.paged_flash_decode_fwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                                           + [ctypes.c_float] + [ctypes.c_int] * 5
                                           + [ctypes.c_void_p])
    lib.flash_decode_fwd.restype = lib.paged_flash_decode_fwd.restype = ctypes.c_int
    lib.flash_set_prof.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    import torch

    from llm_inference_tpu_torch.ops.kernels import flash_decode

    c.phase_device()
    src = ROOT / "build" / "flash_profile" / "flash_decode_stamped.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(stamped_source())
    dev = torch.device("cuda")
    B, S, L, H, d = c.BATCH, c.BATCH_SEQ, 26, 4, 256
    g = torch.Generator(device=dev).manual_seed(9)
    pos = torch.tensor(c._batch_positions(S), dtype=torch.int32, device=dev)
    lengths = torch.where(pos >= S, torch.zeros_like(pos), pos + 1).to(torch.int32)
    starts = torch.zeros_like(lengths)
    q = torch.randn((B, H, d), device=dev, generator=g) * 0.06
    kc = torch.randn((L, B, S, 1, d), device=dev, generator=g).to(torch.bfloat16)
    vc = torch.randn((L, B, S, 1, d), device=dev, generator=g).to(torch.bfloat16)
    plan = flash_decode.plan(B, S, H, 1, d, d, None,
                             torch.cuda.get_device_properties(0).multi_processor_count)
    phases = (("setup", 0, 1), ("K0 wait", 1, 2), ("scores0", 2, 8), ("softmax0", 8, 9),
              ("V0 wait", 9, 10), ("P.V0", 10, 11), ("later tiles", 11, 3), ("arrive", 3, 4),
              ("combine", 4, 5))
    for name, extra in (("with copies", []), ("without copies", ["-DNOCOPY"])):
        flash_decode._lib = build(src, extra)
        ms = c.graph_ms(lambda i: flash_decode.flash_decode(q, kc[i % L], vc[i % L], lengths,
                                                            starts), L)
        prof = torch.zeros((plan.n_ranges * B, 16), dtype=torch.int64, device=dev)
        for layer in range(L):  # layer 0 last touched 25 layers ago: cold
            flash_decode.flash_decode(q, kc[layer], vc[layer], lengths, starts)
        flash_decode._lib.flash_set_prof(ctypes.c_void_p(prof.data_ptr()))
        flash_decode.flash_decode(q, kc[0], vc[0], lengths, starts)
        torch.cuda.synchronize()
        flash_decode._lib.flash_set_prof(None)
        m = prof.cpu().double()
        t0 = m[:, 0][m[:, 0] > 0].min()
        live = m[m[:, 1] > 0]

        def us(a, b):
            ok = (live[:, a] > 0) & (live[:, b] > 0)
            x = (live[:, b] - live[:, a])[ok] / 1e3
            return f"{x.mean().item():.2f}/{x.max().item():.2f}" if len(x) else "-"

        spans = ", ".join(f"{n} {us(a, b)}" for n, a, b in phases)
        c.log(f"flash_decode {name}: {ms:.4f} ms a call (cold, CUDA graph); one call: "
              f"{len(live)} live CTAs of {len(m)}, span {(m[:, :6].max() - t0) / 1e3:.2f} us; "
              f"per live CTA mean/max us: {spans}; CTAs an SM at most "
              f"{int(torch.bincount(live[:, 6].long()).max())}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
