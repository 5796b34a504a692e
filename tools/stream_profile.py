#!/usr/bin/env python3
"""Where the whole steps' tiled weight stream (csrc/tile_stream.cuh) spends
its tiles, on one NVIDIA GPU:

    python tools/stream_profile.py [--whole [--rowq8 | --gemma4]] [--block N]

It builds a copy of the kernel sources with %globaltimer stamps written into
csrc/tile_stream.cuh (text substitutions on the source; the tool fails if
the source no longer has the places it stamps) and runs the capacity step
(csrc/fused_decode_stream.cu) at chip_smoke's phase 13 inputs (Gemma-3-12B
width and depth, position 300, random serve-q int8 and serve-q4 nibbles
with Q4_K offsets) or, with ``--whole``, the whole-layer lossless step
(csrc/fused_decode_q.cu) at phase 9's (Gemma-3-1B, position 300, the same
formats), with ``--whole --rowq8`` the rowq8 step (csrc/fused_decode.cu)
at phase 4's (the 1B, position 300, random per-row int8), with ``--whole
--gemma4`` its gemma4 instance at phase 15's (GEOM_G4, position 300). For
block N (0 by default) and every tile of one step it records
when the tile's copies were issued, when warp 0 began to wait for it and
got it, when each warp released its stage and when the last one did; it
prints, per GEMV phase over the layers, the mean of:
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
__device__ int g_prof_block = 0;
__device__ __forceinline__ void stamp(int k, int col) {
  if (g_prof != nullptr && blockIdx.x == g_prof_block) {
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
     "  if (g_prof != nullptr && blockIdx.x == g_prof_block) "
     "g_prof[24 * (size_t)(sc.total - cur.left) + 4] = "
     "cur.kind;\n  const TSeg& g = sc.seg[cur.kind];\n  const Part& pt = p.parts[cur.kind];"),
    ("      mbar_wait(rg.full + k.slot, k.parity);",
     "      if (warp == 0 && lane == 0) stamp(k.idx, 1);\n"
     "      mbar_wait(rg.full + k.slot, k.parity);\n"
     "      if (warp == 0 && lane == 0) stamp(k.idx, 2);"),
    ("      release_tile(p, f, mp, sc, rg, cur);",
     "      if (lane == 0) stamp(k.idx, 5 + warp);\n      release_tile(p, f, mp, sc, rg, cur);\n"
     "      if (threadIdx.x == kIssuer) stamp(k.idx, 3);"),
)


def stamped_sources(kernel: str, out: Path) -> Path:
    """The kernel sources in ``out`` with tile_stream.cuh stamped and a
    setter of the stamps' buffer and block in source ``kernel``; returns
    the kernel's source path."""
    from llm_inference_tpu_torch.ops.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.iterdir():
        (out / f.name).write_text(f.read_text())
    s = (out / "tile_stream.cuh").read_text()
    s = s.replace("namespace {\n", PRELUDE + "namespace {\n", 1)
    for anchor, stamped in STAMPS:
        if s.count(anchor) != 1:
            raise SystemExit(f"stream_profile: the kernel source changed: {anchor!r}")
        s = s.replace(anchor, stamped)
    (out / "tile_stream.cuh").write_text(s)
    k = (out / f"{kernel}.cu").read_text()
    anchor = f"const char* {kernel}_error_string"
    if k.count(anchor) != 1:
        raise SystemExit(f"stream_profile: {kernel}.cu has no {anchor}")
    (out / f"{kernel}.cu").write_text(k.replace(
        anchor, "int stream_set_prof(void* ptr, int block) {\n"
        "  cudaError_t e = cudaMemcpyToSymbol(g_prof, &ptr, sizeof(ptr));\n"
        "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_prof_block, &block, sizeof(block));\n"
        "  return (int)e;\n}\n\n" + anchor, 1))
    return out / f"{kernel}.cu"


def build(src: Path, kernel: str) -> ctypes.CDLL:
    """Library ``src`` built, the C entries of kernel ``kernel`` typed."""
    from llm_inference_tpu_torch.ops.kernels import _build

    out = src.with_suffix(".so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src.parent), "-o",
                        str(out), str(src)], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(out))
    getattr(lib, f"{kernel}_grid").argtypes = [ctypes.c_int]
    getattr(lib, f"{kernel}_smem").argtypes = [ctypes.c_int] * 10
    getattr(lib, f"{kernel}_step").argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int,
                                                                       ctypes.c_void_p]
    for fn in ("grid", "smem", "step"):
        getattr(lib, f"{kernel}_{fn}").restype = ctypes.c_int
    lib.stream_set_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def main() -> int:
    import torch

    from llm_inference_tpu_torch.models.gemma import init_cache
    from llm_inference_tpu_torch.ops.kernels import fused_decode, fused_decode_q
    from llm_inference_tpu_torch.ops.kernels import fused_decode_stream as fds

    whole = "--whole" in sys.argv
    rowq8, gemma4 = whole and "--rowq8" in sys.argv, whole and "--gemma4" in sys.argv
    block = int(sys.argv[sys.argv.index("--block") + 1]) if "--block" in sys.argv else 0
    c.phase_device()
    source = "fused_decode" if rowq8 or gemma4 else "fused_decode_q" if whole \
        else "fused_decode_stream"
    kernel = "fused_decode_g4" if gemma4 else source
    lib = build(stamped_sources(source, ROOT / "build" / "stream_profile"), kernel)
    fds._lib = lambda kernel=kernel: lib
    kscale = 1.0
    if gemma4:
        hp = c.hp_gemma4(**c.GEOM_G4, sliding_window=c.G4_WINDOW)
        S, pos, what, kscale = c.STREAM_SEQ, c.STREAM_POS, "GEOM_G4", c.G4_QK_NORM
        step, mod = fused_decode.decode_step, fused_decode
        models = (("rowq8", lambda: c.random_g4_model(hp, seed=19)),)
    elif whole:
        hp, S, pos, what = c._hp_1b(), 1024, 300, "1B"
        step, mod = ((fused_decode.decode_step, fused_decode) if rowq8
                     else (fused_decode_q.decode_step_q, fused_decode_q))
    else:
        hp = c.hp_gemma3(**c.GEOM_12B, sliding_window=1024)
        S, pos, what = c.STREAM_SEQ, c.STREAM_POS, "12B"
        step, mod = fds.decode_step_stream, fds
    if rowq8:
        models = (("rowq8", lambda: c._random_model(hp, seed=2)),)
    elif not gemma4:
        seed = 7 if whole else 17
        models = tuple((label, lambda nibble=nibble: c._random_lossless_model(
            hp, seed=seed, nibble=nibble)) for label, nibble in (
            ("serve-q int8", False), ("serve-q4 nibble+offsets", True)))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    cache = init_cache(hp, S, device=dev, flat=not whole)
    cache.k[:, :pos] = (kscale * torch.randn(cache.k[:, :pos].shape, device=dev, generator=g)
                        ).to(torch.bfloat16)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
    token = torch.tensor([200001], dtype=torch.int64, device=dev)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    for label, make in models:
        w = make()
        consts = mod.prepare(hp, dev, swa_mask=False, max_seq=S)
        ms = c.time_ms(lambda i=0: step(hp, w, cache, token, p, consts), 10)
        (plan, _), = consts.scratch["plans"].values()
        prof = torch.zeros((20000, 24), dtype=torch.int64, device=dev)
        lib.stream_set_prof(ctypes.c_void_p(prof.data_ptr()), block)
        step(hp, w, cache, token, p, consts)
        torch.cuda.synchronize()
        lib.stream_set_prof(None, 0)
        m = prof.cpu().double()
        m = m[m[:, 3] > 0]  # the block's tiles
        period = torch.cat([torch.zeros(1, dtype=torch.float64), m[1:, 3] - m[:-1, 3]])
        out = []
        for k, name in enumerate(fds.PHASES):
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
        c.log(f"stream_profile {what} {label}: {ms:.4f} ms a step; plan {plan}; block {block}, "
              "mean us a tile: " + "; ".join(out))
        del w, consts
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
