// The tiled weight stream of the whole decode steps on Hopper (sm_90a):
// each GEMV phase of a step as tiles of rows by a column slab, one
// tensor-map copy a plane and tile through a ring of shared-memory stages,
// consumed on the tensor cores. Shared by every step that runs
// whole_step.cuh's body: the rowq8 steps (fused_decode.cu, fused_decode_tp.cu),
// the lossless ones (fused_decode_q.cu, fused_decode_q_tp.cu) and the
// capacity step (fused_decode_stream.cu).
//
// The parts, and why (PERF.md, measured on the capacity step):
//   - tiles, not whole rows: a block takes whole tiles of a phase (16, 32 or
//     64 rows, gate/up: row pairs), cut into slabs of columns by the
//     wrapper's plan (ops/kernels/fused_decode_stream.py ``plan``: a pure
//     function of the shapes, the formats and the grid, held on the CPU);
//     the ring has as many stages as shared memory leaves room for, up to
//     eight;
//   - one tensor-map copy a plane and tile: the quants as the slab's column
//     blocks of the tile's rows, 128-byte swizzled, the scales and offsets as
//     one box of the slab's groups (small copies cost this card's TMA ~60-80
//     ns each, whatever their size);
//   - the GEMVs on the tensor cores (consume_tiles): int8 and nibbles become
//     exact bf16, mma.sync m16n8k16 runs them against the activation, and
//     each group's f32 partial takes its exact scale (and offset term) in
//     registers, so the lossless contract holds and only the order of the
//     f32 sums differs (a nibble phase's scales may stream as the
//     checkpoint's raw f16, 2 bytes a group, widened exactly where they are
//     read); a per-row int8 (rowq8) tile is its quants alone, and
//     the row's scale, read from global memory, multiplies the row's
//     finished sum (the rowq8 contract, fused_decode.cu);
//   - one block barrier a tile, then one thread a plane (lane 0 of each of
//     the last three warps) refills the stage with its plane of the tile a
//     ring ahead, from a cursor that steps without a division, so the warps
//     stay on one tile and the refill leaves the barrier at once; the stream
//     runs ahead across phases, grid barriers, attention and layers.
// A block's tiles of a phase are whole tiles of the phase's row blocks (the
// tiles are dealt out in order, as evenly as whole tiles go), so no copy
// carries rows that its block does not read.

#pragma once

#include <cuda.h>
#include <cuda_fp16.h>

#include "decode_step.cuh"

namespace {

constexpr int kI8 = 0;    // int8 quants
constexpr int kNib = 1;   // nibble pairs (byte j: column 2j low, 2j + 1 high)
constexpr int kBF16 = 2;  // dense bf16 (the embedding)
constexpr int kI8R = 3;   // int8 quants with one f32 scale a row (rowq8)

// the threads that copy the tiles: plane j's is lane 0 of warp kWarps - 1 -
// j (the last warps own the fewest columns of a ragged slab), the quants'
// (kIssuer) also expects the tile's bytes on its stage's barrier
constexpr int kIssuer = kThreads - 32;
constexpr int kMaxStreamStages = 8;
constexpr int kMaxSmem = 232448;  // a block's most shared memory on the H100

// The wrapper's plan (ops/kernels/fused_decode_stream.py ``plan``): per
// phase the rows (gate/up: pairs) of a tile, 16, 32 or 64, and the columns
// of its slab (``slab_unit``: whole 128-byte boxes a row, split over a row
// group's warps by 32-byte pieces); the bytes of a ring stage (the largest
// tile) and the number of stages.
struct TilePlan {
  int rb[kKinds], cs[kKinds];
  int stage_bytes, stages;
};

// Per phase and plane, the tensor map the tiles are copied through
// (encode_plane): the quants a 4-D map of bytes, the scales and offsets a
// 3-D map of floats; a box is one tile's rows of one slab.
struct Maps {
  CUtensorMap m[kKinds][kMaxPlanes];
};

// The weight format of a step's phases and the stream's plan. ``G``: the q
// heads a block's attention work item holds (a KV group, or under tensor
// parallelism the rank's share of one), which sizes the PV partials.
struct StreamFmt {
  int fmt[kKinds];      // per Kind: kI8, kNib, kBF16 or kI8R
  int gs[kKinds];       // columns a group (kI8, kNib)
  int sbytes[kKinds];   // bytes of a group scale: 4 (f32) or 2 (f16; kNib without offsets)
  float bias[kKinds];   // 8 for Q4_0's nibbles, else 0
  int has_off[kKinds];
  const float* rs[kKinds];  // kI8R: the row scales, [L, R] (logits, kPLM: [R])
  int rs_rows[kKinds];      // kI8R: a layer's rows of rs (0: one layer)
  float* scores;   // [H, S] attention scores, then probabilities
  int G;
  int nk;          // the step's phases: 5, or kKinds with gemma4's
  TilePlan plan;
  G4Params g4;     // gemma4's parameters (nk == kKinds)

  // s.x = the token's embedding row (the logits' weights: bf16, or int8
  // times the row's scale) * sqrt(D)
  __device__ void embed(const Step& p, Smem& s, int tok) const {
    const char* emb = p.parts[kLogits].base[0];
    if (fmt[kLogits] == kBF16) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(emb) + (size_t)tok * p.D;
      for (int i = threadIdx.x; i < p.D; i += kThreads) s.x[i] = __bfloat162float(e[i]) * p.emb_mult;
    } else {
      const int8_t* e = reinterpret_cast<const int8_t*>(emb) + (size_t)tok * p.D;
      const float es = rs[kLogits][tok];
      for (int i = threadIdx.x; i < p.D; i += kThreads) s.x[i] = (float)e[i] * es * p.emb_mult;
    }
  }
};

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory arrays of a tiled step (byte offsets); ``work`` holds in
// turn the GEMV activation (bf16 [max(D, A, F)]), the QKV row (f32 [Rq]) and
// the attention's per-warp PV partials (f32 [kWarps, G, dv]).
struct StreamLayout {
  size_t x, tmp, work, red, stat, qb, kn, vn, xsum, bars, rowsum, ring, total;
};

__host__ __device__ inline StreamLayout stream_layout(const Step& p, int G, int stage_bytes,
                                                      int stages) {
  StreamLayout o;
  const size_t work = imax(2 * imax(p.D, imax(p.A, p.F)), imax(4 * p.Rq, 4 * kWarps * G * p.dv));
  size_t off = 0;
  o.x = off;    off += align16(sizeof(float) * p.D);
  o.tmp = off;  off += align16(sizeof(float) * p.D);
  o.work = off; off += align16(work);
  o.red = off;  off += align16(sizeof(float) * 32);
  o.stat = off; off += align16(sizeof(float) * 2 * p.H);
  o.qb = off;   off += align16(2 * (size_t)p.H * p.dk);
  o.kn = off;   off += align16(2 * (size_t)p.Hkv * p.dk);
  o.vn = off;   off += align16(2 * (size_t)p.Hkv * p.dv);
  o.xsum = off; off += align16(sizeof(float) * p.xsum_floats);
  o.bars = off; off += align16(8 * stages);
  o.rowsum = off; off += align16(sizeof(float) * kWarps * 16);
  // the ring last, with room to start it on a 1024-byte boundary (the
  // swizzled tensor copies' destinations), wherever dynamic shared memory
  // begins
  o.ring = off; off += 1024 + (size_t)stages * stage_bytes;
  o.total = off;
  return o;
}

__host__ __device__ inline int kind_cols(const Step& p, int kind) {
  return kind == kWo ? p.A : kind == kDown ? p.F : kind == kPLJ ? p.P : p.D;
}
__host__ __device__ inline int kind_rows(const Step& p, int kind) {
  return kind == kQKV ? p.Rq : kind == kGU ? p.F : kind == kLogits ? p.V
       : kind == kPLM ? p.L * p.P : kind == kPLG ? p.P : p.D;
}
// The phases whose weights are stacked by layer (the logits' and the
// prologue's are one matrix).
__host__ __device__ inline bool kind_stacked(int kind) { return kind != kLogits && kind != kPLM; }

// Bytes of plane ``j`` of one row over ``cols`` columns: the quants (int8,
// nibble pairs or bf16), then the group scales (f32, or f16) and offsets
// (f32).
__host__ __device__ inline int plane_bytes(const StreamFmt& f, int kind, int j, int cols) {
  if (j == 0) return f.fmt[kind] == kNib ? cols / 2 : f.fmt[kind] == kBF16 ? 2 * cols : cols;
  return (j == 1 ? f.sbytes[kind] : 4) * (cols / f.gs[kind]);
}

// A tile's bytes: rb rows (gate/up: rb gate rows, then rb up rows) of a
// cs-column slab in every plane (the stage layout of ``TSeg``).
__host__ __device__ inline int tile_bytes(const Step& p, const StreamFmt& f, int kind, int rb,
                                          int cs) {
  int b = 0;
  for (int j = 0; j < p.parts[kind].n_planes; ++j) b += plane_bytes(f, kind, j, cs);
  return b * rb * (kind == kGU ? 2 : 1);
}

// log2 of the bytes of a quant box's row: 128-byte rows, or 64 where a row's
// quants are not whole 128-byte blocks (its last block would read the next
// row's bytes: the map's boxes must end where the row does). A box row is
// the swizzle's width, so a box lands in shared memory as it is counted.
__host__ __device__ inline int box_shift(int row_bytes) { return row_bytes % 128 ? 6 : 7; }

// The byte, in a stage's quants of one copy, of byte ``cb`` of row ``r`` of
// the slab: the boxes' column blocks of 2^bsh bytes lie block after block,
// each rb rows, swizzled by the tensor copy (the stage is 1024-aligned):
// 128-byte rows take the 128-byte swizzle (16-byte chunk bits 4-6 of the
// address XOR its 128-byte line bits 7-9), 64-byte rows the 64-byte one
// (bits 4-5 XOR bits 7-8). Either way the same chunk of eight consecutive
// rows lies in eight distinct bank groups, so ldmatrix reads it at once.
__device__ __forceinline__ int quant_addr(int cb, int r, int rb, int bsh) {
  const int a = (((cb >> bsh) * rb + r) << bsh) | (cb & ((1 << bsh) - 1));
  return a ^ (((a >> 7) & ((1 << (bsh - 4)) - 1)) << 4);
}

// This block's share of one GEMV phase: rows (gate/up: pairs) [r0, r1) of
// R, n_rb whole row blocks of rb rows (the last one short only at R), each
// streamed as n_sl slabs of cs columns (the last one ragged): n = n_rb *
// n_sl tiles, row block by row block. In a stage, plane j starts
// plane_off[j] bytes in and holds srb[j] bytes a row (copy 1, gate/up's up
// rows, rb rows after copy 0): the scales and offsets row after row, the
// quants as the slab's column blocks of 2^bsh bytes (128; 64 where a row's
// quants are not whole 128-byte blocks, as Gemma-3-1B's 576-byte nibble
// rows), each rb rows of a block, swizzled (quant_addr).
struct TSeg {
  int r0, r1, R, C, copies, rb, cs, n_rb, n_sl, n, bsh;
  int slab_groups;  // a slab's groups (cs / gs; 0 without group planes): no division at issue
  int tx;  // a tile's bytes (the full boxes)
  int srb[kMaxPlanes];
  int plane_off[kMaxPlanes];
};

// The stream's phases in order: gemma4's prologue (kPLM), then per layer
// its ``nlp`` phases layer_kind(0 .. nlp - 1) (QKV, Wo, gate/up, down, and
// gemma4's per-layer gate and proj), then the logits.
struct TSched {
  TSeg seg[kKinds];
  int nlp, total;
};

__device__ __forceinline__ int layer_kind(int i) { return i < 4 ? i : i + 2; }

// Block ``blk`` of ``nblk``'s schedule, written in place (in shared memory:
// a TSched built in registers would spill): the phase's ceil(R / rb) row
// blocks are dealt out in order, blk taking [blk * nt / nblk, (blk + 1) *
// nt / nblk).
__device__ void make_tsched(TSched& sc, const Step& p, const StreamFmt& f, int blk, int nblk) {
  for (int k = 0; k < kKinds; ++k) {
    TSeg& g = sc.seg[k];
    if (k >= f.nk) {  // a phase this step does not have
      g = TSeg{};
      continue;
    }
    const int R = kind_rows(p, k);
    g.R = R;
    g.C = kind_cols(p, k);
    g.copies = k == kGU ? 2 : 1;
    g.rb = f.plan.rb[k];
    g.cs = f.plan.cs[k];
    const int nt = (R + g.rb - 1) / g.rb;
    const int t0 = (int)((long long)blk * nt / nblk), t1 = (int)((long long)(blk + 1) * nt / nblk);
    g.r0 = min(R, t0 * g.rb);
    g.r1 = min(R, t1 * g.rb);
    g.n_rb = t1 - t0;
    g.n_sl = (g.C + g.cs - 1) / g.cs;
    g.n = g.n_rb * g.n_sl;
    g.bsh = box_shift(p.parts[k].row_bytes[0]);
    g.slab_groups = f.gs[k] > 0 ? g.cs / f.gs[k] : 0;
    int off = 0;
    for (int j = 0; j < kMaxPlanes; ++j) {
      g.srb[j] = j < p.parts[k].n_planes ? plane_bytes(f, k, j, g.cs) : 0;
      g.plane_off[j] = off;
      off += g.copies * g.rb * g.srb[j];
    }
    g.tx = off;
  }
  sc.nlp = f.nk == kKinds ? 6 : 4;
  int per_layer = 0;
  for (int i = 0; i < sc.nlp; ++i) per_layer += sc.seg[layer_kind(i)].n;
  sc.total = sc.seg[kPLM].n + p.L * per_layer + sc.seg[kLogits].n;
}

// The issuer's place in the block's tile stream: the next tile to copy, as
// phase, layer, row block and slab, and its stage. Stepping it costs a few
// compares, no division, so a refill leaves the block barrier at once.
struct Cursor {
  int kind, l, rbi, sl, slot, left;
  int plane;  // the plane this thread copies, or -1 (issuer_plane)

  // past phase kind's last tile: the next phase of the layer with tiles,
  // the next layer's first, or the logits
  __device__ void next_phase(const Step& p, const TSched& sc) {
    rbi = sl = 0;
    do {
      if (kind == kLogits) return;
      // kind's place in a layer (layer_kind's inverse; the prologue's -1)
      int li = kind == kPLM ? -1 : kind < 4 ? kind : kind - 2;
      if (++li == sc.nlp) {
        li = 0;
        ++l;
      }
      kind = l < p.L ? layer_kind(li) : kLogits;
    } while (sc.seg[kind].n == 0);
  }
  __device__ void start(const Step& p, const TSched& sc) {
    kind = kPLM; l = 0; rbi = sl = slot = 0; left = sc.total;
    if (sc.seg[kind].n == 0) next_phase(p, sc);
  }
  __device__ void step(const Step& p, const TSched& sc, int stages) {
    --left;
    if (++slot == stages) slot = 0;
    const TSeg& g = sc.seg[kind];
    if (++sl < g.n_sl) return;
    sl = 0;
    if (++rbi < g.n_rb) return;
    next_phase(p, sc);
  }
};

// The plane of the tiles this thread copies, or -1.
__device__ __forceinline__ int issuer_plane() {
  const int j = (kIssuer - (int)threadIdx.x) / 32;
  return (int)threadIdx.x == kIssuer - 32 * j && j >= 0 && j < kMaxPlanes ? j : -1;
}

// An issuer: start the tensor copies of its plane of the cursor's tile into
// its stage, a box of rb rows (gate/up: the gate and the up rows), and step
// the cursor; the quants' issuer expects the tile's bytes first (a copy of
// another plane may complete before that: the barrier's byte count may
// run below zero meanwhile). Rows past R and columns past C arrive as zeros
// and are never read; the boxes' full bytes complete the stage.
__device__ void issue_tile(const Step& p, const StreamFmt& f, const Maps& mp, const TSched& sc,
                           char* ring, uint64_t* full, Cursor& cur) {
  const TSeg& g = sc.seg[cur.kind];
  const Part& pt = p.parts[cur.kind];
  const int pl = cur.plane;
  if (pl < pt.n_planes) {
    const int row0 = g.r0 + cur.rbi * g.rb;
    char* stage = ring + (size_t)cur.slot * f.plan.stage_bytes;
    uint64_t* bar = full + cur.slot;
    const int l = kind_stacked(cur.kind) ? cur.l : 0;
    // order this block's earlier generic-proxy reads of the stage before the copy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (pl == 0) {
      mbar_expect_tx(bar, (uint32_t)g.tx);
      // the quants: the slab's column blocks of rb rows, swizzled, in one
      // copy (a block after block)
      for (int cp = 0; cp < g.copies; ++cp)
        tma_load_4d(stage + (size_t)cp * g.rb * g.srb[0], &mp.m[cur.kind][0], 0,
                    cp * g.R + row0, cur.sl * (g.srb[0] >> g.bsh), l, bar);
    } else {
      // the scales or offsets: a box of the slab's groups, rb rows
      const int e0 = cur.sl * g.slab_groups;  // the slab's first group
      for (int cp = 0; cp < g.copies; ++cp)
        tma_load_3d(stage + g.plane_off[pl] + (size_t)cp * g.rb * g.srb[pl], &mp.m[cur.kind][pl],
                    e0, cp * g.R + row0, l, bar);
    }
  }
  cur.step(p, sc, f.plan.stages);
}

// A consumer's next tile: its stage and the parity of that stage's fill.
struct Slot {
  int slot;
  uint32_t parity;
  __device__ void next(int stages) {
    if (++slot == stages) {
      slot = 0;
      parity ^= 1u;
    }
  }
};

// The stream's stages, their full barriers, and the row sums of a row
// block's warps (f32 [kWarps][16]).
struct Ring {
  char* ring;
  uint64_t* full;
  float* rowsum;
};

// Thread kIssuer sets up the stream of block ``blk`` of ``nblk``: its
// schedule and its stages' barriers (the block synchronises before any
// issuer starts).
__device__ void init_stream(const Step& p, const StreamFmt& f, TSched& sched, const Ring& rg,
                            int blk, int nblk) {
  make_tsched(sched, p, f, blk, nblk);
  for (int i = 0; i < f.plan.stages; ++i) mbar_init(rg.full + i, 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// An issuer starts its cursor and its plane of the first ``stages`` tiles.
__device__ void start_stream(const Step& p, const StreamFmt& f, const Maps& mp,
                             const TSched& sched, const Ring& rg, Cursor& cur) {
  cur.start(p, sched);
  for (int k = 0; k < f.plan.stages && cur.left > 0; ++k)
    issue_tile(p, f, mp, sched, rg.ring, rg.full, cur);
}

// The block is done with a tile's stage: the issuers refill it at once with
// the tile a ring ahead (the cursor's), which may belong to a later phase or layer,
// so the stream keeps flowing across the grid barriers. The block barrier
// keeps the warps on one tile: a stage is held only as long as its slowest
// warp works on it (warps left to run apart held each stage through their
// whole spread, several tiles' work, while the ring ran dry).
__device__ __forceinline__ void release_tile(const Step& p, const StreamFmt& f, const Maps& mp,
                                             const TSched& sc, const Ring& rg, Cursor& cur) {
  __syncthreads();
  if (cur.plane >= 0 && cur.left > 0) issue_tile(p, f, mp, sc, rg.ring, rg.full, cur);
}

// ---- the GEMV consumer on the tensor cores -----------------------------------

// d = a . b (+ c) for one 16x8x16 tile: bf16 in, f32 sums (A row-major, B
// column-major).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 matrices of 16-bit elements from shared memory, one row address
// a lane (lanes 8i .. 8i + 7: matrix i's rows); lane (g, t) gets elements
// (g, 2t) and (g, 2t + 1) of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// a * b + c on bf16 pairs, rounded to nearest even once (exact here: small
// integers).
__device__ __forceinline__ uint32_t fma2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Bytes (2j, 2j + 1) of a word of int8 quants as an exact bf16 pair.
__device__ __forceinline__ uint32_t i8_pair(uint32_t w, int j) {
  return __byte_perm(__float_as_uint(i8(w, 2 * j)), __float_as_uint(i8(w, 2 * j + 1)), 0x7632);
}

// Nibbles (s, s + 16) of a word (bit offsets) as the bf16 pair (128 + u).
__device__ __forceinline__ uint32_t nib_pair(uint32_t w, int s) {
  return ((w >> s) & 0x000F000Fu) | 0x43004300u;
}

// Group ``gi``'s scale from a row of a stage's scale plane: f32, or f16
// (H16) widened exactly.
template <bool H16>
__device__ __forceinline__ float scale_at(const char* row, int gi) {
  if constexpr (H16) return __half2float(reinterpret_cast<const __half*>(row)[gi]);
  else return reinterpret_cast<const float*>(row)[gi];
}

// Consume this block's tiles of phase ``kind`` in format F (PAIR: gate/up;
// H16: kNib with f16 group scales) on the tensor cores. A tile of rb rows is NG groups of 16 A rows (gate/up:
// 8 gate rows over the same 8 pairs' up rows), each group's slab split over
// KP = 16 / NG warps by whole 32-byte column pieces; a warp takes its 16 rows'
// quants with ldmatrix from the swizzled boxes, forms exact bf16 weights
// (int8: byte permutes; nibbles: a mask and one bf16x2 fma; bf16 as it is),
// and multiplies them with mma.sync m16n8k16 by the bf16 activation,
// replicated over the 8 columns of B, so every lane's sums are its two rows'
// dot over the k16 slice. The products bf16(x) . q are exact and a group's
// f32 partial takes its exact scale (and offset term): only the order of
// the f32 sums differs from a row-by-row dot (kI8R: the row's sum takes the
// row's scale ``rs[row]``, the up row's ``rs[R + row]``, at its end). The KP
// warps' sums of a row meet in shared memory at the row block's end, added
// in warp order. emit(row, value, up value) takes each row's sum once.
template <int F, bool PAIR, bool H16, class Emit>
__device__ void consume_tiles(const Step& p, const StreamFmt& f, const Maps& mp, const TSched& sc,
                              const Ring& rg, Cursor& cur, const Smem& s, Slot& k, int kind,
                              const float* rs, Emit&& emit) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t = lane % 4;
  const TSeg& g = sc.seg[kind];
  const int gs = f.gs[kind];
  const bool off = f.has_off[kind] != 0;
  const int NG = PAIR ? g.rb / 8 : g.rb / 16, KP = kWarps / NG;
  const int grp = warp / KP, kp = warp % KP;
  const int qb = g.srb[0], kpb = qb / KP;  // quant bytes a row: the slab's, this warp's
  // this lane's ldmatrix row: matrix mi = lane / 8 (odd: A rows 8-15), row r8
  const int mi = lane / 8, r8 = lane % 8;
  const int arow = PAIR ? grp * 8 + r8 : grp * 16 + (mi & 1) * 8 + r8;  // row in its copy
  const int acopy = PAIR ? (mi & 1) : 0;
  // the lane's two A rows (g, g + 8) in the scale planes
  const int srow0 = PAIR ? grp * 8 + gq : grp * 16 + gq;
  const int srow1 = PAIR ? g.rb + grp * 8 + gq : grp * 16 + 8 + gq;
  constexpr int kColsPerByte2 = F == kNib ? 4 : F == kBF16 ? 1 : 2;  // columns in 2 bytes
  const uint32_t nb2 = f.bias[kind] != 0.f ? 0xC308C308u : 0xC300C300u;  // -(128 + bias)
  for (int rbi = 0; rbi < g.n_rb; ++rbi) {
    const int row0 = g.r0 + rbi * g.rb;
    const int nrow = min(g.rb, g.r1 - row0);
    float acc0 = 0.f, acc1 = 0.f;  // rows g and g + 8 of the warp's group
    for (int sl = 0; sl < g.n_sl; ++sl, k.next(f.plan.stages)) {
      const int c0 = sl * g.cs, ncol = min(g.cs, g.C - c0);
      mbar_wait(rg.full + k.slot, k.parity);
      const char* st = rg.ring + (size_t)k.slot * f.plan.stage_bytes;
      const char* qp = st + g.plane_off[0] + (size_t)acopy * qb * g.rb;
      const char* sc0 = st + g.plane_off[1] + (size_t)srow0 * g.srb[1];
      const char* sc1 = st + g.plane_off[1] + (size_t)srow1 * g.srb[1];
      const float* of0 = off ? reinterpret_cast<const float*>(st + g.plane_off[2] + (size_t)srow0 * g.srb[2]) : nullptr;
      const float* of1 = off ? reinterpret_cast<const float*>(st + g.plane_off[2] + (size_t)srow1 * g.srb[2]) : nullptr;
      float dl[4] = {0.f, 0.f, 0.f, 0.f};  // kBF16, kI8R: the whole slab's sums
      // the warp's 32-byte pieces of the slab: 2 chunks of 16 bytes each
      for (int pb = kp * kpb; pb < (kp + 1) * kpb; pb += 32) {
        const int col = pb * kColsPerByte2 / 2;  // the piece's first column in the slab
        if (col >= ncol) break;                  // the ragged slab's end (warp-uniform)
        // A: this lane's row address in the swizzled boxes, chunk pb / 16 + mi / 2
        uint32_t r[4];
        ldmatrix_x4(r, qp + quant_addr(pb + 16 * (mi >> 1), arow, g.rb, g.bsh));
        const __nv_bfloat16* hv = s.hv + c0 + col;
        if constexpr (F == kI8 || F == kI8R) {
          // two 16-column slices: chunk j's words r0 (row g), r1 (row g + 8)
          const uint2 b0 = *reinterpret_cast<const uint2*>(hv + 4 * t);
          const uint2 b1 = *reinterpret_cast<const uint2*>(hv + 16 + 4 * t);
          const uint32_t a0[4] = {i8_pair(r[0], 0), i8_pair(r[1], 0), i8_pair(r[0], 1), i8_pair(r[1], 1)};
          const uint32_t a1[4] = {i8_pair(r[2], 0), i8_pair(r[3], 0), i8_pair(r[2], 1), i8_pair(r[3], 1)};
          if constexpr (F == kI8R) {  // no group scale: the row's scale comes at its end
            mma_bf16(dl, a0, b0.x, b0.y);
            mma_bf16(dl, a1, b1.x, b1.y);
            continue;
          }
          float d0[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(d0, a0, b0.x, b0.y);
          if (gs == 16) {
            const int gi = col >> 4;
            acc0 = fmaf(scale_at<false>(sc0, gi), d0[0], acc0);
            acc1 = fmaf(scale_at<false>(sc1, gi), d0[2], acc1);
            if (off) {
              acc0 = fmaf(-of0[gi], s.xsum[(c0 + col) >> 4], acc0);
              acc1 = fmaf(-of1[gi], s.xsum[(c0 + col) >> 4], acc1);
            }
            d0[0] = d0[1] = d0[2] = d0[3] = 0.f;
          }
          mma_bf16(d0, a1, b1.x, b1.y);
          const int gi = (col + 16) / gs;  // the group that ends with this piece
          acc0 = fmaf(scale_at<false>(sc0, gi), d0[0], acc0);
          acc1 = fmaf(scale_at<false>(sc1, gi), d0[2], acc1);
          if (off) {
            const float xg = s.xsum[(c0 + col + 16) / gs];
            acc0 = fmaf(-of0[gi], xg, acc0);
            acc1 = fmaf(-of1[gi], xg, acc1);
          }
        } else if constexpr (F == kNib) {
          // two 32-column groups (chunks), each two slices; lane t holds
          // columns 8t .. 8t + 7 of a chunk: pairs (0,4) (1,5) (2,6) (3,7)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint4 v = *reinterpret_cast<const uint4*>(hv + 32 * j + 8 * t);
            const uint32_t wg = r[2 * j], wh = r[2 * j + 1];
            const uint32_t P0 = fma2(nib_pair(wg, 0), 0x3F803F80u, nb2),
                           P1 = fma2(nib_pair(wg, 4), 0x3F803F80u, nb2),
                           P2 = fma2(nib_pair(wg, 8), 0x3F803F80u, nb2),
                           P3 = fma2(nib_pair(wg, 12), 0x3F803F80u, nb2);
            const uint32_t Q0 = fma2(nib_pair(wh, 0), 0x3F803F80u, nb2),
                           Q1 = fma2(nib_pair(wh, 4), 0x3F803F80u, nb2),
                           Q2 = fma2(nib_pair(wh, 8), 0x3F803F80u, nb2),
                           Q3 = fma2(nib_pair(wh, 12), 0x3F803F80u, nb2);
            const uint32_t aA[4] = {P0, Q0, P1, Q1}, aB[4] = {P2, Q2, P3, Q3};
            float d0[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(d0, aA, __byte_perm(v.x, v.z, 0x5410), __byte_perm(v.x, v.z, 0x7632));
            mma_bf16(d0, aB, __byte_perm(v.y, v.w, 0x5410), __byte_perm(v.y, v.w, 0x7632));
            const int gi = (col + 32 * j) >> 5;  // gs 32: a chunk is a group
            acc0 = fmaf(scale_at<H16>(sc0, gi), d0[0], acc0);
            acc1 = fmaf(scale_at<H16>(sc1, gi), d0[2], acc1);
            if (off) {
              const float xg = s.xsum[(c0 + col + 32 * j) >> 5];
              acc0 = fmaf(-of0[gi], xg, acc0);
              acc1 = fmaf(-of1[gi], xg, acc1);
            }
          }
        } else {
          // one 16-column slice: chunks j (k 0-7) and j + 1 (k 8-15)
          const uint32_t a[4] = {r[0], r[1], r[2], r[3]};
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(hv + 2 * t);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(hv + 8 + 2 * t);
          mma_bf16(dl, a, b0, b1);
        }
      }
      if constexpr (F == kBF16 || F == kI8R) {
        acc0 += dl[0];
        acc1 += dl[2];
      }
      release_tile(p, f, mp, sc, rg, cur);
    }
    // the KP warps of each group add their sums in warp order; lane t == 0
    // of each quad holds rows g and g + 8 (the four lanes agree)
    if (t == 0) {
      rg.rowsum[warp * 16 + gq] = acc0;
      rg.rowsum[warp * 16 + 8 + gq] = acc1;
    }
    __syncthreads();
    if (kp == 0 && lane < 16) {
      float v = 0.f, u = 0.f;
      for (int w = 0; w < KP; ++w) {
        v += rg.rowsum[(grp * KP + w) * 16 + lane];
        if (PAIR && lane < 8) u += rg.rowsum[(grp * KP + w) * 16 + 8 + lane];
      }
      if (PAIR) {
        const int r = row0 + grp * 8 + lane;
        if constexpr (F == kI8R) {
          if (lane < 8 && grp * 8 + lane < nrow) emit(r, v * rs[r], u * rs[g.R + r]);
        } else {
          if (lane < 8 && grp * 8 + lane < nrow) emit(r, v, u);
        }
      } else if (grp * 16 + lane < nrow) {
        const int r = row0 + grp * 16 + lane;
        emit(r, F == kI8R ? v * rs[r] : v, 0.f);
      }
    }
  }
}

// Phase ``kind``'s tiles of layer ``l`` in the format it streams: every
// phase of a rowq8 step (kRow) is kI8R; a lossless step's are kI8 or kNib,
// and its logits kBF16 (fill_stream holds a step to its family, so each
// kernel carries only its own consumers).
template <bool kRow, bool PAIR, class Emit>
__device__ void consume_phase(const Step& p, const StreamFmt& f, const Maps& mp, const TSched& sc,
                              const Ring& rg, Cursor& cur, const Smem& s, Slot& k, int kind,
                              int l, Emit&& emit) {
  if constexpr (kRow) {
    const float* rs = f.rs[kind] + (size_t)l * f.rs_rows[kind];
    consume_tiles<kI8R, PAIR, false>(p, f, mp, sc, rg, cur, s, k, kind, rs, emit);
  } else {
    const int fm = f.fmt[kind];
    if (fm == kNib && f.sbytes[kind] == 2)
      consume_tiles<kNib, PAIR, true>(p, f, mp, sc, rg, cur, s, k, kind, nullptr, emit);
    else if (fm == kNib)
      consume_tiles<kNib, PAIR, false>(p, f, mp, sc, rg, cur, s, k, kind, nullptr, emit);
    else if (fm == kI8)
      consume_tiles<kI8, PAIR, false>(p, f, mp, sc, rg, cur, s, k, kind, nullptr, emit);
    else if constexpr (!PAIR)
      consume_tiles<kBF16, false, false>(p, f, mp, sc, rg, cur, s, k, kind, nullptr, emit);
  }
}

// The activation's per-group sums, for the offset term.
__device__ void group_sums(const Step& p, Smem& s, const StreamFmt& f, int kind) {
  if (!f.has_off[kind]) return;
  const int C = kind_cols(p, kind), gs = f.gs[kind];
  for (int g = threadIdx.x; g < C / gs; g += kThreads) {
    float t = 0.f;
    for (int j = 0; j < gs; ++j) t += __bfloat162float(s.hv[g * gs + j]);
    s.xsum[g] = t;
  }
  __syncthreads();
}

// ---- host side -------------------------------------------------------------------

// The ``nk`` phases of a step (5, or kKinds with gemma4's) in ``p`` and
// ``f``, from the C entries' ``wptrs`` (per phase quants, scales, offsets)
// and ``winfo`` (per phase format, group size, centering and scale bytes:
// 4, or 2 for a kNib phase's raw f16 scales in rows padded to 16 bytes,
// centered and without offsets), over the
// dimensions already in ``p``, and the wrapper's ``plan`` (TilePlan: per
// phase the tile rows, then per phase the slab columns, then the stage
// bytes and the stage count), checked; ``row``: a rowq8 step (every phase
// kI8R) or a lossless one (none). Returns 0 or a cudaError_t.
inline int fill_stream(Step& p, StreamFmt& f, int nk, bool row, void* const* wptrs,
                       const int* winfo, const int* plan) {
  p.xsum_floats = imax(p.D, imax(p.A, p.F)) / 16;
  f.nk = nk;
  for (int k = 0; k < nk; ++k) {
    const int fm = winfo[4 * k], gs = winfo[4 * k + 1], centered = winfo[4 * k + 2];
    const int R = kind_rows(p, k) * (k == kGU ? 2 : 1), C = kind_cols(p, k);
    Part& pt = p.parts[k];
    f.fmt[k] = fm;
    f.gs[k] = gs;
    f.sbytes[k] = winfo[4 * k + 3];
    f.bias[k] = centered ? 8.f : 0.f;
    f.has_off[k] = wptrs[3 * k + 2] != nullptr;
    // the logits' weights are the embedding's rows: bf16, or rowq8; f16
    // scales only for centered nibbles without offsets
    if (fm < kI8 || fm > kI8R || (fm == kBF16) != (k == kLogits && fm != kI8R) ||
        (fm == kI8R) != row || wptrs[3 * k] == nullptr ||
        (fm != kI8 && fm != kNib && f.has_off[k]) ||
        (f.sbytes[k] != 4 && (f.sbytes[k] != 2 || fm != kNib || f.has_off[k] || !centered)))
      return (int)cudaErrorInvalidValue;
    pt.base[0] = (const char*)wptrs[3 * k];
    pt.row_bytes[0] = fm == kNib ? C / 2 : fm == kBF16 ? 2 * C : C;
    pt.n_planes = 1;
    if (fm == kI8R) {  // the row scales stay in global memory
      if (wptrs[3 * k + 1] == nullptr) return (int)cudaErrorInvalidValue;
      f.rs[k] = (const float*)wptrs[3 * k + 1];
      f.rs_rows[k] = kind_stacked(k) ? R : 0;
    } else if (fm != kBF16) {
      if ((gs != 16 && gs != 32) || C % (4 * gs) || wptrs[3 * k + 1] == nullptr)
        return (int)cudaErrorInvalidValue;
      // a scale plane's rows lie a multiple of 16 bytes apart (the tensor
      // copies need it): f32 rows of C / gs groups do (C % (4 gs) == 0), f16
      // rows are padded up to it
      const int gbytes = 4 * (C / gs);
      pt.base[1] = (const char*)wptrs[3 * k + 1];
      pt.row_bytes[1] = (f.sbytes[k] * (C / gs) + 15) & ~15;
      pt.n_planes = 2;
      if (f.has_off[k]) {
        pt.base[2] = (const char*)wptrs[3 * k + 2];
        pt.row_bytes[2] = gbytes;
        pt.n_planes = 3;
      }
    }
    for (int j = 0; j < pt.n_planes; ++j)
      pt.layer_bytes[j] = kind_stacked(k) ? (long long)R * pt.row_bytes[j] : 0;
  }
  TilePlan& tp = f.plan;
  for (int k = 0; k < nk; ++k) {
    tp.rb[k] = plan[k];
    tp.cs[k] = plan[nk + k];
  }
  tp.stage_bytes = plan[2 * nk];
  tp.stages = plan[2 * nk + 1];
  if (tp.stages < 2 || tp.stages > kMaxStreamStages || tp.stage_bytes < 1 || tp.stage_bytes % 1024)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < nk; ++k) {
    // rb rows in groups of 16 (gate/up: 8 pairs), a group's slab over 16 / NG
    // warps by whole 32-byte pieces; slabs of whole 128-byte boxes
    const int rb = tp.rb[k], qbytes = plane_bytes(f, k, 0, tp.cs[k]);
    const int ng = k == kGU ? rb / 8 : rb / 16;
    const bool grouped = f.fmt[k] == kI8 || f.fmt[k] == kNib;
    if ((rb != 16 && rb != 32 && rb != 64) || tp.cs[k] < 128 || tp.cs[k] % 128 ||
        qbytes % 128 || qbytes % (32 * (kWarps / ng)) ||
        tile_bytes(p, f, k, rb, tp.cs[k]) > tp.stage_bytes ||
        (grouped && plane_bytes(f, k, 1, tp.cs[k]) % 16) ||
        (f.fmt[k] == kNib && f.gs[k] != 32) || (grouped && tp.cs[k] % f.gs[k]))
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// The shapes a tiled step takes over a view whose attention work items hold
// ``G`` q heads of one KV head on ``blocks`` blocks.
inline bool stream_shapes_ok(const Step& p, int G, int blocks) {
  return !(p.Hkv < 1 || G < 1 || G > kMaxGroup || p.H % G || blocks < p.H / G || p.D % 128 ||
           p.F % 128 || p.A % 128 || p.A != p.H * p.dv || (p.dk != 128 && p.dk != 256) ||
           (p.dv != 128 && p.dv != 256) || p.Rq != p.H * p.dk + p.Hkv * (p.dk + p.dv));
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return (EncodeTiled) nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// The map of plane ``pl`` of phase ``kind``: the quants as [layers, column
// blocks, rows, block bytes] (blocks of 128 bytes, or 64: box_shift), a box
// a slab's blocks of ``rb`` rows, swizzled by the block's width, which lands
// as one block of rows after another; the scales and offsets [layers, rows,
// groups] (f32, or f16 scales in rows padded to 16 bytes) in boxes of one
// slab's groups.
inline bool encode_plane(CUtensorMap* map, const Step& p, const StreamFmt& f, int kind, int pl,
                         int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const Part& pt = p.parts[kind];
  const long long rb_bytes = pt.row_bytes[pl];
  const bool stacked = kind_stacked(kind);
  const cuuint64_t lstride = stacked ? pt.layer_bytes[pl] : rows * rb_bytes;
  const cuuint32_t rb = (cuuint32_t)f.plan.rb[kind];
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  if (pl == 0) {  // quants: [layers, column blocks, rows, block bytes], swizzled
    const int bsh = box_shift((int)rb_bytes);
    const cuuint64_t bw = 1u << bsh;
    const cuuint64_t dims[4] = {bw, (cuuint64_t)rows, (cuuint64_t)(rb_bytes >> bsh),
                                (cuuint64_t)(stacked ? p.L : 1)};
    const cuuint64_t strides[3] = {(cuuint64_t)rb_bytes, bw, lstride};
    const cuuint32_t box[4] = {(cuuint32_t)bw, rb,
                               (cuuint32_t)(plane_bytes(f, kind, 0, f.plan.cs[kind]) >> bsh), 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<char*>(pt.base[0]), dims, strides,
              box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
              bsh == 7 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  const bool h16 = pl == 1 && f.sbytes[kind] == 2;
  const cuuint64_t dims[3] = {(cuuint64_t)(kind_cols(p, kind) / f.gs[kind]), (cuuint64_t)rows,
                              (cuuint64_t)(stacked ? p.L : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)rb_bytes, lstride};
  const cuuint32_t box[3] = {(cuuint32_t)(f.plan.cs[kind] / f.gs[kind]), rb, 1};
  return fn(map, h16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<char*>(pt.base[pl]), dims,
            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Every phase's and plane's map (a plane a phase lacks repeats its quants').
inline bool encode_maps(Maps& maps, const Step& p, const StreamFmt& f) {
  for (int k = 0; k < f.nk; ++k)
    for (int j = 0; j < kMaxPlanes; ++j)
      if (!encode_plane(&maps.m[k][j], p, f, k, j < p.parts[k].n_planes ? j : 0,
                        kind_rows(p, k) * (k == kGU ? 2 : 1)))
        return false;
  return true;
}

}  // namespace
