// The whole single-token decode step of a capacity-class Gemma-3 model (the
// 4B, 12B and 27B widths) over its checkpoint's own group-scaled quants
// (lossless serve-q / serve-q4), in one persistent cooperative kernel, for
// Hopper (sm_90a).
//
// Replaces llm_inference_tpu/ops/pallas/fused_decode_stream.py::
// decode_step_megakernel_stream (:882; _run_step :776/:855, _tile_dot :295).
// It computes what fused_decode_q.cu computes, with the same numerics
// (fused_decode_stream.py:33-37: exact f32 group scales on f32 group partials
// of bf16(x) . q, Q4_K offsets times the activation's group sums, the bf16
// rounding points of the lossless step; lossless.cuh), for layers too wide
// for that kernel: D up to 5376, H * dv up to 4096, F up to 21504, up to four
// q heads per KV head and any number of KV heads, head_dim 128 or 256. The
// TPU kernel streams row tiles of each projection through two VMEM slots per
// part and copies each layer's K/V one layer ahead into VMEM, because a
// capacity layer does not fit in 128 MiB of VMEM (:11-33). None of that is
// copied: the grid barriers, the residual stream and the norms are
// decode_step.cuh's, K/V rows are read from device memory where they lie,
// and each GEMV phase (the logits too, over the bf16 tied embedding) is a
// stream of tiles through a ring of TMA stages that runs ahead across
// phases, barriers and layers.
//
// What differs from the whole-layer step, and why:
//   - the activation is read from shared memory, never held in registers (a
//     lane's registers hold 1536 columns; D is 3840 at 12B);
//   - tiles, not whole rows: a wide row does not fit a stage many times (a
//     12B serve-q down row is 17.3 KB), so a block streams its rows of a
//     phase as tiles of 16, 32 or 64 rows (gate/up: row pairs) by a slab of
//     columns, cut by the wrapper's plan (ops/kernels/fused_decode_stream.py
//     ``plan``: a pure function of the shapes, the formats and the grid; as
//     many stages as shared memory leaves room for at each geometry, up to
//     eight). A tile is one tensor-map copy a plane: the quants as the slab's
//     128-byte column blocks of the tile's rows, 128-byte swizzled, the
//     scales and offsets as one box of the slab's groups (small copies cost
//     this card's TMA ~60-80 ns each, whatever their size);
//   - the GEMVs on the tensor cores (consume_tiles): a warp owns 16 rows of a
//     tile (gate/up: 8 gate rows over the same pairs' up rows, so a lane ends
//     with both of a pair) over a part of the slab, reads them with ldmatrix,
//     forms exact bf16 weights (int8 by byte permutes, nibbles by a mask and
//     one bf16x2 fma) and runs mma.sync m16n8k16 against the activation,
//     replicated over B's 8 columns; each group's f32 partial takes its
//     exact scale in registers over the whole row block, and the warps of a
//     row group add their sums in warp order once a row block;
//   - one block barrier a tile, then one thread (kIssuer) refills the stage
//     with the tile a ring ahead from a cursor that steps without a
//     division: the warps stay on one tile, so a stage is held only as long
//     as the slowest warp works on it (warps left to run apart, each
//     releasing on its own, held each stage through their whole spread and
//     were slower, PERF.md);
//   - attention takes (KV head, slot range) work items over the blocks, so
//     all KV heads (8 at 12B, 16 at 27B) run in parallel, and keeps the
//     scores in a global [H, S] scratch (L2-resident) instead of shared
//     memory, so no cache length is bounded by shared memory; the per-warp
//     PV partials share one shared region with the QKV row and the GEMV
//     activation, which are dead by then;
//   - the K/V row of slot pos is written straight to the cache by block 0
//     (the attention blocks take it from shared memory), so no writeback
//     lags a layer: the reference's LLMI_STREAM_DEFER_WB, whose two layers'
//     writebacks share one semaphore (fused_decode_stream.py:588-664), has
//     no counterpart, and no per-parity synchronisation is owed.
// Numerics: a row's value is the sum, in f32, of its groups' exact scale
// times the group's f32 partial of bf16(x) . q (minus the offset times the
// activation's group sum), as in the whole-layer step; the products are
// exact in the tensor cores and only the order of the f32 sums differs; the
// order is fixed, so a second launch is bit-equal.
// Every offset into the stacked weights (5.66 GB of 12B gate/up int8), the
// embedding (2.01 GB at 12B, 2.82 GB at 27B) and the caches is computed in
// 64 bits (the tensor maps address the layers, rows and blocks).
//
// What bounds it on the H100: bytes. A Gemma-3-12B step (48 layers, D 3840,
// F 15360) reads 10.76 G weights a step: in serve-q4 6.72 GB of nibbles and
// f32 scales plus the 2.01 GB bf16 embedding for the logits, 8.74 GB, 2.61 ms
// at 3.35 TB/s; in serve-q 14.1 GB, 4.22 ms. K/V at position 300 adds 59 MB.
// A ring of ~108 KB a block (three 36 KB stages at 12B) holds about one
// tile's arrival latency (4-5 us under load) of the stream, and the GEMV
// consumer's time a tile adds to it: the tensor cores and the barrier-held
// ring keep that time short. What it leaves on the table (six grid
// barriers a layer, the issuer's copies on the tile's critical path, warps
// idle where a block's share of a phase is under a tile) is measured in
// PERF.md (tools/stream_profile.py times every tile of block 0).

#include <cuda.h>

#include "lossless.cuh"

namespace {

// the thread that copies the tiles: lane 0 of the last warp, which owns the
// fewest rows of a tile when a block's share is not a multiple of 16
constexpr int kIssuer = kThreads - 32;
constexpr int kMaxStreamStages = 8;

// The wrapper's plan (ops/kernels/fused_decode_stream.py ``plan``): per
// phase the rows (gate/up: pairs) of a tile, 16, 32 or 64, and the columns
// of its slab (``slab_unit``: whole 128-byte boxes a row, split over a row
// group's warps by 32-byte pieces); the bytes of a ring stage (the largest
// tile) and the number of stages.
struct TilePlan {
  int rb[5], cs[5];
  int stage_bytes, stages;
};

// Per phase and plane, the tensor map the tiles are copied through
// (encode_plane): the quants a 4-D map of bytes, the scales and offsets a
// 3-D map of floats; a box is one tile's rows of one slab.
struct Maps {
  CUtensorMap m[5][kMaxPlanes];
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

// Shared-memory arrays of the stream step (byte offsets); ``work`` holds in
// turn the GEMV activation (bf16 [max(D, A, F)]), the QKV row (f32 [Rq]) and
// the attention's per-warp PV partials (f32 [kWarps, G, dv]).
struct StreamLayout {
  size_t x, tmp, work, red, stat, qb, kn, vn, xsum, bars, rowsum, ring, total;
};

__host__ __device__ inline StreamLayout stream_layout(const Step& p, int stage_bytes, int stages) {
  StreamLayout o;
  const int G = p.H / p.Hkv;
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

struct StreamFmt {
  int fmt[5];      // per Kind: kI8, kNib or kBF16
  int gs[5];       // columns a group
  float bias[5];   // 8 for Q4_0's nibbles, else 0
  int has_off[5];
  float* scores;   // [H, S] attention scores, then probabilities
  TilePlan plan;
};

__host__ __device__ inline int kind_cols(const Step& p, int kind) {
  return kind == kWo ? p.A : kind == kDown ? p.F : p.D;
}
__host__ __device__ inline int kind_rows(const Step& p, int kind) {
  return kind == kQKV ? p.Rq : kind == kGU ? p.F : kind == kLogits ? p.V : p.D;
}

// Bytes of plane ``j`` of one row over ``cols`` columns: the quants (int8,
// nibble pairs or bf16), then the group scales and offsets.
__host__ __device__ inline int plane_bytes(const StreamFmt& f, int kind, int j, int cols) {
  if (j == 0) return f.fmt[kind] == kI8 ? cols : f.fmt[kind] == kNib ? cols / 2 : 2 * cols;
  return 4 * (cols / f.gs[kind]);
}

// A tile's bytes: rb rows (gate/up: rb gate rows, then rb up rows) of a
// cs-column slab in every plane (the stage layout of ``TSeg``).
__host__ __device__ inline int tile_bytes(const Step& p, const StreamFmt& f, int kind, int rb,
                                          int cs) {
  int b = 0;
  for (int j = 0; j < p.parts[kind].n_planes; ++j) b += plane_bytes(f, kind, j, cs);
  return b * rb * (kind == kGU ? 2 : 1);
}

// This block's share of one GEMV phase: rows (gate/up: pairs) [r0, r1) of
// R, cut into n_rb row blocks of rb rows, each streamed as n_sl slabs of cs
// columns (the last one ragged): n = n_rb * n_sl tiles, row block by row
// block. In a stage, plane j starts plane_off[j] bytes in and holds srb[j]
// bytes a row (copy 1, gate/up's up rows, rb rows after copy 0): the
// scales and offsets row after row, the quants as the slab's 128-byte
// column blocks, each rb rows of 128 bytes, 128-byte swizzled.
struct TSeg {
  int r0, r1, R, C, copies, rb, cs, n_rb, n_sl, n;
  int tx;  // a tile's bytes (the full boxes)
  int srb[kMaxPlanes];
  int plane_off[kMaxPlanes];
};

struct TSched {
  TSeg seg[5];
  int per_layer, total;
};

__device__ TSched make_tsched(const Step& p, const StreamFmt& f) {
  TSched sc;
  for (int k = 0; k < 5; ++k) {
    TSeg& g = sc.seg[k];
    const int R = kind_rows(p, k);
    g.R = R;
    g.C = kind_cols(p, k);
    g.r0 = (int)((long long)blockIdx.x * R / gridDim.x);
    g.r1 = (int)((long long)(blockIdx.x + 1) * R / gridDim.x);
    g.copies = k == kGU ? 2 : 1;
    g.rb = f.plan.rb[k];
    g.cs = f.plan.cs[k];
    g.n_rb = (g.r1 - g.r0 + g.rb - 1) / g.rb;
    g.n_sl = (g.C + g.cs - 1) / g.cs;
    g.n = g.n_rb * g.n_sl;
    int off = 0;
    for (int j = 0; j < kMaxPlanes; ++j) {
      g.srb[j] = j < p.parts[k].n_planes ? plane_bytes(f, k, j, g.cs) : 0;
      g.plane_off[j] = off;
      off += g.copies * g.rb * g.srb[j];
    }
    g.tx = off;
  }
  sc.per_layer = 0;
  for (int k = 0; k < 4; ++k) sc.per_layer += sc.seg[k].n;
  sc.total = p.L * sc.per_layer + sc.seg[kLogits].n;
  return sc;
}

// The issuer's place in the block's tile stream: the next tile to copy, as
// phase, layer, row block and slab, and its stage. Stepping it costs a few
// compares, no division, so a refill leaves the block barrier at once.
struct Cursor {
  int kind, l, rbi, sl, slot, left;

  // past phase kind's last tile: the next phase of the layer with tiles,
  // the next layer's first, or the logits
  __device__ void next_phase(const Step& p, const TSched& sc) {
    rbi = sl = 0;
    do {
      if (kind == kLogits) return;
      if (++kind == kLogits && ++l < p.L) kind = kQKV;
    } while (sc.seg[kind].n == 0);
  }
  __device__ void start(const Step& p, const TSched& sc) {
    kind = kQKV; l = 0; rbi = sl = slot = 0; left = sc.total;
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

// The issuer: start the tensor copies of the cursor's tile into its stage, a
// box of rb rows (gate/up: the gate and the up rows) a plane, and step the
// cursor. Rows past the block's share are copied too and never read (rows
// past R and columns past C arrive as zeros); the box's full bytes
// complete the stage.
__device__ void issue_tile(const Step& p, const StreamFmt& f, const Maps& mp, const TSched& sc,
                           char* ring, uint64_t* full, Cursor& cur) {
  const TSeg& g = sc.seg[cur.kind];
  const Part& pt = p.parts[cur.kind];
  const int row0 = g.r0 + cur.rbi * g.rb;
  char* stage = ring + (size_t)cur.slot * f.plan.stage_bytes;
  uint64_t* bar = full + cur.slot;
  // order this block's earlier generic-proxy reads of the stage before the copy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_expect_tx(bar, (uint32_t)g.tx);
  const int l = cur.kind == kLogits ? 0 : cur.l;
  // the quants: the slab's 128-byte column blocks of rb rows, swizzled, in
  // one copy (a block after block)
  for (int cp = 0; cp < g.copies; ++cp)
    tma_load_4d(stage + (size_t)cp * g.rb * g.srb[0], &mp.m[cur.kind][0], 0, cp * g.R + row0,
                cur.sl * (g.srb[0] / 128), l, bar);
  // the scales and offsets: a box of the slab's groups, rb rows (floats)
  for (int pl = 1; pl < pt.n_planes; ++pl) {
    const int e0 = cur.sl * (g.srb[pl] / 4);  // the slab's first group
    for (int cp = 0; cp < g.copies; ++cp)
      tma_load_3d(stage + g.plane_off[pl] + (size_t)cp * g.rb * g.srb[pl], &mp.m[cur.kind][pl], e0,
                  cp * g.R + row0, l, bar);
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

// The block is done with a tile's stage: the issuer refills it at once with
// the tile a ring ahead (the cursor's), which may belong to a later phase or layer,
// so the stream keeps flowing across the grid barriers. The block barrier
// keeps the warps on one tile: a stage is held only as long as its slowest
// warp works on it (warps left to run apart held each stage through their
// whole spread, several tiles' work, while the ring ran dry).
__device__ __forceinline__ void release_tile(const Step& p, const StreamFmt& f, const Maps& mp,
                                             const TSched& sc, const Ring& rg, Cursor& cur) {
  __syncthreads();
  if (threadIdx.x == kIssuer && cur.left > 0) issue_tile(p, f, mp, sc, rg.ring, rg.full, cur);
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

// Consume this block's tiles of phase ``kind`` in format F (PAIR: gate/up)
// on the tensor cores. A tile of rb rows is NG groups of 16 A rows (gate/up:
// 8 gate rows over the same 8 pairs' up rows), each group's slab split over
// KP = 16 / NG warps by whole 32-byte column pieces; a warp takes its 16 rows'
// quants with ldmatrix from the swizzled boxes, forms exact bf16 weights
// (int8: byte permutes; nibbles: a mask and one bf16x2 fma; bf16 as it is),
// and multiplies them with mma.sync m16n8k16 by the bf16 activation,
// replicated over the 8 columns of B, so every lane's sums are its two rows'
// dot over the k16 slice. The products bf16(x) . q are exact and a group's
// f32 partial takes its exact scale (and offset term) as in the whole-layer
// step: only the order of the f32 sums differs. The KP warps' sums of a row
// meet in shared memory at the row block's end, added in warp order.
template <int F, bool PAIR, class Emit>
__device__ void consume_tiles(const Step& p, const StreamFmt& f, const Maps& mp, const TSched& sc,
                              const Ring& rg, Cursor& cur, const Smem& s, Slot& k, int kind,
                              Emit&& emit) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t = lane % 4;
  const TSeg& g = sc.seg[kind];
  const int gs = f.gs[kind];
  const bool off = f.has_off[kind] != 0;
  const int NG = PAIR ? g.rb / 8 : g.rb / 16, KP = kWarps / NG;
  const int grp = warp / KP, kp = warp % KP;
  const int qb = g.srb[0], kpb = qb / KP;  // quant bytes a row: the slab's, this warp's
  const int nbox = qb / 128;
  // this lane's ldmatrix row: matrix mi = lane / 8 (odd: A rows 8-15), row r8
  const int mi = lane / 8, r8 = lane % 8;
  const int arow = PAIR ? grp * 8 + r8 : grp * 16 + (mi & 1) * 8 + r8;  // row in its copy
  const int acopy = PAIR ? (mi & 1) : 0;
  // the lane's two A rows (g, g + 8) in the scale planes
  const int srow0 = PAIR ? grp * 8 + gq : grp * 16 + gq;
  const int srow1 = PAIR ? g.rb + grp * 8 + gq : grp * 16 + 8 + gq;
  constexpr int kColsPerByte2 = F == kI8 ? 2 : F == kNib ? 4 : 1;  // columns in 2 bytes
  const uint32_t nb2 = f.bias[kind] != 0.f ? 0xC308C308u : 0xC300C300u;  // -(128 + bias)
  for (int rbi = 0; rbi < g.n_rb; ++rbi) {
    const int row0 = g.r0 + rbi * g.rb;
    const int nrow = min(g.rb, g.r1 - row0);
    float acc0 = 0.f, acc1 = 0.f;  // rows g and g + 8 of the warp's group
    for (int sl = 0; sl < g.n_sl; ++sl, k.next(f.plan.stages)) {
      const int c0 = sl * g.cs, ncol = min(g.cs, g.C - c0);
      mbar_wait(rg.full + k.slot, k.parity);
      const char* st = rg.ring + (size_t)k.slot * f.plan.stage_bytes;
      const char* qp = st + g.plane_off[0] + (size_t)acopy * nbox * g.rb * 128;
      const float* sc0 = reinterpret_cast<const float*>(st + g.plane_off[1] + (size_t)srow0 * g.srb[1]);
      const float* sc1 = reinterpret_cast<const float*>(st + g.plane_off[1] + (size_t)srow1 * g.srb[1]);
      const float* of0 = off ? reinterpret_cast<const float*>(st + g.plane_off[2] + (size_t)srow0 * g.srb[2]) : nullptr;
      const float* of1 = off ? reinterpret_cast<const float*>(st + g.plane_off[2] + (size_t)srow1 * g.srb[2]) : nullptr;
      float dl[4] = {0.f, 0.f, 0.f, 0.f};  // kBF16: the whole slab's sums
      // the warp's 32-byte pieces of the slab: 2 chunks of 16 bytes each
      for (int pb = kp * kpb; pb < (kp + 1) * kpb; pb += 32) {
        const int col = pb * kColsPerByte2 / 2;  // the piece's first column in the slab
        if (col >= ncol) break;                  // the ragged slab's end (warp-uniform)
        // A: this lane's row address in the swizzled box, chunk pb / 16 + mi / 2
        const int cb = pb + 16 * (mi >> 1);
        const char* rowp = qp + (size_t)(cb >> 7) * g.rb * 128 + (size_t)arow * 128 +
                           ((((cb >> 4) & 7) ^ (arow & 7)) << 4);
        uint32_t r[4];
        ldmatrix_x4(r, rowp);
        const __nv_bfloat16* hv = s.hv + c0 + col;
        if constexpr (F == kI8) {
          // two 16-column slices: chunk j's words r0 (row g), r1 (row g + 8)
          const uint2 b0 = *reinterpret_cast<const uint2*>(hv + 4 * t);
          const uint2 b1 = *reinterpret_cast<const uint2*>(hv + 16 + 4 * t);
          const uint32_t a0[4] = {i8_pair(r[0], 0), i8_pair(r[1], 0), i8_pair(r[0], 1), i8_pair(r[1], 1)};
          const uint32_t a1[4] = {i8_pair(r[2], 0), i8_pair(r[3], 0), i8_pair(r[2], 1), i8_pair(r[3], 1)};
          float d0[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(d0, a0, b0.x, b0.y);
          if (gs == 16) {
            const int gi = col >> 4;
            acc0 = fmaf(sc0[gi], d0[0], acc0);
            acc1 = fmaf(sc1[gi], d0[2], acc1);
            if (off) {
              acc0 = fmaf(-of0[gi], s.xsum[(c0 + col) >> 4], acc0);
              acc1 = fmaf(-of1[gi], s.xsum[(c0 + col) >> 4], acc1);
            }
            d0[0] = d0[1] = d0[2] = d0[3] = 0.f;
          }
          mma_bf16(d0, a1, b1.x, b1.y);
          const int gi = (col + 16) / gs;  // the group that ends with this piece
          acc0 = fmaf(sc0[gi], d0[0], acc0);
          acc1 = fmaf(sc1[gi], d0[2], acc1);
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
            acc0 = fmaf(sc0[gi], d0[0], acc0);
            acc1 = fmaf(sc1[gi], d0[2], acc1);
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
      if constexpr (F == kBF16) {
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
        if (lane < 8 && grp * 8 + lane < nrow) emit(row0 + grp * 8 + lane, v, u);
      } else if (grp * 16 + lane < nrow) {
        emit(row0 + grp * 16 + lane, v, 0.f);
      }
    }
  }
}

// Phase ``kind``'s tiles in the format it streams.
template <bool PAIR, class Emit>
__device__ void consume_phase(const Step& p, const StreamFmt& f, const Maps& mp, const TSched& sc,
                              const Ring& rg, Cursor& cur, const Smem& s, Slot& k, int kind,
                              Emit&& emit) {
  if (f.fmt[kind] == kNib) consume_tiles<kNib, PAIR>(p, f, mp, sc, rg, cur, s, k, kind, emit);
  else if (f.fmt[kind] == kI8) consume_tiles<kI8, PAIR>(p, f, mp, sc, rg, cur, s, k, kind, emit);
  else if constexpr (!PAIR) consume_tiles<kBF16, false>(p, f, mp, sc, rg, cur, s, k, kind, emit);
}

// The activation's per-group sums, for the offset term.
__device__ void group_sums(const Step& p, Smem& s, const StreamFmt& f, int kind) {
  if (f.fmt[kind] == kBF16 || !f.has_off[kind]) return;
  const int C = kind_cols(p, kind), gs = f.gs[kind];
  for (int g = threadIdx.x; g < C / gs; g += kThreads) {
    float t = 0.f;
    for (int j = 0; j < gs; ++j) t += __bfloat162float(s.hv[g * gs + j]);
    s.xsum[g] = t;
  }
  __syncthreads();
}

// q/k norms, RoPE and the new K/V row of layer ``l`` from the QKV scratch,
// then attention over [start, pos]: work item (KV head g, slot split sp) on
// block g + Hkv * sp, two passes around a grid barrier (none with one split),
// partials [split][H][max, sum, PV] in p.part; then every block combines them
// into bf16(attention output) [H * dv] in s.hv. ``m0``: the layer's first
// profile mark.
__device__ void stream_attention(const Step& p, Smem& s, const StreamFmt& f, int l, int pos,
                                 int m0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = p.H / p.Hkv;
  const int hdk = p.dk / 2;  // rotary pairs (d, d + hdk)
  for (int i = threadIdx.x; i < p.Rq; i += kThreads) s.qkv[i] = __ldcg(p.qkv + i);
  __syncthreads();
  for (int hh = warp; hh < p.H + p.Hkv; hh += kWarps) {  // q heads, then k heads
    float* v = s.qkv + hh * p.dk;
    const float* w = (hh < p.H ? p.q_norm : p.k_norm) + (size_t)l * p.dk;
    float ss = 0.f;
    for (int d = lane; d < p.dk; d += 32) ss += v[d] * v[d];
    const float r = rsqrtf(warp_sum(ss) / (float)p.dk + p.eps);
    for (int d = lane; d < p.dk; d += 32) v[d] = v[d] * r * w[d];
  }
  __syncthreads();
  {
    const float* fr = p.inv_freq + (size_t)p.base_idx[l] * hdk;
    for (int idx = threadIdx.x; idx < (p.H + p.Hkv) * hdk; idx += kThreads) {
      const int hh = idx / hdk, i = idx % hdk;
      const float* v = s.qkv + hh * p.dk;
      const float ang = (float)pos * fr[i] / p.freq_scale;
      const float c = cosf(ang), sn = sinf(ang);
      const float x0 = v[i], x1 = v[i + hdk];
      float r0 = x0 * c - x1 * sn, r1 = x0 * sn + x1 * c;
      if (hh < p.H) {
        r0 *= p.attn_scale;
        r1 *= p.attn_scale;
        s.qb[hh * p.dk + i] = __float2bfloat16_rn(r0);
        s.qb[hh * p.dk + i + hdk] = __float2bfloat16_rn(r1);
      } else {
        s.kn[(hh - p.H) * p.dk + i] = __float2bfloat16_rn(r0);
        s.kn[(hh - p.H) * p.dk + i + hdk] = __float2bfloat16_rn(r1);
      }
    }
    const float* vsrc = s.qkv + (p.H + p.Hkv) * p.dk;
    for (int i = threadIdx.x; i < p.Hkv * p.dv; i += kThreads) s.vn[i] = __float2bfloat16_rn(vsrc[i]);
  }
  __syncthreads();  // s.qkv is dead from here: s.pv (the same bytes) takes the PV partials
  const size_t krow = (size_t)p.Hkv * p.dk, vrow = (size_t)p.Hkv * p.dv;
  __nv_bfloat16* kl = p.kc + (size_t)l * p.S * krow;
  __nv_bfloat16* vl = p.vc + (size_t)l * p.S * vrow;
  if (blockIdx.x == 0) {  // the in-place cache write of slot pos
    for (int i = threadIdx.x; i < (int)krow; i += kThreads) kl[(size_t)pos * krow + i] = s.kn[i];
    for (int i = threadIdx.x; i < (int)vrow; i += kThreads) vl[(size_t)pos * vrow + i] = s.vn[i];
  }
  const int wl = p.windows[l];
  const int start = wl > 0 ? max(0, pos - wl + 1) : 0;
  const int n = pos - start + 1;
  const int max_splits = (int)gridDim.x / p.Hkv;
  const int chunk = max(kMinChunk, (n + max_splits - 1) / max_splits);
  const int splits = (n + chunk - 1) / chunk;
  const int g = (int)blockIdx.x % p.Hkv, sp = (int)blockIdx.x / p.Hkv;
  const bool active = sp < splits;
  const int j0 = start + sp * chunk;
  const int nj = active ? min(chunk, pos + 1 - j0) : 0;
  const bool lane_k = lane * 8 < p.dk, lane_v = lane * 8 < p.dv;  // dk, dv <= 256
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  float* sc = f.scores;  // [H, S]; this block's heads and slots only
  if (active) {
    // scores: a warp takes four slots at a time, its K loads all in flight
    for (int jj0 = warp * 4; jj0 < nj; jj0 += kWarps * 4) {
      uint4 kv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + jj0 + u;
        const __nv_bfloat16* kr = j == pos ? s.kn : kl + (size_t)j * krow;
        kv[u] = (jj0 + u < nj && lane_k)
                    ? *reinterpret_cast<const uint4*>(kr + g * p.dk + lane * 8) : zero;
      }
#pragma unroll
      for (int i = 0; i < kMaxGroup; ++i) {
        if (i >= G) break;
        const int h = g * G + i;
        const uint4 qv = lane_k ? *reinterpret_cast<const uint4*>(s.qb + h * p.dk + lane * 8) : zero;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float v = warp_sum(dot8(qv, kv[u]));
          if (p.softcap > 0.f) v = p.softcap * tanhf(v / p.softcap);
          if (lane == 0 && jj0 + u < nj) __stcg(sc + (size_t)h * p.S + j0 + jj0 + u, v);
        }
      }
    }
    __syncthreads();
    for (int i = warp; i < G; i += kWarps) {
      const int h = g * G + i;
      float m = -INFINITY;
      for (int jj = lane; jj < nj; jj += 32) m = fmaxf(m, __ldcg(sc + (size_t)h * p.S + j0 + jj));
      m = warp_max(m);
      if (lane == 0) {
        s.stat[p.H + h] = m;
        __stcg(p.part + ((size_t)sp * p.H + h) * (p.dv + 2), m);
      }
    }
    __syncthreads();
  }
  // The softmax uses the max over ALL live slots, as the TPU kernel does, so
  // every probability rounds to bf16 exactly as there and the splits combine
  // by plain sums. One split needs no exchange (every block agrees on it).
  mark(p, m0 + 3);
  if (splits > 1) grid_sync(p.barrier);
  mark(p, m0 + 4);
  if (active) {
    for (int i = warp; i < G; i += kWarps) {
      const int h = g * G + i;
      float m = -INFINITY;
      if (splits > 1) {
        for (int b = lane; b < splits; b += 32)
          m = fmaxf(m, __ldcg(p.part + ((size_t)b * p.H + h) * (p.dv + 2)));
        m = warp_max(m);
      } else {
        m = s.stat[p.H + h];
      }
      float* row = sc + (size_t)h * p.S + j0;
      float sum = 0.f;
      for (int jj = lane; jj < nj; jj += 32) {
        const float e = expf(__ldcg(row + jj) - m);
        __stcg(row + jj, e);
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) s.stat[h] = sum;
    }
    __syncthreads();
    // PV: a warp takes two slots at a time, each lane 8 dims of V (one
    // 16-byte load) for every q head of the group; the warps' partial sums
    // then add up in a fixed order
    float o[kMaxGroup][8];
#pragma unroll
    for (int i = 0; i < kMaxGroup; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) o[i][e] = 0.f;
    for (int jj0 = warp * 2; jj0 < nj; jj0 += kWarps * 2) {
      uint4 vv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + jj0 + u;
        const __nv_bfloat16* vr = j == pos ? s.vn : vl + (size_t)j * vrow;
        vv[u] = (jj0 + u < nj && lane_v)
                    ? *reinterpret_cast<const uint4*>(vr + g * p.dv + lane * 8) : zero;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (jj0 + u >= nj) break;
        const float vf[8] = {bf16_lo(vv[u].x), bf16_hi(vv[u].x), bf16_lo(vv[u].y),
                             bf16_hi(vv[u].y), bf16_lo(vv[u].z), bf16_hi(vv[u].z),
                             bf16_lo(vv[u].w), bf16_hi(vv[u].w)};
#pragma unroll
        for (int i = 0; i < kMaxGroup; ++i) {
          if (i >= G) break;
          const float pb = bf16r(__ldcg(sc + (size_t)(g * G + i) * p.S + j0 + jj0 + u));
#pragma unroll
          for (int e = 0; e < 8; ++e) o[i][e] = fmaf(pb, vf[e], o[i][e]);
        }
      }
    }
    if (lane_v) {
#pragma unroll
      for (int i = 0; i < kMaxGroup; ++i) {
        if (i >= G) break;
        float* dst = s.pv + ((size_t)warp * G + i) * p.dv + lane * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = o[i][e];
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < G * p.dv; idx += kThreads) {
      const int i = idx / p.dv, d = idx % p.dv;
      const int h = g * G + i;
      float acc = 0.f;
      for (int w = 0; w < kWarps; ++w) acc += s.pv[(size_t)w * G * p.dv + idx];
      float* pt = p.part + ((size_t)sp * p.H + h) * (p.dv + 2);
      __stcg(pt + 2 + d, acc);
      if (d == 0) __stcg(pt + 1, s.stat[h]);
    }
  }
  mark(p, m0 + 5);
  grid_sync(p.barrier);
  mark(p, m0 + 6);

  // ---- combine the attention partials ---------------------------------------
  for (int idx = threadIdx.x; idx < p.H * p.dv; idx += kThreads) {
    const int h = idx / p.dv, d = idx % p.dv;
    float num = 0.f, den = 0.f;
    for (int b = 0; b < splits; ++b) {
      const float* pb = p.part + ((size_t)b * p.H + h) * (p.dv + 2);
      den += __ldcg(pb + 1);
      num += __ldcg(pb + 2 + d);
    }
    s.hv[idx] = __float2bfloat16_rn(num / den);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) decode_step_stream_kernel(Step p, StreamFmt f, const __grid_constant__ Maps mp) {
  extern __shared__ __align__(16) char smem_raw[];
  const StreamLayout o = stream_layout(p, f.plan.stage_bytes, f.plan.stages);
  Smem s{};
  s.x = (float*)(smem_raw + o.x);
  s.tmp = (float*)(smem_raw + o.tmp);
  s.hv = (__nv_bfloat16*)(smem_raw + o.work);
  s.qkv = (float*)(smem_raw + o.work);
  s.pv = (float*)(smem_raw + o.work);
  s.red = (float*)(smem_raw + o.red);
  s.stat = (float*)(smem_raw + o.stat);
  s.qb = (__nv_bfloat16*)(smem_raw + o.qb);
  s.kn = (__nv_bfloat16*)(smem_raw + o.kn);
  s.vn = (__nv_bfloat16*)(smem_raw + o.vn);
  s.xsum = (float*)(smem_raw + o.xsum);
  char* ring = smem_raw + o.ring;
  ring += (1024 - (smem_u32(ring) & 1023)) & 1023;
  const Ring rg{ring, (uint64_t*)(smem_raw + o.bars), (float*)(smem_raw + o.rowsum)};
  const long long tok64 = p.token[0];
  const int pos = p.pos[0];
  const int D = p.D, F = p.F;

  // A position outside the cache or a token outside the vocabulary would
  // read and write out of bounds: every block sees the same values and
  // leaves before the first barrier, and the logits come back NaN.
  if (pos < 0 || pos >= p.S || tok64 < 0 || tok64 >= p.V) {
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.V; i += gridDim.x * kThreads)
      p.logits[i] = __int_as_float(0x7fc00000);
    return;
  }

  // the weight stream starts before anything else
  __shared__ TSched sched_s;
  Cursor cur;  // the issuer's
  if (threadIdx.x == kIssuer) {
    sched_s = make_tsched(p, f);
    for (int i = 0; i < f.plan.stages; ++i) mbar_init(rg.full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    cur.start(p, sched_s);
    for (int k = 0; k < f.plan.stages && cur.left > 0; ++k)
      issue_tile(p, f, mp, sched_s, rg.ring, rg.full, cur);
  }
  mark(p, 0);
  __syncthreads();
  const TSched& sc = sched_s;
  Slot k{0, 0u};  // next stream tile, the same in every thread

  const __nv_bfloat16* emb = reinterpret_cast<const __nv_bfloat16*>(p.parts[kLogits].base[0]);
  for (int i = threadIdx.x; i < D; i += kThreads)
    s.x[i] = __bfloat162float(emb[(size_t)tok64 * D + i]) * p.emb_mult;
  __syncthreads();

  for (int l = 0; l < p.L; ++l) {
    const int m0 = 1 + l * kMarks;
    mark(p, m0);
    if (l > 0) residual_add(p, s, p.y_ffn, p.post_ffw_norm ? p.post_ffw_norm + (size_t)(l - 1) * D : nullptr);

    // ---- QKV ---------------------------------------------------------------
    norm_to_hv(p, s, p.attn_norm + (size_t)l * D);
    group_sums(p, s, f, kQKV);
    consume_phase<false>(p, f, mp, sc, rg, cur, s, k, kQKV, [&](int r, float v, float) { __stcg(p.qkv + r, v); });
    mark(p, m0 + 1);
    grid_sync(p.barrier);
    mark(p, m0 + 2);

    // ---- q/k norms, RoPE, new K/V row, attention -------------------------------
    stream_attention(p, s, f, l, pos, m0);

    // ---- Wo ------------------------------------------------------------------
    group_sums(p, s, f, kWo);
    consume_phase<false>(p, f, mp, sc, rg, cur, s, k, kWo, [&](int r, float v, float) { __stcg(p.y_attn + r, v); });
    mark(p, m0 + 7);
    grid_sync(p.barrier);
    mark(p, m0 + 8);

    // ---- residual, ffn_norm, gate/up + GeGLU ------------------------------------
    residual_add(p, s, p.y_attn, p.post_attn_norm ? p.post_attn_norm + (size_t)l * D : nullptr);
    norm_to_hv(p, s, p.ffn_norm + (size_t)l * D);
    group_sums(p, s, f, kGU);
    consume_phase<true>(p, f, mp, sc, rg, cur, s, k, kGU, [&](int r, float g, float u) {
      const float c = 0.7978845608028654f;
      const float a = 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g))) * u;
      __stcg(reinterpret_cast<unsigned short*>(p.act) + r,
             __bfloat16_as_ushort(__float2bfloat16_rn(a)));
    });
    mark(p, m0 + 9);
    grid_sync(p.barrier);
    mark(p, m0 + 10);

    // ---- down ------------------------------------------------------------------
    for (int i = threadIdx.x; i < F / 8; i += kThreads)
      reinterpret_cast<uint4*>(s.hv)[i] = __ldcg(reinterpret_cast<const uint4*>(p.act) + i);
    __syncthreads();
    group_sums(p, s, f, kDown);
    consume_phase<false>(p, f, mp, sc, rg, cur, s, k, kDown, [&](int r, float v, float) { __stcg(p.y_ffn + r, v); });
    mark(p, m0 + 11);
    grid_sync(p.barrier);
    mark(p, m0 + 12);
  }

  // ---- final norm, tied-embedding logits ---------------------------------------
  residual_add(p, s, p.y_ffn, p.post_ffw_norm ? p.post_ffw_norm + (size_t)(p.L - 1) * D : nullptr);
  norm_to_hv(p, s, p.out_norm);
  mark(p, 1 + p.L * kMarks);
  consume_phase<false>(p, f, mp, sc, rg, cur, s, k, kLogits, [&](int r, float v, float) { p.logits[r] = v; });
  mark(p, 2 + p.L * kMarks);
}

// Host side: the shapes the stream step takes.
inline bool stream_shapes_ok(const Step& p, int grid) {
  return !(p.Hkv < 1 || p.H % p.Hkv || p.D % 128 || p.F % 128 || p.A % 128 ||
           p.A != p.H * p.dv || grid < p.Hkv || (p.dk != 128 && p.dk != 256) ||
           (p.dv != 128 && p.dv != 256) || p.H / p.Hkv > kMaxGroup ||
           p.Rq != p.H * p.dk + p.Hkv * (p.dk + p.dv));
}

constexpr int kMaxSmem = 232448;  // a block's most shared memory on the H100
int g_smem_checked = 0;

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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

// The map of plane ``pl`` of phase ``kind``: the quants as [layers, 128-byte
// column blocks, rows, 128 bytes], a box a slab's blocks of ``rb`` rows,
// swizzled, which lands as one 128-byte box of rows after another; the
// scales and offsets [layers, rows, groups] floats in boxes of one slab's
// groups.
bool encode_plane(CUtensorMap* map, const Step& p, const StreamFmt& f, int kind, int pl,
                  int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const Part& pt = p.parts[kind];
  const long long rb_bytes = pt.row_bytes[pl];
  const bool stacked = kind != kLogits;
  const cuuint64_t lstride = stacked ? pt.layer_bytes[pl] : rows * rb_bytes;
  const cuuint32_t rb = (cuuint32_t)f.plan.rb[kind];
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  if (pl == 0) {  // quants: [layers, 128-byte column blocks, rows, 128 bytes], swizzled
    const cuuint64_t dims[4] = {128, (cuuint64_t)rows, (cuuint64_t)(rb_bytes / 128),
                                (cuuint64_t)(stacked ? p.L : 1)};
    const cuuint64_t strides[3] = {(cuuint64_t)rb_bytes, 128, lstride};
    const cuuint32_t box[4] = {128, rb, (cuuint32_t)(plane_bytes(f, kind, 0, f.plan.cs[kind]) / 128),
                               1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<char*>(pt.base[0]), dims, strides,
              box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)(rb_bytes / 4), (cuuint64_t)rows,
                              (cuuint64_t)(stacked ? p.L : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)rb_bytes, lstride};
  const cuuint32_t box[3] = {(cuuint32_t)(plane_bytes(f, kind, pl, f.plan.cs[kind]) / 4), rb, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<char*>(pt.base[pl]), dims,
            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

int fused_decode_stream_grid(int smem) {
  return cooperative_grid((const void*)decode_step_stream_kernel, smem);
}

// Shared memory the kernel needs for these dimensions and a ring of
// ``stages`` stages of ``stage_bytes`` (bytes).
int fused_decode_stream_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv,
                             int stage_bytes, int stages) {
  Step p{};
  p.D = D; p.F = F; p.A = A; p.Rq = Rq; p.H = H; p.Hkv = Hkv; p.dk = dk; p.dv = dv;
  p.xsum_floats = imax(D, imax(A, F)) / 16;
  return (int)stream_layout(p, stage_bytes, stages).total;
}

// One decode step. ``ptrs``: the 22 step pointers of fill_step (token, pos,
// base_idx, windows, inv_freq, attn_norm, ffn_norm, q_norm, k_norm,
// out_norm, post_attn_norm, post_ffw_norm, kc, vc, logits, qkv, part,
// y_attn, act, y_ffn, barrier, prof), then the scores scratch f32 [H, S];
// ``dims`` the 12 ints L, D, F, A, Rq, V, S, H, Hkv, dk, dv, 0; ``scalars``
// eps, attn_scale, softcap, freq_scale, emb_mult. ``wptrs``: per phase (QKV
// [L, Rq, D], Wo [L, D, A], gate/up [L, 2F, D], down [L, D, F], logits) its
// quants (int8 [.., R, C], nibble pairs [.., R, C / 2], or for the logits
// the bf16 embedding [V, D]), its scales and its offsets f32
// [.., R, C / gs] (null where absent). ``winfo``: per phase its format
// (0 int8, 1 nibble, 2 bf16), group size and centering (1: Q4_0 nibbles,
// value u - 8). ``plan``: the wrapper's tile plan (TilePlan: per phase the
// tile rows, then per phase the slab columns, then the stage bytes and the
// stage count), checked here. Returns the launch's cudaError_t.
int fused_decode_stream_step(void* const* ptrs, const int* dims, const float* scalars,
                             void* const* wptrs, const int* winfo, const int* plan, int grid,
                             void* stream) {
  Step p{};
  fill_step(p, ptrs, dims, scalars);
  p.max_chunk = 0;
  p.xsum_floats = imax(p.D, imax(p.A, p.F)) / 16;
  StreamFmt fmt{};
  fmt.scores = (float*)ptrs[22];
  const int R[5] = {p.Rq, p.D, 2 * p.F, p.D, p.V};
  const int C[5] = {p.D, p.A, p.D, p.F, p.D};
  if (!stream_shapes_ok(p, grid) || fmt.scores == nullptr) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 5; ++k) {
    const int f = winfo[3 * k], gs = winfo[3 * k + 1];
    Part& pt = p.parts[k];
    fmt.fmt[k] = f;
    fmt.gs[k] = gs;
    fmt.bias[k] = winfo[3 * k + 2] ? 8.f : 0.f;
    fmt.has_off[k] = wptrs[3 * k + 2] != nullptr;
    if ((k == kLogits) != (f == kBF16) || f < 0 || f > kBF16 || wptrs[3 * k] == nullptr)
      return (int)cudaErrorInvalidValue;
    pt.base[0] = (const char*)wptrs[3 * k];
    pt.row_bytes[0] = f == kI8 ? C[k] : f == kNib ? C[k] / 2 : 2 * C[k];
    pt.n_planes = 1;
    if (f != kBF16) {
      if ((gs != 16 && gs != 32) || C[k] % (4 * gs) || wptrs[3 * k + 1] == nullptr)
        return (int)cudaErrorInvalidValue;
      const int gbytes = 4 * (C[k] / gs);  // a multiple of 16: the bulk copies need it
      pt.base[1] = (const char*)wptrs[3 * k + 1];
      pt.row_bytes[1] = gbytes;
      pt.n_planes = 2;
      if (fmt.has_off[k]) {
        pt.base[2] = (const char*)wptrs[3 * k + 2];
        pt.row_bytes[2] = gbytes;
        pt.n_planes = 3;
      }
    }
    int row = 0;
    for (int j = 0; j < pt.n_planes; ++j) {
      pt.layer_bytes[j] = k == kLogits ? 0 : (long long)R[k] * pt.row_bytes[j];
      row += pt.row_bytes[j];
    }
    if (row * (k == kGU ? 2 : 1) > kStageBytes) return (int)cudaErrorInvalidValue;
  }
  TilePlan& tp = fmt.plan;
  for (int k = 0; k < 5; ++k) {
    tp.rb[k] = plan[k];
    tp.cs[k] = plan[5 + k];
  }
  tp.stage_bytes = plan[10];
  tp.stages = plan[11];
  if (tp.stages < 2 || tp.stages > kMaxStreamStages || tp.stage_bytes < 1 || tp.stage_bytes % 16)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 5; ++k) {
    // rb rows in groups of 16 (gate/up: 8 pairs), a group's slab over 16 / NG
    // warps by whole 32-byte pieces; slabs of whole 128-byte boxes
    const int rb = tp.rb[k], qbytes = plane_bytes(fmt, k, 0, tp.cs[k]);
    const int ng = k == kGU ? rb / 8 : rb / 16;
    if ((rb != 16 && rb != 32 && rb != 64) || tp.cs[k] < 128 || tp.cs[k] % 128 ||
        qbytes % 128 || qbytes % (32 * (kWarps / ng)) ||
        tile_bytes(p, fmt, k, rb, tp.cs[k]) > tp.stage_bytes || tp.stage_bytes % 1024 ||
        (fmt.fmt[k] == kNib && fmt.gs[k] != 32) || (fmt.fmt[k] != kBF16 && tp.cs[k] % fmt.gs[k]))
      return (int)cudaErrorInvalidValue;
  }
  Maps maps;
  for (int k = 0; k < 5; ++k)
    for (int j = 0; j < kMaxPlanes; ++j)
      if (!encode_plane(&maps.m[k][j], p, fmt, k, j < p.parts[k].n_planes ? j : 0, R[k]))
        return (int)cudaErrorInvalidValue;
  const int smem = (int)stream_layout(p, tp.stage_bytes, tp.stages).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > g_smem_checked) {  // sets the dynamic shared-memory limit once per size
    if (fused_decode_stream_grid(smem) < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
    g_smem_checked = smem;
  }
  void* args[] = {&p, &fmt, &maps};
  cudaError_t err = cudaLaunchCooperativeKernel((void*)decode_step_stream_kernel, dim3(grid),
                                                dim3(kThreads), args, smem,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* fused_decode_stream_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
