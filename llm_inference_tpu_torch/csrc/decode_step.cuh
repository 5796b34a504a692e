// The persistent, cooperative skeleton of a whole single-token decode step
// of a Gemma-3 model on Hopper (sm_90a), shared by the per-row int8 step
// (fused_decode.cu) and the lossless group-scaled step (fused_decode_q.cu).
// Each of those includes this header and supplies a weight format: how
// the embedding row is read, how one weight row of a GEMV phase is
// multiplied with the activation, and what the phase prepares first.
//
// The step, per layer: attn_norm -> bf16 -> fused QKV GEMV -> q/k RMS norms
// -> RoPE (q also * f_attention_scale) -> bf16 K/V row written in place at
// slot pos of the stacked cache -> attention over slots [start, pos] (bf16
// q.K, softcap, softmax with bf16 probabilities in the PV dot, f32
// denominator) -> bf16 -> Wo GEMV -> [post_attn_norm] -> residual ->
// ffn_norm -> bf16 -> gate/up GEMV -> tanh GeGLU -> bf16 -> down GEMV ->
// [post_ffw_norm] -> residual; then final norm -> bf16 -> tied-embedding
// logits [V] f32 (the caller applies the final softcap). The bf16 rounding
// points are the TPU kernels' (fused_decode.py:338, 353-355, 433, 439, 452,
// 481; fused_decode_q.py:312, 327-329, 379, 387, 397, 405).
//
// Design: one persistent kernel launched with cudaLaunchCooperativeKernel,
// one block per SM (grid sized with the occupancy API), phases separated by
// grid-wide barriers: QKV -> attention -> Wo -> gate/up + GeGLU -> down ->
// next layer; the last phase is the logits. The TPU kernels double-buffer a
// whole layer (~27 MB) in VMEM; an SM has 227 KB, so instead every GEMV
// phase gives each block a contiguous slab of weight rows, and a block's
// slabs for the whole step form one stream of 1-D bulk copies (TMA,
// cp.async.bulk) through a ring of three 36 KB shared-memory stages,
// completed on mbarriers: thread 0 refills a stage as soon as the block has
// consumed it, with the chunk three ahead, which may belong to the next
// phase or layer, so weights keep streaming while the block computes,
// waits at a barrier or runs attention. A chunk carries up to three planes
// of the same rows (the quants, and where the format streams them, the
// rows' group scales and offsets). Warps take the chunk's rows from shared
// memory, one row a warp. The residual stream x lives in each block's
// shared memory: every block recomputes the cheap [1, D] norms and residual
// adds itself, identically (fixed-order block reductions), so x never
// crosses the grid. Attention splits the live slots [start, pos] over blocks
// in two passes around one more barrier: scores and the split's max, then
// (with the max over all splits, as the TPU kernels' single softmax has it)
// the exp sums and bf16-probability PV sums, which every block adds up at
// the start of the Wo phase: six barriers a layer, five while one block
// holds all live slots. The cache is read only over [start, pos] (the TPU
// kernels read all S slots and mask, which adds exact zeros). The new K/V
// row is used from shared memory by the attention blocks and written to the
// cache by block 0, so no barrier waits on that write. Inter-block scratch
// is read with ld.global.cg (L2), never a stale L1 line. No atomics touch
// data, so the result is deterministic.
//
// gemma4 (decode_step_body<true>, the rowq8 step only; reference
// model.cpp:568-704, 774-835, 927-977, the TPU kernel's static features at
// fused_decode.py:194-530) adds to that step:
//   - a prologue: the per_layer_model_proj GEMV [L * P, D] over bf16 of the
//     scaled embedding row, / sqrt(D), into global scratch (its rows are the
//     stream's first segment; the layer-0 QKV barrier orders them before
//     any read);
//   - the unweighted RMS norm of each KV head's v;
//   - shared-KV layers (l >= n_kv) attend over layer kv_src[l]'s cache and
//     write none: the new row at slot pos is the source layer's, which
//     block 0 wrote several grid barriers earlier, so every block reads it
//     back with ld.global.cg;
//   - after the down residual, the per-layer-input epilogue: inp = (rms(
//     proj_l) * per_layer_proj_norm + emb_l) / sqrt(2) (emb_l the token's
//     per-layer embedding slice, gathered by every block), the gate GEMV
//     [P, D] over bf16(x) -> GeLU * inp -> bf16 in scratch, a grid barrier,
//     the proj GEMV [D, P] -> scratch, a grid barrier, and in every block
//     x += rms(proj) * per_layer_post_norm, then x *= out_scale: eight
//     barriers a layer. The two GEMVs are two more stream segments a layer.
// The gemma4 instance reads every GEMV activation from shared memory (no
// register slice), so its width is bound by shared memory, not by
// kMaxRegCols; the per-warp PV partials then hold one KV group at a time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMinChunk = 64;  // fewest cache slots an attention block takes
constexpr int kMaxGroup = 4;   // q heads per KV head the attention registers hold
constexpr int kStages = 3;       // weight-stream ring stages per block
constexpr int kStageBytes = 36864;  // one stage: 32 rows of 1152 int8
constexpr int kMarks = 13;       // profile timestamps per layer
constexpr int kMarksG4 = 17;     // the same with gemma4's gate and proj phases
constexpr int kMaxRegCols = 1536;  // widest activation a lane holds in registers
constexpr int kMaxPlanes = 3;

// GEMV phases. gemma4 adds the prologue's per_layer_model_proj (kPLM) and
// each layer's per-layer-input gate (kPLG) and projection (kPLJ).
enum Kind { kQKV = 0, kWo = 1, kGU = 2, kDown = 3, kLogits = 4, kPLM = 5, kPLG = 6, kPLJ = 7 };
constexpr int kKinds = 8;

// One GEMV phase's weights as the stream reads them: up to kMaxPlanes arrays
// of rows (plane 0 the quants; the others per-row data such as group
// scales), each ``row_bytes`` a row (a multiple of 16), layer l at
// ``base + l * layer_bytes``. Gate/up rows come in pairs: the up row of
// gate row f is row F + f of the same arrays.
struct Part {
  const char* base[kMaxPlanes];
  long long layer_bytes[kMaxPlanes];
  int row_bytes[kMaxPlanes];
  int n_planes;
};

struct Step {
  const long long* token;  // [1] token id (device)
  const int* pos;          // [1] position (device)
  const int* base_idx;     // [L] rope-base row per layer
  const int* windows;      // [L] sliding window per layer, 0 = none
  const float* inv_freq;   // [n_bases, dk / 2]
  const float* attn_norm;  // [L, D]
  const float* ffn_norm;   // [L, D]
  const float* q_norm;     // [L, dk]
  const float* k_norm;     // [L, dk]
  const float* out_norm;   // [D]
  const float* post_attn_norm;  // [L, D] or null
  const float* post_ffw_norm;   // [L, D] or null
  __nv_bfloat16* kc;  // [L, S, Hkv * dk]
  __nv_bfloat16* vc;  // [L, S, Hkv * dv]
  float* logits;      // [V]
  // inter-block scratch
  float* qkv;            // [Rq]
  float* part;           // [grid, H, dv + 2]: per-block max, sum, PV
  float* y_attn;         // [D]
  __nv_bfloat16* act;    // [F]
  float* y_ffn;          // [D]
  unsigned int* barrier; // [2]: arrivals, generation
  unsigned long long* prof;  // [L * marks + 3] phase timestamps (ns), or null
  Part parts[5];         // by Kind
  int L, D, F, A, Rq, V, S, H, Hkv, dk, dv, max_chunk;
  int xsum_floats;       // shared floats the format keeps per-group activation sums in
  float eps, attn_scale, softcap, freq_scale, emb_mult;
};

// gemma4's parameters beyond Step (the gemma4 instance's format carries
// them, so Step, and with it the Gemma-3 and lossless instances' code, is
// what it was before gemma4).
struct G4Params {
  Part parts[3];              // kPLM, kPLG, kPLJ (index kind - kPLM)
  const int* kv_src;          // [L] the cache layer each layer attends over
  const float* out_scale;     // [L] or null
  const float* pl_proj_norm;  // [P]
  const float* pl_post_norm;  // [L, D]
  const int8_t* pl_emb_q;     // [V, L * P] per-layer embedding, per-row int8
  const float* pl_emb_s;      // [V]
  float* pl_proj;             // [L * P] scratch: per_layer_model_proj(x0) / sqrt(D)
  int P, n_kv;
  float pl_emb_mult, pl_proj_mult, inv_sqrt2;  // sqrt(P), 1 / sqrt(D), 1 / sqrt(2)
};

struct Smem {
  float* x;     // [D] residual stream
  float* tmp;   // [D]
  float* qkv;   // [Rq]
  float* sc;    // [H * max_chunk] scores, then probabilities
  float* red;   // [32]
  float* stat;  // [2 * H] per-head sum, then max
  float* pv;    // [kWarps, H, dv] per-warp PV partial sums
  __nv_bfloat16* hv;  // [max(D, A, F)] GEMV activation
  __nv_bfloat16* qb;  // [H * dk]
  __nv_bfloat16* kn;  // [Hkv * dk]
  __nv_bfloat16* vn;  // [Hkv * dv]
  float* xsum;        // [xsum_floats]
  char* ring;         // [kStages][kStageBytes] weight stream
  uint64_t* bars;     // [kStages] stage-full barriers
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Byte offsets of the shared-memory arrays; ``total`` is the size.
struct Layout {
  size_t x, tmp, qkv, sc, red, stat, pv, hv, qb, kn, vn, xsum, ring, bars, total;
};

// ``g4``: the gemma4 instance's layout (one KV group's PV partials).
__host__ __device__ inline Layout smem_layout(const Step& p, bool g4 = false) {
  Layout o;
  size_t off = 0;
  o.x = off;    off += align16(sizeof(float) * p.D);
  o.tmp = off;  off += align16(sizeof(float) * p.D);
  o.qkv = off;  off += align16(sizeof(float) * p.Rq);
  o.sc = off;   off += align16(sizeof(float) * p.H * p.max_chunk);
  o.red = off;  off += align16(sizeof(float) * 32);
  o.stat = off; off += align16(sizeof(float) * 2 * p.H);
  // per-warp PV partials: every head, or (gemma4) one KV group's heads
  o.pv = off;   off += align16(sizeof(float) * kWarps * (g4 ? p.H / p.Hkv : p.H) * p.dv);
  o.hv = off;   off += align16(2 * (size_t)imax(p.D, imax(p.A, p.F)));
  o.qb = off;   off += align16(2 * (size_t)p.H * p.dk);
  o.kn = off;   off += align16(2 * (size_t)p.Hkv * p.dk);
  o.vn = off;   off += align16(2 * (size_t)p.Hkv * p.dv);
  o.xsum = off; off += align16(sizeof(float) * p.xsum_floats);
  o.ring = off; off += (size_t)kStages * kStageBytes;
  o.bars = off; off += align16(8 * kStages);
  o.total = off;
  return o;
}

__device__ inline Smem smem_carve(const Step& p, char* base, bool g4 = false) {
  const Layout o = smem_layout(p, g4);
  return Smem{(float*)(base + o.x), (float*)(base + o.tmp), (float*)(base + o.qkv),
              (float*)(base + o.sc), (float*)(base + o.red), (float*)(base + o.stat),
              (float*)(base + o.pv),
              (__nv_bfloat16*)(base + o.hv), (__nv_bfloat16*)(base + o.qb),
              (__nv_bfloat16*)(base + o.kn), (__nv_bfloat16*)(base + o.vn),
              (float*)(base + o.xsum), base + o.ring, (uint64_t*)(base + o.bars)};
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }
// Byte k of a word of int8 values as f32, without I2F (16 a clock per SM):
// the byte, offset by 128, becomes the mantissa of 2^23 (one byte permute)
// and one subtraction removes 2^23 + 128. Exact for every int8.
__device__ __forceinline__ float i8(uint32_t u, int k) {
  return __int_as_float(__byte_perm(u ^ 0x80808080u, 0x4B000000u, 0x7540u + k)) - 8388736.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  return v;
}

// Fixed-order block sum (same result in every block for the same input).
__device__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < kWarps ? red[lane] : 0.f;
  t = warp_sum(t);
  return t;  // every warp holds the total
}

// rsqrt(mean(v^2) + eps) over n values in shared memory.
__device__ float rms_scale(const float* v, int n, float eps, float* red) {
  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) ss += v[i] * v[i];
  ss = block_sum(ss, red);
  return rsqrtf(ss / (float)n + eps);
}

// 16 int8 weights . 16 bf16 activations.
__device__ __forceinline__ float dot16(const uint4 w, const __nv_bfloat16* a) {
  const uint4 a0 = *reinterpret_cast<const uint4*>(a);
  const uint4 a1 = *reinterpret_cast<const uint4*>(a + 8);
  float s = 0.f;
  s = fmaf(i8(w.x, 0), bf16_lo(a0.x), s); s = fmaf(i8(w.x, 1), bf16_hi(a0.x), s);
  s = fmaf(i8(w.x, 2), bf16_lo(a0.y), s); s = fmaf(i8(w.x, 3), bf16_hi(a0.y), s);
  s = fmaf(i8(w.y, 0), bf16_lo(a0.z), s); s = fmaf(i8(w.y, 1), bf16_hi(a0.z), s);
  s = fmaf(i8(w.y, 2), bf16_lo(a0.w), s); s = fmaf(i8(w.y, 3), bf16_hi(a0.w), s);
  s = fmaf(i8(w.z, 0), bf16_lo(a1.x), s); s = fmaf(i8(w.z, 1), bf16_hi(a1.x), s);
  s = fmaf(i8(w.z, 2), bf16_lo(a1.y), s); s = fmaf(i8(w.z, 3), bf16_hi(a1.y), s);
  s = fmaf(i8(w.w, 0), bf16_lo(a1.z), s); s = fmaf(i8(w.w, 1), bf16_hi(a1.z), s);
  s = fmaf(i8(w.w, 2), bf16_lo(a1.w), s); s = fmaf(i8(w.w, 3), bf16_hi(a1.w), s);
  return s;
}

// 8 bf16 . 8 bf16 (one 16-byte lane slice of a head)
__device__ __forceinline__ float dot8(const uint4 x, const uint4 y) {
  float acc = 0.f;
  acc = fmaf(bf16_lo(x.x), bf16_lo(y.x), acc); acc = fmaf(bf16_hi(x.x), bf16_hi(y.x), acc);
  acc = fmaf(bf16_lo(x.y), bf16_lo(y.y), acc); acc = fmaf(bf16_hi(x.y), bf16_hi(y.y), acc);
  acc = fmaf(bf16_lo(x.z), bf16_lo(y.z), acc); acc = fmaf(bf16_hi(x.z), bf16_hi(y.z), acc);
  acc = fmaf(bf16_lo(x.w), bf16_lo(y.w), acc); acc = fmaf(bf16_hi(x.w), bf16_hi(y.w), acc);
  return acc;
}

// ---- the weight stream: 1-D bulk copies (TMA) into a ring of stages ---------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// This block's share of one GEMV phase: rows [r0, r1) of R, in chunks of
// ``ch`` rows (gate/up chunks carry ``ch`` gate rows, then the matching
// ``ch`` up rows, in each plane); plane j of a chunk starts ``plane_off[j]``
// bytes into its stage.
struct Seg {
  int r0, r1, R, ch, copies, n;
  int plane_off[kMaxPlanes];
};

// The phase list of a step's weight stream, fixed at compile time: kSegs
// kinds (0 .. kSegs - 1) with a segment each; kPrologue: kPLM's chunks come
// before layer 0; then per layer the kLayer phases layer_kind(0 ..
// kLayer - 1), in that order; then the logits chunks. part() and rows()
// give a kind's weights and row count; Extra is what the instance carries
// beyond Step. Gemma3Stream is the Gemma-3 steps' (and the capacity
// step's): per layer QKV, Wo, gate/up, down.
struct Gemma3Stream {
  struct Extra {};
  static constexpr int kSegs = 5, kLayer = 4;
  static constexpr bool kPrologue = false;
  __device__ static int layer_kind(int i) { return i; }
  __device__ static const Part& part(const Step& p, const Extra&, int kind) {
    return p.parts[kind];
  }
  __device__ static int rows(const Step& p, const Extra&, int kind) {
    return kind == kQKV ? p.Rq : kind == kGU ? p.F : kind == kLogits ? p.V : p.D;
  }
};

// gemma4's: the prologue's per_layer_model_proj, then per layer QKV, Wo,
// gate/up, down, the per-layer gate and the per-layer proj.
struct Gemma4Stream {
  using Extra = G4Params;
  static constexpr int kSegs = kKinds, kLayer = 6;
  static constexpr bool kPrologue = true;
  __device__ static int layer_kind(int i) { return i < 4 ? i : (i == 4 ? kPLG : kPLJ); }
  __device__ static const Part& part(const Step& p, const G4Params& q, int kind) {
    return kind < kPLM ? p.parts[kind] : q.parts[kind - kPLM];
  }
  __device__ static int rows(const Step& p, const G4Params& q, int kind) {
    return kind == kPLM ? p.L * q.P : kind == kPLG ? q.P : kind == kPLJ ? p.D
                                                                         : Gemma3Stream::rows(p, {}, kind);
  }
};

// The block's whole weight stream for one step, in consumption order.
template <class Ph>
struct Sched {
  Seg seg[Ph::kSegs];
  int pro, per_layer, total;  // pro: the prologue's chunks
};

template <class Ph>
__device__ Sched<Ph> make_sched(const Step& p, const typename Ph::Extra& ext) {
  Sched<Ph> sc;
  for (int k = 0; k < Ph::kSegs; ++k) {
    Seg& g = sc.seg[k];
    const Part& pt = Ph::part(p, ext, k);
    const int R = Ph::rows(p, ext, k);
    g.R = R;
    g.r0 = (int)((long long)blockIdx.x * R / gridDim.x);
    g.r1 = (int)((long long)(blockIdx.x + 1) * R / gridDim.x);
    g.copies = k == kGU ? 2 : 1;
    int row = 0;
    for (int j = 0; j < pt.n_planes; ++j) row += pt.row_bytes[j];
    g.ch = max(1, kStageBytes / (row * g.copies));
    int off = 0;
    for (int j = 0; j < kMaxPlanes; ++j) {
      g.plane_off[j] = off;
      if (j < pt.n_planes) off += g.copies * g.ch * pt.row_bytes[j];
    }
    g.n = (g.r1 - g.r0 + g.ch - 1) / g.ch;
  }
  sc.pro = 0;
  if constexpr (Ph::kPrologue) sc.pro = sc.seg[kPLM].n;
  sc.per_layer = 0;
  for (int i = 0; i < Ph::kLayer; ++i) sc.per_layer += sc.seg[Ph::layer_kind(i)].n;
  sc.total = sc.pro + p.L * sc.per_layer + sc.seg[kLogits].n;
  return sc;
}

// Thread 0: start the bulk copies of stream chunk ``k`` into its stage.
template <class Ph>
__device__ void issue_chunk(const Step& p, const typename Ph::Extra& ext, const Sched<Ph>& sc,
                            const Smem& s, int k) {
  int kind = kLogits, l = 0, j = k - sc.pro;
  if (Ph::kPrologue && j < 0) {
    kind = kPLM;
    j = k;
  } else if (j < p.L * sc.per_layer) {
    l = j / sc.per_layer;
    j %= sc.per_layer;
    int i = 0;
    while (j >= sc.seg[Ph::layer_kind(i)].n) j -= sc.seg[Ph::layer_kind(i++)].n;
    kind = Ph::layer_kind(i);
  } else {
    j -= p.L * sc.per_layer;
  }
  const Seg& g = sc.seg[kind];
  const Part& pt = Ph::part(p, ext, kind);
  const int row = g.r0 + j * g.ch;
  const int rows = min(g.ch, g.r1 - row);
  char* stage = s.ring + (size_t)(k % kStages) * kStageBytes;
  uint64_t* bar = s.bars + k % kStages;
  uint32_t bytes = 0;
  for (int pl = 0; pl < pt.n_planes; ++pl) bytes += (uint32_t)(rows * pt.row_bytes[pl] * g.copies);
  // order this block's earlier generic-proxy reads of the stage before the copy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_expect_tx(bar, bytes);
  for (int pl = 0; pl < pt.n_planes; ++pl) {
    const size_t rb = (size_t)pt.row_bytes[pl];
    const char* src = pt.base[pl] + (size_t)l * pt.layer_bytes[pl];
    for (int cp = 0; cp < g.copies; ++cp)
      bulk_load(stage + g.plane_off[pl] + cp * rows * rb, src + ((size_t)cp * g.R + row) * rb,
                (uint32_t)(rows * rb), bar);
  }
}

// Consume this block's chunks of phase ``kind``: per_row(row, chunk_row,
// chunk_rows, stage) runs once per row, one warp a row; each freed stage
// immediately takes the chunk kStages ahead, which may belong to a later
// phase or layer, so the stream keeps flowing across the grid barriers.
template <class Ph, class PerRow>
__device__ void consume(const Step& p, const typename Ph::Extra& ext, const Sched<Ph>& sc,
                        const Smem& s, int& k, int kind, PerRow&& per_row) {
  const int warp = threadIdx.x / 32;
  const Seg& g = sc.seg[kind];
  for (int j = 0; j < g.n; ++j, ++k) {
    mbar_wait(s.bars + k % kStages, (uint32_t)((k / kStages) & 1));
    const int row0 = g.r0 + j * g.ch;
    const int rows = min(g.ch, g.r1 - row0);
    const char* stage = s.ring + (size_t)(k % kStages) * kStageBytes;
    for (int rr = warp; rr < rows; rr += kWarps) per_row(row0 + rr, rr, rows, stage);
    __syncthreads();
    if (threadIdx.x == 0 && k + kStages < sc.total) issue_chunk(p, ext, sc, s, k + kStages);
  }
}

// A lane's slice of a bf16 activation of n <= 1536 values, in f32 registers:
// columns lane * 16 + k * 512 + e (k < 3, e < 16), zero past n.
struct ActRegs {
  float v[3][16];
};

__device__ __forceinline__ void load_act(ActRegs& r, const __nv_bfloat16* a, int n) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int c = lane * 16 + k * 512;
    const uint4 a0 = c < n ? *reinterpret_cast<const uint4*>(a + c) : make_uint4(0u, 0u, 0u, 0u);
    const uint4 a1 = c < n ? *reinterpret_cast<const uint4*>(a + c + 8) : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t w[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      r.v[k][2 * e] = bf16_lo(w[e]);
      r.v[k][2 * e + 1] = bf16_hi(w[e]);
    }
  }
}

// A weight row in shared memory (n <= 1536 int8, n % 16 == 0) against the
// activation registers; every lane gets the sum.
__device__ __forceinline__ float row_dot_regs(const int8_t* w, const ActRegs& r, int n) {
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int c = lane * 16 + k * 512;
    if (c < n) {
      const uint4 q = *reinterpret_cast<const uint4*>(w + c);
      const uint32_t qw[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 16; ++e) acc = fmaf(i8(qw[e / 4], e % 4), r.v[k][e], acc);
    }
  }
  return warp_sum(acc);
}

// A weight row in shared memory (n int8, n % 16 == 0) against the bf16
// activation in shared memory; every lane gets the sum.
__device__ __forceinline__ float smem_row_dot(const int8_t* w, const __nv_bfloat16* a, int n) {
  float acc = 0.f;
  for (int c = (threadIdx.x % 32) * 16; c < n; c += 512)
    acc += dot16(*reinterpret_cast<const uint4*>(w + c), a + c);
  return warp_sum(acc);
}

__device__ __forceinline__ void mark(const Step& p, int idx) {
  if (p.prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.prof[idx] = t;
  }
}

// Grid-wide barrier over co-resident blocks (the launch is cooperative):
// arrivals count up with a release-acquire atomic, the last one resets the
// count and publishes the next generation, the others spin on it.
__device__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int gen, old, cur;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(gen) : "l"(bar + 1) : "memory");
    __threadfence();
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;" : "=r"(old) : "l"(bar) : "memory");
    if (old == gridDim.x - 1) {
      asm volatile("st.relaxed.gpu.global.u32 [%0], 0;" ::"l"(bar) : "memory");
      asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(bar + 1), "r"(gen + 1) : "memory");
    } else {
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(cur) : "l"(bar + 1) : "memory");
      } while (cur == gen);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void attn_range(const Step& p, int pos, int l, int* start, int* chunk,
                                           int* splits) {
  const int wl = p.windows[l];
  *start = wl > 0 ? max(0, pos - wl + 1) : 0;
  const int n = pos - *start + 1;
  *chunk = max(kMinChunk, (n + (int)gridDim.x - 1) / (int)gridDim.x);
  *splits = (n + *chunk - 1) / *chunk;
}

// x += [norm](y) with y read from scratch; norm weights may be null.
__device__ void residual_add(const Step& p, Smem& s, const float* y, const float* norm_w) {
  for (int i = threadIdx.x; i < p.D; i += kThreads) s.tmp[i] = __ldcg(y + i);
  __syncthreads();
  float r = 1.f;
  if (norm_w) r = rms_scale(s.tmp, p.D, p.eps, s.red);
  for (int i = threadIdx.x; i < p.D; i += kThreads) {
    const float v = norm_w ? s.tmp[i] * r * norm_w[i] : s.tmp[i];
    s.x[i] = s.x[i] + v;
  }
  __syncthreads();
}

// hv = bf16(rms(x) * w)
__device__ void norm_to_hv(const Step& p, Smem& s, const float* w) {
  const float r = rms_scale(s.x, p.D, p.eps, s.red);
  for (int i = threadIdx.x; i < p.D; i += kThreads) s.hv[i] = __float2bfloat16_rn(s.x[i] * r * w[i]);
  __syncthreads();
}

// q/k norms, RoPE and the new K/V row of layer ``l`` from the QKV scratch,
// then attention over [start, pos] split over blocks (two grid barriers, or
// one while one block holds all live slots); leaves bf16(attention output)
// [H * dv] in s.hv in every block. ``m0`` is the layer's first profile mark.
// kG4: the unweighted V norm, shared-KV layers, and PV partials a KV group
// at a time (decode_step_body's gemma4 notes).
template <bool kG4>
__device__ void attention_phase(const Step& p, Smem& s, int l, int pos, int m0,
                                const G4Params* q = nullptr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = p.H / p.Hkv;
  const int hdk = p.dk / 2;  // rotary pairs (d, d + hdk)
  for (int i = threadIdx.x; i < p.Rq; i += kThreads) s.qkv[i] = __ldcg(p.qkv + i);
  __syncthreads();
  // q heads, then k heads (kG4: then the unweighted norm of each v head)
  const int n_norms = kG4 ? p.H + 2 * p.Hkv : p.H + p.Hkv;
  for (int hh = warp; hh < n_norms; hh += kWarps) {
    if constexpr (kG4) {
      if (hh >= p.H + p.Hkv) {
        float* v = s.qkv + (p.H + p.Hkv) * p.dk + (hh - p.H - p.Hkv) * p.dv;
        float ss = 0.f;
        for (int d = lane; d < p.dv; d += 32) ss += v[d] * v[d];
        const float r = rsqrtf(warp_sum(ss) / (float)p.dv + p.eps);
        for (int d = lane; d < p.dv; d += 32) v[d] = v[d] * r;
        continue;
      }
    }
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
  __syncthreads();
  const size_t krow = (size_t)p.Hkv * p.dk, vrow = (size_t)p.Hkv * p.dv;
  int src = l;         // the cache this layer attends over
  bool owner = true;   // a shared-KV layer writes no cache row
  if constexpr (kG4) {
    src = q->kv_src[l];
    owner = l < q->n_kv;
  }
  __nv_bfloat16* kl = p.kc + (size_t)src * p.S * krow;
  __nv_bfloat16* vl = p.vc + (size_t)src * p.S * vrow;
  if (blockIdx.x == 0 && owner) {  // the in-place cache write of slot pos
    for (int i = threadIdx.x; i < (int)krow; i += kThreads) kl[(size_t)pos * krow + i] = s.kn[i];
    for (int i = threadIdx.x; i < (int)vrow; i += kThreads) vl[(size_t)pos * vrow + i] = s.vn[i];
  }
  if constexpr (kG4) {
    if (!owner) {
      // the source layer's row at pos, written by block 0 before a grid
      // barrier that this block has passed since: read from L2
      const unsigned short* kq = reinterpret_cast<const unsigned short*>(kl + (size_t)pos * krow);
      const unsigned short* vq = reinterpret_cast<const unsigned short*>(vl + (size_t)pos * vrow);
      for (int i = threadIdx.x; i < (int)krow; i += kThreads) s.kn[i] = __ushort_as_bfloat16(__ldcg(kq + i));
      for (int i = threadIdx.x; i < (int)vrow; i += kThreads) s.vn[i] = __ushort_as_bfloat16(__ldcg(vq + i));
      __syncthreads();
    }
  }
  int start, chunk, splits;
  attn_range(p, pos, l, &start, &chunk, &splits);
  // each split block takes slots [j0, j0 + nj); scores stay in its smem
  const bool active = (int)blockIdx.x < splits;
  const int j0 = start + blockIdx.x * chunk;
  const int nj = active ? min(chunk, pos + 1 - j0) : 0;
  float* part = p.part + (size_t)blockIdx.x * p.H * (p.dv + 2);  // [H][max, sum, PV]
  const bool lane_k = lane * 8 < p.dk, lane_v = lane * 8 < p.dv;  // dk, dv <= 256
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (active) {
    // scores: a warp takes four slots at a time, its K loads all in flight
    for (int g = 0; g < p.Hkv; ++g) {
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
          const uint4 qv = lane_k ? *reinterpret_cast<const uint4*>(s.qb + h * p.dk + lane * 8)
                                  : zero;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float sc = warp_sum(dot8(qv, kv[u]));
            if (p.softcap > 0.f) sc = p.softcap * tanhf(sc / p.softcap);
            if (lane == 0 && jj0 + u < nj) s.sc[h * p.max_chunk + jj0 + u] = sc;
          }
        }
      }
    }
    __syncthreads();
    for (int h = warp; h < p.H; h += kWarps) {
      const float* row = s.sc + h * p.max_chunk;
      float m = -INFINITY;
      for (int jj = lane; jj < nj; jj += 32) m = fmaxf(m, row[jj]);
      m = warp_max(m);
      if (lane == 0) {
        s.stat[p.H + h] = m;
        __stcg(part + h * (p.dv + 2), m);
      }
    }
  }
  // The softmax uses the max over ALL live slots, as the TPU kernel does,
  // so every probability rounds to bf16 exactly as there and the splits
  // combine by plain sums (a per-split max would round them differently).
  // One split needs no exchange (every block takes the same branch).
  mark(p, m0 + 3);
  if (splits > 1) grid_sync(p.barrier);
  mark(p, m0 + 4);
  if (active) {
    for (int h = warp; h < p.H; h += kWarps) {
      float m = -INFINITY;
      if (splits > 1) {
        for (int b = lane; b < splits; b += 32)
          m = fmaxf(m, __ldcg(p.part + ((size_t)b * p.H + h) * (p.dv + 2)));
        m = warp_max(m);
      } else {
        m = s.stat[p.H + h];
      }
      float* row = s.sc + h * p.max_chunk;
      float sum = 0.f;
      for (int jj = lane; jj < nj; jj += 32) {
        const float e = expf(row[jj] - m);
        row[jj] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) s.stat[h] = sum;
    }
    __syncthreads();
    // PV: a warp takes two slots at a time, each lane 8 dims of V (one
    // 16-byte load) for every q head of the group; the warps' partial sums
    // then add up in a fixed order (kG4: a group's at a time, in s.pv sized
    // for one group)
    const int pvh = kG4 ? G : p.H;  // heads whose per-warp partials s.pv holds
    for (int g = 0; g < p.Hkv; ++g) {
      float o[kMaxGroup][8];
#pragma unroll
      for (int i = 0; i < kMaxGroup; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) o[i][k] = 0.f;
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
            const float pb = bf16r(s.sc[(g * G + i) * p.max_chunk + jj0 + u]);
#pragma unroll
            for (int k = 0; k < 8; ++k) o[i][k] = fmaf(pb, vf[k], o[i][k]);
          }
        }
      }
      if (lane_v) {
#pragma unroll
        for (int i = 0; i < kMaxGroup; ++i) {
          if (i >= G) break;
          float* dst = s.pv + ((size_t)warp * pvh + (kG4 ? i : g * G + i)) * p.dv + lane * 8;
#pragma unroll
          for (int k = 0; k < 8; ++k) dst[k] = o[i][k];
        }
      }
      if constexpr (kG4) {
        __syncthreads();
        for (int idx = threadIdx.x; idx < G * p.dv; idx += kThreads) {
          const int h = g * G + idx / p.dv, d = idx % p.dv;
          float o = 0.f;
          for (int w = 0; w < kWarps; ++w) o += s.pv[(size_t)w * G * p.dv + idx];
          __stcg(part + h * (p.dv + 2) + 2 + d, o);
          if (d == 0) __stcg(part + h * (p.dv + 2) + 1, s.stat[h]);
        }
        __syncthreads();  // before the next group overwrites s.pv
      }
    }
    if constexpr (!kG4) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < p.H * p.dv; idx += kThreads) {
        const int h = idx / p.dv, d = idx % p.dv;
        float o = 0.f;
        for (int w = 0; w < kWarps; ++w) o += s.pv[(size_t)w * p.H * p.dv + idx];
        __stcg(part + h * (p.dv + 2) + 2 + d, o);
        if (d == 0) __stcg(part + h * (p.dv + 2) + 1, s.stat[h]);
      }
    }
  }
  mark(p, m0 + 5);
  grid_sync(p.barrier);
  mark(p, m0 + 6);

  // ---- combine the attention partials, Wo ---------------------------
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

// gemma4: s.tmp[0, P) = layer l's per-layer input (rms(proj_l) *
// per_layer_proj_norm + the token's per-layer embedding slice * sqrt(P)) /
// sqrt(2), in every block (fused_decode.py:459-465 of the TPU kernel).
__device__ void per_layer_input(const Step& p, const G4Params& q, Smem& s, int l, int tok) {
  const int P = q.P;
  for (int i = threadIdx.x; i < P; i += kThreads) s.tmp[i] = __ldcg(q.pl_proj + (size_t)l * P + i);
  __syncthreads();
  const float r = rms_scale(s.tmp, P, p.eps, s.red);
  const int8_t* eq = q.pl_emb_q + ((size_t)tok * p.L + l) * P;
  const float es = q.pl_emb_s[tok];
  for (int i = threadIdx.x; i < P; i += kThreads)
    s.tmp[i] = (s.tmp[i] * r * q.pl_proj_norm[i] + (float)eq[i] * es * q.pl_emb_mult) * q.inv_sqrt2;
  __syncthreads();
}

// hv = bf16(x), no norm
__device__ void x_to_hv(const Step& p, Smem& s) {
  for (int i = threadIdx.x; i < p.D; i += kThreads) s.hv[i] = __float2bfloat16_rn(s.x[i]);
  __syncthreads();
}

// An instance's stream phase list, and what it carries beyond Step.
template <bool kG4> struct StreamOf {
  using type = Gemma3Stream;
  template <class Fmt> __device__ static Gemma3Stream::Extra extra(const Fmt&) { return {}; }
};
template <> struct StreamOf<true> {
  using type = Gemma4Stream;
  template <class Fmt> __device__ static const G4Params& extra(const Fmt& f) { return f.g4; }
};

// The whole step, over a weight format ``Fmt``, which supplies:
//   kRegs                       true: phases but the down projection take
//                               the activation in registers (load_act);
//                               false: every phase reads it from s.hv
//   embed(p, s, tok)            s.x = the token's embedding row * sqrt(D)
//   begin(p, s, kind, l)        per-phase set-up once s.hv holds the activation
//   row(p, s, seg, ar, kind, l, r, rr, rows, stage, copy)
//                               weight row r (chunk row rr of ``rows``, in
//                               ``stage``; copy 1: gate/up's up row) times the
//                               activation, scales applied; every lane gets it.
// kG4 adds gemma4's features (the header's notes); its formats read the
// activation from shared memory and carry G4Params as ``g4``.
template <bool kG4, class Fmt>
__device__ void decode_step_body(const Step& p, const Fmt& fmt) {
  static_assert(!(kG4 && Fmt::kRegs), "the gemma4 step reads its activations from shared memory");
  constexpr int kM = kG4 ? kMarksG4 : kMarks;
  extern __shared__ __align__(16) char smem_raw[];
  Smem s = smem_carve(p, smem_raw, kG4);
  const int lane = threadIdx.x % 32;
  const long long tok64 = p.token[0];
  const int tok = (int)tok64;
  const int pos = p.pos[0];
  const int D = p.D, F = p.F, A = p.A;

  // A position outside the cache or a token outside the vocabulary would
  // read and write out of bounds: every block sees the same values and
  // leaves before the first barrier, and the logits come back NaN.
  if (pos < 0 || pos >= p.S || tok64 < 0 || tok64 >= p.V) {
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.V; i += gridDim.x * kThreads)
      p.logits[i] = __int_as_float(0x7fc00000);
    return;
  }

  // the weight stream starts before anything else
  using Ph = typename StreamOf<kG4>::type;
  const auto& ext = StreamOf<kG4>::extra(fmt);
  __shared__ Sched<Ph> sched_s;
  const G4Params* q = nullptr;
  if constexpr (kG4) q = &fmt.g4;
  if (threadIdx.x == 0) {
    mark(p, 0);
    sched_s = make_sched<Ph>(p, ext);
    for (int i = 0; i < kStages; ++i) mbar_init(s.bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < kStages && k < sched_s.total; ++k) issue_chunk(p, ext, sched_s, s, k);
  }
  __syncthreads();
  const auto& sc = sched_s;
  int k = 0;  // next stream chunk, the same in every thread

  fmt.embed(p, s, tok);
  __syncthreads();

  if constexpr (kG4) {
    // ---- prologue: per_layer_model_proj over bf16(x0), / sqrt(D) ---------
    x_to_hv(p, s);
    ActRegs ar;  // unused: the rows read s.hv
    consume(p, ext, sc, s, k, kPLM, [&](int r, int rr, int rows, const char* st) {
      const float v = fmt.row(p, s, sc.seg[kPLM], ar, kPLM, 0, r, rr, rows, st, 0);
      if (lane == 0) __stcg(q->pl_proj + r, v * q->pl_proj_mult);
    });
  }

  for (int l = 0; l < p.L; ++l) {
    const int m0 = 1 + l * kM;
    mark(p, m0);
    if (!kG4 && l > 0)
      residual_add(p, s, p.y_ffn, p.post_ffw_norm ? p.post_ffw_norm + (size_t)(l - 1) * D : nullptr);

    // ---- QKV ---------------------------------------------------------
    norm_to_hv(p, s, p.attn_norm + (size_t)l * D);
    fmt.begin(p, s, kQKV, l);
    {
      ActRegs ar;
      if constexpr (Fmt::kRegs) load_act(ar, s.hv, D);
      consume(p, ext, sc, s, k, kQKV, [&](int r, int rr, int rows, const char* st) {
        const float v = fmt.row(p, s, sc.seg[kQKV], ar, kQKV, l, r, rr, rows, st, 0);
        if (lane == 0) __stcg(p.qkv + r, v);
      });
    }
    mark(p, m0 + 1);
    grid_sync(p.barrier);
    mark(p, m0 + 2);

    // ---- q/k norms, RoPE, new K/V row, attention ------------------------
    attention_phase<kG4>(p, s, l, pos, m0, q);

    // ---- Wo ----------------------------------------------------------
    fmt.begin(p, s, kWo, l);
    {
      ActRegs ar;
      if constexpr (Fmt::kRegs) load_act(ar, s.hv, A);
      consume(p, ext, sc, s, k, kWo, [&](int r, int rr, int rows, const char* st) {
        const float v = fmt.row(p, s, sc.seg[kWo], ar, kWo, l, r, rr, rows, st, 0);
        if (lane == 0) __stcg(p.y_attn + r, v);
      });
    }
    mark(p, m0 + 7);
    grid_sync(p.barrier);
    mark(p, m0 + 8);

    // ---- residual, ffn_norm, gate/up + GeGLU --------------------------
    residual_add(p, s, p.y_attn, p.post_attn_norm ? p.post_attn_norm + (size_t)l * D : nullptr);
    norm_to_hv(p, s, p.ffn_norm + (size_t)l * D);
    fmt.begin(p, s, kGU, l);
    {
      ActRegs ar;
      if constexpr (Fmt::kRegs) load_act(ar, s.hv, D);
      consume(p, ext, sc, s, k, kGU, [&](int f, int rr, int rows, const char* st) {
        const float g = fmt.row(p, s, sc.seg[kGU], ar, kGU, l, f, rr, rows, st, 0);
        const float u = fmt.row(p, s, sc.seg[kGU], ar, kGU, l, f, rr, rows, st, 1);
        if (lane == 0) {
          const float c = 0.7978845608028654f;
          const float a = 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g))) * u;
          __stcg(reinterpret_cast<unsigned short*>(p.act) + f,
                 __bfloat16_as_ushort(__float2bfloat16_rn(a)));
        }
      });
    }
    mark(p, m0 + 9);
    grid_sync(p.barrier);
    mark(p, m0 + 10);

    // ---- down ----------------------------------------------------------
    for (int i = threadIdx.x; i < F / 8; i += kThreads)
      reinterpret_cast<uint4*>(s.hv)[i] = __ldcg(reinterpret_cast<const uint4*>(p.act) + i);
    __syncthreads();
    fmt.begin(p, s, kDown, l);
    {
      ActRegs ar;  // unused: the down rows read s.hv
      consume(p, ext, sc, s, k, kDown, [&](int r, int rr, int rows, const char* st) {
        const float v = fmt.row(p, s, sc.seg[kDown], ar, kDown, l, r, rr, rows, st, 0);
        if (lane == 0) __stcg(p.y_ffn + r, v);
      });
    }
    mark(p, m0 + 11);
    grid_sync(p.barrier);
    mark(p, m0 + 12);

    if constexpr (kG4) {
      // ---- the per-layer-input epilogue, out_scale -----------------------
      // gate: bf16(GeLU(gate . bf16(x)) * inp) into act (free since down)
      residual_add(p, s, p.y_ffn, p.post_ffw_norm ? p.post_ffw_norm + (size_t)l * D : nullptr);
      per_layer_input(p, *q, s, l, tok);
      x_to_hv(p, s);
      ActRegs ar;  // unused: the rows read s.hv
      consume(p, ext, sc, s, k, kPLG, [&](int f, int rr, int rows, const char* st) {
        const float g = fmt.row(p, s, sc.seg[kPLG], ar, kPLG, l, f, rr, rows, st, 0);
        if (lane == 0) {
          const float c = 0.7978845608028654f;
          const float a = 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g))) * s.tmp[f];
          __stcg(reinterpret_cast<unsigned short*>(p.act) + f,
                 __bfloat16_as_ushort(__float2bfloat16_rn(a)));
        }
      });
      mark(p, m0 + 13);
      grid_sync(p.barrier);
      mark(p, m0 + 14);
      // proj: [D] into y_ffn (free since its residual add above)
      for (int i = threadIdx.x; i < q->P / 8; i += kThreads)
        reinterpret_cast<uint4*>(s.hv)[i] = __ldcg(reinterpret_cast<const uint4*>(p.act) + i);
      __syncthreads();
      consume(p, ext, sc, s, k, kPLJ, [&](int r, int rr, int rows, const char* st) {
        const float v = fmt.row(p, s, sc.seg[kPLJ], ar, kPLJ, l, r, rr, rows, st, 0);
        if (lane == 0) __stcg(p.y_ffn + r, v);
      });
      mark(p, m0 + 15);
      grid_sync(p.barrier);
      mark(p, m0 + 16);
      residual_add(p, s, p.y_ffn, q->pl_post_norm + (size_t)l * D);
      if (q->out_scale != nullptr) {
        const float os = q->out_scale[l];
        for (int i = threadIdx.x; i < D; i += kThreads) s.x[i] = s.x[i] * os;
        __syncthreads();
      }
    }
  }

  // ---- final norm, tied-embedding logits ---------------------------------
  if (!kG4)
    residual_add(p, s, p.y_ffn, p.post_ffw_norm ? p.post_ffw_norm + (size_t)(p.L - 1) * D : nullptr);
  norm_to_hv(p, s, p.out_norm);
  mark(p, 1 + p.L * kM);
  fmt.begin(p, s, kLogits, 0);
  ActRegs ar;
  if constexpr (Fmt::kRegs) load_act(ar, s.hv, D);
  consume(p, ext, sc, s, k, kLogits, [&](int r, int rr, int rows, const char* st) {
    const float v = fmt.row(p, s, sc.seg[kLogits], ar, kLogits, 0, r, rr, rows, st, 0);
    if (lane == 0) p.logits[r] = v;
  });
  mark(p, 2 + p.L * kM);
}

// Host side: the grid a cooperative launch of ``kernel`` gets on the current
// device (one block per SM), 0 if it cannot be resident with ``smem`` bytes.
inline int cooperative_grid(const void* kernel, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) != cudaSuccess)
    return 0;
  return per_sm >= 1 ? sms : 0;
}

// Host side: fill the non-weight fields of a Step from the wrappers' arrays:
// ``ptrs`` the 22 pointers from ``token`` to ``prof`` in field order,
// ``dims`` the 12 ints from L to max_chunk, ``scalars`` the 5 floats.
inline void fill_step(Step& p, void* const* ptrs, const int* dims, const float* scalars) {
  p.token = (const long long*)ptrs[0]; p.pos = (const int*)ptrs[1];
  p.base_idx = (const int*)ptrs[2]; p.windows = (const int*)ptrs[3];
  p.inv_freq = (const float*)ptrs[4]; p.attn_norm = (const float*)ptrs[5];
  p.ffn_norm = (const float*)ptrs[6]; p.q_norm = (const float*)ptrs[7];
  p.k_norm = (const float*)ptrs[8]; p.out_norm = (const float*)ptrs[9];
  p.post_attn_norm = (const float*)ptrs[10]; p.post_ffw_norm = (const float*)ptrs[11];
  p.kc = (__nv_bfloat16*)ptrs[12]; p.vc = (__nv_bfloat16*)ptrs[13];
  p.logits = (float*)ptrs[14]; p.qkv = (float*)ptrs[15]; p.part = (float*)ptrs[16];
  p.y_attn = (float*)ptrs[17]; p.act = (__nv_bfloat16*)ptrs[18]; p.y_ffn = (float*)ptrs[19];
  p.barrier = (unsigned int*)ptrs[20]; p.prof = (unsigned long long*)ptrs[21];
  p.L = dims[0]; p.D = dims[1]; p.F = dims[2]; p.A = dims[3]; p.Rq = dims[4]; p.V = dims[5];
  p.S = dims[6]; p.H = dims[7]; p.Hkv = dims[8]; p.dk = dims[9]; p.dv = dims[10];
  p.max_chunk = dims[11];
  p.eps = scalars[0]; p.attn_scale = scalars[1]; p.softcap = scalars[2];
  p.freq_scale = scalars[3]; p.emb_mult = scalars[4];
}

// Host side: the shapes every format of the step needs (``regs``: the
// format holds activations in registers, kMaxRegCols wide at most).
inline bool step_shapes_ok(const Step& p, int grid, bool regs = true) {
  return !(p.H % p.Hkv || p.D % 16 || p.F % 16 || p.A % 16 ||
           (regs && (p.D > kMaxRegCols || p.A > kMaxRegCols)) || p.A != p.H * p.dv || grid < 1 ||
           (p.dk != 128 && p.dk != 256) || (p.dv != 128 && p.dv != 256) || p.H / p.Hkv > kMaxGroup);
}

}  // namespace
