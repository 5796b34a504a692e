// The whole single-token decode step of a Gemma-3 model in one persistent
// cooperative kernel, for Hopper (sm_90a).
//
// Replaces llm_inference_tpu/ops/pallas/fused_decode.py::decode_step_megakernel
// (_make_kernel / _run_step), Gemma-3 features: per-row int8 (rowq8) stacked
// weights, q/k norms, optional post-attention / post-FFN norms, optional
// attention softcap and a per-layer sliding window. One call computes
//
//   token -> embedding row * row scale * sqrt(D)
//   per layer: attn_norm -> bf16 -> fused QKV dot * scales -> q/k RMS norms
//     -> RoPE (q also * f_attention_scale) -> bf16 K/V row written in place at
//     slot pos of the stacked cache -> attention over slots [start, pos]
//     (bf16 q.K, softcap, softmax with bf16 probabilities in the PV dot,
//     f32 denominator) -> bf16 -> Wo -> [post_attn_norm] -> residual ->
//     ffn_norm -> bf16 -> gate/up dot -> tanh GeGLU -> bf16 -> down ->
//     [post_ffw_norm] -> residual
//   -> final norm -> bf16 -> tied-embedding logits [V] f32 (the caller
//   applies the final softcap).
//
// The bf16 rounding points are the TPU kernel's (fused_decode.py:338,
// 353-355, 433, 439, 452, 481); the plain twin in ops/kernels/fused_decode.py
// mirrors them.
//
// What bounds it on the H100: bytes. A Gemma-3-1B step reads ~1.0 GB (698 MB
// of layer int8, 302 MB of tied-embedding int8, the row scales and the live
// K/V), about 0.3 ms at 3.35 TB/s, while its ~2 GFLOP are nothing to the
// card. The TPU kernel double-buffers a whole layer (~27 MB) in VMEM; an SM
// has 227 KB, so that structure cannot be copied.
//
// Design: one persistent kernel launched with cudaLaunchCooperativeKernel,
// one block per SM (grid sized with the occupancy API), phases separated by
// grid-wide barriers: QKV -> attention -> Wo -> gate/up + GeGLU -> down ->
// next layer; the last phase is the logits. Every GEMV phase gives each
// block a contiguous slab of weight rows. A block's slabs for the whole step
// form one stream of 1-D bulk copies (TMA, cp.async.bulk) through a ring of
// three 36 KB shared-memory stages, completed on mbarriers: thread 0 refills
// a stage as soon as the block has consumed it, with the chunk three ahead,
// which may belong to the next phase or layer, so weights keep streaming
// while the block computes, waits at a barrier or runs attention. Warps take
// the chunk's rows from shared memory, one row a warp. The residual stream
// x lives in each block's shared memory: every block recomputes the cheap
// [1, D] norms and residual adds itself, identically (fixed-order block
// reductions), so x never crosses the grid. Attention splits the live slots
// [start, pos] over blocks in two passes around one more barrier: scores and
// the split's max, then (with the max over all splits, as the TPU kernel's
// single softmax has it) the exp sums and bf16-probability PV sums, which
// every block adds up at the start of the Wo phase: six barriers a layer,
// five while one block holds all live slots. The cache is read only over
// [start, pos] (the TPU kernel reads all S slots and masks, which adds exact
// zeros). The new K/V row is used from shared memory by the attention
// blocks and written to the cache by block 0, so no barrier waits on that
// write. Inter-block scratch is read with ld.global.cg (L2), never a stale
// L1 line. No atomics touch data, so the result is deterministic.

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

struct Params {
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
  const int8_t* wqkv_q; const float* wqkv_s;  // [L, Rq, D], [L, Rq]
  const int8_t* wo_q; const float* wo_s;      // [L, D, A], [L, D]
  const int8_t* gu_q; const float* gu_s;      // [L, 2F, D], [L, 2F]
  const int8_t* wd_q; const float* wd_s;      // [L, D, F], [L, D]
  const int8_t* emb_q; const float* emb_s;    // [V, D], [V]
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
  unsigned long long* prof;  // [L * kMarks + 3] phase timestamps (ns), or null
  int L, D, F, A, Rq, V, S, H, Hkv, dk, dv, max_chunk;
  float eps, attn_scale, softcap, freq_scale, emb_mult;
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
  int8_t* ring;       // [kStages][kStageBytes] weight stream
  uint64_t* bars;     // [kStages] stage-full barriers
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Byte offsets of the shared-memory arrays; ``total`` is the size.
struct Layout {
  size_t x, tmp, qkv, sc, red, stat, pv, hv, qb, kn, vn, ring, bars, total;
};

__host__ __device__ inline Layout smem_layout(const Params& p) {
  Layout o;
  size_t off = 0;
  o.x = off;    off += align16(sizeof(float) * p.D);
  o.tmp = off;  off += align16(sizeof(float) * p.D);
  o.qkv = off;  off += align16(sizeof(float) * p.Rq);
  o.sc = off;   off += align16(sizeof(float) * p.H * p.max_chunk);
  o.red = off;  off += align16(sizeof(float) * 32);
  o.stat = off; off += align16(sizeof(float) * 2 * p.H);
  o.pv = off;   off += align16(sizeof(float) * kWarps * p.H * p.dv);
  o.hv = off;   off += align16(2 * (size_t)imax(p.D, imax(p.A, p.F)));
  o.qb = off;   off += align16(2 * (size_t)p.H * p.dk);
  o.kn = off;   off += align16(2 * (size_t)p.Hkv * p.dk);
  o.vn = off;   off += align16(2 * (size_t)p.Hkv * p.dv);
  o.ring = off; off += (size_t)kStages * kStageBytes;
  o.bars = off; off += align16(8 * kStages);
  o.total = off;
  return o;
}

__device__ inline Smem smem_carve(const Params& p, char* base) {
  const Layout o = smem_layout(p);
  return Smem{(float*)(base + o.x), (float*)(base + o.tmp), (float*)(base + o.qkv),
              (float*)(base + o.sc), (float*)(base + o.red), (float*)(base + o.stat),
              (float*)(base + o.pv),
              (__nv_bfloat16*)(base + o.hv), (__nv_bfloat16*)(base + o.qb),
              (__nv_bfloat16*)(base + o.kn), (__nv_bfloat16*)(base + o.vn),
              (int8_t*)(base + o.ring), (uint64_t*)(base + o.bars)};
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

enum Kind { kQKV = 0, kWo = 1, kGU = 2, kDown = 3, kLogits = 4 };

// This block's share of one GEMV phase: rows [r0, r1) of R, in chunks of
// ``ch`` rows of C int8 (gate/up chunks carry ``ch`` gate rows, then the
// matching ``ch`` up rows).
struct Seg {
  int r0, r1, ch, C, copies, n;
};

// The block's whole weight stream for one step, in consumption order:
// per layer QKV, Wo, gate/up, down chunks, then the logits chunks.
struct Sched {
  Seg seg[5];
  int per_layer, total;
};

__device__ Sched make_sched(const Params& p) {
  Sched sc;
  const int R[5] = {p.Rq, p.D, p.F, p.D, p.V};
  const int C[5] = {p.D, p.A, p.D, p.F, p.D};
  for (int k = 0; k < 5; ++k) {
    Seg& g = sc.seg[k];
    g.r0 = (int)((long long)blockIdx.x * R[k] / gridDim.x);
    g.r1 = (int)((long long)(blockIdx.x + 1) * R[k] / gridDim.x);
    g.C = C[k];
    g.copies = k == kGU ? 2 : 1;
    g.ch = max(1, kStageBytes / (C[k] * g.copies));
    g.n = (g.r1 - g.r0 + g.ch - 1) / g.ch;
  }
  sc.per_layer = sc.seg[kQKV].n + sc.seg[kWo].n + sc.seg[kGU].n + sc.seg[kDown].n;
  sc.total = p.L * sc.per_layer + sc.seg[kLogits].n;
  return sc;
}

// Thread 0: start the bulk copy of stream chunk ``k`` into its stage.
__device__ void issue_chunk(const Params& p, const Sched& sc, const Smem& s, int k) {
  int kind = kLogits, l = 0, j = k - p.L * sc.per_layer;
  if (j < 0) {
    l = k / sc.per_layer;
    j = k % sc.per_layer;
    kind = kQKV;
    while (j >= sc.seg[kind].n) j -= sc.seg[kind++].n;
  }
  const Seg& g = sc.seg[kind];
  const int row = g.r0 + j * g.ch;
  const uint32_t bytes = (uint32_t)(min(g.ch, g.r1 - row) * g.C);
  const int8_t* base;
  size_t layer_rows;
  switch (kind) {
    case kQKV: base = p.wqkv_q; layer_rows = p.Rq; break;
    case kWo: base = p.wo_q; layer_rows = p.D; break;
    case kGU: base = p.gu_q; layer_rows = 2 * (size_t)p.F; break;
    case kDown: base = p.wd_q; layer_rows = p.D; break;
    default: base = p.emb_q; layer_rows = 0;
  }
  base += ((size_t)l * layer_rows + row) * g.C;
  int8_t* dst = s.ring + (size_t)(k % kStages) * kStageBytes;
  uint64_t* bar = s.bars + k % kStages;
  // order this block's earlier generic-proxy reads of the stage before the copy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_expect_tx(bar, bytes * g.copies);
  bulk_load(dst, base, bytes, bar);
  if (kind == kGU) bulk_load(dst + bytes, base + (size_t)p.F * g.C, bytes, bar);
}

// Consume this block's chunks of phase ``kind``: per_row(row, chunk_row,
// chunk_rows, stage) runs once per row, one warp a row; each freed stage
// immediately takes the chunk kStages ahead, which may belong to a later
// phase or layer, so the stream keeps flowing across the grid barriers.
template <class PerRow>
__device__ void consume(const Params& p, const Sched& sc, const Smem& s, int& k, int kind,
                        PerRow&& per_row) {
  const int warp = threadIdx.x / 32;
  const Seg& g = sc.seg[kind];
  for (int j = 0; j < g.n; ++j, ++k) {
    mbar_wait(s.bars + k % kStages, (uint32_t)((k / kStages) & 1));
    const int row0 = g.r0 + j * g.ch;
    const int rows = min(g.ch, g.r1 - row0);
    const int8_t* stage = s.ring + (size_t)(k % kStages) * kStageBytes;
    for (int rr = warp; rr < rows; rr += kWarps) per_row(row0 + rr, rr, rows, stage);
    __syncthreads();
    if (threadIdx.x == 0 && k + kStages < sc.total) issue_chunk(p, sc, s, k + kStages);
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

__device__ __forceinline__ void mark(const Params& p, int idx) {
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

__device__ __forceinline__ void attn_range(const Params& p, int pos, int l, int* start, int* chunk,
                                           int* splits) {
  const int wl = p.windows[l];
  *start = wl > 0 ? max(0, pos - wl + 1) : 0;
  const int n = pos - *start + 1;
  *chunk = max(kMinChunk, (n + (int)gridDim.x - 1) / (int)gridDim.x);
  *splits = (n + *chunk - 1) / *chunk;
}

// x += [norm](y) with y read from scratch; norm weights may be null.
__device__ void residual_add(const Params& p, Smem& s, const float* y, const float* norm_w) {
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
__device__ void norm_to_hv(const Params& p, Smem& s, const float* w) {
  const float r = rms_scale(s.x, p.D, p.eps, s.red);
  for (int i = threadIdx.x; i < p.D; i += kThreads) s.hv[i] = __float2bfloat16_rn(s.x[i] * r * w[i]);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) decode_step_kernel(Params p) {
  extern __shared__ __align__(16) char smem_raw[];
  Smem s = smem_carve(p, smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long tok64 = p.token[0];
  const int tok = (int)tok64;
  const int pos = p.pos[0];
  const int G = p.H / p.Hkv;
  const int hdk = p.dk / 2;  // rotary pairs (d, d + hdk)
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
  __shared__ Sched sched_s;
  if (threadIdx.x == 0) {
    mark(p, 0);
    sched_s = make_sched(p);
    for (int i = 0; i < kStages; ++i) mbar_init(s.bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < kStages && k < sched_s.total; ++k) issue_chunk(p, sched_s, s, k);
  }
  __syncthreads();
  const Sched& sc = sched_s;
  int k = 0;  // next stream chunk, the same in every thread

  // embedding row * row scale * sqrt(D), in every block
  const float es = p.emb_s[tok];
  for (int i = threadIdx.x; i < D; i += kThreads)
    s.x[i] = (float)p.emb_q[(size_t)tok * D + i] * es * p.emb_mult;
  __syncthreads();

  for (int l = 0; l < p.L; ++l) {
    const int m0 = 1 + l * kMarks;
    mark(p, m0);
    if (l > 0) residual_add(p, s, p.y_ffn, p.post_ffw_norm ? p.post_ffw_norm + (size_t)(l - 1) * D : nullptr);

    // ---- QKV ---------------------------------------------------------
    norm_to_hv(p, s, p.attn_norm + (size_t)l * D);
    {
      const float* ws = p.wqkv_s + (size_t)l * p.Rq;
      ActRegs ar;
      load_act(ar, s.hv, D);
      consume(p, sc, s, k, kQKV, [&](int r, int rr, int, const int8_t* st) {
        const float v = row_dot_regs(st + (size_t)rr * D, ar, D);
        if (lane == 0) __stcg(p.qkv + r, v * ws[r]);
      });
    }
    mark(p, m0 + 1);
    grid_sync(p.barrier);
    mark(p, m0 + 2);

    // ---- q/k norms, RoPE, new K/V row, attention partials -------------
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
    __syncthreads();
    const size_t krow = (size_t)p.Hkv * p.dk, vrow = (size_t)p.Hkv * p.dv;
    __nv_bfloat16* kl = p.kc + (size_t)l * p.S * krow;
    __nv_bfloat16* vl = p.vc + (size_t)l * p.S * vrow;
    if (blockIdx.x == 0) {  // the in-place cache write of slot pos
      for (int i = threadIdx.x; i < (int)krow; i += kThreads) kl[(size_t)pos * krow + i] = s.kn[i];
      for (int i = threadIdx.x; i < (int)vrow; i += kThreads) vl[(size_t)pos * vrow + i] = s.vn[i];
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
      // then add up in a fixed order
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
            float* dst = s.pv + ((size_t)warp * p.H + g * G + i) * p.dv + lane * 8;
#pragma unroll
            for (int k = 0; k < 8; ++k) dst[k] = o[i][k];
          }
        }
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < p.H * p.dv; idx += kThreads) {
        const int h = idx / p.dv, d = idx % p.dv;
        float o = 0.f;
        for (int w = 0; w < kWarps; ++w) o += s.pv[(size_t)w * p.H * p.dv + idx];
        __stcg(part + h * (p.dv + 2) + 2 + d, o);
        if (d == 0) __stcg(part + h * (p.dv + 2) + 1, s.stat[h]);
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
    {
      const float* ws = p.wo_s + (size_t)l * D;
      ActRegs ar;
      load_act(ar, s.hv, A);
      consume(p, sc, s, k, kWo, [&](int r, int rr, int, const int8_t* st) {
        const float v = row_dot_regs(st + (size_t)rr * A, ar, A);
        if (lane == 0) __stcg(p.y_attn + r, v * ws[r]);
      });
    }
    mark(p, m0 + 7);
    grid_sync(p.barrier);
    mark(p, m0 + 8);

    // ---- residual, ffn_norm, gate/up + GeGLU --------------------------
    residual_add(p, s, p.y_attn, p.post_attn_norm ? p.post_attn_norm + (size_t)l * D : nullptr);
    norm_to_hv(p, s, p.ffn_norm + (size_t)l * D);
    {
      const float* ws = p.gu_s + (size_t)l * 2 * F;
      ActRegs ar;
      load_act(ar, s.hv, D);
      consume(p, sc, s, k, kGU, [&](int f, int rr, int rows, const int8_t* st) {
        const float g = row_dot_regs(st + (size_t)rr * D, ar, D) * ws[f];
        const float u = row_dot_regs(st + (size_t)(rows + rr) * D, ar, D) * ws[F + f];
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
    {
      const float* ws = p.wd_s + (size_t)l * D;
      consume(p, sc, s, k, kDown, [&](int r, int rr, int, const int8_t* st) {
        const float v = smem_row_dot(st + (size_t)rr * F, s.hv, F);
        if (lane == 0) __stcg(p.y_ffn + r, v * ws[r]);
      });
    }
    mark(p, m0 + 11);
    grid_sync(p.barrier);
    mark(p, m0 + 12);
  }

  // ---- final norm, tied-embedding logits ---------------------------------
  residual_add(p, s, p.y_ffn, p.post_ffw_norm ? p.post_ffw_norm + (size_t)(p.L - 1) * D : nullptr);
  norm_to_hv(p, s, p.out_norm);
  mark(p, 1 + p.L * kMarks);
  ActRegs ar;
  load_act(ar, s.hv, D);
  consume(p, sc, s, k, kLogits, [&](int r, int rr, int, const int8_t* st) {
    const float v = row_dot_regs(st + (size_t)rr * D, ar, D);
    if (lane == 0) p.logits[r] = v * p.emb_s[r];
  });
  mark(p, 2 + p.L * kMarks);
}

int g_smem_checked = 0;

}  // namespace

extern "C" {

// Blocks of the cooperative grid on the current device (one per SM), 0 if
// the kernel cannot be resident with ``smem`` bytes of shared memory.
int fused_decode_grid(int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (cudaFuncSetAttribute(decode_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_step_kernel, kThreads, smem) !=
      cudaSuccess)
    return 0;
  return per_sm >= 1 ? sms : 0;
}

// Shared memory the kernel needs for these dimensions (bytes).
int fused_decode_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv, int max_chunk) {
  Params p{};
  p.D = D; p.F = F; p.A = A; p.Rq = Rq; p.H = H; p.Hkv = Hkv; p.dk = dk; p.dv = dv;
  p.max_chunk = max_chunk;
  return (int)smem_layout(p).total;
}

int fused_decode_min_chunk() { return kMinChunk; }

// One decode step. ``ptrs`` holds the 32 device pointers in Params order,
// ``dims`` the 12 ints, ``scalars`` the 5 floats. Returns the launch's
// cudaError_t.
int fused_decode_step(void* const* ptrs, const int* dims, const float* scalars, int grid,
                      void* stream) {
  Params p;
  void** dst = reinterpret_cast<void**>(&p);
  for (int i = 0; i < 32; ++i) dst[i] = ptrs[i];
  int* di = &p.L;
  for (int i = 0; i < 12; ++i) di[i] = dims[i];
  float* df = &p.eps;
  for (int i = 0; i < 5; ++i) df[i] = scalars[i];
  if (p.H % p.Hkv || p.D % 16 || p.F % 16 || p.A % 16 || p.D > 1536 || p.A > 1536 ||
      p.F > kStageBytes || p.A != p.H * p.dv || grid < 1 ||
      (p.dk != 128 && p.dk != 256) || (p.dv != 128 && p.dv != 256) || p.H / p.Hkv > kMaxGroup)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_layout(p).total;
  if (smem > g_smem_checked) {  // sets the dynamic shared-memory limit once per size
    if (fused_decode_grid(smem) < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
    g_smem_checked = smem;
  }
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel((void*)decode_step_kernel, dim3(grid), dim3(kThreads),
                                                args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* fused_decode_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
