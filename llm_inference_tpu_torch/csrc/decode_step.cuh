// The shared skeleton of the whole single-token decode steps of a Gemma
// model on Hopper (sm_90a): the step's parameters (Step), the views of the
// blocks that run it, the counting grid barrier, the norms and the
// residual stream. One body runs every such step (whole_step.cuh) over one
// tiled weight stream (tile_stream.cuh): the rowq8 steps (fused_decode.cu,
// its Gemma-3 and gemma4 instances; fused_decode_tp.cu), the lossless ones
// (fused_decode_q.cu, fused_decode_q_tp.cu) and the capacity step
// (fused_decode_stream.cu).
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
// whole layer (~27 MB) in VMEM; an SM has 227 KB, so each block streams its
// tiles of every GEMV phase through a ring of shared-memory stages that runs
// ahead across phases, barriers, attention and layers (tile_stream.cuh).
// The residual stream x lives in each block's shared memory: every block
// recomputes the cheap [1, D] norms and residual adds itself, identically
// (fixed-order block reductions), so x never crosses the grid. Inter-block
// scratch is read with ld.global.cg (L2), never a stale L1 line. No atomics
// touch data, so the result is deterministic.
//
// gemma4 (the body's kG4 instance; reference model.cpp:568-704, 774-835,
// 927-977, the TPU kernel's static features at fused_decode.py:194-530)
// adds a prologue (the per_layer_model_proj GEMV [L * P, D] over bf16 of
// the scaled embedding row, / sqrt(D), into global scratch), the unweighted
// RMS norm of each KV head's v, shared-KV layers (l >= n_kv attend over
// layer kv_src[l]'s cache and write none), and after the down residual the
// per-layer-input epilogue (two more GEMV phases, each ending at a grid
// barrier) and out_scale: G4Params.
//
// Views. The body runs over a compile-time view of the blocks that run one
// step: Solo, the whole grid (every single-chip step), or tp.cuh's TpView,
// one rank's group of blocks in a tensor-parallel launch. The view says
// which block of how many this one is, and carries the cross-rank hooks,
// which Solo leaves empty: the embedding row (an all-reduce of the owner's
// row), the partial sums of Wo and the down projection (written, barrier,
// all-reduced), and which KV heads the step's q heads read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMinChunk = 64;  // fewest cache slots an attention block takes
constexpr int kMaxGroup = 4;   // q heads per KV head the attention registers hold
constexpr int kMarks = 13;     // profile timestamps per layer
constexpr int kMarksG4 = 17;   // the same with gemma4's gate and proj phases
constexpr int kMaxPlanes = 3;

// GEMV phases. gemma4 adds the prologue's per_layer_model_proj (kPLM) and
// each layer's per-layer-input gate (kPLG) and projection (kPLJ).
enum Kind { kQKV = 0, kWo = 1, kGU = 2, kDown = 3, kLogits = 4, kPLM = 5, kPLG = 6, kPLJ = 7 };
constexpr int kKinds = 8;

// One GEMV phase's weights as the stream reads them: up to kMaxPlanes arrays
// of rows (plane 0 the quants; the others the rows' group scales and
// offsets), each ``row_bytes`` a row (a multiple of 16), layer l at
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
  unsigned int* barrier; // [2]: the step's own 64-bit arrival count
  unsigned long long* prof;  // [L * marks + 3] phase timestamps (ns), or null
  Part parts[kKinds];    // by Kind (gemma4's three past the logits)
  int L, D, F, A, Rq, V, S, H, Hkv, dk, dv;
  int P;                 // gemma4: the per-layer input's width (0: Gemma-3)
  int xsum_floats;       // shared floats the per-group activation sums take
  float eps, attn_scale, softcap, freq_scale, emb_mult;
};

// gemma4's parameters beyond Step.
struct G4Params {
  const int* kv_src;          // [L] the cache layer each layer attends over
  const float* out_scale;     // [L] or null
  const float* pl_proj_norm;  // [P]
  const float* pl_post_norm;  // [L, D]
  const int8_t* pl_emb_q;     // [V, L * P] per-layer embedding, per-row int8
  const float* pl_emb_s;      // [V]
  float* pl_proj;             // [L * P] scratch: per_layer_model_proj(x0) / sqrt(D)
  int n_kv;
  float pl_emb_mult, pl_proj_mult, inv_sqrt2;  // sqrt(P), 1 / sqrt(D), 1 / sqrt(2)
};

// A block's shared-memory arrays (whole_step.cuh lays them out).
struct Smem {
  float* x;     // [D] residual stream
  float* tmp;   // [D]
  float* qkv;   // [Rq]
  float* red;   // [32]
  float* stat;  // [2 * H] per-head sum, then max
  float* pv;    // [kWarps, G, dv] per-warp PV partial sums
  __nv_bfloat16* hv;  // [max(D, A, F)] GEMV activation
  __nv_bfloat16* qb;  // [H * dk]
  __nv_bfloat16* kn;  // [Hkv * dk]
  __nv_bfloat16* vn;  // [Hkv * dv]
  float* xsum;        // [xsum_floats]
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

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

// 8 bf16 . 8 bf16 (one 16-byte lane slice of a head)
__device__ __forceinline__ float dot8(const uint4 x, const uint4 y) {
  float acc = 0.f;
  acc = fmaf(bf16_lo(x.x), bf16_lo(y.x), acc); acc = fmaf(bf16_hi(x.x), bf16_hi(y.x), acc);
  acc = fmaf(bf16_lo(x.y), bf16_lo(y.y), acc); acc = fmaf(bf16_hi(x.y), bf16_hi(y.y), acc);
  acc = fmaf(bf16_lo(x.z), bf16_lo(y.z), acc); acc = fmaf(bf16_hi(x.z), bf16_hi(y.z), acc);
  acc = fmaf(bf16_lo(x.w), bf16_lo(y.w), acc); acc = fmaf(bf16_hi(x.w), bf16_hi(y.w), acc);
  return acc;
}

__device__ __forceinline__ void mark(const Step& p, int idx) {
  if (p.prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.prof[idx] = t;
  }
}

// The grid barrier over ``n`` co-resident blocks (the launch is
// cooperative; the whole grid, or one rank's group in a tensor-parallel
// launch), whose barrier word is the step's alone: a 64-bit arrival count
// (8-byte aligned) that only grows, across barriers and launches. Each block adds its arrival
// without waiting for the atomic's answer (red.release) and spins until the
// count reaches its next target, so a barrier costs one trip to L2 fewer
// than one that waits for its atomic's answer. count_sync_start takes the count every earlier barrier
// left (a multiple of n: no barrier of this launch can complete before this
// block arrives) as the block's base, in shared memory.
__device__ __forceinline__ unsigned long long& count_target() {
  __shared__ unsigned long long target;
  return target;
}
__device__ void count_sync_start(unsigned int* bar, unsigned int n) {
  if (threadIdx.x == 0) {
    unsigned long long cur;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(cur) : "l"(bar) : "memory");
    count_target() = cur / n * n;
  }
  __syncthreads();
}
__device__ void count_sync(unsigned int* bar, unsigned int n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long t = count_target() + n;
    count_target() = t;
    __threadfence();
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(bar) : "memory");
    unsigned long long cur;
    do {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(cur) : "l"(bar) : "memory");
    } while (cur < t);
  }
  __syncthreads();
}

// The view of a single-chip step: the whole grid; partial sums go through
// scratch in global memory, and every q head is the model's.
struct Solo {
  __device__ int block() const { return blockIdx.x; }
  __device__ int blocks() const { return gridDim.x; }
  __device__ long long vocab(const Step& p) const { return p.V; }
  template <class Fmt>
  __device__ void embed(const Step& p, const Fmt& fmt, Smem& s, int tok) {
    fmt.embed(p, s, tok);
  }
  // before the step's first barrier
  __device__ void begin(const Step& p) const { count_sync_start(p.barrier, gridDim.x); }
  __device__ void sync(const Step& p) const { count_sync(p.barrier, gridDim.x); }
  // partial-sum phases: put each row into y, then reduce (a barrier), then
  // take the element i of the sum and, once a thread has read all it needs,
  // call taken
  __device__ void put(const Step&, float* y, int r, float v) const { __stcg(y + r, v); }
  __device__ void reduce(const Step& p) const { count_sync(p.barrier, gridDim.x); }
  __device__ float take(const Step&, const float* y, int i) const { return __ldcg(y + i); }
  __device__ void taken() {}
  __device__ void finish(const Step&) const {}
  // q heads a KV head serves, KV groups of the step's heads, the first KV head
  __device__ int group(const Step& p) const { return p.H / p.Hkv; }
  __device__ int groups(const Step& p) const { return p.Hkv; }
  __device__ int kv0(const Step&) const { return 0; }
};

// x += [norm](y) with y read from scratch (the view's sum); norm weights may
// be null.
template <class V>
__device__ void residual_add(const Step& p, Smem& s, V& vw, const float* y, const float* norm_w) {
  for (int i = threadIdx.x; i < p.D; i += kThreads) s.tmp[i] = vw.take(p, y, i);
  vw.taken();
  __syncthreads();
  float r = 1.f;
  if (norm_w) r = rms_scale(s.tmp, p.D, p.eps, s.red);
  for (int i = threadIdx.x; i < p.D; i += kThreads) {
    const float v = norm_w ? s.tmp[i] * r * norm_w[i] : s.tmp[i];
    s.x[i] = s.x[i] + v;
  }
  __syncthreads();
}
__device__ void residual_add(const Step& p, Smem& s, const float* y, const float* norm_w) {
  Solo vw;
  residual_add(p, s, vw, y, norm_w);
}

// hv = bf16(rms(x) * w)
__device__ void norm_to_hv(const Step& p, Smem& s, const float* w) {
  const float r = rms_scale(s.x, p.D, p.eps, s.red);
  for (int i = threadIdx.x; i < p.D; i += kThreads) s.hv[i] = __float2bfloat16_rn(s.x[i] * r * w[i]);
  __syncthreads();
}

// gemma4: s.tmp[0, P) = layer l's per-layer input (rms(proj_l) *
// per_layer_proj_norm + the token's per-layer embedding slice * sqrt(P)) /
// sqrt(2), in every block (fused_decode.py:459-465 of the TPU kernel).
__device__ void per_layer_input(const Step& p, const G4Params& q, Smem& s, int l, int tok) {
  const int P = p.P;
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
// ``dims`` the 12 ints L, D, F, A, Rq, V, S, H, Hkv, dk, dv, P (0 but for
// gemma4), ``scalars`` the 5 floats.
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
  p.P = dims[11];
  p.eps = scalars[0]; p.attn_scale = scalars[1]; p.softcap = scalars[2];
  p.freq_scale = scalars[3]; p.emb_mult = scalars[4];
}

}  // namespace
