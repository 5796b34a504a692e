// One batched decode step of a Gemma-3 model for B lanes, for Hopper (sm_90a),
// over dense lanes or a shared page pool.
//
// Replaces llm_inference_tpu/ops/pallas/fused_decode_batch.py::
// decode_step_megakernel_batch (_make_kernel / _run_step) and
// fused_decode_batch_paged.py::decode_step_megakernel_batch_paged (the same
// step over paged K/V): B concurrent lanes over stacked per-row int8 (rowq8)
// weights, each at its own position:
//
//   tokens -> embedding rows * row scale * sqrt(D)
//   per layer: attn_norm -> bf16 -> QKV dot * scales -> q/k RMS norms ->
//     per-lane RoPE (q also * f_attention_scale) -> bf16 K/V rows written in
//     place at (layer, lane, pos) -> per-lane attention over slots [0, pos]
//     (bf16 q.K in f32, softcap, softmax with the max over all live slots,
//     bf16 probabilities in the PV dot, f32 denominator) -> bf16 -> Wo ->
//     [post_attn_norm] -> residual -> ffn_norm -> bf16 -> gate/up ->
//     tanh GeGLU -> bf16 -> down -> [post_ffw_norm] -> residual
//   -> final norm -> bf16 -> tied-embedding logits [B, V] f32, or with
//   greedy the argmax of each lane [B] int32 (lowest id on ties), so no
//   [B, V] logits leave the device.
//
// The bf16 rounding points are the TPU kernel's; the plain twin in
// ops/kernels/fused_decode_batch.py mirrors them. Parked lanes (pos outside
// [0, S)) are clamped to row 0, as the TPU wrapper does (:585-590): their
// row-0 write is garbage that a re-admitted slot's prefill rewrites.
//
// Where slot j of lane b lives is a template parameter of the three kernels
// that touch the cache (the row write, scores, PV), so the dense step and
// the paged one are the same code:
//   dense:  layer caches [B, S, Hkv * d], row(b, j) = b * S + j;
//   paged:  layer pools [P1, PAGE, Hkv * d], table [B, NB] int32, S = NB *
//           PAGE, row(b, j) = clamp(table[b, j / PAGE], 0, P1 - 1) * PAGE +
//           j % PAGE. Row P1 - 1 is the trash page: the server's unmapped
//           entries hold it, so a parked lane (clamped to slot 0) writes
//           there and never into a page another lane owns (the TPU
//           wrapper's rules, fused_decode_batch_paged.py:563-571).
// Either way a lane reads only its live slots [0, pos]: the TPU kernel
// zero-fills whole lane buffers because it reads them whole; here a reused
// page's stale rows past pos are never read, so they never reach a softmax.
//
// What bounds it on the H100: bytes. At B = 32 and position 300 a step of
// the 1B model reads 1.0 GB of weights, scales and norms and 0.26 GB of live
// K/V (1.26 GB, 0.376 ms at 3.35 TB/s), while its ~64 GFLOP take 0.065 ms
// at the bf16 tensor-core peak. On CUDA-core FMA the same products would
// take longer than the bytes, so every projection runs on the tensor cores:
// int8 weights are converted exactly to bf16 once per tile and multiplied
// with mma.sync m16n8k16 (bf16 in, f32 sums) with the lanes in the M slot
// (the fragment layout of csrc/qmatmul.cu), so each weight byte is read once
// per step for all lanes.
//
// Design: the TPU kernel keeps a whole layer and all lanes' caches in VMEM;
// an SM has 227 KB. Here one step is a fixed sequence of kernels that this
// file launches on the caller's stream in one call (9 a layer, 237 for the
// 1B model), each a phase of the TPU kernel's body, each launched as a
// programmatic dependent of the one before (griddepcontrol), so the next
// kernel's launch overlaps the end of the one before and a GEMM's blocks
// load their first weights before they wait for its activations:
//   - GEMM: a block copies its column range of the bf16 activations of all
//     lanes into shared memory once (cp.async; the down projection's
//     [32, 6912] input is 442 KB, so its contraction splits over blocks and
//     the splits' partial sums are added in a fixed order by the kernel that
//     reads them), then each warp streams 16 weight rows 16 bytes a lane,
//     four 64-column chunks in flight while one multiplies. Gate/up rows are
//     taken in (gate, up) pairs by one warp, so the GeGLU runs in the
//     epilogue. The logits GEMM with greedy keeps each block's best
//     (value, id) per lane, and a last small kernel reduces the blocks'
//     bests; the order on (value, id) is total, so ties resolve to the
//     lowest id on every run.
//   - per lane: residual add, post norm and the next RMS norm; q/k norms,
//     RoPE and the K/V row write.
//   - attention: (128-slot chunk, KV head, lane) CTAs spread the ragged
//     lanes over all SMs; scores (a thread a slot) and each chunk's max,
//     then (with the max over the lane's chunks, as the TPU kernel's single
//     softmax) exp sums and bf16-probability PV partials, then a per-lane
//     combine. A lane's cache is read over [0, pos] only, within the TPU
//     kernel's max(pos)+16.
// No atomics: the result is deterministic and each lane's numbers do not
// depend on the other lanes'. Splitting the step into kernels instead of one
// persistent kernel with grid barriers (csrc/fused_decode.cu) keeps each
// phase's grid shaped to its work (32 lanes, 256 attention chunks, 4096
// logits row groups) at the cost of the kernels' launch and ramp time;
// PERF.md has the measured split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;                 // attention blocks
constexpr int kRowsPerWarp = 16;                      // two n8 tiles
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;  // 64
constexpr int kPairsPerBlock = kWarps * 8;            // GeGLU: (gate, up) row pairs
constexpr int kGemmSplitK = 2;                        // warps a block's rows share, each a part of C
constexpr int kGemmThreads = kThreads * kGemmSplitK;
constexpr int kChunk = 64;                            // columns a step
constexpr int kDepth = 4;                             // weight chunks a lane has in flight
constexpr int kMaxLanes = 64;                         // four m16 tiles
constexpr int kLaneThreads = 512;                     // per-lane kernels
constexpr int kLaneWarps = kLaneThreads / 32;
constexpr int kSlotChunk = 128;                       // attention slots a CTA
constexpr int kMaxGroup = 8;                          // q heads per KV head
constexpr int kMaxDim = 256;                          // dk, dv
constexpr int kMaxSmem = 232448;                      // 227 KB a block

// Slot j of lane b in dense lanes of S slots.
struct DenseRows {
  int S;
  __device__ __forceinline__ size_t operator()(int b, int j) const { return (size_t)b * S + j; }
};

// Slot j of lane b through the page table (ids clamped into the pool, whose
// last row is the trash page).
struct PagedRows {
  const int* table;  // [B, nb]
  int nb, page, p1;
  __device__ __forceinline__ size_t operator()(int b, int j) const {
    const int pid = min(max(__ldg(table + (size_t)b * nb + j / page), 0), p1 - 1);
    return (size_t)pid * page + j % page;
  }
};

enum Mode { kPartial = 0, kScaled = 1, kGLU = 2, kArgmax = 3 };

// Byte k of a word of int8 values as f32 (exact): the byte, offset by 128,
// becomes the mantissa of 2^23 and one subtraction removes 2^23 + 128.
__device__ __forceinline__ float i8(uint32_t u, int k) {
  return __int_as_float(__byte_perm(u ^ 0x80808080u, 0x4B000000u, 0x7540u + k)) - 8388736.f;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }
__device__ __forceinline__ void unpack8(const uint4 u, float (&f)[8]) {
  f[0] = bf16_lo(u.x); f[1] = bf16_hi(u.x); f[2] = bf16_lo(u.y); f[3] = bf16_hi(u.y);
  f[4] = bf16_lo(u.z); f[5] = bf16_hi(u.z); f[6] = bf16_lo(u.w); f[7] = bf16_hi(u.w);
}

// d += a . b for one 16x8x16 tile (A row-major, B column-major).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, asynchronously (zeros when !valid).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }
// Programmatic dependent launch: the next kernel of the step may start once
// every block of this one has run griddep_launch (a GEMM, after its main
// loop) or exited; it waits in griddep_wait until this one has finished and
// its writes are visible. Before its wait a kernel touches nothing but the
// weights, which no kernel writes.
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
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

// Total order of (value, id) candidates for the greedy pick: NaN above
// every number (torch.argmax's rule), then the larger value, then the
// lower id.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// sum_k p[k * stride] over the splits in a fixed order, four loads in flight.
__device__ __forceinline__ float sum_splits(const float* p, size_t stride, int splits) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int k = 0;
  for (; k + 4 <= splits; k += 4) {
    a0 += p[(size_t)k * stride];
    a1 += p[(size_t)(k + 1) * stride];
    a2 += p[(size_t)(k + 2) * stride];
    a3 += p[(size_t)(k + 3) * stride];
  }
  for (; k < splits; ++k) a0 += p[(size_t)k * stride];
  return (a0 + a1) + (a2 + a3);
}

// Fixed-order block sum over kLaneThreads threads (every thread gets it).
__device__ float lane_block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < kLaneWarps ? red[lane] : 0.f;
  return warp_sum(t);
}

// ---- the batched GEMM ------------------------------------------------------

struct Gemm {
  const __nv_bfloat16* a;  // [B, lda] bf16 activations, columns [0, C)
  int lda;
  const int8_t* q;         // [R, C] (kGLU: [2R, C], gate rows then up rows)
  const float* scale;      // [R] (kGLU: [2R])
  int B, R, C;             // R: output rows (kGLU: row pairs)
  float* y;                // kPartial: [splits, B, R] unscaled; kScaled: [B, R]
  __nv_bfloat16* act;      // kGLU: [B, R]
  float* best_v;           // kArgmax: [gridDim.x, B]
  int* best_i;
};

// MT 16-lane tiles (B <= 16 * MT). gridDim.y splits C (kPartial only);
// blocks walk the row units blockIdx.x, + gridDim.x, ...
template <int MT, int MODE>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(Gemm g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ float sv[kWarps][kMaxLanes];
  __shared__ int si[kWarps][kMaxLanes];
  __shared__ float kred[kWarps][32][4 * 8];  // the second half's sums (MT <= 4)
  // kWarps row warps, each twice: the second copy (part = 1) takes the second
  // half of the block's columns, and its sums join the first's in shared
  // memory, so twice the warps keep weights in flight
  const int warp = (threadIdx.x / 32) % kWarps, part = threadIdx.x / 32 / kWarps;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4, t = lane % 4;  // mma group and thread in group
  const int n_chunks = g.C / kChunk;
  const int ck0 = (int)((long long)blockIdx.y * n_chunks / gridDim.y);
  const int ck1 = (int)((long long)(blockIdx.y + 1) * n_chunks / gridDim.y);
  const int ncols = (ck1 - ck0) * kChunk;
  const int stride = ncols + 8;  // bf16; the padding spreads the banks
  const int kmid = ck0 + (ck1 - ck0 + 1) / 2;
  const int wk0 = part ? kmid : ck0, wk1 = part ? ck1 : kmid;  // this warp's chunks
  bool staged = false;

  // stage this split's columns of every lane (zero rows past B) once, with
  // asynchronous copies that stay in flight while the first weights load
  const int vecs = ncols / 8;
  auto stage = [&]() {
    griddep_wait();  // the activations come from the kernel before
    for (int i = threadIdx.x; i < MT * 16 * vecs; i += kGemmThreads) {
      const int tr = i / vecs, c8 = (i % vecs) * 8;
      const bool valid = tr < g.B;
      cp_async16(xs + (size_t)tr * stride + c8,
                 g.a + (size_t)(valid ? tr : 0) * g.lda + (size_t)ck0 * kChunk + c8, valid);
    }
    cp_async_wait_all();
    __syncthreads();
    staged = true;
  };

  float bv[MT][2];  // kArgmax: the best (value, row) of each lane seen so far
  int bi[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bv[m][h] = -INFINITY;
      bi[m][h] = 0x7FFFFFFF;
    }

  const int per_unit = MODE == kGLU ? kPairsPerBlock : kRowsPerBlock;
  const int units = (g.R + per_unit - 1) / per_unit;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    // the lane's two weight rows (column gq of each n8 tile); rows past the
    // end read the last row and are never written
    int r0, r1;
    if (MODE == kGLU) {
      const int pair = min(u * kPairsPerBlock + warp * 8 + gq, g.R - 1);
      r0 = pair;
      r1 = g.R + pair;
    } else {
      const int row_base = u * kRowsPerBlock + warp * kRowsPerWarp;
      r0 = min(row_base + gq, g.R - 1);
      r1 = min(row_base + 8 + gq, g.R - 1);
    }
    const int8_t* q0 = g.q + (size_t)r0 * g.C + 16 * t;
    const int8_t* q1 = g.q + (size_t)r1 * g.C + 16 * t;
    if (!staged) {
      // the unit's rows past the ring, into L2 while the ring and the
      // activations arrive (each of the four lanes of a row takes every
      // fourth 128-byte line)
      for (int c = (wk0 + kDepth) * kChunk + 128 * t; c < wk1 * kChunk; c += 512) {
        prefetch_l2(q0 - 16 * t + c);
        prefetch_l2(q1 - 16 * t + c);
      }
    }

    float acc[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

    // a ring of kDepth chunks of the lane's two rows in registers: chunk ck
    // computes while ck + 1 .. ck + kDepth - 1 are in flight
    uint4 ring[kDepth][2];
#pragma unroll
    for (int j = 0; j < kDepth; ++j) {
      ring[j][0] = ring[j][1] = make_uint4(0u, 0u, 0u, 0u);
      if (wk0 + j < wk1) {
        ring[j][0] = __ldg(reinterpret_cast<const uint4*>(q0 + (size_t)(wk0 + j) * kChunk));
        ring[j][1] = __ldg(reinterpret_cast<const uint4*>(q1 + (size_t)(wk0 + j) * kChunk));
      }
    }
    if (!staged) stage();  // the first unit's weights are already in flight
    for (int base = wk0; base < wk1; base += kDepth) {
#pragma unroll
      for (int j = 0; j < kDepth; ++j) {
        const int ck = base + j;
        if (ck >= wk1) break;
        const uint32_t cw[2][4] = {{ring[j][0].x, ring[j][0].y, ring[j][0].z, ring[j][0].w},
                                   {ring[j][1].x, ring[j][1].y, ring[j][1].z, ring[j][1].w}};
        if (ck + kDepth < wk1) {
          ring[j][0] = __ldg(reinterpret_cast<const uint4*>(q0 + (size_t)(ck + kDepth) * kChunk));
          ring[j][1] = __ldg(reinterpret_cast<const uint4*>(q1 + (size_t)(ck + kDepth) * kChunk));
        }
        // The lane holds chunk columns 16t..16t+15 of its rows; k-slice s
        // takes bytes 4s..4s+3, and the activation fragments below read the
        // same physical columns (the contraction is permuted alike on both
        // sides, which leaves every sum unchanged).
        uint32_t b[2][4][2];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            b[n][s][0] = pack_bf16(i8(cw[n][s], 0), i8(cw[n][s], 1));
            b[n][s][1] = pack_bf16(i8(cw[n][s], 2), i8(cw[n][s], 3));
          }
        const int col = (ck - ck0) * kChunk + 16 * t;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const __nv_bfloat16* top_p = xs + (size_t)(m * 16 + gq) * stride + col;
          const __nv_bfloat16* bot_p = xs + (size_t)(m * 16 + gq + 8) * stride + col;
          const uint4 lo0 = *reinterpret_cast<const uint4*>(top_p);
          const uint4 hi0 = *reinterpret_cast<const uint4*>(top_p + 8);
          const uint4 lo1 = *reinterpret_cast<const uint4*>(bot_p);
          const uint4 hi1 = *reinterpret_cast<const uint4*>(bot_p + 8);
          const uint32_t top[8] = {lo0.x, lo0.y, lo0.z, lo0.w, hi0.x, hi0.y, hi0.z, hi0.w};
          const uint32_t bot[8] = {lo1.x, lo1.y, lo1.z, lo1.w, hi1.x, hi1.y, hi1.z, hi1.w};
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const uint32_t a[4] = {top[2 * s], bot[2 * s], top[2 * s + 1], bot[2 * s + 1]};
            mma_bf16(acc[m][0], a, b[0][s][0], b[0][s][1]);
            mma_bf16(acc[m][1], a, b[1][s][0], b[1][s][1]);
          }
        }
      }
    }

    // the second half's sums join the first's, in a fixed order
    if (part == 1) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) kred[warp][lane][m * 8 + n * 4 + i] = acc[m][n][i];
    }
    __syncthreads();
    if (part == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][n][i] += kred[warp][lane][m * 8 + n * 4 + i];
    }
    __syncthreads();  // kred is free for the next unit

    // accumulator i of tile (m, n): lane m*16 + gq (+8 for i >= 2), tile
    // column 2t + (i & 1)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tok = m * 16 + gq + (i >= 2 ? 8 : 0);
        if (tok >= g.B || part == 1) continue;
        if (MODE == kGLU) {
          const int pair = u * kPairsPerBlock + warp * 8 + 2 * t + (i & 1);
          if (pair < g.R) {
            const float gv = acc[m][0][i] * g.scale[pair];
            const float uv = acc[m][1][i] * g.scale[g.R + pair];
            const float c = 0.7978845608028654f;
            const float a = 0.5f * gv * (1.f + tanhf(c * (gv + 0.044715f * gv * gv * gv))) * uv;
            g.act[(size_t)tok * g.R + pair] = __float2bfloat16_rn(a);
          }
        } else {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int r = u * kRowsPerBlock + warp * kRowsPerWarp + 8 * n + 2 * t + (i & 1);
            if (r >= g.R) continue;
            if (MODE == kPartial) {
              g.y[((size_t)blockIdx.y * g.B + tok) * g.R + r] = acc[m][n][i];
            } else if (MODE == kScaled) {
              g.y[(size_t)tok * g.R + r] = acc[m][n][i] * g.scale[r];
            } else {
              const float v = acc[m][n][i] * g.scale[r];
              const int h = i >= 2 ? 1 : 0;
              if (better(v, r, bv[m][h], bi[m][h])) {
                bv[m][h] = v;
                bi[m][h] = r;
              }
            }
          }
        }
      }
  }

  if (!staged) stage();
  griddep_launch();
  if (MODE == kArgmax) {
    // the four lanes of a group hold the same tokens: reduce them, then the
    // warps, then write the block's best per lane
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float ov = __shfl_xor_sync(0xFFFFFFFFu, bv[m][h], off);
          const int oi = __shfl_xor_sync(0xFFFFFFFFu, bi[m][h], off);
          if (better(ov, oi, bv[m][h], bi[m][h])) {
            bv[m][h] = ov;
            bi[m][h] = oi;
          }
        }
        if (t == 0 && part == 0) {
          sv[warp][m * 16 + gq + 8 * h] = bv[m][h];
          si[warp][m * 16 + gq + 8 * h] = bi[m][h];
        }
      }
    __syncthreads();
    for (int tok = threadIdx.x; tok < g.B; tok += kGemmThreads) {
      float v = sv[0][tok];
      int id = si[0][tok];
      for (int w = 1; w < kWarps; ++w)
        if (better(sv[w][tok], si[w][tok], v, id)) {
          v = sv[w][tok];
          id = si[w][tok];
        }
      g.best_v[(size_t)blockIdx.x * g.B + tok] = v;
      g.best_i[(size_t)blockIdx.x * g.B + tok] = id;
    }
  }
}

// out[b] = the best id over the GEMM blocks' candidates of lane b.
__global__ void __launch_bounds__(kLaneThreads)
argmax_reduce_kernel(const float* __restrict__ best_v, const int* __restrict__ best_i, int nblk,
                     int B, int* __restrict__ out) {
  griddep_wait();
  __shared__ float sv[kLaneWarps];
  __shared__ int si[kLaneWarps];
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float v = -INFINITY;
  int id = 0x7FFFFFFF;
  for (int j = threadIdx.x; j < nblk; j += kLaneThreads) {
    const float cv = best_v[(size_t)j * B + b];
    const int ci = best_i[(size_t)j * B + b];
    if (better(cv, ci, v, id)) {
      v = cv;
      id = ci;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xFFFFFFFFu, v, off);
    const int oi = __shfl_xor_sync(0xFFFFFFFFu, id, off);
    if (better(ov, oi, v, id)) {
      v = ov;
      id = oi;
    }
  }
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = id;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kLaneWarps; ++w)
      if (better(sv[w], si[w], v, id)) {
        v = sv[w];
        id = si[w];
      }
    out[b] = id;
  }
}

// ---- per-lane kernels ---------------------------------------------------------

struct Resid {
  const int* tokens;        // non-null: x = embedding rows (the step's start)
  const int8_t* emb_q;
  const float* emb_s;
  float emb_mult;
  int V;
  const float* part;        // non-null: y = (sum of the splits' partials) * scale
  int splits;
  const float* scale;
  const float* post_norm;   // [D] or null
  const float* norm_w;      // [D]: the next RMS norm
  float* x;                 // [B, D] residual stream
  __nv_bfloat16* h;         // [B, ldh] out
  int ldh, B, D;
  float eps;
};

// grid B: x (+)= [post_norm](y) or the embedding; h = bf16(rms(x) * norm_w).
// Dynamic shared memory: 2 * D floats.
__global__ void __launch_bounds__(kLaneThreads) residual_norm_kernel(Resid r) {
  griddep_wait();
  extern __shared__ float lsm[];
  __shared__ float red[32];
  float* xs = lsm;
  float* ys = lsm + r.D;
  const int b = blockIdx.x;
  float* xb = r.x + (size_t)b * r.D;
  if (r.tokens != nullptr) {
    const int tok = min(max(r.tokens[b], 0), r.V - 1);  // in bounds whatever the id
    const float es = r.emb_s[tok];
    for (int i = threadIdx.x; i < r.D; i += kLaneThreads)
      xs[i] = (float)r.emb_q[(size_t)tok * r.D + i] * es * r.emb_mult;
  } else {
    for (int i = threadIdx.x; i < r.D; i += kLaneThreads)
      ys[i] = sum_splits(r.part + (size_t)b * r.D + i, (size_t)r.B * r.D, r.splits) * r.scale[i];
    float rr = 1.f;
    if (r.post_norm != nullptr) {
      float ss = 0.f;
      for (int i = threadIdx.x; i < r.D; i += kLaneThreads) ss += ys[i] * ys[i];
      rr = rsqrtf(lane_block_sum(ss, red) / (float)r.D + r.eps);
    }
    for (int i = threadIdx.x; i < r.D; i += kLaneThreads) {
      const float y = r.post_norm != nullptr ? ys[i] * rr * r.post_norm[i] : ys[i];
      xs[i] = xb[i] + y;
    }
  }
  float ss = 0.f;
  for (int i = threadIdx.x; i < r.D; i += kLaneThreads) {
    xb[i] = xs[i];
    ss += xs[i] * xs[i];
  }
  const float rr = rsqrtf(lane_block_sum(ss, red) / (float)r.D + r.eps);
  for (int i = threadIdx.x; i < r.D; i += kLaneThreads)
    r.h[(size_t)b * r.ldh + i] = __float2bfloat16_rn(xs[i] * rr * r.norm_w[i]);
}

struct Prep {
  const float* part;    // [splits, B, Rq] QKV partial sums
  int splits;
  const float* scale;   // [Rq]
  const float* q_norm;  // [dk]
  const float* k_norm;  // [dk]
  const float* inv_freq;  // [n_bases, dk / 2]
  const int* base_idx;  // [L]
  int l;
  const int* pos;       // [B]
  __nv_bfloat16* qb;    // [B, H * dk] out
  __nv_bfloat16* kc;    // layer l: rows of Hkv * dk (Rows addresses them)
  __nv_bfloat16* vc;    // layer l: rows of Hkv * dv
  int B, S, H, Hkv, dk, dv, Rq;
  float eps, attn_scale, freq_scale;
};

__device__ __forceinline__ int lane_pos(const int* pos, int b, int S) {
  const int p = pos[b];
  return (p < 0 || p >= S) ? 0 : p;  // parked lanes: row 0
}

// grid B: q/k norms, RoPE, the K/V row write. Dynamic shared memory: Rq floats.
template <class Rows>
__global__ void __launch_bounds__(kLaneThreads) qkv_prep_kernel(Prep p, Rows rows) {
  griddep_wait();
  extern __shared__ float qkv[];
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pos = lane_pos(p.pos, b, p.S);
  for (int r = threadIdx.x; r < p.Rq; r += kLaneThreads)
    qkv[r] = sum_splits(p.part + (size_t)b * p.Rq + r, (size_t)p.B * p.Rq, p.splits) * p.scale[r];
  __syncthreads();
  for (int hh = warp; hh < p.H + p.Hkv; hh += kLaneWarps) {  // q heads, then k heads
    float* v = qkv + hh * p.dk;
    const float* w = hh < p.H ? p.q_norm : p.k_norm;
    float ss = 0.f;
    for (int d = lane; d < p.dk; d += 32) ss += v[d] * v[d];
    const float r = rsqrtf(warp_sum(ss) / (float)p.dk + p.eps);
    for (int d = lane; d < p.dk; d += 32) v[d] = v[d] * r * w[d];
  }
  __syncthreads();
  const int half = p.dk / 2;
  const float* fr = p.inv_freq + (size_t)p.base_idx[p.l] * half;
  const size_t krow = (size_t)p.Hkv * p.dk, vrow = (size_t)p.Hkv * p.dv;
  __nv_bfloat16* kdst = p.kc + rows(b, pos) * krow;
  __nv_bfloat16* vdst = p.vc + rows(b, pos) * vrow;
  for (int idx = threadIdx.x; idx < (p.H + p.Hkv) * half; idx += kLaneThreads) {
    const int hh = idx / half, i = idx % half;
    const float* v = qkv + hh * p.dk;
    const float ang = (float)pos * fr[i] / p.freq_scale;
    const float c = cosf(ang), sn = sinf(ang);
    const float x0 = v[i], x1 = v[i + half];
    float r0 = x0 * c - x1 * sn, r1 = x0 * sn + x1 * c;
    if (hh < p.H) {
      r0 *= p.attn_scale;
      r1 *= p.attn_scale;
      p.qb[((size_t)b * p.H + hh) * p.dk + i] = __float2bfloat16_rn(r0);
      p.qb[((size_t)b * p.H + hh) * p.dk + i + half] = __float2bfloat16_rn(r1);
    } else {
      kdst[(hh - p.H) * p.dk + i] = __float2bfloat16_rn(r0);
      kdst[(hh - p.H) * p.dk + i + half] = __float2bfloat16_rn(r1);
    }
  }
  const float* vsrc = qkv + (p.H + p.Hkv) * p.dk;
  for (int i = threadIdx.x; i < (int)vrow; i += kLaneThreads) vdst[i] = __float2bfloat16_rn(vsrc[i]);
}

struct Attn {
  const __nv_bfloat16* qb;  // [B, H * dk]
  const __nv_bfloat16* kc;  // layer l: rows of Hkv * dk (Rows addresses them)
  const __nv_bfloat16* vc;  // layer l: rows of Hkv * dv
  const int* pos;
  float* scores;            // [B, H, S]
  float* cmax;              // [B, H, nch]
  float* pl;                // [B, H, nch]
  float* pacc;              // [B, H, nch, dv]
  __nv_bfloat16* out;       // [B, ldo] attention output
  int ldo, B, S, H, Hkv, dk, dv, nch;
  float softcap;
};

// grid (nch, Hkv, B): scores of the chunk's live slots and its max per
// head. A thread takes a slot and its whole K row (16-byte loads, the q heads
// broadcast from shared memory), so no cross-lane reduction is needed.
template <int G, class Rows>
__global__ void __launch_bounds__(kThreads) attn_scores_kernel(Attn a, Rows rows) {
  griddep_wait();
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = lane_pos(a.pos, b, a.S) + 1;
  const int j0 = c * kSlotChunk;
  if (j0 >= n) return;
  const int nj = min(kSlotChunk, n - j0);
  __shared__ float sc[kMaxGroup][kSlotChunk];
  __shared__ __align__(16) float qs[kMaxGroup][kMaxDim];
  for (int idx = threadIdx.x; idx < G * a.dk; idx += kThreads) {
    const int i = idx / a.dk, d = idx % a.dk;
    qs[i][d] = __bfloat162float(a.qb[((size_t)b * a.H + g * G + i) * a.dk + d]);
  }
  __syncthreads();
  const size_t krow = (size_t)a.Hkv * a.dk;
  const __nv_bfloat16* kl = a.kc + g * a.dk;
  for (int jj = threadIdx.x; jj < nj; jj += kThreads) {
    const __nv_bfloat16* kr = kl + rows(b, j0 + jj) * krow;
    float sv[G];
#pragma unroll
    for (int i = 0; i < G; ++i) sv[i] = 0.f;
#pragma unroll 8
    for (int d0 = 0; d0 < a.dk; d0 += 8) {
      float kf[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(kr + d0)), kf);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float4 q0 = *reinterpret_cast<const float4*>(&qs[i][d0]);
        const float4 q1 = *reinterpret_cast<const float4*>(&qs[i][d0 + 4]);
        float t = sv[i];
        t = fmaf(q0.x, kf[0], t); t = fmaf(q0.y, kf[1], t); t = fmaf(q0.z, kf[2], t);
        t = fmaf(q0.w, kf[3], t); t = fmaf(q1.x, kf[4], t); t = fmaf(q1.y, kf[5], t);
        t = fmaf(q1.z, kf[6], t); t = fmaf(q1.w, kf[7], t);
        sv[i] = t;
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      float v = sv[i];
      if (a.softcap > 0.f) v = a.softcap * tanhf(v / a.softcap);
      sc[i][jj] = v;
      a.scores[((size_t)b * a.H + g * G + i) * a.S + j0 + jj] = v;
    }
  }
  __syncthreads();
  for (int i = warp; i < G; i += kWarps) {
    float m = -INFINITY;
    for (int jj = lane; jj < nj; jj += 32) m = fmaxf(m, sc[i][jj]);
    m = warp_max(m);
    if (lane == 0) a.cmax[((size_t)b * a.H + g * G + i) * a.nch + c] = m;
  }
}

constexpr int kPvSlots = 8;  // V rows a warp has in flight

// grid (nch, Hkv, B): exp sums and bf16-probability PV partials with the
// max over all of the lane's live slots.
template <int G, class Rows>
__global__ void __launch_bounds__(kThreads) attn_pv_kernel(Attn a, Rows rows) {
  griddep_wait();
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = lane_pos(a.pos, b, a.S) + 1;
  const int j0 = c * kSlotChunk;
  if (j0 >= n) return;
  const int nj = min(kSlotChunk, n - j0);
  const int nchl = (n + kSlotChunk - 1) / kSlotChunk;
  __shared__ float sc[kMaxGroup][kSlotChunk];
  __shared__ float pv[kWarps][kMaxGroup][kMaxDim];
  for (int i = warp; i < G; i += kWarps) {
    const size_t bh = (size_t)b * a.H + g * G + i;
    float m = -INFINITY;
    for (int k = lane; k < nchl; k += 32) m = fmaxf(m, a.cmax[bh * a.nch + k]);
    m = warp_max(m);
    float l = 0.f;
    for (int jj = lane; jj < nj; jj += 32) {
      const float e = expf(a.scores[bh * a.S + j0 + jj] - m);
      sc[i][jj] = bf16r(e);  // the PV dot's bf16 probability ...
      l += e;                // ... and the f32 denominator
    }
    l = warp_sum(l);
    if (lane == 0) a.pl[bh * a.nch + c] = l;
  }
  __syncthreads();
  const size_t vrow = (size_t)a.Hkv * a.dv;
  const __nv_bfloat16* vl = a.vc + g * a.dv;
  const bool lane_v = lane * 8 < a.dv;
  float o[G][8];
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) o[i][e] = 0.f;
  // a warp takes kPvSlots slots at a time (all its V loads in flight), each
  // lane 8 dims of V for every q head of the group
  for (int jj0 = warp * kPvSlots; jj0 < nj; jj0 += kWarps * kPvSlots) {
    uint4 vv[kPvSlots];
#pragma unroll
    for (int u = 0; u < kPvSlots; ++u)
      vv[u] = (jj0 + u < nj && lane_v)
          ? __ldg(reinterpret_cast<const uint4*>(vl + rows(b, j0 + jj0 + u) * vrow + lane * 8))
          : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < kPvSlots; ++u) {
      if (jj0 + u >= nj) break;
      float vf[8];
      unpack8(vv[u], vf);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float pb = sc[i][jj0 + u];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[i][e] = fmaf(pb, vf[e], o[i][e]);
      }
    }
  }
  if (lane_v) {
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) pv[warp][i][lane * 8 + e] = o[i][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * a.dv; idx += kThreads) {
    const int i = idx / a.dv, d = idx % a.dv;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += pv[w][i][d];  // fixed order
    a.pacc[(((size_t)b * a.H + g * G + i) * a.nch + c) * a.dv + d] = s;
  }
}

// grid B: out = bf16(sum of PV partials / sum of exp sums), chunk order.
__global__ void __launch_bounds__(kLaneThreads) attn_combine_kernel(Attn a) {
  griddep_wait();
  const int b = blockIdx.x;
  const int nchl = (lane_pos(a.pos, b, a.S) + 1 + kSlotChunk - 1) / kSlotChunk;
  for (int idx = threadIdx.x; idx < a.H * a.dv; idx += kLaneThreads) {
    const int h = idx / a.dv, d = idx % a.dv;
    const size_t bh = (size_t)b * a.H + h;
    float num = 0.f, den = 0.f;
    for (int k = 0; k < nchl; ++k) {
      den += a.pl[bh * a.nch + k];
      num += a.pacc[(bh * a.nch + k) * a.dv + d];
    }
    a.out[(size_t)b * a.ldo + idx] = __float2bfloat16_rn(num / den);
  }
}

// ---- launching ---------------------------------------------------------------

// Launch ``kernel`` on ``s`` as a programmatic dependent of the kernel before.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem, cudaStream_t s,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int G, class Rows>
cudaError_t launch_attention_g(const Attn& at, Rows rows, dim3 grid, cudaStream_t s) {
  cudaError_t err = launch(attn_scores_kernel<G, Rows>, grid, dim3(kThreads), 0, s, at, rows);
  if (err != cudaSuccess) return err;
  return launch(attn_pv_kernel<G, Rows>, grid, dim3(kThreads), 0, s, at, rows);
}

// scores and PV partials of one layer, for G q heads per KV head
template <class Rows>
cudaError_t launch_attention(const Attn& at, Rows rows, int G, dim3 grid, cudaStream_t s) {
  switch (G) {
    case 1: return launch_attention_g<1>(at, rows, grid, s);
    case 2: return launch_attention_g<2>(at, rows, grid, s);
    case 3: return launch_attention_g<3>(at, rows, grid, s);
    case 4: return launch_attention_g<4>(at, rows, grid, s);
    case 5: return launch_attention_g<5>(at, rows, grid, s);
    case 6: return launch_attention_g<6>(at, rows, grid, s);
    case 7: return launch_attention_g<7>(at, rows, grid, s);
    default: return launch_attention_g<8>(at, rows, grid, s);
  }
}

size_t gemm_smem(int mt, int n_chunks, int splits) {
  const int cols = ((n_chunks + splits - 1) / splits) * kChunk;
  return (size_t)mt * 16 * (cols + 8) * 2;
}

template <int MT, int MODE>
cudaError_t launch_gemm_mt(const Gemm& g, int grid_x, int splits, size_t smem, cudaStream_t s) {
  // the opt-in covers static + dynamic shared memory past the default 48 KB
  static size_t smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(gemm_kernel<MT, MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  return launch(gemm_kernel<MT, MODE>, dim3(grid_x, splits), dim3(kGemmThreads), smem, s, g);
}

// Blocks of a GEMM over R rows. With one split, blocks walk several row
// units each (the activations are staged once a block); two blocks an SM
// fit the 1B shapes' 92 KB.
template <int MODE>
int gemm_grid(int R, int sms) {
  const int per_unit = MODE == kGLU ? kPairsPerBlock : kRowsPerBlock;
  const int units = (R + per_unit - 1) / per_unit;
  return MODE == kPartial ? units : min(units, 2 * sms);
}

template <int MODE>
cudaError_t launch_gemm(const Gemm& g, int splits, int sms, cudaStream_t s) {
  const int mt = (g.B + 15) / 16;
  const int n_chunks = g.C / kChunk;
  const size_t smem = gemm_smem(mt, n_chunks, splits);
  if (smem + 2 * sizeof(float) * kWarps * kMaxLanes + sizeof(float) * kWarps * 32 * 32 >
      (size_t)kMaxSmem)
    return cudaErrorInvalidConfiguration;
  const int grid_x = gemm_grid<MODE>(g.R, sms);
  switch (mt) {
    case 1: return launch_gemm_mt<1, MODE>(g, grid_x, splits, smem, s);
    case 2: return launch_gemm_mt<2, MODE>(g, grid_x, splits, smem, s);
    case 3: return launch_gemm_mt<3, MODE>(g, grid_x, splits, smem, s);
    default: return launch_gemm_mt<4, MODE>(g, grid_x, splits, smem, s);
  }
}

#define CHECK(expr)                            \
  do {                                         \
    cudaError_t err_ = (expr);                 \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

// One batched decode step; ``rows`` addresses the cache slots and each
// layer's cache is ``layer_rows`` rows past the one before.
template <class Rows>
int run_step(void* const* ptrs, const int* dims, const float* scalars, Rows rows,
             long long layer_rows, cudaStream_t s) {
  const int* tokens = (const int*)ptrs[0];
  const int* pos = (const int*)ptrs[1];
  const int* base_idx = (const int*)ptrs[2];
  const float* inv_freq = (const float*)ptrs[3];
  const float* attn_norm = (const float*)ptrs[4];
  const float* ffn_norm = (const float*)ptrs[5];
  const float* q_norm = (const float*)ptrs[6];
  const float* k_norm = (const float*)ptrs[7];
  const float* out_norm = (const float*)ptrs[8];
  const float* post_attn = (const float*)ptrs[9];
  const float* post_ffw = (const float*)ptrs[10];
  const int8_t* wqkv_q = (const int8_t*)ptrs[11];
  const float* wqkv_s = (const float*)ptrs[12];
  const int8_t* wo_q = (const int8_t*)ptrs[13];
  const float* wo_s = (const float*)ptrs[14];
  const int8_t* gu_q = (const int8_t*)ptrs[15];
  const float* gu_s = (const float*)ptrs[16];
  const int8_t* wd_q = (const int8_t*)ptrs[17];
  const float* wd_s = (const float*)ptrs[18];
  const int8_t* emb_q = (const int8_t*)ptrs[19];
  const float* emb_s = (const float*)ptrs[20];
  __nv_bfloat16* kc = (__nv_bfloat16*)ptrs[21];
  __nv_bfloat16* vc = (__nv_bfloat16*)ptrs[22];
  void* out = ptrs[23];
  float* x = (float*)ptrs[24];
  __nv_bfloat16* h = (__nv_bfloat16*)ptrs[25];
  __nv_bfloat16* act = (__nv_bfloat16*)ptrs[26];
  float* part = (float*)ptrs[27];
  __nv_bfloat16* qb = (__nv_bfloat16*)ptrs[28];
  float* scores = (float*)ptrs[29];
  float* cmax = (float*)ptrs[30];
  float* pl = (float*)ptrs[31];
  float* pacc = (float*)ptrs[32];
  float* best_v = (float*)ptrs[33];
  int* best_i = (int*)ptrs[34];
  const int L = dims[0], B = dims[1], D = dims[2], F = dims[3], A = dims[4], Rq = dims[5];
  const int V = dims[6], S = dims[7], H = dims[8], Hkv = dims[9], dk = dims[10], dv = dims[11];
  const int ldh = dims[12];
  const long long part_cap = dims[13];
  const int sq = dims[14], so = dims[15], sd = dims[16], sms = dims[17], greedy = dims[18];
  const int best_cap = dims[19];
  const float eps = scalars[0], attn_scale = scalars[1], softcap = scalars[2];
  const float freq_scale = scalars[3], emb_mult = scalars[4];

  if (B < 1 || B > kMaxLanes || L < 1 || Hkv < 1 || H % Hkv != 0 || H / Hkv > kMaxGroup ||
      D % kChunk || A % kChunk || F % kChunk || dk % 16 || dv % 8 || dk > kMaxDim ||
      dv > kMaxDim || A != H * dv || Rq != H * dk + Hkv * (dk + dv) || ldh < D || ldh < A ||
      ldh % 8 || sq < 1 || so < 1 || sd < 1 || sq > D / kChunk || so > A / kChunk ||
      sd > F / kChunk || (long long)sq * B * Rq > part_cap || (long long)so * B * D > part_cap ||
      (long long)sd * B * D > part_cap || sms < 1 ||
      (greedy && (long long)gemm_grid<kArgmax>(V, sms) * B > best_cap))
    return (int)cudaErrorInvalidValue;
  const int nch = (S + kSlotChunk - 1) / kSlotChunk;
  const size_t lane_smem = 2 * sizeof(float) * D;
  const size_t prep_smem = sizeof(float) * Rq;
  if (lane_smem > 48 * 1024 || prep_smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const size_t krow = (size_t)Hkv * dk, vrow = (size_t)Hkv * dv;

  Resid r{};
  r.emb_q = emb_q; r.emb_s = emb_s; r.emb_mult = emb_mult; r.V = V;
  r.x = x; r.h = h; r.ldh = ldh; r.B = B; r.D = D; r.eps = eps;
  // the step's start: embedding rows, attn_norm of layer 0
  r.tokens = tokens;
  r.norm_w = attn_norm;
  CHECK(launch(residual_norm_kernel, dim3(B), dim3(kLaneThreads), lane_smem, s, r));
  r.tokens = nullptr;

  Gemm g{};
  g.B = B;
  Attn at{};
  at.qb = qb; at.pos = pos; at.scores = scores; at.cmax = cmax; at.pl = pl; at.pacc = pacc;
  at.out = h; at.ldo = ldh; at.B = B; at.S = S; at.H = H; at.Hkv = Hkv; at.dk = dk; at.dv = dv;
  at.nch = nch; at.softcap = softcap;
  Prep pr{};
  pr.q_norm = nullptr; pr.inv_freq = inv_freq; pr.base_idx = base_idx; pr.pos = pos; pr.qb = qb;
  pr.B = B; pr.S = S; pr.H = H; pr.Hkv = Hkv; pr.dk = dk; pr.dv = dv; pr.Rq = Rq;
  pr.eps = eps; pr.attn_scale = attn_scale; pr.freq_scale = freq_scale;

  for (int l = 0; l < L; ++l) {
    __nv_bfloat16* kl = kc + (size_t)l * layer_rows * krow;
    __nv_bfloat16* vl = vc + (size_t)l * layer_rows * vrow;
    // QKV
    g.a = h; g.lda = ldh; g.q = wqkv_q + (size_t)l * Rq * D; g.scale = wqkv_s + (size_t)l * Rq;
    g.R = Rq; g.C = D; g.y = part;
    CHECK(launch_gemm<kPartial>(g, sq, sms, s));
    // q/k norms, RoPE, K/V rows
    pr.part = part; pr.splits = sq; pr.scale = wqkv_s + (size_t)l * Rq;
    pr.q_norm = q_norm + (size_t)l * dk; pr.k_norm = k_norm + (size_t)l * dk; pr.l = l;
    pr.kc = kl; pr.vc = vl;
    CHECK(launch(qkv_prep_kernel<Rows>, dim3(B), dim3(kLaneThreads), prep_smem, s, pr, rows));
    // attention
    at.kc = kl; at.vc = vl;
    CHECK(launch_attention(at, rows, H / Hkv, dim3(nch, Hkv, B), s));
    CHECK(launch(attn_combine_kernel, dim3(B), dim3(kLaneThreads), 0, s, at));
    // Wo, residual, ffn_norm
    g.a = h; g.q = wo_q + (size_t)l * D * A; g.scale = wo_s + (size_t)l * D; g.R = D; g.C = A;
    CHECK(launch_gemm<kPartial>(g, so, sms, s));
    r.part = part; r.splits = so; r.scale = wo_s + (size_t)l * D;
    r.post_norm = post_attn ? post_attn + (size_t)l * D : nullptr;
    r.norm_w = ffn_norm + (size_t)l * D;
    CHECK(launch(residual_norm_kernel, dim3(B), dim3(kLaneThreads), lane_smem, s, r));
    // gate/up + GeGLU
    g.a = h; g.q = gu_q + (size_t)l * 2 * F * D; g.scale = gu_s + (size_t)l * 2 * F; g.R = F;
    g.C = D; g.act = act;
    CHECK(launch_gemm<kGLU>(g, 1, sms, s));
    // down, residual, the next norm
    g.a = act; g.lda = F; g.q = wd_q + (size_t)l * D * F; g.scale = wd_s + (size_t)l * D;
    g.R = D; g.C = F;
    CHECK(launch_gemm<kPartial>(g, sd, sms, s));
    g.lda = ldh;
    r.part = part; r.splits = sd; r.scale = wd_s + (size_t)l * D;
    r.post_norm = post_ffw ? post_ffw + (size_t)l * D : nullptr;
    r.norm_w = l + 1 < L ? attn_norm + (size_t)(l + 1) * D : out_norm;
    CHECK(launch(residual_norm_kernel, dim3(B), dim3(kLaneThreads), lane_smem, s, r));
  }

  // tied-embedding logits, or each lane's argmax
  g.a = h; g.lda = ldh; g.q = emb_q; g.scale = emb_s; g.R = V; g.C = D;
  if (greedy) {
    g.best_v = best_v; g.best_i = best_i;
    CHECK(launch_gemm<kArgmax>(g, 1, sms, s));
    CHECK(launch(argmax_reduce_kernel, dim3(B), dim3(kLaneThreads), 0, s, (const float*)best_v,
                 (const int*)best_i, gemm_grid<kArgmax>(V, sms), B, (int*)out));
  } else {
    g.y = (float*)out;
    CHECK(launch_gemm<kScaled>(g, 1, sms, s));
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Blocks of the logits GEMM (the greedy candidates' scratch is that many
// times B).
int fused_decode_batch_logits_grid(int V, int sms) { return gemm_grid<kArgmax>(V, sms); }

int fused_decode_batch_slot_chunk() { return kSlotChunk; }

// One batched decode step over dense lanes. ``ptrs`` holds the 35 device
// pointers in the order of the wrapper (ops/kernels/fused_decode_batch.py),
// ``dims`` the 20 ints, ``scalars`` the 5 floats; the caches are [L, B, S,
// Hkv, d]. Launches the step's kernels on ``stream``; returns the first
// cudaError_t.
int fused_decode_batch_step(void* const* ptrs, const int* dims, const float* scalars,
                            void* stream) {
  const int B = dims[1], S = dims[7];
  return run_step(ptrs, dims, scalars, DenseRows{S}, (long long)B * S,
                  static_cast<cudaStream_t>(stream));
}

// The same step over paged K/V: ptrs[21] and ptrs[22] are the stacked pools
// [L, p1, page, Hkv, d] (row p1 - 1 the trash page), ``table`` the [B, nb]
// int32 page table, and dims[7] (the slots a lane) is nb * page.
int fused_decode_batch_paged_step(void* const* ptrs, const int* dims, const float* scalars,
                                  const void* table, int nb, int page, int p1, void* stream) {
  if (table == nullptr || nb < 1 || page < 1 || p1 < 1 || (long long)nb * page != dims[7])
    return (int)cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(table), nb, page, p1};
  return run_step(ptrs, dims, scalars, rows, (long long)p1 * page,
                  static_cast<cudaStream_t>(stream));
}

const char* fused_decode_batch_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
