// Ragged one-query decode attention for Hopper (sm_90a), over dense lanes
// or through a page table.
//
// Replaces llm_inference_tpu/ops/pallas/flash_decode.py::flash_decode
// (_kernel) and ::paged_flash_decode (_kernel, _kernel_dsplit): for each
// lane b and q head h, one query against the lane's slots
// [starts[b], lengths[b]):
//
//   s_j = softcap(q[b, h] . k[row(b, j), h / G])      (f32; softcap optional)
//   out[b, h] = sum_j softmax(s)_j v[row(b, j), h / G] (f32), 0 for an empty range
//
// q [B, H, Dk] f32 (already scaled), out [B, H, Dv] f32. GQA: G = H / Hkv q
// heads share a KV head. Where slot j of lane b lives is the one thing the
// two entries differ in, a template parameter of the same kernels:
//   dense:  caches [B, S, Hkv, D] bf16, row(b, j) = b * S + j;
//   paged:  pools [N, PAGE, Hkv, D] bf16, table [B, NB] int32,
//           row(b, j) = clamp(table[b, j / PAGE], 0, N - 1) * PAGE + j % PAGE,
//           over the first nb <= NB table blocks (the TPU kernel's nb_cap
//           grid bound: slots past nb * PAGE are not attended).
// PAGE is any positive run-time value; a 256-slot CTA block may span
// several pages, so rows are computed per slot, never per block. The TPU
// kernel's split-d pools ([N, PAGE, D / 128, 128] for one KV head) hold the
// same bytes as [N, PAGE, 1, D]; the port keeps that one layout. Page ids
// are clamped into the pool as the TPU kernel's index map clamps them
// (a parked lane's sentinel entries are never read: its range is empty).
//
// What bounds it on the H100: the bytes of the live K/V rows. At the 1B
// serving shapes (B = 32, one KV head of 256) a lane at position 1000 reads
// 1 MB a layer; the whole batch a few MB, a few microseconds at 3.35 TB/s,
// if enough of it is in flight. The TPU kernel walks a lane's 256-slot
// blocks in order on one core, carrying the online softmax in VMEM. Here
// each (block of 256 slots, KV head, lane) is its own CTA, so a batch of
// ragged lanes spreads over all SMs: the CTA computes the block's scores,
// its own max, exp sums and P.V in f32 (the TPU kernel's online-softmax
// terms for one block), and a second small kernel combines the blocks of a
// (lane, head) in block order with the usual rescaling. Blocks outside
// [starts, lengths) are never read; an empty range gives zeros, never NaN.
// No atomics: the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlock = 256;    // slots a CTA (the TPU kernel's DEFAULT_BLOCK)
constexpr int kMaxGroup = 8;   // q heads per KV head
constexpr int kMaxDim = 256;   // Dk, Dv: a lane holds 8 of them

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

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

__device__ __forceinline__ void unpack8(const uint4 u, float (&f)[8]) {
  f[0] = bf16_lo(u.x); f[1] = bf16_hi(u.x); f[2] = bf16_lo(u.y); f[3] = bf16_hi(u.y);
  f[4] = bf16_lo(u.z); f[5] = bf16_hi(u.z); f[6] = bf16_lo(u.w); f[7] = bf16_hi(u.w);
}

// Slot j of lane b in dense lanes of S slots.
struct DenseRows {
  int S;
  __device__ __forceinline__ size_t operator()(int b, int j) const { return (size_t)b * S + j; }
};

// Slot j of lane b through the page table (ids clamped into the pool).
struct PagedRows {
  const int* table;  // [B, nb_table]
  int nb_table, page, n_pages;
  __device__ __forceinline__ size_t operator()(int b, int j) const {
    const int pid = min(max(__ldg(table + (size_t)b * nb_table + j / page), 0), n_pages - 1);
    return (size_t)pid * page + j % page;
  }
};

// grid (n_blocks, Hkv, B); a lane has S slots. Partials per (b, h, block):
// max m, exp sum l and P.V acc[Dv]; an empty block writes m = -inf, l = 0
// and no acc.
template <class Rows>
__global__ void __launch_bounds__(kThreads)
flash_block_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
                   const __nv_bfloat16* __restrict__ vc, const int* __restrict__ lengths,
                   const int* __restrict__ starts, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc, int S, int H,
                   int Hkv, int Dk, int Dv, float softcap, Rows rows) {
  __shared__ float sc[kMaxGroup][kBlock];
  __shared__ float pv[kWarps][kMaxGroup][kMaxDim];
  const int j = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int nb = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = H / Hkv;
  const int len = min(lengths[b], S);
  const int st = max(starts[b], 0);
  const int lo = max(j * kBlock, st), hi = min((j + 1) * kBlock, len);
  const size_t pbase = ((size_t)b * H + g * G) * nb + j;  // + i * nb for head g*G+i
  if (lo >= hi) {
    if (threadIdx.x < G) {
      part_m[pbase + threadIdx.x * nb] = -INFINITY;
      part_l[pbase + threadIdx.x * nb] = 0.f;
    }
    return;
  }
  const int n = hi - lo;
  const size_t krow = (size_t)Hkv * Dk, vrow = (size_t)Hkv * Dv;
  const __nv_bfloat16* kl = kc + g * Dk;  // + rows(b, slot) * krow
  const __nv_bfloat16* vl = vc + g * Dv;
  const bool lane_k = lane * 8 < Dk, lane_v = lane * 8 < Dv;

  // the lane's 8 dims of each q head of the group
  float qf[kMaxGroup][8];
#pragma unroll
  for (int i = 0; i < kMaxGroup; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qf[i][e] = (i < G && lane_k) ? q[((size_t)b * H + g * G + i) * Dk + lane * 8 + e] : 0.f;

  // scores: a warp takes four slots at a time, its K loads all in flight
  for (int jj0 = warp * 4; jj0 < n; jj0 += kWarps * 4) {
    float kf[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint4 kv = (jj0 + u < n && lane_k)
          ? *reinterpret_cast<const uint4*>(kl + rows(b, lo + jj0 + u) * krow + lane * 8)
          : make_uint4(0u, 0u, 0u, 0u);
      unpack8(kv, kf[u]);
    }
#pragma unroll
    for (int i = 0; i < kMaxGroup; ++i) {
      if (i >= G) break;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(qf[i][e], kf[u][e], s);
        s = warp_sum(s);
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        if (lane == 0 && jj0 + u < n) sc[i][jj0 + u] = s;
      }
    }
  }
  __syncthreads();
  // the block's max and exp sum per head, p = exp(s - m) in place
  for (int i = warp; i < G; i += kWarps) {
    float m = -INFINITY;
    for (int jj = lane; jj < n; jj += 32) m = fmaxf(m, sc[i][jj]);
    m = warp_max(m);
    float l = 0.f;
    for (int jj = lane; jj < n; jj += 32) {
      const float p = expf(sc[i][jj] - m);
      sc[i][jj] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      part_m[pbase + i * nb] = m;
      part_l[pbase + i * nb] = l;
    }
  }
  __syncthreads();
  // P.V: a warp takes two slots at a time, each lane 8 dims of V
  float o[kMaxGroup][8];
#pragma unroll
  for (int i = 0; i < kMaxGroup; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) o[i][e] = 0.f;
  for (int jj0 = warp * 2; jj0 < n; jj0 += kWarps * 2) {
    float vf[2][8];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint4 vv = (jj0 + u < n && lane_v)
          ? *reinterpret_cast<const uint4*>(vl + rows(b, lo + jj0 + u) * vrow + lane * 8)
          : make_uint4(0u, 0u, 0u, 0u);
      unpack8(vv, vf[u]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (jj0 + u >= n) break;
#pragma unroll
      for (int i = 0; i < kMaxGroup; ++i) {
        if (i >= G) break;
        const float p = sc[i][jj0 + u];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[i][e] = fmaf(p, vf[u][e], o[i][e]);
      }
    }
  }
  if (lane_v) {
#pragma unroll
    for (int i = 0; i < kMaxGroup; ++i) {
      if (i >= G) break;
#pragma unroll
      for (int e = 0; e < 8; ++e) pv[warp][i][lane * 8 + e] = o[i][e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * Dv; idx += kThreads) {
    const int i = idx / Dv, d = idx % Dv;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += pv[w][i][d];  // fixed order
    part_acc[(pbase + i * nb) * Dv + d] = s;
  }
}

// grid (B * H): out = sum_j e^(m_j - M) acc_j / sum_j e^(m_j - M) l_j, in
// block order; zeros where no block held a slot.
__global__ void __launch_bounds__(kThreads)
flash_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                     const float* __restrict__ part_acc, float* __restrict__ out, int nb, int Dv) {
  const size_t bh = blockIdx.x;
  const float* pm = part_m + bh * nb;
  const float* plp = part_l + bh * nb;
  float M = -INFINITY;
  for (int j = 0; j < nb; ++j) M = fmaxf(M, pm[j]);
  float L = 0.f;
  for (int j = 0; j < nb; ++j)
    if (pm[j] != -INFINITY) L += expf(pm[j] - M) * plp[j];
  for (int d = threadIdx.x; d < Dv; d += kThreads) {
    float acc = 0.f;
    for (int j = 0; j < nb; ++j)
      if (pm[j] != -INFINITY) acc += expf(pm[j] - M) * part_acc[(bh * nb + j) * Dv + d];
    out[bh * Dv + d] = L > 0.f ? acc / L : 0.f;
  }
}

bool dims_ok(int B, int S, int H, int Hkv, int Dk, int Dv) {
  return B >= 1 && S >= 1 && Hkv >= 1 && H % Hkv == 0 && H / Hkv <= kMaxGroup && Dk >= 8 &&
         Dv >= 8 && Dk <= kMaxDim && Dv <= kMaxDim && Dk % 8 == 0 && Dv % 8 == 0;
}

// The block kernel over lanes of S slots, then the combine in block order.
template <class Rows>
int launch(const void* q, const void* kc, const void* vc, const void* lengths, const void* starts,
           void* out, void* part_m, void* part_l, void* part_acc, int B, int S, int H, int Hkv,
           int Dk, int Dv, float softcap, Rows rows, cudaStream_t s) {
  const int nb = (S + kBlock - 1) / kBlock;
  flash_block_kernel<Rows><<<dim3(nb, Hkv, B), kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), static_cast<const int*>(lengths),
      static_cast<const int*>(starts), static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), S, H, Hkv, Dk, Dv, softcap, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_combine_kernel<<<B * H, kThreads, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<float*>(out), nb, Dv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q f32 [B, H, Dk], kc bf16 [B, S, Hkv, Dk], vc bf16 [B, S, Hkv, Dv],
// lengths / starts int32 [B], out f32 [B, H, Dv]; scratch part_m, part_l
// [B * H * nb] and part_acc [B * H * nb * Dv] f32 with nb = ceil(S / 256).
// Returns the launches' cudaError_t.
int flash_decode_fwd(const void* q, const void* kc, const void* vc, const void* lengths,
                     const void* starts, void* out, void* part_m, void* part_l, void* part_acc,
                     int B, int S, int H, int Hkv, int Dk, int Dv, float softcap, void* stream) {
  if (!dims_ok(B, S, H, Hkv, Dk, Dv)) return (int)cudaErrorInvalidValue;
  return launch(q, kc, vc, lengths, starts, out, part_m, part_l, part_acc, B, S, H, Hkv, Dk, Dv,
                softcap, DenseRows{S}, static_cast<cudaStream_t>(stream));
}

// The same through a page table: kp bf16 [n_pages, page, Hkv, Dk], vp bf16
// [n_pages, page, Hkv, Dv], table int32 [B, nb_table]; the first nb <=
// nb_table blocks are walked. Scratch as flash_decode_fwd with S = nb * page.
int paged_flash_decode_fwd(const void* q, const void* kp, const void* vp, const void* table,
                           const void* lengths, const void* starts, void* out, void* part_m,
                           void* part_l, void* part_acc, int B, int nb_table, int nb, int page,
                           int n_pages, int H, int Hkv, int Dk, int Dv, float softcap,
                           void* stream) {
  if (page < 1 || nb < 1 || nb > nb_table || n_pages < 1 || (long long)nb * page > (1 << 30) ||
      !dims_ok(B, nb * page, H, Hkv, Dk, Dv))
    return (int)cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(table), nb_table, page, n_pages};
  return launch(q, kp, vp, lengths, starts, out, part_m, part_l, part_acc, B, nb * page, H, Hkv,
                Dk, Dv, softcap, rows, static_cast<cudaStream_t>(stream));
}

int flash_decode_block() { return kBlock; }

const char* flash_decode_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
