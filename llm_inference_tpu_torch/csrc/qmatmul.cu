// Rowwise int8 weight x activation matmul for Hopper (sm_90a).
//
// Replaces llm_inference_tpu/ops/pallas/qmatmul.py::quant_matmul, rowwise
// branch (_make_kernel(rowwise=True) called from _run): with one scale per
// weight row (requantize_rowwise),
//
//     y[T, R] = (bf16(x)[T, C] . q[R, C]^T, f32 accumulation) * scale[R],  T <= 64.
//
// The int8 values are exact in bf16 and every bf16 x bf16 product is exact
// in f32, so the kernel and its plain twin differ only in summation order.
//
// What bounds it on the H100: the weight read. At the prefill shapes
// (T = 32, R x C up to 13824 x 1152) the R*C int8 bytes take a few
// microseconds at 3.35 TB/s and the 2*T*R*C operations less on the tensor
// cores, so the kernel has to keep every SM streaming weights.
//
// Design: the TPU kernel keeps all of x[T, C] in VMEM; at T = 64, C = 6912
// that is 884 KB of bf16, beyond a block's 227 KB of shared memory. Here a
// block of 4 warps owns 64 weight rows (16 a warp, two n8 tiles) over one
// range of C, and walks it in chunks of 64 columns: x[:, chunk] is staged
// in shared memory as bf16 (9 KB at T = 64), each lane loads 16 bytes of
// each of its two weight rows (the next chunk's while it computes this
// one), converts them exactly to bf16, and the warp runs mma.sync
// m16n8k16 (bf16 in, f32 sums) for every 16-token tile. The contraction
// index inside a chunk is permuted the same way for x and the weights (a
// lane takes 16 contiguous weight bytes), which leaves each sum unchanged
// and needs no shuffles. C splits over gridDim.y blocks, chosen by the
// wrapper so every shape puts several blocks on each SM; the splits' f32
// partial sums add up in a second small kernel in a fixed order, so the
// result is deterministic (no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;                      // two n8 tiles
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;  // 64
constexpr int kChunk = 64;                            // columns a step
constexpr int kRowStride = kChunk + 8;                // bf16; padding spreads the banks

// Byte k of a word of int8 values as f32 (exact): the byte, offset by 128,
// becomes the mantissa of 2^23 and one subtraction removes 2^23 + 128.
__device__ __forceinline__ float i8(uint32_t u, int k) {
  return __int_as_float(__byte_perm(u ^ 0x80808080u, 0x4B000000u, 0x7540u + k)) - 8388736.f;
}

// Two floats as a bf16 pair, ``lo`` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// MT 16-token tiles (T <= 16 * MT). ``part`` is null with one split: the
// block then writes y (times the row scale); otherwise it writes its
// split's unscaled sums to part[blockIdx.y, T, R].
template <int MT>
__global__ void __launch_bounds__(kThreads)
qmatmul_mma_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, float* __restrict__ y,
                   float* __restrict__ part, int T, int R, int C) {
  __shared__ __align__(16) __nv_bfloat16 xs[MT * 16][kRowStride];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma group and thread in group
  const int row_base = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const int n_chunks = C / kChunk;
  const int ck0 = (int)((long long)blockIdx.y * n_chunks / gridDim.y);
  const int ck1 = (int)((long long)(blockIdx.y + 1) * n_chunks / gridDim.y);

  // The lane's weight rows (column g of each n8 tile); rows past R read
  // row R - 1 and are never written.
  const int8_t* q0 = q + (size_t)min(row_base + g, R - 1) * C + 16 * t;
  const int8_t* q1 = q + (size_t)min(row_base + 8 + g, R - 1) * C + 16 * t;

  float acc[MT][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  uint4 w0 = make_uint4(0u, 0u, 0u, 0u), w1 = w0;
  if (ck0 < ck1) {
    w0 = __ldg(reinterpret_cast<const uint4*>(q0 + (size_t)ck0 * kChunk));
    w1 = __ldg(reinterpret_cast<const uint4*>(q1 + (size_t)ck0 * kChunk));
  }
  for (int ck = ck0; ck < ck1; ++ck) {
    const uint32_t cw[2][4] = {{w0.x, w0.y, w0.z, w0.w}, {w1.x, w1.y, w1.z, w1.w}};
    if (ck + 1 < ck1) {  // the next chunk's weights load while this one computes
      w0 = __ldg(reinterpret_cast<const uint4*>(q0 + (size_t)(ck + 1) * kChunk));
      w1 = __ldg(reinterpret_cast<const uint4*>(q1 + (size_t)(ck + 1) * kChunk));
    }
    __syncthreads();  // the previous chunk's x is consumed
    for (int i = threadIdx.x; i < MT * 16 * (kChunk / 4); i += kThreads) {
      const int tr = i / (kChunk / 4), c4 = (i % (kChunk / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (tr < T) v = *reinterpret_cast<const float4*>(x + (size_t)tr * C + (size_t)ck * kChunk + c4);
      // the TPU kernel's bf16 cast of x
      *reinterpret_cast<uint2*>(&xs[tr][c4]) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
    __syncthreads();

    // The lane holds chunk columns 16t..16t+15 of its rows. k-slice s
    // (16 logical columns) takes bytes 4s..4s+3: logical columns 2t, 2t+1
    // are bytes 4s, 4s+1 and 2t+8, 2t+9 are bytes 4s+2, 4s+3. The x
    // fragments below read the same physical columns.
    uint32_t b[2][4][2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        b[n][s][0] = pack_bf16(i8(cw[n][s], 0), i8(cw[n][s], 1));
        b[n][s][1] = pack_bf16(i8(cw[n][s], 2), i8(cw[n][s], 3));
      }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const uint4 lo0 = *reinterpret_cast<const uint4*>(&xs[m * 16 + g][16 * t]);
      const uint4 hi0 = *reinterpret_cast<const uint4*>(&xs[m * 16 + g][16 * t + 8]);
      const uint4 lo1 = *reinterpret_cast<const uint4*>(&xs[m * 16 + g + 8][16 * t]);
      const uint4 hi1 = *reinterpret_cast<const uint4*>(&xs[m * 16 + g + 8][16 * t + 8]);
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

  // accumulator i of tile (m, n): token m*16 + g (+8 for i >= 2), row
  // row_base + 8n + 2t + (i & 1)
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tok = m * 16 + g + (i >= 2 ? 8 : 0);
        const int r = row_base + 8 * n + 2 * t + (i & 1);
        if (tok < T && r < R) {
          if (part != nullptr)
            part[((size_t)blockIdx.y * T + tok) * R + r] = acc[m][n][i];
          else
            y[(size_t)tok * R + r] = acc[m][n][i] * scale[r];
        }
      }
}

// y[i] = (sum over splits of part[k, i], in split order) * scale[row].
__global__ void reduce_splits_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                                     float* __restrict__ y, int n, int R, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
  y[i] = s * scale[i % R];
}

template <int MT>
cudaError_t launch(const float* x, const int8_t* q, const float* scale, float* y, float* part,
                   int T, int R, int C, int splits, cudaStream_t stream) {
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock, splits);
  qmatmul_mma_kernel<MT><<<grid, kThreads, 0, stream>>>(x, q, scale, y, splits > 1 ? part : nullptr,
                                                        T, R, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int n = T * R;
  reduce_splits_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, scale, y, n, R, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x f32 [T, C], q int8 [R, C], scale f32 [R], y f32 [T, R]; all contiguous
// on the current device, 16-byte aligned. C splits over ``splits`` blocks
// (1 <= splits <= C / 64); with more than one, ``part`` holds splits * T * R
// floats of scratch. Returns the launches' cudaError_t.
int qmatmul_rowwise(const void* x, const void* q, const void* scale, void* y, void* part,
                    int T, int R, int C, int splits, void* stream) {
  if (T < 1 || T > 64 || R < 1 || C < kChunk || C % kChunk != 0 || splits < 1 ||
      splits > C / kChunk || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(scale);
  float* yf = static_cast<float*>(y);
  float* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 16) return (int)launch<1>(xf, qi, sf, yf, pf, T, R, C, splits, s);
  if (T <= 32) return (int)launch<2>(xf, qi, sf, yf, pf, T, R, C, splits, s);
  if (T <= 48) return (int)launch<3>(xf, qi, sf, yf, pf, T, R, C, splits, s);
  return (int)launch<4>(xf, qi, sf, yf, pf, T, R, C, splits, s);
}

const char* qmatmul_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
