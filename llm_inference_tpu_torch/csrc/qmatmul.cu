// Quantized weight x activation matmul for Hopper (sm_90a): int8 per-row,
// int8 per-group and nibble-packed per-group weights.
//
// Replaces llm_inference_tpu/ops/pallas/qmatmul.py:
//   - quant_matmul, rowwise branch (_make_kernel(rowwise=True) from _run):
//     with one scale per weight row (requantize_rowwise),
//       y[T, R] = (bf16(x)[T, C] . q[R, C]^T, f32 accumulation) * scale[R];
//     the int8 values are exact in bf16 and every bf16 x bf16 product is
//     exact in f32, so the kernel and its plain twin differ only in
//     summation order;
//   - quant_matmul, grouped branch (_make_kernel(rowwise=False), :65-94),
//     and q4_matmul (_make_kernel_q4, :143-167): with group scales and
//     Q4_K's min offsets along C (groups of 16 or 32 columns),
//       w = bf16(bf16(q) * bf16(scale[r, g])) - bf16(offset[r, g]), rounded
//       to bf16, y = bf16(x) . w^T with f32 accumulation,
//     the TPU kernels' rounding points (qmatmul.py:74, :85-87, :152-160):
//     the dequantized weight is formed in bf16, then a bf16 x bf16 dot. q is
//     int8 in logical column order or nibbles in consecutive pairs (byte j:
//     column 2j low, 2j + 1 high; Q4_0's are stored as q + 8).
// T <= 64 in every format.
//
// What bounds it on the H100: the weight read. At the prefill shapes
// (T = 32, R x C up to 13824 x 1152) the R*C int8 bytes (half that for
// nibbles, plus 4 or 8 bytes of scales a group) take a few microseconds at
// 3.35 TB/s and the 2*T*R*C operations less on the tensor cores, so the
// kernel has to keep every SM streaming weights. The grouped formats add
// a dequantization of each weight (two bf16 roundings) on the CUDA cores,
// once per weight, shared by all T tokens.
//
// Design: the TPU kernel keeps all of x[T, C] in VMEM; at T = 64, C = 6912
// that is 884 KB of bf16, beyond a block's 227 KB of shared memory. Here a
// block of 4 warps owns 64 weight rows (16 a warp, two n8 tiles) over one
// range of C, and walks it in chunks of 64 columns: x[:, chunk] is staged
// in shared memory as bf16 (9 KB at T = 64), each lane loads its 16 columns
// of each of its two weight rows (16 int8 bytes or 8 nibble bytes, and the
// rows' one group scale and offset: 16 columns never straddle a group) for
// the next chunk while it computes this one, dequantizes them to bf16 in
// registers, and the warp runs mma.sync m16n8k16 (bf16 in, f32 sums) for
// every 16-token tile. The contraction index inside a chunk is permuted the
// same way for x and the weights (a lane takes 16 contiguous columns),
// which leaves each sum unchanged and needs no shuffles. C splits over
// gridDim.y blocks, chosen by the wrapper so every shape puts several
// blocks on each SM; the splits' f32 partial sums add up in a second small
// kernel in a fixed order, so the result is deterministic (no atomics).

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

// weight formats
constexpr int kRow = 0;     // int8, one scale a row, applied to the output
constexpr int kGroup = 1;   // int8, group scales (and offsets) along C
constexpr int kNibble = 2;  // nibble pairs, group scales (and offsets) along C

struct Weights {
  const int8_t* q;       // [R, C] int8, or [R, C / 2] nibble pairs
  const float* scale;    // [R, G] (kRow: [R])
  const float* offset;   // [R, G] or null
  int gs;                // columns a group (kGroup, kNibble)
  float bias;            // 8 for centered nibbles (Q4_0), else 0
};

// Byte k of a word of int8 values as f32 (exact): the byte, offset by 128,
// becomes the mantissa of 2^23 and one subtraction removes 2^23 + 128.
__device__ __forceinline__ float i8(uint32_t u, int k) {
  return __int_as_float(__byte_perm(u ^ 0x80808080u, 0x4B000000u, 0x7540u + k)) - 8388736.f;
}

// Nibble ``hi`` of byte k of a word, as f32 (exact), minus ``bias``.
__device__ __forceinline__ float nib(uint32_t u, int k, int hi, float bias) {
  return __int_as_float(0x4B000000u | ((u >> (8 * k + 4 * hi)) & 0xFu)) - (8388608.f + bias);
}

__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

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

// A lane's 16 columns (from ``col``) of weight row ``r``: the quant bytes
// and, for the grouped formats, the row's group scale and offset there,
// rounded to bf16 as the TPU kernel rounds them.
template <int FMT>
__device__ __forceinline__ void load_tile(const Weights& W, int r, int C, int col, uint4& w,
                                          float& s, float& o) {
  if (FMT == kNibble) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(W.q + (size_t)r * (C / 2) + col / 2));
    w = make_uint4(v.x, v.y, 0u, 0u);
  } else {
    w = __ldg(reinterpret_cast<const uint4*>(W.q + (size_t)r * C + col));
  }
  if (FMT != kRow) {
    const size_t gi = (size_t)r * (C / W.gs) + col / W.gs;
    s = bf16r(__ldg(W.scale + gi));
    o = W.offset != nullptr ? bf16r(__ldg(W.offset + gi)) : 0.f;
  }
}

// The lane's B fragments for the four k-slices of a chunk. k-slice s_ (16
// logical columns) takes chunk columns 16t + 4s_ .. 16t + 4s_ + 3 of the
// lane's row: logical columns 2t, 2t+1 are the first two, 2t+8, 2t+9 the
// last two. The x fragments read the same physical columns.
template <int FMT>
__device__ __forceinline__ void to_frags(uint32_t (&b)[4][2], const uint4 w, float s, float o,
                                         float bias) {
  const uint32_t cw[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v[4];
    if (FMT == kNibble) {  // columns 4k.. are bytes 2(k&1), 2(k&1)+1 of word k>>1, low first
      const uint32_t u = cw[k >> 1];
      const int by = 2 * (k & 1);
      v[0] = nib(u, by, 0, bias); v[1] = nib(u, by, 1, bias);
      v[2] = nib(u, by + 1, 0, bias); v[3] = nib(u, by + 1, 1, bias);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = i8(cw[k], e);
    }
    if (FMT != kRow) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = bf16r(bf16r(v[e] * s) - o);
    }
    b[k][0] = pack_bf16(v[0], v[1]);
    b[k][1] = pack_bf16(v[2], v[3]);
  }
}

// MT 16-token tiles (T <= 16 * MT). ``part`` is null with one split: the
// block then writes y (kRow: times the row scale); otherwise it writes its
// split's sums (kRow: unscaled) to part[blockIdx.y, T, R].
template <int MT, int FMT>
__global__ void __launch_bounds__(kThreads)
qmatmul_mma_kernel(const float* __restrict__ x, const Weights W, float* __restrict__ y,
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
  const int r0 = min(row_base + g, R - 1), r1 = min(row_base + 8 + g, R - 1);

  float acc[MT][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  uint4 w0 = make_uint4(0u, 0u, 0u, 0u), w1 = w0;
  float s0 = 0.f, s1 = 0.f, o0 = 0.f, o1 = 0.f;
  if (ck0 < ck1) {
    load_tile<FMT>(W, r0, C, ck0 * kChunk + 16 * t, w0, s0, o0);
    load_tile<FMT>(W, r1, C, ck0 * kChunk + 16 * t, w1, s1, o1);
  }
  for (int ck = ck0; ck < ck1; ++ck) {
    uint32_t b[2][4][2];
    to_frags<FMT>(b[0], w0, s0, o0, W.bias);
    to_frags<FMT>(b[1], w1, s1, o1, W.bias);
    if (ck + 1 < ck1) {  // the next chunk's weights load while this one computes
      load_tile<FMT>(W, r0, C, (ck + 1) * kChunk + 16 * t, w0, s0, o0);
      load_tile<FMT>(W, r1, C, (ck + 1) * kChunk + 16 * t, w1, s1, o1);
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
            y[(size_t)tok * R + r] = FMT == kRow ? acc[m][n][i] * W.scale[r] : acc[m][n][i];
        }
      }
}

// y[i] = (sum over splits of part[k, i], in split order) * scale[row]
// (scale null: 1).
__global__ void reduce_splits_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                                     float* __restrict__ y, int n, int R, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
  y[i] = scale != nullptr ? s * scale[i % R] : s;
}

template <int MT, int FMT>
cudaError_t launch(const float* x, const Weights& W, float* y, float* part, int T, int R, int C,
                   int splits, cudaStream_t stream) {
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock, splits);
  qmatmul_mma_kernel<MT, FMT><<<grid, kThreads, 0, stream>>>(x, W, y, splits > 1 ? part : nullptr,
                                                             T, R, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int n = T * R;
  reduce_splits_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, FMT == kRow ? W.scale : nullptr,
                                                            y, n, R, splits);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t dispatch(const void* x, const Weights& W, void* y, void* part, int T, int R, int C,
                     int splits, void* stream) {
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  float* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 16) return launch<1, FMT>(xf, W, yf, pf, T, R, C, splits, s);
  if (T <= 32) return launch<2, FMT>(xf, W, yf, pf, T, R, C, splits, s);
  if (T <= 48) return launch<3, FMT>(xf, W, yf, pf, T, R, C, splits, s);
  return launch<4, FMT>(xf, W, yf, pf, T, R, C, splits, s);
}

bool bad_args(int T, int R, int C, int splits, const void* part) {
  return T < 1 || T > 64 || R < 1 || C < kChunk || C % kChunk != 0 || splits < 1 ||
         splits > C / kChunk || (splits > 1 && part == nullptr);
}

}  // namespace

extern "C" {

// x f32 [T, C], q int8 [R, C], scale f32 [R], y f32 [T, R]; all contiguous
// on the current device, 16-byte aligned. C splits over ``splits`` blocks
// (1 <= splits <= C / 64); with more than one, ``part`` holds splits * T * R
// floats of scratch. Returns the launches' cudaError_t.
int qmatmul_rowwise(const void* x, const void* q, const void* scale, void* y, void* part,
                    int T, int R, int C, int splits, void* stream) {
  if (bad_args(T, R, C, splits, part)) return (int)cudaErrorInvalidValue;
  const Weights W{static_cast<const int8_t*>(q), static_cast<const float*>(scale), nullptr, C, 0.f};
  return (int)dispatch<kRow>(x, W, y, part, T, R, C, splits, stream);
}

// The grouped formats: q int8 [R, C] (nibble = 0) or nibble pairs [R, C / 2]
// (nibble = 1; centered = 1 for Q4_0's q + 8), scale and offset (or null)
// f32 [R, C / gs] with gs 16 or 32; the rest as qmatmul_rowwise (q 16-byte
// aligned for int8, 8-byte for nibbles).
int qmatmul_grouped(const void* x, const void* q, const void* scale, const void* offset, void* y,
                    void* part, int T, int R, int C, int gs, int nibble, int centered, int splits,
                    void* stream) {
  if (bad_args(T, R, C, splits, part) || (gs != 16 && gs != 32)) return (int)cudaErrorInvalidValue;
  const Weights W{static_cast<const int8_t*>(q), static_cast<const float*>(scale),
                  static_cast<const float*>(offset), gs, centered ? 8.f : 0.f};
  if (nibble) return (int)dispatch<kNibble>(x, W, y, part, T, R, C, splits, stream);
  return (int)dispatch<kGroup>(x, W, y, part, T, R, C, splits, stream);
}

const char* qmatmul_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
