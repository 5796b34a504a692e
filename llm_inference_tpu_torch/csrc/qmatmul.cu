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
//     column 2j low, 2j + 1 high; Q4_0's are stored as q + 8). Centered
//     nibbles without offsets may come with the checkpoint's raw f16 scales
//     (the capacity load's): they stream at 2 bytes a group and are widened
//     to f32 (exact) before bf16(scale), so the weights and sums are the f32
//     scales' bit for bit.
// T <= 64 in every format.
//
// What bounds them on the H100: the weight read. At the prefill shapes
// (T = 32, R x C up to 13824 x 1152 at 1B, 30720 x 3840 at 12B) the R*C
// int8 bytes (half that for nibbles, plus 4 or 8 bytes of scales a group)
// take microseconds at 3.35 TB/s and the 2*T*R*C operations far less on the
// tensor cores, so a kernel has to keep every SM streaming weights. The
// grouped formats add a dequantization of each weight (two bf16 roundings)
// on the CUDA cores, once per weight, shared by all T tokens.
//
// One kernel (qmatmul_grouped) takes the three formats as template
// instances; the rowwise one has no scales in its ring, turns its quants
// into exact bf16 A fragments with byte permutes alone, and multiplies the
// f32 sums by the row's scale in the epilogue (after the splits' sum), as
// the TPU kernel scales its [T, TILE_R] output (qmatmul.py:76-83).
//
// Design, one launch a call: a block owns a tile of 128 weight rows over
// one split of C, with two consumer warpgroups (64 rows each) and one
// producer warp, and takes an SM's shared memory.
//   - Weights through a TMA ring: the producer's one thread keeps a ring of
//     four shared-memory stages full with 2-D tensor-map copies (the maps
//     encoded on the host through cudaGetDriverEntryPoint, so the build
//     needs no -lcuda), each completed on an mbarrier: a stage is 128 rows
//     x 128 quant bytes (128 int8 or 256 nibble columns, 128-byte swizzled,
//     16 KB) and the same rows' group scales (and offsets), if any.
//     Consumers copy a stage to registers and release it at once: 64 KB of
//     weights stay in flight an SM.
//   - x once a block: the consumers convert their split's x[T, cols] to
//     bf16 in shared memory once, zero-padded to N tokens, in the K-major
//     core-matrix layout that wgmma reads as B (8 tokens x 16 bytes a core
//     matrix; slices padded so a warp's stores hit distinct banks), then
//     pass one named barrier; nothing else synchronises the consumers.
//   - wgmma with the weights as A from registers: each lane dequantizes its
//     two rows' quants (byte permutes to exact integers, then bf16x2 fma
//     for the scale product and the offset, each rounded where the TPU
//     kernel rounds) straight into A fragments, four k16 slices a chunk,
//     and a chunk's products run while the next chunk dequantizes; M = 64
//     weight rows a warpgroup, so T = 1 wastes no M; N = T rounded up to 8,
//     16, 32 or 64 (one instance each); f32 sums in registers. A lane takes
//     32 contiguous quant bytes of each row a stage, and the contraction
//     index of each k16 slice is permuted the same way in x's layout, which
//     leaves every sum's terms unchanged.
//   - Splits reduced in the kernel: with C split over several blocks, each
//     writes its f32 partial tile to per-call scratch and counts itself on
//     its row tile's arrival counter; the last to arrive adds the splits in
//     split order (deterministic: a second launch is bit-equal) and writes
//     y, then sets the counter back to 0. The counters belong to the
//     caller's stream (ops/kernels/qmatmul.py), so calls on two streams
//     share none, and a captured CUDA graph replays with them at 0.
//   - The wrapper's plan (ops/kernels/qmatmul.py ``plan``) picks the split
//     (as many blocks as the SMs hold one each, and x small enough to sit
//     beside the ring), the N instance and the shared memory.
// What still holds it back (PERF.md, tools/qmatmul_profile.py): at T = 32 a
// tile's f32 x is as many L2 bytes as its int8 quants, read before the
// first product; with C split, the arrival count and the last block's
// reduction add about 1-2 us; the small 1B shapes are one stage a block.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

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

// ---- grouped: TMA ring, wgmma, one launch ---------------------------------

constexpr int kTileRows = 128;              // weight rows a block (two warpgroups of 64)
constexpr int kConsumers = 256;             // the two consumer warpgroups
constexpr int kGroupedThreads = kConsumers + 32;  // and one producer warp
constexpr int kStageQBytes = kTileRows * 128;     // a stage's quants: 128 rows x 128 bytes
constexpr int kMaxSmem = 232448;            // a block's most shared memory on the H100

// The weight formats of the one kernel: group-scaled int8, group-scaled
// nibble pairs, and int8 with one scale a row (applied to the sums).
enum Fmt { kGroupedI8 = 0, kNibble = 1, kRowwise = 2 };

// The call's plan (the wrapper's, checked by qmatmul_grouped) and the
// shared-memory layout it gives, in bytes from the 1024-aligned base: the
// ring's quants, then its scales, its offsets, x, and the barriers.
struct Plan {
  int T, R, C, gs, splits, ring;  // gs 0: rowwise
  int n_sc;          // stages along a row: ceil(C / stage columns)
  int gps;           // groups a stage
  int has_off;
  int s16;           // f16 group scales (nibbles without offsets), else f32
  uint32_t neg_bias2;  // bf16x2 of -(128 + bias): a nibble's magic (128 + u) to q
  int scale_bytes;   // one stage's scales (as many bytes again for f32 offsets; 0 rowwise)
  int s_off, o_off, x_off, bar_off;
};

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// a * b + c on bf16 pairs, rounded to nearest even once.
__device__ __forceinline__ uint32_t fma2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// bf16x2 (v, v) of an f32, rounded to nearest even.
__device__ __forceinline__ uint32_t bf16x2_of(float v) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %1;" : "=r"(d) : "f"(v));
  return d;
}

constexpr uint32_t kOne2 = 0x3F803F80u;      // bf16x2 (1, 1)
constexpr uint32_t kNegZero2 = 0x80008000u;  // bf16x2 (-0, -0): a * b + -0 == a * b

// The TPU kernels' weight from an exact bf16 pair of quants q: bf16(q * s),
// then bf16(that - o) with offsets (``no2`` holds -o).
__device__ __forceinline__ uint32_t dequant2(uint32_t q2, uint32_t s2, uint32_t no2, bool off) {
  const uint32_t p = fma2(q2, s2, kNegZero2);
  return off ? fma2(p, kOne2, no2) : p;
}

// Bytes (2j, 2j + 1) of a word of int8 quants as an exact bf16 pair: each
// byte becomes an exact f32 (i8), whose top half is its bf16.
__device__ __forceinline__ uint32_t i8_pair(uint32_t w, int j) {
  return __byte_perm(__float_as_uint(i8(w, 2 * j)), __float_as_uint(i8(w, 2 * j + 1)), 0x7632);
}

// Nibbles (s, s + 16) of a word (bit offsets; s in {0, 4, 8, 12}) as the
// exact bf16 pair (128 + u): the nibble in the mantissa of 128.0.
__device__ __forceinline__ uint32_t nib_pair(uint32_t w, int s) {
  return ((w >> s) & 0x000F000Fu) | 0x43004300u;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(PENDING) : "memory");
}
// Pins a register's value to this point (wgmma reads and writes registers
// asynchronously: the compiler must neither read an accumulator nor reuse
// an A fragment's register before the wait).
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// The wgmma descriptor of a K-major B operand without swizzle: 8x8 core
// matrices of 128 contiguous bytes, the two k halves 128 bytes apart (LBO)
// and successive 8-token groups 256 bytes apart (SBO).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// x in shared memory: one N-token B operand a k16 slice, ``slice_bytes``
// apart (32N, plus 16 so that the slices a warp stores at once fall on
// distinct banks); this is the byte offset of (token n, slice sl, k half
// h), where 8 consecutive k values take 16 bytes.
template <int N>
__host__ __device__ constexpr int slice_bytes() { return N * 32 + 16; }
template <int N>
__device__ __forceinline__ int x_at(int n, int sl, int h) {
  return sl * slice_bytes<N>() + (((n >> 3) * 2 + h) << 7) + ((n & 7) << 4);
}

// Stage the block's split of x (columns [c0, c1), zero past c1 and past T
// tokens) as bf16 in the B layout, once. The contraction index k of a slice
// is permuted as the lanes hold the quants (k = 8h + 2t + e, lane t of a
// quad): for int8, slice j of a stage takes columns 32t + 4j + 2h + e; for
// nibbles, slices 2i and 2i + 1 take 64t + 8i + c8, c8 = 0..7, where c8 =
// (e, h) = (0,0) (1,0) (0,1) (1,1) -> 0 4 1 5 for slice 2i and 2 6 3 7 for
// 2i + 1. One unit of work is one token's slice (int8: four 16-byte loads)
// or slice pair (nibbles: eight): consecutive threads read consecutive
// columns and store to consecutive slices, and each thread keeps 16 loads
// in flight (kB units at once).
template <int N, bool NIB>
__device__ __forceinline__ void stage_x(const float* __restrict__ x, uint8_t* xs, int T, int C,
                                        int c0, int c1, int nk, int tid) {
  constexpr int kSC = NIB ? 256 : 128, kSlices = kSC / 16, kLoads = NIB ? 8 : 4, kB = 16 / kLoads;
  constexpr int kLogN = N == 8 ? 3 : N == 16 ? 4 : N == 32 ? 5 : 6;
  // unit i: j = i & 7 (fastest), token n = (i >> 3) & (N - 1), stage kk = i >> (3 + log N)
  const int total = nk * 8 * N;
  for (int i0 = tid; i0 < total; i0 += kB * kConsumers) {
    float4 v[kB][kLoads];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int i = i0 + b * kConsumers, n = (i >> 3) & (N - 1);
      const int col = c0 + (i >> (3 + kLogN)) * kSC + (NIB ? 8 : 4) * (i & 7);
      const bool live = i < total && n < T;
#pragma unroll
      for (int l = 0; l < kLoads; ++l) {
        const int at = NIB ? 64 * (l >> 1) + 4 * (l & 1) : 32 * l;  // lane t = l (>> 1)
        v[b][l] = live && col + at < c1
                      ? __ldg(reinterpret_cast<const float4*>(x + (size_t)n * C + col + at))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int i = i0 + b * kConsumers, n = (i >> 3) & (N - 1);
      if (i >= total) continue;
      const int sl = (i >> (3 + kLogN)) * kSlices + (NIB ? 2 : 1) * (i & 7);
      if (!NIB) {
        const float4* a = v[b];
        *reinterpret_cast<uint4*>(xs + x_at<N>(n, sl, 0)) =
            make_uint4(pack_bf16(a[0].x, a[0].y), pack_bf16(a[1].x, a[1].y),
                       pack_bf16(a[2].x, a[2].y), pack_bf16(a[3].x, a[3].y));
        *reinterpret_cast<uint4*>(xs + x_at<N>(n, sl, 1)) =
            make_uint4(pack_bf16(a[0].z, a[0].w), pack_bf16(a[1].z, a[1].w),
                       pack_bf16(a[2].z, a[2].w), pack_bf16(a[3].z, a[3].w));
      } else {
        // lane t's columns 0-3 in v[2t], 4-7 in v[2t + 1]: (c0, c4) (c1, c5)
        // feed slice 2j's k halves, (c2, c6) (c3, c7) slice 2j + 1's
        const float4* a = v[b];
        *reinterpret_cast<uint4*>(xs + x_at<N>(n, sl, 0)) =
            make_uint4(pack_bf16(a[0].x, a[1].x), pack_bf16(a[2].x, a[3].x),
                       pack_bf16(a[4].x, a[5].x), pack_bf16(a[6].x, a[7].x));
        *reinterpret_cast<uint4*>(xs + x_at<N>(n, sl, 1)) =
            make_uint4(pack_bf16(a[0].y, a[1].y), pack_bf16(a[2].y, a[3].y),
                       pack_bf16(a[4].y, a[5].y), pack_bf16(a[6].y, a[7].y));
        *reinterpret_cast<uint4*>(xs + x_at<N>(n, sl + 1, 0)) =
            make_uint4(pack_bf16(a[0].z, a[1].z), pack_bf16(a[2].z, a[3].z),
                       pack_bf16(a[4].z, a[5].z), pack_bf16(a[6].z, a[7].z));
        *reinterpret_cast<uint4*>(xs + x_at<N>(n, sl + 1, 1)) =
            make_uint4(pack_bf16(a[0].w, a[1].w), pack_bf16(a[2].w, a[3].w),
                       pack_bf16(a[4].w, a[5].w), pack_bf16(a[6].w, a[7].w));
      }
    }
  }
}

// The A fragments of four k16 slices from the lane's quant words of its
// two rows (a: row g, b: row g + 8 of the warp's 16): int8, words 0-3, a
// slice each; nibbles, words 0-1, two slices each. Fragment registers:
// (row g, k 2t..), (row g + 8, k 2t..), (row g, k 2t + 8..), (row g + 8,
// k 2t + 8..). s/n: each row's bf16x2 scale and negated offset. Rowwise:
// the quants themselves, exact in bf16 (the row scale multiplies the sums).
template <int FMT>
__device__ __forceinline__ void dequant_chunk(uint32_t (&fr)[4][4], const uint32_t (&aw)[4],
                                              const uint32_t (&bw)[4], uint32_t sa, uint32_t sb,
                                              uint32_t na, uint32_t nb, bool off, uint32_t nbias2) {
  if (FMT == kRowwise) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fr[i][0] = i8_pair(aw[i], 0);
      fr[i][1] = i8_pair(bw[i], 0);
      fr[i][2] = i8_pair(aw[i], 1);
      fr[i][3] = i8_pair(bw[i], 1);
    }
  } else if (FMT == kGroupedI8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fr[i][0] = dequant2(i8_pair(aw[i], 0), sa, na, off);
      fr[i][1] = dequant2(i8_pair(bw[i], 0), sb, nb, off);
      fr[i][2] = dequant2(i8_pair(aw[i], 1), sa, na, off);
      fr[i][3] = dequant2(i8_pair(bw[i], 1), sb, nb, off);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int sub = 0; sub < 2; ++sub)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int sh = 8 * sub + 4 * h;
          fr[2 * i + sub][2 * h] = dequant2(fma2(nib_pair(aw[i], sh), kOne2, nbias2), sa, na, off);
          fr[2 * i + sub][2 * h + 1] =
              dequant2(fma2(nib_pair(bw[i], sh), kOne2, nbias2), sb, nb, off);
        }
  }
}

// ``row_scale`` (rowwise, else null): f32 [R], multiplying y's columns.
template <int N, int FMT>
__global__ void __launch_bounds__(kGroupedThreads, 1)
qmatmul_grouped_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap ts,
                       const __grid_constant__ CUtensorMap to, const float* __restrict__ x,
                       const float* __restrict__ row_scale, float* __restrict__ y,
                       float* __restrict__ part, unsigned int* __restrict__ counters,
                       unsigned long long* __restrict__ prof, const Plan p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr bool NIB = FMT == kNibble, ROW = FMT == kRowwise;
  constexpr int kSC = NIB ? 256 : 128, kSlices = kSC / 16;
  if (smem_u32(smem) & 1023) __trap();  // the swizzled stages need a 1024-byte base
  const int rt = blockIdx.x, split = blockIdx.y;
  const int k0 = (int)((long long)split * p.n_sc / p.splits);
  const int nk = (int)((long long)(split + 1) * p.n_sc / p.splits) - k0;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + p.ring;
  int* last = reinterpret_cast<int*>(empty + p.ring);
  // the optional profile: 8 stamps a block (globaltimer ns, then the SM and
  // the block's stages), at entry, x staged, first stage in, loop done, end,
  // and the producer's last copy issued
  unsigned long long* mark = prof ? prof + 8 * ((size_t)split * gridDim.x + rt) : nullptr;
  if (threadIdx.x == 0) {
    if (mark) {
      unsigned int sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      mark[0] = now_ns();
      mark[5] = sm;
      mark[7] = (unsigned long long)nk;
    }
    for (int i = 0; i < p.ring; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: one thread fills the ring
    if (threadIdx.x == kConsumers) {
      const uint32_t bytes = kStageQBytes + p.scale_bytes * (p.has_off ? 2 : 1);
      for (int k = 0; k < nk; ++k) {
        const int slot = k % p.ring;
        if (k >= p.ring) mbar_wait(empty + slot, (uint32_t)((k / p.ring - 1) & 1));
        mbar_expect_tx(full + slot, bytes);
        tma_load_2d(smem + slot * kStageQBytes, &tq, (k0 + k) * 128, rt * kTileRows, full + slot);
        if (!ROW)
          tma_load_2d(smem + p.s_off + slot * p.scale_bytes, &ts, (k0 + k) * p.gps,
                      rt * kTileRows, full + slot);
        if (p.has_off)
          tma_load_2d(smem + p.o_off + slot * p.scale_bytes, &to, (k0 + k) * p.gps,
                      rt * kTileRows, full + slot);  // offsets come with f32 scales only
      }
      if (mark) mark[6] = now_ns();
    }
    return;
  }

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32, g = lane / 4, t = lane % 4;
  stage_x<N, NIB>(x, smem + p.x_off, p.T, p.C, k0 * kSC, min((k0 + nk) * kSC, p.C), nk, tid);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // x is wgmma's operand
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  if (mark && tid == 0) mark[1] = now_ns();

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const int row = wg * 64 + warp * 16 + g;  // the lane's rows: row, row + 8 (row & 7 == g)
  const int lg = p.gs == 32 ? 5 : 4;
  const bool off = p.has_off != 0;
  const uint64_t desc0 = b_desc(smem_u32(smem + p.x_off));
  constexpr int kChunks = NIB ? 4 : 2;  // four k16 slices a chunk
  uint32_t fr[2][4][4];                 // two chunks' A fragments: one in flight, one filling
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int sl = 0; sl < 4; ++sl)
#pragma unroll
      for (int r = 0; r < 4; ++r) fr[b][sl][r] = 0u;
  for (int k = 0; k < nk; ++k) {
    const int slot = k % p.ring;
    mbar_wait(full + slot, (uint32_t)((k / p.ring) & 1));
    if (mark && tid == 0 && k == 0) mark[2] = now_ns();
    // the lane's 32 bytes of each row: 16-byte chunks 2t, 2t + 1, 128-byte swizzled
    const uint8_t* qs = smem + slot * kStageQBytes;
    uint4 qa[2], qb[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      qa[c] = *reinterpret_cast<const uint4*>(qs + row * 128 + (((2 * t + c) ^ g) << 4));
      qb[c] = *reinterpret_cast<const uint4*>(qs + (row + 8) * 128 + (((2 * t + c) ^ g) << 4));
    }
    // each chunk's group (one a row): stage column 32t + 16ch (int8), 64t + 16ch (nibbles)
    uint32_t sa[kChunks] = {}, sb[kChunks] = {}, na[kChunks] = {}, nb[kChunks] = {};
    if (!ROW) {
      const uint8_t* sp = smem + p.s_off + slot * p.scale_bytes;
      const float* ss = reinterpret_cast<const float*>(sp);
      const __half* hs = reinterpret_cast<const __half*>(sp);
      const float* os = reinterpret_cast<const float*>(smem + p.o_off + slot * p.scale_bytes);
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const int gi = ((NIB ? 64 : 32) * t + 16 * ch) >> lg;
        const int ia = row * p.gps + gi, ib = (row + 8) * p.gps + gi;
        // f16 scales widen exactly, so bf16(scale) is the f32 scales' bf16
        sa[ch] = bf16x2_of(NIB && p.s16 ? __half2float(hs[ia]) : ss[ia]);
        sb[ch] = bf16x2_of(NIB && p.s16 ? __half2float(hs[ib]) : ss[ib]);
        na[ch] = off ? bf16x2_of(-os[row * p.gps + gi]) : 0u;
        nb[ch] = off ? bf16x2_of(-os[(row + 8) * p.gps + gi]) : 0u;
      }
    }
    mbar_arrive(empty + slot);  // the stage is in registers
    // four slices a chunk; a chunk's products run while the next one dequantizes
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const uint4 a = qa[NIB ? ch >> 1 : ch], b = qb[NIB ? ch >> 1 : ch];
      const bool upper = NIB && (ch & 1);
      const uint32_t aw[4] = {upper ? a.z : a.x, upper ? a.w : a.y, a.z, a.w};
      const uint32_t bw[4] = {upper ? b.z : b.x, upper ? b.w : b.y, b.z, b.w};
      uint32_t (&f)[4][4] = fr[ch & 1];
      dequant_chunk<FMT>(f, aw, bw, sa[ch], sb[ch], na[ch], nb[ch], off, p.neg_bias2);
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < 4; ++sl)
        Wgmma<N>::mma(acc, f[sl],
                      desc0 + (uint64_t)(((k * kSlices + 4 * ch + sl) * slice_bytes<N>()) >> 4));
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done: its fragments are free
#pragma unroll
      for (int sl = 0; sl < 4; ++sl)
#pragma unroll
        for (int r = 0; r < 4; ++r) pin(fr[(ch & 1) ^ 1][sl][r]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) pin(acc[i]);

  if (mark && tid == 0) mark[3] = now_ns();
  // accumulator i: token 8(i >> 2) + 2t + (i & 1), tile row row + 8((i >> 1) & 1)
  const int r0 = rt * kTileRows + row;
  if (p.splits > 1) {
    const size_t stride = (size_t)gridDim.x * (N / 2) * kConsumers;
    float* mine = part + (size_t)split * stride + ((size_t)rt * (N / 2)) * kConsumers + tid;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) __stcg(mine + i * kConsumers, acc[i]);
    // the block's partials, then its arrival: one thread's acquire-release
    // count orders the block's stores (which the barrier gave it) before the
    // count, and the other splits' stores before the last block's reads
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    if (tid == 0) {
      unsigned int old;
      asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                   : "=r"(old)
                   : "l"(counters + rt)
                   : "memory");
      *last = old == (unsigned)(p.splits - 1);
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    if (mark && tid == 0) mark[4] = now_ns();
    if (!*last) return;
    // the splits' sums in split order, whichever block came last; kBatch
    // splits' loads in flight at once (64 values a thread)
    constexpr int kBatch = 128 / N;
    float sum[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sum[i] = 0.f;
    const float* base = part + ((size_t)rt * (N / 2)) * kConsumers + tid;
    for (int sp0 = 0; sp0 < p.splits; sp0 += kBatch) {
      float v[kBatch][N / 2];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int sp = sp0 + b;
#pragma unroll
        for (int i = 0; i < N / 2; ++i)
          v[b][i] = sp == split ? acc[i]
                    : sp < p.splits ? __ldcg(base + sp * stride + i * kConsumers) : 0.f;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (sp0 + b < p.splits)
#pragma unroll
          for (int i = 0; i < N / 2; ++i) sum[i] += v[b][i];
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = sum[i];
    if (tid == 0) counters[rt] = 0u;  // every split has arrived: ready for the next call
  }
  float rsc[2] = {1.f, 1.f};  // the lane's two rows' scales (rowwise)
  if (ROW) {
    rsc[0] = r0 < p.R ? __ldg(row_scale + r0) : 0.f;
    rsc[1] = r0 + 8 < p.R ? __ldg(row_scale + r0 + 8) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int tok = 8 * (i >> 2) + 2 * t + (i & 1), r = r0 + 8 * ((i >> 1) & 1);
    if (tok < p.T && r < p.R) y[(size_t)tok * p.R + r] = ROW ? acc[i] * rsc[(i >> 1) & 1] : acc[i];
  }
  if (mark && tid == 0) mark[4] = now_ns();
}

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

// A row-major [rows, cols] map of ``box_cols`` x 128-row boxes, rows
// ``row_bytes`` apart; rows past the end read as zeros.
bool encode_2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int row_bytes,
               int rows, int cols, int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)kTileRows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N, int FMT>
cudaError_t launch_grouped(const CUtensorMap& tq, const CUtensorMap& ts, const CUtensorMap& to,
                           const float* x, const float* row_scale, float* y, float* part,
                           unsigned int* counters, unsigned long long* prof, const Plan& p,
                           int smem, cudaStream_t stream) {
  static unsigned done = 0;  // devices whose shared-memory limit is raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < 32 && !((done >> dev) & 1u)) {
    err = cudaFuncSetAttribute(qmatmul_grouped_kernel<N, FMT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess) done |= 1u << dev;
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((p.R + kTileRows - 1) / kTileRows, p.splits);
  qmatmul_grouped_kernel<N, FMT><<<grid, kGroupedThreads, smem, stream>>>(
      tq, ts, to, x, row_scale, y, part, counters, prof, p);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t dispatch_grouped(int n_inst, const CUtensorMap& tq, const CUtensorMap& ts,
                             const CUtensorMap& to, const float* x, const float* rsc, float* y,
                             float* part, unsigned int* c, unsigned long long* prof, const Plan& p,
                             int smem, cudaStream_t s) {
  switch (n_inst) {
    case 8: return launch_grouped<8, FMT>(tq, ts, to, x, rsc, y, part, c, prof, p, smem, s);
    case 16: return launch_grouped<16, FMT>(tq, ts, to, x, rsc, y, part, c, prof, p, smem, s);
    case 32: return launch_grouped<32, FMT>(tq, ts, to, x, rsc, y, part, c, prof, p, smem, s);
    default: return launch_grouped<64, FMT>(tq, ts, to, x, rsc, y, part, c, prof, p, smem, s);
  }
}

}  // namespace

extern "C" {

// Every format, one launch: q int8 [R, C] (nibble = 0) or nibble pairs
// [R, C / 2] (nibble = 1; centered = 1 for Q4_0's q + 8), scale and offset
// (or null) f32 [R, C / gs] with gs 16 or 32 (``scale_bytes`` 4), or for
// centered nibbles without offsets f16 scales (``scale_bytes`` 2) in rows
// padded to a multiple of 8, or (gs = 0, rowwise: int8, no offset) scale
// f32 [R], one a row; x f32 [T, C], y f32 [T, R]; all
// contiguous on the current device, 16-byte aligned (the rowwise scale
// need not be). The plan
// (ops/kernels/qmatmul.py ``plan``): 128-row tiles, C split over
// ``splits`` blocks on whole stages of ``stage_cols`` columns (128 int8,
// 256 nibble), a ring of ``stages`` stages, x of at most ``x_stages`` stages
// a block, ``smem`` bytes of dynamic shared memory and the N = ``n_inst``
// instance (8, 16, 32 or 64, at least T). With more than one split,
// ``part`` holds splits * ceil(R / 128) * n_inst * 128 floats of scratch
// and ``counters`` ceil(R / 128) zeroed arrival counters that no call on
// another stream uses (the kernel leaves them at 0). ``prof`` (or null)
// takes 8 u64 stamps a block (the kernel's profile). Returns the launch's
// cudaError_t.
int qmatmul_grouped(const void* x, const void* q, const void* scale, const void* offset, void* y,
                    void* part, void* counters, void* prof, int T, int R, int C, int gs,
                    int nibble, int centered, int scale_bytes, int row_tile, int splits,
                    int stage_cols, int stages, int x_stages, int smem, int n_inst,
                    void* stream) {
  const int sc = nibble ? 256 : 128;
  const bool row = gs == 0;
  const bool s16 = scale_bytes == 2;
  if (T < 1 || T > 64 || R < 1 || C < 128 || C % 128 != 0 ||
      (gs != 16 && gs != 32 && !(row && !nibble && offset == nullptr)) ||
      (scale_bytes != 4 && !(s16 && nibble && centered && offset == nullptr)) ||
      row_tile != kTileRows || stage_cols != sc || stages < 4 ||
      (n_inst != 8 && n_inst != 16 && n_inst != 32 && n_inst != 64) || n_inst < T)
    return (int)cudaErrorInvalidValue;
  Plan p{};
  p.T = T; p.R = R; p.C = C; p.gs = gs; p.splits = splits; p.ring = stages;
  p.n_sc = (C + sc - 1) / sc;
  p.gps = row ? 0 : sc / gs;
  p.has_off = offset != nullptr;
  p.s16 = s16;
  const uint32_t nb = centered ? 0xC308u : 0xC300u;  // bf16 -(128 + 8), -128
  p.neg_bias2 = nb | (nb << 16);
  p.scale_bytes = kTileRows * p.gps * scale_bytes;
  p.s_off = stages * kStageQBytes;
  p.o_off = p.s_off + stages * p.scale_bytes;
  p.x_off = p.o_off + (p.has_off ? stages * p.scale_bytes : 0);
  p.bar_off = p.x_off + x_stages * (sc / 16) * (n_inst * 32 + 16);
  const int need = p.bar_off + 2 * stages * 8 + 16;
  if (splits < 1 || splits > p.n_sc || x_stages != (p.n_sc + splits - 1) / splits ||
      smem < need || smem > kMaxSmem || (splits > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, ts, to;
  const int cb = nibble ? C / 2 : C;  // quant bytes a row
  if (!encode_2d(&tq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, cb, R, cb, 128,
                 CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  // f16 scale rows: C / gs groups padded to a multiple of 8 (16 bytes)
  const int G = row ? 0 : C / gs, s_row = s16 ? 2 * ((G + 7) / 8 * 8) : 4 * G;
  if (!row && !encode_2d(&ts, scale, s16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         s_row, R, G, p.gps, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  if (p.has_off && !encode_2d(&to, offset, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4 * G, R, G, p.gps,
                              CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  if (row) ts = tq;  // unused
  if (!p.has_off) to = ts;  // unused
  const float* xf = static_cast<const float*>(x);
  const float* rsc = row ? static_cast<const float*>(scale) : nullptr;
  float* yf = static_cast<float*>(y);
  float* pf = static_cast<float*>(part);
  unsigned int* cf = static_cast<unsigned int*>(counters);
  unsigned long long* mf = static_cast<unsigned long long*>(prof);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row)
    return (int)dispatch_grouped<kRowwise>(n_inst, tq, ts, to, xf, rsc, yf, pf, cf, mf, p, smem, s);
  if (nibble)
    return (int)dispatch_grouped<kNibble>(n_inst, tq, ts, to, xf, rsc, yf, pf, cf, mf, p, smem, s);
  return (int)dispatch_grouped<kGroupedI8>(n_inst, tq, ts, to, xf, rsc, yf, pf, cf, mf, p, smem, s);
}

const char* qmatmul_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
