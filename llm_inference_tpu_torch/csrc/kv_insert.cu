// In-place KV row insertion for Hopper (sm_90a).
//
// Replaces llm_inference_tpu/ops/pallas/kv_insert.py::insert_rows:
//
//     dst[rowidx[b]] = rows[b]   for b < B, in place; ids < 0 or >= R are dropped.
//
// and, in one launch, the per-op batched routes' K/V append around it
// (llm_inference_tpu/models/gemma.py:717-723 and :905-911, which write
// insert_rows(pool, k.astype(pool.dtype), idx) for K and then for V):
//
//     kdst[rowidx[b]] = bf16(k[b]);  vdst[rowidx[b]] = bf16(v[b])
//
// A destination is a [R, H, d] view of a cache or page pool ([B, S, Hkv, d]
// -> [B * S, Hkv, d]); a source [B, H, d] rows, each row's H * d elements
// contiguous, row b at its own byte stride (v is a column slice of the
// fused QKV projection, so its rows are not packed).
//
// What bounds it on the H100: nothing but latency. A step moves B rows of
// Hkv * (dk + dv) * 2 bytes a layer (32 KB at B = 32 for the 1B model), a
// few nanoseconds of bandwidth; the launch costs more than the copy. The
// TPU kernel issues B HBM -> HBM DMAs at once to pay one latency for all of
// them, and jit fuses the cast into its producer. Here one launch takes a
// lane's K and V rows in one block: an f32 source is rounded to bf16 in
// registers (__floats2bfloat162_rn: round to nearest even, as
// Tensor.to(torch.bfloat16)), a source of the destination's dtype is copied
// as bytes; 16-byte stores, all blocks in flight together. So the route
// pays one launch a layer where it paid two casts and two copies. The TPU
// kernel's [2, 128] re-view of a [1, 256] row (layout_supported) is a TPU
// tiling rule: a row is any multiple of 16 bytes here. The kernel reads its
// ids on the device, so the caller never syncs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

// One destination and its source: row r of dst is words 16-byte words at
// dst + r * words; source row b starts stride bytes after row b - 1 and
// holds the same words (a byte copy) or, with f32 set, twice as many f32
// words that round to them.
struct Pair {
  const char* src;
  long long stride;
  uint4* dst;
  int words;
  int f32;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void put(const Pair& p, int b, long long r, int w) {
  const char* row = p.src + (long long)b * p.stride;
  uint4 out;
  if (p.f32) {
    const float4* s = reinterpret_cast<const float4*>(row) + 2 * w;
    const float4 a = __ldg(s), c = __ldg(s + 1);
    out = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(c.x, c.y),
                     pack_bf16(c.z, c.w));
  } else {
    out = __ldg(reinterpret_cast<const uint4*>(row) + w);
  }
  p.dst[r * p.words + w] = out;
}

// Block b writes lane b's K row then its V row (v.words = 0: K only).
__global__ void __launch_bounds__(kMaxThreads)
insert_kernel(const Pair k, const Pair v, const int* __restrict__ rowidx, long long R) {
  const long long r = rowidx[blockIdx.x];
  if (r < 0 || r >= R) return;  // dropped, as the scatter's mode="drop"
  const int n = k.words + v.words;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (i < k.words) {
      put(k, blockIdx.x, r, i);
    } else {
      put(v, blockIdx.x, r, i - k.words);
    }
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool valid(const void* src, long long stride, const void* dst, int words) {
  return src != nullptr && dst != nullptr && words > 0 && stride % 16 == 0 && aligned(src) &&
         aligned(dst);
}

}  // namespace

extern "C" {

// ksrc [B] rows at kstride bytes, each kwords * 16 bytes (kf32 = 0, a byte
// copy) or kwords * 32 bytes of f32 (kf32 = 1, rounded to bf16), into kdst
// [R, kwords * 16 bytes] at rows rowidx (int32 [B]); the same for V in the
// same launch, or no V where vsrc is null. Pointers and strides 16-byte
// aligned. Launches on stream, allocates nothing; returns the launch's
// cudaError_t.
int kv_insert_pairs(const void* ksrc, long long kstride, int kf32, void* kdst, int kwords,
                    const void* vsrc, long long vstride, int vf32, void* vdst, int vwords,
                    const void* rowidx, long long R, int B, void* stream) {
  if (B < 0 || R < 0 || rowidx == nullptr || !valid(ksrc, kstride, kdst, kwords) ||
      (vsrc != nullptr && !valid(vsrc, vstride, vdst, vwords)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Pair k{static_cast<const char*>(ksrc), kstride, static_cast<uint4*>(kdst), kwords,
               kf32 != 0};
  const Pair v = vsrc == nullptr
                     ? Pair{nullptr, 0, nullptr, 0, 0}
                     : Pair{static_cast<const char*>(vsrc), vstride, static_cast<uint4*>(vdst),
                            vwords, vf32 != 0};
  const int n = k.words + v.words;
  const int threads = n >= kMaxThreads ? kMaxThreads : (n + 31) / 32 * 32;
  insert_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      k, v, static_cast<const int*>(rowidx), R);
  return (int)cudaGetLastError();
}

const char* kv_insert_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
