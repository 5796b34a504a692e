// In-place KV row insertion for Hopper (sm_90a).
//
// Replaces llm_inference_tpu/ops/pallas/kv_insert.py::insert_rows:
//
//     dst[rowidx[b]] = rows[b]   for b < B, in place; ids < 0 or >= R are dropped.
//
// dst is a [R, H, d] view of a batched cache ([B, S, Hkv, d] -> [B * S, Hkv, d]),
// rows the [B, H, d] new K or V rows of one decode step, both bf16.
//
// What bounds it on the H100: nothing but latency. A step moves B rows of
// H * d * 2 bytes (32 KB at B = 32 for the 1B model), a few nanoseconds of
// bandwidth; the launch costs more than the copy. The TPU kernel issues B
// HBM -> HBM DMAs at once to pay one latency for all of them; here one block
// per row copies it with 16-byte loads and stores, all blocks in flight
// together. The TPU kernel's [2, 128] re-view of a [1, 256] row
// (layout_supported) is a TPU tiling rule: a row is any multiple of 16 bytes
// here. The kernel reads its ids on the device, so the caller never syncs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
insert_rows_kernel(const uint4* __restrict__ rows, const int* __restrict__ rowidx,
                   uint4* __restrict__ dst, long long R, int words) {
  const long long r = rowidx[blockIdx.x];
  if (r < 0 || r >= R) return;  // dropped, as the scatter's mode="drop"
  const uint4* src = rows + (size_t)blockIdx.x * words;
  uint4* out = dst + (size_t)r * words;
  for (int i = threadIdx.x; i < words; i += kThreads) out[i] = src[i];
}

}  // namespace

extern "C" {

// rows [B, row_bytes], rowidx int32 [B], dst [R, row_bytes]; row_bytes a
// multiple of 16 and both buffers 16-byte aligned. Returns the launch's
// cudaError_t.
int kv_insert_rows(const void* rows, const void* rowidx, void* dst, long long R, int B,
                   int row_bytes, void* stream) {
  if (B < 0 || R < 0 || row_bytes <= 0 || row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  insert_rows_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(rows), static_cast<const int*>(rowidx), static_cast<uint4*>(dst), R,
      row_bytes / 16);
  return (int)cudaGetLastError();
}

const char* kv_insert_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
