// The lossless weight formats of the whole decode steps: how one lane's 16
// consecutive columns of a group-scaled weight row (int8 quants, nibble
// pairs, or dense bf16) meet the activation, and how a group's partial takes
// its exact f32 scale and Q4_K offset. Shared by the whole-layer lossless step
// (fused_decode_q.cu) and the capacity step (fused_decode_stream.cu); the
// numerics are described in fused_decode_q.cu.

#pragma once

#include "decode_step.cuh"

namespace {

constexpr int kI8 = 0;    // int8 quants
constexpr int kNib = 1;   // nibble pairs (byte j: column 2j low, 2j + 1 high)
constexpr int kBF16 = 2;  // dense bf16 (the embedding)

// The lane's 16 weights from column c of row w . the activation a[16].
template <int F>
__device__ __forceinline__ float piece(const char* w, int c, const float (&a)[16], float bias) {
  float acc = 0.f;
  if constexpr (F == kI8) {
    const uint4 q = *reinterpret_cast<const uint4*>(w + c);
    const uint32_t qw[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 16; ++e) acc = fmaf(i8(qw[e / 4], e % 4), a[e], acc);
  } else if constexpr (F == kNib) {
    const uint2 q = *reinterpret_cast<const uint2*>(w + c / 2);
    const uint32_t qw[2] = {q.x, q.y};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const uint32_t u = (qw[e / 8] >> (4 * (e % 8))) & 0xFu;  // column c + e
      acc = fmaf(__int_as_float(0x4B000000u | u) - (8388608.f + bias), a[e], acc);
    }
  } else {
    const uint4 q0 = *reinterpret_cast<const uint4*>(w + 2 * c);
    const uint4 q1 = *reinterpret_cast<const uint4*>(w + 2 * c + 16);
    const uint32_t qw[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc = fmaf(bf16_lo(qw[e]), a[2 * e], acc);
      acc = fmaf(bf16_hi(qw[e]), a[2 * e + 1], acc);
    }
  }
  return acc;
}

// One piece's share of a row: the partial of its group (two lanes' pieces
// joined for 32-column groups), times the group's scale, minus its offset
// term; every lane calls it (the shuffle needs the whole warp).
template <int F>
__device__ __forceinline__ float group_term(float p, bool live, int c, const float* sc,
                                           const float* of, const float* xs, int gs) {
  if constexpr (F == kBF16) {
    return p;
  } else {
    if (gs == 32) p += __shfl_xor_sync(0xFFFFFFFFu, p, 1);
    if (!live || (gs == 32 && (threadIdx.x & 1))) return 0.f;
    const int g = c / gs;
    float t = sc[g] * p;
    if (of != nullptr) t = fmaf(-of[g], xs[g], t);
    return t;
  }
}

}  // namespace
