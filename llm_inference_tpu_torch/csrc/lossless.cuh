// The lossless weight formats of the whole decode steps: how one lane's 16
// consecutive columns of a group-scaled weight row (int8 quants, nibble
// pairs, or dense bf16) meet the activation, and how a group's partial takes
// its exact f32 scale and Q4_K offset, and the format of the whole-layer
// lossless steps (``Lossless``, over the phases of decode_step.cuh). Shared by
// the whole-layer lossless step (fused_decode_q.cu), its tensor-parallel
// counterpart (fused_decode_q_tp.cu) and the capacity step
// (fused_decode_stream.cu); the numerics are described in fused_decode_q.cu.

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

// Weight row w (n columns) . the activation, with its group scales ``sc``
// and offsets ``of`` (or null) and the activation's group sums ``xs``.
// REGS: the activation in registers (n <= kMaxRegCols); else read from hv.
template <int F, bool REGS>
__device__ __forceinline__ float qrow(const char* w, const float* sc, const float* of,
                                     const float* xs, const ActRegs& ar,
                                     const __nv_bfloat16* hv, int n, int gs, float bias) {
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  if constexpr (REGS) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int c = lane * 16 + k * 512;
      const bool live = c < n;
      const float p = live ? piece<F>(w, c, ar.v[k], bias) : 0.f;
      acc += group_term<F>(p, live, c, sc, of, xs, gs);
    }
  } else {
    for (int base = 0; base < n; base += 512) {
      const int c = base + lane * 16;
      const bool live = c < n;
      float p = 0.f;
      if (live) {
        const uint4 a0 = *reinterpret_cast<const uint4*>(hv + c);
        const uint4 a1 = *reinterpret_cast<const uint4*>(hv + c + 8);
        const uint32_t aw[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float a[16];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          a[2 * e] = bf16_lo(aw[e]);
          a[2 * e + 1] = bf16_hi(aw[e]);
        }
        p = piece<F>(w, c, a, bias);
      }
      acc += group_term<F>(p, live, c, sc, of, xs, gs);
    }
  }
  return warp_sum(acc);
}

__device__ __forceinline__ int phase_cols(const Step& p, int kind) {
  const int C[5] = {p.D, p.A, p.D, p.F, p.D};
  return C[kind];
}

struct Lossless {
  static constexpr bool kRegs = true;  // activations in registers but for down
  const __nv_bfloat16* emb;  // [V, D]
  int fmt[5];                // per Kind: kI8, kNib or kBF16
  int gs[5];                 // columns a group
  float bias[5];             // 8 for Q4_0's nibbles, else 0
  int has_off[5];

  __device__ void embed(const Step& p, Smem& s, int tok) const {
    for (int i = threadIdx.x; i < p.D; i += kThreads)
      s.x[i] = __bfloat162float(emb[(size_t)tok * p.D + i]) * p.emb_mult;
  }

  // The activation's per-group sums, for the offset term.
  __device__ void begin(const Step& p, Smem& s, int kind, int) const {
    if (fmt[kind] == kBF16 || !has_off[kind]) return;
    const int C = phase_cols(p, kind), g_s = gs[kind];
    for (int g = threadIdx.x; g < C / g_s; g += kThreads) {
      float t = 0.f;
      for (int j = 0; j < g_s; ++j) t += __bfloat162float(s.hv[g * g_s + j]);
      s.xsum[g] = t;
    }
    __syncthreads();
  }

  __device__ float row(const Step& p, const Smem& s, const Seg& g, const ActRegs& ar, int kind,
                       int, int, int rr, int rows, const char* st, int copy) const {
    const Part& pt = p.parts[kind];
    const int C = phase_cols(p, kind);
    const size_t rrow = (size_t)copy * rows + rr;
    const char* q = st + g.plane_off[0] + rrow * pt.row_bytes[0];
    const float* sc = reinterpret_cast<const float*>(st + g.plane_off[1] + rrow * pt.row_bytes[1]);
    const float* of = has_off[kind]
        ? reinterpret_cast<const float*>(st + g.plane_off[2] + rrow * pt.row_bytes[2]) : nullptr;
    const int f = fmt[kind], n_gs = gs[kind];
    const float b = bias[kind];
    if (kind == kDown) {
      if (f == kNib) return qrow<kNib, false>(q, sc, of, s.xsum, ar, s.hv, C, n_gs, b);
      return qrow<kI8, false>(q, sc, of, s.xsum, ar, s.hv, C, n_gs, b);
    }
    if (f == kBF16) return qrow<kBF16, true>(q, sc, of, s.xsum, ar, s.hv, C, n_gs, b);
    if (f == kNib) return qrow<kNib, true>(q, sc, of, s.xsum, ar, s.hv, C, n_gs, b);
    return qrow<kI8, true>(q, sc, of, s.xsum, ar, s.hv, C, n_gs, b);
  }
};

// Host side: the five phases of the lossless step in ``p`` and ``fmt``, from
// the C entries' ``wptrs`` (per phase quants, scales, offsets) and ``winfo``
// (per phase format, group size, centering), over the dimensions already in
// ``p``. Returns 0 or a cudaError_t.
inline int fill_lossless(Step& p, Lossless& fmt, void* const* wptrs, const int* winfo) {
  p.xsum_floats = imax(p.D, imax(p.A, p.F)) / 16;
  const int R[5] = {p.Rq, p.D, 2 * p.F, p.D, p.V};
  const int C[5] = {p.D, p.A, p.D, p.F, p.D};
  for (int k = 0; k < 5; ++k) {
    const int f = winfo[3 * k], gs = winfo[3 * k + 1];
    Part& pt = p.parts[k];
    fmt.fmt[k] = f;
    fmt.gs[k] = gs;
    fmt.bias[k] = winfo[3 * k + 2] ? 8.f : 0.f;
    fmt.has_off[k] = wptrs[3 * k + 2] != nullptr;
    if ((k == kLogits) != (f == kBF16) || f < 0 || f > kBF16 || wptrs[3 * k] == nullptr)
      return (int)cudaErrorInvalidValue;
    pt.base[0] = (const char*)wptrs[3 * k];
    pt.row_bytes[0] = f == kI8 ? C[k] : f == kNib ? C[k] / 2 : 2 * C[k];
    pt.n_planes = 1;
    if (f != kBF16) {
      if ((gs != 16 && gs != 32) || C[k] % (4 * gs) || wptrs[3 * k + 1] == nullptr)
        return (int)cudaErrorInvalidValue;
      const int gbytes = 4 * (C[k] / gs);  // a multiple of 16: the bulk copies need it
      pt.base[1] = (const char*)wptrs[3 * k + 1];
      pt.row_bytes[1] = gbytes;
      pt.n_planes = 2;
      if (fmt.has_off[k]) {
        pt.base[2] = (const char*)wptrs[3 * k + 2];
        pt.row_bytes[2] = gbytes;
        pt.n_planes = 3;
      }
    }
    int row = 0;
    for (int j = 0; j < pt.n_planes; ++j) {
      pt.layer_bytes[j] = k == kLogits ? 0 : (long long)R[k] * pt.row_bytes[j];
      row += pt.row_bytes[j];
    }
    if (row * (k == kGU ? 2 : 1) > kStageBytes) return (int)cudaErrorInvalidValue;
  }
  fmt.emb = (const __nv_bfloat16*)wptrs[3 * kLogits];
  return 0;
}

}  // namespace
