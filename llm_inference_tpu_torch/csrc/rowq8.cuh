// The per-row int8 (rowq8) weight format of the whole decode steps: the
// embedding row is int8 times its row scale, and every GEMV row is an int8
// row . bf16 activation (f32 FMA) times the row's scale. Shared by the
// single-chip rowq8 step (fused_decode.cu) and the tensor-parallel one
// (fused_decode_tp.cu).

#pragma once

#include "decode_step.cuh"

namespace {

// kSmemAct: every GEMV row reads the activation from s.hv (the gemma4
// instance); otherwise from registers, but the down projection's.
template <bool kSmemAct>
struct RowQ8Base {
  static constexpr bool kRegs = !kSmemAct;
  static constexpr int kN = kSmemAct ? kKinds : 5;  // phases with weights
  const int8_t* emb_q;     // [V, D]
  const float* emb_s;      // [V]
  const float* scale[kN];  // per Kind: row scales, [L, rows] (logits, kPLM: [rows])
  long long layer_rows[kN];

  __device__ void embed(const Step& p, Smem& s, int tok) const {
    const float es = emb_s[tok];
    for (int i = threadIdx.x; i < p.D; i += kThreads)
      s.x[i] = (float)emb_q[(size_t)tok * p.D + i] * es * p.emb_mult;
  }

  __device__ void begin(const Step&, Smem&, int, int) const {}

  // the row's dot with the activation, times its scale, the row's C int8
  // already at ``w``
  __device__ float scaled(const Smem& s, const Seg& g, const ActRegs& ar, int kind, int l, int r,
                          const int8_t* w, int C, int copy) const {
    float v;
    if constexpr (kSmemAct) v = smem_row_dot(w, s.hv, C);
    else v = kind == kDown ? smem_row_dot(w, s.hv, C) : row_dot_regs(w, ar, C);
    return v * scale[kind][(size_t)l * layer_rows[kind] + (size_t)copy * g.R + r];
  }
};

// Gemma-3: the five phases of Step
struct RowQ8 : RowQ8Base<false> {
  __device__ float row(const Step& p, const Smem& s, const Seg& g, const ActRegs& ar, int kind,
                       int l, int r, int rr, int rows, const char* st, int copy) const {
    const int C = p.parts[kind].row_bytes[0];
    const int8_t* w = reinterpret_cast<const int8_t*>(st) + (size_t)(copy * rows + rr) * C;
    return scaled(s, g, ar, kind, l, r, w, C, copy);
  }
};

// Host side: the step fields, and the five rowq8 phases of ``ptrs`` (the
// Gemma-3 entry's 32 pointers) in ``fmt``.
template <class Fmt>
void fill_rowq8(Step& p, Fmt& fmt, void* const* ptrs, const int* dims, const float* scalars) {
  void* step_ptrs[22];
  for (int i = 0; i < 12; ++i) step_ptrs[i] = ptrs[i];
  for (int i = 0; i < 10; ++i) step_ptrs[12 + i] = ptrs[22 + i];
  fill_step(p, step_ptrs, dims, scalars);
  fmt.emb_q = (const int8_t*)ptrs[20];
  fmt.emb_s = (const float*)ptrs[21];
  const int R[5] = {p.Rq, p.D, 2 * p.F, p.D, p.V};
  const int C[5] = {p.D, p.A, p.D, p.F, p.D};
  for (int k = 0; k < 5; ++k) {
    Part& pt = p.parts[k];
    pt.base[0] = (const char*)ptrs[12 + 2 * k];
    pt.row_bytes[0] = C[k];
    pt.layer_bytes[0] = k == kLogits ? 0 : (long long)R[k] * C[k];
    pt.n_planes = 1;
    fmt.scale[k] = (const float*)ptrs[13 + 2 * k];
    fmt.layer_rows[k] = k == kLogits ? 0 : R[k];
  }
}

}  // namespace
