// The whole single-token decode step of a Gemma-3 or gemma4 model over
// per-row int8 weights in one persistent cooperative kernel, for Hopper
// (sm_90a).
//
// Replaces llm_inference_tpu/ops/pallas/fused_decode.py::decode_step_megakernel
// (_make_kernel / _run_step): per-row int8 (rowq8) stacked weights, q/k
// norms, optional post-attention / post-FFN norms, optional attention
// softcap and a per-layer sliding window, and (a second instance,
// decode_step_g4_kernel) gemma4's static features: the per-layer-input
// prologue and epilogue, shared-KV layers, the unweighted V norm and the
// per-layer out_scale (fused_decode.py:194-530). The step's structure, its
// phases and the design that streams the weights through every SM are in
// decode_step.cuh, which the lossless step (fused_decode_q.cu) shares. This
// file supplies the rowq8 weight format: the embedding row is int8 times its
// row scale, and every GEMV row is an int8 row . bf16 activation (f32 FMA)
// times the row's scale (fused_decode.py:338, 353-355, 433, 439, 452, 481
// for the rounding points; the plain twin in ops/kernels/fused_decode.py
// mirrors them). The Gemma-3 instance holds a GEMV's activation in
// registers (D and H * dv up to 1536, the 1B class); the gemma4 instance
// reads it from shared memory, so its widths are bound by shared memory
// alone (D 2048 and past).
//
// What bounds it on the H100: bytes. A Gemma-3-1B step reads ~1.0 GB (698 MB
// of layer int8, 302 MB of tied-embedding int8, the row scales and the live
// K/V), about 0.3 ms at 3.35 TB/s; a gemma4 step at bench.py's GEOM_G4
// (24 layers, D 2048, P 256) ~1.44 GB (0.881 GB of layers, the 0.537 GB
// int8 logits, the 12.6 MB per_layer_model_proj, the owner layers' K/V),
// 0.43 ms; the ~2-3 GFLOP are nothing to the card. The row scales are read
// from global memory where a row's sum is done; only the int8 rows stream.
// The zero K/V rows of a shared-KV layer's padded QKV stream with it (8.4 MB
// a GEOM_G4 step): the segments keep one shape for every layer.

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

// gemma4: also the three per-layer-input phases, whose weights G4Params holds
struct RowQ8G4 : RowQ8Base<true> {
  G4Params g4;

  __device__ float row(const Step& p, const Smem& s, const Seg& g, const ActRegs& ar, int kind,
                       int l, int r, int rr, int rows, const char* st, int copy) const {
    const int C = (kind < kPLM ? p.parts[kind] : g4.parts[kind - kPLM]).row_bytes[0];
    const int8_t* w = reinterpret_cast<const int8_t*>(st) + (size_t)(copy * rows + rr) * C;
    return scaled(s, g, ar, kind, l, r, w, C, copy);
  }
};

__global__ void __launch_bounds__(kThreads, 1) decode_step_kernel(Step p, RowQ8 fmt) {
  decode_step_body<false>(p, fmt);
}

__global__ void __launch_bounds__(kThreads, 1) decode_step_g4_kernel(Step p, RowQ8G4 fmt) {
  decode_step_body<true>(p, fmt);
}

int g_smem_checked = 0;
int g_smem_checked_g4 = 0;

// The shared part of both entries: the step fields, and the five rowq8
// phases of ``ptrs`` (the Gemma-3 entry's 32 pointers) in ``fmt``.
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

template <class Fmt>
int launch(const void* kernel, Step& p, Fmt& fmt, int smem, int grid, void* stream) {
  void* args[] = {&p, &fmt};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, smem,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the cooperative grid on the current device (one per SM), 0 if
// the kernel cannot be resident with ``smem`` bytes of shared memory.
int fused_decode_grid(int smem) { return cooperative_grid((const void*)decode_step_kernel, smem); }
int fused_decode_g4_grid(int smem) {
  return cooperative_grid((const void*)decode_step_g4_kernel, smem);
}

// Shared memory the kernel needs for these dimensions (bytes).
int fused_decode_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv, int max_chunk) {
  Step p{};
  p.D = D; p.F = F; p.A = A; p.Rq = Rq; p.H = H; p.Hkv = Hkv; p.dk = dk; p.dv = dv;
  p.max_chunk = max_chunk;
  return (int)smem_layout(p).total;
}
int fused_decode_g4_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv,
                         int max_chunk) {
  Step p{};
  p.D = D; p.F = F; p.A = A; p.Rq = Rq; p.H = H; p.Hkv = Hkv; p.dk = dk; p.dv = dv;
  p.max_chunk = max_chunk;
  return (int)smem_layout(p, true).total;
}

int fused_decode_min_chunk() { return kMinChunk; }
int fused_decode_g4_min_chunk() { return kMinChunk; }

// One decode step. ``ptrs`` holds 32 device pointers: token, pos, base_idx,
// windows, inv_freq, attn_norm, ffn_norm, q_norm, k_norm, out_norm,
// post_attn_norm, post_ffw_norm; then the int8 rows and row scales of wqkv
// [L, Rq, D], wo [L, D, A], gate/up [L, 2F, D], down [L, D, F] and the
// embedding [V, D]; then kc, vc, logits and the scratch qkv, part, y_attn,
// act, y_ffn, barrier, prof. ``dims`` holds the 12 ints L, D, F, A, Rq, V,
// S, H, Hkv, dk, dv, max_chunk, ``scalars`` the 5 floats eps, attn_scale,
// softcap, freq_scale, emb_mult. Returns the launch's cudaError_t.
int fused_decode_step(void* const* ptrs, const int* dims, const float* scalars, int grid,
                      void* stream) {
  Step p{};
  RowQ8 fmt{};
  fill_rowq8(p, fmt, ptrs, dims, scalars);
  if (!step_shapes_ok(p, grid) || p.F > kStageBytes) return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_layout(p).total;
  if (smem > g_smem_checked) {  // sets the dynamic shared-memory limit once per size
    if (fused_decode_grid(smem) < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
    g_smem_checked = smem;
  }
  return launch((const void*)decode_step_kernel, p, fmt, smem, grid, stream);
}

// One gemma4 decode step. ``ptrs``: the 32 of fused_decode_step, then 13
// more: kv_src [L] int32, out_scale [L] (or null), per_layer_proj_norm [P],
// per_layer_post_norm [L, D], the int8 rows and row scales of
// per_layer_inp_gate [L, P, D], per_layer_proj [L, D, P] and
// per_layer_model_proj [L * P, D], the per-layer embedding [V, L * P] and
// its row scales [V], and the scratch pl_proj [L * P] f32. ``dims``: the 12
// ints, then P and n_kv (the layers that own a cache; kc and vc are
// [n_kv, S, ...]). ``scalars``: the 5 floats, then sqrt(P), 1 / sqrt(D),
// 1 / sqrt(2). Returns the launch's cudaError_t.
int fused_decode_g4_step(void* const* ptrs, const int* dims, const float* scalars, int grid,
                         void* stream) {
  Step p{};
  RowQ8G4 fmt{};
  fill_rowq8(p, fmt, ptrs, dims, scalars);
  G4Params& q = fmt.g4;
  q.kv_src = (const int*)ptrs[32];
  q.out_scale = (const float*)ptrs[33];
  q.pl_proj_norm = (const float*)ptrs[34];
  q.pl_post_norm = (const float*)ptrs[35];
  q.pl_emb_q = (const int8_t*)ptrs[42];
  q.pl_emb_s = (const float*)ptrs[43];
  q.pl_proj = (float*)ptrs[44];
  q.P = dims[12];
  q.n_kv = dims[13];
  q.pl_emb_mult = scalars[5];
  q.pl_proj_mult = scalars[6];
  q.inv_sqrt2 = scalars[7];
  const int R[3] = {p.L * q.P, q.P, p.D};  // kPLM, kPLG, kPLJ
  const int C[3] = {p.D, p.D, q.P};
  for (int j = 0; j < 3; ++j) {
    const int k = kPLM + j;
    Part& pt = q.parts[j];
    // ptrs: gate 36/37, proj 38/39, model proj 40/41
    const int at = k == kPLM ? 40 : k == kPLG ? 36 : 38;
    pt.base[0] = (const char*)ptrs[at];
    pt.row_bytes[0] = C[j];
    pt.layer_bytes[0] = k == kPLM ? 0 : (long long)R[j] * C[j];
    pt.n_planes = 1;
    fmt.scale[k] = (const float*)ptrs[at + 1];
    fmt.layer_rows[k] = k == kPLM ? 0 : R[j];
  }
  if (!step_shapes_ok(p, grid, false) || p.F > kStageBytes || 2 * p.D > kStageBytes ||
      q.P < 16 || q.P % 16 || q.P > p.D || q.P > p.F || q.n_kv < 1 || q.n_kv > p.L ||
      q.kv_src == nullptr || q.pl_proj == nullptr)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_layout(p, true).total;
  if (smem > g_smem_checked_g4) {
    if (fused_decode_g4_grid(smem) < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
    g_smem_checked_g4 = smem;
  }
  return launch((const void*)decode_step_g4_kernel, p, fmt, smem, grid, stream);
}

const char* fused_decode_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
