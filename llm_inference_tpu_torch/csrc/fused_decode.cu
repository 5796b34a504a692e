// The whole single-token decode step of a Gemma-3 model over per-row int8
// weights in one persistent cooperative kernel, for Hopper (sm_90a).
//
// Replaces llm_inference_tpu/ops/pallas/fused_decode.py::decode_step_megakernel
// (_make_kernel / _run_step), Gemma-3 features: per-row int8 (rowq8) stacked
// weights, q/k norms, optional post-attention / post-FFN norms, optional
// attention softcap and a per-layer sliding window. The step's structure,
// its phases and the design that streams the weights through every SM are
// in decode_step.cuh, which the lossless step (fused_decode_q.cu) shares.
// This file supplies the rowq8 weight format: the embedding row is int8
// times its row scale, and every GEMV row is an int8 row . bf16 activation
// (f32 FMA) times the row's scale (fused_decode.py:338, 353-355, 433, 439,
// 452, 481 for the rounding points; the plain twin in
// ops/kernels/fused_decode.py mirrors them).
//
// What bounds it on the H100: bytes. A Gemma-3-1B step reads ~1.0 GB (698 MB
// of layer int8, 302 MB of tied-embedding int8, the row scales and the live
// K/V), about 0.3 ms at 3.35 TB/s, while its ~2 GFLOP are nothing to the
// card. The row scales are read from global memory where a row's sum is
// done; only the int8 rows stream.

#include "decode_step.cuh"

namespace {

struct RowQ8 {
  const int8_t* emb_q;     // [V, D]
  const float* emb_s;      // [V]
  const float* scale[5];   // per Kind: row scales, [L, rows] (logits: [V])
  long long layer_rows[5];

  __device__ void embed(const Step& p, Smem& s, int tok) const {
    const float es = emb_s[tok];
    for (int i = threadIdx.x; i < p.D; i += kThreads)
      s.x[i] = (float)emb_q[(size_t)tok * p.D + i] * es * p.emb_mult;
  }

  __device__ void begin(const Step&, Smem&, int, int) const {}

  __device__ float row(const Step& p, const Smem& s, const Seg& g, const ActRegs& ar, int kind,
                       int l, int r, int rr, int rows, const char* st, int copy) const {
    const int C = p.parts[kind].row_bytes[0];
    const int8_t* w = reinterpret_cast<const int8_t*>(st) + (size_t)(copy * rows + rr) * C;
    const float v = kind == kDown ? smem_row_dot(w, s.hv, C) : row_dot_regs(w, ar, C);
    return v * scale[kind][(size_t)l * layer_rows[kind] + (size_t)copy * g.R + r];
  }
};

__global__ void __launch_bounds__(kThreads, 1) decode_step_kernel(Step p, RowQ8 fmt) {
  decode_step_body(p, fmt);
}

int g_smem_checked = 0;

}  // namespace

extern "C" {

// Blocks of the cooperative grid on the current device (one per SM), 0 if
// the kernel cannot be resident with ``smem`` bytes of shared memory.
int fused_decode_grid(int smem) { return cooperative_grid((const void*)decode_step_kernel, smem); }

// Shared memory the kernel needs for these dimensions (bytes).
int fused_decode_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv, int max_chunk) {
  Step p{};
  p.D = D; p.F = F; p.A = A; p.Rq = Rq; p.H = H; p.Hkv = Hkv; p.dk = dk; p.dv = dv;
  p.max_chunk = max_chunk;
  return (int)smem_layout(p).total;
}

int fused_decode_min_chunk() { return kMinChunk; }

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
  void* step_ptrs[22];
  for (int i = 0; i < 12; ++i) step_ptrs[i] = ptrs[i];
  for (int i = 0; i < 10; ++i) step_ptrs[12 + i] = ptrs[22 + i];
  Step p{};
  fill_step(p, step_ptrs, dims, scalars);
  RowQ8 fmt{};
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
  if (!step_shapes_ok(p, grid) || p.F > kStageBytes) return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_layout(p).total;
  if (smem > g_smem_checked) {  // sets the dynamic shared-memory limit once per size
    if (fused_decode_grid(smem) < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
    g_smem_checked = smem;
  }
  void* args[] = {&p, &fmt};
  cudaError_t err = cudaLaunchCooperativeKernel((void*)decode_step_kernel, dim3(grid), dim3(kThreads),
                                                args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* fused_decode_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
