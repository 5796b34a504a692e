// The whole single-token decode step of a Gemma-3 model over its
// checkpoint's own group-scaled quants (lossless serve-q / serve-q4), in one
// persistent cooperative kernel, for Hopper (sm_90a).
//
// Replaces llm_inference_tpu/ops/pallas/fused_decode_q.py::
// decode_step_megakernel_q (_make_kernel :226-450, _run_step :459-547, the
// masked-dot _qdot :155-223). The step's structure, its phases and the
// design that streams the weights through every SM are in decode_step.cuh,
// which the per-row int8 step (fused_decode.cu) shares. This file supplies
// the lossless weight format. Each projection (QKV, Wo, gate/up, down) is
// int8 quants or nibble pairs in logical column order (quant/device.py) with
// f32 scales, and Q4_K's f32 min offsets, per group of 16 or 32 columns; each
// part has its own format and group size, so a serve-q4 step may mix nibble
// and int8 projections. The embedding is dense bf16 [V, D]: its row, times
// sqrt(D), starts the residual stream, and its rows give the logits.
//
// Numerics, those of the TPU kernel (fused_decode_q.py:22-26, :209-223): a
// weight row r of a phase gives
//
//     y[r] = sum_g ( s[r, g] * P[g] - off[r, g] * X[g] ),
//     P[g] = sum_{c in g} bf16(x_c) * q[r, c],   X[g] = sum_{c in g} bf16(x_c),
//
// with the exact f32 scales applied to f32 group partials (no bf16 rounding
// of the weights, unlike the per-op kernels). The TPU kernel folds the
// nibble rebias and sign-hi /16 into its scales (fused_decode_q.py:176-182,
// :219-221); here a nibble unpacks to its exact integer (u - 8 for Q4_0), so
// int8 and nibble parts take the same arithmetic. X[g] is summed once per
// phase into shared memory. The plain twin in ops/kernels/fused_decode_q.py
// computes the same sums in another order.
//
// What bounds it on the H100: bytes. A Gemma-3-1B step at position 300 reads
// 1.397 GB (serve-q): 697.8 MB of int8 quants, 87.2 MB of f32 group scales,
// 604.0 MB of bf16 embedding rows for the logits, 8.0 MB of live K/V; 0.417
// ms at 3.35 TB/s. serve-q4 halves the quants: 1.048 GB, 0.313 ms. Its
// ~3 GFLOP of f32 FMA take 0.05 ms at the CUDA cores' peak. The design
// streams the scales and offsets with their rows through the same TMA ring
// (a chunk carries three planes: quants, scales, offsets), so no GEMV row
// waits on a global load; a lane holds 16 consecutive columns, which lie in
// one group, so it reads one scale a piece, and two lanes' partials join
// with one shuffle for 32-column groups. Nibbles unpack with shifts and
// masks in registers.

#include "lossless.cuh"

namespace {

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

__global__ void __launch_bounds__(kThreads, 1) decode_step_q_kernel(Step p, Lossless fmt) {
  decode_step_body(p, fmt);
}

int g_smem_checked = 0;

}  // namespace

extern "C" {

int fused_decode_q_grid(int smem) { return cooperative_grid((const void*)decode_step_q_kernel, smem); }

// Shared memory the kernel needs for these dimensions (bytes).
int fused_decode_q_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv, int max_chunk) {
  Step p{};
  p.D = D; p.F = F; p.A = A; p.Rq = Rq; p.H = H; p.Hkv = Hkv; p.dk = dk; p.dv = dv;
  p.max_chunk = max_chunk;
  p.xsum_floats = imax(D, imax(A, F)) / 16;
  return (int)smem_layout(p).total;
}

int fused_decode_q_min_chunk() { return kMinChunk; }

// One decode step. ``ptrs``: the 22 step pointers (token, pos, base_idx,
// windows, inv_freq, attn_norm, ffn_norm, q_norm, k_norm, out_norm,
// post_attn_norm, post_ffw_norm, kc, vc, logits, qkv, part, y_attn, act,
// y_ffn, barrier, prof); ``dims`` the 12 ints L, D, F, A, Rq, V, S, H, Hkv,
// dk, dv, max_chunk; ``scalars`` eps, attn_scale, softcap, freq_scale,
// emb_mult. ``wptrs``: per phase (QKV [L, Rq, D], Wo [L, D, A], gate/up
// [L, 2F, D], down [L, D, F], logits), its quants (int8 [.., R, C], nibble
// pairs [.., R, C / 2], or for the logits the bf16 embedding [V, D]), its
// scales and its offsets f32 [.., R, C / gs] (null where absent).
// ``winfo``: per phase its format (0 int8, 1 nibble, 2 bf16), group size
// and centering (1: Q4_0 nibbles, value u - 8). Returns the launch's
// cudaError_t.
int fused_decode_q_step(void* const* ptrs, const int* dims, const float* scalars,
                        void* const* wptrs, const int* winfo, int grid, void* stream) {
  Step p{};
  fill_step(p, ptrs, dims, scalars);
  p.xsum_floats = imax(p.D, imax(p.A, p.F)) / 16;
  Lossless fmt{};
  const int R[5] = {p.Rq, p.D, 2 * p.F, p.D, p.V};
  const int C[5] = {p.D, p.A, p.D, p.F, p.D};
  if (!step_shapes_ok(p, grid)) return (int)cudaErrorInvalidValue;
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
  const int smem = (int)smem_layout(p).total;
  if (smem > g_smem_checked) {  // sets the dynamic shared-memory limit once per size
    if (fused_decode_q_grid(smem) < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
    g_smem_checked = smem;
  }
  void* args[] = {&p, &fmt};
  cudaError_t err = cudaLaunchCooperativeKernel((void*)decode_step_q_kernel, dim3(grid),
                                                dim3(kThreads), args, smem,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* fused_decode_q_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
