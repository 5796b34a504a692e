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
// per-layer out_scale (fused_decode.py:194-530). The step is
// whole_step.cuh's body over tile_stream.cuh's weight stream, the body and
// stream of every whole step of the port (the lossless and capacity steps,
// and the tensor-parallel rowq8 step of fused_decode_tp.cu); its skeleton,
// views and barrier are decode_step.cuh's.
//
// The rowq8 contract: the embedding row is int8 times its row scale, and
// every GEMV row is an int8 row . bf16 activation times the row's f32
// scale (fused_decode.py:338, 353-355, 433, 439, 452, 481 for the rounding
// points; the plain twin in ops/kernels/fused_decode.py mirrors them). Each
// int8 becomes an exact bf16 on the tensor cores, so every product with the
// bf16 activation is exact; the f32 sums run in another order than the
// plain twin's, and the row's scale, read from global memory, multiplies
// the row's finished sum. Only the int8 rows stream: a rowq8 tile has one
// plane. No atomic touches data, so a second launch is bit-equal.
//
// What bounds it on the H100: bytes. A Gemma-3-1B step reads ~1.0 GB (698 MB
// of layer int8, 302 MB of tied-embedding int8, the row scales and the live
// K/V), about 0.3 ms at 3.35 TB/s; a gemma4 step at bench.py's GEOM_G4
// (24 layers, D 2048, P 256) ~1.44 GB (0.881 GB of layers, the 0.537 GB
// int8 logits, the 12.6 MB per_layer_model_proj, the owner layers' K/V),
// 0.43 ms; the ~2-3 GFLOP of products run on the tensor cores. The zero K/V
// rows of a shared-KV layer's padded QKV stream with it (8.4 MB a GEOM_G4
// step): the phases keep one shape for every layer. The prologue's 6144 x
// 2048 per_layer_model_proj is cut into whole tiles dealt out over every
// block, as every phase is.

#include "whole_step.cuh"

namespace {

__global__ void __launch_bounds__(kThreads, 1)
    decode_step_kernel(Step p, StreamFmt f, const __grid_constant__ Maps mp) {
  whole_step_body<true, false>(p, f, mp, Solo{});
}

// Its parameters are __grid_constant__: the gemma4 body takes their
// addresses, which would otherwise copy them to the stack (1.4 KB).
__global__ void __launch_bounds__(kThreads, 1)
    decode_step_g4_kernel(const __grid_constant__ Step p, const __grid_constant__ StreamFmt f,
                          const __grid_constant__ Maps mp) {
  whole_step_body<true, true>(p, f, mp, Solo{});
}

int g_smem_checked = 0;
int g_smem_checked_g4 = 0;

}  // namespace

extern "C" {

// Blocks of the cooperative grid on the current device (one per SM), 0 if
// the kernel cannot be resident with ``smem`` bytes of shared memory.
int fused_decode_grid(int smem) { return cooperative_grid((const void*)decode_step_kernel, smem); }
int fused_decode_g4_grid(int smem) {
  return cooperative_grid((const void*)decode_step_g4_kernel, smem);
}

// Shared memory the kernel needs for these dimensions and a ring of
// ``stages`` stages of ``stage_bytes`` (bytes).
int fused_decode_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv,
                      int stage_bytes, int stages) {
  return whole_smem(D, F, A, Rq, H, Hkv, dk, dv, H / Hkv, stage_bytes, stages);
}
int fused_decode_g4_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv,
                         int stage_bytes, int stages) {
  return whole_smem(D, F, A, Rq, H, Hkv, dk, dv, H / Hkv, stage_bytes, stages);
}

// One decode step. ``ptrs``: the 22 step pointers (token, pos, base_idx,
// windows, inv_freq, attn_norm, ffn_norm, q_norm, k_norm, out_norm,
// post_attn_norm, post_ffw_norm, kc, vc, logits, qkv, part, y_attn, act,
// y_ffn, barrier, prof), then the scores scratch f32 [H, S]; ``dims`` the 12
// ints L, D, F, A, Rq, V, S, H, Hkv, dk, dv, 0; ``scalars`` eps, attn_scale,
// softcap, freq_scale, emb_mult. ``wptrs``: per phase (QKV [L, Rq, D], Wo
// [L, D, A], gate/up [L, 2F, D], down [L, D, F], logits over the embedding
// [V, D]) its int8 rows, their f32 row scales [.., R, 1] and a null;
// ``winfo``: per phase 3 (tile_stream.cuh kI8R), 0, 0, 4. ``plan``: the
// wrapper's tile plan (tile_stream.cuh TilePlan), checked here. Returns the
// launch's cudaError_t.
int fused_decode_step(void* const* ptrs, const int* dims, const float* scalars,
                      void* const* wptrs, const int* winfo, const int* plan, int grid,
                      void* stream) {
  return launch_whole((const void*)decode_step_kernel, true, false, fused_decode_grid, g_smem_checked,
                      ptrs, dims, scalars, wptrs, winfo, plan, grid, stream);
}

// One gemma4 decode step. ``ptrs``: the 23 of fused_decode_step, then
// kv_src [L] int32, out_scale [L] (or null), per_layer_proj_norm [P],
// per_layer_post_norm [L, D], the per-layer embedding int8 [V, L * P] and
// its row scales [V], and the scratch pl_proj [L * P] f32. ``dims``: the 12
// ints with P last, then n_kv (the layers that own a cache; kc and vc are
// [n_kv, S, ...]). ``scalars``: the 5 floats, then sqrt(P), 1 / sqrt(D),
// 1 / sqrt(2). ``wptrs``, ``winfo``: as fused_decode_step's over eight
// phases, the five, then per_layer_model_proj [L * P, D], the per-layer
// gate [L, P, D] and proj [L, D, P]; ``plan`` over the eight. Returns the
// launch's cudaError_t.
int fused_decode_g4_step(void* const* ptrs, const int* dims, const float* scalars,
                         void* const* wptrs, const int* winfo, const int* plan, int grid,
                         void* stream) {
  return launch_whole((const void*)decode_step_g4_kernel, true, true, fused_decode_g4_grid,
                      g_smem_checked_g4, ptrs, dims, scalars, wptrs, winfo, plan, grid, stream);
}

const char* fused_decode_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
