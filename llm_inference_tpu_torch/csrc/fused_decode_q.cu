// The whole single-token decode step of a Gemma-3 model over its
// checkpoint's own group-scaled quants (lossless serve-q / serve-q4), in one
// persistent cooperative kernel, for Hopper (sm_90a).
//
// Replaces llm_inference_tpu/ops/pallas/fused_decode_q.py::
// decode_step_megakernel_q (_make_kernel :226-450, _run_step :459-547, the
// masked-dot _qdot :155-223). The step's order, its rounding points and
// its residual stream are decode_step.cuh's; its body is whole_step.cuh's
// (the body of every whole step: the rowq8 ones, fused_decode.cu and
// fused_decode_tp.cu, the tensor-parallel lossless step,
// fused_decode_q_tp.cu, and the capacity step, fused_decode_stream.cu). Each projection (QKV, Wo, gate/up, down) is
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
// ~3 GFLOP of products run on the tensor cores (exact bf16 operands).
//
// Design: whole_step.cuh's step over the whole grid, with tile_stream.cuh's
// weight stream (fused_decode_stream.cu is the same body at the capacity
// widths). Every GEMV phase, the logits over the bf16 embedding included,
// streams row x column-slab tiles: one tensor-map copy a plane and tile
// (quants, scales, offsets) into a ring of shared-memory stages that runs
// ahead across grid barriers, attention and layers; the products on the
// tensor cores over exact bf16 weights (int8 by byte permutes, nibbles by a
// mask and one bf16x2 fma); a block barrier a tile and a refill cursor
// without divisions (a copy a row, or warps that release stages on their
// own, cost more: PERF.md). A block's share of a phase is whole tiles (at
// 1B a QKV, Wo or down tile is 16 rows: 96, 72 and 72 blocks take one
// each), cut by the wrapper's plan (ops/kernels/fused_decode_stream.py
// ``plan``, a pure function of the shapes, the formats and the grid). What
// the step still spends beyond its bytes (the attention chain, the
// barriers, the blocks that hold two tiles more than others) is measured
// in PERF.md.

#include "whole_step.cuh"

namespace {

__global__ void __launch_bounds__(kThreads, 1)
    decode_step_q_kernel(Step p, StreamFmt f, const __grid_constant__ Maps mp) {
  whole_step_body<false, false>(p, f, mp, Solo{});
}

int g_smem_checked = 0;

}  // namespace

extern "C" {

int fused_decode_q_grid(int smem) { return cooperative_grid((const void*)decode_step_q_kernel, smem); }

// Shared memory the kernel needs for these dimensions and a ring of
// ``stages`` stages of ``stage_bytes`` (bytes).
int fused_decode_q_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv,
                        int stage_bytes, int stages) {
  return whole_smem(D, F, A, Rq, H, Hkv, dk, dv, H / Hkv, stage_bytes, stages);
}

// One decode step. ``ptrs``: the 22 step pointers (token, pos, base_idx,
// windows, inv_freq, attn_norm, ffn_norm, q_norm, k_norm, out_norm,
// post_attn_norm, post_ffw_norm, kc, vc, logits, qkv, part, y_attn, act,
// y_ffn, barrier, prof), then the scores scratch f32 [H, S]; ``dims`` the 12
// ints L, D, F, A, Rq, V, S, H, Hkv, dk, dv, 0; ``scalars`` eps, attn_scale,
// softcap, freq_scale, emb_mult. ``wptrs``: per phase (QKV [L, Rq, D], Wo
// [L, D, A], gate/up [L, 2F, D], down [L, D, F], logits), its quants (int8
// [.., R, C], nibble pairs [.., R, C / 2], or for the logits the bf16
// embedding [V, D]), its scales and its offsets f32 [.., R, C / gs] (null
// where absent). ``winfo``: per phase its format (0 int8, 1 nibble, 2 bf16),
// group size, centering (1: Q4_0 nibbles, value u - 8) and scale bytes (4;
// 2 for raw f16 scales, tile_stream.cuh fill_stream). ``plan``: the
// wrapper's tile plan (tile_stream.cuh TilePlan), checked here. Returns the
// launch's cudaError_t.
int fused_decode_q_step(void* const* ptrs, const int* dims, const float* scalars,
                        void* const* wptrs, const int* winfo, const int* plan, int grid,
                        void* stream) {
  return launch_whole((const void*)decode_step_q_kernel, false, false, fused_decode_q_grid,
                      g_smem_checked, ptrs, dims, scalars, wptrs, winfo, plan, grid, stream);
}

const char* fused_decode_q_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
