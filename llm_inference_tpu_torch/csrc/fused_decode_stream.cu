// The whole single-token decode step of a capacity-class Gemma-3 model (the
// 4B, 12B and 27B widths) over its checkpoint's own group-scaled quants
// (lossless serve-q / serve-q4), in one persistent cooperative kernel, for
// Hopper (sm_90a).
//
// Replaces llm_inference_tpu/ops/pallas/fused_decode_stream.py::
// decode_step_megakernel_stream (:882; _run_step :776/:855, _tile_dot :295).
// It computes what fused_decode_q.cu computes, with the same numerics
// (fused_decode_stream.py:33-37: exact f32 group scales on f32 group partials
// of bf16(x) . q, Q4_K offsets times the activation's group sums, the bf16
// rounding points of the lossless step; whole_step.cuh), for layers too wide
// for that kernel: D up to 5376, H * dv up to 4096, F up to 21504, up to four
// q heads per KV head and any number of KV heads, head_dim 128 or 256. The
// TPU kernel streams row tiles of each projection through two VMEM slots per
// part and copies each layer's K/V one layer ahead into VMEM, because a
// capacity layer does not fit in 128 MiB of VMEM (:11-33). None of that is
// copied: the grid barriers, the residual stream and the norms are
// decode_step.cuh's, K/V rows are read from device memory where they lie,
// and each GEMV phase (the logits too, over the bf16 tied embedding) is a
// stream of tiles through a ring of TMA stages that runs ahead across
// phases, barriers and layers.
//
// The step body is whole_step.cuh's, over the whole grid, and its weight
// stream tile_stream.cuh's, both shared with the whole-layer lossless step
// (fused_decode_q.cu) and its tensor-parallel counterpart: this kernel is
// the capacity widths' instance. What the capacity widths ask of them:
//   - the activation is read from shared memory, never held in registers;
//   - tiles, not whole rows: a wide row does not fit a stage many times (a
//     12B serve-q down row is 17.3 KB), so a block streams its rows of a
//     phase as tiles of 16, 32 or 64 rows (gate/up: row pairs) by a slab of
//     columns, cut by the wrapper's plan (ops/kernels/fused_decode_stream.py
//     ``plan``);
//   - attention takes (KV head, slot range) work items over the blocks, so
//     all KV heads (8 at 12B, 16 at 27B) run in parallel, with the scores in
//     a global [H, S] scratch, so no cache length is bounded by shared
//     memory;
//   - the K/V row of slot pos is written straight to the cache by block 0
//     (the attention blocks take it from shared memory), so no writeback
//     lags a layer: the reference's LLMI_STREAM_DEFER_WB, whose two layers'
//     writebacks share one semaphore (fused_decode_stream.py:588-664), has
//     no counterpart, and no per-parity synchronisation is owed.
// Numerics: a row's value is the sum, in f32, of its groups' exact scale
// times the group's f32 partial of bf16(x) . q (minus the offset times the
// activation's group sum), as in the whole-layer step; the products are
// exact in the tensor cores and only the order of the f32 sums differs; the
// order is fixed, so a second launch is bit-equal.
// Every offset into the stacked weights (5.66 GB of 12B gate/up int8), the
// embedding (2.01 GB at 12B, 2.82 GB at 27B) and the caches is computed in
// 64 bits (the tensor maps address the layers, rows and blocks).
//
// What bounds it on the H100: bytes. A Gemma-3-12B step (48 layers, D 3840,
// F 15360) reads 10.76 G weights a step: in serve-q4 6.72 GB of nibbles and
// f32 scales plus the 2.01 GB bf16 embedding for the logits, 8.74 GB, 2.61 ms
// at 3.35 TB/s; in serve-q 14.1 GB, 4.22 ms. K/V at position 300 adds 59 MB.
// A ring of ~108 KB a block (three 36 KB stages at 12B) holds about one
// tile's arrival latency (4-5 us under load) of the stream, and the GEMV
// consumer's time a tile adds to it: the tensor cores and the barrier-held
// ring keep that time short. What it leaves on the table (six grid
// barriers a layer, the issuer's copies on the tile's critical path, warps
// idle where a block's share of a phase is under a tile) is measured in
// PERF.md (tools/stream_profile.py times every tile of block 0).

#include "whole_step.cuh"

namespace {

__global__ void __launch_bounds__(kThreads, 1)
    decode_step_stream_kernel(Step p, StreamFmt f, const __grid_constant__ Maps mp) {
  whole_step_body<false, false>(p, f, mp, Solo{});
}

int g_smem_checked = 0;

}  // namespace

extern "C" {

int fused_decode_stream_grid(int smem) {
  return cooperative_grid((const void*)decode_step_stream_kernel, smem);
}

// Shared memory the kernel needs for these dimensions and a ring of
// ``stages`` stages of ``stage_bytes`` (bytes).
int fused_decode_stream_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv,
                             int stage_bytes, int stages) {
  return whole_smem(D, F, A, Rq, H, Hkv, dk, dv, H / Hkv, stage_bytes, stages);
}

// One decode step. ``ptrs``: the 22 step pointers of fill_step (token, pos,
// base_idx, windows, inv_freq, attn_norm, ffn_norm, q_norm, k_norm,
// out_norm, post_attn_norm, post_ffw_norm, kc, vc, logits, qkv, part,
// y_attn, act, y_ffn, barrier, prof), then the scores scratch f32 [H, S];
// ``dims`` the 12 ints L, D, F, A, Rq, V, S, H, Hkv, dk, dv, 0; ``scalars``
// eps, attn_scale, softcap, freq_scale, emb_mult. ``wptrs``: per phase (QKV
// [L, Rq, D], Wo [L, D, A], gate/up [L, 2F, D], down [L, D, F], logits) its
// quants (int8 [.., R, C], nibble pairs [.., R, C / 2], or for the logits
// the bf16 embedding [V, D]), its scales and its offsets f32
// [.., R, C / gs] (null where absent). ``winfo``: per phase its format
// (0 int8, 1 nibble, 2 bf16), group size, centering (1: Q4_0 nibbles,
// value u - 8) and scale bytes (4, or 2: a centered nibble phase's raw f16
// scales without offsets, rows padded to 16 bytes). ``plan``: the wrapper's
// tile plan (TilePlan: per phase the tile rows, then per phase the slab
// columns, then the stage bytes and the stage count), checked here. Returns
// the launch's cudaError_t.
int fused_decode_stream_step(void* const* ptrs, const int* dims, const float* scalars,
                             void* const* wptrs, const int* winfo, const int* plan, int grid,
                             void* stream) {
  return launch_whole((const void*)decode_step_stream_kernel, false, false, fused_decode_stream_grid,
                      g_smem_checked, ptrs, dims, scalars, wptrs, winfo, plan, grid, stream);
}

const char* fused_decode_stream_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
