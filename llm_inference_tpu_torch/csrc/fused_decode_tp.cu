// The tensor-parallel whole single-token decode step of a Gemma-3 model
// over per-row int8 weight shards, for Hopper (sm_90a): every rank the mesh
// puts on this device runs as a group of blocks of one persistent
// cooperative launch.
//
// Replaces llm_inference_tpu/ops/pallas/fused_decode_tp.py::
// decode_step_megakernel_tp (_make_tp_kernel :173-435, _run_step_tp
// :437-545). Per rank it computes what the TPU kernel computes per device:
// the entry all-reduce of the owner's embedding row times sqrt(D); per
// layer rms -> QKV over the rank's Rql = Hl * dk + Hkv * (dk + dv) rows ->
// q/k norms -> RoPE -> the new K/V row into the rank's cache replica ->
// attention of its Hl heads (with windows) -> its Wo partial -> all-reduce
// #1 -> post-attention norm -> residual; rms -> its 2 * Flp gate/up rows ->
// GeLU-tanh * up -> its down partial -> all-reduce #2 -> post-FFN norm ->
// residual; then the final norm and its V / n logits rows, into its slice of
// one [V] f32 buffer. The step is the single-chip rowq8 step's (the body of
// whole_step.cuh over tile_stream.cuh's stream in the per-row int8 format,
// the contract of fused_decode.cu) over tp.cuh's rank view: each rank
// streams its shards as tiles of the rank's plan (the single-chip plan's
// function over the rank's widths and blocks, from the wrapper), and its
// attention work items are (its q heads' KV group, slot range). tp.cuh says
// how the ranks, barriers and all-reduces are laid out on the card. The
// plain twin is ops/kernels/fused_decode_tp.py's decode_step_tp_plain.
//
// What bounds it on one H100: the bytes all ranks read, their shards (the
// 1B: ~1.0 GB, as the single-chip step) and n times the replicated K/V rows
// and live cache slots; ~0.3 ms at 3.35 TB/s. On n distinct cards the bound
// would be per card, one shard each.

#include "tp.cuh"

namespace {

int g_smem_checked = 0;

}  // namespace

extern "C" {

// Blocks of a cooperative launch on the current device (one per SM), 0 if
// the kernel cannot be resident with ``smem`` bytes of shared memory.
int fused_decode_tp_grid(int smem) { return tp_grid<true>(smem); }

// Shared memory a rank's blocks need for its dimensions, attention items of
// G q heads and a ring of ``stages`` stages of ``stage_bytes`` (bytes).
int fused_decode_tp_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv, int G,
                         int stage_bytes, int stages) {
  return whole_smem(D, F, A, Rq, H, Hkv, dk, dv, G, stage_bytes, stages);
}

// Let the current device reach ``peer``'s memory (the gather buffers, flags
// and logits of a mesh over distinct cards). Returns a cudaError_t.
int fused_decode_tp_enable_peer(int peer) { return enable_peer(peer); }

// One decode step of the ranks on the current device (tp.cuh launch_tp):
// ``ptrs`` per rank the 23 pointers of fused_decode_step over its cache
// replica, logits slice and scratch; ``wptrs`` per rank the 15 weight
// pointers of fused_decode_step over its shards; ``dims``, ``scalars``,
// ``winfo`` and ``plan`` those of fused_decode_step with the rank's widths
// (F the padded Flp, A = Hl * dv, Rq = Rql, V = V / n, H = Hl); ``tp_ptrs``:
// gather[n], flags[n], epoch; ``tp_dims``: n, rank_base, ranks_here,
// per_rank, sys, Hg (tp.cuh TpShared). Returns the launch's cudaError_t.
int fused_decode_tp_step(void* const* ptrs, const int* dims, const float* scalars,
                         void* const* wptrs, const int* winfo, const int* plan,
                         void* const* tp_ptrs, const int* tp_dims, void* stream) {
  return launch_tp<true>(ptrs, dims, scalars, wptrs, winfo, plan, tp_ptrs, tp_dims,
                         g_smem_checked, stream);
}

const char* fused_decode_tp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
