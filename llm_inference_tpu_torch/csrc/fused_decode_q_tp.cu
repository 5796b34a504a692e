// The tensor-parallel whole single-token decode step of a Gemma-3 model
// over shards of its checkpoint's own group-scaled quants (lossless serve-q
// / serve-q4), for Hopper (sm_90a): every rank the mesh puts on this device
// runs as a group of blocks of one persistent cooperative launch.
//
// Replaces llm_inference_tpu/ops/pallas/fused_decode_q_tp.py::
// decode_step_megakernel_q_tp (_make_tp_kernel_q :199-461, _run_step_tp_q
// :463-575). It is the whole-layer lossless step (whole_step.cuh's body and
// tile_stream.cuh's weight stream, the numerics of fused_decode_q.cu) over
// tp.cuh's TpView, the ranks and all-reduces of fused_decode_tp.cu: rank r
// holds its q heads' QKV rows and every K/V row, its heads' Wo columns and
// its F / n down columns cut on whole groups (their group scales and
// offsets with them), its F / n gate/up rows, and V / n rows of the dense
// bf16 embedding.
// tp.cuh says how the ranks, barriers and all-reduces are laid out. Each
// rank streams its shards as tiles of the rank's plan (the single-chip
// plan's function over the rank's widths and blocks, from the wrapper); its
// attention work items are (its q heads' KV group, slot range). The plain
// twin is ops/kernels/fused_decode_q_tp.py's decode_step_q_tp_plain.
//
// What bounds it on one H100: the bytes all ranks read, their shards (the
// 1B: ~1.4 GB in serve-q, ~1.05 GB in serve-q4, as the single-chip step)
// and n times the replicated K/V rows and live cache slots. On n distinct
// cards the bound would be per card, one shard each.

#include "tp.cuh"

namespace {

int g_smem_checked = 0;

}  // namespace

extern "C" {

int fused_decode_q_tp_grid(int smem) { return tp_grid<false>(smem); }

// Shared memory a rank's blocks need for its dimensions, attention items of
// G q heads and a ring of ``stages`` stages of ``stage_bytes`` (bytes).
int fused_decode_q_tp_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv, int G,
                           int stage_bytes, int stages) {
  return whole_smem(D, F, A, Rq, H, Hkv, dk, dv, G, stage_bytes, stages);
}

// Let the current device reach ``peer``'s memory. Returns a cudaError_t.
int fused_decode_q_tp_enable_peer(int peer) { return enable_peer(peer); }

// One decode step of the ranks on the current device (tp.cuh launch_tp).
// ``ptrs``: per rank (tp_dims[2] of them) the 23 step pointers of
// fused_decode_q_step over its cache replica, logits slice and scratch (the
// scores [H / n, S] last); ``wptrs``: per rank the 15 weight pointers of
// fused_decode_q_step over its shards; ``dims``, ``scalars``, ``winfo`` and
// ``plan`` those of fused_decode_q_step with the rank's widths (F = F / n
// padded, A = Hl * dv, Rq = Rql, V = V / n, H = Hl); ``tp_ptrs`` and
// ``tp_dims`` as in fused_decode_tp_step. Returns the launch's cudaError_t.
int fused_decode_q_tp_step(void* const* ptrs, const int* dims, const float* scalars,
                           void* const* wptrs, const int* winfo, const int* plan,
                           void* const* tp_ptrs, const int* tp_dims, void* stream) {
  return launch_tp<false>(ptrs, dims, scalars, wptrs, winfo, plan, tp_ptrs, tp_dims,
                         g_smem_checked, stream);
}

const char* fused_decode_q_tp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
