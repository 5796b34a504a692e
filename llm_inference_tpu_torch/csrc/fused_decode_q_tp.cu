// The tensor-parallel whole single-token decode step of a Gemma-3 model
// over shards of its checkpoint's own group-scaled quants (lossless serve-q
// / serve-q4), for Hopper (sm_90a): every rank the mesh puts on this device
// runs as a group of blocks of one persistent cooperative launch.
//
// Replaces llm_inference_tpu/ops/pallas/fused_decode_q_tp.py::
// decode_step_megakernel_q_tp (_make_tp_kernel_q :199-461, _run_step_tp_q
// :463-575). It is fused_decode_tp.cu's step over the lossless format
// (lossless.cuh, the numerics of fused_decode_q.cu): rank r holds its q
// heads' QKV rows and every K/V row, its heads' Wo columns and its F / n
// down columns cut on whole groups (their group scales and offsets with
// them), its F / n gate/up rows, and V / n rows of the dense bf16 embedding.
// tp.cuh says how the ranks, barriers and all-reduces are laid out. The
// plain twin is ops/kernels/fused_decode_q_tp.py's decode_step_q_tp_plain.
//
// What bounds it on one H100: the bytes all ranks read, their shards (the
// 1B: ~1.4 GB in serve-q, ~1.05 GB in serve-q4, as the single-chip step)
// and n times the replicated K/V rows and live cache slots. On n distinct
// cards the bound would be per card, one shard each.

#include "lossless.cuh"
#include "tp.cuh"

namespace {

static_assert(sizeof(TpArgs<Lossless>) <= 4096, "a launch's parameters must fit in 4 KB");

int g_smem_checked = 0;

int tp_grid(int smem) {
  return cooperative_grid((const void*)decode_step_tp_kernel<Lossless>, smem);
}

}  // namespace

extern "C" {

int fused_decode_q_tp_grid(int smem) { return tp_grid(smem); }

// Shared memory a rank's blocks need for its dimensions (bytes).
int fused_decode_q_tp_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv,
                           int max_chunk) {
  Step p{};
  p.D = D; p.F = F; p.A = A; p.Rq = Rq; p.H = H; p.Hkv = Hkv; p.dk = dk; p.dv = dv;
  p.max_chunk = max_chunk;
  p.xsum_floats = imax(D, imax(A, F)) / 16;
  return (int)smem_layout(p).total;
}

int fused_decode_q_tp_min_chunk() { return kMinChunk; }

// Let the current device reach ``peer``'s memory. Returns a cudaError_t.
int fused_decode_q_tp_enable_peer(int peer) { return enable_peer(peer); }

// One decode step of the ranks on the current device. ``ptrs``: per rank
// (tp_dims[2] of them) the 22 step pointers of fused_decode_q_step over its
// cache replica, logits slice and scratch; ``wptrs``: per rank the 15
// weight pointers of fused_decode_q_step over its shards; ``dims``,
// ``scalars`` and ``winfo`` those of fused_decode_q_step with the rank's
// widths (F = F / n, A = Hl * dv, Rq = Rql, V = V / n, H = Hl); ``tp_ptrs``
// and ``tp_dims`` as in fused_decode_tp_step. Returns the launch's
// cudaError_t.
int fused_decode_q_tp_step(void* const* ptrs, const int* dims, const float* scalars,
                           void* const* wptrs, const int* winfo, void* const* tp_ptrs,
                           const int* tp_dims, void* stream) {
  TpArgs<Lossless> a{};
  if (!fill_tp(a.tp, tp_ptrs, tp_dims)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < a.tp.ranks_here; ++i) {
    fill_step(a.p[i], ptrs + 22 * i, dims, scalars);
    if (a.p[i].prof != nullptr) return (int)cudaErrorInvalidValue;
    if (int err = fill_lossless(a.p[i], a.fmt[i], wptrs + 15 * i, winfo)) return err;
  }
  if (!tp_shapes_ok(a.p[0], a.tp, true)) return (int)cudaErrorInvalidValue;
  return launch_tp(a, (int)smem_layout(a.p[0]).total, tp_grid, g_smem_checked, stream);
}

const char* fused_decode_q_tp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
