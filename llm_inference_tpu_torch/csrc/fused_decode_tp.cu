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
// one [V] f32 buffer. The step is decode_step.cuh's decode_step_body over
// the rowq8 format (rowq8.cuh) and tp.cuh's rank view; tp.cuh says how the
// ranks, barriers and all-reduces are laid out on the card. The plain twin
// is ops/kernels/fused_decode_tp.py's decode_step_tp_plain.
//
// What bounds it on one H100: the bytes all ranks read, their shards (the
// 1B: ~1.0 GB, as the single-chip step) and n times the replicated K/V rows
// and live cache slots; ~0.3 ms at 3.35 TB/s. On n distinct cards the bound
// would be per card, one shard each.

#include "rowq8.cuh"
#include "tp.cuh"

namespace {

static_assert(sizeof(TpArgs<RowQ8>) <= 4096, "a launch's parameters must fit in 4 KB");

int g_smem_checked = 0;

int tp_grid(int smem) { return cooperative_grid((const void*)decode_step_tp_kernel<RowQ8>, smem); }

}  // namespace

extern "C" {

// Blocks of a cooperative launch on the current device (one per SM), 0 if
// the kernel cannot be resident with ``smem`` bytes of shared memory.
int fused_decode_tp_grid(int smem) { return tp_grid(smem); }

// Shared memory a rank's blocks need for its dimensions (bytes).
int fused_decode_tp_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv,
                         int max_chunk) {
  Step p{};
  p.D = D; p.F = F; p.A = A; p.Rq = Rq; p.H = H; p.Hkv = Hkv; p.dk = dk; p.dv = dv;
  p.max_chunk = max_chunk;
  return (int)smem_layout(p).total;
}

int fused_decode_tp_min_chunk() { return kMinChunk; }

// Let the current device reach ``peer``'s memory (the gather buffers, flags
// and logits of a mesh over distinct cards). Returns a cudaError_t.
int fused_decode_tp_enable_peer(int peer) { return enable_peer(peer); }

// One decode step of the ranks on the current device. ``ptrs``: per rank
// (tp_dims[2] of them) the 32 pointers of fused_decode_step, over the rank's
// shards, cache replica, logits slice and scratch; ``dims`` and ``scalars``
// those of fused_decode_step with the rank's widths (F the padded Flp, A =
// Hl * dv, Rq = Rql, V = V / n, H = Hl). ``tp_ptrs``: gather[n], flags[n],
// epoch; ``tp_dims``: n, rank_base, ranks_here, per_rank, sys, Hg (tp.cuh
// TpShared). Returns the launch's cudaError_t.
int fused_decode_tp_step(void* const* ptrs, const int* dims, const float* scalars,
                         void* const* tp_ptrs, const int* tp_dims, void* stream) {
  TpArgs<RowQ8> a{};
  if (!fill_tp(a.tp, tp_ptrs, tp_dims)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < a.tp.ranks_here; ++i) {
    fill_rowq8(a.p[i], a.fmt[i], ptrs + 32 * i, dims, scalars);
    if (a.p[i].prof != nullptr) return (int)cudaErrorInvalidValue;
  }
  if (!tp_shapes_ok(a.p[0], a.tp, true)) return (int)cudaErrorInvalidValue;
  return launch_tp(a, (int)smem_layout(a.p[0]).total, tp_grid, g_smem_checked, stream);
}

const char* fused_decode_tp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
