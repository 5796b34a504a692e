// The tensor-parallel whole single-token decode step of a Gemma-3 model
// over shards of its checkpoint's own group-scaled quants (lossless serve-q
// / serve-q4), for Hopper (sm_90a): every rank the mesh puts on this device
// runs as a group of blocks of one persistent cooperative launch.
//
// Replaces llm_inference_tpu/ops/pallas/fused_decode_q_tp.py::
// decode_step_megakernel_q_tp (_make_tp_kernel_q :199-461, _run_step_tp_q
// :463-575). It is the whole-layer lossless step (lossless.cuh's body and
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

#include "lossless.cuh"
#include "tp.cuh"

namespace {

// The launch's parameters: per rank its Step, format and plan, and tensor
// maps (read in place by the copies, so they stay kernel parameters; a
// launch's parameters may take up to 32764 bytes since CUDA 12.1).
struct LosslessTpArgs {
  Maps maps[kMaxRanksHere];
  Step p[kMaxRanksHere];
  StreamFmt fmt[kMaxRanksHere];
  TpShared tp;
};

static_assert(sizeof(LosslessTpArgs) <= 32764, "a launch's parameters must fit in 32764 bytes");

// Block b runs rank rank_base + b / per_rank; its Step, format and the mesh's
// parameters are copied into shared memory first (tp.cuh).
__global__ void __launch_bounds__(kThreads, 1)
    decode_step_q_tp_kernel(const __grid_constant__ LosslessTpArgs a) {
  static_assert(sizeof(Step) % 4 == 0 && sizeof(StreamFmt) % 4 == 0 && sizeof(TpShared) % 4 == 0,
                "");
  __shared__ __align__(16) Step p_s;
  __shared__ __align__(16) StreamFmt f_s;
  __shared__ __align__(16) TpShared t_s;
  const int local = (int)blockIdx.x / a.tp.per_rank;
  copy_words(&p_s, &a.p[local], sizeof(Step));
  copy_words(&f_s, &a.fmt[local], sizeof(StreamFmt));
  copy_words(&t_s, &a.tp, sizeof(TpShared));
  __syncthreads();
  TpViewOf<CountBarrier> vw{&t_s, t_s.rank_base + local, local, __ldcg(t_s.epoch + local)};
  lossless_step_body(p_s, f_s, a.maps[local], vw);
}

int g_smem_checked = 0;

int tp_grid(int smem) { return cooperative_grid((const void*)decode_step_q_tp_kernel, smem); }

}  // namespace

extern "C" {

int fused_decode_q_tp_grid(int smem) { return tp_grid(smem); }

// Shared memory a rank's blocks need for its dimensions, attention items of
// G q heads and a ring of ``stages`` stages of ``stage_bytes`` (bytes).
int fused_decode_q_tp_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv, int G,
                           int stage_bytes, int stages) {
  return lossless_smem(D, F, A, Rq, H, Hkv, dk, dv, G, stage_bytes, stages);
}

// Let the current device reach ``peer``'s memory. Returns a cudaError_t.
int fused_decode_q_tp_enable_peer(int peer) { return enable_peer(peer); }

// One decode step of the ranks on the current device. ``ptrs``: per rank
// (tp_dims[2] of them) the 23 step pointers of fused_decode_q_step over its
// cache replica, logits slice and scratch (the scores [H / n, S] last);
// ``wptrs``: per rank the 15 weight pointers of fused_decode_q_step over its
// shards; ``dims``, ``scalars``, ``winfo`` and ``plan`` those of
// fused_decode_q_step with the rank's widths (F = F / n padded, A = Hl *
// dv, Rq = Rql, V = V / n, H = Hl); ``tp_ptrs`` and ``tp_dims`` as in
// fused_decode_tp_step. Returns the launch's cudaError_t.
int fused_decode_q_tp_step(void* const* ptrs, const int* dims, const float* scalars,
                           void* const* wptrs, const int* winfo, const int* plan,
                           void* const* tp_ptrs, const int* tp_dims, void* stream) {
  static LosslessTpArgs a;  // 10-11 KB: kept off the host thread's stack
  a = LosslessTpArgs{};
  if (!fill_tp(a.tp, tp_ptrs, tp_dims)) return (int)cudaErrorInvalidValue;
  const int per_rank = a.tp.per_rank;
  for (int i = 0; i < a.tp.ranks_here; ++i) {
    Step& p = a.p[i];
    StreamFmt& f = a.fmt[i];
    fill_step(p, ptrs + 23 * i, dims, scalars);
    p.max_chunk = 0;
    f.scores = (float*)ptrs[23 * i + 22];
    if (p.prof != nullptr || f.scores == nullptr || p.Hkv < 1) return (int)cudaErrorInvalidValue;
    const int G = a.tp.Hg / p.Hkv;
    f.G = G < p.H ? G : p.H;  // TpView::group
    if (int err = fill_stream(p, f, wptrs + 15 * i, winfo, plan)) return err;
    if (!encode_maps(a.maps[i], p, f)) return (int)cudaErrorInvalidValue;
  }
  const Step& p0 = a.p[0];
  if (!tp_shapes_ok(p0, a.tp, false) || !stream_shapes_ok(p0, a.fmt[0].G, per_rank))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)stream_layout(p0, a.fmt[0].G, a.fmt[0].plan.stage_bytes,
                                      a.fmt[0].plan.stages).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int grid = a.tp.ranks_here * per_rank;
  if (smem > g_smem_checked) {  // sets the dynamic shared-memory limit once per size
    if (tp_grid(smem) < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
    g_smem_checked = smem;
  }
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)decode_step_q_tp_kernel, dim3(grid),
                                                dim3(kThreads), args, smem,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* fused_decode_q_tp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
