// Tensor parallelism for the whole single-token decode steps on Hopper
// (sm_90a): n ranks, each a group of blocks of one persistent cooperative
// launch, run whole_step.cuh's body over their own weight shards and meet
// in the all-reduces of Wo's and the down projection's partial sums. The
// kernel and its launch (tp_step_kernel, launch_tp below) serve the rowq8
// step (fused_decode_tp.cu) and the lossless one (fused_decode_q_tp.cu):
// the format is the shards'.
//
// Replaces the collectives of llm_inference_tpu/ops/pallas/fused_decode_tp.py
// and fused_decode_q_tp.py (the broadcast-gather ``all_reduce`` over
// inter-chip DMA, fused_decode_tp.py:206-224, and the owner-only entry row,
// :239-262). The
// sharding is the TPU kernels': rank r holds its H / n q heads' QKV rows,
// every K/V row (K/V and the cache are replicated, so attention is local),
// its heads' Wo columns, F / n gate/up rows (zero-padded) and the matching
// down columns, and V / n embedding rows; the host side is
// ops/kernels/fused_decode_tp.py and fused_decode_q_tp.py.
//
// Design, for a card rather than a chip:
//   - Ranks as block groups. One cooperative launch covers every rank the
//     mesh puts on a device: block b runs rank rank_base + b / per_rank as
//     its block b % per_rank of per_rank. Two launches would not do on one
//     card: concurrent kernels are not guaranteed to be co-resident, and the
//     ranks spin on each other. Each rank has its own scratch, barrier and
//     K/V cache replica; a rank's Step, format and these parameters are
//     copied into shared memory at the start (the kernel's parameters hold
//     one of each per rank, and the rank's tensor maps, which the copies
//     read in place: up to 32764 bytes of parameters since CUDA 12.1).
//   - Per-rank barrier: the counting barrier over the rank's per_rank
//     blocks (its barrier word is the rank's), and every row partition and
//     attention split over the rank's blocks (TpView).
//   - All-reduce, the TPU kernel's broadcast-gather: every block writes its
//     rows of the rank's f32 [D] partial into row ``rank`` of slot e & 1 of
//     every rank's gather buffer [2][n][D]; the rank's barrier; its block 0
//     publishes flag (slot, rank) = e in every rank's flag array [2][n]
//     with a release store; every block waits until all n flags of its own
//     array read e (acquire loads), then reads the n rows with ld.global.cg
//     (never a stale L1 line) and sums them in rank order 0..n-1, as the
//     plain twin and jnp.sum(gbuf[slot], axis=0) do. Every rank's x is then
//     bit-identical, so the cache replicas stay bit-equal.
//   - e is the all-reduce's number, rising by one per all-reduce across
//     steps and launches: each rank keeps the next one in a device counter
//     (epoch, starting at 1 over zeroed flags), read by every block at the
//     start and written by the rank's block 0 at the end (after barriers
//     every block passed having read it), so a stale flag never equals the
//     awaited e and CUDA graphs over many steps need no host argument. Slots
//     alternate with e across step boundaries too. A rank writes slot s for
//     all-reduce e + 2 only after all n flags of e + 1, each published after
//     its rank's barrier, which every block of that rank reaches after
//     reading slot s for e: no rank overwrites a row a peer still reads.
//   - The entry row: only the owner of the token's embedding row
//     contributes it (times sqrt(D)), the others zeros; the same
//     all-reduce assembles it everywhere.
//   - Distinct cards (``sys``): one launch per device, the gather buffers and
//     flags of other devices through peer pointers, system-scope fences and
//     flags. No run has checked that leg: every measurement of this port has
//     one card.
//
// What bounds it on one H100: bytes, as the single-chip steps; the n ranks
// share the HBM and the SMs, and the all-reduces add a barrier and a flag
// round trip each (2L + 1 a step).

#pragma once

#include "whole_step.cuh"

namespace {

constexpr int kMaxRanks = 8;      // ranks of a mesh
constexpr int kMaxRanksHere = 4;  // ranks one launch covers (the parameters hold a Step each)

struct TpShared {
  float* gather[kMaxRanks];        // per rank: [2][n][D] f32, on the rank's device
  unsigned int* flags[kMaxRanks];  // per rank: [2][n], on the rank's device
  unsigned int* epoch;             // [ranks_here]: each rank's next all-reduce number
  int n, rank_base, ranks_here, per_rank, sys, Hg;  // Hg: the model's q heads
};

__device__ __forceinline__ void flag_store(unsigned int* f, unsigned int v, bool sys) {
  if (sys) asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(f), "r"(v) : "memory");
  else asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(f), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned int flag_load(const unsigned int* f, bool sys) {
  unsigned int v;
  if (sys) asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(f) : "memory");
  else asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(f) : "memory");
  return v;
}

// One rank's group of blocks (decode_step.cuh's view interface).
struct TpView {
  const TpShared* t;
  int rank, local;  // the rank, and its index among the launch's ranks
  unsigned int e;   // the next all-reduce's number

  __device__ int block() const { return (int)blockIdx.x - local * t->per_rank; }
  __device__ int blocks() const { return t->per_rank; }
  __device__ long long vocab(const Step& p) const { return (long long)p.V * t->n; }

  // the owner's embedding row (the local row tok - rank * V / n), zeros
  // elsewhere, all-reduced
  template <class Fmt>
  __device__ void embed(const Step& p, const Fmt& fmt, Smem& s, int tok) {
    const long long tl = tok - (long long)rank * p.V;
    if (tl >= 0 && tl < p.V) {
      fmt.embed(p, s, (int)tl);
    } else {
      for (int i = threadIdx.x; i < p.D; i += kThreads) s.x[i] = 0.f;
    }
    __syncthreads();
    if (block() == 0)
      for (int i = threadIdx.x; i < p.D; i += kThreads) put(p, nullptr, i, s.x[i]);
    reduce(p);
    for (int i = threadIdx.x; i < p.D; i += kThreads) s.x[i] = take(p, nullptr, i);
    taken();
  }

  __device__ void begin(const Step& p) const { count_sync_start(p.barrier, (unsigned)t->per_rank); }
  __device__ void sync(const Step& p) const { count_sync(p.barrier, (unsigned)t->per_rank); }

  __device__ void put(const Step& p, float*, int r, float v) const {
    const size_t off = ((size_t)(e & 1) * t->n + rank) * p.D + r;
    for (int d = 0; d < t->n; ++d) __stcg(t->gather[d] + off, v);
  }

  // the rank's barrier, then its flag to every rank, then every rank's flag
  __device__ void reduce(const Step& p) const {
    const bool sys = t->sys != 0;
    if (sys) __threadfence_system();  // this thread's rows on peer devices
    count_sync(p.barrier, (unsigned)t->per_rank);
    const int slot = e & 1, n = t->n;
    if (threadIdx.x == 0) {
      if (block() == 0) {
        if (sys) __threadfence_system();
        for (int d = 0; d < n; ++d) flag_store(t->flags[d] + slot * n + rank, e, sys);
      }
      const unsigned int* f = t->flags[rank] + slot * n;
      for (int r = 0; r < n; ++r)
        while (flag_load(f + r, sys) != e) {
        }
    }
    __syncthreads();
  }

  __device__ float take(const Step& p, const float*, int i) const {
    const float* g = t->gather[rank] + (size_t)(e & 1) * t->n * p.D + i;
    float acc = __ldcg(g);
    for (int r = 1; r < t->n; ++r) acc += __ldcg(g + (size_t)r * p.D);
    return acc;
  }
  __device__ void taken() { ++e; }

  __device__ void finish(const Step&) const {
    if (block() == 0 && threadIdx.x == 0) __stcg(t->epoch + local, e);
  }

  // the model's q heads per KV head, cut to this rank's heads; the first
  // KV head of the rank's heads
  __device__ int group(const Step& p) const {
    const int G = t->Hg / p.Hkv;
    return G < p.H ? G : p.H;
  }
  __device__ int groups(const Step& p) const { return p.H / group(p); }
  __device__ int kv0(const Step& p) const { return rank * p.H / (t->Hg / p.Hkv); }
};
// The launch's parameters: per rank its Step, format and plan, and tensor
// maps.
struct TpArgs {
  Maps maps[kMaxRanksHere];
  Step p[kMaxRanksHere];
  StreamFmt fmt[kMaxRanksHere];
  TpShared tp;
};

static_assert(sizeof(TpArgs) <= 32764, "a launch's parameters must fit in 32764 bytes");

__device__ __forceinline__ void copy_words(void* dst, const void* src, size_t bytes) {
  for (size_t i = threadIdx.x; i < bytes / 4; i += kThreads)
    static_cast<uint32_t*>(dst)[i] = static_cast<const uint32_t*>(src)[i];
}

// Block b runs rank rank_base + b / per_rank; its Step, format and the mesh's
// parameters are copied into shared memory first. kRow: the rowq8 step's
// instance (whole_step_body).
template <bool kRow>
__global__ void __launch_bounds__(kThreads, 1) tp_step_kernel(const __grid_constant__ TpArgs a) {
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
  TpView vw{&t_s, t_s.rank_base + local, local, __ldcg(t_s.epoch + local)};
  whole_step_body<kRow, false>(p_s, f_s, a.maps[local], vw);
}

// Host side: the parameters of a launch from the C entries' ``tp_ptrs``
// (gather[n], flags[n], epoch) and ``tp_dims`` (n, rank_base, ranks_here,
// per_rank, sys, Hg); false if they do not describe a mesh.
inline bool fill_tp(TpShared& t, void* const* tp_ptrs, const int* tp_dims) {
  t.n = tp_dims[0]; t.rank_base = tp_dims[1]; t.ranks_here = tp_dims[2];
  t.per_rank = tp_dims[3]; t.sys = tp_dims[4]; t.Hg = tp_dims[5];
  if (t.n < 2 || t.n > kMaxRanks || t.ranks_here < 1 || t.ranks_here > kMaxRanksHere ||
      t.rank_base < 0 || t.rank_base + t.ranks_here > t.n || t.per_rank < 1)
    return false;
  for (int d = 0; d < t.n; ++d) {
    t.gather[d] = (float*)tp_ptrs[d];
    t.flags[d] = (unsigned int*)tp_ptrs[t.n + d];
    if (t.gather[d] == nullptr || t.flags[d] == nullptr) return false;
  }
  t.epoch = (unsigned int*)tp_ptrs[2 * t.n];
  return t.epoch != nullptr;
}

// Host side: the shapes a rank's step needs: the model's head geometry
// (Hg q heads over Hkv KV heads of dk and dv), the rank's own widths, and
// its heads one n-th of the model's.
inline bool tp_shapes_ok(const Step& p, const TpShared& t) {
  const int G = p.Hkv > 0 ? t.Hg / p.Hkv : 0;
  return p.Hkv >= 1 && t.Hg % p.Hkv == 0 && G <= kMaxGroup && p.H * t.n == t.Hg &&
         (p.H % G == 0 || G % p.H == 0) && p.A == p.H * p.dv && p.V >= 1 && p.P == 0;
}

template <bool kRow>
int tp_grid(int smem) {
  return cooperative_grid((const void*)tp_step_kernel<kRow>, smem);
}

// Host side: one cooperative launch of the ranks the mesh puts on the
// current device, from the C entries' arrays: ``ptrs`` per rank (tp_dims[2]
// of them) the 23 step pointers of fill_whole over its cache replica, logits
// slice and scratch (the scores [H / n, S] last); ``wptrs`` per rank the 15
// weight pointers of fill_stream over its shards; ``dims``, ``scalars``,
// ``winfo`` and ``plan`` those of a single-chip step with the rank's widths
// (F = F / n padded, A = Hl * dv, Rq = Rql, V = V / n, H = Hl);
// ``tp_ptrs``: gather[n], flags[n], epoch; ``tp_dims``: n, rank_base,
// ranks_here, per_rank, sys, Hg (TpShared). ``checked``: the largest shared
// memory already checked. kRow: the rowq8 step's shards (fill_stream).
// Returns the launch's cudaError_t.
template <bool kRow>
int launch_tp(void* const* ptrs, const int* dims, const float* scalars,
                     void* const* wptrs, const int* winfo, const int* plan,
                     void* const* tp_ptrs, const int* tp_dims, int& checked, void* stream) {
  static TpArgs a;  // ~17 KB: kept off the host thread's stack
  a = TpArgs{};
  if (!fill_tp(a.tp, tp_ptrs, tp_dims)) return (int)cudaErrorInvalidValue;
  const int per_rank = a.tp.per_rank;
  for (int i = 0; i < a.tp.ranks_here; ++i) {
    Step& p = a.p[i];
    StreamFmt& f = a.fmt[i];
    if (int err = fill_whole(p, f, kRow, false, ptrs + 23 * i, dims, scalars, wptrs + 15 * i,
                             winfo, plan))
      return err;
    const int G = p.Hkv > 0 ? a.tp.Hg / p.Hkv : 0;
    f.G = G < p.H ? G : p.H;  // TpView::group
    // the profile marks are block 0's: rank 0's, where this launch holds it
    if ((p.prof != nullptr && a.tp.rank_base + i != 0) || !encode_maps(a.maps[i], p, f))
      return (int)cudaErrorInvalidValue;
  }
  const Step& p0 = a.p[0];
  if (!tp_shapes_ok(p0, a.tp) || !stream_shapes_ok(p0, a.fmt[0].G, per_rank))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)stream_layout(p0, a.fmt[0].G, a.fmt[0].plan.stage_bytes,
                                      a.fmt[0].plan.stages).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int grid = a.tp.ranks_here * per_rank;
  if (smem > checked) {  // sets the dynamic shared-memory limit once per size
    if (tp_grid<kRow>(smem) < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
    checked = smem;
  }
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)tp_step_kernel<kRow>, dim3(grid),
                                                dim3(kThreads), args, smem,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Host side: let the current device read and write ``peer``'s memory.
inline int enable_peer(int peer) {
  cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it
    return 0;
  }
  return (int)err;
}

}  // namespace
