// Ragged one-query decode attention for Hopper (sm_90a), over dense lanes
// or through a page table.
//
// Replaces llm_inference_tpu/ops/pallas/flash_decode.py::flash_decode
// (_kernel) and ::paged_flash_decode (_kernel, _kernel_dsplit): for each
// lane b and q head h, one query against the lane's slots
// [starts[b], lengths[b]):
//
//   s_j = softcap(q[b, h] . k[row(b, j), h / G])      (f32; softcap optional)
//   out[b, h] = sum_j softmax(s)_j v[row(b, j), h / G] (f32), 0 for an empty range
//
// q [B, H, Dk] f32 (already scaled), out [B, H, Dv] f32. GQA: G = H / Hkv q
// heads share a KV head. Where slot j of lane b lives is the one thing the
// two entries differ in, a template parameter of the same kernel:
//   dense:  caches [B, S, Hkv, D] bf16, row(b, j) = b * S + j;
//   paged:  pools [N, PAGE, Hkv, D] bf16, table [B, NB] int32,
//           row(b, j) = clamp(table[b, j / PAGE], 0, N - 1) * PAGE + j % PAGE,
//           over the first nb <= NB table blocks (the TPU kernel's nb_cap
//           grid bound: slots past nb * PAGE are not attended).
// PAGE is any positive run-time value; a range may span several pages. The
// TPU kernel's split-d pools ([N, PAGE, D / 128, 128] for one KV head) hold
// the same bytes as [N, PAGE, 1, D]; the port keeps that one layout. Page
// ids are clamped into the pool as the TPU kernel's index map clamps them
// (a parked lane's sentinel entries are never read: its range is empty).
//
// What bounds it on the H100: the bytes of the live K/V rows. At the 1B
// serving shapes (B = 32, one KV head of 256, lanes ragged up to 1000
// slots) that is 14.6 MB a call, 4.4 us at 3.35 TB/s, and ~58 MFLOP of f32
// FMA (under 1 us on the CUDA cores), if enough bytes are in flight. The
// TPU kernel walks a lane's blocks in order on one core, carrying the
// online softmax in VMEM; a CTA per 256-slot block with a few rows in
// flight a warp is bound by DRAM round trips instead (the longest lane's
// block sets the time). So the design is about bytes in flight, over all
// SMs, in one launch:
//   - Work units from a pure plan (ops/kernels/flash_decode.py ``plan``):
//     a CTA takes (range of ``rs`` slots, KV head, lane), rs a multiple of
//     32 picked from the shapes alone (never from lengths, so no host sync
//     and graph capture keeps working); ranges outside the lane's
//     [starts, lengths) exit at once.
//   - K and V in flight together: warp 0 issues bulk copies
//     (cp.async.bulk, completed on an mbarrier; K and V on separate
//     barriers) of each 32-slot tile into a ring of two tile stages before
//     the first score, one copy a run of rows that lie together: the whole
//     tile of a dense lane with one KV head, up to a page boundary through
//     the table, a row each with several KV heads. At the 1B shapes three
//     CTAs share an SM, up to ~190 KB in flight on it, the whole call's
//     bytes at once. Paged: the range's table entries are read once into
//     shared memory (one a page the range touches), then the copies go out.
//     q is loaded ahead of the copies, so it does not queue behind them.
//   - Scores with q in registers: a group of lanes (as many as K's 16-byte
//     chunks, rounded up to 8, 16 or 32: the SUB template parameter) takes
//     a K row, each lane one chunk (a row of more than 32 chunks, Dk above
//     256: each lane CPL = 2 chunks, ch and ch + 32, summed before the
//     shuffles), and walks 8 slots a warp, each K element serving four
//     heads at a time; a reduce-scatter over the group (SUB - 1 shuffles
//     for SUB (slot, head) sums) leaves one score a lane.
//   - Online softmax across the range's tiles (a warp a head), then P.V
//     with each thread owning 8 columns of V for every head over its slot
//     group (a group of V's 16-byte chunks rounded up to 8, 16, 32 or 64
//     threads: two slot groups at Dv 512); the groups' sums meet once a
//     range, in group order.
//   - Head dims up to 512 (Gemma 4's global heads): the 256-wide code is
//     the CPL = 1 instantiation, as it was; at 512 a stage of K and V is
//     64 KB, so shared memory holds one or two CTAs an SM, and the plan
//     counts them from its layout (ops/kernels/flash_decode.py ``plan``).
//   - One launch a call: a range with others in its lane writes its
//     (m, l, acc) partials and counts itself on the (lane, KV head)'s
//     arrival counter; the last to arrive combines the partials in range
//     order (deterministic: a second launch is bit-equal), writes out and
//     sets the counter back to 0. The counters belong to the caller's
//     stream (ops/kernels/_build.py ``stream_counters``), so calls on two
//     streams share none and a captured CUDA graph replays with them at 0.
//     A lane with one live range writes out directly.
// What holds it now (PERF.md): a range is a chain of short dependent
// phases (copies landing, scores, softmax, P.V, the arrival, the last
// range's combine of up to 16 partials), ~19 us at the 1B shapes against
// the 4.4 us bound; with no copies at all the same chain takes ~15 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;      // slots a tile: 8 a warp in the scores, a lane each in the softmax
constexpr int kMaxGroup = 8;   // q heads per KV head
constexpr int kMaxDim = 512;   // Dk, Dv
constexpr int kMaxRanges = 64;  // ranges a lane (the plan's cap)
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  return v;
}

// Reduce-scatter of N values over the N lanes of a group (lane bits below
// N): each step a lane keeps half its values (the upper half where its lane
// bit OFF is set) and adds its partner's; lane l ends with value l % N,
// summed over the group, in val[0]. Unrolled at compile time, so val stays
// in registers.
template <int OFF, int N>
__device__ __forceinline__ void reduce_scatter(float (&val)[N], int lane) {
  if constexpr (OFF >= 1) {
    const bool up = (lane & OFF) != 0;
#pragma unroll
    for (int k = 0; k < OFF; ++k) {
      const float send = up ? val[k] : val[k + OFF];
      const float keep = up ? val[k + OFF] : val[k];
      val[k] = keep + __shfl_xor_sync(0xFFFFFFFFu, send, OFF);
    }
    reduce_scatter<OFF / 2>(val, lane);
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

// The call's plan (the wrapper's, checked by the entry points) and the
// shared-memory layout it gives, in bytes from the base: the ring (each
// stage a K tile of kTile rows, then a V tile, rows as they lie in a lane),
// q (each head's 16-byte chunks of d, 8 floats in 48 bytes: a quarter-warp
// reads 8 chunks from 8 bank groups), the tile's p values, the softmax
// state, the combine's (m, l), the range's table entries and the barriers;
// the P.V slot groups' sums over the ring where they fit, else last.
struct Plan {
  int B, S, H, Hkv, Dk, Dv, G;
  int rs, nr, stages, ptab;
  int stage_bytes, g4;
  int q_off, p_off, st_off, red_off, w_off, tab_off, bar_off, need;
  float softcap;
  // paged addressing (page = 0: dense)
  const int* table;
  int nb_table, page, n_pages;
};

__host__ __device__ constexpr int align16(int v) { return (v + 15) / 16 * 16; }

// Fills the layout from the shapes and the wrapper's rs / nr / stages / ptab.
bool layout(Plan& p) {
  if (p.B < 1 || p.S < 1 || p.Hkv < 1 || p.H % p.Hkv != 0 || p.H / p.Hkv > kMaxGroup ||
      p.Dk < 8 || p.Dv < 8 || p.Dk > kMaxDim || p.Dv > kMaxDim || p.Dk % 8 || p.Dv % 8)
    return false;
  p.G = p.H / p.Hkv;
  if (p.rs < kTile || p.rs % kTile || p.nr != (p.S + p.rs - 1) / p.rs || p.nr > kMaxRanges ||
      p.stages < 1 || p.stages > 4 || p.ptab < 0)
    return false;
  p.stage_bytes = kTile * (p.Dk + p.Dv) * 2;
  p.g4 = (p.G + 3) / 4 * 4;
  const int ring = p.stages * p.stage_bytes;
  const int vsub = p.Dv / 8 > 32 ? 64 : p.Dv / 8 > 16 ? 32 : p.Dv / 8 > 8 ? 16 : 8;
  const int red = kThreads / vsub * p.G * p.Dv * 4;
  p.q_off = ring;
  p.p_off = p.q_off + p.G * (p.Dk / 8) * 48;
  p.st_off = p.p_off + kTile * p.g4 * 4;
  p.w_off = p.st_off + 3 * kMaxGroup * 4;
  p.tab_off = p.w_off + align16(2 * p.nr * p.G * 4);
  p.bar_off = p.tab_off + align16(p.ptab * 4);
  p.need = p.bar_off + 2 * p.stages * 8 + 16;
  p.red_off = red <= ring ? 0 : p.need;
  if (red > ring) p.need += red;
  return true;
}

template <bool PAGED>
__device__ __forceinline__ size_t row_of(const Plan& p, const int* tab, int b, int slot, int p0) {
  if (!PAGED) return (size_t)b * p.S + slot;
  return (size_t)tab[slot / p.page - p0] * p.page + slot % p.page;
}

// Warp 0 issues tile t's live rows [a, c) (absolute slots; tile base tb)
// into stage ``s``, one bulk copy of K and one of V a run of rows that lie
// together in memory: the whole tile in a dense lane with one KV head, up
// to a page boundary through the table, a row each with several KV heads.
// Lane i starts the run that begins at slot a + i, if one does.
template <bool PAGED>
__device__ __forceinline__ void issue_tile(const Plan& p, uint8_t* smem, const __nv_bfloat16* kc,
                                           const __nv_bfloat16* vc, const int* tab, int b, int g,
                                           int a, int c, int tb, int s, int p0, int lane) {
  uint64_t* kbar = reinterpret_cast<uint64_t*>(smem + p.bar_off) + s;
  uint64_t* vbar = kbar + p.stages;
  const int n = c - a;
  if (lane == 0) {
    // order the block's earlier generic-proxy reads of the stage before the copies
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect_tx(kbar, (uint32_t)(n * p.Dk * 2));
    mbar_expect_tx(vbar, (uint32_t)(n * p.Dv * 2));
  }
  __syncwarp();
  const int slot = a + lane;
  int run = 0;  // rows of the run starting at ``slot``
  if (lane < n) {
    if (p.Hkv > 1)
      run = 1;
    else if (!PAGED)
      run = lane == 0 ? n : 0;
    else if (lane == 0 || slot % p.page == 0)
      run = min(n - lane, p.page - slot % p.page);
  }
  if (run > 0) {
    const size_t row = row_of<PAGED>(p, tab, b, slot, p0) * p.Hkv + g;
    uint8_t* st = smem + s * p.stage_bytes;
    bulk_load(st + (slot - tb) * p.Dk * 2, kc + row * p.Dk, (uint32_t)(run * p.Dk * 2), kbar);
    bulk_load(st + kTile * p.Dk * 2 + (slot - tb) * p.Dv * 2, vc + row * p.Dv,
              (uint32_t)(run * p.Dv * 2), vbar);
  }
}

// grid (nr, Hkv, B), kThreads threads, p.need bytes of dynamic shared
// memory; SUB = the 16-byte chunks of Dk rounded up to 8, 16 or 32 (the
// lanes that share a K row in the scores), CPL = the chunks a lane takes
// (2 where Dk has more than 32), G4 = G rounded up to 4 or 8 (the P.V
// accumulators a thread holds). part: [B, Hkv, nr, G, Dv] accumulators,
// then [B, Hkv, nr, G, 2] (m, l); counters [B * Hkv].
template <int SUB, int CPL, int G4, bool PAGED>
__global__ void __launch_bounds__(kThreads, CPL == 2 ? 1 : G4 == 4 ? 4 : 3)  // G4 4: 128 registers
flash_decode_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ vc, const int* __restrict__ lengths,
                    const int* __restrict__ starts, float* __restrict__ out,
                    float* __restrict__ part, unsigned int* __restrict__ counters, const Plan p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int j = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = p.G, Dk = p.Dk, Dv = p.Dv;
  const int len = min(lengths[b], p.S);
  const int st = max(starts[b], 0);
  int r_lo = 0, r_hi = 0;  // the lane's live ranges
  if (st < len) {
    r_lo = st / p.rs;
    r_hi = (len - 1) / p.rs + 1;
  }
  float* o = out + ((size_t)b * p.H + g * G) * Dv;
  if (r_lo == r_hi) {  // an empty range: zeros, written by range 0
    if (j == 0)
      for (int i = tid; i < G * Dv; i += kThreads) o[i] = 0.f;
    return;
  }
  if (j < r_lo || j >= r_hi) return;
  const int base = j * p.rs;
  const int lo = max(base, st), hi = min(base + p.rs, len);
  const int t0 = (lo - base) / kTile, t1 = (hi - base - 1) / kTile + 1;  // live tiles
  const int p0 = PAGED ? lo / p.page : 0;

  float* ps = reinterpret_cast<float*>(smem + p.p_off);  // [kTile][g4] p values
  float* sm = reinterpret_cast<float*>(smem + p.st_off);  // m, l, alpha per head
  float* sl_ = sm + kMaxGroup;
  float* sa = sm + 2 * kMaxGroup;
  int* tab = reinterpret_cast<int*>(smem + p.tab_off);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  int* last = reinterpret_cast<int*>(bars + 2 * p.stages);

  // q of the group's G heads ([G, Dk] in global memory): loads issued ahead
  // of the K/V copies, so they do not queue behind them
  constexpr int kQ = kMaxGroup * CPL * 256 / 4 / kThreads;  // float4s a thread, at most
  const float4* qsrc = reinterpret_cast<const float4*>(q + ((size_t)b * p.H + g * G) * Dk);
  float4 qv[kQ];
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int i = tid + u * kThreads;
    if (i < G * Dk / 4) qv[u] = __ldg(qsrc + i);
  }
  if (warp == 0) {  // barriers, the range's table entries, the first stages' copies
    if (lane == 0) {
      for (int i = 0; i < 2 * p.stages; ++i) mbar_init(bars + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (PAGED) {
      const int ntab = (hi - 1) / p.page - p0 + 1;
      for (int e = lane; e < ntab; e += 32)
        tab[e] = min(max(__ldg(p.table + (size_t)b * p.nb_table + p0 + e), 0), p.n_pages - 1);
    }
    __syncwarp();
    for (int t = t0; t < min(t1, t0 + p.stages); ++t) {
      const int tb = base + t * kTile;
      issue_tile<PAGED>(p, smem, kc, vc, tab, b, g, max(lo, tb), min(hi, tb + kTile), tb,
                        (t - t0) % p.stages, p0, lane);
    }
  }
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int i = tid + u * kThreads;
    if (i < G * Dk / 4)
      *reinterpret_cast<float4*>(smem + p.q_off + (i / 2) * 48 + (i % 2) * 16) = qv[u];
  }
  if (tid < G) {
    sm[tid] = -INFINITY;
    sl_[tid] = 0.f;
  }
  __syncthreads();

  // scores: a group of SUB lanes takes a K row, lane ch its 16-byte chunks
  // ch + c * SUB of d, c < CPL (q of the chunk in registers, four heads at
  // a time); a warp walks 8 slots of the tile, PAR at once
  constexpr int PAR = 32 / SUB, STEPS = 8 / PAR;
  const int ch = lane % SUB, sub = lane / SUB;
  // P.V: thread owns 8 columns (chunk vch) of V for every head, over the
  // tile slots of its slot group vg (vg, vg + nvg, ...)
  const int vsub = Dv / 8 > 32 ? 64 : Dv / 8 > 16 ? 32 : Dv / 8 > 8 ? 16 : 8;
  const int nvg = kThreads / vsub;
  const int vch = tid % vsub, vg = tid / vsub;
  const bool pv = vch < Dv / 8;
  float acc[G4][8];
#pragma unroll
  for (int i = 0; i < G4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) % p.stages;
    const uint32_t par = (uint32_t)(((t - t0) / p.stages) & 1);
    const int tb = base + t * kTile;
    const int a = max(lo, tb) - tb, c = min(hi, tb + kTile) - tb;  // live tile slots
    const uint8_t* ks = smem + s * p.stage_bytes;
    const uint8_t* vs = ks + kTile * Dk * 2;
    mbar_wait(bars + s, par);
    for (int h0 = 0; h0 < G; h0 += 4) {
      float val[SUB];  // val[4 u + i]: step u's slot, head h0 + i, this lane's chunks
#pragma unroll
      for (int k = 0; k < SUB; ++k) val[k] = 0.f;
#pragma unroll
      for (int cp = 0; cp < CPL; ++cp) {
        const int cc = ch + cp * SUB;  // the chunk of d
        const bool cc_ok = cc < Dk / 8;
        const uint8_t* qs = smem + p.q_off + cc * 48;  // + head * (Dk / 8) * 48
        float qr[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float4 q0 = make_float4(0.f, 0.f, 0.f, 0.f), q1 = q0;
          if (cc_ok && h0 + i < G) {
            q0 = *reinterpret_cast<const float4*>(qs + (h0 + i) * (Dk / 8) * 48);
            q1 = *reinterpret_cast<const float4*>(qs + (h0 + i) * (Dk / 8) * 48 + 16);
          }
          qr[i][0] = q0.x; qr[i][1] = q0.y; qr[i][2] = q0.z; qr[i][3] = q0.w;
          qr[i][4] = q1.x; qr[i][5] = q1.y; qr[i][6] = q1.z; qr[i][7] = q1.w;
        }
#pragma unroll
        for (int u = 0; u < STEPS; ++u) {
          const int sl = warp * 8 + u * PAR + sub;
          uint4 kv = make_uint4(0u, 0u, 0u, 0u);
          if (cc_ok && sl >= a && sl < c)
            kv = *reinterpret_cast<const uint4*>(ks + (size_t)sl * Dk * 2 + cc * 16);
          const float kf[8] = {bf16_lo(kv.x), bf16_hi(kv.x), bf16_lo(kv.y), bf16_hi(kv.y),
                               bf16_lo(kv.z), bf16_hi(kv.z), bf16_lo(kv.w), bf16_hi(kv.w)};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float v = val[4 * u + i];
#pragma unroll
            for (int e = 0; e < 8; ++e) v = fmaf(qr[i][e], kf[e], v);
            val[4 * u + i] = v;
          }
        }
      }
      reduce_scatter<SUB / 2>(val, lane);  // lane ch: value ch over the row's chunks
      const int sl = warp * 8 + (ch / 4) * PAR + sub, h = h0 + ch % 4;
      if (h < G) {
        float v = val[0];
        if (p.softcap > 0.f) v = p.softcap * tanhf(v / p.softcap);
        ps[sl * p.g4 + h] = sl >= a && sl < c ? v : -INFINITY;
      }
    }
    __syncthreads();
    // online softmax: warp w takes heads w, w + 4, one slot a lane
    for (int i = warp; i < G; i += kThreads / 32) {
      const float sv = ps[lane * p.g4 + i];
      const float m_old = sm[i];
      const float m_new = fmaxf(m_old, warp_max(sv));  // finite: the tile has a live slot
      const float pe = expf(sv - m_new);               // 0 at -inf
      const float l = warp_sum(pe);
      ps[lane * p.g4 + i] = pe;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        sm[i] = m_new;
        sl_[i] = sl_[i] * alpha + l;
        sa[i] = alpha;
      }
    }
    mbar_wait(bars + p.stages + s, par);
    __syncthreads();
    if (pv) {
#pragma unroll
      for (int i = 0; i < G4; ++i) {
        if (i >= G) break;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] *= sa[i];
      }
      // the group's slots vg, vg + nvg, ... of the tile, four at a time with
      // their V and p loads issued together
      for (int u0 = 0; u0 * nvg < kTile; u0 += 4) {
        uint4 vv[4];
        float4 pp[4][G4 / 4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int sl = vg + (u0 + u) * nvg;
          const bool live = sl >= a && sl < c;
          vv[u] = live ? *reinterpret_cast<const uint4*>(vs + (size_t)sl * Dv * 2 + vch * 16)
                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
          for (int i4 = 0; i4 < G4 / 4; ++i4)  // p of a dead slot: 0 (heads past G: unused)
            pp[u][i4] = live ? *reinterpret_cast<const float4*>(ps + sl * p.g4 + 4 * i4)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float vf[8] = {bf16_lo(vv[u].x), bf16_hi(vv[u].x), bf16_lo(vv[u].y),
                               bf16_hi(vv[u].y), bf16_lo(vv[u].z), bf16_hi(vv[u].z),
                               bf16_lo(vv[u].w), bf16_hi(vv[u].w)};
#pragma unroll
          for (int i4 = 0; i4 < G4 / 4; ++i4) {
            const float pr[4] = {pp[u][i4].x, pp[u][i4].y, pp[u][i4].z, pp[u][i4].w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int e = 0; e < 8; ++e)
                acc[4 * i4 + i][e] = fmaf(pr[i], vf[e], acc[4 * i4 + i][e]);
          }
        }
      }
    }
    __syncthreads();  // the stage and p are consumed
    if (warp == 0 && t + p.stages < t1) {
      const int tn = base + (t + p.stages) * kTile;
      issue_tile<PAGED>(p, smem, kc, vc, tab, b, g, max(lo, tn), min(hi, tn + kTile), tn, s, p0,
                        lane);
    }
  }

  // the slot groups' sums, in group order (red may lie over the ring: every
  // copy has landed and been read)
  float* red = reinterpret_cast<float*>(smem + p.red_off);  // [nvg][G][Dv]
  if (pv) {
#pragma unroll
    for (int i = 0; i < G4; ++i) {
      if (i >= G) break;
      float4* r = reinterpret_cast<float4*>(red + (vg * G + i) * Dv + vch * 8);
      r[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      r[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  __syncthreads();
  const bool alone = r_hi - r_lo == 1;  // the lane's only range: out directly
  const size_t lane_head = (size_t)b * p.Hkv + g;
  const size_t n_acc = (size_t)p.B * p.Hkv * p.nr * G * Dv;
  float* pacc = part + lane_head * p.nr * G * Dv;  // + (r * G + i) * Dv + d
  float* pml = part + n_acc + lane_head * p.nr * G * 2;  // + (r * G + i) * 2
  for (int k = 4 * tid; k < G * Dv; k += 4 * kThreads) {  // four columns a thread
    const int i = k / Dv;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int v = 0; v < nvg; ++v) {
      const float4 r = *reinterpret_cast<const float4*>(red + v * G * Dv + k);
      sum.x += r.x; sum.y += r.y; sum.z += r.z; sum.w += r.w;
    }
    if (alone) {
      const float l = sl_[i];
      *reinterpret_cast<float4*>(o + k) = make_float4(sum.x / l, sum.y / l, sum.z / l, sum.w / l);
    } else {
      __stcg(reinterpret_cast<float4*>(pacc + (size_t)j * G * Dv + k), sum);
    }
  }
  if (alone) return;

  // partials, then the arrival; the last range combines them in range order
  if (tid < G) {
    __stcg(pml + ((size_t)j * G + tid) * 2, sm[tid]);
    __stcg(pml + ((size_t)j * G + tid) * 2 + 1, sl_[tid]);
  }
  // one thread's acquire-release count orders the block's stores (which
  // the barrier gave it) before the count, and the other ranges' stores
  // before the last block's reads
  __syncthreads();
  if (tid == 0) {
    unsigned int old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(counters + lane_head)
                 : "memory");
    *last = old == (unsigned)(r_hi - r_lo - 1);
  }
  __syncthreads();
  if (!*last) return;
  const int nl = r_hi - r_lo;
  float* wm = reinterpret_cast<float*>(smem + p.w_off);  // [nl][G] m
  float* wl = wm + p.nr * G;                              // [nl][G] l
  // each thread's columns, four at a time, kE groups of four a pass; the
  // first pass's first kB ranges load while (m, l) load
  constexpr int kB = 8, kE = 2;
  const float4* src0 = reinterpret_cast<const float4*>(pacc + (size_t)r_lo * G * Dv);
  const int step = G * Dv / 4;  // float4s a range
  float4 v[kB][kE];
  auto load = [&](int r, int pass) {
#pragma unroll
    for (int u = 0; u < kB; ++u)
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int k4 = tid + (pass * kE + e) * kThreads;
        v[u][e] = r + u < nl && k4 < step ? __ldcg(src0 + (size_t)(r + u) * step + k4)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
  };
  load(0, 0);
  for (int k = tid; k < nl * G; k += kThreads) {
    wm[k] = __ldcg(pml + ((size_t)r_lo * G + k) * 2);
    wl[k] = __ldcg(pml + ((size_t)r_lo * G + k) * 2 + 1);
  }
  __syncthreads();
  for (int i = warp; i < G; i += kThreads / 32) {  // each head's M over the ranges
    float m = -INFINITY;
    for (int r = lane; r < nl; r += 32) m = fmaxf(m, wm[r * G + i]);
    m = warp_max(m);
    if (lane == 0) sm[i] = m;
  }
  __syncthreads();
  // out = sum_r e^(m_r - M) acc_r / sum_r e^(m_r - M) l_r, both sums in
  // range order, each thread forming its weights itself
  for (int pass = 0; pass * kE * kThreads < step; ++pass) {
    float4 acc4[kE];
    float M[kE], L[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      acc4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      L[e] = 0.f;
      const int k4 = tid + (pass * kE + e) * kThreads;
      M[e] = k4 < step ? sm[4 * k4 / Dv] : 0.f;
    }
    for (int r = 0; r < nl; r += kB) {  // in range order
      if (r > 0 || pass > 0) load(r, pass);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int k4 = tid + (pass * kE + e) * kThreads;
        if (k4 >= step) break;
        const int i = 4 * k4 / Dv;
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          if (r + u >= nl) break;
          const float w = expf(wm[(r + u) * G + i] - M[e]);
          L[e] = fmaf(w, wl[(r + u) * G + i], L[e]);
          acc4[e].x = fmaf(w, v[u][e].x, acc4[e].x);
          acc4[e].y = fmaf(w, v[u][e].y, acc4[e].y);
          acc4[e].z = fmaf(w, v[u][e].z, acc4[e].z);
          acc4[e].w = fmaf(w, v[u][e].w, acc4[e].w);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int k4 = tid + (pass * kE + e) * kThreads;
      if (k4 >= step) break;
      const float4 a4 = acc4[e];
      const float l = L[e];
      reinterpret_cast<float4*>(o)[k4] = make_float4(a4.x / l, a4.y / l, a4.z / l, a4.w / l);
    }
  }
  if (tid == 0) counters[lane_head] = 0u;  // every range has arrived: ready for the next call
}

template <int SUB, int CPL, int G4, bool PAGED>
int launch_sub(const void* q, const void* kc, const void* vc, const void* lengths,
               const void* starts, void* out, void* part, void* counters, const Plan& p, int smem,
               cudaStream_t s) {
  static unsigned done = 0;  // devices whose shared-memory limit is raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < 32 && !((done >> dev) & 1u)) {
    err = cudaFuncSetAttribute(flash_decode_kernel<SUB, CPL, G4, PAGED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess) done |= 1u << dev;
  }
  if (err != cudaSuccess) return (int)err;
  flash_decode_kernel<SUB, CPL, G4, PAGED><<<dim3(p.nr, p.Hkv, p.B), kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), static_cast<const int*>(lengths),
      static_cast<const int*>(starts), static_cast<float*>(out), static_cast<float*>(part),
      static_cast<unsigned int*>(counters), p);
  return (int)cudaGetLastError();
}

template <int G4, bool PAGED>
int launch_g(const void* q, const void* kc, const void* vc, const void* lengths,
             const void* starts, void* out, void* part, void* counters, const Plan& p, int smem,
             cudaStream_t s) {
  if (p.Dk / 8 > 32)
    return launch_sub<32, 2, G4, PAGED>(q, kc, vc, lengths, starts, out, part, counters, p, smem,
                                        s);
  if (p.Dk / 8 > 16)
    return launch_sub<32, 1, G4, PAGED>(q, kc, vc, lengths, starts, out, part, counters, p, smem,
                                        s);
  if (p.Dk / 8 > 8)
    return launch_sub<16, 1, G4, PAGED>(q, kc, vc, lengths, starts, out, part, counters, p, smem,
                                        s);
  return launch_sub<8, 1, G4, PAGED>(q, kc, vc, lengths, starts, out, part, counters, p, smem, s);
}

template <bool PAGED>
int launch(const void* q, const void* kc, const void* vc, const void* lengths, const void* starts,
           void* out, void* part, void* counters, const Plan& p, int smem, cudaStream_t s) {
  if (p.G <= 4)
    return launch_g<4, PAGED>(q, kc, vc, lengths, starts, out, part, counters, p, smem, s);
  return launch_g<8, PAGED>(q, kc, vc, lengths, starts, out, part, counters, p, smem, s);
}

bool plan_ok(Plan& p, int smem, const void* part, const void* counters) {
  return layout(p) && smem >= p.need && smem <= kMaxSmem &&
         (p.nr == 1 || (part != nullptr && counters != nullptr));
}

}  // namespace

extern "C" {

// q f32 [B, H, Dk], kc bf16 [B, S, Hkv, Dk], vc bf16 [B, S, Hkv, Dv],
// lengths / starts int32 [B], out f32 [B, H, Dv]; all contiguous, K and V
// 16-byte aligned. The plan (ops/kernels/flash_decode.py ``plan``): ranges
// of ``rs`` slots (a multiple of 32), ``nr`` = ceil(S / rs) of them a lane,
// a ring of ``stages`` tiles, ``ptab`` table entries a range (0 here),
// ``smem`` bytes of dynamic shared memory. With nr > 1, ``part`` holds
// B * Hkv * nr * G * (Dv + 2) floats of scratch and ``counters`` B * Hkv
// zeroed arrival counters that no call on another stream uses (the kernel
// leaves them at 0). Returns the launch's cudaError_t.
int flash_decode_fwd(const void* q, const void* kc, const void* vc, const void* lengths,
                     const void* starts, void* out, void* part, void* counters, int B, int S,
                     int H, int Hkv, int Dk, int Dv, float softcap, int rs, int nr, int stages,
                     int ptab, int smem, void* stream) {
  Plan p{};
  p.B = B; p.S = S; p.H = H; p.Hkv = Hkv; p.Dk = Dk; p.Dv = Dv; p.softcap = softcap;
  p.rs = rs; p.nr = nr; p.stages = stages; p.ptab = ptab;
  if (!plan_ok(p, smem, part, counters)) return (int)cudaErrorInvalidValue;
  return launch<false>(q, kc, vc, lengths, starts, out, part, counters, p, smem,
                       static_cast<cudaStream_t>(stream));
}

// The same through a page table: kp bf16 [n_pages, page, Hkv, Dk], vp bf16
// [n_pages, page, Hkv, Dv], table int32 [B, nb_table]; the first nb <=
// nb_table blocks are walked (S = nb * page in the plan); a range touches
// at most ``ptab`` pages.
int paged_flash_decode_fwd(const void* q, const void* kp, const void* vp, const void* table,
                           const void* lengths, const void* starts, void* out, void* part,
                           void* counters, int B, int nb_table, int nb, int page, int n_pages,
                           int H, int Hkv, int Dk, int Dv, float softcap, int rs, int nr,
                           int stages, int ptab, int smem, void* stream) {
  if (page < 1 || nb < 1 || nb > nb_table || n_pages < 1 || (long long)nb * page > (1 << 30) ||
      ptab < (rs - 1) / page + 2)
    return (int)cudaErrorInvalidValue;
  Plan p{};
  p.B = B; p.S = nb * page; p.H = H; p.Hkv = Hkv; p.Dk = Dk; p.Dv = Dv; p.softcap = softcap;
  p.rs = rs; p.nr = nr; p.stages = stages; p.ptab = ptab;
  p.table = static_cast<const int*>(table);
  p.nb_table = nb_table; p.page = page; p.n_pages = n_pages;
  if (!plan_ok(p, smem, part, counters)) return (int)cudaErrorInvalidValue;
  return launch<true>(q, kp, vp, lengths, starts, out, part, counters, p, smem,
                      static_cast<cudaStream_t>(stream));
}

const char* flash_decode_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
