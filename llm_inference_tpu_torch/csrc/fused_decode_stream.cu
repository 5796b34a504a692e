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
// rounding points of the lossless step; lossless.cuh), for layers too wide
// for that kernel: D up to 5376, H * dv up to 4096, F up to 21504, up to four
// q heads per KV head and any number of KV heads, head_dim 128 or 256. The
// TPU kernel streams row tiles of each projection through two VMEM slots per
// part and copies each layer's K/V one layer ahead into VMEM, because a
// capacity layer does not fit in 128 MiB of VMEM (:11-33). None of that is
// copied: the weight stream, the grid barriers, the residual stream and the
// norms are decode_step.cuh's (one slab of rows a block and phase, streamed
// through a ring of three 36 KB TMA stages that runs ahead across phases and
// layers), K/V rows are read from device memory where they lie, and the
// logits are the bf16 tied-embedding rows streamed the same way.
//
// What differs from the whole-layer step, and why:
//   - the activation is read from shared memory, never held in registers (a
//     lane's registers hold 1536 columns; D is 3840 at 12B);
//   - a stream chunk holds few rows of a wide projection (a 12B serve-q down
//     row is 15360 int8 + 480 f32 scales = 17.3 KB, two a stage), so the
//     block's 16 warps split each row's columns between them and add their
//     partials in a fixed order; a whole-layer chunk holds more rows than
//     warps and gives each warp a row, as there;
//   - attention takes (KV head, slot range) work items over the blocks, so
//     all KV heads (8 at 12B, 16 at 27B) run in parallel, and keeps the
//     scores in a global [H, S] scratch (L2-resident) instead of shared
//     memory, so no cache length is bounded by shared memory; the per-warp
//     PV partials share one shared region with the QKV row and the GEMV
//     activation, which are dead by then;
//   - the K/V row of slot pos is written straight to the cache by block 0
//     (the attention blocks take it from shared memory), so no writeback
//     lags a layer: the reference's LLMI_STREAM_DEFER_WB, whose two layers'
//     writebacks share one semaphore (fused_decode_stream.py:588-664), has
//     no counterpart, and no per-parity synchronisation is owed.
// Every offset into the stacked weights (5.66 GB of 12B gate/up int8), the
// embedding (2.01 GB at 12B, 2.82 GB at 27B) and the caches is computed in
// 64 bits (decode_step.cuh issue_chunk; the cache and embedding rows here).
//
// What bounds it on the H100: bytes. A Gemma-3-12B step (48 layers, D 3840,
// F 15360) reads 10.76 G weights a step: in serve-q4 6.72 GB of nibbles and
// f32 scales plus the 2.01 GB bf16 embedding for the logits, 8.74 GB, 2.61 ms
// at 3.35 TB/s; in serve-q 14.1 GB, 4.22 ms. K/V at position 300 adds 59 MB.
// Its f32 FMAs (2 per weight) take 0.32 ms at the CUDA cores' 67 TFLOP/s.
// The design keeps the weight stream in flight through every phase (the
// ring runs ahead across barriers), streams scales and offsets with their
// rows, and splits wide rows over warps so a stage's compute stays short;
// what it leaves on the table (six grid barriers a layer, three 36 KB
// stages in flight per SM) is measured in PERF.md.

#include "lossless.cuh"

namespace {

// Shared-memory arrays of the stream step (byte offsets); ``work`` holds in
// turn the GEMV activation (bf16 [max(D, A, F)]), the QKV row (f32 [Rq]) and
// the attention's per-warp PV partials (f32 [kWarps, G, dv]).
struct StreamLayout {
  size_t x, tmp, work, red, stat, qb, kn, vn, xsum, wred, ring, bars, total;
};

__host__ __device__ inline StreamLayout stream_layout(const Step& p) {
  StreamLayout o;
  const int G = p.H / p.Hkv;
  const size_t work = imax(2 * imax(p.D, imax(p.A, p.F)), imax(4 * p.Rq, 4 * kWarps * G * p.dv));
  size_t off = 0;
  o.x = off;    off += align16(sizeof(float) * p.D);
  o.tmp = off;  off += align16(sizeof(float) * p.D);
  o.work = off; off += align16(work);
  o.red = off;  off += align16(sizeof(float) * 32);
  o.stat = off; off += align16(sizeof(float) * 2 * p.H);
  o.qb = off;   off += align16(2 * (size_t)p.H * p.dk);
  o.kn = off;   off += align16(2 * (size_t)p.Hkv * p.dk);
  o.vn = off;   off += align16(2 * (size_t)p.Hkv * p.dv);
  o.xsum = off; off += align16(sizeof(float) * p.xsum_floats);
  o.wred = off; off += align16(sizeof(float) * 2 * kWarps);
  o.ring = off; off += (size_t)kStages * kStageBytes;
  o.bars = off; off += align16(8 * kStages);
  o.total = off;
  return o;
}

struct StreamFmt {
  int fmt[5];      // per Kind: kI8, kNib or kBF16
  int gs[5];       // columns a group
  float bias[5];   // 8 for Q4_0's nibbles, else 0
  int has_off[5];
  float* scores;   // [H, S] attention scores, then probabilities
  float* wred;     // shared: [2, kWarps] split-row partials (set in the kernel)
};

__device__ __forceinline__ int kind_cols(const Step& p, int kind) {
  const int C[5] = {p.D, p.A, p.D, p.F, p.D};
  return C[kind];
}

// One warp's share of a weight row (n columns) . the activation hv in shared
// memory: the 512-column pieces part, part + split, ... of the row. Every
// lane returns the share.
template <int F>
__device__ __forceinline__ float row_share(const char* w, const float* sc, const float* of,
                                           const float* xs, const __nv_bfloat16* hv, int n,
                                           int gs, float bias, int part, int split) {
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int base = part * 512; base < n; base += split * 512) {
    const int c = base + lane * 16;
    const bool live = c < n;
    float pc = 0.f;
    if (live) {
      const uint4 a0 = *reinterpret_cast<const uint4*>(hv + c);
      const uint4 a1 = *reinterpret_cast<const uint4*>(hv + c + 8);
      const uint32_t aw[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float a[16];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        a[2 * e] = bf16_lo(aw[e]);
        a[2 * e + 1] = bf16_hi(aw[e]);
      }
      pc = piece<F>(w, c, a, bias);
    }
    acc += group_term<F>(pc, live, c, sc, of, xs, gs);
  }
  return warp_sum(acc);
}

// The share of chunk row rr (copy 1: gate/up's up row) of phase ``kind``.
__device__ float share(const Step& p, const Smem& s, const StreamFmt& f, const Seg& g, int kind,
                       int rr, int rows, const char* st, int copy, int part, int split) {
  const Part& pt = p.parts[kind];
  const size_t rrow = (size_t)copy * rows + rr;
  const char* q = st + g.plane_off[0] + rrow * pt.row_bytes[0];
  const float* sc = reinterpret_cast<const float*>(st + g.plane_off[1] + rrow * pt.row_bytes[1]);
  const float* of = f.has_off[kind]
      ? reinterpret_cast<const float*>(st + g.plane_off[2] + rrow * pt.row_bytes[2]) : nullptr;
  const int n = kind_cols(p, kind), gs = f.gs[kind];
  const float b = f.bias[kind];
  if (f.fmt[kind] == kNib) return row_share<kNib>(q, sc, of, s.xsum, s.hv, n, gs, b, part, split);
  if (f.fmt[kind] == kI8) return row_share<kI8>(q, sc, of, s.xsum, s.hv, n, gs, b, part, split);
  return row_share<kBF16>(q, sc, of, s.xsum, s.hv, n, gs, b, part, split);
}

// The activation's per-group sums, for the offset term.
__device__ void group_sums(const Step& p, Smem& s, const StreamFmt& f, int kind) {
  if (f.fmt[kind] == kBF16 || !f.has_off[kind]) return;
  const int C = kind_cols(p, kind), gs = f.gs[kind];
  for (int g = threadIdx.x; g < C / gs; g += kThreads) {
    float t = 0.f;
    for (int j = 0; j < gs; ++j) t += __bfloat162float(s.hv[g * gs + j]);
    s.xsum[g] = t;
  }
  __syncthreads();
}

// Consume this block's chunks of phase ``kind``. A chunk of at least kWarps
// rows gives each warp whole rows; a smaller one splits each row's columns
// over kWarps / rows warps, whose shares add up in a fixed order. emit(r, v0,
// v1) runs on one lane per row with the row's value (v1: the up row of
// gate/up). Each freed stage takes the chunk kStages ahead, as in consume().
template <class Emit>
__device__ void consume_rows(const Step& p, const Sched& sc, const Smem& s, const StreamFmt& f,
                             int& k, int kind, Emit&& emit) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Seg& g = sc.seg[kind];
  const bool pair = g.copies == 2;
  for (int j = 0; j < g.n; ++j, ++k) {
    mbar_wait(s.bars + k % kStages, (uint32_t)((k / kStages) & 1));
    const int row0 = g.r0 + j * g.ch;
    const int rows = min(g.ch, g.r1 - row0);
    const char* st = s.ring + (size_t)(k % kStages) * kStageBytes;
    if (rows >= kWarps) {
      for (int rr = warp; rr < rows; rr += kWarps) {
        const float v0 = share(p, s, f, g, kind, rr, rows, st, 0, 0, 1);
        const float v1 = pair ? share(p, s, f, g, kind, rr, rows, st, 1, 0, 1) : 0.f;
        if (lane == 0) emit(row0 + rr, v0, v1);
      }
    } else {
      const int split = kWarps / rows;
      const int rr = warp / split, part = warp % split;
      if (rr < rows) {
        const float v0 = share(p, s, f, g, kind, rr, rows, st, 0, part, split);
        const float v1 = pair ? share(p, s, f, g, kind, rr, rows, st, 1, part, split) : 0.f;
        if (lane == 0) {
          f.wred[warp] = v0;
          f.wred[kWarps + warp] = v1;
        }
      }
      __syncthreads();
      if (rr < rows && part == 0 && lane == 0) {
        float v0 = 0.f, v1 = 0.f;
        for (int i = 0; i < split; ++i) {
          v0 += f.wred[warp + i];
          v1 += f.wred[kWarps + warp + i];
        }
        emit(row0 + rr, v0, v1);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0 && k + kStages < sc.total) issue_chunk(p, sc, s, k + kStages);
  }
}

// q/k norms, RoPE and the new K/V row of layer ``l`` from the QKV scratch,
// then attention over [start, pos]: work item (KV head g, slot split sp) on
// block g + Hkv * sp, two passes around a grid barrier (none with one split),
// partials [split][H][max, sum, PV] in p.part; then every block combines them
// into bf16(attention output) [H * dv] in s.hv. ``m0``: the layer's first
// profile mark.
__device__ void stream_attention(const Step& p, Smem& s, const StreamFmt& f, int l, int pos,
                                 int m0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = p.H / p.Hkv;
  const int hdk = p.dk / 2;  // rotary pairs (d, d + hdk)
  for (int i = threadIdx.x; i < p.Rq; i += kThreads) s.qkv[i] = __ldcg(p.qkv + i);
  __syncthreads();
  for (int hh = warp; hh < p.H + p.Hkv; hh += kWarps) {  // q heads, then k heads
    float* v = s.qkv + hh * p.dk;
    const float* w = (hh < p.H ? p.q_norm : p.k_norm) + (size_t)l * p.dk;
    float ss = 0.f;
    for (int d = lane; d < p.dk; d += 32) ss += v[d] * v[d];
    const float r = rsqrtf(warp_sum(ss) / (float)p.dk + p.eps);
    for (int d = lane; d < p.dk; d += 32) v[d] = v[d] * r * w[d];
  }
  __syncthreads();
  {
    const float* fr = p.inv_freq + (size_t)p.base_idx[l] * hdk;
    for (int idx = threadIdx.x; idx < (p.H + p.Hkv) * hdk; idx += kThreads) {
      const int hh = idx / hdk, i = idx % hdk;
      const float* v = s.qkv + hh * p.dk;
      const float ang = (float)pos * fr[i] / p.freq_scale;
      const float c = cosf(ang), sn = sinf(ang);
      const float x0 = v[i], x1 = v[i + hdk];
      float r0 = x0 * c - x1 * sn, r1 = x0 * sn + x1 * c;
      if (hh < p.H) {
        r0 *= p.attn_scale;
        r1 *= p.attn_scale;
        s.qb[hh * p.dk + i] = __float2bfloat16_rn(r0);
        s.qb[hh * p.dk + i + hdk] = __float2bfloat16_rn(r1);
      } else {
        s.kn[(hh - p.H) * p.dk + i] = __float2bfloat16_rn(r0);
        s.kn[(hh - p.H) * p.dk + i + hdk] = __float2bfloat16_rn(r1);
      }
    }
    const float* vsrc = s.qkv + (p.H + p.Hkv) * p.dk;
    for (int i = threadIdx.x; i < p.Hkv * p.dv; i += kThreads) s.vn[i] = __float2bfloat16_rn(vsrc[i]);
  }
  __syncthreads();  // s.qkv is dead from here: s.pv (the same bytes) takes the PV partials
  const size_t krow = (size_t)p.Hkv * p.dk, vrow = (size_t)p.Hkv * p.dv;
  __nv_bfloat16* kl = p.kc + (size_t)l * p.S * krow;
  __nv_bfloat16* vl = p.vc + (size_t)l * p.S * vrow;
  if (blockIdx.x == 0) {  // the in-place cache write of slot pos
    for (int i = threadIdx.x; i < (int)krow; i += kThreads) kl[(size_t)pos * krow + i] = s.kn[i];
    for (int i = threadIdx.x; i < (int)vrow; i += kThreads) vl[(size_t)pos * vrow + i] = s.vn[i];
  }
  const int wl = p.windows[l];
  const int start = wl > 0 ? max(0, pos - wl + 1) : 0;
  const int n = pos - start + 1;
  const int max_splits = (int)gridDim.x / p.Hkv;
  const int chunk = max(kMinChunk, (n + max_splits - 1) / max_splits);
  const int splits = (n + chunk - 1) / chunk;
  const int g = (int)blockIdx.x % p.Hkv, sp = (int)blockIdx.x / p.Hkv;
  const bool active = sp < splits;
  const int j0 = start + sp * chunk;
  const int nj = active ? min(chunk, pos + 1 - j0) : 0;
  const bool lane_k = lane * 8 < p.dk, lane_v = lane * 8 < p.dv;  // dk, dv <= 256
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  float* sc = f.scores;  // [H, S]; this block's heads and slots only
  if (active) {
    // scores: a warp takes four slots at a time, its K loads all in flight
    for (int jj0 = warp * 4; jj0 < nj; jj0 += kWarps * 4) {
      uint4 kv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + jj0 + u;
        const __nv_bfloat16* kr = j == pos ? s.kn : kl + (size_t)j * krow;
        kv[u] = (jj0 + u < nj && lane_k)
                    ? *reinterpret_cast<const uint4*>(kr + g * p.dk + lane * 8) : zero;
      }
#pragma unroll
      for (int i = 0; i < kMaxGroup; ++i) {
        if (i >= G) break;
        const int h = g * G + i;
        const uint4 qv = lane_k ? *reinterpret_cast<const uint4*>(s.qb + h * p.dk + lane * 8) : zero;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float v = warp_sum(dot8(qv, kv[u]));
          if (p.softcap > 0.f) v = p.softcap * tanhf(v / p.softcap);
          if (lane == 0 && jj0 + u < nj) __stcg(sc + (size_t)h * p.S + j0 + jj0 + u, v);
        }
      }
    }
    __syncthreads();
    for (int i = warp; i < G; i += kWarps) {
      const int h = g * G + i;
      float m = -INFINITY;
      for (int jj = lane; jj < nj; jj += 32) m = fmaxf(m, __ldcg(sc + (size_t)h * p.S + j0 + jj));
      m = warp_max(m);
      if (lane == 0) {
        s.stat[p.H + h] = m;
        __stcg(p.part + ((size_t)sp * p.H + h) * (p.dv + 2), m);
      }
    }
    __syncthreads();
  }
  // The softmax uses the max over ALL live slots, as the TPU kernel does, so
  // every probability rounds to bf16 exactly as there and the splits combine
  // by plain sums. One split needs no exchange (every block agrees on it).
  mark(p, m0 + 3);
  if (splits > 1) grid_sync(p.barrier);
  mark(p, m0 + 4);
  if (active) {
    for (int i = warp; i < G; i += kWarps) {
      const int h = g * G + i;
      float m = -INFINITY;
      if (splits > 1) {
        for (int b = lane; b < splits; b += 32)
          m = fmaxf(m, __ldcg(p.part + ((size_t)b * p.H + h) * (p.dv + 2)));
        m = warp_max(m);
      } else {
        m = s.stat[p.H + h];
      }
      float* row = sc + (size_t)h * p.S + j0;
      float sum = 0.f;
      for (int jj = lane; jj < nj; jj += 32) {
        const float e = expf(__ldcg(row + jj) - m);
        __stcg(row + jj, e);
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) s.stat[h] = sum;
    }
    __syncthreads();
    // PV: a warp takes two slots at a time, each lane 8 dims of V (one
    // 16-byte load) for every q head of the group; the warps' partial sums
    // then add up in a fixed order
    float o[kMaxGroup][8];
#pragma unroll
    for (int i = 0; i < kMaxGroup; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) o[i][e] = 0.f;
    for (int jj0 = warp * 2; jj0 < nj; jj0 += kWarps * 2) {
      uint4 vv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + jj0 + u;
        const __nv_bfloat16* vr = j == pos ? s.vn : vl + (size_t)j * vrow;
        vv[u] = (jj0 + u < nj && lane_v)
                    ? *reinterpret_cast<const uint4*>(vr + g * p.dv + lane * 8) : zero;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (jj0 + u >= nj) break;
        const float vf[8] = {bf16_lo(vv[u].x), bf16_hi(vv[u].x), bf16_lo(vv[u].y),
                             bf16_hi(vv[u].y), bf16_lo(vv[u].z), bf16_hi(vv[u].z),
                             bf16_lo(vv[u].w), bf16_hi(vv[u].w)};
#pragma unroll
        for (int i = 0; i < kMaxGroup; ++i) {
          if (i >= G) break;
          const float pb = bf16r(__ldcg(sc + (size_t)(g * G + i) * p.S + j0 + jj0 + u));
#pragma unroll
          for (int e = 0; e < 8; ++e) o[i][e] = fmaf(pb, vf[e], o[i][e]);
        }
      }
    }
    if (lane_v) {
#pragma unroll
      for (int i = 0; i < kMaxGroup; ++i) {
        if (i >= G) break;
        float* dst = s.pv + ((size_t)warp * G + i) * p.dv + lane * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = o[i][e];
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < G * p.dv; idx += kThreads) {
      const int i = idx / p.dv, d = idx % p.dv;
      const int h = g * G + i;
      float acc = 0.f;
      for (int w = 0; w < kWarps; ++w) acc += s.pv[(size_t)w * G * p.dv + idx];
      float* pt = p.part + ((size_t)sp * p.H + h) * (p.dv + 2);
      __stcg(pt + 2 + d, acc);
      if (d == 0) __stcg(pt + 1, s.stat[h]);
    }
  }
  mark(p, m0 + 5);
  grid_sync(p.barrier);
  mark(p, m0 + 6);

  // ---- combine the attention partials ---------------------------------------
  for (int idx = threadIdx.x; idx < p.H * p.dv; idx += kThreads) {
    const int h = idx / p.dv, d = idx % p.dv;
    float num = 0.f, den = 0.f;
    for (int b = 0; b < splits; ++b) {
      const float* pb = p.part + ((size_t)b * p.H + h) * (p.dv + 2);
      den += __ldcg(pb + 1);
      num += __ldcg(pb + 2 + d);
    }
    s.hv[idx] = __float2bfloat16_rn(num / den);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) decode_step_stream_kernel(Step p, StreamFmt f) {
  extern __shared__ __align__(16) char smem_raw[];
  const StreamLayout o = stream_layout(p);
  Smem s{};
  s.x = (float*)(smem_raw + o.x);
  s.tmp = (float*)(smem_raw + o.tmp);
  s.hv = (__nv_bfloat16*)(smem_raw + o.work);
  s.qkv = (float*)(smem_raw + o.work);
  s.pv = (float*)(smem_raw + o.work);
  s.red = (float*)(smem_raw + o.red);
  s.stat = (float*)(smem_raw + o.stat);
  s.qb = (__nv_bfloat16*)(smem_raw + o.qb);
  s.kn = (__nv_bfloat16*)(smem_raw + o.kn);
  s.vn = (__nv_bfloat16*)(smem_raw + o.vn);
  s.xsum = (float*)(smem_raw + o.xsum);
  s.ring = smem_raw + o.ring;
  s.bars = (uint64_t*)(smem_raw + o.bars);
  f.wred = (float*)(smem_raw + o.wred);
  const long long tok64 = p.token[0];
  const int pos = p.pos[0];
  const int D = p.D, F = p.F;

  // A position outside the cache or a token outside the vocabulary would
  // read and write out of bounds: every block sees the same values and
  // leaves before the first barrier, and the logits come back NaN.
  if (pos < 0 || pos >= p.S || tok64 < 0 || tok64 >= p.V) {
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.V; i += gridDim.x * kThreads)
      p.logits[i] = __int_as_float(0x7fc00000);
    return;
  }

  // the weight stream starts before anything else
  __shared__ Sched sched_s;
  if (threadIdx.x == 0) {
    mark(p, 0);
    sched_s = make_sched(p);
    for (int i = 0; i < kStages; ++i) mbar_init(s.bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < kStages && k < sched_s.total; ++k) issue_chunk(p, sched_s, s, k);
  }
  __syncthreads();
  const Sched& sc = sched_s;
  int k = 0;  // next stream chunk, the same in every thread

  const __nv_bfloat16* emb = reinterpret_cast<const __nv_bfloat16*>(p.parts[kLogits].base[0]);
  for (int i = threadIdx.x; i < D; i += kThreads)
    s.x[i] = __bfloat162float(emb[(size_t)tok64 * D + i]) * p.emb_mult;
  __syncthreads();

  for (int l = 0; l < p.L; ++l) {
    const int m0 = 1 + l * kMarks;
    mark(p, m0);
    if (l > 0) residual_add(p, s, p.y_ffn, p.post_ffw_norm ? p.post_ffw_norm + (size_t)(l - 1) * D : nullptr);

    // ---- QKV ---------------------------------------------------------------
    norm_to_hv(p, s, p.attn_norm + (size_t)l * D);
    group_sums(p, s, f, kQKV);
    consume_rows(p, sc, s, f, k, kQKV, [&](int r, float v, float) { __stcg(p.qkv + r, v); });
    mark(p, m0 + 1);
    grid_sync(p.barrier);
    mark(p, m0 + 2);

    // ---- q/k norms, RoPE, new K/V row, attention -------------------------------
    stream_attention(p, s, f, l, pos, m0);

    // ---- Wo ------------------------------------------------------------------
    group_sums(p, s, f, kWo);
    consume_rows(p, sc, s, f, k, kWo, [&](int r, float v, float) { __stcg(p.y_attn + r, v); });
    mark(p, m0 + 7);
    grid_sync(p.barrier);
    mark(p, m0 + 8);

    // ---- residual, ffn_norm, gate/up + GeGLU ------------------------------------
    residual_add(p, s, p.y_attn, p.post_attn_norm ? p.post_attn_norm + (size_t)l * D : nullptr);
    norm_to_hv(p, s, p.ffn_norm + (size_t)l * D);
    group_sums(p, s, f, kGU);
    consume_rows(p, sc, s, f, k, kGU, [&](int r, float g, float u) {
      const float c = 0.7978845608028654f;
      const float a = 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g))) * u;
      __stcg(reinterpret_cast<unsigned short*>(p.act) + r,
             __bfloat16_as_ushort(__float2bfloat16_rn(a)));
    });
    mark(p, m0 + 9);
    grid_sync(p.barrier);
    mark(p, m0 + 10);

    // ---- down ------------------------------------------------------------------
    for (int i = threadIdx.x; i < F / 8; i += kThreads)
      reinterpret_cast<uint4*>(s.hv)[i] = __ldcg(reinterpret_cast<const uint4*>(p.act) + i);
    __syncthreads();
    group_sums(p, s, f, kDown);
    consume_rows(p, sc, s, f, k, kDown, [&](int r, float v, float) { __stcg(p.y_ffn + r, v); });
    mark(p, m0 + 11);
    grid_sync(p.barrier);
    mark(p, m0 + 12);
  }

  // ---- final norm, tied-embedding logits ---------------------------------------
  residual_add(p, s, p.y_ffn, p.post_ffw_norm ? p.post_ffw_norm + (size_t)(p.L - 1) * D : nullptr);
  norm_to_hv(p, s, p.out_norm);
  mark(p, 1 + p.L * kMarks);
  consume_rows(p, sc, s, f, k, kLogits, [&](int r, float v, float) { p.logits[r] = v; });
  mark(p, 2 + p.L * kMarks);
}

// Host side: the shapes the stream step takes.
inline bool stream_shapes_ok(const Step& p, int grid) {
  return !(p.Hkv < 1 || p.H % p.Hkv || p.D % 128 || p.F % 128 || p.A % 128 ||
           p.A != p.H * p.dv || grid < p.Hkv || (p.dk != 128 && p.dk != 256) ||
           (p.dv != 128 && p.dv != 256) || p.H / p.Hkv > kMaxGroup ||
           p.Rq != p.H * p.dk + p.Hkv * (p.dk + p.dv));
}

int g_smem_checked = 0;

}  // namespace

extern "C" {

int fused_decode_stream_grid(int smem) {
  return cooperative_grid((const void*)decode_step_stream_kernel, smem);
}

// Shared memory the kernel needs for these dimensions (bytes).
int fused_decode_stream_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv) {
  Step p{};
  p.D = D; p.F = F; p.A = A; p.Rq = Rq; p.H = H; p.Hkv = Hkv; p.dk = dk; p.dv = dv;
  p.xsum_floats = imax(D, imax(A, F)) / 16;
  return (int)stream_layout(p).total;
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
// (0 int8, 1 nibble, 2 bf16), group size and centering (1: Q4_0 nibbles,
// value u - 8). Returns the launch's cudaError_t.
int fused_decode_stream_step(void* const* ptrs, const int* dims, const float* scalars,
                             void* const* wptrs, const int* winfo, int grid, void* stream) {
  Step p{};
  fill_step(p, ptrs, dims, scalars);
  p.max_chunk = 0;
  p.xsum_floats = imax(p.D, imax(p.A, p.F)) / 16;
  StreamFmt fmt{};
  fmt.scores = (float*)ptrs[22];
  const int R[5] = {p.Rq, p.D, 2 * p.F, p.D, p.V};
  const int C[5] = {p.D, p.A, p.D, p.F, p.D};
  if (!stream_shapes_ok(p, grid) || fmt.scores == nullptr) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 5; ++k) {
    const int f = winfo[3 * k], gs = winfo[3 * k + 1];
    Part& pt = p.parts[k];
    fmt.fmt[k] = f;
    fmt.gs[k] = gs;
    fmt.bias[k] = winfo[3 * k + 2] ? 8.f : 0.f;
    fmt.has_off[k] = wptrs[3 * k + 2] != nullptr;
    if ((k == kLogits) != (f == kBF16) || f < 0 || f > kBF16 || wptrs[3 * k] == nullptr)
      return (int)cudaErrorInvalidValue;
    pt.base[0] = (const char*)wptrs[3 * k];
    pt.row_bytes[0] = f == kI8 ? C[k] : f == kNib ? C[k] / 2 : 2 * C[k];
    pt.n_planes = 1;
    if (f != kBF16) {
      if ((gs != 16 && gs != 32) || C[k] % (4 * gs) || wptrs[3 * k + 1] == nullptr)
        return (int)cudaErrorInvalidValue;
      const int gbytes = 4 * (C[k] / gs);  // a multiple of 16: the bulk copies need it
      pt.base[1] = (const char*)wptrs[3 * k + 1];
      pt.row_bytes[1] = gbytes;
      pt.n_planes = 2;
      if (fmt.has_off[k]) {
        pt.base[2] = (const char*)wptrs[3 * k + 2];
        pt.row_bytes[2] = gbytes;
        pt.n_planes = 3;
      }
    }
    int row = 0;
    for (int j = 0; j < pt.n_planes; ++j) {
      pt.layer_bytes[j] = k == kLogits ? 0 : (long long)R[k] * pt.row_bytes[j];
      row += pt.row_bytes[j];
    }
    if (row * (k == kGU ? 2 : 1) > kStageBytes) return (int)cudaErrorInvalidValue;
  }
  const int smem = (int)stream_layout(p).total;
  if (smem > g_smem_checked) {  // sets the dynamic shared-memory limit once per size
    if (fused_decode_stream_grid(smem) < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
    g_smem_checked = smem;
  }
  void* args[] = {&p, &fmt};
  cudaError_t err = cudaLaunchCooperativeKernel((void*)decode_step_stream_kernel, dim3(grid),
                                                dim3(kThreads), args, smem,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* fused_decode_stream_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
