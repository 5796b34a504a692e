// The lossless whole decode step of a Gemma-3 model on Hopper (sm_90a): one
// persistent cooperative kernel over the checkpoint's own group-scaled
// quants (serve-q int8, serve-q4 nibble pairs; exact f32 group scales and
// Q4_K offsets) and the dense bf16 tied embedding, its GEMV phases streamed
// by tile_stream.cuh. Shared by the whole-layer lossless step
// (fused_decode_q.cu), its tensor-parallel counterpart (fused_decode_q_tp.cu,
// over tp.cuh's TpView) and the capacity step (fused_decode_stream.cu); the
// numerics are described in fused_decode_q.cu.
//
// The step's order, rounding points and residual stream are decode_step.cuh's
// (the norms and residual adds recomputed in every block, x in shared
// memory, fixed-order sums, six grid barriers a layer); what differs:
//   - every GEMV phase (QKV, Wo, gate/up, down and the logits over the bf16
//     embedding) is a stream of row x column-slab tiles on the tensor cores
//     (tile_stream.cuh), and the activation is read from shared memory;
//   - attention takes (KV group, slot range) work items over the view's
//     blocks, so every KV head of a wide model runs in parallel, and keeps
//     the scores in a global [H, S] scratch (L2-resident) instead of shared
//     memory, so no cache length is bounded by shared memory; the per-warp
//     PV partials share one shared region with the QKV row and the GEMV
//     activation, which are dead by then;
//   - the K/V row of slot pos is written straight to the cache by the view's
//     block 0 (the attention blocks take it from shared memory).
//   - the grid barriers are decode_step.cuh's counting barrier (the step's
//     barrier word is its own): one trip to L2 fewer a barrier.
// ``V`` is the view of the blocks that run the step (decode_step.cuh:
// SoloOf<CountBarrier>, the whole grid; tp.cuh's TpViewOf<CountBarrier>, one
// rank's group).

#pragma once

#include "tile_stream.cuh"

namespace {

// A block's attention work item under a layer window ``wl`` (0: none):
// (KV group gi, slot split sp) on the view's block gi + ngrp * sp, the live
// slots [start, pos] cut into ``splits`` ranges of ``chunk`` (at least
// kMinChunk), this block's range [j0, j0 + nj) (nj 0 past the last split).
struct AttnItem {
  int start, chunk, splits, gi, sp, j0, nj;
};

template <class V>
__device__ AttnItem attn_item(const Step& p, V& vw, int wl, int pos) {
  AttnItem it;
  const int ngrp = vw.groups(p), blk = vw.block();
  it.start = wl > 0 ? max(0, pos - wl + 1) : 0;
  const int n = pos - it.start + 1;
  const int max_splits = vw.blocks() / ngrp;
  it.chunk = max(kMinChunk, (n + max_splits - 1) / max_splits);
  it.splits = (n + it.chunk - 1) / it.chunk;
  it.gi = blk % ngrp;
  it.sp = blk / ngrp;
  it.j0 = it.start + it.sp * it.chunk;
  it.nj = it.sp < it.splits ? min(it.chunk, pos + 1 - it.j0) : 0;
  return it;
}

// q/k norms, RoPE and the new K/V row of layer ``l`` from the QKV scratch,
// then attention over [start, pos] (attn_item: ``wl`` the layer's window,
// ``base`` its rope base row): scores and each head's max over the block's
// slots (the warps' maxima in registers), the block's max to p.part, a
// barrier (none with one split), then the PV pass, which forms each
// probability exp(score - max) as it goes (bf16 in the product, f32 in the
// denominator); partials [split][H][max, sum, PV] in p.part; then every
// block combines them into bf16(attention output) [H * dv] in s.hv. Group
// gi's G q heads read KV head kv0 + gi (the view's). ``m0``: the layer's
// first profile mark.
template <class V>
__device__ void stream_attention(const Step& p, Smem& s, float* scores, int l, int wl, int base,
                                 int pos, int m0, V& vw) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = vw.group(p), kv0 = vw.kv0(p);
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
    // each rotary pair's angle once (every head turns by the same ones), in
    // s.tmp (free between residual adds)
    const float* fr = p.inv_freq + (size_t)base * hdk;
    for (int i = threadIdx.x; i < hdk; i += kThreads) {
      float sn, c;
      sincosf((float)pos * fr[i] / p.freq_scale, &sn, &c);
      s.tmp[i] = c;
      s.tmp[hdk + i] = sn;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < (p.H + p.Hkv) * hdk; idx += kThreads) {
      const int hh = idx / hdk, i = idx % hdk;
      const float* v = s.qkv + hh * p.dk;
      const float c = s.tmp[i], sn = s.tmp[hdk + i];
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
  if (vw.block() == 0) {  // the in-place cache write of slot pos
    for (int i = threadIdx.x; i < (int)krow; i += kThreads) kl[(size_t)pos * krow + i] = s.kn[i];
    for (int i = threadIdx.x; i < (int)vrow; i += kThreads) vl[(size_t)pos * vrow + i] = s.vn[i];
  }
  const AttnItem it = attn_item(p, vw, wl, pos);
  const int gi = it.gi, sp = it.sp, j0 = it.j0, nj = it.nj, splits = it.splits;
  const int kvh = kv0 + gi;
  const bool active = nj > 0;
  const bool lane_k = lane * 8 < p.dk, lane_v = lane * 8 < p.dv;  // dk, dv <= 256
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  float* sc = scores;  // [H, S]; this block's heads and slots only
  float* wmax = s.pv;  // [kWarps][kMaxGroup] the warps' maxima (s.pv is free until PV)
  if (active) {
    // scores: a warp takes four slots at a time, its K loads all in flight
    float wm[kMaxGroup];
#pragma unroll
    for (int i = 0; i < kMaxGroup; ++i) wm[i] = -INFINITY;
    for (int jj0 = warp * 4; jj0 < nj; jj0 += kWarps * 4) {
      uint4 kv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + jj0 + u;
        const __nv_bfloat16* kr = j == pos ? s.kn : kl + (size_t)j * krow;
        kv[u] = (jj0 + u < nj && lane_k)
                    ? *reinterpret_cast<const uint4*>(kr + kvh * p.dk + lane * 8) : zero;
      }
#pragma unroll
      for (int i = 0; i < kMaxGroup; ++i) {
        if (i >= G) break;
        const int h = gi * G + i;
        const uint4 qv = lane_k ? *reinterpret_cast<const uint4*>(s.qb + h * p.dk + lane * 8) : zero;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float v = warp_sum(dot8(qv, kv[u]));
          if (p.softcap > 0.f) v = p.softcap * tanhf(v / p.softcap);
          if (jj0 + u < nj) {
            if (lane == 0) __stcg(sc + (size_t)h * p.S + j0 + jj0 + u, v);
            wm[i] = fmaxf(wm[i], v);
          }
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kMaxGroup; ++i) wmax[warp * kMaxGroup + i] = wm[i];
    }
    __syncthreads();
    for (int i = warp; i < G; i += kWarps) {
      const int h = gi * G + i;
      const float m = warp_max(lane < kWarps ? wmax[lane * kMaxGroup + i] : -INFINITY);
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
  if (splits > 1) vw.sync(p);
  mark(p, m0 + 4);
  if (active) {
    if (splits > 1) {
      for (int i = warp; i < G; i += kWarps) {
        const int h = gi * G + i;
        float m = -INFINITY;
        for (int b = lane; b < splits; b += 32)
          m = fmaxf(m, __ldcg(p.part + ((size_t)b * p.H + h) * (p.dv + 2)));
        m = warp_max(m);
        if (lane == 0) s.stat[p.H + h] = m;
      }
      __syncthreads();
    }
    float mh[kMaxGroup];
#pragma unroll
    for (int i = 0; i < kMaxGroup; ++i) mh[i] = i < G ? s.stat[p.H + gi * G + i] : 0.f;
    // PV: a warp takes two slots at a time, each lane 8 dims of V (one
    // 16-byte load) for every q head of the group, with the slots' scores
    // loaded beside the V rows; the warps' partial sums then add up in a
    // fixed order
    float o[kMaxGroup][8], den[kMaxGroup];
#pragma unroll
    for (int i = 0; i < kMaxGroup; ++i) {
      den[i] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) o[i][e] = 0.f;
    }
    for (int jj0 = warp * 2; jj0 < nj; jj0 += kWarps * 2) {
      uint4 vv[2];
      float sv[2][kMaxGroup];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + jj0 + u;
        const bool live = jj0 + u < nj;
        const __nv_bfloat16* vr = j == pos ? s.vn : vl + (size_t)j * vrow;
        vv[u] = (live && lane_v) ? *reinterpret_cast<const uint4*>(vr + kvh * p.dv + lane * 8) : zero;
#pragma unroll
        for (int i = 0; i < kMaxGroup; ++i)
          sv[u][i] = (live && i < G) ? __ldcg(sc + (size_t)(gi * G + i) * p.S + j) : 0.f;
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
          const float e = expf(sv[u][i] - mh[i]);
          den[i] += e;
          const float pb = bf16r(e);
#pragma unroll
          for (int k = 0; k < 8; ++k) o[i][k] = fmaf(pb, vf[k], o[i][k]);
        }
      }
    }
    // the warps' denominators in s.qb (q is dead: at least 64 floats)
    float* wden = reinterpret_cast<float*>(s.qb);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kMaxGroup; ++i) wden[warp * kMaxGroup + i] = den[i];
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
      const int h = gi * G + i;
      float acc = 0.f;
      for (int w = 0; w < kWarps; ++w) acc += s.pv[(size_t)w * G * p.dv + idx];
      float* pt = p.part + ((size_t)sp * p.H + h) * (p.dv + 2);
      __stcg(pt + 2 + d, acc);
      if (d == 0) {
        float dn = 0.f;
        for (int w = 0; w < kWarps; ++w) dn += wden[w * kMaxGroup + i];
        __stcg(pt + 1, dn);
      }
    }
  }
  mark(p, m0 + 5);
  vw.sync(p);
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

// The whole step over the view ``vw``: f the format and plan, mp the tensor
// maps (a __grid_constant__ kernel parameter: the copies read them there).
template <class V>
__device__ void lossless_step_body(const Step& p, const StreamFmt& f, const Maps& mp, V vw) {
  extern __shared__ __align__(16) char smem_raw[];
  const StreamLayout o = stream_layout(p, f.G, f.plan.stage_bytes, f.plan.stages);
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
  char* ring = smem_raw + o.ring;
  ring += (1024 - (smem_u32(ring) & 1023)) & 1023;
  const Ring rg{ring, (uint64_t*)(smem_raw + o.bars), (float*)(smem_raw + o.rowsum)};
  const long long tok64 = p.token[0];
  const int pos = p.pos[0];
  const int D = p.D, F = p.F;

  // A position outside the cache or a token outside the vocabulary would
  // read and write out of bounds: every block sees the same values and
  // leaves before the first barrier, and the logits come back NaN.
  if (pos < 0 || pos >= p.S || tok64 < 0 || tok64 >= vw.vocab(p)) {
    for (int i = vw.block() * kThreads + threadIdx.x; i < p.V; i += vw.blocks() * kThreads)
      p.logits[i] = __int_as_float(0x7fc00000);
    return;
  }

  vw.begin(p);
  // the weight stream starts before anything else
  __shared__ TSched sched_s;
  if (threadIdx.x == kIssuer) init_stream(p, f, sched_s, rg, vw.block(), vw.blocks());
  __syncthreads();
  Cursor cur;  // an issuer's
  cur.plane = issuer_plane();
  if (cur.plane >= 0) start_stream(p, f, mp, sched_s, rg, cur);
  mark(p, 0);
  __syncthreads();
  const TSched& sc = sched_s;
  Slot k{0, 0u};  // next stream tile, the same in every thread

  vw.embed(p, f, s, (int)tok64);
  __syncthreads();

  for (int l = 0; l < p.L; ++l) {
    const int m0 = 1 + l * kMarks;
    mark(p, m0);
    const int wl = p.windows[l], base = p.base_idx[l];
    if (l > 0)
      residual_add(p, s, vw, p.y_ffn, p.post_ffw_norm ? p.post_ffw_norm + (size_t)(l - 1) * D : nullptr);

    // ---- QKV ---------------------------------------------------------------
    norm_to_hv(p, s, p.attn_norm + (size_t)l * D);
    group_sums(p, s, f, kQKV);
    consume_phase<false>(p, f, mp, sc, rg, cur, s, k, kQKV, [&](int r, float v, float) { __stcg(p.qkv + r, v); });
    mark(p, m0 + 1);
    vw.sync(p);
    mark(p, m0 + 2);

    // ---- q/k norms, RoPE, new K/V row, attention -------------------------------
    stream_attention(p, s, f.scores, l, wl, base, pos, m0, vw);

    // ---- Wo ------------------------------------------------------------------
    group_sums(p, s, f, kWo);
    consume_phase<false>(p, f, mp, sc, rg, cur, s, k, kWo, [&](int r, float v, float) { vw.put(p, p.y_attn, r, v); });
    mark(p, m0 + 7);
    vw.reduce(p);
    mark(p, m0 + 8);

    // ---- residual, ffn_norm, gate/up + GeGLU ------------------------------------
    residual_add(p, s, vw, p.y_attn, p.post_attn_norm ? p.post_attn_norm + (size_t)l * D : nullptr);
    norm_to_hv(p, s, p.ffn_norm + (size_t)l * D);
    group_sums(p, s, f, kGU);
    consume_phase<true>(p, f, mp, sc, rg, cur, s, k, kGU, [&](int r, float g, float u) {
      const float c = 0.7978845608028654f;
      const float a = 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g))) * u;
      __stcg(reinterpret_cast<unsigned short*>(p.act) + r,
             __bfloat16_as_ushort(__float2bfloat16_rn(a)));
    });
    mark(p, m0 + 9);
    vw.sync(p);
    mark(p, m0 + 10);

    // ---- down ------------------------------------------------------------------
    for (int i = threadIdx.x; i < F / 8; i += kThreads)
      reinterpret_cast<uint4*>(s.hv)[i] = __ldcg(reinterpret_cast<const uint4*>(p.act) + i);
    __syncthreads();
    group_sums(p, s, f, kDown);
    consume_phase<false>(p, f, mp, sc, rg, cur, s, k, kDown, [&](int r, float v, float) { vw.put(p, p.y_ffn, r, v); });
    mark(p, m0 + 11);
    vw.reduce(p);
    mark(p, m0 + 12);
  }

  // ---- final norm, tied-embedding logits ---------------------------------------
  residual_add(p, s, vw, p.y_ffn, p.post_ffw_norm ? p.post_ffw_norm + (size_t)(p.L - 1) * D : nullptr);
  norm_to_hv(p, s, p.out_norm);
  mark(p, 1 + p.L * kMarks);
  consume_phase<false>(p, f, mp, sc, rg, cur, s, k, kLogits, [&](int r, float v, float) { p.logits[r] = v; });
  mark(p, 2 + p.L * kMarks);
  vw.finish(p);
}

// Host side: one single-chip step of ``kernel`` (a __global__ (Step,
// StreamFmt, const __grid_constant__ Maps) running lossless_step_body over
// SoloOf<CountBarrier>) from the C entries' arrays: ``ptrs`` the 22 step pointers of
// fill_step, then the scores scratch f32 [H, S]; ``dims`` and ``scalars``
// those of fill_step (max_chunk unused); ``wptrs``, ``winfo`` and ``plan``
// those of fill_stream. ``grid_of(smem)``: the cooperative grid the kernel
// gets with ``smem`` bytes (0 if none); ``checked``: the largest size
// already checked. Returns the launch's cudaError_t.
inline int launch_lossless(const void* kernel, int (*grid_of)(int), int& checked,
                           void* const* ptrs, const int* dims, const float* scalars,
                           void* const* wptrs, const int* winfo, const int* plan, int grid,
                           void* stream) {
  Step p{};
  fill_step(p, ptrs, dims, scalars);
  p.max_chunk = 0;
  StreamFmt f{};
  f.scores = (float*)ptrs[22];
  f.G = p.Hkv > 0 ? p.H / p.Hkv : 0;
  if (p.Hkv < 1 || p.H % p.Hkv || !stream_shapes_ok(p, f.G, grid) || f.scores == nullptr)
    return (int)cudaErrorInvalidValue;
  if (int err = fill_stream(p, f, wptrs, winfo, plan)) return err;
  Maps maps;
  if (!encode_maps(maps, p, f)) return (int)cudaErrorInvalidValue;
  const int smem = (int)stream_layout(p, f.G, f.plan.stage_bytes, f.plan.stages).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > checked) {  // sets the dynamic shared-memory limit once per size
    if (grid_of(smem) < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
    checked = smem;
  }
  void* args[] = {&p, &f, &maps};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, smem,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Host side: the shared memory of a lossless step whose attention items hold
// G q heads, with a ring of ``stages`` stages of ``stage_bytes`` (bytes).
inline int lossless_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv, int G,
                         int stage_bytes, int stages) {
  Step p{};
  p.D = D; p.F = F; p.A = A; p.Rq = Rq; p.H = H; p.Hkv = Hkv; p.dk = dk; p.dv = dv;
  p.xsum_floats = imax(D, imax(A, F)) / 16;
  return (int)stream_layout(p, G, stage_bytes, stages).total;
}

}  // namespace
