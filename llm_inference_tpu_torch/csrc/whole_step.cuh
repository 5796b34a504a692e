// The body of every whole single-token decode step on Hopper (sm_90a): one
// persistent cooperative kernel over a Gemma-3 or gemma4 model, its GEMV
// phases streamed by tile_stream.cuh in the weight format each phase has:
// per-row int8 (the rowq8 steps: fused_decode.cu's Gemma-3 and gemma4
// instances, fused_decode_tp.cu), or the checkpoint's own group-scaled
// quants (lossless serve-q int8, serve-q4 nibble pairs; exact f32 group
// scales and Q4_K offsets) with the dense bf16 tied embedding (the lossless
// steps: fused_decode_q.cu, fused_decode_q_tp.cu, and the capacity step,
// fused_decode_stream.cu). Each source states its numerics.
//
// The step's order, rounding points and residual stream are decode_step.cuh's
// (the norms and residual adds recomputed in every block, x in shared
// memory, fixed-order sums, six grid barriers a layer, eight with gemma4's
// per-layer inputs); its parts:
//   - every GEMV phase (QKV, Wo, gate/up, down, the logits over the tied
//     embedding, gemma4's per_layer_model_proj, per-layer gate and proj) is
//     a stream of row x column-slab tiles on the tensor cores
//     (tile_stream.cuh), and the activation is read from shared memory;
//   - attention takes (KV group, slot range) work items over the view's
//     blocks, so every KV head runs in parallel, and keeps the scores in a
//     global [H, S] scratch (L2-resident) instead of shared memory, so no
//     cache length is bounded by shared memory; the per-warp PV partials
//     share one shared region with the QKV row and the GEMV activation,
//     which are dead by then;
//   - the K/V row of slot pos is written straight to the cache by the view's
//     block 0 (the attention blocks take it from shared memory); a gemma4
//     shared-KV layer writes none and reads its source layer's row back
//     with ld.global.cg (block 0 wrote it several grid barriers earlier);
//   - the grid barriers are decode_step.cuh's counting barrier (each step's
//     barrier word is its own): one trip to L2 fewer a barrier.
// ``V`` is the view of the blocks that run the step (decode_step.cuh: Solo,
// the whole grid; tp.cuh's TpView, one rank's group).

#pragma once

#include <type_traits>

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
// first profile mark. The block's scores stay in shared memory where its G
// heads' slots fit beside the residual stream, else they go to the global
// [H, S] scratch. kG4: the unweighted V norm, and a shared-KV layer
// (l >= q.n_kv) attends over layer q.kv_src[l]'s cache and writes none.
template <bool kG4, class V>
__device__ void stream_attention(const Step& p, Smem& s, const StreamFmt& f, int l, int wl,
                                 int base, int pos, int m0, V& vw) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = vw.group(p), kv0 = vw.kv0(p);
  const int hdk = p.dk / 2;  // rotary pairs (d, d + hdk)
  for (int i = threadIdx.x; i < p.Rq; i += kThreads) s.qkv[i] = __ldcg(p.qkv + i);
  __syncthreads();
  // q heads, then k heads (kG4: then the unweighted norm of each v head)
  const int n_norms = kG4 ? p.H + 2 * p.Hkv : p.H + p.Hkv;
  for (int hh = warp; hh < n_norms; hh += kWarps) {
    const bool vh = hh >= p.H + p.Hkv;
    const int n = vh ? p.dv : p.dk;
    float* v = vh ? s.qkv + (p.H + p.Hkv) * p.dk + (hh - p.H - p.Hkv) * p.dv : s.qkv + hh * p.dk;
    const float* w = vh ? nullptr : (hh < p.H ? p.q_norm : p.k_norm) + (size_t)l * p.dk;
    float ss = 0.f;
    for (int d = lane; d < n; d += 32) ss += v[d] * v[d];
    const float r = rsqrtf(warp_sum(ss) / (float)n + p.eps);
    for (int d = lane; d < n; d += 32) v[d] = w ? v[d] * r * w[d] : v[d] * r;
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
  const int src = kG4 ? f.g4.kv_src[l] : l;  // the cache this layer attends over
  const bool owner = !kG4 || l < f.g4.n_kv;  // a shared-KV layer writes no cache row
  __nv_bfloat16* kl = p.kc + (size_t)src * p.S * krow;
  __nv_bfloat16* vl = p.vc + (size_t)src * p.S * vrow;
  if (vw.block() == 0 && owner) {  // the in-place cache write of slot pos
    for (int i = threadIdx.x; i < (int)krow; i += kThreads) kl[(size_t)pos * krow + i] = s.kn[i];
    for (int i = threadIdx.x; i < (int)vrow; i += kThreads) vl[(size_t)pos * vrow + i] = s.vn[i];
  }
  if (!owner) {
    // the source layer's row at pos, written by block 0 before a grid
    // barrier that this block has passed since: read from L2
    const unsigned short* kq = reinterpret_cast<const unsigned short*>(kl + (size_t)pos * krow);
    const unsigned short* vq = reinterpret_cast<const unsigned short*>(vl + (size_t)pos * vrow);
    for (int i = threadIdx.x; i < (int)krow; i += kThreads) s.kn[i] = __ushort_as_bfloat16(__ldcg(kq + i));
    for (int i = threadIdx.x; i < (int)vrow; i += kThreads) s.vn[i] = __ushort_as_bfloat16(__ldcg(vq + i));
    __syncthreads();
  }
  const AttnItem it = attn_item(p, vw, wl, pos);
  const int gi = it.gi, sp = it.sp, j0 = it.j0, nj = it.nj, splits = it.splits;
  const int kvh = kv0 + gi;
  const bool active = nj > 0;
  const bool lane_k = lane * 8 < p.dk, lane_v = lane * 8 < p.dv;  // dk, dv <= 256
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // this block's scores, [i][jj] for its G heads and nj slots: in shared
  // memory (s.tmp, free until the next residual add) where they fit, which
  // keeps the PV pass's reads off L2; else in the global [H, S] scratch
  const bool in_smem = G * it.chunk <= p.D;
  float* sc = in_smem ? s.tmp : f.scores + (size_t)gi * G * p.S + j0;
  const int scs = in_smem ? it.chunk : p.S;  // a head's stride
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
            if (lane == 0) sc[(size_t)i * scs + jj0 + u] = v;
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
          sv[u][i] = (live && i < G) ? sc[(size_t)i * scs + jj0 + u] : 0.f;
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
// kRow: a rowq8 step (consume_phase); kG4 adds gemma4's features
// (decode_step.cuh), f.g4 its parameters.
template <bool kRow, bool kG4, class V>
__device__ void whole_step_body(const Step& p, const StreamFmt& f, const Maps& mp, V vw) {
  static_assert(!kG4 || std::is_same<V, Solo>::value, "the gemma4 step runs on one grid");
  constexpr int kM = kG4 ? kMarksG4 : kMarks;
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
  const G4Params& q = f.g4;
  const long long tok64 = p.token[0];
  const int tok = (int)tok64;
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

  vw.embed(p, f, s, tok);
  __syncthreads();

  if constexpr (kG4) {
    // ---- prologue: per_layer_model_proj over bf16(x0), / sqrt(D) ---------------
    x_to_hv(p, s);
    consume_phase<kRow, false>(p, f, mp, sc, rg, cur, s, k, kPLM, 0,
                         [&](int r, float v, float) { __stcg(q.pl_proj + r, v * q.pl_proj_mult); });
  }

  for (int l = 0; l < p.L; ++l) {
    const int m0 = 1 + l * kM;
    mark(p, m0);
    const int wl = p.windows[l], base = p.base_idx[l];
    if (!kG4 && l > 0)
      residual_add(p, s, vw, p.y_ffn, p.post_ffw_norm ? p.post_ffw_norm + (size_t)(l - 1) * D : nullptr);

    // ---- QKV ---------------------------------------------------------------
    norm_to_hv(p, s, p.attn_norm + (size_t)l * D);
    group_sums(p, s, f, kQKV);
    consume_phase<kRow, false>(p, f, mp, sc, rg, cur, s, k, kQKV, l,
                         [&](int r, float v, float) { __stcg(p.qkv + r, v); });
    mark(p, m0 + 1);
    vw.sync(p);
    mark(p, m0 + 2);

    // ---- q/k norms, RoPE, new K/V row, attention -------------------------------
    stream_attention<kG4>(p, s, f, l, wl, base, pos, m0, vw);

    // ---- Wo ------------------------------------------------------------------
    group_sums(p, s, f, kWo);
    consume_phase<kRow, false>(p, f, mp, sc, rg, cur, s, k, kWo, l,
                         [&](int r, float v, float) { vw.put(p, p.y_attn, r, v); });
    mark(p, m0 + 7);
    vw.reduce(p);
    mark(p, m0 + 8);

    // ---- residual, ffn_norm, gate/up + GeGLU ------------------------------------
    residual_add(p, s, vw, p.y_attn, p.post_attn_norm ? p.post_attn_norm + (size_t)l * D : nullptr);
    norm_to_hv(p, s, p.ffn_norm + (size_t)l * D);
    group_sums(p, s, f, kGU);
    consume_phase<kRow, true>(p, f, mp, sc, rg, cur, s, k, kGU, l, [&](int r, float g, float u) {
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
    consume_phase<kRow, false>(p, f, mp, sc, rg, cur, s, k, kDown, l,
                         [&](int r, float v, float) { vw.put(p, p.y_ffn, r, v); });
    mark(p, m0 + 11);
    vw.reduce(p);
    mark(p, m0 + 12);

    if constexpr (kG4) {
      // ---- the per-layer-input epilogue, out_scale -----------------------------
      // gate: bf16(GeLU(gate . bf16(x)) * inp) into act (free since down)
      residual_add(p, s, vw, p.y_ffn, p.post_ffw_norm ? p.post_ffw_norm + (size_t)l * D : nullptr);
      per_layer_input(p, q, s, l, tok);
      x_to_hv(p, s);
      consume_phase<kRow, false>(p, f, mp, sc, rg, cur, s, k, kPLG, l, [&](int r, float g, float) {
        const float c = 0.7978845608028654f;
        const float a = 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g))) * s.tmp[r];
        __stcg(reinterpret_cast<unsigned short*>(p.act) + r,
               __bfloat16_as_ushort(__float2bfloat16_rn(a)));
      });
      mark(p, m0 + 13);
      vw.sync(p);
      mark(p, m0 + 14);
      // proj: [D] into y_ffn (free since its residual add above)
      for (int i = threadIdx.x; i < p.P / 8; i += kThreads)
        reinterpret_cast<uint4*>(s.hv)[i] = __ldcg(reinterpret_cast<const uint4*>(p.act) + i);
      __syncthreads();
      consume_phase<kRow, false>(p, f, mp, sc, rg, cur, s, k, kPLJ, l,
                           [&](int r, float v, float) { __stcg(p.y_ffn + r, v); });
      mark(p, m0 + 15);
      vw.sync(p);
      mark(p, m0 + 16);
      residual_add(p, s, vw, p.y_ffn, q.pl_post_norm + (size_t)l * D);
      if (q.out_scale != nullptr) {
        const float os = q.out_scale[l];
        for (int i = threadIdx.x; i < D; i += kThreads) s.x[i] = s.x[i] * os;
        __syncthreads();
      }
    }
  }

  // ---- final norm, tied-embedding logits ---------------------------------------
  if (!kG4)
    residual_add(p, s, vw, p.y_ffn, p.post_ffw_norm ? p.post_ffw_norm + (size_t)(p.L - 1) * D : nullptr);
  norm_to_hv(p, s, p.out_norm);
  mark(p, 1 + p.L * kM);
  consume_phase<kRow, false>(p, f, mp, sc, rg, cur, s, k, kLogits, 0,
                       [&](int r, float v, float) { p.logits[r] = v; });
  mark(p, 2 + p.L * kM);
  vw.finish(p);
}

// Host side: the step and format of one single-chip launch from the C
// entries' arrays: ``ptrs`` the 22 step pointers of fill_step, then the
// scores scratch f32 [H, S] (gemma4: then kv_src [L] int32, out_scale [L]
// or null, per_layer_proj_norm [P], per_layer_post_norm [L, D], the
// per-layer embedding int8 [V, L * P] and its row scales [V], and the
// scratch pl_proj f32 [L * P]); ``dims`` and ``scalars`` those of
// fill_step (gemma4: then n_kv, and sqrt(P), 1 / sqrt(D), 1 / sqrt(2));
// ``wptrs``, ``winfo`` and ``plan`` those of fill_stream over the step's
// phases (gemma4's eight). Returns 0 or a cudaError_t.
inline int fill_whole(Step& p, StreamFmt& f, bool row, bool g4, void* const* ptrs,
                      const int* dims, const float* scalars, void* const* wptrs,
                      const int* winfo, const int* plan) {
  fill_step(p, ptrs, dims, scalars);
  f.scores = (float*)ptrs[22];
  f.G = p.Hkv > 0 ? p.H / p.Hkv : 0;
  if (g4) {
    G4Params& q = f.g4;
    q.kv_src = (const int*)ptrs[23];
    q.out_scale = (const float*)ptrs[24];
    q.pl_proj_norm = (const float*)ptrs[25];
    q.pl_post_norm = (const float*)ptrs[26];
    q.pl_emb_q = (const int8_t*)ptrs[27];
    q.pl_emb_s = (const float*)ptrs[28];
    q.pl_proj = (float*)ptrs[29];
    q.n_kv = dims[12];
    q.pl_emb_mult = scalars[5];
    q.pl_proj_mult = scalars[6];
    q.inv_sqrt2 = scalars[7];
    if (p.P < 128 || p.P % 128 || p.P > p.D || p.P > p.F || q.n_kv < 1 || q.n_kv > p.L ||
        q.kv_src == nullptr || q.pl_proj == nullptr || q.pl_emb_q == nullptr)
      return (int)cudaErrorInvalidValue;
  } else if (p.P != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.Hkv < 1 || f.scores == nullptr) return (int)cudaErrorInvalidValue;
  return fill_stream(p, f, g4 ? kKinds : 5, row, wptrs, winfo, plan);
}

// Host side: one single-chip step of ``kernel`` (a __global__ (Step,
// StreamFmt, Maps) running whole_step_body over Solo: a rowq8 instance
// where ``row``, gemma4's where ``g4``) from the C entries' arrays
// (fill_whole). ``grid_of(smem)``: the cooperative grid the kernel gets
// with ``smem`` bytes (0 if none); ``checked``: the largest size already
// checked. Returns the launch's cudaError_t.
inline int launch_whole(const void* kernel, bool row, bool g4, int (*grid_of)(int), int& checked,
                        void* const* ptrs, const int* dims, const float* scalars,
                        void* const* wptrs, const int* winfo, const int* plan, int grid,
                        void* stream) {
  Step p{};
  StreamFmt f{};
  if (int err = fill_whole(p, f, row, g4, ptrs, dims, scalars, wptrs, winfo, plan)) return err;
  if (p.H % p.Hkv || !stream_shapes_ok(p, f.G, grid)) return (int)cudaErrorInvalidValue;
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

// Host side: the shared memory of a step whose attention items hold G q
// heads, with a ring of ``stages`` stages of ``stage_bytes`` (bytes).
inline int whole_smem(int D, int F, int A, int Rq, int H, int Hkv, int dk, int dv, int G,
                      int stage_bytes, int stages) {
  Step p{};
  p.D = D; p.F = F; p.A = A; p.Rq = Rq; p.H = H; p.Hkv = Hkv; p.dk = dk; p.dv = dv;
  p.xsum_floats = imax(D, imax(A, F)) / 16;
  return (int)stream_layout(p, G, stage_bytes, stages).total;
}

}  // namespace
