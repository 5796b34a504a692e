"""Whole-step decode: the CUDA kernel (csrc/fused_decode.cu) and its plain twin.

Replaces llm_inference_tpu/ops/pallas/fused_decode.py::decode_step_megakernel
for Gemma-3 and gemma4 checkpoints: one call runs the entire single-token
forward over the stacked per-row int8 weights and returns the
tied-embedding logits [V] (f32, final softcap left to the caller), writing
the token's bf16 K/V rows in place at slot ``pos`` of the stacked cache.
gemma4 (over ``stack_layers_gemma4``'s zero-padded stack) adds the TPU
kernel's static features: the per-layer-input prologue and epilogue,
shared-KV layers (which read ``hp.kv_source_layer``'s cache and write
none), the unweighted V norm and the per-layer ``out_scale``; it runs a
second instance of the kernel. The source notes in csrc/fused_decode.cu
and csrc/whole_step.cuh say what bounds it on the H100 and how the design
answers that: the body of every whole step of the port, which streams each
GEMV phase as row x column-slab tiles on the tensor cores
(csrc/tile_stream.cuh; a rowq8 tile is its int8 quants alone, the row's
scale applied to its finished sum), cut by ``fused_decode_stream.plan`` (a
pure function of the shapes, the formats and the grid) at first launch and
kept in the prepared scratch. This module also holds what every whole
step's launch shares: the constants (``prepare``), the plain twins' step
(``step_plain``) and the C entries' arrays (``launch_args``, ``step_dims``).

``decode_step`` launches the kernel for CUDA tensors (or raises) and runs
``decode_step_plain`` for CPU tensors. The token and the position are
one-element device tensors, so a decode loop never syncs the host per step.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...quant.device import DenseTensor, Q4Tensor, QuantTensor, check_f16_scales

launches = 0

KERNEL = "fused_decode"
_LANE = 128
_MAX_GROUP = 4  # q heads per KV head (csrc/decode_step.cuh kMaxGroup)
_MAX_COLS = 1536  # widest D and H * dv of the Gemma-3 instance (the 1B class)
_STATIC_SMEM = 1024  # kept for the kernel's static shared memory (its tile schedule)
PROFILE_MARKS = 13  # timestamps per layer (csrc/decode_step.cuh kMarks)
PROFILE_MARKS_G4 = 17  # the gemma4 instance's (kMarksG4): + gate, barrier, proj, barrier
# per weight class its format in the C entries (csrc/tile_stream.cuh kI8, kNib,
# kBF16; a per-row int8 QuantTensor, one group a row, is kI8R, 3)
_FMT = {QuantTensor: 0, Q4Tensor: 1, DenseTensor: 2}
_ROWQ8 = 3


def is_gemma4(w) -> bool:
    """The weights carry gemma4's per-layer inputs (the kernel's gemma4
    instance and the plain twin's gemma4 features)."""
    return w.token_embd_per_layer is not None


def decode_supported(hp, w) -> bool:
    """Whole-step kernel eligibility (llm_inference_tpu's
    ``megakernel_supported``, fused_decode.py:129-191, without its VMEM
    budget): stacked layers with per-row int8 weights everywhere, q/k norms,
    no ALiBi, uniform head dims of 128 or 256, at most four q heads per KV
    head, 128-aligned widths, and the step's shared memory with a ring of
    two full stages within a block's (``fits_shared_memory``). Gemma-3: D,
    H * dv <= 1536 (the 1B class; wider Gemma-3 layers are the capacity
    step's). gemma4 (``stack_layers_gemma4``'s stack): the per-layer-input
    weights, per-row int8 too (the per-layer embedding and the model
    projection included), P % 128 == 0 within D and F, and
    ``per_layer_model_proj`` of L * P rows."""
    from ...models.weights import LayerWeights

    lw = w.layers
    if not isinstance(lw, LayerWeights) or hp.architecture not in ("gemma3", "gemma4"):
        return False
    g4 = hp.architecture == "gemma4"
    if hp.f_max_alibi_bias > 0.0 or is_gemma4(w) != g4 or bool(hp.embedding_length_per_layer) != g4:
        return False
    parts = [lw.wqkv, lw.wo, lw.w_gate_up, lw.w_down, w.token_embd]
    if g4:
        parts += [lw.per_layer_inp_gate, lw.per_layer_proj, w.token_embd_per_layer,
                  w.per_layer_model_proj]
        if lw.per_layer_post_norm is None or w.per_layer_proj_norm is None:
            return False
    if not all(isinstance(p, QuantTensor) and p.groups == 1 for p in parts):
        return False  # a grouped weight would lose its group scales here
    if lw.q_norm is None or lw.k_norm is None:
        return False
    if hp.n_embd_head_k != hp.n_embd_head_k_swa or hp.n_embd_head_v != hp.n_embd_head_v_swa:
        return False
    D, F, A = hp.embedding_length, lw.w_down.cols, lw.wo.cols
    dk, dv = hp.n_embd_head_k, hp.n_embd_head_v
    if D % _LANE or F % _LANE or A % _LANE or dk not in (128, 256) or dv not in (128, 256):
        return False
    if not g4 and (D > _MAX_COLS or A > _MAX_COLS):
        return False
    if hp.n_head % hp.n_head_kv or hp.n_head // hp.n_head_kv > _MAX_GROUP:
        return False
    if A != hp.n_head * dv:
        return False
    if lw.w_gate_up.rows != 2 * F or lw.w_down.rows != D or lw.wo.rows != D:
        return False
    Rq = hp.n_head * dk + hp.n_head_kv * (dk + dv)
    if lw.wqkv.rows != Rq or not fits_shared_memory(hp, D=D, F=F, A=A, Rq=Rq):
        return False
    if not g4:
        return True
    P, L = hp.embedding_length_per_layer, hp.block_count
    if not all(0 <= hp.kv_source_layer(i) < hp.n_kv_layers for i in range(L)):
        return False  # a shared layer's source must be an owner layer
    if P % _LANE or P > min(D, F) or w.per_layer_model_proj.rows != L * P or \
            w.per_layer_model_proj.cols != D or w.token_embd_per_layer.cols != L * P:
        return False
    if lw.per_layer_inp_gate.rows != P or lw.per_layer_inp_gate.cols != D or \
            lw.per_layer_proj.rows != D or lw.per_layer_proj.cols != P:
        return False
    return True


def fits_shared_memory(hp, *, D: int, F: int, A: int, Rq: int) -> bool:
    """A single-chip whole step's shared memory (csrc/tile_stream.cuh
    ``stream_layout``) with a ring of two full 36 KB stages, the least a
    plan takes (``fused_decode_stream.plan``), within a block's 227 KB less
    the kernel's static arrays."""
    from .fused_decode_stream import _SMEM_LIMIT, _STAGE_BYTES, plan_smem

    H, Hkv = hp.n_head, hp.n_head_kv
    return plan_smem(D, F, A, Rq, H, Hkv, hp.n_embd_head_k, hp.n_embd_head_v, _STAGE_BYTES,
                     2) <= _SMEM_LIMIT - _STATIC_SMEM


def window_array(hp, swa_mask: bool) -> np.ndarray:
    """Per-layer sliding-window sizes [L] int32: hp.swa_window per layer
    when real SWA is on (LLMI_SWA_MASK=1), zeros otherwise."""
    return np.array([hp.swa_window(i) if swa_mask else 0
                     for i in range(hp.block_count)], dtype=np.int32)


@dataclasses.dataclass
class DecodeConsts:
    """Per-model constants of a decode step, built once: the rope base index
    per layer, the inverse-frequency rows per distinct base (f32, as
    llm_inference_tpu's ``_rope_tables`` computes them), the window array,
    and the kernel's inter-block scratch (CUDA only)."""

    base_idx: torch.Tensor  # [L] int32
    inv_freq: torch.Tensor  # [n_bases, dk // 2] f32
    windows: torch.Tensor   # [L] int32
    kv_src: torch.Tensor | None = None  # [L] int32, hp.kv_source_layer
    scratch: dict | None = None
    grid: int = 0
    max_seq: int = 0  # the longest cache the scratch serves


def prepare(hp, device, *, swa_mask: bool, max_seq: int = 0,
            kernel: str | None = KERNEL) -> DecodeConsts:
    """Build the step constants on ``device`` (and, on CUDA, the scratch of
    whole-step kernel ``kernel``, this module's or fused_decode_q's or
    fused_decode_stream's, for caches of up to ``max_seq`` slots; None: no
    scratch). A gemma4 ``hp`` takes this kernel's gemma4 instance."""
    L, dk = hp.block_count, hp.n_embd_head_k
    bases = sorted({hp.rope_base_for_layer(i) for i in range(L)})
    base_idx = torch.tensor([bases.index(hp.rope_base_for_layer(i)) for i in range(L)],
                            dtype=torch.int32)
    i = torch.arange(dk // 2, dtype=torch.float32)
    inv_freq = torch.stack([1.0 / torch.pow(torch.tensor(b, dtype=torch.float32), 2.0 * i / dk)
                            for b in bases])
    windows = torch.from_numpy(window_array(hp, swa_mask))
    kv_src = torch.tensor([hp.kv_source_layer(i) for i in range(L)], dtype=torch.int32)
    device = torch.device(device)
    consts = DecodeConsts(base_idx.to(device), inv_freq.to(device), windows.to(device),
                          kv_src.to(device))
    if kernel == KERNEL and hp.architecture == "gemma4":
        kernel = "fused_decode_g4"
    if device.type == "cuda" and kernel is not None:
        from .fused_decode_stream import tiled_scratch

        tiled_scratch(consts, hp, device, max_seq, kernel)
    return consts


def _rms(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v * torch.rsqrt(torch.mean(v * v, dim=-1, keepdim=True) + eps)


def _bf16r(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).float()


def _mixed_dot(h: torch.Tensor, qt_q: torch.Tensor, qt_s: torch.Tensor) -> torch.Tensor:
    """bf16 activation [..., C] x int8 rows [R, C] -> [..., R] f32, times row scales."""
    return (h @ qt_q.float().T) * qt_s[:, 0]


def _rowq8_dot(t, l, h: torch.Tensor) -> torch.Tensor:
    """The rowq8 GEMV of layer ``l`` of a stacked weight (of the whole
    weight for None)."""
    return _mixed_dot(h, t.q, t.scale) if l is None else _mixed_dot(h, t.q[l], t.scale[l])


def _rowq8_embed(emb, tok: int) -> torch.Tensor:
    return emb.q[tok].float() * emb.scale[tok, 0]


def decode_step_plain(hp, w, cache, token, pos, consts: DecodeConsts) -> torch.Tensor:
    """Plain torch version of the kernel, with the same rounding points."""
    return step_plain(hp, w, cache, token, pos, consts, _rowq8_dot, _rowq8_embed)


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _geglu(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    c = _f32(0.7978845608028654)
    return 0.5 * g * (1.0 + torch.tanh(c * (g + 0.044715 * g * g * g))) * u


def attention_plain(hp, lw, qkv: torch.Tensor, l: int, cache, p: int, consts: DecodeConsts,
                    Hq: int, kv0: int) -> torch.Tensor:
    """Layer ``l``'s attention from its QKV row ``qkv`` (``Hq`` q heads, then
    every K and V head), with the kernels' rounding points: q/k norms, RoPE
    (q times the attention scale, bf16), the new K/V row written at slot
    ``p`` of ``cache`` (not by a gemma4 shared-KV layer, which reads its
    source's rows), softmax over the live slots with bf16 probabilities in
    the PV dot. The ``Hq`` q heads are consecutive heads of the model, G =
    min(H / Hkv, Hq) of them a KV head, the first G reading KV head ``kv0``:
    every head on one chip (kv0 0), a rank's under tensor parallelism.
    Returns bf16(attention output) [Hq * dv] as f32."""
    Hkv, dk, dv, eps = hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v, hp.rms_eps
    G = min(hp.n_head // Hkv, Hq)  # the q heads of one KV head among these
    half = dk // 2
    q = _rms(qkv[: Hq * dk].reshape(Hq, dk), eps) * lw.q_norm[l]
    k = _rms(qkv[Hq * dk : (Hq + Hkv) * dk].reshape(Hkv, dk), eps) * lw.k_norm[l]
    v = qkv[(Hq + Hkv) * dk :].reshape(Hkv, dv)
    if hp.architecture == "gemma4":
        v = _rms(v, eps)  # the unweighted V norm
    ang = float(p) * consts.inv_freq[int(consts.base_idx[l])] / torch.tensor(
        hp.rope_freq_scale, dtype=torch.float32)
    cos, sin = torch.cos(ang), torch.sin(ang)

    def rope(t):
        t0, t1 = t[:, :half], t[:, half:]
        return torch.cat([t0 * cos - t1 * sin, t0 * sin + t1 * cos], dim=1)

    qb = _bf16r(rope(q) * _f32(hp.f_attention_scale))
    src = hp.kv_source_layer(l)  # a shared-KV layer reads its source's rows
    if hp.layer_has_kv(l):
        cache.k[l, p] = rope(k).to(cache.k.dtype)
        cache.v[l, p] = v.to(cache.v.dtype)
    wl = int(consts.windows[l])
    start = max(0, p - wl + 1) if wl > 0 else 0
    kk = cache.k[src, start : p + 1].float()  # [n, Hkv, dk]
    vv = cache.v[src, start : p + 1].float()
    outs = []
    for g in range(Hq // G):
        s = qb[g * G : (g + 1) * G] @ kk[:, kv0 + g].T  # [G, n]
        if hp.attn_soft_cap and hp.attn_soft_cap > 0.0:
            s = hp.attn_soft_cap * torch.tanh(s / hp.attn_soft_cap)
        pr = torch.exp(s - s.max(dim=1, keepdim=True).values)
        outs.append((_bf16r(pr) @ vv[:, kv0 + g]) / pr.sum(dim=1, keepdim=True))
    return _bf16r(torch.cat(outs, dim=0).reshape(Hq * dv))


def step_plain(hp, w, cache, token, pos, consts: DecodeConsts, dot, embed) -> torch.Tensor:
    """Plain torch version of a whole step with the kernels' rounding
    points, for either weight format: ``dot(weight, l, h)`` is the GEMV of
    layer ``l`` of a stacked weight (or of a whole weight, l None) on the
    bf16-rounded activation ``h``; ``embed(emb, tok)`` the token's row.
    gemma4 weights (``is_gemma4``) add the per-layer-input prologue and
    epilogue, shared-KV layers, the V norm and out_scale (fused_decode.py
    :283-325, :351-404, :459-475 of the TPU kernel)."""
    lw = w.layers
    L = lw.attn_norm.shape[0]
    D, H, eps, F = hp.embedding_length, hp.n_head, hp.rms_eps, lw.w_down.cols
    tok = int(token.reshape(-1)[0])
    p = int(pos.reshape(-1)[0])
    emb = w.token_embd
    x = embed(emb, tok) * _f32(math.sqrt(D))
    g4 = is_gemma4(w)
    if g4:
        P = hp.embedding_length_per_layer
        pl_emb = _rowq8_embed(w.token_embd_per_layer, tok) * _f32(math.sqrt(P))
        pl_proj = dot(w.per_layer_model_proj, None, _bf16r(x)) * _f32(1.0 / math.sqrt(D))
    for l in range(L):
        h = _bf16r(_rms(x, eps) * lw.attn_norm[l])
        attn = attention_plain(hp, lw, dot(lw.wqkv, l, h), l, cache, p, consts, H, 0)
        y = dot(lw.wo, l, attn)
        if lw.post_attn_norm is not None:
            y = _rms(y, eps) * lw.post_attn_norm[l]
        x = x + y
        h2 = _bf16r(_rms(x, eps) * lw.ffn_norm[l])
        gu = dot(lw.w_gate_up, l, h2)
        a = _bf16r(_geglu(gu[:F], gu[F:]))
        y3 = dot(lw.w_down, l, a)
        if lw.post_ffw_norm is not None:
            y3 = _rms(y3, eps) * lw.post_ffw_norm[l]
        x = x + y3
        if g4:
            sl = slice(l * P, (l + 1) * P)
            inp = (_rms(pl_proj[sl], eps) * w.per_layer_proj_norm + pl_emb[sl]) * _f32(
                1.0 / math.sqrt(2.0))
            a = _bf16r(_geglu(dot(lw.per_layer_inp_gate, l, _bf16r(x)), inp))
            x = x + _rms(dot(lw.per_layer_proj, l, a), eps) * lw.per_layer_post_norm[l]
        if lw.out_scale is not None:
            x = x * lw.out_scale[l, 0]
    h = _bf16r(_rms(x, eps) * w.output_norm)
    return dot(emb, None, h)


def _need(t: torch.Tensor, name: str, dtype, shape, device) -> torch.Tensor:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"decode_step kernel: {name} must be contiguous {dtype} "
                         f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")
    return t


def decode_step(hp, w, cache, token: torch.Tensor, pos: torch.Tensor,
                consts: DecodeConsts, profile: torch.Tensor | None = None) -> torch.Tensor:
    """One single-token decode step. ``token`` (int64) and ``pos`` (int32)
    are one-element tensors on the weights' device. Writes the K/V rows in
    place; returns logits [V] f32 (final softcap not applied).

    ``profile`` (kernel only): an int64 tensor of ``L * PROFILE_MARKS + 3``
    (gemma4: ``PROFILE_MARKS_G4``) that receives block 0's globaltimer (ns)
    at each phase boundary: kernel start; per layer its start, QKV done,
    barrier passed, scores done, barrier passed, PV done, barrier passed, Wo
    done, barrier passed, gate/up done, barrier passed, down done, barrier
    passed (gemma4: then per-layer gate done, barrier passed, per-layer
    proj done, barrier passed); logits start and end."""
    if not token.is_cuda:
        return decode_step_plain(hp, w, cache, token, pos, consts)
    global launches
    from .fused_decode_stream import launch_tiled

    logits = launch_tiled("fused_decode_g4" if is_gemma4(w) else KERNEL, hp, w, cache, token, pos,
                          consts, profile)
    launches += 1
    return logits


def launch_args(hp, w, cache, token: torch.Tensor, pos: torch.Tensor, consts: DecodeConsts,
                logits: torch.Tensor, profile: torch.Tensor | None):
    """The C entries' arrays of a whole step, checked: the 23 step tensors
    (with the scratch of ``consts``, the attention scores last), then
    gemma4's 7 (kv_src, out_scale, per_layer_proj_norm, per_layer_post_norm,
    the per-layer embedding's rows and row scales, the pl_proj scratch); per
    phase (QKV, Wo, gate/up, down, logits; gemma4: then
    per_layer_model_proj, the per-layer gate and proj) the 3 weight
    pointers (quants, scales, offsets: the row scales of a per-row int8
    weight, then None) and the 4 ints of format (``_FMT``, ``_ROWQ8``),
    group size, centering and scale bytes (2 for raw f16 group scales, else
    4). ``cache`` is the stacked [L, S, Hkv, d] cache
    (a flat one viewed so). The widths are those of ``hp`` and of the
    weights' own shapes, so a tensor-parallel rank passes its local ``hp``
    and shards (ops/kernels/fused_decode_tp.py)."""
    if consts.scratch is None:
        raise ValueError("decode step kernel: consts were prepared without CUDA scratch")
    dev = logits.device
    lw = w.layers
    L = lw.attn_norm.shape[0]
    D = hp.embedding_length
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
    S = cache.k.shape[1]
    f32, i32 = torch.float32, torch.int32
    pa, pf = lw.post_attn_norm, lw.post_ffw_norm
    sc = consts.scratch
    nb = consts.inv_freq.shape[0]
    g4 = is_gemma4(w)
    if profile is not None:
        _need(profile, "profile", torch.int64,
              (L * (PROFILE_MARKS_G4 if g4 else PROFILE_MARKS) + 3,), dev)
    # the stacked cache holds the layers that own K/V (gemma4: n_kv < L)
    step = [
        _need(token, "token", torch.int64, (1,), dev),
        _need(pos, "pos", i32, (1,), dev),
        _need(consts.base_idx, "base_idx", i32, (L,), dev),
        _need(consts.windows, "windows", i32, (L,), dev),
        _need(consts.inv_freq, "inv_freq", f32, (nb, dk // 2), dev),
        _need(lw.attn_norm, "attn_norm", f32, (L, D), dev),
        _need(lw.ffn_norm, "ffn_norm", f32, (L, D), dev),
        _need(lw.q_norm, "q_norm", f32, (L, dk), dev),
        _need(lw.k_norm, "k_norm", f32, (L, dk), dev),
        _need(w.output_norm, "output_norm", f32, (D,), dev),
        None if pa is None else _need(pa, "post_attn_norm", f32, (L, D), dev),
        None if pf is None else _need(pf, "post_ffw_norm", f32, (L, D), dev),
        _need(cache.k, "cache.k", torch.bfloat16, (hp.n_kv_layers, S, Hkv, dk), dev),
        _need(cache.v, "cache.v", torch.bfloat16, (hp.n_kv_layers, S, Hkv, dv), dev),
        logits, sc["qkv"], sc["part"], sc["y_attn"], sc["act"], sc["y_ffn"], sc["barrier"],
        profile, sc["scores"],
    ]
    parts = [("wqkv", lw.wqkv), ("wo", lw.wo), ("w_gate_up", lw.w_gate_up), ("w_down", lw.w_down),
             ("token_embd", w.token_embd)]
    if g4:
        if "pl_proj" not in sc:
            raise ValueError("decode_step kernel: consts were prepared for a Gemma-3 step")
        pe, os_ = w.token_embd_per_layer, lw.out_scale
        P = hp.embedding_length_per_layer
        step += [
            _need(consts.kv_src, "kv_src", i32, (L,), dev),
            None if os_ is None else _need(os_, "out_scale", f32, (L, 1), dev),
            _need(w.per_layer_proj_norm, "per_layer_proj_norm", f32, (P,), dev),
            _need(lw.per_layer_post_norm, "per_layer_post_norm", f32, (L, D), dev),
            _need(pe.q, "token_embd_per_layer.q", torch.int8, (pe.rows, L * P), dev),
            _need(pe.scale, "token_embd_per_layer.scale", f32, (pe.rows, 1), dev),
            sc["pl_proj"]]
        parts += [("per_layer_model_proj", w.per_layer_model_proj),
                  ("per_layer_inp_gate", lw.per_layer_inp_gate),
                  ("per_layer_proj", lw.per_layer_proj)]
    wts, info = [], []
    for name, t in parts:
        lead = () if name in ("token_embd", "per_layer_model_proj") else (L,)
        if isinstance(t, DenseTensor):
            wts += [_need(t.w, name, torch.bfloat16, (t.rows, t.cols), dev), None, None]
            info += [_FMT[DenseTensor], 0, 0, 4]
            continue
        q4 = isinstance(t, Q4Tensor)
        q = _need(t.packed, f"{name}.packed", torch.uint8, (*lead, t.rows, t.cols // 2), dev) \
            if q4 else _need(t.q, f"{name}.q", torch.int8, (*lead, t.rows, t.cols), dev)
        gshape = (*lead, t.rows, t.groups)
        h16 = t.scale.dtype == torch.float16  # raw f16 scales: centered nibbles, no offsets
        scale = (check_f16_scales(t, gshape, dev, f"decode_step kernel: {name}") if h16
                 else _need(t.scale, f"{name}.scale", f32, gshape, dev))
        wts += [q, scale,
                None if t.offset is None else _need(t.offset, f"{name}.offset", f32, gshape, dev)]
        rowq8 = not q4 and t.groups == 1
        info += [_ROWQ8, 0, 0, 4] if rowq8 else [_FMT[type(t)], t.group_size,
                                                 int(q4 and t.centered), 2 if h16 else 4]
    # tensor copies and 16-byte loads read these from their base; the
    # barrier's count is 64-bit
    if any(t is not None and t.data_ptr() % 16 for t in wts + [cache.k, cache.v]) \
            or sc["barrier"].data_ptr() % 8:
        raise ValueError("decode step kernel: weights and caches must start on a 16-byte "
                         "boundary, the barrier word on an 8-byte one")
    return step, wts, info


def step_dims(hp, w, cache, consts: DecodeConsts) -> tuple[list, list]:
    """The C entries' 12 ints (L, D, F, A, Rq, V, S, H, Hkv, dk, dv, P: 0 but
    for gemma4, which adds n_kv) and 5 floats (eps, attn_scale, softcap,
    freq_scale, sqrt(D); gemma4 adds sqrt(P), 1 / sqrt(D), 1 / sqrt(2)),
    from ``hp`` and the weights' own widths (a tensor-parallel rank's local
    ones, ops/kernels/fused_decode_tp.py); the cache within the prepared
    scores scratch (``consts.max_seq`` slots)."""
    lw = w.layers
    D, S = hp.embedding_length, cache.k.shape[1]
    if S > consts.max_seq:
        raise ValueError(f"decode step kernel: cache of {S} slots exceeds the prepared scratch "
                         f"({consts.max_seq})")
    g4 = is_gemma4(w)
    P = hp.embedding_length_per_layer if g4 else 0
    dims = [lw.attn_norm.shape[0], D, lw.w_down.cols, lw.wo.cols, lw.wqkv.rows, w.token_embd.rows,
            S, hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v, P]
    scalars = [hp.rms_eps, hp.f_attention_scale, hp.attn_soft_cap or 0.0, hp.rope_freq_scale,
               math.sqrt(D)]
    if g4:
        dims.append(hp.n_kv_layers)
        scalars += [math.sqrt(P), 1.0 / math.sqrt(D), 1.0 / math.sqrt(2.0)]
    return dims, scalars
