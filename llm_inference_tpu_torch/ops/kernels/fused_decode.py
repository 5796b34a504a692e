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
second instance of the kernel, whose activations live in shared memory,
so D may exceed the Gemma-3 instance's 1536. The source notes in
csrc/fused_decode.cu and csrc/decode_step.cuh say what bounds it on the
H100 and how the persistent cooperative design answers that.

``decode_step`` launches the kernel for CUDA tensors (or raises) and runs
``decode_step_plain`` for CPU tensors. The token and the position are
one-element device tensors, so a decode loop never syncs the host per step.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ...quant.device import QuantTensor
from . import _build

launches = 0

_LANE = 128
_MAX_GROUP = 4  # q heads per KV head (csrc/fused_decode.cu kMaxGroup)
_MAX_REG_COLS = 1536  # widest row whose activation a lane holds in registers
_STAGE_BYTES = 36864  # one weight-stream stage: the widest row (csrc kStageBytes)
_STAGES, _WARPS, _MIN_CHUNK = 3, 16, 64  # csrc kStages, kWarps, kMinChunk
_SMEM_LIMIT = 232448 - 1024  # a block's shared memory, less the static Sched
_PTR_FIELDS = 32
_PTR_FIELDS_G4 = 45
PROFILE_MARKS = 13  # timestamps per layer (csrc/decode_step.cuh kMarks)
PROFILE_MARKS_G4 = 17  # the gemma4 instance's (kMarksG4): + gate, barrier, proj, barrier
_KERNEL_LIBRARY = {"fused_decode_g4": "fused_decode"}  # entry prefix -> csrc source


def is_gemma4(w) -> bool:
    """The weights carry gemma4's per-layer inputs (the kernel's gemma4
    instance and the plain twin's gemma4 features)."""
    return w.token_embd_per_layer is not None


def smem_bytes(hp, F: int, *, gemma4: bool, max_chunk: int = _MIN_CHUNK) -> int:
    """The kernel's dynamic shared memory (csrc/decode_step.cuh
    ``smem_layout``): the gemma4 instance holds one KV group's PV partials."""
    D, H, Hkv = hp.embedding_length, hp.n_head, hp.n_head_kv
    dk, dv = hp.n_embd_head_k, hp.n_embd_head_v
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    Rq, A = H * dk + Hkv * (dk + dv), H * dv
    pv_heads = H // Hkv if gemma4 else H
    return (2 * a16(4 * D) + a16(4 * Rq) + a16(4 * H * max_chunk) + a16(4 * 32) + a16(8 * H)
            + a16(4 * _WARPS * pv_heads * dv) + a16(2 * max(D, A, F)) + a16(2 * H * dk)
            + a16(2 * Hkv * dk) + a16(2 * Hkv * dv) + _STAGES * _STAGE_BYTES + a16(8 * _STAGES))


def decode_supported(hp, w) -> bool:
    """Whole-step kernel eligibility (llm_inference_tpu's
    ``megakernel_supported``, fused_decode.py:129-191, without its VMEM
    budget): stacked layers with per-row int8 weights everywhere, q/k norms,
    no ALiBi, uniform head dims of 128 or 256, at most four q heads per KV
    head, 128-aligned widths and F <= 36864. Gemma-3: D, H * dv <= 1536
    (the instance that holds activations in registers: the 1B class).
    gemma4 (``stack_layers_gemma4``'s stack): the per-layer-input weights,
    per-row int8 too (the per-layer embedding and the model projection
    included), P % 128 == 0, ``per_layer_model_proj`` of L * P rows, and the
    shared-memory instance's layout within a block's shared memory."""
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
    if F > _STAGE_BYTES or 2 * D > _STAGE_BYTES:
        return False
    if not g4 and (D > _MAX_REG_COLS or A > _MAX_REG_COLS):
        return False
    if hp.n_head % hp.n_head_kv or hp.n_head // hp.n_head_kv > _MAX_GROUP:
        return False
    if A != hp.n_head * dv:
        return False
    if lw.w_gate_up.rows != 2 * F or lw.w_down.rows != D or lw.wo.rows != D:
        return False
    if lw.wqkv.rows != hp.n_head * dk + hp.n_head_kv * (dk + dv):
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
    return smem_bytes(hp, F, gemma4=True) <= _SMEM_LIMIT


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
    max_chunk: int = 0


def prepare(hp, device, *, swa_mask: bool, max_seq: int = 0,
            kernel: str | None = "fused_decode") -> DecodeConsts:
    """Build the step constants on ``device`` (and, on CUDA, the scratch of
    the step kernel ``kernel``, fused_decode or fused_decode_q, for caches
    of ``max_seq`` slots; None: no scratch). A gemma4 ``hp`` takes
    fused_decode's gemma4 instance."""
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
    if kernel == "fused_decode" and hp.architecture == "gemma4":
        kernel = "fused_decode_g4"
    if device.type == "cuda" and kernel is not None:
        _alloc_scratch(consts, hp, device, max_seq, kernel)
    return consts


def step_lib(name: str = "fused_decode"):
    """The loaded library of step kernel ``name`` (an entry prefix of a
    csrc source), its C entries typed."""
    lib = _build.library(_KERNEL_LIBRARY.get(name, name))
    getattr(lib, f"{name}_grid").argtypes = [ctypes.c_int]
    getattr(lib, f"{name}_smem").argtypes = [ctypes.c_int] * 9
    for fn in ("grid", "smem", "min_chunk", "step"):
        getattr(lib, f"{name}_{fn}").restype = ctypes.c_int
    return lib


def _alloc_scratch(consts: DecodeConsts, hp, device, max_seq: int, name: str) -> None:
    lib = step_lib(name)
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
    D, F = hp.embedding_length, hp.feed_forward_length
    Rq = H * dk + Hkv * (dk + dv)
    # one block per SM; each attention block takes at least min_chunk slots
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    min_chunk = getattr(lib, f"{name}_min_chunk")()
    max_chunk = max(min_chunk, -(-max_seq // sms))
    with torch.cuda.device(device):
        smem = getattr(lib, f"{name}_smem")(D, F, H * dv, Rq, H, Hkv, dk, dv, max_chunk)
        grid = getattr(lib, f"{name}_grid")(smem)
    if grid != sms:
        raise RuntimeError(f"{name}: the kernel is not resident on every SM "
                           f"({grid} of {sms}) with {smem} bytes of shared memory")
    consts.grid = grid
    consts.max_chunk = max_chunk
    f32 = dict(dtype=torch.float32, device=device)
    consts.scratch = {
        "qkv": torch.empty(Rq, **f32),
        "part": torch.empty(grid * H * (dv + 2), **f32),
        "y_attn": torch.empty(D, **f32),
        "act": torch.empty(F, dtype=torch.bfloat16, device=device),
        "y_ffn": torch.empty(D, **f32),
        "barrier": torch.zeros(2, dtype=torch.int32, device=device),
    }
    if name == "fused_decode_g4":
        consts.scratch["pl_proj"] = torch.empty(hp.block_count * hp.embedding_length_per_layer,
                                                **f32)


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
    D, H, Hkv = hp.embedding_length, hp.n_head, hp.n_head_kv
    dk, dv, eps = hp.n_embd_head_k, hp.n_embd_head_v, hp.rms_eps
    G, half, F = H // Hkv, dk // 2, lw.w_down.cols
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
        qkv = dot(lw.wqkv, l, h)
        q = _rms(qkv[: H * dk].reshape(H, dk), eps) * lw.q_norm[l]
        k = _rms(qkv[H * dk : (H + Hkv) * dk].reshape(Hkv, dk), eps) * lw.k_norm[l]
        v = qkv[(H + Hkv) * dk :].reshape(Hkv, dv)
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
        for g in range(Hkv):
            s = qb[g * G : (g + 1) * G] @ kk[:, g].T  # [G, n]
            if hp.attn_soft_cap and hp.attn_soft_cap > 0.0:
                s = hp.attn_soft_cap * torch.tanh(s / hp.attn_soft_cap)
            pr = torch.exp(s - s.max(dim=1, keepdim=True).values)
            outs.append((_bf16r(pr) @ vv[:, g]) / pr.sum(dim=1, keepdim=True))
        attn = _bf16r(torch.cat(outs, dim=0).reshape(H * dv))
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
    if consts.scratch is None:
        raise ValueError("decode_step kernel: consts were prepared without CUDA scratch")
    dev = token.device
    lw = w.layers
    L, Rq, D = lw.wqkv.q.shape
    F, A = lw.w_down.cols, lw.wo.cols
    V = w.token_embd.rows
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
    S = cache.k.shape[1]
    if -(-S // consts.grid) > consts.max_chunk:
        raise ValueError(f"decode_step kernel: cache of {S} slots exceeds the prepared scratch")
    f32, i8, i32 = torch.float32, torch.int8, torch.int32
    pa, pf = lw.post_attn_norm, lw.post_ffw_norm
    sc = consts.scratch
    nb = consts.inv_freq.shape[0]
    tensors = [
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
        _need(lw.wqkv.q, "wqkv.q", i8, (L, Rq, D), dev),
        _need(lw.wqkv.scale, "wqkv.scale", f32, (L, Rq, 1), dev),
        _need(lw.wo.q, "wo.q", i8, (L, D, A), dev),
        _need(lw.wo.scale, "wo.scale", f32, (L, D, 1), dev),
        _need(lw.w_gate_up.q, "w_gate_up.q", i8, (L, 2 * F, D), dev),
        _need(lw.w_gate_up.scale, "w_gate_up.scale", f32, (L, 2 * F, 1), dev),
        _need(lw.w_down.q, "w_down.q", i8, (L, D, F), dev),
        _need(lw.w_down.scale, "w_down.scale", f32, (L, D, 1), dev),
        _need(w.token_embd.q, "token_embd.q", i8, (V, D), dev),
        _need(w.token_embd.scale, "token_embd.scale", f32, (V, 1), dev),
        # the stacked cache holds the layers that own K/V (gemma4: n_kv < L)
        _need(cache.k, "cache.k", torch.bfloat16, (hp.n_kv_layers, S, Hkv, dk), dev),
        _need(cache.v, "cache.v", torch.bfloat16, (hp.n_kv_layers, S, Hkv, dv), dev),
    ]
    g4 = is_gemma4(w)
    logits = torch.empty(V, dtype=f32, device=dev)
    marks = PROFILE_MARKS_G4 if g4 else PROFILE_MARKS
    if profile is not None:
        _need(profile, "profile", torch.int64, (L * marks + 3,), dev)
    tensors += [logits, sc["qkv"], sc["part"], sc["y_attn"], sc["act"], sc["y_ffn"],
                sc["barrier"], profile]
    assert len(tensors) == _PTR_FIELDS
    aligned = [lw.wqkv.q, lw.wo.q, lw.w_gate_up.q, lw.w_down.q, w.token_embd.q, cache.k, cache.v]
    dims = [L, D, F, A, Rq, V, S, H, Hkv, dk, dv, consts.max_chunk]
    scalars = [hp.rms_eps, hp.f_attention_scale, hp.attn_soft_cap or 0.0, hp.rope_freq_scale,
               math.sqrt(D)]
    if g4:
        P = hp.embedding_length_per_layer
        LP = L * P
        plg, plj, pe, pm = (lw.per_layer_inp_gate, lw.per_layer_proj, w.token_embd_per_layer,
                            w.per_layer_model_proj)
        if "pl_proj" not in sc:
            raise ValueError("decode_step kernel: consts were prepared for a Gemma-3 step")
        os_ = lw.out_scale
        tensors += [
            _need(consts.kv_src, "kv_src", i32, (L,), dev),
            None if os_ is None else _need(os_, "out_scale", f32, (L, 1), dev),
            _need(w.per_layer_proj_norm, "per_layer_proj_norm", f32, (P,), dev),
            _need(lw.per_layer_post_norm, "per_layer_post_norm", f32, (L, D), dev),
            _need(plg.q, "per_layer_inp_gate.q", i8, (L, P, D), dev),
            _need(plg.scale, "per_layer_inp_gate.scale", f32, (L, P, 1), dev),
            _need(plj.q, "per_layer_proj.q", i8, (L, D, P), dev),
            _need(plj.scale, "per_layer_proj.scale", f32, (L, D, 1), dev),
            _need(pm.q, "per_layer_model_proj.q", i8, (LP, D), dev),
            _need(pm.scale, "per_layer_model_proj.scale", f32, (LP, 1), dev),
            _need(pe.q, "token_embd_per_layer.q", i8, (V, LP), dev),
            _need(pe.scale, "token_embd_per_layer.scale", f32, (V, 1), dev),
            sc["pl_proj"]]
        assert len(tensors) == _PTR_FIELDS_G4
        aligned += [plg.q, plj.q, pm.q]
        dims += [P, hp.n_kv_layers]
        scalars += [math.sqrt(P), 1.0 / math.sqrt(D), 1.0 / math.sqrt(2.0)]
    # bulk copies and 16-byte loads read these from their base
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError("decode_step kernel: weights and caches must start on a "
                         "16-byte boundary")
    ptrs = (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr()
                                              for t in tensors])
    name = "fused_decode_g4" if g4 else "fused_decode"
    fn = getattr(step_lib(name), f"{name}_step")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    err = fn(ptrs, (ctypes.c_int * len(dims))(*dims), (ctypes.c_float * len(scalars))(*scalars),
             consts.grid, _build.stream_of(token))
    _build.check("fused_decode", err, "decode_step launch")
    launches += 1
    return logits
