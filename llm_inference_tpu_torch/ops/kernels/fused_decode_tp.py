"""Tensor-parallel whole-step decode over per-row int8 shards: the CUDA
kernel (csrc/fused_decode_tp.cu) and its plain twin.

Replaces llm_inference_tpu/ops/pallas/fused_decode_tp.py::
decode_step_megakernel_tp: n ranks of a mesh's 'model' axis each run one
single-token step over their shard (``shard_rowq8_for_tp``, the TPU
kernel's layout: local q-head rows plus the replicated K/V rows of wqkv,
the local heads' Wo columns, F / n gate/up rows zero-padded to a multiple
of 128, the matching down columns, V / n embedding rows) and a K/V cache
replica of their own, and meet in three kinds of all-reduce: the entry row
(only the token's owner contributes its embedding row times sqrt(D)), Wo's
partial sums and the down projection's. Each rank writes its V / n logits
into its place of one [V] f32 row on the mesh's first device.

The mesh's devices may repeat: ``[cuda:0] * n`` runs all n ranks on one
card, in one cooperative launch, each rank a group of the card's SMs
(csrc/tp.cuh), each running the single-chip whole step's body over its
shards as tiles of its own plan (``fused_decode_stream.plan`` over the
rank's widths and blocks, cut at first launch); ``[cpu] * n`` runs the
plain twin. Distinct cards take one launch per device, with the
all-reduces through peer pointers; no run has checked that leg (the port
is measured on one card).

``decode_step_tp`` launches the kernel for CUDA tensors (or raises) and
runs ``decode_step_tp_plain`` for CPU tensors; ``launches`` counts kernel
launches (one a step on one card). The lossless counterpart,
fused_decode_q_tp.py, shares this module's sharding, constants, plain twin
and launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from . import _build
from .fused_decode import (_bf16r, _geglu, _rms, _rowq8_dot, _rowq8_embed, _f32,
                           attention_plain, decode_supported, is_gemma4, launch_args,
                           prepare as _prepare, step_dims)

launches = 0

KERNEL = "fused_decode_tp"
LANE = 128
_MAX_RANKS, _MAX_RANKS_HERE = 8, 4  # csrc/tp.cuh kMaxRanks, kMaxRanksHere
# shared memory a rank's plan may take: a block's 227 KB less the kernel's
# static arrays (the rank's Step, format and mesh parameters, copied into
# shared memory, and the tile schedule: 1.97 KB)
TILED_STATIC_SMEM = 2048
TILED_SMEM = 232448 - TILED_STATIC_SMEM


def split_ok(hp, V: int, F: int, n: int) -> bool:
    """The TPU kernels' shared splits (fused_decode_tp.py:69-95): n >= 2
    ranks, whole q heads a rank, a rank's heads tiling whole KV groups or
    within one, Hl * dv lanes a multiple of 128, whole and 128-aligned
    vocabulary shards, whole F shards; and the port's limits: at most 8
    ranks (csrc/tp.cuh kMaxRanks)."""
    H, Hkv = hp.n_head, hp.n_head_kv
    if n < 2 or n > _MAX_RANKS or H % n or Hkv < 1:
        return False
    G, Hl = H // Hkv, H // n
    if Hl % G and G % Hl:
        return False
    if (Hl * hp.n_embd_head_v) % LANE:
        return False
    return V % n == 0 and (V // n) % LANE == 0 and F % n == 0


def tp_decode_supported(hp, w, n: int) -> bool:
    """Eligibility (llm_inference_tpu's ``tp_megakernel_supported``,
    fused_decode_tp.py:69-95): the single-chip step's
    (``fused_decode.decode_supported``) and clean head, KV-group, lane,
    vocabulary and F splits over n ranks. gemma4 is refused: the TPU
    kernel's gate admits a gemma4 stack through ``megakernel_supported``,
    but its body (_run_step_tp) has none of gemma4's features."""
    if is_gemma4(w) or hp.architecture != "gemma3" or not decode_supported(hp, w):
        return False
    return split_ok(hp, w.token_embd.rows, w.layers.w_down.cols, n)


@dataclasses.dataclass
class TPWeights:
    """Per-rank shards: ``ranks[r]`` is rank r's stacked model (its own
    widths, the norms replicated) on ``devices[r]``; ``geom`` the JAX
    package's geometry dict (n, L, D, H, Hkv, dk, dv, Hl, F, Fl, Flp, V,
    Vl)."""

    n: int
    devices: list
    geom: dict
    ranks: list


def _rows(t, idx):
    """Rows ``idx`` of a weight of any class, stacked or not (the same format)."""
    kw = {k: getattr(t, k)[..., idx, :] for k in ("q", "packed", "w", "scale", "offset")
          if isinstance(getattr(t, k, None), torch.Tensor)}
    return dataclasses.replace(t, rows=next(iter(kw.values())).shape[-2], **kw)


def _cols(t, c0: int, c1: int):
    """Columns [c0, c1) of a stacked quantized weight: whole groups of a
    grouped one (its scales and offsets with them); a per-row weight keeps
    its row scales."""
    if t.groups == 1:  # per row: one scale for any slice of the row
        return dataclasses.replace(t, q=t.q[..., c0:c1], cols=c1 - c0, group_size=c1 - c0)
    gs = t.group_size
    if c0 % gs or c1 % gs:
        raise ValueError(f"a column shard [{c0}, {c1}) must cut whole groups of {gs}")
    g = slice(c0 // gs, c1 // gs)
    kw = {"scale": t.scale[..., g], "offset": None if t.offset is None else t.offset[..., g]}
    if hasattr(t, "packed"):  # nibble pairs: column 2j and 2j + 1 in byte j
        kw["packed"] = t.packed[..., c0 // 2 : c1 // 2]
    else:
        kw["q"] = t.q[..., c0:c1]
    return dataclasses.replace(t, cols=c1 - c0, **kw)


def _pad_rows(t, rows: int):
    """A per-row weight zero-padded to ``rows`` rows (zero quants and scales)."""
    extra = rows - t.rows
    if extra == 0:
        return t
    L, _, C = t.q.shape
    return dataclasses.replace(
        t, rows=rows,
        q=torch.cat([t.q, t.q.new_zeros((L, extra, C))], dim=1),
        scale=torch.cat([t.scale, t.scale.new_zeros((L, extra, 1))], dim=1))


def _pad_cols(t, cols: int):
    """A per-row weight zero-padded to ``cols`` columns (its row scales kept)."""
    extra = cols - t.cols
    if extra == 0:
        return t
    L, R, _ = t.q.shape
    return dataclasses.replace(t, cols=cols, group_size=cols,
                               q=torch.cat([t.q, t.q.new_zeros((L, R, extra))], dim=2))


def _on(v, device):
    """A weight or a tensor, contiguous on ``device`` (no copy where it is)."""
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.to(device).contiguous()
    fields = {f.name: getattr(v, f.name) for f in dataclasses.fields(v)}
    return dataclasses.replace(v, **{k: _on(x, device) for k, x in fields.items()
                                     if isinstance(x, torch.Tensor)})


def shard_for_tp(hp, w, n: int, devices=None) -> TPWeights:
    """Per-rank shards of stacked Gemma-3 weights (per-row int8 or
    group-scaled), in the TPU kernels' layout (fused_decode_tp.py:98-170,
    fused_decode_q_tp.py:125-197): rank r takes wqkv's rows of its Hl = H / n
    q heads and every K/V row; Wo's columns of its heads; gate/up rows [r *
    Fl, (r + 1) * Fl) of the gate and of the up half, zero-padded to Flp (a
    multiple of 128; per-row weights only: the lossless gate wants Fl % 128
    == 0); w_down's matching columns (zero-padded alike); embedding rows [r *
    V / n, (r + 1) * V / n). Column shards of a grouped weight cut whole
    groups. The norms are replicated. ``devices``: each rank's device
    (default: the weights' own, n times)."""
    lw = w.layers
    L, D = lw.attn_norm.shape[0], hp.embedding_length
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
    Hl, F, V = H // n, lw.w_down.cols, w.token_embd.rows
    Fl, Vl = F // n, V // n
    Flp = -(-Fl // LANE) * LANE
    devices = [torch.device(d) for d in (devices or [lw.attn_norm.device] * n)]
    dev_w = lw.attn_norm.device
    if Flp != Fl and lw.w_down.groups != 1:
        raise ValueError(f"F / n = {Fl}: a group-scaled FFN shard takes no padding")
    ranks = []
    for r in range(n):
        qkv_rows = torch.cat([torch.arange(r * Hl * dk, (r + 1) * Hl * dk),
                              torch.arange(H * dk, lw.wqkv.rows)]).to(dev_w)
        frows = torch.arange(r * Fl, (r + 1) * Fl)
        gate, up = _rows(lw.w_gate_up, frows.to(dev_w)), _rows(lw.w_gate_up, (F + frows).to(dev_w))
        down = _cols(lw.w_down, r * Fl, (r + 1) * Fl)
        if Flp != Fl:
            gate, up, down = _pad_rows(gate, Flp), _pad_rows(up, Flp), _pad_cols(down, Flp)
        gu = dataclasses.replace(gate, rows=2 * Flp, **{
            k: torch.cat([getattr(gate, k), getattr(up, k)], dim=1)
            for k in ("q", "packed", "scale", "offset")
            if isinstance(getattr(gate, k, None), torch.Tensor)})
        layers = dataclasses.replace(
            lw, wqkv=_rows(lw.wqkv, qkv_rows), wo=_cols(lw.wo, r * Hl * dv, (r + 1) * Hl * dv),
            w_gate_up=gu, w_down=down)
        layers = dataclasses.replace(layers, **{
            f.name: _on(getattr(layers, f.name), devices[r]) for f in dataclasses.fields(layers)})
        emb = _rows(w.token_embd, slice(r * Vl, (r + 1) * Vl))
        ranks.append(dataclasses.replace(w, token_embd=_on(emb, devices[r]),
                                         output_norm=_on(w.output_norm, devices[r]),
                                         layers=layers))
    geom = dict(n=n, L=L, D=D, H=H, Hkv=Hkv, dk=dk, dv=dv, Hl=Hl, F=F, Fl=Fl, Flp=Flp, V=V, Vl=Vl)
    return TPWeights(n=n, devices=devices, geom=geom, ranks=ranks)


# the JAX package's name (fused_decode_tp.py:98): the per-row int8 shards
shard_rowq8_for_tp = shard_for_tp


def local_hparams(hp, tw: TPWeights):
    """A rank's hyperparameters: its q heads and FFN width."""
    g = tw.geom
    return dataclasses.replace(hp, n_head=g["Hl"], feed_forward_length=g["Flp"])


@dataclasses.dataclass
class TPConsts:
    """Step constants of a tensor-parallel step: ``step[r]`` rank r's
    (on its device; on CUDA with its scratch, ``grid`` its blocks), and on
    CUDA the all-reduce state: ``gather[r]`` [2, n, D] f32 and ``flags[r]``
    [2, n] int32 on rank r's device, ``epoch`` per device [ranks there]
    int32 (each rank's next all-reduce number, from 1), ``groups`` the
    (device, first rank, ranks) of each launch."""

    step: list
    gather: list | None = None
    flags: list | None = None
    epoch: dict | None = None
    groups: list | None = None


def device_groups(devices: list) -> list:
    """(device, first rank, rank count) per device: a device's ranks must be
    consecutive (one launch covers them)."""
    groups = []
    for r, d in enumerate(devices):
        if groups and groups[-1][0] == d:
            groups[-1][2] += 1
        elif any(g[0] == d for g in groups):
            raise ValueError(f"mesh ranks on {d} are not consecutive")
        else:
            groups.append([d, r, 1])
    return [tuple(g) for g in groups]


def prepare(hp, tw: TPWeights, *, swa_mask: bool, max_seq: int = 0,
            kernel: str = KERNEL) -> TPConsts:
    """The step constants of each rank (and on CUDA the scratch of step
    kernel ``kernel``, fused_decode_tp or the lossless fused_decode_q_tp,
    for caches of up to ``max_seq`` slots, and the all-reduce state).
    Enables peer access between distinct cards (raising where a pair has
    none). A rank's scratch holds the attention scores [Hl, max_seq], its
    own barrier word, its attention items' q heads ``G`` and a cache of its
    plans by weight formats (``fused_decode_stream.plan`` over the rank's
    widths and blocks, cut at first launch)."""
    groups = device_groups(tw.devices)
    by_dev = {d: _prepare(hp, d, swa_mask=swa_mask, kernel=None) for d, _, _ in groups}
    consts = TPConsts(step=[dataclasses.replace(by_dev[d]) for d in tw.devices])
    if tw.devices[0].type != "cuda":
        return consts
    lib = _build.library(kernel)
    g = tw.geom
    n, D, H, Hkv, dk, dv = tw.n, g["D"], g["Hl"], g["Hkv"], g["dk"], g["dv"]
    lw = tw.ranks[0].layers
    F, A, Rq = lw.w_down.cols, lw.wo.cols, lw.wqkv.rows
    if len(groups) > 1:
        _enable_peers([d for d, _, _ in groups], kernel, lib)
    consts.gather, consts.flags, consts.epoch, consts.groups = [], [], {}, groups
    for d, r0, k in groups:
        if k > _MAX_RANKS_HERE:
            raise ValueError(f"{k} ranks on {d}: one launch covers at most {_MAX_RANKS_HERE}")
        sms = torch.cuda.get_device_properties(d).multi_processor_count
        per_rank = sms // k
        with torch.cuda.device(d):  # the most any plan of the rank takes
            grid = getattr(lib, f"{kernel}_grid")(TILED_SMEM)
        if grid < per_rank * k:
            raise RuntimeError(f"{kernel}: the kernel is not resident on every SM of {d} "
                               f"({grid} of {sms}) with {TILED_SMEM} bytes of shared memory")
        f32 = dict(dtype=torch.float32, device=d)
        for r in range(r0, r0 + k):
            c = consts.step[r]
            c.grid, c.max_seq = per_rank, max_seq
            c.scratch = {
                "qkv": torch.empty(Rq, **f32),
                "part": torch.empty(per_rank * H * (dv + 2), **f32),
                "y_attn": torch.empty(D, **f32),
                "act": torch.empty(F, dtype=torch.bfloat16, device=d),
                "y_ffn": torch.empty(D, **f32),
                "barrier": torch.zeros(2, dtype=torch.int32, device=d),
                "scores": torch.empty(H * max_seq, **f32),
                "G": min(g["H"] // Hkv, H),
                "plans": {},
            }
            consts.gather.append(torch.zeros((2, n, D), **f32))
            consts.flags.append(torch.zeros((2, n), dtype=torch.int32, device=d))
        consts.epoch[d] = torch.ones(k, dtype=torch.int32, device=d)
    return consts


def _enable_peers(devices: list, kernel: str, lib) -> None:
    for a in devices:
        for b in devices:
            if a == b:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(f"tensor parallelism over {a} and {b} needs peer access, "
                                   "which this pair of cards does not have")
            with torch.cuda.device(a):
                _build.check(kernel, getattr(lib, f"{kernel}_enable_peer")(b.index),
                             f"peer access {a} -> {b}")


def all_reduce_plain(parts: list, device) -> torch.Tensor:
    """The ranks' partial sums added in rank order 0..n-1 on ``device``."""
    acc = parts[0].to(device)
    for t in parts[1:]:
        acc = acc + t.to(device)
    return acc


def tp_step_plain(hp, tw: TPWeights, caches: list, token, pos, consts: TPConsts, dot,
                  embed) -> torch.Tensor:
    """Plain torch version of a tensor-parallel step with the kernels'
    rounding points, for either weight format (``dot`` and ``embed`` as in
    fused_decode.step_plain): each rank's partial step on its shard and
    cache replica, each all-reduce a sum of the ranks' f32 partials in rank
    order. Returns the logits [V] f32 on the mesh's first device."""
    g = tw.geom
    n, L, D, H, Hkv, Hl, Vl = g["n"], g["L"], g["D"], g["H"], g["Hkv"], g["Hl"], g["Vl"]
    eps = hp.rms_eps
    G = H // Hkv
    dev0 = tw.devices[0]
    tok = int(token.reshape(-1)[0])
    p = int(pos.reshape(-1)[0])
    ranks = tw.ranks
    lw0 = ranks[0].layers
    parts = []
    for r, rw in enumerate(ranks):
        tl = tok - r * Vl
        parts.append(embed(rw.token_embd, tl) * _f32(math.sqrt(D)) if 0 <= tl < Vl
                     else torch.zeros(D, device=tw.devices[r]))
    x = all_reduce_plain(parts, dev0)
    for l in range(L):
        h = _bf16r(_rms(x, eps) * lw0.attn_norm[l])
        ys = []
        for r, rw in enumerate(ranks):
            lw, dev = rw.layers, tw.devices[r]
            qkv = dot(lw.wqkv, l, h.to(dev))
            attn = attention_plain(hp, lw, qkv, l, caches[r], p, consts.step[r], Hl,
                                   r * Hl // G)
            ys.append(dot(lw.wo, l, attn))
        y = all_reduce_plain(ys, dev0)
        if lw0.post_attn_norm is not None:
            y = _rms(y, eps) * lw0.post_attn_norm[l]
        x = x + y
        h2 = _bf16r(_rms(x, eps) * lw0.ffn_norm[l])
        ys = []
        for r, rw in enumerate(ranks):
            lw = rw.layers
            Fp = lw.w_down.cols
            gu = dot(lw.w_gate_up, l, h2.to(tw.devices[r]))
            ys.append(dot(lw.w_down, l, _bf16r(_geglu(gu[:Fp], gu[Fp:]))))
        y3 = all_reduce_plain(ys, dev0)
        if lw0.post_ffw_norm is not None:
            y3 = _rms(y3, eps) * lw0.post_ffw_norm[l]
        x = x + y3
    h = _bf16r(_rms(x, eps) * ranks[0].output_norm)
    return torch.cat([dot(rw.token_embd, None, h.to(tw.devices[r])).to(dev0)
                      for r, rw in enumerate(ranks)])


def decode_step_tp_plain(hp, tw: TPWeights, caches: list, token, pos,
                         consts: TPConsts) -> torch.Tensor:
    """Plain torch version of the kernel, with the same rounding points."""
    return tp_step_plain(hp, tw, caches, token, pos, consts, _rowq8_dot, _rowq8_embed)


def run_tp(hp, tw: TPWeights, caches: list, token: torch.Tensor, pos: torch.Tensor,
           consts: TPConsts, kernel: str, profile: torch.Tensor | None = None) -> torch.Tensor:
    """Launch step kernel ``kernel`` (fused_decode_tp or fused_decode_q_tp)
    once per device of the mesh, over the arrays of its ranks
    (``rank_args``); ``profile`` as in ``fused_decode.decode_step``, block 0
    of rank 0's marks. Returns the logits [V] f32 on the mesh's first
    device."""
    if consts.groups is None:
        raise ValueError(f"{kernel}: consts were prepared without CUDA scratch")
    g = tw.geom
    Vl, dev0 = g["Vl"], tw.devices[0]
    if token.device != dev0:
        raise ValueError(f"{kernel}: token on {token.device}, the mesh starts on {dev0}")
    hl = local_hparams(hp, tw)
    logits = torch.empty(g["V"], dtype=torch.float32, device=dev0)
    fn = getattr(_build.library(kernel), f"{kernel}_step")
    tp_ptrs = consts.gather + consts.flags
    sys_scope = int(len(consts.groups) > 1)

    def pointers(ts):
        return (ctypes.c_void_p * len(ts))(*[None if t is None else t.data_ptr() for t in ts])

    done = []
    for d, r0, k in consts.groups:
        tok_d, pos_d = token.to(d), pos.to(d)
        ranks = [rank_args(hl, tw.ranks[r], caches[r], tok_d, pos_d, consts.step[r],
                           logits[r * Vl : (r + 1) * Vl], profile if r == 0 else None)
                 for r in range(r0, r0 + k)]
        a = ranks[0]
        args = [pointers([t for ra in ranks for t in ra["ptrs"]]),
                (ctypes.c_int * len(a["dims"]))(*a["dims"]),
                (ctypes.c_float * len(a["scalars"]))(*a["scalars"]),
                pointers([t for ra in ranks for t in ra["wptrs"]]),
                (ctypes.c_int * len(a["winfo"]))(*a["winfo"]), a["plan"]]
        tp_dims = [tw.n, r0, k, consts.step[r0].grid, sys_scope, hp.n_head]
        args += [pointers(tp_ptrs + [consts.epoch[d]]), (ctypes.c_int * 6)(*tp_dims)]
        fn.argtypes = [ctypes.c_void_p] * (len(args) + 1)
        with torch.cuda.device(d):
            _build.check(kernel, fn(*args, _build.stream_of(tok_d)), f"{kernel} launch on {d}")
            if d != dev0:
                done.append(torch.cuda.Event())
                done[-1].record()
    for ev in done:  # the other cards wrote their logits slices into the first's memory
        torch.cuda.current_stream(dev0).wait_event(ev)
    return logits


def rank_args(hl, rw, cache, tok, pos, consts, logits, profile=None) -> dict:
    """A rank's arrays (``run_tp``): the single-chip step's over its shards
    (fused_decode.launch_args, step_dims: its step pointers ``ptrs`` and
    weight pointers ``wptrs``, with the ``dims``, ``scalars`` and ``winfo``
    every rank shares) and its tile plan (the rank's widths over its
    blocks)."""
    from .fused_decode_stream import formats_of, plan_ints, plan_shapes

    step, wts, info = launch_args(hl, rw, cache, tok, pos, consts, logits, profile)
    dims, scalars = step_dims(hl, rw, cache, consts)
    _, ints = plan_ints(consts.scratch["plans"], formats_of(wts, info),
                        **plan_shapes(hl, rw, consts.grid), G=consts.scratch["G"],
                        static_smem=TILED_STATIC_SMEM)
    return {"ptrs": step, "wptrs": wts, "winfo": info, "plan": ints, "dims": dims,
            "scalars": scalars}


def decode_step_tp(hp, tw: TPWeights, caches: list, token: torch.Tensor, pos: torch.Tensor,
                   consts: TPConsts, profile: torch.Tensor | None = None) -> torch.Tensor:
    """One tensor-parallel single-token decode step. ``token`` (int64) and
    ``pos`` (int32) are one-element tensors on the mesh's first device;
    ``caches[r]`` is rank r's stacked K/V replica, written in place. Returns
    the logits [V] f32 on the mesh's first device (final softcap not
    applied). ``profile`` (kernel only): rank 0's block 0 marks, as
    ``fused_decode.decode_step``'s."""
    if not token.is_cuda:
        return decode_step_tp_plain(hp, tw, caches, token, pos, consts)
    global launches
    logits = run_tp(hp, tw, caches, token, pos, consts, KERNEL, profile)
    launches += len(consts.groups)
    return logits


__all__ = ["TPConsts", "TPWeights", "decode_step_tp", "decode_step_tp_plain", "prepare",
           "shard_for_tp", "shard_rowq8_for_tp", "split_ok", "tp_decode_supported",
           "tp_step_plain"]
