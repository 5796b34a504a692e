"""Ragged flash-decode attention: the CUDA kernels (csrc/flash_decode.cu) and their plain twins.

Replaces llm_inference_tpu/ops/pallas/flash_decode.py::flash_decode and
::paged_flash_decode: one query per lane against the lane's slots
``[starts[b], lengths[b])``, softmax in f32 with an optional softcap, GQA,
``[B, H, Dv]`` f32 out; a lane with an empty range (a parked lane, length 0)
gives zeros. ``q`` is ``[B, H, Dk]`` f32, already scaled. ``flash_decode``
reads dense caches ``[B, S, Hkv, D]`` bf16; ``paged_flash_decode`` reads
shared page pools ``[N, PAGE, Hkv, D]`` bf16 through a ``[B, NB]`` int32
page table (ids clamped into the pool), walking the first
``min(NB, nb_cap)`` blocks of each lane. The source note in
csrc/flash_decode.cu says how the kernels split the work.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain twin for CPU tensors; ``launches`` and ``paged_launches`` count the
kernels' launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0
paged_launches = 0
BLOCK = 256  # slots a CTA (csrc/flash_decode.cu kBlock)
_MAX_GROUP = 8
_MAX_DIM = 256


def _starts(starts, lengths):
    return torch.zeros_like(lengths) if starts is None else starts


def flash_decode_plain(q, k_cache, v_cache, lengths, starts=None, *, softcap: float = 0.0,
                       alibi_slopes=None):
    """Plain torch version: the full masked softmax per lane and head (f32).
    ``alibi_slopes`` ([H] f32, the kernel has none) adds the ALiBi bias
    ``slope[h] * (key - query position)`` after the softcap, the query
    standing at ``lengths - 1``; the per-op batched decode uses it."""
    B, H, Dk = q.shape
    _, S, Hkv, Dv = v_cache.shape
    G = H // Hkv
    starts = _starts(starts, lengths)
    s = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, Hkv, G, Dk), k_cache.float())
    if softcap and softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    key = torch.arange(S, device=q.device)
    if alibi_slopes is not None:
        bias = (key[None, :] - (lengths[:, None].long() - 1)).float()  # [B, S]
        s = s + alibi_slopes.reshape(Hkv, G)[None, :, :, None] * bias[:, None, None, :]
    valid = (key[None, :] >= starts[:, None].long()) & (key[None, :] < lengths[:, None].long())
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)  # exactly 0 at masked slots
    den = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = out / torch.where(den == 0, torch.ones_like(den), den)
    return out.reshape(B, H, Dv)


def _check_cuda(what, q, kc, vc, lengths, starts, Hkv, Dv, table=None) -> None:
    """Raise unless the kernel takes these CUDA inputs."""
    B, H, Dk = q.shape
    if H // Hkv > _MAX_GROUP or Dk > _MAX_DIM or Dv > _MAX_DIM or Dk % 8 or Dv % 8:
        raise ValueError(f"{what} kernel: at most {_MAX_GROUP} q heads per KV head, "
                         f"head dims <= {_MAX_DIM} and multiples of 8")
    tensors = [("q", q, torch.float32), ("K", kc, torch.bfloat16), ("V", vc, torch.bfloat16),
               ("lengths", lengths, torch.int32), ("starts", starts, torch.int32)]
    if table is not None:
        tensors.append(("table", table, torch.int32))
    for name, t, dtype in tensors:
        if t.device != q.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what} kernel: {name} must be contiguous {dtype} on {q.device}")
    if lengths.shape != (B,) or starts.shape != (B,):
        raise ValueError(f"{what} kernel: lengths and starts must be [B]")
    if kc.data_ptr() % 16 or vc.data_ptr() % 16:
        raise ValueError(f"{what} kernel: K and V must start on a 16-byte boundary")


def flash_decode(q, k_cache, v_cache, lengths, starts=None, *, softcap: float = 0.0):
    """Blockwise masked attention for one query per lane: [B, H, Dv] f32."""
    if q.ndim != 3 or k_cache.ndim != 4 or v_cache.shape[:3] != k_cache.shape[:3]:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    B, H, Dk = q.shape
    _, S, Hkv, Dv = v_cache.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != Dk or H % Hkv:
        raise ValueError("flash_decode: q and caches disagree on B, Dk or the head groups")
    if not q.is_cuda:
        return flash_decode_plain(q, k_cache, v_cache, lengths, starts, softcap=softcap)
    global launches
    starts = _starts(starts, lengths)
    q = q.float().contiguous()
    _check_cuda("flash_decode", q, k_cache, v_cache, lengths, starts, Hkv, Dv)
    nb = -(-S // BLOCK)
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty((B, H, Dv), **f32)
    part_m = torch.empty(B * H * nb, **f32)
    part_l = torch.empty(B * H * nb, **f32)
    part_acc = torch.empty(B * H * nb * Dv, **f32)
    fn = _build.library("flash_decode").flash_decode_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*[_build.ptr(t) for t in (q, k_cache, v_cache, lengths, starts, out, part_m, part_l,
                                       part_acc)],
             B, S, H, Hkv, Dk, Dv, float(softcap or 0.0), _build.stream_of(q))
    _build.check("flash_decode", err, "flash_decode launch")
    launches += 1
    return out


def walked_blocks(table, nb_cap=None) -> int:
    """Table blocks a paged call walks: all ``NB``, or ``nb_cap`` of them
    (at least one). A cap at or above every lane's live depth changes
    nothing; a smaller one truncates attention (the JAX contract)."""
    nb = table.shape[1]
    return nb if nb_cap is None else max(1, min(nb, int(nb_cap)))


def paged_flash_decode_plain(q, k_pool, v_pool, table, lengths, starts=None, *,
                             softcap: float = 0.0, nb_cap=None):
    """Plain torch version: each lane's walked pages gathered into a dense
    lane, then ``flash_decode_plain``."""
    B = q.shape[0]
    N, page = k_pool.shape[:2]
    nb = walked_blocks(table, nb_cap)
    tbl = table[:, :nb].long().clamp(0, N - 1)
    kd = k_pool[tbl].reshape(B, nb * page, *k_pool.shape[2:])
    vd = v_pool[tbl].reshape(B, nb * page, *v_pool.shape[2:])
    return flash_decode_plain(q, kd, vd, lengths, starts, softcap=softcap)


def paged_flash_decode(q, k_pool, v_pool, table, lengths, starts=None, *, softcap: float = 0.0,
                       nb_cap=None):
    """Blockwise masked attention through a page table: [B, H, Dv] f32."""
    if q.ndim != 3 or k_pool.ndim != 4 or v_pool.shape[:3] != k_pool.shape[:3] or table.ndim != 2:
        raise ValueError(f"paged_flash_decode: q {tuple(q.shape)}, k {tuple(k_pool.shape)}, "
                         f"v {tuple(v_pool.shape)}, table {tuple(table.shape)}")
    B, H, Dk = q.shape
    N, page, Hkv, Dv = v_pool.shape
    if k_pool.shape[3] != Dk or H % Hkv or table.shape[0] != B:
        raise ValueError("paged_flash_decode: q, pools and table disagree on B, Dk or the head "
                         "groups")
    if not q.is_cuda:
        return paged_flash_decode_plain(q, k_pool, v_pool, table, lengths, starts,
                                        softcap=softcap, nb_cap=nb_cap)
    global paged_launches
    starts = _starts(starts, lengths)
    q = q.float().contiguous()
    _check_cuda("paged_flash_decode", q, k_pool, v_pool, lengths, starts, Hkv, Dv, table)
    nb = walked_blocks(table, nb_cap)
    ncta = -(-(nb * page) // BLOCK)
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty((B, H, Dv), **f32)
    part_m = torch.empty(B * H * ncta, **f32)
    part_l = torch.empty(B * H * ncta, **f32)
    part_acc = torch.empty(B * H * ncta * Dv, **f32)
    fn = _build.library("flash_decode").paged_flash_decode_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*[_build.ptr(t) for t in (q, k_pool, v_pool, table, lengths, starts, out, part_m,
                                       part_l, part_acc)],
             B, table.shape[1], nb, page, N, H, Hkv, Dk, Dv, float(softcap or 0.0),
             _build.stream_of(q))
    _build.check("flash_decode", err, "paged_flash_decode launch")
    paged_launches += 1
    return out
