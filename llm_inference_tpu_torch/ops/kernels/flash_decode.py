"""Ragged flash-decode attention: the CUDA kernel (csrc/flash_decode.cu) and its plain twins.

Replaces llm_inference_tpu/ops/pallas/flash_decode.py::flash_decode and
::paged_flash_decode: one query per lane against the lane's slots
``[starts[b], lengths[b])``, softmax in f32 with an optional softcap, GQA,
``[B, H, Dv]`` f32 out; a lane with an empty range (a parked lane, length 0)
gives zeros. ``q`` is ``[B, H, Dk]`` f32, already scaled. ``flash_decode``
reads dense caches ``[B, S, Hkv, D]`` bf16; ``paged_flash_decode`` reads
shared page pools ``[N, PAGE, Hkv, D]`` bf16 through a ``[B, NB]`` int32
page table (ids clamped into the pool), walking the first
``min(NB, nb_cap)`` blocks of each lane. The source note in
csrc/flash_decode.cu says how the kernel splits the work.

One launch a call: ``plan``, a pure function of the shapes and the SM count
(tests/test_torch_flash_plan.py), cuts each lane into ranges of slots, one
CTA each; the ranges of a (lane, KV head) meet in the kernel through
arrival counters kept per stream (``_build.stream_counters``).
``flash_decode_ranges_plain`` computes what the kernel computes range by
range, combined in range order.

Each wrapper launches the kernel for CUDA tensors (or raises) and runs its
plain twin for CPU tensors; ``launches`` and ``paged_launches`` count the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build

launches = 0
paged_launches = 0
TILE = 32          # slots a tile (csrc/flash_decode.cu kTile)
STAGES = 2         # tiles in flight a CTA
MAX_RANGES = 64    # ranges a lane (kMaxRanges): the combine reads them all
CTAS_PER_SM = 4    # the range size grows until a full batch takes about this many
_THREADS = 128
_MAX_GROUP = 8
_MAX_DIM = 512
SMEM_MAX = 232448
SMEM_SM = 233472   # an SM's shared memory, 1024 bytes of it reserved a CTA


def _starts(starts, lengths):
    return torch.zeros_like(lengths) if starts is None else starts


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's launch over lanes of ``slots`` slots: ``n_ranges``
    ranges of ``range_size`` slots a lane (a CTA each, grid (n_ranges, Hkv,
    B)), a ring of ``stages`` tiles of ``TILE`` slots, ``table_slots``
    page-table entries a range may touch (0 for dense lanes), ``smem`` bytes
    of dynamic shared memory, ``part_floats`` floats of scratch for the
    ranges' partials and ``counters`` arrival counters (none with one range
    a lane)."""

    slots: int
    range_size: int
    n_ranges: int
    stages: int
    table_slots: int
    smem: int
    part_floats: int
    counters: int

    def ranges(self, length: int, start: int = 0) -> list[tuple[int, int]]:
        """The live slots [lo, hi) of each range that holds any of the lane's
        [start, length) (length clamped to the lane's slots), in range
        order, as the kernel cuts them."""
        start, length = max(start, 0), min(length, self.slots)
        rs = self.range_size
        if start >= length:
            return []
        return [(max(j * rs, start), min((j + 1) * rs, length))
                for j in range(start // rs, (length - 1) // rs + 1)]


def dims_ok(H: int, Hkv: int, Dk: int, Dv: int) -> bool:
    """The head geometry the kernel takes (csrc/flash_decode.cu ``layout``)."""
    return (Hkv >= 1 and H % Hkv == 0 and 1 <= H // Hkv <= _MAX_GROUP and 8 <= Dk <= _MAX_DIM
            and 8 <= Dv <= _MAX_DIM and Dk % 8 == 0 and Dv % 8 == 0)


def plan(B: int, S: int, H: int, Hkv: int, Dk: int, Dv: int, page: int | None,
         sms: int) -> Plan:
    """The kernel's plan for ``B`` lanes of ``S`` slots (paged: the walked
    blocks times ``page``) on ``sms`` SMs, from the shapes alone.

    The range size starts at one tile and doubles while a batch of full
    lanes would take more than ``ctas_per_sm`` CTAs an SM, then while a lane
    has more than ``MAX_RANGES`` ranges; ragged lanes leave about half the
    CTAs empty, and those exit at once. ``ctas_per_sm`` is ``CTAS_PER_SM``,
    or one more than the CTAs an SM's shared memory holds at once where that
    is fewer (heads above 256: a stage of K and V is 64 KB at 512)."""
    if B < 1 or S < 1 or not dims_ok(H, Hkv, Dk, Dv) or (page is not None and page < 1):
        raise ValueError(f"flash_decode plan: B={B}, S={S}, H={H}, Hkv={Hkv}, Dk={Dk}, "
                         f"Dv={Dv}, page={page} (at most {_MAX_GROUP} q heads per KV head, "
                         f"head dims 8..{_MAX_DIM} in multiples of 8)")
    rs = TILE
    while rs < S:
        resident = SMEM_SM // (_layout(rs, S, H, Hkv, Dk, Dv, page)[3] + 1024)
        if B * Hkv * -(-S // rs) <= min(CTAS_PER_SM, resident + 1) * sms:
            break
        rs *= 2
    while -(-S // rs) > MAX_RANGES:
        rs *= 2
    nr, stages, ptab, smem = _layout(rs, S, H, Hkv, Dk, Dv, page)
    G = H // Hkv
    part = B * Hkv * nr * G * (Dv + 2) if nr > 1 else 0
    return Plan(S, rs, nr, stages, ptab, smem, part, B * Hkv if nr > 1 else 0)


def _layout(rs: int, S: int, H: int, Hkv: int, Dk: int, Dv: int, page: int | None):
    """(ranges a lane, stages, table entries, shared-memory bytes) of ranges
    of ``rs`` slots: csrc/flash_decode.cu ``layout``."""
    nr = -(-S // rs)
    stages = min(STAGES, rs // TILE)
    ptab = 0 if page is None else (rs - 1) // page + 2
    G = H // Hkv
    ring = stages * TILE * (Dk + Dv) * 2                  # K and V tiles
    vsub = 64 if Dv // 8 > 32 else 32 if Dv // 8 > 16 else 16 if Dv // 8 > 8 else 8
    red = _THREADS // vsub * G * Dv * 4                   # the P.V slot groups' sums
    a16 = lambda v: -(-v // 16) * 16  # noqa: E731
    smem = (ring
            + G * Dk // 8 * 48                            # q, 8 floats in 48 bytes
            + TILE * -(-G // 4) * 4 * 4                   # the tile's p values
            + 3 * _MAX_GROUP * 4                          # m, l, alpha
            + a16(2 * nr * G * 4) + a16(ptab * 4)         # the combine's (m, l), table entries
            + 2 * stages * 8 + 16                         # barriers, the last-arrival flag
            + (red if red > ring else 0))                 # over the ring where it fits
    return nr, stages, ptab, smem


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


def flash_decode_ranges_plain(q, k_cache, v_cache, lengths, starts=None, *,
                              softcap: float = 0.0, range_size: int):
    """Plain torch version of the kernel's split: each range of
    ``range_size`` slots its own (m, l, acc) over its live slots, then the
    ranges combined in range order, out = sum_r e^(m_r - M) acc_r / sum_r
    e^(m_r - M) l_r; zeros for an empty lane."""
    B, H, Dk = q.shape
    _, S, Hkv, Dv = v_cache.shape
    G = H // Hkv
    nr = -(-S // range_size)
    pad = nr * range_size - S
    starts = _starts(starts, lengths)
    s = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, Hkv, G, Dk), k_cache.float())
    if softcap and softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    key = torch.arange(S, device=q.device)
    valid = (key[None, :] >= starts[:, None].long()) & (key[None, :] < lengths[:, None].long())
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    s = s.reshape(B, Hkv, G, nr, range_size)
    v = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, 0, 0, pad))
    v = v.reshape(B, nr, range_size, Hkv, Dv)
    m = s.amax(dim=-1)  # [B, Hkv, G, nr]; -inf for a range without live slots
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m))[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgrs,brskd->bkgrd", p, v)
    M = m.amax(dim=-1)
    w = torch.exp(m - torch.where(torch.isfinite(M), M, torch.zeros_like(M))[..., None])
    L = torch.zeros_like(M)
    out = torch.zeros((B, Hkv, G, Dv), dtype=torch.float32, device=q.device)
    for r in range(nr):  # range order
        L = L + w[..., r] * l[..., r]
        out = out + w[..., r, None] * acc[..., r, :]
    out = out / torch.where(L == 0, torch.ones_like(L), L)[..., None]
    return out.reshape(B, H, Dv)


def _check_cuda(what, q, kc, vc, lengths, starts, Hkv, Dv, table=None) -> int:
    """Raise unless the kernel takes these CUDA inputs; the device's SM count."""
    B, H, Dk = q.shape
    if not dims_ok(H, Hkv, Dk, Dv):
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
    if q.data_ptr() % 16 or kc.data_ptr() % 16 or vc.data_ptr() % 16:
        raise ValueError(f"{what} kernel: q, K and V must start on a 16-byte boundary")
    return _build.sm_count(q.device)


def _scratch(q, p: Plan, B: int, H: int, Dv: int, what: str):
    out = torch.empty((B, H, Dv), dtype=torch.float32, device=q.device)
    part = counters = None
    if p.n_ranges > 1:
        part = torch.empty(p.part_floats, dtype=torch.float32, device=q.device)
        counters = _build.stream_counters(what, q, p.counters)
    return out, part, counters


def _ptrs(*ts):
    return [None if t is None else _build.ptr(t) for t in ts]


def flash_decode(q, k_cache, v_cache, lengths, starts=None, *, softcap: float = 0.0):
    """Ragged masked attention for one query per lane: [B, H, Dv] f32."""
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
    sms = _check_cuda("flash_decode", q, k_cache, v_cache, lengths, starts, Hkv, Dv)
    p = plan(B, S, H, Hkv, Dk, Dv, None, sms)
    out, part, counters = _scratch(q, p, B, H, Dv, "flash_decode")
    fn = _library().flash_decode_fwd
    err = fn(*_ptrs(q, k_cache, v_cache, lengths, starts, out, part, counters),
             B, S, H, Hkv, Dk, Dv, float(softcap or 0.0), p.range_size, p.n_ranges, p.stages,
             p.table_slots, p.smem, _build.stream_of(q))
    _build.check("flash_decode", err, "flash_decode launch")
    launches += 1
    return out


def walked_blocks(table, nb_cap=None) -> int:
    """Table blocks a paged call walks: all ``NB``, or ``nb_cap`` of them
    (at least one). A cap at or above every lane's live depth changes
    nothing; a smaller one truncates attention (the JAX contract)."""
    nb = table.shape[1]
    return nb if nb_cap is None else max(1, min(nb, int(nb_cap)))


def gather_pages(pool, table, nb: int):
    """Each lane's first ``nb`` table blocks of ``pool`` as a dense lane
    ``[B, nb * PAGE, ...]`` (ids clamped into the pool)."""
    N, page = pool.shape[:2]
    tbl = table[:, :nb].long().clamp(0, N - 1)
    return pool[tbl].reshape(table.shape[0], nb * page, *pool.shape[2:])


def paged_flash_decode_plain(q, k_pool, v_pool, table, lengths, starts=None, *,
                             softcap: float = 0.0, nb_cap=None):
    """Plain torch version: each lane's walked pages gathered into a dense
    lane, then ``flash_decode_plain``."""
    nb = walked_blocks(table, nb_cap)
    return flash_decode_plain(q, gather_pages(k_pool, table, nb), gather_pages(v_pool, table, nb),
                              lengths, starts, softcap=softcap)


def paged_flash_decode(q, k_pool, v_pool, table, lengths, starts=None, *, softcap: float = 0.0,
                       nb_cap=None):
    """Ragged masked attention through a page table: [B, H, Dv] f32."""
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
    sms = _check_cuda("paged_flash_decode", q, k_pool, v_pool, lengths, starts, Hkv, Dv, table)
    nb = walked_blocks(table, nb_cap)
    p = plan(B, nb * page, H, Hkv, Dk, Dv, page, sms)
    out, part, counters = _scratch(q, p, B, H, Dv, "paged_flash_decode")
    fn = _library().paged_flash_decode_fwd
    err = fn(*_ptrs(q, k_pool, v_pool, table, lengths, starts, out, part, counters),
             B, table.shape[1], nb, page, N, H, Hkv, Dk, Dv, float(softcap or 0.0),
             p.range_size, p.n_ranges, p.stages, p.table_slots, p.smem, _build.stream_of(q))
    _build.check("flash_decode", err, "paged_flash_decode launch")
    paged_launches += 1
    return out


_lib = None


def _library():
    """The kernel library, its entry points' argument types bound once."""
    global _lib
    if _lib is None:
        lib = _build.library("flash_decode")
        lib.flash_decode_fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                                         + [ctypes.c_float] + [ctypes.c_int] * 5
                                         + [ctypes.c_void_p])
        lib.flash_decode_fwd.restype = ctypes.c_int
        lib.paged_flash_decode_fwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                                               + [ctypes.c_float] + [ctypes.c_int] * 5
                                               + [ctypes.c_void_p])
        lib.paged_flash_decode_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib
