"""The flash-decode kernel's launch plan and its range split, on the CPU.

``flash_decode.plan`` is a pure function of the shapes and the SM count;
csrc/flash_decode.cu takes what it says (and checks it). Here it is held:

  - its ranges cover each lane's ``[starts, lengths)`` exactly, in order,
    one range a CTA, at lengths on every range edge, for empty and parked
    lanes and lengths past the lane;
  - a range touches no more pages than the plan reads table entries for, at
    pages of 16, 32, 48 and 256, and ``nb_cap`` truncates the walked slots;
  - its scratch, counters and shared memory (three CTAs an SM at the 1B
    serving shapes), and its refusals outside the kernel's head geometry.

``flash_decode_ranges_plain`` computes what the kernel computes, each
range's (m, l, acc) combined in range order, at the plan's range sizes; it
is held against the Pallas kernels in interpret mode (dense and paged) and
against ``flash_decode_plain``, with and without softcap and windows, within
1e-5 * max(1, max|out|): f32 sums in another order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_inference_tpu.ops.pallas.flash_decode import flash_decode as jax_flash_decode
from llm_inference_tpu.ops.pallas.flash_decode import paged_flash_decode as jax_paged_flash
from llm_inference_tpu_torch.ops.kernels import flash_decode

SMS = 132


def _ranges_ok(p, length, start):
    """The plan's ranges against the lane's live slots, slot by slot."""
    got = p.ranges(length, start)
    live = list(range(max(start, 0), min(length, p.slots)))
    cover = [s for lo, hi in got for s in range(lo, hi)]
    assert cover == live, (length, start, got)
    for lo, hi in got:
        j = lo // p.range_size
        assert lo < hi and (hi - 1) // p.range_size == j < p.n_ranges
    return got


@pytest.mark.parametrize("B,S,Hkv,sms", [(32, 1024, 1, SMS), (1, 1024, 1, SMS), (8, 300, 2, SMS),
                                         (32, 32768, 1, SMS), (3, 512, 1, 1), (4, 48, 2, SMS)])
def test_ranges_cover_each_lane_exactly(B, S, Hkv, sms):
    p = flash_decode.plan(B, S, 4 * Hkv, Hkv, 256, 256, None, sms)
    rs = p.range_size
    assert rs % flash_decode.TILE == 0 and p.n_ranges == -(-S // rs) <= flash_decode.MAX_RANGES
    edges = sorted({0, 1, S - 1, S, S + 5} | {k * rs + d for k in range(p.n_ranges + 1)
                                                for d in (-1, 0, 1)})
    for length in (v for v in edges if v >= 0):
        for start in (0, 1, rs - 1, rs, rs + 1, length - 1, length, length + 3):
            _ranges_ok(p, length, start)
    assert p.ranges(0) == [] and p.ranges(S + 9, S) == []  # a parked lane, a slid-out window
    assert p.ranges(S + 9) == p.ranges(S)  # lengths past the lane are clamped to it


def test_range_size_spreads_full_lanes_over_the_sms():
    """The 1B serving shapes: 64-slot ranges, 16 a lane, 512 CTAs for 32
    full lanes (<= 4 an SM); one lane spreads over the most ranges; a long
    context keeps <= MAX_RANGES a lane."""
    p = flash_decode.plan(32, 1024, 4, 1, 256, 256, None, SMS)
    assert (p.range_size, p.n_ranges, p.stages) == (64, 16, 2)
    assert flash_decode.plan(1, 1024, 4, 1, 256, 256, None, SMS).range_size == 32
    for B, S in ((32, 32768), (1, 1 << 20), (64, 8192)):
        q = flash_decode.plan(B, S, 8, 2, 128, 128, None, SMS)
        assert q.n_ranges <= flash_decode.MAX_RANGES
        assert B * 2 * q.n_ranges <= 4 * SMS or q.range_size == flash_decode.TILE


@pytest.mark.parametrize("page", [16, 32, 48, 256])
@pytest.mark.parametrize("B,nb", [(32, None), (2, None), (5, 2)])
def test_ranges_that_span_pages(page, B, nb):
    """Every range's pages fit the table entries the plan reads; ``nb``
    (nb_cap) walks only the first nb blocks of each lane."""
    S = 1024 if nb is None else nb * page
    p = flash_decode.plan(B, S, 4, 1, 128, 128, page, SMS)
    assert p.slots == S and p.table_slots == (p.range_size - 1) // page + 2
    spans = 0
    for length in range(0, S + 2 * page, 7):
        for start in (0, length - 100, length - page):
            for lo, hi in _ranges_ok(p, length, start):
                pages = (hi - 1) // page - lo // page + 1
                assert pages <= p.table_slots
                spans += pages > 1
    if page < p.range_size or page % p.range_size:
        assert spans > 0  # the case is exercised
    if nb is not None:  # truncation: nothing past nb * page
        assert p.ranges(10 * S)[-1][1] == S


def test_scratch_counters_and_shared_memory():
    for B, S, H, Hkv, D, page in ((32, 1024, 4, 1, 256, None), (3, 300, 8, 1, 128, 16),
                                  (8, 600, 16, 2, 256, 48), (1, 64, 2, 2, 72, None)):
        p = flash_decode.plan(B, S, H, Hkv, D, D, page, SMS)
        G = H // Hkv
        if p.n_ranges > 1:
            assert p.part_floats == B * Hkv * p.n_ranges * G * (D + 2)
            assert p.counters == B * Hkv
        else:
            assert p.part_floats == p.counters == 0
        # csrc/flash_decode.cu layout(): the ring, q, p values, m/l/alpha,
        # the combine's (m, l), table entries, barriers; the P.V slot groups'
        # sums over the ring where they fit
        ring = p.stages * flash_decode.TILE * 4 * D
        red = 128 // (32 if D > 128 else 16 if D > 64 else 8) * G * D * 4
        a16 = lambda v: -(-v // 16) * 16  # noqa: E731
        need = (ring + G * D // 8 * 48 + 32 * -(-G // 4) * 16 + 96 + a16(8 * p.n_ranges * G)
                + a16(4 * p.table_slots) + 16 * p.stages + 16 + (red if red > ring else 0))
        assert p.smem == need <= flash_decode.SMEM_MAX
    # the 1B serving shapes: three CTAs an SM (228 KB, 1 KB reserved a CTA)
    p = flash_decode.plan(32, 1024, 4, 1, 256, 256, 256, SMS)
    assert 3 * (p.smem + 1024) <= 228 * 1024
    # the largest geometry still fits a block
    assert flash_decode.plan(1, 1 << 20, 64, 8, 256, 256, 16, SMS).smem <= flash_decode.SMEM_MAX


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("geom", ["1b", "4b", "12b"])
def test_plan_at_shard_heads(geom, n):
    """A rank's heads on the sharded per-op route (parallel/sharding.py):
    the KV heads split over n ranks where they divide (H / n query heads
    over Hkv / n KV heads, the same group), else the cache stays whole. The
    plan takes both, dense at the 1B serving lanes and paged, its ranges
    cover a lane, and the shared memory fits."""
    import chip_smoke

    g = {"1b": chip_smoke.GEOM_1B, "4b": chip_smoke.GEOM_4B, "12b": chip_smoke.GEOM_12B}[geom]
    H, Hkv, d = g["n_head"], g["n_head_kv"], g["head_dim"]
    split = Hkv % n == 0
    assert split == ((geom, n) != ("1b", 2) and (geom, n) != ("1b", 4))
    h, hkv = (H // n, Hkv // n) if split else (H, Hkv)
    for B, S, page in ((32, 1024, None), (1, 4096, None), (16, 1024, 256)):
        p = flash_decode.plan(B, S, h, hkv, d, d, page, SMS)
        assert p.smem <= flash_decode.SMEM_MAX
        _ranges_ok(p, S - 3, 0)
        if page is None and p.n_ranges > 1:
            assert p.counters == B * hkv


@pytest.mark.parametrize("args", [
    (0, 64, 4, 1, 128, 128, None),    # no lanes
    (2, 0, 4, 1, 128, 128, None),     # no slots
    (2, 64, 18, 2, 128, 128, None),   # 9 q heads per KV head
    (2, 64, 6, 4, 128, 128, None),    # H not a multiple of Hkv
    (2, 64, 4, 1, 264, 128, None),    # Dk past 256
    (2, 64, 4, 1, 128, 100, None),    # Dv not a multiple of 8
    (2, 64, 4, 1, 0, 128, None),
    (2, 64, 4, 1, 128, 128, 0),       # page 0
])
def test_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        flash_decode.plan(*args, SMS)


# -- the range split's plain twin --------------------------------------------------


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    tol = 1e-5 * max(1.0, np.abs(want).max())
    assert err <= tol, f"max abs err {err} > {tol}"


@pytest.mark.parametrize("sms", [SMS, 8, 1])  # range sizes 32, 64 and 256
@pytest.mark.parametrize("case", ["plain", "softcap", "windows"])
def test_ranges_twin_matches_jax_and_plain(case, sms):
    rng = np.random.default_rng(3)
    B, S, hkv, group, D = 4, 256, 2, 2, 128
    q = (rng.standard_normal((B, hkv * group, D)) * (3.0 if case == "softcap" else 1.0))
    q = q.astype(np.float32)
    k = _bf16(rng.standard_normal((B, S, hkv, D)))
    v = _bf16(rng.standard_normal((B, S, hkv, D)))
    lengths = np.array([256, 0, 97, 33], np.int32)
    starts = np.maximum(lengths - 70, 0).astype(np.int32) if case == "windows" else None
    softcap = 30.0 if case == "softcap" else 0.0
    rs = flash_decode.plan(B, S, hkv * group, hkv, D, D, None, sms).range_size
    assert rs == {SMS: 32, 8: 64, 1: 256}[sms]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tl = torch.from_numpy(lengths)
    ts = None if starts is None else torch.from_numpy(starts)
    got = flash_decode.flash_decode_ranges_plain(tq, tk.to(torch.bfloat16), tv.to(torch.bfloat16),
                                                 tl, ts, softcap=softcap, range_size=rs)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
                            jnp.asarray(v, jnp.bfloat16), jnp.asarray(lengths),
                            None if starts is None else jnp.asarray(starts), block=128,
                            softcap=softcap, interpret=True)
    assert np.isfinite(got.numpy()).all() and not got[1].any()
    _close(got.numpy(), want)
    _close(got.numpy(), flash_decode.flash_decode_plain(tq, tk, tv, tl, ts, softcap=softcap))


@pytest.mark.parametrize("case", ["plain", "softcap_windows", "nb_cap"])
def test_ranges_twin_matches_jax_paged(case):
    """Through a shuffled page table (32-slot pages, ranges of 32 and 64):
    the gathered lanes through the twin against the JAX paged kernel."""
    rng = np.random.default_rng(4)
    B, NB, page, N, hkv, group, D = 4, 4, 32, 18, 1, 4, 128
    q = rng.standard_normal((B, hkv * group, D)).astype(np.float32)
    k = _bf16(rng.standard_normal((N, page, hkv, D)))
    v = _bf16(rng.standard_normal((N, page, hkv, D)))
    table = rng.permutation(N)[: B * NB].reshape(B, NB).astype(np.int32)
    table[1] = N  # the parked lane's sentinels
    lengths = np.array([128, 0, 70, 1], np.int32)
    kw = {}
    if case == "softcap_windows":
        kw = dict(softcap=20.0, starts=np.maximum(lengths - 40, 0).astype(np.int32))
    nb_cap = 2 if case == "nb_cap" else None
    want = jax_paged_flash(jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
                           jnp.asarray(v, jnp.bfloat16), jnp.asarray(table), jnp.asarray(lengths),
                           None if "starts" not in kw else jnp.asarray(kw["starts"]),
                           softcap=kw.get("softcap", 0.0), nb_cap=nb_cap, interpret=True)
    nb = flash_decode.walked_blocks(torch.from_numpy(table), nb_cap)
    kd = flash_decode.gather_pages(torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(table),
                                   nb)
    vd = flash_decode.gather_pages(torch.from_numpy(v).to(torch.bfloat16), torch.from_numpy(table),
                                   nb)
    for sms in (SMS, 1):
        rs = flash_decode.plan(B, nb * page, hkv * group, hkv, D, D, page, sms).range_size
        got = flash_decode.flash_decode_ranges_plain(
            torch.from_numpy(q), kd, vd, torch.from_numpy(lengths),
            None if "starts" not in kw else torch.from_numpy(kw["starts"]),
            softcap=kw.get("softcap", 0.0), range_size=rs)
        assert not got[1].any()
        _close(got.numpy(), want)
