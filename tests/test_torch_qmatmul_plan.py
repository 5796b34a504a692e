"""The quant_matmul / q4_matmul kernel's launch plan and the one-hot
dequantization readback, on the CPU.

``qmatmul.plan`` is a pure function of the weight's shape, the token count,
the format and the SM count; csrc/qmatmul.cu takes what it says (and checks
it). Here it is held at the Gemma-3 1B, 4B, 12B and 27B layer shapes and
the gemma4 one (chip_smoke's GEOM_*), every T in 1..64, 16- and 32-column
groups, int8 and nibbles, with and without offsets, and int8 with one scale
a row (the rowwise format), on an H100's 132 SMs:
every column lies in exactly one split, splits start on whole stages and
groups, the shared memory fits a block, and the grid fills the SMs as far
as whole row tiles allow with one block an SM (a second block on an SM
doubles that SM's share of the call), splitting further only where x must
to fit beside the ring.

The one-hot readback runs x made of unit rows through the plain twins: y
must equal ``dequant_bf16_tpu``'s columns bit for bit, over weights whose
quants run through every value of the format and whose scales and offsets
land the bf16 roundings on ties (chip_smoke.onehot_weight; the card test
runs the same helper through the kernels)."""

import pytest
import torch

import chip_smoke
from llm_inference_tpu_torch.ops.kernels import qmatmul

SMS = 132
GEOMS = {"1b": chip_smoke.GEOM_1B, "4b": chip_smoke.GEOM_4B, "12b": chip_smoke.GEOM_12B,
         "27b": chip_smoke.GEOM_27B,
         "g4": dict(chip_smoke.GEOM_G4, head_dim=chip_smoke.GEOM_G4["n_embd"]
                    // chip_smoke.GEOM_G4["n_head"])}


def _smem_need(p, nibble, gs, offsets):
    """csrc/qmatmul.cu qmatmul_grouped's layout: ring quants, scales,
    offsets, x, barriers (no scales in the rowwise ring, gs None)."""
    scale_bytes = 0 if gs is None else p.row_tile * (p.stage_cols // gs) * 4
    return (p.stages * (qmatmul.STAGE_QBYTES + scale_bytes * (2 if offsets else 1))
            + p.x_stages * (p.stage_cols // 16) * (32 * p.n_inst + 16) + 16 * p.stages + 16)


def _hold(R, C, T, nibble, gs, offsets, what):
    """One plan against the kernel's rules."""
    p = qmatmul.plan(R, C, T, nibble, gs, offsets, SMS)
    what = f"{what}: {p}"
    assert p.n_inst == min(n for n in qmatmul.N_INSTANCES if n >= T), what
    assert p.row_tile == 128 and p.stages >= 4, what
    assert p.stage_cols == (256 if nibble else 128), what
    assert p.row_tiles == -(-R // 128) and p.row_stages == -(-C // p.stage_cols)
    # every column once, splits on whole stages and groups, x fits
    ranges = p.split_columns(C)
    assert len(ranges) == p.splits and ranges[0][0] == 0 and ranges[-1][1] == C, what
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0, what
    for c0, c1 in ranges:
        assert c0 < c1 and c0 % p.stage_cols == 0 and c0 % (gs or 1) == 0, what
        assert c1 - c0 <= p.x_stages * p.stage_cols, what
    # shared memory: the kernel's layout fits the block
    assert _smem_need(p, nibble, gs, offsets) <= p.smem <= qmatmul.SMEM_MAX, what
    # each SM keeps at least 32 KB of weights in flight
    assert p.stages * qmatmul.STAGE_QBYTES >= 32 * 1024, what
    # the grid fills the SMs as far as whole row tiles allow, one
    # block an SM (or every stage its own block), and splits no
    # further than x's room asks
    blocks = p.row_tiles * p.splits
    if p.row_tiles <= SMS:
        assert blocks > SMS - p.row_tiles or p.splits == p.row_stages, what
        fit_splits = -(-p.row_stages // p.x_stages)
        assert blocks <= SMS or p.splits == fit_splits, what
    return p


@pytest.mark.parametrize("gs", [16, 32])
@pytest.mark.parametrize("nibble", [False, True], ids=["int8", "nibble"])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_plan_covers_fits_and_fills(geom, nibble, gs):
    for name, (R, C) in chip_smoke.layer_shapes(GEOMS[geom]).items():
        for offsets in (False, True):
            for T in range(1, qmatmul.MAX_T + 1):
                _hold(R, C, T, nibble, gs, offsets, f"{geom} {name} {R}x{C} T={T} "
                      f"offsets={offsets}")


@pytest.mark.parametrize("geom", list(GEOMS))
def test_rowwise_plan_covers_fits_and_fills(geom):
    """The rowwise format: the same rules, a ring without scales (so never
    more splits than the grouped int8 plan, and less shared memory at the
    same split: x's room is larger)."""
    for name, (R, C) in chip_smoke.layer_shapes(GEOMS[geom]).items():
        for T in range(1, qmatmul.MAX_T + 1):
            p = _hold(R, C, T, False, None, False, f"{geom} {name} {R}x{C} T={T} rowwise")
            grouped = qmatmul.plan(R, C, T, False, 32, False, SMS)
            assert p.splits < grouped.splits or (p.splits == grouped.splits
                                                 and p.smem < grouped.smem)
            assert (p.stage_cols, p.n_inst, p.row_tiles) == (grouped.stage_cols, grouped.n_inst,
                                                             grouped.row_tiles)


def test_plan_fills_the_sms_with_few_splits():
    """The 1B shapes at T = 32: as many splits as the SMs hold one block of
    each row tile (gate_up's 108 tiles: none), or all of a row's stages
    where there are fewer (wqkv, wo)."""
    got = {name: qmatmul.plan(R, C, 32, False, 32, False, SMS).splits
           for name, (R, C) in chip_smoke.layer_shapes(GEOMS["1b"]).items()}
    assert got == {"wqkv": 9, "wo": 8, "w_gate_up": 1, "w_down": 14}
    rowwise = {name: qmatmul.plan(R, C, 32, False, None, False, SMS).splits
               for name, (R, C) in chip_smoke.layer_shapes(GEOMS["1b"]).items()}
    assert rowwise == got


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("geom", ["1b", "4b", "12b"])
def test_plan_at_shard_shapes(geom, n):
    """The sharded per-op route's shapes (parallel/sharding.py over n ranks):
    a shard the kernel takes (cols % 128 == 0, as ``supports_kernel`` asks)
    gets a plan that holds the rules, rowwise and grouped, int8 and nibbles;
    one it does not take (1B down over 4 ranks: 6912 / 4 = 1728 columns) is
    refused by the plan too, and takes the dequantized product."""
    shapes = chip_smoke.shard_shapes(GEOMS[geom], n)
    if geom == "1b":
        assert shapes["wk"] == (256 // n, 1152) and shapes["w_down"] == (1152, 6912 // n)
    for name, (R, C) in shapes.items():
        if C % 128:
            assert (geom, n, name) == ("1b", 4, "w_down"), (geom, n, name, C)
            with pytest.raises(ValueError):
                qmatmul.plan(R, C, 1, False, None, False, SMS)
            continue
        for T in (1, 17, 32, 64):
            _hold(R, C, T, False, None, False, f"{geom}/{n} {name} {R}x{C} T={T} rowwise")
            for nibble, gs, offsets in ((False, 32, False), (True, 32, True), (False, 16, False)):
                if not nibble or C % 256 == 0:
                    _hold(R, C, T, nibble, gs, offsets, f"{geom}/{n} {name} {R}x{C} T={T}")


@pytest.mark.parametrize("args", [(64, 128, 0, False, 32), (64, 128, 65, False, 32),
                                  (64, 96, 8, False, 32), (64, 128, 8, True, 64),
                                  (64, 128, 8, True, None), (64, 96, 8, False, None),
                                  (64, 128, 65, False, None)])
def test_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        qmatmul.plan(*args, False, SMS)
    if args[-1] is None:  # rowwise: int8 without offsets only
        with pytest.raises(ValueError):
            qmatmul.plan(64, 128, 8, False, None, True, SMS)


@pytest.mark.parametrize("nibble,gs,offsets", [
    (False, 32, False),  # Q4_0/Q8_0-like int8
    (False, 32, True),   # Q4_K-like int8
    (False, 16, False),  # Q6_K-like int8
    (True, 32, False),   # Q4_0 nibbles, centered
    (True, 32, True),    # Q4_K nibbles, offsets
    (True, 16, True),
])
def test_onehot_readback_is_the_tpu_dequant(nibble, gs, offsets):
    qt = chip_smoke.onehot_weight(200, 512, nibble, gs, offsets, device="cpu")
    fn = qmatmul.q4_matmul if nibble else qmatmul.quant_matmul
    q = qt.quants() if nibble else qt.q
    assert q.unique().numel() == (16 if nibble else 256)
    # the helper's roundings land on ties: bf16(scale), q * bf16(scale), and p - bf16(o)
    tie = lambda v: int(((v.float().view(torch.int32) & 0xFFFF) == 0x8000).sum())  # noqa: E731
    sb = qt.scale.to(torch.bfloat16).double().repeat_interleave(gs, -1)
    prod = q.double() * sb
    assert tie(qt.scale) > 0 and tie(prod) > 0
    if offsets:
        ob = qt.offset.to(torch.bfloat16).double().repeat_interleave(gs, -1)
        assert tie(prod.float().to(torch.bfloat16).double() - ob) > 0
    y = chip_smoke.onehot_readback(fn, qt)
    want = qmatmul.dequant_bf16_tpu(q, qt).float().T
    assert torch.equal(y, want)
    assert qmatmul.grouped_launches == qmatmul.q4_launches == 0
