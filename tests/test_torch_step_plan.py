"""The capacity step's launch plan and the whole steps' eligibility, on the CPU.

The capacity step (csrc/fused_decode_stream.cu) streams each GEMV phase as
tiles of a block's rows by a slab of columns, cut by
``fused_decode_stream.plan``, a pure function of the shapes, the formats and
the grid. These tests hold it on the CPU in seconds:

- every row and column of every phase is in exactly one tile of exactly one
  block, at the Gemma-3 1B, 4B, 12B and 27B widths in serve-q (int8) and
  serve-q4 (nibbles with Q4_K offsets, and Q4_0 nibbles with f32 or raw
  f16 scales), on a grid of 132 blocks (12B also on 114);
- each tile fits its stage, its quants are whole 128-byte boxes that its
  row groups' warps split by 32-byte pieces, its scale box rows are whole
  16-byte pieces (f16 scales too), the ring holds at least three
  stages and its shared memory stays within the 227 KB of a block (1 KB
  kept for the static schedule);
- the whole steps' plans (the rowq8 and lossless steps at the 1B and a
  D-1536 width, on one chip and a tensor-parallel rank's at 2 and 4 ranks;
  the gemma4 rowq8 step's eight phases at GEOM_G4, its prologue dealt out
  over the grid), and a rowq8 tile being its quants alone;
- the capacity step's eligibility (``decode_stream_supported`` on weights,
  ``stream_supported_from_directory`` on a tensor directory) and the
  batched steps' (``batch_supported``, ``batch_paged_supported``) answer as
  before at the fixtures' and chip_smoke's geometries.
"""

import dataclasses

import pytest
import torch

import chip_smoke
from llm_inference_tpu_torch.gguf import GGMLType, GGUFFile
from llm_inference_tpu_torch.models.weights import (LayerWeights, ModelWeights, fuse_projections,
                                                    load_weights, stack_layers)
from llm_inference_tpu_torch.ops.kernels import fused_decode_batch, fused_decode_batch_paged
from llm_inference_tpu_torch.ops.kernels import fused_decode_stream as fds
from llm_inference_tpu_torch.quant.device import DenseTensor, Q4Tensor, QuantTensor

from fixtures import build_gemma3_gguf
from test_torch_capacity import GEOMETRIES, _directory

V = 262144
# per phase (QKV, Wo, gate/up, down, logits): format (0 int8, 1 nibbles, 2
# bf16), group size, offsets, scale bytes (2: raw f16) -- chip_smoke's phase
# 13 weights and the tame checkpoints' Q4_0, with f32 or f16 scales
FORMATS = {
    "serve-q int8": [(0, 32, False, 4)] * 3 + [(0, 16, False, 4), (2, 0, False, 4)],
    "serve-q4 nibble+offsets": [(1, 32, True, 4)] * 3 + [(0, 16, False, 4), (2, 0, False, 4)],
    "serve-q4 Q4_0": [(1, 32, False, 4)] * 4 + [(2, 0, False, 4)],
    "serve-q4 Q4_0 f16 scales": [(1, 32, False, 2)] * 4 + [(2, 0, False, 4)],
}


def _dims(geom: dict) -> dict:
    D, F, H, Hkv, d = (geom[k] for k in ("n_embd", "n_ff", "n_head", "n_head_kv", "head_dim"))
    return dict(D=D, F=F, A=H * d, Rq=H * d + 2 * Hkv * d, V=V, H=H, Hkv=Hkv, dk=d, dv=d)


@pytest.mark.parametrize("geom,grid", [("1b", 132), ("4b", 132), ("12b", 132), ("27b", 132),
                                       ("12b", 114)])
@pytest.mark.parametrize("fmts", list(FORMATS))
def test_stream_plan_covers_every_row_and_column_once(geom, grid, fmts):
    dims = _dims(GEOMETRIES[geom])
    p = fds.plan(**dims, fmts=FORMATS[fmts], grid=grid)
    for k, (R, C) in enumerate(fds.phase_shapes(dims["D"], dims["F"], dims["A"], dims["Rq"], V)):
        rows = torch.zeros(R, dtype=torch.int32)
        for blk in range(grid):
            cols_by_row = {}
            for row0, nrow, c0, ncol in fds.plan_tiles(p, k, R, C, grid, blk):
                assert 1 <= nrow <= p.rb[k] and 1 <= ncol <= p.cs[k]
                assert c0 % 128 == 0 and ncol % 128 == 0
                cols_by_row[row0] = cols_by_row.get(row0, 0) + ncol
                rows[row0:row0 + nrow] += 1
            assert all(v == C for v in cols_by_row.values())  # every column, once
        assert bool((rows == len(range(0, C, p.cs[k]))).all())  # every row, in each slab


@pytest.mark.parametrize("geom", ["1b", "4b", "12b", "27b"])
@pytest.mark.parametrize("fmts", list(FORMATS))
def test_stream_plan_fits_stages_boxes_and_shared_memory(geom, fmts):
    dims = _dims(GEOMETRIES[geom])
    p = fds.plan(**dims, fmts=FORMATS[fmts], grid=132)
    assert 3 <= p.stages <= 8 and p.stage_bytes % 1024 == 0 and p.stage_bytes <= 36864
    for k, (fmt, gs, off, sb) in enumerate(FORMATS[fmts]):
        assert p.rb[k] in (16, 32, 64) and p.cs[k] % 128 == 0
        assert fds.tile_bytes(fmt, gs, off, k == 2, p.rb[k], p.cs[k], sb) <= p.stage_bytes
        # whole 128-byte boxes, split over a row group's warps by 32-byte pieces
        qbytes = fds._plane_bytes(fmt, gs, 0, p.cs[k])
        kp = 16 // (p.rb[k] // 8 if k == 2 else p.rb[k] // 16)
        assert qbytes % 128 == 0 and qbytes % (32 * kp) == 0
        assert p.cs[k] % fds.slab_unit(fmt, k == 2, p.rb[k]) == 0
        assert fmt == 2 or p.cs[k] % gs == 0
        # a scale box's rows: whole 16-byte pieces (a tensor copy's least)
        assert fmt == 2 or fds._plane_bytes(fmt, gs, 1, p.cs[k], sb) % 16 == 0
    D, F, A, Rq, H, Hkv, dk, dv = (dims[x] for x in ("D", "F", "A", "Rq", "H", "Hkv", "dk", "dv"))
    assert p.smem == fds.plan_smem(D, F, A, Rq, H, Hkv, dk, dv, p.stage_bytes, p.stages)
    assert p.smem <= 232448 - 1024
    # no more stages fit (up to eight): the ring takes what the geometry leaves
    assert p.stages == 8 or fds.plan_smem(D, F, A, Rq, H, Hkv, dk, dv, p.stage_bytes,
                                          p.stages + 1) > 232448 - 1024
    # three of the plan's stages take what the eligibility bound counts (three
    # full 36 KB stages beside the arrays), give or take the ring's alignment
    # and the row sums (2 KB)
    assert fds.plan_smem(D, F, A, Rq, H, Hkv, dk, dv, p.stage_bytes, 3) <= fds.smem_bytes(
        D, F, A, Rq, H, Hkv, dk, dv) + 2048


@pytest.mark.parametrize("geom", ["1b", "4b", "12b", "27b"])
def test_f16_scale_plan_cuts_the_f32_tiles(geom):
    """Q4_0 nibbles with raw f16 scales are cut into the f32 scales' tiles
    (every f32 sum in the same order: the step bit-equal), in stages no
    larger."""
    dims = _dims(GEOMETRIES[geom])
    p32 = fds.plan(**dims, fmts=FORMATS["serve-q4 Q4_0"], grid=132)
    p16 = fds.plan(**dims, fmts=FORMATS["serve-q4 Q4_0 f16 scales"], grid=132)
    assert (p16.rb, p16.cs) == (p32.rb, p32.cs)
    assert p16.stage_bytes <= p32.stage_bytes and p16.stages >= p32.stages


def test_stream_plan_takes_whole_shares_and_wide_slabs_at_12b():
    """At 12B a block's share of a layer phase is one to four row blocks of
    at most 64 rows, and every slab holds at least 512 columns."""
    dims = _dims(GEOMETRIES["12b"])
    for fmts in FORMATS.values():
        p = fds.plan(**dims, fmts=fmts, grid=132)
        for k, (R, C) in enumerate(fds.phase_shapes(dims["D"], dims["F"], dims["A"],
                                                    dims["Rq"], V)):
            share = -(-R // 132)
            assert k == 4 or 1 <= -(-share // p.rb[k]) <= 4
            assert p.cs[k] >= 512


@pytest.mark.parametrize("geom", ["4b", "12b", "27b"])
@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_K", "Q6_K", "Q8_0"])
@pytest.mark.parametrize("q4", [False, True])
def test_stream_eligibility_at_capacity_geometries(geom, fmt, q4):
    """As before the tile plan: every capacity geometry is eligible, from the
    directory and from the shapes, and a cache past int32 positions is not."""
    d, hp = _directory(GEOMETRIES[geom], GGMLType[fmt])
    assert fds.stream_supported_from_directory(d, hp, q4=q4, max_seq=8192)
    assert not fds.stream_supported_from_directory(d, hp, q4=q4, max_seq=1 << 31)
    g = fds.directory_geometry(d, hp, q4=q4, layers=1)
    assert fds._geometry_fits(hp, max_seq=8192, **g)


def _meta_rowq8(hp, *, L: int = 1) -> ModelWeights:
    """Stacked rowq8 weights of ``hp``'s shapes on the meta device (no
    memory): what the eligibility rules read."""
    D, F = hp.embedding_length, hp.feed_forward_length
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
    Rq = H * dk + Hkv * (dk + dv)

    def q(rows, cols, lead=(L,)):
        return QuantTensor(q=torch.empty((*lead, rows, cols), dtype=torch.int8, device="meta"),
                           scale=torch.empty((*lead, rows, 1), device="meta"), fmt=None,
                           rows=rows, cols=cols)

    vec = lambda n: torch.empty((L, n), device="meta")  # noqa: E731
    lw = LayerWeights(attn_norm=vec(D), wo=q(D, H * dv), q_norm=vec(dk), k_norm=vec(dk),
                      ffn_norm=vec(D), w_down=q(D, F), wqkv=q(Rq, D), w_gate_up=q(2 * F, D))
    return ModelWeights(token_embd=q(V, D, lead=()), output_norm=torch.empty(D, device="meta"),
                        layers=lw)


def test_batch_eligibility_at_the_serving_geometries():
    """batch_supported: up to 64 lanes, up to 8 q heads per KV head, head
    dims up to 256, max_seq a multiple of 16; batch_paged_supported: any
    page that is a positive multiple of 16."""
    hp = chip_smoke._hp_1b()
    w = _meta_rowq8(hp)
    for B in (1, 17, 32, 64):
        assert fused_decode_batch.batch_supported(hp, w, batch=B, max_seq=1024)
    assert not fused_decode_batch.batch_supported(hp, w, batch=65, max_seq=1024)
    assert not fused_decode_batch.batch_supported(hp, w, batch=32, max_seq=1000)
    for page in (16, 32, 48, 256, 1024):
        assert fused_decode_batch_paged.batch_paged_supported(hp, w, batch=32, nb=4, page=page)
    for page in (0, 8, 24, 100):
        assert not fused_decode_batch_paged.batch_paged_supported(hp, w, batch=32, nb=4,
                                                                  page=page)
    for G, d, ok in ((8, 128, True), (8, 256, True), (9, 128, False), (2, 384, False)):
        hpg = dataclasses.replace(hp, n_head=G, n_head_kv=1, n_embd_head_k=d, n_embd_head_v=d,
                                  n_embd_head_k_swa=d, n_embd_head_v_swa=d)
        assert fused_decode_batch.batch_supported(hpg, _meta_rowq8(hpg), batch=32,
                                                  max_seq=1024) == ok


def test_batch_eligibility_on_the_fixture():
    hp, w = load_weights(GGUFFile(build_gemma3_gguf(
        n_layers=2, n_embd=256, n_ff=512, n_head=4, n_head_kv=2, head_dim=128)), mode="rowq8")
    w = fuse_projections(w)
    w = dataclasses.replace(w, layers=stack_layers(w.layers))
    assert fused_decode_batch.batch_supported(hp, w, batch=64, max_seq=64)
    assert fused_decode_batch_paged.batch_paged_supported(hp, w, batch=64, nb=4, page=16)
    assert not fused_decode_batch_paged.batch_paged_supported(hp, w, batch=64, nb=0, page=16)
    assert not fds.decode_stream_supported(hp, w)  # per-row int8: not the capacity formats


def test_stream_eligibility_on_meta_weights_at_12b():
    """decode_stream_supported on loaded-weight shapes at 12B (meta tensors):
    int8 and nibble parts in groups of 32, a 16-column down, a bf16
    embedding."""
    hp = chip_smoke.hp_gemma3(**dict(chip_smoke.GEOM_12B, n_layers=2), sliding_window=1024)
    D, F = hp.embedding_length, hp.feed_forward_length
    Rq = hp.n_head * 256 + hp.n_head_kv * 512
    A = hp.n_head * 256

    def grouped(rows, cols, gs, nibble, offsets):
        scale = torch.empty((2, rows, cols // gs), device="meta")
        off = torch.empty((2, rows, cols // gs), device="meta") if offsets else None
        if nibble:
            return Q4Tensor(packed=torch.empty((2, rows, cols // 2), dtype=torch.uint8,
                                               device="meta"), scale=scale,
                            fmt=GGMLType.Q4_K if offsets else GGMLType.Q4_0, offset=off,
                            centered=not offsets, rows=rows, cols=cols, group_size=gs)
        return QuantTensor(q=torch.empty((2, rows, cols), dtype=torch.int8, device="meta"),
                           scale=scale, offset=off, fmt=None, rows=rows, cols=cols,
                           group_size=gs)

    vec = lambda n: torch.empty((2, n), device="meta")  # noqa: E731
    emb = DenseTensor(w=torch.empty((V, D), dtype=torch.bfloat16, device="meta"),
                      fmt=GGMLType.BF16, rows=V, cols=D)
    for nibble in (False, True):
        lw = LayerWeights(attn_norm=vec(D), q_norm=vec(256), k_norm=vec(256), ffn_norm=vec(D),
                          wqkv=grouped(Rq, D, 32, nibble, nibble),
                          wo=grouped(D, A, 32, nibble, nibble),
                          w_gate_up=grouped(2 * F, D, 32, nibble, nibble),
                          w_down=grouped(D, F, 16, False, False))
        w = ModelWeights(token_embd=emb, output_norm=torch.empty(D, device="meta"), layers=lw)
        assert fds.decode_stream_supported(hp, w, max_seq=1024)
        assert not fds.decode_stream_supported(hp, w, max_seq=1 << 31)


# -- the whole-layer lossless steps -------------------------------------------------
# The whole-layer step (csrc/fused_decode_q.cu) and its tensor-parallel
# counterpart (csrc/fused_decode_q_tp.cu) stream their phases through the
# same tiles as the capacity step, cut by the same ``plan`` at their own
# widths: the Gemma-3-1B's, the widest a whole step takes (D and H * dv at
# 1536, fused_decode_q.whole_step_fits) and four q heads a KV head over a
# long down row; a tensor-parallel rank over its shards' widths (Hl = H /
# n q heads, F / n padded to 128, V / n) on its 132 / n blocks, with its
# attention items' q heads G = min(H / Hkv, Hl) and 2 KB kept for the
# kernel's static copies of its Step, format and mesh parameters.

# the whole steps stream the capacity formats and the rowq8 one (format 3:
# per-row int8, its quants alone)
WHOLE_FORMATS = {**FORMATS, "rowq8": [(3, 0, False, 4)] * 5}

WHOLE = {
    "1b": GEOMETRIES["1b"],
    "w1536": dict(n_embd=1536, n_ff=6144, n_head=12, n_head_kv=4, head_dim=128),
    "g4_f24k": dict(n_embd=1024, n_ff=24576, n_head=4, n_head_kv=1, head_dim=256),
}


def _rank_dims(geom: dict, n: int) -> tuple[dict, int]:
    """A tensor-parallel rank's widths (fused_decode_tp.shard_for_tp's
    shards) and its attention items' q heads."""
    dims = _dims(geom)
    if n == 1:
        return dims, dims["H"] // dims["Hkv"]
    H, Hkv, d = dims["H"], dims["Hkv"], dims["dk"]
    Hl = H // n
    Flp = -(-(dims["F"] // n) // 128) * 128
    return dict(dims, F=Flp, A=Hl * d, Rq=Hl * d + 2 * Hkv * d, V=V // n, H=Hl), min(H // Hkv, Hl)


@pytest.mark.parametrize("geom", list(WHOLE))
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("fmts", list(WHOLE_FORMATS))
def test_whole_step_plan_covers_every_row_and_column_once(geom, n, fmts):
    from llm_inference_tpu_torch.ops.kernels import fused_decode_tp

    dims, G = _rank_dims(WHOLE[geom], n)
    grid = 132 // n
    static = 1024 if n == 1 else fused_decode_tp.TILED_STATIC_SMEM
    p = fds.plan(**dims, fmts=WHOLE_FORMATS[fmts], grid=grid, G=G, static_smem=static)
    for k, (R, C) in enumerate(fds.phase_shapes(dims["D"], dims["F"], dims["A"], dims["Rq"],
                                                dims["V"])):
        rows = torch.zeros(R, dtype=torch.int32)
        for blk in range(grid):
            tiles = fds.plan_tiles(p, k, R, C, grid, blk)
            for row0, nrow, c0, ncol in tiles:
                assert row0 % p.rb[k] == 0  # whole tiles: no copy carries another block's rows
                assert 1 <= nrow <= p.rb[k] and 1 <= ncol <= p.cs[k] and c0 % 128 == 0
                rows[row0:row0 + nrow] += 1
        assert bool((rows == len(range(0, C, p.cs[k]))).all())  # every row, in each slab
        # a row's quants are whole 64-byte blocks (the 128-byte ones where they fit)
        fmt = WHOLE_FORMATS[fmts][k][0]
        assert fds._plane_bytes(fmt, 32, 0, C) % 64 == 0


@pytest.mark.parametrize("geom", list(WHOLE))
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("fmts", list(WHOLE_FORMATS))
def test_whole_step_plan_fits_stages_and_shared_memory(geom, n, fmts):
    from llm_inference_tpu_torch.ops.kernels import fused_decode_tp

    dims, G = _rank_dims(WHOLE[geom], n)
    static = 1024 if n == 1 else fused_decode_tp.TILED_STATIC_SMEM
    p = fds.plan(**dims, fmts=WHOLE_FORMATS[fmts], grid=132 // n, G=G, static_smem=static)
    assert 2 <= p.stages <= 8 and p.stage_bytes % 1024 == 0 and p.stage_bytes <= 36864
    for k, (fmt, gs, off, sb) in enumerate(WHOLE_FORMATS[fmts]):
        assert p.rb[k] in (16, 32, 64) and p.cs[k] % fds.slab_unit(fmt, k == 2, p.rb[k]) == 0
        assert fds.tile_bytes(fmt, gs, off, k == 2, p.rb[k], p.cs[k], sb) <= p.stage_bytes
    D, F, A, Rq, H, Hkv, dk, dv = (dims[x] for x in ("D", "F", "A", "Rq", "H", "Hkv", "dk", "dv"))
    assert p.smem == fds.plan_smem(D, F, A, Rq, H, Hkv, dk, dv, p.stage_bytes, p.stages, G)
    assert p.smem <= 232448 - static
    assert p.stages == 8 or fds.plan_smem(D, F, A, Rq, H, Hkv, dk, dv, p.stage_bytes,
                                          p.stages + 1, G) > 232448 - static
    # the PV partials of G heads fit beside the GEMV activation in one region
    assert fds.plan_smem(D, F, A, Rq, H, Hkv, dk, dv, 1024, 1, G) >= 4 * 16 * G * dv


def test_whole_step_plan_at_1b_deals_out_whole_tiles():
    """At 1B a QKV, Wo or down tile is 16 rows and gate/up 32 pairs: 96, 72
    and 72 blocks take one of the first three, the gate/up tiles go one or
    two a block, and two ranks of 66 blocks each take their shards the same
    way; the ring holds four stages on one chip, more on a rank (its G of 2
    or 1 q heads halve or quarter the PV partials)."""
    dims, G = _rank_dims(WHOLE["1b"], 1)
    p = fds.plan(**dims, fmts=FORMATS["serve-q int8"], grid=132)
    assert p.rb == (16, 16, 32, 16, 32) and p.stages == 4
    shapes = fds.phase_shapes(dims["D"], dims["F"], dims["A"], dims["Rq"], V)
    busy = [sum(1 for b in range(132) if fds.plan_tiles(p, k, R, C, 132, b)) for k, (R, C)
            in enumerate(shapes)]
    assert busy[:4] == [96, 72, 132, 72]
    most = max(len({t[0] for t in fds.plan_tiles(p, 2, *shapes[2], 132, b)}) for b in range(132))
    assert most == 2
    for n, stages in ((2, 5), (4, 6)):
        dims, G = _rank_dims(WHOLE["1b"], n)
        assert G == 4 // n
        p = fds.plan(**dims, fmts=FORMATS["serve-q int8"], grid=132 // n, G=G,
                     static_smem=2048)
        assert p.stages == stages


def test_rowq8_tile_is_one_plane():
    """A rowq8 tile (format 3) is its int8 quants alone: the rows' scales stay
    in global memory, read where a row's sum is done; a grouped int8 tile
    of the same rows and slab adds its scale plane."""
    for pair in (False, True):
        for rb, cs in ((16, 512), (32, 384), (64, 1152)):
            rows = rb * (2 if pair else 1)
            assert fds.tile_bytes(3, 0, False, pair, rb, cs) == rows * cs
            assert fds.tile_bytes(0, 32, False, pair, rb, cs) == rows * (cs + 4 * (cs // 32))
            assert fds.slab_unit(3, pair, rb) == fds.slab_unit(0, pair, rb)


def test_rowq8_plan_at_1b_deals_out_whole_tiles():
    """The rowq8 step at 1B: QKV, Wo and down tiles of 16 rows go one to a
    block (96, 72 and 72 blocks), gate/up's pairs cover every block, the
    int8 logits rows go in tiles of 64; the ring holds four stages on one
    chip and at least five on a rank of two or four."""
    dims, _ = _rank_dims(WHOLE["1b"], 1)
    p = fds.plan(**dims, fmts=WHOLE_FORMATS["rowq8"], grid=132)
    assert p.rb[:4] == (16, 16, 32, 16) and p.rb[4] == 64
    shapes = fds.phase_shapes(dims["D"], dims["F"], dims["A"], dims["Rq"], V)
    busy = [sum(1 for b in range(132) if fds.plan_tiles(p, k, R, C, 132, b)) for k, (R, C)
            in enumerate(shapes)]
    assert busy == [96, 72, 132, 72, 132]
    assert p.stages == 4
    for n in (2, 4):
        dims, G = _rank_dims(WHOLE["1b"], n)
        assert fds.plan(**dims, fmts=WHOLE_FORMATS["rowq8"], grid=132 // n, G=G,
                        static_smem=2048).stages >= 5


G4 = dict(D=2048, F=4096, A=8 * 256, Rq=8 * 256 + 2 * 512, V=V, H=8, Hkv=2, dk=256, dv=256,
          P=256, L=24)  # chip_smoke.GEOM_G4


@pytest.mark.parametrize("grid", [132, 114])
def test_gemma4_plan_covers_eight_phases_and_spreads_the_prologue(grid):
    """The gemma4 rowq8 step at GEOM_G4 streams eight phases: every row and
    column of each is in one tile of one block; the prologue's 6144 x 2048
    per_layer_model_proj is dealt out over the grid, no block holding
    more than one row block above another (on 132 blocks each holds one or
    two); the per-layer proj's 256-column
    rows fit one slab; the ring fits beside the step's arrays."""
    p = fds.plan(**G4, fmts=[(3, 0, False, 4)] * 8, grid=grid)
    shapes = fds.phase_shapes(G4["D"], G4["F"], G4["A"], G4["Rq"], V, G4["P"], G4["L"])
    assert len(shapes) == len(p.rb) == len(p.cs) == 8 and fds.PHASES[5:] == (
        "per-layer model proj", "per-layer gate", "per-layer proj")
    for k, (R, C) in enumerate(shapes):
        rows = torch.zeros(R, dtype=torch.int32)
        for blk in range(grid):
            for row0, nrow, c0, ncol in fds.plan_tiles(p, k, R, C, grid, blk):
                assert row0 % p.rb[k] == 0 and 1 <= ncol <= p.cs[k] and c0 % 128 == 0
                rows[row0:row0 + nrow] += 1
        assert bool((rows == len(range(0, C, p.cs[k]))).all())
        assert fds.tile_bytes(3, 0, False, k == 2, p.rb[k], p.cs[k]) <= p.stage_bytes
    R, C = shapes[5]
    blocks = [len({t[0] for t in fds.plan_tiles(p, 5, R, C, grid, b)}) for b in range(grid)]
    assert max(blocks) - min(blocks) <= 1 and sum(blocks) == -(-R // p.rb[5])
    assert grid != 132 or min(blocks) >= 1  # on the H100 every block takes some
    assert -(-G4["P"] // p.cs[7]) == 1
    D, F, A, Rq, H, Hkv = (G4[x] for x in ("D", "F", "A", "Rq", "H", "Hkv"))
    assert p.smem == fds.plan_smem(D, F, A, Rq, H, Hkv, 256, 256, p.stage_bytes, p.stages)
    assert p.smem <= 232448 - 1024 and p.stages >= 3
    with pytest.raises(ValueError):  # five formats for eight phases
        fds.plan(**G4, fmts=[(3, 0, False, 4)] * 5, grid=grid)
