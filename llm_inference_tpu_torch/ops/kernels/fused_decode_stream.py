"""Capacity whole-step decode: the CUDA kernel (csrc/fused_decode_stream.cu)
and its plain twin.

Replaces llm_inference_tpu/ops/pallas/fused_decode_stream.py::
decode_step_megakernel_stream (:882) for a capacity-class Gemma-3 checkpoint
(the 4B, 12B and 27B widths) served in serve-q or serve-q4: one call runs
the entire single-token forward over the stacked group-scaled layer weights
(int8 ``QuantTensor`` or nibble ``Q4Tensor``, each projection in its own
format and group size, as ``models/weights.py load_capacity_stacked`` loads
them) and the dense bf16 tied embedding, returns the logits [V] (f32, final
softcap left to the caller) and writes the token's bf16 K/V rows in place at
slot ``pos`` of the cache, flat [L, S, Hkv * d] (``init_cache(flat=True)``)
or stacked [L, S, Hkv, d], the same bytes. Numerics are those of the
lossless whole step (fused_decode_stream.py:33-37, fused_decode_q.py), and
the plain twin is that step's, over the same cache viewed 4-D.

Eligibility (``decode_stream_supported`` on loaded weights,
``stream_supported_from_directory`` on a GGUF tensor directory before any
load) follows the JAX package's structural contract with the port's own
limits in place of its VMEM budget: the TPU kernel's tile target
(``_TILE_TARGET``, ``LLMI_STREAM_TILE_KB``), its unrolled-dot cap
(``_MAX_DOTS``) and its logits tile pick (``_pick_tn``) are VMEM and Mosaic
budgets with no counterpart here. The port's limits: 128-aligned widths,
head dims of 128 or 256, at most four q heads per KV head, groups of 16 or
32 columns in whole 4-group scale rows, one weight row of each phase
(gate/up: a pair) within a 36 KB stream stage, and the kernel's shared
memory within 227 KB (``smem_bytes``). The TPU pipeline knobs
``LLMI_STREAM_TILE_KB``, ``LLMI_STREAM_LDEPTH``, ``LLMI_STREAM_DEFER_WB``,
``LLMI_STREAM_EAGER``, ``LLMI_STREAM_NO_ATTN`` and ``LLMI_STREAM_NO_LOGITS``
(fused_decode_stream.py:933-937) tune VMEM tiling and DMA order; they have
no counterpart in this kernel and are ignored, as ``LLMI_PAGED_UNROLL`` is
by the server.

The kernel streams each projection as tiles of rows by a column slab;
``plan`` (a pure function of the shapes, the formats and the grid, held on
the CPU by tests/test_torch_step_plan.py) cuts them and sizes the ring, and
a launch reuses the plan of its weights' formats from the prepared scratch.
Every whole step of the port runs this kernel's body (csrc/whole_step.cuh)
over its own widths and formats, so ``plan``, ``tiled_scratch`` and
``launch_tiled`` serve them all: the rowq8 steps (fused_decode.py, its
gemma4 instance with three more phases), the lossless one
(fused_decode_q.py) and the tensor-parallel ranks (fused_decode_tp.py).

``decode_step_stream`` launches the kernel for CUDA tensors (or raises) and
runs ``decode_step_stream_plain`` for CPU tensors. ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ...gguf.constants import GGMLType
from ...quant.device import DenseTensor, Q4Tensor, QuantTensor
from . import _build, fused_decode
from .fused_decode import DecodeConsts, launch_args, step_dims, step_plain
from .fused_decode_q import (_STAGE_BYTES, _dense_embed, _group_dot, _row_bytes,
                             step_geometry_fits)

launches = 0

KERNEL = "fused_decode_stream"
_STAGES = 3           # full stages the eligibility bound counts (the plan gives at least these)
_MAX_STAGES = 8       # stages a ring may hold (csrc kMaxStreamStages)
_WARPS = 16           # warps a block (kWarps)
_SMEM_LIMIT = 232448  # shared memory a block may use on the H100 (227 KB)
_STATIC_SMEM = 1024   # kept for the kernel's static shared memory (its tile schedule)
_TILE_ROWS = (64, 32, 16)  # rows (gate/up: pairs) a tile may take
_BOX = 128            # quant bytes a row of a swizzled tensor-copy box
_MAX_SEQ = 2**31 - 1  # positions are int32 in the kernel
# the quantized layer formats the port loads as group-scaled weights
# (quant/device.py _PLANAR and _TORCH_PLANAR)
_GROUPED = (GGMLType.Q4_0, GGMLType.Q8_0, GGMLType.Q5_0, GGMLType.Q4_K, GGMLType.Q6_K)
_NIBBLE = (GGMLType.Q4_0, GGMLType.Q4_K)
# the phases by their place in the C entries (csrc/decode_step.cuh Kind):
# every step's five, then gemma4's three
PHASES = ("QKV", "Wo", "gate/up", "down", "logits", "per-layer model proj", "per-layer gate",
          "per-layer proj")
_SOURCE = {"fused_decode_g4": "fused_decode"}  # a kernel's entry prefix -> its csrc source


def _align16(n: int) -> int:
    return (n + 15) & ~15


def smem_bytes(D: int, F: int, A: int, Rq: int, H: int, Hkv: int, dk: int, dv: int) -> int:
    """The eligibility bound on shared memory: the step's arrays beside a
    ring of three full 36 KB stages, as the whole-row stream of earlier
    versions laid them out (``plan`` always finds at least as much room)."""
    G = H // Hkv
    work = max(2 * max(D, A, F), 4 * Rq, 4 * _WARPS * G * dv)
    arrays = [4 * D, 4 * D, work, 4 * 32, 4 * 2 * H, 2 * H * dk, 2 * Hkv * dk, 2 * Hkv * dv,
              4 * (max(D, A, F) // 16), 4 * 2 * _WARPS]
    return sum(_align16(n) for n in arrays) + _STAGES * _STAGE_BYTES + _align16(8 * _STAGES)


def plan_smem(D: int, F: int, A: int, Rq: int, H: int, Hkv: int, dk: int, dv: int,
              stage_bytes: int, stages: int, G: int | None = None) -> int:
    """Dynamic shared memory of the kernel with a ring of ``stages`` stages
    of ``stage_bytes`` (csrc stream_layout, byte for byte); ``G``: the q
    heads an attention work item holds (H / Hkv; a tensor-parallel rank's
    share of a KV group)."""
    G = H // Hkv if G is None else G
    work = max(2 * max(D, A, F), 4 * Rq, 4 * _WARPS * G * dv)
    arrays = [4 * D, 4 * D, work, 4 * 32, 4 * 2 * H, 2 * H * dk, 2 * Hkv * dk, 2 * Hkv * dv,
              4 * (max(D, A, F) // 16), 8 * stages, 4 * _WARPS * 16]
    # the ring last, with room to start it on a 1024-byte boundary
    return sum(_align16(n) for n in arrays) + 1024 + stages * stage_bytes


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """The kernel's tile cut: per phase (``PHASES``) the rows of a tile
    (gate/up: row pairs) and the columns of its slab; the ring's stage
    bytes and stage count; the dynamic shared memory they give."""
    rb: tuple
    cs: tuple
    stage_bytes: int
    stages: int
    smem: int

    def ints(self) -> list:
        return [*self.rb, *self.cs, self.stage_bytes, self.stages]


def _plane_bytes(fmt: int, gs: int, j: int, cols: int, sbytes: int = 4) -> int:
    if j == 0:
        return cols // 2 if fmt == 1 else 2 * cols if fmt == 2 else cols
    return (sbytes if j == 1 else 4) * (cols // gs)


def tile_bytes(fmt: int, gs: int, offsets: bool, pair: bool, rb: int, cs: int,
               sbytes: int = 4) -> int:
    """A tile's bytes in its stage: rb rows (gate/up: rb gate and rb up
    rows) of a cs-column slab of every plane (csrc tile_bytes): bf16 and
    per-row int8 tiles have their quants alone, the grouped ones their
    scales (``sbytes`` a group) and offsets (4) too."""
    planes = 1 if fmt in (2, 3) else 3 if offsets else 2
    return rb * (2 if pair else 1) * sum(_plane_bytes(fmt, gs, j, cs, sbytes)
                                         for j in range(planes))


def phase_shapes(D: int, F: int, A: int, Rq: int, V: int, P: int = 0, L: int = 0) -> list:
    """Per phase (``PHASES``) its rows (gate/up: pairs) and columns; with
    gemma4's per-layer input of width P (and L layers), its three too."""
    shapes = [(Rq, D), (D, A), (F, D), (D, F), (V, D)]
    return shapes + ([(L * P, D), (P, D), (D, P)] if P else [])


def slab_unit(fmt: int, pair: bool, rb: int) -> int:
    """The columns a slab is a multiple of (csrc consume_tiles): whole
    128-byte boxes of quants, split over the 16 / NG warps of a 16-row group
    (gate/up: 8 pairs) by whole 32-byte pieces, and 128 columns. A nibble
    slab is thus a multiple of 256 columns: 8 groups of 32, whose f16
    scales are the 16 bytes a tensor-copy box row needs."""
    kp = _WARPS // (rb // 8 if pair else rb // 16)
    unit_bytes = max(_BOX, 32 * kp)
    cols = 2 * unit_bytes if fmt == 1 else unit_bytes // 2 if fmt == 2 else unit_bytes
    return -(-cols // 128) * 128


def plan(*, D: int, F: int, A: int, Rq: int, V: int, H: int, Hkv: int, dk: int, dv: int,
         fmts, grid: int, G: int | None = None, static_smem: int = _STATIC_SMEM, P: int = 0,
         L: int = 0) -> StreamPlan:
    """The tile cut of one step of the whole steps (this one, the rowq8 and
    lossless whole-layer steps of fused_decode.py and fused_decode_q.py and
    a tensor-parallel rank's over its own widths; a pure function of
    shapes, formats and the grid). ``fmts``: per phase (``PHASES``; the
    first five, or with gemma4's P and L all eight) (format, group size,
    offsets, scale bytes), format 0 grouped int8, 1 nibble pairs, 2 bf16
    (the logits), 3 per-row int8 (rowq8: the quants alone stream), and 2
    scale bytes for raw f16 group scales, else 4. Each phase takes the
    most rows a tile (of ``_TILE_ROWS``, no more than a block's share
    needs) whose stage holds a slab of at least 512 columns (else 16
    rows), and slabs of equal width (a multiple of ``slab_unit``)
    within one 36 KB stage; the stage is the largest tile, and the ring
    holds as many stages as the shared memory leaves room for (less
    ``static_smem`` for the kernel's static arrays), up to eight. ``G`` as
    in ``plan_smem``. Tiles are cut at f32 scales whatever the scale
    bytes, so f16 scales take the f32 scales' tiles, and with them the
    order of every f32 sum (the step's results bit-equal); only their
    stages carry fewer bytes."""
    rbs, css, biggest = [], [], 0
    shapes = phase_shapes(D, F, A, Rq, V, P, L)
    if len(fmts) != len(shapes):
        raise ValueError(f"{KERNEL}: {len(fmts)} phase formats for {len(shapes)} phases")
    for k, ((R, C), (fmt, gs, off, sbytes)) in enumerate(zip(shapes, fmts)):
        pair = k == 2
        share = -(-R // grid)
        need = -(-share // 16) * 16
        pick = None
        for rb in _TILE_ROWS:
            if rb > need and rb != 16:
                continue
            unit = slab_unit(fmt, pair, rb)
            per_unit = tile_bytes(fmt, gs, off, pair, rb, unit)
            cs_max = min(-(-C // unit) * unit, _STAGE_BYTES // per_unit * unit)
            if cs_max >= min(512, C) or rb == 16:
                pick = (rb, unit, cs_max)
                break
        rb, unit, cs_max = pick
        n_sl = -(-C // cs_max)
        per = -(-C // n_sl)  # equal slabs, each a multiple of the unit
        cs = -(-per // unit) * unit
        rbs.append(rb)
        css.append(cs)
        biggest = max(biggest, tile_bytes(fmt, gs, off, pair, rb, cs, sbytes))
    stage = -(-biggest // 1024) * 1024
    budget = _SMEM_LIMIT - static_smem
    for stages in range(_MAX_STAGES, 1, -1):
        smem = plan_smem(D, F, A, Rq, H, Hkv, dk, dv, stage, stages, G)
        if smem <= budget:
            return StreamPlan(tuple(rbs), tuple(css), stage, stages, smem)
    raise ValueError(f"{KERNEL}: no ring of two {stage}-byte stages fits the shared memory")


def plan_tiles(p: StreamPlan, k: int, R: int, C: int, grid: int, blk: int) -> list:
    """Block ``blk``'s tiles of phase ``k`` in stream order: (row0, rows,
    col0, cols) each (csrc make_tsched / issue_tile): the phase's row
    blocks dealt out whole, in order, as evenly as whole blocks go."""
    rb, cs = p.rb[k], p.cs[k]
    nt = -(-R // rb)
    r0, r1 = min(R, blk * nt // grid * rb), min(R, (blk + 1) * nt // grid * rb)
    out = []
    for row0 in range(r0, r1, rb):
        for c0 in range(0, C, cs):
            out.append((row0, min(rb, r1 - row0), c0, min(cs, C - c0)))
    return out


def _geometry_fits(hp, *, D: int, F: int, A: int, Rq: int, parts, max_seq) -> bool:
    """The port kernel's limits (module docstring): the single-stream
    steps' shared ones (``fused_decode_q.step_geometry_fits``), one bf16
    embedding row a stage, the shared memory, and int32 positions."""
    if max_seq is not None and not 0 < max_seq <= _MAX_SEQ:
        return False
    if 2 * D > _STAGE_BYTES or not step_geometry_fits(hp, D=D, F=F, A=A, Rq=Rq, parts=parts):
        return False
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
    return smem_bytes(D, F, A, Rq, H, Hkv, dk, dv) <= _SMEM_LIMIT


def _stream_row_bytes(cols: int, gs: int, nibble: bool, offsets: bool) -> int:
    return (cols // 2 if nibble else cols) + 4 * (cols // gs) * (2 if offsets else 1)


def directory_geometry(gguf, hp, *, q4: bool, layers: int | None = None) -> dict | None:
    """The shapes the step kernels' limits read, from the GGUF tensor
    directory alone: {D, F, A, Rq, parts}, ``parts`` per phase (QKV, Wo,
    gate/up, down) the bytes of one stream row in the port's layout (nibble
    pairs for Q4_0/Q4_K when ``q4``), its group size and its columns. None
    unless the seven projections of the first ``layers`` layers (all by
    default) are present and in one group-scaled format, with the fused
    shapes of a Gemma-3 layer."""
    infos = {i.name: i for i in gguf.tensor_infos}
    names = ("attn_q.weight", "attn_k.weight", "attn_v.weight", "attn_output.weight",
             "ffn_gate.weight", "ffn_up.weight", "ffn_down.weight")
    fmt = None
    for l in range(hp.block_count if layers is None else layers):
        for n in names:
            info = infos.get(f"blk.{l}.{n}")
            if info is None:
                return None
            f = GGMLType(info.tensor_type)
            if f not in _GROUPED or (fmt is not None and f != fmt):
                return None
            fmt = f
    if fmt is None or "token_embd.weight" not in infos:
        return None
    gs = 16 if fmt == GGMLType.Q6_K else 32
    nibble = q4 and fmt in _NIBBLE
    offsets = fmt == GGMLType.Q4_K
    D = hp.embedding_length
    b0 = {n: infos[f"blk.0.{n}"] for n in names}
    A, F = b0["attn_output.weight"].n_cols, b0["ffn_down.weight"].n_cols
    if any(b0[n].n_cols != D for n in names[:3] + names[4:6]) or b0["ffn_gate.weight"].n_rows != F \
            or b0["ffn_up.weight"].n_rows != F or infos["token_embd.weight"].n_cols != D:
        return None
    if b0["attn_output.weight"].n_rows != D or b0["ffn_down.weight"].n_rows != D:
        return None
    Rq = sum(b0[n].n_rows for n in names[:3])
    parts = [(_stream_row_bytes(c, gs, nibble, offsets), gs, c) for c in (D, A, D, F)]
    return dict(D=D, F=F, A=A, Rq=Rq, parts=parts)


def stream_supported_from_directory(gguf, hp, *, q4: bool, max_seq) -> bool:
    """Eligibility from the GGUF tensor directory alone (no tensor data
    read), the counterpart of fused_decode_stream.py:167-248: a Gemma-3
    checkpoint whose seven layer projections are all in one group-scaled
    format over every layer (load_capacity_stacked refuses mixed layers),
    with the q/k norms, the embedding and the output norm present, and
    geometry within the kernel's limits. The embedding loads as dense bf16
    from any format, as the JAX capacity load makes it. A False is final; a
    True is confirmed by ``decode_stream_supported`` after the load."""
    if hp.architecture != "gemma3" or hp.embedding_length_per_layer:
        return False
    if hp.f_max_alibi_bias > 0.0:
        return False
    if hp.n_embd_head_k != hp.n_embd_head_k_swa or hp.n_embd_head_v != hp.n_embd_head_v_swa:
        return False
    names = {i.name for i in gguf.tensor_infos}
    if not {"output_norm.weight", "blk.0.attn_q_norm.weight", "blk.0.attn_k_norm.weight"} <= names:
        return False
    geom = directory_geometry(gguf, hp, q4=q4)
    return geom is not None and _geometry_fits(hp, max_seq=max_seq, **geom)


def decode_stream_supported(hp, w, *, max_seq=None) -> bool:
    """Eligibility of the capacity step on loaded weights, the counterpart
    of fused_decode_stream.py:251-292: stacked Gemma-3 layers whose four
    fused projections are group-scaled (an int8 ``QuantTensor`` with more
    than one group a row, or a ``Q4Tensor``), a dense bf16 tied embedding,
    q/k norms, no ALiBi, uniform head dims, within the kernel's limits."""
    from ...models.weights import LayerWeights

    lw = w.layers
    if not isinstance(lw, LayerWeights) or hp.architecture != "gemma3":
        return False
    if hp.f_max_alibi_bias > 0.0 or hp.embedding_length_per_layer:
        return False
    parts = [lw.wqkv, lw.wo, lw.w_gate_up, lw.w_down]
    if not all(isinstance(p, Q4Tensor) or (isinstance(p, QuantTensor) and p.groups > 1)
               for p in parts):
        return False
    emb = w.token_embd
    if not (isinstance(emb, DenseTensor) and emb.w.dtype == torch.bfloat16):
        return False
    if lw.q_norm is None or lw.k_norm is None:
        return False
    if hp.n_embd_head_k != hp.n_embd_head_k_swa or hp.n_embd_head_v != hp.n_embd_head_v_swa:
        return False
    D, F, A = hp.embedding_length, lw.w_down.cols, lw.wo.cols
    if emb.cols != D or lw.wqkv.cols != D or lw.w_gate_up.cols != D:
        return False
    if lw.w_gate_up.rows != 2 * F or lw.w_down.rows != D or lw.wo.rows != D:
        return False
    return _geometry_fits(hp, D=D, F=F, A=A, Rq=lw.wqkv.rows, max_seq=max_seq,
                          parts=[(_row_bytes(p), p.group_size, p.cols) for p in parts])


def prepare(hp, device, *, swa_mask: bool, max_seq: int) -> DecodeConsts:
    """The step constants on ``device``; on CUDA with this kernel's scratch
    for caches of up to ``max_seq`` slots (the attention scores [H, S] among
    them)."""
    return fused_decode.prepare(hp, device, swa_mask=swa_mask, max_seq=max_seq, kernel=KERNEL)


def tiled_scratch(consts: DecodeConsts, hp, device, max_seq: int, kernel: str) -> None:
    """Give ``consts`` the scratch of whole-step kernel ``kernel`` (this
    module's, fused_decode's, its gemma4 instance fused_decode_g4, or
    fused_decode_q's) on CUDA ``device`` for caches of up to ``max_seq``
    slots: the inter-block arrays, the attention scores [H, S], the step's
    own barrier word (the counting barrier's 64-bit count), gemma4's
    per_layer_model_proj output, and a cache of its plans by weight
    formats, filled at first launch."""
    lib = _lib(kernel)
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
    D, F = hp.embedding_length, hp.feed_forward_length
    Rq = H * dk + Hkv * (dk + dv)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    smem = _SMEM_LIMIT - _STATIC_SMEM  # the most any plan takes
    with torch.cuda.device(device):
        grid = getattr(lib, f"{kernel}_grid")(smem)
    if grid != sms:
        raise RuntimeError(f"{kernel}: the kernel is not resident on every SM ({grid} of {sms}) "
                           f"with {smem} bytes of shared memory")
    f32 = dict(dtype=torch.float32, device=device)
    consts.grid, consts.max_seq = grid, max_seq
    consts.scratch = {
        "qkv": torch.empty(Rq, **f32),
        "part": torch.empty(grid * H * (dv + 2), **f32),
        "y_attn": torch.empty(D, **f32),
        "act": torch.empty(F, dtype=torch.bfloat16, device=device),
        "y_ffn": torch.empty(D, **f32),
        "barrier": torch.zeros(2, dtype=torch.int32, device=device),
        "scores": torch.empty(H * max_seq, **f32),
        "plans": {},  # by the weights' formats: (StreamPlan, its ints for the C entry)
    }
    if kernel == "fused_decode_g4":
        consts.scratch["pl_proj"] = torch.empty(
            hp.block_count * hp.embedding_length_per_layer, **f32)


def _lib(kernel: str = KERNEL):
    """The loaded library of whole-step kernel ``kernel``, its C entries
    typed."""
    lib = _build.library(_SOURCE.get(kernel, kernel))
    getattr(lib, f"{kernel}_grid").argtypes = [ctypes.c_int]
    getattr(lib, f"{kernel}_smem").argtypes = [ctypes.c_int] * 10
    for fn in ("grid", "smem", "step"):
        getattr(lib, f"{kernel}_{fn}").restype = ctypes.c_int
    getattr(lib, f"{kernel}_step").argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int,
                                                                       ctypes.c_void_p]
    return lib


def formats_of(wts: list, info: list) -> tuple:
    """Per phase (format, group size, offsets, scale bytes) of
    ``launch_args``' weight pointers and ints: the key a plan is cut for."""
    return tuple((info[4 * k], info[4 * k + 1], wts[3 * k + 2] is not None, info[4 * k + 3])
                 for k in range(len(info) // 4))


def plan_ints(cache: dict, fmts: tuple, **shapes):
    """The plan for ``fmts`` at ``shapes`` (the keywords of ``plan`` but
    ``fmts``), cut once and kept in ``cache``: (StreamPlan, its ints for a
    C entry)."""
    cached = cache.get(fmts)
    if cached is None:
        pl = plan(fmts=fmts, **shapes)
        ints = pl.ints()
        cached = cache[fmts] = (pl, (ctypes.c_int * len(ints))(*ints))
    return cached


def plan_shapes(hp, w, grid: int) -> dict:
    """The keywords of ``plan`` but ``fmts`` for the weights ``w`` (a
    tensor-parallel rank's shards under its local ``hp``) on ``grid``
    blocks."""
    lw = w.layers
    shapes = dict(D=hp.embedding_length, F=lw.w_down.cols, A=lw.wo.cols, Rq=lw.wqkv.rows,
                  V=w.token_embd.rows, H=hp.n_head, Hkv=hp.n_head_kv, dk=hp.n_embd_head_k,
                  dv=hp.n_embd_head_v, grid=grid)
    if fused_decode.is_gemma4(w):
        shapes.update(P=hp.embedding_length_per_layer, L=lw.attn_norm.shape[0])
    return shapes


def launch_tiled(kernel: str, hp, w, cache, token: torch.Tensor, pos: torch.Tensor,
                 consts: DecodeConsts, profile: torch.Tensor | None) -> torch.Tensor:
    """One launch of whole-step kernel ``kernel`` over eligible weights and
    a stacked (or flat) cache; returns the logits [V] f32."""
    if consts.scratch is None:
        raise ValueError(f"{kernel}: consts were prepared without CUDA scratch")
    logits = torch.empty(w.token_embd.rows, dtype=torch.float32, device=token.device)
    step, wts, info = launch_args(hp, w, _stacked(hp, cache), token, pos, consts, logits, profile)
    ptrs = (ctypes.c_void_p * len(step))(*[None if t is None else t.data_ptr() for t in step])
    wptrs = (ctypes.c_void_p * len(wts))(*[None if t is None else t.data_ptr() for t in wts])
    d, sc = step_dims(hp, w, cache, consts)
    dims, scalars = (ctypes.c_int * len(d))(*d), (ctypes.c_float * len(sc))(*sc)
    winfo = (ctypes.c_int * len(info))(*info)
    _, ints = plan_ints(consts.scratch["plans"], formats_of(wts, info),
                        **plan_shapes(hp, w, consts.grid))
    err = getattr(_lib(kernel), f"{kernel}_step")(ptrs, dims, scalars, wptrs, winfo, ints,
                                                  consts.grid, _build.stream_of(token))
    _build.check(kernel, err, f"{kernel} launch")
    return logits


def _stacked(hp, cache):
    """The cache as stacked [L, S, Hkv, d] views (a flat cache's bytes)."""
    if cache.k.dim() == 4:
        return cache
    L, S = cache.k.shape[:2]
    return dataclasses.replace(
        cache, k=cache.k.view(L, S, hp.n_head_kv, hp.n_embd_head_k),
        v=cache.v.view(L, S, hp.n_head_kv, hp.n_embd_head_v))


def decode_step_stream_plain(hp, w, cache, token, pos, consts: DecodeConsts) -> torch.Tensor:
    """Plain torch version of the kernel, with the same rounding points (the
    lossless step's plain twin over the cache viewed 4-D)."""
    return step_plain(hp, w, _stacked(hp, cache), token, pos, consts, _group_dot, _dense_embed)


def decode_step_stream(hp, w, cache, token: torch.Tensor, pos: torch.Tensor,
                       consts: DecodeConsts, profile: torch.Tensor | None = None) -> torch.Tensor:
    """One capacity single-token decode step. ``token`` (int64) and ``pos``
    (int32) are one-element tensors on the weights' device; ``consts`` come
    from ``prepare``. Writes the K/V rows in place; returns logits [V] f32
    (final softcap not applied). ``profile`` as in
    ``fused_decode.decode_step``."""
    if not token.is_cuda:
        return decode_step_stream_plain(hp, w, cache, token, pos, consts)
    global launches
    if not decode_stream_supported(hp, w, max_seq=cache.k.shape[1]):
        raise ValueError("decode_step_stream kernel: the weights are not eligible "
                         "(decode_stream_supported)")
    logits = launch_tiled(KERNEL, hp, w, cache, token, pos, consts, profile)
    launches += 1
    return logits
