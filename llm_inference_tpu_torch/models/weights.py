"""GGUF tensor-name -> device-weight mapping for every engine mode.

Counterpart of llm_inference_tpu/models/weights.py: ``load_weights`` in the
modes ``bf16`` (serve: every matmul weight dequantized once to bf16),
``rowq8`` (serve-q8: every matmul weight per-row int8), ``packed-serve``
(serve-q: the checkpoint's own group-scaled quants, lossless), ``packed-q4``
(serve-q4: the same with Q4_0/Q4_K layer weights nibble-packed) and
``packed`` (parity: the checkpoint's quants, and dense tensors in their own
dtype), gemma4's per-layer-input tensors included;
``fuse_projections``, ``layers_stackable``, ``stack_layers`` and
``layer_view`` over every weight class; ``stack_layers_gemma4`` (the
zero-padded stack of a shared-KV model for the whole-step kernel);
``load_capacity_stacked``, the capacity-class load straight into stacked
device tensors, with ``layer_bytes_estimate``; and ``from_jax_arrays``, which carries weights the JAX package loaded across to
this port (flattened to numpy on the JAX side, so this package never imports
JAX), converting its group-strided and masked-dot layouts to the port's
logical one (quant/device.py says why the port keeps one layout). Norm
weights are F32 in GGUF and load as f32 vectors.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFFile, TensorInfo
from ..quant.device import (DenseTensor, Q4Tensor, QuantTensor, ShardedTensor, dense_bf16,
                            f16_scale_plane, f16_scales, from_gguf_bytes, pack_nibbles,
                            pack_q4_host, place_weight, requantize_rowwise, shard_weight)
from .hparams import HParams, load_hparams

_W = Optional["QuantTensor | Q4Tensor | DenseTensor"]
_V = Optional[torch.Tensor]


@dataclasses.dataclass
class LayerWeights:
    """One layer's weights, or (``stack_layers``) all layers with a leading
    [n_layers] axis on every tensor."""

    attn_norm: _V = None
    wq: _W = None
    wk: _W = None
    wv: _W = None
    wo: _W = None
    q_norm: _V = None
    k_norm: _V = None
    post_attn_norm: _V = None
    ffn_norm: _V = None
    w_gate: _W = None
    w_up: _W = None
    w_down: _W = None
    post_ffw_norm: _V = None
    # gemma4 per-layer-input path (reference model.cpp:927-966)
    per_layer_inp_gate: _W = None
    per_layer_proj: _W = None
    per_layer_post_norm: _V = None
    out_scale: _V = None  # [1]
    # load-time row-concatenated fusions (fuse_projections); when set, the
    # corresponding unfused fields are None
    wqkv: _W = None
    w_gate_up: _W = None


@dataclasses.dataclass
class ModelWeights:
    token_embd: "QuantTensor | DenseTensor"
    output_norm: torch.Tensor
    layers: "tuple[LayerWeights, ...] | LayerWeights"
    # gemma4 per-layer inputs (reference model.cpp:568-704)
    token_embd_per_layer: _W = None
    per_layer_model_proj: _W = None
    per_layer_proj_norm: _V = None


# GGUF per-layer param name (with the gemma4 aliases, reference
# model.cpp:193-236) -> LayerWeights field and kind ('w' = matmul weight,
# 'v' = f32 vector or scalar), the JAX package's table.
_LAYER_PARAMS = {
    "attn_norm.weight": ("attn_norm", "v"),
    "attn_q.weight": ("wq", "w"),
    "attn_k.weight": ("wk", "w"),
    "attn_v.weight": ("wv", "w"),
    "attn_output.weight": ("wo", "w"),
    "ffn_norm.weight": ("ffn_norm", "v"),
    "ffn_gate.weight": ("w_gate", "w"),
    "ffn_up.weight": ("w_up", "w"),
    "ffn_down.weight": ("w_down", "w"),
    "post_attention_norm.weight": ("post_attn_norm", "v"),
    "attn_post_norm.weight": ("post_attn_norm", "v"),
    "post_ffw_norm.weight": ("post_ffw_norm", "v"),
    "ffn_post_norm.weight": ("post_ffw_norm", "v"),
    "attn_k_norm.weight": ("k_norm", "v"),
    "attn_q_norm.weight": ("q_norm", "v"),
    "out_scale.weight": ("out_scale", "v"),
    "layer_output_scale.weight": ("out_scale", "v"),
    "per_layer_inp_gate.weight": ("per_layer_inp_gate", "w"),
    "inp_gate.weight": ("per_layer_inp_gate", "w"),
    "per_layer_proj.weight": ("per_layer_proj", "w"),
    "proj.weight": ("per_layer_proj", "w"),
    "per_layer_post_norm.weight": ("per_layer_post_norm", "v"),
    "post_norm.weight": ("per_layer_post_norm", "v"),
}
# model-level gemma4 tensors -> ModelWeights field and kind
_MODEL_PARAMS = {
    "token_embd_per_layer.weight": ("token_embd_per_layer", "w"),
    "per_layer_token_embd.weight": ("token_embd_per_layer", "w"),
    "per_layer_model_proj.weight": ("per_layer_model_proj", "w"),
    "per_layer_proj_norm.weight": ("per_layer_proj_norm", "v"),
}


def _load_v(gguf: GGUFFile, info: TensorInfo, device) -> torch.Tensor:
    if info.tensor_type != GGMLType.F32:
        raise ValueError(f"{info.name}: norm/scale weights must be F32, got {info.tensor_type}")
    arr = np.ascontiguousarray(gguf.tensor_bytes(info)).view(np.float32).copy()
    return torch.from_numpy(arr).to(device)


LOAD_MODES = ("bf16", "rowq8", "packed-serve", "packed-q4", "packed")


def _load_w(gguf: GGUFFile, info: TensorInfo, mode: str, device):
    """One matmul weight in load ``mode`` (llm_inference_tpu/models/weights.py
    ``_load_w``): ``bf16`` dequantizes to exact f32 and rounds to bf16
    (the JAX native helper's ``dequant_bf16``, the same bits); ``rowq8``
    requantizes per row; ``packed-serve`` keeps the checkpoint's quants and
    re-types F16 to bf16 (a lossy rounding the JAX package makes too);
    ``packed-q4`` nibble-packs Q4_0/Q4_K layer weights, keeps other quantized
    layer weights int8, and dequantizes everything else (the embedding too)
    to bf16; ``packed`` keeps the quants and every dense tensor's dtype."""
    raw, fmt, rows, cols = gguf.tensor_bytes(info), info.tensor_type, info.n_rows, info.n_cols
    if mode == "bf16":
        return dense_bf16(raw, fmt, rows, cols, device=device)
    if mode == "rowq8":
        return requantize_rowwise(fmt, raw, rows, cols, device=device)
    if mode == "packed-q4":
        if not info.name.startswith("blk."):
            return dense_bf16(raw, fmt, rows, cols, device=device)
        w = pack_q4_host(raw, fmt, rows, cols, device=device)
        if w is None:
            w = from_gguf_bytes(raw, fmt, rows, cols, device=device)
        if isinstance(w, DenseTensor):
            return dense_bf16(raw, fmt, rows, cols, device=device)
        return w
    w = from_gguf_bytes(raw, fmt, rows, cols, device=device)
    if mode == "packed-serve" and isinstance(w, DenseTensor) and w.w.dtype == torch.float16:
        w = DenseTensor(w=w.w.to(torch.bfloat16), fmt=GGMLType.BF16, rows=rows, cols=cols)
    return w


def load_weights(gguf: GGUFFile, hparams: HParams | None = None, *, mode: str = "rowq8",
                 device="cpu", sharding_fn=None) -> tuple[HParams, ModelWeights]:
    """Map every model tensor onto ``device`` in load ``mode`` (LOAD_MODES).

    ``sharding_fn(name, info)`` (parallel/sharding.py ``gemma_sharding_fn``;
    the JAX package's weights.py:186-231) gives a tensor's sharding or None.
    A sharded matmul weight is loaded whole, then split into a
    ``ShardedTensor`` over the ranks of this process's first data row of the
    function's mesh; everything else goes to that row's first device, which
    then takes the place of ``device``."""
    if mode not in LOAD_MODES:
        raise ValueError(f"unknown load mode {mode!r}; supported: {', '.join(LOAD_MODES)}")
    hp = hparams or load_hparams(gguf.metadata)
    mesh = getattr(sharding_fn, "mesh", None)
    row = mesh.local_rows()[0] if mesh is not None else 0
    if mesh is not None:
        device = mesh.home(row)
    layers = [dict() for _ in range(hp.block_count)]
    token_embd = output_norm = None
    extra = {}

    def load_w(info):
        w = _load_w(gguf, info, mode, device)
        shard = sharding_fn(info.name, info) if sharding_fn is not None else None
        return w if shard is None else shard_weight(w, shard, row)

    for info in gguf.tensor_infos:
        name = info.name
        if name == "token_embd.weight":
            token_embd = load_w(info)
        elif name == "output_norm.weight":
            output_norm = _load_v(gguf, info, device)
        elif name in _MODEL_PARAMS:
            field, kind = _MODEL_PARAMS[name]
            extra[field] = load_w(info) if kind == "w" else _load_v(gguf, info, device)
        elif name.startswith("blk."):
            _, idx, param = name.split(".", 2)
            i = int(idx)
            if i >= hp.block_count:
                continue
            entry = _LAYER_PARAMS.get(param)
            if entry is None:
                continue  # unknown per-layer tensors are ignored, as in the reference
            field, kind = entry
            layers[i][field] = load_w(info) if kind == "w" else _load_v(gguf, info, device)

    if token_embd is None:
        raise ValueError("GGUF is missing token_embd.weight")
    if output_norm is None:
        raise ValueError("GGUF is missing output_norm.weight")
    return hp, ModelWeights(token_embd=token_embd, output_norm=output_norm,
                            layers=tuple(LayerWeights(**lw) for lw in layers), **extra)


_DATA = {QuantTensor: ("q", "scale", "offset"), Q4Tensor: ("packed", "scale", "offset"),
         DenseTensor: ("w",)}


def _is_weight(v) -> bool:
    return type(v) in _DATA


def _map_data(fn, vals: list):
    """A weight of ``vals[0]``'s class whose tensor fields are
    ``fn([that field of each of vals])`` (None stays None)."""
    first = vals[0]
    return dataclasses.replace(first, **{
        f: None if getattr(first, f) is None else fn([getattr(v, f) for v in vals])
        for f in _DATA[type(first)]})


def _concat(parts: list):
    """Row-concatenate weights of one class sharing cols and format (exact:
    the output rows simply stack; offsets are zero where a part has none,
    as in the JAX package's ``_concat_weights``)."""
    first = parts[0]
    if any(getattr(p, "offset", None) is not None for p in parts):
        parts = [p if p.offset is not None else dataclasses.replace(
            p, offset=torch.zeros_like(p.scale)) for p in parts]
    return dataclasses.replace(_map_data(torch.cat, parts), rows=sum(p.rows for p in parts))


def _fusable(parts: list) -> bool:
    if any(p is None for p in parts):
        return False
    first = parts[0]
    if not all(type(p) is type(first) and p.cols == first.cols and p.fmt == first.fmt
               for p in parts):
        return False
    if isinstance(first, ShardedTensor):  # row-parallel parts over the same ranks
        return all(p.dim == 0 and p.mesh is first.mesh and p.data_row == first.data_row
                   and p.n == first.n and not p.parts for p in parts) and _fusable(
            [p.local for p in parts])
    return True


def _concat_sharded(parts: list) -> ShardedTensor:
    """Row-parallel parts fused rank by rank: rank r's shard is
    ``[part0_r; part1_r; ...]``, and ``parts`` records the whole parts' rows
    so the join puts each part's ranks back together (concatenating whole
    shards would mix the parts' rows across ranks)."""
    first = parts[0]
    shards = [None if first.shards[r] is None else _concat([p.shards[r] for p in parts])
              for r in range(first.n)]
    return dataclasses.replace(first, shards=shards, rows=sum(p.rows for p in parts),
                               parts=tuple(p.rows for p in parts))


def fuse_projections(model: ModelWeights) -> ModelWeights:
    """Fuse each layer's Q/K/V and FFN gate/up into single weights (fewer
    launches; identical results since row concatenation commutes with the
    contraction). Row-parallel ``ShardedTensor`` parts fuse rank by rank
    (``_concat_sharded``); a mix of sharded and replicated parts stays
    unfused."""
    new_layers = []
    for lw in model.layers:
        lw = dataclasses.replace(lw)
        for fused, names in (("wqkv", ("wq", "wk", "wv")), ("w_gate_up", ("w_gate", "w_up"))):
            parts = [getattr(lw, f) for f in names]
            if _fusable(parts):
                sharded = isinstance(parts[0], ShardedTensor)
                setattr(lw, fused, _concat_sharded(parts) if sharded else _concat(parts))
                for f in names:
                    setattr(lw, f, None)
        new_layers.append(lw)
    return dataclasses.replace(model, layers=tuple(new_layers))


def place_weights(model: ModelWeights, mesh, data_row: int) -> ModelWeights:
    """``model`` (weights of one data row of ``mesh``) on data row
    ``data_row``'s devices (quant/device.py ``place_weight``): the server's
    weights for each data row. Rows that share a device share its tensors."""
    def place(v):
        return v if v is None else place_weight(v, mesh, data_row)

    def fields(obj):
        return {f.name: place(getattr(obj, f.name)) for f in dataclasses.fields(obj)
                if f.name != "layers"}

    return ModelWeights(**fields(model), layers=tuple(
        LayerWeights(**fields(lw)) for lw in model.layers))


def _signature(lw: LayerWeights):
    sig = []
    for f in dataclasses.fields(lw):
        v = getattr(lw, f.name)
        if v is None:
            sig.append((f.name, None))
        elif _is_weight(v):
            sig.append((f.name, type(v).__name__, v.fmt, getattr(v, "group_size", None),
                        getattr(v, "centered", None),
                        tuple(None if getattr(v, d) is None else tuple(getattr(v, d).shape)
                              for d in _DATA[type(v)])))
        else:
            sig.append((f.name, tuple(v.shape), v.dtype))
    return tuple(sig)


def layers_stackable(hp: HParams, layers) -> bool:
    """Homogeneous layers (every layer owns its KV, same tensor formats and
    shapes, uniform head dims) can be stacked."""
    if hp.n_layer_kv_from_start >= 0 or hp.embedding_length_per_layer:
        return False
    if hp.n_embd_head_k != hp.n_embd_head_k_swa or hp.n_embd_head_v != hp.n_embd_head_v_swa:
        return False
    if isinstance(layers, LayerWeights) or len(layers) < 2:
        return False
    first = _signature(layers[0])
    return all(_signature(lw) == first for lw in layers[1:])


def stack_layers(layers) -> LayerWeights:
    """Stack homogeneous per-layer weights into one LayerWeights whose
    tensors carry a leading [n_layers] axis: the layout of the layer loop
    in prefill and of the whole-step decode kernels."""
    out = {}
    for f in dataclasses.fields(LayerWeights):
        vals = [getattr(lw, f.name) for lw in layers]
        if vals[0] is None:
            out[f.name] = None
        elif _is_weight(vals[0]):
            out[f.name] = _map_data(torch.stack, vals)
        else:
            out[f.name] = torch.stack(vals)
    return LayerWeights(**out)


def stack_layers_gemma4(hp: HParams, model: ModelWeights) -> Optional[ModelWeights]:
    """Stack a gemma4 model's layers for the whole-step kernel
    (llm_inference_tpu/models/weights.py:285-349). Shared-KV layers own only
    ``wq`` (``fuse_projections`` leaves it unfused); their fused QKV here is
    Q followed by zero K/V rows with zero row scales, so every layer has one
    ``[Rq, D]`` shape. The kernel reads ``hp.kv_source_layer``'s cache for
    them and writes none; the prefill over ``layer_view``s of the stack takes
    a shared layer's first ``H * dk`` rows (``shared_q_view``). Per-row int8
    (rowq8) layers only. None when the layers cannot be stacked so."""
    lw = model.layers
    if isinstance(lw, LayerWeights):
        return None  # already stacked
    if hp.n_embd_head_k != hp.n_embd_head_k_swa or hp.n_embd_head_v != hp.n_embd_head_v_swa:
        return None
    rq = hp.n_head * hp.n_embd_head_k
    rkv = hp.n_head_kv * (hp.n_embd_head_k + hp.n_embd_head_v)
    padded = []
    for i, layer in enumerate(lw):
        if hp.layer_has_kv(i):
            if layer.wqkv is None:  # K/V present but not fused
                return None
            padded.append(layer)
            continue
        wq = layer.wq if layer.wqkv is None else layer.wqkv
        if not (isinstance(wq, QuantTensor) and wq.groups == 1 and wq.rows == rq):
            return None
        wqkv = dataclasses.replace(
            wq, q=torch.cat([wq.q, wq.q.new_zeros((rkv, wq.cols))]),
            scale=torch.cat([wq.scale, wq.scale.new_zeros((rkv, 1))]), rows=rq + rkv)
        padded.append(dataclasses.replace(layer, wqkv=wqkv, wq=None, wk=None, wv=None))
    first = _signature(padded[0])
    if not all(_signature(layer) == first for layer in padded[1:]):
        return None
    return dataclasses.replace(model, layers=stack_layers(padded))


def shared_q_view(hp: HParams, lw: LayerWeights) -> LayerWeights:
    """A shared-KV layer's view of ``stack_layers_gemma4``'s padded QKV: its
    Q rows as ``wq`` (a view, no copy), the zero K/V rows left out."""
    rq = hp.n_head * hp.n_embd_head_k
    wq = dataclasses.replace(_map_data(lambda ts: ts[0][:rq], [lw.wqkv]), rows=rq)
    return dataclasses.replace(lw, wq=wq, wqkv=None)


def weight_layer(w, l: int):
    """Layer ``l`` of a stacked weight of any class (a view)."""
    return _map_data(lambda ts: ts[0][l], [w])


def layer_view(lw: LayerWeights, l: int) -> LayerWeights:
    """Layer ``l`` of stacked weights, as per-layer views (no copy)."""
    out = {}
    for f in dataclasses.fields(LayerWeights):
        v = getattr(lw, f.name)
        if _is_weight(v):
            v = weight_layer(v, l)
        elif v is not None:
            v = v[l]
        out[f.name] = v
    return LayerWeights(**out)


# the capacity load's fused projections, from GGUF per-layer tensor names
_CAPACITY_FUSED = {
    "wqkv": ("attn_q.weight", "attn_k.weight", "attn_v.weight"),
    "wo": ("attn_output.weight",),
    "w_gate_up": ("ffn_gate.weight", "ffn_up.weight"),
    "w_down": ("ffn_down.weight",),
}
_CAPACITY_VECS = {
    "attn_norm": ("attn_norm.weight",),
    "ffn_norm": ("ffn_norm.weight",),
    "q_norm": ("attn_q_norm.weight",),
    "k_norm": ("attn_k_norm.weight",),
    "post_attn_norm": ("post_attention_norm.weight", "attn_post_norm.weight"),
    "post_ffw_norm": ("post_ffw_norm.weight", "ffn_post_norm.weight"),
}
_GROUPED_FMTS = (GGMLType.Q4_0, GGMLType.Q8_0, GGMLType.Q5_0, GGMLType.Q4_K, GGMLType.Q6_K)
CAPACITY_THREAD = "llmi-capacity-load"  # the producer thread's name prefix
_EMBD_CHUNK_ROWS = 16384


def layer_bytes_estimate(gguf: GGUFFile, *, q4: bool) -> Optional[int]:
    """One layer's device bytes in the port's layout (int8 quants, or nibble
    pairs for Q4_0/Q4_K in serve-q4, plus f32 scales and Q4_K offsets per
    group) from the tensor directory alone, the counterpart of
    llm_inference_tpu's ``maskdot_layer_bytes_estimate`` (weights.py:728-750;
    the same count: the port's layout stores the same bytes without the
    masked-dot padding). None when a projection is missing or dense."""
    infos = {i.name: i for i in gguf.tensor_infos}
    total = 0
    for names in _CAPACITY_FUSED.values():
        for n in names:
            info = infos.get(f"blk.0.{n}")
            if info is None:
                return None
            fmt = GGMLType(info.tensor_type)
            if fmt in (GGMLType.F16, GGMLType.BF16, GGMLType.F32):
                return None
            gs = 16 if fmt == GGMLType.Q6_K else 32
            nel = info.n_rows * info.n_cols
            wb = nel // 2 if (q4 and fmt in (GGMLType.Q4_0, GGMLType.Q4_K)) else nel
            total += wb + (nel // gs) * 4 * (2 if fmt == GGMLType.Q4_K else 1)
    return total


def _embedding_bf16(gguf: GGUFFile, info: TensorInfo, device) -> DenseTensor:
    """The embedding dequantized to bf16 on ``device`` (the JAX capacity
    load's ``bf16`` mode), in row chunks, so no f32 copy of the whole table
    is ever held."""
    rows, cols = info.n_rows, info.n_cols
    raw = np.asarray(gguf.tensor_bytes(info)).reshape(rows, -1)
    out = torch.empty((rows, cols), dtype=torch.bfloat16, device=device)
    for r0 in range(0, rows, _EMBD_CHUNK_ROWS):
        r1 = min(rows, r0 + _EMBD_CHUNK_ROWS)
        out[r0:r1] = dense_bf16(raw[r0:r1], info.tensor_type, r1 - r0, cols, device=device).w
    return DenseTensor(w=out, fmt=GGMLType.BF16, rows=rows, cols=cols)


def load_capacity_stacked(gguf: GGUFFile, hparams: HParams | None = None, *, q4: bool,
                          device) -> Optional[tuple[HParams, ModelWeights]]:
    """Capacity-class load, the counterpart of llm_inference_tpu's
    ``load_maskdot_stacked`` (weights.py:471-725) in the port's one layout
    (no masked-dot repack: the one-layout decision in ROADMAP.md): stacked
    ``LayerWeights`` built straight from the GGUF directory and bytes, the
    same tensors as ``load_weights`` (``packed-q4`` when ``q4``, else
    ``packed-serve``) + ``fuse_projections`` + ``stack_layers``, bit for bit
    but the scales below: int8 ``QuantTensor`` or nibble ``Q4Tensor`` parts
    with [R, G] scales and offsets, QKV rows and gate|up rows fused. The
    embedding is dequantized to bf16 (equal to those loads for an F16 or
    BF16 one; the JAX capacity load dequantizes any format so).

    The group scales of centered Q4_0 nibble parts without offsets
    (serve-q4) stay the checkpoint's f16 ``d``, [L, R, G] in an f16 scale
    plane (quant/device.py ``f16_scale_plane``), equal to the f32 load's
    when widened: the step and the prefill read half the scale bytes and
    give the same bits. The JAX package does so only under
    ``LLMI_CAP_SCALE_F16=1`` (``load_maskdot_stacked(scale_f16=)``,
    quant/device.py:826-834), because Mosaic rejects f16; Hopper takes it,
    so the port always does. Q4_K, Q8_0 and serve-q's int8 parts keep f32.

    The [L, ...] device tensors are allocated once, from layer 0's shapes,
    and layer i is written into its slot: nothing is concatenated or
    stacked afterwards, and no second copy of the weights is held. A
    one-worker producer thread decodes layer i + 1 on the host while layer i
    uploads. On every return and on an exception the thread is cancelled
    and joined first (the JAX loader leaves it reading the mmap,
    weights.py:660-664).

    Returns None for gemma4, a missing tensor, a projection that is not
    group-scaled, layers whose formats or shapes differ, or norms that are
    not F32: the caller then takes the standard load."""
    hp = hparams or load_hparams(gguf.metadata)
    if hp.architecture != "gemma3" or hp.embedding_length_per_layer:
        return None
    infos = {i.name: i for i in gguf.tensor_infos}
    if "token_embd.weight" not in infos or "output_norm.weight" not in infos:
        return None
    mode = "packed-q4" if q4 else "packed-serve"
    L = hp.block_count
    cpu = torch.device("cpu")

    def layer_parts(i: int):
        """Layer i on the host: ({field: fused weight}, {field: vector or
        None}), or None when it cannot be loaded so."""
        fused = {}
        for field, names in _CAPACITY_FUSED.items():
            parts = []
            for n in names:
                info = infos.get(f"blk.{i}.{n}")
                if info is None or GGMLType(info.tensor_type) not in _GROUPED_FMTS:
                    return None
                parts.append(_load_w(gguf, info, mode, cpu))
            if not _fusable(parts):
                return None
            w = _concat(parts) if len(parts) > 1 else parts[0]
            if isinstance(w, Q4Tensor) and w.centered and w.offset is None:
                w = dataclasses.replace(w, scale=w.scale.half())  # exact: the f16 d widened
            fused[field] = w
        vecs = {}
        for field, names in _CAPACITY_VECS.items():
            info = next((infos[f"blk.{i}.{n}"] for n in names if f"blk.{i}.{n}" in infos), None)
            if info is not None and info.tensor_type != GGMLType.F32:
                return None
            vecs[field] = None if info is None else _load_v(gguf, info, cpu)
        return fused, vecs

    def signature(layer):
        fused, vecs = layer
        return (_signature(LayerWeights(**fused)),
                tuple((f, None if v is None else tuple(v.shape)) for f, v in vecs.items()))

    slots, sig0 = None, None
    ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix=CAPACITY_THREAD)
    fut = ex.submit(layer_parts, 0)
    try:
        for i in range(L):
            layer = fut.result()
            if layer is None:
                return None
            if i + 1 < L:
                fut = ex.submit(layer_parts, i + 1)
            if slots is None:
                sig0 = signature(layer)
                fused, vecs = layer

                def empty(ts):
                    shape, dtype = (L, *ts[0].shape), ts[0].dtype
                    return (f16_scale_plane(shape, device) if dtype == torch.float16
                            else torch.empty(shape, dtype=dtype, device=device))

                slots = {f: _map_data(empty, [t]) for f, t in fused.items()}
                slots.update({f: None if v is None else torch.empty((L, *v.shape), dtype=v.dtype,
                                                                    device=device)
                              for f, v in vecs.items()})
            elif signature(layer) != sig0:
                return None  # formats, shapes or norms differ between layers
            fused, vecs = layer
            for f, t in fused.items():
                for name in _DATA[type(t)]:
                    src = getattr(t, name)
                    if src is not None:
                        getattr(slots[f], name)[i].copy_(src)
            for f, v in vecs.items():
                if v is not None:
                    slots[f][i].copy_(v)
            del layer, fused, vecs
    finally:
        if not fut.cancel():
            fut.exception()  # wait out a layer in flight; a refused load ignores its outcome
        ex.shutdown(wait=True)
    token_embd = _embedding_bf16(gguf, infos["token_embd.weight"], device)
    output_norm = _load_v(gguf, infos["output_norm.weight"], device)
    return hp, ModelWeights(token_embd=token_embd, output_norm=output_norm,
                            layers=LayerWeights(**slots))


def _torch(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a torch tensor on ``device`` (a copy: JAX's arrays
    are read-only); bf16 arrives as ml_dtypes' bfloat16 and goes by its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _unstride(q: np.ndarray, groups: int) -> np.ndarray:
    """Group-strided columns [.., R, C] (JAX device column s*G + g holds
    logical column g*gs + s) -> logical order."""
    lead, (R, C) = q.shape[:-2], q.shape[-2:]
    ql = q.reshape(lead + (R, C // groups, groups))
    return np.ascontiguousarray(np.swapaxes(ql, -1, -2).reshape(lead + (R, C)))


def _maskdot_scales(t: np.ndarray, nblk: int, bg: int, mp: int) -> np.ndarray:
    """Transposed, block-padded [.., nblk*mp, R] -> [.., R, nblk*bg], f32
    (raw f16 scales stay f16)."""
    lead, R = t.shape[:-2], t.shape[-1]
    dtype = np.float16 if np.asarray(t).dtype == np.float16 else np.float32
    tb = np.asarray(t, dtype=dtype).reshape(lead + (nblk, mp, R))[..., :bg, :]
    return np.ascontiguousarray(np.swapaxes(tb.reshape(lead + (nblk * bg, R)), -1, -2))


def _jax_weight(arrays: dict, prefix: str):
    """(kind, q int8 logical [.., R, C], scale [.., R, G], offset or None,
    centered) of the JAX weight at ``prefix``, or None. Kinds: ``dense``
    (``DenseTensor``), ``quant`` (``QuantTensor``, group-strided), ``q4``
    (``Q4Tensor``: the low nibble holds device column c, the high one
    c + C/2, group-strided), ``tquant``/``tq4`` (the masked-dot
    ``TQuantTensor``/``TQ4Tensor``: transposed [.., C, R], block-padded
    transposed scales, and for ``tq4`` block-paired sign-hi nibbles with
    folded scales, quant/device.py:384-605 of the JAX package)."""
    def get(name):
        return arrays.get(f"{prefix}.{name}")

    meta = {k: None if get(k) is None else int(get(k)) for k in ("group_size", "bg", "mp", "centered")}
    fmt = get("fmt")
    centered = bool(meta["centered"]) if meta["centered"] is not None else (
        fmt is not None and GGMLType(int(fmt)) == GGMLType.Q4_0)
    if get("w") is not None:
        return "dense", get("w"), None, None, False
    if get("q") is not None:
        scale = np.asarray(get("scale"), dtype=np.float32)
        return ("quant", _unstride(np.asarray(get("q")), scale.shape[-1]), scale, get("offset"),
                False)
    if get("packed") is not None:
        p = np.asarray(get("packed")).view(np.uint8)
        q = np.concatenate([p & 0x0F, p >> 4], axis=-1).astype(np.int8)
        if centered:
            q = q - 8
        scale = np.asarray(get("scale"), dtype=np.float32)
        return "q4", _unstride(q, scale.shape[-1]), scale, get("offset"), centered
    tq, tp = get("qT"), get("packedT")
    if tq is None and tp is None:
        return None
    C = tq.shape[-2] if tq is not None else 2 * tp.shape[-2]
    R, lead = (tq if tq is not None else tp).shape[-1], (tq if tq is not None else tp).shape[:-2]
    gs, bg, mp = meta["group_size"], meta["bg"], meta["mp"]
    nblk = C // (gs * bg)
    s_t, off_t = np.asarray(get("sT")), get("offT")
    if tq is not None:
        qT = np.asarray(tq)
        scale = _maskdot_scales(s_t, nblk, bg, mp)
        offset = None if off_t is None else _maskdot_scales(off_t, nblk, bg, mp)
        kind = "tquant"
    else:
        # block-paired sign-hi nibbles: in block b, transposed row j < BC/2
        # is the low nibble of packedT[b*BC/2 + j], row j + BC/2 the high one
        # XOR 8 (JAX TQ4Tensor._unpacked_qT)
        p = np.asarray(tp).view(np.uint8).reshape(lead + (nblk, gs * bg // 2, R))
        qT = np.concatenate([p & 0x0F, (p >> 4) ^ 8], axis=-2).astype(np.int8)
        if centered:
            qT = qT - 8
        qT = qT.reshape(lead + (C, R))
        if s_t.dtype == np.float16:  # raw f16 scales: nothing folded
            scale, offset = _maskdot_scales(s_t, nblk, bg, mp), None
        else:
            # undo the folding (JAX TQ4Tensor._true_scale_off): the high
            # groups of each block hold s/16 and off - 8s
            hg = bg // 2
            sb = np.asarray(s_t, dtype=np.float32).reshape(lead + (nblk, mp, R)).copy()
            sb[..., hg:bg, :] *= np.float32(16.0)
            if off_t is not None:
                ob = np.asarray(off_t, dtype=np.float32).reshape(lead + (nblk, mp, R)).copy()
                ob[..., hg:bg, :] += np.float32(8.0) * sb[..., hg:bg, :]
                offset = _maskdot_scales(ob.reshape(lead + (nblk * mp, R)), nblk, bg, mp)
            else:
                offset = None
            scale = _maskdot_scales(sb.reshape(lead + (nblk * mp, R)), nblk, bg, mp)
        kind = "tq4"
    q = np.ascontiguousarray(np.swapaxes(qT, -1, -2))
    return kind, q, scale, offset, centered


def from_jax_arrays(hparams: dict, arrays: dict, *, device="cpu") -> tuple[HParams, ModelWeights]:
    """Carry weights loaded by llm_inference_tpu across to this port.

    ``hparams``: the JAX package's ``HParams`` fields as a dict.
    ``arrays``: its ``ModelWeights`` flattened to numpy, keyed by field
    path: ``"token_embd.q"``, ``"token_embd.scale"``, ``"output_norm"``, and
    per layer either stacked (``"layers.wqkv.q"`` with a leading [L] axis)
    or unstacked (``"layers.3.wqkv.q"``). A weight is given by the data
    fields of its JAX class: ``w`` (``DenseTensor``); ``q``, ``scale``
    [, ``offset``] (``QuantTensor``, per-row or group-strided); ``packed``,
    ``scale`` [, ``offset``] (``Q4Tensor``); ``qT``, ``sT`` [, ``offT``]
    (``TQuantTensor``); ``packedT``, ``sT`` [, ``offT``] (``TQ4Tensor``);
    and by its metadata where the class has it: ``fmt`` (the GGUF encoding;
    a dense weight without it takes the one its dtype names, so an F16
    embedding keeps its f16 activation contract),
    ``group_size``, ``bg``, ``mp``, ``centered``. The masked-dot classes need
    ``group_size``, ``bg`` and ``mp``. A ``TQ4Tensor``'s raw f16 ``sT`` (the
    JAX capacity load's ``scale_f16``) stays f16, in an f16 scale plane, as
    ``load_capacity_stacked`` keeps it: the port's one
    layout has no sign-hi nibbles, so neither its folded /16 nor the JAX
    kernel's unfolding applies (quant/device.py's notes).
    Returns the port's (HParams, ModelWeights) on ``device``, every weight in
    the port's layout: nibble kinds as ``Q4Tensor``, the others as
    ``QuantTensor`` or ``DenseTensor``."""
    hp_fields = dict(hparams)
    hp_fields["swa_layers"] = tuple(bool(v) for v in hp_fields.get("swa_layers", ()))
    hp = HParams(**hp_fields)

    def tensor(key):
        return _torch(arrays[key], device)

    def weight(prefix):
        got = _jax_weight(arrays, prefix)
        if got is None:
            return None
        kind, q, scale, offset, centered = got
        fmt = arrays.get(f"{prefix}.fmt")
        fmt = None if fmt is None else GGMLType(int(fmt))
        R, C = q.shape[-2:]
        if kind == "dense":
            w = _torch(q, device)
            if fmt is None:  # the dtype names the encoding (and its act_quant contract)
                fmt = {torch.float16: GGMLType.F16, torch.bfloat16: GGMLType.BF16,
                       torch.float32: GGMLType.F32}[w.dtype]
            return DenseTensor(w=w, fmt=fmt, rows=R, cols=C)
        G = scale.shape[-1]
        off = None if offset is None else _torch(np.asarray(offset, dtype=np.float32), device)
        if kind in ("q4", "tq4"):
            u = q.astype(np.int16) + (8 if centered else 0)
            s = _torch(scale, device)
            return Q4Tensor(packed=pack_nibbles(_torch(u, device)),
                            scale=f16_scales(s) if s.dtype == torch.float16 else s,
                            offset=off, fmt=fmt, rows=R, cols=C, group_size=C // G,
                            centered=centered)
        return QuantTensor(q=_torch(q, device), scale=_torch(scale, device), offset=off, fmt=fmt,
                           rows=R, cols=C, group_size=C // G)

    def layer(prefix):
        kw = {}
        for f in dataclasses.fields(LayerWeights):
            key = f"{prefix}.{f.name}"
            if key in arrays:
                kw[f.name] = tensor(key)
            else:
                kw[f.name] = weight(key)
        return LayerWeights(**kw)

    if any(k.startswith("layers.0.") for k in arrays):
        layers = tuple(layer(f"layers.{i}") for i in range(hp.block_count))
    else:
        layers = layer("layers")
    embd = weight("token_embd")
    if embd is None:
        raise ValueError("from_jax_arrays: token_embd is missing")
    return hp, ModelWeights(
        token_embd=embd, output_norm=tensor("output_norm"), layers=layers,
        token_embd_per_layer=weight("token_embd_per_layer"),
        per_layer_model_proj=weight("per_layer_model_proj"),
        per_layer_proj_norm=(tensor("per_layer_proj_norm") if "per_layer_proj_norm" in arrays
                             else None))


__all__ = ["LayerWeights", "ModelWeights", "from_jax_arrays", "fuse_projections",
           "layer_bytes_estimate", "layer_view", "layers_stackable", "load_capacity_stacked",
           "load_weights", "place_weights", "shared_q_view", "stack_layers",
           "stack_layers_gemma4"]
