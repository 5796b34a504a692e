"""GGUF tensor-name -> device-weight mapping, serve-q8 (per-row int8) mode.

Counterpart of llm_inference_tpu/models/weights.py for the serve-q8 path:
``load_weights(mode="rowq8")``, ``fuse_projections``, ``layers_stackable``
and ``stack_layers``, plus ``from_jax_arrays``, which carries weights the
JAX package loaded across to this port (flattened to numpy on the JAX side,
so this package never imports JAX). Norm weights are F32 in GGUF and load
as f32 vectors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFFile, TensorInfo
from ..quant.device import QuantTensor, requantize_rowwise
from .hparams import HParams, load_hparams

_W = Optional[QuantTensor]
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
    # load-time row-concatenated fusions (fuse_projections); when set, the
    # corresponding unfused fields are None
    wqkv: _W = None
    w_gate_up: _W = None


@dataclasses.dataclass
class ModelWeights:
    token_embd: QuantTensor
    output_norm: torch.Tensor
    layers: "tuple[LayerWeights, ...] | LayerWeights"


# GGUF per-layer param name -> LayerWeights field and kind ('w' = matmul
# weight, 'v' = f32 vector), the Gemma-3 subset of the JAX package's table.
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
}


def _load_v(gguf: GGUFFile, info: TensorInfo, device) -> torch.Tensor:
    if info.tensor_type != GGMLType.F32:
        raise ValueError(f"{info.name}: norm/scale weights must be F32, got {info.tensor_type}")
    arr = np.ascontiguousarray(gguf.tensor_bytes(info)).view(np.float32).copy()
    return torch.from_numpy(arr).to(device)


def load_weights(gguf: GGUFFile, hparams: HParams | None = None, *, mode: str = "rowq8",
                 device="cpu") -> tuple[HParams, ModelWeights]:
    """Map + requantize every model tensor onto ``device``. Only the serve-q8
    representation (``mode="rowq8"``: every matmul weight per-row int8) is
    ported so far."""
    if mode != "rowq8":
        raise NotImplementedError(
            f"load mode {mode!r}: only 'rowq8' is ported (ROADMAP.md queue 1, "
            "later slices)")
    hp = hparams or load_hparams(gguf.metadata)
    layers = [dict() for _ in range(hp.block_count)]
    token_embd = output_norm = None

    def load_w(info):
        return requantize_rowwise(info.tensor_type, gguf.tensor_bytes(info),
                                  info.n_rows, info.n_cols, device=device)

    for info in gguf.tensor_infos:
        name = info.name
        if name == "token_embd.weight":
            token_embd = load_w(info)
        elif name == "output_norm.weight":
            output_norm = _load_v(gguf, info, device)
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
                            layers=tuple(LayerWeights(**lw) for lw in layers))


def _concat(parts: list) -> QuantTensor:
    """Row-concatenate per-row int8 weights sharing cols (exact: the output
    rows simply stack)."""
    first = parts[0]
    return QuantTensor(q=torch.cat([p.q for p in parts]), scale=torch.cat([p.scale for p in parts]),
                       fmt=first.fmt, rows=sum(p.rows for p in parts), cols=first.cols)


def _fusable(parts: list) -> bool:
    if any(p is None for p in parts):
        return False
    first = parts[0]
    return all(type(p) is type(first) and p.cols == first.cols and p.fmt == first.fmt
               for p in parts)


def fuse_projections(model: ModelWeights) -> ModelWeights:
    """Fuse each layer's Q/K/V and FFN gate/up into single weights (fewer
    launches; identical results since row concatenation commutes with the
    contraction)."""
    new_layers = []
    for lw in model.layers:
        lw = dataclasses.replace(lw)
        if _fusable([lw.wq, lw.wk, lw.wv]):
            lw.wqkv = _concat([lw.wq, lw.wk, lw.wv])
            lw.wq = lw.wk = lw.wv = None
        if _fusable([lw.w_gate, lw.w_up]):
            lw.w_gate_up = _concat([lw.w_gate, lw.w_up])
            lw.w_gate = lw.w_up = None
        new_layers.append(lw)
    return dataclasses.replace(model, layers=tuple(new_layers))


def _signature(lw: LayerWeights):
    sig = []
    for f in dataclasses.fields(lw):
        v = getattr(lw, f.name)
        if v is None:
            sig.append((f.name, None))
        elif isinstance(v, QuantTensor):
            sig.append((f.name, tuple(v.q.shape), tuple(v.scale.shape), v.fmt))
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
    in prefill and of the whole-step decode kernel."""
    out = {}
    for f in dataclasses.fields(LayerWeights):
        vals = [getattr(lw, f.name) for lw in layers]
        if vals[0] is None:
            out[f.name] = None
        elif isinstance(vals[0], QuantTensor):
            out[f.name] = QuantTensor(q=torch.stack([v.q for v in vals]),
                                      scale=torch.stack([v.scale for v in vals]),
                                      fmt=vals[0].fmt, rows=vals[0].rows, cols=vals[0].cols)
        else:
            out[f.name] = torch.stack(vals)
    return LayerWeights(**out)


def layer_view(lw: LayerWeights, l: int) -> LayerWeights:
    """Layer ``l`` of stacked weights, as per-layer views (no copy)."""
    out = {}
    for f in dataclasses.fields(LayerWeights):
        v = getattr(lw, f.name)
        if isinstance(v, QuantTensor):
            v = QuantTensor(q=v.q[l], scale=v.scale[l], fmt=v.fmt, rows=v.rows, cols=v.cols)
        elif v is not None:
            v = v[l]
        out[f.name] = v
    return LayerWeights(**out)


def from_jax_arrays(hparams: dict, arrays: dict, *, device="cpu") -> tuple[HParams, ModelWeights]:
    """Carry weights loaded by llm_inference_tpu across to this port.

    ``hparams``: the JAX package's ``HParams`` fields as a dict.
    ``arrays``: its ``ModelWeights`` flattened to numpy, keyed by field
    path: ``"token_embd.q"``, ``"token_embd.scale"``, ``"output_norm"``, and
    per layer either stacked (``"layers.wqkv.q"`` with a leading [L] axis)
    or unstacked (``"layers.3.wqkv.q"``). Per-row int8 weights have ``q``
    [.., R, C] int8 and ``scale`` [.., R, 1] f32; a ``"<path>.fmt"`` entry,
    when present, gives the GGUF encoding they came from.
    Returns the port's (HParams, ModelWeights) on ``device``."""
    hp_fields = dict(hparams)
    hp_fields["swa_layers"] = tuple(bool(v) for v in hp_fields.get("swa_layers", ()))
    hp = HParams(**hp_fields)

    def tensor(key):
        return torch.from_numpy(np.array(arrays[key])).to(device)  # a copy: jax arrays are read-only

    def weight(prefix):
        if f"{prefix}.q" not in arrays:
            return None
        q, scale = tensor(f"{prefix}.q"), tensor(f"{prefix}.scale")
        fmt = arrays.get(f"{prefix}.fmt")
        return QuantTensor(q=q, scale=scale, fmt=None if fmt is None else GGMLType(int(fmt)),
                           rows=q.shape[-2], cols=q.shape[-1])

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
        raise ValueError("from_jax_arrays: token_embd must be a per-row int8 weight")
    return hp, ModelWeights(token_embd=embd, output_norm=tensor("output_norm"), layers=layers)


__all__ = ["LayerWeights", "ModelWeights", "from_jax_arrays", "fuse_projections",
           "layer_view", "layers_stackable", "load_weights", "stack_layers"]
