"""Tensor-parallel sharding layouts for Gemma-family weights and caches.

Counterpart of llm_inference_tpu/parallel/sharding.py, with its names,
policies and replication rules. The JAX package expresses the Megatron
layout as GSPMD annotations and XLA inserts the collectives; the port runs
the ranks of a mesh's 'model' axis itself, op by op (ops/linear.py
``matmul`` and ``embed_rows`` over a ``quant.device.ShardedTensor``,
models/gemma.py over a ``ShardedKVCache``):

  - attn_q/k/v, ffn_gate/up : row-parallel (output rows sharded); the
    ranks' outputs are joined in rank order, exactly.
  - attn_output, ffn_down   : col-parallel (input columns sharded); the
    ranks' partial sums are added in rank order.
  - token_embd              : vocab-sharded (rows); the tied logits are a
    row-parallel product, the gather picks each id's row from the rank
    that holds it.

Tensors whose dimensions do not divide the axis are replicated, so tiny
test models always run. A sharding here is a plain description: which dim
of which leaf splits over which mesh axis (``_LeafSharding.for_array``,
``CacheSharding.spec``), read by quant/device.py ``shard_weight`` and
models/gemma.py ``init_cache``.
"""

from __future__ import annotations

import dataclasses

from ..gguf.constants import block_geometry
from ..gguf.reader import TensorInfo
from .mesh import Mesh

# per-tensor-name policy: 'row' (shard output dim), 'col' (shard input dim)
_ROW_SHARDED = ("attn_q.weight", "attn_k.weight", "attn_v.weight",
                "ffn_gate.weight", "ffn_up.weight",
                "per_layer_inp_gate.weight", "inp_gate.weight",
                "per_layer_model_proj.weight")
_COL_SHARDED = ("attn_output.weight", "ffn_down.weight",
                "per_layer_proj.weight", "proj.weight")


def _policy(name: str) -> str | None:
    if name == "token_embd.weight":
        return "row"  # vocab-sharded
    if not name.startswith("blk."):
        return None
    param = name.split(".", 2)[2]
    if param in _ROW_SHARDED:
        return "row"
    if param in _COL_SHARDED:
        return "col"
    return None


def gemma_sharding_fn(mesh: Mesh, axis: str = "model"):
    """A ``sharding_fn(name, info)`` for models/weights.py ``load_weights``:
    a ``_LeafSharding`` (dim 0 for the row policy, 1 for the col policy) or
    None (replicated) per tensor, by the JAX rule: replicated where
    ``n_rows % n`` (row), or where ``n_cols % n`` or the GGUF groups ``% n``
    (col). The function carries its ``mesh`` and ``axis``, which the Engine
    and the server read."""
    n = mesh.shape[axis]

    def fn(name: str, info: TensorInfo):
        pol = _policy(name)
        if pol is None:
            return None
        elems, _ = block_geometry(info.tensor_type)
        groups = max(1, info.n_cols // max(elems, 1))
        if pol == "row":
            if info.n_rows % n:
                return None
            return _LeafSharding(mesh, axis, dim=0)
        if info.n_cols % n or groups % n:
            return None
        return _LeafSharding(mesh, axis, dim=1)

    fn.mesh = mesh
    fn.axis = axis
    return fn


@dataclasses.dataclass(frozen=True, eq=False)
class _LeafSharding:
    """Shards ``dim`` of each array leaf of one weight over ``axis`` (a
    weight maps to several leaves of different ranks: ``QuantTensor`` q [R,
    C] and scale [R, G], ``DenseTensor`` w [R, C])."""

    mesh: Mesh
    axis: str
    dim: int

    @property
    def n(self) -> int:
        return self.mesh.shape[self.axis]

    def for_rank(self, rank: int) -> tuple:
        """The partition spec of a leaf of ``rank`` dims: ``axis`` at ``dim``."""
        spec = [None] * rank
        if self.dim < rank:
            spec[self.dim] = self.axis
        return tuple(spec)

    def for_array(self, x) -> tuple:
        """Like ``for_rank``, but replicated (``()``) where the leaf's target
        dim does not divide the axis (rowq8's [R, 1] scales under the col
        policy: per-row scales commute with the sum)."""
        rank = len(x.shape)
        if self.dim < rank and x.shape[self.dim] % self.n == 0:
            return self.for_rank(rank)
        return ()


@dataclasses.dataclass(frozen=True, eq=False)
class CacheSharding:
    """Where a cache's dims go: ``spec`` names the mesh axis of each dim
    (None: not split), or is ``()`` (replicated), as a JAX
    ``NamedSharding``'s partition spec."""

    mesh: Mesh
    spec: tuple

    def axis_of(self, dim: int) -> str | None:
        return self.spec[dim] if dim < len(self.spec) else None


def kv_cache_sharding(mesh: Mesh, n_head_kv: int, axis: str = "model") -> CacheSharding:
    """For [max_seq, n_head_kv, head_dim] caches: KV heads over the model
    axis when they divide, else replicated."""
    if n_head_kv % mesh.shape[axis] == 0:
        return CacheSharding(mesh, (None, axis, None))
    return CacheSharding(mesh, ())


def batched_kv_cache_sharding(mesh: Mesh, n_head_kv: int, axis: str = "model",
                              data_axis: str | None = "data") -> CacheSharding:
    """For the server's [max_batch, max_seq, n_head_kv, head_dim] lanes:
    lanes over the data axis (when the mesh has one above 1), KV heads over
    the model axis (when they divide)."""
    d = data_axis if data_axis in mesh.shape and mesh.shape[data_axis] > 1 else None
    m = axis if n_head_kv % mesh.shape[axis] == 0 else None
    return CacheSharding(mesh, (d, None, m, None))
