"""The port's per-op sharded path (``parallel/sharding.py``) on the CPU against llm_inference_tpu.

The JAX side runs on conftest.py's 8 virtual CPU devices; the port on
meshes of repeated CPU devices (``make_mesh(model=n, devices=[cpu] * n)``),
its ranks one after the other in one process. Bars:

  - ``gemma_sharding_fn``'s decision (a dim or None) equals the JAX one's
    for every tensor of a Gemma-3 and a gemma4 fixture at n = 2, 4 and 8,
    and the cache shardings' specs equal the JAX ``NamedSharding`` specs,
    replicated cases included;
  - each rank's shard is bit-equal to the data of JAX's addressable shard
    on the matching device, in every load mode. The JAX package keeps
    group-scaled quants group-strided (quant/device.py of the port says
    why the port does not), so a row shard's quants are compared after the
    JAX shard is put back in logical column order, and a column shard's
    quants (a set of strided columns on the JAX side, a range of logical
    columns here) against the logical range of JAX's whole array; scales,
    offsets, dense weights and per-row quants compare shard to shard. The
    shards joined back are bit-equal to the unsharded load;
  - on the tests/test_parallel.py fixture (2 layers, 256 wide, 8 heads, 8 KV
    heads, 8 ranks), and on the same with a 512-token vocabulary (so the
    embedding and the tied logits shard too), the sharded prefill and
    decode logits within atol = 2e-5 of the port's single device (the JAX
    suite's bar, tests/test_parallel.py:57-58), and within the serve bar
    1.5e-2 * max(1, max|logits|) of JAX's sharded logits, argmax equal.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_tpu.gguf import GGMLType as JGGMLType
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.models import forward as jax_forward
from llm_inference_tpu.models import init_cache as jax_init_cache
from llm_inference_tpu.models import load_weights as jax_load_weights
from llm_inference_tpu.parallel import batched_kv_cache_sharding as jax_batched_sharding
from llm_inference_tpu.parallel import gemma_sharding_fn as jax_sharding_fn
from llm_inference_tpu.parallel import kv_cache_sharding as jax_kv_sharding
from llm_inference_tpu.parallel import make_mesh as jax_make_mesh
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.models.weights import fuse_projections, load_weights
from llm_inference_tpu_torch.parallel import (batched_kv_cache_sharding, gemma_sharding_fn,
                                              kv_cache_sharding, make_mesh)
from llm_inference_tpu_torch.quant.device import DenseTensor, Q4Tensor, QuantTensor, ShardedTensor

from fixtures import build_gemma3_gguf, build_gemma4_gguf
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

CPU = torch.device("cpu")
VOCAB = [f"t{i}" for i in range(512)]
VOCAB[1], VOCAB[2], VOCAB[3] = "<eos>", "<bos>", "<unk>"
LOAD_MODES = ("bf16", "rowq8", "packed-serve", "packed-q4", "packed")
PARALLEL = dict(n_layers=2, n_embd=256, n_ff=512, n_head=8, n_head_kv=8, seed=3)


def cpu_mesh(model: int, data: int = 1):
    return make_mesh(model=model, data=data, devices=[CPU] * (model * data))


def jax_mesh(model: int, data: int = 1):
    return jax_make_mesh(model=model, data=data, devices=jax.devices()[: model * data])


@pytest.fixture(scope="module")
def bufs():
    return {
        "gemma3": build_gemma3_gguf(**PARALLEL, vocab=VOCAB),
        "parallel": build_gemma3_gguf(**PARALLEL),
        "q4k": build_gemma3_gguf(n_layers=1, n_embd=512, n_ff=1024, n_head=4, n_head_kv=2,
                                 vocab=VOCAB, weight_fmt=JGGMLType.Q4_K, seed=5),
        "gemma4": build_gemma4_gguf(n_layers=4, n_embd=256, n_ff=512, n_head=4, n_head_kv=2,
                                    n_embd_per_layer=128, shared_kv_layers=1),
    }


# -- decisions ------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["gemma3", "gemma4", "q4k"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharding_decisions_match_jax(bufs, name, n):
    fn, jfn = gemma_sharding_fn(cpu_mesh(n)), jax_sharding_fn(jax_mesh(n))
    jinfos = {i.name: i for i in JGGUFFile(bufs[name]).tensor_infos}
    seen = set()
    for info in GGUFFile(bufs[name]).tensor_infos:
        got, want = fn(info.name, info), jfn(info.name, jinfos[info.name])
        assert (got is None) == (want is None), (info.name, n)
        if got is not None:
            assert (got.dim, got.axis, got.n) == (want.dim, want.axis, n), info.name
            seen.add(got.dim)
    # both policies met (Q4_K's 256-column blocks: no col shard of 4 blocks over 8 ranks)
    assert seen == ({0} if (name, n) == ("q4k", 8) else {0, 1})


@pytest.mark.parametrize("model,data", [(1, 1), (2, 1), (4, 1), (8, 1), (2, 2), (4, 2), (2, 4)])
@pytest.mark.parametrize("n_head_kv", [1, 2, 4, 8])
def test_cache_shardings_match_jax(model, data, n_head_kv):
    m, jm = cpu_mesh(model, data), jax_mesh(model, data)
    assert kv_cache_sharding(m, n_head_kv).spec == tuple(jax_kv_sharding(jm, n_head_kv).spec)
    got = batched_kv_cache_sharding(m, n_head_kv).spec
    assert got == tuple(jax_batched_sharding(jm, n_head_kv).spec)
    assert batched_kv_cache_sharding(m, n_head_kv, data_axis=None).spec == tuple(
        jax_batched_sharding(jm, n_head_kv, data_axis=None).spec)
    # the leaf rule: a dim that does not divide is replicated (rowq8's [R, 1] col scale)
    ls, jls = gemma_sharding_fn(m), jax_sharding_fn(jm)
    from llm_inference_tpu_torch.parallel.sharding import _LeafSharding
    from llm_inference_tpu.parallel.sharding import _LeafSharding as _JLeaf
    for dim in (0, 1):
        for shape in ((16, 1), (16, 8), (8, 16), (3, 5)):
            x = np.zeros(shape)
            assert _LeafSharding(m, "model", dim).for_array(x) == tuple(
                _JLeaf(jm, "model", dim).for_array(x).spec)
    assert ls.mesh is m and callable(jls)


# -- shards ---------------------------------------------------------------------------------


def _bits(a) -> np.ndarray:
    """A numpy or torch array's raw bits."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy().view(np.uint8)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.uint8)


def _unstride(q: np.ndarray, groups: int) -> np.ndarray:
    """JAX's group-strided columns (device column s * G + g holds logical
    column g * gs + s) in logical order."""
    R, C = q.shape
    return np.ascontiguousarray(q.reshape(R, C // groups, groups).swapaxes(-1, -2).reshape(R, C))


def _nibbles_logical(packed, groups: int) -> np.ndarray:
    """JAX Q4Tensor bytes (low nibble: device column c, high: c + C/2,
    group-strided) as the nibble values in logical order."""
    p = np.asarray(packed).view(np.uint8)
    return _unstride(np.concatenate([p & 0x0F, p >> 4], axis=-1), groups)


def _port_quants(s) -> np.ndarray:
    if isinstance(s, Q4Tensor):
        p = s.packed
        return torch.stack([p & 0x0F, p >> 4], dim=-1).flatten(-2).numpy()
    return s.q.numpy()


def _jax_shard(leaf, device):
    return np.asarray(next(sh for sh in leaf.addressable_shards if sh.device == device).data)


def _weights(w):
    """(name, weight) of every matmul weight of a ModelWeights (port or JAX)."""
    out = [("token_embd", w.token_embd)]
    for f in ("token_embd_per_layer", "per_layer_model_proj"):
        if getattr(w, f, None) is not None:
            out.append((f, getattr(w, f)))
    for i, lw in enumerate(w.layers):
        for f in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "per_layer_inp_gate",
                  "per_layer_proj"):
            if getattr(lw, f) is not None:
                out.append((f"{i}.{f}", getattr(lw, f)))
    return out


def _check_shard(name, ps: ShardedTensor, jw, jmesh, n: int):
    """Rank r's leaves against JAX's shard on ``jmesh.devices[0, r]``."""
    dim = ps.dim
    for r, s in ps.ranks():
        dev = jmesh.devices[0, r]
        if isinstance(s, DenseTensor):
            np.testing.assert_array_equal(_bits(s.w), _bits(_jax_shard(jw.w, dev)), name)
            continue
        for f in ("scale", "offset"):
            if getattr(s, f) is not None:
                np.testing.assert_array_equal(
                    _bits(getattr(s, f)), _bits(_jax_shard(getattr(jw, f), dev)), (name, f))
        G = jw.scale.shape[-1]
        if isinstance(s, QuantTensor) and G == 1:  # per row: one layout on both sides
            np.testing.assert_array_equal(_port_quants(s), _jax_shard(jw.q, dev), name)
            continue
        q4 = isinstance(s, Q4Tensor)
        leaf = jw.packed if q4 else jw.q
        logical = (lambda a, g: _nibbles_logical(a, g)) if q4 else _unstride
        if dim == 0:
            want = logical(_jax_shard(leaf, dev), G)
        else:
            c = ps.cols // n
            want = logical(np.asarray(leaf), G)[:, r * c:(r + 1) * c]
        np.testing.assert_array_equal(_port_quants(s), want, name)


def _join(ps: ShardedTensor, field: str, whole: torch.Tensor) -> torch.Tensor:
    """A leaf's shards joined back; a leaf the rule replicates (its dim does
    not divide) is the same in every shard."""
    parts = [getattr(s, field) for s in ps.shards]
    if whole.shape[ps.dim] % ps.n:
        assert all(torch.equal(p, whole) for p in parts)
        return parts[0]
    return torch.cat(parts, dim=ps.dim)


# gemma4's per-layer tensors in rowq8; its layers shard as Gemma-3's in the other modes
SHARD_CASES = ([(m, name, n) for name, n in (("gemma3", 2), ("gemma3", 8), ("q4k", 2))
                for m in LOAD_MODES] + [("rowq8", "gemma4", 2)])


@pytest.mark.parametrize("mode,name,n", SHARD_CASES)
def test_shards_bit_equal_to_jax(bufs, mode, name, n):
    jmesh = jax_mesh(n)
    _, jw = jax_load_weights(JGGUFFile(bufs[name]), sharding_fn=jax_sharding_fn(jmesh), mode=mode)
    _, whole = load_weights(GGUFFile(bufs[name]), mode=mode)
    _, w = load_weights(GGUFFile(bufs[name]), mode=mode, sharding_fn=gemma_sharding_fn(cpu_mesh(n)))
    kinds = set()
    for (pname, ps), (_, jwt), (_, pw) in zip(_weights(w), _weights(jw), _weights(whole)):
        leaf = jwt.w if hasattr(jwt, "w") else jwt.q if hasattr(jwt, "q") else jwt.packed
        if not isinstance(ps, ShardedTensor):
            assert leaf.sharding.is_fully_replicated, pname
            continue
        assert len(leaf.sharding.device_set) == n and ps.n == n, pname
        assert (ps.rows, ps.cols, ps.fmt) == (pw.rows, pw.cols, pw.fmt)
        _check_shard(pname, ps, jwt, jmesh, n)
        for f in ("w", "q", "packed", "scale", "offset"):
            if getattr(pw, f, None) is not None:
                assert torch.equal(_join(ps, f, getattr(pw, f)), getattr(pw, f)), (pname, f)
        kinds.add((type(ps.local).__name__, ps.dim))
    assert {d for _, d in kinds} == {0, 1}


# -- forward --------------------------------------------------------------------------------


def _port_logits(buf, mode, mesh=None, tokens=(2, 7, 8), nxt=9):
    exact = mode == "packed"
    fn = None if mesh is None else gemma_sharding_fn(mesh)
    hp, w = load_weights(GGUFFile(buf), mode=mode, sharding_fn=fn)
    if not exact:
        w = fuse_projections(w)
    dtype = gemma.PARITY_KV_DTYPE if exact else gemma.KV_DTYPE
    sharding = None if mesh is None else kv_cache_sharding(mesh, hp.n_head_kv)
    cache = gemma.init_cache(hp, 32, dtype=dtype, sharding=sharding)
    a, cache = gemma.forward(hp, w, cache, torch.tensor(tokens), 0, exact=exact)
    b, _ = gemma.forward(hp, w, cache, torch.tensor([nxt]), len(tokens), exact=exact)
    return a.numpy(), b.numpy(), w, cache


def _jax_logits(buf, mode, n, tokens=(2, 7, 8), nxt=9):
    exact = mode == "packed"
    jmesh = jax_mesh(n)
    hp, w = jax_load_weights(JGGUFFile(buf), sharding_fn=jax_sharding_fn(jmesh), mode=mode)
    dtype = jnp.float16 if exact else jnp.bfloat16
    cache = jax_init_cache(hp, 32, sharding=jax_kv_sharding(jmesh, hp.n_head_kv), dtype=dtype)
    fwd = jax.jit(partial(jax_forward, hp, exact=exact))
    a, cache = fwd(w, cache, jnp.asarray(tokens, dtype=jnp.int32), 0)
    b, _ = fwd(w, cache, jnp.asarray([nxt], dtype=jnp.int32), len(tokens))
    return np.asarray(a), np.asarray(b)


@pytest.mark.parametrize("mode", ["packed", "rowq8", "bf16", "packed-q4"])
@pytest.mark.parametrize("name", ["parallel", "gemma3"])
def test_sharded_logits_match(bufs, name, mode):
    n = 8
    want = _port_logits(bufs[name], mode)
    got = _port_logits(bufs[name], mode, cpu_mesh(n))
    w, cache = got[2], got[3]
    assert isinstance(cache, gemma.ShardedKVCache) and len(cache.shards) == n
    assert cache.shards[0].k.shape[-2] == 1  # one KV head a rank
    assert isinstance(w.layers[0].w_down, ShardedTensor)
    assert isinstance(w.token_embd, ShardedTensor) == (name == "gemma3")
    for g, ref in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, ref, atol=2e-5)
    for g, ref in zip(got[:2], _jax_logits(bufs[name], mode, n)):
        err = float(np.abs(g - ref).max()) / max(1.0, float(np.abs(ref).max()))
        assert err <= 1.5e-2, err
        assert int(g.argmax()) == int(ref.argmax())


def test_fused_qkv_shards_keep_heads(bufs):
    """Rank r's fused QKV is [q_r; k_r; v_r], and the join puts each of Q, K
    and V back whole: the fused product equals the three unfused ones."""
    _, w = load_weights(GGUFFile(bufs["gemma3"]), mode="rowq8",
                        sharding_fn=gemma_sharding_fn(cpu_mesh(4)))
    lw = w.layers[0]
    fused = fuse_projections(w).layers[0].wqkv
    assert fused.parts == (lw.wq.rows, lw.wk.rows, lw.wv.rows) and fused.n == 4
    r1 = fused.shards[1]
    q_rows = lw.wq.rows // 4
    assert torch.equal(r1.q[:q_rows], lw.wq.shards[1].q)
    assert torch.equal(r1.q[q_rows : q_rows + lw.wk.rows // 4], lw.wk.shards[1].q)
    x = torch.randn(3, lw.wq.cols, generator=torch.Generator().manual_seed(0))
    from llm_inference_tpu_torch.ops.linear import matmul

    want = torch.cat([matmul(lw.wq, x), matmul(lw.wk, x), matmul(lw.wv, x)], dim=-1)
    assert torch.equal(matmul(fused, x), want)


def test_vocab_sharded_embedding_is_exact(bufs):
    for mode in ("rowq8", "bf16", "packed"):
        _, w = load_weights(GGUFFile(bufs["gemma3"]), mode=mode,
                            sharding_fn=gemma_sharding_fn(cpu_mesh(8)))
        _, whole = load_weights(GGUFFile(bufs["gemma3"]), mode=mode)
        ids = torch.tensor([0, 2, 63, 64, 200, 511, 448])
        from llm_inference_tpu_torch.ops.linear import embed_rows

        assert isinstance(w.token_embd, ShardedTensor)
        assert torch.equal(embed_rows(w.token_embd, ids), embed_rows(whole.token_embd, ids))


def test_fused_shards_join_back(bufs):
    """Every fused rank-by-rank weight's shards, dequantized and joined
    (``join_rows``: each part's ranks together), are the whole fused weight."""
    _, w = load_weights(GGUFFile(bufs["gemma3"]), mode="packed-q4",
                        sharding_fn=gemma_sharding_fn(cpu_mesh(2)))
    _, whole = load_weights(GGUFFile(bufs["gemma3"]), mode="packed-q4")
    fused, wf = fuse_projections(w).layers[1], fuse_projections(whole).layers[1]
    for f in ("wqkv", "w_gate_up", "w_down", "wo"):
        ps, parts = getattr(fused, f), [s.dequant() for s in getattr(fused, f).shards]
        got = ps.join_rows([p.T for p in parts]).T if ps.dim == 0 else torch.cat(parts, dim=1)
        assert torch.equal(got, getattr(wf, f).dequant()), f
