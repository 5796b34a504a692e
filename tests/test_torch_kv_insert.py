"""The port's one-launch K/V append (``kv_insert.insert_kv_rows``) on the CPU
against llm_inference_tpu's ``insert_rows``.

The JAX per-op batched routes append a layer's new K and V rows as
``insert_rows(pool, k.astype(pool.dtype), idx)``, once for each pool
(llm_inference_tpu/models/gemma.py:717-723 and :905-911). The port does
both in one launch on the card; on the CPU ``insert_kv_rows`` runs its
plain twin. Same seeded inputs through both, the JAX kernel in interpret
mode: both pools bit-equal. The sources are laid out as the port's
``_batched_step`` leaves them: ``k`` packed (RoPE's output) and ``v`` a
column slice of the fused [B, (H + 2 Hkv) d] projection, f32 (the W8A8
route) or bf16; the ids drop at R, past R and below 0, as parked lanes do.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_inference_tpu.ops.pallas.kv_insert import insert_rows as jax_insert_rows
from llm_inference_tpu_torch.ops.kernels import kv_insert

# (Hkv, d) of a KV row: the 1B model's and gemma4's (GEOM_G4)
GEOMS = {"1b": (1, 256), "gemma4": (2, 256)}
R = 48


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 values (as f32), so both packages hold the same."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _inputs(seed: int, Hkv: int, d: int, ids, src_dtype, packed_v: bool):
    """Pools [R, Hkv, d] (bf16 values) and the step's rows: numpy f32 as the
    JAX route sees them, torch as the port's route leaves them."""
    rng = np.random.default_rng(seed)
    B, H = len(ids), 4 * Hkv
    kpool = _bf16(rng.normal(size=(R, Hkv, d)))
    vpool = _bf16(rng.normal(size=(R, Hkv, d)))
    qkv = rng.normal(size=(B, (H + 2 * Hkv) * d)).astype(np.float32)
    if src_dtype == torch.bfloat16:
        qkv = _bf16(qkv)
    t = torch.from_numpy(qkv).to(src_dtype)
    k = t[:, H * d:(H + Hkv) * d].reshape(B, Hkv, d).contiguous()
    v = t[:, (H + Hkv) * d:].reshape(B, Hkv, d)
    if packed_v:
        v = v.contiguous()
    assert v.is_contiguous() == packed_v
    k_np = qkv[:, H * d:(H + Hkv) * d].reshape(B, Hkv, d)
    v_np = qkv[:, (H + Hkv) * d:].reshape(B, Hkv, d)
    return kpool, vpool, k, v, k_np, v_np, np.asarray(ids, np.int32)


def _jax_append(pool: np.ndarray, rows: np.ndarray, idx: np.ndarray) -> np.ndarray:
    out = jax_insert_rows(jnp.asarray(pool, jnp.bfloat16), jnp.asarray(rows).astype(jnp.bfloat16),
                          jnp.asarray(idx), interpret=True)
    return np.asarray(out, np.float32)


IDS = {"scatter": [3, 17, R, 47, -1, R + 9, 0], "all_dropped": [R, R + 5, -2]}
CASES = [(g, dt, packed, "scatter") for g in GEOMS for dt in (torch.float32, torch.bfloat16)
         for packed in (False, True)] + [(g, torch.float32, False, "all_dropped") for g in GEOMS]


@pytest.mark.parametrize("geom,src_dtype,packed_v,ids", CASES)
def test_plain_insert_kv_rows_matches_jax_kernel(geom, src_dtype, packed_v, ids):
    Hkv, d = GEOMS[geom]
    kpool, vpool, k, v, k_np, v_np, idx = _inputs(7, Hkv, d, IDS[ids], src_dtype, packed_v)
    want_k, want_v = _jax_append(kpool, k_np, idx), _jax_append(vpool, v_np, idx)
    got_k = torch.from_numpy(kpool).to(torch.bfloat16)
    got_v = torch.from_numpy(vpool).to(torch.bfloat16)
    launches = kv_insert.launches
    kv_insert.insert_kv_rows(got_k, got_v, k, v, torch.from_numpy(idx))
    assert kv_insert.launches == launches  # the plain twin on the CPU
    np.testing.assert_array_equal(got_k.float().numpy(), want_k)
    np.testing.assert_array_equal(got_v.float().numpy(), want_v)
    if ids == "all_dropped":
        np.testing.assert_array_equal(want_k, kpool)


def test_plain_insert_kv_rows_is_the_two_insert_composition():
    """The twin is the route's old sequence: cast, insert K; cast, insert V."""
    kpool, vpool, k, v, _, _, idx = _inputs(3, 2, 256, IDS["scatter"], torch.float32, False)
    idx = torch.from_numpy(idx)
    kp, vp = torch.from_numpy(kpool).to(torch.bfloat16), torch.from_numpy(vpool).to(torch.bfloat16)
    ka, va = kp.clone(), vp.clone()
    kv_insert.insert_kv_rows_plain(ka, va, k, v, idx)
    kv_insert.insert_rows(kp, k.to(kp.dtype).contiguous(), idx)
    kv_insert.insert_rows(vp, v.to(vp.dtype).contiguous(), idx)
    assert torch.equal(ka, kp) and torch.equal(va, vp)


def _refusal_inputs(case):
    kpool = torch.zeros(8, 2, 16, dtype=torch.bfloat16)
    vpool = torch.zeros(8, 2, 16, dtype=torch.bfloat16)
    k, v = torch.zeros(2, 2, 16), torch.zeros(2, 2, 16)
    idx = torch.tensor([0, 1], dtype=torch.int32)
    if case == "source_dtype":
        k = k.to(torch.float16)
    elif case == "shape":
        v = torch.zeros(2, 2, 8)
    elif case == "pool_dtype":
        kpool, vpool = kpool.float(), vpool.float()
    elif case == "pool_rows":
        vpool = torch.zeros(9, 2, 16, dtype=torch.bfloat16)
    elif case == "ids":
        idx = torch.tensor([0, 1, 2], dtype=torch.int32)
    return kpool, vpool, k, v, idx


@pytest.mark.parametrize("case", ["source_dtype", "shape", "pool_dtype", "pool_rows", "ids"])
def test_insert_kv_rows_refuses(case):
    kpool, vpool, k, v, idx = _refusal_inputs(case)
    before_k, before_v = kpool.clone(), vpool.clone()
    with pytest.raises(ValueError):
        kv_insert.insert_kv_rows(kpool, vpool, k, v, idx)
    assert torch.equal(kpool, before_k) and torch.equal(vpool, before_v)  # nothing written
