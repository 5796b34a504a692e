"""The port's paged serving on the CPU against llm_inference_tpu's.

Same seeded inputs through both packages:

  - the plain ``paged_flash_decode`` against the Pallas kernel in interpret
    mode (tests/test_flash_decode.py's bar, rtol = atol = 2e-3): shuffled
    tables, sentinel entries, zero lengths, softcap, window starts,
    ``nb_cap`` (at or above the live depth it equals the uncapped call), and
    a JAX split-d pool re-viewed into the port's one layout;
  - the port's ``forward_batched_decode_paged`` (the per-op paged route) and
    the plain twin of the paged whole step against the JAX
    ``forward_batched_decode_paged`` over three steps, with ragged
    positions and a parked lane, on plain pools and on sliding-window ring
    pools (tests/test_fused_decode_batch_paged.py's bars): logits within
    1.5e-2 * max(1, max|logits|) per live lane with equal argmax; layer 0's
    written K/V rows within one bf16 step, every layer's within 4e-2; no
    other pool row changes, except the trash row that the whole step's
    parked lanes write;
  - ``BatchedServer(kv_pages=...)`` against the JAX server's streams in
    serve-q8 (both paged routes), serve-q and serve-q4 (dense and paged),
    and the scheduling cases of tests/test_serving.py and tests/test_swa.py.

The JAX package reads its page size once at import (serving.py:47); the
tests set its module's ``PAGE`` and the port's ``LLMI_PAGE`` to the same
small page.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import llm_inference_tpu.serving as jserving
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.models import forward as jax_forward
from llm_inference_tpu.models import init_cache as jax_init_cache
from llm_inference_tpu.models import load_weights as jax_load_weights
from llm_inference_tpu.models.gemma import KVCache as JKVCache
from llm_inference_tpu.models.gemma import forward_batched_decode_paged as jax_paged_decode
from llm_inference_tpu.models.weights import fuse_projections as jax_fuse
from llm_inference_tpu.ops.pallas.flash_decode import paged_flash_decode as jax_paged_flash
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.models import gemma, load_hparams
from llm_inference_tpu_torch.models.weights import fuse_projections, load_weights, stack_layers
from llm_inference_tpu_torch.ops.kernels import (flash_decode, fused_decode_batch,
                                                 fused_decode_batch_paged, kv_insert)
from llm_inference_tpu_torch.serving import BatchedServer

from fixtures import build_gemma3_gguf
from torch_jax_native import jax_native  # noqa: F401  (autouse: the JAX default route)

VOCAB = [f"t{i}" for i in range(256)]
VOCAB[1], VOCAB[2], VOCAB[3] = "<eos>", "<bos>", "<unk>"


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 values (as f32), so both packages hold the same."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


# -- paged_flash_decode -----------------------------------------------------------


def _paged_inputs(seed, B, NB, page, N, hkv, group, D, q_scale=1.0):
    """q, pools of N pages and a shuffled table with sentinel (== N) entries
    past each lane's pages."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, hkv * group, D)) * q_scale).astype(np.float32)
    k = _bf16(rng.standard_normal((N, page, hkv, D)))
    v = _bf16(rng.standard_normal((N, page, hkv, D)))
    table = rng.permutation(N)[: B * NB].reshape(B, NB).astype(np.int32)
    return q, k, v, table


def _both_paged(q, k, v, table, lengths, starts=None, softcap=0.0, nb_cap=None, dsplit=False):
    jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    if dsplit:  # the JAX split-d pools: one KV head of D stored [N, PAGE, D / 128, 128]
        jk = jk.reshape(k.shape[0], k.shape[1], -1, 128)
        jv = jv.reshape(v.shape[0], v.shape[1], -1, 128)
    want = jax_paged_flash(jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(lengths),
                           None if starts is None else jnp.asarray(starts), softcap=softcap,
                           dsplit=dsplit, nb_cap=nb_cap, interpret=True)
    if dsplit:  # the port's one layout, re-viewed from the JAX pool as pools_from_arrays does
        k = np.asarray(jk, np.float32).reshape(k.shape)
        v = np.asarray(jv, np.float32).reshape(v.shape)
    launches = flash_decode.paged_launches
    got = flash_decode.paged_flash_decode(
        torch.from_numpy(q), torch.from_numpy(k).to(torch.bfloat16),
        torch.from_numpy(v).to(torch.bfloat16), torch.from_numpy(table),
        torch.from_numpy(lengths), None if starts is None else torch.from_numpy(starts),
        softcap=softcap, nb_cap=nb_cap)
    assert flash_decode.paged_launches == launches  # the CPU takes the plain twin
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("hkv,group", [(1, 4), (2, 2), (1, 8)])
def test_plain_paged_flash_decode_matches_jax_kernel(hkv, group):
    q, k, v, table = _paged_inputs(1, 3, 4, 32, 16, hkv, group, 128)
    table[1, 2:] = 16  # sentinels past lane 1's pages
    got, want = _both_paged(q, k, v, table, np.array([128, 50, 97], np.int32))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("case", ["zero_length", "softcap", "swa_starts", "nb_cap_covers",
                                  "nb_cap_truncates", "dsplit", "page_16"])
def test_plain_paged_flash_decode_cases_match_jax_kernel(case):
    lengths = np.array([70, 0, 128, 1], np.int32)
    if case == "page_16":
        q, k, v, table = _paged_inputs(8, 4, 8, 16, 40, 2, 2, 128)
        got, want = _both_paged(q, k, v, table, lengths)
    elif case == "dsplit":  # the 1B geometry: one KV head of 256, four q heads
        q, k, v, table = _paged_inputs(7, 4, 4, 32, 20, 1, 4, 256)
        got, want = _both_paged(q, k, v, table, lengths, dsplit=True)
    else:
        q, k, v, table = _paged_inputs(2, 4, 4, 32, 18, 1, 2, 128,
                                       q_scale=3.0 if case == "softcap" else 1.0)
        table[1] = 18  # the zero-length lane: all sentinels, never read
        kw = {}
        if case == "softcap":
            kw = dict(softcap=30.0)
        elif case == "swa_starts":
            kw = dict(starts=np.maximum(lengths - 40, 0).astype(np.int32))
        elif case == "nb_cap_covers":
            kw = dict(nb_cap=4)
        elif case == "nb_cap_truncates":
            kw = dict(nb_cap=2)  # under lanes 0 and 2's depth: both packages truncate
        got, want = _both_paged(q, k, v, table, lengths, **kw)
        if case == "nb_cap_covers":
            uncapped, _ = _both_paged(q, k, v, table, lengths)
            np.testing.assert_array_equal(got, uncapped)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_paged_flash_decode_rejects_mismatched_inputs():
    q = torch.zeros(2, 4, 128)
    pool = torch.zeros(8, 16, 1, 128, dtype=torch.bfloat16)
    lengths = torch.tensor([3, 0], dtype=torch.int32)
    with pytest.raises(ValueError):
        flash_decode.paged_flash_decode(q, pool, pool, torch.zeros(3, 2, dtype=torch.int32),
                                        lengths)
    with pytest.raises(ValueError):
        flash_decode.paged_flash_decode(q[:, :, :64], pool, pool,
                                        torch.zeros(2, 2, dtype=torch.int32), lengths)


def test_pools_from_arrays_re_views_split_d_pools():
    hp = load_hparams(GGUFFile(build_gemma3_gguf(n_layers=2, n_embd=128, n_ff=256, n_head=4,
                                                 n_head_kv=1, head_dim=256, vocab=VOCAB)).metadata)
    rng = np.random.default_rng(3)
    split = [_bf16(rng.standard_normal((5, 16, 2, 128))) for _ in range(2)]
    pools = gemma.pools_from_arrays(hp, split, split)
    assert pools.k_all is not None and pools.k_all.shape == (2, 5, 16, 1, 256)
    assert pools.k[1].data_ptr() == pools.k_all[1].data_ptr()  # views of the stack
    np.testing.assert_array_equal(pools.v[0].float().numpy().reshape(5, 16, 2, 128), split[0])


# -- the batched paged step -----------------------------------------------------------

PAGE, NB, N_PAGES = 16, 4, 9  # logical max_seq 64; pool rows 0..8, sentinel 9
PROMPTS = [[2] + list(range(10, 42)), [2, 9], [2, 5, 6, 7, 11]]  # 33, 2 and 5 tokens
TABLE = np.array([[4, 0, 7, N_PAGES], [2, N_PAGES, N_PAGES, N_PAGES],
                  [5, N_PAGES, N_PAGES, N_PAGES], [N_PAGES] * NB], np.int32)  # lane 3 parked
WINDOW = 20  # ring layers: ceil(20 / 16) + 1 = 3 pages a lane


def _buf(swa: bool):
    kw = dict(sliding_window=WINDOW, swa_pattern=[True, False, True]) if swa else {}
    return build_gemma3_gguf(n_layers=3, n_embd=256, n_ff=512, n_head=4, n_head_kv=2,
                             head_dim=128, vocab=VOCAB, with_post_norms=True, **kw)


def _models(buf):
    jhp, jw = jax_load_weights(JGGUFFile(buf), mode="rowq8")
    jw = jax_fuse(jw)
    hp, w = load_weights(GGUFFile(buf), mode="rowq8")
    w = fuse_projections(w)
    return jhp, jw, hp, dataclasses.replace(w, layers=stack_layers(w.layers))


def _prefill_pools(jhp, jw, rings, rows):
    """JAX per-lane dense prefill scattered into page pools of ``rows``
    pages (numpy f32 per layer): plain layers through TABLE, ring layers
    into each lane's ring rows for the live window's blocks."""
    fwd = jax.jit(partial(jax_forward, jhp, exact=False, mm_impl="xla"))
    B = len(TABLE)
    shape = (jhp.n_head_kv, jhp.n_embd_head_k)
    kp = [np.zeros((B * rings[i] if i in rings else rows, PAGE) + shape, np.float32)
          for i in range(jhp.n_kv_layers)]
    vp = [np.zeros_like(a) for a in kp]
    for b, ids in enumerate(PROMPTS):
        cache = jax_init_cache(jhp, NB * PAGE, dtype=jnp.bfloat16)
        _, cache = fwd(jw, cache, jnp.asarray(ids, dtype=jnp.int32), 0)
        last = (len(ids) - 1) // PAGE
        for i in range(jhp.n_kv_layers):
            for j in range(NB):
                r = rings.get(i, 0)
                if r:
                    if not last - r < j <= last:
                        continue
                    row = b * r + j % r
                elif TABLE[b, j] < N_PAGES:
                    row = TABLE[b, j]
                else:
                    continue
                kp[i][row] = np.asarray(cache.k[i][j * PAGE : (j + 1) * PAGE], np.float32)
                vp[i][row] = np.asarray(cache.v[i][j * PAGE : (j + 1) * PAGE], np.float32)
    return kp, vp


def _written_rows(rings, i, b, p):
    """(pool row, slot) that lane b's step at position p writes in layer i."""
    r = rings.get(i, 0)
    j = p // PAGE
    return (b * r + j % r if r else TABLE[b, j]), p % PAGE


def _run_paged_steps(port_step, swa, monkeypatch, trash=False):
    """Three steps of the JAX forward_batched_decode_paged and ``port_step``
    from the same pools; the JAX argmax feeds both. Lane 3 is parked. Returns
    (port pools, JAX pools as numpy [L][rows, ...], initial pools, the
    rows written, rings)."""
    if swa:
        monkeypatch.setenv("LLMI_SWA_MASK", "1")
    jhp, jw, hp, w = _models(_buf(swa))
    rings = gemma.ring_pages(hp, PAGE)
    assert bool(rings) == swa and all(r == 3 for r in rings.values())
    kp, vp = _prefill_pools(jhp, jw, rings, N_PAGES)
    jpools = JKVCache(k=tuple(jnp.asarray(a, jnp.bfloat16) for a in kp),
                      v=tuple(jnp.asarray(a, jnp.bfloat16) for a in vp))
    pad = ((0, int(trash)), (0, 0), (0, 0), (0, 0))  # the whole step's trash row
    init_k = [np.pad(a, pad) for a in kp]
    init_v = [np.pad(a, pad) for a in vp]
    pools = gemma.pools_from_arrays(hp, init_k, init_v)
    fwd = jax.jit(partial(jax_paged_decode, jhp, ring_layers=tuple(sorted(rings))))
    pos = np.array([len(p) for p in PROMPTS] + [NB * PAGE], np.int32)
    tokens = np.array([9, 12, 14, 3], np.int32)
    written = set()
    for step in range(3):
        jl, jpools = fwd(jw, jpools, jnp.asarray(TABLE), jnp.asarray(tokens), jnp.asarray(pos))
        jl = np.asarray(jl)
        got = port_step(hp, w, pools, torch.from_numpy(TABLE), torch.from_numpy(tokens),
                        torch.from_numpy(pos), rings)
        for b in range(3):
            scale = max(1.0, np.abs(jl[b]).max())
            np.testing.assert_allclose(got[b], jl[b], rtol=0, atol=1.5e-2 * scale,
                                       err_msg=f"step {step} lane {b}")
            assert int(got[b].argmax()) == int(jl[b].argmax()), (step, b)
            for i in range(hp.n_kv_layers):
                written.add((i,) + tuple(int(x) for x in _written_rows(rings, i, b, pos[b])))
        tokens = jl.argmax(axis=1).astype(np.int32)
        pos = pos.copy()
        pos[:3] += 1
    jk = [np.asarray(a, np.float32) for a in jpools.k]
    jv = [np.asarray(a, np.float32) for a in jpools.v]
    return pools, (jk, jv), (init_k, init_v), written, rings


def _check_pools(pools, jax_pools, initial, written, *, trash_row=None, same_numerics=True):
    """Written rows: every layer's within 4e-2 of the JAX rows, and layer 0's
    within one bf16 step where both sides compute them with the same
    numerics (the per-op routes; the whole step rounds its activations to
    bf16 where the per-op route does not); every other row bit-equal to its
    initial value (the trash row exempt)."""
    for got_l, want_l, init_l in zip((pools.k, pools.v), jax_pools, initial):
        for i, (got, want, init) in enumerate(zip(got_l, want_l, init_l)):
            got = got.float().numpy()
            mask = np.zeros(got.shape[:2], bool)
            for (li, row, slot) in written:
                if li == i:
                    mask[row, slot] = True
                    g, wv = got[row, slot], want[row, slot]
                    np.testing.assert_allclose(g, wv, rtol=0, atol=4e-2)
                    if i == 0 and same_numerics:
                        assert (np.abs(g - wv) <= 2 ** -7 * np.abs(wv) + 1e-6).all()
            if trash_row is not None:
                mask[trash_row] = True
            np.testing.assert_array_equal(got[~mask], init[~mask])
            n = want.shape[0]  # the JAX per-op pools have no trash row
            np.testing.assert_array_equal(want[~mask[:n]], init[:n][~mask[:n]])


@pytest.mark.parametrize("pools_kind", ["plain", "ring"])
def test_forward_batched_decode_paged_matches_jax(pools_kind, monkeypatch):
    calls = {"insert": 0, "flash": 0}
    real_insert, real_flash = kv_insert.insert_kv_rows_plain, flash_decode.paged_flash_decode_plain
    monkeypatch.setattr(kv_insert, "insert_kv_rows_plain",
                        lambda *a: calls.__setitem__("insert", calls["insert"] + 1)
                        or real_insert(*a))
    monkeypatch.setattr(flash_decode, "paged_flash_decode_plain",
                        lambda *a, **k: calls.__setitem__("flash", calls["flash"] + 1)
                        or real_flash(*a, **k))

    def step(hp, w, pools, table, tokens, pos, rings):
        logits, _ = gemma.forward_batched_decode_paged(hp, w, pools, table, tokens, pos,
                                                       ring_layers=tuple(rings), nb_cap=4)
        return logits.numpy()

    pools, jpools, initial, written, rings = _run_paged_steps(step, pools_kind == "ring",
                                                              monkeypatch)
    assert calls == {"insert": 3 * 3, "flash": 3 * 3}  # one K/V append a layer and step
    assert (pools.k_all is None) == bool(rings)
    _check_pools(pools, jpools, initial, written)


def test_forward_batched_decode_paged_with_alibi_matches_jax(monkeypatch):
    """ALiBi keeps the paged per-op route off paged_flash_decode: each
    lane's pages gathered, then the per-lane masked softmax with the bias."""
    monkeypatch.setattr(flash_decode, "paged_flash_decode",
                        lambda *a, **k: pytest.fail("ALiBi must not reach the flash kernel"))
    jhp, jw, hp, w = _models(_buf(False))
    jhp = dataclasses.replace(jhp, f_max_alibi_bias=8.0)
    hp = dataclasses.replace(hp, f_max_alibi_bias=8.0)
    kp, vp = _prefill_pools(jhp, jw, {}, N_PAGES)
    jpools = JKVCache(k=tuple(jnp.asarray(a, jnp.bfloat16) for a in kp),
                      v=tuple(jnp.asarray(a, jnp.bfloat16) for a in vp))
    pos = np.array([len(p) for p in PROMPTS] + [NB * PAGE], np.int32)
    tokens = np.array([9, 12, 14, 3], np.int32)
    jl, _ = jax_paged_decode(jhp, jw, jpools, jnp.asarray(TABLE), jnp.asarray(tokens),
                             jnp.asarray(pos))
    got, _ = gemma.forward_batched_decode_paged(hp, w, gemma.pools_from_arrays(hp, kp, vp),
                                                torch.from_numpy(TABLE), torch.from_numpy(tokens),
                                                torch.from_numpy(pos))
    jl, got = np.asarray(jl), got.numpy()
    for b in range(3):
        np.testing.assert_allclose(got[b], jl[b], rtol=0, atol=1.5e-2 * max(1, np.abs(jl[b]).max()))
        assert int(got[b].argmax()) == int(jl[b].argmax())


def test_plain_paged_step_matches_jax_paged_decode(monkeypatch):
    """The paged whole step's plain twin (through the wrapper, on the CPU)
    against the JAX per-op paged step; its pools carry the trash row
    N_PAGES, which the parked lane's writes land in, and nothing else
    outside the live lanes' rows changes."""
    consts = {}

    def step(hp, w, pools, table, tokens, pos, rings):
        if "c" not in consts:
            consts["c"] = fused_decode_batch.prepare_batch(hp, "cpu", batch=4, max_seq=NB * PAGE)
        return fused_decode_batch_paged.decode_step_batch_paged(
            hp, w, pools.k_all, pools.v_all, table, tokens, pos, consts["c"]).numpy()

    launches = fused_decode_batch_paged.launches
    pools, jpools, initial, written, _ = _run_paged_steps(step, False, monkeypatch, trash=True)
    assert fused_decode_batch_paged.launches == launches  # the CPU takes the plain twin
    _check_pools(pools, jpools, initial, written, trash_row=N_PAGES, same_numerics=False)
    # the parked lane (position 0 after the clamp) wrote slot 0 of the trash row
    assert not torch.equal(pools.k_all[:, N_PAGES, 0], torch.from_numpy(
        np.stack(initial[0])[:, N_PAGES, 0]).to(torch.bfloat16))


def test_paged_step_greedy_and_eligibility():
    _, _, hp, w = _models(_buf(False))
    consts = fused_decode_batch.prepare_batch(hp, "cpu", batch=3, max_seq=NB * PAGE)
    pools = gemma.init_paged_cache(hp, N_PAGES + 1, PAGE)
    g = torch.Generator().manual_seed(0)
    pools.k_all.copy_(torch.randn(pools.k_all.shape, generator=g))
    pools.v_all.copy_(torch.randn(pools.v_all.shape, generator=g))
    table = torch.from_numpy(TABLE[:3].copy())
    toks = torch.tensor([9, 12, 14], dtype=torch.int32)
    pos = torch.tensor([35, 2, 5], dtype=torch.int32)
    k0, v0 = pools.k_all.clone(), pools.v_all.clone()
    logits = fused_decode_batch_paged.decode_step_batch_paged(hp, w, pools.k_all, pools.v_all,
                                                              table, toks, pos, consts)
    ids = fused_decode_batch_paged.decode_step_batch_paged(hp, w, k0.clone(), v0.clone(), table,
                                                           toks, pos, consts, greedy=True)
    assert torch.equal(ids, torch.argmax(logits, dim=-1).to(torch.int32))
    assert fused_decode_batch_paged.batch_paged_supported(hp, w, batch=4, nb=NB, page=PAGE)
    assert not fused_decode_batch_paged.batch_paged_supported(hp, w, batch=4, nb=NB, page=24)
    assert not fused_decode_batch_paged.batch_paged_supported(hp, w, batch=4, nb=0, page=PAGE)
    assert not fused_decode_batch_paged.batch_paged_supported(hp, w, batch=65, nb=NB, page=PAGE)


@pytest.mark.slow
def test_plain_paged_step_matches_interpret_megakernel(monkeypatch):
    """The plain twin against the Pallas paged kernel itself, in interpret
    mode (minutes of CPU emulation, hence slow), trash row included."""
    monkeypatch.setenv("LLMI_FUSED_INTERPRET", "1")
    from llm_inference_tpu.models.weights import stack_layers as jax_stack
    from llm_inference_tpu.ops.pallas.fused_decode_batch_paged import (
        decode_step_megakernel_batch_paged)

    jhp, jw, hp, w = _models(_buf(False))
    jws = dataclasses.replace(jw, layers=jax_stack(jw.layers))
    kp, vp = _prefill_pools(jhp, jw, {}, N_PAGES + 1)
    pos = np.array([len(p) for p in PROMPTS] + [NB * PAGE], np.int32)
    toks = np.array([9, 12, 14, 3], np.int32)
    ref, kc, _ = decode_step_megakernel_batch_paged(
        jhp, jws, jnp.asarray(np.stack(kp), jnp.bfloat16), jnp.asarray(np.stack(vp), jnp.bfloat16),
        jnp.asarray(TABLE), jnp.asarray(toks), jnp.asarray(pos), interpret=True)
    pools = gemma.pools_from_arrays(hp, kp, vp)
    consts = fused_decode_batch.prepare_batch(hp, "cpu", batch=4, max_seq=NB * PAGE)
    got = fused_decode_batch_paged.decode_step_batch_paged(
        hp, w, pools.k_all, pools.v_all, torch.from_numpy(TABLE), torch.from_numpy(toks),
        torch.from_numpy(pos), consts).numpy()
    ref = np.asarray(ref)
    for b in range(3):
        np.testing.assert_allclose(got[b], ref[b], rtol=0, atol=1.5e-2 * max(1, np.abs(ref[b]).max()))
        assert int(got[b].argmax()) == int(ref[b].argmax())
    kc = np.asarray(kc, np.float32)
    np.testing.assert_allclose(pools.k_all[:, :N_PAGES].float().numpy(), kc[:, :N_PAGES],
                               rtol=0, atol=4e-2)


# -- BatchedServer(kv_pages=...) ------------------------------------------------------

WIDE = dict(n_layers=3, n_embd=256, n_ff=512, n_head=4, n_head_kv=2, head_dim=128, vocab=VOCAB,
            weight_std=0.15)  # streams that wander over the vocabulary
MORE = [([2, 7, 8], 9), ([2, 9], 3), ([2, 5, 6], 6), ([2, 11], 8), ([2, 4, 13, 7], 5)]
SERVER = dict(max_seq=64, max_batch=2, decode_chunk=3)
KV_PAGES = 3  # each request needs one or two pages of 16: some wait on the pool


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    out = {}
    for name, buf in {
        "wide": build_gemma3_gguf(**WIDE),
        "swa": build_gemma3_gguf(sliding_window=WINDOW, swa_pattern=[True, False, True], **WIDE),
    }.items():
        (d / f"{name}.gguf").write_bytes(buf)
        out[name] = str(d / f"{name}.gguf")
    return out


@pytest.fixture
def page16(monkeypatch):
    monkeypatch.setattr(jserving, "PAGE", PAGE)
    monkeypatch.setenv("LLMI_PAGE", str(PAGE))


@pytest.fixture(scope="module")
def jax_streams(paths):
    """The JAX server's MORE streams per mode, paged (page 16, per-op on
    the CPU) and dense."""
    old, jserving.PAGE = jserving.PAGE, PAGE
    try:
        out = {}
        for mode in ("serve-q8", "serve-q", "serve-q4"):
            out[mode, "paged"] = jserving.BatchedServer(paths["wide"], mode=mode,
                                                        kv_pages=KV_PAGES, **SERVER).run(MORE)
            if mode != "serve-q8":
                out[mode, "dense"] = jserving.BatchedServer(paths["wide"], mode=mode,
                                                            **SERVER).run(MORE)
        out["serve-q8", "dense"] = jserving.BatchedServer(paths["wide"], mode="serve-q8",
                                                          **SERVER).run(MORE)
        return out
    finally:
        jserving.PAGE = old


def _port_server(path, monkeypatch, *, route=None, **kw):
    args = dict(SERVER, mode="serve-q8", device="cpu")
    args.update(kw)
    if route == "paged-kernel":
        monkeypatch.setenv("LLMI_PAGED_MEGAKERNEL", "1")
    srv = BatchedServer(path, **args)
    monkeypatch.delenv("LLMI_PAGED_MEGAKERNEL", raising=False)
    if route is not None:
        assert srv.decode_route == route
    return srv


@pytest.mark.parametrize("mode,route", [("serve-q8", "paged-per-op"), ("serve-q8", "paged-kernel"),
                                        ("serve-q", "paged-per-op"), ("serve-q4", "paged-per-op"),
                                        ("serve-q", "per-op"), ("serve-q4", "per-op")])
def test_server_matches_jax_server(paths, jax_streams, page16, monkeypatch, mode, route):
    """Five requests through two slots and three pages (requests wait on the
    pool and reuse freed pages) give the JAX server's streams; paged equals
    dense in both packages."""
    paged = route.startswith("paged")
    assert jax_streams[mode, "paged"] == jax_streams[mode, "dense"]
    kw = dict(kv_pages=KV_PAGES) if paged else {}
    counts = {"paged_flash": 0, "step": 0}
    real_flash = flash_decode.paged_flash_decode_plain
    real_step = fused_decode_batch_paged.decode_step_batch_paged_plain
    monkeypatch.setattr(flash_decode, "paged_flash_decode_plain",
                        lambda *a, **k: counts.__setitem__("paged_flash", counts["paged_flash"] + 1)
                        or real_flash(*a, **k))
    monkeypatch.setattr(fused_decode_batch_paged, "decode_step_batch_paged_plain",
                        lambda *a, **k: counts.__setitem__("step", counts["step"] + 1)
                        or real_step(*a, **k))
    srv = _port_server(paths["wide"], monkeypatch, route=route, mode=mode, **kw)
    assert srv.run(MORE) == jax_streams[mode, "paged" if paged else "dense"]
    steps = srv.stats.decode_steps
    want = {"paged-per-op": {"paged_flash": 3 * steps, "step": 0},
            "paged-kernel": {"paged_flash": 0, "step": steps},
            "per-op": {"paged_flash": 0, "step": 0}}[route]
    assert steps > 0 and counts == want
    if paged:
        assert sorted(srv._free_pages) == list(range(KV_PAGES))
        assert (srv._table == KV_PAGES).all()
        rows = KV_PAGES + (route == "paged-kernel")  # the kernel route's trash row
        assert srv._caches.k_all.shape[1] == rows


@pytest.mark.parametrize("case", ["grouped_vs_serial", "pool_exhaustion", "unservable",
                                  "swa_rings", "bad_page", "parity", "nb_cap_off"])
def test_paged_scheduling(paths, jax_streams, page16, monkeypatch, case):
    if case == "grouped_vs_serial":
        reqs = [([2, 7, 8], 5), ([2, 10, 11], 5), ([2, 12], 5), ([2, 9, 4], 5)]
        kw = dict(max_batch=4, kv_pages=8)
        serial = _port_server(paths["wide"], monkeypatch, max_admit_per_step=1, **kw)
        grouped = _port_server(paths["wide"], monkeypatch, max_admit_per_step=4, **kw)
        assert grouped.run(reqs) == serial.run(reqs)
        assert sorted(grouped._free_pages) == list(range(8))
    elif case == "pool_exhaustion":
        # two pages, three requests of one page each, all slots free: the
        # third waits for a retirement and takes a freed page
        srv = _port_server(paths["wide"], monkeypatch, max_batch=4, kv_pages=2)
        reqs = [srv.submit(p, n) for p, n in MORE[:3]]
        srv.step()
        assert [r.slot for r in reqs] == [0, 1, -1] and len(srv._queue) == 1
        freed = list(srv._free_pages)  # request 1 (three tokens) retired in the first chunk
        assert reqs[1].done and len(freed) == 1
        srv.step()
        assert reqs[2].slot >= 0 and reqs[2].pages == freed
        while srv.step():
            pass
        assert [r.out for r in reqs] == jax_streams["serve-q8", "dense"][:3]
        assert sorted(srv._free_pages) == [0, 1]
    elif case == "unservable":
        srv = _port_server(paths["wide"], monkeypatch, kv_pages=1)
        with pytest.raises(ValueError, match="pages"):
            srv.submit([2] * 8, n_predict=20)  # 31 slots: two pages of 16
        srv.submit([2] * 3, n_predict=9)  # 15: one page
    elif case == "swa_rings":
        monkeypatch.setenv("LLMI_SWA_MASK", "1")
        # (the second request's eighth token is a near tie on which the JAX
        # server and engine disagree; the port gives the engine's)
        reqs = [([2, 7, 8, 9, 4, 5, 6, 3, 8, 7, 2] * 3, 6), ([2, 12, 9, 4, 5], 7)]
        want = jserving.BatchedServer(paths["swa"], mode="serve-q8", kv_pages=6,
                                      **SERVER).run(reqs)
        dense = jserving.BatchedServer(paths["swa"], mode="serve-q8", **SERVER).run(reqs)
        assert want == dense
        monkeypatch.setenv("LLMI_PAGED_MEGAKERNEL", "1")  # rings keep the per-op route
        srv = BatchedServer(paths["swa"], mode="serve-q8", kv_pages=6, device="cpu", **SERVER)
        assert srv.decode_route == "paged-per-op" and srv._caches.k_all is None
        assert [t.shape[0] for t in srv._caches.k] == [2 * 3, 6, 2 * 3]  # rings of 3 pages
        assert srv.run(reqs) == want
    elif case == "bad_page":
        for bad in ("24", "0", "-16", "x", "128"):  # 128 does not divide max_seq 64
            monkeypatch.setenv("LLMI_PAGE", bad)
            with pytest.raises(ValueError, match="LLMI_PAGE"):
                BatchedServer(paths["wide"], mode="serve-q8", kv_pages=4, device="cpu", **SERVER)
        # dense servers never read it
        BatchedServer(paths["wide"], mode="serve-q8", device="cpu", **SERVER)
    elif case == "parity":
        with pytest.raises(ValueError, match="serve-mode"):
            BatchedServer(paths["wide"], mode="parity", kv_pages=4, device="cpu", **SERVER)
        # dense parity lanes are served: f16, unfused, per op (tests/test_torch_parity.py)
        srv = BatchedServer(paths["wide"], mode="parity", device="cpu", **SERVER)
        assert srv.decode_route == "per-op" and srv._caches.k.dtype == torch.float16
    else:  # the whole table walked: the same streams
        monkeypatch.setenv("LLMI_PAGED_NBCAP", "0")
        srv = _port_server(paths["wide"], monkeypatch, kv_pages=KV_PAGES)
        assert srv._nb_cap() is None
        assert srv.run(MORE) == jax_streams["serve-q8", "paged"]


def test_nb_cap_bucketing(paths, page16, monkeypatch):
    """The cap covers the deepest lane's blocks at the chunk's end, as a
    power of two, at most the table's blocks."""
    srv = _port_server(paths["wide"], monkeypatch, kv_pages=KV_PAGES, max_seq=128, decode_chunk=4)
    req = srv.submit([2, 7, 8], 8)
    srv._admit()
    for pos, cap in ((3, 1), (11, 1), (12, 2), (27, 2), (28, 4), (60, 8), (120, 8)):
        req.pos = pos
        assert srv._nb_cap() == cap, pos
        assert cap * PAGE >= pos + srv.decode_chunk + 1 or cap == 128 // PAGE
