"""The port's CUDA kernels against their plain twins, on an NVIDIA GPU.

Marked ``cuda``: without a GPU every test skips (a fixture decides, never
the import). On the card, without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(tests/conftest.py sets up JAX, which the GPU machine need not have; this
file imports only torch and the port.) chip_smoke.py holds the kernels at
the Gemma-3-1B shapes; these cases cover the other geometries the kernels
accept: ragged row and token counts, C split over one to many blocks, q
heads per KV head of 2 and 4, head dims 128 and 256, post norms, the
attention softcap, sliding windows, attention split over several blocks,
and out-of-range decode inputs; the batched-serving kernels (insert_rows,
flash_decode, the batched whole step) at B in {1, 3, 8}, one or two KV
heads, head dims 128 and 256, and a server on both decode routes; the
lossless kernels (grouped quant_matmul, q4_matmul, the lossless whole
step) over 16- and 32-column groups, Q4_K offsets, centered and offset
nibbles, mixed nibble and int8 parts, odd T <= 64, softcap and windows,
and Engine serve-q / serve-q4 on both decode routes; the capacity step at
the Gemma-3 4B, 12B and 27B widths (two layers) on int8 and nibble parts
with Q4_K offsets and a 16-column-group down projection, windows on and
off, positions 0 and past 1000, and the capacity Engine in serve-q and
serve-q4; the paged-serving
kernels (paged_flash_decode, the paged batched whole step) at pages of 16,
32 and 256 slots, one or two KV heads, up to 8 q heads per KV head, head
dims 128 and 256, nb_cap, and a parked lane writing the trash page, and a
paged server on both paged routes; the gemma4 whole step (P 128 and
256, 0 to 2 shared-KV layers, windows on and off, and a 27B-class D of 5376
through the shared-memory activations) and a gemma4 Engine on both routes.

Bars: ``quant_matmul`` within 1e-4 * max(1, max|y|) (exact products, only
the f32 summation order differs); the decode step within 1.5e-2 *
max(1, max|logits|) with equal argmax (tests/test_fused_decode.py's bar:
bf16 activations round at the same points, but sums in another order can
tip a rounding), the written K/V rows of layer 0 within one bf16 step and
of every layer within the logits' bar; greedy streams identical."""

import dataclasses

import pytest
import torch

import chip_smoke
from llm_inference_tpu_torch.engine import Engine, GenerationStats
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.models.weights import fuse_projections, load_weights, stack_layers
from llm_inference_tpu_torch.ops.kernels import fused_decode, qmatmul
from llm_inference_tpu_torch.quant.device import Q4Tensor, QuantTensor

pytestmark = pytest.mark.cuda

VOCAB = [f"t{i}" for i in range(256)]
VOCAB[1], VOCAB[2], VOCAB[3] = "<eos>", "<bos>", "<unk>"
GEOMS = {
    "g2_d128": dict(n_layers=3, n_embd=256, n_ff=512, n_head=4, n_head_kv=2, head_dim=128),
    "g4_d256": dict(n_layers=2, n_embd=512, n_ff=1024, n_head=4, n_head_kv=1, head_dim=256),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, rel):
    err = (got.float() - ref.float()).abs().max().item()
    tol = rel * max(1.0, ref.float().abs().max().item())
    assert err <= tol, f"max abs err {err} > {tol}"


@pytest.mark.parametrize("R,C,T", [(100, 256, 1), (96, 384, 5), (1024, 128, 33),
                                   (64, 6912, 64), (200, 640, 48), (13824, 1152, 16)])
def test_quant_matmul_kernel_matches_plain(cuda, R, C, T):
    g = torch.Generator(device=cuda).manual_seed(R + C + T)
    q = torch.randint(-127, 128, (R, C), dtype=torch.int8, device=cuda, generator=g)
    scale = torch.rand((R, 1), device=cuda, generator=g) * 1e-2
    qt = QuantTensor(q=q, scale=scale, fmt=None, rows=R, cols=C)
    x = torch.randn((T, C), device=cuda, generator=g)
    before = qmatmul.launches
    y = qmatmul.quant_matmul(qt, x)
    assert qmatmul.launches == before + 1
    _close(y, qmatmul.quant_matmul_plain(qt, x), 1e-4)


@pytest.mark.parametrize("T,R,C", [(1, 256, 1152), (5, 1536, 1152), (32, 1152, 6912),
                                   (40, 2048, 4096)])
def test_int8_dot_on_cuda_is_exact(cuda, T, R, C):
    """The W8A8 contraction on the card (torch._int_mm) gives the exact
    integer sums, saturated rows past 2^24 included, as the CPU's f32 chunks."""
    from llm_inference_tpu_torch.ops.linear import int8_dot

    g = torch.Generator().manual_seed(T + R + C)
    q = torch.randint(-127, 128, (R, C), dtype=torch.int8, generator=g)
    xq = torch.randint(-127, 128, (T, C), dtype=torch.int8, generator=g)
    q[0] = 127
    xq[0] = 127
    exact = (xq.long() @ q.long().T).to(torch.int32)
    assert torch.equal(int8_dot(xq, q), exact)
    got = int8_dot(xq.to(cuda), q.to(cuda)).cpu()
    assert torch.equal(got, exact), (got - exact).abs().max()


def _stacked_model(device, geom, **kw):
    buf = chip_smoke.build_gemma3_gguf(vocab=VOCAB, **GEOMS[geom], **kw)
    hp, w = load_weights(GGUFFile(buf), mode="rowq8", device=device)
    w = fuse_projections(w)
    return hp, dataclasses.replace(w, layers=stack_layers(w.layers))


@pytest.mark.parametrize("geom,post_norms,softcap,window,pos", [
    ("g2_d128", True, 0.0, 0, 0),
    ("g2_d128", False, 0.0, 0, 200),   # attention split over four blocks
    ("g2_d128", True, 20.0, 16, 150),  # softcap, a window inside one block
    ("g4_d256", False, 0.0, 100, 300),  # a window over two blocks
    ("g4_d256", True, 0.0, 0, 77),
])
def test_decode_step_kernel_matches_plain(cuda, geom, post_norms, softcap, window, pos):
    hp, w = _stacked_model(cuda, geom, with_post_norms=post_norms)
    hp = dataclasses.replace(hp, attn_soft_cap=softcap)
    assert fused_decode.decode_supported(hp, w)
    S = 512
    consts = fused_decode.prepare(hp, cuda, swa_mask=False, max_seq=S)
    consts.windows = torch.full_like(consts.windows, window)
    cache = gemma.init_cache(hp, S, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(pos)
    cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=cuda, generator=g)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=cuda, generator=g)
    ck = gemma.KVCache(k=cache.k.clone(), v=cache.v.clone())
    cp = gemma.KVCache(k=cache.k.clone(), v=cache.v.clone())
    token = torch.tensor([37], dtype=torch.int64, device=cuda)
    p = torch.tensor([pos], dtype=torch.int32, device=cuda)
    before = fused_decode.launches
    y = fused_decode.decode_step(hp, w, ck, token, p, consts)
    ref = fused_decode.decode_step_plain(hp, w, cp, token, p, consts)
    assert fused_decode.launches == before + 1
    _close(y, ref, 1.5e-2)
    assert int(y.argmax()) == int(ref.argmax())
    for got, want in ((ck.k, cp.k), (ck.v, cp.v)):
        row0 = (got[0, pos].float() - want[0, pos].float()).abs()
        assert (row0 <= 2 ** -7 * want[0, pos].float().abs() + 1e-6).all()
        _close(got[:, pos], want[:, pos], 1.5e-2)
    untouched = torch.ones(S, dtype=torch.bool, device=cuda)
    untouched[pos] = False
    assert torch.equal(ck.k[:, untouched], cache.k[:, untouched])
    assert torch.equal(ck.v[:, untouched], cache.v[:, untouched])


def test_decode_step_kernel_refuses_out_of_range_inputs(cuda):
    """A position past the cache or a token past the vocabulary writes
    nothing and returns NaN logits (the device cannot raise)."""
    hp, w = _stacked_model(cuda, "g2_d128")
    S = 64
    consts = fused_decode.prepare(hp, cuda, swa_mask=False, max_seq=S)
    cache = gemma.init_cache(hp, S, device=cuda)
    for tok, pos in ((5, S), (len(VOCAB), 3), (-1, 3)):
        y = fused_decode.decode_step(hp, w, cache, torch.tensor([tok], device=cuda),
                                     torch.tensor([pos], dtype=torch.int32, device=cuda), consts)
        assert torch.isnan(y).all()
        assert not cache.k.any() and not cache.v.any()


def test_engine_on_cuda_matches_cpu(cuda, tmp_path):
    path = tmp_path / "m.gguf"
    path.write_bytes(chip_smoke.build_gemma3_gguf(vocab=VOCAB, with_post_norms=True,
                                                  **GEOMS["g2_d128"]))
    prompt, n = [2, 40, 41, 42, 43], 16
    streams = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(str(path), max_seq=128, decode_chunk=4, device=dev)
        eng.tokenizer.eos_id = eng.tokenizer.end_of_turn_id = -1
        qmatmul.launches = fused_decode.launches = 0
        stats = GenerationStats()
        streams[dev] = eng.generate_from_ids(prompt, n_predict=n, stats=stats)
        if dev == "cuda":
            # prefill: four layer projections a layer plus the 256-row logits
            assert qmatmul.launches == 4 * eng.hparams.block_count + 1
            assert fused_decode.launches == stats.decode_steps > 0
        else:
            assert qmatmul.launches == fused_decode.launches == 0
    assert streams["cuda"] == streams["cpu"]
    assert len(streams["cpu"]) == n


# -- the batched-serving kernels ------------------------------------------------------
# Bars: insert_rows bit-equal; flash_decode rtol = atol = 2e-3
# (tests/test_flash_decode.py: f32 sums in another order); the batched step
# as the single-stream one, per lane, and its greedy ids equal to the plain
# twin's; server streams identical on the card and the CPU.


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("Hkv,d", [(1, 128), (2, 128), (1, 256), (2, 256)])
def test_insert_rows_kernel_matches_plain(cuda, B, Hkv, d):
    from llm_inference_tpu_torch.ops.kernels import kv_insert

    g = torch.Generator(device=cuda).manual_seed(B * d + Hkv)
    S = 48
    dst = torch.randn((B * S, Hkv, d), device=cuda, generator=g).to(torch.bfloat16)
    rows = torch.randn((B, Hkv, d), device=cuda, generator=g).to(torch.bfloat16)
    idx = torch.arange(B, device=cuda, dtype=torch.int32) * S + 7
    idx[0] = B * S if B > 1 else -1  # a dropped row
    ref = kv_insert.insert_rows_plain(dst.clone(), rows, idx)
    before = kv_insert.launches
    got = kv_insert.insert_rows(dst, rows, idx)
    torch.cuda.synchronize()
    assert kv_insert.launches == before + 1 and got is dst
    assert torch.equal(got, ref)


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("Hkv,G,d", [(1, 4, 256), (2, 2, 128), (1, 4, 128), (2, 2, 256)])
@pytest.mark.parametrize("S,softcap", [(512, 0.0), (300, 30.0)])
def test_flash_decode_kernel_matches_plain(cuda, B, Hkv, G, d, S, softcap):
    from llm_inference_tpu_torch.ops.kernels import flash_decode

    g = torch.Generator(device=cuda).manual_seed(B + S + d)
    q = torch.randn((B, Hkv * G, d), device=cuda, generator=g) * 0.3
    k = torch.randn((B, S, Hkv, d), device=cuda, generator=g).to(torch.bfloat16)
    v = torch.randn((B, S, Hkv, d), device=cuda, generator=g).to(torch.bfloat16)
    lengths = torch.randint(1, S + 1, (B,), device=cuda, generator=g, dtype=torch.int32)
    lengths[0] = 0  # a parked lane
    starts = torch.clamp(lengths - 130, min=0).to(torch.int32)  # a window in every long lane
    before = flash_decode.launches
    got = flash_decode.flash_decode(q, k, v, lengths, starts, softcap=softcap)
    ref = flash_decode.flash_decode_plain(q, k, v, lengths, starts, softcap=softcap)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    assert torch.isfinite(got).all() and not got[0].any()
    torch.testing.assert_close(got, ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("geom,S", [("g2_d128", 512), ("g4_d256", 208), ("g2_d128", 80)])
def test_decode_step_batch_kernel_matches_plain(cuda, B, geom, S):
    """Ragged positions, the last lane parked (pos = S) when B > 1; S = 208
    and 80 are not multiples of 64 (the TPU kernel's single cache chunk)."""
    from llm_inference_tpu_torch.ops.kernels import fused_decode_batch

    hp, w = _stacked_model(cuda, geom, with_post_norms=B != 3)
    assert fused_decode_batch.batch_supported(hp, w, batch=B, max_seq=S)
    consts = fused_decode_batch.prepare_batch(hp, cuda, batch=B, max_seq=S)
    g = torch.Generator(device=cuda).manual_seed(B * S)
    cache = gemma.init_batched_cache(hp, B, S, device=cuda)
    cache.k.copy_(torch.randn(cache.k.shape, device=cuda, generator=g))
    cache.v.copy_(torch.randn(cache.v.shape, device=cuda, generator=g))
    pos = torch.tensor([(S - 1) * (b + 1) // (B + 1) for b in range(B)], dtype=torch.int32,
                       device=cuda)
    if B > 1:
        pos[-1] = S
    tokens = torch.randint(0, len(VOCAB), (B,), device=cuda, generator=g, dtype=torch.int32)
    ck = gemma.BatchedKVCache(k=cache.k.clone(), v=cache.v.clone())
    cp = gemma.BatchedKVCache(k=cache.k.clone(), v=cache.v.clone())
    before = fused_decode_batch.launches
    y = fused_decode_batch.decode_step_batch(hp, w, ck, tokens, pos, consts)
    ref = fused_decode_batch.decode_step_batch_plain(hp, w, cp, tokens, pos, consts)
    torch.cuda.synchronize()
    assert fused_decode_batch.launches == before + 1
    for b in range(B):
        _close(y[b], ref[b], 1.5e-2)
        assert int(y[b].argmax()) == int(ref[b].argmax())
    ids = fused_decode_batch.decode_step_batch(hp, w, gemma.BatchedKVCache(
        k=cache.k.clone(), v=cache.v.clone()), tokens, pos, consts, greedy=True)
    assert torch.equal(ids, torch.argmax(ref, dim=-1).to(torch.int32))
    p = fused_decode_batch.clamp_positions(pos, S).long()
    lanes = torch.arange(B, device=cuda)
    for got, want in ((ck.k, cp.k), (ck.v, cp.v)):
        row0 = (got[0, lanes, p].float() - want[0, lanes, p].float()).abs()
        assert (row0 <= 2 ** -7 * want[0, lanes, p].float().abs() + 1e-6).all()
        _close(got[:, lanes, p], want[:, lanes, p], 1.5e-2)
    untouched = torch.ones((B, S), dtype=torch.bool, device=cuda)
    untouched[lanes, p] = False
    assert torch.equal(ck.k[:, untouched], cache.k[:, untouched])
    assert torch.equal(ck.v[:, untouched], cache.v[:, untouched])


def test_batched_server_on_cuda_matches_cpu(cuda, tmp_path, monkeypatch):
    """The kernel route gives the CPU's streams (the step's kernels against
    their plain twins); the per-op route's W8A8 projections on the card are
    not the CPU's bf16 products, so its streams are held against the same
    route on the card with insert_rows and flash_decode swapped for their
    plain twins."""
    from llm_inference_tpu_torch.ops.kernels import flash_decode, fused_decode_batch, kv_insert
    from llm_inference_tpu_torch.serving import BatchedServer

    path = tmp_path / "m.gguf"
    path.write_bytes(chip_smoke.build_gemma3_gguf(vocab=VOCAB, weight_std=0.15,
                                                  **GEOMS["g2_d128"]))
    reqs = [([2, 7, 8], 9), ([2, 10, 11, 9], 6), ([2, 12], 7), ([2, 5, 6], 12), ([2, 4], 5)]

    def serve(dev):
        srv = BatchedServer(str(path), max_seq=256, max_batch=4, decode_chunk=4, device=dev)
        fused_decode_batch.launches = kv_insert.launches = flash_decode.launches = 0
        out = srv.run(reqs)
        counts = (fused_decode_batch.launches, kv_insert.launches, flash_decode.launches)
        return srv, out, counts

    srv, got, counts = serve("cuda")
    assert srv.decode_route == "kernel" and counts == (srv.stats.decode_steps, 0, 0)
    assert got == serve("cpu")[1]

    monkeypatch.setenv("LLMI_NO_FUSED_DECODE", "1")
    srv, got, counts = serve("cuda")
    L, steps = srv.hparams.block_count, srv.stats.decode_steps
    assert srv.decode_route == "per-op" and counts == (0, 2 * L * steps, L * steps)
    monkeypatch.setattr(kv_insert, "insert_rows", kv_insert.insert_rows_plain)
    monkeypatch.setattr(flash_decode, "flash_decode", flash_decode.flash_decode_plain)
    _, want, counts = serve("cuda")
    assert counts == (0, 0, 0) and got == want


# -- the paged-serving kernels ---------------------------------------------------------
# Bars: paged_flash_decode as flash_decode (rtol = atol = 2e-3); the paged
# step as the dense one, per live lane; no pool row outside the live lanes'
# written rows and the trash page changes.


@pytest.mark.parametrize("page", [16, 32, 256])
@pytest.mark.parametrize("Hkv,G,d", [(1, 4, 256), (2, 2, 128), (1, 8, 128), (2, 4, 256)])
@pytest.mark.parametrize("softcap,window,nb_cap", [(0.0, 0, None), (30.0, 100, 2)])
def test_paged_flash_decode_kernel_matches_plain(cuda, page, Hkv, G, d, softcap, window, nb_cap):
    from llm_inference_tpu_torch.ops.kernels import flash_decode

    B, nb = 5, -(-600 // page)
    N = B * nb + 3
    g = torch.Generator(device=cuda).manual_seed(page + d + G)
    q = torch.randn((B, Hkv * G, d), device=cuda, generator=g) * 0.3
    k = torch.randn((N, page, Hkv, d), device=cuda, generator=g).to(torch.bfloat16)
    v = torch.randn((N, page, Hkv, d), device=cuda, generator=g).to(torch.bfloat16)
    table = torch.randperm(N, device=cuda, generator=g)[: B * nb].reshape(B, nb).to(torch.int32)
    lengths = torch.tensor([600, 0, 1, 333, page + 1], dtype=torch.int32, device=cuda)
    table[1] = N  # the parked lane's sentinels (clamped, never read)
    table[2, 1:] = N + 7  # ids past the pool, beyond the lane's live block
    starts = torch.clamp(lengths - window, min=0).to(torch.int32) if window else None
    before = flash_decode.paged_launches
    got = flash_decode.paged_flash_decode(q, k, v, table, lengths, starts, softcap=softcap,
                                          nb_cap=nb_cap)
    ref = flash_decode.paged_flash_decode_plain(q, k, v, table, lengths, starts, softcap=softcap,
                                                nb_cap=nb_cap)
    torch.cuda.synchronize()
    assert flash_decode.paged_launches == before + 1
    assert torch.isfinite(got).all() and not got[1].any()
    torch.testing.assert_close(got, ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("geom,page,nb", [("g2_d128", 16, 5), ("g4_d256", 32, 4),
                                          ("g2_d128", 256, 2)])
def test_decode_step_batch_paged_kernel_matches_plain(cuda, B, geom, page, nb):
    """Ragged positions over shuffled pages, the last lane parked (pos = nb *
    page, its table all sentinels) when B > 1: it writes the trash page."""
    from llm_inference_tpu_torch.ops.kernels import fused_decode_batch, fused_decode_batch_paged

    hp, w = _stacked_model(cuda, geom, with_post_norms=B != 3)
    S = nb * page
    assert fused_decode_batch_paged.batch_paged_supported(hp, w, batch=B, nb=nb, page=page)
    consts = fused_decode_batch.prepare_batch(hp, cuda, batch=B, max_seq=S)
    g = torch.Generator(device=cuda).manual_seed(B * S)
    P1 = B * nb + 2  # real pages, then the trash row P1 - 1
    pools = gemma.init_paged_cache(hp, P1, page, device=cuda)
    pools.k_all.copy_(torch.randn(pools.k_all.shape, device=cuda, generator=g))
    pools.v_all.copy_(torch.randn(pools.v_all.shape, device=cuda, generator=g))
    pos = torch.tensor([(S - 1) * (b + 1) // (B + 1) for b in range(B)], dtype=torch.int32,
                       device=cuda)
    table = torch.randperm(P1 - 1, device=cuda, generator=g)[: B * nb].reshape(B, nb)
    table = table.to(torch.int32)
    for b in range(B):
        table[b, int(pos[b]) // page + 1:] = P1 - 1  # unmapped past the live block
    if B > 1:
        pos[-1] = S
        table[-1] = P1 - 1
    tokens = torch.randint(0, len(VOCAB), (B,), device=cuda, generator=g, dtype=torch.int32)
    kk, vk = pools.k_all.clone(), pools.v_all.clone()
    kp, vp = pools.k_all.clone(), pools.v_all.clone()
    before = fused_decode_batch_paged.launches
    y = fused_decode_batch_paged.decode_step_batch_paged(hp, w, kk, vk, table, tokens, pos, consts)
    ref = fused_decode_batch_paged.decode_step_batch_paged_plain(hp, w, kp, vp, table, tokens, pos,
                                                                 consts)
    torch.cuda.synchronize()
    assert fused_decode_batch_paged.launches == before + 1
    live = B - 1 if B > 1 else B
    for b in range(live):
        _close(y[b], ref[b], 1.5e-2)
        assert int(y[b].argmax()) == int(ref[b].argmax())
    ids = fused_decode_batch_paged.decode_step_batch_paged(
        hp, w, pools.k_all.clone(), pools.v_all.clone(), table, tokens, pos, consts, greedy=True)
    assert torch.equal(ids[:live], torch.argmax(ref[:live], dim=-1).to(torch.int32))
    rows = [(int(table[b, int(pos[b]) // page]), int(pos[b]) % page) for b in range(live)]
    touched = torch.zeros((P1, page), dtype=torch.bool, device=cuda)
    touched[P1 - 1] = True  # the trash page
    for row, slot in rows:
        touched[row, slot] = True
        for got, want in ((kk, kp), (vk, vp)):
            r0 = (got[0, row, slot].float() - want[0, row, slot].float()).abs()
            assert (r0 <= 2 ** -7 * want[0, row, slot].float().abs() + 1e-6).all()
            _close(got[:, row, slot], want[:, row, slot], 1.5e-2)
    assert torch.equal(kk[:, ~touched], pools.k_all[:, ~touched])
    assert torch.equal(vk[:, ~touched], pools.v_all[:, ~touched])
    if B > 1:  # the parked lane ran at position 0 and wrote slot 0 of the trash page
        assert not torch.equal(kk[:, P1 - 1, 0], pools.k_all[:, P1 - 1, 0])


def test_paged_server_on_cuda_matches_cpu(cuda, tmp_path, monkeypatch):
    """Both paged routes give the CPU's streams with the kernels' launches
    (the per-op route against the same route on the card with its kernels
    swapped for their plain twins, as the dense per-op route)."""
    from llm_inference_tpu_torch.ops.kernels import (flash_decode, fused_decode_batch_paged,
                                                     kv_insert)
    from llm_inference_tpu_torch.serving import BatchedServer

    path = tmp_path / "m.gguf"
    path.write_bytes(chip_smoke.build_gemma3_gguf(vocab=VOCAB, weight_std=0.15,
                                                  **GEOMS["g2_d128"]))
    reqs = [([2, 7, 8], 9), ([2, 10, 11, 9], 6), ([2, 12], 7), ([2, 5, 6], 12), ([2, 4], 5)]
    monkeypatch.setenv("LLMI_PAGE", "32")

    def serve(dev):
        srv = BatchedServer(str(path), max_seq=128, max_batch=3, decode_chunk=4, kv_pages=4,
                            device=dev)
        fused_decode_batch_paged.launches = kv_insert.launches = flash_decode.paged_launches = 0
        out = srv.run(reqs)
        counts = (fused_decode_batch_paged.launches, kv_insert.launches,
                  flash_decode.paged_launches)
        assert sorted(srv._free_pages) == list(range(4))
        return srv, out, counts

    monkeypatch.setenv("LLMI_PAGED_MEGAKERNEL", "1")
    srv, got, counts = serve("cuda")
    assert srv.decode_route == "paged-kernel" and counts == (srv.stats.decode_steps, 0, 0)
    assert got == serve("cpu")[1]
    monkeypatch.delenv("LLMI_PAGED_MEGAKERNEL")
    srv, got, counts = serve("cuda")
    L, steps = srv.hparams.block_count, srv.stats.decode_steps
    assert srv.decode_route == "paged-per-op" and counts == (0, 2 * L * steps, L * steps)
    monkeypatch.setattr(kv_insert, "insert_rows", kv_insert.insert_rows_plain)
    monkeypatch.setattr(flash_decode, "paged_flash_decode", flash_decode.paged_flash_decode_plain)
    _, want, counts = serve("cuda")
    assert counts == (0, 0, 0) and got == want


# -- the lossless serve-q / serve-q4 kernels ------------------------------------------
# Bars: the grouped quant_matmul and q4_matmul as the rowwise one, 1e-4 *
# max(1, max|y|) (the same bf16 weights and exact bf16 products, only the
# f32 summation order differs); the lossless step as the rowq8 one
# (tests/test_fused_decode_q.py's 1.5e-2 with equal argmax, layer 0's K/V
# row within one bf16 step); greedy streams identical on the card and the CPU.


@pytest.mark.parametrize("R,C,T,nibble,gs,lo,hi,offsets", [
    (100, 256, 1, False, 32, -8, 7, False),       # Q4_0-like int8
    (96, 384, 5, False, 16, -32, 31, False),      # Q6_K-like, 16-column groups
    (1024, 128, 33, False, 32, 0, 15, True),      # Q4_K-like, offsets
    (64, 6912, 64, False, 16, -32, 31, False),
    (200, 640, 47, False, 32, -127, 127, False),  # Q8_0-like
    (13824, 1152, 16, False, 32, 0, 15, True),
    (100, 256, 1, True, 32, -8, 7, False),        # Q4_0 nibbles, centered
    (1024, 128, 33, True, 32, 0, 15, True),       # Q4_K nibbles, offsets
    (200, 640, 47, True, 32, -8, 7, False),
    (64, 6912, 64, True, 32, 0, 15, True),
    (13824, 1152, 16, True, 32, -8, 7, False),
])
def test_grouped_matmul_kernels_match_plain(cuda, R, C, T, nibble, gs, lo, hi, offsets):
    g = torch.Generator(device=cuda).manual_seed(R + C + T + gs)
    qt = chip_smoke._grouped_weight(R, C, nibble, gs, lo, hi, offsets, g)
    assert isinstance(qt, Q4Tensor) == nibble and qt.groups == C // gs
    x = torch.randn((T, C), device=cuda, generator=g)
    before = (qmatmul.launches, qmatmul.grouped_launches, qmatmul.q4_launches)
    if nibble:
        y, ref = qmatmul.q4_matmul(qt, x), qmatmul.q4_matmul_plain(qt, x)
        want = (before[0], before[1], before[2] + 1)
    else:
        y, ref = qmatmul.quant_matmul(qt, x), qmatmul.quant_matmul_plain(qt, x)
        want = (before[0], before[1] + 1, before[2])
    torch.cuda.synchronize()
    assert (qmatmul.launches, qmatmul.grouped_launches, qmatmul.q4_launches) == want
    _close(y, ref, 1e-4)


def _lossless_model(device, geom, fmt, mode, **kw):
    """Stacked serve-q / serve-q4 weights of a seeded checkpoint; ``mixed``:
    Q4_K nibbles with a Q6_K int8 down projection (16-column groups), as a
    Q4_K_M checkpoint mixes them."""
    from llm_inference_tpu_torch.gguf import GGMLType

    load = {"serve-q": "packed-serve", "serve-q4": "packed-q4"}[mode]

    def get(f):
        buf = chip_smoke.build_gemma3_gguf(vocab=VOCAB, weight_fmt=GGMLType[f], **GEOMS[geom], **kw)
        hp, w = load_weights(GGUFFile(buf), mode=load, device=device)
        w = fuse_projections(w)
        return hp, dataclasses.replace(w, layers=stack_layers(w.layers))

    if fmt != "mixed":
        return get(fmt)
    hp, w = get("Q4_K")
    _, w6 = get("Q6_K")
    return hp, dataclasses.replace(w, layers=dataclasses.replace(w.layers, w_down=w6.layers.w_down))


@pytest.mark.parametrize("geom,fmt,mode,post_norms,softcap,window,pos", [
    ("g2_d128", "Q4_0", "serve-q", True, 0.0, 0, 0),
    ("g2_d128", "Q4_K", "serve-q4", False, 0.0, 0, 200),   # attention split over four blocks
    ("g2_d128", "Q4_K", "serve-q", True, 20.0, 16, 150),   # softcap, a window inside one block
    ("g4_d256", "Q4_0", "serve-q4", False, 0.0, 100, 300),  # a window over two blocks
    ("g4_d256", "mixed", "serve-q4", True, 0.0, 0, 77),     # nibble and int8 parts, gs 32 and 16
    ("g2_d128", "Q8_0", "serve-q", False, 30.0, 0, 64),
    ("g2_d128", "Q6_K", "serve-q4", True, 0.0, 40, 120),    # Q6_K stays int8 in serve-q4
])
def test_decode_step_q_kernel_matches_plain(cuda, geom, fmt, mode, post_norms, softcap, window,
                                            pos):
    from llm_inference_tpu_torch.ops.kernels import fused_decode_q

    hp, w = _lossless_model(cuda, geom, fmt, mode, with_post_norms=post_norms)
    hp = dataclasses.replace(hp, attn_soft_cap=softcap)
    assert fused_decode_q.decode_q_supported(hp, w) and not fused_decode.decode_supported(hp, w)
    if fmt == "mixed":
        assert isinstance(w.layers.wqkv, Q4Tensor) and isinstance(w.layers.w_down, QuantTensor)
        assert w.layers.w_down.group_size == 16
    S = 512
    consts = fused_decode_q.prepare(hp, cuda, swa_mask=False, max_seq=S)
    consts.windows = torch.full_like(consts.windows, window)
    cache = gemma.init_cache(hp, S, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(pos + 1)
    cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=cuda, generator=g)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=cuda, generator=g)
    ck = gemma.KVCache(k=cache.k.clone(), v=cache.v.clone())
    cp = gemma.KVCache(k=cache.k.clone(), v=cache.v.clone())
    token = torch.tensor([37], dtype=torch.int64, device=cuda)
    p = torch.tensor([pos], dtype=torch.int32, device=cuda)
    before = fused_decode_q.launches
    y = fused_decode_q.decode_step_q(hp, w, ck, token, p, consts)
    ref = fused_decode_q.decode_step_q_plain(hp, w, cp, token, p, consts)
    torch.cuda.synchronize()
    assert fused_decode_q.launches == before + 1
    _close(y, ref, 1.5e-2)
    assert int(y.argmax()) == int(ref.argmax())
    for got, want in ((ck.k, cp.k), (ck.v, cp.v)):
        row0 = (got[0, pos].float() - want[0, pos].float()).abs()
        assert (row0 <= 2 ** -7 * want[0, pos].float().abs() + 1e-6).all()
        _close(got[:, pos], want[:, pos], 1.5e-2)
    untouched = torch.ones(S, dtype=torch.bool, device=cuda)
    untouched[pos] = False
    assert torch.equal(ck.k[:, untouched], cache.k[:, untouched])
    assert torch.equal(ck.v[:, untouched], cache.v[:, untouched])


def test_decode_step_q_kernel_refuses_out_of_range_inputs(cuda):
    from llm_inference_tpu_torch.ops.kernels import fused_decode_q

    hp, w = _lossless_model(cuda, "g2_d128", "Q4_K", "serve-q4")
    S = 64
    consts = fused_decode_q.prepare(hp, cuda, swa_mask=False, max_seq=S)
    cache = gemma.init_cache(hp, S, device=cuda)
    for tok, pos in ((5, S), (len(VOCAB), 3), (-1, 3)):
        y = fused_decode_q.decode_step_q(hp, w, cache, torch.tensor([tok], device=cuda),
                                         torch.tensor([pos], dtype=torch.int32, device=cuda),
                                         consts)
        assert torch.isnan(y).all()
        assert not cache.k.any() and not cache.v.any()


@pytest.mark.parametrize("mode", ["serve-q", "serve-q4"])
@pytest.mark.parametrize("route", ["kernel", "per-op"])
def test_lossless_engine_on_cuda_matches_cpu(cuda, tmp_path, monkeypatch, mode, route):
    from llm_inference_tpu_torch.gguf import GGMLType
    from llm_inference_tpu_torch.ops.kernels import fused_decode_q

    path = tmp_path / "m.gguf"
    path.write_bytes(chip_smoke.build_gemma3_gguf(vocab=VOCAB, with_post_norms=True,
                                                  weight_fmt=GGMLType.Q4_K, **GEOMS["g2_d128"]))
    if route == "per-op":
        monkeypatch.setenv("LLMI_NO_FUSED_DECODE", "1")
    prompt, n = [2, 40, 41, 42, 43], 16
    streams = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(str(path), max_seq=128, decode_chunk=4, mode=mode, device=dev)
        assert eng.decode_route == route
        eng.tokenizer.eos_id = eng.tokenizer.end_of_turn_id = -1
        qmatmul.launches = qmatmul.grouped_launches = qmatmul.q4_launches = 0
        fused_decode.launches = fused_decode_q.launches = 0
        stats = GenerationStats()
        streams[dev] = eng.generate_from_ids(prompt, n_predict=n, stats=stats)
        counts = (qmatmul.launches, qmatmul.grouped_launches, qmatmul.q4_launches,
                  fused_decode.launches, fused_decode_q.launches)
        if dev == "cpu":
            assert counts == (0, 0, 0, 0, 0)
        elif route == "kernel":  # prefill: plain GEMMs on the bf16 operand cache
            assert counts == (0, 0, 0, 0, stats.decode_steps) and stats.decode_steps > 0
        else:  # four projections a layer, prefill and every step
            per_op = 4 * eng.hparams.block_count * (stats.decode_steps + 1)
            want = (0, 0, per_op, 0, 0) if mode == "serve-q4" else (0, per_op, 0, 0, 0)
            assert counts == want
    assert streams["cuda"] == streams["cpu"]
    assert len(streams["cpu"]) == n


# -- the capacity step ------------------------------------------------------------
# Bars: the lossless step's (the same numerics over wider layers); the
# capacity Engine's greedy streams identical on the card and the CPU.

CAPACITY = {"4b": chip_smoke.GEOM_4B, "12b": chip_smoke.GEOM_12B, "27b": chip_smoke.GEOM_27B}


@pytest.mark.parametrize("geom", ["4b", "12b", "27b"])
@pytest.mark.parametrize("nibble", [False, True])
@pytest.mark.parametrize("window,pos", [(0, 0), (0, 1100), (1024, 1200), (100, 0)])
def test_decode_step_stream_kernel_matches_plain(cuda, geom, nibble, window, pos):
    """Two layers at the capacity widths, random weights: serve-q int8 in
    32-column groups or serve-q4 nibbles with Q4_K offsets, the down
    projection Q6_K-like int8 in 16-column groups either way; the flat
    cache; the full 262144-row bf16 embedding (2.8 GB at 27B: its row
    offsets pass 2^31)."""
    from llm_inference_tpu_torch.ops.kernels import fused_decode_q, fused_decode_stream

    hp = chip_smoke.hp_gemma3(**dict(CAPACITY[geom], n_layers=2), sliding_window=1024)
    w = chip_smoke._random_lossless_model(hp, seed=pos + window + len(geom), nibble=nibble)
    assert fused_decode_stream.decode_stream_supported(hp, w, max_seq=1280)
    assert not fused_decode_q.decode_q_supported(hp, w)
    S = 1280
    consts = fused_decode_stream.prepare(hp, cuda, swa_mask=False, max_seq=S)
    consts.windows = torch.full_like(consts.windows, window)
    cache = gemma.init_cache(hp, S, device=cuda, flat=True)
    g = torch.Generator(device=cuda).manual_seed(pos + 3)
    cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=cuda, generator=g)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=cuda, generator=g)
    ck = gemma.KVCache(k=cache.k.clone(), v=cache.v.clone())
    cp = gemma.KVCache(k=cache.k.clone(), v=cache.v.clone())
    token = torch.tensor([200001], dtype=torch.int64, device=cuda)
    p = torch.tensor([pos], dtype=torch.int32, device=cuda)
    before = fused_decode_stream.launches
    y = fused_decode_stream.decode_step_stream(hp, w, ck, token, p, consts)
    ref = fused_decode_stream.decode_step_stream_plain(hp, w, cp, token, p, consts)
    torch.cuda.synchronize()
    assert fused_decode_stream.launches == before + 1
    _close(y, ref, 1.5e-2)
    assert int(y.argmax()) == int(ref.argmax())
    for got, want in ((ck.k, cp.k), (ck.v, cp.v)):
        row0 = (got[0, pos].float() - want[0, pos].float()).abs()
        assert (row0 <= 2 ** -7 * want[0, pos].float().abs() + 1e-6).all()
        _close(got[:, pos], want[:, pos], 1.5e-2)
    untouched = torch.ones(S, dtype=torch.bool, device=cuda)
    untouched[pos] = False
    assert torch.equal(ck.k[:, untouched], cache.k[:, untouched])
    assert torch.equal(ck.v[:, untouched], cache.v[:, untouched])


def test_decode_step_stream_kernel_refuses_out_of_range_inputs(cuda):
    from llm_inference_tpu_torch.ops.kernels import fused_decode_stream

    hp = chip_smoke.hp_gemma3(**dict(chip_smoke.GEOM_4B, n_layers=2), sliding_window=1024)
    w = chip_smoke._random_lossless_model(hp, seed=5, nibble=True)
    S = 64
    consts = fused_decode_stream.prepare(hp, cuda, swa_mask=False, max_seq=S)
    cache = gemma.init_cache(hp, S, device=cuda, flat=True)
    for tok, pos in ((5, S), (chip_smoke.VOCAB_SIZE, 3), (-1, 3)):
        y = fused_decode_stream.decode_step_stream(
            hp, w, cache, torch.tensor([tok], device=cuda),
            torch.tensor([pos], dtype=torch.int32, device=cuda), consts)
        assert torch.isnan(y).all()
        assert not cache.k.any() and not cache.v.any()
    with pytest.raises(ValueError, match="exceeds the prepared scratch"):
        fused_decode_stream.decode_step_stream(
            hp, w, gemma.init_cache(hp, 2 * S, device=cuda, flat=True),
            torch.tensor([5], device=cuda), torch.tensor([3], dtype=torch.int32, device=cuda),
            consts)


@pytest.mark.parametrize("mode", ["serve-q", "serve-q4"])
def test_capacity_engine_on_cuda_matches_cpu(cuda, tmp_path, monkeypatch, mode):
    from llm_inference_tpu_torch.gguf import GGMLType
    from llm_inference_tpu_torch.ops.kernels import fused_decode_q, fused_decode_stream

    path = tmp_path / "m.gguf"
    path.write_bytes(chip_smoke.build_gemma3_gguf(vocab=VOCAB, with_post_norms=True,
                                                  weight_fmt=GGMLType.Q4_K, **GEOMS["g2_d128"]))
    monkeypatch.setenv("LLMI_FORCE_CAPACITY", "1")
    prompt, n = [2, 40, 41, 42, 43], 16
    streams = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(str(path), max_seq=128, decode_chunk=4, mode=mode, device=dev)
        assert eng.decode_route == "capacity" and eng.new_cache().k.dim() == 3
        eng.tokenizer.eos_id = eng.tokenizer.end_of_turn_id = -1
        qmatmul.launches = qmatmul.grouped_launches = qmatmul.q4_launches = 0
        fused_decode_q.launches = fused_decode_stream.launches = 0
        stats = GenerationStats()
        streams[dev] = eng.generate_from_ids(prompt, n_predict=n, stats=stats)
        counts = (qmatmul.grouped_launches, qmatmul.q4_launches, fused_decode_q.launches,
                  fused_decode_stream.launches)
        if dev == "cpu":
            assert counts == (0, 0, 0, 0)
        else:  # prefill per op over the stacked weights' layer views
            per_op = 4 * eng.hparams.block_count
            want = (0, per_op) if mode == "serve-q4" else (per_op, 0)
            assert counts == (*want, 0, stats.decode_steps) and stats.decode_steps > 0
    assert streams["cuda"] == streams["cpu"]
    assert len(streams["cpu"]) == n


# -- gemma4: the whole step's gemma4 instance ------------------------------------

G4_GEOMS = {
    # P 128, head_dim 128, two q heads per KV head
    "p128": dict(n_layers=4, n_embd=512, n_ff=512, n_head=4, n_head_kv=2, n_embd_per_layer=128),
    # P 256, head_dim 256, four q heads per KV head
    "p256": dict(n_layers=4, n_embd=1024, n_ff=2048, n_head=4, n_head_kv=1, n_embd_per_layer=256),
    # a 27B-class D (Gemma-3-27B's 5376): activations past the Gemma-3
    # instance's 1536 register columns, read from shared memory
    "d5376": dict(n_layers=4, n_embd=5376, n_ff=2048, n_head=8, n_head_kv=2, n_embd_per_layer=256,
                  head_dim=128),
}


@pytest.mark.parametrize("geom,shared,window,pos", [
    ("p128", 0, 0, 37), ("p128", 1, 0, 100), ("p128", 2, 8, 100), ("p128", 2, 0, 0),
    ("p256", 1, 0, 300), ("p256", 2, 64, 150), ("d5376", 1, 0, 70), ("d5376", 2, 32, 200),
])
def test_decode_step_g4_kernel_matches_plain(cuda, geom, shared, window, pos):
    """The gemma4 step against its plain twin (chip_smoke.check_g4_step:
    phase 4's bars, a planted fault in layer n_kv - 2, no write past the
    owner layers), with 0, 1 and 2 shared-KV layers, P 128 and 256, windows
    on and off (every fourth layer global), positions 0 to 300."""
    hp = chip_smoke.hp_gemma4(**G4_GEOMS[geom], shared_kv_layers=shared,
                              sliding_window=window or 16, vocab_size=512)
    w = chip_smoke.random_g4_model(hp, seed=pos + shared)
    assert fused_decode.decode_supported(hp, w)
    S = 512
    g = torch.Generator(device=cuda).manual_seed(pos)
    cache = gemma.init_cache(hp, S, device=cuda)
    cache.k[:, :pos] = (chip_smoke.G4_QK_NORM * torch.randn(cache.k[:, :pos].shape, device=cuda,
                                                           generator=g)).to(torch.bfloat16)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=cuda, generator=g).to(torch.bfloat16)
    consts = fused_decode.prepare(hp, cuda, swa_mask=window > 0, max_seq=S)
    token = torch.tensor([123], dtype=torch.int64, device=cuda)
    p = torch.tensor([pos], dtype=torch.int32, device=cuda)
    if shared == 0:  # no shared source to fault: plant it in layer 0
        chip_smoke._check_step_q(f"{geom} pos={pos}", hp, w, cache, token, p, consts,
                                 step=fused_decode.decode_step,
                                 plain=fused_decode.decode_step_plain, fault_layer=0)
    else:
        chip_smoke.check_g4_step(f"{geom} shared={shared} pos={pos}", hp, w, cache, token, p,
                                 consts)


def test_decode_step_g4_kernel_refuses_out_of_range_inputs(cuda):
    hp = chip_smoke.hp_gemma4(**G4_GEOMS["p128"], shared_kv_layers=1, sliding_window=16,
                              vocab_size=512)
    w = chip_smoke.random_g4_model(hp, seed=3)
    cache = gemma.init_cache(hp, 128, device=cuda)
    consts = fused_decode.prepare(hp, cuda, swa_mask=False, max_seq=128)
    for tok, pos in ((600, 3), (5, 128), (-1, 3)):
        y = fused_decode.decode_step(hp, w, cache, torch.tensor([tok], device=cuda),
                                     torch.tensor([pos], dtype=torch.int32, device=cuda), consts)
        assert torch.isnan(y).all()
    gemma3 = fused_decode.prepare(chip_smoke.hp_gemma3(**GEOMS["g2_d128"], sliding_window=0),
                                  cuda, swa_mask=False, max_seq=128)
    with pytest.raises(ValueError):
        fused_decode.decode_step(hp, w, cache, torch.tensor([5], device=cuda),
                                 torch.tensor([3], dtype=torch.int32, device=cuda), gemma3)


@pytest.mark.parametrize("route", ["kernel", "per-op"])
def test_gemma4_engine_on_cuda_matches_cpu(cuda, tmp_path, monkeypatch, route):
    """A gemma4 serve-q8 Engine on both routes: the CUDA kernels' stream
    equals the CPU's (plain twins), and the kernel route launches one
    decode_step a decode step."""
    if route == "per-op":
        monkeypatch.setenv("LLMI_NO_FUSED_DECODE", "1")
    path = tmp_path / "g4.gguf"
    path.write_bytes(chip_smoke.build_gemma4_gguf(
        n_layers=4, n_embd=512, n_ff=512, n_head=4, n_head_kv=2, n_embd_per_layer=128,
        shared_kv_layers=2, vocab=VOCAB))
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(str(path), max_seq=64, decode_chunk=4, device=dev)
        assert eng.decode_route == route
        eng.tokenizer.eos_id = eng.tokenizer.end_of_turn_id = -1
        fused_decode.launches = 0
        stats = GenerationStats()
        outs[dev] = eng.generate_from_ids([2, 40, 41, 42], n_predict=9, stats=stats)
        if dev == "cuda":
            assert fused_decode.launches == (stats.decode_steps if route == "kernel" else 0)
    assert outs["cuda"] == outs["cpu"]
