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
the K/V pair append insert_kv_rows from f32 rows with a strided V and from
bf16 rows at the 1B, gemma4 and 12B row shapes, flash_decode, the batched
whole step) at B in {1, 3, 8} (the step also at
17 and 64, with lanes at position 0 and S - 1), one or two KV
heads, head dims 128 and 256, and a server on both decode routes; the
lossless kernels (grouped quant_matmul, q4_matmul, the lossless whole
step) over 16- and 32-column groups, Q4_K offsets, centered and offset
nibbles, mixed nibble and int8 parts, odd T <= 64, softcap and windows,
the grouped kernels at every wgmma N instance and the 12B gate_up shape, a
bit-equal one-hot readback of their dequantized weight, a bit-equal second
launch, calls on two streams at once and a replayed CUDA graph (the same
for the rowwise quant_matmul, flash_decode and paged_flash_decode, and
flash lanes on every range edge of the flash plan), and Engine
serve-q / serve-q4 on both decode routes; the capacity step at
the Gemma-3 4B, 12B and 27B widths (two layers) on int8 and nibble parts
with Q4_K offsets and a 16-column-group down projection, windows on and
off, positions 0 and past 1000, a bit-equal second launch at 12B and 27B,
and the capacity Engine in serve-q and serve-q4; the paged-serving
kernels (paged_flash_decode, the paged batched whole step) at pages of 16,
32 and 256 slots, one or two KV heads, up to 8 q heads per KV head, head
dims 128 and 256, nb_cap, and a parked lane writing the trash page, and a
paged server on both paged routes; the gemma4 whole step (P 128 and
256, 0 to 2 shared-KV layers, windows on and off, and a 27B-class D of
5376) and a gemma4 Engine on both routes; flash_decode and
paged_flash_decode at heads of 512 and mixed Dk != Dv (GQA 4 and 8,
softcap, windows, range edges), insert_kv_rows at 512-wide and mixed rows,
and a gemma4 checkpoint with per-layer head dims (512 / 256) through the
Engine and both servers; the rowq8 steps on the tiled body
(Gemma-3 at the 1B and D-1536 widths on one chip and on 2 and 4 ranks,
windows on and off; gemma4 at GEOM_G4's widths with shared-KV layers), a
bit-equal second launch and the plan's shared memory equal to the
kernel's layout; the tensor-parallel steps (2 and 4 ranks on the card,
rowq8 with and without padded FFN shards, int8, nibble and mixed lossless
parts with Q4_K offsets, softcap and windows) over five consecutive steps
with their cache replicas bit-equal, out-of-range inputs, and a TP Engine
in serve-q8, serve-q and serve-q4; raw f16 group scales (the capacity
load's) on q4_matmul (rows of 36 groups padded to 40, the 12B gate_up) and
the capacity step (4B, 12B), bit-equal to the same weights' f32 scales,
refused where they do not belong, and the capacity Engine over them, its
logits bit-equal to its weights' f32 twin's.

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
        eng = Engine(str(path), max_seq=128, mode="serve-q8", decode_chunk=4, device=dev)
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
# Bars: insert_rows and insert_kv_rows bit-equal; flash_decode rtol = atol = 2e-3
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


@pytest.mark.parametrize("B", [1, 3, 8, 32])
# 1B, gemma4, 12B, GEOM_G4's global layers at 512
@pytest.mark.parametrize("Hkv,d", [(1, 256), (2, 256), (8, 256), (2, 512)])
@pytest.mark.parametrize("src", ["f32 strided v", "bf16"])
def test_insert_kv_rows_kernel_matches_plain(cuda, B, Hkv, d, src):
    """One launch appends K and V: bit-equal to the twin (cast, then
    insert, for each pool), a second launch bit-equal, one launch counted.
    ``k`` packed, ``v`` a column slice of a [B, (H + 2 Hkv) d] projection."""
    from llm_inference_tpu_torch.ops.kernels import kv_insert

    g = torch.Generator(device=cuda).manual_seed(B * d + Hkv)
    S, H = 40, 2 * Hkv
    dtype = torch.float32 if src.startswith("f32") else torch.bfloat16
    kpool = torch.randn((B * S, Hkv, d), device=cuda, generator=g).to(torch.bfloat16)
    vpool = torch.randn((B * S, Hkv, d), device=cuda, generator=g).to(torch.bfloat16)
    qkv = torch.randn((B, (H + 2 * Hkv) * d), device=cuda, generator=g).to(dtype)
    k = qkv[:, H * d:(H + Hkv) * d].reshape(B, Hkv, d).contiguous()
    v = qkv[:, (H + Hkv) * d:].reshape(B, Hkv, d)
    if dtype == torch.bfloat16:
        v = v.contiguous()
    idx = torch.arange(B, device=cuda, dtype=torch.int32) * S + 5
    idx[0] = B * S if B > 1 else -1  # a dropped row
    if B > 2:
        idx[2] = -7
    kref, vref = kpool.clone(), vpool.clone()
    kv_insert.insert_kv_rows_plain(kref, vref, k, v, idx)
    ka, va = kpool.clone(), vpool.clone()
    before = kv_insert.launches
    kv_insert.insert_kv_rows(ka, va, k, v, idx)
    torch.cuda.synchronize()
    assert kv_insert.launches == before + 1
    assert torch.equal(ka, kref) and torch.equal(va, vref)
    kb, vb = kpool.clone(), vpool.clone()
    kv_insert.insert_kv_rows(kb, vb, k, v, idx)
    assert torch.equal(kb, ka) and torch.equal(vb, va)


def test_insert_kv_rows_kernel_refuses(cuda):
    """On the card the pair launches or raises: a source whose row is not
    packed, an unaligned row stride, ids that are not int32."""
    from llm_inference_tpu_torch.ops.kernels import kv_insert

    kpool = torch.zeros((16, 2, 128), device=cuda, dtype=torch.bfloat16)
    vpool = torch.zeros_like(kpool)
    k = torch.zeros((2, 2, 128), device=cuda)
    idx = torch.tensor([0, 1], device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError):  # [H, d] not packed
        kv_insert.insert_kv_rows(kpool, vpool, k, torch.zeros((2, 128, 2), device=cuda).mT, idx)
    with pytest.raises(ValueError):  # a row stride of 1028 bytes
        kv_insert.insert_kv_rows(kpool, vpool, k, torch.zeros((2, 257), device=cuda)[:, :256]
                                 .reshape(2, 2, 128), idx)
    with pytest.raises(ValueError):
        kv_insert.insert_kv_rows(kpool, vpool, k, k, idx.long())
    assert not kpool.any() and not vpool.any()


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


@pytest.mark.parametrize("B", [1, 3, 8, 17, 64])
@pytest.mark.parametrize("geom,S", [("g2_d128", 512), ("g4_d256", 208), ("g2_d128", 80)])
def test_decode_step_batch_kernel_matches_plain(cuda, B, geom, S):
    """Ragged positions, the last lane parked (pos = S) when B > 1, and from
    17 lanes on a lane at position 0 and one at S - 1; S = 208 and 80 are not
    multiples of 64 (the TPU kernel's single cache chunk)."""
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
    if B >= 17:
        pos[0], pos[1] = 0, S - 1
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
    route on the card with insert_kv_rows and flash_decode swapped for their
    plain twins."""
    from llm_inference_tpu_torch.ops.kernels import flash_decode, fused_decode_batch, kv_insert
    from llm_inference_tpu_torch.serving import BatchedServer

    path = tmp_path / "m.gguf"
    path.write_bytes(chip_smoke.build_gemma3_gguf(vocab=VOCAB, weight_std=0.15,
                                                  **GEOMS["g2_d128"]))
    reqs = [([2, 7, 8], 9), ([2, 10, 11, 9], 6), ([2, 12], 7), ([2, 5, 6], 12), ([2, 4], 5)]

    def serve(dev):
        srv = BatchedServer(str(path), mode="serve-q8", max_seq=256, max_batch=4, decode_chunk=4,
                            device=dev)
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
    assert srv.decode_route == "per-op" and counts == (0, L * steps, L * steps)
    monkeypatch.setattr(kv_insert, "insert_kv_rows", kv_insert.insert_kv_rows_plain)
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


@pytest.mark.parametrize("B", [1, 3, 8, 17, 64])
@pytest.mark.parametrize("geom,page,nb", [("g2_d128", 16, 5), ("g4_d256", 32, 4),
                                          ("g2_d128", 256, 2)])
def test_decode_step_batch_paged_kernel_matches_plain(cuda, B, geom, page, nb):
    """Ragged positions over shuffled pages, the last lane parked (pos = nb *
    page, its table all sentinels) when B > 1: it writes the trash page; from
    17 lanes on a lane at position 0 and one at S - 1."""
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
    if B >= 17:
        pos[0], pos[1] = 0, S - 1
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
        srv = BatchedServer(str(path), mode="serve-q8", max_seq=128, max_batch=3, decode_chunk=4,
                            kv_pages=4, device=dev)
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
    assert srv.decode_route == "paged-per-op" and counts == (0, L * steps, L * steps)
    monkeypatch.setattr(kv_insert, "insert_kv_rows", kv_insert.insert_kv_rows_plain)
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
    # every wgmma N instance and a T between them, C split (wqkv, down) and not (gate_up)
    *[(1536, 1152, T, False, 32, -8, 7, False) for T in (1, 8, 17, 32, 64)],
    *[(1152, 6912, T, True, 32, -8, 7, False) for T in (1, 8, 17, 32, 64)],
    *[(13824, 1152, T, False, 16, -32, 31, False) for T in (1, 17, 64)],
    # the 12B gate_up (capacity prefill), x split to fit beside the ring at T = 64
    (30720, 3840, 1, False, 32, -8, 7, False),
    (30720, 3840, 32, True, 32, -8, 7, False),
    (30720, 3840, 64, False, 32, 0, 15, True),
    # nibbles in 16-column groups (and half a nibble stage at C = 1152, 640)
    *[(200, 640, T, True, 16, 0, 15, True) for T in (1, 8, 17, 32, 64)],
    (1536, 1152, 17, True, 16, -8, 7, False),
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


# The one-hot readback: x made of unit rows reads the kernel's dequantized
# weight back column by column, which must be dequant_bf16_tpu's bit for bit
# (every int8 value, every nibble, bf16 roundings on ties: chip_smoke's
# onehot_weight), C split or not; a second launch is bit-equal; calls on two
# streams at once and a replayed CUDA graph give the eager results.


@pytest.mark.parametrize("R,C", [(200, 512), (300, 2304)])
@pytest.mark.parametrize("nibble,gs,offsets", [
    (False, 32, False), (False, 32, True), (False, 16, False),
    (True, 32, False), (True, 32, True), (True, 16, True)])
def test_grouped_onehot_readback_is_bit_equal(cuda, R, C, nibble, gs, offsets):
    qt = chip_smoke.onehot_weight(R, C, nibble, gs, offsets)
    fn = qmatmul.q4_matmul if nibble else qmatmul.quant_matmul
    y = chip_smoke.onehot_readback(fn, qt)
    want = qmatmul.dequant_bf16_tpu(qt.quants() if nibble else qt.q, qt).float().T
    torch.cuda.synchronize()
    assert torch.equal(y, want), f"{int((y != want).sum())} of {y.numel()} differ"


def _split_weights(cuda):
    """Three grouped weights whose plans split C (int8, nibbles) or not."""
    g = torch.Generator(device=cuda).manual_seed(11)
    return [(chip_smoke._grouped_weight(R, C, nib, 32, lo, hi, off, g), nib)
            for R, C, nib, lo, hi, off in ((1536, 1152, False, -8, 7, False),
                                           (1152, 6912, True, 0, 15, True),
                                           (13824, 1152, False, -127, 127, False))]


def test_grouped_second_launch_is_bit_equal(cuda):
    g = torch.Generator(device=cuda).manual_seed(12)
    for qt, nib in _split_weights(cuda):
        fn = qmatmul.q4_matmul if nib else qmatmul.quant_matmul
        for T in (1, 32):
            x = torch.randn((T, qt.cols), device=cuda, generator=g)
            assert torch.equal(fn(qt, x), fn(qt, x))


def test_grouped_calls_on_two_streams_at_once(cuda):
    g = torch.Generator(device=cuda).manual_seed(13)
    (qa, na), (qb, nb), _ = _split_weights(cuda)
    xa = torch.randn((17, qa.cols), device=cuda, generator=g)
    xb = torch.randn((32, qb.cols), device=cuda, generator=g)
    fa = qmatmul.q4_matmul if na else qmatmul.quant_matmul
    fb = qmatmul.q4_matmul if nb else qmatmul.quant_matmul
    want_a, want_b = fa(qa, xa), fb(qb, xb)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    s1.wait_stream(torch.cuda.current_stream())
    s2.wait_stream(torch.cuda.current_stream())
    got_a, got_b = [], []
    for _ in range(20):  # both streams' row tiles 0.. count arrivals at the same time
        with torch.cuda.stream(s1):
            got_a.append(fa(qa, xa))
        with torch.cuda.stream(s2):
            got_b.append(fb(qb, xb))
    torch.cuda.synchronize()
    assert all(torch.equal(y, want_a) for y in got_a)
    assert all(torch.equal(y, want_b) for y in got_b)


def test_grouped_cuda_graph_replays(cuda):
    g = torch.Generator(device=cuda).manual_seed(14)
    calls = []
    for qt, nib in _split_weights(cuda):
        fn = qmatmul.q4_matmul if nib else qmatmul.quant_matmul
        x = torch.randn((32, qt.cols), device=cuda, generator=g)
        calls.append((fn, qt, x, fn(qt, x)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graph asks
        for fn, qt, x, _ in calls:
            fn(qt, x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(qt, x) for fn, qt, x, _ in calls]
    for _ in range(3):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, want) for o, (*_, want) in zip(outs, calls))
    assert all(torch.equal(fn(qt, x), want) for fn, qt, x, want in calls)  # eager again


# -- one launch a call: the rowwise quant_matmul, flash_decode, paged_flash_decode ----
# As the grouped kernel's: a second launch is bit-equal, calls on two streams
# at once and a replayed CUDA graph give the eager results, with the arrival
# counters left at 0; and lanes of every length on the flash plan's range
# edges agree with the plain twins (rtol = atol = 2e-3).


def _one_launch_calls(cuda, kind, seed):
    """Zero-argument calls of ``kind`` whose plans split the work over
    several blocks that meet on arrival counters (and one that does not)."""
    from llm_inference_tpu_torch.ops.kernels import flash_decode

    g = torch.Generator(device=cuda).manual_seed(seed)
    calls = []
    if kind == "rowwise":
        for R, C, T in ((1536, 1152, 32), (1152, 6912, 1), (13824, 1152, 17)):
            q = torch.randint(-127, 128, (R, C), dtype=torch.int8, device=cuda, generator=g)
            scale = torch.rand((R, 1), device=cuda, generator=g) * 1e-2
            qt = QuantTensor(q=q, scale=scale, fmt=None, rows=R, cols=C)
            x = torch.randn((T, C), device=cuda, generator=g)
            calls.append(lambda qt=qt, x=x: qmatmul.quant_matmul(qt, x))
        return calls
    for B, S, Hkv, G, d in ((8, 1024, 1, 4, 256), (3, 600, 2, 2, 128), (2, 64, 1, 8, 128)):
        q = torch.randn((B, Hkv * G, d), device=cuda, generator=g) * 0.3
        lengths = torch.randint(0, S + 1, (B,), device=cuda, generator=g, dtype=torch.int32)
        lengths[0] = S
        if kind == "flash":
            k = torch.randn((B, S, Hkv, d), device=cuda, generator=g).to(torch.bfloat16)
            v = torch.randn((B, S, Hkv, d), device=cuda, generator=g).to(torch.bfloat16)
            calls.append(lambda q=q, k=k, v=v, n=lengths: flash_decode.flash_decode(
                q, k, v, n, softcap=30.0))
        else:
            page = 32
            nb = -(-S // page)
            N = B * nb + 1
            k = torch.randn((N, page, Hkv, d), device=cuda, generator=g).to(torch.bfloat16)
            v = torch.randn((N, page, Hkv, d), device=cuda, generator=g).to(torch.bfloat16)
            table = torch.randperm(N, device=cuda, generator=g)[: B * nb].reshape(B, nb)
            calls.append(lambda q=q, k=k, v=v, t=table.to(torch.int32), n=lengths:
                         flash_decode.paged_flash_decode(q, k, v, t, n))
    return calls


def _counters_at_zero():
    from llm_inference_tpu_torch.ops.kernels import _build

    torch.cuda.synchronize()
    return all(int(c.abs().sum()) == 0 for c in _build._counters.values())


@pytest.mark.parametrize("kind", ["rowwise", "flash", "paged_flash"])
def test_one_launch_second_launch_is_bit_equal(cuda, kind):
    for fn in _one_launch_calls(cuda, kind, 21):
        assert torch.equal(fn(), fn())
    assert _counters_at_zero()


@pytest.mark.parametrize("kind", ["rowwise", "flash", "paged_flash"])
def test_one_launch_calls_on_two_streams_at_once(cuda, kind):
    fa, fb, _ = _one_launch_calls(cuda, kind, 22)
    want_a, want_b = fa(), fb()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    s1.wait_stream(torch.cuda.current_stream())
    s2.wait_stream(torch.cuda.current_stream())
    got_a, got_b = [], []
    for _ in range(20):  # both streams' counters taken at the same time
        with torch.cuda.stream(s1):
            got_a.append(fa())
        with torch.cuda.stream(s2):
            got_b.append(fb())
    torch.cuda.synchronize()
    assert all(torch.equal(y, want_a) for y in got_a)
    assert all(torch.equal(y, want_b) for y in got_b)
    assert _counters_at_zero()


@pytest.mark.parametrize("kind", ["rowwise", "flash", "paged_flash"])
def test_one_launch_cuda_graph_replays(cuda, kind):
    calls = [(fn, fn()) for fn in _one_launch_calls(cuda, kind, 23)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graph asks
        for fn, _ in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for fn, _ in calls]
    for _ in range(3):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, want) for o, (_, want) in zip(outs, calls))
        assert _counters_at_zero()
    assert all(torch.equal(fn(), want) for fn, want in calls)  # eager again


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("B,Hkv,G,d", [(32, 1, 4, 256), (1, 2, 2, 128), (4, 1, 8, 128),
                                       (8, 2, 4, 512)])
def test_flash_decode_lengths_on_range_edges(cuda, paged, B, Hkv, G, d):
    """Lanes ending (and windows starting) one before, on and one after each
    range edge of the plan, a full lane and an empty one."""
    from llm_inference_tpu_torch.ops.kernels import _build, flash_decode

    S, page = 1024, 48
    nb = -(-S // page)
    slots = nb * page if paged else S
    rs = flash_decode.plan(B, slots, Hkv * G, Hkv, d, d, page if paged else None,
                           _build.sm_count(cuda)).range_size
    edges = sorted({0, 1, slots} | {e + k for e in range(rs, slots, rs) for k in (-1, 0, 1)})
    g = torch.Generator(device=cuda).manual_seed(B + d + G)
    for i in range(0, len(edges), B):
        chunk = (edges[i:i + B] * B)[:B]
        lengths = torch.tensor(chunk, dtype=torch.int32, device=cuda)
        starts = torch.tensor((edges[::-1] * B)[i:i + B], dtype=torch.int32, device=cuda) % (
            lengths + 1)
        q = torch.randn((B, Hkv * G, d), device=cuda, generator=g) * 0.3
        if paged:
            N = B * nb + 1
            k = torch.randn((N, page, Hkv, d), device=cuda, generator=g).to(torch.bfloat16)
            v = torch.randn((N, page, Hkv, d), device=cuda, generator=g).to(torch.bfloat16)
            table = torch.randperm(N, device=cuda, generator=g)[: B * nb].reshape(B, nb)
            table = table.to(torch.int32)
            for st in (None, starts):
                got = flash_decode.paged_flash_decode(q, k, v, table, lengths, st)
                ref = flash_decode.paged_flash_decode_plain(q, k, v, table, lengths, st)
                torch.testing.assert_close(got, ref, rtol=2e-3, atol=2e-3)
        else:
            k = torch.randn((B, S, Hkv, d), device=cuda, generator=g).to(torch.bfloat16)
            v = torch.randn((B, S, Hkv, d), device=cuda, generator=g).to(torch.bfloat16)
            for st in (None, starts):
                got = flash_decode.flash_decode(q, k, v, lengths, st)
                ref = flash_decode.flash_decode_plain(q, k, v, lengths, st)
                torch.testing.assert_close(got, ref, rtol=2e-3, atol=2e-3)
        assert not got[lengths == 0].any()


# -- heads of 512 and per-layer head dims (Gemma 4's global heads) -----------------
# Bars: flash_decode and paged_flash_decode within rtol = atol = 2e-3 of their
# twins, a second launch bit-equal; insert_kv_rows bit-equal; streams of
# the per-layer head dims checkpoint equal on the kernels and their twins.


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("Dk,Dv", [(512, 512), (512, 256), (256, 512)])
@pytest.mark.parametrize("Hkv,G", [(2, 4), (1, 8)])
def test_flash_decode_wide_heads_match_plain(cuda, paged, Dk, Dv, Hkv, G):
    """Heads up to 512 and mixed Dk != Dv (the CPL = 2 score instantiation,
    64-thread P.V slot groups), GQA 4 and 8, softcap on, window starts,
    ragged and empty lanes; a second launch bit-equal."""
    from llm_inference_tpu_torch.ops.kernels import flash_decode

    B, S, page = 5, 640, 64
    g = torch.Generator(device=cuda).manual_seed(Dk + Dv + G)
    q = torch.randn((B, Hkv * G, Dk), device=cuda, generator=g) * 0.05
    lengths = torch.tensor([640, 0, 1, 333, 129], dtype=torch.int32, device=cuda)
    starts = torch.clamp(lengths - 200, min=0).to(torch.int32)
    if paged:
        nb = S // page
        N = B * nb + 2
        k = torch.randn((N, page, Hkv, Dk), device=cuda, generator=g).to(torch.bfloat16)
        v = torch.randn((N, page, Hkv, Dv), device=cuda, generator=g).to(torch.bfloat16)
        table = torch.randperm(N, device=cuda, generator=g)[: B * nb].reshape(B, nb)
        table = table.to(torch.int32)
        table[1] = N + 5  # the empty lane's ids past the pool

        def run():
            return flash_decode.paged_flash_decode(q, k, v, table, lengths, starts, softcap=30.0)

        ref = flash_decode.paged_flash_decode_plain(q, k, v, table, lengths, starts, softcap=30.0)
        count = lambda: flash_decode.paged_launches  # noqa: E731
    else:
        k = torch.randn((B, S, Hkv, Dk), device=cuda, generator=g).to(torch.bfloat16)
        v = torch.randn((B, S, Hkv, Dv), device=cuda, generator=g).to(torch.bfloat16)

        def run():
            return flash_decode.flash_decode(q, k, v, lengths, starts, softcap=30.0)

        ref = flash_decode.flash_decode_plain(q, k, v, lengths, starts, softcap=30.0)
        count = lambda: flash_decode.launches  # noqa: E731
    before = count()
    got, again = run(), run()
    torch.cuda.synchronize()
    assert count() == before + 2
    assert got.shape == (B, Hkv * G, Dv) and torch.isfinite(got).all() and not got[1].any()
    torch.testing.assert_close(got, ref, rtol=2e-3, atol=2e-3)
    assert torch.equal(got, again)


def test_flash_decode_refuses_heads_past_512(cuda):
    """On the card a wrapper launches or raises: no plain-twin fallback for
    heads the kernel does not take."""
    from llm_inference_tpu_torch.ops.kernels import flash_decode

    q = torch.zeros((1, 2, 520), device=cuda)
    kv = torch.zeros((1, 64, 1, 520), device=cuda, dtype=torch.bfloat16)
    lengths = torch.ones(1, dtype=torch.int32, device=cuda)
    before = flash_decode.launches
    with pytest.raises(ValueError):
        flash_decode.flash_decode(q, kv, kv, lengths)
    assert flash_decode.launches == before


def test_insert_kv_rows_mixed_widths_match_plain(cuda):
    """K rows of 512 and V rows of 256 in one launch (f32 rows, v a column
    slice of the projection), bit-equal to the twin, twice."""
    from llm_inference_tpu_torch.ops.kernels import kv_insert

    g = torch.Generator(device=cuda).manual_seed(7)
    B, S, Hkv, dk, dv = 4, 40, 2, 512, 256
    kpool = torch.randn((B * S, Hkv, dk), device=cuda, generator=g).to(torch.bfloat16)
    vpool = torch.randn((B * S, Hkv, dv), device=cuda, generator=g).to(torch.bfloat16)
    qkv = torch.randn((B, 8 * dk + Hkv * (dk + dv)), device=cuda, generator=g)
    k = qkv[:, 8 * dk:8 * dk + Hkv * dk].reshape(B, Hkv, dk).contiguous()
    v = qkv[:, 8 * dk + Hkv * dk:].reshape(B, Hkv, dv)
    idx = torch.tensor([3, B * S, 2 * S + 9, 3 * S + 39], dtype=torch.int32, device=cuda)
    kref, vref = kpool.clone(), vpool.clone()
    kv_insert.insert_kv_rows_plain(kref, vref, k, v, idx)
    for _ in range(2):
        ka, va = kpool.clone(), vpool.clone()
        kv_insert.insert_kv_rows(ka, va, k, v, idx)
        torch.cuda.synchronize()
        assert torch.equal(ka, kref) and torch.equal(va, vref)


def test_head_dims_engine_and_servers_on_cuda(cuda, tmp_path, monkeypatch):
    """A gemma4 checkpoint with global heads of 512 and sliding ones of 256
    (the pattern puts layer n_kv - 1 global, n_kv - 2 sliding): the Engine
    in serve-q8 on the per-op route with LLMI_FLASH_DECODE=1 (flash_decode
    at both widths, one a layer and step) gives the masked route's stream;
    the dense and paged servers' per-op routes (insert_kv_rows and
    flash_decode / paged_flash_decode once a layer and step) give the
    streams of the same routes on the card with those kernels swapped for
    their plain twins, under LLMI_SWA_MASK unset and =1."""
    from llm_inference_tpu_torch.ops.kernels import flash_decode, kv_insert
    from llm_inference_tpu_torch.serving import BatchedServer

    path = tmp_path / "hd.gguf"
    path.write_bytes(chip_smoke.build_gemma4_gguf(
        n_layers=6, n_embd=256, n_ff=512, n_head=8, n_head_kv=2, n_embd_per_layer=128,
        shared_kv_layers=2, vocab=VOCAB, head_dims=(512, 256),
        pattern=[True, True, True, False, True, False], sliding_window=8))
    prompt, n = [2, 7, 8, 9, 4, 5, 6, 30, 8, 7, 2, 9], 10
    reqs = [([2, 7, 8], 9), ([2, 10, 11, 9], 6), ([2, 12], 7), ([2, 5, 6], 12)]
    monkeypatch.setenv("LLMI_PAGE", "32")
    for swa in ("0", "1"):
        monkeypatch.setenv("LLMI_SWA_MASK", swa)
        eng = Engine(str(path), max_seq=256, mode="serve-q8", decode_chunk=4, device="cuda")
        assert eng.decode_route == "per-op"
        assert [t.shape[-1] for t in eng.new_cache().k] == [256, 256, 256, 512]
        eng.tokenizer.eos_id = eng.tokenizer.end_of_turn_id = -1
        masked = eng.generate_from_ids(prompt, n_predict=n)
        monkeypatch.setenv("LLMI_FLASH_DECODE", "1")
        flash_decode.launches = 0
        stats = GenerationStats()
        assert eng.generate_from_ids(prompt, n_predict=n, stats=stats) == masked
        monkeypatch.delenv("LLMI_FLASH_DECODE")
        assert flash_decode.launches == 6 * stats.decode_steps > 0

        def serve(pages):
            srv = BatchedServer(str(path), mode="serve-q8", max_seq=256, max_batch=3,
                                decode_chunk=4, kv_pages=pages, device="cuda")
            srv.tokenizer.eos_id = srv.tokenizer.end_of_turn_id = -1
            kv_insert.launches = flash_decode.launches = flash_decode.paged_launches = 0
            out = srv.run(reqs)
            steps = srv.stats.decode_steps
            return out, (kv_insert.launches, flash_decode.launches + flash_decode.paged_launches,
                         steps)

        for pages in (None, 6):
            got, (ins, fl, steps) = serve(pages)
            assert ins == 4 * steps and fl == 6 * steps and steps > 0
            with monkeypatch.context() as m:
                m.setattr(kv_insert, "insert_kv_rows", kv_insert.insert_kv_rows_plain)
                m.setattr(flash_decode, "flash_decode", flash_decode.flash_decode_plain)
                m.setattr(flash_decode, "paged_flash_decode",
                          flash_decode.paged_flash_decode_plain)
                want, counts = serve(pages)
            assert counts[:2] == (0, 0) and got == want


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


# -- the whole-layer lossless steps on the tiled stream -----------------------------
# Rows 4 and 12 of PERF.md at their real widths: the Gemma-3-1B's and the
# widest a whole step takes (D and H * dv at 1536, three q heads a KV head),
# two layers, the full 262144-row bf16 embedding, random group-scaled
# weights in every phase: Q4_K nibbles and int8 with offsets, Q4_0 nibbles
# and int8. Bars: the lossless step's against its plain twin, and a second
# launch bit-equal in logits and every cache row (one card; two ranks on it
# for the tensor-parallel step, its replicas bit-equal).

TILED_GEOMS = {"1b": chip_smoke.GEOM_1B,
               "w1536": dict(n_embd=1536, n_ff=6144, n_head=12, n_head_kv=4, head_dim=128)}
TILED_VARIANTS = {"Q4_K nibble": "nibble offsets (Q4_K)", "Q4_K int8": "int8 gs32 offsets (Q4_K)",
                  "Q4_0 nibble": "nibble centered (Q4_0)", "Q4_0 int8": "int8 gs32 (Q4_0)"}


def _tiled_model(cuda, hp, variant: str, seed: int):
    """Stacked random weights of ``hp`` with every projection in one
    chip_smoke.GROUPED_VARIANTS variant, and a bf16 embedding."""
    from llm_inference_tpu_torch.gguf import GGMLType
    from llm_inference_tpu_torch.models.weights import LayerWeights, ModelWeights
    from llm_inference_tpu_torch.quant.device import DenseTensor

    g = torch.Generator(device=cuda).manual_seed(seed)
    nib, gs, (lo, hi), off = {v[0]: v[1:] for v in chip_smoke.GROUPED_VARIANTS}[variant]
    L, D, F = hp.block_count, hp.embedding_length, hp.feed_forward_length
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v

    def part(R, C):
        return chip_smoke._grouped_weight(R, C, nib, gs, lo, hi, off, g, lead=(L,))

    def norm(*shape):
        return 1.0 + 0.1 * torch.randn(shape, device=cuda, generator=g)

    layers = LayerWeights(
        attn_norm=norm(L, D), ffn_norm=norm(L, D), q_norm=norm(L, dk), k_norm=norm(L, dk),
        post_attn_norm=norm(L, D), post_ffw_norm=norm(L, D),
        wqkv=part(H * dk + Hkv * (dk + dv), D), wo=part(D, H * dv), w_gate_up=part(2 * F, D),
        w_down=part(D, F))
    V = chip_smoke.VOCAB_SIZE
    emb = DenseTensor(w=(0.02 * torch.randn((V, D), device=cuda, generator=g)).to(torch.bfloat16),
                      fmt=GGMLType.BF16, rows=V, cols=D)
    return ModelWeights(token_embd=emb, output_norm=norm(D), layers=layers)


@pytest.mark.parametrize("geom", list(TILED_GEOMS))
@pytest.mark.parametrize("variant", list(TILED_VARIANTS))
@pytest.mark.parametrize("n", [1, 2])
def test_whole_layer_tiled_steps_match_plain_and_relaunch_bit_equal(cuda, geom, variant, n):
    from llm_inference_tpu_torch.ops.kernels import (fused_decode_q, fused_decode_q_tp,
                                                     fused_decode_stream)
    from llm_inference_tpu_torch.parallel import make_mesh

    hp = chip_smoke.hp_gemma3(**dict(TILED_GEOMS[geom], n_layers=2), sliding_window=128)
    w = _tiled_model(cuda, hp, TILED_VARIANTS[variant], seed=len(geom) + 7 * n)
    assert fused_decode_q.decode_q_supported(hp, w)
    S, pos = 512, 300
    g = torch.Generator(device=cuda).manual_seed(n)
    cache = gemma.init_cache(hp, S, device=cuda)
    cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=cuda, generator=g)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=cuda, generator=g)
    token = torch.tensor([200001], dtype=torch.int64, device=cuda)
    p = torch.tensor([pos], dtype=torch.int32, device=cuda)

    def fresh():
        return gemma.KVCache(k=cache.k.clone(), v=cache.v.clone())

    if n == 1:
        consts = fused_decode_q.prepare(hp, cuda, swa_mask=True, max_seq=S)
        runs = [(fused_decode_q.decode_step_q(hp, w, c, token, p, consts), [c])
                for c in (fresh(), fresh())]
        cp = fresh()
        ref = fused_decode_q.decode_step_q_plain(hp, w, cp, token, p, consts)
        (plan, _), = consts.scratch["plans"].values()
        # the plan's shared memory is the kernel's layout, byte for byte
        lw = w.layers
        assert fused_decode_stream._lib("fused_decode_q").fused_decode_q_smem(
            hp.embedding_length, lw.w_down.cols, lw.wo.cols, lw.wqkv.rows, hp.n_head,
            hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v, plan.stage_bytes,
            plan.stages) == plan.smem
    else:
        assert fused_decode_q_tp.tp_decode_q_supported(hp, w, n)
        tw = fused_decode_q_tp.shard_for_tp(hp, w, n, make_mesh(
            model=n, devices=[cuda] * n).model_devices)
        consts = fused_decode_q_tp.prepare(hp, tw, swa_mask=True, max_seq=S)
        runs = []
        for _ in range(2):
            cs = [fresh() for _ in range(n)]
            runs.append((fused_decode_q_tp.decode_step_q_tp(hp, tw, cs, token, p, consts), cs))
        cp = fresh()
        ref = fused_decode_q_tp.decode_step_q_tp_plain(hp, tw, [cp] + [fresh()] * (n - 1),
                                                       token, p, consts)
        (plan, _), = consts.step[0].scratch["plans"].values()
    torch.cuda.synchronize()
    (y, cs), (y2, cs2) = runs
    _close(y, ref, 1.5e-2)
    assert int(y.argmax()) == int(ref.argmax())
    assert torch.equal(y, y2)
    for c in cs + cs2:  # every replica of both launches bit-equal
        assert torch.equal(c.k, cs[0].k) and torch.equal(c.v, cs[0].v)
    row0 = (cs[0].k[0, pos].float() - cp.k[0, pos].float()).abs()
    assert (row0 <= 2 ** -7 * cp.k[0, pos].float().abs() + 1e-6).all()
    assert plan.stages >= 2 and plan.smem <= 232448 - 1024


# -- the rowq8 whole steps on the tiled body ----------------------------------------
# Row 3 (the Gemma-3 instance) and row 11 (2 and 4 ranks on the card) at the
# 1B and the D-1536 widths, two layers, the full 262144-row int8 embedding,
# random rowq8 weights, windows on and off; row 3's gemma4 instance at
# GEOM_G4's widths over six layers, two of them sharing K/V. Bars: the
# kernel against its plain twin, a second launch bit-equal in logits and
# every cache row (every replica), and the plan's shared memory the
# kernel's layout, byte for byte.


@pytest.mark.parametrize("geom", list(TILED_GEOMS))
@pytest.mark.parametrize("window", [0, 128])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_rowq8_steps_match_plain_and_relaunch_bit_equal(cuda, geom, window, n):
    from llm_inference_tpu_torch.ops.kernels import _build, fused_decode_stream, fused_decode_tp
    from llm_inference_tpu_torch.parallel import make_mesh

    hp = chip_smoke.hp_gemma3(**dict(TILED_GEOMS[geom], n_layers=2),
                              sliding_window=window or 128)
    w = chip_smoke._random_model(hp, seed=len(geom) + 5 * n)
    assert fused_decode.decode_supported(hp, w)
    S, pos = 512, 300
    g = torch.Generator(device=cuda).manual_seed(window + n)
    cache = gemma.init_cache(hp, S, device=cuda)
    cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=cuda, generator=g)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=cuda, generator=g)
    token = torch.tensor([200001], dtype=torch.int64, device=cuda)
    p = torch.tensor([pos], dtype=torch.int32, device=cuda)
    Hkv, dk, dv = hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v

    def fresh():
        return gemma.KVCache(k=cache.k.clone(), v=cache.v.clone())

    if n == 1:
        consts = fused_decode.prepare(hp, cuda, swa_mask=window > 0, max_seq=S)
        runs = [(fused_decode.decode_step(hp, w, c, token, p, consts), [c])
                for c in (fresh(), fresh())]
        cp = fresh()
        ref = fused_decode.decode_step_plain(hp, w, cp, token, p, consts)
        (plan, _), = consts.scratch["plans"].values()
        lw = w.layers
        smem = fused_decode_stream._lib("fused_decode").fused_decode_smem(
            hp.embedding_length, lw.w_down.cols, lw.wo.cols, lw.wqkv.rows, hp.n_head, Hkv, dk,
            dv, plan.stage_bytes, plan.stages)
    else:
        assert fused_decode_tp.tp_decode_supported(hp, w, n)
        tw = fused_decode_tp.shard_for_tp(hp, w, n, make_mesh(
            model=n, devices=[cuda] * n).model_devices)
        consts = fused_decode_tp.prepare(hp, tw, swa_mask=window > 0, max_seq=S)
        runs = []
        for _ in range(2):
            cs = [fresh() for _ in range(n)]
            runs.append((fused_decode_tp.decode_step_tp(hp, tw, cs, token, p, consts), cs))
        cp = fresh()
        ref = fused_decode_tp.decode_step_tp_plain(hp, tw, [cp] + [fresh()] * (n - 1), token, p,
                                                   consts)
        rank = consts.step[0]
        (plan, _), = rank.scratch["plans"].values()
        rl = tw.ranks[0].layers
        smem = _build.library("fused_decode_tp").fused_decode_tp_smem(
            hp.embedding_length, rl.w_down.cols, rl.wo.cols, rl.wqkv.rows, tw.geom["Hl"], Hkv,
            dk, dv, rank.scratch["G"], plan.stage_bytes, plan.stages)
    torch.cuda.synchronize()
    (y, cs), (y2, cs2) = runs
    _close(y, ref, 1.5e-2)
    assert int(y.argmax()) == int(ref.argmax())
    assert torch.equal(y, y2)
    for c in cs + cs2:  # every replica of both launches bit-equal
        assert torch.equal(c.k, cs[0].k) and torch.equal(c.v, cs[0].v)
    row0 = (cs[0].k[0, pos].float() - cp.k[0, pos].float()).abs()
    assert (row0 <= 2 ** -7 * cp.k[0, pos].float().abs() + 1e-6).all()
    _close(cs[0].k[:, pos], cp.k[:, pos], 1.5e-2)
    assert smem == plan.smem and plan.stages >= 2


@pytest.mark.parametrize("window", [0, 128])
def test_rowq8_gemma4_step_at_geom_g4_matches_plain_and_relaunch_bit_equal(cuda, window):
    """chip_smoke.check_g4_step's bars (a second launch bit-equal, the
    planted fault in the windowed source layer, no write past the owner
    layers) over six GEOM_G4 layers, the last two sharing K/V; the plan's
    eight phases and its shared memory the kernel's layout."""
    from llm_inference_tpu_torch.ops.kernels import fused_decode_stream

    hp = chip_smoke.hp_gemma4(**dict(chip_smoke.GEOM_G4, n_layers=6, shared_kv_layers=2),
                              sliding_window=chip_smoke.G4_WINDOW)
    w = chip_smoke.random_g4_model(hp, seed=29 + window)
    assert fused_decode.decode_supported(hp, w)
    S, pos = 512, 300
    g = torch.Generator(device=cuda).manual_seed(window)
    cache = gemma.init_cache(hp, S, device=cuda)
    cache.k[:, :pos] = (chip_smoke.G4_QK_NORM * torch.randn(cache.k[:, :pos].shape, device=cuda,
                                                           generator=g)).to(torch.bfloat16)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=cuda, generator=g).to(torch.bfloat16)
    consts = fused_decode.prepare(hp, cuda, swa_mask=window > 0, max_seq=S)
    token = torch.tensor([222222], dtype=torch.int64, device=cuda)
    p = torch.tensor([pos], dtype=torch.int32, device=cuda)
    chip_smoke.check_g4_step(f"GEOM_G4 6 layers window={window}", hp, w, cache, token, p, consts)
    (plan, _), = consts.scratch["plans"].values()
    lw = w.layers
    smem = fused_decode_stream._lib("fused_decode_g4").fused_decode_g4_smem(
        hp.embedding_length, lw.w_down.cols, lw.wo.cols, lw.wqkv.rows, hp.n_head, hp.n_head_kv,
        hp.n_embd_head_k, hp.n_embd_head_v, plan.stage_bytes, plan.stages)
    assert len(plan.rb) == 8 and smem == plan.smem


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


@pytest.mark.parametrize("geom", ["12b", "27b"])
@pytest.mark.parametrize("nibble", [False, True])
def test_decode_step_stream_kernel_relaunch_bit_equal(cuda, geom, nibble):
    """Two layers at the widest geometries, the plan's ring (at least three
    stages; four or more where shared memory leaves room): a second launch
    gives bit-equal logits and K/V rows, and the plan is the one launched."""
    from llm_inference_tpu_torch.ops.kernels import fused_decode_stream

    hp = chip_smoke.hp_gemma3(**dict(CAPACITY[geom], n_layers=2), sliding_window=1024)
    w = chip_smoke._random_lossless_model(hp, seed=11, nibble=nibble)
    S, pos = 512, 300
    consts = fused_decode_stream.prepare(hp, cuda, swa_mask=True, max_seq=S)
    cache = gemma.init_cache(hp, S, device=cuda, flat=True)
    g = torch.Generator(device=cuda).manual_seed(5)
    cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=cuda, generator=g)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=cuda, generator=g)
    token = torch.tensor([7], dtype=torch.int64, device=cuda)
    p = torch.tensor([pos], dtype=torch.int32, device=cuda)
    outs = []
    for _ in range(2):
        c = gemma.KVCache(k=cache.k.clone(), v=cache.v.clone())
        outs.append((fused_decode_stream.decode_step_stream(hp, w, c, token, p, consts), c))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1].k, outs[1][1].k) and torch.equal(outs[0][1].v, outs[1][1].v)
    (plan, _), = consts.scratch["plans"].values()
    assert plan.stages >= 3 and plan.smem <= 232448 - 1024


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
    # a 27B-class D (Gemma-3-27B's 5376), past the Gemma-3 instance's 1536
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
        eng = Engine(str(path), max_seq=64, mode="serve-q8", decode_chunk=4, device=dev)
        assert eng.decode_route == route
        eng.tokenizer.eos_id = eng.tokenizer.end_of_turn_id = -1
        fused_decode.launches = 0
        stats = GenerationStats()
        outs[dev] = eng.generate_from_ids([2, 40, 41, 42], n_predict=9, stats=stats)
        if dev == "cuda":
            assert fused_decode.launches == (stats.decode_steps if route == "kernel" else 0)
    assert outs["cuda"] == outs["cpu"]


# -- tensor parallelism: n ranks on one card ------------------------------------------

TP_VOCAB = [f"t{i}" for i in range(512)]  # a 4-way shard needs V / 4 a multiple of 128
TP_VOCAB[1], TP_VOCAB[2], TP_VOCAB[3] = "<eos>", "<bos>", "<unk>"


def _tp_model(device, geom, fmt, mode, **kw):
    """Stacked weights of a seeded checkpoint with TP_VOCAB: rowq8 (serve-q8)
    or lossless, ``mixed`` as in _lossless_model."""
    from llm_inference_tpu_torch.gguf import GGMLType

    load = {"serve-q8": "rowq8", "serve-q": "packed-serve", "serve-q4": "packed-q4"}[mode]

    def get(f):
        buf = chip_smoke.build_gemma3_gguf(vocab=TP_VOCAB, weight_fmt=GGMLType[f],
                                           **{**GEOMS[geom], **kw})
        hp, w = load_weights(GGUFFile(buf), mode=load, device=device)
        w = fuse_projections(w)
        return hp, dataclasses.replace(w, layers=stack_layers(w.layers))

    if fmt != "mixed":
        return get(fmt)
    hp, w = get("Q4_K")
    _, w6 = get("Q6_K")
    return hp, dataclasses.replace(w, layers=dataclasses.replace(w.layers, w_down=w6.layers.w_down))


@pytest.mark.parametrize("geom,fmt,mode,n,softcap,window,pos,kw", [
    ("g2_d128", "Q4_0", "serve-q8", 2, 0.0, 0, 0, {}),
    ("g2_d128", "Q4_0", "serve-q8", 4, 20.0, 16, 150, {}),   # 1 q head a rank, softcap, window
    ("g4_d256", "Q4_0", "serve-q8", 2, 0.0, 100, 300, {}),   # a window over several blocks
    ("g4_d256", "Q4_0", "serve-q8", 4, 0.0, 0, 77, {"with_post_norms": True}),
    ("g2_d128", "Q4_0", "serve-q8", 4, 0.0, 0, 200, {"n_ff": 640}),  # F / 4 = 160 padded to 256
    ("g2_d128", "Q4_0", "serve-q", 2, 0.0, 0, 0, {"with_post_norms": True}),
    ("g2_d128", "Q4_K", "serve-q4", 4, 20.0, 16, 150, {}),   # nibbles and Q4_K offsets
    ("g4_d256", "Q4_K", "serve-q", 2, 0.0, 100, 300, {}),    # int8 with offsets
    ("g4_d256", "Q4_0", "serve-q4", 2, 0.0, 0, 77, {}),      # centered nibbles
    ("g4_d256", "mixed", "serve-q4", 4, 0.0, 0, 200, {}),    # nibbles with a gs-16 int8 down
])
def test_decode_step_tp_kernels_match_plain(cuda, geom, fmt, mode, n, softcap, window, pos, kw):
    """The tensor-parallel steps (n ranks on one card) against their plain
    twins over five consecutive steps (a stale all-reduce flag or epoch
    would show in a later one), every rank's cache replica bit-equal to
    the others, layer 0's written rows within one bf16 step of the twin's,
    and the logits within the single-chip kernel's bar of its own."""
    from llm_inference_tpu_torch.ops.kernels import (fused_decode_q, fused_decode_q_tp,
                                                     fused_decode_tp)
    from llm_inference_tpu_torch.parallel import make_mesh

    hp, w = _tp_model(cuda, geom, fmt, mode, **kw)
    hp = dataclasses.replace(hp, attn_soft_cap=softcap)
    q8 = mode == "serve-q8"
    mod = fused_decode_tp if q8 else fused_decode_q_tp
    single = fused_decode if q8 else fused_decode_q
    step = mod.decode_step_tp if q8 else mod.decode_step_q_tp
    plain = mod.decode_step_tp_plain if q8 else mod.decode_step_q_tp_plain
    single_step = single.decode_step if q8 else single.decode_step_q
    assert (mod.tp_decode_supported if q8 else mod.tp_decode_q_supported)(hp, w, n)
    tw = mod.shard_for_tp(hp, w, n, make_mesh(model=n, devices=[cuda] * n).model_devices)
    if "n_ff" in kw:
        assert tw.geom["Flp"] == 256 and tw.geom["Fl"] == 160
    S = 512
    consts = mod.prepare(hp, tw, swa_mask=False, max_seq=S)
    c1 = single.prepare(hp, cuda, swa_mask=False, max_seq=S)
    for c in consts.step + [c1]:
        c.windows = torch.full_like(c.windows, window)
    cache = gemma.init_cache(hp, S, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(pos + n)
    cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=cuda, generator=g)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=cuda, generator=g)
    ck = [gemma.KVCache(k=cache.k.clone(), v=cache.v.clone()) for _ in range(n)]
    cp = [gemma.KVCache(k=cache.k.clone(), v=cache.v.clone()) for _ in range(n)]
    cs = gemma.KVCache(k=cache.k.clone(), v=cache.v.clone())
    for i, tok in enumerate([37, 300, 5, 511, 128]):
        token = torch.tensor([tok], dtype=torch.int64, device=cuda)
        p = torch.tensor([pos + i], dtype=torch.int32, device=cuda)
        before = mod.launches
        y = step(hp, tw, ck, token, p, consts)
        ref = plain(hp, tw, cp, token, p, consts)
        y1 = single_step(hp, w, cs, token, p, c1)
        torch.cuda.synchronize()
        assert mod.launches == before + 1  # one launch covers every rank on the card
        _close(y, ref, 1.5e-2)
        _close(y, y1, 1.5e-2)
        assert int(y.argmax()) == int(ref.argmax())
        for c in ck:
            assert torch.equal(c.k, ck[0].k) and torch.equal(c.v, ck[0].v)
        for got, want in ((ck[0].k, cp[0].k), (ck[0].v, cp[0].v)):
            row0 = (got[0, pos + i].float() - want[0, pos + i].float()).abs()
            assert (row0 <= 2 ** -7 * want[0, pos + i].float().abs() + 1e-6).all()
            _close(got[:, pos + i], want[:, pos + i], 1.5e-2)
    untouched = torch.ones(S, dtype=torch.bool, device=cuda)
    untouched[pos : pos + 5] = False
    assert torch.equal(ck[0].k[:, untouched], cache.k[:, untouched])
    assert torch.equal(ck[0].v[:, untouched], cache.v[:, untouched])


def test_decode_step_tp_kernel_refuses_out_of_range_inputs(cuda):
    """A position past the cache or a token past the vocabulary writes no
    replica and returns NaN logits on every rank, and the next valid step
    (whose all-reduces follow on the skipped ones' epoch) is right."""
    from llm_inference_tpu_torch.ops.kernels import fused_decode_tp
    from llm_inference_tpu_torch.parallel import make_mesh

    hp, w = _tp_model(cuda, "g2_d128", "Q4_0", "serve-q8")
    tw = fused_decode_tp.shard_for_tp(hp, w, 2, make_mesh(model=2, devices=[cuda] * 2)
                                      .model_devices)
    S = 64
    consts = fused_decode_tp.prepare(hp, tw, swa_mask=False, max_seq=S)
    caches = [gemma.init_cache(hp, S, device=cuda) for _ in range(2)]
    for tok, pos in ((5, S), (len(TP_VOCAB), 3), (-1, 3)):
        y = fused_decode_tp.decode_step_tp(hp, tw, caches, torch.tensor([tok], device=cuda),
                                           torch.tensor([pos], dtype=torch.int32, device=cuda),
                                           consts)
        assert torch.isnan(y).all()
        assert not any(c.k.any() or c.v.any() for c in caches)
    token, p = torch.tensor([5], device=cuda), torch.tensor([0], dtype=torch.int32, device=cuda)
    y = fused_decode_tp.decode_step_tp(hp, tw, caches, token, p, consts)
    ref = fused_decode_tp.decode_step_tp_plain(
        hp, tw, [gemma.init_cache(hp, S, device=cuda) for _ in range(2)], token, p, consts)
    _close(y, ref, 1.5e-2)


@pytest.mark.parametrize("mode,n", [("serve-q8", 2), ("serve-q8", 4), ("serve-q", 2),
                                    ("serve-q4", 2)])
def test_tp_engine_on_cuda_matches_cpu(cuda, tmp_path, mode, n):
    """Engine(tp_mesh=[cuda] * n): the TP kernels' stream equals the CPU
    mesh's (plain twins) and the single-card kernel route's, with one TP
    launch a decode step."""
    from llm_inference_tpu_torch.gguf import GGMLType
    from llm_inference_tpu_torch.ops.kernels import fused_decode_q_tp, fused_decode_tp
    from llm_inference_tpu_torch.parallel import make_mesh

    path = tmp_path / "m.gguf"
    path.write_bytes(chip_smoke.build_gemma3_gguf(vocab=TP_VOCAB, weight_fmt=GGMLType.Q4_K,
                                                  weight_std=0.15, seed=7, **GEOMS["g2_d128"]))
    mod = fused_decode_tp if mode == "serve-q8" else fused_decode_q_tp
    outs = {}
    for dev in ("cpu", "cuda"):
        for mesh in (None, make_mesh(model=n, devices=[torch.device(dev)] * n)):
            eng = Engine(str(path), max_seq=64, mode=mode, decode_chunk=4, device=dev,
                         tp_mesh=mesh)
            assert eng.decode_route == ("kernel" if mesh is None else "tp")
            eng.tokenizer.eos_id = eng.tokenizer.end_of_turn_id = -1
            mod.launches = 0
            stats = GenerationStats()
            outs[(dev, mesh is None)] = eng.generate_from_ids([2, 40, 41, 42], n_predict=9,
                                                              stats=stats)
            if dev == "cuda" and mesh is not None:
                assert mod.launches == stats.decode_steps > 0
    assert len(set(map(tuple, outs.values()))) == 1, outs


# -- the serve and parity modes ------------------------------------------------------
# Bars: greedy streams identical to the CPU's (serve: the same bf16 products
# and plain attention; parity: the exact products, with the scores summed in
# true f32 on the card and in f64 on the CPU); parity's prefill logits within
# 1.5e-2 * max(1, max|logits|) of the CPU's with equal argmax.


@pytest.mark.parametrize("mode", ["serve", "parity"])
def test_serve_and_parity_engine_on_cuda_match_cpu(cuda, tmp_path, mode, monkeypatch):
    """Both modes decode per op on the card; under LLMI_FLASH_DECODE=1 the
    serve decode attends through flash_decode, one launch a layer and step,
    and gives the same stream."""
    from llm_inference_tpu_torch.ops.kernels import flash_decode

    path = tmp_path / "m.gguf"
    path.write_bytes(chip_smoke.build_gemma3_gguf(vocab=VOCAB, with_post_norms=True,
                                                  **GEOMS["g2_d128"]))
    prompt, n = [2, 40, 41, 42, 43], 8
    streams, logits = {}, {}
    for dev in ("cpu", "cuda"):
        eng = Engine(str(path), max_seq=256, mode=mode, decode_chunk=4, device=dev)
        assert eng.decode_route == "per-op"
        eng.tokenizer.eos_id = eng.tokenizer.end_of_turn_id = -1
        stats = GenerationStats()
        streams[dev] = eng.generate_from_ids(prompt, n_predict=n, stats=stats)
        logits[dev] = stats.first_logits.float().cpu()
    assert streams["cuda"] == streams["cpu"]
    _close(logits["cuda"], logits["cpu"], 1.5e-2)
    assert int(logits["cuda"].argmax()) == int(logits["cpu"].argmax())
    if mode == "serve":
        monkeypatch.setenv("LLMI_FLASH_DECODE", "1")
        eng = Engine(str(path), max_seq=256, mode=mode, decode_chunk=4, device="cuda")
        eng.tokenizer.eos_id = eng.tokenizer.end_of_turn_id = -1
        flash_decode.launches = 0
        stats = GenerationStats()
        assert eng.generate_from_ids(prompt, n_predict=n, stats=stats) == streams["cpu"]
        assert flash_decode.launches == eng.hparams.block_count * stats.decode_steps > 0


def test_exact_matmul_refuses_tf32(cuda):
    """The parity contract's products run in true f32 or raise: TF32 allowed
    (either switch) refuses the exact matmul and the parity scores."""
    from llm_inference_tpu_torch.gguf import GGMLType
    from llm_inference_tpu_torch.models.hparams import load_hparams
    from llm_inference_tpu_torch.ops import linear
    from llm_inference_tpu_torch.quant.device import DenseTensor

    w = DenseTensor(w=torch.randn(64, 32, device=cuda), fmt=GGMLType.F32, rows=64, cols=32)
    x = torch.randn(3, 32, device=cuda)
    _close(linear.matmul(w, x, exact=True), x @ w.w.T, 1e-6)
    hp = load_hparams(GGUFFile(chip_smoke.build_gemma3_gguf(vocab=VOCAB)).metadata)
    q = torch.randn(1, 2, 16, device=cuda)
    k = torch.randn(4, 1, 16, device=cuda, dtype=torch.float16)
    prec = torch.get_float32_matmul_precision()
    for flip in ("allow_tf32", "precision"):
        if flip == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        try:
            with pytest.raises(RuntimeError, match="true f32"):
                linear.matmul(w, x, exact=True)
            with pytest.raises(RuntimeError, match="true f32"):
                gemma._masked_scores(q, k, pos=3, hp=hp, exact=True)
        finally:
            torch.set_float32_matmul_precision(prec)
            torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("paged", [False, True])
def test_serve_server_on_cuda_launches_the_kernels(cuda, tmp_path, paged, monkeypatch):
    """serve's BatchedServer, dense or paged (per op): each decode step
    launches insert_kv_rows and flash_decode (dense) or paged_flash_decode
    (paged) once a layer and never calls their plain twins; its streams
    equal the same route's with the kernels swapped for the twins."""
    from llm_inference_tpu_torch.ops.kernels import flash_decode, kv_insert
    from llm_inference_tpu_torch.serving import BatchedServer

    path = tmp_path / "m.gguf"
    path.write_bytes(chip_smoke.build_gemma3_gguf(vocab=VOCAB, weight_std=0.15,
                                                  **GEOMS["g2_d128"]))
    reqs = [([2, 7, 8], 9), ([2, 10, 11, 9], 6), ([2, 12], 7), ([2, 5, 6], 12), ([2, 4], 5)]
    if paged:
        monkeypatch.setenv("LLMI_PAGE", "32")
    twins = []
    for mod, name in ((kv_insert, "insert_kv_rows_plain"), (flash_decode, "flash_decode_plain"),
                      (flash_decode, "paged_flash_decode_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **kw:
                            twins.append(_n) or _r(*a, **kw))

    def serve():
        srv = BatchedServer(str(path), mode="serve", max_seq=256, max_batch=3, decode_chunk=4,
                            kv_pages=4 if paged else None, device="cuda")
        kv_insert.launches = flash_decode.launches = flash_decode.paged_launches = 0
        out = srv.run(reqs)
        return srv, out, (kv_insert.launches, flash_decode.launches, flash_decode.paged_launches)

    srv, got, counts = serve()
    L, steps = srv.hparams.block_count, srv.stats.decode_steps
    assert srv.decode_route == ("paged-per-op" if paged else "per-op")
    assert counts == (L * steps, 0 if paged else L * steps, L * steps if paged else 0)
    assert steps > 0 and twins == []
    monkeypatch.setattr(kv_insert, "insert_kv_rows", kv_insert.insert_kv_rows_plain)
    monkeypatch.setattr(flash_decode, "flash_decode", flash_decode.flash_decode_plain)
    monkeypatch.setattr(flash_decode, "paged_flash_decode", flash_decode.paged_flash_decode_plain)
    _, want, counts = serve()
    assert counts == (0, 0, 0) and got == want and twins


# The group pass against passes of one on the two-layer fixture, by mode:
# each bar just above the gap measured on the card (NVIDIA H100 80GB HBM3,
# 700.00 W, dense and paged alike; PERF.md §6), far below the tame 1B's
# 1e-1 of phases 7 and 12, which its 26 layers' amplification sets. Layer 0
# is bit-equal in serve-q8 (exact int8 sums); from layer 1 a flipped int8
# (serve-q8) or bf16 (serve-q4) rounding of an activation row, after the
# batch's f32 attention sums, moves the rows.
# a KV layer's rows' relative Frobenius error: measured 5.725e-3 and 1.107e-3
GROUP_KV_BAR = {"serve-q8": 1e-2, "serve-q4": 2e-3}
# the logits' max-abs gap over max|logits|: measured 2.305e-2 and 2.898e-3
GROUP_LOGITS_BAR = {"serve-q8": 3e-2, "serve-q4": 5e-3}


@pytest.mark.parametrize("mode", ["serve-q8", "serve-q4"])
@pytest.mark.parametrize("paged", [False, True])
def test_group_prefill_on_cuda_equals_lone_prefills(cuda, tmp_path, mode, paged, monkeypatch):
    """A same-bucket group of six ragged prompts admitted in one group pass
    against the same prompts admitted one at a time (passes of one), on one
    two-layer server, dense or paged: first ids equal and every KV layer's
    rows within the mode's GROUP_KV_BAR (chip_smoke.admission_check); the
    group pass's logits within its GROUP_LOGITS_BAR of the single-stream
    ``forward``'s, member by member, with equal argmax; and a group of one
    bit-equal to the single-stream ``forward``, logits and every K/V row."""
    from llm_inference_tpu_torch.serving import BatchedServer

    path = tmp_path / "m.gguf"
    path.write_bytes(chip_smoke.build_gemma3_gguf(vocab=VOCAB, weight_std=0.15,
                                                  **GEOMS["g4_d256"]))
    if paged:
        monkeypatch.setenv("LLMI_PAGE", "32")
    srv = BatchedServer(str(path), mode=mode, max_seq=256, max_batch=8, decode_chunk=4,
                        kv_pages=16 if paged else None, device="cuda")
    prompts = [[2] + [(7 * i + 11 * j) % 250 + 4 for j in range(n)]
               for i, n in enumerate((2, 31, 9, 17, 24, 5))]
    what = f"{mode} {'paged' if paged else 'dense'}"
    out = chip_smoke.admission_check(what, srv, prompts, bar=GROUP_KV_BAR[mode])
    assert out["ids_equal"] == len(prompts) and out["kv_rel"] <= GROUP_KV_BAR[mode]
    hp, w = srv.hparams, srv.weights
    toks = torch.zeros((len(prompts), 32), dtype=torch.int64)
    for g, p in enumerate(prompts):
        toks[g, :len(p)] = torch.tensor(p)
    toks = toks.cuda()
    logits, _ = gemma.forward_prefill_group(hp, w, toks, [len(p) for p in prompts])
    gap = 0.0
    for g, p in enumerate(prompts):
        n = len(p)
        lone_logits, lone = gemma.forward(hp, w, gemma.init_cache(hp, 32, device="cuda"),
                                          toks[g], 0, n, mm_impl="xla")
        assert int(lone_logits.argmax()) == int(logits[g].argmax()), g
        gap = max(gap, ((logits[g] - lone_logits).abs().max()
                        / lone_logits.abs().max()).item())
        # a group of one is the single-stream forward bit for bit: the gaps are the batch's order
        one_logits, one = gemma.forward_prefill_group(hp, w, toks[g:g + 1], [n])
        assert torch.equal(one_logits[0], lone_logits)
        for i in range(hp.n_kv_layers):
            assert torch.equal(one.k[i][0, :n], lone.k[i][:n])
            assert torch.equal(one.v[i][0, :n], lone.v[i][:n])
    chip_smoke.log(f"{what}: group pass against passes of one: KV rows' relative Frobenius "
                   f"error {out['kv_rel']:.3e} (bar {GROUP_KV_BAR[mode]:.1e}), logits max-abs gap "
                   f"over max|logits| {gap:.3e} (bar {GROUP_LOGITS_BAR[mode]:.1e})")
    assert gap <= GROUP_LOGITS_BAR[mode]


# -- raw f16 group scales (the capacity load's) ------------------------------------------
# Bars: the f32 scales' bars against the twins, and bit-equal to the same
# weights with f32 scales (f16 -> f32 is exact).


def _f16_pair(qt):
    """(the weight with f32 scales, the same with an f16 scale plane): its
    scales rounded to f16 values first, as a checkpoint's d is."""
    from llm_inference_tpu_torch.quant.device import f16_scales

    s = qt.scale.half()
    return dataclasses.replace(qt, scale=s.float()), dataclasses.replace(qt, scale=f16_scales(s))


@pytest.mark.parametrize("R,C,T", [(1536, 1152, 1), (1536, 1152, 32), (200, 640, 17),
                                   (1152, 6912, 64), (30720, 3840, 32)])
def test_q4_matmul_f16_scales_match_plain_and_f32(cuda, R, C, T):
    g = torch.Generator(device=cuda).manual_seed(R + C + T)
    q32, q16 = _f16_pair(chip_smoke._grouped_weight(R, C, True, 32, -8, 7, False, g))
    assert q16.scale.dtype == torch.float16 and q16.scale.stride(0) == -(-(C // 32) // 8) * 8
    x = torch.randn((T, C), device=cuda, generator=g)
    before = qmatmul.q4_launches
    y16, y32, again = qmatmul.q4_matmul(q16, x), qmatmul.q4_matmul(q32, x), qmatmul.q4_matmul(q16, x)
    ref = qmatmul.q4_matmul_plain(q16, x)
    torch.cuda.synchronize()
    assert qmatmul.q4_launches == before + 3
    assert torch.equal(y16, y32) and torch.equal(y16, again)
    assert torch.equal(ref, qmatmul.q4_matmul_plain(q32, x))
    _close(y16, ref, 1e-4)


def test_f16_scales_refused_where_they_do_not_belong(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((4, 1152), device=cuda, generator=g)
    i8 = chip_smoke._grouped_weight(256, 1152, False, 32, -8, 7, False, g)
    with pytest.raises(ValueError, match="centered Q4Tensor's f16 scale plane"):
        qmatmul.quant_matmul(dataclasses.replace(i8, scale=i8.scale.half()), x)
    nib = chip_smoke._grouped_weight(256, 1152, True, 32, -8, 7, False, g)
    with pytest.raises(ValueError, match="f16 scale plane"):  # rows of 72 bytes, unpadded
        qmatmul.q4_matmul(dataclasses.replace(nib, scale=nib.scale.half().contiguous()), x)
    q4k = chip_smoke._grouped_weight(256, 1152, True, 32, 0, 15, True, g)
    with pytest.raises(ValueError, match="Q4_K keeps f32"):
        dataclasses.replace(q4k, scale=q4k.scale.half())


@pytest.mark.parametrize("geom", ["4b", "12b"])
def test_decode_step_stream_f16_scales_match_plain_and_f32(cuda, geom):
    """Two layers at the capacity widths, centered Q4_0 nibbles in every
    projection: the step over f16 scale planes against its twin, bit-equal
    to the f32 scales' step (logits and K/V rows) and to its second launch."""
    from llm_inference_tpu_torch.ops.kernels import fused_decode_stream

    hp = chip_smoke.hp_gemma3(**dict(CAPACITY[geom], n_layers=2), sliding_window=1024)
    w = chip_smoke._random_lossless_model(hp, seed=19, nibble=True,
                                          variant=chip_smoke.Q4_0_SYMMETRIC)
    parts = ("wqkv", "wo", "w_gate_up", "w_down")
    pairs = {f: _f16_pair(getattr(w.layers, f)) for f in parts}
    w32, w16 = (dataclasses.replace(w, layers=dataclasses.replace(
        w.layers, **{f: pairs[f][i] for f in parts})) for i in (0, 1))
    assert fused_decode_stream.decode_stream_supported(hp, w16, max_seq=512)
    S, pos = 512, 300
    consts = fused_decode_stream.prepare(hp, cuda, swa_mask=False, max_seq=S)
    cache = gemma.init_cache(hp, S, device=cuda, flat=True)
    gen = torch.Generator(device=cuda).manual_seed(7)
    cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=cuda, generator=gen)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=cuda, generator=gen)
    token = torch.tensor([1234], dtype=torch.int64, device=cuda)
    p = torch.tensor([pos], dtype=torch.int32, device=cuda)
    outs = []
    for ww in (w16, w32, w16):
        c = gemma.KVCache(k=cache.k.clone(), v=cache.v.clone())
        outs.append((fused_decode_stream.decode_step_stream(hp, ww, c, token, p, consts), c))
    cp = gemma.KVCache(k=cache.k.clone(), v=cache.v.clone())
    ref = fused_decode_stream.decode_step_stream_plain(hp, w16, cp, token, p, consts)
    torch.cuda.synchronize()
    for y, c in outs[1:]:
        assert torch.equal(y, outs[0][0])
        assert torch.equal(c.k, outs[0][1].k) and torch.equal(c.v, outs[0][1].v)
    _close(outs[0][0], ref, 1.5e-2)
    assert int(outs[0][0].argmax()) == int(ref.argmax())
    assert len(consts.scratch["plans"]) == 2  # one plan a scale width


def test_capacity_engine_f16_scales_on_cuda(cuda, tmp_path, monkeypatch):
    """A Q4_0 serve-q4 checkpoint whose D (384) gives rows of 12 groups (24
    bytes, padded to 32) under LLMI_FORCE_CAPACITY=1: the capacity route
    keeps f16 scales, its prefill (q4_matmul) and decode (the capacity step)
    give the logits of its weights' f32 twin bit for bit, and the stream
    equals the CPU's."""
    from llm_inference_tpu_torch.gguf import GGMLType
    from llm_inference_tpu_torch.ops.kernels import fused_decode_stream

    path = tmp_path / "m.gguf"
    path.write_bytes(chip_smoke.build_gemma3_gguf(
        vocab=VOCAB, with_post_norms=True, weight_fmt=GGMLType.Q4_0, n_layers=2, n_embd=384,
        n_ff=768, n_head=4, n_head_kv=1, head_dim=128))
    monkeypatch.setenv("LLMI_FORCE_CAPACITY", "1")
    prompt, n = [2, 40, 41, 42, 43], 12
    runs = {}
    for dev in ("cuda", "cpu"):
        eng = Engine(str(path), max_seq=128, decode_chunk=4, mode="serve-q4", device=dev)
        assert eng.decode_route == "capacity"
        assert eng.weights.layers.wqkv.scale.dtype == torch.float16
        eng.tokenizer.eos_id = eng.tokenizer.end_of_turn_id = -1
        for f16 in ((True, False) if dev == "cuda" else (True,)):
            if not f16:
                eng.weights = eng._prefill_w = chip_smoke.f32_scales(eng.weights)
            logits = chip_smoke._first_step_logits(eng, prompt)
            qmatmul.q4_launches = fused_decode_stream.launches = 0
            stats = GenerationStats()
            out = eng.generate_from_ids(prompt, n_predict=n, stats=stats)
            if dev == "cuda":
                assert (qmatmul.q4_launches, fused_decode_stream.launches) == (
                    4 * eng.hparams.block_count, stats.decode_steps)
            runs[(f16, dev)] = (out, [t.cpu() for t in logits])
    (o32, l32), (o16, l16) = runs[(False, "cuda")], runs[(True, "cuda")]
    assert o16 == o32 == runs[(True, "cpu")][0] and len(o16) == n
    assert all(torch.equal(a, b) for a, b in zip(l16, l32))
