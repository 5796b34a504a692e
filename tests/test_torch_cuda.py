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
and out-of-range decode inputs.

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
from llm_inference_tpu_torch.quant.device import QuantTensor

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
