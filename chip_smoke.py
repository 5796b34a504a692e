#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

  1. device   the card's name and power limit (nvidia-smi); no GPU -> fail.
  2. build    nvcc builds every kernel source in llm_inference_tpu_torch/csrc
              (one process per source, all started together).
  3. quant_matmul  the kernel against its plain twin at the four Gemma-3-1B
              layer shapes and T in {1, 32, 64}; tolerance 1e-4 * max(1, max|y|)
              (the products are exact, only the summation order differs).
  4. decode_step   the whole-step kernel against its plain twin at full 1B
              width and depth, one step at position 300 over seeded K/V rows
              0..299, with and without sliding windows; logits within
              1.5e-2 * max(1, max|logits|) with equal argmax (the bar of
              tests/test_fused_decode.py); layer 0's written K/V row within
              one bf16 step (2^-7 relative), every layer's within the logits' bar.
  5. slice    the tame synthetic Gemma-3-1B checkpoint (bench.py's
              build_tame_checkpoint bytes, built here with the port's own
              writer, cached in the temp directory), Engine(mode="serve-q8")
              on cuda, the golden 32-token prompt, 100 greedy tokens: the
              stream must equal tests/golden/parity_1b_tame.json, prefill must
              launch quant_matmul 4 x 26 = 104 times and decode one
              decode_step per step. TTFT is the median of seven prefills.

The last lines are the card line, one JSON object with each kernel's
numbers, and {"ok": true, "device": {...}}. Times are CUDA-event means over
repeated launches (quant_matmul's, its plain twin's and torch.matmul's
through CUDA graphs, as each takes less time than the host needs to issue
it); bound_ms is the larger of bytes / 3.35 TB/s and
operations / 989 TFLOP/s (H100 SXM data sheet, bf16 dense).
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12

GEOM_1B = dict(n_layers=26, n_embd=1152, n_ff=6912, n_head=4, n_head_kv=1, head_dim=256)
VOCAB_SIZE = 262144
TAME_SEED, TAME_STD = 20260816, 0.02


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)


def bound_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(iters):
        fn(i)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def graph_ms(fn, calls: int, replays: int = 20) -> float:
    """Device time a call of ``fn(i)``: ``calls`` calls captured in one CUDA
    graph and replayed, so the host's per-call overhead (which exceeds a
    small kernel's time) is not counted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graph asks
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (replays * calls)


def build_gemma3_gguf(*, n_layers=1, n_embd=32, n_ff=64, n_head=2, n_head_kv=1, vocab=None,
                      seed=12345, rope_freq_base=10000.0, with_post_norms=False,
                      head_dim=None, weight_std=0.1) -> bytes:
    """The seeded synthetic Gemma-3 checkpoint of tests/fixtures.py
    (Q4_0 layer weights, F16 embeddings), byte for byte, written with the
    port's own GGUF writer."""
    from llm_inference_tpu_torch.gguf import GGMLType, GGUFWriter

    explicit_head_dim = head_dim is not None and head_dim != n_embd // n_head
    head_dim = head_dim if head_dim is not None else n_embd // n_head
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return (rng.standard_normal(shape) * weight_std).astype(np.float32)

    w = GGUFWriter()
    w.add_metadata("general.architecture", "gemma3")
    w.add_metadata("gemma3.block_count", n_layers)
    w.add_metadata("gemma3.embedding_length", n_embd)
    w.add_metadata("gemma3.feed_forward_length", n_ff)
    w.add_metadata("gemma3.attention.head_count", n_head)
    w.add_metadata("gemma3.attention.head_count_kv", n_head_kv)
    w.add_metadata("gemma3.attention.layer_norm_rms_epsilon", 1e-6)
    w.add_metadata("gemma3.rope.freq_base", rope_freq_base)
    if explicit_head_dim:
        w.add_metadata("gemma3.attention.key_length", head_dim)
        w.add_metadata("gemma3.attention.value_length", head_dim)
    w.add_metadata("tokenizer.ggml.tokens", vocab)
    w.add_metadata("tokenizer.ggml.bos_token_id", 2)
    w.add_metadata("tokenizer.ggml.eos_token_id", 1)
    w.add_metadata("tokenizer.ggml.unk_token_id", 3)

    q4, f16, f32 = GGMLType.Q4_0, GGMLType.F16, GGMLType.F32
    w.add_tensor("token_embd.weight", rand(len(vocab), n_embd), f16)
    w.add_tensor("output_norm.weight", rand(n_embd) + 1.0, f32)
    for i in range(n_layers):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", rand(n_embd) + 1.0, f32)
        w.add_tensor(p + "attn_q_norm.weight", rand(head_dim) + 1.0, f32)
        w.add_tensor(p + "attn_k_norm.weight", rand(head_dim) + 1.0, f32)
        w.add_tensor(p + "attn_q.weight", rand(n_head * head_dim, n_embd), q4)
        w.add_tensor(p + "attn_k.weight", rand(n_head_kv * head_dim, n_embd), q4)
        w.add_tensor(p + "attn_v.weight", rand(n_head_kv * head_dim, n_embd), q4)
        w.add_tensor(p + "attn_output.weight", rand(n_embd, n_head * head_dim), q4)
        w.add_tensor(p + "ffn_norm.weight", rand(n_embd) + 1.0, f32)
        w.add_tensor(p + "ffn_gate.weight", rand(n_ff, n_embd), q4)
        w.add_tensor(p + "ffn_up.weight", rand(n_ff, n_embd), q4)
        w.add_tensor(p + "ffn_down.weight", rand(n_embd, n_ff), q4)
        if with_post_norms:
            w.add_tensor(p + "post_attention_norm.weight", rand(n_embd) + 1.0, f32)
            w.add_tensor(p + "post_ffw_norm.weight", rand(n_embd) + 1.0, f32)
    return w.build()


def tame_vocab() -> list[str]:
    vocab = [f"t{i}" for i in range(VOCAB_SIZE)]
    vocab[1], vocab[2], vocab[3] = "<eos>", "<bos>", "<unk>"
    return vocab


def tame_checkpoint() -> Path:
    path = Path(tempfile.gettempdir()) / "llmi_torch_tame_gemma3_1b_q4_0.gguf"
    if not path.exists():
        t0 = time.perf_counter()
        buf = build_gemma3_gguf(vocab=tame_vocab(), seed=TAME_SEED, weight_std=TAME_STD, **GEOM_1B)
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(buf)
        tmp.rename(path)
        log(f"built the tame 1B checkpoint in {time.perf_counter() - t0:.1f} s")
    return path


# -- phases ---------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    name = torch.cuda.get_device_name(0)
    log(f"device {name}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    # the plain twins are f32 references: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi


def phase_build():
    from llm_inference_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"ptxas {name}: {line.strip()}")
    log(f"built {', '.join(logs)} in {time.perf_counter() - t0:.1f} s")


def phase_quant_matmul():
    import torch

    from llm_inference_tpu_torch.ops.kernels import qmatmul
    from llm_inference_tpu_torch.quant.device import QuantTensor

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    D, F, H, Hkv, dk = 1152, 6912, 4, 1, 256
    shapes = {"wqkv": ((H + 2 * Hkv) * dk, D), "wo": (D, H * dk),
              "w_gate_up": (2 * F, D), "w_down": (D, F)}
    worst, totals = 0.0, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for name, (R, C) in shapes.items():
        # enough weight copies to exceed the 50 MB L2, as prefill finds them cold
        n_copies = max(1, math.ceil(100e6 / (R * C)))
        qs = [torch.randint(-127, 128, (R, C), dtype=torch.int8, device=dev, generator=g)
              for _ in range(n_copies)]
        scale = (torch.rand((R, 1), device=dev, generator=g) * 1e-3 + 1e-4)
        qts = [QuantTensor(q=q, scale=scale, fmt=None, rows=R, cols=C) for q in qs]
        for T in (1, 32, 64):
            x = torch.randn((T, C), device=dev, generator=g)
            y = qmatmul.quant_matmul(qts[0], x)
            ref = qmatmul.quant_matmul_plain(qts[0], x)
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            log(f"quant_matmul {name} R={R} C={C} T={T}: max_abs_err {err:.3e} (tol {tol:.3e})")
            if not err <= tol:
                fail(f"quant_matmul {name} T={T}: kernel disagrees with plain ({err} > {tol})")
            worst = max(worst, err)
            if T != 32:
                continue
            ms = graph_ms(lambda i: qmatmul.quant_matmul(qts[i % n_copies], x), n_copies)
            plain = graph_ms(lambda i: qmatmul.quant_matmul_plain(qts[i % n_copies], x), 4)
            # bf16 weights: as many copies as exceed the L2 too
            n_lib = min(n_copies, max(2, math.ceil(100e6 / (2 * R * C))))
            wds = [qt.dequant(torch.bfloat16) for qt in qts[:n_lib]]
            xb = x.to(torch.bfloat16)
            lib = graph_ms(lambda i: torch.matmul(xb, wds[i % len(wds)].T), len(wds))
            del wds
            b = bound_ms(R * C + 4 * R + 4 * T * C + 4 * T * R, 2 * T * R * C)
            log(f"quant_matmul {name} T=32: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"torch.matmul bf16 {lib:.4f} ms, bound {b:.4f} ms")
            for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", b)):
                totals[k] += v
        del qs, qts
    torch.cuda.empty_cache()
    return worst, totals


def _first_layers(v, n):
    """The first ``n`` layers of a stacked field (a view)."""
    from llm_inference_tpu_torch.quant.device import QuantTensor

    if v is None:
        return None
    if isinstance(v, QuantTensor):
        return dataclasses.replace(v, q=v.q[:n], scale=v.scale[:n])
    return v[:n]


def _random_model(hp, seed: int):
    """Stacked per-row int8 weights at hp's widths, random from ``seed``."""
    import torch

    from llm_inference_tpu_torch.models.weights import LayerWeights, ModelWeights
    from llm_inference_tpu_torch.quant.device import QuantTensor

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    L, D, F = hp.block_count, hp.embedding_length, hp.feed_forward_length
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v

    def qt(rows, cols, lead=(L,), std=0.02):
        q = torch.randint(-127, 128, (*lead, rows, cols), dtype=torch.int8, device=dev, generator=g)
        s = torch.full((*lead, rows, 1), std / 73.3, device=dev) * (
            1 + 0.1 * torch.rand((*lead, rows, 1), device=dev, generator=g))
        return QuantTensor(q=q, scale=s, fmt=None, rows=rows, cols=cols)

    def norm(*shape):
        return 1.0 + 0.1 * torch.randn(shape, device=dev, generator=g)

    layers = LayerWeights(
        attn_norm=norm(L, D), ffn_norm=norm(L, D), q_norm=norm(L, dk), k_norm=norm(L, dk),
        post_attn_norm=norm(L, D), post_ffw_norm=norm(L, D),
        wqkv=qt(H * dk + Hkv * (dk + dv), D), wo=qt(D, H * dv),
        w_gate_up=qt(2 * F, D), w_down=qt(D, F))
    return ModelWeights(token_embd=qt(VOCAB_SIZE, D, lead=()), output_norm=norm(D), layers=layers)


def phase_decode_step():
    import torch

    from llm_inference_tpu_torch.models.gemma import init_cache
    from llm_inference_tpu_torch.models.hparams import load_hparams
    from llm_inference_tpu_torch.ops.kernels import fused_decode

    meta = {"general.architecture": "gemma3", "gemma3.block_count": 26,
            "gemma3.embedding_length": 1152, "gemma3.feed_forward_length": 6912,
            "gemma3.attention.head_count": 4, "gemma3.attention.head_count_kv": 1,
            "gemma3.attention.layer_norm_rms_epsilon": 1e-6, "gemma3.rope.freq_base": 1e6,
            "gemma3.attention.key_length": 256, "gemma3.attention.value_length": 256,
            "gemma3.attention.sliding_window": 128,
            "tokenizer.ggml.tokens": ["t"] * VOCAB_SIZE}
    hp = load_hparams(meta)
    dev = torch.device("cuda")
    w = _random_model(hp, seed=2)
    if not fused_decode.decode_supported(hp, w):
        fail("decode_step: the 1B-shaped random model is not eligible")
    S, pos = 1024, 300
    g = torch.Generator(device=dev).manual_seed(3)
    cache = init_cache(hp, S, device=dev)
    cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
    token = torch.tensor([12345], dtype=torch.int64, device=dev)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    worst = 0.0
    for swa in (False, True):
        consts = fused_decode.prepare(hp, dev, swa_mask=swa, max_seq=S)
        ck = type(cache)(k=cache.k.clone(), v=cache.v.clone())
        cp = type(cache)(k=cache.k.clone(), v=cache.v.clone())
        y = fused_decode.decode_step(hp, w, ck, token, p, consts)
        ref = fused_decode.decode_step_plain(hp, w, cp, token, p, consts)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        tol = 1.5e-2 * max(1.0, ref.abs().max().item())
        # layer 0's K/V row rounds the same f32 values (summed in another
        # order) to bf16: within one bf16 step (2^-7 relative); deeper rows
        # inherit the residual stream's noise and take the logits' bar
        kv0 = max(((ck.k[0, pos].float() - cp.k[0, pos].float()).abs()
                   / (cp.k[0, pos].float().abs() + 1e-3)).max().item(),
                  ((ck.v[0, pos].float() - cp.v[0, pos].float()).abs()
                   / (cp.v[0, pos].float().abs() + 1e-3)).max().item())
        kv_all = max((ck.k[:, pos].float() - cp.k[:, pos].float()).abs().max().item(),
                     (ck.v[:, pos].float() - cp.v[:, pos].float()).abs().max().item())
        kv_tol = 1.5e-2 * max(1.0, cp.k[:, pos].float().abs().max().item(),
                              cp.v[:, pos].float().abs().max().item())
        untouched = bool(torch.equal(ck.k[:, :pos], cache.k[:, :pos])
                         and torch.equal(ck.k[:, pos + 1:], cache.k[:, pos + 1:]))
        log(f"decode_step swa={swa} windows={consts.windows.tolist()[:6]}...: logits "
            f"max_abs_err {err:.3e} (tol {tol:.3e}), argmax {int(y.argmax())} vs "
            f"{int(ref.argmax())}, layer-0 K/V row max_rel_err {kv0:.3e} (tol {2 ** -7:.3e}), "
            f"all K/V rows max_abs_err {kv_all:.3e} (tol {kv_tol:.3e})")
        if not err <= tol or int(y.argmax()) != int(ref.argmax()):
            fail(f"decode_step swa={swa}: kernel logits disagree with plain")
        if not kv0 <= 2 ** -7 or not kv_all <= kv_tol or not untouched:
            fail(f"decode_step swa={swa}: K/V cache write disagrees with plain")
        worst = max(worst, err)
        del ck, cp
    consts = fused_decode.prepare(hp, dev, swa_mask=False, max_seq=S)
    ms = time_ms(lambda i=0: fused_decode.decode_step(hp, w, cache, token, p, consts), 50)
    plain = time_ms(lambda i=0: fused_decode.decode_step_plain(hp, w, cache, token, p, consts), 3,
                    warmup=1)
    # depth sweep: the same weights cut to one layer give the fixed cost
    # (embedding + final norm + logits) and, by difference, the per-layer cost
    w1 = dataclasses.replace(w, layers=dataclasses.replace(
        w.layers, **{f.name: _first_layers(getattr(w.layers, f.name), 1)
                     for f in dataclasses.fields(w.layers)}))
    hp1 = dataclasses.replace(hp, block_count=1)
    c1 = fused_decode.prepare(hp1, dev, swa_mask=False, max_seq=S)
    cache1 = type(cache)(k=cache.k[:1].clone(), v=cache.v[:1].clone())
    ms1 = time_ms(lambda i=0: fused_decode.decode_step(hp1, w1, cache1, token, p, c1), 50)
    per_layer = (ms - ms1) / (hp.block_count - 1)
    log(f"decode_step depth sweep: 1 layer {ms1:.4f} ms, 26 layers {ms:.4f} ms -> "
        f"{per_layer * 1e3:.2f} us per layer, {(ms1 - per_layer) * 1e3:.2f} us fixed "
        f"(embedding, final norm, {VOCAB_SIZE}-row logits)")
    # where the step's time goes: block 0's globaltimer at each phase
    # boundary, averaged over launches and layers
    L = hp.block_count
    marks = fused_decode.PROFILE_MARKS
    prof = torch.zeros(L * marks + 3, dtype=torch.int64, device=dev)
    names = ["norm+QKV", "barrier", "qk-norm+rope+scores", "max barrier", "softmax+PV",
             "barrier", "combine+Wo", "barrier", "norm+gate/up", "barrier", "down", "barrier"]
    acc = np.zeros(len(names))
    edge = np.zeros(3)
    n_prof = 20
    for _ in range(n_prof):
        fused_decode.decode_step(hp, w, cache, token, p, consts, profile=prof)
        t = prof.cpu().numpy().astype(np.float64)
        per = t[1 : 1 + L * marks].reshape(L, marks)
        acc += np.diff(per, axis=1).mean(axis=0)
        edge += [t[1] - t[0], t[1 + L * marks] - per[-1, -1], t[2 + L * marks] - t[1 + L * marks]]
    acc, edge = acc / n_prof / 1e3, edge / n_prof / 1e3
    log("decode_step phases (us, block 0, mean per layer): "
        + ", ".join(f"{n} {v:.2f}" for n, v in zip(names, acc))
        + f"; per layer {acc.sum():.2f}; start {edge[0]:.2f}, final norm {edge[1]:.2f}, "
        f"logits {edge[2]:.2f}")
    L, D, F, V = hp.block_count, 1152, 6912, VOCAB_SIZE
    Rq, A, kvrow = 1536, 1024, 2 * 256 * 2
    wbytes = L * (Rq * D + D * A + 2 * F * D + D * F) + V * D
    sbytes = 4 * (L * (Rq + D + 2 * F + D) + V)
    nbytes = wbytes + sbytes + 4 * (L * (4 * D + 2 * 256) + D) + L * (pos + 1) * kvrow + 4 * V
    ops = 2 * wbytes + 2 * L * 4 * (pos + 1) * 512
    b = bound_ms(nbytes, ops)
    log(f"decode_step 1B pos={pos}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms "
        f"({nbytes / 1e9:.4f} GB)")
    del w, cache
    torch.cuda.empty_cache()
    return worst, {"ms": ms, "plain_ms": plain, "library_ms": None, "bound_ms": b}


def phase_slice():
    import torch

    from llm_inference_tpu_torch.engine import Engine, GenerationStats
    from llm_inference_tpu_torch.ops.kernels import fused_decode, qmatmul

    golden_path = ROOT / "tests" / "golden" / "parity_1b_tame.json"
    if not golden_path.exists():
        fail(f"missing {golden_path}")
    golden = json.loads(golden_path.read_text())
    ck = golden["checkpoint"]
    if (ck["seed"], ck["weight_std"], ck["geometry"], ck["vocab_size"]) != (
            TAME_SEED, TAME_STD, GEOM_1B, VOCAB_SIZE):
        fail("the golden stream was recorded on another checkpoint")
    path = tame_checkpoint()
    t0 = time.perf_counter()
    eng = Engine(str(path), mode="serve-q8", max_seq=1024, decode_chunk=16, device="cuda")
    torch.cuda.synchronize()
    log(f"Engine load {time.perf_counter() - t0:.1f} s")
    eng.tokenizer.eos_id = -1  # random weights may argmax onto <eos>: never stop early
    eng.tokenizer.end_of_turn_id = -1
    prompt, steps = golden["prompt"], golden["steps"]
    eng.generate_from_ids(prompt, n_predict=8)  # warm-up

    qmatmul.launches = 0
    fused_decode.launches = 0
    stats = GenerationStats()
    out = eng.generate_from_ids(prompt, n_predict=steps, stats=stats)
    torch.cuda.synchronize()
    counts = {"quant_matmul": qmatmul.launches, "decode_step": fused_decode.launches}

    n_match = next((i for i, (a, b) in enumerate(zip(out, golden["tokens"])) if a != b),
                   min(len(out), len(golden["tokens"])))
    log(f"slice: {n_match}/{steps} tokens match the golden stream; launches {counts}; "
        f"decode steps {stats.decode_steps}")
    if out != golden["tokens"][:steps] or len(out) != steps:
        fail(f"greedy stream diverges from the golden stream at token {n_match}: "
             f"{out[:12]}... vs {golden['tokens'][:12]}...")
    n_layers = GEOM_1B["n_layers"]
    if counts["quant_matmul"] != 4 * n_layers:
        fail(f"prefill launched quant_matmul {counts['quant_matmul']} times, not {4 * n_layers}")
    if counts["decode_step"] != stats.decode_steps or stats.decode_steps == 0:
        fail(f"decode launched decode_step {counts['decode_step']} times for "
             f"{stats.decode_steps} steps")
    # TTFT runs host-side torch ops between the kernels and varies from one
    # prefill to the next on a shared host: the median of seven
    ttfts = [stats.prefill_seconds]
    for _ in range(6):
        s1 = GenerationStats()
        eng.generate_from_ids(prompt, n_predict=1, stats=s1)
        ttfts.append(s1.prefill_seconds)
    log(f"slice: TTFT of seven prefills (ms): {', '.join(f'{t * 1e3:.2f}' for t in ttfts)}")
    perf = {"decode_tok_s": stats.decode_tok_per_s, "ttft_ms": float(np.median(ttfts)) * 1e3,
            "decode_steps": stats.decode_steps, "prompt_tokens": stats.prompt_tokens}
    return counts, perf


def main() -> int:
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    try:
        import llm_inference_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port package is not beside chip_smoke.py ({e})")
    t_all = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    qm_err, qm = phase_quant_matmul()
    dec_err, dec = phase_decode_step()
    counts, perf = phase_slice()
    log(f"slice: decode {perf['decode_tok_s']:.2f} tok/s, TTFT (median) {perf['ttft_ms']:.2f} ms "
        f"({perf['prompt_tokens']}-token prompt) on {smi}; total {time.perf_counter() - t_all:.1f} s")
    kernels = [
        dict(name="quant_matmul", route="cuda", source="llm_inference_tpu_torch/csrc/qmatmul.cu",
             replaces="llm_inference_tpu/ops/pallas/qmatmul.py:129",
             launches=counts["quant_matmul"], max_abs_err=qm_err, ms=qm["ms"],
             plain_ms=qm["plain_ms"], bound_ms=qm["bound_ms"], bound_by="bytes",
             library_ms=qm["library_ms"], note="sum over the four 1B layer shapes at T=32"),
        dict(name="decode_step", route="cuda", source="llm_inference_tpu_torch/csrc/fused_decode.cu",
             replaces="llm_inference_tpu/ops/pallas/fused_decode.py:674",
             launches=counts["decode_step"], max_abs_err=dec_err, ms=dec["ms"],
             plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"], bound_by="bytes",
             library_ms=None),
    ]
    print(f"slice serve-q8 decode_tok_s={perf['decode_tok_s']:.3f} ttft_ms={perf['ttft_ms']:.3f} "
          f"on {smi}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
