#!/usr/bin/env python3
"""Time the port's single-stream whole-step kernels of two checkouts in
turns on one NVIDIA GPU, so that two versions are compared on one card in
one run:

    python tools/torch_step_ab.py DIR_A DIR_B
    python tools/torch_step_ab.py --batched DIR_A DIR_B
    python tools/torch_step_ab.py --paged DIR_A DIR_B
    python tools/torch_step_ab.py --stream DIR_A DIR_B
    python tools/torch_step_ab.py --qmatmul DIR_A DIR_B
    python tools/torch_step_ab.py --flash DIR_A DIR_B
    python tools/torch_step_ab.py --lossless DIR_A DIR_B
    python tools/torch_step_ab.py --rowq8 DIR_A [DIR_B]
    python tools/torch_step_ab.py --insert DIR_A [DIR_B]

Each of DIR_A, DIR_B, DIR_B, DIR_A (a checkout of the repo each, e.g. the
parent unpacked with ``git archive`` into an ignored directory) runs in its
own process, from its own chip_smoke.py: the per-row int8 step's phase 4
(its kernel-vs-plain check at the Gemma-3-1B shapes, the time a step at
position 300, the depth sweep and the per-phase profile), then, where the
checkout has the lossless step, that step's time on chip_smoke's random
serve-q int8 and serve-q4 nibble weights (the same seeds in every
checkout). With ``--batched`` each process times the dense batched whole
step instead (csrc/fused_decode_batch.cu): B = 32 lanes of 1024 slots
ragged over positions 0..1000 and four parked (chip_smoke's phase 6
lanes), chip_smoke's random 1B int8 weights, the device time of a greedy
step through a CUDA graph, three times. With ``--qmatmul`` each process
times the per-op quantized matmuls (csrc/qmatmul.cu) at the four
Gemma-3-1B layer shapes, summed, at T = 1 and T = 32, on cold weights
(copies past the 50 MB L2) through CUDA graphs: the grouped kernels over
every variant of chip_smoke's GROUPED_VARIANTS and the rowwise kernel,
then the rowq8 and lossless whole steps (1B, position 300) that share no
code with them, as a control. With ``--flash`` each process times
flash_decode at chip_smoke's phase 6 lanes (q [32, 4, 256], one KV head,
1024 slots, lanes ragged over 0..1000, four parked) and paged_flash_decode
at its phase 11 lanes (the same through a shuffled pool of 256-slot pages,
nb_cap 4), cold (each call over the next of 26 layers' caches, as the
per-op route finds them) and warm (layer 0's caches every call, as the
repo timed them before), through CUDA graphs; and, in each checkout,
scaled_dot_product_attention timed both ways over the dense caches (bf16
q, the lengths as a mask, no softcap). With ``--paged`` each process times
the paged batched whole step at chip_smoke's phase 11 lanes (the phase 6
lanes through a shuffled pool of 256-slot pages) beside the dense step on
the same lanes, three times. With ``--stream`` each process checks and times
the capacity step (csrc/fused_decode_stream.cu) at chip_smoke's phase 13
inputs (Gemma-3-12B width and depth, position 300, random serve-q int8 and
serve-q4 nibbles with Q4_K offsets, a Q6_K-like int8 down projection),
three times each, with its per-phase profile and gate/up's bytes per
second. With ``--lossless`` each process times, three times each, the
whole-layer lossless step (row 4 of PERF.md) on chip_smoke's random serve-q
int8 and serve-q4 nibble weights (Q4_K offsets, a Q6_K-like down) at the
1B shapes, position 300, with its per-phase profile, and the
tensor-parallel lossless step (row 12) with two ranks on one card on the
same weights; then, as controls of the shared code, the rowq8 step and its
tensor-parallel counterpart (rows 3 and 11) at the same shapes and the
capacity step (row 10) at phase 13's 12B inputs, in both formats. With
``--rowq8`` each process times, three times each, the rowq8 whole step
(row 3) at the 1B shapes, position 300, with its per-phase profile, its
tensor-parallel counterpart (row 11) with two and four ranks on one card
on the same weights (with rank 0's profile where the checkout has one),
and the gemma4 instance of row 3 at phase 15's inputs (GEOM_G4, position
300) with its profile; then, as controls of the shared body, the lossless
whole step (row 4, serve-q int8 with its profile, and serve-q4), its
tensor-parallel counterpart (row 12, two ranks) and the capacity step
(row 10, 12B) in both formats. With ``--insert`` each process times one
layer's K/V append of the per-op batched routes (row 7) at chip_smoke's
phase 6 lanes, three times, through a CUDA graph cold over the layers'
pools: f32 ``k`` contiguous (as RoPE leaves it) and ``v`` a column slice of
a [B, (H + 2 Hkv) d] projection, at the 1B geometry [1, 256] over 26
layers and gemma4's [2, 256] over its 20 owner layers; a checkout with
``kv_insert.insert_kv_rows`` runs that one launch, one without it two casts
and two ``insert_rows``; beside it the one-pool ``insert_rows`` of bf16
rows, the same call in every checkout. Then the per-op batched step on the tame 1B
checkpoint's serve-q8 weights (BatchedServer's per-op route), dense over a
[26, 32, 1024] cache and paged over phase 11's shuffled pool (nb_cap 4), at
the same lanes: its wall time a step (host synced), the sum of its device
kernels' times a step (torch.profiler) and their count a step. Given one
checkout, any mode runs it once.
``--batched``, ``--paged`` and ``--stream`` also time, as controls
of the shared skeleton (csrc/decode_step.cuh), the rowq8 and lossless
whole steps and the rowq8 and lossless tensor-parallel steps (two ranks on
one card) at the 1B shapes, position 300. The lines are prefixed with the
checkout; the last is the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys

CONTROLS = r"""
from llm_inference_tpu_torch.models.gemma import init_cache
from llm_inference_tpu_torch.ops.kernels import (_build, fused_decode, fused_decode_q,
                                                 fused_decode_q_tp, fused_decode_tp)

_build.build_all(("fused_decode", "fused_decode_q", "fused_decode_tp", "fused_decode_q_tp"))
hp = c._hp_1b()
dev = torch.device("cuda")
S, pos = 1024, 300
g = torch.Generator(device=dev).manual_seed(6)
cache = init_cache(hp, S, device=dev)
cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
token = torch.tensor([12345], dtype=torch.int64, device=dev)
p = torch.tensor([pos], dtype=torch.int32, device=dev)
for label, nibble in (("rowq8", None), ("serve-q int8", False), ("serve-q4 nibble+offsets", True)):
    lossless = nibble is not None
    w = c._random_lossless_model(hp, seed=7, nibble=nibble) if lossless else c._random_model(hp, seed=2)
    single = fused_decode_q if lossless else fused_decode
    one = single.decode_step_q if lossless else single.decode_step
    consts = single.prepare(hp, dev, swa_mask=False, max_seq=S)
    ms = c.time_ms(lambda i=0: one(hp, w, cache, token, p, consts), 50)
    c.log(f"AB control single-chip step {label} 1B pos={pos}: {ms:.4f} ms")
    if label == "serve-q4 nibble+offsets":
        continue
    mod = fused_decode_q_tp if lossless else fused_decode_tp
    tw = mod.shard_for_tp(hp, w, 2, c._tp_mesh(2).model_devices)
    tc = mod.prepare(hp, tw, swa_mask=False, max_seq=S)
    caches = [type(cache)(k=cache.k.clone(), v=cache.v.clone()) for _ in range(2)]
    step = mod.decode_step_q_tp if lossless else mod.decode_step_tp
    ms = c.time_ms(lambda i=0: step(hp, tw, caches, token, p, tc), 50)
    c.log(f"AB control TP step {label} n=2 1B pos={pos}: {ms:.4f} ms")
    del w, tw, caches
    torch.cuda.empty_cache()
"""

PROBE = r"""
import torch
import chip_smoke as c

c.phase_device()
c.phase_build()
c.phase_decode_step()
if hasattr(c, "_random_lossless_model"):
    from llm_inference_tpu_torch.models.gemma import init_cache
    from llm_inference_tpu_torch.ops.kernels import fused_decode_q

    hp = c._hp_1b()
    dev = torch.device("cuda")
    S, pos = 1024, 300
    cache = init_cache(hp, S, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
    token = torch.tensor([12345], dtype=torch.int64, device=dev)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    for label, nibble in (("serve-q int8", False), ("serve-q4 nibble+offsets", True)):
        w = c._random_lossless_model(hp, seed=7, nibble=nibble)
        consts = fused_decode_q.prepare(hp, dev, swa_mask=False, max_seq=S)
        ms = c.time_ms(lambda i=0: fused_decode_q.decode_step_q(hp, w, cache, token, p, consts), 50)
        c.log(f"decode_step_q random {label} 1B pos={pos}: kernel {ms:.4f} ms")
        del w
"""

PROBE_BATCHED = r"""
import torch
import chip_smoke as c
from llm_inference_tpu_torch.models.gemma import init_batched_cache
from llm_inference_tpu_torch.ops.kernels import fused_decode_batch

c.phase_device()
c.phase_build()
hp = c._hp_1b()
dev = torch.device("cuda")
B, S = c.BATCH, c.BATCH_SEQ
w = c._random_model(hp, seed=2)
g = torch.Generator(device=dev).manual_seed(4)
cache = init_batched_cache(hp, B, S, device=dev)
cache.k.copy_(torch.randn(cache.k.shape, device=dev, generator=g))
cache.v.copy_(torch.randn(cache.v.shape, device=dev, generator=g))
pos = torch.tensor(c._batch_positions(S), dtype=torch.int32, device=dev)
tokens = torch.randint(0, c.VOCAB_SIZE, (B,), device=dev, generator=g, dtype=torch.int32)
consts = fused_decode_batch.prepare_batch(hp, dev, batch=B, max_seq=S)
for _ in range(3):
    ms = c.graph_ms(lambda i=0: fused_decode_batch.decode_step_batch(
        hp, w, cache, tokens, pos, consts, greedy=True), 4, replays=10)
    c.log(f"decode_step_batch random 1B B={B} ragged: device {ms:.4f} ms")
del w
torch.cuda.empty_cache()
""" + CONTROLS

PROBE_QMATMUL = r"""
import math
import torch
import chip_smoke as c
from llm_inference_tpu_torch.models.gemma import init_cache
from llm_inference_tpu_torch.ops.kernels import _build, fused_decode, fused_decode_q, qmatmul
from llm_inference_tpu_torch.quant.device import QuantTensor

c.phase_device()
_build.build_all(("qmatmul", "fused_decode", "fused_decode_q"))
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(5)
D, F = 1152, 6912
shapes = ((1536, D), (D, 1024), (2 * F, D), (D, F))


def total(make, nbytes, fn, T):
    ms = 0.0
    for R, C in shapes:
        ws = [make(R, C) for _ in range(max(1, math.ceil(100e6 / nbytes(R, C))))]
        x = torch.randn((T, C), device=dev, generator=g)
        ms += c.graph_ms(lambda i: fn(ws[i % len(ws)], x), len(ws))
        del ws
    return ms


for name, nib, gs, (lo, hi), off in c.GROUPED_VARIANTS:
    fn = qmatmul.q4_matmul if nib else qmatmul.quant_matmul
    for T in (1, 32):
        ms = total(lambda R, C: c._grouped_weight(R, C, nib, gs, lo, hi, off, g),
                   lambda R, C: R * C // (2 if nib else 1) + 4 * R * (C // gs) * (2 if off else 1),
                   fn, T)
        c.log(f"AB grouped {name} T={T}: {ms:.4f} ms (4 1B shapes)")
for T in (1, 32):
    ms = total(lambda R, C: QuantTensor(
        q=torch.randint(-127, 128, (R, C), dtype=torch.int8, device=dev, generator=g),
        scale=torch.rand((R, 1), device=dev, generator=g) * 1e-3 + 1e-4, fmt=None, rows=R, cols=C),
        lambda R, C: R * C, qmatmul.quant_matmul, T)
    c.log(f"AB rowwise T={T}: {ms:.4f} ms (4 1B shapes)")
hp = c._hp_1b()
S, pos = 1024, 300
cache = init_cache(hp, S, device=dev)
cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
token = torch.tensor([12345], dtype=torch.int64, device=dev)
p = torch.tensor([pos], dtype=torch.int32, device=dev)
w = c._random_model(hp, seed=2)
consts = fused_decode.prepare(hp, dev, swa_mask=False, max_seq=S)
ms = c.time_ms(lambda i=0: fused_decode.decode_step(hp, w, cache, token, p, consts), 50)
c.log(f"AB decode_step rowq8 1B pos={pos}: {ms:.4f} ms")
del w
for label, nibble in (("serve-q int8", False), ("serve-q4 nibble+offsets", True)):
    w = c._random_lossless_model(hp, seed=7, nibble=nibble)
    consts = fused_decode_q.prepare(hp, dev, swa_mask=False, max_seq=S)
    ms = c.time_ms(lambda i=0: fused_decode_q.decode_step_q(hp, w, cache, token, p, consts), 50)
    c.log(f"AB decode_step_q random {label} 1B pos={pos}: {ms:.4f} ms")
    del w
"""

PROBE_FLASH = r"""
import torch
import chip_smoke as c
from llm_inference_tpu_torch.ops.kernels import _build, flash_decode

c.phase_device()
_build.build_all(("flash_decode",))
dev = torch.device("cuda")
B, S, L, H, d = c.BATCH, c.BATCH_SEQ, 26, 4, 256
g = torch.Generator(device=dev).manual_seed(9)
positions = c._batch_positions(S)
pos = torch.tensor(positions, dtype=torch.int32, device=dev)
lengths = torch.where(pos >= S, torch.zeros_like(pos), pos + 1).to(torch.int32)
q = torch.randn((B, H, d), device=dev, generator=g) * 0.06
kc = torch.randn((L, B, S, 1, d), device=dev, generator=g).to(torch.bfloat16)
vc = torch.randn((L, B, S, 1, d), device=dev, generator=g).to(torch.bfloat16)
table, p1 = c._paged_layout(positions, S, g)
kp = torch.randn((L, p1, c.PAGE, 1, d), device=dev, generator=g).to(torch.bfloat16)
vp = torch.randn((L, p1, c.PAGE, 1, d), device=dev, generator=g).to(torch.bfloat16)
qb = q.to(torch.bfloat16)[:, :, None, :]
mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
kt, vt = kc.permute(0, 1, 3, 2, 4), vc.permute(0, 1, 3, 2, 4)  # [L, B, 1, S, d] views
for _ in range(3):
    ms = {}
    for how, n in (("cold", L), ("warm", 1)):  # warm: layer 0's caches every call
        ms[how] = (
            c.graph_ms(lambda i: flash_decode.flash_decode(q, kc[i % n], vc[i % n], lengths), L),
            c.graph_ms(lambda i: flash_decode.paged_flash_decode(
                q, kp[i % n], vp[i % n], table, lengths, nb_cap=4), L),
            c.graph_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
                qb, kt[i % n], vt[i % n], attn_mask=mask, scale=1.0, enable_gqa=True), L))
    c.log("AB flash " + "; ".join(
        f"{how}: flash_decode {d:.4f} ms, paged_flash_decode {pg:.4f} ms, sdpa {sd:.4f} ms"
        for how, (d, pg, sd) in ms.items()) + f" ({L} layers)")
"""

PROBE_STREAM = r"""
import torch
import chip_smoke as c
from llm_inference_tpu_torch.models.gemma import init_cache
from llm_inference_tpu_torch.ops.kernels import _build, fused_decode, fused_decode_stream as fds

c.phase_device()
_build.build_all(("fused_decode_stream",))
hp = c.hp_gemma3(**c.GEOM_12B, sliding_window=1024)
dev = torch.device("cuda")
S, pos = c.STREAM_SEQ, c.STREAM_POS
g = torch.Generator(device=dev).manual_seed(13)
cache = init_cache(hp, S, device=dev, flat=True)
cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
token = torch.tensor([200001], dtype=torch.int64, device=dev)
p = torch.tensor([pos], dtype=torch.int32, device=dev)
L, F, D = hp.block_count, hp.feed_forward_length, hp.embedding_length
for label, nibble in (("serve-q int8", False), ("serve-q4 nibble+offsets", True)):
    w = c._random_lossless_model(hp, seed=17, nibble=nibble)
    consts = fds.prepare(hp, dev, swa_mask=False, max_seq=S)
    c._check_step_q(f"12B {label}", hp, w, cache, token, p, consts,
                    step=fds.decode_step_stream, plain=fds.decode_step_stream_plain)
    for _ in range(3):
        ms = c.time_ms(lambda i=0: fds.decode_step_stream(hp, w, cache, token, p, consts), 20)
        c.log(f"AB decode_step_stream 12B {label} pos={pos}: {ms:.4f} ms")
    prof = c._step_profile(f"AB decode_step_stream 12B {label}", lambda pr: fds.decode_step_stream(
        hp, w, cache, token, p, consts, profile=pr), hp,
        L * fused_decode.PROFILE_MARKS + 3, n=5)
    gu = w.layers.w_gate_up
    gu_bytes = gu.packed[0].numel() if hasattr(gu, "packed") else gu.q[0].numel()
    gu_bytes += gu.scale[0].numel() * 4 * (2 if gu.offset is not None else 1)
    c.log(f"AB decode_step_stream 12B {label} gate/up: {gu_bytes / 1e6:.2f} MB a layer in "
          f"{prof['norm+gate/up']:.2f} us (norm included): "
          f"{gu_bytes / prof['norm+gate/up'] / 1e6:.3f} TB/s")
    del w, consts
    torch.cuda.empty_cache()
del cache
torch.cuda.empty_cache()
""" + CONTROLS

PROBE_PAGED = r"""
import torch
import chip_smoke as c
from llm_inference_tpu_torch.models.gemma import init_batched_cache
from llm_inference_tpu_torch.ops.kernels import _build, fused_decode_batch, fused_decode_batch_paged

c.phase_device()
_build.build_all(("fused_decode_batch",))
hp = c._hp_1b()
dev = torch.device("cuda")
B, S, L = c.BATCH, c.BATCH_SEQ, hp.block_count
w = c._random_model(hp, seed=2)
g = torch.Generator(device=dev).manual_seed(4)
positions = c._batch_positions(S)
pos = torch.tensor(positions, dtype=torch.int32, device=dev)
tokens = torch.randint(0, c.VOCAB_SIZE, (B,), device=dev, generator=g, dtype=torch.int32)
cache = init_batched_cache(hp, B, S, device=dev)
cache.k.copy_(torch.randn(cache.k.shape, device=dev, generator=g))
cache.v.copy_(torch.randn(cache.v.shape, device=dev, generator=g))
table, p1 = c._paged_layout(positions, S, g)
kd, vd = hp.n_embd_head_k, hp.n_embd_head_v
kpool = torch.randn((L, p1, c.PAGE, hp.n_head_kv, kd), device=dev, generator=g).to(torch.bfloat16)
vpool = torch.randn((L, p1, c.PAGE, hp.n_head_kv, vd), device=dev, generator=g).to(torch.bfloat16)
consts = fused_decode_batch.prepare_batch(hp, dev, batch=B, max_seq=S)
for _ in range(3):
    dense = c.graph_ms(lambda i=0: fused_decode_batch.decode_step_batch(
        hp, w, cache, tokens, pos, consts, greedy=True), 4, replays=10)
    paged = c.graph_ms(lambda i=0: fused_decode_batch_paged.decode_step_batch_paged(
        hp, w, kpool, vpool, table, tokens, pos, consts, greedy=True), 4, replays=10)
    c.log(f"AB batched 1B B={B} ragged: dense {dense:.4f} ms, paged {paged:.4f} ms")
del w
torch.cuda.empty_cache()
""" + CONTROLS

PROBE_LOSSLESS = r"""
import torch
import chip_smoke as c
from llm_inference_tpu_torch.models.gemma import init_cache
from llm_inference_tpu_torch.ops.kernels import (_build, fused_decode, fused_decode_q,
                                                 fused_decode_q_tp, fused_decode_stream as fds,
                                                 fused_decode_tp)

c.phase_device()
_build.build_all(("fused_decode", "fused_decode_q", "fused_decode_tp", "fused_decode_q_tp",
                  "fused_decode_stream"))
hp = c._hp_1b()
dev = torch.device("cuda")
S, pos = 1024, 300
g = torch.Generator(device=dev).manual_seed(6)
cache = init_cache(hp, S, device=dev)
cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
token = torch.tensor([12345], dtype=torch.int64, device=dev)
p = torch.tensor([pos], dtype=torch.int32, device=dev)
for label, nibble in (("serve-q int8", False), ("serve-q4 nibble+offsets", True), ("rowq8", None)):
    lossless = nibble is not None
    w = c._random_lossless_model(hp, seed=7, nibble=nibble) if lossless else c._random_model(hp, seed=2)
    single = fused_decode_q if lossless else fused_decode
    one = single.decode_step_q if lossless else single.decode_step
    consts = single.prepare(hp, dev, swa_mask=False, max_seq=S)
    for _ in range(3):
        ms = c.time_ms(lambda i=0: one(hp, w, cache, token, p, consts), 50)
        c.log(f"AB single-chip step {label} 1B pos={pos}: {ms:.4f} ms")
    if lossless:
        c._step_profile(f"AB single-chip step {label}", lambda pr: one(
            hp, w, cache, token, p, consts, profile=pr), hp,
            hp.block_count * fused_decode.PROFILE_MARKS + 3)
    mod = fused_decode_q_tp if lossless else fused_decode_tp
    tw = mod.shard_for_tp(hp, w, 2, c._tp_mesh(2).model_devices)
    tc = mod.prepare(hp, tw, swa_mask=False, max_seq=S)
    caches = [type(cache)(k=cache.k.clone(), v=cache.v.clone()) for _ in range(2)]
    step = mod.decode_step_q_tp if lossless else mod.decode_step_tp
    for _ in range(3):
        ms = c.time_ms(lambda i=0: step(hp, tw, caches, token, p, tc), 50)
        c.log(f"AB TP step {label} n=2 1B pos={pos}: {ms:.4f} ms")
    del w, tw, caches, consts, tc
    torch.cuda.empty_cache()
del cache
torch.cuda.empty_cache()
hp = c.hp_gemma3(**c.GEOM_12B, sliding_window=1024)
S, pos = c.STREAM_SEQ, c.STREAM_POS
cache = init_cache(hp, S, device=dev, flat=True)
cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
token = torch.tensor([200001], dtype=torch.int64, device=dev)
p = torch.tensor([pos], dtype=torch.int32, device=dev)
for label, nibble in (("serve-q int8", False), ("serve-q4 nibble+offsets", True)):
    w = c._random_lossless_model(hp, seed=17, nibble=nibble)
    consts = fds.prepare(hp, dev, swa_mask=False, max_seq=S)
    for _ in range(3):
        ms = c.time_ms(lambda i=0: fds.decode_step_stream(hp, w, cache, token, p, consts), 20)
        c.log(f"AB capacity step 12B {label} pos={pos}: {ms:.4f} ms")
    del w, consts
    torch.cuda.empty_cache()
"""

PROBE_ROWQ8 = r"""
import inspect

import torch
import chip_smoke as c
from llm_inference_tpu_torch.models.gemma import init_cache
from llm_inference_tpu_torch.ops.kernels import (_build, fused_decode, fused_decode_q,
                                                 fused_decode_q_tp, fused_decode_stream as fds,
                                                 fused_decode_tp)

c.phase_device()
_build.build_all(("fused_decode", "fused_decode_q", "fused_decode_tp", "fused_decode_q_tp",
                  "fused_decode_stream"))
dev = torch.device("cuda")


def filled(hp, S, pos, seed, kscale=1.0, flat=False):
    cache = init_cache(hp, S, device=dev, flat=flat)
    g = torch.Generator(device=dev).manual_seed(seed)
    cache.k[:, :pos] = (kscale * torch.randn(cache.k[:, :pos].shape, device=dev, generator=g)
                        ).to(torch.bfloat16)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=dev, generator=g).to(
        torch.bfloat16)
    return cache


def timed(what, fn, iters=50):
    for _ in range(3):
        c.log(f"AB {what}: {c.time_ms(lambda i=0: fn(), iters):.4f} ms")


def tp_rows(label, mod, step, hp, w, cache, token, p, ns):
    for n in ns:
        tw = mod.shard_for_tp(hp, w, n, c._tp_mesh(n).model_devices)
        tc = mod.prepare(hp, tw, swa_mask=False, max_seq=cache.k.shape[1])
        caches = [type(cache)(k=cache.k.clone(), v=cache.v.clone()) for _ in range(n)]
        timed(f"{label} n={n} 1B pos={int(p.item())}",
              lambda: step(hp, tw, caches, token, p, tc))
        if "profile" in inspect.signature(step).parameters:  # rank 0's block 0
            c._step_profile(f"AB {label} n={n} 1B", lambda pr: step(
                hp, tw, caches, token, p, tc, profile=pr), hp,
                hp.block_count * fused_decode.PROFILE_MARKS + 3)
        del tw, tc, caches
        torch.cuda.empty_cache()


hp = c._hp_1b()
S, pos = 1024, 300
L = hp.block_count
cache = filled(hp, S, pos, 6)
token = torch.tensor([12345], dtype=torch.int64, device=dev)
p = torch.tensor([pos], dtype=torch.int32, device=dev)
w = c._random_model(hp, seed=2)
consts = fused_decode.prepare(hp, dev, swa_mask=False, max_seq=S)
timed(f"row 3 rowq8 1B pos={pos}", lambda: fused_decode.decode_step(hp, w, cache, token, p, consts))
c._step_profile("AB row 3 rowq8 1B", lambda pr: fused_decode.decode_step(
    hp, w, cache, token, p, consts, profile=pr), hp, L * fused_decode.PROFILE_MARKS + 3)
tp_rows("row 11 TP rowq8", fused_decode_tp, fused_decode_tp.decode_step_tp, hp, w, cache, token,
        p, (2, 4))
del w, consts
torch.cuda.empty_cache()
for label, nibble in (("serve-q int8", False), ("serve-q4 nibble+offsets", True)):
    w = c._random_lossless_model(hp, seed=7, nibble=nibble)
    consts = fused_decode_q.prepare(hp, dev, swa_mask=False, max_seq=S)
    timed(f"control row 4 {label} 1B pos={pos}",
          lambda: fused_decode_q.decode_step_q(hp, w, cache, token, p, consts))
    if not nibble:
        c._step_profile(f"AB control row 4 {label} 1B", lambda pr: fused_decode_q.decode_step_q(
            hp, w, cache, token, p, consts, profile=pr), hp, L * fused_decode.PROFILE_MARKS + 3)
    tp_rows(f"control row 12 {label}", fused_decode_q_tp, fused_decode_q_tp.decode_step_q_tp,
            hp, w, cache, token, p, (2,))
    del w, consts
    torch.cuda.empty_cache()
del cache
hp = c.hp_gemma4(**c.GEOM_G4, sliding_window=c.G4_WINDOW)
S, pos = c.STREAM_SEQ, c.STREAM_POS
cache = filled(hp, S, pos, 23, kscale=c.G4_QK_NORM)
token = torch.tensor([222222], dtype=torch.int64, device=dev)
p = torch.tensor([pos], dtype=torch.int32, device=dev)
w = c.random_g4_model(hp, seed=19)
consts = fused_decode.prepare(hp, dev, swa_mask=False, max_seq=S)
timed(f"row 3 gemma4 GEOM_G4 pos={pos}",
      lambda: fused_decode.decode_step(hp, w, cache, token, p, consts))
c._step_profile("AB row 3 gemma4 GEOM_G4", lambda pr: fused_decode.decode_step(
    hp, w, cache, token, p, consts, profile=pr), hp,
    hp.block_count * fused_decode.PROFILE_MARKS_G4 + 3, gemma4=True)
del w, consts, cache
torch.cuda.empty_cache()
hp = c.hp_gemma3(**c.GEOM_12B, sliding_window=1024)
cache = filled(hp, S, pos, 13, flat=True)
token = torch.tensor([200001], dtype=torch.int64, device=dev)
for label, nibble in (("serve-q int8", False), ("serve-q4 nibble+offsets", True)):
    w = c._random_lossless_model(hp, seed=17, nibble=nibble)
    consts = fds.prepare(hp, dev, swa_mask=False, max_seq=S)
    timed(f"control row 10 12B {label} pos={pos}",
          lambda: fds.decode_step_stream(hp, w, cache, token, p, consts), 20)
    del w, consts
    torch.cuda.empty_cache()
"""

PROBE_INSERT = r"""
import os
import time

import torch
import chip_smoke as c
from torch.profiler import ProfilerActivity, profile
from llm_inference_tpu_torch.models import gemma
from llm_inference_tpu_torch.ops.kernels import _build, kv_insert

c.phase_device()
_build.build_all()
dev = torch.device("cuda")
pair = hasattr(kv_insert, "insert_kv_rows")
B, S = c.BATCH, c.BATCH_SEQ
positions = c._batch_positions(S)
pos = torch.tensor(positions, dtype=torch.int32, device=dev)
lanes = torch.arange(B, dtype=torch.int32, device=dev)
idx = torch.where(pos < S, lanes * S + pos, torch.full_like(pos, B * S)).to(torch.int32)
g = torch.Generator(device=dev).manual_seed(31)
how = "one insert_kv_rows" if pair else "two casts + two insert_rows"


def append(kc, vc, k, v):
    if pair:
        kv_insert.insert_kv_rows(kc, vc, k, v, idx)
    else:
        kv_insert.insert_rows(kc, k.to(kc.dtype).contiguous(), idx)
        kv_insert.insert_rows(vc, v.to(vc.dtype).contiguous(), idx)


for label, H, Hkv, L in (("1B [1, 256]", 4, 1, 26), ("gemma4 [2, 256]", 8, 2, 20)):
    d = 256
    kc = torch.zeros((L, B * S, Hkv, d), dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    qkv = torch.randn((B, (H + 2 * Hkv) * d), device=dev, generator=g)
    k = qkv[:, H * d:(H + Hkv) * d].reshape(B, Hkv, d).contiguous()
    v = qkv[:, (H + Hkv) * d:].reshape(B, Hkv, d)
    kb = k.to(torch.bfloat16)
    for _ in range(3):
        ms = c.graph_ms(lambda i: append(kc[i % L], vc[i % L], k, v), L)
        one = c.graph_ms(lambda i: kv_insert.insert_rows(kc[i % L], kb, idx), L)
        c.log(f"AB insert {label} B={B}: {how} {ms:.5f} ms a layer; one-pool insert_rows "
              f"{one:.5f} ms (graphs, cold over {L} layers)")
    del kc, vc
    torch.cuda.empty_cache()


def dev_us(e):
    return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))


def per_op(label, fn, n=10):
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        c.log(f"AB per-op step {label}: wall {(time.perf_counter() - t0) * 1e3 / n:.3f} ms a step "
              "(host synced)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if dev_us(e) > 0 and str(getattr(e, "device_type", "")).endswith("CUDA")]
    ins = [e for e in evs if "insert" in e.key or "copy" in e.key.lower()]
    c.log(f"AB per-op step {label}: device {sum(dev_us(e) for e in evs) / n / 1e3:.4f} ms of "
          f"kernels a step, {sum(e.count for e in evs) / n:.1f} kernels a step (profiler); "
          + "; ".join(f"{e.key[:50]} x{e.count / n:.0f} {dev_us(e) / n:.1f} us" for e in ins))


os.environ["LLMI_NO_FUSED_DECODE"] = "1"
from llm_inference_tpu_torch.serving import BatchedServer

srv = BatchedServer(str(c.tame_checkpoint()), mode="serve-q8", max_batch=B, max_seq=S,
                    decode_chunk=32, max_admit_per_step=B, device="cuda")
hp, w = srv.hparams, srv.weights
tokens = torch.randint(0, c.VOCAB_SIZE, (B,), device=dev, generator=g, dtype=torch.int32)
per_op(f"dense 1B B={B} ragged ({how})",
       lambda: gemma.forward_batched_decode(hp, w, srv._caches, tokens, pos))
table, p1 = c._paged_layout(positions, S, g)
pools = gemma.init_paged_cache(hp, p1, c.PAGE, device=dev)
per_op(f"paged 1B B={B} ragged ({how})", lambda: gemma.forward_batched_decode_paged(
    hp, w, pools, table, tokens, pos, nb_cap=4))
"""

KEEP = ("1B pos=300", "depth sweep", "phases", "1B B=", "AB ", "FAIL", "Error")


def run(checkout: str, probe: str) -> None:
    out = subprocess.run([sys.executable, "-c", probe], cwd=checkout, capture_output=True,
                         text=True)
    for line in (out.stdout + out.stderr).splitlines():
        if any(k in line for k in KEEP):
            print(f"{checkout}: {line}", flush=True)
    if out.returncode != 0:
        print(f"{checkout}: exit {out.returncode}", flush=True)


def main() -> int:
    args = sys.argv[1:]
    probe = {"--batched": PROBE_BATCHED, "--paged": PROBE_PAGED, "--stream": PROBE_STREAM,
             "--qmatmul": PROBE_QMATMUL, "--flash": PROBE_FLASH,
             "--lossless": PROBE_LOSSLESS, "--rowq8": PROBE_ROWQ8,
             "--insert": PROBE_INSERT}.get(args[0] if args else "")
    args = args[1:] if probe else args
    if len(args) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    for checkout in args if len(args) == 1 else (args[0], args[1], args[1], args[0]):
        run(checkout, probe or PROBE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
