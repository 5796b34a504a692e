#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

(For a quicker run while developing, import the module and call the phase
functions wanted after phase_device() and phase_build().)

Phases, each of which exits non-zero on failure (they run in the order
1-5, 8-10, 23, 6-7, 11-22; each one's seconds are logged). The five synthetic
checkpoints (tame_checkpoint, capacity_checkpoint, gemma4_checkpoint,
head_dims_checkpoint, tools_checkpoint) are built in processes of their own, started before
phase 2, so their writing overlaps the phases before the first one that
reads each; that phase waits for its builder.

  1. device   the card's name and power limit (nvidia-smi); no GPU -> fail.
  2. build    nvcc builds every kernel source in llm_inference_tpu_torch/csrc
              (one process per source, all started together).
  3. quant_matmul  the rowwise kernel against its plain twin at the four
              Gemma-3-1B layer shapes and T in {1, 32, 64}; tolerance 1e-4 *
              max(1, max|y|) (the products are exact, only the summation order
              differs); every call launched twice, bit-equal; times at T = 1
              and T = 32 on cold weights beside torch.matmul of bf16 x on the
              bf16 weights.
  4. decode_step   the whole-step kernel against its plain twin at full 1B
              width and depth, one step at position 300 over seeded K/V rows
              0..299, with and without sliding windows; logits within
              1.5e-2 * max(1, max|logits|) with equal argmax (the bar of
              tests/test_fused_decode.py); layer 0's written K/V row within
              one bf16 step (2^-7 relative), every layer's within the logits'
              bar; a second launch bit-equal; the tile plan, time, bound,
              depth sweep and per-phase profile.
  5. slice    the tame synthetic Gemma-3-1B checkpoint (bench.py's
              build_tame_checkpoint bytes, built here with the port's own
              writer, cached in the temp directory), Engine(mode="serve-q8")
              on cuda, the golden 32-token prompt, 100 greedy tokens: the
              stream must equal tests/golden/parity_1b_tame.json, prefill must
              launch quant_matmul 4 x 26 = 104 times and decode one
              decode_step per step. TTFT is the median of seven prefills.
  6. batched kernels  at the 1B serving shapes, each against its plain twin:
              the batched whole step at B = 32, full width and depth, lanes
              ragged over positions 0..1000 and four parked, on uniform random
              int8 weights and on the tame checkpoint's: logits within
              1.5e-2 * max(1, max|logits|) per lane (the bar of
              tests/test_fused_decode_batch.py), equal argmax on every lane
              whose plain top-2 gap exceeds twice that bar, greedy ids equal
              to the argmax of the kernel's logits on every lane, layer 0's
              written K/V rows within one bf16 step and every layer's within
              the logits' bar, no other row touched; a planted fault (one
              layer's cached V zeroed in the plain step) must leave the bar
              on some lane; flash_decode at q
              [32, 4, 256] over S = 1024 with ragged and zero lengths, with and
              without softcap and window starts, rtol = atol = 2e-3 (the bar of
              tests/test_flash_decode.py), a second launch bit-equal, timed
              cold (each call over the next of the 26 layers' caches, as the
              per-op route finds them) and warm (layer 0's every call), beside
              scaled_dot_product_attention timed both ways; insert_rows over
              the [32 * 1024, 1, 256] view with dropped ids, bit-equal; the
              per-op routes' K/V append insert_kv_rows (one launch for both
              pools, f32 k packed and f32 v a column slice of the QKV
              projection, rounded to bf16 in the kernel) against its plain
              twin at the same ids, bit-equal, a second launch bit-equal,
              timed cold over the 26 layers' caches beside the two casts and
              two insert_rows it replaced and two index_copy_.
  7. server   BatchedServer(max_batch=32, max_seq=1024, decode_chunk=32,
              max_admit_per_step=32) on the tame checkpoint with bench.py
              bench_batched's traffic (32 prompts of 32 ids, 256 tokens each;
              the first is the golden prompt and asks for its 100 tokens), once
              per decode route (the per-op one forced with
              LLMI_NO_FUSED_DECODE=1): the golden lane must equal the golden
              stream; on the kernel route every request served alone by the
              same server must give its batched stream (the per-op route
              serves none alone: ALONE says why);
              the kernel route must launch one batched step a decode step, the
              per-op route 26 insert_kv_rows and 26 flash_decode a step; the
              two routes' 32 batched streams must be identical. Aggregate decode tok/s (tokens over the decode loop's wall time)
              and p50 TTFT per route (the 32 prompts, one bucket, admitted
              as one group: one forward_prefill_group pass). Then, on the
              per-op route's server, admission_check: the 32 prompts
              admitted as one group and then one at a time (a group pass
              of one each), the lanes freed between:
              32/32 first ids equal, layer 0's K/V rows within one bf16
              step, every layer's within 1e-1 of its rows' norm (relative
              Frobenius error: the tame 1B amplifies the batch's f32
              rounding order over its 26 layers to 7.5e-2, PERF.md §6);
              both admissions' wall seconds; the group pass's device time
              (torch.profiler) beside the pass of one's.
  8. grouped per-op kernels  quant_matmul over group-scaled int8 and
              q4_matmul over nibbles against their plain twins at the four 1B
              layer shapes and T in {1, 17, 32, 64}, for every variant of
              GROUPED_VARIANTS (Q4_0-, Q8_0-, Q4_K- and Q6_K-like int8; centered
              and offset nibbles); tolerance 1e-4 * max(1, max|y|) (the same
              bf16 weights and exact products, only the summation order
              differs); every call launched twice, bit-equal; each variant's
              dequantized weight read back through x of unit rows at the 1B
              wqkv shape, bit-equal to dequant_bf16_tpu (onehot_weight: every
              quant value, bf16 roundings on ties); times at T = 32 and T = 1
              beside torch.matmul of bf16 x on the pre-dequantized bf16
              weights; Q4_0 nibbles with raw f16 scales (the capacity
              prefill's) the same way, each call also bit-equal
              to the same weights with f32 scales, timed beside the f32
              ones; then Q4_0 int8 and nibbles at the four Gemma-3-12B
              shapes (the capacity prefill's), checked and timed at T = 32.
  9. lossless step  the serve-q / serve-q4 whole step against its plain twin
              at full 1B width and depth, one step at position 300 over seeded
              K/V rows, with and without sliding windows, on random serve-q
              int8 weights, random serve-q4 nibbles with offsets (a Q6_K-like
              int8 down projection in 16-column groups in both) and the tame
              checkpoint's weights in both modes; the bars of phase 4 (equal
              argmax required where the plain top-2 gap exceeds twice the bar),
              no other cache row touched, and a planted fault (layer 13's
              cached V zeroed in the plain step) must leave the bar; the tile
              plan of its weight stream (fused_decode_stream.plan at the 1B
              widths), time, bound and per-phase profile.
 10. lossless slice  the tame checkpoint under Engine(mode="serve-q") and
              Engine(mode="serve-q4"), each on both decode routes (the per-op
              one forced with LLMI_NO_FUSED_DECODE=1): 100 greedy tokens equal
              to the golden stream; the kernel route launches one lossless
              step a decode step and no per-op kernel (its prefill runs plain
              GEMMs on the bf16 operand cache), the per-op route 4 x 26
              grouped quant_matmul (serve-q) or q4_matmul (serve-q4) a prefill
              and a decode step. Decode tok/s and median TTFT per mode and route.
 11. paged kernels  at the 1B serving shapes over a shuffled pool of 256-slot
              pages (each live lane's blocks on distinct pages, later blocks
              and the four parked lanes on the trash page), each against its
              plain twin: the paged batched whole step at B = 32, full width
              and depth, lanes ragged over 0..1000, on random and tame int8
              weights, with phase 6's bars, argmax rule and planted fault, no
              pool row outside the live lanes' written rows and the trash page
              touched, and the parked lanes' rows in the trash page; then
              paged_flash_decode at q [32, 4, 256] with ragged and zero
              lengths, softcap, window starts and nb_cap (a cap covering every
              lane bit-equal to none, a smaller one truncating as the plain
              twin), rtol = atol = 2e-3, a second launch bit-equal, timed cold
              over the pools' 26 layers and warm over layer 0's.
 12. paged server  BatchedServer(kv_pages=48, max_batch=32, max_seq=1024,
              decode_chunk=32, max_admit_per_step=32) on the tame checkpoint
              with phase 7's traffic, on both paged routes (the kernel one
              asked for with LLMI_PAGED_MEGAKERNEL=1): each request takes
              ceil((32 + 256 + 32) / 256) = 2 pages (the golden one 1), so 24
              are admitted at first and the rest wait on the pool; the golden
              lane must equal the golden stream and all 32 streams phase 7's;
              the kernel route must launch one paged step a decode step; the
              free list must hold 48 pages at the end. The per-op route (a
              host-bound ~85 ms a step) serves the same prompts cut to
              PER_OP_TOKENS (64) tokens (the golden one its 100), one page
              each out of PER_OP_POOL (24), so 24 are admitted at first
              again: the streams must equal phase 7's prefixes, 26
              insert_kv_rows and 26 paged_flash_decode a decode step. Then
              serve-q and serve-q4 paged (the per-op route), the golden
              request and 7 others at PER_OP_TOKENS tokens: the golden lane
              must equal the golden stream's prefix. Decode tok/s and p50
              TTFT per route and mode (each admission's same-bucket group
              one forward_prefill_group pass). Then admission_check on the
              kernel route's server (its 48 pages hold all 32 prompts at
              8 tokens each): as phase 7's, with its bars (layer 0 one
              bf16 step, every layer 1e-1 of its rows' norm), the pages
              scattered in one copy a pool, each table row mapping its
              pages, and after each retirement the table all sentinel and
              48 pages free.
 13. capacity step  the capacity whole step (fused_decode_stream) against its
              plain twin at full Gemma-3-12B width and depth (48 layers, D 3840,
              F 15360, 16 q heads over 8 KV heads of 256), one step at position
              300 over seeded K/V rows of a flat cache, with and without sliding
              windows, on random serve-q int8 weights and random serve-q4
              nibbles with Q4_K offsets (a Q6_K-like int8 down projection in
              16-column groups in both): phase 9's bars, argmax rule and planted
              fault; time, bound, per-phase profile, gate/up's bytes a second
              and the tile plan (fused_decode_stream.plan). Then random
              centered Q4_0 nibbles (quants -7..7, Q4_0_SYMMETRIC) in every
              projection with raw f16 scales (the capacity load's): the same
              bars against the twin, a second launch bit-equal, bit-equal to
              the same weights with f32 scales; both timed beside their
              bounds (8.19 against 8.86 GB). Then the tame 1B checkpoint
              under LLMI_FORCE_CAPACITY=1 in serve-q and in serve-q4 (its
              load keeps raw f16 scales), the latter also over the f32 twin
              of its weights (f32_scales): the golden stream, one capacity
              step a decode step and 4 x 26 grouped per-op kernels in the
              prefill, the f16 run's prefill and first decode logits
              bit-equal to the f32 twin's.
 14. capacity slice  the tame synthetic Gemma-3-12B checkpoint (full width and
              depth, Q4_0 layers from seeded random bytes, F16 embedding,
              capacity_checkpoint, 8.07 GB, cached in the temp directory) under
              Engine(mode="serve-q4") and Engine(mode="serve-q") on cuda: the
              capacity route, one capacity step a decode step and 4 x 48
              grouped kernels a prefill; the golden prompt's 100 greedy
              tokens, the same in both modes, whose first
              CAPACITY_PER_OP_TOKENS (8) must be the per-op route's
              (LLMI_NO_FUSED_DECODE=1, 4 x 48 grouped kernels a prefill and a
              step). Decode tok/s, TTFT (median of seven), checkpoint -> first
              token, and the peak device memory of each route's load.
 15. gemma4 step  the rowq8 whole step's gemma4 instance against its plain
              twin at full GEOM_G4 width and depth (bench.py's gemma4: 24
              layers, the last 4 sharing K/V, D 2048, F 4096, 8 q heads over 2
              KV heads of 256, P 256), one step at position 300 over seeded K/V
              rows, with and without sliding windows (every fourth layer
              global, so the shared layers read a windowed and a global
              source), on random rowq8 weights: phase 9's bars and argmax rule,
              a planted fault in layer 18 (the windowed source), no write
              past the 20 owner layers' cache, a second launch bit-equal;
              the tile plan (eight phases), time, bound, per-phase profile.
 16. gemma4 slice  the tame gemma4 checkpoint (gemma4_checkpoint, 4.80 GB,
              cached in the temp directory; its sha256 must be the golden's)
              under Engine(mode="serve-q8") on both decode routes: the golden
              prompt's 100 greedy tokens equal to
              tests/golden/gemma4_g4_tame.json (baked by
              tools/bake_golden_gemma4.py), 145 quant_matmul a prefill and one
              decode_step a decode step (per op: 145 a step); then
              BatchedServer dense and paged on the per-op route, 8 requests:
              the golden lane equal to the golden's server_tokens (the W8A8
              route's stream), identical streams, 20 insert_kv_rows and 24
              flash_decode / paged_flash_decode a decode step.
 17. tp step  the tensor-parallel whole steps on one card (meshes [cuda:0] *
              n, each rank a group of the card's SMs in one launch): the rowq8
              step at n = 2 and 4 and the lossless step at n = 2 on random
              serve-q int8 and serve-q4 nibble weights with Q4_K offsets, full
              1B width and depth, one step at position 300 over seeded K/V rows,
              with and without sliding windows: logits within 1.5e-2 *
              max(1, max|logits|) of the plain twin's and of the single-chip
              kernel's (row 3 / 4) on the same weights, equal argmax where the
              plain top-2 gap exceeds twice the bar (phase 9's rule), every
              rank's K/V replica bit-equal, layer 0's row within one bf16 step
              of the twin's, a second launch bit-equal, and a planted fault
              (rank 1's Wo partial of layer FAULT_LAYER left out of its
              all-reduce in the twin) outside the bar; the lossless ranks'
              tile plan; time and bound over all ranks' bytes (tp_step_bytes).
 18. tp slice  the tame 1B checkpoint under Engine(mode, tp_mesh=[cuda:0] *
              n) for serve-q8 (n = 2, 4), serve-q and serve-q4 (n = 2): the
              golden prompt's 100 greedy tokens equal to the golden stream, one
              tensor-parallel launch a decode step, 4 x 26 quant_matmul /
              grouped quant_matmul / q4_matmul a prefill (the per-op prefill
              on the mesh's first device). Decode tok/s and median TTFT.
 19. serve and parity  the tame 1B checkpoint at full width and depth in
              the serve and parity modes (both per op, no whole step):
              Engine(mode="serve") on cuda, the golden prompt's 100 greedy
              tokens equal to the golden stream, once as it stands (no kernel
              launched: bf16 products and the masked softmax) and once under
              LLMI_FLASH_DECODE=1 (flash_decode 26 times a decode step, nothing
              else); BatchedServer(mode="serve") with phase 7's first 4
              requests at SERVE_TOKENS (64) tokens each, dense and paged (8
              pages): the golden lane equal to the golden's first 64 tokens,
              the two servers' streams identical, 26 insert_kv_rows and 26
              flash_decode (dense) or paged_flash_decode (paged) a decode step;
              Engine(mode="parity") against the golden's first PARITY_TOKENS
              (16) tokens only (the parity attention walks the cache slot by
              slot, 26 layers x ~60 slots of small launches a token: the cut
              keeps the phase short), no kernel launched; the CLI's --trace
              (python -m llm_inference_tpu_torch, a process of its own, -n 1:
              the prefill only): its .npz holds the eager parity prefill's
              taps in order, all finite, each within 1e-5 of max(1, max|x|)
              of the eager taps; BatchedServer(mode="parity") with 2
              lanes of 8 tokens (phase 7's first two prompts): the golden
              lane equal to the golden's prefix, no kernel launched (its f16
              lanes never reach insert_kv_rows). Decode tok/s and TTFT of
              each mode and server.
 20. sampling  stochastic sampling (temperature 0.8, top_k 40, top_p 0.95;
              llm_inference_tpu_torch/sampling.py, random.py: plain torch,
              no kernel): the sampler at V = 262144 for 1 and 32 lanes on the
              card against the same code on the CPU, from the same logits
              copied to the host: the keys read back and the random words
              bit-equal, the ids identical (and under temperature 1.0, top_p
              0.9), its device ms a call (a CUDA graph of 20 calls) beside
              greedy argmax's and its random words' alone, and eager; the
              tame 1B under Engine(mode="serve-q8", sampling, seed) on the
              kernel route, SAMPLE_TOKENS (32) tokens twice: the same stream,
              one whole step a decode step; BatchedServer(mode="serve-q8",
              sampling, seed) with phase 7's first SAMPLE_REQUESTS (4)
              prompts at 32 tokens, dense and paged (8 pages), each twice: the
              per-op routes (a sampled server leaves the kernel routes), the
              same streams, no batched whole step, 26 insert_kv_rows and 26
              flash_decode / paged_flash_decode a decode step. Decode tok/s
              and TTFT of each.
 21. sharded   the per-op sharded path (parallel/sharding.py) on one card,
              its ranks on meshes that repeat cuda:0: the tame 1B (Hkv 1, so
              its caches stay whole) under Engine(mode="serve-q8",
              sharding_fn=gemma_sharding_fn, cache_sharding=kv_cache_sharding)
              over 2 ranks against the unsharded per-op route
              (LLMI_NO_FUSED_DECODE=1): the golden's first SHARD_TOKENS (32)
              tokens on both, the prefill's and first decode step's logits
              within 1.5e-2 * max(1, max|logits|) with equal argmax, 4 x 2 x
              26 quant_matmul a forward (the per-op route 4 x 26), every
              distinct 1B shard through quant_matmul against its plain twin
              at T 1 and 32 (phase 3's bar, a second launch bit-equal);
              BatchedServer over data 2 x model 2 (two lanes a data row) and
              a paged one (8 pages) with weights over 2 ranks, phase 7's
              first SHARD_REQUESTS (4) prompts for 16 tokens: streams equal
              to the unsharded per-op server's, the DP x TP server's first
              step's logits within the bar of the per-op server's (every
              projection a W8A8 product: the col-parallel ones must quantize
              with the whole row's scale), insert_kv_rows and flash_decode
              (paged_flash_decode) once a layer, a data row and a step; then
              a random 2-layer model at GEOM_4B widths (H 8, Hkv 4) over 2
              and 4 ranks (2 and 1 KV heads a rank): the sharded prefill (T
              32), decode step (flash_decode on each rank's heads, under
              LLMI_FLASH_DECODE=1) and batched step (4 lanes over seeded
              caches) within the bar of the unsharded ones, quant_matmul on
              every shard at T 1, 4 and 32, and each rank's insert_kv_rows
              (bit-equal) and flash_decode (rtol = atol = 2e-3) against their
              plain twins at the rank's shard shapes, second launches
              bit-equal. Decode tok/s and TTFT of each run.
 22. head dims  per-layer head dims (Gemma 4's global heads wider than its
              sliding ones): head_dims_checkpoint (GEOM_G4's widths and
              depth, global heads of 512, sliding ones of 256, gemma4_checkpoint's
              tame recipe; cut: a HD_VOCAB-token vocabulary, 0.80 GB) under
              Engine(mode="serve-q8") on cuda, the per-op route (no whole
              step takes per-layer head dims) with a per-layer cache at each
              KV layer's width: HD_PROMPT_LENS' four prompts at HD_TOKENS
              tokens, masked and under LLMI_FLASH_DECODE=1 (24 flash_decode a
              decode step, at both widths), the same streams, 145
              quant_matmul a forward; BatchedServer dense and paged on the
              same requests: every lane equal to the Engine's stream, 20
              insert_kv_rows and 24 flash_decode / paged_flash_decode a decode
              step; flash_decode and paged_flash_decode at both widths (GQA
              4, ragged and empty lanes, softcap, window starts, nb_cap)
              within phase 21's rtol = atol = 2e-3 of their twins, second
              launches bit-equal, insert_kv_rows bit-equal twice; and both
              widths timed at phase 6's lanes, cold over HD_LAYERS layers,
              beside scaled_dot_product_attention and the bound. Then the
              sharded per-op path on the same checkpoint, its ranks on a mesh
              that repeats cuda:0 (_hd_sharded): Engine(sharding_fn,
              cache_sharding) over 2 ranks (a KV head a rank, each rank's
              cache per layer at 512 or 256) under LLMI_FLASH_DECODE=1,
              BatchedServer over data 2 x model 2 and the paged server with
              weights over 2 ranks (whole pools): every stream equal to the
              unsharded Engine's; flash_decode 2 x 24, insert_kv_rows 2 x 2 x
              20 and flash_decode 2 x 2 x 24 (DP x TP), 20 insert_kv_rows and
              24 paged_flash_decode (paged) a decode step; insert_kv_rows and
              flash_decode at a rank's shard shapes (4 q heads over one KV
              head of 512 and of 256) against their twins (phase 21's
              _check_rank_attention).
 23. tools    the port's tools (tools/torch_perplexity.py,
              torch_greedy_parity.py, torch_compare_with_reference.py,
              torch_roofline.py) driven through their functions on the tame
              1B: the perplexity of the golden prompt and its first 32 tokens
              (63 scored positions) in serve-q8 on the kernel route and per
              op (LLMI_NO_FUSED_DECODE=1 with LLMI_FLASH_DECODE=1) and in
              serve: the two routes' per-position log-probs, and the kernel
              route's against one teacher-forced prefill over the same 64
              tokens, within 3e-2 * max(1, max|logits|); serve's mean NLL
              within 5% of serve-q8's; the stream below the same prompt with a
              random continuation. Greedy parity in serve-q8 and serve-q4 on
              the kernel routes: 100/100 of the golden, one whole step a
              decode step. The comparison on tools_checkpoint (a random
              2-layer model at the 1B widths; cut: a TOOLS_VOCAB-token
              vocabulary): the card's parity taps against the CPU's written in
              the reference printer's format, PARITY OK at rel_tol 1e-3; the
              same dump with one tensor x 1.01 exits 1 naming it. The roofline
              of the serve-q8 kernel route (2 chunks of 16), the per-op route
              (1 chunk of 1), prefill buckets 32 and 64 (a prefill each) and
              BatchedServer at 4 lanes dense (the kernel route, 1 chunk of 16)
              and paged (1 chunk of 1): each port
              kernel's traced calls equal to its wrapper's launch counter over
              the same window, the step bound equal to rowq8_step_work's
              within 1%.

The last lines are the card line, one JSON object with each kernel's
numbers, and {"ok": true, "device": {...}}. Times are CUDA-event means over
repeated launches (through CUDA graphs where a call takes less time than
the host needs to issue it); bound_ms is the larger of bytes / 3.35 TB/s and
the operations' time at the peak of their type: tensor-core bf16 products
at 989 TFLOP/s, CUDA-core f32 ones at 67 TFLOP/s (H100 SXM data sheet,
dense). Each kernel's
launches are counted over its path's run, with every count set to 0 just
before it: phase 5 for quant_matmul and decode_step, phase 10's per-op
routes for the grouped quant_matmul and q4_matmul, its kernel routes for
the lossless step, phase 7's kernel route for the batched step, its per-op
route for flash_decode and insert_rows (phase 19's serve runs launch
flash_decode, paged_flash_decode and insert_kv_rows too, counted there
and not in the line), phase 12's paged kernel route for
the paged step and its paged per-op route for paged_flash_decode, phase
14's two capacity runs for the capacity step, phase 16's kernel route for
the gemma4 step, phase 18's serve-q8 runs for the rowq8 tensor-parallel
step and its serve-q and serve-q4 runs for the lossless one; phase 13's
tame serve-q4 run over its own f16 scales for the f16-scale instances
of the capacity step and q4_matmul (their own lines). Phase 21's
sharded runs (its Engine and servers, counted the same way) add their
launches to quant_matmul, flash_decode, paged_flash_decode and insert_rows,
and phase 22's (its flash Engine run and servers, unsharded and sharded)
to flash_decode, paged_flash_decode and insert_rows, whose notes carry the
512-wide times; phase 23's (each tool's run, counted the same way) to
quant_matmul, decode_step, decode_step_q, flash_decode, paged_flash_decode,
insert_rows and decode_step_batch.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

GEOM_1B = dict(n_layers=26, n_embd=1152, n_ff=6912, n_head=4, n_head_kv=1, head_dim=256)
# the capacity class (tools/capacity_demo.py GEOMS; the Gemma-3 model cards),
# each with its 1024-token sliding window
GEOM_4B = dict(n_layers=34, n_embd=2560, n_ff=10240, n_head=8, n_head_kv=4, head_dim=256)
GEOM_12B = dict(n_layers=48, n_embd=3840, n_ff=15360, n_head=16, n_head_kv=8, head_dim=256)
GEOM_27B = dict(n_layers=62, n_embd=5376, n_ff=21504, n_head=32, n_head_kv=16, head_dim=128)
# the repo's gemma4 configuration (bench.py GEOM_G4: head_dim = n_embd // n_head = 256)
GEOM_G4 = dict(n_layers=24, n_embd=2048, n_ff=4096, n_head=8, n_head_kv=2,
               n_embd_per_layer=256, shared_kv_layers=4)
G4_WINDOW = 128  # the gemma4 phases' sliding window (every fourth layer global)
# The random gemma4 models' q_norm and k_norm weights: their product 1/16 is
# Gemma-3's 1 / sqrt(head_dim) at head_dim 256. gemma4 scales attention by
# 1.0 and leaves the temperature to these learned weights; at 1.0 the
# scores of random unit-RMS q and k have a spread of 16, and the 24-layer
# random model is chaotic: its plain twin alone moves its logits by 0.68 of
# max|logits| for a 1e-7 relative change of the embedding scale (a D-1024
# cut of GEOM_G4 on the CPU), so no two summation orders could meet a bar.
# At 0.25 the same change moves them by 1e-7.
G4_QK_NORM = 0.25
VOCAB_SIZE = 262144
TAME_SEED, TAME_STD = 20260816, 0.02


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)


try:  # the H100's peaks, bound_ms and the card line, shared with the tools
    from llm_inference_tpu_torch.card import (  # noqa: F401
        BF16_OPS_PER_S, F32_OPS_PER_S, HBM_BYTES_PER_S, bound_by, bound_ms, nvidia_smi)
except ImportError as e:
    fail(f"the port package is not beside chip_smoke.py ({e})")


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


def _gemma3_metadata(w, *, n_layers, n_embd, n_ff, n_head, n_head_kv, head_dim,
                     explicit_head_dim, vocab, rope_freq_base, sliding_window=0) -> None:
    """The Gemma-3 metadata of tests/fixtures.py's checkpoints, in its order."""
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
    if sliding_window:
        w.add_metadata("gemma3.attention.sliding_window", sliding_window)
    w.add_metadata("tokenizer.ggml.tokens", vocab)
    w.add_metadata("tokenizer.ggml.bos_token_id", 2)
    w.add_metadata("tokenizer.ggml.eos_token_id", 1)
    w.add_metadata("tokenizer.ggml.unk_token_id", 3)


def build_gemma3_gguf(*, n_layers=1, n_embd=32, n_ff=64, n_head=2, n_head_kv=1, vocab=None,
                      seed=12345, rope_freq_base=10000.0, with_post_norms=False,
                      head_dim=None, weight_std=0.1, weight_fmt=None) -> bytes:
    """The seeded synthetic Gemma-3 checkpoint of tests/fixtures.py
    (layer weights in ``weight_fmt``, Q4_0 by default, F16 embeddings),
    byte for byte, written with the port's own GGUF writer."""
    from llm_inference_tpu_torch.gguf import GGMLType, GGUFWriter

    explicit_head_dim = head_dim is not None and head_dim != n_embd // n_head
    head_dim = head_dim if head_dim is not None else n_embd // n_head
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return (rng.standard_normal(shape) * weight_std).astype(np.float32)

    w = GGUFWriter()
    _gemma3_metadata(w, n_layers=n_layers, n_embd=n_embd, n_ff=n_ff, n_head=n_head,
                     n_head_kv=n_head_kv, head_dim=head_dim, explicit_head_dim=explicit_head_dim,
                     vocab=vocab, rope_freq_base=rope_freq_base)

    q4, f16, f32 = weight_fmt or GGMLType.Q4_0, GGMLType.F16, GGMLType.F32
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


def build_gemma4_gguf(*, n_layers=4, n_embd=32, n_ff=64, n_head=2, n_head_kv=1,
                      n_embd_per_layer=32, shared_kv_layers=1, vocab=None, weight_fmt=None,
                      seed=777, weight_std=0.1, head_dims=None, pattern=None,
                      sliding_window=0) -> bytes:
    """The seeded synthetic gemma4 checkpoint of tests/fixtures.py
    (per-layer inputs, shared trailing KV layers, out_scale; layer weights
    in ``weight_fmt``, Q4_0 by default, F16 embeddings), byte for byte at
    its spread of 0.1 without the last three arguments, written with the
    port's own GGUF writer. ``pattern`` (sliding layers) with
    ``sliding_window``, and ``head_dims`` (global, sliding): per-layer head
    dims, each layer's projections and q/k norms at its width."""
    from llm_inference_tpu_torch.gguf import GGMLType, GGUFWriter

    hd = [n_embd // n_head if head_dims is None else head_dims[1] if sw else head_dims[0]
          for sw in (pattern or [False] * n_layers)]
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return (rng.standard_normal(shape) * weight_std).astype(np.float32)

    q4, f16, f32 = weight_fmt or GGMLType.Q4_0, GGMLType.F16, GGMLType.F32
    w = GGUFWriter()
    for key, val in (("general.architecture", "gemma4"), ("gemma4.block_count", n_layers),
                     ("gemma4.embedding_length", n_embd), ("gemma4.feed_forward_length", n_ff),
                     ("gemma4.attention.head_count", n_head),
                     ("gemma4.attention.head_count_kv", n_head_kv),
                     ("gemma4.attention.layer_norm_rms_epsilon", 1e-6),
                     ("gemma4.rope.freq_base", 1000000.0),
                     ("gemma4.embedding_length_per_layer", n_embd_per_layer),
                     ("gemma4.attention.shared_kv_layers", shared_kv_layers)):
        w.add_metadata(key, val)
    if pattern is not None:
        w.add_metadata("gemma4.attention.sliding_window", sliding_window)
        w.add_metadata("gemma4.attention.sliding_window_pattern", list(pattern))
    if head_dims is not None:
        for key, val in zip(("key_length", "value_length", "key_length_swa", "value_length_swa"),
                            (head_dims[0], head_dims[0], head_dims[1], head_dims[1])):
            w.add_metadata(f"gemma4.attention.{key}", val)
    for key, val in (("tokenizer.ggml.tokens", vocab), ("tokenizer.ggml.bos_token_id", 2),
                     ("tokenizer.ggml.eos_token_id", 1), ("tokenizer.ggml.unk_token_id", 3),
                     ("tokenizer.ggml.add_bos_token", True)):
        w.add_metadata(key, val)
    P = n_embd_per_layer
    w.add_tensor("token_embd.weight", rand(len(vocab), n_embd), f16)
    w.add_tensor("output_norm.weight", rand(n_embd) + 1.0, f32)
    w.add_tensor("token_embd_per_layer.weight", rand(len(vocab), n_layers * P), f16)
    w.add_tensor("per_layer_model_proj.weight", rand(n_layers * P, n_embd), q4)
    w.add_tensor("per_layer_proj_norm.weight", rand(P) + 1.0, f32)
    for i in range(n_layers):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", rand(n_embd) + 1.0, f32)
        w.add_tensor(p + "attn_q_norm.weight", rand(hd[i]) + 1.0, f32)
        w.add_tensor(p + "attn_k_norm.weight", rand(hd[i]) + 1.0, f32)
        w.add_tensor(p + "attn_q.weight", rand(n_head * hd[i], n_embd), q4)
        if i < n_layers - shared_kv_layers:
            w.add_tensor(p + "attn_k.weight", rand(n_head_kv * hd[i], n_embd), q4)
            w.add_tensor(p + "attn_v.weight", rand(n_head_kv * hd[i], n_embd), q4)
        w.add_tensor(p + "attn_output.weight", rand(n_embd, n_head * hd[i]), q4)
        w.add_tensor(p + "ffn_norm.weight", rand(n_embd) + 1.0, f32)
        w.add_tensor(p + "ffn_gate.weight", rand(n_ff, n_embd), q4)
        w.add_tensor(p + "ffn_up.weight", rand(n_ff, n_embd), q4)
        w.add_tensor(p + "ffn_down.weight", rand(n_embd, n_ff), q4)
        w.add_tensor(p + "post_attention_norm.weight", rand(n_embd) + 1.0, f32)
        w.add_tensor(p + "post_ffw_norm.weight", rand(n_embd) + 1.0, f32)
        w.add_tensor(p + "per_layer_inp_gate.weight", rand(P, n_embd), q4)
        w.add_tensor(p + "per_layer_proj.weight", rand(n_embd, P), q4)
        w.add_tensor(p + "per_layer_post_norm.weight", rand(n_embd) + 1.0, f32)
        w.add_tensor(p + "out_scale.weight", np.asarray([0.9], dtype=np.float32), f32)
    return w.build()


def tame_vocab() -> list[str]:
    vocab = [f"t{i}" for i in range(VOCAB_SIZE)]
    vocab[1], vocab[2], vocab[3] = "<eos>", "<bos>", "<unk>"
    return vocab


# The checkpoint builders started by start_checkpoint_builders, by function
# name; a checkpoint's function waits for its builder before it looks for
# the file.
_BUILDERS: dict = {}


def start_checkpoint_builders() -> None:
    """Build the five synthetic checkpoints (up to about 45 s each) in processes
    of their own, spawned so that none inherits CUDA state, while the
    phases before the first reader of each run. Daemonic: a failing smoke
    ends them as it exits."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    for fn in (tame_checkpoint, capacity_checkpoint, gemma4_checkpoint,
               head_dims_checkpoint, tools_checkpoint):
        proc = ctx.Process(target=fn, name=fn.__name__, daemon=True)
        proc.start()
        _BUILDERS[fn.__name__] = proc


def _await_builder(name: str) -> None:
    proc = _BUILDERS.pop(name, None)
    if proc is None:
        return
    t0 = time.perf_counter()
    proc.join()
    if proc.exitcode != 0:
        fail(f"{name}: its builder process ended with exit code {proc.exitcode}")
    if time.perf_counter() - t0 > 0.5:
        log(f"{name}: waited {time.perf_counter() - t0:.1f} s for its builder")


def tame_checkpoint() -> Path:
    _await_builder("tame_checkpoint")
    path = Path(tempfile.gettempdir()) / "llmi_torch_tame_gemma3_1b_q4_0.gguf"
    if not path.exists():
        t0 = time.perf_counter()
        buf = build_gemma3_gguf(vocab=tame_vocab(), seed=TAME_SEED, weight_std=TAME_STD, **GEOM_1B)
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(buf)
        tmp.rename(path)
        log(f"built the tame 1B checkpoint in {time.perf_counter() - t0:.1f} s")
    return path


CAPACITY_SEED = 20261017


def capacity_checkpoint() -> Path:
    """The tame synthetic Gemma-3-12B (GEOM_12B, 262144-token vocabulary,
    1e6 rope base, 1024-token sliding window): Q4_0 layer weights whose
    nibbles are seeded random bytes and whose block scales give a spread of
    about 0.02 (uniform nibbles minus 8 have a spread of sqrt(21.25)), an F16
    embedding and F32 norms of spread 0.02 about 1. Written once into the
    temp directory a tensor at a time (8.07 GB; encoding floats to Q4_0 would
    take minutes)."""
    from llm_inference_tpu_torch.gguf import GGMLType, GGUFWriter

    _await_builder("capacity_checkpoint")
    path = Path(tempfile.gettempdir()) / "llmi_torch_tame_gemma3_12b_q4_0.gguf"
    if path.exists():
        return path
    t0 = time.perf_counter()
    g = GEOM_12B
    L, D, F, H, Hkv, hd = (g[k] for k in ("n_layers", "n_embd", "n_ff", "n_head", "n_head_kv",
                                          "head_dim"))
    rng = np.random.default_rng(CAPACITY_SEED)
    d = TAME_STD / math.sqrt(21.25)

    def q4_0(rows, cols):
        def produce():
            nb = rows * cols // 32
            blocks = np.empty((nb, 18), dtype=np.uint8)
            scale = (d * (1 + 0.1 * rng.random(nb, dtype=np.float32))).astype(np.float16)
            blocks[:, :2] = scale.view(np.uint8).reshape(nb, 2)
            blocks[:, 2:] = np.frombuffer(rng.bytes(nb * 16), dtype=np.uint8).reshape(nb, 16)
            return blocks
        return (cols, rows), GGMLType.Q4_0, rows * cols // 32 * 18, produce

    def f32(n):
        return (n,), GGMLType.F32, 4 * n, lambda: (
            rng.standard_normal(n, dtype=np.float32) * TAME_STD + 1.0)

    def f16(rows, cols):
        return (cols, rows), GGMLType.F16, 2 * rows * cols, lambda: (
            rng.standard_normal((rows, cols), dtype=np.float32) * TAME_STD).astype(np.float16)

    w = GGUFWriter()
    _gemma3_metadata(w, vocab=tame_vocab(), rope_freq_base=1e6, explicit_head_dim=True,
                     sliding_window=1024, **g)
    w.add_tensor_stream("token_embd.weight", *f16(VOCAB_SIZE, D))
    w.add_tensor_stream("output_norm.weight", *f32(D))
    for i in range(L):
        p = f"blk.{i}."
        for name, spec in (("attn_norm", f32(D)), ("attn_q_norm", f32(hd)),
                           ("attn_k_norm", f32(hd)), ("attn_q", q4_0(H * hd, D)),
                           ("attn_k", q4_0(Hkv * hd, D)), ("attn_v", q4_0(Hkv * hd, D)),
                           ("attn_output", q4_0(D, H * hd)), ("ffn_norm", f32(D)),
                           ("ffn_gate", q4_0(F, D)), ("ffn_up", q4_0(F, D)),
                           ("ffn_down", q4_0(D, F)), ("post_attention_norm", f32(D)),
                           ("post_ffw_norm", f32(D))):
            w.add_tensor_stream(p + name + ".weight", *spec)
    tmp = path.with_suffix(".tmp")
    w.write(str(tmp))
    tmp.rename(path)
    log(f"built the tame 12B checkpoint ({path.stat().st_size / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    return path


G4_SEED = 20261018


def gemma4_checkpoint() -> Path:
    """The tame synthetic gemma4 at bench.py's GEOM_G4 (24 layers, the last
    4 sharing K/V, D 2048, F 4096, 8 q heads over 2 KV heads of 256, P 256,
    262144-token vocabulary, 1e6 rope base, every fourth layer global in a
    128-token window): Q4_0 layer weights and per_layer_model_proj whose
    nibbles are seeded random bytes and whose block scales give a spread of
    about 0.02, F16 embedding and per-layer embedding of spread 0.02, F32
    norms about 1 and out_scale about 0.95. Written once into the temp
    directory a tensor at a time (4.80 GB), as capacity_checkpoint does."""
    _await_builder("gemma4_checkpoint")
    path = Path(tempfile.gettempdir()) / "llmi_torch_tame_gemma4_g4_q4_0.gguf"
    if not path.exists():
        _write_gemma4(path, "tame gemma4", seed=G4_SEED, vocab=tame_vocab())
    return path


# Phase 22's checkpoint: GEOM_G4 with Gemma 4's per-layer head dims, global
# heads of 512 and sliding ones of 256 (key = value width), and a cut
# vocabulary (the phase's subject is the attention at both widths; the
# embedding tables are held at full size by phase 16's checkpoint).
HD_DIMS = (512, 256)
HD_VOCAB = 16384
HD_SEED = 20261019


def head_dims_checkpoint() -> Path:
    """gemma4_checkpoint's recipe at GEOM_G4's widths with per-layer head
    dims: layers 3, 7, ..., 23 global with heads of HD_DIMS[0], the others
    sliding (window G4_WINDOW) with heads of HD_DIMS[1]; a HD_VOCAB-token
    vocabulary. Layer n_kv - 1 = 19 is global and 18 sliding, the sources
    that ``kv_source_layer`` gives the four shared-KV layers. About 0.8 GB."""
    _await_builder("head_dims_checkpoint")
    path = Path(tempfile.gettempdir()) / "llmi_torch_gemma4_g4_head_dims_q4_0.gguf"
    if not path.exists():
        vocab = [f"t{i}" for i in range(HD_VOCAB)]
        vocab[1], vocab[2], vocab[3] = "<eos>", "<bos>", "<unk>"
        _write_gemma4(path, "gemma4 per-layer head dims", seed=HD_SEED, vocab=vocab,
                      head_dims=HD_DIMS)
    return path


TOOLS_VOCAB = 16384
TOOLS_SEED = 20261020


def tools_checkpoint() -> Path:
    """Phase 23's comparison model: a random 2-layer Gemma-3 at GEOM_1B's
    widths (Q4_0 layers, F16 embedding; cut: depth 2, a TOOLS_VOCAB-token
    vocabulary). About 68 MB."""
    _await_builder("tools_checkpoint")
    path = Path(tempfile.gettempdir()) / "llmi_torch_tools_gemma3_2l_q4_0.gguf"
    if not path.exists():
        vocab = [f"t{i}" for i in range(TOOLS_VOCAB)]
        vocab[1], vocab[2], vocab[3] = "<eos>", "<bos>", "<unk>"
        buf = build_gemma3_gguf(vocab=vocab, seed=TOOLS_SEED, weight_std=TAME_STD,
                                **dict(GEOM_1B, n_layers=2))
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(buf)
        tmp.rename(path)
    return path


def _write_gemma4(path: Path, what: str, *, seed: int, vocab: list, head_dims=None) -> None:
    """Write a tame gemma4 at GEOM_G4 into ``path`` (gemma4_checkpoint's
    recipe); ``head_dims`` (global, sliding) gives the layers per-layer head
    dims (``attention.key_length``/``_swa``, ``value_length``/``_swa``)."""
    from llm_inference_tpu_torch.gguf import GGMLType, GGUFWriter

    t0 = time.perf_counter()
    g = GEOM_G4
    L, D, F, H, Hkv, P, shared = (g[k] for k in ("n_layers", "n_embd", "n_ff", "n_head",
                                                  "n_head_kv", "n_embd_per_layer",
                                                  "shared_kv_layers"))
    pattern = [i % 4 != 3 for i in range(L)]
    hd = [D // H if head_dims is None else head_dims[1] if sw else head_dims[0]
          for sw in pattern]
    V = len(vocab)
    rng = np.random.default_rng(seed)
    d = TAME_STD / math.sqrt(21.25)

    def q4_0(rows, cols):
        def produce():
            nb = rows * cols // 32
            blocks = np.empty((nb, 18), dtype=np.uint8)
            scale = (d * (1 + 0.1 * rng.random(nb, dtype=np.float32))).astype(np.float16)
            blocks[:, :2] = scale.view(np.uint8).reshape(nb, 2)
            blocks[:, 2:] = np.frombuffer(rng.bytes(nb * 16), dtype=np.uint8).reshape(nb, 16)
            return blocks
        return (cols, rows), GGMLType.Q4_0, rows * cols // 32 * 18, produce

    def f32(n, mean=1.0, std=TAME_STD):
        return (n,), GGMLType.F32, 4 * n, lambda: (
            rng.standard_normal(n, dtype=np.float32) * std + mean)

    def f16(rows, cols):
        return (cols, rows), GGMLType.F16, 2 * rows * cols, lambda: (
            rng.standard_normal((rows, cols), dtype=np.float32) * TAME_STD).astype(np.float16)

    w = GGUFWriter()
    dims = [] if head_dims is None else [
        ("gemma4.attention.key_length", head_dims[0]),
        ("gemma4.attention.value_length", head_dims[0]),
        ("gemma4.attention.key_length_swa", head_dims[1]),
        ("gemma4.attention.value_length_swa", head_dims[1])]
    for key, val in (("general.architecture", "gemma4"), ("gemma4.block_count", L),
                     ("gemma4.embedding_length", D), ("gemma4.feed_forward_length", F),
                     ("gemma4.attention.head_count", H), ("gemma4.attention.head_count_kv", Hkv),
                     ("gemma4.attention.layer_norm_rms_epsilon", 1e-6),
                     ("gemma4.rope.freq_base", 1e6), ("gemma4.embedding_length_per_layer", P),
                     ("gemma4.attention.shared_kv_layers", shared),
                     ("gemma4.attention.sliding_window", G4_WINDOW),
                     ("gemma4.attention.sliding_window_pattern", pattern), *dims,
                     ("tokenizer.ggml.tokens", vocab), ("tokenizer.ggml.bos_token_id", 2),
                     ("tokenizer.ggml.eos_token_id", 1), ("tokenizer.ggml.unk_token_id", 3)):
        w.add_metadata(key, val)
    w.add_tensor_stream("token_embd.weight", *f16(V, D))
    w.add_tensor_stream("output_norm.weight", *f32(D))
    w.add_tensor_stream("token_embd_per_layer.weight", *f16(V, L * P))
    w.add_tensor_stream("per_layer_model_proj.weight", *q4_0(L * P, D))
    w.add_tensor_stream("per_layer_proj_norm.weight", *f32(P))
    for i in range(L):
        p = f"blk.{i}."
        kv = (("attn_k", q4_0(Hkv * hd[i], D)), ("attn_v", q4_0(Hkv * hd[i], D))) \
            if i < L - shared else ()
        for name, spec in (("attn_norm", f32(D)), ("attn_q_norm", f32(hd[i])),
                           ("attn_k_norm", f32(hd[i])), ("attn_q", q4_0(H * hd[i], D)), *kv,
                           ("attn_output", q4_0(D, H * hd[i])), ("ffn_norm", f32(D)),
                           ("ffn_gate", q4_0(F, D)), ("ffn_up", q4_0(F, D)),
                           ("ffn_down", q4_0(D, F)), ("post_attention_norm", f32(D)),
                           ("post_ffw_norm", f32(D)), ("per_layer_inp_gate", q4_0(P, D)),
                           ("per_layer_proj", q4_0(D, P)), ("per_layer_post_norm", f32(D)),
                           ("out_scale", f32(1, mean=0.95))):
            w.add_tensor_stream(p + name + ".weight", *spec)
    tmp = path.with_suffix(".tmp")
    w.write(str(tmp))
    tmp.rename(path)
    log(f"built the {what} checkpoint ({path.stat().st_size / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")


def sha256_of(path: Path) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            h.update(chunk)
    return h.hexdigest()


# -- phases ---------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    smi = nvidia_smi()
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
    t1 = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}  # the same at T = 1
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
            again = qmatmul.quant_matmul(qts[0], x)
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            log(f"quant_matmul {name} R={R} C={C} T={T}: max_abs_err {err:.3e} (tol {tol:.3e})")
            if not err <= tol:
                fail(f"quant_matmul {name} T={T}: kernel disagrees with plain ({err} > {tol})")
            if not torch.equal(y, again):
                fail(f"quant_matmul {name} T={T}: a second launch is not bit-equal")
            worst = max(worst, err)
            if T == 64:
                continue
            ms = graph_ms(lambda i: qmatmul.quant_matmul(qts[i % n_copies], x), n_copies)
            # bf16 weights: as many copies as exceed the L2 too
            n_lib = min(n_copies, max(2, math.ceil(100e6 / (2 * R * C))))
            wds = [qt.dequant(torch.bfloat16) for qt in qts[:n_lib]]
            xb = x.to(torch.bfloat16)
            lib = graph_ms(lambda i: torch.matmul(xb, wds[i % len(wds)].T), len(wds))
            del wds
            b = bound_ms(R * C + 4 * R + 4 * T * C + 4 * T * R, 2 * T * R * C)
            if T == 1:
                log(f"quant_matmul {name} T=1: kernel {ms:.4f} ms, torch.matmul bf16 "
                    f"{lib:.4f} ms, bound {b:.4f} ms")
                for k, v in (("ms", ms), ("library_ms", lib), ("bound_ms", b)):
                    t1[k] += v
                continue
            plain = graph_ms(lambda i: qmatmul.quant_matmul_plain(qts[i % n_copies], x), 4)
            log(f"quant_matmul {name} T=32: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"torch.matmul bf16 {lib:.4f} ms, bound {b:.4f} ms")
            for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", b)):
                totals[k] += v
        del qs, qts
    torch.cuda.empty_cache()
    log(f"quant_matmul four 1B shapes: T=32 kernel {totals['ms']:.4f} ms, torch.matmul bf16 "
        f"{totals['library_ms']:.4f} ms, bound {totals['bound_ms']:.4f} ms; T=1 kernel "
        f"{t1['ms']:.4f} ms, torch.matmul bf16 {t1['library_ms']:.4f} ms, bound "
        f"{t1['bound_ms']:.4f} ms; second launches bit-equal")
    return worst, totals


# The grouped per-op variants of phase 8: (name, nibble packing, group
# size, the quants' range, offsets). Q4_0-like int8 and nibbles are
# centered 4-bit values, Q8_0-like full int8, Q4_K-like unsigned 4-bit
# with min offsets, Q6_K-like 6-bit values in 16-column groups.
GROUPED_VARIANTS = (
    ("int8 gs32 (Q4_0)", False, 32, (-8, 7), False),
    ("int8 gs32 (Q8_0)", False, 32, (-127, 127), False),
    ("int8 gs32 offsets (Q4_K)", False, 32, (0, 15), True),
    ("int8 gs16 (Q6_K)", False, 16, (-32, 31), False),
    ("nibble centered (Q4_0)", True, 32, (-8, 7), False),
    ("nibble offsets (Q4_K)", True, 32, (0, 15), True),
)


# Phase 13's raw-f16 instance: centered Q4_0 nibbles whose quants are
# symmetric about 0, as a checkpoint's round(w / d) of centred weights are.
# Uniform -8..7 (mean -0.5) gave a 48-layer model whose planted fault
# (_check_step_q) did not move the logits at all.
Q4_0_SYMMETRIC = ("nibble centered (Q4_0), quants -7..7", True, 32, (-7, 7), False)


def _grouped_weight(R: int, C: int, nibble: bool, gs: int, lo: int, hi: int, offsets: bool,
                    g, lead=(), std: float = 0.02):
    """A random group-scaled weight (QuantTensor or Q4Tensor) whose values
    have about ``std`` spread: quants uniform in [lo, hi], group scales
    std / (the quants' spread) * (1 + 0.1 u), offsets centering unsigned ones."""
    import torch

    from llm_inference_tpu_torch.quant.device import QuantTensor, pack_q4

    dev = torch.device("cuda")
    G = C // gs
    q = torch.randint(lo, hi + 1, (*lead, R, C), dtype=torch.int8, device=dev, generator=g)
    spread = (hi - lo + 1) / math.sqrt(12.0)
    s = (std / spread) * (1 + 0.1 * torch.rand((*lead, R, G), device=dev, generator=g))
    off = s * (lo + hi) / 2 if offsets else None
    qt = QuantTensor(q=q, scale=s, offset=off, fmt=_fmt_of(offsets, gs, hi, nibble), rows=R,
                     cols=C, group_size=gs)
    return pack_q4(qt) if nibble else qt  # pack_q4 packs the last axis


def _fmt_of(offsets: bool, gs: int, hi: int, nibble: bool = False):
    """The GGUF format a random grouped weight stands for (nibbles: the two
    4-bit formats, whatever the group size)."""
    from llm_inference_tpu_torch.gguf import GGMLType

    if offsets:
        return GGMLType.Q4_K
    if gs == 16 and not nibble:
        return GGMLType.Q6_K
    return GGMLType.Q4_0 if hi <= 7 else GGMLType.Q8_0


def onehot_weight(R: int, C: int, nibble: bool, gs: int, offsets: bool, device="cuda"):
    """A grouped weight (QuantTensor or Q4Tensor) for the one-hot readback:
    every row runs through all 256 int8 values (all 16 nibbles) along its
    columns, and the scales and offsets put the TPU kernels' bf16 roundings
    on ties. Scales are bf16 values with the last mantissa bit set, so q * s
    often has one bit past bf16 (a tie), and every other group's f32 scale
    lies halfway between two bf16 values (a tie in bf16(scale)); offsets the
    same at the products' magnitude, so bf16(p - o) meets ties too. Nibbles
    are centered (Q4_0) without offsets, unsigned (Q4_K) with them."""
    import torch

    from llm_inference_tpu_torch.gguf import GGMLType
    from llm_inference_tpu_torch.quant.device import QuantTensor, pack_q4

    G = C // gs
    r, c = np.arange(R)[:, None], np.arange(C)[None, :]
    if nibble:
        q = (3 * r + c) % 16 - (0 if offsets else 8)
    else:
        q = (7 * r + c) % 256 - 128
    k = np.arange(R)[:, None] * G + np.arange(G)[None, :]
    mant = 1.0 + (2 * (k % 64) + 1) / 128.0          # bf16, last mantissa bit set
    half = np.where(k % 2 == 1, 2.0 ** -8, 0.0)       # half a bf16 step: f32 ties
    s = (mant + half) * 2.0 ** -(4 + k % 5)
    qt = QuantTensor(q=torch.from_numpy(q.astype(np.int8)).to(device),
                     scale=torch.from_numpy(s.astype(np.float32)).to(device),
                     fmt=GGMLType.Q6_K if gs == 16 else GGMLType.Q8_0, rows=R, cols=C,
                     group_size=gs)
    if offsets:
        o = (1.0 + (2 * ((k * 5) % 64) + 1) / 128.0 + np.where(k % 3 == 0, 2.0 ** -8, 0.0)) \
            * 2.0 ** -(2 + k % 4)
        qt.offset = torch.from_numpy(o.astype(np.float32)).to(device)
        qt.fmt = GGMLType.Q4_K if nibble else qt.fmt
    elif nibble:
        qt.fmt = GGMLType.Q4_0
    return pack_q4(qt) if nibble else qt


def onehot_readback(fn, qt, t: int = 64):
    """fn(qt, x) over x made of unit rows, ``t`` at a time: [C, R], whose row
    c is the weight's column c as the kernel (or its plain twin) forms it."""
    import torch

    eye = torch.eye(qt.cols, device=qt.scale.device)
    return torch.cat([fn(qt, eye[c0:c0 + t]) for c0 in range(0, qt.cols, t)])


def layer_shapes(geom: dict) -> dict:
    """The four per-op projections [R, C] of a Gemma-3 geometry."""
    D, F, hd, H, Hkv = (geom[k] for k in ("n_embd", "n_ff", "head_dim", "n_head", "n_head_kv"))
    return {"wqkv": ((H + 2 * Hkv) * hd, D), "wo": (D, H * hd), "w_gate_up": (2 * F, D),
            "w_down": (D, F)}


def shard_shapes(geom: dict, n: int) -> dict:
    """Rank r's per-op projections [R, C] of a Gemma-3 geometry under
    parallel/sharding.py's gemma_sharding_fn over n ranks: the fused QKV and
    gate|up rows a rank (Q, K and V each split where its rows divide; the
    K/V rows whole where they do not), wo's and down's columns, and the lone
    K (V) shard the unfused projections give."""
    D, F, hd, H, Hkv = (geom[k] for k in ("n_embd", "n_ff", "head_dim", "n_head", "n_head_kv"))
    kv = hd * Hkv // n if (Hkv * hd) % n == 0 else hd * Hkv
    return {"wqkv": (H * hd // n + 2 * kv, D), "wk": (kv, D), "wo": (D, H * hd // n),
            "w_gate_up": (2 * F // n, D), "w_down": (D, F // n)}


def _time_grouped(fn, plain_fn, qts, x, qbytes: float) -> dict:
    """One shape's device times (cold weight copies through a CUDA graph):
    the kernel, its plain twin, torch.matmul of bf16 x on the pre-dequantized
    bf16 weights, and the bound."""
    import torch

    (T, C), R = x.shape, qts[0].rows
    ms = graph_ms(lambda i: fn(qts[i % len(qts)], x), len(qts))
    plain = graph_ms(lambda i: plain_fn(qts[i % len(qts)], x), 2)
    n_lib = min(len(qts), max(2, math.ceil(100e6 / (2 * R * C))))
    wds = [qt.dequant(torch.bfloat16) for qt in qts[:n_lib]]
    xb = x.to(torch.bfloat16)
    lib = graph_ms(lambda i: torch.matmul(xb, wds[i % len(wds)].T), len(wds))
    del wds
    nbytes = qbytes + 4 * T * C + 4 * T * R
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bound_ms(nbytes, 2 * T * R * C), "bytes": nbytes}


def _grouped_check(label: str, fn, plain_fn, qt, x) -> float:
    """The kernel against its plain twin (1e-4 * max(1, max|y|)) and a second
    launch bit-equal to the first; the error."""
    import torch

    y, ref, y2 = fn(qt, x), plain_fn(qt, x), fn(qt, x)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    if not err <= tol:
        fail(f"{label}: kernel disagrees with plain ({err} > {tol})")
    if not torch.equal(y, y2):
        fail(f"{label}: a second launch differs from the first")
    return err


def phase_grouped_matmul():
    """Phase 8: the grouped quant_matmul and q4_matmul kernels against their
    plain twins at the four 1B layer shapes, T in {1, 17, 32, 64}, over every
    variant of GROUPED_VARIANTS, each launched twice (bit-equal), and the
    one-hot readback of each variant's dequantized weight at the 1B wqkv
    shape (bit-equal to dequant_bf16_tpu); times at T = 32 and T = 1; Q4_0
    nibbles with raw f16 scales (the capacity load's) the same way, each
    call also bit-equal to the same weights with f32 scales; then Q4_0 int8
    and Q4_0 nibbles at the four Gemma-3-12B shapes (the capacity prefill's),
    checked and timed at T = 32."""
    import torch

    from llm_inference_tpu_torch.ops.kernels import qmatmul
    from llm_inference_tpu_torch.quant.device import Q4Tensor, f16_scales

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes")
    out = {}

    def run(name, nibble, gs, lo, hi, offsets, shapes, check_ts, time_ts, f16=False):
        fn = qmatmul.q4_matmul if nibble else qmatmul.quant_matmul
        plain_fn = qmatmul.q4_matmul_plain if nibble else qmatmul.quant_matmul_plain
        worst, totals = 0.0, {T: dict.fromkeys(keys, 0.0) for T in time_ts}
        for pname, (R, C) in shapes.items():
            sbytes = (2 if f16 else 4) * R * (C // gs)
            qbytes = R * C // (2 if nibble else 1) + sbytes * (2 if offsets else 1)
            n_copies = max(1, math.ceil(100e6 / qbytes))  # cold weights, as prefill finds them
            qts = [_grouped_weight(R, C, nibble, gs, lo, hi, offsets, g) for _ in range(n_copies)]
            assert isinstance(qts[0], Q4Tensor) == nibble
            if f16:  # the checkpoint's raw d: f16 planes, and an f32 twin of the first
                qts = [dataclasses.replace(q, scale=f16_scales(q.scale.half())) for q in qts]
                q32 = dataclasses.replace(qts[0], scale=qts[0].scale.float())
            for T in check_ts:
                x = torch.randn((T, C), device=dev, generator=g)
                worst = max(worst, _grouped_check(f"{fn.__name__} {name} {pname} T={T}", fn,
                                                  plain_fn, qts[0], x))
                if f16 and not torch.equal(fn(qts[0], x), fn(q32, x)):
                    fail(f"{fn.__name__} {name} {pname} T={T}: f16 scales give other sums "
                         "than their f32 values")
                if T in time_ts:
                    for k, v in _time_grouped(fn, plain_fn, qts, x, qbytes).items():
                        totals[T][k] += v
            del qts
        torch.cuda.empty_cache()
        for T, tot in totals.items():
            log(f"{fn.__name__} {name}, {len(shapes)} shapes at T={T}: kernel {tot['ms']:.4f} ms, "
                f"plain {tot['plain_ms']:.4f} ms, torch.matmul bf16 {tot['library_ms']:.4f} ms, "
                f"bound {tot['bound_ms']:.4f} ms ({tot['bytes'] / 1e6:.1f} MB)")
        return worst, totals

    shapes_1b = layer_shapes(GEOM_1B)
    for name, nibble, gs, (lo, hi), offsets in GROUPED_VARIANTS:
        worst, totals = run(name, nibble, gs, lo, hi, offsets, shapes_1b, (1, 17, 32, 64), (1, 32))
        qt = onehot_weight(*shapes_1b["wqkv"], nibble, gs, offsets)
        fn = qmatmul.q4_matmul if nibble else qmatmul.quant_matmul
        y = onehot_readback(fn, qt)
        want = qmatmul.dequant_bf16_tpu(qt.quants() if nibble else qt.q, qt).float().T
        if not torch.equal(y, want):
            fail(f"{fn.__name__} {name}: the one-hot readback differs from dequant_bf16_tpu in "
                 f"{int((y != want).sum())} of {y.numel()} weights")
        log(f"{fn.__name__} {name}: max_abs_err {worst:.3e} over 4 shapes x T in (1, 17, 32, "
            f"64) (tol 1e-4 * max(1, max|y|)), second launches bit-equal, one-hot readback "
            f"bit-equal over {y.numel()} weights")
        out[name] = dict(totals[32], err=worst, t1=totals[1])
    # row 2 with the capacity prefill's raw f16 scales:
    # held against its twin and bit-equal to the same weights' f32 scales
    name = "nibble centered (Q4_0) f16 scales"
    worst, totals = run(name, True, 32, -8, 7, False, shapes_1b, (1, 17, 32, 64), (1, 32),
                        f16=True)
    log(f"q4_matmul {name}: max_abs_err {worst:.3e}, bit-equal to its f32 scales at every T")
    out[name] = dict(totals[32], err=worst, t1=totals[1])
    t_1b = time.perf_counter() - t_start
    for name, nibble, gs, (lo, hi), offsets in GROUPED_VARIANTS:
        if "Q4_0" in name:
            worst, totals = run(name, nibble, gs, lo, hi, offsets, layer_shapes(GEOM_12B), (32,),
                                (32,))
            out["12B " + name] = dict(totals[32], err=worst)
    log(f"phase 8 parts: 1B variants {t_1b:.1f} s, 12B shapes "
        f"{time.perf_counter() - t_start - t_1b:.1f} s")
    return out


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


def hp_gemma3(*, n_layers, n_embd, n_ff, n_head, n_head_kv, head_dim, sliding_window):
    """Gemma-3 hyperparameters of a geometry (1e6 rope base, the reference's
    sliding-window pattern) over the 262144-token vocabulary."""
    from llm_inference_tpu_torch.models.hparams import load_hparams

    return load_hparams({
        "general.architecture": "gemma3", "gemma3.block_count": n_layers,
        "gemma3.embedding_length": n_embd, "gemma3.feed_forward_length": n_ff,
        "gemma3.attention.head_count": n_head, "gemma3.attention.head_count_kv": n_head_kv,
        "gemma3.attention.layer_norm_rms_epsilon": 1e-6, "gemma3.rope.freq_base": 1e6,
        "gemma3.attention.key_length": head_dim, "gemma3.attention.value_length": head_dim,
        "gemma3.attention.sliding_window": sliding_window,
        "tokenizer.ggml.tokens": ["t"] * VOCAB_SIZE})


def _hp_1b():
    """The Gemma-3-1B hyperparameters (bench.py's geometry, 128-token
    sliding window)."""
    return hp_gemma3(**GEOM_1B, sliding_window=128)


def hp_gemma4(*, n_layers, n_embd, n_ff, n_head, n_head_kv, n_embd_per_layer,
              shared_kv_layers, sliding_window, vocab_size=VOCAB_SIZE, head_dim=None):
    """gemma4 hyperparameters of a geometry (bench.py's gemma4 metadata:
    1e6 rope base, head_dim n_embd // n_head unless given) with every
    fourth layer global: layer n_kv - 1 is global and n_kv - 2 windowed, so
    the shared layers read both kinds of source (kv_source_layer)."""
    from llm_inference_tpu_torch.models.hparams import load_hparams

    dims = {} if head_dim is None else {"gemma4.attention.key_length": head_dim,
                                        "gemma4.attention.value_length": head_dim}
    return load_hparams({**dims,
        "general.architecture": "gemma4", "gemma4.block_count": n_layers,
        "gemma4.embedding_length": n_embd, "gemma4.feed_forward_length": n_ff,
        "gemma4.attention.head_count": n_head, "gemma4.attention.head_count_kv": n_head_kv,
        "gemma4.attention.layer_norm_rms_epsilon": 1e-6, "gemma4.rope.freq_base": 1e6,
        "gemma4.embedding_length_per_layer": n_embd_per_layer,
        "gemma4.attention.shared_kv_layers": shared_kv_layers,
        "gemma4.attention.sliding_window": sliding_window,
        "gemma4.attention.sliding_window_pattern": [i % 4 != 3 for i in range(n_layers)],
        "tokenizer.ggml.tokens": ["t"] * vocab_size})


def random_g4_model(hp, seed: int, device="cuda"):
    """A gemma4 model at hp's widths in stack_layers_gemma4's layout,
    per-row int8 everywhere, random from ``seed``: the shared-KV layers'
    K/V rows and scales zero, weights of spread 0.02, norms about 1,
    out_scale about 0.95, and q_norm and k_norm about G4_QK_NORM."""
    import torch

    from llm_inference_tpu_torch.models.weights import LayerWeights, ModelWeights
    from llm_inference_tpu_torch.quant.device import QuantTensor

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    L, D, F, P = hp.block_count, hp.embedding_length, hp.feed_forward_length, \
        hp.embedding_length_per_layer
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
    V = hp.vocab_size

    def qt(rows, cols, lead=(L,), std=0.02):
        q = torch.randint(-127, 128, (*lead, rows, cols), dtype=torch.int8, device=dev, generator=g)
        s = torch.full((*lead, rows, 1), std / 73.3, device=dev) * (
            1 + 0.1 * torch.rand((*lead, rows, 1), device=dev, generator=g))
        return QuantTensor(q=q, scale=s, fmt=None, rows=rows, cols=cols)

    def norm(*shape):
        return 1.0 + 0.1 * torch.randn(shape, device=dev, generator=g)

    wqkv = qt(H * dk + Hkv * (dk + dv), D)
    shared = [i for i in range(L) if not hp.layer_has_kv(i)]
    wqkv.q[shared, H * dk:] = 0
    wqkv.scale[shared, H * dk:] = 0
    layers = LayerWeights(
        attn_norm=norm(L, D), ffn_norm=norm(L, D), q_norm=G4_QK_NORM * norm(L, dk),
        k_norm=G4_QK_NORM * norm(L, dk), post_attn_norm=norm(L, D), post_ffw_norm=norm(L, D),
        wqkv=wqkv, wo=qt(D, H * dv),
        w_gate_up=qt(2 * F, D), w_down=qt(D, F), per_layer_inp_gate=qt(P, D),
        per_layer_proj=qt(D, P), per_layer_post_norm=norm(L, D),
        out_scale=0.95 + 0.05 * torch.rand((L, 1), device=dev, generator=g))
    return ModelWeights(token_embd=qt(V, D, lead=()), output_norm=norm(D), layers=layers,
                        token_embd_per_layer=qt(V, L * P, lead=()),
                        per_layer_model_proj=qt(L * P, D, lead=()), per_layer_proj_norm=norm(P))


def rowq8_step_work(hp, pos: int) -> tuple[float, float, float]:
    """Bytes, bf16 tensor-core operations and f32 CUDA-core operations of
    one Gemma-3 rowq8 step at ``pos``: every int8 weight and its f32 row
    scale once, the norms (post norms and Q/K norms), each layer's live K/V
    rows [0, pos] (the written one included) and the [V] f32 logits; the
    products on the tensor cores (exact bf16 operands), attention's on the
    CUDA cores."""
    L, D, F, V = hp.block_count, hp.embedding_length, hp.feed_forward_length, hp.vocab_size
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
    Rq, A, kvrow = H * dk + Hkv * (dk + dv), H * dv, Hkv * (dk + dv) * 2
    wbytes = L * (Rq * D + D * A + 2 * F * D + D * F) + V * D
    sbytes = 4 * (L * (Rq + D + 2 * F + D) + V)
    nbytes = wbytes + sbytes + 4 * (L * (4 * D + 2 * dk) + D) + L * (pos + 1) * kvrow + 4 * V
    return nbytes, 2 * wbytes, 2 * L * H * (pos + 1) * (dk + dv)


def g4_step_bytes(hp, pos: int) -> tuple[float, float]:
    """Bytes and f32 CUDA-core operations of one gemma4 rowq8 step at
    ``pos``: every int8 weight row the step needs and its row scale once (a
    shared-KV layer's Q rows only: the zero K/V rows the kernel streams for
    the padded layout are its overhead, not the function's), the token's
    per-layer embedding row, norms, the owner layers' live K/V rows [0, pos]
    and the written rows, the logits."""
    L, D, F, P = hp.block_count, hp.embedding_length, hp.feed_forward_length, \
        hp.embedding_length_per_layer
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
    V, n_kv = hp.vocab_size, hp.n_kv_layers
    A = H * dv
    q_rows = n_kv * (H * dk + Hkv * (dk + dv)) + (L - n_kv) * H * dk  # QKV, or Q alone
    rows = q_rows + L * (D + 2 * F + D + P + D) + V + L * P  # every weight row, model proj too
    params = q_rows * D + L * (D * A + 2 * F * D + D * F + 2 * P * D) + V * D + L * P * D
    nbytes = (params + 4 * rows + (L * P + 4) + 4 * (L * (6 * D + 2 * dk + 1) + D + P)
              + n_kv * (pos + 2) * Hkv * (dk + dv) * 2 + 4 * V)
    ops = 2 * params + 2 * L * H * (pos + 1) * (dk + dv)
    return nbytes, ops


def tp_step_bytes(hp, tw, pos: int) -> tuple[float, float]:
    """Bytes and f32 CUDA-core operations of one tensor-parallel step of
    ``tw``'s n ranks on one card at ``pos``: every rank's shard once (its
    quants, scales and offsets, its embedding rows, the zero padding it
    holds), every rank's norms, n times the live K/V rows [0, pos] and the
    written row (each rank reads its own replica), the [V] f32 logits. On n
    distinct cards the bound would be per card: one rank's share."""
    g = tw.geom
    L, D, Hl, Hkv, dk, dv = g["L"], g["D"], g["Hl"], g["Hkv"], g["dk"], g["dv"]
    nbytes, ops = 4.0 * g["V"], 0.0
    for rw in tw.ranks:
        lw = rw.layers
        for t in (lw.wqkv, lw.wo, lw.w_gate_up, lw.w_down, rw.token_embd):
            for k in ("q", "packed", "scale", "offset", "w"):
                x = getattr(t, k, None)
                if x is not None:
                    nbytes += x.numel() * x.element_size()
            ops += 2 * t.rows * t.cols * (1 if t is rw.token_embd else L)
        nbytes += 4 * (L * (4 * D + 2 * dk) + D) + L * (pos + 2) * Hkv * (dk + dv) * 2
        ops += 2 * L * Hl * (pos + 1) * (dk + dv)
    return nbytes, ops


def check_g4_step(label: str, hp, w, cache, token, p, consts) -> tuple[float, float]:
    """The gemma4 whole step against its plain twin: phase 4's bars through
    _check_step_q, the planted fault in layer n_kv - 2 (the windowed source
    the shared layers read), and the kernel's cache a view of the n_kv
    owner layers of a tensor with as many more layers as there are shared
    ones, where a shared layer's cache would stand: those stay untouched."""
    from llm_inference_tpu_torch.ops.kernels import fused_decode

    return _check_step_q(label, hp, w, cache, token, p, consts, step=fused_decode.decode_step,
                         plain=fused_decode.decode_step_plain, fault_layer=hp.n_kv_layers - 2,
                         guard_layers=hp.block_count - hp.n_kv_layers)


def phase_decode_step():
    import torch

    from llm_inference_tpu_torch.models.gemma import init_cache
    from llm_inference_tpu_torch.ops.kernels import fused_decode

    hp = _hp_1b()
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
        y_again = fused_decode.decode_step(hp, w, type(cache)(k=cache.k.clone(), v=cache.v.clone()),
                                           token, p, consts)
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
        if not torch.equal(y, y_again):
            fail(f"decode_step swa={swa}: a second launch gives other logits")
        worst = max(worst, err)
        del ck, cp
    (plan, _), = consts.scratch["plans"].values()
    log(f"decode_step: a second launch bit-equal; tile plan {plan}")
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
    nbytes, bf16_ops, f32_ops = rowq8_step_work(hp, pos)
    b = bound_ms(nbytes, bf16_ops, f32_ops)
    log(f"decode_step 1B pos={pos}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms "
        f"({nbytes / 1e9:.4f} GB)")
    del w, cache
    torch.cuda.empty_cache()
    return worst, {"ms": ms, "plain_ms": plain, "library_ms": None, "bound_ms": b,
                   "bound_by": bound_by(nbytes, bf16_ops, f32_ops)}


def _random_lossless_model(hp, seed: int, nibble: bool, variant: tuple | None = None):
    """Stacked group-scaled weights at hp's widths, random from ``seed``, and
    a bf16 embedding: serve-q int8 (Q8_0-like quants) or serve-q4 nibbles
    with Q4_K offsets; the down projection Q6_K-like int8 in 16-column
    groups either way, as a Q4_K_M checkpoint mixes them. ``variant`` (a
    GROUPED_VARIANTS entry): every projection in it instead."""
    import torch

    from llm_inference_tpu_torch.gguf import GGMLType
    from llm_inference_tpu_torch.models.weights import LayerWeights, ModelWeights
    from llm_inference_tpu_torch.quant.device import DenseTensor

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    L, D, F = hp.block_count, hp.embedding_length, hp.feed_forward_length
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
    variants = {v[0]: v[1:] for v in GROUPED_VARIANTS + ((variant,) if variant else ())}
    main = variant[0] if variant else ("nibble offsets (Q4_K)" if nibble else "int8 gs32 (Q8_0)")

    def part(name, R, C):
        nib, gs, (lo, hi), off = variants[name]
        return _grouped_weight(R, C, nib, gs, lo, hi, off, g, lead=(L,))

    def norm(*shape):
        return 1.0 + 0.1 * torch.randn(shape, device=dev, generator=g)

    layers = LayerWeights(
        attn_norm=norm(L, D), ffn_norm=norm(L, D), q_norm=norm(L, dk), k_norm=norm(L, dk),
        post_attn_norm=norm(L, D), post_ffw_norm=norm(L, D),
        wqkv=part(main, H * dk + Hkv * (dk + dv), D), wo=part(main, D, H * dv),
        w_gate_up=part(main, 2 * F, D), w_down=part(variant[0] if variant else "int8 gs16 (Q6_K)",
                                                    D, F))
    emb = DenseTensor(w=(0.02 * torch.randn((VOCAB_SIZE, D), device=dev, generator=g)).to(
        torch.bfloat16), fmt=GGMLType.BF16, rows=VOCAB_SIZE, cols=D)
    return ModelWeights(token_embd=emb, output_norm=norm(D), layers=layers)


def _lossless_bytes(hp, w, pos: int) -> tuple[float, float]:
    """Bytes and f32 CUDA-core operations of one lossless step at ``pos``:
    every quant, scale and offset once, the bf16 embedding rows, norms, the
    live K/V rows [0, pos] and the written row, the logits."""
    lw = w.layers
    L, D, V = hp.block_count, hp.embedding_length, VOCAB_SIZE
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
    nbytes, params = 0.0, 0.0
    for t in (lw.wqkv, lw.wo, lw.w_gate_up, lw.w_down):
        data = t.packed if hasattr(t, "packed") else t.q
        nbytes += data.numel() + t.scale.element_size() * t.scale.numel() + (
            4 * t.offset.numel() if t.offset is not None else 0)
        params += L * t.rows * t.cols
    nbytes += 2 * V * D + 4 * (L * (4 * D + 2 * dk) + D) + L * (pos + 2) * Hkv * (dk + dv) * 2 + 4 * V
    ops = 2 * (params + V * D) + 2 * L * H * (pos + 1) * (dk + dv)
    return nbytes, ops


def _check_step_q(label: str, hp, w, cache, token, p, consts, step=None,
                  plain=None, fault_layer: int | None = None,
                  guard_layers: int = 0) -> tuple[float, float]:
    """The lossless step (or the capacity one: ``step``, ``plain``) against
    its plain twin on one set of weights (phases 9 and 13); fails on a
    disagreement or on a second launch that is not bit-equal. Logits within
    1.5e-2 * max(1, max|logits|) (tests/test_fused_decode_q.py's bar),
    equal argmax if the plain top-2 gap exceeds twice that bar, layer 0's
    K/V row within one bf16 step, every layer's within the logits' bar, no
    other row touched. A planted fault (layer FAULT_LAYER's cached V zeroed
    in the plain step) must leave the bar. ``guard_layers``: the kernel's
    cache is a view of a tensor with that many more layers of sentinel
    values past it, which must stay untouched. Returns (max_abs_err, the
    fault's err / max(1, max|logits|)).
    """
    import torch

    from llm_inference_tpu_torch.ops.kernels import fused_decode_q

    step = step or fused_decode_q.decode_step_q
    plain = plain or fused_decode_q.decode_step_q_plain
    fault_layer = FAULT_LAYER if fault_layer is None else fault_layer
    what = step.__name__
    pos = int(p.item())
    n = cache.k.shape[0]
    big = [torch.full((n + guard_layers, *t.shape[1:]), 7.0, dtype=t.dtype, device=t.device)
           for t in (cache.k, cache.v)]
    big[0][:n], big[1][:n] = cache.k, cache.v
    ck = type(cache)(k=big[0][:n], v=big[1][:n])
    cp = type(cache)(k=cache.k.clone(), v=cache.v.clone())
    cf = type(cache)(k=cache.k.clone(), v=cache.v.clone())
    cf.v[fault_layer].zero_()
    y = step(hp, w, ck, token, p, consts)
    y_again = step(hp, w, type(cache)(k=cache.k.clone(), v=cache.v.clone()), token, p, consts)
    ref = plain(hp, w, cp, token, p, consts)
    faulted = plain(hp, w, cf, token, p, consts)
    del cf
    torch.cuda.synchronize()
    scale = max(1.0, ref.abs().max().item())
    err = (y - ref).abs().max().item()
    tol = 1.5e-2 * scale
    fault = (faulted - ref).abs().max().item() / scale
    top2 = ref.topk(2).values
    decisive = (top2[0] - top2[1]).item() > 2 * tol
    argmax_ok = int(y.argmax()) == int(ref.argmax())
    kv0 = max(((ck.k[0, pos].float() - cp.k[0, pos].float()).abs()
               / (cp.k[0, pos].float().abs() + 1e-3)).max().item(),
              ((ck.v[0, pos].float() - cp.v[0, pos].float()).abs()
               / (cp.v[0, pos].float().abs() + 1e-3)).max().item())
    kv_all = max((ck.k[:, pos].float() - cp.k[:, pos].float()).abs().max().item(),
                 (ck.v[:, pos].float() - cp.v[:, pos].float()).abs().max().item())
    kv_tol = 1.5e-2 * max(1.0, cp.k[:, pos].float().abs().max().item(),
                          cp.v[:, pos].float().abs().max().item())
    if guard_layers:  # per-layer growth of the written rows' error (gemma4's owner layers)
        rows = (ck.k[:, pos].float() - cp.k[:, pos].float()).abs().flatten(1).amax(dim=1)
        log(f"{what} {label}: written K row max_abs_err by layer "
            + ", ".join(f"{e:.2e}" for e in rows.tolist()))
    untouched = bool(torch.equal(ck.k[:, :pos], cache.k[:, :pos])
                     and torch.equal(ck.k[:, pos + 1:], cache.k[:, pos + 1:])
                     and torch.equal(ck.v[:, :pos], cache.v[:, :pos])
                     and bool((big[0][n:] == 7.0).all()) and bool((big[1][n:] == 7.0).all()))
    log(f"{what} {label}: logits err/max(1,max|logits|) {err / scale:.3e} (bar 1.5e-2), "
        f"argmax {int(y.argmax())} vs {int(ref.argmax())} (top-2 gap "
        f"{(top2[0] - top2[1]).item():.3e}, decisive {decisive}); layer-0 K/V row max_rel_err "
        f"{kv0:.3e} (tol {2 ** -7:.3e}), all K/V rows max_abs_err {kv_all:.3e} (tol "
        f"{kv_tol:.3e}); planted fault (layer {fault_layer}'s V zeroed) moves the plain logits "
        f"by {fault:.3e}")
    if not err <= tol or (decisive and not argmax_ok):
        fail(f"{what} {label}: kernel logits disagree with plain")
    if not kv0 <= 2 ** -7 or not kv_all <= kv_tol or not untouched:
        fail(f"{what} {label}: K/V cache write disagrees with plain")
    if pos > 0 and not fault > 1.5e-2:  # at pos 0 no cached row is read
        fail(f"{what} {label}: the planted fault stays inside the bar")
    if not torch.equal(y, y_again):
        fail(f"{what} {label}: a second launch gives other logits")
    return err, fault


def _step_profile(what: str, step, hp, prof_len: int, n: int = 20,
                  gemma4: bool = False) -> dict:
    """Block 0's globaltimer at each phase boundary of a whole step (the
    ``profile`` argument of fused_decode.decode_step / decode_step_q),
    averaged over ``n`` launches and the layers; returns {phase: us}."""
    import torch

    from llm_inference_tpu_torch.ops.kernels import fused_decode

    L = hp.block_count
    marks = fused_decode.PROFILE_MARKS_G4 if gemma4 else fused_decode.PROFILE_MARKS
    prof = torch.zeros(prof_len, dtype=torch.int64, device="cuda")
    names = ["norm+QKV", "barrier", "qk-norm+rope+scores", "max barrier", "softmax+PV",
             "barrier", "combine+Wo", "barrier", "norm+gate/up", "barrier", "down", "barrier"]
    if gemma4:
        names += ["residual+inp+per-layer gate", "barrier", "per-layer proj", "barrier"]
    acc, edge = np.zeros(len(names)), np.zeros(3)
    for _ in range(n):
        step(prof)
        t = prof.cpu().numpy().astype(np.float64)
        per = t[1 : 1 + L * marks].reshape(L, marks)
        acc += np.diff(per, axis=1).mean(axis=0)
        edge += [t[1] - t[0], t[1 + L * marks] - per[-1, -1], t[2 + L * marks] - t[1 + L * marks]]
    acc, edge = acc / n / 1e3, edge / n / 1e3
    log(f"{what} phases (us, block 0, mean per layer): "
        + ", ".join(f"{nm} {v:.2f}" for nm, v in zip(names, acc))
        + f"; per layer {acc.sum():.2f}; start {edge[0]:.2f}, final norm {edge[1]:.2f}, "
        f"logits {edge[2]:.2f}")
    out = dict(zip(names, acc.tolist()))
    out.update({"per layer": float(acc.sum()), "start": edge[0], "final norm": edge[1],
                "logits": edge[2]})
    return out


def phase_lossless_step():
    """Phase 9: the lossless whole step against its plain twin at full 1B
    width and depth, one step at position 300 over seeded K/V rows, with
    and without sliding windows, on random serve-q int8 weights, random
    serve-q4 nibble weights with offsets, and the tame checkpoint's weights
    in both modes; times, bound and per-phase profile."""
    import torch

    from llm_inference_tpu_torch.gguf import GGUFFile
    from llm_inference_tpu_torch.models.gemma import init_cache
    from llm_inference_tpu_torch.models.weights import fuse_projections, load_weights, stack_layers
    from llm_inference_tpu_torch.ops.kernels import fused_decode, fused_decode_q

    hp_r = _hp_1b()
    dev = torch.device("cuda")
    S, pos = 1024, 300
    g = torch.Generator(device=dev).manual_seed(6)
    cache = init_cache(hp_r, S, device=dev)
    cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
    token = torch.tensor([12345], dtype=torch.int64, device=dev)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    worst, out = 0.0, {}
    sets = [("random serve-q int8", False, None), ("random serve-q4 nibble+offsets", True, None),
            ("tame serve-q", None, "packed-serve"), ("tame serve-q4", None, "packed-q4")]
    for label, nibble, load_mode in sets:
        if load_mode is None:
            hp, w = hp_r, _random_lossless_model(hp_r, seed=7, nibble=nibble)
        else:
            hp, w = load_weights(GGUFFile(str(tame_checkpoint())), mode=load_mode, device=dev)
            w = fuse_projections(w)
            w = dataclasses.replace(w, layers=stack_layers(w.layers))
        if not fused_decode_q.decode_q_supported(hp, w):
            fail(f"decode_step_q: the {label} weights are not eligible")
        for swa in (False, True):
            consts = fused_decode_q.prepare(hp, dev, swa_mask=swa, max_seq=S)
            err, fault = _check_step_q(f"{label} swa={swa}", hp, w, cache, token, p, consts)
            worst = max(worst, err)
        (plan, _), = consts.scratch["plans"].values()
        log(f"decode_step_q {label}: tile plan {plan}")
        consts = fused_decode_q.prepare(hp, dev, swa_mask=False, max_seq=S)
        ms = time_ms(lambda i=0: fused_decode_q.decode_step_q(hp, w, cache, token, p, consts), 50)
        plain = time_ms(lambda i=0: fused_decode_q.decode_step_q_plain(
            hp, w, cache, token, p, consts), 3, warmup=1)
        nbytes, ops = _lossless_bytes(hp, w, pos)
        b = bound_ms(nbytes, f32_ops=ops)
        log(f"decode_step_q {label} 1B pos={pos}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {b:.4f} ms ({nbytes / 1e9:.4f} GB, {ops / 1e9:.2f} GFLOP f32)")
        _step_profile(f"decode_step_q {label}", lambda prof: fused_decode_q.decode_step_q(
            hp, w, cache, token, p, consts, profile=prof), hp,
            hp.block_count * fused_decode.PROFILE_MARKS + 3)
        out[label] = dict(ms=ms, plain_ms=plain, bound_ms=b, bytes=nbytes,
                          bound_by=bound_by(nbytes, f32_ops=ops))
        del w
        torch.cuda.empty_cache()
    del cache
    torch.cuda.empty_cache()
    return worst, out


def _single_counts() -> dict:
    """The launch counts of the single-stream path's kernels."""
    from llm_inference_tpu_torch.ops.kernels import (fused_decode, fused_decode_q,
                                                     fused_decode_stream, qmatmul)

    return {"quant_matmul": qmatmul.launches, "quant_matmul_grouped": qmatmul.grouped_launches,
            "q4_matmul": qmatmul.q4_launches, "decode_step": fused_decode.launches,
            "decode_step_q": fused_decode_q.launches,
            "decode_step_stream": fused_decode_stream.launches}


def _zero_single_counts() -> None:
    from llm_inference_tpu_torch.ops.kernels import (fused_decode, fused_decode_q,
                                                     fused_decode_stream, qmatmul)

    qmatmul.launches = qmatmul.grouped_launches = qmatmul.q4_launches = 0
    fused_decode.launches = fused_decode_q.launches = fused_decode_stream.launches = 0


def _single_want(mode: str, route: str, L: int, steps: int) -> dict:
    """The launches a serve-q / serve-q4 run of ``steps`` decode steps must
    count: the kernel route one lossless step a step (its prefill runs plain
    GEMMs on the bf16 operand cache), the capacity route one capacity step a
    step and 4 x L grouped kernels in the prefill, the per-op route 4 x L a
    prefill and a step."""
    want = {k: 0 for k in _single_counts()}
    per_op = "q4_matmul" if mode == "serve-q4" else "quant_matmul_grouped"
    if route == "kernel":
        want["decode_step_q"] = steps
    elif route == "capacity":
        want["decode_step_stream"] = steps
        want[per_op] = 4 * L
    else:
        want[per_op] = 4 * L * (steps + 1)
    return want


def phase_lossless_slice():
    """Phase 10: the tame 1B checkpoint under Engine(mode="serve-q") and
    Engine(mode="serve-q4"), each on both decode routes (the per-op one
    forced with LLMI_NO_FUSED_DECODE=1): 100 greedy tokens equal to the
    golden stream, and the launch counts of the route's kernels."""
    import os

    import torch

    from llm_inference_tpu_torch.engine import Engine, GenerationStats

    golden = json.loads((ROOT / "tests" / "golden" / "parity_1b_tame.json").read_text())
    path = tame_checkpoint()
    prompt, steps = golden["prompt"], golden["steps"]
    L = GEOM_1B["n_layers"]
    results = {}
    for mode in ("serve-q", "serve-q4"):
        for route in ("kernel", "per-op"):
            if route == "per-op":
                os.environ["LLMI_NO_FUSED_DECODE"] = "1"  # the JAX package's own switch
            try:
                t0 = time.perf_counter()
                eng = Engine(str(path), mode=mode, max_seq=1024, decode_chunk=16, device="cuda")
            finally:
                os.environ.pop("LLMI_NO_FUSED_DECODE", None)
            torch.cuda.synchronize()
            if eng.decode_route != route:
                fail(f"{mode}: expected the {route} route, got {eng.decode_route}")
            eng.tokenizer.eos_id = -1  # random weights may argmax onto <eos>: never stop early
            eng.tokenizer.end_of_turn_id = -1
            eng.generate_from_ids(prompt, n_predict=8)  # warm-up
            log(f"{mode} {route}: Engine load + warm-up {time.perf_counter() - t0:.1f} s")
            _zero_single_counts()
            stats = GenerationStats()
            out = eng.generate_from_ids(prompt, n_predict=steps, stats=stats)
            torch.cuda.synchronize()
            counts = _single_counts()
            n_match = next((i for i, (a, b) in enumerate(zip(out, golden["tokens"])) if a != b),
                           min(len(out), len(golden["tokens"])))
            log(f"{mode} {route}: {n_match}/{steps} tokens match the golden stream; launches "
                f"{counts}; decode steps {stats.decode_steps}")
            if out != golden["tokens"][:steps] or len(out) != steps:
                fail(f"{mode} {route}: the greedy stream diverges from the golden stream at "
                     f"token {n_match}: {out[:12]}... vs {golden['tokens'][:12]}...")
            n = stats.decode_steps
            want = _single_want(mode, route, L, n)
            if n == 0 or counts != want:
                fail(f"{mode} {route}: launches {counts}, expected {want}")
            ttfts = [stats.prefill_seconds]
            for _ in range(6):
                s1 = GenerationStats()
                eng.generate_from_ids(prompt, n_predict=1, stats=s1)
                ttfts.append(s1.prefill_seconds)
            perf = dict(decode_tok_s=stats.decode_tok_per_s, ttft_ms=float(np.median(ttfts)) * 1e3,
                        counts=counts, decode_steps=n)
            log(f"{mode} {route}: decode {perf['decode_tok_s']:.2f} tok/s, TTFT (median of seven) "
                f"{perf['ttft_ms']:.2f} ms; TTFTs (ms) {', '.join(f'{t * 1e3:.2f}' for t in ttfts)}")
            results[(mode, route)] = perf
            del eng
            torch.cuda.empty_cache()
    return results


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


BATCH, BATCH_SEQ = 32, 1024


def _batch_positions(S: int) -> list[int]:
    """28 live lanes ragged over 0..1000 and four parked lanes (pos = S)."""
    live = BATCH - 4
    return [round(b * 1000 / (live - 1)) for b in range(live)] + [S] * 4


def _step_bound(hp, positions, S) -> tuple[float, float, float]:
    """Bytes, bf16 tensor-core operations (the projections) and f32
    CUDA-core operations (attention) of one batched step at these positions:
    every weight, scale and norm once, each lane's live K/V rows [0, pos] (a
    parked lane reads its row 0), the written rows, ids in and out."""
    L, D, F, V = hp.block_count, hp.embedding_length, hp.feed_forward_length, VOCAB_SIZE
    H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
    Rq, A = H * dk + Hkv * (dk + dv), H * dv
    kvrow = Hkv * (dk + dv) * 2
    slots = sum(p + 1 if p < S else 1 for p in positions)
    B = len(positions)
    wparams = L * (Rq * D + D * A + 2 * F * D + D * F) + V * D
    nbytes = (wparams + 4 * (L * (Rq + D + 2 * F + D) + V) + 4 * (L * (4 * D + dk + dk) + D)
              + L * slots * kvrow + L * B * kvrow + 3 * 4 * B)
    return nbytes, 2 * B * wparams, 2 * L * slots * H * (dk + dv)


def _profile_kernels(what: str, fn, calls: int, top: int = 12) -> None:
    """Device time per call of each CUDA kernel ``fn`` launches
    (torch.profiler), the largest first, and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / calls

    def dev_us(e):
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))

    # device-side events only (kernels, copies): CPU ops carry their children's time too
    evs = [e for e in prof.key_averages()
           if dev_us(e) > 0 and str(getattr(e, "device_type", "")).endswith("CUDA")]
    evs = sorted(evs, key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in evs) / calls / 1e3
    log(f"{what} profile: {busy:.4f} ms of kernels a call in {wall:.4f} ms of wall time (under the "
        f"profiler); " + "; ".join(f"{e.key[:60]} x{e.count // calls} {dev_us(e) / calls:.1f} us"
                                   for e in evs[:top]))


FAULT_LAYER = 13  # the planted fault: this layer's cached V rows zeroed (phase 6)


def _check_batched_step(label: str, hp, w, cache, tokens, pos, consts) -> float:
    """The batched step against its plain twin on one set of weights (phase
    6); fails on a disagreement and returns the logits' max_abs_err.

    Logits: within 1.5e-2 * max(1, max|logits|) per lane. Argmax: equal on
    every lane whose plain top-2 gap exceeds twice that bar (a closer pair
    may swap within the bar); the greedy ids equal the argmax of the
    kernel's own logits on every lane. The plain step is also run with one
    planted fault (layer FAULT_LAYER's cached V rows zeroed, so its
    attention reads only the written row) and must leave the bar on some
    lane, so the bar can see a fault in one layer's attention."""
    import torch

    from llm_inference_tpu_torch.models import gemma
    from llm_inference_tpu_torch.ops.kernels import fused_decode_batch

    B, S = tokens.shape[0], cache.k.shape[2]
    dev = tokens.device

    def copy():
        return gemma.BatchedKVCache(k=cache.k.clone(), v=cache.v.clone())

    ck, cp, cf = copy(), copy(), copy()
    y = fused_decode_batch.decode_step_batch(hp, w, ck, tokens, pos, consts)
    if not torch.equal(y, fused_decode_batch.decode_step_batch(hp, w, copy(), tokens, pos, consts)):
        fail(f"decode_step_batch {label}: a second launch gives other logits")
    ref = fused_decode_batch.decode_step_batch_plain(hp, w, cp, tokens, pos, consts)
    ids = fused_decode_batch.decode_step_batch(hp, w, copy(), tokens, pos, consts, greedy=True)
    cf.v[FAULT_LAYER].zero_()
    faulted = fused_decode_batch.decode_step_batch_plain(hp, w, cf, tokens, pos, consts)
    del cf
    torch.cuda.synchronize()
    err = _step_verdict("decode_step_batch", label, y, ref, ids, faulted)
    p = fused_decode_batch.clamp_positions(pos, S).long()
    rows = torch.arange(B, device=dev) * S + p  # each lane's written row, parked ones at 0

    def flat(t):
        return t.view(t.shape[0], B * S, *t.shape[3:])

    _kv_verdict("decode_step_batch", label, (flat(ck.k), flat(ck.v)), (flat(cp.k), flat(cp.v)),
                (flat(cache.k), flat(cache.v)), rows)
    return err


def _kv_verdict(what: str, label: str, got, ref, orig, rows, exempt=None) -> None:
    """The written K/V rows of a batched step (phases 6 and 11): ``got``,
    ``ref`` and ``orig`` are (k, v) pairs of [L, R, Hkv, d] row views (the
    kernel's, the plain twin's, the state before), ``rows`` the rows the
    step writes. Layer 0's rows within one bf16 step of the plain twin's,
    every layer's within 1.5e-2 * max(1, max|row|), and every other row,
    save the ``exempt`` mask's, untouched."""
    import torch

    kv0 = max(((g[0, rows].float() - r[0, rows].float()).abs()
               / (r[0, rows].float().abs() + 1e-3)).max().item() for g, r in zip(got, ref))
    kv_all = max((g[:, rows].float() - r[:, rows].float()).abs().max().item()
                 for g, r in zip(got, ref))
    kv_tol = 1.5e-2 * max(1.0, *(r[:, rows].float().abs().max().item() for r in ref))
    untouched = torch.ones(got[0].shape[1], dtype=torch.bool, device=rows.device)
    untouched[rows] = False
    if exempt is not None:
        untouched &= ~exempt
    kept = all(torch.equal(g[:, untouched], o[:, untouched]) for g, o in zip(got, orig))
    log(f"{what} {label}: layer-0 K/V rows max_rel_err {kv0:.3e} (tol {2 ** -7:.3e}), all K/V "
        f"rows max_abs_err {kv_all:.3e} (tol {kv_tol:.3e}), other rows untouched {kept}")
    if not kv0 <= 2 ** -7 or not kv_all <= kv_tol or not kept:
        fail(f"{what} {label}: K/V cache writes disagree with plain")


def _step_verdict(what: str, label: str, y, ref, ids, faulted) -> float:
    """The batched steps' logits verdict (phases 6 and 11): each lane within
    1.5e-2 * max(1, max|logits|); equal argmax on every lane whose plain
    top-2 gap exceeds twice that bar; greedy ids equal to the argmax of the
    kernel's logits; the planted fault out of the bar on some lane. Fails on
    a miss; returns the logits' max_abs_err."""
    B = y.shape[0]
    tol = 1.5e-2 * ref.abs().amax(dim=-1).clamp(min=1.0)  # [B]
    err = (y - ref).abs().amax(dim=-1)
    fault = (faulted - ref).abs().amax(dim=-1)
    top2 = ref.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    decisive = gap > 2 * tol
    am_y, am_ref = y.argmax(dim=-1), ref.argmax(dim=-1)
    argmax_ok = bool((am_y == am_ref)[decisive].all())
    ids_ok = bool((ids == am_y.to(ids.dtype)).all())
    # how wide the bar is against the logits' own spread (lane median)
    spread = (tol / ref.std(dim=-1)).median().item()
    ratio = (err / tol).max().item() * 1.5e-2
    fault_ratio = fault / tol * 1.5e-2
    log(f"{what} {label} B={B}: logits max_abs_err {err.max().item():.3e}, worst lane "
        f"err/max(1,max|logits|) {ratio:.3e} (bar 1.5e-2; the bar is {spread:.2f} logit standard "
        f"deviations), {int(decisive.sum())}/{B} lanes with a top-2 gap above twice the bar, "
        f"argmax equal on them {argmax_ok}, on all lanes {int((am_y == am_ref).sum())}/{B}, "
        f"greedy ids equal the kernel logits' argmax {ids_ok}")
    log(f"{what} {label}: planted fault (layer {FAULT_LAYER}'s V rows zeroed) moves "
        f"the plain logits by err/max(1,max|logits|) {fault_ratio.min().item():.3e} (least "
        f"lane) to {fault_ratio.max().item():.3e}; {int((fault > tol).sum())}/{B} lanes leave "
        f"the bar")
    for b in (am_y != am_ref).nonzero().flatten().tolist():
        log(f"{what} {label} lane {b}: argmax {int(am_y[b])} vs plain {int(am_ref[b])}, "
            f"plain top-2 gap {gap[b].item():.3e}, lane err {err[b].item():.3e}, bar "
            f"{tol[b].item():.3e}")
    if not bool((err <= tol).all()) or not argmax_ok or not ids_ok:
        fail(f"{what} {label}: kernel logits or greedy ids disagree with plain")
    if not bool((fault > tol).any()):
        fail(f"{what} {label}: the planted fault stays inside the bar")
    return err.max().item()


def phase_batched_kernels():
    """Phase 6: the batched step, flash_decode and insert_rows against their
    plain twins at the 1B serving shapes."""
    import torch

    from llm_inference_tpu_torch.gguf import GGUFFile
    from llm_inference_tpu_torch.models import gemma
    from llm_inference_tpu_torch.models.weights import fuse_projections, load_weights, stack_layers
    from llm_inference_tpu_torch.ops.kernels import flash_decode, fused_decode_batch, kv_insert

    dev = torch.device("cuda")
    B, S = BATCH, BATCH_SEQ
    g = torch.Generator(device=dev).manual_seed(4)
    positions = _batch_positions(S)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    tokens = torch.randint(0, VOCAB_SIZE, (B,), device=dev, generator=g, dtype=torch.int32)
    log(f"decode_step_batch B={B}: positions {positions[0]}..{max(positions[:-4])}, 4 parked")
    out = {}

    # -- the batched whole step, on two sets of weights: uniform random int8
    # (phase 4's; they spread the logits) and the tame checkpoint's (the
    # weights phase 7 serves; contractive, one logit far above the rest)
    hp_r = _hp_1b()
    w_r = _random_model(hp_r, seed=2)
    cache = gemma.init_batched_cache(hp_r, B, S, device=dev)
    cache.k.copy_(torch.randn(cache.k.shape, device=dev, generator=g))
    cache.v.copy_(torch.randn(cache.v.shape, device=dev, generator=g))
    if not fused_decode_batch.batch_supported(hp_r, w_r, batch=B, max_seq=S):
        fail("decode_step_batch: the 1B-shaped random model is not eligible")
    consts_r = fused_decode_batch.prepare_batch(hp_r, dev, batch=B, max_seq=S)
    err = _check_batched_step("random weights", hp_r, w_r, cache, tokens, pos, consts_r)
    del w_r, consts_r
    torch.cuda.empty_cache()
    hp, w = load_weights(GGUFFile(str(tame_checkpoint())), mode="rowq8", device=dev)
    w = fuse_projections(w)
    w = dataclasses.replace(w, layers=stack_layers(w.layers))
    if not fused_decode_batch.batch_supported(hp, w, batch=B, max_seq=S):
        fail("decode_step_batch: the tame 1B checkpoint is not eligible")
    consts = fused_decode_batch.prepare_batch(hp, dev, batch=B, max_seq=S)
    log(f"decode_step_batch plan: {consts.plan}")
    err = max(err, _check_batched_step("tame weights", hp, w, cache, tokens, pos, consts))
    torch.cuda.empty_cache()

    def step(i=0):
        return fused_decode_batch.decode_step_batch(hp, w, cache, tokens, pos, consts, greedy=True)

    eager = time_ms(step, 20)
    ms = graph_ms(step, 4, replays=10)
    plain = time_ms(lambda i=0: fused_decode_batch.decode_step_batch_plain(
        hp, w, cache, tokens, pos, consts, greedy=True), 2, warmup=1)
    work = _step_bound(hp, positions, S)
    b = bound_ms(*work)
    pos300 = torch.full((B,), 300, dtype=torch.int32, device=dev)
    ms300 = graph_ms(lambda i=0: fused_decode_batch.decode_step_batch(
        hp, w, cache, tokens, pos300, consts, greedy=True), 4, replays=10)
    work300 = _step_bound(hp, [300] * B, S)
    log(f"decode_step_batch B={B} ragged: device {ms:.4f} ms (CUDA graph), eager {eager:.4f} ms "
        f"(host issue of the step's kernels included), plain {plain:.4f} ms, bound {b:.4f} ms "
        f"({work[0] / 1e9:.4f} GB, {work[1] / 1e9:.1f} GFLOP bf16, {work[2] / 1e9:.2f} GFLOP "
        f"f32); all lanes at pos 300: device {ms300:.4f} ms, bound {bound_ms(*work300):.4f} ms "
        f"({work300[0] / 1e9:.4f} GB)")
    _profile_kernels("decode_step_batch", step, 5)
    out["decode_step_batch"] = dict(err=err, ms=ms, plain_ms=plain, bound_ms=b, library_ms=None,
                                    bound_by=bound_by(*work))
    del w
    torch.cuda.empty_cache()

    # -- flash_decode at the per-op route's shapes: q [32, 4, 256], one KV head
    H, Hkv, d = hp.n_head, hp.n_head_kv, hp.n_embd_head_k
    L = cache.k.shape[0]
    kc, vc = cache.k[0], cache.v[0]  # [B, S, 1, 256]
    q = torch.randn((B, H, d), device=dev, generator=g) * 0.06
    lengths = torch.where(pos >= S, torch.zeros_like(pos), pos + 1).to(torch.int32)
    lanes = torch.arange(B, device=dev)
    worst = 0.0
    for softcap in (0.0, 50.0):
        got = flash_decode.flash_decode(q, kc, vc, lengths, softcap=softcap)
        want = flash_decode.flash_decode_plain(q, kc, vc, lengths, softcap=softcap)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=2e-3, atol=2e-3) and not got[lengths == 0].any()
        log(f"flash_decode B={B} S={S} softcap={softcap}: max_abs_err {e:.3e} "
            f"(rtol = atol = 2e-3) ok {ok}")
        if not ok:
            fail(f"flash_decode softcap={softcap}: kernel disagrees with plain")
        worst = max(worst, e)
    starts = torch.clamp(lengths - 128, min=0).to(torch.int32)
    got = flash_decode.flash_decode(q, kc, vc, lengths, starts)
    want = flash_decode.flash_decode_plain(q, kc, vc, lengths, starts)
    if not torch.allclose(got, want, rtol=2e-3, atol=2e-3):
        fail("flash_decode with window starts: kernel disagrees with plain")
    if not torch.equal(flash_decode.flash_decode(q, kc, vc, lengths, starts, softcap=50.0),
                       flash_decode.flash_decode(q, kc, vc, lengths, starts, softcap=50.0)):
        fail("flash_decode: a second launch is not bit-equal")
    # cold: each call over another layer's caches, as the per-op route finds
    # them (26 layers' K/V exceed the 50 MB L2); warm: layer 0's every call
    fms = graph_ms(lambda i: flash_decode.flash_decode(q, cache.k[i % L], cache.v[i % L],
                                                       lengths), L)
    warm = graph_ms(lambda i: flash_decode.flash_decode(q, kc, vc, lengths), L)
    fplain = graph_ms(lambda i: flash_decode.flash_decode_plain(q, kc, vc, lengths), 4)
    qb = q.to(torch.bfloat16)[:, :, None, :]
    kts = [cache.k[i].permute(0, 2, 1, 3) for i in range(L)]  # [B, Hkv, S, d] views
    vts = [cache.v[i].permute(0, 2, 1, 3) for i in range(L)]
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]

    def sdpa(i=0, layer=None):
        j = i % L if layer is None else layer
        return torch.nn.functional.scaled_dot_product_attention(qb, kts[j], vts[j], attn_mask=mask,
                                                                scale=1.0, enable_gqa=True)

    flib = graph_ms(sdpa, L)
    flib_warm = graph_ms(lambda i: sdpa(i, layer=0), L)
    live = int(lengths.sum())
    fbytes = live * Hkv * 2 * d * 2 + B * H * d * 4 * 2 + B * 4
    fops = 2 * live * H * 2 * d  # f32 FMA on the CUDA cores
    fb = bound_ms(fbytes, f32_ops=fops)
    log(f"flash_decode: second launch bit-equal; cold over {L} layers: kernel {fms:.4f} ms, "
        f"scaled_dot_product_attention (bf16 q, mask, no softcap) {flib:.4f} ms; warm (layer "
        f"0's caches every call): kernel {warm:.4f} ms, sdpa {flib_warm:.4f} ms; plain "
        f"{fplain:.4f} ms, bound {fb:.4f} ms ({fbytes / 1e6:.3f} MB)")
    out["flash_decode"] = dict(err=worst, ms=fms, plain_ms=fplain, bound_ms=fb, library_ms=flib,
                               bound_by=bound_by(fbytes, f32_ops=fops))

    # -- insert_rows over the [32 * 1024, 1, 256] view, four parked lanes dropped
    dst = cache.k[1].view(B * S, Hkv, d)
    rows = torch.randn((B, Hkv, d), device=dev, generator=g).to(torch.bfloat16)
    idx = torch.where(pos < S, lanes.to(torch.int32) * S + pos, torch.full_like(pos, B * S))
    idx[-1] = -3  # a negative id drops too
    a = kv_insert.insert_rows(dst.clone(), rows, idx)
    bref = kv_insert.insert_rows_plain(dst.clone(), rows, idx)
    torch.cuda.synchronize()
    if not torch.equal(a, bref):
        fail("insert_rows: kernel disagrees with plain")
    keep = (idx >= 0) & (idx < B * S)
    vidx, vrows = idx[keep].long(), rows[keep]
    ims = graph_ms(lambda i: kv_insert.insert_rows(dst, rows, idx), 52)
    iplain = time_ms(lambda i=0: kv_insert.insert_rows_plain(dst, rows, idx), 20)
    ilib = graph_ms(lambda i: dst.index_copy_(0, vidx, vrows), 52)
    n_kept = int(keep.sum())
    ibytes = 2 * n_kept * Hkv * d * 2 + 4 * B
    ib = bound_ms(ibytes)
    log(f"insert_rows: bit-equal; kernel {ims:.5f} ms, plain {iplain:.4f} ms (eager: its "
        f"boolean mask syncs the host), index_copy_ {ilib:.5f} ms, bound {ib:.6f} ms")

    # -- insert_kv_rows: a layer's K/V append on the per-op routes, one launch
    # from f32 rows as the forward leaves them (k packed, v a column slice of
    # the fused QKV projection) into the [32 * 1024, 1, 256] views; timed
    # cold over the 26 layers' caches beside the sequence it replaced
    qkv = torch.randn((B, (H + 2 * Hkv) * d), device=dev, generator=g)
    k32 = qkv[:, H * d:(H + Hkv) * d].reshape(B, Hkv, d).contiguous()
    v32 = qkv[:, (H + Hkv) * d:].reshape(B, Hkv, d)
    pools = [(cache.k[i].view(B * S, Hkv, d), cache.v[i].view(B * S, Hkv, d)) for i in range(L)]
    kd, vd = pools[2]
    got = [t.clone() for t in (kd, vd, kd, vd)]
    kv_insert.insert_kv_rows(got[0], got[1], k32, v32, idx)
    kv_insert.insert_kv_rows(got[2], got[3], k32, v32, idx)
    kref, vref = kd.clone(), vd.clone()
    kv_insert.insert_kv_rows_plain(kref, vref, k32, v32, idx)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], kref) and torch.equal(got[1], vref)):
        fail("insert_kv_rows: kernel disagrees with plain")
    if not (torch.equal(got[2], got[0]) and torch.equal(got[3], got[1])):
        fail("insert_kv_rows: a second launch is not bit-equal")

    def parent_seq(i):  # the route's append before the pair: two casts, two inserts
        kc, vc = pools[i % L]
        kv_insert.insert_rows(kc, k32.to(kc.dtype).contiguous(), idx)
        kv_insert.insert_rows(vc, v32.to(vc.dtype).contiguous(), idx)

    kb16, vb16 = k32.to(torch.bfloat16)[keep], v32.to(torch.bfloat16)[keep]

    def two_copies(i):  # the library: index_copy_ a pool, on rows cast beforehand
        pools[i % L][0].index_copy_(0, vidx, kb16)
        pools[i % L][1].index_copy_(0, vidx, vb16)

    pms = graph_ms(lambda i: kv_insert.insert_kv_rows(*pools[i % L], k32, v32, idx), L)
    seq = graph_ms(parent_seq, L)
    plib = graph_ms(two_copies, L)
    pplain = time_ms(lambda i=0: kv_insert.insert_kv_rows_plain(kd, vd, k32, v32, idx), 20)
    # each kept lane's f32 K and V read once and written once as bf16, the ids
    pbytes = n_kept * Hkv * 2 * d * (4 + 2) + 4 * B
    pb = bound_ms(pbytes)
    log(f"insert_kv_rows (f32 k, strided f32 v): bit-equal, a second launch bit-equal; cold over "
        f"{L} layers: kernel {pms:.5f} ms a layer, the parent's two casts + two insert_rows "
        f"{seq:.5f} ms, two index_copy_ on pre-cast rows {plib:.5f} ms; plain {pplain:.4f} ms, "
        f"bound {pb:.6f} ms ({pbytes} bytes)")
    out["insert_rows"] = dict(err=0.0, ms=pms, plain_ms=pplain, bound_ms=pb, library_ms=plib,
                              bound_by="bytes", one_pool_ms=ims, parent_seq_ms=seq)
    del cache, dst, pools, kd, vd, got
    torch.cuda.empty_cache()
    return out


def _server_requests(golden):
    """bench_batched's traffic: 32 prompts of [2] + 31 ids from
    default_rng(0).integers(10, 10000), 256 tokens each; the first prompt is
    the golden one (the same draw), which asks for its 100 golden tokens."""
    rng = np.random.default_rng(0)
    prompts = [[2] + rng.integers(10, 10000, size=31).tolist() for _ in range(BATCH)]
    if prompts[0] != golden["prompt"]:
        fail("bench_batched's first prompt is not the golden prompt")
    return [(p, golden["steps"] if i == 0 else 256) for i, p in enumerate(prompts)]


def admission_check(what: str, srv, prompts, smi: str = "", bar: float = 1e-1) -> dict:
    """A same-bucket group's admission against the lone path on one server
    (phases 7 and 12; tests/test_torch_cuda.py): ``prompts`` submitted and
    admitted as one group (one ``forward_prefill_group`` pass), their first
    ids and K/V rows [0, n_valid) of every KV layer copied, the lanes (and
    pages) freed, then the same prompts submitted and admitted one at a time
    (each a group pass of one, bit-equal to the single-stream ``forward``:
    tests/test_torch_cuda.py). Every first id must be equal; layer 0's K/V
    rows within one bf16 step of the lone ones (phase 6's layer-0 bar: 2^-7
    relative, on |ref| + 1e-3; W8A8 sums are exact, so on the card they are
    bit-equal, and a row copied to the wrong lane, page, slot or head shows
    here); every KV layer's rows of each request within ``bar`` of the lone
    rows' norm (relative Frobenius error, K and V apart). The default 1e-1
    is the tame 1B's (phases 7 and 12): phase 6's every-layer bar, 1.5e-2 *
    max(1, max|rows|), holds one step, but a prefill compounds over its
    layers the f32 attention sums that cuBLAS orders one way for a batch of
    G members and another for one, each flipped bf16 or int8 rounding
    moving the next layer's rows: on the tame 1B the gap grows to 7.5e-2 at
    layer 25 (0.35 against phase 6's 0.076 elementwise), with the first ids
    all equal (PERF.md §6); the card test's two-layer fixture takes a bar
    just above its own measured gap. To show that growth is the model's,
    the lone prefill of the first prompt is run again with layer
    0's attn_norm weight (f32) scaled by 1 + 2^-22, a few f32 roundings,
    and its gap from the lone rows is logged beside the group's. Paged: each
    admitted request's table row maps its pages, and after each retirement
    the table is all sentinel and every page free again. Fails on a miss;
    returns each admission's wall seconds (ended by its first ids' host
    copy, then a sync), the K/V gaps and the count of equal first ids."""
    import torch

    def rows(req):  # [n_valid, Hkv, d] of every KV layer, copies
        n = len(req.prompt_ids)
        if srv.paged:
            pools = srv._caches
            pages = torch.as_tensor(req.pages, device=pools.k[0].device)
            return ([t[pages].flatten(0, 1)[:n].clone() for t in pools.k],
                    [t[pages].flatten(0, 1)[:n].clone() for t in pools.v])
        lane = srv._caches.lane(req.slot)
        return ([lane.k[i][:n].clone() for i in range(len(lane.k))],
                [lane.v[i][:n].clone() for i in range(len(lane.v))])

    def admit(groups):
        torch.cuda.synchronize()
        reqs, t0 = [], time.perf_counter()
        for g in groups:
            reqs += [srv.submit(p, 8) for p in g]
            srv._admit()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if any(r.slot < 0 for r in reqs) or srv._queue:
            fail(f"{what}: {sum(r.slot < 0 for r in reqs)} of {len(reqs)} requests not admitted")
        if srv.paged and any(list(srv._table[r.slot, :len(r.pages)]) != r.pages for r in reqs):
            fail(f"{what}: a table row does not map its request's pages")
        out = [(r.pending, rows(r)) for r in reqs]
        for slot in list(srv._active):
            srv._retire(slot)
        if srv.paged and (not (srv._table == srv.kv_pages).all()
                          or sorted(srv._free_pages) != list(range(srv.kv_pages))):
            fail(f"{what}: after retirement the table is not all sentinel or pages are missing "
                 f"({len(srv._free_pages)} of {srv.kv_pages} free)")
        return out, secs

    group, group_s = admit([prompts])
    lone, lone_s = admit([[p] for p in prompts])
    same = sum(a == b for (a, _), (b, _) in zip(group, lone))
    n_kv = len(group[0][1][0])
    gap = gap0 = 0.0
    rel = [0.0] * n_kv  # a KV layer's largest relative Frobenius error, K or V, any request
    for (_, (kg, vg)), (_, (kl, vl)) in zip(group, lone):
        for i, pairs in enumerate(zip(kg + vg, kl + vl)):
            a, b = (t.float() for t in pairs)
            d = (a - b).abs()
            gap = max(gap, d.max().item())
            rel[i % n_kv] = max(rel[i % n_kv], (d.norm() / b.norm().clamp(min=1e-30)).item())
            if i % n_kv == 0:
                gap0 = max(gap0, (d / (b.abs() + 1e-3)).max().item())
    worst = max(range(n_kv), key=rel.__getitem__)
    # the model's own amplification of a few f32 roundings, on the first prompt
    from llm_inference_tpu_torch.models import gemma

    hp, w = srv.hparams, srv._row_weights[0]
    norm = gemma._layers(hp, w)[0].attn_norm
    kept = norm.clone()
    norm.mul_(1 + 2 ** -22)
    try:
        cache = gemma.init_cache(hp, max(len(prompts[0]), 16), device=norm.device)
        gemma.forward(hp, w, cache, torch.tensor(prompts[0], device=norm.device), 0,
                      len(prompts[0]), mm_impl="xla")
    finally:
        norm.copy_(kept)
    n0, lone0 = len(prompts[0]), lone[0][1][0]
    moved = [((cache.k[i][:n0].float() - lone0[i].float()).norm()
              / lone0[i].float().norm().clamp(min=1e-30)).item() for i in range(n_kv)]
    log(f"{what}: {len(prompts)} prompts admitted as one group in {group_s:.4f} s and one at a "
        f"time (passes of one) in {lone_s:.4f} s (wall, synced); first ids equal "
        f"{same}/{len(prompts)}; K/V rows [0, n_valid): layer 0 max_rel_err {gap0:.3e} (tol "
        f"{2 ** -7:.3e}), relative Frobenius error by KV layer {' '.join(f'{r:.1e}' for r in rel)} "
        f"(worst layer {worst}: {rel[worst]:.3e}, tol {bar:.1e}), max_abs_err {gap:.3e}; the "
        f"first prompt's lone K rows with layer 0's norm weight x (1 + 2^-22), by KV layer "
        f"{' '.join(f'{r:.1e}' for r in moved)}"
        + (f"; the table all sentinel and {srv.kv_pages} pages free after each retirement"
           if srv.paged else "") + (f" on {smi}" if smi else ""))
    if same != len(prompts) or not gap0 <= 2 ** -7 or not rel[worst] <= bar:
        fail(f"{what}: the group admission disagrees with the lone one")
    return dict(group_s=group_s, lone_s=lone_s, kv_err=gap, kv_rel=rel[worst], kv0_rel=gap0,
                ids_equal=same, perturbed_rel=max(moved))


# Phase 7's runs alone, by route: the tokens kept of each request served
# alone, and the stride over the requests so served. The per-op route
# issues about 4000 eager torch ops a step, and a run alone decodes a
# whole chunk of 32 steps however few tokens it keeps: its runs alone
# (every fourth request, 32 tokens) took 36.7 s of a 781.9 s smoke on a
# slow host (measured on one H100), so it serves none alone (the cut
# ROADMAP.md queue 1 item 6 lists first). Lane isolation is still held on
# both routes: the kernel route serves every request alone for its whole
# stream, and the per-op route's 32 batched streams must equal the kernel
# route's.
ALONE = {"kernel": (256, 1), "per-op": (0, 1)}


def phase_server(smi: str):
    """Phase 7: BatchedServer on the tame 1B checkpoint, once per decode route."""
    import os

    import torch

    from llm_inference_tpu_torch.ops.kernels import (flash_decode, fused_decode,
                                                     fused_decode_batch, kv_insert, qmatmul)
    from llm_inference_tpu_torch.serving import BatchedServer, ServerStats

    golden = json.loads((ROOT / "tests" / "golden" / "parity_1b_tame.json").read_text())
    path = tame_checkpoint()
    reqs = _server_requests(golden)
    L = GEOM_1B["n_layers"]
    mods = {"decode_step_batch": fused_decode_batch, "insert_rows": kv_insert,
            "flash_decode": flash_decode, "quant_matmul": qmatmul, "decode_step": fused_decode}
    results, streams = {}, {}
    for route in ("kernel", "per-op"):
        if route == "per-op":
            os.environ["LLMI_NO_FUSED_DECODE"] = "1"  # the JAX package's own switch
        try:
            t0 = time.perf_counter()
            srv = BatchedServer(str(path), mode="serve-q8", max_batch=BATCH, max_seq=BATCH_SEQ,
                                decode_chunk=32, max_admit_per_step=BATCH, device="cuda")
        finally:
            os.environ.pop("LLMI_NO_FUSED_DECODE", None)
        if srv.decode_route != route:
            fail(f"server: expected the {route} route, got {srv.decode_route}")
        srv.tokenizer.eos_id = -1  # random weights may argmax onto <eos>: never stop early
        srv.tokenizer.end_of_turn_id = -1
        srv.run([(p, 8) for p, _ in reqs])  # warm-up
        torch.cuda.synchronize()
        log(f"server {route}: load + warm-up {time.perf_counter() - t0:.1f} s")
        srv.stats = ServerStats()
        for m in mods.values():
            m.launches = 0
        handles = [srv.submit(p, n) for p, n in reqs]
        while srv.step():
            pass
        torch.cuda.synchronize()
        counts = {k: m.launches for k, m in mods.items()}
        st = srv.stats
        outs = [h.out for h in handles]
        streams[route] = outs
        n_match = next((i for i, (a, b) in enumerate(zip(outs[0], golden["tokens"])) if a != b),
                       min(len(outs[0]), len(golden["tokens"])))
        log(f"server {route}: golden lane {n_match}/{golden['steps']} tokens match; "
            f"decode steps {st.decode_steps}; launches {counts}")
        if outs[0] != golden["tokens"][: golden["steps"]]:
            fail(f"server {route}: the golden lane diverges at token {n_match}: "
                 f"{outs[0][:12]}... vs {golden['tokens'][:12]}...")
        if any(len(o) != n for o, (_, n) in zip(outs, reqs)):
            fail(f"server {route}: a request ended short of its n_predict")
        want = ({"decode_step_batch": st.decode_steps, "insert_rows": 0, "flash_decode": 0}
                if route == "kernel" else
                {"decode_step_batch": 0, "insert_rows": L * st.decode_steps,
                 "flash_decode": L * st.decode_steps})
        if st.decode_steps == 0 or any(counts[k] != v for k, v in want.items()):
            fail(f"server {route}: launches {counts}, expected {want}")
        tok_s = sum(len(o) for o in outs) / st.decode_seconds
        ttft = float(np.percentile([h.ttft_s for h in handles], 50)) * 1e3
        dec_s, adm_s = st.decode_seconds, st.prefill_seconds  # before the runs alone add to them
        # lane isolation: requests served alone by the same server
        n_alone, every = ALONE[route]
        t1 = time.perf_counter()
        for i, (p, n) in list(enumerate(reqs))[::every] if n_alone else ():
            m = min(n, n_alone)
            alone = srv.run([(p, m)])[0]
            if alone != outs[i][:m]:
                fail(f"server {route}: request {i} alone differs from its batched stream")
        if n_alone:
            log(f"server {route}: {len(reqs[::every])} of {len(reqs)} requests alone "
                f"({n_alone} tokens each at most) equal their batched streams "
                f"({time.perf_counter() - t1:.1f} s)")
        log(f"server {route}: {sum(len(o) for o in outs)} tokens, decode {tok_s:.2f} tok/s "
            f"aggregate ({dec_s:.3f} s), p50 TTFT {ttft:.2f} ms (through the group prefill), "
            f"admissions {adm_s:.3f} s on {smi}")
        results[route] = dict(tok_s=tok_s, ttft_ms=ttft, counts=counts,
                              decode_steps=st.decode_steps, streams=outs, admissions_s=adm_s)
        if route == "per-op":  # the prefill is the same on both routes: checked once
            results["admission"] = admission_check("server admission", srv,
                                                   [p for p, _ in reqs], smi)
        # where a step's and a prefill's time goes (after the checks: both
        # write into the server's cache)
        tok = torch.zeros(BATCH, dtype=torch.int32, device="cuda")
        p300 = torch.full((BATCH,), 300, dtype=torch.int32, device="cuda")
        if route == "per-op":
            from llm_inference_tpu_torch.models.gemma import forward_batched_decode

            _profile_kernels("per-op step (32 lanes at pos 300)", lambda: forward_batched_decode(
                srv.hparams, srv.weights, srv._caches, tok, p300), 3)
            _profile_kernels("W8A8 prefill (32 tokens, a group pass of one)",
                             lambda: srv._prefill_group(handles[:1], [0], 32), 3)
            _profile_kernels(f"W8A8 group prefill ({BATCH} x 32 tokens)",
                             lambda: srv._prefill_group(handles, list(range(BATCH)), 32), 3)
        else:
            _profile_kernels("kernel-route step (32 lanes at pos 300)",
                             lambda: fused_decode_batch.decode_step_batch(
                                 srv.hparams, srv.weights, srv._caches, tok, p300, srv._consts,
                                 greedy=True), 3)
        del srv
        torch.cuda.empty_cache()
    same = sum(a == b for a, b in zip(streams["kernel"], streams["per-op"]))
    log(f"server: {same}/{len(reqs)} streams identical across the two routes")
    if same != len(reqs):
        fail("server: the two decode routes give different streams")
    return results


PAGE = 256          # the paged phases' page (LLMI_PAGE's default)
PAGED_POOL = 48     # phase 12's kv_pages: 24 of the 32 requests fit at first
PER_OP_TOKENS = 64  # phase 12's per-op traffic: each request's first 64 tokens,
PER_OP_POOL = 24    # ... a page each out of 24: again 24 fit at first


def _paged_layout(positions, S, g):
    """A shuffled pool for B lanes of S slots: each lane's blocks up to its
    position map to distinct real pages, later blocks and parked lanes to
    the sentinel, the trash row. Returns (table [B, NB] int32, rows P1)."""
    import torch

    B, nb = len(positions), S // PAGE
    p1 = B * nb + 1  # real pages, then the trash row
    perm = torch.randperm(p1 - 1, device="cuda", generator=g)
    table = torch.full((B, nb), p1 - 1, dtype=torch.int32, device="cuda")
    for b, p in enumerate(positions):
        if p < S:
            n = p // PAGE + 1
            table[b, :n] = perm[b * nb : b * nb + n].to(torch.int32)
    return table, p1


def _check_paged_step(label: str, hp, w, kpool, vpool, table, tokens, pos, consts) -> float:
    """The paged batched step against its plain twin on one set of weights
    (phase 11), with phase 6's bars and planted fault; the live lanes'
    written rows as phase 6's, and no pool row outside them and the trash
    page touched."""
    import torch

    from llm_inference_tpu_torch.ops.kernels import fused_decode_batch, fused_decode_batch_paged

    step = fused_decode_batch_paged.decode_step_batch_paged
    plain = fused_decode_batch_paged.decode_step_batch_paged_plain
    L, p1 = kpool.shape[:2]
    B, nb = table.shape
    kk, vk, kp, vp = kpool.clone(), vpool.clone(), kpool.clone(), vpool.clone()
    y = step(hp, w, kk, vk, table, tokens, pos, consts)
    y_again = step(hp, w, kpool.clone(), vpool.clone(), table, tokens, pos, consts)
    ref = plain(hp, w, kp, vp, table, tokens, pos, consts)
    ids = step(hp, w, kpool.clone(), vpool.clone(), table, tokens, pos, consts, greedy=True)
    kf, vf = kpool.clone(), vpool.clone()
    vf[FAULT_LAYER].zero_()
    faulted = plain(hp, w, kf, vf, table, tokens, pos, consts)
    del kf, vf
    torch.cuda.synchronize()
    S = nb * PAGE
    live = (pos < S).nonzero().flatten()
    # the parked lanes share the trash page's slot 0: their logits are
    # garbage by design, so only the live lanes' must repeat bit for bit
    if not torch.equal(y[live], y_again[live]):
        fail(f"decode_step_batch_paged {label}: a second launch gives other logits")
    err = _step_verdict("decode_step_batch_paged", label, y[live], ref[live], ids[live],
                        faulted[live])
    p = pos[live].long()
    rows = table[live, p // PAGE].long() * PAGE + p % PAGE
    trash = torch.zeros(p1 * PAGE, dtype=torch.bool, device="cuda")
    trash[(p1 - 1) * PAGE:] = True

    def flat(t):
        return t.view(L, p1 * PAGE, *t.shape[3:])

    _kv_verdict("decode_step_batch_paged", label, (flat(kk), flat(vk)), (flat(kp), flat(vp)),
                (flat(kpool), flat(vpool)), rows, exempt=trash)
    parked_wrote = not torch.equal(kk[:, p1 - 1, 0], kpool[:, p1 - 1, 0])
    log(f"decode_step_batch_paged {label}: the parked lanes wrote the trash page {parked_wrote}")
    if len(live) < B and not parked_wrote:
        fail(f"decode_step_batch_paged {label}: the parked lanes' rows did not reach the trash page")
    del kk, vk, kp, vp
    return err


def phase_paged_kernels():
    """Phase 11: paged_flash_decode and the paged batched step against their
    plain twins at the 1B serving shapes, over a shuffled pool of 256-slot
    pages."""
    import torch

    from llm_inference_tpu_torch.gguf import GGUFFile
    from llm_inference_tpu_torch.models import gemma
    from llm_inference_tpu_torch.models.weights import fuse_projections, load_weights, stack_layers
    from llm_inference_tpu_torch.ops.kernels import (flash_decode, fused_decode_batch,
                                                     fused_decode_batch_paged)

    dev = torch.device("cuda")
    B, S = BATCH, BATCH_SEQ
    g = torch.Generator(device=dev).manual_seed(11)
    positions = _batch_positions(S)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    tokens = torch.randint(0, VOCAB_SIZE, (B,), device=dev, generator=g, dtype=torch.int32)
    table, p1 = _paged_layout(positions, S, g)
    log(f"paged B={B} page={PAGE}: positions {positions[0]}..{max(positions[:-4])}, 4 parked, "
        f"pool of {p1} pages (the last the trash page)")
    out = {}

    # -- the paged whole step on random and on the tame checkpoint's weights
    hp_r = _hp_1b()
    w_r = _random_model(hp_r, seed=2)
    pools = gemma.init_paged_cache(hp_r, p1, PAGE, device=dev)
    pools.k_all.copy_(torch.randn(pools.k_all.shape, device=dev, generator=g))
    pools.v_all.copy_(torch.randn(pools.v_all.shape, device=dev, generator=g))
    nb = S // PAGE
    if not fused_decode_batch_paged.batch_paged_supported(hp_r, w_r, batch=B, nb=nb, page=PAGE):
        fail("decode_step_batch_paged: the 1B-shaped random model is not eligible")
    consts_r = fused_decode_batch.prepare_batch(hp_r, dev, batch=B, max_seq=S)
    err = _check_paged_step("random weights", hp_r, w_r, pools.k_all, pools.v_all, table, tokens,
                            pos, consts_r)
    del w_r, consts_r
    torch.cuda.empty_cache()
    hp, w = load_weights(GGUFFile(str(tame_checkpoint())), mode="rowq8", device=dev)
    w = fuse_projections(w)
    w = dataclasses.replace(w, layers=stack_layers(w.layers))
    consts = fused_decode_batch.prepare_batch(hp, dev, batch=B, max_seq=S)
    err = max(err, _check_paged_step("tame weights", hp, w, pools.k_all, pools.v_all, table,
                                     tokens, pos, consts))
    torch.cuda.empty_cache()

    def step(i=0):
        return fused_decode_batch_paged.decode_step_batch_paged(
            hp, w, pools.k_all, pools.v_all, table, tokens, pos, consts, greedy=True)

    ms = graph_ms(step, 4, replays=10)
    plain = time_ms(lambda i=0: fused_decode_batch_paged.decode_step_batch_paged_plain(
        hp, w, pools.k_all, pools.v_all, table, tokens, pos, consts, greedy=True), 2, warmup=1)
    # the dense step on the same lanes in the same process, for comparison
    cache = gemma.init_batched_cache(hp, B, S, device=dev)
    dense = graph_ms(lambda i=0: fused_decode_batch.decode_step_batch(
        hp, w, cache, tokens, pos, consts, greedy=True), 4, replays=10)
    del cache
    nbytes, bf16_ops, f32_ops = _step_bound(hp, positions, S)
    nbytes += 4 * B * nb  # the table
    b = bound_ms(nbytes, bf16_ops, f32_ops)
    log(f"decode_step_batch_paged B={B} ragged: device {ms:.4f} ms (CUDA graph), plain "
        f"{plain:.4f} ms, bound {b:.4f} ms ({nbytes / 1e9:.4f} GB); the dense step on the same "
        f"lanes {dense:.4f} ms")
    _profile_kernels("decode_step_batch_paged", step, 5)
    out["decode_step_batch_paged"] = dict(err=err, ms=ms, plain_ms=plain, bound_ms=b,
                                          library_ms=None,
                                          bound_by=bound_by(nbytes, bf16_ops, f32_ops))
    del w

    # -- paged_flash_decode at the per-op route's shapes: q [32, 4, 256], layer 0's pools
    H, Hkv, d = hp.n_head, hp.n_head_kv, hp.n_embd_head_k
    L = len(pools.k)
    kc, vc = pools.k[0], pools.v[0]  # [p1, 256, 1, 256]
    q = torch.randn((B, H, d), device=dev, generator=g) * 0.06
    lengths = torch.where(pos >= S, torch.zeros_like(pos), pos + 1).to(torch.int32)
    worst = 0.0
    cases = (("softcap 0", {}), ("softcap 50", dict(softcap=50.0)),
             ("window starts", dict(starts=torch.clamp(lengths - 128, min=0).to(torch.int32))),
             ("nb_cap 4 (covers every lane)", dict(nb_cap=4)),
             ("nb_cap 2 (truncates)", dict(nb_cap=2)))
    for name, kw in cases:
        got = flash_decode.paged_flash_decode(q, kc, vc, table, lengths, **kw)
        want = flash_decode.paged_flash_decode_plain(q, kc, vc, table, lengths, **kw)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=2e-3, atol=2e-3) and not got[lengths == 0].any()
        log(f"paged_flash_decode B={B} {name}: max_abs_err {e:.3e} (rtol = atol = 2e-3) ok {ok}")
        if not ok:
            fail(f"paged_flash_decode {name}: kernel disagrees with plain")
        worst = max(worst, e)
    capped = flash_decode.paged_flash_decode(q, kc, vc, table, lengths, nb_cap=4)
    if not torch.equal(capped, flash_decode.paged_flash_decode(q, kc, vc, table, lengths)):
        fail("paged_flash_decode: a cap covering every lane changed the result")
    if not torch.equal(capped, flash_decode.paged_flash_decode(q, kc, vc, table, lengths,
                                                               nb_cap=4)):
        fail("paged_flash_decode: a second launch is not bit-equal")
    # cold over the pools' layers, as the per-op route finds them; warm: layer 0's
    fms = graph_ms(lambda i: flash_decode.paged_flash_decode(
        q, pools.k[i % L], pools.v[i % L], table, lengths, nb_cap=4), L)
    warm = graph_ms(lambda i: flash_decode.paged_flash_decode(q, kc, vc, table, lengths,
                                                              nb_cap=4), L)
    fplain = graph_ms(lambda i: flash_decode.paged_flash_decode_plain(q, kc, vc, table, lengths,
                                                                      nb_cap=4), 4)
    live = int(lengths.sum())
    fbytes = live * Hkv * 2 * d * 2 + B * H * d * 4 * 2 + B * 4 + 4 * B * nb
    fops = 2 * live * H * 2 * d  # f32 FMA on the CUDA cores
    fb = bound_ms(fbytes, f32_ops=fops)
    log(f"paged_flash_decode: second launch bit-equal; cold over {L} layers: kernel "
        f"{fms:.4f} ms; warm (layer 0's pools every call): kernel {warm:.4f} ms; plain "
        f"{fplain:.4f} ms, library none (no one PyTorch call reads through a page table), "
        f"bound {fb:.4f} ms ({fbytes / 1e6:.3f} MB)")
    out["paged_flash_decode"] = dict(err=worst, ms=fms, plain_ms=fplain, bound_ms=fb,
                                     library_ms=None, bound_by=bound_by(fbytes, f32_ops=fops))
    del pools
    torch.cuda.empty_cache()
    return out


def phase_paged_server(dense_streams, smi: str):
    """Phase 12: BatchedServer(kv_pages=48) on the tame 1B checkpoint with
    phase 7's traffic on both paged routes, then serve-q and serve-q4 paged."""
    import os

    import torch

    from llm_inference_tpu_torch.ops.kernels import (flash_decode, fused_decode_batch,
                                                     fused_decode_batch_paged, kv_insert)
    from llm_inference_tpu_torch.serving import BatchedServer, ServerStats

    golden = json.loads((ROOT / "tests" / "golden" / "parity_1b_tame.json").read_text())
    path = tame_checkpoint()
    reqs = _server_requests(golden)
    L = GEOM_1B["n_layers"]
    os.environ.pop("LLMI_PAGE", None)  # the default page, 256

    def counts():
        return {"decode_step_batch_paged": fused_decode_batch_paged.launches,
                "paged_flash_decode": flash_decode.paged_launches,
                "insert_rows": kv_insert.launches, "decode_step_batch": fused_decode_batch.launches,
                "flash_decode": flash_decode.launches}

    def zero():
        fused_decode_batch_paged.launches = flash_decode.paged_launches = 0
        kv_insert.launches = fused_decode_batch.launches = flash_decode.launches = 0

    def serve(srv, requests):
        srv.tokenizer.eos_id = -1  # random weights may argmax onto <eos>: never stop early
        srv.tokenizer.end_of_turn_id = -1
        srv.run([(p, 8) for p, _ in requests])  # warm-up
        torch.cuda.synchronize()
        srv.stats = ServerStats()
        zero()
        handles = [srv.submit(p, n) for p, n in requests]
        srv.step()
        admitted_first = len(handles) - len(srv._queue)
        while srv.step():
            pass
        torch.cuda.synchronize()
        return [h.out for h in handles], handles, admitted_first, counts()

    def per_step(route, steps):
        return ({"decode_step_batch_paged": steps, "paged_flash_decode": 0, "insert_rows": 0}
                if route == "paged-kernel" else
                {"decode_step_batch_paged": 0, "paged_flash_decode": L * steps,
                 "insert_rows": L * steps}) | {"decode_step_batch": 0, "flash_decode": 0}

    results = {}
    # the per-op route's traffic, cut (a host-bound step): the golden lane whole
    cut = [reqs[0]] + [(p, PER_OP_TOKENS) for p, _ in reqs[1:]]
    for route in ("paged-per-op", "paged-kernel"):
        per_op = route == "paged-per-op"
        pool = PER_OP_POOL if per_op else PAGED_POOL
        if route == "paged-kernel":
            os.environ["LLMI_PAGED_MEGAKERNEL"] = "1"  # the JAX package's opt-in
        try:
            t0 = time.perf_counter()
            srv = BatchedServer(str(path), mode="serve-q8", max_batch=BATCH, max_seq=BATCH_SEQ,
                                decode_chunk=32, max_admit_per_step=BATCH, kv_pages=pool,
                                device="cuda")
        finally:
            os.environ.pop("LLMI_PAGED_MEGAKERNEL", None)
        if srv.decode_route != route:
            fail(f"paged server: expected the {route} route, got {srv.decode_route}")
        outs, handles, first, got = serve(srv, cut if per_op else reqs)
        st = srv.stats
        log(f"paged server {route}: load, warm-up and run {time.perf_counter() - t0:.1f} s; "
            f"{first} of {len(reqs)} requests admitted at first (the pool of {pool} pages "
            f"holds them), decode steps {st.decode_steps}; launches {got}")
        n_match = next((i for i, (a, b) in enumerate(zip(outs[0], golden["tokens"])) if a != b),
                       min(len(outs[0]), len(golden["tokens"])))
        if outs[0] != golden["tokens"][: golden["steps"]]:
            fail(f"paged server {route}: the golden lane diverges at token {n_match}")
        same = sum(a == b[: len(a)] and len(a) == n for a, b, (_, n) in
                   zip(outs, dense_streams, cut if per_op else reqs))
        log(f"paged server {route}: golden lane {n_match}/{golden['steps']} tokens match; "
            f"{same}/{len(reqs)} streams equal phase 7's")
        if same != len(reqs) or first != 24:
            fail(f"paged server {route}: {same} streams equal phase 7's, {first} admitted at first "
                 "(expected all, and 24)")
        want = per_step(route, st.decode_steps)
        if st.decode_steps == 0 or got != want:
            fail(f"paged server {route}: launches {got}, expected {want}")
        if sorted(srv._free_pages) != list(range(pool)):
            fail(f"paged server {route}: {len(srv._free_pages)} pages free at the end, not "
                 f"{pool}")
        tok_s = sum(len(o) for o in outs) / st.decode_seconds
        ttft = float(np.percentile([h.ttft_s for h in handles], 50)) * 1e3
        log(f"paged server {route}: {sum(len(o) for o in outs)} tokens, decode {tok_s:.2f} tok/s "
            f"aggregate ({st.decode_seconds:.3f} s), p50 TTFT {ttft:.2f} ms (through the group "
            f"prefill), admissions {st.prefill_seconds:.3f} s; the free list holds {pool} pages "
            f"again; on {smi}")
        results[route] = dict(tok_s=tok_s, ttft_ms=ttft, counts=got, decode_steps=st.decode_steps,
                              admissions_s=st.prefill_seconds)
        if route == "paged-kernel":  # its pool holds all 32 prompts' pages at once
            results["admission"] = admission_check(f"paged server admission ({pool} pages)", srv,
                                                   [p for p, _ in reqs], smi)
        del srv
        torch.cuda.empty_cache()

    # serve-q / serve-q4 paged: the per-op route over the dequantized weights
    few = [(p, PER_OP_TOKENS) for p, _ in reqs[:8]]
    for mode in ("serve-q", "serve-q4"):
        t0 = time.perf_counter()
        srv = BatchedServer(str(path), mode=mode, max_batch=8, max_seq=BATCH_SEQ, decode_chunk=32,
                            max_admit_per_step=8, kv_pages=PAGED_POOL, device="cuda")
        if srv.decode_route != "paged-per-op":
            fail(f"paged server {mode}: expected the paged-per-op route, got {srv.decode_route}")
        outs, handles, _, got = serve(srv, few)
        st = srv.stats
        want = per_step("paged-per-op", st.decode_steps)
        tok_s = sum(len(o) for o in outs) / st.decode_seconds
        ttft = float(np.percentile([h.ttft_s for h in handles], 50)) * 1e3
        want_golden = golden["tokens"][:PER_OP_TOKENS]
        log(f"paged server {mode}: {len(few)} requests of {PER_OP_TOKENS} tokens in "
            f"{time.perf_counter() - t0:.1f} s with load; golden lane equal "
            f"{outs[0] == want_golden}; decode {tok_s:.2f} tok/s, p50 TTFT {ttft:.2f} ms; "
            f"launches {got}")
        if outs[0] != want_golden:
            fail(f"paged server {mode}: the golden lane diverges from the golden stream")
        if got != want or sorted(srv._free_pages) != list(range(PAGED_POOL)):
            fail(f"paged server {mode}: launches {got} (expected {want}) or pages not freed")
        results[mode] = dict(tok_s=tok_s, ttft_ms=ttft, counts=got, decode_steps=st.decode_steps,
                             admissions_s=st.prefill_seconds)
        del srv
        torch.cuda.empty_cache()
    return results


STREAM_SEQ, STREAM_POS = 1024, 300


def _serve_golden(eng, what: str, golden, steps: int | None = None
                  ) -> tuple[list, "object", dict]:
    """The golden prompt's 100 greedy tokens (or its first ``steps``) on
    ``eng`` after a warm-up, with the launch counts of that run."""
    from llm_inference_tpu_torch.engine import GenerationStats

    import torch

    eng.tokenizer.eos_id = -1  # random weights may argmax onto <eos>: never stop early
    eng.tokenizer.end_of_turn_id = -1
    eng.generate_from_ids(golden["prompt"], n_predict=8)  # warm-up
    torch.cuda.synchronize()
    _zero_single_counts()
    stats = GenerationStats()
    out = eng.generate_from_ids(golden["prompt"], n_predict=steps or golden["steps"], stats=stats)
    torch.cuda.synchronize()
    counts = _single_counts()
    log(f"{what}: launches {counts}; decode steps {stats.decode_steps}")
    return out, stats, counts


def phase_stream_step(golden):
    """Phase 13: the capacity step against its plain twin at full Gemma-3-12B
    width and depth (48 layers), one step at position 300 over seeded K/V
    rows in a flat cache, with and without sliding windows, on random
    serve-q int8 and serve-q4 nibble weights (Q4_K offsets, a Q6_K-like down
    projection); times, bound, per-phase profile. Then centered Q4_0 nibbles
    (every projection) with raw f16 scales (the capacity load's): held
    against the twin (a second launch bit-equal), bit-equal to the same
    weights with f32 scales, both timed, the bound from this run's tensors.
    Then the tame 1B under LLMI_FORCE_CAPACITY=1 in serve-q and in serve-q4
    (raw f16 scales), the latter again over its weights' f32 twin: the
    golden stream with one capacity step a decode step, the f16 run's first
    prefill and decode logits bit-equal to the f32 twin's."""
    import os

    import torch

    from llm_inference_tpu_torch.engine import Engine
    from llm_inference_tpu_torch.models.gemma import init_cache
    from llm_inference_tpu_torch.ops.kernels import fused_decode, fused_decode_stream as fds
    from llm_inference_tpu_torch.quant.device import Q4Tensor

    hp = hp_gemma3(**GEOM_12B, sliding_window=1024)
    dev = torch.device("cuda")
    S, pos = STREAM_SEQ, STREAM_POS
    g = torch.Generator(device=dev).manual_seed(13)
    cache = init_cache(hp, S, device=dev, flat=True)
    cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
    token = torch.tensor([200001], dtype=torch.int64, device=dev)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    worst, out = 0.0, {}
    for label, nibble in (("random serve-q int8", False), ("random serve-q4 nibble+offsets", True)):
        w = _random_lossless_model(hp, seed=17, nibble=nibble)
        if not fds.decode_stream_supported(hp, w, max_seq=S):
            fail(f"decode_step_stream: the 12B {label} weights are not eligible")
        for swa in (False, True):
            consts = fds.prepare(hp, dev, swa_mask=swa, max_seq=S)
            err, _ = _check_step_q(f"12B {label} swa={swa}", hp, w, cache, token, p, consts,
                                   step=fds.decode_step_stream, plain=fds.decode_step_stream_plain)
            worst = max(worst, err)
        consts = fds.prepare(hp, dev, swa_mask=False, max_seq=S)
        ms = time_ms(lambda i=0: fds.decode_step_stream(hp, w, cache, token, p, consts), 20)
        plain = time_ms(lambda i=0: fds.decode_step_stream_plain(hp, w, cache, token, p, consts),
                        2, warmup=1)
        nbytes, ops = _lossless_bytes(hp, w, pos)
        b = bound_ms(nbytes, f32_ops=ops)
        log(f"decode_step_stream 12B {label} pos={pos}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {b:.4f} ms ({nbytes / 1e9:.4f} GB, {ops / 1e9:.2f} GFLOP f32), "
            f"{nbytes / ms / 1e9:.3f} TB/s")
        prof = _step_profile(f"decode_step_stream 12B {label}", lambda pr: fds.decode_step_stream(
            hp, w, cache, token, p, consts, profile=pr), hp,
            hp.block_count * fused_decode.PROFILE_MARKS + 3, n=5)
        # gate/up's bytes a layer over its phase (the norm before it included)
        gu = w.layers.w_gate_up
        gu_bytes = (gu.packed[0].numel() if isinstance(gu, Q4Tensor) else gu.q[0].numel()) \
            + 4 * gu.scale[0].numel() * (2 if gu.offset is not None else 1)
        (plan, _), = consts.scratch["plans"].values()
        log(f"decode_step_stream 12B {label}: gate/up {gu_bytes / 1e6:.2f} MB a layer in "
            f"{prof['norm+gate/up']:.2f} us, {gu_bytes / prof['norm+gate/up'] / 1e6:.3f} TB/s; "
            f"plan {plan}")
        out[label] = dict(ms=ms, plain_ms=plain, bound_ms=b, bytes=nbytes,
                          bound_by=bound_by(nbytes, f32_ops=ops))
        del w, consts
        torch.cuda.empty_cache()
    worst = max(worst, _stream_f16_scales(hp, cache, token, p, out))
    del cache
    torch.cuda.empty_cache()

    # the tame 1B through the capacity route: serve-q, and serve-q4 (raw f16
    # scales) over its own weights and over their f32 twin
    L = GEOM_1B["n_layers"]
    first = {}
    for mode in ("serve-q", "serve-q4"):
        os.environ["LLMI_FORCE_CAPACITY"] = "1"  # the JAX package's own switch
        try:
            eng = Engine(str(tame_checkpoint()), mode=mode, max_seq=1024, decode_chunk=16,
                         device="cuda")
        finally:
            os.environ.pop("LLMI_FORCE_CAPACITY", None)
        f16 = mode == "serve-q4"
        scale = eng.weights.layers.wqkv.scale
        if eng.decode_route != "capacity" or (scale.dtype == torch.float16) != f16:
            fail(f"tame 1B {mode} under LLMI_FORCE_CAPACITY=1: route {eng.decode_route}, "
                 f"scales {scale.dtype}")
        for run in (("f16 scales", "f32 scales") if f16 else ("",)):
            if run == "f32 scales":
                eng.weights = eng._prefill_w = f32_scales(eng.weights)
            what = f"tame 1B {mode} {run}".rstrip()
            if f16:
                first[run] = _first_step_logits(eng, golden["prompt"])
            got, stats, counts = _serve_golden(eng, f"{what} capacity", golden)
            if got != golden["tokens"][: golden["steps"]]:
                fail(f"{what} capacity: the stream diverges from the golden stream: {got[:12]}...")
            want = _single_want(mode, "capacity", L, stats.decode_steps)
            if stats.decode_steps == 0 or counts != want:
                fail(f"{what} capacity: launches {counts}, expected {want}")
            log(f"{what} capacity: the golden stream, {stats.decode_tok_per_s:.2f} tok/s")
            if run == "f16 scales":
                out["tame serve-q4 f16 scales"] = dict(counts=counts)
        del eng
        torch.cuda.empty_cache()
    for i, what in enumerate(("prefill", "first decode step")):
        a, b = first["f16 scales"][i], first["f32 scales"][i]
        if not torch.equal(a, b):
            fail(f"tame 1B serve-q4 capacity: the f16-scale {what} logits differ from the f32 "
                 f"twin's by {float((a - b).abs().max()):.3e}")
    log("tame 1B serve-q4 capacity: f16-scale prefill and first decode logits bit-equal to the "
        "f32 twin's")
    return worst, out


def f32_scales(w):
    """``w`` with its layers' raw f16 scale planes widened to dense f32: the
    same numbers in an f32 load's layout (the capacity load keeps centered
    Q4_0 nibbles' f16 d)."""
    import torch

    lw = w.layers
    return dataclasses.replace(w, layers=dataclasses.replace(lw, **{
        f: dataclasses.replace(t, scale=t.scale.float())
        for f in ("wqkv", "wo", "w_gate_up", "w_down")
        if (t := getattr(lw, f)).scale.dtype == torch.float16}))


def _stream_f16_scales(hp, cache, token, p, out) -> float:
    """Phase 13's raw-f16 part at the 12B widths: random centered Q4_0
    nibbles in every projection, their scales f16 values, once as f32 and
    once as f16 scale planes (the same numbers). The f16 step against its
    twin (_check_step_q: the bar, a second launch bit-equal), bit-equal to
    the f32 step; both timed (f32 first) beside their bounds. Returns the
    f16 step's max_abs_err."""
    import torch

    from llm_inference_tpu_torch.models.weights import LayerWeights
    from llm_inference_tpu_torch.ops.kernels import fused_decode_stream as fds
    from llm_inference_tpu_torch.quant.device import f16_scales

    S, pos = cache.k.shape[1], int(p.item())
    w = _random_lossless_model(hp, seed=23, nibble=True, variant=Q4_0_SYMMETRIC)
    parts = ("wqkv", "wo", "w_gate_up", "w_down")
    lw = w.layers
    w32 = dataclasses.replace(w, layers=dataclasses.replace(lw, **{
        f: dataclasses.replace(getattr(lw, f), scale=getattr(lw, f).scale.half().float())
        for f in parts}))
    w16 = dataclasses.replace(w, layers=dataclasses.replace(lw, **{
        f: dataclasses.replace(getattr(lw, f), scale=f16_scales(getattr(lw, f).scale.half()))
        for f in parts}))
    del w, lw
    assert isinstance(w16.layers, LayerWeights)
    consts = fds.prepare(hp, token.device, swa_mask=False, max_seq=S)
    for ww in (w32, w16):
        if not fds.decode_stream_supported(hp, ww, max_seq=S):
            fail("decode_step_stream: the 12B Q4_0 weights are not eligible")
    label = "12B random serve-q4 Q4_0 f16 scales"
    err, _ = _check_step_q(label, hp, w16, cache, token, p, consts,
                           step=fds.decode_step_stream, plain=fds.decode_step_stream_plain)
    ys = [fds.decode_step_stream(hp, ww, type(cache)(k=cache.k.clone(), v=cache.v.clone()),
                                 token, p, consts) for ww in (w32, w16)]
    torch.cuda.synchronize()
    if not torch.equal(ys[0], ys[1]):
        fail(f"decode_step_stream {label}: logits differ from the f32 scales' by "
             f"{float((ys[0] - ys[1]).abs().max()):.3e}")
    for tag, ww in (("f32", w32), ("f16", w16)):
        ms = time_ms(lambda i=0: fds.decode_step_stream(hp, ww, cache, token, p, consts), 20)
        plain = time_ms(lambda i=0: fds.decode_step_stream_plain(hp, ww, cache, token, p, consts),
                        2, warmup=1)
        nbytes, ops = _lossless_bytes(hp, ww, pos)
        b = bound_ms(nbytes, f32_ops=ops)
        log(f"decode_step_stream 12B random serve-q4 Q4_0 {tag} scales pos={pos}: kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms ({nbytes / 1e9:.4f} GB), "
            f"{nbytes / ms / 1e9:.3f} TB/s")
        out[f"random serve-q4 Q4_0 {tag} scales"] = dict(
            ms=ms, plain_ms=plain, bound_ms=b, bytes=nbytes, bound_by=bound_by(nbytes, f32_ops=ops))
    out["random serve-q4 Q4_0 f16 scales"]["err"] = err
    (plan16, _) = next(v for k, v in consts.scratch["plans"].items() if k[0][3] == 2)
    log(f"decode_step_stream {label}: bit-equal to the f32 scales; plan {plan16}")
    del w16, w32, consts
    torch.cuda.empty_cache()
    return err


def phase_g4_step():
    """Phase 15: the gemma4 whole step (fused_decode's gemma4 instance)
    against its plain twin at full GEOM_G4 width and depth (24 layers, the
    last 4 sharing K/V, D 2048, P 256), one step at position 300 over seeded
    K/V rows, with and without sliding windows (every fourth layer global:
    the shared layers read a windowed and a global source), on random rowq8
    weights: phase 4's bars, the argmax rule, no shared layer's cache slot
    touched, a planted fault; time, bound and per-phase profile."""
    import torch

    from llm_inference_tpu_torch.models.gemma import init_cache
    from llm_inference_tpu_torch.ops.kernels import fused_decode

    hp = hp_gemma4(**GEOM_G4, sliding_window=G4_WINDOW)
    dev = torch.device("cuda")
    w = random_g4_model(hp, seed=19)
    if not fused_decode.decode_supported(hp, w):
        fail("decode_step gemma4: the GEOM_G4 random model is not eligible")
    S, pos = STREAM_SEQ, STREAM_POS
    g = torch.Generator(device=dev).manual_seed(23)
    cache = init_cache(hp, S, device=dev)
    # cached keys as the model writes them: unit RMS times k_norm
    cache.k[:, :pos] = (G4_QK_NORM * torch.randn(cache.k[:, :pos].shape, device=dev, generator=g)
                        ).to(torch.bfloat16)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
    token = torch.tensor([222222], dtype=torch.int64, device=dev)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    worst = 0.0
    for swa in (False, True):
        consts = fused_decode.prepare(hp, dev, swa_mask=swa, max_seq=S)
        err, _ = check_g4_step(f"GEOM_G4 swa={swa}", hp, w, cache, token, p, consts)
        worst = max(worst, err)
    (plan, _), = consts.scratch["plans"].values()
    log(f"decode_step gemma4: tile plan {plan}")
    consts = fused_decode.prepare(hp, dev, swa_mask=False, max_seq=S)
    ms = time_ms(lambda i=0: fused_decode.decode_step(hp, w, cache, token, p, consts), 50)
    plain = time_ms(lambda i=0: fused_decode.decode_step_plain(hp, w, cache, token, p, consts), 3,
                    warmup=1)
    nbytes, ops = g4_step_bytes(hp, pos)
    b = bound_ms(nbytes, f32_ops=ops)
    zero_kv = (hp.block_count - hp.n_kv_layers) * hp.n_head_kv * (
        hp.n_embd_head_k + hp.n_embd_head_v) * (hp.embedding_length + 4)
    log(f"decode_step gemma4 GEOM_G4 pos={pos}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{b:.4f} ms ({nbytes / 1e9:.4f} GB, {ops / 1e9:.2f} GFLOP f32), "
        f"{nbytes / ms / 1e9:.3f} TB/s; the kernel also streams the shared layers' zero K/V "
        f"rows, {zero_kv / 1e6:.2f} MB past the bound's bytes")
    prof = _step_profile("decode_step gemma4 GEOM_G4", lambda pr: fused_decode.decode_step(
        hp, w, cache, token, p, consts, profile=pr), hp,
        hp.block_count * fused_decode.PROFILE_MARKS_G4 + 3, gemma4=True)
    del w, cache, consts
    torch.cuda.empty_cache()
    return worst, {"ms": ms, "plain_ms": plain, "bound_ms": b, "library_ms": None,
                   "bound_by": bound_by(nbytes, f32_ops=ops), "profile": prof}


def g4_golden() -> dict:
    """tests/golden/gemma4_g4_tame.json, checked against this file's
    gemma4 checkpoint recipe."""
    path = ROOT / "tests" / "golden" / "gemma4_g4_tame.json"
    if not path.exists():
        fail(f"missing {path}")
    golden = json.loads(path.read_text())
    ck = golden["checkpoint"]
    if (ck["seed"], ck["weight_std"], ck["geometry"], ck["vocab_size"], ck["sliding_window"]) != (
            G4_SEED, TAME_STD, GEOM_G4, VOCAB_SIZE, G4_WINDOW):
        fail("the gemma4 golden stream was recorded on another checkpoint")
    return golden


G4_SERVER = dict(max_batch=8, max_seq=256, decode_chunk=16, max_admit_per_step=8)
G4_PAGE, G4_PAGES = 64, 16  # 2 pages a 64-token request, 3 the golden one: one waits


def phase_g4_slice():
    """Phase 16: the tame gemma4 checkpoint (gemma4_checkpoint, GEOM_G4 at
    full width and depth) under Engine(mode="serve-q8") on cuda, on both
    decode routes (the per-op one forced with LLMI_NO_FUSED_DECODE=1): the
    golden prompt's 100 greedy tokens equal to tests/golden/gemma4_g4_tame.json
    on both; the kernel route launches one gemma4 decode_step a decode step
    and 6 x 24 + 1 = 145 quant_matmul in the prefill (QKV or a shared
    layer's Q, Wo, gate/up, down, the per-layer gate and proj, and the
    per_layer_model_proj; the logits take the W8A8 product), the per-op
    route 145 a prefill and a decode step. Then BatchedServer on the per-op
    route, dense and paged (LLMI_PAGE=64, 16 pages), on 8 requests (the
    golden one at 100 tokens, 7 more of 64): the golden lane equals the
    golden's server_tokens (the W8A8 products the per-op server takes on
    the card; tools/bake_golden_gemma4.py says why that stream is baked
    apart from ``tokens``, which it equals on this checkpoint), the two
    servers' streams are identical, and each decode
    step launches 20 insert_kv_rows (the owner layers) and 24 flash_decode
    or paged_flash_decode. Decode tok/s, TTFT, and the load's peak device
    memory."""
    import os

    import torch

    from llm_inference_tpu_torch.engine import Engine, GenerationStats
    from llm_inference_tpu_torch.ops.kernels import flash_decode, kv_insert
    from llm_inference_tpu_torch.serving import BatchedServer

    golden = g4_golden()
    path = gemma4_checkpoint()
    digest = sha256_of(path)
    if digest != golden["checkpoint"]["sha256"]:
        fail(f"the gemma4 checkpoint's sha256 {digest} is not the golden's "
             f"{golden['checkpoint']['sha256']}")
    g = GEOM_G4
    L, n_kv = g["n_layers"], g["n_layers"] - g["shared_kv_layers"]
    per_fwd = 6 * L + 1
    steps = golden["steps"]
    results, streams = {}, {}
    for route in ("kernel", "per-op"):
        if route == "per-op":
            os.environ["LLMI_NO_FUSED_DECODE"] = "1"
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            eng = Engine(str(path), mode="serve-q8", max_seq=1024, decode_chunk=16, device="cuda")
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        finally:
            os.environ.pop("LLMI_NO_FUSED_DECODE", None)
        held = (torch.cuda.memory_allocated() - base) / 1e9
        if eng.decode_route != route:
            fail(f"gemma4 serve-q8: expected the {route} route, got {eng.decode_route}")
        log(f"gemma4 serve-q8 {route}: load {t_load:.1f} s, peak device memory of the load "
            f"{peak:.2f} GB, held {held:.2f} GB")
        got, stats, counts = _serve_golden(eng, f"gemma4 serve-q8 {route}", golden)
        want = {k: 0 for k in counts}
        if route == "kernel":
            want.update(quant_matmul=per_fwd, decode_step=stats.decode_steps)
        else:
            want.update(quant_matmul=per_fwd * (stats.decode_steps + 1))
        if stats.decode_steps == 0 or counts != want:
            fail(f"gemma4 serve-q8 {route}: launches {counts}, expected {want}")
        n_match = next((i for i, (a, b) in enumerate(zip(got, golden["tokens"])) if a != b),
                       min(len(got), len(golden["tokens"])))
        log(f"gemma4 serve-q8 {route}: {n_match}/{steps} tokens match the golden stream")
        if got != golden["tokens"][:steps]:
            fail(f"gemma4 serve-q8 {route}: the stream diverges from the golden stream at token "
                 f"{n_match}: {got[:12]}... vs {golden['tokens'][:12]}...")
        ttfts = [stats.prefill_seconds]
        for _ in range(6):
            s1 = GenerationStats()
            eng.generate_from_ids(golden["prompt"], n_predict=1, stats=s1)
            ttfts.append(s1.prefill_seconds)
        streams[route] = got
        results[route] = dict(decode_tok_s=stats.decode_tok_per_s,
                              ttft_ms=float(np.median(ttfts)) * 1e3, load_s=t_load, peak_gb=peak,
                              held_gb=held, counts=counts, decode_steps=stats.decode_steps)
        log(f"gemma4 serve-q8 {route}: decode {stats.decode_tok_per_s:.2f} tok/s, TTFT (median "
            f"of seven) {results[route]['ttft_ms']:.2f} ms; TTFTs (ms) "
            f"{', '.join(f'{t * 1e3:.2f}' for t in ttfts)}")
        del eng
        torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    prompts = [[2] + rng.integers(10, 10000, size=31).tolist() for _ in range(8)]
    if prompts[0] != golden["prompt"]:
        fail("the gemma4 server's first prompt is not the golden prompt")
    reqs = [(q, steps if i == 0 else 64) for i, q in enumerate(prompts)]
    server_golden = golden["server_tokens"][:steps]
    mods = {"insert_rows": kv_insert, "flash_decode": flash_decode}
    srv_streams = {}
    for paged in (False, True):
        route = "paged-per-op" if paged else "per-op"
        old_page = os.environ.get("LLMI_PAGE")
        os.environ["LLMI_PAGE"] = str(G4_PAGE)
        try:
            t0 = time.perf_counter()
            srv = BatchedServer(str(path), mode="serve-q8", device="cuda",
                                kv_pages=G4_PAGES if paged else None, **G4_SERVER)
        finally:
            if old_page is None:
                os.environ.pop("LLMI_PAGE", None)
            else:
                os.environ["LLMI_PAGE"] = old_page
        if srv.decode_route != route:
            fail(f"gemma4 server: expected the {route} route, got {srv.decode_route}")
        srv.tokenizer.eos_id = -1
        srv.tokenizer.end_of_turn_id = -1
        srv.run([(q, 4) for q, _ in reqs[:2]])  # warm-up
        torch.cuda.synchronize()
        log(f"gemma4 server {route}: load + warm-up {time.perf_counter() - t0:.1f} s")
        kv_insert.launches = flash_decode.launches = flash_decode.paged_launches = 0
        from llm_inference_tpu_torch.serving import ServerStats

        srv.stats = ServerStats()
        handles = [srv.submit(q, n) for q, n in reqs]
        while srv.step():
            pass
        torch.cuda.synchronize()
        st = srv.stats
        counts = {"insert_rows": kv_insert.launches,
                  "flash_decode": flash_decode.paged_launches if paged else flash_decode.launches,
                  "other_flash": flash_decode.launches if paged else flash_decode.paged_launches}
        outs = [h.out for h in handles]
        srv_streams[route] = outs
        want = {"insert_rows": n_kv * st.decode_steps, "flash_decode": L * st.decode_steps,
                "other_flash": 0}
        log(f"gemma4 server {route}: decode steps {st.decode_steps}, launches {counts}")
        n_match = next((i for i, (a, b) in enumerate(zip(outs[0], server_golden)) if a != b),
                       min(len(outs[0]), steps))
        log(f"gemma4 server {route}: {n_match}/{steps} tokens of the golden lane match the "
            f"golden's server_tokens")
        if outs[0] != server_golden:
            fail(f"gemma4 server {route}: the golden lane diverges from the golden's "
                 f"server_tokens at token {n_match}: {outs[0][:12]}... vs {server_golden[:12]}...")
        if any(len(o) != n for o, (_, n) in zip(outs, reqs)):
            fail(f"gemma4 server {route}: a request ended short of its n_predict")
        if st.decode_steps == 0 or counts != want:
            fail(f"gemma4 server {route}: launches {counts}, expected {want}")
        if paged and sorted(srv._free_pages) != list(range(G4_PAGES)):
            fail("gemma4 paged server: pages leaked")
        tok_s = sum(len(o) for o in outs) / st.decode_seconds
        ttft = float(np.percentile([h.ttft_s for h in handles], 50)) * 1e3
        log(f"gemma4 server {route}: {sum(len(o) for o in outs)} tokens, decode {tok_s:.2f} tok/s "
            f"aggregate, p50 TTFT {ttft:.2f} ms")
        results[f"server {route}"] = dict(tok_s=tok_s, ttft_ms=ttft, counts=counts,
                                          decode_steps=st.decode_steps)
        del srv
        torch.cuda.empty_cache()
    if srv_streams["per-op"] != srv_streams["paged-per-op"]:
        fail("gemma4 server: the dense and paged streams differ")
    log("gemma4: both serve-q8 routes and both servers give the golden stream")
    return results


# Tokens of phase 14's per-op runs, the 12B capacity streams' reference: at
# 12B that route decodes about 5 tokens a second on an NVIDIA H100 80GB HBM3
# at 700 W (PERF.md section 4). Its 8 tokens must be the first 8 of the
# capacity route's, whose stream is held at 100.
CAPACITY_PER_OP_TOKENS = 8


def phase_capacity_slice(golden):
    """Phase 14: the tame Gemma-3-12B checkpoint (capacity_checkpoint, full
    width and depth) under Engine(mode="serve-q4") and Engine(mode="serve-q")
    on cuda: the capacity route, one capacity step a decode step, 100 greedy
    tokens of the golden prompt, the same in both modes, whose first
    CAPACITY_PER_OP_TOKENS must be the per-op route's (LLMI_NO_FUSED_DECODE=1);
    decode tok/s, TTFT (median of seven), checkpoint -> first token, and the
    peak device memory of the capacity load against the standard (per-op)
    one."""
    import os

    import torch

    from llm_inference_tpu_torch.engine import Engine, GenerationStats

    path = capacity_checkpoint()
    L = GEOM_12B["n_layers"]
    results, capacity = {}, {}
    for mode in ("serve-q4", "serve-q"):
        streams = {}
        for route in ("capacity", "per-op"):
            if route == "per-op":
                os.environ["LLMI_NO_FUSED_DECODE"] = "1"
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                eng = Engine(str(path), mode=mode, max_seq=1024, decode_chunk=16, device="cuda")
                torch.cuda.synchronize()
                t_load = time.perf_counter() - t0
                peak = (torch.cuda.max_memory_allocated() - base) / 1e9
                first = GenerationStats()
                eng.generate_from_ids(golden["prompt"], n_predict=1, stats=first)
                torch.cuda.synchronize()
                to_first = time.perf_counter() - t0
            finally:
                os.environ.pop("LLMI_NO_FUSED_DECODE", None)
            if eng.decode_route != route:
                fail(f"12B {mode}: expected the {route} route, got {eng.decode_route}")
            held = (torch.cuda.memory_allocated() - base) / 1e9
            log(f"12B {mode} {route}: load {t_load:.1f} s, checkpoint -> first token "
                f"{to_first:.1f} s; peak device memory of the load {peak:.2f} GB, held "
                f"{held:.2f} GB")
            got, stats, counts = _serve_golden(
                eng, f"12B {mode} {route}", golden,
                golden["steps"] if route == "capacity" else CAPACITY_PER_OP_TOKENS)
            want = _single_want(mode, route, L, stats.decode_steps)
            if stats.decode_steps == 0 or counts != want:
                fail(f"12B {mode} {route}: launches {counts}, expected {want}")
            ttfts = [stats.prefill_seconds]
            for _ in range(6):
                s1 = GenerationStats()
                eng.generate_from_ids(golden["prompt"], n_predict=1, stats=s1)
                ttfts.append(s1.prefill_seconds)
            streams[route] = got
            perf = dict(decode_tok_s=stats.decode_tok_per_s, ttft_ms=float(np.median(ttfts)) * 1e3,
                        to_first_s=to_first, load_s=t_load, peak_gb=peak, counts=counts,
                        decode_steps=stats.decode_steps)
            log(f"12B {mode} {route}: decode {perf['decode_tok_s']:.2f} tok/s, TTFT (median of "
                f"seven) {perf['ttft_ms']:.2f} ms; TTFTs (ms) "
                f"{', '.join(f'{t * 1e3:.2f}' for t in ttfts)}; stream {got[:8]}...")
            results[(mode, route)] = perf
            del eng
            torch.cuda.empty_cache()
        n_op = CAPACITY_PER_OP_TOKENS
        if (streams["capacity"][:n_op] != streams["per-op"] or len(streams["per-op"]) != n_op
                or len(streams["capacity"]) != golden["steps"]):
            n = next((i for i, (a, b) in enumerate(zip(*streams.values())) if a != b), None)
            fail(f"12B {mode}: the capacity stream differs from the per-op route's at token {n}")
        log(f"12B {mode}: the per-op stream ({n_op} tokens) is the capacity stream's first "
            f"{n_op} of {golden['steps']}")
        capacity[mode] = streams["capacity"]
    if capacity["serve-q4"] != capacity["serve-q"]:
        n = next((i for i, (a, b) in enumerate(zip(*capacity.values())) if a != b), None)
        fail(f"12B: the serve-q4 and serve-q capacity streams differ at token {n}")
    log(f"12B: the serve-q4 and serve-q capacity streams are the same {golden['steps']} tokens")
    return results


def _tp_mesh(n: int):
    import torch

    from llm_inference_tpu_torch.parallel import make_mesh

    return make_mesh(model=n, devices=[torch.device("cuda", 0)] * n)


def _check_tp_step(label: str, hp, w, tw, cache, token, p, swa: bool, lossless: bool) -> float:
    """One tensor-parallel step against its plain twin and against the
    single-chip kernel on the same weights (phase 17); fails on a
    disagreement. Returns max|kernel - plain|."""
    import torch

    from llm_inference_tpu_torch.ops.kernels import (fused_decode, fused_decode_q,
                                                     fused_decode_q_tp, fused_decode_tp)

    mod = fused_decode_q_tp if lossless else fused_decode_tp
    step = mod.decode_step_q_tp if lossless else mod.decode_step_tp
    plain = mod.decode_step_q_tp_plain if lossless else mod.decode_step_tp_plain
    single = fused_decode_q if lossless else fused_decode
    single_step = single.decode_step_q if lossless else single.decode_step
    S, pos, n = cache.k.shape[1], int(p.item()), tw.n
    what = step.__name__
    consts = mod.prepare(hp, tw, swa_mask=swa, max_seq=S)
    c1 = single.prepare(hp, p.device, swa_mask=swa, max_seq=S)

    def replicas():
        return [type(cache)(k=cache.k.clone(), v=cache.v.clone()) for _ in range(n)]

    ck, cp, cf = replicas(), replicas(), replicas()
    cs = type(cache)(k=cache.k.clone(), v=cache.v.clone())
    y = step(hp, tw, ck, token, p, consts)
    y_again = step(hp, tw, replicas(), token, p, consts)  # a second launch: the next epoch
    ref = plain(hp, tw, cp, token, p, consts)
    y1 = single_step(hp, w, cs, token, p, c1)
    # the planted fault: rank 1's Wo partial of layer FAULT_LAYER left out
    # of its all-reduce (its row scales zeroed in a copy of its shard)
    rw = tw.ranks[1]
    wo = dataclasses.replace(rw.layers.wo, scale=rw.layers.wo.scale.clone())
    wo.scale[FAULT_LAYER].zero_()
    bad = dataclasses.replace(tw, ranks=[tw.ranks[0], dataclasses.replace(
        rw, layers=dataclasses.replace(rw.layers, wo=wo))] + tw.ranks[2:])
    faulted = plain(hp, bad, cf, token, p, consts)
    torch.cuda.synchronize()
    scale = max(1.0, ref.abs().max().item())
    tol = 1.5e-2 * scale
    err = (y - ref).abs().max().item()
    err1 = (y - y1).abs().max().item()
    fault = (faulted - ref).abs().max().item() / scale
    top2 = ref.topk(2).values
    decisive = (top2[0] - top2[1]).item() > 2 * tol
    same = int(y.argmax()) == int(ref.argmax()) == int(y1.argmax())
    bit_equal = all(torch.equal(c.k, ck[0].k) and torch.equal(c.v, ck[0].v) for c in ck)
    kv0 = max(((ck[0].k[0, pos].float() - cp[0].k[0, pos].float()).abs()
               / (cp[0].k[0, pos].float().abs() + 1e-3)).max().item(),
              ((ck[0].v[0, pos].float() - cp[0].v[0, pos].float()).abs()
               / (cp[0].v[0, pos].float().abs() + 1e-3)).max().item())
    untouched = all(torch.equal(c.k[:, :pos], cache.k[:, :pos])
                    and torch.equal(c.k[:, pos + 1:], cache.k[:, pos + 1:])
                    and torch.equal(c.v[:, :pos], cache.v[:, :pos]) for c in ck)
    log(f"{what} {label} n={n} swa={swa}: logits err/max(1,max|logits|) vs plain "
        f"{err / scale:.3e}, vs the single-chip kernel {err1 / scale:.3e} (bar 1.5e-2); argmax "
        f"{int(y.argmax())} / plain {int(ref.argmax())} / single {int(y1.argmax())} (top-2 gap "
        f"{(top2[0] - top2[1]).item():.3e}, decisive {decisive}); replicas bit-equal "
        f"{bit_equal}; layer-0 K/V row max_rel_err {kv0:.3e} (tol {2 ** -7:.3e}); a second "
        f"launch bit-equal {bool(torch.equal(y, y_again))}; planted fault (rank 1's Wo partial "
        f"of layer {FAULT_LAYER} left out) moves the plain logits by {fault:.3e}")
    if not err <= tol or not err1 <= tol or (decisive and not same):
        fail(f"{what} {label} n={n} swa={swa}: kernel logits disagree with plain or single-chip")
    if not bit_equal or not kv0 <= 2 ** -7 or not untouched:
        fail(f"{what} {label} n={n} swa={swa}: the cache replicas disagree")
    if not torch.equal(y, y_again):
        fail(f"{what} {label} n={n}: a second launch gives other logits")
    if not fault > 1.5e-2:
        fail(f"{what} {label} n={n}: the planted fault stays inside the bar")
    return err


def phase_tp_step():
    """Phase 17: the tensor-parallel steps on one card, meshes [cuda:0] * n:
    the rowq8 step at n = 2 and 4 and the lossless step at n = 2 in serve-q
    (int8) and serve-q4 (nibbles, Q4_K offsets), full 1B width and depth,
    one step at position 300 over seeded K/V rows, with and without sliding
    windows, each against its plain twin and the single-chip kernel, replicas
    bit-equal, a planted fault; times and bounds."""
    import torch

    from llm_inference_tpu_torch.models.gemma import init_cache
    from llm_inference_tpu_torch.ops.kernels import (fused_decode_q_tp, fused_decode_tp)

    hp = _hp_1b()
    dev = torch.device("cuda")
    S, pos = 1024, 300
    g = torch.Generator(device=dev).manual_seed(17)
    cache = init_cache(hp, S, device=dev)
    cache.k[:, :pos] = torch.randn(cache.k[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
    cache.v[:, :pos] = torch.randn(cache.v[:, :pos].shape, device=dev, generator=g).to(torch.bfloat16)
    token = torch.tensor([12345], dtype=torch.int64, device=dev)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    out = {}
    worst = {"decode_step_tp": 0.0, "decode_step_q_tp": 0.0}
    sets = [("random rowq8", None, (2, 4)), ("random serve-q int8", False, (2,)),
            ("random serve-q4 nibble+offsets", True, (2,))]
    for label, nibble, ns in sets:
        lossless = nibble is not None
        w = _random_lossless_model(hp, seed=7, nibble=nibble) if lossless else \
            _random_model(hp, seed=2)
        mod = fused_decode_q_tp if lossless else fused_decode_tp
        ok = mod.tp_decode_q_supported if lossless else mod.tp_decode_supported
        key = "decode_step_q_tp" if lossless else "decode_step_tp"
        for n in ns:
            if not ok(hp, w, n):
                fail(f"{key}: the {label} weights are not eligible at n={n}")
            tw = mod.shard_for_tp(hp, w, n, _tp_mesh(n).model_devices)
            for swa in (False, True):
                worst[key] = max(worst[key], _check_tp_step(label, hp, w, tw, cache, token, p,
                                                            swa, lossless))
            consts = mod.prepare(hp, tw, swa_mask=False, max_seq=S)
            caches = [type(cache)(k=cache.k.clone(), v=cache.v.clone()) for _ in range(n)]
            step = mod.decode_step_q_tp if lossless else mod.decode_step_tp
            step(hp, tw, caches, token, p, consts)
            (plan, _), = consts.step[0].scratch["plans"].values()
            log(f"{key} {label} n={n}: a rank's tile plan {plan}")
            plain = mod.decode_step_q_tp_plain if lossless else mod.decode_step_tp_plain
            ms = time_ms(lambda i=0: step(hp, tw, caches, token, p, consts), 50)
            plain_ms = time_ms(lambda i=0: plain(hp, tw, caches, token, p, consts), 3, warmup=1)
            nbytes, ops = tp_step_bytes(hp, tw, pos)
            b = bound_ms(nbytes, f32_ops=ops)
            log(f"{key} {label} n={n} 1B pos={pos}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {b:.4f} ms ({nbytes / 1e9:.4f} GB over all ranks, {ops / 1e9:.2f} GFLOP "
                "f32; on n distinct cards the bound would be per card)")
            out[(label, n)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bytes=nbytes,
                                   bound_by=bound_by(nbytes, f32_ops=ops))
            del tw, consts
            torch.cuda.empty_cache()
        del w
        torch.cuda.empty_cache()
    del cache
    torch.cuda.empty_cache()
    return worst, out


TP_RUNS = (("serve-q8", 2), ("serve-q", 2), ("serve-q4", 2), ("serve-q8", 4))


def phase_tp_slice():
    """Phase 18: the tame 1B checkpoint under Engine(mode, tp_mesh=[cuda:0] *
    n) for TP_RUNS: the golden prompt's 100 greedy tokens equal to the golden
    stream, one tensor-parallel launch a decode step, 4 x 26 per-op matmuls
    (quant_matmul, the grouped quant_matmul, q4_matmul) a prefill. Decode
    tok/s and median TTFT per run."""
    import torch

    from llm_inference_tpu_torch.engine import Engine, GenerationStats
    from llm_inference_tpu_torch.ops.kernels import fused_decode_q_tp, fused_decode_tp

    golden = json.loads((ROOT / "tests" / "golden" / "parity_1b_tame.json").read_text())
    path = tame_checkpoint()
    prompt, steps = golden["prompt"], golden["steps"]
    L = GEOM_1B["n_layers"]
    results = {}

    def counts():
        c = _single_counts()
        c.update(decode_step_tp=fused_decode_tp.launches, decode_step_q_tp=fused_decode_q_tp.launches)
        return c

    for mode, n in TP_RUNS:
        t0 = time.perf_counter()
        eng = Engine(str(path), mode=mode, max_seq=1024, decode_chunk=16, device="cuda",
                     tp_mesh=_tp_mesh(n))
        torch.cuda.synchronize()
        if eng.decode_route != "tp":
            fail(f"{mode} n={n}: expected the tp route, got {eng.decode_route}")
        eng.tokenizer.eos_id = -1  # random weights may argmax onto <eos>: never stop early
        eng.tokenizer.end_of_turn_id = -1
        eng.generate_from_ids(prompt, n_predict=8)  # warm-up
        log(f"{mode} tp n={n}: Engine load + warm-up {time.perf_counter() - t0:.1f} s")
        _zero_single_counts()
        fused_decode_tp.launches = fused_decode_q_tp.launches = 0
        stats = GenerationStats()
        out = eng.generate_from_ids(prompt, n_predict=steps, stats=stats)
        torch.cuda.synchronize()
        got = counts()
        n_match = next((i for i, (a, b) in enumerate(zip(out, golden["tokens"])) if a != b),
                       min(len(out), len(golden["tokens"])))
        log(f"{mode} tp n={n}: {n_match}/{steps} tokens match the golden stream; launches {got}; "
            f"decode steps {stats.decode_steps}")
        if out != golden["tokens"][:steps] or len(out) != steps:
            fail(f"{mode} tp n={n}: the greedy stream diverges from the golden stream at token "
                 f"{n_match}: {out[:12]}... vs {golden['tokens'][:12]}...")
        want = {k: 0 for k in got}
        want["decode_step_q_tp" if mode != "serve-q8" else "decode_step_tp"] = stats.decode_steps
        want[{"serve-q8": "quant_matmul", "serve-q": "quant_matmul_grouped",
              "serve-q4": "q4_matmul"}[mode]] = 4 * L
        if stats.decode_steps == 0 or got != want:
            fail(f"{mode} tp n={n}: launches {got}, expected {want}")
        ttfts = [stats.prefill_seconds]
        for _ in range(6):
            s1 = GenerationStats()
            eng.generate_from_ids(prompt, n_predict=1, stats=s1)
            ttfts.append(s1.prefill_seconds)
        perf = dict(decode_tok_s=stats.decode_tok_per_s, ttft_ms=float(np.median(ttfts)) * 1e3,
                    counts=got, decode_steps=stats.decode_steps)
        log(f"{mode} tp n={n}: decode {perf['decode_tok_s']:.2f} tok/s, TTFT (median of seven) "
            f"{perf['ttft_ms']:.2f} ms; TTFTs (ms) {', '.join(f'{t * 1e3:.2f}' for t in ttfts)}")
        results[(mode, n)] = perf
        del eng
        torch.cuda.empty_cache()
    return results


SERVE_REQUESTS = 4    # phase 19's server requests: the first four of phase 7's
SERVE_TOKENS = 64     # ... each asking for this many tokens (the golden's prefix)
PARITY_TOKENS = 16    # phase 19's parity Engine: the golden's first 16 tokens
PARITY_LANE_TOKENS = 8


def _serve_parity_counts() -> dict:
    """The launch counts of every kernel a serve or parity run could reach."""
    from llm_inference_tpu_torch.ops.kernels import flash_decode, kv_insert

    return {**_single_counts(), "flash_decode": flash_decode.launches,
            "paged_flash_decode": flash_decode.paged_launches,
            "insert_kv_rows": kv_insert.launches}


def _zero_serve_parity_counts() -> None:
    from llm_inference_tpu_torch.ops.kernels import flash_decode, kv_insert

    _zero_single_counts()
    flash_decode.launches = flash_decode.paged_launches = kv_insert.launches = 0


def _golden_prefix(out, golden, n: int, what: str) -> None:
    want = golden["tokens"][:n]
    n_match = next((i for i, (a, b) in enumerate(zip(out, want)) if a != b), min(len(out), n))
    log(f"{what}: {n_match}/{n} tokens match the golden stream")
    if out != want:
        fail(f"{what}: the greedy stream diverges from the golden stream at token {n_match}: "
             f"{out[:12]}... vs {want[:12]}...")


def _engine_run(eng, prompt, n: int, ttft_runs: int):
    """(stream, stats, median TTFT ms over ``ttft_runs`` prefills) after a
    one-token warm-up; the counts are set to 0 just before the measured run."""
    import torch

    from llm_inference_tpu_torch.engine import GenerationStats

    eng.tokenizer.eos_id = -1  # random weights may argmax onto <eos>: never stop early
    eng.tokenizer.end_of_turn_id = -1
    eng.generate_from_ids(prompt, n_predict=2)  # warm-up
    torch.cuda.synchronize()
    _zero_serve_parity_counts()
    stats = GenerationStats()
    out = eng.generate_from_ids(prompt, n_predict=n, stats=stats)
    torch.cuda.synchronize()
    counts = _serve_parity_counts()
    ttfts = [stats.prefill_seconds]
    for _ in range(ttft_runs - 1):
        s1 = GenerationStats()
        eng.generate_from_ids(prompt, n_predict=1, stats=s1)
        ttfts.append(s1.prefill_seconds)
    return out, stats, counts, float(np.median(ttfts)) * 1e3


def _profile_mode_step(what: str, eng, pos: int, calls: int = 3) -> None:
    """Device time against wall time of one single-stream decode step of
    ``eng``'s mode at ``pos`` (over a fresh cache), under torch.profiler."""
    import torch

    from llm_inference_tpu_torch.models.gemma import forward

    cache = eng.new_cache()
    tok = torch.full((1,), 8467, dtype=torch.int64, device="cuda")
    _profile_kernels(f"{what} decode step (pos {pos})", lambda: forward(
        eng.hparams, eng.weights, cache, tok, pos, exact=eng.exact), calls, top=6)


def phase_serve_parity():
    """Phase 19: the serve and parity modes on the tame 1B checkpoint at full
    width and depth (the parity runs cut to the golden's first 32 tokens and
    two lanes of 16: the parity attention walks the cache slot by slot), and
    the CLI's --trace (cut: -n 1, the prefill's taps)."""
    import os
    import shutil

    import torch

    from llm_inference_tpu_torch.engine import Engine
    from llm_inference_tpu_torch.serving import BatchedServer, ServerStats

    golden = json.loads((ROOT / "tests" / "golden" / "parity_1b_tame.json").read_text())
    path = tame_checkpoint()
    prompt, steps = golden["prompt"], golden["steps"]
    L = GEOM_1B["n_layers"]
    results = {}
    none = {k: 0 for k in _serve_parity_counts()}
    # serve: bf16 weights, per op; under LLMI_FLASH_DECODE=1 flash_decode attends
    for attend in ("masked", "flash"):
        if attend == "flash":
            os.environ["LLMI_FLASH_DECODE"] = "1"
        try:
            t0 = time.perf_counter()
            eng = Engine(str(path), mode="serve", max_seq=1024, decode_chunk=16, device="cuda")
            if eng.decode_route != "per-op":
                fail(f"serve: expected the per-op route, got {eng.decode_route}")
            out, stats, counts, ttft = _engine_run(eng, prompt, steps, 5)
            _profile_mode_step(f"serve {attend}", eng, 100)
        finally:
            os.environ.pop("LLMI_FLASH_DECODE", None)
        log(f"serve {attend}: load + run {time.perf_counter() - t0:.1f} s; launches {counts}; "
            f"decode steps {stats.decode_steps}")
        _golden_prefix(out, golden, steps, f"serve {attend}")
        want = dict(none, flash_decode=L * stats.decode_steps if attend == "flash" else 0)
        if stats.decode_steps == 0 or counts != want:
            fail(f"serve {attend}: launches {counts}, expected {want}")
        results[("serve", attend)] = dict(decode_tok_s=stats.decode_tok_per_s, ttft_ms=ttft)
        del eng
        torch.cuda.empty_cache()
    # serve's servers: dense lanes and the paged pool, per op
    reqs = [(p, SERVE_TOKENS) for p, _ in _server_requests(golden)[:SERVE_REQUESTS]]
    streams = {}
    for route in ("per-op", "paged-per-op"):
        t0 = time.perf_counter()
        srv = BatchedServer(str(path), mode="serve", max_batch=SERVE_REQUESTS, max_seq=BATCH_SEQ,
                            decode_chunk=32, max_admit_per_step=SERVE_REQUESTS, device="cuda",
                            kv_pages=2 * SERVE_REQUESTS if route == "paged-per-op" else None)
        if srv.decode_route != route:
            fail(f"serve server: expected the {route} route, got {srv.decode_route}")
        srv.tokenizer.eos_id = -1
        srv.tokenizer.end_of_turn_id = -1
        srv.run([(p, 4) for p, _ in reqs])  # warm-up
        torch.cuda.synchronize()
        srv.stats = ServerStats()
        _zero_serve_parity_counts()
        handles = [srv.submit(p, n) for p, n in reqs]
        while srv.step():
            pass
        torch.cuda.synchronize()
        counts, st = _serve_parity_counts(), srv.stats
        outs = streams[route] = [h.out for h in handles]
        log(f"serve server {route}: load + run {time.perf_counter() - t0:.1f} s; launches "
            f"{counts}; decode steps {st.decode_steps}")
        _golden_prefix(outs[0], golden, SERVE_TOKENS, f"serve server {route}")
        if any(len(o) != SERVE_TOKENS for o in outs):
            fail(f"serve server {route}: a request ended short of its {SERVE_TOKENS} tokens")
        attn = "paged_flash_decode" if route == "paged-per-op" else "flash_decode"
        want = dict(none, insert_kv_rows=L * st.decode_steps, **{attn: L * st.decode_steps})
        if st.decode_steps == 0 or counts != want:
            fail(f"serve server {route}: launches {counts}, expected {want}")
        results[("serve server", route)] = dict(
            tok_s=sum(len(o) for o in outs) / st.decode_seconds,
            ttft_ms=float(np.percentile([h.ttft_s for h in handles], 50)) * 1e3)
        del srv
        torch.cuda.empty_cache()
    if streams["per-op"] != streams["paged-per-op"]:
        fail("serve server: the dense and paged streams differ")
    # parity: the exact contract, f16 caches, the parity attention; f32 scores on the card
    t0 = time.perf_counter()
    eng = Engine(str(path), mode="parity", max_seq=1024, decode_chunk=16, device="cuda")
    out, stats, counts, ttft = _engine_run(eng, prompt, PARITY_TOKENS, 2)
    log(f"parity: load + run {time.perf_counter() - t0:.1f} s; launches {counts}; "
        f"decode steps {stats.decode_steps}")
    _golden_prefix(out, golden, PARITY_TOKENS, "parity")
    if counts != none:
        fail(f"parity: launches {counts}, expected none")
    results[("parity", "per-op")] = dict(decode_tok_s=stats.decode_tok_per_s, ttft_ms=ttft)
    _profile_mode_step("parity", eng, 40, calls=1)
    # the CLI's --trace (a process of its own; cut: -n 1, its prefill's taps)
    # against this engine's eager taps of the same prefill
    from llm_inference_tpu_torch import trace
    from llm_inference_tpu_torch.engine import prefill_bucket
    from llm_inference_tpu_torch.models.gemma import forward

    tmp = Path(tempfile.mkdtemp(prefix="llmi_trace_"))
    try:
        cli_prompt = "t5 t6 t7"
        ids = eng.tokenizer.encode(cli_prompt, False).ids
        session = trace.enable_trace(str(tmp / "unused.npz"))
        try:
            padded = torch.zeros(prefill_bucket(len(ids)), dtype=torch.int64, device="cuda")
            padded[: len(ids)] = torch.tensor(ids)
            forward(eng.hparams, eng._prefill_w, eng.new_cache(), padded, 0, len(ids),
                    exact=True)
        finally:
            trace.disable_trace()
        taps = session.records
        del eng
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        npz = tmp / "trace.npz"
        proc = subprocess.run(
            [sys.executable, "-m", "llm_inference_tpu_torch", "-m", str(path), "-p", cli_prompt,
             "-n", "1", "--no-cnv", "--max-seq", "256", "--trace", str(npz)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0 or not npz.exists():
            fail(f"--trace: exit code {proc.returncode}: {proc.stderr[-2000:]}")
        with np.load(npz) as z:
            got = [(k.split("|", 1)[1], z[k]) for k in sorted(z.keys())]
        if [n for n, _ in got] != [n for n, _ in taps]:
            fail(f"--trace: {len(got)} records, not the eager prefill's {len(taps)} taps")
        bad = [n for n, v in got if not np.isfinite(v).all()]
        if bad:
            fail(f"--trace: {len(bad)} records hold NaN or inf, the first {bad[0]}")
        gaps = [(float(np.abs(v - w).max()) / max(1.0, float(np.abs(w).max())), n)
                for (n, v), (_, w) in zip(got, taps)]
        worst, at = max(gaps)
        if worst > 1e-5:
            fail(f"--trace: tap {at} differs from the eager prefill's by {worst:.3e} of "
                 "max(1, its max|x|)")
        log(f"--trace: {len(got)} records (the prefill's taps), all finite, each within "
            f"{worst:.3e} of max(1, max|x|) of the eager prefill's, "
            f"{npz.stat().st_size / 1e6:.1f} MB, {time.perf_counter() - t1:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # parity's server: two dense f16 lanes through the exact single-sequence forward
    t0 = time.perf_counter()
    srv = BatchedServer(str(path), mode="parity", max_batch=2, max_seq=BATCH_SEQ,
                        decode_chunk=PARITY_LANE_TOKENS, device="cuda")
    srv.tokenizer.eos_id = -1
    srv.tokenizer.end_of_turn_id = -1
    lanes = [(p, PARITY_LANE_TOKENS) for p, _ in _server_requests(golden)[:2]]
    _zero_serve_parity_counts()
    handles = [srv.submit(p, n) for p, n in lanes]
    while srv.step():
        pass
    torch.cuda.synchronize()
    counts, st = _serve_parity_counts(), srv.stats
    log(f"parity server: {time.perf_counter() - t0:.1f} s; launches {counts}; decode steps "
        f"{st.decode_steps}")
    _golden_prefix(handles[0].out, golden, PARITY_LANE_TOKENS, "parity server")
    if len(handles[1].out) != PARITY_LANE_TOKENS or counts != none:
        fail(f"parity server: lane 1 gave {len(handles[1].out)} tokens; launches {counts}")
    results[("parity server", "per-op")] = dict(
        tok_s=sum(len(h.out) for h in handles) / st.decode_seconds,
        ttft_ms=float(np.percentile([h.ttft_s for h in handles], 50)) * 1e3)
    del srv
    torch.cuda.empty_cache()
    return results


SAMPLE_CFG = (0.8, 40, 0.95)  # phase 20's sampler: temperature, top_k, top_p
SAMPLE_SEED = 20261018
SAMPLE_TOKENS = 32      # phase 20's streams: 32 tokens ...
SAMPLE_REQUESTS = 4     # ... of phase 7's first four prompts in its servers


def _sampler_check(B: int, cfg, label: str) -> dict:
    """The sampler on the card against the same port code on the CPU at
    V = 262144 and B lanes (lane b's key fold_in(fold_in(seed, b), 100 + b),
    logits N(0, 2^2) from a seed): the keys read back and the random words
    bit-equal, the ids identical; then its time a call beside greedy
    argmax's: device time through a CUDA graph of 20 calls (5 at B = 32),
    and eager (CUDA events around as many calls, host issue included)."""
    import torch

    from llm_inference_tpu_torch import random
    from llm_inference_tpu_torch.sampling import SamplingConfig, pick_batch

    t0 = time.perf_counter()
    V = VOCAB_SIZE
    g = torch.Generator().manual_seed(SAMPLE_SEED + B)
    logits_cpu = torch.randn(B, V, generator=g) * 2.0
    logits = logits_cpu.to("cuda")
    lanes = random.fold_in(random.PRNGKey(SAMPLE_SEED), np.arange(B))
    host_keys = random.fold_in(lanes, 100 + np.arange(B))
    keys, keys_cpu = random.to_device(host_keys, "cuda"), random.to_device(host_keys, "cpu")
    if not torch.equal(keys.cpu(), keys_cpu):
        fail(f"sampler {label}: the keys read back from the card differ from the host's")
    bits = random.random_bits(keys, V)
    if not torch.equal(bits.cpu(), random.random_bits(keys_cpu, V)):
        n_bad = int((bits.cpu() != random.random_bits(keys_cpu, V)).sum())
        fail(f"sampler {label}: {n_bad} random words differ from the CPU's")
    ids = {}
    for name, c in (("main", cfg), ("nucleus", SamplingConfig(1.0, 0, 0.9))):
        got = pick_batch(logits, c, keys).cpu()
        want = pick_batch(logits_cpu, c, keys_cpu)
        if not torch.equal(got, want):
            fail(f"sampler {label} {name}: ids {got.tolist()[:8]} differ from the CPU twin's "
                 f"{want.tolist()[:8]}")
        ids[name] = got
    greedy = SamplingConfig()
    out = dict(ids=len(set(ids["main"].tolist())))
    calls = 20 if B == 1 else 5  # B = 32 takes ~10 ms a call
    for name, fn in (("sample", lambda i=0: pick_batch(logits, cfg, keys)),
                     ("bits", lambda i=0: random.random_bits(keys, V)),
                     ("argmax", lambda i=0: pick_batch(logits, greedy))):
        out[f"{name}_eager_ms"] = time_ms(fn, calls)
        try:
            out[f"{name}_ms"] = graph_ms(fn, calls, replays=calls)
        except RuntimeError as e:  # a capture the card refuses: device time not measured
            log(f"sampler {label} {name}: no CUDA graph ({str(e).splitlines()[0]})")
            out[f"{name}_ms"] = None
    log(f"sampler {label} ({time.perf_counter() - t0:.1f} s): keys, {B * V} random words and "
        f"ids equal to the CPU's; "
        + ", ".join(f"{k} {v:.4f}" if v is not None else f"{k} not measured"
                    for k, v in out.items() if k.endswith("ms")))
    return out


def phase_sampling():
    """Phase 20: stochastic sampling (temperature 0.8, top_k 40, top_p 0.95)
    on the card: the sampler against its CPU twin at V = 262144 for 1 and 32
    lanes; the tame 1B under Engine(mode="serve-q8") on the kernel route,
    SAMPLE_TOKENS tokens twice under one seed (the same stream, one whole
    step a decode step); BatchedServer in serve-q8, dense and paged (8
    pages), SAMPLE_REQUESTS of phase 7's prompts at SAMPLE_TOKENS tokens,
    twice under one seed (the same streams): the per-op routes, no batched
    whole step launched."""
    import torch

    from llm_inference_tpu_torch.engine import Engine, GenerationStats
    from llm_inference_tpu_torch.ops.kernels import (flash_decode, fused_decode,
                                                     fused_decode_batch,
                                                     fused_decode_batch_paged, kv_insert)
    from llm_inference_tpu_torch.sampling import SamplingConfig
    from llm_inference_tpu_torch.serving import BatchedServer, ServerStats

    cfg = SamplingConfig(*SAMPLE_CFG)
    results = {"sampler": {B: _sampler_check(B, cfg, f"B={B}") for B in (1, BATCH)}}
    golden = json.loads((ROOT / "tests" / "golden" / "parity_1b_tame.json").read_text())
    path = tame_checkpoint()
    prompt = golden["prompt"]
    t0 = time.perf_counter()
    eng = Engine(str(path), mode="serve-q8", max_seq=1024, decode_chunk=16, device="cuda",
                 sampling=cfg, seed=SAMPLE_SEED)
    if eng.decode_route != "kernel":
        fail(f"sampling Engine: expected the kernel route, got {eng.decode_route}")
    eng.tokenizer.eos_id = -1
    eng.tokenizer.end_of_turn_id = -1
    eng.generate_from_ids(prompt, n_predict=2)  # warm-up
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        fused_decode.launches = 0
        stats = GenerationStats()
        out = eng.generate_from_ids(prompt, n_predict=SAMPLE_TOKENS, stats=stats)
        torch.cuda.synchronize()
        if len(out) != SAMPLE_TOKENS or fused_decode.launches != stats.decode_steps:
            fail(f"sampling Engine: {len(out)} tokens, {fused_decode.launches} whole steps for "
                 f"{stats.decode_steps} decode steps")
        runs.append((out, stats))
    if runs[0][0] != runs[1][0]:
        fail(f"sampling Engine: one seed gave two streams {runs[0][0][:8]}... and "
             f"{runs[1][0][:8]}...")
    stats = runs[1][1]
    log(f"sampling Engine: load + runs {time.perf_counter() - t0:.1f} s; the same stream twice "
        f"({len(set(runs[0][0]))} distinct ids, greedy's first 8 {golden['tokens'][:8]}, "
        f"sampled {runs[0][0][:8]}); {fused_decode.launches} whole steps for "
        f"{stats.decode_steps} decode steps")
    results["engine"] = dict(decode_tok_s=stats.decode_tok_per_s,
                             ttft_ms=stats.prefill_seconds * 1e3)
    del eng
    torch.cuda.empty_cache()
    reqs = [(p, SAMPLE_TOKENS) for p, _ in _server_requests(golden)[:SAMPLE_REQUESTS]]
    mods = {"decode_step_batch": fused_decode_batch, "decode_step_batch_paged":
            fused_decode_batch_paged, "insert_kv_rows": kv_insert, "flash_decode": flash_decode}
    streams = {}
    for route in ("per-op", "paged-per-op"):
        t0 = time.perf_counter()
        srv = BatchedServer(str(path), mode="serve-q8", max_batch=SAMPLE_REQUESTS,
                            max_seq=BATCH_SEQ, decode_chunk=16, max_admit_per_step=SAMPLE_REQUESTS,
                            device="cuda", sampling=cfg, seed=SAMPLE_SEED,
                            kv_pages=2 * SAMPLE_REQUESTS if route == "paged-per-op" else None)
        if srv.decode_route != route:
            fail(f"sampling server: expected the {route} route, got {srv.decode_route}")
        srv.tokenizer.eos_id = -1
        srv.tokenizer.end_of_turn_id = -1
        srv.run([(p, 2) for p, _ in reqs])  # warm-up
        outs = []
        for _ in range(2):
            torch.cuda.synchronize()
            srv.stats = ServerStats()
            for m in mods.values():
                m.launches = 0
            flash_decode.paged_launches = 0
            handles = [srv.submit(p, n) for p, n in reqs]
            while srv.step():
                pass
            torch.cuda.synchronize()
            counts = {k: m.launches for k, m in mods.items()}
            counts["paged_flash_decode"] = flash_decode.paged_launches
            st = srv.stats
            outs.append([h.out for h in handles])
            L = GEOM_1B["n_layers"]
            attn = "paged_flash_decode" if route == "paged-per-op" else "flash_decode"
            want = {k: 0 for k in counts}
            want.update({"insert_kv_rows": L * st.decode_steps, attn: L * st.decode_steps})
            if st.decode_steps == 0 or counts != want:
                fail(f"sampling server {route}: launches {counts}, expected {want}")
            if any(len(o) != SAMPLE_TOKENS for o in outs[-1]):
                fail(f"sampling server {route}: a request ended short of {SAMPLE_TOKENS} tokens")
        if outs[0] != outs[1]:
            fail(f"sampling server {route}: one seed gave two sets of streams")
        streams[route] = outs[0]
        log(f"sampling server {route}: load + runs {time.perf_counter() - t0:.1f} s; the same "
            f"streams twice ({sum(len(set(o)) for o in outs[0])} distinct ids over "
            f"{SAMPLE_REQUESTS} lanes); launches {counts}; decode steps {st.decode_steps}")
        results[route] = dict(tok_s=sum(len(o) for o in outs[1]) / st.decode_seconds,
                              ttft_ms=float(np.percentile([h.ttft_s for h in handles], 50)) * 1e3)
        del srv
        torch.cuda.empty_cache()
    same = streams["per-op"] == streams["paged-per-op"]
    log(f"sampling server: dense and paged streams {'identical' if same else 'differ'}")
    return results


SHARD_TOKENS = 32        # phase 21's sharded Engine: the golden's first 32 tokens
SHARD_REQUESTS = 4       # ... its servers: the first four of phase 7's prompts,
SHARD_LANE_TOKENS = 16   # ... each asking for this many tokens
SHARD_GEOM = dict(GEOM_4B, n_layers=2)  # the heads that shard: H 8, Hkv 4 at 4B widths
SHARD_POS = (0, 100, 700, 1020)         # its batched lanes' positions (S = 1024)
# the gemma_sharding_fn name of each matmul field of a random model
SHARD_NAMES = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_output",
               "w_gate": "ffn_gate", "w_up": "ffn_up", "w_down": "ffn_down"}


def _bar(label: str, got, ref) -> float:
    """The serve bar: max|got - ref| <= 1.5e-2 * max(1, max|ref|) and equal
    argmax along the last dim; fails otherwise. Returns the scaled error."""
    err = float((got.float() - ref.float()).abs().max()) / max(1.0, float(ref.abs().max()))
    same = bool((got.argmax(-1) == ref.argmax(-1)).all())
    log(f"{label}: max|diff| / max(1, max|ref|) = {err:.3e}, argmax equal {same}")
    if err > 1.5e-2 or not same:
        fail(f"{label}: outside the serve bar ({err:.3e}, argmax equal {same})")
    return err


def _first_step_logits(eng, prompt):
    """(prefill logits, first decode step's logits) of ``eng`` on ``prompt``
    over a fresh cache, through ``forward`` as the Engine calls it."""
    import torch

    from llm_inference_tpu_torch.engine import prefill_bucket
    from llm_inference_tpu_torch.models.gemma import forward

    padded = torch.zeros(prefill_bucket(len(prompt)), dtype=torch.int64, device=eng.device)
    padded[: len(prompt)] = torch.tensor(prompt)
    a, cache = forward(eng.hparams, eng._prefill_w, eng.new_cache(), padded, 0, len(prompt))
    b, _ = forward(eng.hparams, eng.weights, cache, a.argmax().reshape(1), len(prompt))
    return a, b


def _check_shard_kernels(label: str, weights, Ts=(1, 32)) -> float:
    """quant_matmul against its plain twin on every distinct shard it
    launches at: each ShardedTensor of ``weights`` that the kernel takes and
    the W8A8 product does not (the whole weight under 16384 rows), at each
    T of ``Ts`` (phase 3's bar, 1e-4 * max(1, max|y|)); a second launch
    bit-equal. Returns the largest max|kernel - plain|."""
    import torch

    from llm_inference_tpu_torch.ops.kernels import qmatmul
    from llm_inference_tpu_torch.quant.device import ShardedTensor

    shards = {}
    fields = [weights.token_embd] + [getattr(lw, f.name) for lw in weights.layers
                                     for f in dataclasses.fields(lw)]
    for w in fields:
        if isinstance(w, ShardedTensor) and w.rows < 16384:
            for s in w.shards:
                if qmatmul.supports_kernel(s, 1):
                    shards.setdefault((s.rows, s.cols), s)
    g = torch.Generator(device="cuda").manual_seed(21)
    worst = 0.0
    for (R, C), s in sorted(shards.items()):
        for T in Ts:
            x = torch.randn((T, C), device="cuda", generator=g)
            y = qmatmul.quant_matmul(s, x)
            y2 = qmatmul.quant_matmul(s, x)
            ref = qmatmul.quant_matmul_plain(s, x)
            err = float((y - ref).abs().max())
            if err > 1e-4 * max(1.0, float(ref.abs().max())) or not torch.equal(y, y2):
                fail(f"{label}: quant_matmul at the shard [{R}, {C}], T={T}: max|diff| {err:.3e}, "
                     f"second launch bit-equal {torch.equal(y, y2)}")
            worst = max(worst, err)
    log(f"{label}: quant_matmul on the shards {sorted(shards)} at T in {Ts}: max|diff| "
        f"{worst:.3e}, second launches bit-equal")
    return worst


def _check_rank_attention(label: str, q, kc, vc, k, v, rowidx, lengths) -> float:
    """One rank's insert_kv_rows and flash_decode at its shard's shapes
    against their plain twins: the append bit-equal (and its second launch),
    the attention within phase 6's rtol = atol = 2e-3, a second launch
    bit-equal. q [B, h, d], caches [B, S, hkv, d], k/v [B, hkv, d]. Returns
    the attention's max|kernel - plain|."""
    import torch

    from llm_inference_tpu_torch.ops.kernels import flash_decode, kv_insert

    B, S = kc.shape[:2]
    pools = [t.clone().view(B * S, *t.shape[2:]) for t in (kc, vc, kc, vc)]
    kv_insert.insert_kv_rows(pools[0], pools[1], k, v, rowidx)
    once = [t.clone() for t in pools[:2]]
    kv_insert.insert_kv_rows(pools[0], pools[1], k, v, rowidx)
    kv_insert.insert_kv_rows_plain(pools[2], pools[3], k, v, rowidx)
    if not (torch.equal(pools[0], pools[2]) and torch.equal(pools[1], pools[3])
            and torch.equal(pools[0], once[0]) and torch.equal(pools[1], once[1])):
        fail(f"{label}: insert_kv_rows differs from its plain twin or its second launch")
    kn, vn = pools[0].view(kc.shape), pools[1].view(vc.shape)
    starts = torch.zeros_like(lengths)
    out = flash_decode.flash_decode(q, kn, vn, lengths, starts)
    out2 = flash_decode.flash_decode(q, kn, vn, lengths, starts)
    ref = flash_decode.flash_decode_plain(q, kn, vn, lengths, starts)
    err = float((out - ref).abs().max())
    if not torch.allclose(out, ref, rtol=2e-3, atol=2e-3) or not torch.equal(out, out2):
        fail(f"{label}: flash_decode at q {tuple(q.shape)} over {tuple(kc.shape)}: max|diff| "
             f"{err:.3e}, second launch bit-equal {torch.equal(out, out2)}")
    return err


def _check_projections(label: str, whole, sharded) -> float:
    """Layer 0's four projections through ``matmul`` over the whole weights
    and over their shards, on the same x at T 1 and 32: the ranks' joins
    and rank-order sums differ from one product only in the order of f32
    sums, so within 1e-5 * max|y|. Returns the largest scaled difference."""
    import torch

    from llm_inference_tpu_torch.ops.linear import matmul

    g = torch.Generator(device="cuda").manual_seed(23)
    worst = 0.0
    for f in ("wqkv", "wo", "w_gate_up", "w_down"):
        a, b = getattr(whole.layers[0], f), getattr(sharded.layers[0], f)
        for T in (1, 32):
            x = torch.randn((T, a.cols), device="cuda", generator=g)
            ya, yb = matmul(a, x), matmul(b, x)
            err = float((ya - yb).abs().max()) / float(ya.abs().max())
            if err > 1e-5:
                fail(f"{label}: {f} at T={T}: the sharded product differs by {err:.3e} of max|y|")
            worst = max(worst, err)
    log(f"{label}: layer 0's projections, whole against sharded (T 1 and 32): max|diff| / "
        f"max|y| = {worst:.3e}")
    return worst


def _shard_random(w, mesh):
    """A random per-layer model's matmul weights split by gemma_sharding_fn
    (its decision from each tensor's GGUF name and shape), then fused."""
    from types import SimpleNamespace

    from llm_inference_tpu_torch.gguf import GGMLType
    from llm_inference_tpu_torch.models.weights import ModelWeights, fuse_projections
    from llm_inference_tpu_torch.parallel import gemma_sharding_fn
    from llm_inference_tpu_torch.quant.device import shard_weight

    fn = gemma_sharding_fn(mesh)

    def split(name, t):
        info = SimpleNamespace(tensor_type=GGMLType.Q8_0, n_rows=t.rows, n_cols=t.cols)
        sh = fn(name, info)
        return t if sh is None else shard_weight(t, sh)

    layers = tuple(dataclasses.replace(lw, **{f: split(f"blk.{i}.{g}.weight", getattr(lw, f))
                                              for f, g in SHARD_NAMES.items()})
                   for i, lw in enumerate(w.layers))
    return fuse_projections(ModelWeights(token_embd=split("token_embd.weight", w.token_embd),
                                         output_norm=w.output_norm, layers=layers))


def _random_unfused(hp, seed: int):
    """``_random_model``'s weights as per-layer unfused views (Q, K, V and
    gate, up as row ranges of the fused ones)."""
    from llm_inference_tpu_torch.models.weights import layer_view
    from llm_inference_tpu_torch.quant.device import QuantTensor

    w = _random_model(hp, seed)
    H, Hkv, d, F = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.feed_forward_length

    def rows(t, lo, hi):
        return QuantTensor(q=t.q[lo:hi], scale=t.scale[lo:hi], fmt=t.fmt, rows=hi - lo, cols=t.cols)

    layers = []
    for i in range(hp.block_count):
        lw = layer_view(w.layers, i)
        qkv, gu = lw.wqkv, lw.w_gate_up
        layers.append(dataclasses.replace(
            lw, wqkv=None, w_gate_up=None, wq=rows(qkv, 0, H * d),
            wk=rows(qkv, H * d, (H + Hkv) * d), wv=rows(qkv, (H + Hkv) * d, (H + 2 * Hkv) * d),
            w_gate=rows(gu, 0, F), w_up=rows(gu, F, 2 * F)))
    return dataclasses.replace(w, layers=tuple(layers))


def _phase_shard_heads(smi: str) -> float:
    """Phase 21's heads that shard: a random 2-layer model at GEOM_4B widths
    (H 8, Hkv 4) over 2 and 4 ranks on the card."""
    import os

    import torch

    from llm_inference_tpu_torch.models.gemma import (BatchedKVCache, forward,
                                                      forward_batched_decode, init_batched_cache,
                                                      init_cache)
    from llm_inference_tpu_torch.models.weights import fuse_projections
    from llm_inference_tpu_torch.parallel import (batched_kv_cache_sharding, kv_cache_sharding,
                                                  make_mesh)

    hp = hp_gemma3(**SHARD_GEOM, sliding_window=0)
    w = _random_unfused(hp, 2121)
    whole = fuse_projections(w)
    S, B, L = 1024, len(SHARD_POS), hp.block_count
    H, Hkv, d = hp.n_head, hp.n_head_kv, hp.n_embd_head_k
    g = torch.Generator(device="cuda").manual_seed(2122)
    prompt = torch.randint(10, VOCAB_SIZE, (32,), device="cuda", generator=g)
    # the lanes' caches: seeded rows below each lane's position
    kv = [torch.randn((L, B, S, Hkv, d), device="cuda", generator=g).to(torch.bfloat16)
          for _ in range(2)]
    pos = torch.tensor(SHARD_POS, dtype=torch.int32, device="cuda")
    toks = torch.randint(10, VOCAB_SIZE, (B,), device="cuda", generator=g)
    worst = 0.0
    os.environ["LLMI_FLASH_DECODE"] = "1"  # the single stream attends through flash_decode
    try:
        cache = init_cache(hp, S, device="cuda")
        a_ref, cache = forward(hp, whole, cache, prompt, 0)
        b_ref, _ = forward(hp, whole, cache, a_ref.argmax().reshape(1), 32)
        ref_lanes = BatchedKVCache(k=kv[0].clone(), v=kv[1].clone())
        y_ref, _ = forward_batched_decode(hp, whole, ref_lanes, toks, pos)
        for n in (2, 4):
            mesh = make_mesh(model=n, devices=[torch.device("cuda", 0)] * n)
            ws = _shard_random(w, mesh)
            label = f"heads that shard, n={n}"
            cache = init_cache(hp, S, sharding=kv_cache_sharding(mesh, Hkv))
            if len(cache.shards) != n or cache.shards[0].k.shape[2] != Hkv // n:
                fail(f"{label}: the cache did not split its {Hkv} KV heads over {n} ranks")
            a, cache = forward(hp, ws, cache, prompt, 0)
            b, _ = forward(hp, ws, cache, a_ref.argmax().reshape(1), 32)
            _bar(f"{label}: prefill logits (T=32) against the unsharded forward's", a, a_ref)
            _bar(f"{label}: decode logits (flash_decode on each rank's heads)", b, b_ref)
            lanes = init_batched_cache(hp, B, S, sharding=batched_kv_cache_sharding(mesh, Hkv))
            hk = Hkv // n
            for r, c in enumerate(lanes.rows[0].shards):
                c.k.copy_(kv[0][..., r * hk:(r + 1) * hk, :])
                c.v.copy_(kv[1][..., r * hk:(r + 1) * hk, :])
            y, _ = forward_batched_decode(hp, ws, lanes.rows[0], toks, pos)
            _bar(f"{label}: batched step logits (B={B}, lanes at {SHARD_POS})", y, y_ref)
            _check_projections(label, whole, ws)
            worst = max(worst, _check_shard_kernels(label, ws, Ts=(1, B, 32)))
            # each rank's append and attention at its shard's shapes
            lengths = pos + 1
            rowidx = (torch.arange(B, dtype=torch.int32, device="cuda") * S + pos).to(torch.int32)
            kq = torch.randn((B, H, d), device="cuda", generator=g)
            # k and v as the forward hands them over: column ranges of one f32 projection
            qkv = torch.randn((B, (H + 2 * Hkv) * d), device="cuda", generator=g)
            knew = qkv[:, H * d:(H + Hkv) * d].reshape(B, Hkv, d)
            vnew = qkv[:, (H + Hkv) * d:].reshape(B, Hkv, d)
            errs = []
            for r, c in enumerate(lanes.rows[0].shards):
                hq = H // n
                errs.append(_check_rank_attention(
                    f"{label} rank {r}", kq[:, r * hq:(r + 1) * hq], c.k[0], c.v[0],
                    knew[:, r * hk:(r + 1) * hk], vnew[:, r * hk:(r + 1) * hk], rowidx,
                    lengths))
            log(f"{label}: insert_kv_rows bit-equal and flash_decode within 2e-3 (max|diff| "
                f"{max(errs):.3e}) at each rank's [{B}, {S}, {hk}, {d}] shard, second launches "
                f"bit-equal, on {smi}")
    finally:
        os.environ.pop("LLMI_FLASH_DECODE", None)
    return worst


def phase_sharded(smi: str):
    """Phase 21: the per-op sharded path (parallel/sharding.py) on one card,
    its ranks on a mesh that repeats cuda:0. The tame 1B (Hkv 1: its caches
    stay whole) through Engine(mode="serve-q8", sharding_fn, cache_sharding)
    over 2 ranks: the golden's first SHARD_TOKENS tokens, its first prefill
    and decode logits within the serve bar of the unsharded per-op route's
    (LLMI_NO_FUSED_DECODE=1), 4 x 2 x 26 quant_matmul a forward; then
    BatchedServer over data 2 x model 2 (lanes over the data rows) and a
    paged one with sharded weights over 2 ranks, SHARD_REQUESTS of phase 7's
    prompts for SHARD_LANE_TOKENS tokens: streams equal to the unsharded
    per-op server's, the first step's logits within the bar (the W8A8
    products of the col-parallel weights take the whole row's activation
    scale: a shard's would leave the bar), insert_kv_rows and
    (paged_)flash_decode launched once a layer, a data row and a step;
    quant_matmul against its plain twin on every 1B shard. Then the heads
    that shard (_phase_shard_heads). Decode tok/s and median TTFT of each
    run beside the unsharded per-op route's."""
    import os

    import torch

    from llm_inference_tpu_torch.engine import Engine
    from llm_inference_tpu_torch.parallel import (batched_kv_cache_sharding, gemma_sharding_fn,
                                                  kv_cache_sharding, make_mesh)
    from llm_inference_tpu_torch.quant.device import ShardedTensor
    from llm_inference_tpu_torch.serving import BatchedServer, ServerStats

    golden = json.loads((ROOT / "tests" / "golden" / "parity_1b_tame.json").read_text())
    path = tame_checkpoint()
    prompt = golden["prompt"]
    L = GEOM_1B["n_layers"]
    card = torch.device("cuda", 0)
    m2 = make_mesh(model=2, devices=[card] * 2)
    m22 = make_mesh(model=2, data=2, devices=[card] * 4)
    none = {k: 0 for k in _serve_parity_counts()}
    results, counts_all = {}, {}
    # the single stream: the unsharded per-op route, then the sharded one
    logits = {}
    for route in ("per-op", "sharded"):
        t0 = time.perf_counter()
        if route == "per-op":
            os.environ["LLMI_NO_FUSED_DECODE"] = "1"
        try:
            kw = {} if route == "per-op" else dict(sharding_fn=gemma_sharding_fn(m2),
                                                   cache_sharding=kv_cache_sharding(m2, 1))
            eng = Engine(str(path), mode="serve-q8", max_seq=1024, decode_chunk=16,
                         device="cuda", **kw)
        finally:
            os.environ.pop("LLMI_NO_FUSED_DECODE", None)
        if eng.decode_route != route:
            fail(f"sharded Engine: expected the {route} route, got {eng.decode_route}")
        logits[route] = _first_step_logits(eng, prompt)
        out, stats, counts, ttft = _engine_run(eng, prompt, SHARD_TOKENS, 5)
        log(f"Engine serve-q8 {route}: load + run {time.perf_counter() - t0:.1f} s; launches "
            f"{counts}; decode steps {stats.decode_steps}; "
            f"{counts['quant_matmul'] / (stats.decode_steps + 1):.0f} quant_matmul a step")
        _golden_prefix(out, golden, SHARD_TOKENS, f"Engine serve-q8 {route}")
        ranks = 2 if route == "sharded" else 1
        want = dict(none, quant_matmul=4 * ranks * L * (stats.decode_steps + 1))
        if stats.decode_steps == 0 or counts != want:
            fail(f"Engine serve-q8 {route}: launches {counts}, expected {want}")
        if route == "sharded":
            lw = eng.weights.layers[0]
            if not (isinstance(lw.wqkv, ShardedTensor) and lw.w_down.dim == 1
                    and isinstance(eng.weights.token_embd, ShardedTensor)):
                fail("sharded Engine: the weights are not sharded")
            qm_err = _check_shard_kernels("1B shards (2 ranks)", eng.weights)
            counts_all["engine"] = counts
        results[("engine", route)] = dict(decode_tok_s=stats.decode_tok_per_s, ttft_ms=ttft)
        del eng
        torch.cuda.empty_cache()
    for i, what in enumerate(("prefill", "first decode step")):
        _bar(f"sharded Engine: {what} logits against the per-op route's", logits["sharded"][i],
             logits["per-op"][i])
    # the servers
    reqs = [(p, SHARD_LANE_TOKENS) for p, _ in _server_requests(golden)[:SHARD_REQUESTS]]
    runs = {"per-op": {}, "sharded": dict(sharding_fn=gemma_sharding_fn(m22),
                                         cache_sharding=batched_kv_cache_sharding(m22, 1)),
            "paged-sharded": dict(sharding_fn=gemma_sharding_fn(m2), kv_pages=2 * SHARD_REQUESTS)}
    streams, first = {}, {}
    for route, kw in runs.items():
        t0 = time.perf_counter()
        if route == "per-op":
            os.environ["LLMI_NO_FUSED_DECODE"] = "1"
        try:
            srv = BatchedServer(str(path), mode="serve-q8", max_batch=SHARD_REQUESTS,
                                max_seq=BATCH_SEQ, decode_chunk=SHARD_LANE_TOKENS,
                                max_admit_per_step=SHARD_REQUESTS, device="cuda", **kw)
        finally:
            os.environ.pop("LLMI_NO_FUSED_DECODE", None)
        if srv.decode_route != route:
            fail(f"sharded server: expected the {route} route, got {srv.decode_route}")
        srv.tokenizer.eos_id = -1
        srv.tokenizer.end_of_turn_id = -1
        # a first pass: the first step's logits (dense), then drained (a warm-up)
        for p, n in reqs:
            srv.submit(p, n)
        srv._admit()
        if not srv.paged:
            tokens = torch.zeros(SHARD_REQUESTS, dtype=torch.int64, device=card)
            pos = torch.full((SHARD_REQUESTS,), BATCH_SEQ, dtype=torch.int32, device=card)
            for slot, req in srv._active.items():
                tokens[slot], pos[slot] = req.pending, req.pos
            first[route] = srv.dense_step_logits(tokens, pos)
        while srv.step():
            pass
        torch.cuda.synchronize()
        srv.stats = ServerStats()
        _zero_serve_parity_counts()
        handles = [srv.submit(p, n) for p, n in reqs]
        while srv.step():
            pass
        torch.cuda.synchronize()
        counts, st = _serve_parity_counts(), srv.stats
        outs = streams[route] = [h.out for h in handles]
        log(f"server serve-q8 {route}: load + run {time.perf_counter() - t0:.1f} s; launches "
            f"{counts}; decode steps {st.decode_steps}")
        if any(len(o) != SHARD_LANE_TOKENS for o in outs):
            fail(f"server {route}: a request ended short of its {SHARD_LANE_TOKENS} tokens")
        rows = 2 if route == "sharded" else 1
        attn = "paged_flash_decode" if srv.paged else "flash_decode"
        want = dict(none, insert_kv_rows=rows * L * st.decode_steps,
                    **{attn: rows * L * st.decode_steps})
        if st.decode_steps == 0 or counts != want:
            fail(f"server {route}: launches {counts}, expected {want}")
        if route != "per-op":
            counts_all[route] = counts
        results[("server", route)] = dict(
            tok_s=sum(len(o) for o in outs) / st.decode_seconds,
            ttft_ms=float(np.percentile([h.ttft_s for h in handles], 50)) * 1e3)
        del srv
        torch.cuda.empty_cache()
    _bar("DP x TP server: first step's logits (W8A8, whole-row activation scales) against the "
         "per-op server's", first["sharded"], first["per-op"])
    for route in ("sharded", "paged-sharded"):
        if streams[route] != streams["per-op"]:
            fail(f"server {route}: the streams differ from the unsharded per-op server's")
    log(f"servers: the sharded and paged-sharded streams equal the per-op server's "
        f"({SHARD_REQUESTS} x {SHARD_LANE_TOKENS} tokens)")
    qm_err = max(qm_err, _phase_shard_heads(smi))
    launches = {k: sum(c[k] for c in counts_all.values())
                for k in ("quant_matmul", "flash_decode", "paged_flash_decode", "insert_kv_rows")}
    return results, launches, qm_err


HD_SERVER = dict(max_batch=4, max_seq=512, decode_chunk=8, max_admit_per_step=4)
HD_PAGE, HD_PAGES = 64, 16  # phase 22's paged server: a request takes 1-2 pages of 64 slots
HD_TOKENS = 16              # ... tokens a request, of prompts of these lengths:
HD_PROMPT_LENS = (45, 19, 7, 26)
HD_LAYERS = 5               # the timings' caches: GEOM_G4's 5 global owner layers, each its own


def _hd_attention_checks(d: int, g) -> float:
    """flash_decode and paged_flash_decode at GEOM_G4's heads (8 q heads over
    2 KV heads) of width ``d`` against their plain twins at phase 22's
    server shapes (4 lanes of 512 slots, ragged, one empty; pages of
    HD_PAGE through a shuffled table with an id past the pool; softcap on
    and off, window starts, nb_cap): rtol = atol = 2e-3 (phase 21's bar), a
    second launch bit-equal; and insert_kv_rows (f32 k, v a column slice of
    the fused QKV projection) bit-equal to its twin, a second launch too.
    Returns the largest max|kernel - plain|."""
    import torch

    from llm_inference_tpu_torch.ops.kernels import flash_decode, kv_insert

    dev = torch.device("cuda")
    H, Hkv = GEOM_G4["n_head"], GEOM_G4["n_head_kv"]
    B, S = HD_SERVER["max_batch"], HD_SERVER["max_seq"]
    q = torch.randn((B, H, d), device=dev, generator=g) * (0.5 / math.sqrt(d))
    k = torch.randn((B, S, Hkv, d), device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn((B, S, Hkv, d), device=dev, generator=g).to(torch.bfloat16)
    lengths = torch.tensor([S, 0, 300, 47], dtype=torch.int32, device=dev)
    worst = 0.0

    def held(what, fn, plain):
        nonlocal worst
        got, again, want = fn(), fn(), plain()
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        if (not torch.allclose(got, want, rtol=2e-3, atol=2e-3) or not torch.equal(got, again)
                or got[lengths == 0].any()):
            fail(f"{what}: kernel against plain {e:.3e} (rtol = atol = 2e-3), second launch "
                 f"bit-equal {torch.equal(got, again)}")
        worst = max(worst, e)

    starts = torch.clamp(lengths - G4_WINDOW, min=0).to(torch.int32)
    for sc, st in ((0.0, None), (50.0, starts)):
        held(f"flash_decode d={d} softcap={sc}",
             lambda: flash_decode.flash_decode(q, k, v, lengths, st, softcap=sc),
             lambda: flash_decode.flash_decode_plain(q, k, v, lengths, st, softcap=sc))
    nb = S // HD_PAGE
    N = B * nb + 2
    kp = torch.randn((N, HD_PAGE, Hkv, d), device=dev, generator=g).to(torch.bfloat16)
    vp = torch.randn((N, HD_PAGE, Hkv, d), device=dev, generator=g).to(torch.bfloat16)
    table = torch.randperm(N, device=dev, generator=g)[: B * nb].reshape(B, nb).to(torch.int32)
    table[1] = N + 3  # the empty lane's entries: past the pool (clamped, never read)
    for sc, st, cap in ((0.0, None, None), (50.0, starts, 5)):
        held(f"paged_flash_decode d={d} softcap={sc} nb_cap={cap}",
             lambda: flash_decode.paged_flash_decode(q, kp, vp, table, lengths, st, softcap=sc,
                                                     nb_cap=cap),
             lambda: flash_decode.paged_flash_decode_plain(q, kp, vp, table, lengths, st,
                                                           softcap=sc, nb_cap=cap))
    qkv = torch.randn((B, (H + 2 * Hkv) * d), device=dev, generator=g)
    k32 = qkv[:, H * d:(H + Hkv) * d].reshape(B, Hkv, d).contiguous()
    v32 = qkv[:, (H + Hkv) * d:].reshape(B, Hkv, d)
    idx = torch.tensor([5, B * S, 2 * S + 300, 3 * S + 47], dtype=torch.int32, device=dev)
    pools = [t.view(B * S, Hkv, d).clone() for t in (k, v, k, v, k, v)]
    kv_insert.insert_kv_rows(pools[0], pools[1], k32, v32, idx)
    kv_insert.insert_kv_rows(pools[2], pools[3], k32, v32, idx)
    kv_insert.insert_kv_rows(pools[2], pools[3], k32, v32, idx)
    kv_insert.insert_kv_rows_plain(pools[4], pools[5], k32, v32, idx)
    torch.cuda.synchronize()
    if not all(torch.equal(pools[i], pools[i + 4]) and torch.equal(pools[i + 2], pools[i + 4])
               for i in (0, 1)):
        fail(f"insert_kv_rows d={d}: the kernel or its second launch differs from its twin")
    log(f"head dims {d}: flash_decode and paged_flash_decode within 2e-3 of their twins (max "
        f"{worst:.3e}), second launches bit-equal; insert_kv_rows bit-equal, twice")
    return worst


def _hd_times(d: int, g) -> dict:
    """flash_decode, paged_flash_decode and scaled_dot_product_attention at
    phase 6's lanes (32 lanes of 1024 slots ragged over 0..1000, four
    parked) with GEOM_G4's heads of width ``d``, cold: each call over the
    next of HD_LAYERS layers' own caches (over 50 MB of live K/V a call),
    through a CUDA graph; the bound is the live K/V rows read once (q and
    out too) over 3.35 TB/s beside the f32 FMAs at 67 TFLOP/s."""
    import torch

    from llm_inference_tpu_torch.ops.kernels import flash_decode

    dev = torch.device("cuda")
    H, Hkv = GEOM_G4["n_head"], GEOM_G4["n_head_kv"]
    B, S = BATCH, BATCH_SEQ
    pos = torch.tensor(_batch_positions(S), dtype=torch.int32, device=dev)
    lengths = torch.where(pos >= S, torch.zeros_like(pos), pos + 1).to(torch.int32)
    q = torch.randn((B, H, d), device=dev, generator=g) * (0.5 / math.sqrt(d))
    ks = [torch.randn((B, S, Hkv, d), device=dev, generator=g).to(torch.bfloat16)
          for _ in range(HD_LAYERS)]
    vs = [torch.randn((B, S, Hkv, d), device=dev, generator=g).to(torch.bfloat16)
          for _ in range(HD_LAYERS)]
    n = HD_LAYERS
    ms = graph_ms(lambda i: flash_decode.flash_decode(q, ks[i % n], vs[i % n], lengths), n)
    plain = graph_ms(lambda i: flash_decode.flash_decode_plain(q, ks[0], vs[0], lengths), 2,
                     replays=3)
    qb = q.to(torch.bfloat16)[:, :, None, :]
    kts = [t.permute(0, 2, 1, 3) for t in ks]
    vts = [t.permute(0, 2, 1, 3) for t in vs]
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    lib = graph_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        qb, kts[i % n], vts[i % n], attn_mask=mask, scale=1.0, enable_gqa=True), n)
    table = torch.arange(B * (S // PAGE), dtype=torch.int32, device=dev).reshape(B, S // PAGE)
    table = table[torch.randperm(B, device=dev, generator=g)]  # lanes' pages out of order
    kps = [t.view(-1, PAGE, Hkv, d) for t in ks]
    vps = [t.view(-1, PAGE, Hkv, d) for t in vs]
    pms = graph_ms(lambda i: flash_decode.paged_flash_decode(q, kps[i % n], vps[i % n], table,
                                                             lengths), n)
    pplain = graph_ms(lambda i: flash_decode.paged_flash_decode_plain(q, kps[0], vps[0], table,
                                                                      lengths), 2, replays=3)
    live = int(lengths.sum())
    nbytes = live * Hkv * 2 * d * 2 + B * H * d * 4 * 2 + B * 4
    ops = 2 * live * H * 2 * d
    b = bound_ms(nbytes, f32_ops=ops)
    log(f"flash at d={d} (H {H}, Hkv {Hkv}, B {B}, S {S}, ragged, cold over {n} layers): "
        f"flash_decode {ms:.4f} ms, paged_flash_decode {pms:.4f} ms ({PAGE}-slot pages), "
        f"scaled_dot_product_attention {lib:.4f} ms, plain {plain:.4f} / {pplain:.4f} ms, bound "
        f"{b:.4f} ms ({nbytes / 1e6:.3f} MB, {bound_by(nbytes, f32_ops=ops)})")
    del ks, vs, kts, vts, kps, vps
    torch.cuda.empty_cache()
    return dict(ms=ms, paged_ms=pms, plain_ms=plain, paged_plain_ms=pplain, library_ms=lib,
                bound_ms=b, bound_by=bound_by(nbytes, f32_ops=ops))


def phase_head_dims(smi: str):
    """Phase 22: per-layer head dims on the card. head_dims_checkpoint
    (GEOM_G4, global heads of 512, sliding ones of 256) under
    Engine(mode="serve-q8"), which takes the per-op route (no whole step's
    gate takes per-layer head dims), a per-layer cache at each KV layer's
    width: HD_PROMPT_LENS' prompts at HD_TOKENS tokens, with the masked
    attention and with LLMI_FLASH_DECODE=1 (flash_decode at both widths,
    24 a decode step), equal streams, 6 x 24 + 1 = 145 quant_matmul a
    forward; then BatchedServer dense and paged (LLMI_PAGE=HD_PAGE) on the
    same requests: every lane's stream equal to the Engine's, 20
    insert_kv_rows (the owner layers) and 24 flash_decode or
    paged_flash_decode a decode step, lanes and pools at each layer's
    width. Then the kernels at both widths against their plain twins
    (_hd_attention_checks) and timed at phase 6's lanes (_hd_times).
    Returns (results, launches, max_abs_err)."""
    import os

    import torch

    from llm_inference_tpu_torch.engine import Engine, GenerationStats
    from llm_inference_tpu_torch.models import gemma
    from llm_inference_tpu_torch.ops.kernels import flash_decode, kv_insert, qmatmul
    from llm_inference_tpu_torch.serving import BatchedServer, ServerStats

    path = head_dims_checkpoint()
    L = GEOM_G4["n_layers"]
    n_kv = L - GEOM_G4["shared_kv_layers"]
    per_fwd = 6 * L + 1
    rng = np.random.default_rng(22)
    prompts = [[2] + rng.integers(10, HD_VOCAB, size=n - 1).tolist() for n in HD_PROMPT_LENS]
    reqs = [(q, HD_TOKENS) for q in prompts]
    t0 = time.perf_counter()
    eng = Engine(str(path), mode="serve-q8", max_seq=HD_SERVER["max_seq"], decode_chunk=8,
                 device="cuda")
    hp = eng.hparams
    widths = [HD_DIMS[1] if hp.is_swa_layer(i) else HD_DIMS[0] for i in range(n_kv)]
    log(f"head dims: load {time.perf_counter() - t0:.1f} s; key widths {hp.n_embd_head_k} "
        f"(global) / {hp.n_embd_head_k_swa} (sliding); route {eng.decode_route}")
    if eng.decode_route != "per-op" or [t.shape[-1] for t in eng.new_cache().k] != widths:
        fail(f"head dims Engine: route {eng.decode_route}, cache widths "
             f"{[t.shape[-1] for t in eng.new_cache().k]}, expected per-op and {widths}")
    eng.tokenizer.eos_id = eng.tokenizer.end_of_turn_id = -1
    results, streams = {}, {}

    def zero():
        qmatmul.launches = flash_decode.launches = flash_decode.paged_launches = 0
        kv_insert.launches = 0

    def counts():
        return {"quant_matmul": qmatmul.launches, "flash_decode": flash_decode.launches,
                "paged_flash_decode": flash_decode.paged_launches,
                "insert_kv_rows": kv_insert.launches}

    launches = {k: 0 for k in counts()}
    for flash in (False, True):
        route = "flash" if flash else "masked"
        if flash:
            os.environ["LLMI_FLASH_DECODE"] = "1"
        try:
            eng.generate_from_ids(prompts[0], n_predict=4)  # warm-up
            torch.cuda.synchronize()
            zero()
            outs, steps, dec_s, ttft = [], 0, 0.0, []
            for q, n in reqs:
                st = GenerationStats()
                outs.append(eng.generate_from_ids(q, n_predict=n, stats=st))
                steps += st.decode_steps
                dec_s += st.decode_seconds
                ttft.append(st.prefill_seconds)
            torch.cuda.synchronize()
        finally:
            os.environ.pop("LLMI_FLASH_DECODE", None)
        got = counts()
        want = {"quant_matmul": per_fwd * (steps + len(reqs)),
                "flash_decode": L * steps if flash else 0, "paged_flash_decode": 0,
                "insert_kv_rows": 0}
        log(f"head dims Engine {route}: {steps} decode steps, launches {got}")
        if got != want or steps == 0:
            fail(f"head dims Engine {route}: launches {got}, expected {want}")
        if flash:
            launches["flash_decode"] += got["flash_decode"]
        streams[route] = outs
        results[("Engine", route)] = dict(decode_tok_s=steps / dec_s,
                                          ttft_ms=float(np.median(ttft)) * 1e3)
        log(f"head dims Engine {route}: decode {steps / dec_s:.2f} tok/s, TTFT (median of "
            f"{len(ttft)}) {results[('Engine', route)]['ttft_ms']:.2f} ms; streams "
            f"{[o[:6] for o in outs]}")
    if streams["flash"] != streams["masked"]:
        fail("head dims Engine: the LLMI_FLASH_DECODE=1 streams differ from the masked ones")
    del eng
    torch.cuda.empty_cache()

    for paged in (False, True):
        route = "paged-per-op" if paged else "per-op"
        old_page = os.environ.get("LLMI_PAGE")
        os.environ["LLMI_PAGE"] = str(HD_PAGE)
        try:
            srv = BatchedServer(str(path), mode="serve-q8", device="cuda",
                                kv_pages=HD_PAGES if paged else None, **HD_SERVER)
        finally:
            if old_page is None:
                os.environ.pop("LLMI_PAGE", None)
            else:
                os.environ["LLMI_PAGE"] = old_page
        got_widths = [t.shape[-1] for t in srv._caches.k]  # dense lanes or pools
        if srv.decode_route != route or got_widths != widths:
            fail(f"head dims server: route {srv.decode_route}, widths {got_widths}, expected "
                 f"{route} and {widths}")
        srv.tokenizer.eos_id = srv.tokenizer.end_of_turn_id = -1
        srv.run([(prompts[0], 4)])  # warm-up
        torch.cuda.synchronize()
        srv.stats = ServerStats()
        zero()
        handles = [srv.submit(q, n) for q, n in reqs]
        while srv.step():
            pass
        torch.cuda.synchronize()
        got, st = counts(), srv.stats
        key = "paged_flash_decode" if paged else "flash_decode"
        want = {"quant_matmul": got["quant_matmul"], "flash_decode": 0, "paged_flash_decode": 0,
                "insert_kv_rows": n_kv * st.decode_steps}
        want[key] = L * st.decode_steps
        outs = [h.out for h in handles]
        log(f"head dims server {route}: {st.decode_steps} decode steps, launches {got}")
        if got != want or st.decode_steps == 0:
            fail(f"head dims server {route}: launches {got}, expected {want}")
        if outs != streams["masked"]:
            fail(f"head dims server {route}: lanes {[o[:6] for o in outs]} differ from the "
                 f"Engine's {[o[:6] for o in streams['masked']]}")
        if paged and sorted(srv._free_pages) != list(range(HD_PAGES)):
            fail("head dims paged server: pages leaked")
        launches[key] += got[key]
        launches["insert_kv_rows"] += got["insert_kv_rows"]
        tok_s = sum(len(o) for o in outs) / st.decode_seconds
        ttft = float(np.percentile([h.ttft_s for h in handles], 50)) * 1e3
        results[("server", route)] = dict(tok_s=tok_s, ttft_ms=ttft)
        log(f"head dims server {route}: every lane equal to the Engine's stream; decode "
            f"{tok_s:.2f} tok/s aggregate, p50 TTFT {ttft:.2f} ms")
        del srv
        torch.cuda.empty_cache()

    g = torch.Generator(device="cuda").manual_seed(22)
    err = max(_hd_attention_checks(d, g) for d in HD_DIMS)
    shd, shd_launches, shd_err = _hd_sharded(path, reqs, streams["masked"], g)
    results.update(shd)
    for k, v in shd_launches.items():
        launches[k] += v
    times = {d: _hd_times(d, g) for d in HD_DIMS}
    results["times"] = times
    return results, launches, max(err, shd_err)


def _hd_sharded(path, reqs, want, g):
    """Phase 22's sharded part: per-layer head dims on the per-op sharded
    path over ranks that repeat cuda:0 (the phase's docstring). ``want``:
    the unsharded Engine's streams of ``reqs``. Returns (results, launches,
    the rank kernels' largest max|kernel - plain|)."""
    import os

    import torch

    from llm_inference_tpu_torch.engine import Engine, GenerationStats
    from llm_inference_tpu_torch.models import gemma
    from llm_inference_tpu_torch.ops.kernels import flash_decode, kv_insert
    from llm_inference_tpu_torch.parallel import (batched_kv_cache_sharding, gemma_sharding_fn,
                                                  kv_cache_sharding, make_mesh)
    from llm_inference_tpu_torch.serving import BatchedServer, ServerStats

    card = torch.device("cuda", 0)
    m2 = make_mesh(model=2, devices=[card] * 2)
    m22 = make_mesh(model=2, data=2, devices=[card] * 4)
    L, Hkv = GEOM_G4["n_layers"], GEOM_G4["n_head_kv"]
    n_kv = L - GEOM_G4["shared_kv_layers"]
    results, launches = {}, {"flash_decode": 0, "paged_flash_decode": 0, "insert_kv_rows": 0}

    def zero():
        flash_decode.launches = flash_decode.paged_launches = kv_insert.launches = 0

    def counts():
        return {"flash_decode": flash_decode.launches,
                "paged_flash_decode": flash_decode.paged_launches,
                "insert_kv_rows": kv_insert.launches}

    t0 = time.perf_counter()
    eng = Engine(str(path), mode="serve-q8", max_seq=HD_SERVER["max_seq"], decode_chunk=8,
                 device="cuda", sharding_fn=gemma_sharding_fn(m2),
                 cache_sharding=kv_cache_sharding(m2, Hkv))
    cache = eng.new_cache()
    hp = eng.hparams
    widths = [[(t.shape[-2], t.shape[-1]) for t in c.k] for c in cache.shards]
    expect = [(Hkv // 2, gemma.head_dims(hp, i)[0]) for i in range(n_kv)]
    if eng.decode_route != "sharded" or widths != [expect, expect]:
        fail(f"head dims sharded Engine: route {eng.decode_route}, rank caches {widths}")
    del cache
    eng.tokenizer.eos_id = eng.tokenizer.end_of_turn_id = -1
    os.environ["LLMI_FLASH_DECODE"] = "1"
    try:
        eng.generate_from_ids(reqs[0][0], n_predict=4)  # warm-up
        torch.cuda.synchronize()
        zero()
        outs, steps, dec_s, ttft = [], 0, 0.0, []
        for q, n in reqs:
            st = GenerationStats()
            outs.append(eng.generate_from_ids(q, n_predict=n, stats=st))
            steps += st.decode_steps
            dec_s += st.decode_seconds
            ttft.append(st.prefill_seconds)
        torch.cuda.synchronize()
    finally:
        os.environ.pop("LLMI_FLASH_DECODE", None)
    got = counts()
    if got != dict(flash_decode=2 * L * steps, paged_flash_decode=0, insert_kv_rows=0)             or steps == 0:
        fail(f"head dims sharded Engine: launches {got} over {steps} decode steps")
    if outs != want:
        fail(f"head dims sharded Engine: streams {[o[:6] for o in outs]} differ from the "
             f"unsharded Engine's {[o[:6] for o in want]}")
    launches["flash_decode"] += got["flash_decode"]
    results[("Engine", "sharded")] = dict(decode_tok_s=steps / dec_s,
                                          ttft_ms=float(np.median(ttft)) * 1e3)
    log(f"head dims sharded Engine (2 ranks, flash): load + run {time.perf_counter() - t0:.1f} "
        f"s; launches {got}; the unsharded streams; decode {steps / dec_s:.2f} tok/s")
    del eng
    torch.cuda.empty_cache()

    for route, kw in (("sharded", dict(sharding_fn=gemma_sharding_fn(m22),
                                       cache_sharding=batched_kv_cache_sharding(m22, Hkv))),
                      ("paged-sharded", dict(sharding_fn=gemma_sharding_fn(m2),
                                             kv_pages=HD_PAGES))):
        t0 = time.perf_counter()
        old_page = os.environ.get("LLMI_PAGE")
        os.environ["LLMI_PAGE"] = str(HD_PAGE)
        try:
            srv = BatchedServer(str(path), mode="serve-q8", device="cuda", **HD_SERVER, **kw)
        finally:
            if old_page is None:
                os.environ.pop("LLMI_PAGE", None)
            else:
                os.environ["LLMI_PAGE"] = old_page
        if srv.decode_route != route:
            fail(f"head dims server: route {srv.decode_route}, expected {route}")
        srv.tokenizer.eos_id = srv.tokenizer.end_of_turn_id = -1
        srv.run([(reqs[0][0], 4)])  # warm-up
        torch.cuda.synchronize()
        srv.stats = ServerStats()
        zero()
        handles = [srv.submit(q, n) for q, n in reqs]
        while srv.step():
            pass
        torch.cuda.synchronize()
        got, st = counts(), srv.stats
        ranks = 4 if route == "sharded" else 1  # data rows x the KV heads' ranks
        key = "flash_decode" if route == "sharded" else "paged_flash_decode"
        expect = {"flash_decode": 0, "paged_flash_decode": 0,
                  "insert_kv_rows": ranks * n_kv * st.decode_steps}
        expect[key] = ranks * L * st.decode_steps
        outs = [h.out for h in handles]
        if got != expect or st.decode_steps == 0:
            fail(f"head dims server {route}: launches {got}, expected {expect}")
        if outs != want:
            fail(f"head dims server {route}: lanes {[o[:6] for o in outs]} differ from the "
                 f"unsharded Engine's {[o[:6] for o in want]}")
        for k in launches:
            launches[k] += got[k]
        tok_s = sum(len(o) for o in outs) / st.decode_seconds
        results[("server", route)] = dict(
            tok_s=tok_s, ttft_ms=float(np.percentile([h.ttft_s for h in handles], 50)) * 1e3)
        log(f"head dims server {route}: load + run {time.perf_counter() - t0:.1f} s; launches "
            f"{got}; every lane the unsharded Engine's stream; decode {tok_s:.2f} tok/s")
        del srv
        torch.cuda.empty_cache()

    # rows 5-7 at a rank's shard shapes: 4 q heads over one KV head of each width
    dev = torch.device("cuda")
    B, S, h = HD_SERVER["max_batch"], HD_SERVER["max_seq"], GEOM_G4["n_head"] // 2
    lengths = torch.tensor([S, 0, 300, 47], dtype=torch.int32, device=dev)
    rowidx = torch.tensor([S - 1, B * S, 2 * S + 299, 3 * S + 46], dtype=torch.int32, device=dev)
    err = 0.0
    for d in HD_DIMS:
        q = torch.randn((B, h, d), device=dev, generator=g) * (0.5 / math.sqrt(d))
        kc, vc = (torch.randn((B, S, 1, d), device=dev, generator=g).to(torch.bfloat16)
                  for _ in range(2))
        k, v = (torch.randn((B, 1, d), device=dev, generator=g) for _ in range(2))
        err = max(err, _check_rank_attention(f"head dims rank shard d={d}", q, kc, vc, k, v,
                                             rowidx, lengths))
    log(f"head dims rank shards: insert_kv_rows bit-equal, flash_decode within 2e-3 (max "
        f"{err:.3e}) at q [{B}, {h}, d] over [{B}, {S}, 1, d], d in {HD_DIMS}")
    return results, launches, err


TOOLS_PPL_TOKENS = 32   # phase 23's perplexity stream: the golden prompt and its first 32 tokens
TOOLS_CHUNK = 16        # ... scored in chunks of 16, the Engine's decode chunk
TOOLS_PER_OP_CHUNK = 1  # the per-op routes' traced chunk: the profiler takes ~1 s to
                        # process a per-op step's ~2000 kernels and their host ops
TOOLS_BATCH = 4         # the roofline's servers: 4 lanes, dense and out of 16 pages
TOOLS_PROMPT = "t100t2000t31 t4095"  # the comparison's prompt: 11 ids of TOOLS_VOCAB


def _counted(total, fn, *args, **kw):
    """``fn(*args, **kw)``, adding the port wrappers' launches during it to ``total``."""
    import torch
    import torch_roofline

    before = torch_roofline.launch_counts()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    after = torch_roofline.launch_counts()
    total.update({k: after[k] - before[k] for k in after})
    return out


def _tool_main(total, tool, argv: list[str]) -> tuple[int, str]:
    """A tool's ``main(argv)``, counted, with its standard output."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _counted(total, tool.main, argv)
    return rc, buf.getvalue()


def _engine(path, mode: str, per_op: bool = False, chunk: int = TOOLS_CHUNK):
    import os

    from llm_inference_tpu_torch.engine import Engine

    if per_op:
        os.environ["LLMI_NO_FUSED_DECODE"] = "1"  # the JAX package's own switch
    try:
        eng = Engine(str(path), mode=mode, max_seq=1024, decode_chunk=chunk, device="cuda")
    finally:
        os.environ.pop("LLMI_NO_FUSED_DECODE", None)
    want = "per-op" if per_op or mode == "serve" else "kernel"
    if eng.decode_route != want:
        fail(f"tools: {mode} took the {eng.decode_route} route, not the {want} route")
    return eng


def _prefill_logprobs(eng, ids: list[int]):
    """Teacher forcing through one prefill ``forward`` over ``ids[:-1]`` (the
    engine's prefill operands): every position's logits, from the last
    layer's output (its ``l_out`` tap) through the forward's own final norm
    and logits matmul. Returns (log p of ids[1:] [n], max|logits| [n])."""
    import os

    import torch

    from llm_inference_tpu_torch import trace
    from llm_inference_tpu_torch.engine import prefill_bucket
    from llm_inference_tpu_torch.models import gemma
    from llm_inference_tpu_torch.ops.numerics import softcap

    hp, w, n = eng.hparams, eng._prefill_w, len(ids) - 1
    padded = torch.zeros(prefill_bucket(n), dtype=torch.int64)
    padded[:n] = torch.tensor(ids[:-1], dtype=torch.int64)
    session = trace.enable_trace(os.devnull)
    try:
        gemma.forward(hp, w, eng.new_cache(), padded.cuda(), 0, n, exact=False)
    finally:
        trace.disable_trace()
    x = next(v for name, v in session.records if name == f"l_out-{hp.block_count - 1}")
    x = torch.from_numpy(np.ascontiguousarray(x[:n])).cuda()
    logits = softcap(gemma._mm(False, "auto")(w.token_embd, gemma._norm(x, w.output_norm,
                                                                         hp.rms_eps)),
                     hp.final_logit_softcap).float()
    tgt = torch.tensor(ids[1:], dtype=torch.int64, device="cuda")
    lp = torch.log_softmax(logits, dim=-1).gather(1, tgt[:, None])[:, 0]
    return lp.cpu().numpy(), logits.abs().amax(dim=1).cpu().numpy()


def _held(what: str, got, ref, amax) -> float:
    """Per-position log-probs within 3e-2 * max(1, max|logits|): twice the
    suite's logit bar (a log-softmax entry moves by at most twice its
    inputs' largest change). Returns the worst gap over its bar."""
    bar = 3e-2 * np.maximum(1.0, amax)
    gap = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    worst = float((gap / bar).max())
    log(f"tools: {what}: largest log-prob gap {gap.max():.3e} ({worst:.3f} of its bar, "
        f"max|logits| up to {amax.max():.3f})")
    if not np.all(np.isfinite(got)) or worst > 1.0:
        i = int(np.argmax(gap / bar))
        fail(f"tools: {what}: position {i}'s log-prob {got[i]:.6f} against {ref[i]:.6f}, "
             f"past 3e-2 * max(1, {amax[i]:.3f})")
    return worst


def phase_tools(smi: str):
    """Phase 23: the port's tools (tools/torch_*.py) on the card, on the tame
    1B: perplexity of the golden prompt and its first TOOLS_PPL_TOKENS
    tokens (63 scored positions) in serve-q8 on the kernel route and per op
    (LLMI_NO_FUSED_DECODE=1, LLMI_FLASH_DECODE=1) and in serve, the routes'
    per-position log-probs within 3e-2 * max(1, max|logits|) of each other
    and of one teacher-forced prefill over the same 64 tokens, serve and
    serve-q8 mean NLL within 5%, the stream below the same prompt with a
    random continuation; greedy parity in serve-q8 and serve-q4 on the
    kernel route, 100/100 of the golden; the reference comparison of
    tools_checkpoint's model on the card against its CPU taps written in
    the reference printer's format (PARITY OK at rel_tol 1e-3), and against
    the same dump with one tensor x 1.01 (exit 1, that tensor named); the
    roofline of the serve-q8 kernel route (2 chunks of 16), the per-op route
    (1 chunk of 1, flash attention), prefill buckets 32 and 64 (one prefill
    each) and BatchedServer at TOOLS_BATCH lanes dense (1 chunk of 16) and
    paged (1 chunk of 1): every port
    kernel's traced calls equal to its wrapper's launches over the window,
    the step bound equal to rowq8_step_work's within 1%. Returns (results,
    launches)."""
    import collections
    import os

    import torch

    if str(ROOT / "tools") not in sys.path:
        sys.path.insert(0, str(ROOT / "tools"))
    import torch_compare_with_reference as compare
    import torch_greedy_parity as greedy
    import torch_perplexity as perplexity
    import torch_roofline as roofline

    from llm_inference_tpu_torch import parity
    from llm_inference_tpu_torch.serving import BatchedServer

    golden = json.loads((ROOT / "tests" / "golden" / "parity_1b_tame.json").read_text())
    path = tame_checkpoint()
    total = collections.Counter()
    res, secs = {}, {}

    # perplexity: the kernel route, per op, serve; against one prefill
    t0 = time.perf_counter()
    ids = golden["prompt"] + golden["tokens"][:TOOLS_PPL_TOKENS]
    kq8 = _engine(path, "serve-q8")
    lp_k, amax_k = _counted(total, perplexity.token_logprobs, kq8, ids, chunk=TOOLS_CHUNK,
                            with_max=True)
    kp = _engine(path, "serve-q8", per_op=True, chunk=TOOLS_PER_OP_CHUNK)
    os.environ["LLMI_FLASH_DECODE"] = "1"
    try:
        lp_p, amax_p = _counted(total, perplexity.token_logprobs, kp, ids, chunk=TOOLS_CHUNK,
                                with_max=True)
    finally:
        os.environ.pop("LLMI_FLASH_DECODE", None)
    serve = _engine(path, "serve")
    _, nll_s, n_s = _counted(total, perplexity.perplexity, serve, ids, chunk=TOOLS_CHUNK)
    del serve
    torch.cuda.empty_cache()
    lp_f, amax_f = _prefill_logprobs(kq8, ids)
    res["routes_worst"] = _held("serve-q8 kernel route against per op", lp_k, lp_p,
                                np.maximum(amax_k, amax_p))
    res["prefill_worst"] = _held("serve-q8 kernel route against one prefill", lp_k, lp_f,
                                 np.maximum(amax_k, amax_f))
    nll = {"serve-q8 kernel": float(-lp_k.astype(np.float64).mean()),
           "serve-q8 per-op": float(-lp_p.astype(np.float64).mean()), "serve": nll_s,
           "serve-q8 prefill": float(-lp_f.astype(np.float64).mean())}
    if n_s != len(ids) - 1 or abs(nll_s - nll["serve-q8 kernel"]) / nll_s >= 0.05:
        fail(f"tools: serve's mean NLL {nll_s:.6f} against serve-q8's "
             f"{nll['serve-q8 kernel']:.6f}: not within 5%")
    rng = np.random.default_rng(23)
    rand = golden["prompt"] + rng.integers(10, 10000, size=TOOLS_PPL_TOKENS).tolist()
    ppl_own = math.exp(nll["serve-q8 kernel"])
    ppl_rand, _, _ = _counted(total, perplexity.perplexity, kq8, rand, chunk=TOOLS_CHUNK)
    if not ppl_own < ppl_rand:
        fail(f"tools: the model's own stream scores {ppl_own:.4f}, a random continuation "
             f"{ppl_rand:.4f}")
    res["ppl"] = {k: math.exp(v) for k, v in nll.items()}
    res["nll"] = nll
    res["ppl_random"] = ppl_rand
    log("tools: perplexity of the golden prompt + 32 golden tokens (63 positions): "
        + ", ".join(f"{k} {math.exp(v):.4f} (nll {v:.6f})" for k, v in nll.items())
        + f"; a random continuation {ppl_rand:.4f}")
    secs["perplexity"] = time.perf_counter() - t0

    # greedy parity
    t0 = time.perf_counter()
    before = collections.Counter(total)
    rows, ok, got = _counted(total, greedy.run, path, ["serve-q8", "serve-q4"],
                             golden["prompt"], golden["tokens"], "cuda")
    for row in rows:
        log(f"tools: greedy parity {row}")
    steps = len(golden["tokens"])
    for mode, r in got.items():
        if r is None or r[0] != steps:
            fail(f"tools: greedy parity {mode}: {rows}")
    gp = {k: total[k] - before[k] for k in ("decode_step", "decode_step_q")}
    if gp != {"decode_step": 112, "decode_step_q": 112}:
        fail(f"tools: greedy parity did not take the kernel routes: launches {gp}")
    secs["greedy parity"] = time.perf_counter() - t0

    # the reference comparison: the card against the CPU's taps
    t0 = time.perf_counter()
    cpath = tools_checkpoint()
    from llm_inference_tpu_torch.gguf.reader import GGUFFile
    from llm_inference_tpu_torch.models.hparams import load_hparams
    from llm_inference_tpu_torch.tokenizer import Tokenizer

    g = GGUFFile(str(cpath))
    cids = Tokenizer(g.metadata, load_hparams(g.metadata).architecture).encode(
        TOOLS_PROMPT, False).ids
    recs = compare.port_records(cpath, cids, "cpu")
    dump = Path(tempfile.gettempdir()) / "llmi_torch_tools_reference_dump.txt"
    dump.write_text(parity.format_reference_dump(recs))
    argv = ["-m", str(cpath), "-p", TOOLS_PROMPT, "--ref-dump", str(dump)]
    rc, out = _tool_main(total, compare, argv)
    if rc != 0 or "PARITY OK" not in out:
        fail(f"tools: the comparison against the CPU's taps exits {rc}:\n{out[-3000:]}")
    ratio = [abs(float(v.sum())) / max(float(np.abs(v).sum()), 1e-30) for _, v in recs]
    j = int(np.argmax(ratio))
    rel = 0.01 * ratio[j] / 1.01
    if rel < 1.5e-3:
        fail(f"tools: no tap's sum moves past rel_tol under x 1.01 (best {recs[j][0]}: {rel:.2e})")
    dump.write_text(parity.format_reference_dump([(n, v * np.float32(1.01) if i == j else v)
                                    for i, (n, v) in enumerate(recs)]))
    rc_f, out_f = _tool_main(total, compare, argv)
    named = re.findall(r"^  (.+?)\s+ref=", out_f.split("top offenders:", 1)[-1], flags=re.M)
    if rc_f != 1 or named != [recs[j][0]]:
        fail(f"tools: the dump with {recs[j][0]} x 1.01 exits {rc_f} naming {named}")
    log(f"tools: comparison of {len(recs)} taps ({len(cids)} ids) on the card against the CPU's: "
        f"PARITY OK; {recs[j][0]} x 1.01 (rel {rel:.2e}) named, exit 1")
    secs["comparison"] = time.perf_counter() - t0

    # the roofline
    t0 = time.perf_counter()
    reports, rsecs = {}, {}

    def report(name, fn, *args, **kw):
        t1 = time.perf_counter()
        reports[name] = _counted(total, fn, *args, **kw)
        rsecs[name] = round(time.perf_counter() - t1, 1)

    report("kernel", roofline.roofline_engine, kq8, chunks=2)
    os.environ["LLMI_FLASH_DECODE"] = "1"
    try:
        report("per-op", roofline.roofline_engine, kp, chunks=1)
    finally:
        os.environ.pop("LLMI_FLASH_DECODE", None)
    report("prefill", roofline.roofline_prefill, kq8, (32, 64), reps=1)
    del kp
    for name, pages in (("batch", None), ("paged", TOOLS_BATCH * 4)):
        t1 = time.perf_counter()
        srv = BatchedServer(str(path), mode="serve-q8", max_seq=1024, max_batch=TOOLS_BATCH,
                            decode_chunk=TOOLS_PER_OP_CHUNK if pages else TOOLS_CHUNK,
                            max_admit_per_step=TOOLS_BATCH, kv_pages=pages, device="cuda")
        rsecs[f"{name} load"] = round(time.perf_counter() - t1, 1)
        want = "paged-per-op" if pages else "kernel"
        if srv.decode_route != want:
            fail(f"tools: the {name} server took the {srv.decode_route} route")
        report(name, roofline.roofline_server, srv, chunks=1)
        del srv
        torch.cuda.empty_cache()
    log(f"tools: roofline seconds {rsecs}; the profiler's own seconds "
        f"{ {k: round(v.get('profiler_s', 0.0), 1) for k, v in reports.items()} }")
    try:
        roofline.check_launches(*reports.values())
    except RuntimeError as e:
        fail(f"tools: roofline: {e}")
    hp = kq8.hparams
    for route in ("kernel", "per-op"):
        r = reports[route]
        want = float(np.mean([bound_ms(*rowq8_step_work(hp, p)) for p in range(*r["positions"])]))
        if abs(r["bound_ms"] / want - 1) > 0.01:
            fail(f"tools: roofline {route}: bound {r['bound_ms']:.6f} ms against "
                 f"rowq8_step_work's {want:.6f}")
    for name, r in reports.items():
        log(f"tools: roofline {name} (on {smi}):\n" + "\n".join(r["lines"]))
        log(f"tools: roofline {name} launches: {r['launch_rows']}")
    secs["roofline"] = time.perf_counter() - t0
    res["roofline"] = {k: {x: v[x] for x in ("bound_ms", "device_ms", "summed_ms", "wall_ms",
                                             "busy")
                           if x in v} for k, v in reports.items()}
    res["prefill"] = reports["prefill"]["rows"]
    res["seconds"] = secs
    del kq8
    torch.cuda.empty_cache()
    log(f"tools: seconds {secs}; launches {dict(total)}")
    return res, {k: v for k, v in total.items() if v}


def print_g4_results(g4s: dict, smi: str) -> None:
    """Phase 16's end-to-end numbers, a line each route."""
    for route, r in g4s.items():
        if "decode_tok_s" in r:
            print(f"slice gemma4 serve-q8 {route} route: decode_tok_s={r['decode_tok_s']:.3f} "
                  f"ttft_ms={r['ttft_ms']:.3f} load_peak_gb={r['peak_gb']:.3f} on {smi}")
        else:
            print(f"gemma4 {route}: decode_tok_s={r['tok_s']:.3f} "
                  f"p50_ttft_ms={r['ttft_ms']:.3f} on {smi}")


PHASE_SECONDS: dict = {}


def _phase(name: str, fn, *args):
    """Run a phase and record its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    log(f"phase {name}: {PHASE_SECONDS[name]:.1f} s")
    return out


def main() -> int:
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    t_all = time.perf_counter()
    start_checkpoint_builders()
    name, smi = _phase("1 device", phase_device)
    _phase("2 build", phase_build)
    qm_err, qm = _phase("3 quant_matmul", phase_quant_matmul)
    dec_err, dec = _phase("4 decode_step", phase_decode_step)
    counts, perf = _phase("5 slice", phase_slice)
    log(f"slice: decode {perf['decode_tok_s']:.2f} tok/s, TTFT (median) "
        f"{perf['ttft_ms']:.2f} ms ({perf['prompt_tokens']}-token prompt) on {smi}")
    print(f"slice serve-q8 decode_tok_s={perf['decode_tok_s']:.3f} "
          f"ttft_ms={perf['ttft_ms']:.3f} on {smi}")
    kernels = [
        dict(name="quant_matmul", route="cuda", source="llm_inference_tpu_torch/csrc/qmatmul.cu",
             replaces="llm_inference_tpu/ops/pallas/qmatmul.py:129",
             launches=counts["quant_matmul"], max_abs_err=qm_err, ms=qm["ms"],
             plain_ms=qm["plain_ms"], bound_ms=qm["bound_ms"], bound_by="bytes",
             library_ms=qm["library_ms"], note="sum over the four 1B layer shapes at T=32"),
        dict(name="decode_step", route="cuda",
             source="llm_inference_tpu_torch/csrc/fused_decode.cu",
             replaces="llm_inference_tpu/ops/pallas/fused_decode.py:674",
             launches=counts["decode_step"], max_abs_err=dec_err, ms=dec["ms"],
             plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"], bound_by=dec["bound_by"],
             library_ms=None)]
    gm = _phase("8 grouped per-op kernels", phase_grouped_matmul)
    lq_err, lq = _phase("9 lossless step", phase_lossless_step)
    lslice = _phase("10 lossless slice", phase_lossless_slice)
    for (mode, route), r in lslice.items():
        print(f"slice {mode} {route} route: decode_tok_s={r['decode_tok_s']:.3f} "
              f"ttft_ms={r['ttft_ms']:.3f} on {smi}")
    grouped = gm["int8 gs32 (Q4_0)"]
    nib = gm["nibble centered (Q4_0)"]
    step_q = lq["tame serve-q"]
    kernels += [
        dict(name="quant_matmul_grouped", route="cuda",
             source="llm_inference_tpu_torch/csrc/qmatmul.cu",
             replaces="llm_inference_tpu/ops/pallas/qmatmul.py:65",
             launches=lslice[("serve-q", "per-op")]["counts"]["quant_matmul_grouped"],
             max_abs_err=max(v["err"] for k, v in gm.items() if "int8" in k), ms=grouped["ms"],
             plain_ms=grouped["plain_ms"], bound_ms=grouped["bound_ms"], bound_by="bytes",
             library_ms=grouped["library_ms"],
             note=f"sum over the four 1B layer shapes at T=32, Q4_0-like int8 gs 32 (T=1: "
                  f"{grouped['t1']['ms']:.4f} ms)"),
        dict(name="q4_matmul", route="cuda", source="llm_inference_tpu_torch/csrc/qmatmul.cu",
             replaces="llm_inference_tpu/ops/pallas/qmatmul.py:202",
             launches=lslice[("serve-q4", "per-op")]["counts"]["q4_matmul"],
             max_abs_err=max(v["err"] for k, v in gm.items() if "nibble" in k), ms=nib["ms"],
             plain_ms=nib["plain_ms"], bound_ms=nib["bound_ms"], bound_by="bytes",
             library_ms=nib["library_ms"],
             note=f"sum over the four 1B layer shapes at T=32, Q4_0 nibbles (T=1: "
                  f"{nib['t1']['ms']:.4f} ms)"),
        dict(name="decode_step_q", route="cuda",
             source="llm_inference_tpu_torch/csrc/fused_decode_q.cu",
             replaces="llm_inference_tpu/ops/pallas/fused_decode_q.py:550",
             launches=sum(lslice[(m, "kernel")]["counts"]["decode_step_q"]
                          for m in ("serve-q", "serve-q4")),
             max_abs_err=lq_err, ms=step_q["ms"], plain_ms=step_q["plain_ms"],
             bound_ms=step_q["bound_ms"], bound_by=step_q["bound_by"], library_ms=None,
             note="tame 1B serve-q weights, pos 300; launches over serve-q and serve-q4"),
    ]
    # the tools run while the process is young: torch.profiler's clock drifts with its age
    tools, tools_launches = _phase("23 tools", phase_tools, smi)
    bk = _phase("6 batched kernels", phase_batched_kernels)
    srv = _phase("7 server", phase_server, smi)
    for route in ("kernel", "per-op"):
        r = srv[route]
        print(f"server {route} route: decode_tok_s={r['tok_s']:.3f} "
              f"p50_ttft_ms={r['ttft_ms']:.3f} admissions_s={r['admissions_s']:.4f} "
              f"batch={BATCH} on {smi}")
    adm = srv["admission"]
    print(f"server admission of {BATCH} prompts of 32 ids: group_s={adm['group_s']:.4f} "
          f"lone_s={adm['lone_s']:.4f} first_ids_equal={adm['ids_equal']}/{BATCH} "
          f"kv_rel_err={adm['kv_rel']:.3e} kv_max_abs_err={adm['kv_err']:.3e} on {smi}")
    launches = {"decode_step_batch": srv["kernel"]["counts"]["decode_step_batch"],
                "flash_decode": srv["per-op"]["counts"]["flash_decode"],
                "insert_rows": srv["per-op"]["counts"]["insert_rows"]}
    where = {"decode_step_batch": ("fused_decode_batch.cu", "fused_decode_batch.py:566"),
             "flash_decode": ("flash_decode.cu", "flash_decode.py:284"),
             "insert_rows": ("kv_insert.cu", "kv_insert.py:51")}
    for k in ("decode_step_batch", "flash_decode", "insert_rows"):
        r = bk[k]
        kernels.append(dict(
            name=k, route="cuda", source=f"llm_inference_tpu_torch/csrc/{where[k][0]}",
            replaces=f"llm_inference_tpu/ops/pallas/{where[k][1]}", launches=launches[k],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    ins = bk["insert_rows"]
    kernels[-1]["note"] = (
        f"insert_kv_rows: a layer's K and V rows in one launch, f32 in, bf16 out, cold over 26 "
        f"layers; library: two index_copy_ on pre-cast rows; the one-pool insert_rows "
        f"{ins['one_pool_ms']:.5f} ms; the two casts + two insert_rows it replaced "
        f"{ins['parent_seq_ms']:.5f} ms")
    pk = _phase("11 paged kernels", phase_paged_kernels)
    psrv = _phase("12 paged server", phase_paged_server, srv["kernel"]["streams"], smi)
    for route in ("paged-per-op", "paged-kernel", "serve-q", "serve-q4"):
        r = psrv[route]
        print(f"paged server {route}: decode_tok_s={r['tok_s']:.3f} "
              f"p50_ttft_ms={r['ttft_ms']:.3f} admissions_s={r['admissions_s']:.4f} on {smi}")
    adm = psrv["admission"]
    print(f"paged server admission of {BATCH} prompts of 32 ids: group_s={adm['group_s']:.4f} "
          f"lone_s={adm['lone_s']:.4f} first_ids_equal={adm['ids_equal']}/{BATCH} "
          f"kv_rel_err={adm['kv_rel']:.3e} kv_max_abs_err={adm['kv_err']:.3e} on {smi}")
    paged_launches = {"paged_flash_decode": psrv["paged-per-op"]["counts"]["paged_flash_decode"],
                      "decode_step_batch_paged":
                          psrv["paged-kernel"]["counts"]["decode_step_batch_paged"]}
    where = {"paged_flash_decode": ("flash_decode.cu", "flash_decode.py:181"),
             "decode_step_batch_paged": ("fused_decode_batch.cu",
                                         "fused_decode_batch_paged.py:539")}
    for k in ("paged_flash_decode", "decode_step_batch_paged"):
        r = pk[k]
        kernels.append(dict(
            name=k, route="cuda", source=f"llm_inference_tpu_torch/csrc/{where[k][0]}",
            replaces=f"llm_inference_tpu/ops/pallas/{where[k][1]}", launches=paged_launches[k],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    golden = json.loads((ROOT / "tests" / "golden" / "parity_1b_tame.json").read_text())
    st_err, st = _phase("13 capacity step", phase_stream_step, golden)
    cap = _phase("14 capacity slice", phase_capacity_slice, golden)
    for (mode, route), r in cap.items():
        print(f"slice 12B {mode} {route} route: decode_tok_s={r['decode_tok_s']:.3f} "
              f"ttft_ms={r['ttft_ms']:.3f} to_first_token_s={r['to_first_s']:.3f} "
              f"load_peak_gb={r['peak_gb']:.3f} on {smi}")
    stream_q4 = st["random serve-q4 nibble+offsets"]
    kernels.append(dict(
        name="decode_step_stream", route="cuda",
        source="llm_inference_tpu_torch/csrc/fused_decode_stream.cu",
        replaces="llm_inference_tpu/ops/pallas/fused_decode_stream.py:882",
        launches=sum(cap[(m, "capacity")]["counts"]["decode_step_stream"]
                     for m in ("serve-q4", "serve-q")),
        max_abs_err=st_err, ms=stream_q4["ms"], plain_ms=stream_q4["plain_ms"],
        bound_ms=stream_q4["bound_ms"], bound_by=stream_q4["bound_by"], library_ms=None,
        note="12B random serve-q4 weights, 48 layers, pos 300; launches over phase 14's two "
             "capacity runs (serve-q4's over raw f16 scales)"))
    # rows 10 and 2 with raw f16 scales: launched by phase 13's tame 1B serve-q4 capacity run
    # over its own f16 scales (its decode steps, and its prefill's q4_matmul)
    f16_counts = st["tame serve-q4 f16 scales"]["counts"]
    s16, s32 = st["random serve-q4 Q4_0 f16 scales"], st["random serve-q4 Q4_0 f32 scales"]
    nib16 = gm["nibble centered (Q4_0) f16 scales"]
    kernels += [
        dict(name="decode_step_stream_f16_scales", route="cuda",
             source="llm_inference_tpu_torch/csrc/fused_decode_stream.cu",
             replaces="llm_inference_tpu/ops/pallas/fused_decode_stream.py:882",
             launches=f16_counts["decode_step_stream"], max_abs_err=s16["err"], ms=s16["ms"],
             plain_ms=s16["plain_ms"], bound_ms=s16["bound_ms"], bound_by=s16["bound_by"],
             library_ms=None,
             note=f"12B random centered Q4_0 nibbles with raw f16 scales, 48 layers, pos 300, "
                  f"bit-equal to the same weights with f32 scales: {s32['ms']:.4f} ms, bound "
                  f"{s32['bound_ms']:.4f} ({s16['bytes'] / 1e9:.3f} against "
                  f"{s32['bytes'] / 1e9:.3f} GB); launches: phase 13's tame 1B run"),
        dict(name="q4_matmul_f16_scales", route="cuda",
             source="llm_inference_tpu_torch/csrc/qmatmul.cu",
             replaces="llm_inference_tpu/ops/pallas/qmatmul.py:202",
             launches=f16_counts["q4_matmul"], max_abs_err=nib16["err"], ms=nib16["ms"],
             plain_ms=nib16["plain_ms"], bound_ms=nib16["bound_ms"], bound_by="bytes",
             library_ms=nib16["library_ms"],
             note=f"sum over the four 1B layer shapes at T=32, Q4_0 nibbles with raw f16 scales, "
                  f"bit-equal to f32 scales (T=1: {nib16['t1']['ms']:.4f} ms; f32 scales in this "
                  f"run {nib['ms']:.4f}, T=1 {nib['t1']['ms']:.4f}); launches: phase 13's tame "
                  f"1B capacity prefill")]
    g4_err, g4 = _phase("15 gemma4 step", phase_g4_step)
    g4s = _phase("16 gemma4 slice", phase_g4_slice)
    print_g4_results(g4s, smi)
    kernels.append(dict(
        name="decode_step_gemma4", route="cuda", source="llm_inference_tpu_torch/csrc/fused_decode.cu",
        replaces="llm_inference_tpu/ops/pallas/fused_decode.py:674",
        launches=g4s["kernel"]["counts"]["decode_step"], max_abs_err=g4_err, ms=g4["ms"],
        plain_ms=g4["plain_ms"], bound_ms=g4["bound_ms"], bound_by=g4["bound_by"],
        library_ms=None, note="GEOM_G4 random rowq8 weights, 24 layers (4 shared-KV), pos 300; "
                              "launches over phase 16's kernel route"))
    tp_err, tp = _phase("17 tp step", phase_tp_step)
    tps = _phase("18 tp slice", phase_tp_slice)
    for (mode, n), r in tps.items():
        print(f"slice {mode} tp n={n} (one card): decode_tok_s={r['decode_tok_s']:.3f} "
              f"ttft_ms={r['ttft_ms']:.3f} on {smi}")
    for key, label, src, where, modes in (
            ("decode_step_tp", "random rowq8", "fused_decode_tp.cu", "fused_decode_tp.py:547",
             ("serve-q8",)),
            ("decode_step_q_tp", "random serve-q int8", "fused_decode_q_tp.cu",
             "fused_decode_q_tp.py:577", ("serve-q", "serve-q4"))):
        r = tp[(label, 2)]
        kernels.append(dict(
            name=key, route="cuda", source=f"llm_inference_tpu_torch/csrc/{src}",
            replaces=f"llm_inference_tpu/ops/pallas/{where}",
            launches=sum(v["counts"][key] for (m, _), v in tps.items() if m in modes),
            max_abs_err=tp_err[key], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            note=f"1B {label} weights, 2 ranks on one card, pos 300; bound over both ranks' "
                 f"bytes; launches over phase 18's {' and '.join(modes)} runs"))
    sp = _phase("19 serve and parity", phase_serve_parity)
    for (what, route), r in sp.items():
        if "decode_tok_s" in r:
            print(f"slice {what} {route}: decode_tok_s={r['decode_tok_s']:.3f} "
                  f"ttft_ms={r['ttft_ms']:.3f} on {smi}")
        else:
            print(f"{what} {route}: decode_tok_s={r['tok_s']:.3f} "
                  f"p50_ttft_ms={r['ttft_ms']:.3f} on {smi}")
    smp = _phase("20 sampling", phase_sampling)
    for B, r in smp["sampler"].items():
        ms = {k: f"{r[k]:.4f}" if r[k] is not None else "not measured"
              for k in ("sample_ms", "bits_ms", "argmax_ms")}
        print(f"sampler B={B} V={VOCAB_SIZE} (T 0.8, top_k 40, top_p 0.95): device ms a call "
              f"{ms['sample_ms']} (its random words {ms['bits_ms']}), greedy argmax "
              f"{ms['argmax_ms']}; eager {r['sample_eager_ms']:.4f} / {r['argmax_eager_ms']:.4f} "
              f"on {smi}")
    print(f"slice serve-q8 kernel route, sampled: decode_tok_s="
          f"{smp['engine']['decode_tok_s']:.3f} ttft_ms={smp['engine']['ttft_ms']:.3f} on {smi}")
    for route in ("per-op", "paged-per-op"):
        print(f"sampled server {route}: decode_tok_s={smp[route]['tok_s']:.3f} "
              f"p50_ttft_ms={smp[route]['ttft_ms']:.3f} batch={SAMPLE_REQUESTS} on {smi}")
    shd, shd_launches, shd_err = _phase("21 sharded", phase_sharded, smi)
    for (what, route), r in shd.items():
        if "decode_tok_s" in r:
            print(f"sharded slice serve-q8 Engine {route} (2 ranks on one card): decode_tok_s="
                  f"{r['decode_tok_s']:.3f} ttft_ms={r['ttft_ms']:.3f} on {smi}")
        else:
            print(f"sharded slice serve-q8 server {route} (one card): decode_tok_s="
                  f"{r['tok_s']:.3f} p50_ttft_ms={r['ttft_ms']:.3f} batch={SHARD_REQUESTS} "
                  f"on {smi}")
    for k in kernels:  # phase 21's sharded main-path launches join rows 1, 5, 6 and 7
        add = shd_launches.get({"insert_rows": "insert_kv_rows"}.get(k["name"], k["name"]), 0)
        if add:
            k["launches"] += add
            k["note"] = (k.get("note", "") + f"; launches include phase 21's {add} on the "
                         "sharded per-op path").lstrip("; ")
            if k["name"] == "quant_matmul":
                k["max_abs_err"] = max(k["max_abs_err"], shd_err)
    hd, hd_launches, hd_err = _phase("22 head dims", phase_head_dims, smi)
    for (what, route), r in ((k, v) for k, v in hd.items() if k != "times"):
        if "decode_tok_s" in r:
            print(f"head dims slice serve-q8 Engine {route}: decode_tok_s={r['decode_tok_s']:.3f} "
                  f"ttft_ms={r['ttft_ms']:.3f} on {smi}")
        else:
            print(f"head dims slice serve-q8 server {route}: decode_tok_s={r['tok_s']:.3f} "
                  f"p50_ttft_ms={r['ttft_ms']:.3f} batch={len(HD_PROMPT_LENS)} on {smi}")
    for k in kernels:  # phase 22's launches join rows 5, 6 and 7
        add = hd_launches.get({"insert_rows": "insert_kv_rows"}.get(k["name"], k["name"]), 0)
        if not add:
            continue
        k["launches"] += add
        note = f"launches include phase 22's {add} on per-layer head dims (512 / 256)"
        if k["name"] in ("flash_decode", "paged_flash_decode"):  # insert_kv_rows: bit-equal
            k["max_abs_err"] = max(k["max_abs_err"], hd_err)
            paged = k["name"] == "paged_flash_decode"
            for d, t in hd["times"].items():
                note += (f"; at Dk = Dv = {d} (GEOM_G4 heads, B 32, S 1024, cold over "
                         f"{HD_LAYERS} layers): {t['paged_ms' if paged else 'ms']:.4f} ms, plain "
                         f"{t['paged_plain_ms' if paged else 'plain_ms']:.4f}, bound "
                         f"{t['bound_ms']:.4f}" + ("" if paged else
                                                    f", sdpa {t['library_ms']:.4f}"))
        k["note"] = (k.get("note", "") + "; " + note).lstrip("; ")
    for k, v in tools["ppl"].items():
        print(f"tools perplexity {k} (tame 1B, 63 positions): {v:.6f} on {smi}")
    for k, v in tools["roofline"].items():
        if "device_ms" in v:
            print(f"tools roofline {k}: bound_ms={v['bound_ms']:.4f} device_ms={v['device_ms']:.4f} "
                  f"summed_ms={v['summed_ms']:.4f} wall_ms={v['wall_ms']:.4f} "
                  f"busy={v['busy']:.4f} on {smi}")
    print("tools seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in tools["seconds"].items()))
    for k in kernels:  # phase 23's launches join rows 1, 3, 4, 5, 6, 7 and 8
        add = tools_launches.get({"insert_rows": "insert_kv_rows"}.get(k["name"], k["name"]), 0)
        if add:
            k["launches"] += add
            k["note"] = (k.get("note", "") + f"; launches include phase 23's {add} (the tools: "
                         "perplexity, greedy parity, roofline)").lstrip("; ")
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
