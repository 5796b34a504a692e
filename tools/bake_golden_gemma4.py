#!/usr/bin/env python
"""Bake the golden greedy stream of the tame gemma4 checkpoint for
chip_smoke.py's gemma4 slice (tests/golden/gemma4_g4_tame.json).

    python tools/bake_golden_gemma4.py [--steps 100] [--device cpu]

The checkpoint is chip_smoke.gemma4_checkpoint()'s (bench.py's GEOM_G4 at
full width and depth, 4.80 GB, written once into the temp directory). The
stream comes from ``Reference`` below: a plain re-implementation of the JAX
package's serve-q8 per-op forward (llm_inference_tpu/models/gemma.py
``forward`` with exact=False on its unrolled per-row int8 weights, the
gemma4 per-layer inputs, shared-KV layers, V norm and out_scale included),
written here on torch without the port's model code and without JAX, so it
runs where JAX does not: the full-size checkpoint needs about 12 GB of host
memory for its f32 weight copies, more than a small CPU box should give a
bake. tests/test_torch_gemma4.py holds ``Reference`` against the JAX
package's serve-q8 Engine on small gemma4 checkpoints: identical greedy
streams, prefill logits within 1.5e-2 * max(1, max|logits|) of JAX's
(measured 2.3e-3 and 3.8e-3: bf16 re-roundings of f32 sums taken in
another order, as between the port's and JAX's per-op forwards). The weights
are the port's ``load_weights(mode="rowq8")``, which that test file holds
bit-equal to the JAX package's.

Two streams are baked, one a contract. ``tokens``: the serve-q8 Engine's
numerics (bf16 activations into every projection, the JAX package's CPU
route, and what the port's per-op kernels compute). ``server_tokens``: the
numerics of the per-op BatchedServer on its device, where every per-row
int8 projection called with mm_impl="xla" is the W8A8 product
(llm_inference_tpu/ops/linear.py ``int8_rowwise_matmul``; the port's server
on CUDA takes the same route): each activation row quantized to int8 by its
amax / 127, exact integer sums, times both scales. The per-layer model
projection keeps bf16 activations there, as the JAX package's
``_per_layer_inputs`` calls it with the default dispatch.
tests/test_torch_gemma4.py holds this mode against the JAX package's
forward and BatchedServer with their device dispatch forced on the CPU. On
the tame checkpoint both streams are 100 x 2423; the tame model's logits
crowd (random tied embedding rows of spread 0.02), so a contract that
differs anywhere may part from the other at the first token, and the two
are baked apart.

The JSON records the checkpoint's geometry, seed and sha256 (chip_smoke.py
refuses a stale bake), the prompt (the 1B golden's 32-token prompt) and the
two streams.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
GOLDEN = os.path.join(ROOT, "tests", "golden", "gemma4_g4_tame.json")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


class Reference:
    """The JAX package's serve-q8 per-op forward over the per-row int8
    weights of a GGUF checkpoint, one token sequence at a time: each
    projection multiplies bf16(activation) by bf16(q * row scale) with f32
    sums (its CPU route), attention is the masked f32 softmax over a bf16
    cache, the caches are one per layer that owns K/V."""

    def __init__(self, path: str, max_seq: int, device="cpu", w8a8: bool = False):
        from llm_inference_tpu_torch.gguf import GGUFFile
        from llm_inference_tpu_torch.models.weights import load_weights

        self.hp, w = load_weights(GGUFFile(path), mode="rowq8", device=device)
        hp = self.hp
        if hp.n_embd_head_k != hp.n_embd_head_k_swa or hp.f_max_alibi_bias > 0:
            raise ValueError("the reference takes uniform head dims and no ALiBi")
        self.w = w
        self.w8a8 = w8a8
        self.dev = torch.device(device)
        self._dense = {}  # id(weight) -> bf16-rounded f32 [R, C]; ("q", id) -> f64 quants
        n_kv, Hkv = hp.n_kv_layers, hp.n_head_kv
        self.k = torch.zeros((n_kv, max_seq, Hkv, hp.n_embd_head_k), dtype=torch.bfloat16,
                             device=self.dev)
        self.v = torch.zeros((n_kv, max_seq, Hkv, hp.n_embd_head_v), dtype=torch.bfloat16,
                             device=self.dev)

    def _mm(self, w, x: torch.Tensor, xla: bool = True) -> torch.Tensor:
        """``x`` times ``w``: with ``w8a8``, the W8A8 product wherever the
        JAX package's matmul takes it on its device (linear.py:97-115): a
        call with mm_impl="xla" (``xla``), or a weight of 16384 rows or more;
        bf16(x) times the bf16-rounded weight elsewhere."""
        if self.w8a8 and (xla or w.rows >= 16384):
            # activation rows to int8, exact integer sums, both scales
            amax = x.abs().amax(dim=-1, keepdim=True)
            d = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
            xq = torch.clamp(torch.round(x / d), -127, 127)
            qd = self._dense.get(("q", id(w)))
            if qd is None:
                qd = self._dense[("q", id(w))] = w.q.double()
            sums = (xq.double() @ qd.T).float()  # exact integers: |sum| < 2^53
            return sums * d * w.scale[:, 0][None, :]
        wd = self._dense.get(id(w))
        if wd is None:
            wd = _bf16(w.q.float() * w.scale)
            self._dense[id(w)] = wd
        return _bf16(x) @ wd.T

    def _rows(self, w, tokens: torch.Tensor) -> torch.Tensor:
        return w.q[tokens].float() * w.scale[tokens]

    def _rope(self, x: torch.Tensor, base: float, pos: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        half = d // 2
        i = torch.arange(half, dtype=torch.float32, device=self.dev)
        freq = 1.0 / torch.pow(float(base), 2.0 * i / d)
        ang = pos.float()[:, None] * freq[None, :] / torch.tensor(self.hp.rope_freq_scale)
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x0, x1 = x[..., :half], x[..., half:]
        return torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)

    def forward(self, tokens: list[int], pos: int, swa_mask: bool = False) -> torch.Tensor:
        """Logits [V] of the last of ``tokens`` at positions pos, pos + 1, ..."""
        hp, w = self.hp, self.w
        T, D, eps = len(tokens), hp.embedding_length, hp.rms_eps
        H, Hkv, dk, dv = hp.n_head, hp.n_head_kv, hp.n_embd_head_k, hp.n_embd_head_v
        tok = torch.tensor(tokens, dtype=torch.int64, device=self.dev)
        p = pos + torch.arange(T, device=self.dev)
        x = self._rows(w.token_embd, tok) * torch.tensor(math.sqrt(D))
        inp = None
        if w.token_embd_per_layer is not None:
            L, P = hp.block_count, hp.embedding_length_per_layer
            rows = self._rows(w.token_embd_per_layer, tok).reshape(T, L, P) * torch.tensor(
                math.sqrt(P))
            # the JAX package's _per_layer_inputs calls matmul with mm_impl="auto"
            proj = self._mm(w.per_layer_model_proj, x, xla=False) * torch.tensor(
                1.0 / math.sqrt(D))
            proj = _rms(proj.reshape(T, L, P), eps) * w.per_layer_proj_norm
            inp = (proj + rows) * torch.tensor(1.0 / math.sqrt(2.0))
        for i, lw in enumerate(w.layers):
            base = hp.rope_base_for_layer(i)
            src = hp.kv_source_layer(i)
            h = _rms(x, eps) * lw.attn_norm
            if lw.wqkv is not None:
                qkv = self._mm(lw.wqkv, h)
                q = qkv[:, : H * dk]
                k, v = qkv[:, H * dk : (H + Hkv) * dk], qkv[:, (H + Hkv) * dk :]
            else:
                q = self._mm(lw.wq, h)
                k = None if lw.wk is None else self._mm(lw.wk, h)
                v = None if lw.wv is None else self._mm(lw.wv, h)
            q = _rms(q.reshape(T, H, dk), eps) * lw.q_norm
            q = self._rope(q, base, p) * torch.tensor(hp.f_attention_scale)
            if hp.layer_has_kv(i):
                k = self._rope(_rms(k.reshape(T, Hkv, dk), eps) * lw.k_norm, base, p)
                v = v.reshape(T, Hkv, dv)
                if hp.architecture == "gemma4":
                    v = _rms(v, eps)
                self.k[src, pos : pos + T] = k.to(torch.bfloat16)
                self.v[src, pos : pos + T] = v.to(torch.bfloat16)
            n = pos + T
            kc, vc = self.k[src, :n].float(), self.v[src, :n].float()
            G = H // Hkv
            s = torch.einsum("tkgd,skd->tkgs", q.reshape(T, Hkv, G, dk), kc)
            if hp.attn_soft_cap > 0:
                s = hp.attn_soft_cap * torch.tanh(s / hp.attn_soft_cap)
            keys = torch.arange(n, device=self.dev)
            valid = keys[None, :] <= p[:, None]
            win = hp.swa_window(i) if swa_mask else 0
            if win > 0:
                valid &= keys[None, :] > p[:, None] - win
            s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
            e = torch.exp(s - s.amax(dim=-1, keepdim=True))
            a = torch.einsum("tkgs,skd->tkgd", e / e.sum(dim=-1, keepdim=True), vc)
            y = self._mm(lw.wo, a.reshape(T, H * dv))
            if lw.post_attn_norm is not None:
                y = _rms(y, eps) * lw.post_attn_norm
            x = x + y
            h2 = _rms(x, eps) * lw.ffn_norm
            gu = self._mm(lw.w_gate_up, h2) if lw.w_gate_up is not None else torch.cat(
                [self._mm(lw.w_gate, h2), self._mm(lw.w_up, h2)], dim=-1)
            F = gu.shape[-1] // 2
            y = self._mm(lw.w_down, _gelu(gu[:, :F]) * gu[:, F:])
            if lw.post_ffw_norm is not None:
                y = _rms(y, eps) * lw.post_ffw_norm
            x = x + y
            if inp is not None:
                g = _gelu(self._mm(lw.per_layer_inp_gate, x)) * inp[:, i]
                x = x + _rms(self._mm(lw.per_layer_proj, g), eps) * lw.per_layer_post_norm
            if lw.out_scale is not None:
                x = x * lw.out_scale.reshape(())
        last = _rms(x[-1], eps) * w.output_norm
        logits = self._mm(w.token_embd, last[None])[0]
        if hp.final_logit_softcap > 0:
            logits = hp.final_logit_softcap * torch.tanh(logits / hp.final_logit_softcap)
        return logits

    def greedy(self, prompt: list[int], steps: int) -> list[int]:
        """``steps`` greedy ids after ``prompt`` (no stop token)."""
        out = [int(self.forward(prompt, 0).argmax())]
        while len(out) < steps:
            out.append(int(self.forward([out[-1]], len(prompt) + len(out) - 1).argmax()))
        return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", default=GOLDEN)
    args = ap.parse_args()

    import chip_smoke

    torch.set_grad_enabled(False)
    t0 = time.time()
    path = chip_smoke.gemma4_checkpoint()
    digest = chip_smoke.sha256_of(path)
    with open(os.path.join(ROOT, "tests", "golden", "parity_1b_tame.json")) as f:
        prompt = json.load(f)["prompt"]  # the 1B golden's 32-token prompt
    streams = {}
    t1 = time.time()
    for key, w8a8 in (("tokens", False), ("server_tokens", True)):
        ref = Reference(str(path), max_seq=len(prompt) + args.steps + 16, device=args.device,
                        w8a8=w8a8)
        streams[key] = ref.greedy(prompt, args.steps)
        del ref
    t2 = time.time()
    record = {
        "checkpoint": {"writer": "chip_smoke.gemma4_checkpoint", "seed": chip_smoke.G4_SEED,
                       "weight_std": chip_smoke.TAME_STD, "geometry": chip_smoke.GEOM_G4,
                       "vocab_size": chip_smoke.VOCAB_SIZE,
                       "sliding_window": chip_smoke.G4_WINDOW, "sha256": digest},
        "mode": "serve-q8 per op (tools/bake_golden_gemma4.py Reference, no LLMI_SWA_MASK); "
                "tokens: bf16 activations, server_tokens: W8A8 projections",
        "prompt": prompt, "steps": args.steps, **streams,
    }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"baked {args.steps} tokens twice in {t2 - t1:.1f} s (checkpoint {t1 - t0:.1f} s) on "
          f"{args.device}: {streams['tokens'][:6]}... and {streams['server_tokens'][:6]}... -> "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
