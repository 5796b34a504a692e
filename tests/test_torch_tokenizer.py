"""The port's tokenizer and hparams against llm_inference_tpu's, on the CPU.

Bar: identical. Both are pure-Python copies; the token ids decide every
greedy stream and the hparams every shape, so any difference is a fault."""

import dataclasses

import pytest

from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.models.hparams import load_hparams as jax_load_hparams
from llm_inference_tpu.tokenizer import Tokenizer as JTokenizer
from llm_inference_tpu_torch.gguf import GGUFFile
from llm_inference_tpu_torch.models.hparams import load_hparams
from llm_inference_tpu_torch.tokenizer import Tokenizer

from fixtures import build_gemma3_gguf, build_gemma4_gguf

FIXTURES = {
    "gemma3": lambda: build_gemma3_gguf(n_layers=2),
    "gemma3_swa": lambda: build_gemma3_gguf(n_layers=3, sliding_window=8,
                                            swa_pattern=[True, True, False],
                                            rope_freq_base=1e6),
    "gemma4": lambda: build_gemma4_gguf(n_layers=4),
}
PROMPTS = ["One sentence fact about silicon", "ab c", "abcabc  ab", "", "ü€ fact\nuser"]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_hparams_identical(name):
    buf = FIXTURES[name]()
    assert dataclasses.asdict(load_hparams(GGUFFile(buf).metadata)) == dataclasses.asdict(
        jax_load_hparams(JGGUFFile(buf).metadata))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_tokenizer_identical(name):
    buf = FIXTURES[name]()
    meta = GGUFFile(buf).metadata
    arch = load_hparams(meta).architecture
    a, b = Tokenizer(meta, arch), JTokenizer(JGGUFFile(buf).metadata, arch)
    for attr in ("bos_id", "unk_id", "eos_id", "end_of_turn_id", "think_id", "channel_id",
                 "add_bos", "max_token_len"):
        assert getattr(a, attr) == getattr(b, attr), attr
    for prompt in PROMPTS:
        for template in (True, False):
            ea, eb = a.encode(prompt, template), b.encode(prompt, template)
            assert (ea.ids, ea.prefilled_thinking) == (eb.ids, eb.prefilled_thinking)
            assert a.decode(ea.ids) == b.decode(eb.ids)
    ids = list(range(len(a.id_to_token)))
    assert [a.piece(i) for i in ids] == [b.piece(i) for i in ids]
    assert [a.is_stop(i) for i in ids] == [b.is_stop(i) for i in ids]
