"""The port's GGUF container reader and writer against llm_inference_tpu's.

Bar: bit-equal. Both packages must parse a checkpoint identically (metadata,
tensor directory, tensor bytes) and write identical bytes, since the port's
writer builds the at-scale checkpoint the golden stream was recorded on."""

import numpy as np
import pytest

from llm_inference_tpu.gguf import GGMLType as JGGMLType
from llm_inference_tpu.gguf import GGUFFile as JGGUFFile
from llm_inference_tpu.gguf import GGUFWriter as JGGUFWriter
from llm_inference_tpu.gguf import constants as jconst
from llm_inference_tpu_torch.gguf import GGMLType, GGUFFile, GGUFWriter
from llm_inference_tpu_torch.gguf import constants as tconst

import chip_smoke
from fixtures import build_gemma3_gguf, build_gemma4_gguf

FIXTURES = {
    "gemma3_default": lambda: build_gemma3_gguf(n_layers=2),
    "gemma3_hd128_post_norms": lambda: build_gemma3_gguf(
        n_layers=2, n_embd=256, n_ff=512, n_head=4, n_head_kv=2, head_dim=128,
        with_post_norms=True, sliding_window=8, swa_pattern=[True, False]),
    "gemma4": lambda: build_gemma4_gguf(n_layers=4),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reader_matches_jax_reader(name):
    buf = FIXTURES[name]()
    a, b = JGGUFFile(buf), GGUFFile(buf)
    assert (a.header.magic, a.header.version, a.header.tensor_count,
            a.header.metadata_kv_count) == (b.header.magic, b.header.version,
                                            b.header.tensor_count, b.header.metadata_kv_count)
    assert a.metadata == b.metadata
    assert a.data_section_start == b.data_section_start
    assert [(i.name, i.shape, int(i.tensor_type), i.offset) for i in a.tensor_infos] == [
        (i.name, i.shape, int(i.tensor_type), i.offset) for i in b.tensor_infos]
    for ia, ib in zip(a.tensor_infos, b.tensor_infos):
        np.testing.assert_array_equal(a.tensor_bytes(ia), b.tensor_bytes(ib))


def test_reader_from_path(tmp_path):
    buf = FIXTURES["gemma3_default"]()
    p = tmp_path / "m.gguf"
    p.write_bytes(buf)
    with GGUFFile(str(p)) as f, JGGUFFile(str(p)) as g:
        info = f.tensors["output_norm.weight"]
        np.testing.assert_array_equal(f.tensor_f32(info), g.tensor_f32(g.tensors[info.name]))
        np.testing.assert_array_equal(f.tensor_row_bytes(info, 0),
                                      g.tensor_row_bytes(g.tensors[info.name], 0))


def _write(writer_cls, ggml, rng_seed):
    rng = np.random.default_rng(rng_seed)
    w = writer_cls()
    w.add_metadata("general.architecture", "gemma3")
    w.add_metadata("some.int", 7).add_metadata("some.neg", -(2**40))
    w.add_metadata("some.float", 0.25).add_metadata("some.bool", True)
    w.add_metadata("some.list", ["a", "b"]).add_metadata("some.flags", [True, False])
    for i, fmt in enumerate(("F32", "F16", "BF16", "Q4_0", "Q5_0", "Q8_0", "Q4_K", "Q6_K")):
        w.add_tensor(f"t{i}", rng.standard_normal((3, 256)).astype(np.float32), ggml[fmt])
    w.add_tensor("raw", np.arange(18, dtype=np.uint8), ggml["Q4_0"], shape=(32, 1), raw=True)
    return w.build()


def test_writer_bytes_identical():
    assert _write(GGUFWriter, GGMLType.__members__, 3) == _write(
        JGGUFWriter, JGGMLType.__members__, 3)


@pytest.mark.parametrize("kw", [
    dict(n_layers=1),
    dict(n_layers=2, n_embd=256, n_ff=512, n_head=4, n_head_kv=1, head_dim=128,
         weight_std=0.02, seed=20260816),
    dict(n_layers=2, with_post_norms=True, rope_freq_base=1e6, seed=9),
], ids=["default", "tame_1b_like", "post_norms"])
def test_smoke_checkpoint_bytes_match_fixtures(kw):
    """chip_smoke.py builds the tame 1B checkpoint with the port's writer; at
    small sizes its bytes equal tests/fixtures.py's, which bench.py uses."""
    vocab = [f"t{i}" for i in range(300)]
    vocab[1], vocab[2], vocab[3] = "<eos>", "<bos>", "<unk>"
    assert chip_smoke.build_gemma3_gguf(vocab=vocab, **kw) == build_gemma3_gguf(vocab=vocab, **kw)


def test_constants_match():
    assert {int(k): v for k, v in tconst.BLOCK_GEOMETRY.items()} == {
        int(k): v for k, v in jconst.BLOCK_GEOMETRY.items()}
    assert [(m.name, int(m)) for m in GGMLType] == [(m.name, int(m)) for m in JGGMLType]
    assert (tconst.GGUF_MAGIC, tconst.GGUF_VERSION, tconst.GGUF_ALIGNMENT) == (
        jconst.GGUF_MAGIC, jconst.GGUF_VERSION, jconst.GGUF_ALIGNMENT)
