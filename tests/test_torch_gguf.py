"""The port's GGUF module (classmate_rag_tpu_torch.models.gguf) against the
JAX package's, on the CPU.

Both are numpy; the port's is a copy that places a loaded tree on a torch
device. So everything is held EQUAL, bit for bit: the files either
package writes (byte for byte, and each package reads the other's), the
dequantisation of random raw blocks of every quant type, the quantizers,
``config_from_gguf`` and ``load_params_from_gguf``, and the embedded
tokenizer's ids and decoded text on the fixtures of tests/test_gguf.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from classmate_rag_tpu.models import gguf as JG
from classmate_rag_tpu.models.decoder import (
    DecoderConfig as JConfig,
    init_params as j_init,
)
from classmate_rag_tpu_torch.models import decoder as T
from classmate_rag_tpu_torch.models import gguf as TG

QUANTS = {"F32": JG.GGML_F32, "F16": JG.GGML_F16, "Q8_0": JG.GGML_Q8_0,
          "Q4_0": JG.GGML_Q4_0, "Q4_K": JG.GGML_Q4_K, "Q6_K": JG.GGML_Q6_K}
# Widths divisible by 256, so the K-quants apply to the matmul weights.
WIDE = dict(vocab_size=512, hidden=256, layers=1, heads=4, kv_heads=2,
            ffn=512, max_seq=128)
ARCHS = {"llama": {}, "qwen2": dict(qkv_bias=True),
         "qwen3": dict(qk_norm=True, head_dim_override=32)}


def _tiny_tokens(vocab_size):
    toks = ["<unk>", "<s>", "</s>"]
    toks += [f"<0x{b:02X}>" for b in range(256)]
    words = ["▁hello", "▁world", "▁ciao", "▁the", "▁a", "▁question",
             "▁answer", "hello", "world", "ing", "er", "▁con", "text"]
    toks += words
    toks += [f"<pad{i}>" for i in range(vocab_size - len(toks))]
    return toks[:vocab_size]


def _tok_metadata(G, vocab_size):
    tokens = _tiny_tokens(vocab_size)
    scores = [0.0] * 3 + [-10.0] * 256 + [-1.0] * 13 + [-25.0] * (
        vocab_size - 272)
    return {
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": (G.T_ARRAY, (G.T_STRING, tokens)),
        "tokenizer.ggml.scores": (G.T_ARRAY, (G.T_FLOAT32, scores)),
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.ggml.unknown_token_id": 0,
    }


def _model(arch="llama", **kw):
    cfg = JConfig(**{**WIDE, **ARCHS[arch], **kw})
    return cfg, j_init(cfg, f"gguf-{arch}", host=True)


def _assert_read_equal(path):
    jm, jt = JG.load_gguf(path)
    tm, tt = TG.load_gguf(path)
    assert jm == tm
    assert set(jt) == set(tt)
    for k in jt:
        assert jt[k].dtype == tt[k].dtype
        assert np.array_equal(jt[k], tt[k]), k
    return jm


@pytest.mark.parametrize("quant", list(QUANTS))
def test_files_cross_load(tmp_path, quant):
    """Both packages write the same bytes, and each reads the other's
    file to the same metadata and tensors."""
    cfg, tree = _model()
    tcfg = T.DecoderConfig(**WIDE)
    jpath, tpath = tmp_path / "j.gguf", tmp_path / "t.gguf"
    JG.export_decoder_to_gguf(jpath, tree, cfg, quant_type=QUANTS[quant],
                              extra_metadata=_tok_metadata(JG, 512))
    TG.export_decoder_to_gguf(tpath, tree, tcfg, quant_type=QUANTS[quant],
                              extra_metadata=_tok_metadata(TG, 512))
    assert jpath.read_bytes() == tpath.read_bytes()
    md = _assert_read_equal(jpath)
    assert md["tokenizer.ggml.tokens"] == _tiny_tokens(512)
    _assert_read_equal(tpath)
    # The tensor table too.
    jh, th = JG.read_gguf_header(tpath), TG.read_gguf_header(jpath)
    assert jh[1] == th[1] and jh[2] == th[2]


def test_metadata_all_types_cross_load(tmp_path):
    meta = {
        "u8": (TG.T_UINT8, 200), "i8": (TG.T_INT8, -100),
        "u16": (TG.T_UINT16, 60000), "i16": (TG.T_INT16, -30000),
        "u32": (TG.T_UINT32, 4000000000), "i32": (TG.T_INT32, -2000000000),
        "f32": (TG.T_FLOAT32, 1.5), "f64": (TG.T_FLOAT64, 2.25),
        "bool_t": True, "u64": 2**40, "neg": -7, "s": "ciao — καλημέρα",
        "arr_i": [1, 2, 3], "arr_f": [0.5, 1.5], "arr_s": ["a", "bb"],
        "general.alignment": 64,
    }
    arr = np.arange(64, dtype=np.float32).reshape(2, 32)
    TG.write_gguf(tmp_path / "t.gguf", meta, {"t": arr})
    JG.write_gguf(tmp_path / "j.gguf", meta, {"t": arr})
    assert (tmp_path / "t.gguf").read_bytes() == (
        tmp_path / "j.gguf").read_bytes()
    md = _assert_read_equal(tmp_path / "t.gguf")
    assert md["general.alignment"] == 64 and md["bool_t"] is True


_BLOCK_BYTES = {"Q8_0": 34, "Q4_0": 18, "Q4_K": 144, "Q6_K": 210,
                "F16": 2, "BF16": 2}
_ELEMS = {"Q8_0": 32, "Q4_0": 32, "Q4_K": 256, "Q6_K": 256, "F16": 1,
          "BF16": 1}


@pytest.mark.parametrize("name", list(_BLOCK_BYTES))
def test_dequantize_random_raw_blocks_bit_equal(name):
    gtype = JG.GGML_BF16 if name == "BF16" else QUANTS[name]
    rng = np.random.default_rng(11)
    nb = 64
    bb = _BLOCK_BYTES[name]
    raw = rng.integers(0, 256, size=nb * bb, dtype=np.uint8)
    blocks = raw.reshape(nb, bb)
    # Sane f16 scales (random bytes can encode inf/nan halves).
    half = np.array([0.25], np.float16).view(np.uint8)
    if name in ("Q8_0", "Q4_0", "Q4_K"):
        blocks[:, 0:2] = half
    if name == "Q4_K":
        blocks[:, 2:4] = half
    if name == "Q6_K":
        blocks[:, 208:210] = half
    shape = (nb * _ELEMS[name],)
    want = JG.dequantize(raw, gtype, shape)
    got = TG.dequantize(raw, gtype, shape)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want, equal_nan=True)
    assert TG.tensor_nbytes(gtype, shape[0]) == JG.tensor_nbytes(
        gtype, shape[0])


@pytest.mark.parametrize("name", ["Q8_0", "Q4_0", "Q4_K", "Q6_K"])
def test_quantizers_bit_equal(name):
    w = np.random.default_rng(7).normal(0, 1.0, 2048).astype(np.float32)
    fn = {"Q8_0": "_quantize_q8_0", "Q4_0": "_quantize_q4_0",
          "Q4_K": "_quantize_q4_k", "Q6_K": "_quantize_q6_k"}[name]
    assert np.array_equal(getattr(TG, fn)(w), getattr(JG, fn)(w))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_config_and_params_from_gguf_equal(tmp_path, arch):
    cfg, tree = _model(arch)
    path = tmp_path / f"{arch}.gguf"
    JG.export_decoder_to_gguf(path, tree, cfg, arch=arch,
                              quant_type=JG.GGML_Q8_0)
    md = JG.read_gguf_header(path)[0]
    jc, tc = JG.config_from_gguf(md), TG.config_from_gguf(md)
    fields = [f.name for f in dataclasses.fields(jc)
              if f.name != "compute_dtype"]
    assert [getattr(jc, f) for f in fields] == [getattr(tc, f)
                                                for f in fields]
    jc, jtree = JG.load_params_from_gguf(path, host=True)
    tc, ttree = TG.load_params_from_gguf(path, host=True)
    assert [getattr(jc, f) for f in fields] == [getattr(tc, f)
                                                for f in fields]
    assert isinstance(tc, T.DecoderConfig)
    for k in ("tok_emb", "final_norm", "lm_head"):
        assert np.array_equal(jtree[k], ttree[k])
    assert set(jtree["layers"]) == set(ttree["layers"])
    for k, v in jtree["layers"].items():
        assert np.array_equal(v, ttree["layers"][k]), k
    # Without host=True the tree is placed on the device asked for.
    _, placed = TG.load_params_from_gguf(path, device="cpu")
    want = T.params_from_numpy(ttree, tc, "cpu")
    assert torch.equal(placed["layers"]["q_w"], want["layers"]["q_w"])
    assert torch.equal(placed["tok_emb"], want["tok_emb"])


def test_lazy_tensors_equal(tmp_path):
    cfg, tree = _model()
    path = tmp_path / "lazy.gguf"
    JG.export_decoder_to_gguf(path, tree, cfg, quant_type=JG.GGML_Q4_0)
    jl, tl = JG.LazyGGUFTensors(path), TG.LazyGGUFTensors(path)
    assert set(jl) == set(tl) and len(jl) == len(tl)
    assert jl.f32_nbytes() == tl.f32_nbytes()
    for name in jl:
        assert np.array_equal(jl[name], tl[name]), name


def _bpe_metadata(**extra):
    tokens = ["<unk>", "<s>", "</s>", "Ġ", "h", "e", "l", "o", "w", "r", "d",
              "he", "ll", "llo", "hello", "Ġhello", "wo", "rl", "rld",
              "world", "Ġworld", "m", "y", "_", "v", "a", "f", "b", "(",
              ")", "1", "=", "."]
    merges = ["h e", "l l", "ll o", "he llo", "Ġ hello", "w o", "r l",
              "rl d", "wo rld", "Ġ world"]
    return {
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.merges": merges,
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
        **extra,
    }


def _unigram_metadata(**extra):
    tokens = _tiny_tokens(512)
    return {
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.scores": [0.0] * 3 + [-10.0] * 256 + [-1.0] * 13
        + [-25.0] * (512 - 272),
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.ggml.unknown_token_id": 0,
        **extra,
    }


TEXTS = ["hello world", "hello Ω", "the question and the answer",
         "ciao  world\nhello", "my_var", "foo_bar(1)", "a = b_1.f", "",
         "context hello-world!"]


@pytest.mark.parametrize("meta", [
    _unigram_metadata(), _unigram_metadata(**{
        "tokenizer.ggml.add_bos_token": False}),
    _bpe_metadata(), _bpe_metadata(**{"tokenizer.ggml.add_bos_token": True}),
], ids=["unigram", "unigram-nobos", "bpe", "bpe-bos"])
def test_tokenizer_ids_and_text_equal(meta):
    jt = JG.GGUFTokenizer(dict(meta), max_length=64)
    tt = TG.GGUFTokenizer(dict(meta), max_length=64)
    assert (jt.bos_id, jt.eos_id) == (tt.bos_id, tt.eos_id)
    for text in TEXTS:
        ids = tt.encode_raw(text)
        assert ids == jt.encode_raw(text), text
        assert tt.encode(text) == jt.encode(text)
        assert tt.decode(ids) == jt.decode(ids)
        assert tt.encode_raw(text, max_length=3) == jt.encode_raw(
            text, max_length=3)
