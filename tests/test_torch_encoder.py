"""The port's E5 encoder (classmate_rag_tpu_torch/embeddings/model.py and
encoder.py) vs the JAX package's, on the CPU, on the same numpy inputs.

Tolerances:
- ``init_params``: bit-equal (same generator, same draws, same order);
- ``params_from_numpy``: the module's tree equals the input, with the
  matmul weights at their bf16 values (the reference casts them to bf16
  at every use, so that is all it ever computes with);
- ``embed_tokens``: within 1e-5 (f32 LayerNorm, other summation orders);
- ``encode`` and ``E5Encoder``: per-row cosine ≥ 0.9999 and max |Δ| ≤
  1e-3. Both sum bf16 products in f32 in different orders, and a sum
  that lands on a bf16 rounding boundary before the next matmul may round
  the other way; measured here, the two agree to ~1e-6.
- ``load_params_from_hf``: equal to the JAX loader's tree.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classmate_rag_tpu.embeddings import encoder as jenc
from classmate_rag_tpu.embeddings import model as jm
from classmate_rag_tpu_torch.embeddings import encoder as tenc
from classmate_rag_tpu_torch.embeddings import model as tm
from classmate_rag_tpu_torch.ops import attention as tatt
from classmate_rag_tpu_torch.ops import encoder_fused as tef

COS_MIN = 0.9999
ABS_MAX = 1e-3
NAME = "test-tiny"

TEXTS = [
    "short one",
    "a much longer passage about the rate of change of a function " * 5,
    "mid length text here, with punctuation!",
    "tiny",
    "La lezione di oggi riguarda le equazioni differenziali " * 12,
    "",
]


def _flat(tree):
    out = {k: np.asarray(v) for k, v in tree.items() if k != "layers"}
    out.update({f"layers.{k}": np.asarray(v)
                for k, v in tree["layers"].items()})
    return out


def _bf16(x):
    return torch.tensor(np.asarray(x)).to(torch.bfloat16).float().numpy()


def _tcfg(**kw):
    return dataclasses.replace(tm.EncoderConfig.small_test(), **kw)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jm.EncoderConfig.small_test()
    jp = jm.init_params(jcfg, NAME)
    tree = {k: (np.asarray(v) if k != "layers"
                else {kk: np.asarray(vv) for kk, vv in v.items()})
            for k, v in jp.items()}
    return jcfg, jp, tree


def _batch(cfg, t, b=6, seed=0):
    rng = np.random.default_rng(seed + t)
    ids = rng.integers(4, cfg.vocab_size, (b, t)).astype(np.int32)
    lengths = rng.integers(1, t + 1, b)
    lengths[0] = t
    lengths[1] = 1
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.int32)
    ids[:, 0] = 0
    return np.where(mask == 1, ids, 1).astype(np.int32), mask


@pytest.mark.parametrize("cfg", [
    "small_test",
    dict(vocab_size=300, hidden=128, layers=3, heads=2, intermediate=256,
         max_positions=70, type_vocab=2),
])
def test_init_params_bit_equal(cfg):
    if cfg == "small_test":
        tcfg, jcfg = tm.EncoderConfig.small_test(), jm.EncoderConfig.small_test()
    else:
        tcfg, jcfg = tm.EncoderConfig(**cfg), jm.EncoderConfig(**cfg)
    got = _flat(tm.init_params(tcfg, "intfloat/multilingual-e5-base"))
    want = _flat(jm.init_params(jcfg, "intfloat/multilingual-e5-base"))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == np.float32
        assert np.array_equal(got[key], want[key]), key


def test_config_fields_match():
    for name in ("base", "large", "small_test"):
        t = dataclasses.asdict(getattr(tm.EncoderConfig, name)())
        j = dataclasses.asdict(getattr(jm.EncoderConfig, name)())
        assert t.pop("compute_dtype") == torch.bfloat16
        assert j.pop("compute_dtype") == jnp.bfloat16
        assert t == j
    for model in ("intfloat/multilingual-e5-large", "e5-base", None):
        assert (dataclasses.asdict(tm.EncoderConfig.for_model_name(model))
                ["hidden"] == jm.EncoderConfig.for_model_name(model).hidden)


def test_params_from_numpy_round_trip(tiny):
    _jcfg, _jp, tree = tiny
    model = tm.params_from_numpy(tree, tm.EncoderConfig.small_test(), "cpu")
    got = _flat(model.params_numpy())
    want = _flat(tree)
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        expect = _bf16(val) if key.endswith("_w") else val
        assert np.array_equal(got[key], expect), key


def test_embed_tokens_matches(tiny):
    jcfg, jp, tree = tiny
    model = tm.params_from_numpy(tree, tm.EncoderConfig.small_test(), "cpu")
    ids, mask = _batch(jcfg, 64)
    want = np.asarray(jm.embed_tokens(jp, jnp.asarray(ids),
                                      jnp.asarray(mask), jcfg))
    got = model.embed_tokens(torch.from_numpy(ids),
                             torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [32, 128])
@pytest.mark.parametrize("flash_min_seq", [128, 1024])
@pytest.mark.parametrize("fused", [False, True])
def test_encode_matches_jax(tiny, t, flash_min_seq, fused):
    """Every gate of the port (flash at T = 128 with flash_min_seq 128,
    the fused epilogues) against the JAX forward; on the CPU each gated
    wrapper takes its plain version, and no kernel launches."""
    jcfg, jp, tree = tiny
    cfg = _tcfg(fused_epilogue=fused, flash_min_seq=flash_min_seq)
    model = tm.params_from_numpy(tree, cfg, "cpu")
    ids, mask = _batch(jcfg, t)
    want = np.asarray(jm.encode(jp, jnp.asarray(ids), jnp.asarray(mask),
                                jcfg))
    before = {**tef.LAUNCHES, **tatt.LAUNCHES}
    got = model.encode(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert {**tef.LAUNCHES, **tatt.LAUNCHES} == before
    assert got.shape == want.shape and got.dtype == np.float32
    assert (got * want).sum(axis=1).min() >= COS_MIN
    assert np.abs(got - want).max() <= ABS_MAX


def _save_weights(tensors, tmp_path, fmt):
    if fmt == "bin":
        torch.save(tensors, tmp_path / "pytorch_model.bin")
    else:
        safetensors_numpy = pytest.importorskip("safetensors.numpy")
        safetensors_numpy.save_file({k: v.numpy() for k, v in tensors.items()},
                                    str(tmp_path / "model.safetensors"))


@pytest.mark.parametrize("prefix,fmt", [
    ("", "bin"), ("roberta.", "bin"), ("0.auto_model.", "bin"),
    ("roberta.", "safetensors"),
])
def test_load_params_from_hf_matches_jax(tmp_path, prefix, fmt):
    cfg_kw = dict(vocab_size=50, hidden=32, layers=2, heads=2,
                  intermediate=64, max_positions=20)
    rng = np.random.default_rng(5)
    h, ff = cfg_kw["hidden"], cfg_kw["intermediate"]
    sd = {
        "embeddings.word_embeddings.weight": (cfg_kw["vocab_size"], h),
        "embeddings.position_embeddings.weight": (cfg_kw["max_positions"], h),
        "embeddings.token_type_embeddings.weight": (1, h),
        "embeddings.LayerNorm.weight": (h,),
        "embeddings.LayerNorm.bias": (h,),
    }
    for i in range(cfg_kw["layers"]):
        base = f"encoder.layer.{i}."
        for mod in ("attention.self.query", "attention.self.key",
                    "attention.self.value", "attention.output.dense"):
            sd[base + mod + ".weight"] = (h, h)
            sd[base + mod + ".bias"] = (h,)
        sd[base + "intermediate.dense.weight"] = (ff, h)
        sd[base + "intermediate.dense.bias"] = (ff,)
        sd[base + "output.dense.weight"] = (h, ff)
        sd[base + "output.dense.bias"] = (h,)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[base + ln + ".weight"] = (h,)
            sd[base + ln + ".bias"] = (h,)
    tensors = {prefix + k: torch.from_numpy(
        rng.normal(0, 1, shape).astype(np.float32)) for k, shape in sd.items()}
    _save_weights(tensors, tmp_path, fmt)

    got = tm.load_params_from_hf(str(tmp_path), tm.EncoderConfig(**cfg_kw))
    want = jm.load_params_from_hf(str(tmp_path), jm.EncoderConfig(**cfg_kw))
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key

    # A width mismatch or a missing tensor gives None in both packages.
    wide = tm.EncoderConfig(**{**cfg_kw, "hidden": 64})
    assert tm.load_params_from_hf(str(tmp_path), wide) is None
    del tensors[prefix + "encoder.layer.1.output.dense.bias"]
    _save_weights(tensors, tmp_path, fmt)
    assert tm.load_params_from_hf(str(tmp_path),
                                  tm.EncoderConfig(**cfg_kw)) is None
    assert jm.load_params_from_hf(str(tmp_path),
                                  jm.EncoderConfig(**cfg_kw)) is None
    assert tm.load_params_from_hf(str(tmp_path / "nowhere"),
                                  tm.EncoderConfig(**cfg_kw)) is None


@pytest.fixture(scope="module")
def encoders():
    j = jenc.E5Encoder(model_name=NAME, config=jm.EncoderConfig.small_test())
    t = tenc.E5Encoder(model_name=NAME, config=tm.EncoderConfig.small_test(),
                       device="cpu")
    return j, t


@pytest.mark.parametrize("mode", ["queries", "passages"])
def test_e5_encoder_matches_jax(encoders, mode):
    """Multi-bucket texts (32, 64 and 128 with the prefix) through both
    packages' bucketing and padding."""
    j, t = encoders
    want = getattr(j, f"encode_{mode}")(TEXTS)
    got = getattr(t, f"encode_{mode}")(TEXTS)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape == (len(TEXTS), t.dim)
    assert (got * want).sum(axis=1).min() >= COS_MIN
    assert np.abs(got - want).max() <= ABS_MAX
    assert t.last_flops > 0
    assert t.max_length == j.max_length == 128
    assert not t.has_pretrained_weights


def test_device_path_equals_host_path(encoders):
    _j, t = encoders
    dev = t.encode_queries_device(TEXTS)
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    assert np.array_equal(dev.numpy(), t.encode_queries(TEXTS))
    one = t.encode_queries_device(TEXTS[:1])          # one group, in order
    assert np.array_equal(one.numpy(), t.encode_queries(TEXTS[:1]))
    assert t.encode_queries_device([]).shape == (0, t.dim)
    assert t.encode_passages([]).shape == (0, t.dim)


def test_batch_invariance(encoders):
    """A text embeds the same alone or inside a larger batch."""
    _j, t = encoders
    alone = t.encode_passages(["the same text"])[0]
    batch = t.encode_passages(["other a", "the same text",
                               "other b longer text here"])
    np.testing.assert_allclose(alone, batch[1], atol=1e-6)
    # 70 texts of one bucket pad to 128 rows instead of 64.
    many = t.encode_passages([f"text number {i}" for i in range(70)])
    np.testing.assert_allclose(
        many[3], t.encode_passages(["text number 3"])[0], atol=1e-6)


@pytest.mark.parametrize("dp,cards,want", [
    (1, 4, 1), (0, 1, 1), (0, 4, 4), (0, 12, 8), (3, 4, 2), (2, 1, 1),
])
def test_data_parallel_clamp(monkeypatch, dp, cards, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert tenc.data_parallel_degree(dp, torch.device("cuda")) == want
    assert tenc.data_parallel_degree(dp, torch.device("cpu")) == 1


def test_more_than_one_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tenc, "resolve_device",
                        lambda _d: torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        tenc.E5Encoder(model_name=NAME, config=tm.EncoderConfig.small_test(),
                       data_parallel=0)


@pytest.mark.parametrize("b,t", [(8, 32), (32, 512), (512, 32)])
def test_encoder_flops_matches(b, t):
    for name in ("base", "large"):
        assert tm.encoder_flops(getattr(tm.EncoderConfig, name)(), b, t) \
            == jm.encoder_flops(getattr(jm.EncoderConfig, name)(), b, t)
