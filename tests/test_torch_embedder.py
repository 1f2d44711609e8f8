"""The port's embedding host code (classmate_rag_tpu_torch/embeddings:
tokenizer, cache, backend factory, config knobs) vs the JAX package's.

Tolerance: none — ids, paths, backend choices and cached vectors must be
equal.
"""

import numpy as np
import pytest

import classmate_rag_tpu.config as jconfig
import classmate_rag_tpu.embeddings as jemb
import classmate_rag_tpu.embeddings.encoder as jencoder
from classmate_rag_tpu.embeddings import tokenizer as jtok
from classmate_rag_tpu.embeddings.cache import CachingEmbedder as JCache
from classmate_rag_tpu.embeddings.hashing import HashingEmbedder as JHash
import classmate_rag_tpu_torch.embeddings as temb
from classmate_rag_tpu_torch.config import (
    EMBEDDING_ENV_NAMES,
    load_embedding_config,
)
from classmate_rag_tpu_torch.embeddings import tokenizer as ttok
from classmate_rag_tpu_torch.embeddings.cache import CachingEmbedder
from classmate_rag_tpu_torch.embeddings.encoder import E5Encoder
from classmate_rag_tpu_torch.embeddings.hashing import HashingEmbedder
from classmate_rag_tpu_torch.embeddings.model import EncoderConfig


def _texts(n=300, seed=0):
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefghijklmnopqrstuvwxyzàèéìòù0123456789_") + [
        " ", " ", " ", ",", ".", "!", "'", "-", "\n", "é", "ß", "中", "文"]
    out = ["", "   ", "Hello, world! Ciao mondo.", "word " * 700]
    for _ in range(n):
        size = int(rng.integers(1, 400))
        out.append("".join(rng.choice(alphabet, size=size)))
    return out


@pytest.mark.parametrize("max_length", [None, 64, 512])
def test_hash_tokenizer_ids_equal(max_length):
    j, t = jtok.HashTokenizer(), ttok.HashTokenizer()
    texts = _texts()
    assert t.encode_batch(texts, max_length) == j.encode_batch(
        texts, max_length)
    small_j = jtok.HashTokenizer(vocab_size=1024, max_length=128)
    small_t = ttok.HashTokenizer(vocab_size=1024, max_length=128)
    assert small_t.encode_batch(texts) == small_j.encode_batch(texts)
    ids = t.encode("some words here")
    assert t.decode(ids) == j.decode(ids)


def test_buckets_and_padding_equal():
    assert ttok.LENGTH_BUCKETS == jtok.LENGTH_BUCKETS
    for n in range(0, 700):
        assert ttok.bucket_length(n) == jtok.bucket_length(n)
    tok = ttok.HashTokenizer()
    rows = tok.encode_batch(_texts(60, seed=1), 512)
    for bucket in (32, 128, 512):
        got = ttok.pad_to_bucket(rows, bucket)
        want = jtok.pad_to_bucket(rows, bucket)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_hf_tokenizer_equal(tmp_path):
    tokenizers = pytest.importorskip("tokenizers")
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "hello": 4,
             "world": 5, "ciao": 6, ",": 7}
    tk = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, "<unk>"))
    tk.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tk.save(str(tmp_path / "tokenizer.json"))
    j = jtok.load_tokenizer(str(tmp_path), max_length=4)
    t = ttok.load_tokenizer(str(tmp_path), max_length=4)
    assert type(t).__name__ == type(j).__name__ == "HFTokenizer"
    texts = ["hello world", "ciao , hello world world", "", "nope"]
    assert t.encode_batch(texts) == j.encode_batch(texts)
    assert [t.encode(x) for x in texts] == [j.encode(x) for x in texts]
    assert t.encode_raw("hello ciao", 1) == j.encode_raw("hello ciao", 1)
    assert t.decode([0, 4, 5, 2]) == j.decode([0, 4, 5, 2])
    # No tokenizer.json: the hash fallback in both.
    assert isinstance(ttok.load_tokenizer(str(tmp_path / "x")),
                      ttok.HashTokenizer)


def _tiny_encoder():
    return E5Encoder(model_name="test-tiny",
                     config=EncoderConfig.small_test(), device="cpu")


def test_cache_layout_shared_with_jax(tmp_path):
    """A cache written by the JAX package's CachingEmbedder is read by
    the port's, file for file, without calling the base encoder."""
    texts = ["alpha beta", "gamma delta", "  alpha beta  "]
    jc = JCache(JHash(dim=64), cache_dir=str(tmp_path))
    want = jc.encode_passages(texts)
    base = HashingEmbedder(dim=64)
    calls = []
    base.encode_passages = lambda ts: calls.append(ts) or np.zeros((0, 64))
    tc = CachingEmbedder(base, cache_dir=str(tmp_path))
    assert tc.model_dir == jc.model_dir
    got = tc.encode_passages(texts)
    assert calls == [] and np.array_equal(got, want)
    assert tc._path_for("query", "x") == jc._path_for("query", "x")


def test_cache_partial_hits_and_corruption(tmp_path):
    base = HashingEmbedder(dim=32)
    seen = []
    orig = base.encode_queries
    base.encode_queries = lambda ts: seen.append(list(ts)) or orig(ts)
    c = CachingEmbedder(base, cache_dir=str(tmp_path))
    v1 = c.encode_queries(["one", "two"])
    v2 = c.encode_queries(["one", "three", "two"])
    assert seen == [["one", "two"], ["three"]]
    np.testing.assert_array_equal(v2[[0, 2]], v1)
    files = sorted(tmp_path.rglob("*.npy"))
    files[0].write_bytes(b"garbage")
    np.testing.assert_array_equal(c.encode_queries(["one", "two"]), v1)
    assert c.encode_queries([]).shape == (0, 32)


def test_cache_key_marks_random_init(tmp_path):
    enc = _tiny_encoder()
    c = CachingEmbedder(enc, cache_dir=str(tmp_path))
    assert c.model_name == "test-tiny-randominit"
    enc.has_pretrained_weights = True
    assert CachingEmbedder(enc, cache_dir=str(tmp_path)).model_name \
        == "test-tiny"


def test_cache_device_path_gated_and_honors_reads(tmp_path):
    enc = _tiny_encoder()
    cached = CachingEmbedder(enc, cache_dir=str(tmp_path / "a"))
    assert getattr(cached, "encode_queries_device", None) is not None
    assert getattr(CachingEmbedder(HashingEmbedder(),
                                   cache_dir=str(tmp_path / "b")),
                   "encode_queries_device", None) is None

    dev = cached.encode_queries_device(["hello", "a longer question " * 9])
    assert dev.shape == (2, enc.dim)
    assert not list((tmp_path / "a").rglob("*.npy"))   # no writes on miss
    warm = cached.encode_queries(["hello", "gamma"])     # fills the cache
    calls = []
    orig = enc.encode_queries_device
    enc.encode_queries_device = lambda ts: calls.append(ts) or orig(ts)
    hit = cached.encode_queries_device(["hello", "gamma"])
    assert calls == [] and isinstance(hit, np.ndarray)
    np.testing.assert_array_equal(hit, warm)
    cached.encode_queries_device(["hello", "NEW question"])
    assert len(calls) == 1
    np.testing.assert_array_equal(dev[0].numpy(), warm[0])


@pytest.fixture()
def env(monkeypatch, tmp_path):
    monkeypatch.setattr(jconfig, "_SINGLETON", jconfig._SINGLETON)
    monkeypatch.chdir(tmp_path)            # no .env, no ./models
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    for var in EMBEDDING_ENV_NAMES.values():
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("values", [
    {},
    {"EMBEDDING_MODEL_NAME": "intfloat/multilingual-e5-large",
     "EMBEDDING_BACKEND": "e5", "EMBEDDING_MODEL_DIR": "/nowhere",
     "EMB_CACHE_DIR": "/tmp/cache", "ENCODE_DATA_PARALLEL": "1",
     "ENCODER_CHECKPOINT": "/ckpt"},
    {"ENCODE_DATA_PARALLEL": "oops", "EMBEDDING_BACKEND": ""},
])
def test_embedding_config_matches(env, values):
    for var, val in values.items():
        env.setenv(var, val)
    want = jconfig.load_config(reload=True)
    got = load_embedding_config()
    for name in EMBEDDING_ENV_NAMES:
        assert getattr(got, name) == getattr(want, name), name


class _Stub:
    """Records how a factory built its E5 encoder."""

    def __init__(self, **kw):
        self.kw = kw


def _choice(emb):
    if isinstance(emb, _Stub):
        return ("e5", emb.kw["model_name"], emb.kw["model_dir"])
    return ("hash", emb.model_name, emb.dim)


@pytest.mark.parametrize("backend,with_weights", [
    ("auto", False), ("auto", True), ("hash", True), ("e5", False),
    ("e5", True), ("E5", False),
])
def test_get_embedder_backend_choice(env, tmp_path, backend, with_weights):
    snap = tmp_path / "snap"
    snap.mkdir()
    (snap / "tokenizer.json").write_text("{}")
    if with_weights:
        (snap / "pytorch_model.bin").write_bytes(b"")
    env.setenv("EMBEDDING_BACKEND", backend)
    env.setenv("EMBEDDING_MODEL_DIR", str(snap))
    env.setattr(jencoder, "E5Encoder", lambda **kw: _Stub(**kw))
    env.setattr(temb, "E5Encoder", lambda **kw: _Stub(**kw))
    want = _choice(jemb.get_embedder(jconfig.load_config(reload=True)))
    got = _choice(temb.get_embedder(load_embedding_config()))
    assert got == want
    cached = temb.get_caching_embedder(load_embedding_config())
    assert isinstance(cached, CachingEmbedder)


def test_get_embedder_checkpoint_not_ported(env):
    env.setenv("ENCODER_CHECKPOINT", "/some/ckpt")
    with pytest.raises(NotImplementedError, match="Training"):
        temb.get_embedder(load_embedding_config())
    env.setenv("EMBEDDING_BACKEND", "hash")
    assert isinstance(temb.get_embedder(load_embedding_config()),
                      HashingEmbedder)
