"""The port's native tokenizer and batch packer (classmate_rag_tpu_torch/
native/, its own copy of the C++) against its Python path and the JAX
package's ``tokenize_py`` / ``pack_tokens`` on seeded fuzz text: equal
token lists, equal arrays, equal vocabularies. Also the tf clamp and
overflow, separator tokens falling back, a store built native and one
built in Python giving identical arrays, the ``tokenize`` dispatch, the
hash-named build, and builds racing in several processes.

The library builds with g++ at first use; where g++ is missing these
tests skip (the Python path then runs, as the reference's does). No
wall-clock assertion: timing belongs to chip_smoke.py.
"""

import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from classmate_rag_tpu.index.lexical import pack_tokens as j_pack
from classmate_rag_tpu.index.lexical import tokenize_py as j_tokenize_py
from classmate_rag_tpu_torch import native as native_mod
from classmate_rag_tpu_torch.index import lexical as tlex
from classmate_rag_tpu_torch.index.lexical import pack_tokens, tokenize_py

REPO = Path(__file__).resolve().parent.parent

ALPHABET = (
    "abcdefghijklmnopqrstuvwxyz ABCDEFGHIJKLMNOPQRSTUVWXYZ "
    "àèéìòùÀÈÉÌÒÙ çÇ ñÑ 0123456789 .,;:!?()[]{}<>-_'\"\n\t"
    "的中文字 Ωωλ πρ €£¥ 🙂 ÿÖØö×÷"
)


@pytest.fixture(scope="module")
def native():
    tok = native_mod.get_native_tokenizer()
    if tok is None:
        pytest.skip("native library not buildable here (no g++)")
    return tok


@pytest.fixture()
def packer():
    p = native_mod.make_native_packer()
    if p is None:
        pytest.skip("native library not buildable here (no g++)")
    return p


def test_basic_parity(native):
    text = "The quick brown Fox! Perché l'università è così BELLA, no? x y"
    for lang in ("en", "it", None, "IT-it"):
        want = j_tokenize_py(text, lang)
        assert native.tokenize(text, lang) == want
        assert tokenize_py(text, lang) == want


def test_accents_and_case(native):
    text = "ÀÈÌÒÙ àèìòù Ångström naïve façade coöperate ÑOÑO"
    assert native.tokenize(text, "en") == j_tokenize_py(text, "en")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_parity(native, seed):
    rng = random.Random(seed)
    for trial in range(150):
        n = rng.randint(0, 400)
        text = "".join(rng.choice(ALPHABET) for _ in range(n))
        lang = rng.choice(["en", "it", None])
        want = j_tokenize_py(text, lang)
        assert native.tokenize(text, lang) == want, (trial, text)
        assert tlex.tokenize(text, lang) == want


def test_long_text_grows_buffer(native):
    text = "supercalifragilistic word " * 20000
    out = native.tokenize(text, "en")
    assert out == j_tokenize_py(text, "en")
    assert len(out) == 40000


def test_tokenize_dispatches_to_native(native, monkeypatch):
    calls = []
    real = native.tokenize
    monkeypatch.setattr(native, "tokenize",
                        lambda *a: calls.append(a) or real(*a))
    assert tlex.tokenize("Derivatives measure change", "en") == [
        "derivatives", "measure", "change"]
    assert calls == [("Derivatives measure change", "en")]


def test_tokenize_falls_back_to_python(monkeypatch):
    monkeypatch.setattr(native_mod, "get_native_tokenizer", lambda: None)
    text = "Perché l'università è così bella"
    assert tlex.tokenize(text, "it") == j_tokenize_py(text, "it")


def _pack_py(docs, vocab, width, pack=pack_tokens):
    b = len(docs)
    ids = np.empty((b, width), np.int32)
    tfs = np.empty((b, width), np.uint8)
    dl = np.empty(b, np.float32)
    for i, d in enumerate(docs):
        ids[i], tfs[i], dl[i] = pack(d, vocab, width)
    return ids, tfs, dl


@pytest.mark.parametrize("seed", [7, 8])
def test_packer_fuzz_parity(packer, seed):
    """Native batch packing equals the port's pack_tokens and the JAX
    package's: ids (interning order), tfs, doc_len and the vocab."""
    rng = np.random.default_rng(seed)
    vocab_native, vocab_py, vocab_jax = {}, {}, {}
    words = [f"w{i}" for i in range(150)] + ["café", "perché", "übel"]
    for trial in range(100):
        b = int(rng.integers(1, 7))
        docs = [[words[i] for i in rng.integers(0, len(words),
                                                int(rng.integers(0, 40)))]
                for _ in range(b)]
        width = int(rng.integers(4, 20))
        want = _pack_py(docs, vocab_jax, width, pack=j_pack)
        py = _pack_py(docs, vocab_py, width)
        out = packer.pack_batch(docs, vocab_native, width)
        assert out is not None
        for got_n, got_p, w in zip(out, py, want):
            np.testing.assert_array_equal(got_n, w, err_msg=str(trial))
            np.testing.assert_array_equal(got_p, w)
        assert vocab_native == vocab_py == vocab_jax


def test_packer_tf_clamp_and_overflow(packer):
    docs = [["x"] * 300 + ["y"], [f"t{i}" for i in range(30)] * 2]
    vocab_n, vocab_p = {}, {}
    want = _pack_py(docs, vocab_p, 8, pack=j_pack)
    got = packer.pack_batch(docs, vocab_n, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1][0, 0] == 255        # clamped
    assert got[2][0] == 301.0         # doc_len counts every token
    assert vocab_n == vocab_p


@pytest.mark.parametrize("tokens", [["a b"], ["a\nb"], ["a", ""], [" a"]])
def test_packer_separator_tokens_fall_back(packer, tokens):
    assert packer.pack_batch([tokens], {}, 4) is None


def test_import_vocab_seeds_a_fresh_packer(packer):
    vocab = {"alpha": 0, "beta": 1, "gamma": 2}
    assert packer.import_vocab(vocab)
    assert packer.vocab_size() == 3
    assert not packer.import_vocab(vocab)    # only a fresh packer
    ids, _tfs, _dl = packer.pack_batch([["beta", "delta"]], vocab, 4)
    assert ids[0].tolist() == [1, 3, -1, -1]
    assert vocab["delta"] == 3


def _stores(tmp_path, use_native):
    from classmate_rag_tpu_torch.index.store import IndexStore

    rng = np.random.default_rng(3)
    docs = [[f"w{i}" for i in rng.integers(0, 50, rng.integers(1, 20))]
            for _ in range(40)]
    embs = rng.standard_normal((40, 8)).astype(np.float32)
    st = IndexStore(8, tmp_path / f"s{int(use_native)}", slab_rows=16,
                    terms_per_chunk=12, device="cpu")
    if not use_native:
        st._packer_ok = False
    st.upsert([f"d{i}" for i in range(20)], embs[:20], docs[:20],
              [{}] * 20)
    st.upsert([f"d{i}" for i in range(20, 40)], embs[20:], docs[20:],
              [{}] * 20)
    return st


def test_store_native_python_same_index(tmp_path, packer):
    a, b = _stores(tmp_path, True), _stores(tmp_path, False)
    assert a.packs_natively and not b.packs_natively
    assert a.vocab == b.vocab
    for name in ("term_ids", "tfs", "doc_len"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_store_packs_natively_after_a_restore(tmp_path, packer):
    """A store over restored host state seeds the native interner from
    its vocab and packs the next rows as the Python path does."""
    from classmate_rag_tpu_torch.index.store import IndexStore

    src = _stores(tmp_path, True)
    new = [["w1", "fresh", "w2", "w1"], ["another", "w3"]]
    emb = np.ones((2, 8), np.float32)
    out = []
    for use_native in (True, False):
        st = IndexStore.from_host_state(src.host_state(), device="cpu",
                                        slab_rows=16)
        st._packer_ok = use_native
        st.upsert(["n0", "n1"], emb, new, [{}, {}])
        out.append(st)
    assert out[0].packs_natively
    assert out[0].vocab == out[1].vocab
    np.testing.assert_array_equal(out[0].term_ids, out[1].term_ids)
    np.testing.assert_array_equal(out[0].tfs, out[1].tfs)


def test_vocab_grown_behind_the_packer_packs_in_python(tmp_path, packer):
    """When the vocab grows past the packer's interner (a delta replay
    extends it), the next rows take the Python path, and
    ``packs_natively`` says so; the arrays equal an all-Python store's."""
    out = []
    for use_native in (True, False):
        st = _stores(tmp_path / f"n{int(use_native)}", use_native)
        st.vocab["grown"] = len(st.vocab)
        st.upsert(["g0"], np.ones((1, 8), np.float32),
                  [["grown", "w1", "newer"]], [{}])
        out.append(st)
    assert not out[0].packs_natively
    assert out[0].vocab == out[1].vocab
    for name in ("term_ids", "tfs", "doc_len"):
        np.testing.assert_array_equal(getattr(out[0], name),
                                      getattr(out[1], name))


def test_separator_token_turns_the_store_to_python(tmp_path, packer):
    from classmate_rag_tpu_torch.index.store import IndexStore

    st = IndexStore(8, tmp_path / "sep", slab_rows=16, terms_per_chunk=4,
                    device="cpu")
    st.upsert(["a"], np.ones((1, 8), np.float32), [["x y", "z"]], [{}])
    assert not st.packs_natively
    assert st.vocab == {"x y": 0, "z": 1}


def test_library_name_hashes_the_source(native):
    path = native_mod.lib_path()
    assert path.exists()
    assert path.parent == native_mod.BUILD_DIR
    assert path.name.startswith("libclassmate_native-")
    # The port's copy of the C++ is byte-equal to the JAX package's.
    assert native_mod.CSRC.read_bytes() == (
        REPO / "native" / "classmate_native.cpp").read_bytes()


def test_concurrent_builds_never_load_a_partial_library(tmp_path, native):
    """Processes building the library at once (test workers) each load a
    complete one: every build writes a temporary file renamed into
    place."""
    build = tmp_path / "build"
    child = (
        "import sys; from pathlib import Path\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from classmate_rag_tpu_torch import native\n"
        f"native.BUILD_DIR = Path({str(build)!r})\n"
        "tok = native.get_native_tokenizer()\n"
        "assert tok is not None\n"
        "assert tok.tokenize('Derivatives measure change', 'en') == "
        "['derivatives', 'measure', 'change']\n"
        "print('OK')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", child], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(3)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "OK" in out, out
    assert [f.name for f in build.iterdir()] == [
        native_mod.lib_path().name]


def test_which_path_ran(tmp_path, monkeypatch, native):
    """An ingest through the runtime tokenizes and packs natively, and
    says so: ``native.available()`` and ``IndexStore.packs_natively``."""
    monkeypatch.setenv("INDEX_DIR", str(tmp_path))
    monkeypatch.setenv("DENSE_DIR", str(tmp_path / "d"))
    monkeypatch.setenv("BM25_DIR", str(tmp_path / "b"))
    monkeypatch.setenv("EMB_CACHE_DIR", str(tmp_path / "e"))
    monkeypatch.setenv("EMBEDDING_BACKEND", "hash")
    monkeypatch.setenv("LLM_BACKEND", "extractive")
    from classmate_rag_tpu_torch.metadata import normalize_cli_metadata
    from classmate_rag_tpu_torch.pipeline import get_runtime, ingest_file

    rt = get_runtime(reload=True, device="cpu")
    assert not rt.store.packs_natively          # nothing packed yet
    doc = tmp_path / "a.txt"
    doc.write_text("The derivative measures the rate of change.")
    ingest_file(path=doc, doc_meta=normalize_cli_metadata(), runtime=rt)
    assert native_mod.available() and rt.store.packs_natively
