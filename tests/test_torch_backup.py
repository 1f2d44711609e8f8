"""The port's backup verbs (classmate_rag_tpu_torch/admin/backup.py)
against the JAX package's, on the CPU.

Both runtimes ingest the same files (test_torch_pipeline.make_runtimes,
EMBEDDING_BACKEND=hash, whose vectors are bit-equal between the
packages), so:

- ``dump_index`` writes the SAME BYTES as the JAX package's dump
  (``embedding_sha1`` included);
- ``restore_dump`` into empty directories gives equal ids, rows, vectors
  and BM25 state (vocabulary, term ids, tfs, lengths, df);
- ``vacuum_indexes`` after a delete reclaims the same rows, and each
  package loads the other's compacted directory;
- ``rebuild_embeddings`` onto an E5 ``small_test`` model name (random
  init from the name, bit-equal in both packages) gives vectors within
  the f16 store's tolerance of the JAX rebuild and the same ask ids; onto
  a checkpoint written by the port's ``train_encoder.main``, the
  embedder's name carries ``@ckpt-`` and the embedding cache is missed.
"""

import dataclasses
import json

import numpy as np
import pytest

from test_torch_pipeline import (
    QUESTIONS,
    _env,
    _ingest_all,
    _same_result,
    make_runtimes,
)

VEC_TOL = 2e-3      # f16 rows of the two packages' f32 E5 vectors


@pytest.fixture(autouse=True)
def _fresh_configs():
    yield
    from classmate_rag_tpu.config import load_config as jload
    from classmate_rag_tpu.pipeline.runtime import reset_runtime as jr
    from classmate_rag_tpu_torch.config import load_config as tload
    from classmate_rag_tpu_torch.pipeline.runtime import reset_runtime as tr

    jload(reload=True)
    tload(reload=True)
    jr()
    tr()


@pytest.fixture()
def runtimes(monkeypatch, tmp_path):
    jrt, trt, docs = make_runtimes(monkeypatch, tmp_path)
    _ingest_all(jrt, trt, docs)
    return jrt, trt, docs


def _fresh(monkeypatch, root):
    """(JAX runtime, port runtime) on empty directories under ``root``."""
    from classmate_rag_tpu.pipeline.runtime import get_runtime as j_get
    from classmate_rag_tpu_torch.pipeline.runtime import get_runtime as t_get

    _env(monkeypatch, root / "j")
    jrt = j_get(reload=True)
    _env(monkeypatch, root / "t")
    return jrt, t_get(reload=True, device="cpu")


def _store_state(store):
    rows = [store.id_to_row[i] for i in sorted(store.id_to_row)]
    return {
        "ids": sorted(store.id_to_row),
        "n_rows": store.n_rows,
        "emb": store.emb[rows],
        "term_ids": store.term_ids[rows],
        "tfs": store.tfs[rows],
        "doc_len": store.doc_len[rows],
        "vocab": store.vocab,
        "valid": store.valid[: store.n_rows],
    }


def _same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_dump_is_byte_equal(runtimes, tmp_path):
    from classmate_rag_tpu.admin import backup as jb
    from classmate_rag_tpu_torch.admin import dump_index

    jrt, trt, _ = runtimes
    for checksum in (True, False):
        j_out, t_out = tmp_path / "j.jsonl", tmp_path / "t" / "t.jsonl"
        n_j = jb.dump_index(j_out, include_embedding_checksum=checksum,
                            batch_size=3, runtime=jrt)
        n_t = dump_index(t_out, include_embedding_checksum=checksum,
                         batch_size=3, runtime=trt)
        assert n_t == n_j == len(trt.catalog) > 6
        assert t_out.read_bytes() == j_out.read_bytes()
    recs = [json.loads(x) for x in t_out.read_text().splitlines()]
    assert recs[0]["embedding_sha1"] is None and recs[0]["text_sha1"]


def test_restore_into_empty_directories(runtimes, monkeypatch, tmp_path):
    from classmate_rag_tpu.admin import backup as jb
    from classmate_rag_tpu.pipeline.stats import index_stats as jstats
    from classmate_rag_tpu_torch.admin import dump_index, restore_dump
    from classmate_rag_tpu_torch.pipeline.stats import index_stats as tstats

    jrt, trt, _ = runtimes
    dump = tmp_path / "dump.jsonl"
    n = dump_index(dump, runtime=trt)
    with dump.open("a") as f:                  # lines a restore skips
        f.write("\nnot json\n" + json.dumps({"id": "", "text": "x"}) + "\n")
    with pytest.raises(FileNotFoundError):
        restore_dump(tmp_path / "missing.jsonl", runtime=trt)

    j2, t2 = _fresh(monkeypatch, tmp_path / "restored")
    assert restore_dump(dump, batch_size=4, runtime=t2) == n
    assert jb.restore_dump(dump, batch_size=4, runtime=j2) == n
    _same_state(_store_state(t2.store), _store_state(j2.store))
    assert np.array_equal(t2.store._df_host, j2.store._df_host)

    def view(s):
        return {k: s[k] for k in ("vectors", "bm25", "tombstones",
                                  "vocab_terms")}

    assert view(tstats(t2)) == view(jstats(j2)) == view(tstats(trt))
    for q in QUESTIONS:
        got = t2.retriever.retrieve(question=q, top_k=4)
        want = j2.retriever.retrieve(question=q, top_k=4)
        orig = trt.retriever.retrieve(question=q, top_k=4)
        assert [r["id"] for r in got] == [r["id"] for r in want] == [
            r["id"] for r in orig]
        for x, y in zip(got, want):
            assert x["scores"]["bm25_score"] == pytest.approx(
                y["scores"]["bm25_score"], rel=1e-5, abs=1e-5, nan_ok=True)
    # Persisted: a dump of the restored index holds the same texts.
    redump = tmp_path / "redump.jsonl"
    dump_index(redump, runtime=t2)
    sha = {r["id"]: r["text_sha1"] for r in map(
        json.loads, dump.read_text().splitlines()[:n])}
    assert sha == {r["id"]: r["text_sha1"] for r in map(
        json.loads, redump.read_text().splitlines())}


def test_vacuum_after_delete_loads_in_the_other(runtimes, monkeypatch,
                                                tmp_path):
    from classmate_rag_tpu.admin import backup as jb
    from classmate_rag_tpu.admin import manage as jm
    from classmate_rag_tpu.pipeline.runtime import get_runtime as j_get
    from classmate_rag_tpu_torch.admin import manage as tm
    from classmate_rag_tpu_torch.admin import vacuum_indexes
    from classmate_rag_tpu_torch.pipeline.runtime import get_runtime as t_get

    jrt, trt, docs = runtimes
    ids = tm.resolve_ids(path=str(docs / "calc.md"), runtime=trt)
    assert ids == jm.resolve_ids(path=str(docs / "calc.md"), runtime=jrt)
    tm.delete_by_ids(ids, runtime=trt)
    jm.delete_by_ids(ids, runtime=jrt)
    got, want = vacuum_indexes(trt), jb.vacuum_indexes(jrt)
    assert got == want and f"({len(ids)} tombstoned" in got["dense"]
    assert trt.store.n_rows == jrt.store.n_rows == len(trt.store)
    # Each package cold-starts on the other's compacted directory.
    _env(monkeypatch, tmp_path / "t")
    from_port = j_get(reload=True)
    _env(monkeypatch, tmp_path / "j")
    from_jax = t_get(reload=True, device="cpu")
    _same_state(_store_state(from_port.store), _store_state(trt.store))
    _same_state(_store_state(from_jax.store), _store_state(jrt.store))
    for q in QUESTIONS:
        a = from_port.retriever.retrieve(question=q, top_k=4)
        b = from_jax.retriever.retrieve(question=q, top_k=4)
        assert [r["id"] for r in a] == [r["id"] for r in b]
        assert not {r["id"] for r in b} & set(ids)


def _small_e5(monkeypatch):
    """E5 model names build the small test encoder in both packages."""
    from classmate_rag_tpu.embeddings import model as jm
    from classmate_rag_tpu_torch.embeddings import model as tm

    for m in (jm, tm):
        monkeypatch.setattr(
            m.EncoderConfig, "for_model_name",
            classmethod(lambda cls, name: cls.small_test()))


def test_rebuild_onto_model_name(runtimes, monkeypatch):
    from classmate_rag_tpu.admin import backup as jb
    from classmate_rag_tpu.metadata import normalize_cli_metadata as jmeta
    from classmate_rag_tpu.pipeline.ask import ask_question as jask
    from classmate_rag_tpu_torch.admin import rebuild_embeddings
    from classmate_rag_tpu_torch.metadata import normalize_cli_metadata
    from classmate_rag_tpu_torch.pipeline.ask import ask_question

    _small_e5(monkeypatch)
    jrt, trt, _ = runtimes
    for rt in (jrt, trt):
        rt.cfg = dataclasses.replace(rt.cfg, embedding_backend="e5")
    old_store = trt.store
    got = rebuild_embeddings("test-rebuild-e5", batch_size=5, runtime=trt)
    want = jb.rebuild_embeddings("test-rebuild-e5", batch_size=5,
                                 runtime=jrt)
    assert got == want == {"updated": len(trt.catalog),
                           "model": "test-rebuild-e5"}
    assert trt.store is not old_store and trt.retriever.store is trt.store
    assert trt.store.device.type == "cpu" and trt.store.dim == 64
    assert trt.embedder.model_name == jrt.embedder.model_name
    assert trt.store.embedding_model == jrt.store.embedding_model == (
        "test-rebuild-e5-randominit")
    a, b = _store_state(trt.store), _store_state(jrt.store)
    np.testing.assert_allclose(a.pop("emb").astype(np.float32),
                               b.pop("emb").astype(np.float32),
                               atol=VEC_TOL)
    _same_state(a, b)
    for q in QUESTIONS:
        _same_result(jask(question=q, filters=jmeta(), runtime=jrt),
                     ask_question(question=q,
                                  filters=normalize_cli_metadata(),
                                  runtime=trt))


def test_rebuild_onto_port_checkpoint(runtimes, monkeypatch, tmp_path,
                                      capsys):
    from classmate_rag_tpu_torch.admin import rebuild_embeddings
    from classmate_rag_tpu_torch.admin.backup import _looks_like_checkpoint
    from classmate_rag_tpu_torch.config import embedding_config_of
    from classmate_rag_tpu_torch.embeddings import get_embedder
    from classmate_rag_tpu_torch.embeddings.encoder import E5Encoder
    from classmate_rag_tpu_torch.index.catalog import Catalog, CatalogEntry
    from classmate_rag_tpu_torch.index.lexical import tokenize_py
    from classmate_rag_tpu_torch.training import train_encoder

    _jrt, trt, _ = runtimes
    texts = [e.text for e in trt.catalog.entries()]
    cat = Catalog.load_or_create(tmp_path / "train" / "bm25")
    for i, text in enumerate(texts * 4):
        cat.upsert(CatalogEntry(f"tr{i}", text, tokenize_py(text, "en"), {}))
    cat.save()
    ckpt = tmp_path / "ckpt"
    assert train_encoder.main(
        ["--config", "small_test", "--steps", "2", "--batch", "4",
         "--seq-len", "32", "--warmup-steps", "1", "--eval-batches", "0",
         "--indexes", str(tmp_path / "train"), "--checkpoint-dir",
         str(ckpt)], device="cpu") == 0
    capsys.readouterr()
    assert _looks_like_checkpoint(str(ckpt))
    assert _looks_like_checkpoint(str(ckpt / "step_2"))
    assert not _looks_like_checkpoint(str(tmp_path / "train"))

    encoded = []
    real = E5Encoder.encode_passages

    def spy(self, batch):
        encoded.extend(batch)
        return real(self, batch)

    monkeypatch.setattr(E5Encoder, "encode_passages", spy)
    trt.cfg = dataclasses.replace(trt.cfg, embedding_backend="e5")
    out = rebuild_embeddings(str(ckpt), runtime=trt)
    assert out == {"updated": len(texts), "model": str(ckpt)}
    assert "@ckpt-step_2-" in trt.embedder.model_name
    assert trt.store.embedding_model == trt.embedder.model_name
    # A cache miss for every chunk: the checkpoint's vectors are encoded,
    # not read back under another model's name.
    assert sorted(encoded) == sorted(texts)
    direct = get_embedder(embedding_config_of(trt.cfg),
                          checkpoint=str(ckpt), device="cpu")
    want = direct.encode_passages(texts)
    ids = [e.id for e in trt.catalog.entries()]
    rows = [trt.store.id_to_row[i] for i in ids]
    np.testing.assert_allclose(trt.store.emb[rows].astype(np.float32), want,
                               atol=VEC_TOL)
