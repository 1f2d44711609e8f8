"""Cross-loading persisted indexes between the JAX package and the port.

One package saves (its catalog and its store, into one directory), the
other loads it with ``load_or_create``: a full save, then two delta saves
after upserts and deletes, then a compact and a full save; the v2
snapshot with a persisted split layout; and the torn-save guards. After
every load the loader's host arrays must be BIT-EQUAL to the saver's live
store (and to what the saver's own package loads), and a hybrid batch on
the loaded store must give the saver's rows, scores within atol/rtol
1e-5.
"""

import os

import numpy as np
import pytest

import jax

from classmate_rag_tpu.index.catalog import Catalog as JCatalog
from classmate_rag_tpu.index.catalog import CatalogEntry as JEntry
from classmate_rag_tpu.index.store import IndexStore as JStore
from classmate_rag_tpu_torch.index.catalog import Catalog as TCatalog
from classmate_rag_tpu_torch.index.catalog import CatalogEntry as TEntry
from classmate_rag_tpu_torch.index.lexical import tokenize_py
from classmate_rag_tpu_torch.index.store import IndexStore as TStore

DIM = 16
KW = dict(slab_rows=8, terms_per_chunk=16)
ARRAYS = ("emb", "term_ids", "tfs", "doc_len", "valid", "field_cols",
          "tag_bits")

SIDES = {
    "jax": (JStore, JCatalog, JEntry, {}),
    "torch": (TStore, TCatalog, TEntry, {"device": "cpu"}),
}


class Saver:
    """A catalog + store of one package, mutated and persisted."""

    def __init__(self, side, root, n=12, seed=5):
        self.store_cls, self.cat_cls, self.entry, self.dev = SIDES[side]
        self.root = root
        self.rng = np.random.default_rng(seed)
        self.catalog = self.cat_cls.load_or_create(root / "bm25")
        self.store = self.store_cls(DIM, root / "dense", **KW, **self.dev)
        self.add(range(n))

    def add(self, idx, word="topic"):
        ids, embs, toks, metas = [], [], [], []
        for i in idx:
            text = (f"document number {i} about {word}{i % 3} stuff "
                    f"extra{i} words")
            meta = {"course": f"c{i % 2}", "language": "en"}
            if i % 3 == 0:
                meta["tag_week1"] = True
            ids.append(f"id{i}")
            toks.append(tokenize_py(text, "en"))
            metas.append(meta)
            self.catalog.upsert(self.entry(f"id{i}", text, toks[-1], meta))
        embs = self.rng.standard_normal((len(ids), DIM)).astype(np.float32)
        self.store.upsert(ids, embs, toks, metas)

    def delete(self, ids):
        self.catalog.delete(ids)
        self.store.delete(ids)

    def persist(self):
        self.catalog.save()
        self.store.save(catalog_fingerprint=self.catalog.fingerprint())


def load(side, root):
    store_cls, cat_cls, _entry, dev = SIDES[side]
    catalog = cat_cls.load_or_create(root / "bm25")
    return store_cls.load_or_create(DIM, root / "dense", catalog, **KW,
                                    **dev)


def assert_host_equal(a, b):
    assert a.ids == b.ids and a.capacity == b.capacity
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.vocab == b.vocab and a.tag_slots == b.tag_slots
    assert ({f: t.to_id for f, t in a.interns.items()}
            == {f: t.to_id for f, t in b.interns.items()})


def batch(store, rng):
    q = rng.standard_normal((4, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    terms = [["document", "topic1"], ["extra3", "stuff"], [], ["words"]]
    out = store.hybrid_topk_batch(q, terms, None, top_k=6)
    return {k: np.asarray(jax.device_get(getattr(out, k))
                          if not hasattr(getattr(out, k), "numpy")
                          else getattr(out, k).numpy())
            for k in ("rows", "fused", "vec_dist", "bm25_score")}


def assert_same_answers(a, b, seed=0):
    ra, rb = batch(a, np.random.default_rng(seed)), batch(
        b, np.random.default_rng(seed))
    assert ra["rows"].tolist() == rb["rows"].tolist()
    for k in ("fused", "vec_dist", "bm25_score"):
        np.testing.assert_allclose(ra[k], rb[k], rtol=1e-5, atol=1e-5,
                                   equal_nan=True)


def check_load(saver, loader_side):
    other = load(loader_side, saver.root)
    own = load("jax" if loader_side == "torch" else "torch", saver.root)
    assert_host_equal(saver.store, other)
    assert_host_equal(own, other)
    assert_same_answers(saver.store, other)
    return other


@pytest.mark.parametrize("saver_side,loader_side",
                         [("jax", "torch"), ("torch", "jax")])
def test_full_delta_compact_chain(tmp_path, saver_side, loader_side):
    s = Saver(saver_side, tmp_path, n=16)
    s.persist()
    check_load(s, loader_side)
    dense = tmp_path / "dense"
    base = (dense / "embeddings.npy").read_bytes()

    # Under a quarter of the rows each time, so each save is a delta.
    s.add([2, 16, 17])                 # a re-upsert and two new rows
    s.delete(["id4"])
    s.persist()
    s.add([18], word="brandnew")       # new vocabulary
    s.delete(["id7", "id16"])
    s.persist()
    assert len(list(dense.glob("lexical.delta_*.npz"))) == 2
    assert (dense / "embeddings.npy").read_bytes() == base
    loaded = check_load(s, loader_side)
    assert "brandnew" in loaded.vocab and not loaded.valid[
        loaded.id_to_row["id4"]]

    s.store.compact()
    s.persist()
    assert not list(dense.glob("lexical.delta_*.npz"))
    check_load(s, loader_side)


@pytest.mark.parametrize("saver_side,loader_side",
                         [("jax", "torch"), ("torch", "jax")])
def test_v2_split_snapshot(tmp_path, monkeypatch, saver_side, loader_side):
    """With the persisted split layout (SPLIT_PERSIST_MIN_ROWS lowered on
    both classes) the loader restores it instead of building, and a
    delta on top goes through the O(delta) planner — the same counters in
    both packages."""
    for cls in (JStore, TStore):
        monkeypatch.setattr(cls, "SPLIT_PERSIST_MIN_ROWS", 4)
    s = Saver(saver_side, tmp_path, n=20)
    s.persist()
    assert (tmp_path / "dense" / "split.tf_head.npy").exists()
    s.add([3, 20], word="fresh")
    s.delete(["id5"])
    s.persist()
    a = check_load(s, loader_side)
    b = load(saver_side, tmp_path)
    batch(b, np.random.default_rng(1))
    for st in (a, b):
        assert (st.split_snapshot_restores, st.split_full_builds,
                st.device_full_uploads) == (1, 0, 1)


def test_load_then_upsert_leaves_files(tmp_path):
    """The port adopts the v2 slabs as copy-on-write mmaps: an upsert and
    a device sync after the load must not write through to the files."""
    s = Saver("jax", tmp_path)
    s.persist()
    dense = tmp_path / "dense"
    files = {p.name: p.read_bytes() for p in dense.iterdir()}
    st = load("torch", tmp_path)
    assert isinstance(st.emb, np.memmap)
    batch(st, np.random.default_rng(2))
    st.upsert(["id1", "id3"],
              np.ones((2, DIM), np.float32),
              [["changed", "words"], ["other"]], [{}, {}])
    batch(st, np.random.default_rng(2))
    assert st.device_full_uploads == 1
    assert {p.name: p.read_bytes() for p in dense.iterdir()} == files


@pytest.mark.parametrize("saver_side", ["jax", "torch"])
def test_torn_saves_rebuild_cold(tmp_path, saver_side):
    s = Saver(saver_side, tmp_path)
    s.persist()
    dense = tmp_path / "dense"
    # emb_stat mismatch: the registry indexes another embeddings file.
    emb = dense / "embeddings.npy"
    st = emb.stat()
    os.utime(emb, ns=(st.st_atime_ns, st.st_mtime_ns + 10_000))
    a, b = load("jax", tmp_path), load("torch", tmp_path)
    assert a.n_rows == b.n_rows == 0
    os.utime(emb, ns=(st.st_atime_ns, st.st_mtime_ns))

    # A broken delta chain: the middle delta is gone.
    for k in range(3):
        s.add([20 + k])
        s.persist()
    deltas = sorted(dense.glob("lexical.delta_*.npz"))
    assert len(deltas) == 3
    deltas[1].unlink()
    a, b = load("jax", tmp_path), load("torch", tmp_path)
    assert_host_equal(a, b)
    assert a.n_rows == 12            # the base registry's rows, rebuilt
    assert a._persist_fp is None and b._persist_fp is None
