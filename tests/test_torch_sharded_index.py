"""ShardedHybridIndex, the port's corpus-sharded serving engine
(classmate_rag_tpu_torch/parallel/serving.py), against the port's own
single-device store and the JAX package's engine on its 8 virtual CPU
devices.

The port's mesh is ``[cpu] * S``. Rows must EQUAL the single-device
fused step's and the JAX engine's; fused, vector and BM25 scores agree
within atol/rtol 1e-5 (f32 sums in another order), NaN alike. Also: the
journal (upsert, delete, tag edit, embedding-only update, compaction)
re-places O(delta) bytes and answers equal the store's after each
mutation; a random mutation workload (the JAX package's
tests/test_sharded_fuzz.py); a refresh racing a query; and the host
preparation of per-shard postings equal to the JAX package's.
"""

import sys
import threading
import time

import numpy as np
import pytest

from classmate_rag_tpu.index import lexical as jlex
from classmate_rag_tpu.index.store import IndexStore as JStore
from classmate_rag_tpu.parallel import corpus_mesh as j_mesh
from classmate_rag_tpu.parallel.serving import (
    ShardedHybridIndex as JShardedIndex,
)
from classmate_rag_tpu_torch.index import lexical as tlex
from classmate_rag_tpu_torch.index.lexical import tokenize_py
from classmate_rag_tpu_torch.index.store import IndexStore
from classmate_rag_tpu_torch.parallel import ShardedHybridIndex
from classmate_rag_tpu_torch.parallel import serving as tserving
from classmate_rag_tpu_torch.utils.rwlock import ReadWriteLock

DIM = 48

DOCS = [
    "the derivative measures the rate of change of a function",
    "the integral accumulates the area under a curve",
    "matrix multiplication composes linear transformations",
    "eigenvalues and eigenvectors characterize linear maps",
    "derivative rules include the product rule and chain rule",
    "cooking pasta requires boiling water and adding salt",
    "gradient descent updates parameters against the gradient",
    "the chain rule differentiates composed functions",
    "bayes theorem inverts conditional probabilities",
    "variance measures spread around the mean",
]
QUERY_TERMS = [
    "derivative chain rule", "pasta boiling water", "zzz unknown terms only",
]


def _mesh(s):
    return ["cpu"] * s


def _unit(rng, n, dim=DIM):
    v = rng.standard_normal((n, dim)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _stores(tmp_path, **knobs):
    """(port store, JAX store) over the same documents."""
    rng = np.random.default_rng(13)
    ids = [f"id{i}" for i in range(len(DOCS))]
    embs = _unit(rng, len(DOCS))
    tokens = [tokenize_py(t, "en") for t in DOCS]
    metas = [{"course": "math" if i < 6 else "misc", "tags": ["w1"]}
             for i in range(len(DOCS))]
    t = IndexStore(DIM, tmp_path / "t", slab_rows=16, terms_per_chunk=32,
                   device="cpu", **knobs)
    j = JStore(DIM, tmp_path / "j", slab_rows=16, terms_per_chunk=32,
               **knobs)
    for store in (t, j):
        store.upsert(ids, embs, tokens, metas)
    return t, j


def _queries(seed, n=3):
    q = _unit(np.random.default_rng(seed), n)
    return q, [tokenize_py(t, "en") for t in QUERY_TERMS[:n]]


def _same(got, want):
    assert np.array_equal(np.asarray(got.rows), np.asarray(want.rows))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("where", [None, {"course": "math"},
                                   {"tags": "w1", "course": "misc"}])
@pytest.mark.parametrize("s", [2, 4, 8])
def test_matches_single_device_and_jax(tmp_path, s, where):
    t, j = _stores(tmp_path)
    q, terms = _queries(3)
    engine = ShardedHybridIndex(t, _mesh(s), top_k=6)
    got = engine.query_batch(q, terms, where)
    _same(got, t.hybrid_topk_batch(q, terms, where, top_k=6))
    _same(got, JShardedIndex(j, j_mesh(s), top_k=6).query_batch(
        q, terms, where))
    if where == {"course": "math"}:
        rows = got.rows.numpy()
        assert ((rows < 6) | (rows == -1)).all()
    # The bias cache holds one entry per filter and reuses it.
    engine.query_batch(q, terms, where)
    assert len(engine._bias_cache) == 1


def test_rescore_and_knob_overrides(tmp_path):
    t, _ = _stores(tmp_path, rescore="on", rescore_pool=16)
    q, terms = _queries(4)
    engine = ShardedHybridIndex(t, _mesh(4))
    assert engine._dev["emb16"] is not None
    knobs = dict(top_k=5, k_vector=4, pool=6)
    _same(engine.query_batch(q, terms, None, **knobs),
          t.hybrid_topk_batch(q, terms, None, **knobs))
    with pytest.raises(TypeError, match="unknown query knob"):
        engine.query_batch(q, terms, None, bogus=1)


def test_indivisible_capacity_rejected(tmp_path):
    store = IndexStore(DIM, tmp_path, slab_rows=12, terms_per_chunk=8,
                       device="cpu")
    store.upsert(["a"], _unit(np.random.default_rng(0), 1), [["alpha"]],
                 [{}])
    with pytest.raises(ValueError, match="divide"):
        ShardedHybridIndex(store, _mesh(8))


def test_stats_shard_occupancy(tmp_path):
    t, j = _stores(tmp_path)
    got = ShardedHybridIndex(t, _mesh(8)).stats()
    want = JShardedIndex(j, j_mesh(8)).stats()
    for key in ("n_shards", "rows_per_shard", "tail_postings_per_shard",
                "head_terms", "r_cap", "capacity_per_shard"):
        assert got[key] == want[key], key
    assert sum(got["rows_per_shard"]) == len(t)
    assert got["devices"] == ["cpu"] * 8


def test_journal_o_delta(tmp_path):
    """Each kind of mutation moves O(delta) bytes and the engine answers
    as the store does; compaction re-places everything."""
    t, _ = _stores(tmp_path, rescore="on", rescore_pool=16)
    engine = ShardedHybridIndex(t, _mesh(4), top_k=6)
    placed = engine.bytes_placed_total
    assert t.drain_journal()[1:4] == (set(), set(), set())
    rng = np.random.default_rng(5)

    def check(tag, bar=placed / 4):
        engine.ensure_fresh()
        assert engine.bytes_placed_last_refresh < bar, tag
        for where in (None, {"course": "math"}):
            q, terms = _queries(int(rng.integers(100)))
            _same(engine.query_batch(q, terms, where),
                  t.hybrid_topk_batch(q, terms, where, top_k=6))

    row = t.id_to_row["id2"]
    # Lexical change of one row (new terms: the vocab grows).
    t.upsert(["id2"], t.emb[row:row + 1].astype(np.float32),
             [tokenize_py("matrix quaternion rotation algebra", "en")],
             [{"course": "math", "tags": ["w1"]}])
    check("lexical")
    # Embedding-only update of one row: one f16 row per master.
    t.upsert(["id3"], _unit(rng, 1), [tokenize_py(DOCS[3], "en")],
             [{"course": "math", "tags": ["w1"]}])
    check("embedding", bar=4 * DIM * 2 + 64)
    # Delete and a tag edit: no placed array moves at the refresh.
    t.delete(["id0"])
    check("delete", bar=1)
    t.upsert(["id5"], t.emb[5:6].astype(np.float32),
             [tokenize_py(DOCS[5], "en")],
             [{"course": "misc", "tags": ["w2"]}])
    check("tag", bar=1)
    assert engine.full_lexical_rebuilds == 0
    # Compaction is structural: a full re-place.
    assert t.compact() == 1
    engine.ensure_fresh()
    assert engine.bytes_placed_last_refresh >= placed / 2
    check("after compaction")


def _doc(rng, vocab):
    return [vocab[i] for i in rng.integers(0, len(vocab),
                                           rng.integers(3, 12))]


@pytest.mark.parametrize("seed", [3, 17])
def test_incremental_refresh_fuzz(tmp_path, seed):
    """A random mutation workload (overwrites, appends that grow the
    capacity, deletes, revivals, compactions) through a wrapped store:
    after every round the engine answers as the store does."""
    vocab = [f"w{i}" for i in range(60)]
    rng = np.random.default_rng(seed)
    store = IndexStore(32, tmp_path, slab_rows=8, terms_per_chunk=16,
                       rescore="on", rescore_pool=16, device="cpu")
    n0 = 24
    ids = [f"d{i}" for i in range(n0)]
    store.upsert(ids, _unit(rng, n0, 32), [_doc(rng, vocab) for _ in ids],
                 [{"course": f"c{i % 3}"} for i in range(n0)])
    engine = ShardedHybridIndex(store, _mesh(8), top_k=6)
    live, dead, next_id = set(ids), set(), n0
    for round_i in range(24):
        op = int(rng.integers(0, 6))
        if op == 0 and live:      # new embedding, new tokens
            cid = sorted(live)[int(rng.integers(0, len(live)))]
            store.upsert([cid], _unit(rng, 1, 32), [_doc(rng, vocab)],
                         [{"course": "c1"}])
        elif op == 1:             # append (may grow capacity)
            new = [f"d{next_id + j}" for j in range(int(rng.integers(1, 4)))]
            next_id += len(new)
            store.upsert(new, _unit(rng, len(new), 32),
                         [_doc(rng, vocab) for _ in new],
                         [{"course": f"c{j % 3}"} for j in range(len(new))])
            live.update(new)
        elif op == 2 and len(live) > 4:
            cid = sorted(live)[int(rng.integers(0, len(live)))]
            store.delete([cid])
            live.discard(cid)
            dead.add(cid)
        elif op == 3 and dead:    # revive
            cid = sorted(dead)[int(rng.integers(0, len(dead)))]
            store.upsert([cid], _unit(rng, 1, 32), [_doc(rng, vocab)],
                         [{"course": "c2"}])
            dead.discard(cid)
            live.add(cid)
        elif op == 4 and rng.random() < 0.4:
            store.compact()
            dead.clear()
        qv = _unit(rng, 2, 32)
        terms = [_doc(rng, vocab)[:4], _doc(rng, vocab)[:4]]
        for where in (None, {"course": "c1"}):
            want = store.hybrid_topk_batch(qv, terms, where, top_k=6)
            got = engine.query_batch(qv, terms, where)
            assert np.array_equal(got.rows.numpy(), want.rows.numpy()), (
                round_i, op, where)
            np.testing.assert_allclose(got.fused.numpy(),
                                       want.fused.numpy(), atol=1e-5)


def test_stale_bias_not_cached_after_refresh(tmp_path, monkeypatch):
    """A filter bias computed before a delete's refresh, and finished
    after it, is served to its own query but never cached: the next query
    does not return the deleted row."""
    t, _ = _stores(tmp_path)
    engine = ShardedHybridIndex(t, _mesh(4), top_k=10)
    where = {"course": "math"}
    started, release = threading.Event(), threading.Event()
    real = tserving.mask_bias_host

    def slow(*args):
        out = real(*args)
        started.set()
        assert release.wait(30)
        return out

    monkeypatch.setattr(tserving, "mask_bias_host", slow)
    worker = threading.Thread(target=engine._mask_bias_sharded,
                              args=(where,))
    worker.start()
    assert started.wait(30)
    t.delete(["id1"])
    engine.ensure_fresh()          # bumps _bias_gen while the bias is out
    release.set()
    worker.join(30)
    assert not worker.is_alive()
    assert engine._bias_cache == {}
    monkeypatch.setattr(tserving, "mask_bias_host", real)
    q, terms = _queries(6)
    got = engine.query_batch(q, terms, where)
    assert t.id_to_row["id1"] not in got.rows.numpy()
    _same(got, t.hybrid_topk_batch(q, terms, where, top_k=10))


def test_concurrent_queries_and_mutations(tmp_path):
    """Readers query the engine and the store under a reader lock while
    a writer mutates under the writer lock (the server's discipline):
    every reader sees the engine answer as the store does."""
    t, _ = _stores(tmp_path)
    engine = ShardedHybridIndex(t, _mesh(4), top_k=6)
    lock = ReadWriteLock()
    stop = time.monotonic() + 3.0
    errors, done = [], []

    def reader(seed):
        rng = np.random.default_rng(seed)
        try:
            while time.monotonic() < stop:
                q, terms = _queries(int(rng.integers(1000)))
                with lock.read():
                    got = engine.query_batch(q, terms, None)
                    want = t.hybrid_topk_batch(q, terms, None, top_k=6)
                if not np.array_equal(got.rows.numpy(), want.rows.numpy()):
                    errors.append((got.rows, want.rows))
            done.append(seed)
        except Exception as exc:  # reported below
            errors.append(exc)

    def writer():
        rng = np.random.default_rng(99)
        i = 0
        while time.monotonic() < stop:
            cid = f"id{int(rng.integers(len(DOCS)))}"
            with lock.write():
                if rng.random() < 0.3:
                    t.delete([cid])
                else:
                    t.upsert([cid], _unit(rng, 1), [tokenize_py(
                        DOCS[i % len(DOCS)], "en")], [{"course": "math"}])
            i += 1
        done.append("writer")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader, args=(k,))
                   for k in range(6)] + [threading.Thread(target=writer)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:2]
    assert len(done) == 7


@pytest.mark.parametrize("s", [2, 4, 8])
def test_shard_postings_and_tail_ranges_match_jax(s):
    rng = np.random.default_rng(s)
    n, width, vocab = 64, 10, 80
    term_ids = np.full((n, width), -1, np.int32)
    tfs = np.zeros((n, width), np.uint8)
    for r in range(n):
        terms = np.unique((rng.zipf(1.5, width) - 1).clip(0, vocab - 1))
        term_ids[r, : len(terms)] = terms
        tfs[r, : len(terms)] = rng.integers(1, 6, len(terms))
    lay = tlex.build_split_layout(term_ids, tfs, vocab, seg_cap=4,
                                  head_bytes_budget=1 << 20,
                                  head_df_threshold=6)
    args = (lay["post_rows"], lay["post_tfs"], lay["offsets"], s, n // s,
            lay["r_cap"])
    got = tlex.shard_postings(*args, reserve=16)
    want = jlex.shard_postings(*args, reserve=16)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    q_tids = rng.integers(-1, vocab, size=(4, 6)).astype(np.int32)
    q_counts = np.ones((4, 6), np.float32)
    ov_counts = rng.integers(0, 9, size=vocab) * (rng.random(vocab) < 0.3)
    ov_offsets = np.concatenate([[0], np.cumsum(ov_counts)]).astype(np.int64)
    ov_sh = np.stack([ov_offsets] * s)
    for ov in (None, ov_offsets):
        qa = tlex.split_query_arrays(lay["lut"], lay["offsets"], q_tids,
                                     q_counts, r_cap=lay["r_cap"],
                                     ov_offsets=ov)
        kw = {} if ov is None else dict(
            u_occ=qa["u_occ"], u_ov=qa["u_ov"], ov_offsets_sh=ov_sh,
            ov_starts_sh=got[2][:, -1])
        for mine, theirs in zip(
                tlex.shard_tail_ranges(got[2], qa["u_tids"],
                                       r_cap=lay["r_cap"], **kw),
                jlex.shard_tail_ranges(want[2], qa["u_tids"],
                                       r_cap=lay["r_cap"], **kw)):
            assert np.array_equal(mine, theirs)
