"""The port's multi-process layer (classmate_rag_tpu_torch/parallel/
multihost.py) and cross-process sharded serving, in two real gloo
processes on the CPU (the port's counterpart of tests/test_multihost.py).

Each child joins the group through a ``file://`` rendezvous in the
test's temporary directory (no port to race for under xdist), serves
the same store over 2 processes × 2 CPU shards, and saves what it
returned; the parent holds both ranks' rows against each other, the
port's single-device store and the JAX package's
``IndexStore.hybrid_topk_batch`` on the same seeded inputs (rows equal;
scores within 1e-5, f32 sums in another order). The mutation test
replays one ingest and one delete on both ranks: the O(delta) refresh
moves equal bytes on both (``process_allgather``) with no full lexical
rebuild. A rank that leaves a collective fails the other within the
group timeout instead of hanging it.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from classmate_rag_tpu.index.lexical import tokenize as j_tokenize
from classmate_rag_tpu.index.store import IndexStore as JStore
from classmate_rag_tpu_torch.parallel import multihost
from classmate_rag_tpu_torch.parallel.mesh import RankDevice
from classmate_rag_tpu_torch.parallel.sharded import MeshShards

REPO = Path(__file__).resolve().parent.parent

PREAMBLE = r"""
import sys
import numpy as np
pid = int(sys.argv[1]); rdv = sys.argv[2]; out = sys.argv[3]
sys.path.insert(0, {repo!r})
from classmate_rag_tpu_torch.parallel import multihost
multihost.initialize(f"file://{{rdv}}", 2, pid, backend="gloo",
                     timeout_s=60)
assert multihost.process_count() == 2
assert multihost.process_index() == pid
"""

MESH_CHILD = PREAMBLE + r"""
mesh = multihost.dcn_training_mesh(["cpu", "cpu"])
shape = mesh.shape
assert shape["replica"] == 2, shape
assert shape["data"] * shape["model"] == 2, shape
entries = mesh.entries()
assert len(set(entries)) == 4, entries        # every device exactly once
assert [e.rank for e in entries] == [0, 0, 1, 1], entries
corpus = multihost.process_corpus_mesh(["cpu", "cpu"])
assert [(e.rank, e.local) for e in corpus] == [(0, 0), (0, 1), (1, 0),
                                               (1, 1)], corpus
got = multihost.process_allgather(np.array([pid * 10 + 1], np.int32))
assert got.shape == (2, 1), got.shape
assert sorted(got.ravel().tolist()) == [1, 11], got
print(f"OK proc{{pid}} mesh={{shape}}")
"""

SERVING_CHILD = PREAMBLE + r"""
import torch
from classmate_rag_tpu_torch.index.lexical import tokenize
from classmate_rag_tpu_torch.index.store import IndexStore
from classmate_rag_tpu_torch.parallel import ShardedHybridIndex
from classmate_rag_tpu_torch.parallel.mesh import RankDevice

# Every process builds the SAME store (the SPMD contract).
rng = np.random.default_rng(99)
store = IndexStore(16, f"{{out}}/store{{pid}}", slab_rows=8,
                   terms_per_chunk=8, device="cpu")
docs = ["the derivative measures change", "pasta needs boiling water",
        "eigenvalues characterize maps", "gradients minimize loss",
        "entropy measures uncertainty", "matrices compose maps",
        "integrals accumulate area", "variance measures spread"]
embs = rng.standard_normal((8, 16)).astype(np.float32)
embs /= np.linalg.norm(embs, axis=1, keepdims=True)
metas = [{{"course": "math" if i % 2 else "misc"}} for i in range(8)]
store.upsert([f"d{{i}}" for i in range(8)], embs,
             [tokenize(d, "en") for d in docs], metas)

q_terms = [tokenize("derivative", "en"), tokenize("pasta water", "en"),
           tokenize("entropy uncertainty", "en")]
qv = embs[[0, 1, 4]]
mesh = multihost.process_corpus_mesh(["cpu", "cpu"])  # 4 shards, 2 ranks
# The same shards dealt to the ranks in turn: blocks must still be laid
# out by global shard index.
dealt = [RankDevice(s % 2, s // 2, torch.device("cpu")) for s in range(4)]
res = {{}}
for name, m in (("ranked", mesh), ("dealt", dealt)):
    idx = ShardedHybridIndex(store, m, top_k=2)
    assert idx._shards.owned == ([2 * pid, 2 * pid + 1] if name == "ranked"
                                 else [pid, pid + 2]), idx._shards.owned
    for where in (None, {{"course": "math"}}):
        out_ = idx.query_batch(qv, q_terms, where)
        key = f"{{name}}_{{'f' if where else 'u'}}"
        for field in ("rows", "fused", "vec_dist", "bm25_score"):
            res[f"{{key}}_{{field}}"] = getattr(out_, field).numpy()
    assert idx.bytes_exchanged_total > 0
single = store.hybrid_topk_batch(qv, q_terms, None, top_k=2)
want = single.rows.numpy()
assert np.array_equal(res["ranked_u_rows"], want), (res["ranked_u_rows"],
                                                    want)
np.savez(f"{{out}}/serving{{pid}}.npz", **res)
print(f"OK proc{{pid}} rows={{res['ranked_u_rows'].tolist()}}")
"""

MUTATION_CHILD = PREAMBLE + r"""
from classmate_rag_tpu_torch.index.lexical import tokenize
from classmate_rag_tpu_torch.index.store import IndexStore
from classmate_rag_tpu_torch.parallel import ShardedHybridIndex

DOCS = ["the derivative measures change", "pasta needs boiling water",
        "eigenvalues characterize maps", "gradients minimize loss",
        "entropy measures uncertainty", "matrices compose maps",
        "integrals accumulate area", "variance measures spread",
        "limits define continuity", "tensors generalize matrices"]

def build_store(path):
    # Every process replays the SAME mutation sequence, so journals are
    # identical on every process.
    rng = np.random.default_rng(7)
    store = IndexStore(16, path, slab_rows=16, terms_per_chunk=8,
                       device="cpu")
    embs = rng.standard_normal((12, 16)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    store.upsert([f"d{{i}}" for i in range(10)], embs[:10],
                 [tokenize(d, "en") for d in DOCS], [{{}}] * 10)
    return store, embs

def mutate(store, embs):
    store.upsert(["new0", "new1"], embs[10:12],
                 [tokenize("fourier transforms decompose signals", "en"),
                  tokenize("probability measures belief", "en")],
                 [{{}}, {{}}])
    store.delete(["d1"])

store, embs = build_store(f"{{out}}/mut{{pid}}")
idx = ShardedHybridIndex(store, multihost.process_corpus_mesh(["cpu", "cpu"]),
                         top_k=3)
queries = embs[[0, 4, 9]]
q_terms = [tokenize("derivative", "en"), tokenize("entropy uncertainty", "en"),
           tokenize("fourier signals", "en")]
idx.query_batch(queries, q_terms)        # place the base state
base_bytes = idx.bytes_placed_total

mutate(store, embs)
out_ = idx.query_batch(queries, q_terms)  # drains the journal first
rows = out_.rows.numpy()

delta = idx.bytes_placed_last_refresh
assert 0 < delta < base_bytes * 0.5, (delta, base_bytes)
assert idx.full_lexical_rebuilds == 0, idx.full_lexical_rebuilds

single, s_embs = build_store(f"{{out}}/mut_single{{pid}}")
mutate(single, s_embs)
want = single.hybrid_topk_batch(queries, q_terms, None, top_k=3).rows.numpy()
assert np.array_equal(rows, want), (rows.tolist(), want.tolist())
assert 1 not in rows[0], rows[0]          # the deleted chunk is gone

got = multihost.process_allgather(np.asarray([delta], np.int64))
assert got.ravel()[0] == got.ravel()[1], got  # same delta on every rank
np.savez(f"{{out}}/mutation{{pid}}.npz", rows=rows, delta=delta,
         base=base_bytes)
print(f"OK proc{{pid}} delta_bytes={{delta}} base_bytes={{base_bytes}}")
"""

DESERTER_CHILD = PREAMBLE + r"""
# Rank 1 leaves without entering the collective rank 0 waits in: rank 0
# must fail (peer gone, or the group timeout), not hang.
if pid == 1:
    print("OK proc1 left")
    sys.exit(0)
try:
    multihost.process_allgather(np.zeros(1))
except RuntimeError as exc:
    print(f"OK proc0 failed: {{type(exc).__name__}}")
    sys.exit(0)
sys.exit("proc0: the collective returned without its peer")
"""


def _run_two_process(tmp_path, child_src: str):
    script = tmp_path / "child.py"
    script.write_text(child_src.format(repo=str(REPO)))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": str(REPO)}
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(name, None)
    rdv = tmp_path / "rendezvous"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), str(rdv), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{i} failed:\n{out}"
        assert f"OK proc{i}" in out, out


def test_two_process_mesh_and_allgather(tmp_path):
    _run_two_process(tmp_path, MESH_CHILD)


def _jax_store(tmp_path):
    rng = np.random.default_rng(99)
    store = JStore(16, tmp_path / "jax", slab_rows=8, terms_per_chunk=8)
    docs = ["the derivative measures change", "pasta needs boiling water",
            "eigenvalues characterize maps", "gradients minimize loss",
            "entropy measures uncertainty", "matrices compose maps",
            "integrals accumulate area", "variance measures spread"]
    embs = rng.standard_normal((8, 16)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    metas = [{"course": "math" if i % 2 else "misc"} for i in range(8)]
    store.upsert([f"d{i}" for i in range(8)], embs,
                 [j_tokenize(d, "en") for d in docs], metas)
    q_terms = [j_tokenize("derivative", "en"),
               j_tokenize("pasta water", "en"),
               j_tokenize("entropy uncertainty", "en")]
    return store, embs[[0, 1, 4]], q_terms


def test_two_process_sharded_serving(tmp_path):
    """2 processes × 2 CPU shards: both ranks return the same result,
    with rows equal to one device's and to the JAX package's, filtered
    or not, whichever rank owns which shard."""
    _run_two_process(tmp_path, SERVING_CHILD)
    ranks = [dict(np.load(tmp_path / f"serving{i}.npz")) for i in range(2)]
    for key in ranks[0]:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key],
                                      err_msg=key)
    jstore, qv, q_terms = _jax_store(tmp_path)
    for tag, where in (("u", None), ("f", {"course": "math"})):
        want = jstore.hybrid_topk_batch(qv, q_terms, where, top_k=2)
        for mesh in ("ranked", "dealt"):
            got = ranks[0]
            np.testing.assert_array_equal(
                got[f"{mesh}_{tag}_rows"], np.asarray(want.rows))
            for field in ("fused", "vec_dist", "bm25_score"):
                np.testing.assert_allclose(
                    got[f"{mesh}_{tag}_{field}"],
                    np.asarray(getattr(want, field)), rtol=1e-5,
                    atol=1e-5, equal_nan=True, err_msg=field)


def test_two_process_mutation_journal_refresh(tmp_path):
    """One ingest and one delete replayed on both ranks: an O(delta)
    refresh with equal bytes on both ranks and no full lexical rebuild;
    rows equal to one device's and to the JAX package's store that saw
    the same mutations."""
    _run_two_process(tmp_path, MUTATION_CHILD)
    ranks = [dict(np.load(tmp_path / f"mutation{i}.npz")) for i in range(2)]
    assert int(ranks[0]["delta"]) == int(ranks[1]["delta"])
    np.testing.assert_array_equal(ranks[0]["rows"], ranks[1]["rows"])

    rng = np.random.default_rng(7)
    store = JStore(16, tmp_path / "jax_mut", slab_rows=16, terms_per_chunk=8)
    docs = ["the derivative measures change", "pasta needs boiling water",
            "eigenvalues characterize maps", "gradients minimize loss",
            "entropy measures uncertainty", "matrices compose maps",
            "integrals accumulate area", "variance measures spread",
            "limits define continuity", "tensors generalize matrices"]
    embs = rng.standard_normal((12, 16)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    store.upsert([f"d{i}" for i in range(10)], embs[:10],
                 [j_tokenize(d, "en") for d in docs], [{}] * 10)
    store.upsert(["new0", "new1"], embs[10:12],
                 [j_tokenize("fourier transforms decompose signals", "en"),
                  j_tokenize("probability measures belief", "en")],
                 [{}, {}])
    store.delete(["d1"])
    q_terms = [j_tokenize("derivative", "en"),
               j_tokenize("entropy uncertainty", "en"),
               j_tokenize("fourier signals", "en")]
    want = store.hybrid_topk_batch(embs[[0, 4, 9]], q_terms, None, top_k=3)
    np.testing.assert_array_equal(ranks[0]["rows"], np.asarray(want.rows))


def test_a_rank_leaving_a_collective_fails_the_other(tmp_path):
    _run_two_process(tmp_path, DESERTER_CHILD)


def test_single_process_initialize_stays_local(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    multihost.initialize()
    assert not torch.distributed.is_initialized()
    assert multihost.process_count() == 1
    assert multihost.process_index() == 0
    got = multihost.process_allgather(np.array([3, 4]))
    assert got.tolist() == [[3, 4]]
    mesh = multihost.dcn_training_mesh(["cpu", "cpu", "cpu", "cpu"])
    assert mesh.shape == {"replica": 1, "data": 1, "model": 4}
    corpus = multihost.process_corpus_mesh(["cpu", "cpu"])
    assert corpus == [RankDevice(0, 0, torch.device("cpu")),
                      RankDevice(0, 1, torch.device("cpu"))]
    assert MeshShards(corpus).owned == [0, 1]
    assert not MeshShards(corpus).cross


def test_initialize_needs_an_explicit_backend(monkeypatch):
    """A configured coordinator with no backend named raises before any
    connection is tried: no silent choice between gloo and NCCL."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("127.0.0.1:1", 1, 0)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize(backend="mpi")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("mesh,match", [
    ([RankDevice(1, 0, torch.device("cpu"))], "outside"),
    ([RankDevice(0, 0, torch.device("cpu")), "cpu"], "mixes"),
])
def test_mesh_shards_refuse_a_foreign_layout(mesh, match):
    with pytest.raises(ValueError, match=match):
        MeshShards(mesh)
