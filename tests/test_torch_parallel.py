"""The port's sharded hybrid steps (classmate_rag_tpu_torch/parallel/
sharded.py) against the JAX package's on its 8 virtual CPU devices, and
against the port's own single-device step.

The port's mesh is ``[cpu] * S``: the same code that puts one shard on
each of S cards. Inputs are one numpy-seeded corpus (the JAX package's
tests/test_parallel.py corpus: skewed terms, so some clear the head
threshold) at S 2, 4 and 8, unfiltered, filtered, with a segmented tail,
with a shard that has no live row, with k_bm25 past what the shards hold
(S·k' < k), with the precomputed corpus df, with the f16 rescore, and on
the approx route; the third query of every batch has no term (has_terms
false).

Tolerances: rows EQUAL to JAX's sharded step's and to the port's
single-device step's (the approx route is held against JAX only: each
shard rescores its own wider pool, a superset of the single-device
pool); scores within atol/rtol 1e-5 (test_torch_hybrid_step.py's
tolerance: f32 sums in another order), NaN where a branch did not
return the row on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from classmate_rag_tpu.parallel import corpus_mesh as j_mesh
from classmate_rag_tpu.parallel import make_sharded_hybrid_fn as j_gather_fn
from classmate_rag_tpu.parallel import (
    make_sharded_split_hybrid_fn as j_split_fn,
)
from classmate_rag_tpu_torch.index import lexical as tlex
from classmate_rag_tpu_torch.ops import hybrid_step as tstep
from classmate_rag_tpu_torch.parallel import (
    corpus_mesh,
    make_sharded_hybrid_fn,
    make_sharded_split_hybrid_fn,
)
from classmate_rag_tpu_torch.utils.numerics import NEG_INF

N, L, DIM, VOCAB, VPAD = 64, 12, 32, 100, 4096
KNOBS = dict(k_vector=3, k_bm25=3, top_k=4, pool=4, vocab_pad=VPAD)
T = torch.from_numpy


def shard(x, mesh, dim=0):
    """A global array as one equal block a shard, along ``dim``."""
    return [b.contiguous() for b in torch.as_tensor(x).chunk(len(mesh), dim)]


def _corpus(seed=7):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((N, DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    term_ids = np.full((N, L), -1, np.int32)
    tfs = np.zeros((N, L), np.uint8)
    for r in range(N):
        terms = np.unique(
            (rng.zipf(1.6, L) - 1).clip(0, VOCAB - 1)
        ).astype(np.int32)
        term_ids[r, : len(terms)] = terms
        tfs[r, : len(terms)] = rng.integers(1, 5, len(terms))
    return emb, term_ids, tfs, tfs.sum(axis=1).astype(np.float32)


def _queries(layout):
    rng = np.random.default_rng(3)
    b, m = 3, 6
    q_vecs = rng.standard_normal((b, DIM)).astype(np.float32)
    q_vecs /= np.linalg.norm(q_vecs, axis=1, keepdims=True)
    q_tids = np.full((b, m), -1, np.int32)
    q_counts = np.zeros((b, m), np.float32)
    head = np.where(layout["lut"] >= 0)[0]
    tail = np.where(
        (layout["lut"] < 0) & (np.diff(layout["offsets"]) > 0)
    )[0]
    # Query 0: head-heavy (tail when the layout has no head terms);
    # query 1: mixed; query 2: no terms.
    q_tids[0, :3] = (head if len(head) >= 3 else tail)[:3]
    q_tids[1, 0] = head[0] if len(head) else tail[2]
    q_tids[1, 1:3] = tail[:2]
    q_counts[:2, :3] = 1.0
    return q_vecs, q_tids, q_counts


CASES = {
    "unfiltered": {},
    "filtered": dict(filtered=True),
    "segmented": dict(seg_cap=8, head_df_threshold=10**6),
    "dead_shard": dict(dead_shard=True),
    "k_past_shards": dict(knobs=dict(k_bm25=96)),
    "precomputed_df": dict(with_df=True),
    "rescore": dict(rescore=True),
    "approx": dict(rescore=True, select="approx"),
}


def _case(s, filtered=False, seg_cap=512, head_df_threshold=4,
          dead_shard=False, knobs=None, with_df=False, rescore=False,
          select="exact"):
    emb, term_ids, tfs, doc_len = _corpus()
    layout = tlex.build_split_layout(
        term_ids, tfs, VOCAB, head_bytes_budget=1 << 20,
        head_df_threshold=head_df_threshold, seg_cap=seg_cap,
    )
    assert layout["offsets"][-1] > 0, "need tail postings for coverage"
    n_local = N // s
    bias = np.zeros(N, np.float32)
    if filtered:
        bias[1::3] = NEG_INF
    if dead_shard:
        bias[n_local: 2 * n_local] = NEG_INF
    q_vecs, q_tids, q_counts = _queries(layout)
    qa = tlex.split_query_arrays(layout["lut"], layout["offsets"], q_tids,
                                 q_counts, r_cap=layout["r_cap"])
    post_rows_sh, post_tfs_sh, offsets_sh = tlex.shard_postings(
        layout["post_rows"], layout["post_tfs"], layout["offsets"], s,
        n_local, layout["r_cap"],
    )
    u_starts_sh, u_lens_sh = tlex.shard_tail_ranges(
        offsets_sh, qa["u_tids"], r_cap=layout["r_cap"]
    )
    df = tlex.subset_df(T(term_ids), T(tfs), T(bias == 0.0), VPAD).numpy()
    return dict(
        emb=emb, term_ids=term_ids, tfs=tfs, doc_len=doc_len, bias=bias,
        layout=layout, q_vecs=q_vecs, q_tids=q_tids, q_counts=q_counts,
        qa=qa, has_terms=np.any(q_tids >= 0, axis=1, keepdims=True),
        post_rows_sh=post_rows_sh, post_tfs_sh=post_tfs_sh,
        u_starts_sh=u_starts_sh, u_lens_sh=u_lens_sh, df=df,
        knobs={**KNOBS, **(knobs or {})}, with_df=with_df,
        rescore=rescore, select=select,
    )


def _extra(c):
    return dict(rescore_pool=16, select=c["select"]) if c["rescore"] else {}


def _jax_split(s, c):
    lay, qa = c["layout"], c["qa"]
    fn = j_split_fn(j_mesh(s), r_cap=lay["r_cap"], with_df=c["with_df"],
                    with_rescore=c["rescore"], **_extra(c), **c["knobs"])
    args = [jnp.asarray(c["emb"], jnp.bfloat16)] + [jnp.asarray(x) for x in (
        c["term_ids"], c["tfs"], lay["tf_head"], c["post_rows_sh"],
        c["post_tfs_sh"], c["doc_len"], c["bias"], c["q_vecs"],
        qa["h_slots"], qa["h_tids"], c["u_starts_sh"], c["u_lens_sh"],
        qa["u_cols"], qa["t_tids"], c["q_tids"], c["q_counts"],
        c["has_terms"],
    )]
    if c["with_df"]:
        args.append(jnp.asarray(c["df"]))
    if c["rescore"]:
        args.append(jnp.asarray(c["emb"].astype(np.float16)))
    return fn(*args)


def _port_split(s, c):
    lay, qa = c["layout"], c["qa"]
    mesh = corpus_mesh(devices=["cpu"] * s)
    fn = make_sharded_split_hybrid_fn(mesh, r_cap=lay["r_cap"], **_extra(c),
                                      **c["knobs"])
    return fn(
        shard(T(c["emb"]).bfloat16(), mesh), shard(c["term_ids"], mesh),
        shard(c["tfs"], mesh), shard(lay["tf_head"], mesh, dim=1),
        c["post_rows_sh"], c["post_tfs_sh"], shard(c["doc_len"], mesh),
        shard(c["bias"], mesh), c["q_vecs"], qa["h_slots"], qa["h_tids"],
        c["u_starts_sh"], c["u_lens_sh"], qa["u_cols"], qa["t_tids"],
        c["q_tids"], c["q_counts"], c["has_terms"],
        df=c["df"] if c["with_df"] else None,
        emb16=(shard(c["emb"].astype(np.float16), mesh)
               if c["rescore"] else None),
    )


def _port_single(c):
    lay, qa = c["layout"], c["qa"]
    return tstep.hybrid_query_step_split(
        T(c["emb"]).bfloat16(), T(lay["tf_head"]), T(lay["post_rows"]),
        T(lay["post_tfs"]), T(c["doc_len"]), T(c["df"]), T(c["bias"]),
        T(c["q_vecs"]), *(T(qa[k]) for k in tlex.STEP_COLUMNS),
        T(c["q_tids"]), T(c["q_counts"]), T(c["has_terms"]),
        emb16=T(c["emb"].astype(np.float16)) if c["rescore"] else None,
        r_cap=lay["r_cap"], **_extra(c), **c["knobs"],
    )


def _same(got, want):
    """Rows equal, scores within 1e-5 (NaN on both sides alike)."""
    assert np.array_equal(np.asarray(got.rows), np.asarray(want.rows))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("s", [2, 4, 8])
def test_split_step_matches_jax_and_single_device(s, case):
    c = _case(s, **CASES[case])
    got = _port_split(s, c)
    rows = got.rows.numpy()
    assert got.rows.dtype == torch.int32
    # No merge sentinel leaks: every row is a corpus row or -1.
    assert ((rows >= -1) & (rows < N)).all()
    if case == "dead_shard":
        n_local = N // s
        assert not ((rows >= n_local) & (rows < 2 * n_local)).any()
    _same(got, _jax_split(s, c))
    if c["select"] == "exact":
        _same(got, _port_single(c))


@pytest.mark.parametrize("case", ["unfiltered", "filtered", "dead_shard"])
@pytest.mark.parametrize("s", [2, 4, 8])
def test_gather_pass_step_matches_jax(s, case):
    c = _case(s, **CASES[case])
    knobs = dict(KNOBS, pool=2)
    want = j_gather_fn(j_mesh(s), **knobs)(
        jnp.asarray(c["emb"], jnp.bfloat16), *(jnp.asarray(x) for x in (
            c["term_ids"], c["tfs"], c["doc_len"], c["bias"], c["q_vecs"],
            c["q_tids"], c["q_counts"],
        ))
    )
    mesh = corpus_mesh(devices=["cpu"] * s)
    got = make_sharded_hybrid_fn(mesh, **knobs)(
        shard(T(c["emb"]).bfloat16(), mesh), shard(c["term_ids"], mesh),
        shard(c["tfs"], mesh), shard(c["doc_len"], mesh),
        shard(c["bias"], mesh), c["q_vecs"], c["q_tids"], c["q_counts"],
    )
    _same(got, want)


def test_corpus_mesh():
    assert corpus_mesh(2, ["cpu"] * 4) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="at least one"):
        corpus_mesh(devices=[])
