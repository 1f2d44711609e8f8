"""The approx route's BM25 core on the kernel's operands
(classmate_rag_tpu_torch/ops/bm25_core.py), on the CPU: the plain version
of ``csrc/bm25_sat_gemm.cu`` (head rows by slot, the tail's postings by
row tile, bf16 weights) vs the port's ``bm25_split_score_core(fast=True)``
and the JAX package's, on the same numpy-seeded data, base layouts and a
layout with an overlay (``plan_tail_delta``).

Tolerances: every side rounds the saturation and the weights to bf16 and
sums exact products in f32 in its own order, so scores agree to 1e-4 (the
fast mode's tolerance in test_torch_lexical.py); the tail's tf are
integers and must be EQUAL to the plain core's f32 sums.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from classmate_rag_tpu.index import lexical as jlex
from classmate_rag_tpu_torch.index import lexical as tlex
from classmate_rag_tpu_torch.ops import bm25_core

from test_torch_lexical import LAYOUTS, _corpus, _packed

VPAD = 512
TOL = 1e-4
RESERVE = 256


def _apply_overlay(lay, ids, tfs, dl, docs, vocab, rng):
    """Rewrite 12 rows with other rows' words (every word already in the
    vocabulary) the way the store's O(delta) sync does: head columns
    rewritten, old tail postings set to 0, new ones in the overlay region
    after the base postings. Returns the overlay offsets."""
    rows = rng.choice(len(docs), size=12, replace=False)
    changes = []
    for row in rows:
        src = int(rng.integers(len(docs)))
        new = tlex.pack_tokens(docs[src][::-1][:20], vocab, ids.shape[1])
        changes.append((int(row), (ids[row].copy(), tfs[row].copy()),
                        (new[0], new[1])))
        ids[row], tfs[row], dl[row] = new
    plan = tlex.plan_tail_delta(lay["lut"], lay["offsets"], lay["post_rows"],
                                {}, changes, RESERVE, len(lay["offsets"]) - 1)
    assert plan is not None and len(plan["zero_pos"]) and len(plan["ov_rows"])
    lay["post_tfs"][plan["zero_pos"]] = 0
    at = lay["p_base"] + np.arange(len(plan["ov_rows"]))
    lay["post_rows"][at] = plan["ov_rows"]
    lay["post_tfs"][at] = plan["ov_tfs"]
    c_pad = lay["tf_head"].shape[0]
    lay["tf_head"][:, rows] = tlex.head_tf_columns(
        lay["lut"], c_pad, ids[rows], tfs[rows])
    return plan["ov_offsets"]


def _case(budget, thr, overlay, n_queries=16, seed=7):
    """Core arguments (numpy) of one batch over a split layout."""
    rng, docs = _corpus(seed=seed)
    vocab, ids, tfs, dl = _packed(docs)
    lay = tlex.build_split_layout(ids, tfs, len(vocab),
                                  head_bytes_budget=budget,
                                  head_df_threshold=thr, seg_cap=4,
                                  reserve=RESERVE)
    ov = {}
    if overlay:
        ov = dict(ov_offsets=_apply_overlay(lay, ids, tfs, dl, docs, vocab,
                                            rng),
                  ov_start=lay["p_base"])
    keep = np.random.default_rng(8).random(len(docs)) < 0.8
    df = tlex.subset_df(torch.from_numpy(ids), torch.from_numpy(tfs),
                        torch.from_numpy(keep), VPAD).numpy()
    n_sub = np.float32(keep.sum())
    idf = tlex.okapi_idf(torch.from_numpy(df), torch.tensor(n_sub)).numpy()
    avgdl = np.float32(dl[keep].sum() / n_sub)
    queries = [docs[i][:6] + docs[i][:2] for i in range(0, 4 * n_queries, 4)]
    queries[-1] = []                              # a query with no terms
    q_terms, q_counts = tlex.pack_query_terms(vocab, queries, 8)
    qa = tlex.split_query_arrays(lay["lut"], lay["offsets"], q_terms,
                                 q_counts, r_cap=lay["r_cap"], **ov)
    args = [lay["tf_head"], lay["post_rows"], lay["post_tfs"], dl, keep, idf,
            avgdl, qa["h_slots"], qa["h_tids"], qa["u_starts"], qa["u_lens"],
            qa["u_cols"], qa["t_tids"], q_terms, q_counts]
    return args, lay["r_cap"], qa


def _torch(args):
    return [torch.as_tensor(np.asarray(x)) for x in args]


@pytest.mark.parametrize("overlay", [False, True])
@pytest.mark.parametrize("budget,thr", LAYOUTS)
def test_plain_on_kernel_operands_matches_fast_core(budget, thr, overlay):
    args, r_cap, qa = _case(budget, thr, overlay)
    kw = dict(vocab_pad=VPAD, r_cap=r_cap)
    t = _torch(args)
    got = bm25_core.fast_scores(*t, **kw).numpy()
    core = tlex.bm25_split_score_core(*t, fast=True, **kw).numpy()
    jax = np.asarray(jlex.bm25_split_score_core(
        *[jnp.asarray(x) for x in args], fast=True, **kw))
    np.testing.assert_allclose(got, core, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, jax, rtol=TOL, atol=TOL)
    assert np.count_nonzero(got) > 0 and not got[-1].any()
    if overlay:
        assert (qa["u_ov"][qa["u_lens"] > 0] == 1).any()


@pytest.mark.parametrize("overlay", [False, True])
@pytest.mark.parametrize("budget,thr", LAYOUTS)
def test_tail_postings_equal_the_cores_sums(budget, thr, overlay):
    """The kernel's tail (live postings sorted by 128-row tile), made
    dense, EQUALS the plain core's tail matrix; each tile holds its own
    rows; a (row, term) pair has one live posting at most."""
    args, r_cap, qa = _case(budget, thr, overlay)
    t = _torch(args)
    post_rows, post_tfs, u_starts, u_lens, u_cols, t_tids = (
        t[1], t[2], t[9], t[10], t[11], t[12])
    n = t[0].shape[1]
    sums = tlex.tail_tf_matrix(post_rows, post_tfs, u_starts, u_lens, u_cols,
                               t_tids.shape[0], n, r_cap)
    tail = bm25_core.tail_postings(post_rows, post_tfs, u_starts, u_lens,
                                   u_cols, n, r_cap)
    assert all(x.dtype == torch.int32 for x in tail)
    tiles = -(-n // bm25_core.TILE_ROWS)
    assert tail.off.shape == (tiles + 1,) and int(tail.off[0]) == 0
    end = int(tail.off[-1])
    assert 0 < end == int((sums > 0).sum())
    assert float(sums.max()) <= 255.0
    dense = bm25_core.tail_matrix(tail, t_tids.shape[0], n)
    assert torch.equal(dense.float(), sums.T)
    rows = tail.rows[:end].long()
    tile_of = torch.repeat_interleave(torch.arange(tiles),
                                      tail.off.diff().long())
    assert torch.equal(rows // bm25_core.TILE_ROWS, tile_of)
    pairs = tail.cols[:end].long() * n + rows
    assert pairs.unique().numel() == end


@pytest.mark.parametrize("b", [1, 7, 40])
def test_batch_sizes_match_fast_core(b):
    args, r_cap, _ = _case(1 << 20, 8, False, n_queries=b, seed=11)
    kw = dict(vocab_pad=VPAD, r_cap=r_cap)
    t = _torch(args)
    got = bm25_core.fast_scores(*t, **kw)
    core = tlex.bm25_split_score_core(*t, fast=True, **kw)
    assert got.shape == core.shape == (b, t[0].shape[1])
    np.testing.assert_allclose(got.numpy(), core.numpy(), rtol=TOL, atol=TOL)


def test_sat_operand_rounds_the_cores_saturation():
    """The kernel's operand is the plain core's head matrix rounded to bf16
    (round to nearest even), element for element, masks included."""
    args, _, _ = _case(1 << 20, 8, False)
    tf_head, doc_len, keep, avgdl, h_slots = (
        torch.as_tensor(args[0]), torch.as_tensor(args[3]),
        torch.as_tensor(args[4]), torch.as_tensor(args[6]),
        torch.as_tensor(args[7]))
    rows = tf_head[h_slots.clamp(min=0).long()] * (h_slots >= 0)[:, None]
    sat = tlex.okapi_sat(rows, doc_len[None, :], avgdl)
    want = (sat * (rows > 0) * keep[None, :]).to(torch.bfloat16)
    got = bm25_core.sat_operand(rows, doc_len, keep, avgdl)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert (got.float() > 0).any() and not got[:, ~keep].float().any()


def test_sat_gemm_refuses_wrong_inputs():
    args, r_cap, _ = _case(1 << 20, 8, False)
    t = _torch(args)
    tf_head, doc_len, keep, avgdl, h_slots, t_tids = (
        t[0], t[3], t[4], t[6], t[7], t[12])
    n = tf_head.shape[1]
    tail = bm25_core.tail_postings(t[1], t[2], t[9], t[10], t[11], n, r_cap)
    w = bm25_core.query_weights(t[5], t[8], t_tids, t[13], t[14], VPAD)
    ok = (tf_head, h_slots, tail, doc_len, keep, avgdl, w)
    assert bm25_core.sat_gemm(*ok).shape == (w.shape[0], n)
    bad = [
        (0, tf_head.int()), (1, h_slots.long()),
        (2, tail._replace(rows=tail.rows.long())),
        (2, tail._replace(off=tail.off[:-1])),
        (2, tail._replace(tfs=tail.tfs[:-1])),
        (3, doc_len[:-1]), (4, keep.float()), (5, avgdl.double()),
        (6, w.float()), (6, w[:, :3]), (6, w[:0]),
    ]
    for i, x in bad:
        with pytest.raises((TypeError, ValueError)):
            bm25_core.sat_gemm(*ok[:i], x, *ok[i + 1:])
