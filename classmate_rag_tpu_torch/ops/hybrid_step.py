"""The fused hybrid query step for a batch of queries (port of the JAX
package's ``ops/hybrid_step.py``).

Masked dense scan (the CUDA kernel of ops/topk.py on the card) + f16
pool rescore + MMR, subset-statistics split-frequency BM25, weighted
RRF — plain functions on tensors, with the batch dimension written out
where the reference vmaps. Returns ``top_k`` rows per query with
fused/vector/bm25 scores.

The reference's packed step (one i32 buffer for the batch metadata)
exists to save round trips through a remote TPU link; here the arrays
are passed directly and the outputs are the packed step's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from classmate_rag_tpu_torch.index.lexical import (
    bm25_split_score_core,
    okapi_idf,
    okapi_sat,
    subset_stats,
)
from classmate_rag_tpu_torch.ops.fusion import rrf_merge
from classmate_rag_tpu_torch.ops.mmr import mmr_order
from classmate_rag_tpu_torch.ops.topk import (
    lexsort_desc,
    masked_topk,
    stable_topk,
)
from classmate_rag_tpu_torch.utils.numerics import NEG_INF


class HybridBatchResult(NamedTuple):
    rows: torch.Tensor        # [B, top_k] int32, -1 padded
    fused: torch.Tensor       # [B, top_k] f32
    vec_dist: torch.Tensor    # [B, top_k] f32 (NaN where dense didn't return)
    bm25_score: torch.Tensor  # [B, top_k] f32 (NaN where bm25 didn't return)


def rescore_candidates(q_vecs, cand16, d_rows, d_vals):
    """f16-exact rescore of a bf16-selected candidate pool.

    The scan's bf16 rounding flips near-tie ranks; the small top-``R``
    pool is re-scored in f32 from the f16 master and re-sorted by
    (score desc, row asc), the scan's own tie rule. Returns
    (rows, vals, order) re-ordered."""
    rescored = torch.einsum(
        "bd,brd->br", q_vecs.float(), cand16.float()
    )
    alive = d_vals > NEG_INF / 2
    vals = torch.where(alive, rescored, NEG_INF)
    order = lexsort_desc(vals, d_rows)
    return d_rows.gather(1, order), vals.gather(1, order), order


def _dense_branch(emb, mask_bias, q_vecs, *, k_vector, pool, use_mmr,
                  mmr_lambda, emb16=None, rescore_pool=64):
    """Batched masked dense scan (+MMR) → (vec_rows, vec_dist) [B, kv].

    Serves both selection routes: the reference's "approx" route picks
    the pool with a TPU primitive, here the same scan kernel does, and
    the f16 rescore orders the pool exactly.
    """
    n = emb.shape[0]
    pool_eff = min(pool if use_mmr else k_vector, n)
    sel = pool_eff if emb16 is None else min(max(rescore_pool, pool_eff), n)
    d_vals, d_rows = masked_topk(
        emb, q_vecs.float().contiguous(), mask_bias, sel
    )
    d_rows = d_rows.long()

    if emb16 is not None:
        cand16 = emb16[torch.clamp(d_rows, min=0)]          # [B, sel, d]
        d_rows, d_vals, order = rescore_candidates(
            q_vecs, cand16, d_rows, d_vals
        )
        d_rows = d_rows[:, :pool_eff]
        d_vals = d_vals[:, :pool_eff]
        cand_pool = cand16.float().gather(
            1, order[:, :pool_eff, None].expand(-1, -1, cand16.shape[2])
        )
    else:
        cand_pool = None
    d_alive = d_vals > NEG_INF / 2

    if use_mmr:
        if cand_pool is None:
            cand_pool = emb[torch.clamp(d_rows, min=0)].float()
        orders = mmr_order(q_vecs, cand_pool, d_alive, k_vector, mmr_lambda)
        picked_ok = orders >= 0
        safe = torch.clamp(orders, min=0)
        vec_rows = torch.where(picked_ok, d_rows.gather(1, safe), -1)
        vec_vals = torch.where(picked_ok, d_vals.gather(1, safe), NEG_INF)
    else:
        vec_rows = torch.where(
            d_alive[:, :k_vector], d_rows[:, :k_vector], -1
        )
        vec_vals = d_vals[:, :k_vector]
    return vec_rows, 1.0 - vec_vals


def bm25_rescore_pool(rows, term_ids, tfs, doc_len, avgdl, idf,
                      q_tids, q_counts):
    """EXACT f32 Okapi scores for a candidate pool ``rows`` [B, P] from
    the packed per-row term arrays, under the same subset statistics.

    The sum runs over the QUERY's terms in query order, the same order
    for every row (the reference sums over each row's packed term slots,
    whose order differs from row to row). Rows with equal term counts
    and lengths therefore score exactly equal on any device, and the
    (score desc, row asc) order that follows does not hang on rounding.
    """
    safe = torch.clamp(rows, min=0).long()
    ti = term_ids[safe]                               # [B, P, L]
    tf = tfs[safe].float()
    dl = doc_len[safe]                                # [B, P]
    q_ok = q_tids >= 0                                # [B, M]
    # tf of each query term in each pool row (integers: exact).
    match = (ti[:, :, None, :] == q_tids[:, None, :, None]) & (
        q_ok[:, None, :, None]
    )                                                 # [B, P, M, L]
    tf_q = (match * tf[:, :, None, :]).sum(-1)        # [B, P, M]
    w = torch.where(q_ok, q_counts, 0.0) * idf[
        torch.where(q_ok, q_tids, 0).long()
    ]                                                 # [B, M]
    sat = okapi_sat(tf_q, dl[:, :, None], avgdl) * (tf_q > 0)
    return (w[:, None, :] * sat).sum(-1)


def _bm25_postprocess(bm_scores, mask_bias, has_terms, *, k_bm25,
                      select="exact", rescore_ctx=None):
    """Top-k over BM25 scores with padding/empty-query handling.

    ``select="approx"`` takes a wider pool (max(64, 4k) rows) and, with
    ``rescore_ctx``, re-scores it exactly before the final (value desc,
    row asc) order — BM25 scores tie often, and boundary ties must
    resolve exactly as the exact route does."""
    biased = bm_scores + mask_bias[None, :]
    n = bm_scores.shape[1]
    k_bm_eff = min(k_bm25, n)
    if select == "approx":
        k_sel = min(max(64, 4 * k_bm_eff), n)
        p_vals, p_rows = stable_topk(biased, k_sel)
        if rescore_ctx is not None:
            exact = bm25_rescore_pool(p_rows, *rescore_ctx)
            p_vals = torch.where(p_vals > NEG_INF / 2, exact, NEG_INF)
        order = lexsort_desc(p_vals, p_rows)[:, :k_bm_eff]
        b_vals = p_vals.gather(1, order)
        b_rows = p_rows.gather(1, order)
    else:
        b_vals, b_rows = stable_topk(biased, k_bm_eff)
    b_rows = torch.where(b_vals > NEG_INF / 2, b_rows, -1)
    b_vals = torch.where(b_rows >= 0, b_vals, 0.0)
    b_rows = torch.where(has_terms, b_rows, -1)
    return b_rows, b_vals


def _fuse(vec_rows, vec_dist, bm_rows, bm_vals, *, weight_vector,
          weight_bm25, rrf_k, top_k):
    rows, fused, vdist, bscore = rrf_merge(
        vec_rows, bm_rows, vec_dist, bm_vals,
        weight_vector, weight_bm25, rrf_k, top_k,
    )
    return HybridBatchResult(rows.to(torch.int32), fused, vdist, bscore)


def hybrid_query_step_split(
    emb,            # [N, d] bf16
    tf_head,        # u8 [C, N] — split-frequency BM25 head matrix (term-major)
    post_rows,      # i32 [P] — tail postings
    post_tfs,       # u8 [P]
    doc_len,        # [N] f32
    df,             # [vocab_pad+1] f32
    mask_bias,      # [N] f32
    q_vecs,         # [B, d] f32
    h_slots, h_tids,            # batch head-term union [H]
    u_starts, u_lens,           # batch tail SEGMENT table [U]
    u_cols,                     # [U] segment → tail-term column
    t_tids,                     # [T] batch's distinct tail term ids
    q_tids, q_counts,           # [B, M] query term ids / multiplicities
    has_terms,      # bool [B, 1]: query had ≥1 vocab-known term
    emb16=None,     # optional [N, d] f16 rescore master
    term_ids=None,  # optional [N, L] i32 + [N, L] u8: enable fast BM25
    tfs=None,       #   in approx mode, with an exact pool rescore
    *,
    k_vector: int = 8,
    k_bm25: int = 8,
    top_k: int = 8,
    pool: int = 24,
    vocab_pad: int = 4096,
    r_cap: int = 1024,
    use_mmr: bool = True,
    mmr_lambda: float = 0.5,
    rrf_k: int = 60,
    weight_vector: float = 1.0,
    weight_bm25: float = 1.0,
    rescore_pool: int = 64,
    select: str = "exact",
) -> HybridBatchResult:
    """The fused step with split-frequency BM25 (head matmul + tail
    postings); all tensors on one device."""
    vec_rows, vec_dist = _dense_branch(
        emb, mask_bias, q_vecs,
        k_vector=k_vector, pool=pool, use_mmr=use_mmr, mmr_lambda=mmr_lambda,
        emb16=emb16, rescore_pool=rescore_pool,
    )
    keep, n_sub, avgdl = subset_stats(mask_bias, doc_len)
    idf = okapi_idf(df, n_sub)
    # Fast BM25: approx mode + packed rows available → bf16-rounded sat
    # matrices, with the exact pool rescore restoring final ranks.
    fast = select == "approx" and term_ids is not None
    bm_scores = bm25_split_score_core(
        tf_head, post_rows, post_tfs, doc_len, keep, idf, avgdl,
        h_slots, h_tids, u_starts, u_lens, u_cols, t_tids,
        q_tids, q_counts,
        vocab_pad=vocab_pad, r_cap=r_cap, fast=fast,
    )
    rescore_ctx = (
        (term_ids, tfs, doc_len, avgdl, idf, q_tids, q_counts)
        if fast else None
    )
    bm_rows, bm_vals = _bm25_postprocess(
        bm_scores, mask_bias, has_terms, k_bm25=k_bm25, select=select,
        rescore_ctx=rescore_ctx,
    )
    return _fuse(
        vec_rows, vec_dist, bm_rows, bm_vals,
        weight_vector=weight_vector, weight_bm25=weight_bm25,
        rrf_k=rrf_k, top_k=top_k,
    )
