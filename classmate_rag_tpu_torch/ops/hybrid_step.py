"""The fused hybrid query step for a batch of queries (port of the JAX
package's ``ops/hybrid_step.py``).

Masked dense scan (the CUDA kernel of ops/topk.py on the card) + f16
pool rescore + MMR, subset-statistics split-frequency BM25, weighted
RRF — plain functions on tensors, with the batch dimension written out
where the reference vmaps. Returns ``top_k`` rows per query with
fused/vector/bm25 scores. ``hybrid_query_step`` is the same step with
the gather-pass BM25 over the packed [N, L] term matrix, the reference
of the sharded step. The store serves ``hybrid_query_step_split_packed``:
the same step with the batch's query metadata (head union, tail segment
table, query term ids and counts, has-terms flags) in one i32 buffer
(``pack_query_arrays``), so that a batch makes one host-to-device copy
of it, and ``unpack_query_arrays`` takes views of the one device tensor.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from classmate_rag_tpu_torch.index.lexical import (
    bm25_split_score_core,
    okapi_idf,
    okapi_query_weights,
    okapi_sat,
    okapi_score_rows,
    subset_stats,
)
from classmate_rag_tpu_torch.ops.fusion import rrf_merge
from classmate_rag_tpu_torch.ops.mmr import mmr_order
from classmate_rag_tpu_torch.ops.topk import (
    lexsort_desc,
    masked_topk,
    row_select,
)
from classmate_rag_tpu_torch.utils.metrics import metrics
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
    src = emb if emb16 is None else emb16
    cand = (src[torch.clamp(d_rows, min=0)]
            if emb16 is not None or use_mmr else None)
    return dense_pool_order(
        q_vecs, d_rows, d_vals, cand, pool=pool_eff, k_vector=k_vector,
        use_mmr=use_mmr, mmr_lambda=mmr_lambda, rescore=emb16 is not None,
    )


def dense_pool_order(q_vecs, rows, vals, cand, *, pool, k_vector, use_mmr,
                     mmr_lambda, rescore):
    """The dense branch after selection: ``rows``/``vals`` [B, R] in
    (score desc, row asc) order with their candidate embeddings ``cand``
    [B, R, d] (None when neither rescore nor MMR reads them). With
    ``rescore`` (``cand`` the f16 master) the R rows are re-scored and
    cut to the first ``pool``; then MMR or the first ``k_vector`` →
    (vec_rows, vec_dist) [B, kv]. Dead entries (vals <= NEG_INF/2) never
    come out, whatever row id they carry."""
    if rescore:
        rows, vals, order = rescore_candidates(q_vecs, cand, rows, vals)
        rows, vals = rows[:, :pool], vals[:, :pool]
        cand = cand.gather(
            1, order[:, :pool, None].expand(-1, -1, cand.shape[2])
        )
    alive = vals > NEG_INF / 2
    if use_mmr:
        orders = mmr_order(q_vecs, cand.float(), alive, k_vector, mmr_lambda)
        picked_ok = orders >= 0
        safe = torch.clamp(orders, min=0)
        vec_rows = torch.where(picked_ok, rows.gather(1, safe), -1)
        vec_vals = torch.where(picked_ok, vals.gather(1, safe), NEG_INF)
    else:
        vec_rows = torch.where(alive[:, :k_vector], rows[:, :k_vector], -1)
        vec_vals = vals[:, :k_vector]
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


def select_width(k_bm25, n, select="exact"):
    """Columns ``bm25_select``'s first selection keeps of N: min(k, N) on
    the exact route, the approx route's wider pool min(max(64, 4k), N)."""
    k_bm_eff = min(k_bm25, n)
    if select != "approx":
        return k_bm_eff
    return min(max(64, 4 * k_bm_eff), n)


def bm25_select(scores, bias, k_bm25, *, select="exact", rescore_ctx=None):
    """(vals, rows) [B, k] of the best rows of ``scores`` [B, N] (BM25
    scores) plus ``bias`` [N] (the mask bias), (value desc, row asc);
    k = min(k_bm25, N). The first selection is ``row_select`` (on the card
    one read of the scores; its width, ``select_width``, at most
    ROW_SELECT_MAX_K there).

    ``select="approx"`` takes a wider pool (max(64, 4k) rows) and, with
    ``rescore_ctx``, re-scores it exactly before the final order: BM25
    scores tie often, and boundary ties must resolve exactly as the exact
    route does."""
    n = scores.shape[1]
    k_bm_eff = min(k_bm25, n)
    p_vals, p_rows, _ = row_select(scores, bias,
                                   select_width(k_bm25, n, select))
    if select != "approx":
        return p_vals, p_rows
    if rescore_ctx is not None:
        exact = bm25_rescore_pool(p_rows, *rescore_ctx)
        p_vals = torch.where(p_vals > NEG_INF / 2, exact, NEG_INF)
    order = lexsort_desc(p_vals, p_rows)[:, :k_bm_eff]
    return p_vals.gather(1, order), p_rows.gather(1, order)


def bm25_finish(b_vals, b_rows, has_terms):
    """(bm_rows, bm_vals): -1 / 0 where no live row was found or the
    query had no vocabulary term."""
    b_rows = torch.where(b_vals > NEG_INF / 2, b_rows, -1)
    b_vals = torch.where(b_rows >= 0, b_vals, 0.0)
    return torch.where(has_terms, b_rows, -1), b_vals


def _bm25_postprocess(bm_scores, mask_bias, has_terms, *, k_bm25,
                      select="exact", rescore_ctx=None):
    """Top-k over BM25 scores with padding/empty-query handling."""
    return bm25_finish(
        *bm25_select(bm_scores, mask_bias, k_bm25, select=select,
                     rescore_ctx=rescore_ctx),
        has_terms,
    )


def _fuse(vec_rows, vec_dist, bm_rows, bm_vals, *, weight_vector,
          weight_bm25, rrf_k, top_k):
    rows, fused, vdist, bscore = rrf_merge(
        vec_rows, bm_rows, vec_dist, bm_vals,
        weight_vector, weight_bm25, rrf_k, top_k,
    )
    return HybridBatchResult(rows.to(torch.int32), fused, vdist, bscore)


def hybrid_query_step(
    emb,            # [N, d] bf16
    term_ids,       # [N, L] i32
    tfs,            # [N, L] u8
    doc_len,        # [N] f32
    df,             # [vocab_pad+1] f32 (subset df for the active mask)
    mask_bias,      # [N] f32
    q_vecs,         # [B, d] f32
    q_terms,        # [B, M] i32 (-1 padded)
    q_counts,       # [B, M] f32
    *,
    k_vector: int = 8,
    k_bm25: int = 8,
    top_k: int = 8,
    pool: int = 24,
    vocab_pad: int = 4096,
    use_mmr: bool = True,
    mmr_lambda: float = 0.5,
    rrf_k: int = 60,
    weight_vector: float = 1.0,
    weight_bm25: float = 1.0,
) -> HybridBatchResult:
    """The fused step over the packed [N, L] term matrix (the gather-pass
    BM25): the single-device reference the sharded step
    (parallel/sharded.py) is held against. The subset sums are
    ``lexical.subset_sums``'s, so avgdl equals the split step's bit for
    bit."""
    vec_rows, vec_dist = _dense_branch(
        emb, mask_bias, q_vecs,
        k_vector=k_vector, pool=pool, use_mmr=use_mmr, mmr_lambda=mmr_lambda,
    )
    _keep, n_sub, avgdl = subset_stats(mask_bias, doc_len)
    idf = okapi_idf(df, n_sub)
    bm_scores = okapi_score_rows(
        term_ids, tfs, doc_len, avgdl,
        okapi_query_weights(idf, q_terms, q_counts, vocab_pad), vocab_pad,
    )                                                     # [B, N]
    has_terms = torch.any(q_terms >= 0, dim=1, keepdim=True)
    bm_rows, bm_vals = _bm25_postprocess(
        bm_scores, mask_bias, has_terms, k_bm25=k_bm25,
    )
    return _fuse(
        vec_rows, vec_dist, bm_rows, bm_vals,
        weight_vector=weight_vector, weight_bm25=weight_bm25,
        rrf_k=rrf_k, top_k=top_k,
    )


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
    postings); all tensors on one device. While ``metrics.tracing()`` is
    on, each stage records the span that queues its ops: ``step.dense``
    (scan, f16 rescore, MMR), ``step.bm25_core`` (subset statistics, idf,
    the head and tail scores), ``step.bm25_select`` (the selection, the
    approx route's exact pool rescore, the finish) and ``step.fuse``.
    ``step.bm25_core`` counts ``bm25_k_slots``, the head and tail slots
    its product is handed (H + T as padded; the approx route's kernel
    skips each 64-slot chunk that is wholly padding)."""
    with metrics.span("step.dense"):
        vec_rows, vec_dist = _dense_branch(
            emb, mask_bias, q_vecs,
            k_vector=k_vector, pool=pool, use_mmr=use_mmr,
            mmr_lambda=mmr_lambda, emb16=emb16, rescore_pool=rescore_pool,
        )
    with metrics.span("step.bm25_core",
                      bm25_k_slots=h_slots.shape[0] + t_tids.shape[0]):
        keep, n_sub, avgdl = subset_stats(mask_bias, doc_len)
        idf = okapi_idf(df, n_sub)
        # Fast BM25: approx mode + packed rows available → bf16-rounded
        # sat matrices, with the exact pool rescore restoring final ranks
        # (on CUDA one kernel, ops/bm25_core.py).
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
    with metrics.span("step.bm25_select"):
        bm_rows, bm_vals = _bm25_postprocess(
            bm_scores, mask_bias, has_terms, k_bm25=k_bm25, select=select,
            rescore_ctx=rescore_ctx,
        )
    with metrics.span("step.fuse"):
        return _fuse(
            vec_rows, vec_dist, bm_rows, bm_vals,
            weight_vector=weight_vector, weight_bm25=weight_bm25,
            rrf_k=rrf_k, top_k=top_k,
        )


def pack_query_arrays(qa, q_terms, q_counts, has_terms):
    """Concatenate a batch's query metadata into ONE i32 buffer: the six
    ``STEP_COLUMNS`` of ``lexical.split_query_arrays`` (``qa``), then
    ``q_terms`` [B, M], ``q_counts`` [B, M] f32 bit-cast to i32 and
    ``has_terms`` [B, 1] widened to i32 — the reference's layout, element
    for element. Returns (packed i32 [2H + 3U + T + 2BM + B], statics
    {"h", "u", "t", "b", "m"} for ``hybrid_query_step_split_packed``)."""
    b, m = q_terms.shape
    parts = [
        np.ascontiguousarray(qa["h_slots"], np.int32),
        np.ascontiguousarray(qa["h_tids"], np.int32),
        np.ascontiguousarray(qa["u_starts"], np.int32),
        np.ascontiguousarray(qa["u_lens"], np.int32),
        np.ascontiguousarray(qa["u_cols"], np.int32),
        np.ascontiguousarray(qa["t_tids"], np.int32),
        np.ascontiguousarray(q_terms, np.int32).ravel(),
        np.ascontiguousarray(q_counts, np.float32).ravel().view(np.int32),
        np.ascontiguousarray(has_terms, bool).ravel().astype(np.int32),
    ]
    statics = {"h": len(qa["h_slots"]), "u": len(qa["u_starts"]),
               "t": len(qa["t_tids"]), "b": b, "m": m}
    return np.concatenate(parts), statics


def unpack_query_arrays(packed: torch.Tensor, *, h: int, u: int, t: int,
                        b: int, m: int) -> Dict[str, torch.Tensor]:
    """The arrays of ``pack_query_arrays`` as views of ``packed`` (slices
    and reshapes: no copy, no wait for the device). ``q_counts`` comes
    back bit-cast to f32, ``has_terms`` as bool [B, 1]."""
    out, o = {}, 0
    for name, n in (("h_slots", h), ("h_tids", h), ("u_starts", u),
                    ("u_lens", u), ("u_cols", u), ("t_tids", t),
                    ("q_tids", b * m), ("q_counts", b * m),
                    ("has_terms", b)):
        out[name] = packed[o: o + n]
        o += n
    out["q_tids"] = out["q_tids"].reshape(b, m)
    out["q_counts"] = out["q_counts"].view(torch.float32).reshape(b, m)
    out["has_terms"] = (out["has_terms"] > 0).reshape(b, 1)
    return out


def hybrid_query_step_split_packed(
    emb, tf_head, post_rows, post_tfs, doc_len, df, mask_bias,
    q_vecs,         # [B, d] f32
    packed,         # i32 [L] from pack_query_arrays, on the step's device
    emb16=None,     # optional [N, d] f16 rescore master
    term_ids=None,  # optional [N, L] i32 + [N, L] u8: the fast-BM25
    tfs=None,       #   exact-rescore source (see the unpacked step)
    *,
    h: int, u: int, t: int, b: int, m: int,
    **knobs,
) -> HybridBatchResult:
    """``hybrid_query_step_split`` with the batch metadata in one buffer
    (one host-to-device copy a batch: the serving hot path). ``knobs``
    are the unpacked step's keyword arguments."""
    qa = unpack_query_arrays(packed, h=h, u=u, t=t, b=b, m=m)
    return hybrid_query_step_split(
        emb, tf_head, post_rows, post_tfs, doc_len, df, mask_bias, q_vecs,
        qa["h_slots"], qa["h_tids"], qa["u_starts"], qa["u_lens"],
        qa["u_cols"], qa["t_tids"], qa["q_tids"], qa["q_counts"],
        qa["has_terms"], emb16, term_ids, tfs, **knobs,
    )
