"""Weighted Reciprocal-Rank Fusion, batched over queries (port of the
JAX package's ``ops/fusion.py``, which vmaps one query).

``score(row) = Σ_lists w_l / (rrf_k + rank)`` with 1-based ranks over
the concatenation of the per-branch ranked row lists (-1 padded);
duplicates keep their first occurrence. Results sort by fused desc, then
vector distance asc (rows the dense branch did not return count 0), then
row id asc.
"""

from __future__ import annotations

from typing import Tuple

import torch

from classmate_rag_tpu_torch.utils.numerics import NEG_INF


def rrf_merge(
    vec_idx: torch.Tensor,     # [B, Kv] global row ids, -1 padded, ranked
    bm_idx: torch.Tensor,      # [B, Kb] global row ids, -1 padded, ranked
    vec_dist: torch.Tensor,    # [B, Kv] cosine distances aligned with vec_idx
    bm_scores: torch.Tensor,   # [B, Kb] bm25 scores aligned with bm_idx
    weight_vector: float,
    weight_bm25: float,
    rrf_k: int = 60,
    top_k: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fuse two ranked lists per query.

    Returns (rows, fused, vec_dist, bm_score), each [B, min(top_k, C)];
    rows are -1 (fused NEG_INF) past the end. Per-branch scores carry
    NaN where that branch did not return the row.
    """
    dev = vec_idx.device
    kv = vec_idx.shape[1]
    kb = bm_idx.shape[1]
    cand = torch.cat([vec_idx, bm_idx], dim=1)                 # [B, C]
    c = cand.shape[1]

    # First-occurrence mask (dedup): compare against earlier positions.
    pos = torch.arange(c, device=dev)
    earlier = pos[None, :] < pos[:, None]                      # [C, C]
    eq_prev = (cand[:, :, None] == cand[:, None, :]) & earlier[None]
    alive = (cand >= 0) & ~eq_prev.any(dim=2)

    ranks_v = 1.0 + torch.arange(kv, dtype=torch.float32, device=dev)
    ranks_b = 1.0 + torch.arange(kb, dtype=torch.float32, device=dev)
    in_vec = (cand[:, :, None] == vec_idx[:, None, :]) & (
        vec_idx[:, None, :] >= 0
    )
    in_bm = (cand[:, :, None] == bm_idx[:, None, :]) & (
        bm_idx[:, None, :] >= 0
    )
    fused = (
        torch.where(in_vec, weight_vector / (rrf_k + ranks_v), 0.0).sum(2)
        + torch.where(in_bm, weight_bm25 / (rrf_k + ranks_b), 0.0).sum(2)
    )

    # Per-branch scores for reporting; NaN = branch did not return the row.
    # (A Python scalar, not a tensor made on the device: that copy from
    # the host would make every batch wait for the card.)
    vdist = torch.where(
        in_vec.any(dim=2),
        torch.where(in_vec, vec_dist[:, None, :], 0.0).sum(2),
        float("nan"),
    )
    bscore = torch.where(
        in_bm.any(dim=2),
        torch.where(in_bm, bm_scores[:, None, :], 0.0).sum(2),
        float("nan"),
    )

    fused = torch.where(alive, fused, NEG_INF)
    # Sort key: fused desc, then distance asc (bm25-only rows count 0),
    # then row id asc: jnp.lexsort((cand, dist_term, -fused)) as three
    # stable sorts, least significant key first.
    dist_term = torch.where(torch.isnan(vdist), 0.0, vdist)
    order = torch.sort(cand, dim=1, stable=True).indices
    order = order.gather(1, torch.sort(
        dist_term.gather(1, order), dim=1, stable=True).indices)
    order = order.gather(1, torch.sort(
        fused.gather(1, order), dim=1, descending=True, stable=True).indices)
    take = order[:, :top_k]
    out_fused = fused.gather(1, take)
    dead = out_fused <= NEG_INF / 2
    # Dead slots (padding/duplicates) report row -1 uniformly.
    return (
        torch.where(dead, -1, cand.gather(1, take)),
        out_fused,
        vdist.gather(1, take),
        bscore.gather(1, take),
    )
