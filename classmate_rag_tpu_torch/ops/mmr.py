"""Greedy Maximal-Marginal-Relevance ordering, batched over queries
(port of the JAX package's ``ops/mmr.py``, which vmaps one query).

Pick argmax query-similarity first, then repeatedly pick
``argmax λ·sim(q, i) − (1−λ)·max_{s∈selected} sim(i, s)``; ties resolve
to the lowest pool index (``torch.argmax`` returns the first maximum).
"""

from __future__ import annotations

import torch

from classmate_rag_tpu_torch.utils.numerics import NEG_INF


def mmr_order(
    q: torch.Tensor,        # [B, d] query embeddings (L2-normalized)
    cands: torch.Tensor,    # [B, P, d] candidate embeddings
    valid: torch.Tensor,    # [B, P] bool
    k: int,
    lambda_: float = 0.5,
) -> torch.Tensor:
    """Return [B, k] int64 pool positions in MMR order (-1 where the
    pool is exhausted)."""
    b, p = valid.shape
    # Full f32 similarities (no TF32 on the card, see device.py): pool
    # margins are smaller than a reduced-precision matmul's error.
    c32 = cands.float()
    sims_q = torch.bmm(c32, q.float()[:, :, None])[:, :, 0]   # [B, P]
    sims_cc = torch.bmm(c32, c32.transpose(1, 2))             # [B, P, P]
    sims_q = torch.where(valid, sims_q, NEG_INF)
    ar = torch.arange(b, device=valid.device)
    # Picks leave the pool through masks made on the device: writing a
    # host value through an index (``remaining[ar, pick] = False``)
    # copies it from the host and waits for the card.
    slots = torch.arange(p, device=valid.device)

    order = torch.full((b, k), -1, dtype=torch.int64, device=valid.device)
    first = torch.argmax(sims_q, dim=1)
    order[:, 0] = torch.where(valid.any(dim=1), first, -1)
    remaining = valid & (slots[None, :] != first[:, None])
    # Max similarity of each candidate to the selected set so far.
    run_max = sims_cc[ar, :, first]

    for j in range(1, min(k, p)):
        mmr = lambda_ * sims_q - (1.0 - lambda_) * run_max
        mmr = torch.where(remaining, mmr, NEG_INF)
        pick = torch.argmax(mmr, dim=1)
        ok = remaining.any(dim=1)
        order[:, j] = torch.where(ok, pick, -1)
        remaining = remaining & ~(
            (slots[None, :] == pick[:, None]) & ok[:, None]
        )
        run_max = torch.where(
            ok[:, None], torch.maximum(run_max, sims_cc[ar, :, pick]),
            run_max,
        )
    return order
