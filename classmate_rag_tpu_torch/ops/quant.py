"""Int8 quantized dense scan with exact rescore (port of the JAX
package's ``ops/quant.py``).

The exact scan is bound by the bytes it reads, so an int8 copy of the
corpus halves them: store the corpus twice, int8 row-quantized [N, d]
(+ f32 scales) for the scan and bf16 for rescoring, and answer in two
stages:

1. approximate scores over the int8 matrix (int8 × int8 → int32, exact:
   ``torch._int_mm`` on CUDA, an int32 product on the CPU), scaled as the
   JAX package scales them, → the top ``rescore_pool`` candidates;
2. an exact rescore of those rows only (bf16 products, f32 sums) and the
   final top-k from the rescored values.

Every selection is a stable sort (ties to the lowest index, XLA's
``top_k`` rule), never ``torch.topk``. No path of either package calls
this; ``chip_smoke.py`` times it against the exact scan (``topk_scan``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from classmate_rag_tpu_torch.ops.topk import stable_topk
from classmate_rag_tpu_torch.utils.numerics import NEG_INF, round_up

# torch._int_mm on CUDA takes more than 16 rows and dimensions that are
# multiples of 8.
_INT_MM_MIN_ROWS = 17
_INT_MM_MULTIPLE = 8


def quantize_rows(emb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization → (int8 [N, d], scales f32 [N])."""
    absmax = np.abs(emb).max(axis=1)
    scales = (absmax / 127.0).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)
    q = np.clip(np.rint(emb / safe[:, None]), -127, 127).astype(np.int8)
    return q, scales


def int8_scores(q_i8: torch.Tensor, emb_i8: torch.Tensor) -> torch.Tensor:
    """``q_i8 @ emb_i8ᵀ`` → int32 [Q, N], exact: ``torch._int_mm`` on
    CUDA (queries padded past 16 rows, d and the corpus rows to multiples
    of 8, with zero rows and columns that add nothing), an int32 product
    on the CPU."""
    if not emb_i8.is_cuda:
        return q_i8.to(torch.int32) @ emb_i8.to(torch.int32).T
    nq, d = q_i8.shape
    n = emb_i8.shape[0]
    d_pad = round_up(d, _INT_MM_MULTIPLE)
    n_pad = round_up(n, _INT_MM_MULTIPLE)
    if d_pad != d or n_pad != n:
        q_i8 = torch.nn.functional.pad(q_i8, (0, d_pad - d))
        emb_i8 = torch.nn.functional.pad(emb_i8, (0, d_pad - d, 0, n_pad - n))
    rows = round_up(max(nq, _INT_MM_MIN_ROWS), _INT_MM_MULTIPLE)
    if rows != nq:
        q_i8 = torch.nn.functional.pad(q_i8, (0, 0, 0, rows - nq))
    return torch._int_mm(q_i8.contiguous(), emb_i8.T)[:nq, :n]


def quantize_queries(queries: torch.Tensor):
    """Symmetric per-row int8 quantization of f32 queries → (int8 [Q, d],
    scales f32 [Q, 1]), in the JAX package's order."""
    q_absmax = queries.abs().amax(dim=1, keepdim=True)
    q_scale = torch.clamp(q_absmax / 127.0, min=1e-12)
    q_i8 = torch.clamp(torch.round(queries / q_scale), -127, 127).to(
        torch.int8)
    return q_i8, q_scale


def int8_candidates(
    emb_i8: torch.Tensor,     # [N, d] int8
    scales: torch.Tensor,     # [N] f32
    queries: torch.Tensor,    # [Q, d] f32
    mask_bias: torch.Tensor,  # [N] f32
    pool: int,
) -> torch.Tensor:
    """Stage 1: the rows [Q, pool] (int64) of the best approximate
    scores, ties to the lowest row."""
    q_i8, q_scale = quantize_queries(queries)
    # The JAX order, in place to bound memory: (i32 → f32) * q_scale *
    # scales + bias.
    approx = int8_scores(q_i8, emb_i8).to(torch.float32)
    approx.mul_(q_scale).mul_(scales[None, :]).add_(mask_bias[None, :])
    return stable_topk(approx, pool)[1]


def topk_int8_rescore(
    emb_i8: torch.Tensor,     # [N, d] int8
    scales: torch.Tensor,     # [N] f32
    emb_bf16: torch.Tensor,   # [N, d] bf16 (exact rescore source)
    queries: torch.Tensor,    # [Q, d] f32
    mask_bias: torch.Tensor,  # [N] f32
    k: int,
    rescore_pool: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage masked top-k. Returns (scores f32 [Q, k], rows i32
    [Q, k]); rows -1 where masked or past N."""
    pool = min(rescore_pool, emb_i8.shape[0])
    cand = int8_candidates(emb_i8, scales, queries, mask_bias, pool)

    # Stage 2: exact rescore of the candidates (bf16 products are exact
    # in f32; the sums are f32).
    cand_rows = emb_bf16[cand].float()             # [Q, pool, d]
    q16 = queries.to(torch.bfloat16).float()
    exact = (cand_rows * q16[:, None, :]).sum(dim=-1)
    exact = exact + mask_bias[cand]
    vals, sel = stable_topk(exact, min(k, pool))
    rows = cand.gather(1, sel).to(torch.int32)
    rows = torch.where(vals > NEG_INF / 2, rows, torch.full_like(rows, -1))
    if k > pool:  # a corpus smaller than the pool: pad
        pad = k - pool
        vals = torch.nn.functional.pad(vals, (0, pad), value=NEG_INF)
        rows = torch.nn.functional.pad(rows, (0, pad), value=-1)
    return vals, rows


__all__ = ["int8_candidates", "int8_scores", "quantize_queries",
           "quantize_rows", "topk_int8_rescore"]
