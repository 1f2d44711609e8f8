"""Masked exact-scan dense scoring with fused top-k (port of the JAX
package's ``ops/topk.py``).

``scores = q·Eᵀ + mask_bias`` over a bf16 corpus with f32 sums, and for
each query the k best rows, ties to the LOWEST row. Three pieces:

- ``topk_reference``: the plain PyTorch version (one f32 matmul of the
  bf16-rounded operands, a stable descending sort, the first k). The CPU
  path, and the yardstick the kernel is held against on the card.
- the CUDA kernel ``csrc/topk_scan.cu`` (replaces the TPU kernel
  ``classmate_rag_tpu/ops/topk.py::topk_pallas``): per-chunk top-k lists
  in shared memory, the [Q, N] score matrix never written out.
- ``masked_topk``: the wrapper. CPU tensors take the plain version; CUDA
  tensors launch the kernel or raise.

``torch.topk`` makes no promise about which of several equal values it
returns, so every selection here is a stable sort.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from classmate_rag_tpu_torch.ops import _build
from classmate_rag_tpu_torch.utils.numerics import NEG_INF

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"topk_scan": 0}

# Mirrors CHUNK_ROWS and MAX_K in csrc/topk_scan.cu (the C side checks
# the chunk count it is given).
CHUNK_ROWS = 2048
MAX_K = 128


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, equal values in ascending index order
    (the rule of XLA's ``top_k``). Returns (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def lexsort_desc(vals: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Positions along the last dim ordered by (value desc, row asc) —
    ``jnp.lexsort((rows, -vals))`` as two stable sorts."""
    order = torch.sort(rows, dim=-1, stable=True).indices
    by_val = torch.sort(
        vals.gather(-1, order), dim=-1, descending=True, stable=True
    ).indices
    return order.gather(-1, by_val)


def topk_reference(
    emb: torch.Tensor,        # [N, d] (bf16 in the store)
    queries: torch.Tensor,    # [Q, d] f32
    mask_bias: torch.Tensor,  # [N] f32: 0 keep / NEG_INF drop
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (vals [Q, k] f32, rows [Q, k] i32); past N rows the
    result pads with (NEG_INF, -1)."""
    # Queries round to the corpus dtype, as the reference casts them;
    # the f32 matmul of the upcast operands keeps f32 sums (a bf16
    # matmul would return bf16-rounded scores).
    q = queries.to(emb.dtype).float()
    scores = q @ emb.float().T + mask_bias[None, :]
    vals, rows = stable_topk(scores, k)
    rows = rows.to(torch.int32)
    short = k - vals.shape[1]
    if short > 0:
        vals = torch.nn.functional.pad(vals, (0, short), value=NEG_INF)
        rows = torch.nn.functional.pad(rows, (0, short), value=-1)
    return vals, rows


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk_scan")
    fn = lib.topk_scan_launch
    if fn.argtypes is None:
        # Declared, or ctypes passes each pointer as a 32-bit int.
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return lib


def _check(emb, queries, mask_bias, k):
    if emb.dim() != 2 or queries.dim() != 2 or mask_bias.dim() != 1:
        raise ValueError("expected emb [N, d], queries [Q, d], mask_bias [N]")
    n, d = emb.shape
    if n == 0:
        raise ValueError("empty corpus")
    if queries.shape[1] != d or mask_bias.shape[0] != n:
        raise ValueError(
            f"shape mismatch: emb {tuple(emb.shape)}, queries "
            f"{tuple(queries.shape)}, mask_bias {tuple(mask_bias.shape)}"
        )
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if not (emb.device == queries.device == mask_bias.device):
        raise ValueError("emb, queries and mask_bias must share a device")


def topk_scan(emb, queries, mask_bias, k):
    """Launch the CUDA kernel and merge its chunk lists (CUDA only)."""
    n, d = emb.shape
    nq = queries.shape[0]
    if emb.dtype != torch.bfloat16:
        raise TypeError(f"emb must be bfloat16, got {emb.dtype}")
    if queries.dtype != torch.float32 or mask_bias.dtype != torch.float32:
        raise TypeError("queries and mask_bias must be float32")
    for name, t in (("emb", emb), ("queries", queries),
                    ("mask_bias", mask_bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if d % 8:
        raise ValueError(f"d must be a multiple of 8, got {d}")
    n_chunks = -(-n // CHUNK_ROWS)
    if n_chunks > 65535 or nq == 0:
        raise ValueError(f"unsupported shape N={n}, Q={nq}")
    part_vals = torch.empty((nq, n_chunks, k), dtype=torch.float32,
                            device=emb.device)
    part_rows = torch.empty((nq, n_chunks, k), dtype=torch.int32,
                            device=emb.device)
    lib = _lib()
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = lib.topk_scan_launch(
            emb.data_ptr(), queries.data_ptr(), mask_bias.data_ptr(),
            part_vals.data_ptr(), part_rows.data_ptr(),
            n, d, nq, k, n_chunks, stream,
        )
    if err != 0:
        raise RuntimeError(f"topk_scan launch failed: cudaError {err}")
    LAUNCHES["topk_scan"] += 1
    # Merge: chunk lists ascend by row at equal scores and chunks ascend
    # by row, so a stable sort keeps lowest-row-first; never-filled slots
    # (NEG_INF, -1) exist only in the last chunk and so sort last.
    vals, pos = stable_topk(part_vals.view(nq, n_chunks * k), k)
    rows = part_rows.view(nq, n_chunks * k).gather(1, pos)
    return vals, rows


def masked_topk(
    emb: torch.Tensor,
    queries: torch.Tensor,
    mask_bias: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals [Q, k] f32, rows [Q, k] i32) of the masked dense scan.

    On the CPU: the plain version. On CUDA: the hand-written kernel, or
    an error — there is no fallback."""
    _check(emb, queries, mask_bias, k)
    if emb.device.type == "cpu":
        return topk_reference(emb, queries, mask_bias, k)
    if emb.device.type != "cuda":
        raise ValueError(f"unsupported device {emb.device}")
    return topk_scan(emb, queries, mask_bias, k)
