"""Masked exact-scan dense scoring with fused top-k (port of the JAX
package's ``ops/topk.py``).

``scores = q·Eᵀ + mask_bias`` over a bf16 corpus with f32 sums, and for
each query the k best rows, ties to the LOWEST row. Four pieces:

- ``topk_reference``: the plain PyTorch version (one f32 matmul of the
  bf16-rounded operands, a stable descending sort, the first k). The CPU
  path, and the yardstick the kernel is held against on the card.
- the CUDA kernels ``csrc/topk_scan.cu`` (replace the TPU kernel
  ``classmate_rag_tpu/ops/topk.py::topk_pallas``): the scan, in which
  each block walks one contiguous corpus slice with running top-k lists
  per query and writes them out, the [Q, N] score matrix never; then a
  merge of those lists into each query's top-k. ``slice_geometry`` cuts
  the corpus into the slices; ``merge_partials`` is the merge's plain
  version.
- ``masked_topk``: the wrapper. CPU tensors take the plain version; CUDA
  tensors launch the kernel or raise.

``torch.topk`` makes no promise about which of several equal values it
returns, so every selection here is a stable sort.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Tuple

import torch

from classmate_rag_tpu_torch.ops import _build
from classmate_rag_tpu_torch.utils.numerics import NEG_INF

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"topk_scan": 0, "topk_merge": 0}

# The largest k ``masked_topk`` takes, on either device (the kernel's
# own limit, ``topk_scan_max_k()``, is checked against it at launch).
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


def slice_geometry(n: int, query_blocks: int, *, tile_rows: int,
                   resident_blocks: int) -> Tuple[int, int]:
    """(n_slices, slice_rows) of the scan's grid over an N-row corpus.

    The grid is (query blocks) × (slices); slices are whole tiles, so
    every slice but the last holds ``slice_rows`` rows and the last the
    rest (never none). As many slices as let the whole grid be resident
    at once (one wave), each walked by one block per query block."""
    if n <= 0 or query_blocks <= 0:
        raise ValueError(f"empty scan: N={n}, query blocks={query_blocks}")
    tiles = -(-n // tile_rows)
    per_wave = max(1, resident_blocks // query_blocks)
    tiles_per_slice = -(-tiles // min(per_wave, tiles, 65535))
    slice_rows = tiles_per_slice * tile_rows
    return -(-n // slice_rows), slice_rows


def merge_partials(
    part_vals: torch.Tensor,   # [Q, L, k] f32, each list (score desc, row asc)
    part_rows: torch.Tensor,   # [Q, L, k] i32
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best of a scan's lists, (score desc, row asc): the plain
    version of the merge kernel.

    The lists hold distinct rows in any order of lists. A never-filled
    slot is (-inf, -1): below every real score, masked ones (NEG_INF)
    included, and it comes out as (NEG_INF, -1)."""
    nq = part_vals.shape[0]
    vals = part_vals.reshape(nq, -1)
    rows = part_rows.reshape(nq, -1)
    order = lexsort_desc(
        vals, torch.where(rows < 0, torch.iinfo(torch.int32).max, rows)
    )[:, :k]
    return vals.gather(1, order).clamp_min(NEG_INF), rows.gather(1, order)


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk_scan")
    if lib.topk_scan_launch.argtypes is None:
        # Declared, or ctypes passes each pointer as a 32-bit int.
        lib.topk_scan_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.topk_merge_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
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


_plans: Dict[Tuple[int, int, int, int, int], Tuple[int, int, int]] = {}


def _plan(n: int, nq: int, d: int, k: int,
          device: torch.device) -> Tuple[int, int, int]:
    """(n_slices, slice_rows, lists) of a launch on ``device``: the tile,
    the query block, the resident blocks and the lists a slice come from
    the library."""
    key = (device.index or 0, n, nq, d, k)
    plan = _plans.get(key)
    if plan is None:
        lib = _lib()
        if k > lib.topk_scan_max_k():
            raise ValueError(
                f"k={k} above the kernel's {lib.topk_scan_max_k()}")
        with torch.cuda.device(device):
            resident = lib.topk_scan_resident_blocks(d, k)
            per_slice = lib.topk_scan_lists_per_slice(d, k)
        if resident <= 0:
            raise ValueError(
                f"d={d}, k={k}: the resident queries, the tile ring and the "
                "lists need more shared memory than a block has"
            )
        n_slices, slice_rows = slice_geometry(
            n, -(-nq // lib.topk_scan_block_queries()),
            tile_rows=lib.topk_scan_tile_rows(), resident_blocks=resident)
        plan = _plans[key] = (n_slices, slice_rows, n_slices * per_slice)
    return plan


def kernel_slices(n: int, nq: int, d: int, k: int,
                  device: torch.device) -> Tuple[int, int]:
    """(n_slices, slice_rows) the kernel runs with on ``device``."""
    return _plan(n, nq, d, k, device)[:2]


def _on(device: torch.device):
    """The device's context, or none if it is already the current one."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def scan_partials(emb, queries, mask_bias, k):
    """Launch the scan kernel once (CUDA only): (part_vals, part_rows)
    [Q, L, k], the sorted lists of each query (one or two a corpus
    slice), and bounds [Q] (each query's bound on its k-th score, which
    the merge uses)."""
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
    if nq == 0:
        raise ValueError("no queries")
    n_slices, slice_rows, lists = _plan(n, nq, d, k, emb.device)
    # One allocation: the lists' scores and rows, then the bounds and
    # pools the blocks share (zeroed by the launch).
    size = nq * lists * k
    scratch = torch.empty(
        2 * size + _lib().topk_scan_scratch_words(nq, n_slices),
        dtype=torch.int32, device=emb.device)
    part_vals = scratch[:size].view(torch.float32).view(nq, lists, k)
    part_rows = scratch[size:2 * size].view(nq, lists, k)
    bounds = scratch[2 * size:]
    with _on(emb.device):
        err = _lib().topk_scan_launch(
            emb.data_ptr(), queries.data_ptr(), mask_bias.data_ptr(),
            part_vals.data_ptr(), part_rows.data_ptr(), bounds.data_ptr(),
            n, d, nq, k, n_slices, slice_rows,
            torch.cuda.current_stream(emb.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"topk_scan launch failed: cudaError {err}")
    LAUNCHES["topk_scan"] += 1
    return part_vals, part_rows, bounds


def merge_slices(part_vals, part_rows, bounds, k):
    """A scan's lists -> (vals [Q, k], rows [Q, k]) with the merge
    kernel (CUDA only); ``merge_partials`` is its plain version."""
    nq, lists, _ = part_vals.shape
    vals = torch.empty((nq, k), dtype=torch.float32, device=part_vals.device)
    rows = torch.empty((nq, k), dtype=torch.int32, device=part_vals.device)
    with _on(part_vals.device):
        err = _lib().topk_merge_launch(
            part_vals.data_ptr(), part_rows.data_ptr(), bounds.data_ptr(),
            vals.data_ptr(), rows.data_ptr(), nq, lists, k,
            torch.cuda.current_stream(part_vals.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"topk_merge launch failed: cudaError {err}")
    LAUNCHES["topk_merge"] += 1
    return vals, rows


def topk_scan(emb, queries, mask_bias, k):
    """The scan kernel, then the merge kernel (CUDA only)."""
    return merge_slices(*scan_partials(emb, queries, mask_bias, k), k)


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
