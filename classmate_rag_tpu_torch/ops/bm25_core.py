"""BM25's approx-route core on the card: the Okapi saturation computed from
the u8 head matrix and multiplied on the tensor cores, and the sparse tail
added in, in one kernel (``csrc/bm25_sat_gemm.cu``).

    scores[b, n] = keep[n] · Σ_k bf16(w[b, k]) · bf16(sat(tf[k, n]) · [tf > 0] · keep[n])

with f32 sums, k over the batch's head slots and its tail terms: what
``lexical.bm25_split_score_core(fast=True)`` computes, with the products
summed in another order. Pieces:

- ``query_weights``: w [B, H + T] bf16, the head's weights then the
  tail's (``lexical.split_query_weights``, then one bf16 cast).
- ``tail_postings``: the batch's tail postings (row, tail term column,
  tf) from the posting windows, sorted by 128-row tile, with each tile's
  offsets: plain torch ops on either device.
- ``sat_operand`` / ``sat_gemm_reference``: the plain version of the
  kernel on its own operands (the head rows by slot and the tail's
  postings as a dense term-major matrix, the saturation rounded to bf16,
  an f32 matmul of the upcast operands). The CPU path, and the yardstick
  the kernel is held against on the card.
- ``sat_gemm``: the wrapper. CPU tensors take the plain version; CUDA
  tensors launch the kernel or raise.
- ``fast_scores``: the core from the fused step's arrays (weights, tail
  postings, product), which ``bm25_split_score_core`` runs on CUDA.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from classmate_rag_tpu_torch.index import lexical
from classmate_rag_tpu_torch.ops import _build
from classmate_rag_tpu_torch.ops.topk import _on

# Launches of the kernel, counted where the wrapper launches it.
LAUNCHES = {"bm25_sat_gemm": 0}

# Corpus rows a tail tile holds: the kernel's rows a block
# (``bm25_sat_gemm_block_rows()``, checked when the library loads).
TILE_ROWS = 128


class TailPostings(NamedTuple):
    """The batch's live tail postings sorted by TILE_ROWS-row tile (list
    order within a tile): entry e is row ``rows[e]``, tail term column
    ``cols[e]`` (index into ``t_tids``), ``tfs[e]``; tile x's entries are
    ``off[x]`` .. ``off[x + 1] - 1`` (int32 [ceil(N / TILE_ROWS) + 1]).
    Every array is int32; ``rows``, ``cols`` and ``tfs`` also hold the dead
    window slots, past ``off[-1]``."""
    rows: torch.Tensor
    cols: torch.Tensor
    tfs: torch.Tensor
    off: torch.Tensor


def query_weights(idf, h_tids, t_tids, q_tids, q_counts, vocab_pad: int):
    """w [B, H + T] bf16: each query's head weights, then its tail
    weights, rounded to bf16 once."""
    w_head, w_tail = lexical.split_query_weights(
        idf, h_tids, t_tids, q_tids, q_counts, vocab_pad)
    return torch.cat((w_head, w_tail), 1).to(torch.bfloat16)


def tail_postings(post_rows, post_tfs, u_starts, u_lens, u_cols, n: int,
                  r_cap: int) -> TailPostings:
    """The batch's tail postings from its windows (segment u covers
    postings clamp(u_starts[u], 0, P - r_cap) + [0, u_lens[u]) of term
    column u_cols[u], as ``lexical.tail_tf_matrix`` reads them), those with
    tf > 0 only, stably sorted by row // TILE_ROWS. A (row, term) pair has
    one live posting at most (a row's terms are distinct; an overlay
    entry's base posting reads 0), so a posting is the pair's whole tf.
    No host reads: the dead slots sort last."""
    dev = post_rows.device
    p = post_rows.shape[0]
    starts = torch.clamp(u_starts.long(), 0, max(p - r_cap, 0))
    r_iota = torch.arange(r_cap, device=dev)
    pos = (starts[:, None] + r_iota[None, :]).reshape(-1)
    rows = post_rows[pos]
    tfs = post_tfs[pos].int()
    cols = u_cols.int()[:, None].expand(-1, r_cap).reshape(-1)
    live = ((r_iota[None, :] < u_lens[:, None]).reshape(-1) & (cols >= 0)
            & (tfs > 0))
    tiles = -(-n // TILE_ROWS)
    key = torch.where(live, torch.div(rows, TILE_ROWS, rounding_mode="floor"),
                      tiles).int()
    key, order = torch.sort(key, stable=True)
    off = torch.searchsorted(
        key, torch.arange(tiles + 1, device=dev, dtype=torch.int32)).int()
    return TailPostings(rows[order].int(), cols[order], tfs[order], off)


def tail_matrix(tail: TailPostings, t: int, n: int):
    """The live postings as a dense u8 [t, n] term-major tf matrix."""
    end = tail.off[-1].long()
    live = torch.arange(tail.rows.shape[0], device=tail.rows.device) < end
    at = torch.where(live, tail.cols.long() * n + tail.rows.long(), t * n)
    out = torch.zeros(t * n + 1, dtype=torch.int32, device=tail.rows.device)
    out.index_add_(0, at, torch.where(live, tail.tfs, 0))
    return out[:-1].view(t, n).to(torch.uint8)


def sat_operand(tf, doc_len, keep, avgdl):
    """The kernel's A operand, plain: bf16 [K, N] of the saturation of
    ``tf`` u8 [K, N] (``lexical.okapi_sat`` in f32) masked by tf > 0 and
    ``keep``, as the plain core rounds its saturation matrices."""
    sat = lexical.okapi_sat(tf, doc_len[None, :], avgdl)
    return (sat * (tf > 0) * keep[None, :]).to(torch.bfloat16)


def sat_gemm_reference(tf_head, h_slots, tail: TailPostings, doc_len, keep,
                       avgdl, w):
    """Plain version of the kernel: scores [B, N] f32 =
    (w.float() @ sat.float()) * keep, sat the ``sat_operand`` of the head
    rows ``tf_head[h_slots]`` (padding slots read as zero rows) and then
    of the tail's postings as a dense matrix."""
    n, h = tf_head.shape[1], h_slots.shape[0]
    head = tf_head[torch.clamp(h_slots, min=0).long()] * (h_slots >= 0)[:, None]
    rows = torch.cat((head, tail_matrix(tail, w.shape[1] - h, n)), 0)
    sat = sat_operand(rows, doc_len, keep, avgdl)
    return (w.float() @ sat.float()) * keep[None, :]


def _lib() -> ctypes.CDLL:
    lib = _build.load("bm25_sat_gemm")
    if lib.bm25_sat_gemm_launch.argtypes is None:
        # Declared, or ctypes passes each pointer as a 32-bit int.
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bm25_sat_gemm_launch.argtypes = [
            ptr, i64, ptr, i32, ptr, ptr, ptr, i32, i32, ptr, ptr, ptr, ptr,
            ptr, i32, i32, ptr]
        lib.bm25_sat_gemm_k1.restype = ctypes.c_float
        lib.bm25_sat_gemm_b.restype = ctypes.c_float
        if ((lib.bm25_sat_gemm_k1(), lib.bm25_sat_gemm_b(),
             lib.bm25_sat_gemm_block_rows())
                != (lexical.K1, lexical.B, TILE_ROWS)):
            raise RuntimeError("bm25_sat_gemm.cu's Okapi constants or tile "
                               "differ from ops/bm25_core.py's")
    return lib


def _check(tf_head, h_slots, tail, doc_len, keep, avgdl, w):
    if tf_head.dim() != 2 or tf_head.dtype != torch.uint8:
        raise TypeError("tf_head must be uint8 [C, N]")
    n = tf_head.shape[1]
    if n == 0:
        raise ValueError("empty corpus")
    if h_slots.dim() != 1 or h_slots.dtype != torch.int32:
        raise TypeError("h_slots must be an int32 vector")
    if any(x.dim() != 1 or x.dtype != torch.int32 for x in tail):
        raise TypeError("the tail's postings must be int32 vectors")
    if not tail.rows.shape == tail.cols.shape == tail.tfs.shape:
        raise ValueError("the tail's rows, cols and tfs must have one length")
    if tail.off.shape != (-(-n // TILE_ROWS) + 1,):
        raise ValueError(f"the tail's offsets must be [ceil(N / "
                         f"{TILE_ROWS}) + 1], got {tuple(tail.off.shape)}")
    if doc_len.shape != (n,) or doc_len.dtype != torch.float32:
        raise ValueError("doc_len must be float32 [N]")
    if keep.shape != (n,) or keep.dtype != torch.bool:
        raise ValueError("keep must be bool [N]")
    if avgdl.numel() != 1 or avgdl.dtype != torch.float32:
        raise ValueError("avgdl must be one float32")
    h = h_slots.shape[0]
    if w.dim() != 2 or w.dtype != torch.bfloat16 or w.shape[1] < h:
        raise ValueError(f"w must be bfloat16 [B, H + T] with H = {h}, got "
                         f"{tuple(w.shape)} {w.dtype}")
    if w.shape[0] == 0:
        raise ValueError("no queries")
    devs = {x.device for x in (tf_head, h_slots, *tail, doc_len, keep, avgdl,
                               w)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{sorted(map(str, devs))}")
    return devs.pop()


def sat_gemm(tf_head, h_slots, tail: TailPostings, doc_len, keep, avgdl, w):
    """scores [B, N] f32 of the head rows ``h_slots`` of ``tf_head``
    [C, N] u8 and the tail's postings ``tail`` (``tail_postings``) under
    the weights ``w`` [B, H + T] bf16, for rows ``doc_len`` [N] f32 /
    ``keep`` [N] bool and ``avgdl`` (one f32, on the same device: the
    plain version divides by it as a tensor).

    On the CPU: the plain version, ``sat_gemm_reference``. On CUDA: the
    kernel, which reads each head tf byte once and writes the scores once,
    or an error; there is no fallback."""
    dev = _check(tf_head, h_slots, tail, doc_len, keep, avgdl, w)
    if dev.type == "cpu":
        return sat_gemm_reference(tf_head, h_slots, tail, doc_len, keep,
                                  avgdl, w)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    h, ldw = h_slots.shape[0], w.shape[1]
    if h % 8 or ldw % 8:
        raise ValueError(f"H={h} and H + T={ldw} must be multiples of 8")
    for name, x in (("tf_head", tf_head), ("h_slots", h_slots),
                    ("doc_len", doc_len), ("keep", keep), ("w", w),
                    *zip(TailPostings._fields, tail)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if w.data_ptr() % 16:
        raise ValueError("w must be 16-byte aligned")
    b, n = w.shape[0], tf_head.shape[1]
    if n >= 2 ** 31 or b * n >= 2 ** 62:
        raise ValueError(f"[B={b}, N={n}] too large")
    vec = int(n % 16 == 0 and tf_head.data_ptr() % 16 == 0)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    with _on(dev):
        # The saturation's length term with the plain version's own ops.
        term = lexical.okapi_len_term(doc_len, avgdl.reshape(()))
        err = _lib().bm25_sat_gemm_launch(
            tf_head.data_ptr(), n, h_slots.data_ptr(), h, term.data_ptr(),
            keep.data_ptr(), w.data_ptr(), ldw, b, tail.rows.data_ptr(),
            tail.cols.data_ptr(), tail.tfs.data_ptr(), tail.off.data_ptr(),
            out.data_ptr(), n, vec, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bm25_sat_gemm launch failed: cudaError {err}")
    LAUNCHES["bm25_sat_gemm"] += 1
    return out


def fast_scores(tf_head, post_rows, post_tfs, doc_len, keep, idf, avgdl,
                h_slots, h_tids, u_starts, u_lens, u_cols, t_tids, q_tids,
                q_counts, *, vocab_pad: int, r_cap: int):
    """The approx route's BM25 scores [B, N] from the fused step's arrays
    (``bm25_split_score_core``'s arguments): the weights, the tail's
    postings, then ``sat_gemm``."""
    w = query_weights(idf, h_tids, t_tids, q_tids, q_counts, vocab_pad)
    tail = tail_postings(post_rows, post_tfs, u_starts, u_lens, u_cols,
                         tf_head.shape[1], r_cap)
    return sat_gemm(tf_head, h_slots, tail, doc_len, keep, avgdl, w)
