"""Shard-parallel hybrid retrieval over a list of devices (port of the JAX
package's ``parallel/sharded.py``).

Corpus rows shard across devices: every shard scans only its rows, and
the small per-shard top-k results (values, global row ids, candidate
embeddings) meet on the merge device (the mesh's first) for one merge.
The JAX package runs the body under ``shard_map``; here one process walks
the shards:

- shard-local work runs on each shard's device, under its device
  context (the dense scan is ``ops/topk.masked_topk``: the scan and merge
  kernels on CUDA);
- ``all_gather`` is a ``torch.stack`` of the shards' results copied to
  the merge device (``non_blocking``; no host sync per shard);
- ``psum`` is a sum on the merge device, and what derives from it (idf,
  avgdl) is copied back to the shards' devices.

A mesh may span processes (``RankDevice`` entries, see
``parallel/multihost.py``): each process then runs only its own shards,
and ``all_gather`` also exchanges the local stacks between processes
(``multihost.exchange``) and lays the blocks out by global shard index,
so every process merges the same [S, ...] tensors under the same tie
rule and returns the same, replicated result.

Two BM25 formulations share the subset-statistics prologue and the merge
epilogue: ``make_sharded_hybrid_fn`` (the gather pass over the packed
[N_local, L] term matrix) and ``make_sharded_split_hybrid_fn`` (the
split-frequency form the serving engine runs: head matrix sharded by
columns, tail postings pre-partitioned by shard with shard-local row ids,
see ``index/lexical.shard_postings`` / ``shard_tail_ranges``).

Arguments: a sharded array is a sequence with one block per shard (a
list of tensors, or an [S, ...] array indexed by shard), each block on
its shard's device (None, or anything, for a shard another process
owns). A replicated array is one tensor or numpy array,
copied once to each distinct device that needs it.

Merges re-sort by (value desc, global row asc), the single-device
tie rule, so rows equal the single-device step's wherever each shard
computes its rows' scores as the whole corpus's step does
(tests/test_torch_parallel.py). The subset length sum is exact
(``lexical.subset_sums``), so avgdl does not depend on the shard count.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, NamedTuple, Sequence

import torch

from classmate_rag_tpu_torch.index.lexical import (
    bm25_split_score_core,
    okapi_idf,
    okapi_query_weights,
    okapi_score_rows,
    okapi_subset,
    subset_df,
    subset_sums,
)
from classmate_rag_tpu_torch.ops.fusion import rrf_merge
from classmate_rag_tpu_torch.ops.hybrid_step import (
    bm25_finish,
    bm25_select,
    dense_pool_order,
)
from classmate_rag_tpu_torch.ops.topk import lexsort_desc, masked_topk
from classmate_rag_tpu_torch.parallel.mesh import RankDevice, corpus_mesh
from classmate_rag_tpu_torch.parallel.multihost import (
    exchange,
    process_count,
    process_index,
)
from classmate_rag_tpu_torch.utils.numerics import NEG_INF

# Global row id of a dead merge entry (masked, or padding): above every
# real row, so (value, row) order puts it last among equal values. Dead
# entries never leave the merge as rows (the port's rows pad with -1).
_NO_ROW = 2**30


class ShardedHybridResult(NamedTuple):
    rows: torch.Tensor        # [B, top_k] int32, -1 padded
    fused: torch.Tensor       # [B, top_k] f32
    vec_dist: torch.Tensor    # [B, top_k] f32 (NaN where dense didn't return)
    bm25_score: torch.Tensor  # [B, top_k] f32 (NaN where bm25 didn't return)


def _device_ctx(device: torch.device):
    """The device's context for the launches of one shard."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _Replicas:
    """A replicated input: copied to a device at its first use there."""

    def __init__(self, x) -> None:
        self._x = torch.as_tensor(x)
        self._on: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = self._x.to(device, non_blocking=True)
        return t


class MeshShards:
    """A corpus mesh as this process sees it: each shard's device, the
    shards this process runs (``local``), the merge device, and the
    gather that brings every shard's result there.

    Over devices (one process) every shard is local. Over ``RankDevice``s
    spanning the process group, each process owns its rank's shards
    (every process as many); the gather stacks the local results,
    exchanges the stacks and orders the blocks by global shard index."""

    def __init__(self, mesh) -> None:
        entries = corpus_mesh(devices=mesh)
        ranked = [e for e in entries if isinstance(e, RankDevice)]
        self.n_shards = len(entries)
        self.cross = False
        self._perm = None
        if not ranked:
            self.devices = list(entries)
            self.owned = list(range(self.n_shards))
        elif len(ranked) != len(entries):
            raise ValueError("a mesh mixes RankDevices and devices")
        else:
            self.devices = [e.device for e in ranked]
            world = process_count()
            by_rank = [[s for s, e in enumerate(ranked) if e.rank == r]
                       for r in range(world)]
            if sum(map(len, by_rank)) != self.n_shards:
                raise ValueError(
                    f"mesh ranks {sorted({e.rank for e in ranked})} "
                    f"outside the {world}-process group"
                )
            if len({len(b) for b in by_rank}) != 1:
                raise ValueError(
                    "every process must own as many shards, got "
                    f"{[len(b) for b in by_rank]}"
                )
            self.owned = by_rank[process_index()]
            self.cross = world > 1
            order = [s for b in by_rank for s in b]
            if order != sorted(order):
                self._perm = torch.as_tensor(
                    sorted(range(len(order)), key=order.__getitem__)
                )
        self.merge = self.devices[self.owned[0]]
        # Bytes this process received from the others in all gathers.
        self.bytes_exchanged = 0

    @property
    def local(self) -> List:
        """(global shard index, device) of every shard run here."""
        return [(s, self.devices[s]) for s in self.owned]

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """``all_gather``: the local shards' results (in ``local``
        order) → every shard's, stacked [S, ...] on the merge device."""
        out = torch.stack([p.to(self.merge, non_blocking=True)
                           for p in parts])
        if not self.cross:
            return out
        mine = out.numel() * out.element_size()
        out = exchange(out)
        self.bytes_exchanged += out.numel() * out.element_size() - mine
        if self._perm is not None:
            out = out.index_select(0, self._perm.to(out.device))
        return out


def as_shards(mesh) -> MeshShards:
    """``mesh`` (devices, ``RankDevice``s or a ``MeshShards``) as a
    ``MeshShards``."""
    return mesh if isinstance(mesh, MeshShards) else MeshShards(mesh)


def _blocks(x, sh: MeshShards) -> List:
    """One block per shard (None for another process's), each local one
    moved to its shard's device."""
    out: List = [None] * sh.n_shards
    for s, d in sh.local:
        out[s] = torch.as_tensor(x[s]).to(d)
    return out


def _merge_ranked(vals, idx, k):
    """Merge gathered ranked lists [S, B, k'] → the global top-k by
    (value desc, global row asc), the single-device tie rule. Emits
    exactly k columns, padded with (NEG_INF, _NO_ROW) when S·k' < k (the
    per-shard lists then already hold every row). Also returns each
    pick's position in the flattened [B, S·k'] lists."""
    s, b, kk = vals.shape
    flat_v = vals.transpose(0, 1).reshape(b, s * kk)
    flat_i = idx.transpose(0, 1).reshape(b, s * kk)
    if s * kk < k:
        pad = k - s * kk
        flat_v = torch.nn.functional.pad(flat_v, (0, pad), value=NEG_INF)
        flat_i = torch.nn.functional.pad(flat_i, (0, pad), value=_NO_ROW)
    order = lexsort_desc(flat_v, flat_i)[:, :k]
    return flat_v.gather(1, order), flat_i.gather(1, order), order


def _dense_sharded(sh, emb, mask_bias, q_vecs, *, k_vector, pool,
                   use_mmr, mmr_lambda, emb16=None, rescore_pool=64):
    """Each shard's masked scan → gathered pools → one merged pool →
    (vec_rows, vec_dist) [B, kv] on the merge device.

    Every shard selects ``sel`` rows, so the merged pool is the whole
    corpus's top ``merge_k``: the single-device step's pool, rows and
    values alike (the scan kernel is exact on both selection routes).
    With ``emb16`` the candidates carry their f16 master rows and the
    merged pool is f16-rescored as the single-device step rescores it.
    The merged candidates' embeddings are picked by the merge's own
    positions (the JAX package matches ids over a [B, merge_k, S·sel]
    mask)."""
    n_local = emb[sh.owned[0]].shape[0]
    pool_eff = min(pool if use_mmr else k_vector, n_local)
    sel = pool_eff if emb16 is None else min(
        max(rescore_pool, pool_eff), n_local
    )
    vals, rows, cands = [], [], []
    for s, dev in sh.local:
        with _device_ctx(dev):
            lv, li = masked_topk(
                emb[s], q_vecs.on(dev).float().contiguous(), mask_bias[s],
                sel,
            )
            li = li.long()
            src = emb[s] if emb16 is None else emb16[s]
            cands.append(src[torch.clamp(li, min=0)])       # [B, sel, d]
            rows.append(torch.where(lv > NEG_INF / 2, li + s * n_local,
                                    _NO_ROW))
            vals.append(lv)
    av, ai, ae = (sh.gather(x) for x in (vals, rows, cands))
    n_cand = sh.n_shards * sel
    pool_target = min(pool if use_mmr else k_vector, n_cand)
    merge_k = pool_target if emb16 is None else min(
        max(rescore_pool, pool_target), n_cand
    )
    mv, mi, pos = _merge_ranked(av, ai, merge_k)
    flat_e = ae.transpose(0, 1).reshape(av.shape[1], n_cand, -1)
    me = flat_e.gather(1, pos[:, :, None].expand(-1, -1, flat_e.shape[2]))
    return dense_pool_order(
        q_vecs.on(sh.merge), mi, mv, me, pool=pool_target, k_vector=k_vector,
        use_mmr=use_mmr, mmr_lambda=mmr_lambda, rescore=emb16 is not None,
    )


def _subset_stats_sharded(sh, mask_bias, doc_len, term_ids=None,
                          tfs=None, vocab_pad=None):
    """(keeps, n_sub, avgdl[, df]) of the kept rows of every shard: each
    shard's exact counts and length sum, summed on the merge device. With
    ``term_ids``/``tfs`` also the subset df (integer counts, exact)."""
    keeps: List = [None] * sh.n_shards
    n_kept, dl_sum, dfs = [], [], []
    for s, dev in sh.local:
        with _device_ctx(dev):
            keep, n, dl = subset_sums(mask_bias[s], doc_len[s])
            keeps[s] = keep
            n_kept.append(n)
            dl_sum.append(dl)
            if term_ids is not None:
                dfs.append(subset_df(term_ids[s], tfs[s], keep, vocab_pad))
    n_sub, avgdl = okapi_subset(sh.gather(n_kept).sum(),
                                sh.gather(dl_sum).sum())
    df = sh.gather(dfs).sum(0) if dfs else None
    return keeps, n_sub, avgdl, df


def _bm25_merge_sharded(sh, scores, mask_bias, has_terms, *, k_bm25,
                        select="exact", rescore_ctx=None):
    """Shard-local BM25 scores [B, N_local] → merged (bm_rows, bm_vals)
    [B, k_bm25] on the merge device.

    approx: each shard takes its wider pool and, with ``rescore_ctx``
    (per shard: term_ids, tfs, doc_len, avgdl, idf, q_tids, q_counts),
    rescores it exactly before its local cut, as the JAX package does."""
    vals, rows = [], []
    for s, dev in sh.local:
        with _device_ctx(dev):
            n_local = scores[s].shape[1]
            bv, bi = bm25_select(
                scores[s] + mask_bias[s][None, :], k_bm25, select=select,
                rescore_ctx=None if rescore_ctx is None else rescore_ctx[s],
            )
            vals.append(bv)
            rows.append(torch.where(bv > NEG_INF / 2, bi + s * n_local,
                                    _NO_ROW))
    mbv, mbi, _ = _merge_ranked(sh.gather(vals), sh.gather(rows), k_bm25)
    return bm25_finish(mbv, mbi, has_terms.on(sh.merge))


def _fuse_replicated(vec_rows, vec_dist, bm_rows, bm_vals, *, weight_vector,
                     weight_bm25, rrf_k, top_k) -> ShardedHybridResult:
    rows, fused, vdist, bscore = rrf_merge(
        vec_rows, bm_rows, vec_dist, bm_vals,
        weight_vector, weight_bm25, rrf_k, top_k,
    )
    return ShardedHybridResult(rows.to(torch.int32), fused, vdist, bscore)


def _hybrid_step(sh, emb, term_ids, tfs, doc_len, mask_bias, q_vecs,
                 q_terms, q_counts, *, k_vector, k_bm25, top_k, pool,
                 vocab_pad, use_mmr, mmr_lambda, rrf_k, weight_vector,
                 weight_bm25):
    q_vecs, q_terms, q_counts = (
        _Replicas(x) for x in (q_vecs, q_terms, q_counts)
    )
    vec_rows, vec_dist = _dense_sharded(
        sh, emb, mask_bias, q_vecs, k_vector=k_vector, pool=pool,
        use_mmr=use_mmr, mmr_lambda=mmr_lambda,
    )
    _keeps, n_sub, avgdl, df = _subset_stats_sharded(
        sh, mask_bias, doc_len, term_ids, tfs, vocab_pad
    )
    idf, avgdl = _Replicas(okapi_idf(df, n_sub)), _Replicas(avgdl)
    scores: List = [None] * sh.n_shards
    for s, dev in sh.local:
        with _device_ctx(dev):
            w = okapi_query_weights(idf.on(dev), q_terms.on(dev),
                                    q_counts.on(dev), vocab_pad)
            scores[s] = okapi_score_rows(term_ids[s], tfs[s], doc_len[s],
                                         avgdl.on(dev), w, vocab_pad)
    has_terms = _Replicas(torch.any(q_terms.on(sh.merge) >= 0, dim=1,
                                    keepdim=True))
    bm_rows, bm_vals = _bm25_merge_sharded(
        sh, scores, mask_bias, has_terms, k_bm25=k_bm25
    )
    return _fuse_replicated(
        vec_rows, vec_dist, bm_rows, bm_vals, weight_vector=weight_vector,
        weight_bm25=weight_bm25, rrf_k=rrf_k, top_k=top_k,
    )


def make_sharded_hybrid_fn(
    mesh,
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
):
    """The hybrid query step over ``mesh`` with the gather-pass BM25 (the
    parity path). Returns ``fn(emb, term_ids, tfs, doc_len, mask_bias,
    q_vecs, q_terms, q_counts)``: the first five sharded by rows (emb
    [N_local, d] bf16, term_ids/tfs [N_local, L], doc_len/mask_bias
    [N_local] a shard), the rest replicated ([B, d] f32, [B, M] i32,
    [B, M] f32). ``mesh``: devices, ``RankDevice``s over the process
    group, or a ``MeshShards``. The result lies on the merge device (the
    first local shard's), on every process."""
    return functools.partial(
        _hybrid_step, as_shards(mesh), k_vector=k_vector, k_bm25=k_bm25,
        top_k=top_k, pool=pool, vocab_pad=vocab_pad, use_mmr=use_mmr,
        mmr_lambda=mmr_lambda, rrf_k=rrf_k, weight_vector=weight_vector,
        weight_bm25=weight_bm25,
    )


def _split_hybrid_step(sh, emb, term_ids, tfs, tf_head, post_rows_sh,
                       post_tfs_sh, doc_len, mask_bias, q_vecs, h_slots,
                       h_tids, u_starts_sh, u_lens_sh, u_cols, t_tids,
                       q_tids, q_counts, has_terms, df=None, emb16=None, *,
                       r_cap, k_vector, k_bm25, top_k, pool, vocab_pad,
                       use_mmr, mmr_lambda, rrf_k, weight_vector,
                       weight_bm25, rescore_pool, select):
    rep = {
        name: _Replicas(x) for name, x in (
            ("q_vecs", q_vecs), ("h_slots", h_slots), ("h_tids", h_tids),
            ("u_cols", u_cols), ("t_tids", t_tids), ("q_tids", q_tids),
            ("q_counts", q_counts), ("has_terms", has_terms),
        )
    }
    post_rows_sh, post_tfs_sh, u_starts_sh, u_lens_sh = (
        _blocks(x, sh) for x in (post_rows_sh, post_tfs_sh, u_starts_sh,
                                   u_lens_sh)
    )
    vec_rows, vec_dist = _dense_sharded(
        sh, emb, mask_bias, rep["q_vecs"], k_vector=k_vector, pool=pool,
        use_mmr=use_mmr, mmr_lambda=mmr_lambda, emb16=emb16,
        rescore_pool=rescore_pool,
    )
    if df is None:
        keeps, n_sub, avgdl, df = _subset_stats_sharded(
            sh, mask_bias, doc_len, term_ids, tfs, vocab_pad
        )
    else:
        keeps, n_sub, avgdl, _ = _subset_stats_sharded(
            sh, mask_bias, doc_len
        )
        df = torch.as_tensor(df).to(sh.merge)
    idf, avgdl = _Replicas(okapi_idf(df, n_sub)), _Replicas(avgdl)
    fast = select == "approx"
    scores: List = [None] * sh.n_shards
    rescore_ctx: List = [None] * sh.n_shards
    for s, dev in sh.local:
        with _device_ctx(dev):
            r = {k: v.on(dev) for k, v in rep.items()}
            scores[s] = bm25_split_score_core(
                tf_head[s], post_rows_sh[s], post_tfs_sh[s], doc_len[s],
                keeps[s], idf.on(dev), avgdl.on(dev),
                r["h_slots"], r["h_tids"], u_starts_sh[s], u_lens_sh[s],
                r["u_cols"], r["t_tids"], r["q_tids"], r["q_counts"],
                vocab_pad=vocab_pad, r_cap=r_cap, fast=fast,
            )
            rescore_ctx[s] = (
                term_ids[s], tfs[s], doc_len[s], avgdl.on(dev),
                idf.on(dev), r["q_tids"], r["q_counts"],
            )
    bm_rows, bm_vals = _bm25_merge_sharded(
        sh, scores, mask_bias, rep["has_terms"], k_bm25=k_bm25,
        select=select, rescore_ctx=rescore_ctx if fast else None,
    )
    return _fuse_replicated(
        vec_rows, vec_dist, bm_rows, bm_vals, weight_vector=weight_vector,
        weight_bm25=weight_bm25, rrf_k=rrf_k, top_k=top_k,
    )


def make_sharded_split_hybrid_fn(
    mesh,
    *,
    r_cap: int,
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
    rescore_pool: int = 64,
    select: str = "exact",
):
    """The hybrid step over ``mesh`` with SPLIT-FREQUENCY BM25 (head
    matmul + tail postings) on every shard: the serving engine's step.

    Returns ``fn(emb, term_ids, tfs, tf_head, post_rows_sh, post_tfs_sh,
    doc_len, mask_bias, q_vecs, h_slots, h_tids, u_starts_sh, u_lens_sh,
    u_cols, t_tids, q_tids, q_counts, has_terms, df=None, emb16=None)``.
    Sharded, one block a shard: emb [N_local, d] bf16, term_ids [N_local,
    L] i32 and tfs u8 (subset df; the approx route's exact rescore),
    tf_head [C, N_local] u8 (the head matrix's columns), post_rows_sh
    [Pmax] i32 (shard-LOCAL rows) and post_tfs_sh u8, doc_len and
    mask_bias [N_local] f32, u_starts_sh / u_lens_sh [U] i32, emb16
    [N_local, d] f16 (the rescore master; None: no rescore). Replicated:
    q_vecs [B, d] f32, the batch's head union h_slots / h_tids [H], the
    segment → column map u_cols [U], the tail terms t_tids [T], q_tids
    [B, M] / q_counts [B, M], has_terms [B, 1] bool, and ``df``
    [vocab_pad+1] f32, the precomputed corpus df of an unfiltered query
    (None: the subset df of the kept rows, summed over the shards).

    Host prep: ``lexical.build_split_layout`` → ``shard_postings`` (per
    index build) and ``split_query_arrays`` → ``shard_tail_ranges`` (per
    batch). ``mesh`` as in ``make_sharded_hybrid_fn``; the result lies
    on the merge device, on every process.
    """
    return functools.partial(
        _split_hybrid_step, as_shards(mesh), r_cap=r_cap, k_vector=k_vector,
        k_bm25=k_bm25, top_k=top_k, pool=pool, vocab_pad=vocab_pad,
        use_mmr=use_mmr, mmr_lambda=mmr_lambda, rrf_k=rrf_k,
        weight_vector=weight_vector, weight_bm25=weight_bm25,
        rescore_pool=rescore_pool, select=select,
    )


__all__ = [
    "MeshShards",
    "ShardedHybridResult",
    "as_shards",
    "make_sharded_hybrid_fn",
    "make_sharded_split_hybrid_fn",
]
