"""Corpus-sharded serving: an IndexStore queried over a list of devices
(port of the JAX package's ``parallel/serving.py``).

``ShardedHybridIndex`` wraps a built :class:`IndexStore`. The corpus
arrays are placed once, one block per shard (rows of the embedding and
term matrices, columns of the term-major BM25 head matrix; tail postings
pre-partitioned per shard with shard-local row ids), and every query
batch runs :func:`make_sharded_split_hybrid_fn`: the single-device fused
step's math, with the single-device step's rows
(tests/test_torch_sharded_index.py).

Typical use::

    store = IndexStore(...); store.upsert(...)
    sharded = ShardedHybridIndex(store, corpus_mesh())
    out = sharded.query_batch(q_vecs, q_terms_lists, where=None)

Mutations: the engine consumes the store's journal
(``IndexStore.drain_journal``) at the next query and re-places only what
changed, with in-place ``index_copy_`` on each shard:

- metadata or validity edits (deletes, tag changes) → the cached filter
  biases are dropped and recomputed per active filter (an [N] f32 each);
- embedding-only updates → the changed rows (O(delta · d));
- lexical content changes → the changed rows of the term arrays, and the
  split-BM25 structures kept O(delta): head-matrix columns of the changed
  rows and the tail overlay (``lexical.plan_tail_delta``), with a full
  split re-place only when that plan is infeasible;
- structural changes (capacity growth, compaction) or a backlog over a
  quarter of the rows → full re-place.

``bytes_placed_total`` counts the bytes of every host array handed to a
placement or scatter (query inputs included), the JAX package's rule, so
tests and operators can check the O(delta) property. The port places
the f16 embedding master once and derives the bf16 scan slab on the
device, where the JAX package places it twice.

Across processes (a mesh of ``RankDevice``s from
``multihost.process_corpus_mesh``) the JAX package's SPMD contract
holds: every process holds the same host store, replays the same
mutations and calls ``query_batch`` with identical inputs in the same
order. Each process places, scatters and scans only the shards it owns
(``bytes_placed_*`` still counts the full host arrays, as JAX does on
every process); the shards' results meet on every process through an
``all_gather`` (``bytes_exchanged_total``), and every process returns
the same rows.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from classmate_rag_tpu_torch.device import pin_fp32_matmul
from classmate_rag_tpu_torch.index.filters import mask_bias_host
from classmate_rag_tpu_torch.index.lexical import (
    build_split_layout,
    head_tf_columns,
    overlay_diff_span,
    pack_query_terms,
    plan_tail_delta,
    shard_postings,
    shard_tail_ranges,
    split_query_arrays,
)
from classmate_rag_tpu_torch.index.store import (
    IndexStore,
    device_col_set,
    device_row_set,
)
from classmate_rag_tpu_torch.parallel.sharded import (
    MeshShards,
    ShardedHybridResult,
    make_sharded_split_hybrid_fn,
)

# Above this fraction of dirty rows a full re-place beats scattering.
_SCATTER_FRACTION = 0.25


class ShardedHybridIndex:
    """Sharded view of an IndexStore over a list of devices (``mesh``,
    one per shard; repeats allowed), or over ``RankDevice``s spanning
    processes."""

    def __init__(
        self,
        store: IndexStore,
        mesh: Sequence[Any],
        *,
        k_vector: int = 8,
        k_bm25: int = 8,
        top_k: int = 8,
        pool: int = 24,
        use_mmr: bool = True,
        mmr_lambda: float = 0.5,
        rrf_k: int = 60,
        weight_vector: float = 1.0,
        weight_bm25: float = 1.0,
        max_query_terms: int = 32,
    ) -> None:
        self.store = store
        self._shards = MeshShards(mesh)
        self.mesh = self._shards.devices
        self.n_shards = self._shards.n_shards
        self.max_query_terms = max_query_terms
        self._defaults = dict(
            k_vector=k_vector, k_bm25=k_bm25, top_k=top_k, pool=pool,
            use_mmr=use_mmr, mmr_lambda=mmr_lambda, rrf_k=rrf_k,
            weight_vector=weight_vector, weight_bm25=weight_bm25,
        )
        self._bias_cache: Dict[str, List[torch.Tensor]] = {}
        # Bumped on every bias-cache invalidation: a bias computed from
        # pre-invalidation store state must not be inserted AFTER the
        # clear (it would serve deleted rows until the next metadata
        # mutation). Guarded by _lock.
        self._bias_gen = 0
        self._lock = threading.Lock()
        self.bytes_placed_total = 0
        self.bytes_placed_last_refresh = 0
        self.full_lexical_rebuilds = -1   # _build counts the first one
        self._df_gen = 0
        if any(d.type == "cuda" for _s, d in self._shards.local):
            pin_fp32_matmul()
        self._build()

    # ------------------------------------------------------------------
    # Placement
    # ------------------------------------------------------------------

    def _build(self) -> None:
        """Full placement of the sharded corpus state (constructor and
        structural-change path)."""
        store = self.store
        if store.capacity % self.n_shards:
            raise ValueError(
                f"store capacity {store.capacity} must divide by the "
                f"{self.n_shards}-way shard axis (slab_rows controls this)"
            )
        # Consuming the journal here keeps construction and refresh
        # idempotent: everything below reflects the store as of now.
        self._epoch = store.drain_journal()[0]
        self._capacity = store.capacity
        self._vocab_pad = store.vocab_pad

        layout = build_split_layout(
            store.term_ids, store.tfs, len(store.vocab),
            head_bytes_budget=store.HEAD_BYTES_BUDGET,
            head_df_threshold=store.HEAD_DF_THRESHOLD,
        )
        self._layout = layout
        self._set_postings(layout)
        self.full_lexical_rebuilds += 1

        # Corpus df for unfiltered queries, on the merge device, derived
        # from the store's host-maintained df (see _df_placed_for).
        # _df_gen guards the same insert-after-invalidate race as
        # _bias_gen.
        self._df_placed = None
        self._df_gen += 1
        emb16 = self._place(store.emb)
        self._dev = {
            "emb": [None if e is None else e.to(torch.bfloat16)
                    for e in emb16],
            # f16 rescore master on the same shards; None when the
            # store does not rescore.
            "emb16": emb16 if store.rescore_enabled else None,
            "term_ids": self._place(store.term_ids),
            "tfs": self._place(store.tfs),
            "tf_head": self._place(layout["tf_head"], dim=1),
            "post_rows_sh": self._place_postings(self._host_postings[0]),
            "post_tfs_sh": self._place_postings(self._host_postings[1]),
            "doc_len": self._place(store.doc_len),
        }
        del emb16
        self._tail_diverged = False
        self._bias_cache.clear()
        self._bias_gen += 1

    def _set_postings(self, layout: Mapping[str, Any]) -> None:
        """Host side of the per-shard tail postings of ``layout``: the
        shard-local arrays, their offsets and an empty overlay."""
        store = self.store
        n_local = store.capacity // self.n_shards
        # Per-shard overlay reserve: room for O(delta) tail maintenance
        # (plan_tail_delta) between full rebuilds, a few percent of the
        # base postings with a floor for small corpora.
        self._reserve = max(
            4096, int(layout["p_base"]) // (32 * self.n_shards)
        )
        post_rows_sh, post_tfs_sh, offsets_sh = shard_postings(
            layout["post_rows"], layout["post_tfs"], layout["offsets"],
            self.n_shards, n_local, layout["r_cap"],
            reserve=self._reserve,
        )
        self._offsets_sh = offsets_sh
        self._host_postings = (post_rows_sh, post_tfs_sh)
        # Tail-overlay state (host side; see _try_incremental_lexical):
        # per-shard {tid: {local_row: tf}}, the per-shard overlay offsets,
        # the global overlay offsets fed to the query splitter (None =
        # overlay empty), and each shard's last overlay serialization.
        self._ov_by_term = [dict() for _ in range(self.n_shards)]
        self._ov_offsets_sh = np.zeros(
            (self.n_shards, len(store.vocab) + 1), np.int64
        )
        self._ov_offsets_global = None
        self._ov_prev = [
            (np.zeros(0, np.int32), np.zeros(0, np.uint8))
            for _ in range(self.n_shards)
        ]

    def _place(self, arr, dim: int = 0) -> List[Optional[torch.Tensor]]:
        """Host array → one equal block per shard along ``dim``, each a
        copy on its shard's device (the blocks are updated in place and
        must never alias the store's host masters); None for a shard
        another process owns."""
        arr = np.asarray(arr)
        self.bytes_placed_total += int(arr.nbytes)
        blocks = np.split(arr, self.n_shards, axis=dim)
        out: List[Optional[torch.Tensor]] = [None] * self.n_shards
        for s, dev in self._shards.local:
            out[s] = torch.from_numpy(
                np.ascontiguousarray(blocks[s])).to(dev, copy=True)
        return out

    def _place_postings(self, arr: np.ndarray) -> List[torch.Tensor]:
        """[S, Pmax] per-shard postings → one [Pmax] block per shard."""
        return [None if b is None else b.reshape(-1)
                for b in self._place(arr)]

    # ------------------------------------------------------------------
    # Incremental refresh
    # ------------------------------------------------------------------

    def ensure_fresh(self) -> None:
        """Bring the placed state up to date with the store's journal.

        Called at query time (and safe to call concurrently); see the
        module docstring for what each kind of change moves."""
        with self._lock:
            before = self.bytes_placed_total
            epoch, j_emb, j_lex, j_meta, old_lex = (
                self.store.drain_journal()
            )
            structural = (
                epoch != self._epoch
                or self.store.capacity != self._capacity
            )
            n_dirty = len(j_emb | j_lex)
            if structural or n_dirty > self.store.capacity * _SCATTER_FRACTION:
                self._build()
                self.bytes_placed_last_refresh = (
                    self.bytes_placed_total - before
                )
                return
            if j_lex or j_meta:
                # Corpus df may have moved (content or validity): its
                # copy re-derives from the store's host-maintained df on
                # next use (KBs, not a re-place).
                self._df_placed = None
                self._df_gen += 1
            if j_lex:
                self._refresh_lexical(sorted(j_lex), old_lex)
            if j_emb:
                rows = sorted(j_emb)
                self._scatter_rows("emb", rows, self.store.emb[rows])
                if self._dev["emb16"] is not None:
                    self._scatter_rows("emb16", rows, self.store.emb[rows])
            if j_meta:
                # Filter biases derive from metadata + validity; recompute
                # lazily per active filter (an [N] f32 each).
                self._bias_cache.clear()
                self._bias_gen += 1
            self.bytes_placed_last_refresh = self.bytes_placed_total - before

    def _refresh_lexical(self, rows, old_lex) -> None:
        """Lexical content changed for ``rows``: scatter the row-sharded
        term arrays, then keep the split-BM25 structures O(delta) (frozen
        head partition + tail overlay, lexical.plan_tail_delta), falling
        back to a full layout rebuild only when the plan is infeasible
        (overlay past its reserve, or a mutation's old content not
        captured)."""
        store = self.store
        self._scatter_rows("term_ids", rows, store.term_ids[rows])
        self._scatter_rows("tfs", rows, store.tfs[rows])
        self._scatter_rows("doc_len", rows, store.doc_len[rows])
        if not self._try_incremental_lexical(rows, old_lex):
            self._rebuild_lexical(rows)

    def _try_incremental_lexical(self, rows, old_lex) -> bool:
        store = self.store
        layout = self._layout
        n_vocab = len(store.vocab)
        n_local = self._capacity // self.n_shards
        lut = layout["lut"]
        offsets = layout["offsets"]
        if n_vocab > len(lut):
            # Vocab grew: new terms are tail by construction (df starts
            # tiny); extend the frozen tables with empty entries.
            lut = np.concatenate(
                [lut, np.full(n_vocab - len(lut), -1, np.int32)]
            )
            offsets = np.concatenate([
                offsets,
                np.full(n_vocab + 1 - len(offsets), offsets[-1], np.int64),
            ])
        for name in ("_ov_offsets_sh", "_offsets_sh"):
            # The per-shard base and overlay offsets follow the vocab
            # (new terms: empty ranges): query tids index all of them.
            table = getattr(self, name)
            if table.shape[1] < n_vocab + 1:
                pad = n_vocab + 1 - table.shape[1]
                setattr(self, name, np.concatenate(
                    [table, np.repeat(table[:, -1:], pad, axis=1)], axis=1
                ))

        post_rows_sh, _post_tfs_sh = self._host_postings
        base_lens = self._offsets_sh[:, -1]
        plans = []
        for s in range(self.n_shards):
            changes = []
            for row in rows:
                if row // n_local != s:
                    continue
                if row not in old_lex:
                    return False  # uncaptured mutation
                changes.append((
                    row - s * n_local,
                    old_lex[row],
                    (store.term_ids[row], store.tfs[row]),
                ))
            if not changes:
                plans.append(None)
                continue
            room = (
                post_rows_sh.shape[1] - int(base_lens[s])
                - layout["r_cap"]
            )
            plan = plan_tail_delta(
                # Searches run against THIS shard's postings: ranges come
                # from the per-shard offsets, not the global ones.
                lut, self._offsets_sh[s], post_rows_sh[s],
                self._ov_by_term[s], changes,
                reserve=room, n_vocab=n_vocab,
            )
            if plan is None:
                return False
            plans.append(plan)

        # All shards feasible: apply. Head columns first (frozen lut).
        c_pad = self._dev["tf_head"][self._shards.owned[0]].shape[0]
        cols = head_tf_columns(
            lut, c_pad, store.term_ids[rows], store.tfs[rows]
        )
        self._scatter_cols("tf_head", rows, cols)

        zero_s, zero_p = [], []
        reg_s, reg_p, reg_rows, reg_tfs = [], [], [], []
        ov_counts = np.zeros((self.n_shards, n_vocab), np.int64)
        for s, plan in enumerate(plans):
            if plan is None:
                ov_counts[s] = np.diff(
                    self._ov_offsets_sh[s, : n_vocab + 1]
                )
                continue
            zero_s.extend([s] * len(plan["zero_pos"]))
            zero_p.extend(plan["zero_pos"].tolist())
            # Write only the DIFF SPAN of the overlay region against its
            # previous serialization (zero-padded, so a shrunken
            # overlay's stale tail is cleared).
            lo, hi = overlay_diff_span(
                plan["ov_rows"], plan["ov_tfs"], self._ov_prev[s]
            )
            if hi > lo:
                start = int(base_lens[s])
                reg_s.extend([s] * (hi - lo))
                reg_p.extend(range(start + lo, start + hi))
                rows_pad = np.zeros(hi, np.int32)
                tfs_pad = np.zeros(hi, np.uint8)
                n_new = len(plan["ov_rows"])
                rows_pad[: min(n_new, hi)] = plan["ov_rows"][:hi]
                tfs_pad[: min(n_new, hi)] = plan["ov_tfs"][:hi]
                reg_rows.extend(rows_pad[lo:hi].tolist())
                reg_tfs.extend(tfs_pad[lo:hi].tolist())
            self._ov_prev[s] = (plan["ov_rows"], plan["ov_tfs"])
            ov_counts[s] = np.diff(plan["ov_offsets"])
            self._ov_offsets_sh[s, : n_vocab + 1] = plan["ov_offsets"]

        if zero_p:
            self._scatter_elems("post_tfs_sh", zero_s, zero_p,
                                np.zeros(len(zero_p), np.uint8))
            self._tail_diverged = True
        if reg_p:
            self._scatter_elems("post_rows_sh", reg_s, reg_p,
                                np.asarray(reg_rows, np.int32))
            self._scatter_elems("post_tfs_sh", reg_s, reg_p,
                                np.asarray(reg_tfs, np.uint8))
            self._tail_diverged = True

        total_counts = ov_counts.sum(axis=0)
        ov_global = np.zeros(n_vocab + 1, np.int64)
        np.cumsum(total_counts, out=ov_global[1:])
        self._ov_offsets_global = ov_global if int(ov_global[-1]) else None
        self._layout = dict(layout, lut=lut, offsets=offsets)
        self._vocab_pad = store.vocab_pad
        return True

    def _rebuild_lexical(self, rows) -> None:
        """Full split-layout rebuild (the incremental plan was
        infeasible): O(corpus) host work, the exceptional path."""
        store = self.store
        old_layout = self._layout
        old_rows, old_tfs = self._host_postings
        layout = build_split_layout(
            store.term_ids, store.tfs, len(store.vocab),
            head_bytes_budget=store.HEAD_BYTES_BUDGET,
            head_df_threshold=store.HEAD_DF_THRESHOLD,
        )
        self._layout = layout
        self._vocab_pad = store.vocab_pad
        self._set_postings(layout)
        self.full_lexical_rebuilds += 1

        n_old = len(old_layout["lut"])
        head_stable = (
            layout["r_cap"] == old_layout["r_cap"]
            and layout["tf_head"].shape == old_layout["tf_head"].shape
            and len(layout["lut"]) >= n_old
            and np.array_equal(layout["lut"][:n_old], old_layout["lut"])
            and not (layout["lut"][n_old:] >= 0).any()
        )
        if head_stable:
            # Head term set unchanged → tf_head differs only in the
            # changed rows' columns.
            self._scatter_cols("tf_head", rows, layout["tf_head"][:, rows])
        else:
            self._dev["tf_head"] = self._place(layout["tf_head"], dim=1)

        post_rows_sh, post_tfs_sh = self._host_postings
        if not (
            not self._tail_diverged
            and post_rows_sh.shape == old_rows.shape
            and np.array_equal(post_rows_sh, old_rows)
            and np.array_equal(post_tfs_sh, old_tfs)
        ):
            # Skipped only when the postings are untouched (a head-only
            # content change) AND the device copy never diverged through
            # incremental zeroing or overlay writes (an A->B->A content
            # cycle makes the fresh build equal the stale host copy
            # while the device differs).
            self._dev["post_rows_sh"] = self._place_postings(post_rows_sh)
            self._dev["post_tfs_sh"] = self._place_postings(post_tfs_sh)
            self._tail_diverged = False

    # -- per-shard scatters ------------------------------------------------

    def _scatter_rows(self, name: str, rows, vals: np.ndarray) -> None:
        """``t[rows] = vals`` into a row-sharded array: each shard takes
        the updates in its row range, in place, so host→device moves
        O(delta)."""
        rows = np.asarray(rows, np.int64)
        self.bytes_placed_total += int(vals.nbytes) + int(rows.nbytes)
        n_local = self._capacity // self.n_shards
        shard_of = rows // n_local
        for s, t in enumerate(self._dev[name]):
            mine = shard_of == s
            if t is not None and mine.any():
                device_row_set(t, rows[mine] - s * n_local, vals[mine])

    def _scatter_cols(self, name: str, cols, vals: np.ndarray) -> None:
        """``t[:, cols] = vals`` into a column-sharded [C, N] matrix (the
        term-major head matrix); vals is [C, delta]."""
        cols = np.asarray(cols, np.int64)
        self.bytes_placed_total += int(vals.nbytes) + int(cols.nbytes)
        n_local = self._capacity // self.n_shards
        shard_of = cols // n_local
        for s, t in enumerate(self._dev[name]):
            mine = shard_of == s
            if t is not None and mine.any():
                device_col_set(t, cols[mine] - s * n_local, vals[:, mine])

    def _scatter_elems(self, name: str, shard_ids, positions,
                       vals: np.ndarray) -> None:
        """Element scatter into per-shard [Pmax] postings, addressed as
        (shard, local position): tail-posting zeroing and overlay-region
        writes."""
        shard_ids = np.asarray(shard_ids)
        positions = np.asarray(positions, np.int64)
        self.bytes_placed_total += int(vals.nbytes) + int(positions.nbytes)
        for s, t in enumerate(self._dev[name]):
            mine = shard_ids == s
            if t is not None and mine.any():
                device_row_set(t, positions[mine], vals[mine])

    # ------------------------------------------------------------------

    def _mask_bias_sharded(self, where: Optional[Mapping[str, Any]]):
        """Filter mask as per-shard bias blocks (cached per filter).

        Computed on the host from the store's numpy columns: the store's
        own device mask would stage its whole corpus on one device."""
        key = json.dumps(where or {}, sort_keys=True, default=str)
        with self._lock:
            cached = self._bias_cache.get(key)
            gen = self._bias_gen
        if cached is not None:
            return cached
        store = self.store
        wanted, tag_want = store.compile_filter(where)
        bias = mask_bias_host(
            store.field_cols, store.tag_bits, store.valid, wanted, tag_want
        )
        placed = self._place(bias)
        with self._lock:
            # Insert only if no invalidation raced the computation.
            if self._bias_gen == gen:
                self._bias_cache[key] = placed
        return placed

    def _df_placed_for(self, vocab_pad: int) -> torch.Tensor:
        """[vocab_pad+1] f32 corpus df (unfiltered-query statistics) on
        the merge device, cached until a mutation drains or the vocab pad
        grows. Slot vocab_pad is the padding sink (0)."""
        with self._lock:
            cached = self._df_placed
            gen = self._df_gen
            if cached is not None and cached[0] == vocab_pad:
                return cached[1]
        dfh = self.store._ensure_df_host()
        out = np.zeros(vocab_pad + 1, np.float32)
        out[: min(len(dfh), vocab_pad)] = dfh[:vocab_pad]
        self.bytes_placed_total += int(out.nbytes)
        placed = torch.from_numpy(out).to(self._shards.merge)
        with self._lock:
            # Insert only if no invalidation raced the computation.
            if self._df_gen == gen:
                self._df_placed = (vocab_pad, placed)
        return placed

    def stats(self) -> Dict[str, Any]:
        """Shard occupancy: live rows, tail postings per shard (imbalance
        means one device does more scan work than the rest), head terms,
        and the bytes placed so far."""
        n_local = self.store.capacity // self.n_shards
        valid = self.store.valid
        return {
            "n_shards": self.n_shards,
            "devices": [str(d) for d in self.mesh],
            "rows_per_shard": [
                int(valid[s * n_local:(s + 1) * n_local].sum())
                for s in range(self.n_shards)
            ],
            "tail_postings_per_shard": [
                int(self._offsets_sh[s, -1]) for s in range(self.n_shards)
            ],
            "head_terms": int((self._layout["lut"] >= 0).sum()),
            "r_cap": int(self._layout["r_cap"]),
            "capacity_per_shard": n_local,
            "bytes_placed_total": self.bytes_placed_total,
        }

    @property
    def bytes_exchanged_total(self) -> int:
        """Bytes this process received from the others' shards (0 in one
        process)."""
        return self._shards.bytes_exchanged

    def query_batch(
        self,
        query_vecs,                       # [B, d] f32 (numpy or tensor)
        query_terms_list: Sequence[Sequence[str]],
        where: Optional[Mapping[str, Any]] = None,
        **knob_overrides: Any,
    ) -> ShardedHybridResult:
        """The hybrid step for the whole batch over the shards: rows /
        fused / vec_dist / bm25_score [B, top_k] on the merge device (the
        first local shard's), as ``IndexStore.hybrid_topk_batch`` returns
        them; the same on every process.

        ``knob_overrides`` (top_k, k_vector, pool, ...) override the
        constructor's defaults per call."""
        store = self.store
        # The placed layout must cover the live store: queries pack terms
        # against store.vocab, and a stale lut after a vocab-growing
        # upsert reads out of bounds. No-op when the journal is empty.
        self.ensure_fresh()
        # Coherent snapshot of the placed state: a refresh from another
        # query thread (ensure_fresh holds _lock throughout) must not
        # hand this batch a new lut zipped with old shard offsets.
        # Mutating the STORE while queries run still needs the caller's
        # reader/writer discipline (the server's RW lock): the snapshot
        # makes query-vs-refresh safe, not query-vs-mutation.
        with self._lock:
            layout = self._layout
            offsets_sh = self._offsets_sh
            d = dict(self._dev)
            vocab_pad = self._vocab_pad
            ov_global = self._ov_offsets_global
            ov_offsets_sh = self._ov_offsets_sh
        knobs = dict(self._defaults)
        for k, v in knob_overrides.items():
            if k not in self._defaults:
                raise TypeError(f"unknown query knob {k!r}")
            if v is not None:
                knobs[k] = v
        for k in ("k_vector", "k_bm25", "pool"):
            knobs[k] = min(knobs[k], store.capacity)

        q_vecs = torch.as_tensor(query_vecs, dtype=torch.float32)
        q_terms, q_counts = pack_query_terms(
            store.vocab, list(query_terms_list), self.max_query_terms
        )
        qa = split_query_arrays(
            layout["lut"], layout["offsets"], q_terms, q_counts,
            r_cap=layout["r_cap"], ov_offsets=ov_global,
        )
        overlay = {}
        if ov_global is not None:
            # Overlay active: base slots resolve against the base
            # offsets, overlay slots against the per-shard overlay ranges
            # (each region starts at its shard's base end).
            overlay = dict(
                u_occ=qa["u_occ"], u_ov=qa["u_ov"],
                ov_offsets_sh=ov_offsets_sh[:, : len(layout["offsets"])],
                ov_starts_sh=offsets_sh[:, -1],
            )
        u_starts_sh, u_lens_sh = shard_tail_ranges(
            offsets_sh, qa["u_tids"], r_cap=layout["r_cap"], **overlay
        )
        has_terms = np.any(q_terms >= 0, axis=1, keepdims=True)
        self.bytes_placed_total += q_vecs.element_size() * q_vecs.numel() + sum(
            int(a.nbytes) for a in (
                qa["h_slots"], qa["h_tids"], u_starts_sh, u_lens_sh,
                qa["u_cols"], qa["t_tids"], q_terms, q_counts, has_terms,
            )
        )
        bias = self._mask_bias_sharded(where)
        df = None if where else self._df_placed_for(vocab_pad)
        step = make_sharded_split_hybrid_fn(
            self._shards, r_cap=layout["r_cap"], vocab_pad=vocab_pad,
            rescore_pool=min(store.rescore_pool, store.capacity),
            select=store.select_mode, **knobs,
        )
        return step(
            d["emb"], d["term_ids"], d["tfs"], d["tf_head"],
            d["post_rows_sh"], d["post_tfs_sh"], d["doc_len"], bias,
            q_vecs, qa["h_slots"], qa["h_tids"], u_starts_sh, u_lens_sh,
            qa["u_cols"], qa["t_tids"], q_terms, q_counts, has_terms,
            df=df, emb16=d["emb16"],
        )
