"""Unified index: one row space for dense + lexical + metadata (port of
the JAX package's ``index/store.py``).

The host keeps the master arrays (f16 embeddings, packed [N, L] term
ids/tfs, doc lengths, interned metadata columns, tag bits, validity);
``_sync_device`` places them on the store's device: one f16 upload, the
bf16 scan slab derived there. Capacity grows geometrically in slab
multiples, exactly as in the reference, so both packages see the same
row space.

After the first placement the sync is O(delta): mutations journal the
rows they touched (``_dev_j_emb``/``_dev_j_lex``/``_dev_j_meta``), and
the next query scatters only those rows into the resident tensors with
in-place ``index_copy_``; the split-BM25 layout takes the same rows
through the frozen-head + tail-overlay planner
(``lexical.plan_tail_delta``). A structural change (capacity growth,
``compact``, a backlog over a quarter of the rows, a capture dropped at
``_OLD_LEX_CAP``, an overlay past its reserve) takes the full path;
``device_full_uploads``, ``split_full_builds`` and
``split_snapshot_restores`` count those paths. A second journal
(``_j_*``, ``drain_journal``) feeds the corpus-sharded serving engine
(``parallel/serving.py``) the same rows, for its own O(delta) refresh.

Persistence is the JAX package's format, byte for byte: ``embeddings.npy``
and ``rows.json`` (with ``emb_stat``), the v2 ``lexical.*.npy`` slabs and
``lexical.npz``, ``lexical.delta_NNNN.npz`` files chained by catalog
fingerprints, and at serving scale the split layout (``split.*.npy``).
A directory saved by either package loads in the other.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from classmate_rag_tpu_torch.device import (
    DeviceLike,
    pin_fp32_matmul,
    resolve_device,
)
from classmate_rag_tpu_torch.index.catalog import Catalog
from classmate_rag_tpu_torch.index.filters import (
    FILTER_FIELDS,
    TAG_WORDS,
    InternTable,
    mask_bias_device,
)
from classmate_rag_tpu_torch.index.lexical import (
    STEP_COLUMNS,
    bm25_split_score_core,
    build_split_layout,
    head_tf_columns,
    okapi_idf,
    overlay_diff_span,
    pack_query_terms,
    pack_tokens,
    plan_tail_delta,
    split_query_arrays,
    subset_df,
    subset_stats,
)
from classmate_rag_tpu_torch.metadata.validation import (
    slug_tag,
    tags_from_meta,
)
from classmate_rag_tpu_torch.native import make_native_packer
from classmate_rag_tpu_torch.ops.hybrid_step import (
    HybridBatchResult,
    hybrid_query_step_split_packed,
    pack_query_arrays,
    select_width,
)
from classmate_rag_tpu_torch.ops.topk import (
    ROW_SELECT_MAX_K,
    masked_topk,
    stable_topk,
)
from classmate_rag_tpu_torch.utils.metrics import metrics
from classmate_rag_tpu_torch.utils.numerics import NEG_INF
from classmate_rag_tpu_torch.utils.numerics import round_up as _round_up
from classmate_rag_tpu_torch.utils.profiling import held_stream_ms

# Host arrays a store is made of, with their dtypes (see from_host_state
# and host_state).
_ARRAYS = {
    "emb": np.float16, "term_ids": np.int32, "tfs": np.uint8,
    "doc_len": np.float32, "valid": bool, "field_cols": np.int32,
    "tag_bits": np.uint32,
}

# Cap on old-content captures of lexical rows awaiting the split sync
# (~1 KB a row). Beyond it captures stop, and the split sync detects the
# missing capture and rebuilds in full — what a backlog that size
# warrants anyway.
_OLD_LEX_CAP = 65536
# Sentinel for "capture dropped at the cap", distinct from None ("fresh
# slot with no previous content") in _split_pending.
_OLD_MISSING = object()


def device_row_set(t: torch.Tensor, rows, vals: np.ndarray) -> None:
    """In-place row scatter into a resident tensor: ``t[rows] = vals``
    along dim 0. ``rows`` are distinct, so ``index_copy_`` is
    deterministic (the reference pads updates to a power of two by
    repeating entry 0, for its compile cache; duplicate indices would make
    ``index_copy_`` pick either write)."""
    idx = torch.as_tensor(np.asarray(rows, np.int64), device=t.device)
    src = torch.from_numpy(np.ascontiguousarray(vals)).to(t.device)
    t.index_copy_(0, idx, src.to(t.dtype))


def device_col_set(t: torch.Tensor, cols, vals: np.ndarray) -> None:
    """In-place column scatter into a resident [F, cap] tensor:
    ``t[:, cols] = vals`` with ``vals`` [F, R]."""
    idx = torch.as_tensor(np.asarray(cols, np.int64), device=t.device)
    src = torch.from_numpy(np.ascontiguousarray(vals)).to(t.device)
    t.index_copy_(1, idx, src.to(t.dtype))


@dataclass
class SearchResult:
    row: int
    id: str
    score: float


class IndexStore:
    """Row-unified dense + lexical + metadata index on one device."""

    # "auto" select: above this capacity the reference picks its pool
    # with a TPU primitive; the port's scan kernel serves both routes,
    # and "approx" additionally switches BM25 to its fast bf16 form with
    # an exact pool rescore.
    APPROX_MIN_ROWS = 500_000
    HEAD_DF_THRESHOLD = 256
    # Device-memory budget for the [C, N] u8 head matrix of split BM25.
    HEAD_BYTES_BUDGET = 3584 << 20

    def __init__(
        self,
        dim: int,
        directory: str | Path = "./indexes/dense",
        slab_rows: int = 4096,
        terms_per_chunk: int = 192,
        rescore: str = "auto",          # auto | on | off
        rescore_pool: int = 32,
        select: str = "auto",           # auto | exact | approx
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.dim = dim
        self.directory = Path(directory)
        self.slab_rows = slab_rows
        self.term_width = terms_per_chunk
        self.rescore = rescore
        self.rescore_pool = rescore_pool
        self.select = select

        self.ids: List[str] = []
        self.id_to_row: Dict[str, int] = {}
        cap = slab_rows
        self.emb = np.zeros((cap, dim), dtype=np.float16)
        self.term_ids = np.full((cap, self.term_width), -1, dtype=np.int32)
        self.tfs = np.zeros((cap, self.term_width), dtype=np.uint8)
        self.doc_len = np.zeros(cap, dtype=np.float32)
        self.valid = np.zeros(cap, dtype=bool)
        self.field_cols = np.zeros((len(FILTER_FIELDS), cap), dtype=np.int32)
        self.tag_bits = np.zeros((cap, TAG_WORDS), dtype=np.uint32)
        self.vocab: Dict[str, int] = {}
        self.interns: Dict[str, InternTable] = {
            f: InternTable() for f in FILTER_FIELDS
        }
        self.tag_slots: Dict[str, int] = {}
        # Which embedder produced the persisted vectors (the runtime
        # stamps it; persisted in rows.json).
        self.embedding_model: Optional[str] = None

        self._dev: Dict[str, Any] = {}
        self._split: Optional[Dict[str, Any]] = None
        self._dirty = True
        # Host-maintained corpus df over valid rows (i64 [len(vocab)]):
        # built once (or restored from the snapshot), then kept O(delta)
        # by upsert/delete. Its device copy (_df_cache) is a KB-scale
        # upload, never a device histogram.
        self._df_host: Optional[np.ndarray] = None
        self._df_cache: Optional[torch.Tensor] = None
        # Per-filter subset-df LRU; cleared on any mutation.
        self._df_filter_cache: "OrderedDict[tuple, torch.Tensor]" = (
            OrderedDict()
        )
        self._nofilter_bias: Optional[torch.Tensor] = None
        # Structure generation: bumped by capacity growth and compact,
        # which make the resident tensors' row space stale.
        self._epoch = 0
        self._dev_epoch = -1
        # Mutation journal of the sharded serving engine
        # (parallel/serving.py), drained by drain_journal: the rows
        # touched since the last drain, and each lexical row's
        # pre-mutation (term_ids, tfs) (None = fresh slot). Its own
        # consumer, beside the store's device-sync twins below.
        self._j_emb: set = set()
        self._j_lex: set = set()
        self._j_meta: set = set()
        self._j_old_lex: Dict[int, Any] = {}
        # Device-sync journal: rows touched since the last sync, and each
        # lexical row's pre-mutation (term_ids, tfs) (None = fresh slot).
        self._dev_j_emb: set = set()
        self._dev_j_lex: set = set()
        self._dev_j_meta: set = set()
        self._dev_old_lex: Dict[int, Any] = {}
        # Lexical rows awaiting split-layout maintenance (consumed by
        # _sync_split; _sync_device stashes them because the layout is
        # built lazily and may not exist yet).
        self._split_pending: Dict[int, Any] = {}
        # The incremental sync is not idempotent (in-place scatters plus
        # journal consumption): readers noticing _dirty together
        # serialize here. RLock: _sync_split re-enters via _sync_device.
        self._sync_lock = threading.RLock()
        # How often the O(corpus) paths ran.
        self.device_full_uploads = 0
        self.split_full_builds = 0
        self.split_snapshot_restores = 0
        self.df_full_builds = 0
        # Filtered-df LRU lookups that found their filter, and that built
        # its histogram (unfiltered queries count in neither).
        self.df_filter_cache_hits = 0
        self.df_filter_cache_misses = 0
        # v2 snapshot adoption: the persisted split layout (host mmaps,
        # consumed once by _sync_split_locked) and the rows the persisted
        # deltas touched since it was built (row -> pre-delta
        # (term_ids, tfs) | None), applied through the O(delta) planner.
        self._split_persisted: Optional[Dict[str, Any]] = None
        self._split_load_pending: Dict[int, Any] = {}
        # Persistence delta tracking: rows touched since the last save.
        # With a persisted base, save() appends one small
        # lexical.delta_NNNN.npz instead of rewriting the base.
        self._dirty_rows: set = set()
        self._persist_fp: Optional[str] = None  # catalog fp chain head
        # Fingerprint recorded in the snapshot that load adopted (may be
        # the pre-fold fp accepted via the catalog's fold alias): the
        # next delta chains from what is on disk.
        self._snap_fp: Optional[str] = None
        self._persist_vocab = 0  # vocab size at last persist (delta base)
        self._delta_seq = 0
        self._need_full_save = False
        # Native batch packer (the C++ interner), made at the first pack.
        # Once the Python path interns a term the native side does not
        # know, native packing stays off for this store (the two
        # interners must give the same ids).
        self._packer = None
        self._packer_ok = True
        # Which path packed the latest rows (None before the first pack).
        self._last_pack_native: Optional[bool] = None
        # How device_seconds_per_batch timed its last call: "held stream",
        # "profiler" or "wall" (None before the first).
        self.device_timing: Optional[str] = None

    # ------------------------------------------------------------------
    # Host state carried across packages
    # ------------------------------------------------------------------

    @classmethod
    def from_host_state(
        cls,
        state: Mapping[str, Any],
        device: DeviceLike = None,
        **knobs: Any,
    ) -> "IndexStore":
        """A store over existing host state: numpy arrays ``emb`` (f16),
        ``term_ids``, ``tfs``, ``doc_len``, ``valid``, ``field_cols``,
        ``tag_bits``; ``ids`` (row order); dicts ``vocab``, ``interns``
        (field → value → id) and ``tag_slots``. ``knobs`` are the
        constructor's (``slab_rows``, ``rescore``, ...)."""
        emb = np.asarray(state["emb"])
        store = cls(
            emb.shape[1],
            terms_per_chunk=np.asarray(state["term_ids"]).shape[1],
            device=device, **knobs,
        )
        for name, dtype in _ARRAYS.items():
            setattr(store, name,
                    np.array(state[name], dtype=dtype, copy=True))
        store.ids = [str(i) for i in state["ids"]]
        store.id_to_row = {cid: r for r, cid in enumerate(store.ids)}
        store.vocab = dict(state["vocab"])
        store.interns = {
            f: InternTable(dict(state["interns"].get(f, {})))
            for f in FILTER_FIELDS
        }
        store.tag_slots = dict(state["tag_slots"])
        return store

    def host_state(self) -> Dict[str, Any]:
        """The host state ``from_host_state`` takes (copies)."""
        state: Dict[str, Any] = {n: getattr(self, n).copy() for n in _ARRAYS}
        state["ids"] = list(self.ids)
        state["vocab"] = dict(self.vocab)
        state["interns"] = {
            f: dict(t.to_id) for f, t in self.interns.items()
        }
        state["tag_slots"] = dict(self.tag_slots)
        return state

    # ------------------------------------------------------------------
    # Capacity / registry
    # ------------------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.emb.shape[0]

    def __len__(self) -> int:
        return int(self.valid.sum())

    @property
    def n_rows(self) -> int:
        return len(self.ids)

    def _grow_to(self, rows: int) -> None:
        if rows <= self.capacity:
            return
        # Geometric growth (≥2x), slab-aligned: the reference's rule, so
        # both packages have the same capacity for the same corpus.
        new_cap = _round_up(max(rows, 2 * self.capacity), self.slab_rows)
        self._epoch += 1  # shape change: the resident tensors are stale
        # A persisted split layout is column-sized to the old capacity.
        self._split_persisted = None
        self._split_load_pending.clear()

        def grow(arr: np.ndarray, fill=0) -> np.ndarray:
            out = np.full((new_cap,) + arr.shape[1:], fill, dtype=arr.dtype)
            out[: arr.shape[0]] = arr
            return out

        self.emb = grow(self.emb)
        self.term_ids = grow(self.term_ids, -1)
        self.tfs = grow(self.tfs)
        self.doc_len = grow(self.doc_len)
        self.valid = grow(self.valid, False)
        self.tag_bits = grow(self.tag_bits)
        new_fields = np.zeros((len(FILTER_FIELDS), new_cap), dtype=np.int32)
        new_fields[:, : self.field_cols.shape[1]] = self.field_cols
        self.field_cols = new_fields

    def _row_for(self, cid: str) -> int:
        row = self.id_to_row.get(cid)
        if row is None:
            row = len(self.ids)
            self.ids.append(cid)
            self.id_to_row[cid] = row
            self._grow_to(row + 1)
        return row

    # ------------------------------------------------------------------
    # Mutation
    # ------------------------------------------------------------------

    @property
    def packs_natively(self) -> bool:
        """Whether the latest rows were packed by the C++ packer
        (``native/``); False before the first pack and when they took
        the Python path, whose results are the same."""
        return bool(self._last_pack_native)

    def _pack_rows(self, tokens_list: Sequence[Sequence[str]]):
        """Batch (term_ids [B, W] i32, tfs [B, W] u8, doc_len [B] f32),
        interning new terms in first-seen order: the C++ batch packer
        when it loads (the same ids and arrays), else pack_tokens per
        row."""
        if self._packer_ok and self._packer is None:
            self._packer = make_native_packer()
            if self._packer is None:
                self._packer_ok = False
            elif self.vocab and not self._packer.import_vocab(self.vocab):
                # A fresh packer over a restored vocab: seed the native
                # interner; on failure stay on the Python path.
                self._packer_ok = False
        if (
            self._packer_ok
            and len(self.vocab) == self._packer.vocab_size()
        ):
            out = self._packer.pack_batch(
                tokens_list, self.vocab, self.term_width
            )
            if out is not None:
                self._last_pack_native = True
                return out
            self._packer_ok = False  # separator-bearing tokens: stay Python
        self._last_pack_native = False
        b = len(tokens_list)
        term_ids = np.empty((b, self.term_width), dtype=np.int32)
        tfs = np.empty((b, self.term_width), dtype=np.uint8)
        doc_len = np.empty(b, dtype=np.float32)
        for i, tokens in enumerate(tokens_list):
            term_ids[i], tfs[i], doc_len[i] = pack_tokens(
                tokens, self.vocab, self.term_width
            )
        return term_ids, tfs, doc_len

    def _df_note(self, tids: np.ndarray, tfs: np.ndarray,
                 delta: int) -> None:
        """Apply ONE row's presence contribution (±1 per distinct live
        term) to the host df. Packed rows hold unique terms, so fancy
        indexing (no np.add.at) is exact."""
        live = (tids >= 0) & (tfs > 0)
        t = tids[live]
        if not len(t):
            return
        hi = int(t.max()) + 1
        if hi > len(self._df_host):
            self._df_host = np.concatenate([
                self._df_host, np.zeros(hi - len(self._df_host), np.int64)
            ])
        self._df_host[t] += delta

    def _ensure_df_host(self) -> np.ndarray:
        """Build (or extend) the host df over valid rows: a chunked
        bincount over the packed term matrix, once per store unless
        restored from the snapshot."""
        if self._df_host is None:
            self.df_full_builds += 1
            nv = max(len(self.vocab), 1)
            df = np.zeros(nv, np.int64)
            step = 65536
            for s in range(0, self.n_rows, step):
                e = min(s + step, self.n_rows)
                ids = self.term_ids[s:e]
                live = (
                    (ids >= 0) & (self.tfs[s:e] > 0) & self.valid[s:e, None]
                )
                sel = ids[live]
                if len(sel):
                    df += np.bincount(sel, minlength=nv)
            self._df_host = df
        elif len(self._df_host) < len(self.vocab):
            self._df_host = np.concatenate([
                self._df_host,
                np.zeros(len(self.vocab) - len(self._df_host), np.int64),
            ])
        return self._df_host

    def _df_device(self, vpad: int) -> torch.Tensor:
        """Unfiltered-corpus df as the [vpad+1] f32 tensor the Okapi
        scorers take (slot vpad is the padding sink, kept 0)."""
        if self._df_cache is None or self._df_cache.shape[0] != vpad + 1:
            dfh = self._ensure_df_host()
            out = np.zeros(vpad + 1, np.float32)
            out[: min(len(dfh), vpad)] = dfh[:vpad]
            self._df_cache = torch.from_numpy(out).to(self.device)
        return self._df_cache

    def _df_for_where(self, where, bias: torch.Tensor,
                      vpad: int) -> torch.Tensor:
        """Subset df for a filtered query (a histogram over the masked
        rows, the reference's rebuild-on-subset semantics) behind a small
        per-filter LRU; unfiltered queries take the host-maintained df."""
        if not where:
            return self._df_device(vpad)
        wanted, tag_want = self.compile_filter(where)
        key = (wanted.tobytes(), tag_want.tobytes(), vpad)
        hit = self._df_filter_cache.get(key)
        if hit is not None:
            self.df_filter_cache_hits += 1
            self._df_filter_cache.move_to_end(key)
            return hit
        self.df_filter_cache_misses += 1
        dev = self._sync_device()
        df = subset_df(dev["term_ids"], dev["tfs"], bias == 0.0, vpad)
        self._df_filter_cache[key] = df
        while len(self._df_filter_cache) > 8:
            self._df_filter_cache.popitem(last=False)
        return df

    def upsert(
        self,
        ids: Sequence[str],
        embeddings: np.ndarray,
        tokens_list: Sequence[Sequence[str]],
        metadatas: Sequence[Mapping[str, Any]],
    ) -> int:
        """Idempotent upsert of aligned (id, embedding, tokens, metadata)."""
        if not (len(ids) == len(embeddings) == len(tokens_list)
                == len(metadatas)):
            raise ValueError(
                "ids/embeddings/tokens/metadatas length mismatch"
            )
        t_ids_b, t_tfs_b, dl_b = self._pack_rows(tokens_list)
        for i, cid in enumerate(ids):
            fresh = cid not in self.id_to_row
            row = self._row_for(cid)
            emb_new = embeddings[i].astype(np.float16)
            # Journal what actually changed (fresh rows change
            # everything; identical re-upserts journal nothing).
            if fresh or not np.array_equal(self.emb[row], emb_new):
                self._j_emb.add(row)
                self._dev_j_emb.add(row)
                self._dirty_rows.add(row)
            if fresh or not (
                np.array_equal(self.term_ids[row], t_ids_b[i])
                and np.array_equal(self.tfs[row], t_tfs_b[i])
                and self.doc_len[row] == dl_b[i]
            ):
                # First-touch capture of the row's pre-mutation lexical
                # content: the tail-posting planner needs the old terms
                # to neutralize their base/overlay entries. Each journal
                # (the engine's, the device sync's) keeps its own.
                old = None if fresh else (
                    self.term_ids[row].copy(), self.tfs[row].copy()
                )
                if (
                    row not in self._j_old_lex
                    and len(self._j_old_lex) < _OLD_LEX_CAP
                ):
                    self._j_old_lex[row] = old
                if (
                    row not in self._dev_j_lex
                    and len(self._dev_old_lex) < _OLD_LEX_CAP
                ):
                    self._dev_old_lex[row] = old
                self._j_lex.add(row)
                self._dev_j_lex.add(row)
                self._dirty_rows.add(row)
                lex_changed = True
            else:
                lex_changed = False
            # O(delta) corpus-df maintenance: subtract the row's old
            # contribution (when it was live), add the new, before the
            # overwrites below. Lazy until first built or restored.
            if self._df_host is not None and (
                lex_changed or not self.valid[row]
            ):
                if not fresh and self.valid[row]:
                    self._df_note(self.term_ids[row], self.tfs[row], -1)
                self._df_note(t_ids_b[i], t_tfs_b[i], +1)
                self._df_cache = None
            self.emb[row] = emb_new
            self.term_ids[row] = t_ids_b[i]
            self.tfs[row] = t_tfs_b[i]
            self.doc_len[row] = dl_b[i]
            meta_changed = fresh or not self.valid[row]
            fields, bits = self._pack_row_metadata(metadatas[i] or {})
            meta_changed |= not np.array_equal(
                self.field_cols[:, row], fields
            )
            self.field_cols[:, row] = fields
            meta_changed |= not np.array_equal(self.tag_bits[row], bits)
            self.tag_bits[row] = bits
            self.valid[row] = True
            if meta_changed:
                self._j_meta.add(row)
                self._dev_j_meta.add(row)
                self._dirty_rows.add(row)
        # Any mutation moves filtered-subset membership.
        self._df_filter_cache.clear()
        self._dirty = True
        return len(ids)

    def _pack_row_metadata(self, meta: Mapping[str, Any]):
        """Interned filter-field ids [F] + packed tag bitmask [W] for one
        row (``tags_from_meta`` reads ``tag_<slug>`` flags and legacy
        tags lists). The one definition shared by upsert and the catalog
        cold rebuild."""
        fields = np.empty(len(FILTER_FIELDS), np.int32)
        for j, f in enumerate(FILTER_FIELDS):
            v = meta.get(f)
            fields[j] = self.interns[f].intern(
                str(v) if v is not None else None
            )
        bits = np.zeros(TAG_WORDS, dtype=np.uint32)
        for slug in tags_from_meta(meta):
            slot = self.tag_slots.setdefault(slug, len(self.tag_slots))
            if slot < TAG_WORDS * 32:
                bits[slot // 32] |= np.uint32(1 << (slot % 32))
        return fields, bits

    def delete(self, ids: Sequence[str]) -> int:
        """Tombstone rows; really removes them from every search path."""
        n = 0
        for cid in ids:
            row = self.id_to_row.get(cid)
            if row is not None and self.valid[row]:
                if self._df_host is not None:
                    self._df_note(self.term_ids[row], self.tfs[row], -1)
                self.valid[row] = False
                self._j_meta.add(row)
                self._dev_j_meta.add(row)
                self._dirty_rows.add(row)
                n += 1
        if n:
            self._dirty = True
            self._df_cache = None
            self._df_filter_cache.clear()
        return n

    def compact(self) -> int:
        """Drop tombstoned rows and re-pack; returns rows reclaimed."""
        keep = [r for r in range(self.n_rows) if self.valid[r]]
        reclaimed = self.n_rows - len(keep)
        if reclaimed == 0:
            return 0
        sel = np.asarray(keep, dtype=np.int64)
        self.ids = [self.ids[r] for r in keep]
        self.id_to_row = {cid: i for i, cid in enumerate(self.ids)}
        cap = _round_up(max(len(keep), 1), self.slab_rows)

        def take(arr: np.ndarray, fill=0) -> np.ndarray:
            out = np.full((cap,) + arr.shape[1:], fill, dtype=arr.dtype)
            if len(sel):
                out[: len(sel)] = arr[sel]
            return out

        self.emb = take(self.emb)
        self.term_ids = take(self.term_ids, -1)
        self.tfs = take(self.tfs)
        self.doc_len = take(self.doc_len)
        self.tag_bits = take(self.tag_bits)
        new_valid = np.zeros(cap, dtype=bool)
        new_valid[: len(sel)] = True
        self.valid = new_valid
        new_fields = np.zeros((len(FILTER_FIELDS), cap), dtype=np.int32)
        if len(sel):
            new_fields[:, : len(sel)] = self.field_cols[:, sel]
        self.field_cols = new_fields
        self._dirty = True
        # Row identities moved: incremental deltas are meaningless now.
        self._epoch += 1
        self._j_emb.clear()
        self._j_lex.clear()
        self._j_meta.clear()
        self._j_old_lex.clear()
        self._dev_j_emb.clear()
        self._dev_j_lex.clear()
        self._dev_j_meta.clear()
        self._dev_old_lex.clear()
        self._split_pending.clear()
        self._split_persisted = None
        self._split_load_pending.clear()
        self._dirty_rows.clear()
        self._need_full_save = True
        return reclaimed

    def drain_journal(self):
        """Consume the engine's mutation journal: (epoch, emb_rows,
        lex_rows, meta_rows, old_lex), clearing the row sets. ``old_lex``
        maps each lexical row to its pre-mutation (term_ids, tfs), None
        for a fresh slot. The epoch is not reset: a consumer compares it
        with the epoch it placed at, and a mismatch (capacity growth,
        compaction) means a full re-place. One consumer: the sharded
        serving engine."""
        out = (
            self._epoch, self._j_emb, self._j_lex, self._j_meta,
            self._j_old_lex,
        )
        self._j_emb, self._j_lex, self._j_meta = set(), set(), set()
        self._j_old_lex = {}
        return out

    # ------------------------------------------------------------------
    # Device state
    # ------------------------------------------------------------------

    @property
    def rescore_enabled(self) -> bool:
        """f16 rescore of the dense top pool; "auto" always enables it."""
        return self.rescore != "off"

    @property
    def select_mode(self) -> str:
        """"approx" or "exact". Auto gates on the rescore being active and
        on serving scale; forced "approx" still requires rescore."""
        if self.select == "exact" or not self.rescore_enabled:
            return "exact"
        if self.select == "approx":
            return "approx"
        return (
            "approx" if self.capacity >= self.APPROX_MIN_ROWS else "exact"
        )

    def _place(self, arr: np.ndarray) -> torch.Tensor:
        """A device copy of a host array. Always a copy, on the CPU too:
        the resident tensors are updated in place and must never alias
        the host masters (or a copy-on-write mmap of a persisted slab)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device, copy=True
        )

    def _sync_device(self) -> Dict[str, Any]:
        if not self._dirty and self._dev:
            return self._dev
        with self._sync_lock:
            return self._sync_device_locked()

    def _sync_device_locked(self) -> Dict[str, Any]:
        if not self._dirty and self._dev:
            return self._dev  # another reader synced while we waited
        dirty = self._dev_j_emb | self._dev_j_lex | self._dev_j_meta
        structural = (
            not self._dev
            or self._dev_epoch != self._epoch
            or self._dev["emb"].shape[0] != self.capacity
            or len(dirty) * 4 > max(self.n_rows, 1)
        )
        if structural:
            return self._upload()
        # Incremental: scatter only the touched rows into the resident
        # tensors, in place.
        d = self._dev
        if self._dev_j_emb:
            rows = sorted(self._dev_j_emb)
            vals = self.emb[rows]
            device_row_set(d["emb"], rows, vals)
            if d["emb16"] is not None:
                device_row_set(d["emb16"], rows, vals)
        if self._dev_j_lex:
            rows = sorted(self._dev_j_lex)
            device_row_set(d["term_ids"], rows, self.term_ids[rows])
            device_row_set(d["tfs"], rows, self.tfs[rows])
            device_row_set(d["doc_len"], rows, self.doc_len[rows])
            self._df_filter_cache.clear()
            # _df_cache stays: upsert/delete keep the host df (and so
            # its upload) O(delta).
            for r in rows:
                if r not in self._split_pending:
                    # _OLD_MISSING (capture dropped at the cap) must not
                    # read as None (fresh slot): it forces the rebuild.
                    self._split_pending[r] = self._dev_old_lex.get(
                        r, _OLD_MISSING
                    )
        if self._dev_j_meta or self._dev_j_lex:
            rows = sorted(self._dev_j_meta | self._dev_j_lex)
            device_row_set(d["valid"], rows, self.valid[rows])
            device_col_set(d["field_cols"], rows, self.field_cols[:, rows])
            device_row_set(d["tag_bits"], rows,
                            self.tag_bits[rows].view(np.int32))
            self._df_filter_cache.clear()  # subset membership moved
            self._nofilter_bias = None
        self._dev_j_emb.clear()
        self._dev_j_lex.clear()
        self._dev_j_meta.clear()
        self._dev_old_lex.clear()
        self._dirty = False
        return self._dev

    def _upload(self) -> Dict[str, Any]:
        """Structural upload of every host array (one f16 embedding
        upload; the bf16 scan slab is derived on the device)."""
        if self.device.type == "cuda":
            pin_fp32_matmul()
        if self._split_persisted is not None:
            # Mutations journaled before the first placement must reach
            # the persisted-split restore: stash their pre-mutation
            # content with the load-pending rows (this upload consumes
            # the journals). Rows drained by earlier incremental syncs
            # live only in _split_pending; for a twice-mutated row the
            # older, persisted-base-relative capture wins.
            for r, old in self._split_pending.items():
                if r not in self._split_load_pending:
                    self._split_load_pending[r] = old
            for r in self._dev_j_lex:
                if r not in self._split_load_pending:
                    self._split_load_pending[r] = self._dev_old_lex.get(
                        r, _OLD_MISSING
                    )
        emb16 = self._place(self.emb)
        self._dev = {
            "emb": emb16.to(torch.bfloat16),
            # f16 storage master when rescoring: the bf16 slab feeds the
            # scan, this one re-scores the top pool exactly.
            "emb16": emb16 if self.rescore_enabled else None,
            "term_ids": self._place(self.term_ids),
            "tfs": self._place(self.tfs),
            "doc_len": self._place(self.doc_len),
            "valid": self._place(self.valid),
            "field_cols": self._place(self.field_cols),
            # uint32 words as int32: bitwise ops are what matter.
            "tag_bits": self._place(self.tag_bits.view(np.int32)),
        }
        del emb16
        self._dev_epoch = self._epoch
        self.device_full_uploads += 1
        self._dev_j_emb.clear()
        self._dev_j_lex.clear()
        self._dev_j_meta.clear()
        self._dev_old_lex.clear()
        self._df_cache = None
        self._df_filter_cache.clear()
        self._nofilter_bias = None
        self._split = None
        self._split_pending.clear()
        self._dirty = False
        return self._dev

    # -- split-frequency BM25 layout --------------------------------------

    def _sync_split(self) -> Dict[str, Any]:
        """Head/tail split-BM25 layout, built lazily alongside the device
        tensors and maintained O(delta) between structural changes:
        small lexical deltas update the resident layout through the
        frozen-head + tail-overlay planner (lexical.plan_tail_delta)."""
        with self._sync_lock:
            return self._sync_split_locked()

    def _split_state(self, layout: Mapping[str, Any]) -> Dict[str, Any]:
        """Resident split state from a host layout (built or persisted)."""
        return {
            "lut": layout["lut"],
            "offsets": layout["offsets"],
            "r_cap": layout["r_cap"],
            "tf_head": self._place(layout["tf_head"]),
            "post_rows": self._place(layout["post_rows"]),
            "post_tfs": self._place(layout["post_tfs"]),
            # O(delta) maintenance state (see _try_split_incremental):
            # the base posting rows on the host for neutralization
            # searches, the frozen-head overlay bookkeeping, and the
            # overlay region's last serialization.
            "p_base": layout["p_base"],
            "post_rows_host": layout["post_rows"],
            "overlay": {},
            "ov_offsets": None,
            "ov_prev": (np.zeros(0, np.int32), np.zeros(0, np.uint8)),
        }

    def _sync_split_locked(self) -> Dict[str, Any]:
        self._sync_device_locked()
        if self._split is not None:
            if not self._split_pending:
                return self._split
            if self._try_split_incremental():
                self._split_pending.clear()
                return self._split

        if self._split is None and self._split_persisted is not None:
            # v2 snapshot restore: place the persisted layout and run the
            # rows the persisted deltas / pre-sync mutations touched
            # through the same O(delta) planner as live mutations.
            sp, self._split_persisted = self._split_persisted, None
            self._split = self._split_state(sp)
            self.split_snapshot_restores += 1
            # Earliest capture wins: load-pending rows were captured at
            # the persisted base state, before any live mutation.
            self._split_pending.update(self._split_load_pending)
            self._split_load_pending = {}
            if not self._split_pending:
                return self._split
            if self._try_split_incremental():
                self._split_pending.clear()
                return self._split
            self._split = None  # infeasible: fall through to full build

        self._split_pending.clear()
        self.split_full_builds += 1
        layout = build_split_layout(
            self.term_ids, self.tfs, len(self.vocab),
            head_bytes_budget=self.HEAD_BYTES_BUDGET,
            head_df_threshold=self.HEAD_DF_THRESHOLD,
            reserve=max(4096, int(self.n_rows) * 4),
        )
        if layout["n_overflow"] > 0:
            logging.getLogger(__name__).info(
                "BM25 head self-sized: df threshold %d -> %d "
                "(%d qualifying terms go to segmented tail postings)",
                self.HEAD_DF_THRESHOLD, layout["df_threshold"],
                layout["n_overflow"],
            )
        self._split = self._split_state(layout)
        return self._split

    def _try_split_incremental(self) -> bool:
        """Apply ``_split_pending`` to the resident split state O(delta);
        False → the caller falls back to the full layout rebuild."""
        split = self._split
        n_vocab = len(self.vocab)
        lut = split["lut"]
        offsets = split["offsets"]
        if n_vocab > len(lut):
            # Vocab grew: new terms are tail by construction. Host-only
            # arrays (never uploaded); new objects, so a reader holding
            # the old ones sees a consistent pair.
            lut = np.concatenate(
                [lut, np.full(n_vocab - len(lut), -1, np.int32)]
            )
            offsets = np.concatenate([
                offsets,
                np.full(n_vocab + 1 - len(offsets), offsets[-1], np.int64),
            ])
        rows = sorted(self._split_pending)
        if any(self._split_pending[r] is _OLD_MISSING for r in rows):
            return False  # uncaptured mutation (cap): rebuild
        changes = [
            (r, self._split_pending[r], (self.term_ids[r], self.tfs[r]))
            for r in rows
        ]
        room = (
            len(split["post_rows_host"]) - split["p_base"] - split["r_cap"]
        )
        plan = plan_tail_delta(
            lut, offsets, split["post_rows_host"], split["overlay"],
            changes, reserve=room, n_vocab=n_vocab,
        )
        if plan is None:
            return False
        c_pad = split["tf_head"].shape[0]
        cols = head_tf_columns(
            lut, c_pad, self.term_ids[rows], self.tfs[rows]
        )
        device_col_set(split["tf_head"], rows, cols)
        if len(plan["zero_pos"]):
            device_row_set(
                split["post_tfs"], plan["zero_pos"],
                np.zeros(len(plan["zero_pos"]), np.uint8),
            )
        # Write only the span that differs from the previous overlay
        # serialization (zero-padded, so a shrunken overlay's stale tail
        # is cleared).
        lo, hi = overlay_diff_span(
            plan["ov_rows"], plan["ov_tfs"], split["ov_prev"]
        )
        if hi > lo:
            pos = split["p_base"] + np.arange(lo, hi)
            n_new = len(plan["ov_rows"])
            rows_pad = np.zeros(hi, np.int32)
            tfs_pad = np.zeros(hi, np.uint8)
            rows_pad[: min(n_new, hi)] = plan["ov_rows"][:hi]
            tfs_pad[: min(n_new, hi)] = plan["ov_tfs"][:hi]
            device_row_set(split["post_rows"], pos, rows_pad[lo:hi])
            device_row_set(split["post_tfs"], pos, tfs_pad[lo:hi])
        split["ov_prev"] = (plan["ov_rows"], plan["ov_tfs"])
        split["ov_offsets"] = (
            plan["ov_offsets"] if int(plan["ov_offsets"][-1]) else None
        )
        split["lut"] = lut
        split["offsets"] = offsets
        return True

    def _split_query_arrays(self, q_terms: np.ndarray, q_counts: np.ndarray,
                            split: Optional[Dict[str, Any]] = None,
                            ) -> Dict[str, np.ndarray]:
        """The batch's head union and tail segment table (base and
        overlay segments alike), on the host, against ``split`` (the
        layout the step will read; by default the synced one)."""
        if split is None:
            split = self._sync_split()
        return split_query_arrays(
            split["lut"], split["offsets"], q_terms, q_counts,
            r_cap=split["r_cap"],
            ov_offsets=split["ov_offsets"],
            ov_start=split["p_base"],
        )

    def _split_query_tensors(self, q_terms: np.ndarray,
                             q_counts: np.ndarray) -> Dict[str, torch.Tensor]:
        """``_split_query_arrays`` and the query terms on the device, an
        array a copy (``bm25_topk``'s inputs)."""
        qa = self._split_query_arrays(q_terms, q_counts)
        qa = {k: qa[k] for k in STEP_COLUMNS}
        qa["q_tids"] = q_terms
        qa["q_counts"] = q_counts
        return {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for k, v in qa.items()
        }

    @property
    def vocab_pad(self) -> int:
        return _round_up(max(len(self.vocab), 1), 4096)

    def compile_filter(
        self, where: Optional[Mapping[str, Any]]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Filter dict → (wanted i32 [F], tag_want u32 [W]). Sentinels
        never narrow; unsatisfiable tags set the -2 impossible marker."""
        wanted = np.full(len(FILTER_FIELDS), -1, dtype=np.int32)
        tag_want = np.zeros(TAG_WORDS, dtype=np.uint32)
        satisfiable = True
        if where:
            for j, f in enumerate(FILTER_FIELDS):
                v = where.get(f)
                if v is None:
                    continue
                s = str(v).strip()
                # Both sentinels pass through unfiltered ("auto" is never
                # interned at ingest).
                if (
                    not s
                    or (f == "doc_type" and s.lower() == "other")
                    or (f == "language" and s.lower() == "auto")
                ):
                    continue
                wanted[j] = self.interns[f].lookup(s)
            tags = where.get("tags")
            if isinstance(tags, Mapping) and "$contains" in tags:
                tags = tags["$contains"]
            if isinstance(tags, str):
                tags = [t.strip() for t in tags.split(",") if t.strip()]
            for tag in tags or []:
                slug = slug_tag(str(tag))
                if not slug:
                    continue
                slot = self.tag_slots.get(slug)
                if slot is None or slot >= TAG_WORDS * 32:
                    satisfiable = False
                else:
                    tag_want[slot // 32] |= np.uint32(1 << (slot % 32))
        if not satisfiable:
            wanted[0] = -2  # impossible marker understood by the mask fns
        return wanted, tag_want

    def _mask_bias(self, where: Optional[Mapping[str, Any]]) -> torch.Tensor:
        dev = self._sync_device()
        if not where:
            # Hot path: no filter → validity-only bias, cached.
            if self._nofilter_bias is None:
                self._nofilter_bias = self._bias_for(
                    dev, *self.compile_filter(None)
                )
            return self._nofilter_bias
        return self._bias_for(dev, *self.compile_filter(where))

    def _bias_for(self, dev, wanted: np.ndarray,
                  tag_want: np.ndarray) -> torch.Tensor:
        return mask_bias_device(
            dev["field_cols"], dev["tag_bits"], dev["valid"],
            torch.from_numpy(wanted).to(self.device),
            torch.from_numpy(tag_want.view(np.int32)).to(self.device),
        )

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def _queries(self, query_vecs) -> torch.Tensor:
        """[Q, d] f32 on the store's device. A contiguous f32 tensor
        already there (the encoder's device output) is used as it is,
        with no copy through the host."""
        return torch.as_tensor(
            query_vecs, dtype=torch.float32
        ).to(self.device).contiguous()

    def _host_to_device(self, host: torch.Tensor) -> torch.Tensor:
        """A CPU tensor on the store's device. On CUDA the copy goes
        through pinned memory from PyTorch's caching host allocator and
        does not make the host wait for the stream (the allocator keeps
        the pinned block until the copy has run); on the CPU it is the
        tensor itself."""
        if self.device.type == "cpu":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def dense_topk(
        self,
        query_vecs,                      # [Q, d] f32 (L2-normalized)
        where: Optional[Mapping[str, Any]] = None,
        k: int = 8,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact masked scan → (scores [Q, k], rows [Q, k]; -1 past end)."""
        dev = self._sync_device()
        bias = self._mask_bias(where)
        k_eff = min(k, self.capacity)
        vals, rows = masked_topk(dev["emb"], self._queries(query_vecs),
                                 bias, k_eff)
        vals_np = vals.cpu().numpy()
        rows_np = np.where(vals_np <= NEG_INF / 2, -1, rows.cpu().numpy())
        return vals_np, rows_np

    def bm25_topk(
        self,
        query_terms: Sequence[str],
        where: Optional[Mapping[str, Any]] = None,
        k: int = 8,
        max_query_terms: int = 32,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Subset-statistics BM25 → (scores [k], rows [k]; -1 past end)."""
        dev = self._sync_device()
        bias = self._mask_bias(where)
        vpad = self.vocab_pad
        df = self._df_for_where(where or None, bias, vpad)
        q_terms, q_counts = pack_query_terms(
            self.vocab, [query_terms], max_query_terms
        )
        split = self._sync_split()
        qa = self._split_query_tensors(q_terms, q_counts)
        keep, n_sub, avgdl = subset_stats(bias, dev["doc_len"])
        scores = bm25_split_score_core(
            split["tf_head"], split["post_rows"], split["post_tfs"],
            dev["doc_len"], keep, okapi_idf(df, n_sub), avgdl,
            qa["h_slots"], qa["h_tids"], qa["u_starts"], qa["u_lens"],
            qa["u_cols"], qa["t_tids"], qa["q_tids"], qa["q_counts"],
            vocab_pad=vpad, r_cap=split["r_cap"],
        )
        vals, rows = stable_topk(scores + bias[None, :],
                                 min(k, self.capacity))
        vals_np = vals[0].cpu().numpy()
        rows_np = np.where(vals_np <= NEG_INF / 2, -1,
                           rows[0].cpu().numpy())
        return vals_np, rows_np

    def hybrid_topk_batch(
        self,
        query_vecs,                              # [B, d] f32
        query_terms_list: Sequence[Sequence[str]],
        where: Optional[Mapping[str, Any]] = None,
        **knobs: Any,
    ) -> HybridBatchResult:
        """Fused batched hybrid query; the result stays on the device
        (the caller fetches it). ``knobs`` as in ``hybrid_step_inputs``.
        While ``metrics.tracing()`` is on, the call records the span
        ``store.batch`` around ``store.inputs`` and ``step``, the step's
        queueing."""
        with metrics.span("store.batch"):
            args, kwargs = self.hybrid_step_inputs(
                query_vecs, query_terms_list, where, **knobs
            )
            with metrics.span("step"):
                return hybrid_query_step_split_packed(*args, **kwargs)

    def hybrid_step_inputs(
        self,
        query_vecs,                              # [B, d] f32
        query_terms_list: Sequence[Sequence[str]],
        where: Optional[Mapping[str, Any]] = None,
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
    ) -> Tuple[tuple, Dict[str, Any]]:
        """(args, kwargs) of ``hybrid_query_step_split_packed`` for one
        batch: the device tensors, the batch's query metadata packed into
        one i32 tensor (one host-to-device copy), and the statics and
        clamped knobs. Query vectors already on the device stay there;
        host ones make the batch's second copy.

        While ``metrics.tracing()`` is on it records ``store.inputs``
        around its stages ``store.inputs.sync`` (device tensors and split
        layout, synced once: the split arrays index the layout passed to
        the step), ``.mask``, ``.df``, ``.terms``, ``.split`` (counts
        ``tail_postings``, the live tail segments' posting entries, and
        ``tail_slots``, live segments × ``r_cap``, from the host arrays)
        and ``.pack`` (the buffer and the copies).

        On CUDA a BM25 selection wider than the card's row top-k takes
        (``select_width`` above ROW_SELECT_MAX_K: ``k_bm25`` above 256 on
        the exact route, above 64 on the approx one) raises ValueError
        here, before anything is launched."""
        width = select_width(k_bm25, self.capacity, self.select_mode)
        if self.device.type == "cuda" and width > ROW_SELECT_MAX_K:
            raise ValueError(
                f"k_bm25={k_bm25} on the {self.select_mode} route selects "
                f"{width} BM25 rows, above the {ROW_SELECT_MAX_K} the "
                "card's row top-k takes")
        with metrics.span("store.inputs"):
            with metrics.span("store.inputs.sync"):
                dev = self._sync_device()
                split = self._sync_split()
            with metrics.span("store.inputs.mask"):
                bias = self._mask_bias(where)
            vpad = self.vocab_pad
            with metrics.span("store.inputs.df"):
                df = self._df_for_where(where, bias, vpad)
            with metrics.span("store.inputs.terms"):
                q_terms, q_counts = pack_query_terms(
                    self.vocab, query_terms_list, max_query_terms
                )
            with metrics.span("store.inputs.split") as sp:
                qa = self._split_query_arrays(q_terms, q_counts, split)
                if sp is not None:
                    sp.count(tail_postings=int(qa["u_lens"].sum()),
                             tail_slots=int((qa["u_lens"] > 0).sum())
                             * split["r_cap"])
            with metrics.span("store.inputs.pack"):
                packed, statics = pack_query_arrays(
                    qa, q_terms, q_counts,
                    np.any(q_terms >= 0, axis=1, keepdims=True)
                )
                if isinstance(query_vecs, torch.Tensor) and (
                    query_vecs.device.type != "cpu"
                ):
                    q_vecs = self._queries(query_vecs)
                else:
                    q_vecs = self._host_to_device(torch.as_tensor(
                        query_vecs, dtype=torch.float32).contiguous())
                packed_dev = self._host_to_device(torch.from_numpy(packed))
        args = (
            dev["emb"], split["tf_head"], split["post_rows"],
            split["post_tfs"], dev["doc_len"], df, bias, q_vecs,
            packed_dev, dev["emb16"], dev["term_ids"], dev["tfs"],
        )
        kwargs = dict(
            **statics,
            k_vector=min(k_vector, self.capacity),
            k_bm25=min(k_bm25, self.capacity),
            top_k=top_k,
            pool=min(pool, self.capacity),
            vocab_pad=vpad,
            r_cap=split["r_cap"],
            use_mmr=use_mmr,
            mmr_lambda=mmr_lambda,
            rrf_k=rrf_k,
            weight_vector=weight_vector,
            weight_bm25=weight_bm25,
            rescore_pool=min(self.rescore_pool, self.capacity),
            select=self.select_mode,
        )
        return args, kwargs

    def device_seconds_per_batch(
        self,
        query_vecs,                              # [B, d] f32
        query_terms_list: Sequence[Sequence[str]],
        where: Optional[Mapping[str, Any]] = None,
        *,
        iters: int = 16,
        **knobs: Any,
    ) -> float:
        """The device's seconds for one fused batch, with the host out of
        the way (bench.py reports ``B / this`` as ``device_ceiling_qps``
        beside its wall QPS). The batch's inputs are made once
        (``hybrid_step_inputs``); ``iters`` calls of
        ``hybrid_query_step_split_packed``, the store's route, then run
        on them.

        The timing is ``utils.profiling.held_stream_ms``'s: on CUDA each
        call is queued behind a spin kernel between two CUDA events, and
        the result is the mean event span; a call that waited for the
        host releases the spin before it is queued, and then the seconds
        are the device time torch.profiler traces over ``iters`` calls.
        On the CPU: wall seconds a call. ``device_timing`` records which
        of "held stream", "profiler" or "wall" gave the last result."""
        args, kwargs = self.hybrid_step_inputs(
            query_vecs, query_terms_list, where, **knobs
        )
        t = held_stream_ms(
            lambda: hybrid_query_step_split_packed(*args, **kwargs), iters,
            self.device,
        )
        self.device_timing = t["timing"]
        return t.get("profiler_ms", t["ms"]) / 1e3

    def rows_to_ids(self, rows: Sequence[int]) -> List[Optional[str]]:
        """The id of each row; None past the last row or below 0."""
        return [
            self.ids[r] if 0 <= r < self.n_rows else None for r in rows
        ]

    def embeddings_for_rows(self, rows: np.ndarray) -> torch.Tensor:
        """Device gather of bf16 embedding rows (for MMR)."""
        dev = self._sync_device()
        safe = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        return dev["emb"][safe.clamp(0, self.capacity - 1)]

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------

    # Cap on chained delta files before a forced full rewrite (bounds
    # the per-cold-start apply work and the directory clutter).
    MAX_DELTAS = 128

    def _delta_paths(self) -> List[Path]:
        return sorted(self.directory.glob("lexical.delta_*.npz"))

    def save(self, catalog_fingerprint: Optional[str] = None) -> None:
        """Persist the store. With a persisted base in place and a known
        fingerprint chain, this appends ONE small delta file covering the
        rows touched since the last save — O(delta) bytes, like the
        catalog's journal — instead of rewriting the multi-GB
        embeddings + lexical snapshot at serving scale. Falls back to a
        full rewrite when the delta is large (>25% of rows), the chain is
        broken/absent, rows moved (compact), or no fingerprint is given.

        The fingerprint keys every persisted artifact to the exact
        catalog state it was derived from; load validates the full
        base→delta chain against the live catalog and rebuilds from the
        catalog on any mismatch."""
        self.directory.mkdir(parents=True, exist_ok=True)
        base_ok = (
            self._persist_fp is not None
            and (self.directory / "embeddings.npy").exists()
            and (self.directory / "rows.json").exists()
            and (self.directory / "lexical.npz").exists()
        )
        if (
            catalog_fingerprint is None
            or not base_ok
            or self._need_full_save
            or self._delta_seq >= self.MAX_DELTAS
            or len(self._dirty_rows) * 4 > max(self.n_rows, 1)
        ):
            self._full_save(catalog_fingerprint)
            return
        if not self._dirty_rows and catalog_fingerprint == self._persist_fp:
            return  # nothing changed since the last persist
        self._delta_save(catalog_fingerprint)

    # Persist the split-BM25 layout alongside the snapshot at serving
    # scale: rebuilding it at load costs O(N·L) host work serially inside
    # the first query. Below the threshold the rebuild is sub-second and
    # the extra bytes aren't worth it. The same threshold as the JAX
    # package's, so both write (and read) the same files.
    SPLIT_PERSIST_MIN_ROWS = 200_000

    def _save_slab(self, name: str, arr: np.ndarray) -> Tuple[int, int]:
        """Atomic raw-.npy slab write; returns its (size, mtime_ns)."""
        path = self.directory / name
        tmp = self.directory / (name + ".tmp")
        with tmp.open("wb") as f:
            np.save(f, arr)
        os.replace(tmp, path)
        st = path.stat()
        return (int(st.st_size), int(st.st_mtime_ns))

    def _full_save(self, catalog_fingerprint: Optional[str]) -> None:
        # Embeddings write atomically (tmp+rename — a torn np.save would
        # brick the dense base), and rows.json records the exact
        # (size, mtime_ns) of the embeddings file it indexes: ids pair
        # with embedding rows POSITIONALLY, so a crash between the two
        # renames (e.g. right after a compact() moved rows) must read as
        # "no persisted dense state", never as old ids silently zipped
        # to another save's rows.
        #
        # v2 layout: the embedding matrix (and every lexical column
        # below) persists PADDED to the slab-aligned capacity, so a warm
        # load can adopt the files as copy-on-write mmaps — byte-free
        # load, pages stream in lazily at first device upload — instead
        # of memcpying multi-GB arrays through the page cache.
        emb_path = self.directory / "embeddings.npy"
        emb_tmp = self.directory / "embeddings.npy.tmp"
        with emb_tmp.open("wb") as f:
            np.save(f, self.emb)
        os.replace(emb_tmp, emb_path)
        st = emb_path.stat()
        registry = {
            "ids": self.ids,
            "valid": [bool(v) for v in self.valid[: self.n_rows]],
            "dim": self.dim,
            "emb_stat": [int(st.st_size), int(st.st_mtime_ns)],
        }
        if self.embedding_model:
            registry["embedding_model"] = self.embedding_model
        tmp = self.directory / "rows.json.tmp"
        tmp.write_text(json.dumps(registry), encoding="utf-8")
        tmp.replace(self.directory / "rows.json")

        for p in self._delta_paths():
            p.unlink(missing_ok=True)
        self._dirty_rows.clear()
        self._delta_seq = 0
        self._need_full_save = False

        snap = self.directory / "lexical.npz"
        if catalog_fingerprint is None:
            # Without a fingerprint a stale snapshot must not survive.
            snap.unlink(missing_ok=True)
            self._persist_fp = None
            return
        vocab_terms = sorted(self.vocab, key=self.vocab.__getitem__)
        # v2: big columns as raw padded .npy slabs (mmap-adoptable, see
        # class comment above); the npz keeps only the small derived
        # state + the (size, mtime_ns) binding of every slab file.
        slab_stats = {
            "lexical.term_ids.npy": self._save_slab(
                "lexical.term_ids.npy", self.term_ids
            ),
            "lexical.tfs.npy": self._save_slab("lexical.tfs.npy", self.tfs),
            "lexical.doc_len.npy": self._save_slab(
                "lexical.doc_len.npy", self.doc_len
            ),
            "lexical.field_cols.npy": self._save_slab(
                "lexical.field_cols.npy", self.field_cols
            ),
            "lexical.tag_bits.npy": self._save_slab(
                "lexical.tag_bits.npy", self.tag_bits
            ),
        }
        extra: Dict[str, Any] = {}
        if self.n_rows >= self.SPLIT_PERSIST_MIN_ROWS:
            # Serving scale: ship the split-BM25 layout with the
            # snapshot so the first query does not rebuild it.
            layout = build_split_layout(
                self.term_ids, self.tfs, len(self.vocab),
                head_bytes_budget=self.HEAD_BYTES_BUDGET,
                head_df_threshold=self.HEAD_DF_THRESHOLD,
                reserve=max(4096, int(self.n_rows) * 4),
            )
            slab_stats["split.tf_head.npy"] = self._save_slab(
                "split.tf_head.npy", layout["tf_head"]
            )
            slab_stats["split.post_rows.npy"] = self._save_slab(
                "split.post_rows.npy", layout["post_rows"]
            )
            slab_stats["split.post_tfs.npy"] = self._save_slab(
                "split.post_tfs.npy", layout["post_tfs"]
            )
            extra.update(
                split_lut=layout["lut"],
                split_offsets=layout["offsets"],
                split_r_cap=np.int64(layout["r_cap"]),
                split_p_base=np.int64(layout["p_base"]),
            )
        else:
            for name in ("split.tf_head.npy", "split.post_rows.npy",
                         "split.post_tfs.npy"):
                (self.directory / name).unlink(missing_ok=True)
        tmp_snap = self.directory / "lexical.npz.tmp"
        with tmp_snap.open("wb") as f:
            np.savez(
                f,
                fingerprint=np.str_(catalog_fingerprint),
                term_width=np.int64(self.term_width),
                capacity=np.int64(self.capacity),
                slab_stats=np.str_(json.dumps(slab_stats)),
                # Corpus df over valid rows: restoring it skips the
                # one-time O(N·L) host rebuild on the next cold start
                # (deltas maintain it incrementally on load).
                df=self._ensure_df_host(),
                vocab_blob=np.str_("\n".join(vocab_terms)),
                interns=np.str_(json.dumps(
                    {f: t.to_id for f, t in self.interns.items()}
                )),
                tag_slots=np.str_(json.dumps(self.tag_slots)),
                **extra,
            )
        tmp_snap.replace(snap)
        self._persist_fp = catalog_fingerprint
        self._persist_vocab = len(self.vocab)

    def _delta_save(self, catalog_fingerprint: str) -> None:
        """Append lexical.delta_NNNN.npz: the touched rows' full column
        state + registry/vocab extensions, chained by catalog
        fingerprints (prev -> this)."""
        rows = np.asarray(sorted(self._dirty_rows), np.int64)
        rows = rows[rows < self.n_rows]
        # Vocab delta, not the full table: only terms interned since the
        # last persist (term ids are append-only), so a delta stays
        # O(touched rows), not O(vocab).
        all_terms = sorted(self.vocab, key=self.vocab.__getitem__)
        vocab_new = all_terms[self._persist_vocab:]
        path = self.directory / f"lexical.delta_{self._delta_seq:04d}.npz"
        tmp = path.with_suffix(".npz.tmp")
        with tmp.open("wb") as f:
            np.savez(
                f,
                prev_fingerprint=np.str_(self._persist_fp),
                fingerprint=np.str_(catalog_fingerprint),
                dim=np.int64(self.dim),
                term_width=np.int64(self.term_width),
                rows=rows,
                row_ids=np.str_("\n".join(self.ids[r] for r in rows)),
                valid=self.valid[rows],
                emb=self.emb[rows],
                term_ids=self.term_ids[rows],
                tfs=self.tfs[rows],
                doc_len=self.doc_len[rows],
                field_cols=self.field_cols[:, rows],
                tag_bits=self.tag_bits[rows],
                n_rows=np.int64(self.n_rows),
                vocab_from=np.int64(self._persist_vocab),
                vocab_new=np.str_("\n".join(vocab_new)),
                interns=np.str_(json.dumps(
                    {f: t.to_id for f, t in self.interns.items()}
                )),
                tag_slots=np.str_(json.dumps(self.tag_slots)),
            )
        tmp.replace(path)
        self._dirty_rows.clear()
        self._delta_seq += 1
        self._persist_fp = catalog_fingerprint
        self._persist_vocab = len(self.vocab)

    def _apply_delta(self, path: Path) -> bool:
        """Apply one persisted delta onto the in-memory state. Chain
        validation happened before; returns False on structural
        mismatch."""
        with np.load(path, allow_pickle=False) as z:
            if (int(z["dim"]) != self.dim
                    or int(z["term_width"]) != self.term_width):
                return False
            rows = z["rows"]
            blob = str(z["row_ids"])
            row_ids = blob.split("\n") if blob else []
            if len(row_ids) != len(rows):
                return False
            n_after = int(z["n_rows"])
            self._grow_to(max(n_after, 1))
            # Registry extension: new rows always appended contiguously.
            fresh_rows = set()
            for r, cid in zip(rows, row_ids):
                r = int(r)
                if r < len(self.ids):
                    if self.ids[r] != cid:
                        return False
                elif r == len(self.ids):
                    self.ids.append(cid)
                    self.id_to_row[cid] = r
                    fresh_rows.add(r)
                else:
                    return False
            if self._split_persisted is not None:
                # The persisted split layout was built at the BASE
                # state: first-touch capture of each delta row's
                # pre-delta lexical content so _sync_split can apply the
                # delta through the O(delta) planner instead of a full
                # rebuild (None = fresh slot, nothing to neutralize).
                for r in rows:
                    r = int(r)
                    if r not in self._split_load_pending:
                        self._split_load_pending[r] = (
                            None if r in fresh_rows else (
                                self.term_ids[r].copy(),
                                self.tfs[r].copy(),
                            )
                        )
            if len(self.ids) != n_after:
                return False
            if self._df_host is not None:
                # Maintain the restored corpus df through the delta:
                # subtract the touched rows' pre-delta live
                # contributions (base tids are always within the base
                # vocab the df was saved at)...
                old_ids = self.term_ids[rows]
                old_live = (
                    (old_ids >= 0) & (self.tfs[rows] > 0)
                    & self.valid[rows][:, None]
                )
                sel = old_ids[old_live]
                if len(sel):
                    self._df_host -= np.bincount(
                        sel, minlength=len(self._df_host)
                    )[: len(self._df_host)]
            self.valid[rows] = z["valid"]
            self.emb[rows] = z["emb"]
            self.term_ids[rows] = z["term_ids"]
            self.tfs[rows] = z["tfs"]
            self.doc_len[rows] = z["doc_len"]
            self.field_cols[:, rows] = z["field_cols"]
            self.tag_bits[rows] = z["tag_bits"]
            vocab_from = int(z["vocab_from"])
            if vocab_from != len(self.vocab):
                return False
            blob_v = str(z["vocab_new"])
            for t in (blob_v.split("\n") if blob_v else []):
                self.vocab[t] = len(self.vocab)
            if self._df_host is not None:
                # ... then add the post-delta contributions (the vocab
                # extension above may have introduced new tids).
                new_ids = np.asarray(z["term_ids"])
                new_live = (
                    (new_ids >= 0) & (np.asarray(z["tfs"]) > 0)
                    & np.asarray(z["valid"], bool)[:, None]
                )
                sel = new_ids[new_live]
                if len(sel):
                    add = np.bincount(
                        sel, minlength=max(len(self.vocab), 1)
                    )
                    if len(add) > len(self._df_host):
                        self._df_host = np.concatenate([
                            self._df_host,
                            np.zeros(
                                len(add) - len(self._df_host), np.int64
                            ),
                        ])
                    self._df_host[: len(add)] += add
            interns = json.loads(str(z["interns"]))
            for f_name, mapping in interns.items():
                if f_name in self.interns:
                    self.interns[f_name].to_id = {
                        k: int(v) for k, v in mapping.items()
                    }
            self.tag_slots = {
                k: int(v)
                for k, v in json.loads(str(z["tag_slots"])).items()
            }
        return True

    def _load_snapshot(self, expected_fp) -> bool:
        """Restore the derived columns from lexical.npz when its recorded
        fingerprint matches ``expected_fp`` (the live catalog fingerprint
        — possibly via the catalog's fold alias — or, when persisted
        deltas exist, the chain's base fingerprint). Returns True on
        success."""
        snap = self.directory / "lexical.npz"
        if not snap.exists():
            return False
        if isinstance(expected_fp, str):
            expected_fp = {expected_fp}
        try:
            with np.load(snap, allow_pickle=False) as z:
                if "term_ids" not in z.files:
                    return False  # v2 snapshot: _adopt_snapshot_v2 owns it
                snap_fp = str(z["fingerprint"])
                if snap_fp not in expected_fp:
                    return False
                if int(z["term_width"]) != self.term_width:
                    return False
                n = z["term_ids"].shape[0]
                if n != self.n_rows:
                    return False
                self.term_ids[:n] = z["term_ids"]
                self.tfs[:n] = z["tfs"]
                self.doc_len[:n] = z["doc_len"]
                self.field_cols[:, :n] = z["field_cols"]
                self.tag_bits[:n] = z["tag_bits"]
                vocab_blob = str(z["vocab_blob"])
                terms = vocab_blob.split("\n") if vocab_blob else []
                self.vocab = {t: i for i, t in enumerate(terms)}
                interns = json.loads(str(z["interns"]))
                for f_name, mapping in interns.items():
                    if f_name in self.interns:
                        self.interns[f_name].to_id = {
                            k: int(v) for k, v in mapping.items()
                        }
                self.tag_slots = {
                    k: int(v)
                    for k, v in json.loads(str(z["tag_slots"])).items()
                }
                if "df" in z.files:
                    self._df_host = z["df"].astype(np.int64)
            self._snap_fp = snap_fp
            return True
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            return False

    def _adopt_snapshot_v2(self, expected_fp, emb: np.ndarray,
                           ids: List[str], valid: List[bool],
                           n: int) -> bool:
        """Adopt a v2 slab snapshot: every big column becomes a
        copy-on-write mmap of its padded on-disk file — the load touches
        ~no bytes; pages stream in lazily at the first device upload
        (the runtime's background warm-up places them).
        ``emb`` must be the embeddings.npy mmap opened with
        mmap_mode='c'. Returns False → caller takes the v1/cold paths."""
        snap = self.directory / "lexical.npz"
        if not snap.exists():
            return False
        if isinstance(expected_fp, str):
            expected_fp = {expected_fp}
        id_to_row = {cid: i for i, cid in enumerate(ids[:n])}
        if len(id_to_row) != n:
            return False  # duplicate ids: slow path owns this
        try:
            with np.load(snap, allow_pickle=False) as z:
                if "slab_stats" not in z.files:
                    return False  # v1 snapshot
                snap_fp = str(z["fingerprint"])
                if snap_fp not in expected_fp:
                    return False
                if int(z["term_width"]) != self.term_width:
                    return False
                cap = int(z["capacity"])
                if cap % self.slab_rows or cap < max(n, 1):
                    return False
                if emb.ndim != 2 or emb.shape != (cap, self.dim):
                    return False
                stats = json.loads(str(z["slab_stats"]))
                arrs: Dict[str, np.ndarray] = {}
                for name, want in stats.items():
                    p = self.directory / name
                    st = p.stat()
                    if [int(v) for v in want] != [
                        int(st.st_size), int(st.st_mtime_ns)
                    ]:
                        return False
                    arrs[name] = np.load(p, mmap_mode="c")
                ti = arrs["lexical.term_ids.npy"]
                tf = arrs["lexical.tfs.npy"]
                dl = arrs["lexical.doc_len.npy"]
                fc = arrs["lexical.field_cols.npy"]
                tb = arrs["lexical.tag_bits.npy"]
                if (
                    ti.shape != (cap, self.term_width)
                    or tf.shape != (cap, self.term_width)
                    or dl.shape != (cap,)
                    or fc.shape != (len(FILTER_FIELDS), cap)
                    or tb.shape != (cap, TAG_WORDS)
                ):
                    return False
                split = None
                if "split.tf_head.npy" in arrs and "split_lut" in z.files:
                    split = {
                        "lut": np.asarray(z["split_lut"]),
                        "offsets": np.asarray(z["split_offsets"]),
                        "r_cap": int(z["split_r_cap"]),
                        "p_base": int(z["split_p_base"]),
                        "tf_head": arrs["split.tf_head.npy"],
                        "post_rows": arrs["split.post_rows.npy"],
                        "post_tfs": arrs["split.post_tfs.npy"],
                    }
                    if split["tf_head"].shape[1] != cap:
                        split = None
                vocab_blob = str(z["vocab_blob"])
                terms = vocab_blob.split("\n") if vocab_blob else []
                vocab = {t: i for i, t in enumerate(terms)}
                interns = json.loads(str(z["interns"]))
                tag_slots = {
                    k: int(v)
                    for k, v in json.loads(str(z["tag_slots"])).items()
                }
                df = (
                    z["df"].astype(np.int64) if "df" in z.files else None
                )
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            return False
        # Commit — everything validated.
        self.ids = list(ids[:n])
        self.id_to_row = id_to_row
        self.emb = emb
        self.term_ids = ti
        self.tfs = tf
        self.doc_len = dl
        self.field_cols = fc
        self.tag_bits = tb
        self.valid = np.zeros(cap, dtype=bool)
        self.valid[:n] = np.asarray(valid[:n], bool)
        self.vocab = vocab
        for f_name, mapping in interns.items():
            if f_name in self.interns:
                self.interns[f_name].to_id = {
                    k: int(v) for k, v in mapping.items()
                }
        self.tag_slots = tag_slots
        self._df_host = df
        self._split_persisted = split
        self._snap_fp = snap_fp
        return True

    def _restore_embeddings(self, ids: List[str], emb: np.ndarray,
                            n: int) -> None:
        """Registry/embedding restore shared by the snapshot path and the
        cold rebuild: positional ids[:n] ↔ emb rows."""
        self._grow_to(max(n, 1))
        id_to_row = {cid: i for i, cid in enumerate(ids[:n])}
        if len(id_to_row) == n:
            # Registry ids are unique (always true for our own saves):
            # vectorized restore — one slice copy instead of n per-row
            # copies (seconds vs minutes at 1M rows).
            self.ids = list(ids[:n])
            self.id_to_row = id_to_row
            self.emb[:n] = emb[:n]
        else:
            for i in range(n):
                row = self._row_for(ids[i])
                self.emb[row] = emb[i]

    @classmethod
    def load_or_create(
        cls,
        dim: int,
        directory: str | Path,
        catalog: Catalog,
        slab_rows: int = 4096,
        terms_per_chunk: int = 192,
        rescore: str = "auto",
        rescore_pool: int = 32,
        select: str = "auto",
        device: DeviceLike = None,
    ) -> "IndexStore":
        """Restore embeddings from disk; rebuild lexical/meta columns from
        the catalog (tokens and metadata live there)."""
        store = cls(dim, directory, slab_rows, terms_per_chunk,
                    rescore=rescore, rescore_pool=rescore_pool,
                    select=select, device=device)
        reg_path = Path(directory) / "rows.json"
        emb_path = Path(directory) / "embeddings.npy"
        if not (reg_path.exists() and emb_path.exists()):
            return store
        try:
            registry = json.loads(reg_path.read_text(encoding="utf-8"))
            # Copy-on-write mmap: the v2 fast path ADOPTS this as the
            # live emb slab (writes stay in RAM; zero bytes touched at
            # load); the v1 copy path just streams pages through it.
            emb = np.load(emb_path, mmap_mode="c")
        except (OSError, ValueError, json.JSONDecodeError):
            return store
        if emb.ndim != 2 or emb.shape[1] != dim:
            return store
        emb_stat = registry.get("emb_stat")
        if emb_stat is not None:
            st = emb_path.stat()
            if [int(v) for v in emb_stat] != [
                int(st.st_size), int(st.st_mtime_ns)
            ]:
                # The registry indexes a DIFFERENT embeddings file than
                # the one on disk (crash between the two renames of
                # _full_save): positional id↔row pairing would be silent
                # garbage. Treat as no persisted dense state — the
                # caller rebuilds from the catalog (+ embedding cache).
                return store
        ids = list(registry.get("ids") or [])
        valid = list(registry.get("valid") or [])
        store.embedding_model = registry.get("embedding_model") or None
        n = min(len(ids), emb.shape[0], len(valid))

        # Persisted deltas (O(delta) saves since the last full rewrite):
        # the chain base_fp -> delta_0 -> ... -> delta_last must end at
        # the live catalog fingerprint, else everything persisted is
        # stale and the store rebuilds from the catalog.
        live_fp = catalog.fingerprint()
        # A catalog journal FOLD rewrites bytes without changing logical
        # content: artifacts keyed to the pre-fold fingerprint are still
        # derived from exactly this catalog's entries.
        accept = {live_fp}
        alias = getattr(catalog, "fold_alias", None)
        if alias and alias[1] == live_fp:
            accept.add(alias[0])
        delta_paths = store._delta_paths()
        expected_fp, chain = accept, []
        chain_tail: Optional[str] = None
        if delta_paths:
            chain_fps = []
            try:
                for p in delta_paths:
                    with np.load(p, allow_pickle=False) as z:
                        chain_fps.append(
                            (str(z["prev_fingerprint"]), str(z["fingerprint"]))
                        )
            except (OSError, ValueError, KeyError):
                chain_fps = None
            ok = (
                chain_fps is not None
                and chain_fps[-1][1] in accept
                and all(
                    chain_fps[i][1] == chain_fps[i + 1][0]
                    for i in range(len(chain_fps) - 1)
                )
            )
            if ok:
                expected_fp = {chain_fps[0][0]}
                chain = delta_paths
                chain_tail = chain_fps[-1][1]

        def finish_snapshot_load(st: "IndexStore") -> bool:
            """Apply the delta chain + the final catalog-validity
            recheck; returns False when a delta fails structurally."""
            for p in chain:
                if not st._apply_delta(p):
                    return False
            # Final validity recheck (row alive AND catalog entry
            # present): a bulk membership test — no entry-body reads
            # (the disk-backed catalog fetches bodies lazily).
            m = st.n_rows
            present = np.asarray(catalog.contains_many(st.ids[:m]), bool)
            if st._df_host is not None:
                flipped = np.nonzero(st.valid[:m] & ~present)[0]
                for r in flipped:  # normally empty (torn saves only)
                    st._df_note(st.term_ids[r], st.tfs[r], -1)
            st.valid[:m] &= present
            st._dirty = True
            # Chain the NEXT delta from what is on disk: the chain's
            # last fingerprint, or the snapshot's own recorded one —
            # either may be the PRE-fold fp accepted via the catalog's
            # fold alias. Keying to live_fp here would orphan every
            # persisted artifact at the load after the next delta save
            # (snapshot fp != the chain base it implies) and force a
            # cold O(N·L) rebuild.
            st._persist_fp = chain_tail if chain else st._snap_fp
            st._persist_vocab = len(st.vocab)
            st._delta_seq = len(chain)
            return True

        # v2 snapshot: adopt every persisted slab as a copy-on-write
        # mmap (zero-copy load; pages stream in at first device upload).
        if store._adopt_snapshot_v2(expected_fp, emb, ids, valid, n):
            if finish_snapshot_load(store):
                return store
            # A delta failed structurally: fresh store, cold paths below.
            store = cls(dim, directory, slab_rows, terms_per_chunk,
                        rescore=rescore, rescore_pool=rescore_pool,
                        select=select, device=device)

        store._restore_embeddings(ids, emb, n)
        if store._load_snapshot(expected_fp):
            # Registry validity first; deltas then overwrite the flags of
            # any rows they touched (a delta is newer than the base
            # registry).
            store.valid[:n] = np.asarray(valid[:n], bool)
            if finish_snapshot_load(store):
                return store
            # A delta failed structurally: fall through to cold rebuild.
            store = cls(dim, directory, slab_rows, terms_per_chunk,
                        rescore=rescore, rescore_pool=rescore_pool,
                        select=select, device=device)
            store._restore_embeddings(ids, emb, n)

        # Cold rebuild (no snapshot): stream the catalog ONCE instead of
        # n random per-id fetches — the disk-backed catalog reads
        # sequentially through items().
        wanted = set(ids[:n])
        by_id = {cid: e for cid, e in catalog.items() if cid in wanted}
        entries = [by_id.get(cid) for cid in ids[:n]]
        with_tokens = [i for i in range(n) if entries[i] is not None]
        if with_tokens:
            t_ids_b, t_tfs_b, dl_b = store._pack_rows(
                [entries[i].tokens for i in with_tokens]
            )
        packed_pos = {i: j for j, i in enumerate(with_tokens)}
        for i in range(n):
            cid = ids[i]
            entry = entries[i]
            alive = bool(valid[i]) and entry is not None
            row = store._row_for(cid)
            if entry is not None:
                j = packed_pos[i]
                store.term_ids[row] = t_ids_b[j]
                store.tfs[row] = t_tfs_b[j]
                store.doc_len[row] = dl_b[j]
                fields, bits = store._pack_row_metadata(entry.metadata)
                store.field_cols[:, row] = fields
                store.tag_bits[row] = bits
            store.valid[row] = alive
        store._dirty = True
        return store
