"""Unified index: one row space for dense + lexical + metadata (port of
the JAX package's ``index/store.py``).

The host keeps the master arrays (f16 embeddings, packed [N, L] term
ids/tfs, doc lengths, interned metadata columns, tag bits, validity);
``_sync_device`` places them on the store's device: one f16 upload, the
bf16 scan slab derived there. Capacity grows geometrically in slab
multiples, exactly as in the reference, so both packages see the same
row space.

In this slice any mutation after a sync re-uploads everything and
rebuilds the split-BM25 layout on the next query; ``device_full_uploads``
and ``split_full_builds`` count those O(corpus) paths. The reference's
O(delta) device sync, persistence and sharded journal are not ported yet.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from classmate_rag_tpu_torch.device import (
    DeviceLike,
    pin_fp32_matmul,
    resolve_device,
)
from classmate_rag_tpu_torch.index.filters import (
    FILTER_FIELDS,
    TAG_WORDS,
    InternTable,
    mask_bias_device,
)
from classmate_rag_tpu_torch.index.lexical import (
    bm25_split_score_core,
    build_split_layout,
    okapi_idf,
    pack_query_terms,
    pack_tokens,
    split_query_arrays,
    subset_df,
    subset_stats,
)
from classmate_rag_tpu_torch.metadata.validation import (
    slug_tag,
    tags_from_meta,
)
from classmate_rag_tpu_torch.ops.hybrid_step import (
    HybridBatchResult,
    hybrid_query_step_split,
)
from classmate_rag_tpu_torch.ops.topk import masked_topk, stable_topk
from classmate_rag_tpu_torch.utils.numerics import NEG_INF
from classmate_rag_tpu_torch.utils.numerics import round_up as _round_up

# Host arrays a store is made of, with their dtypes (see from_host_state
# and host_state).
_ARRAYS = {
    "emb": np.float16, "term_ids": np.int32, "tfs": np.uint8,
    "doc_len": np.float32, "valid": bool, "field_cols": np.int32,
    "tag_bits": np.uint32,
}


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
        slab_rows: int = 4096,
        terms_per_chunk: int = 192,
        rescore: str = "auto",          # auto | on | off
        rescore_pool: int = 32,
        select: str = "auto",           # auto | exact | approx
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.dim = dim
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

        self._dev: Dict[str, Any] = {}
        self._split: Optional[Dict[str, Any]] = None
        self._dirty = True
        # Host-maintained corpus df over valid rows (i64 [len(vocab)]):
        # built once, then kept O(delta) by upsert/delete. Its device
        # copy (_df_cache) is a KB-scale upload, never a device histogram.
        self._df_host: Optional[np.ndarray] = None
        self._df_cache: Optional[torch.Tensor] = None
        # Per-filter subset-df LRU; cleared on any mutation.
        self._df_filter_cache: "OrderedDict[tuple, torch.Tensor]" = (
            OrderedDict()
        )
        self._nofilter_bias: Optional[torch.Tensor] = None
        # Two readers noticing _dirty together must not both upload.
        self._sync_lock = threading.RLock()
        # How often the O(corpus) paths ran.
        self.device_full_uploads = 0
        self.split_full_builds = 0
        self.df_full_builds = 0

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

    def _pack_rows(self, tokens_list: Sequence[Sequence[str]]):
        """Batch (term_ids [B, W] i32, tfs [B, W] u8, doc_len [B] f32),
        interning new terms in first-seen order."""
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
        bincount over the packed term matrix, once per store."""
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
            self._df_filter_cache.move_to_end(key)
            return hit
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
            lex_changed = fresh or not (
                np.array_equal(self.term_ids[row], t_ids_b[i])
                and np.array_equal(self.tfs[row], t_tfs_b[i])
                and self.doc_len[row] == dl_b[i]
            )
            # O(delta) corpus-df maintenance: subtract the row's old
            # contribution (when it was live), add the new — before the
            # overwrites below. Lazy until first built.
            if self._df_host is not None and (
                lex_changed or not self.valid[row]
            ):
                if not fresh and self.valid[row]:
                    self._df_note(self.term_ids[row], self.tfs[row], -1)
                self._df_note(t_ids_b[i], t_tfs_b[i], +1)
                self._df_cache = None
            self.emb[row] = embeddings[i].astype(np.float16)
            self.term_ids[row] = t_ids_b[i]
            self.tfs[row] = t_tfs_b[i]
            self.doc_len[row] = dl_b[i]
            fields, bits = self._pack_row_metadata(metadatas[i] or {})
            self.field_cols[:, row] = fields
            self.tag_bits[row] = bits
            self.valid[row] = True
        # Any mutation moves filtered-subset membership.
        self._df_filter_cache.clear()
        self._dirty = True
        return len(ids)

    def _pack_row_metadata(self, meta: Mapping[str, Any]):
        """Interned filter-field ids [F] + packed tag bitmask [W] for one
        row (``tags_from_meta`` reads ``tag_<slug>`` flags and legacy
        tags lists)."""
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
                n += 1
        if n:
            self._dirty = True
            self._df_cache = None
            self._df_filter_cache.clear()
        return n

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

    def _sync_device(self) -> Dict[str, Any]:
        if not self._dirty and self._dev:
            return self._dev
        with self._sync_lock:
            if not self._dirty and self._dev:
                return self._dev  # another reader synced while we waited
            return self._upload()

    def _upload(self) -> Dict[str, Any]:
        """Structural upload of every host array (one f16 embedding
        upload; the bf16 scan slab is derived on the device)."""
        dev = self.device
        if dev.type == "cuda":
            pin_fp32_matmul()
        emb16 = torch.from_numpy(self.emb).to(dev)
        self._dev = {
            "emb": emb16.to(torch.bfloat16),
            # f16 storage master when rescoring: the bf16 slab feeds the
            # scan, this one re-scores the top pool exactly.
            "emb16": emb16 if self.rescore_enabled else None,
            "term_ids": torch.from_numpy(self.term_ids).to(dev),
            "tfs": torch.from_numpy(self.tfs).to(dev),
            "doc_len": torch.from_numpy(self.doc_len).to(dev),
            "valid": torch.from_numpy(self.valid).to(dev),
            "field_cols": torch.from_numpy(self.field_cols).to(dev),
            # uint32 words as int32: bitwise ops are what matter.
            "tag_bits": torch.from_numpy(
                self.tag_bits.view(np.int32)
            ).to(dev),
        }
        self.device_full_uploads += 1
        self._df_cache = None
        self._df_filter_cache.clear()
        self._nofilter_bias = None
        self._split = None
        self._dirty = False
        return self._dev

    def _sync_split(self) -> Dict[str, Any]:
        """Head/tail split-BM25 layout, rebuilt in full after any
        mutation (lexical.build_split_layout) and placed on the device."""
        with self._sync_lock:
            self._sync_device()
            if self._split is not None:
                return self._split
            self.split_full_builds += 1
            layout = build_split_layout(
                self.term_ids, self.tfs, len(self.vocab),
                head_bytes_budget=self.HEAD_BYTES_BUDGET,
                head_df_threshold=self.HEAD_DF_THRESHOLD,
            )
            if layout["n_overflow"] > 0:
                logging.getLogger(__name__).info(
                    "BM25 head self-sized: df threshold %d -> %d "
                    "(%d qualifying terms go to segmented tail postings)",
                    self.HEAD_DF_THRESHOLD, layout["df_threshold"],
                    layout["n_overflow"],
                )
            dev = self.device
            self._split = {
                "lut": layout["lut"],
                "offsets": layout["offsets"],
                "r_cap": layout["r_cap"],
                "tf_head": torch.from_numpy(layout["tf_head"]).to(dev),
                "post_rows": torch.from_numpy(layout["post_rows"]).to(dev),
                "post_tfs": torch.from_numpy(layout["post_tfs"]).to(dev),
            }
            return self._split

    def _split_query_tensors(self, q_terms: np.ndarray,
                             q_counts: np.ndarray) -> Dict[str, torch.Tensor]:
        """The batch's head union and tail segment table, on the device."""
        split = self._sync_split()
        qa = split_query_arrays(
            split["lut"], split["offsets"], q_terms, q_counts,
            r_cap=split["r_cap"],
        )
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
        (the caller fetches it). ``knobs`` as in ``hybrid_step_inputs``."""
        args, kwargs = self.hybrid_step_inputs(
            query_vecs, query_terms_list, where, **knobs
        )
        return hybrid_query_step_split(*args, **kwargs)

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
        """(args, kwargs) of ``hybrid_query_step_split`` for one batch:
        the device tensors and the clamped knobs."""
        dev = self._sync_device()
        bias = self._mask_bias(where)
        vpad = self.vocab_pad
        df = self._df_for_where(where, bias, vpad)
        q_terms, q_counts = pack_query_terms(
            self.vocab, query_terms_list, max_query_terms
        )
        split = self._sync_split()
        qa = self._split_query_tensors(q_terms, q_counts)
        has_terms = torch.from_numpy(
            np.any(q_terms >= 0, axis=1, keepdims=True)
        ).to(self.device)
        args = (
            dev["emb"], split["tf_head"], split["post_rows"],
            split["post_tfs"], dev["doc_len"], df, bias,
            self._queries(query_vecs),
            qa["h_slots"], qa["h_tids"], qa["u_starts"], qa["u_lens"],
            qa["u_cols"], qa["t_tids"], qa["q_tids"], qa["q_counts"],
            has_terms, dev["emb16"], dev["term_ids"], dev["tfs"],
        )
        kwargs = dict(
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

    def rows_to_ids(self, rows: Sequence[int]) -> List[Optional[str]]:
        return [
            self.ids[r] if 0 <= r < self.n_rows else None for r in rows
        ]
