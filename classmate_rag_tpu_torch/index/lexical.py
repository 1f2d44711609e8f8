"""BM25 tokenization, the split-frequency layout, and its scoring on
tensors (port of the JAX package's ``index/lexical.py``).

The host half (tokenizer, packers, split-layout builder) is a copy of
the JAX package's numpy code and gives identical arrays. The device half
is plain PyTorch:

    score(n) = Σ_l  w[term_ids[n, l]] · sat(tfs[n, l], dl_n)

with BM25Okapi's k1=1.5, b=0.75 and the negative-idf ε rule, all corpus
statistics (df, avgdl) taken over the *filtered subset* of rows.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from classmate_rag_tpu_torch import native as _native
from classmate_rag_tpu_torch.utils.numerics import round_up as _round_up

K1 = 1.5
B = 0.75
EPSILON = 0.25

_TOKEN_RE = re.compile(r"[A-Za-zÀ-ÖØ-öø-ÿ]+")

# High-frequency function words; matching the reference's intent (and EN/IT
# coverage) — removal must agree between index and query time for parity.
STOPWORDS_EN = frozenset(
    """a an the and or but if then else for to of in on at by with from as is
    are was were be been being it its this that these those i you he she we
    they them his her their my your our me us not no yes do does did doing
    can could should would may might will shall about into over under again
    further there here when where why how what which who whom""".split()
)
STOPWORDS_IT = frozenset(
    """un uno una le la il lo gli i l e o ma se allora altrimenti per di a da
    in su con come è era sono siamo siete fui fu furono essere stato questo
    questa questi queste quello quella quelli quelle ciò cio io tu lui lei
    noi voi loro mio mia tuo tua suo sua nostro vostro non no si sia fare fa
    fatto posso può puo puoi possono dovrebbe potrebbe sarà sara sarebbe
    saremmo sarete siano che perché perche quando dove cosa quale chi""".split()
)


def stopwords_for(lang: Optional[str]) -> frozenset:
    lang = (lang or "").lower()
    if lang.startswith("it"):
        return STOPWORDS_IT
    return STOPWORDS_EN


def tokenize_py(text: str, lang: Optional[str] = None) -> List[str]:
    """Pure-Python tokenizer (reference implementation / fallback)."""
    sw = stopwords_for(lang)
    return [
        t for t in (m.group(0).lower() for m in _TOKEN_RE.finditer(text or ""))
        if len(t) > 1 and t not in sw
    ]


def tokenize(text: str, lang: Optional[str] = None) -> List[str]:
    """Lowercased unicode-letter tokens minus stopwords and 1-char tokens:
    the C++ tokenizer (``native/``) when its library loads, else
    ``tokenize_py``, with identical results either way."""
    tok = _native.get_native_tokenizer()
    if tok is not None:
        return tok.tokenize(text, lang)
    return tokenize_py(text, lang)


def pack_tokens(
    tokens: Sequence[str],
    vocab: Dict[str, int],
    width: int,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Count term frequencies, intern terms, pack into fixed-width arrays.

    Returns (term_ids i32 [width] −1-padded, tfs u8 [width], doc_len).
    When a chunk has more distinct terms than ``width`` the highest-tf terms
    win (first-seen order breaks ties). doc_len counts all tokens (matching
    BM25Okapi's ``len(document)``).
    """
    counts: Dict[str, int] = {}
    for t in tokens:
        counts[t] = counts.get(t, 0) + 1
    items = list(counts.items())
    if len(items) > width:
        items.sort(key=lambda kv: -kv[1])  # stable: first-seen wins ties
        items = items[:width]
    ids = np.full(width, -1, dtype=np.int32)
    tfs = np.zeros(width, dtype=np.uint8)
    for j, (term, tf) in enumerate(items):
        tid = vocab.get(term)
        if tid is None:
            tid = len(vocab)
            vocab[term] = tid
        ids[j] = tid
        tfs[j] = min(tf, 255)
    return ids, tfs, float(len(tokens))


def pack_query_terms(
    vocab: Dict[str, int],
    term_lists: Sequence[Sequence[str]],
    max_terms: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vocab-known query terms → fixed-width (q_terms i32 [B, M] −1-padded,
    q_counts f32 [B, M] multiplicities). The single definition of the
    query-side truncation/multiplicity semantics — every scoring entry
    point (store, sharded serving, benches) must agree on it."""
    b = len(term_lists)
    q_terms = np.full((b, max_terms), -1, dtype=np.int32)
    q_counts = np.zeros((b, max_terms), dtype=np.float32)
    for i, terms in enumerate(term_lists):
        counts: Dict[int, float] = {}
        for t in terms:
            tid = vocab.get(t)
            if tid is not None:
                counts[tid] = counts.get(tid, 0.0) + 1.0
        for j, (tid, c) in enumerate(list(counts.items())[:max_terms]):
            q_terms[i, j] = tid
            q_counts[i, j] = c
    return q_terms, q_counts

# ---------------------------------------------------------------------------
# Split-frequency layout (host-side build)
# ---------------------------------------------------------------------------

# Tail posting windows are sliced in fixed segments of this many entries;
# a term with a longer list occupies several segments (disjoint rows, same
# weight — contributions sum exactly). This caps the slice width r_cap no
# matter how many high-df terms overflow the head budget.
TAIL_SEG_CAP = 512


def build_split_layout(
    term_ids: np.ndarray,       # i32 [cap, L]
    tfs: np.ndarray,            # u8  [cap, L]
    n_vocab: int,
    *,
    head_bytes_budget: int,
    head_df_threshold: int,
    seg_cap: int = TAIL_SEG_CAP,
    reserve: int = 0,
) -> Dict[str, Any]:
    """Partition the packed lexical matrix into the split-frequency BM25
    layout: a TERM-major dense u8 head matrix [C, cap] for high-df terms
    and term-sorted postings (rows/tfs + per-term offsets) for the tail.

    Pure numpy (IndexStore._sync_split and _full_save). Returns
    ``n_overflow`` > 0 when the head budget could not hold every term
    above the df threshold (those fall to the tail as SEGMENTED posting
    lists — r_cap stays capped at ``seg_cap``, so overflow degrades
    per-batch tail width, not the slice cost).
    """
    cap, width = term_ids.shape
    n_vocab = max(n_vocab, 1)
    flat_ids = term_ids.ravel()
    flat_tfs = tfs.ravel()
    present = (flat_ids >= 0) & (flat_tfs > 0)
    ids_p = flat_ids[present]
    tfs_p = flat_tfs[present]
    rows_p = np.repeat(np.arange(cap, dtype=np.int64), width)[present]

    df = np.bincount(ids_p, minlength=n_vocab)
    max_head = max(128, int(head_bytes_budget // max(cap, 1)))
    head_candidates = np.argsort(-df, kind="stable")
    head_terms = head_candidates[:max_head]
    head_terms = head_terms[df[head_terms] > head_df_threshold]
    # SELF-SIZING: when more terms qualify (df > threshold) than the
    # byte budget can hold, the effective threshold rises to the df
    # spectrum's (max_head)-th value — the head always holds exactly the
    # heaviest terms the budget allows, and every term above the DERIVED
    # threshold is in the head by construction. df_threshold reports the
    # derived value so callers can see the corpus-adaptive cut.
    n_overflow = int((df > head_df_threshold).sum()) - len(head_terms)
    eff_threshold = int(head_df_threshold)
    if n_overflow > 0 and len(head_terms):
        eff_threshold = int(df[head_terms].min())
    # Slot order is arbitrary for scoring; sorting by TERM ID (not df
    # rank) keeps the lut stable across small df drifts, so the O(delta)
    # sync COLUMN-scatters head-matrix updates instead of re-placing
    # [C, N] whenever ingest reorders term frequencies.
    head_terms = np.sort(head_terms)
    c_pad = max(128, _round_up(len(head_terms), 128))
    lut = np.full(n_vocab, -1, dtype=np.int32)
    lut[head_terms] = np.arange(len(head_terms), dtype=np.int32)

    slots = np.where(ids_p >= 0, lut[ids_p], -1)
    is_head = slots >= 0
    tf_head = np.zeros((c_pad, cap), dtype=np.uint8)
    tf_head[slots[is_head], rows_p[is_head]] = tfs_p[is_head]

    rare_ids = ids_p[~is_head]
    rare_rows = rows_p[~is_head].astype(np.int32)
    rare_tfs = tfs_p[~is_head]
    order = np.argsort(rare_ids, kind="stable")
    post_rows = rare_rows[order]
    post_tfs = rare_tfs[order]
    counts = np.bincount(rare_ids, minlength=n_vocab)
    offsets = np.zeros(n_vocab + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    max_rare = int(counts.max()) if counts.size else 0
    r_cap = min(
        max(8, 1 << int(np.ceil(np.log2(max(max_rare, 1))))), seg_cap
    )
    # Pad the postings arrays by r_cap so every window [start, start +
    # r_cap) lies inside them (the scorer clamps starts near the end).
    # ``reserve`` adds an OVERLAY region right after the base postings —
    # the O(delta) refresh (plan_tail_delta) appends new/updated rows'
    # tail entries there between full rebuilds.
    p_base = len(post_rows)
    p_pad = max(8, _round_up(p_base + reserve + r_cap, 4096))
    post_rows_pad = np.zeros(p_pad, dtype=np.int32)
    post_rows_pad[:p_base] = post_rows
    post_tfs_pad = np.zeros(p_pad, dtype=np.uint8)
    post_tfs_pad[:p_base] = post_tfs
    return {
        "lut": lut,
        "offsets": offsets,
        "r_cap": r_cap,
        "tf_head": tf_head,
        "post_rows": post_rows_pad,
        "post_tfs": post_tfs_pad,
        "p_base": p_base,
        "n_overflow": n_overflow,
        "df_threshold": eff_threshold,
    }


def _pad_pow2(arr: np.ndarray, fill) -> np.ndarray:
    real = len(arr)
    padded_n = max(8, 1 << int(np.ceil(np.log2(max(real, 1)))))
    out = np.full(padded_n, fill, dtype=np.int32)
    out[:real] = arr
    return out


# The columns of ``split_query_arrays`` the single-device step reads.
STEP_COLUMNS = ("h_slots", "h_tids", "u_starts", "u_lens", "u_cols", "t_tids")


def split_query_arrays(
    lut: np.ndarray,
    offsets: np.ndarray,
    q_tids: np.ndarray,         # i32 [B, M], -1 padded
    q_counts: np.ndarray,       # f32 [B, M]
    r_cap: int = TAIL_SEG_CAP,
    ov_offsets: Optional[np.ndarray] = None,  # i64 [V+1] overlay ranges
    ov_start: int = 0,          # overlay region start in post arrays
) -> Dict[str, np.ndarray]:
    """Map [B, M] query term ids onto the batch's distinct head-term
    union and tail-term SEGMENT table.

    Tail terms whose posting lists exceed ``r_cap`` emit one segment per
    ``r_cap``-sized window; every segment of a term scatters into that
    term's single column (``u_cols`` maps segment → index into
    ``t_tids``, the batch's distinct tail terms), so the [N, T] tail
    matrix is sized by distinct terms, not segments.

    ``ov_offsets`` adds OVERLAY segments: per-term windows into the
    overlay region at ``ov_start`` (plan_tail_delta), scattering into the
    same term column as the base segments. ``u_tids``/``u_occ``/``u_ov``
    record each segment's term, its occurrence index within its class
    and the class (0 base / 1 overlay), so ``shard_tail_ranges`` can
    re-derive per-shard windows; the single-device step reads only the
    first six columns (``STEP_COLUMNS``).
    """
    safe = np.maximum(q_tids, 0)
    slots = np.where(q_tids >= 0, lut[safe], -1).astype(np.int32)
    is_head = slots >= 0
    has_tail = offsets[safe + 1] - offsets[safe] > 0
    if ov_offsets is not None:
        has_tail |= ov_offsets[safe + 1] - ov_offsets[safe] > 0
    is_rare = (~is_head) & (q_tids >= 0) & has_tail

    head_tids = (
        np.unique(q_tids[is_head]) if is_head.any()
        else np.zeros(0, np.int32)
    )
    h_tids = _pad_pow2(head_tids, -1)
    h_slots = np.full(len(h_tids), -1, dtype=np.int32)
    if len(head_tids):
        h_slots[: len(head_tids)] = lut[head_tids]

    rare_tids = (
        np.unique(q_tids[is_rare]) if is_rare.any()
        else np.zeros(0, np.int32)
    )
    t_tids = _pad_pow2(rare_tids, -1)
    seg_t, seg_col, seg_start, seg_len, seg_occ, seg_ov = ([] for _ in range(6))
    ranges = [(offsets, 0)]
    if ov_offsets is not None:
        ranges.append((ov_offsets, ov_start))
    for col, t in enumerate(rare_tids):
        for ov, (offs, base) in enumerate(ranges):
            start = int(offs[t])
            ln = int(offs[t + 1]) - start
            for occ, k in enumerate(range(0, ln, r_cap)):
                seg_t.append(t)
                seg_col.append(col)
                seg_start.append(base + start + k)
                seg_len.append(min(r_cap, ln - k))
                seg_occ.append(occ)
                seg_ov.append(ov)
    u_cols = _pad_pow2(np.asarray(seg_col, np.int32), -1)
    out = {
        "h_slots": h_slots,
        "h_tids": h_tids,
        "u_tids": _pad_pow2(np.asarray(seg_t, np.int32), -1),
        "u_cols": u_cols,
        "t_tids": t_tids,
    }
    for name, vals in (("u_starts", seg_start), ("u_lens", seg_len),
                       ("u_occ", seg_occ), ("u_ov", seg_ov)):
        col = np.zeros(len(u_cols), dtype=np.int32)
        col[: len(vals)] = vals
        out[name] = col
    return out


def shard_postings(
    post_rows: np.ndarray,
    post_tfs: np.ndarray,
    offsets: np.ndarray,
    n_shards: int,
    n_local: int,
    r_cap: int,
    reserve: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Partition term-sorted tail postings by corpus shard (row // n_local).

    Row ids become SHARD-LOCAL; per-shard per-term offsets are rebuilt so
    each shard can slice its own contiguous posting windows. Returns
    (post_rows_sh [S, Pmax] i32, post_tfs_sh [S, Pmax] u8,
    offsets_sh [S, V+1] i64); Pmax is padded by r_cap like the global
    layout (the scorer's window clamp) plus ``reserve`` slots per shard
    for the O(delta) overlay region (which starts at each shard's
    ``offsets_sh[s, -1]``).
    """
    n_vocab = len(offsets) - 1
    p = int(offsets[-1])
    rows = post_rows[:p].astype(np.int64)
    tfv = post_tfs[:p]
    term_of = np.repeat(
        np.arange(n_vocab, dtype=np.int64), np.diff(offsets)
    )
    shard_of = rows // n_local

    local_rows, local_tfs = [], []
    counts_sh = np.zeros((n_shards, n_vocab), dtype=np.int64)
    for s in range(n_shards):
        sel = shard_of == s        # stable → term grouping preserved
        local_rows.append((rows[sel] - s * n_local).astype(np.int32))
        local_tfs.append(tfv[sel])
        counts_sh[s] = np.bincount(term_of[sel], minlength=n_vocab)
    offsets_sh = np.zeros((n_shards, n_vocab + 1), dtype=np.int64)
    np.cumsum(counts_sh, axis=1, out=offsets_sh[:, 1:])

    pmax = max((len(r) for r in local_rows), default=0)
    p_pad = max(8, _round_up(pmax + reserve + r_cap, 128))
    post_rows_sh = np.zeros((n_shards, p_pad), dtype=np.int32)
    post_tfs_sh = np.zeros((n_shards, p_pad), dtype=np.uint8)
    for s in range(n_shards):
        post_rows_sh[s, : len(local_rows[s])] = local_rows[s]
        post_tfs_sh[s, : len(local_tfs[s])] = local_tfs[s]
    return post_rows_sh, post_tfs_sh, offsets_sh


def shard_tail_ranges(
    offsets_sh: np.ndarray,     # i64 [S, V+1]
    u_tids: np.ndarray,         # i32 [U], -1 padded (segments share tid)
    r_cap: int = TAIL_SEG_CAP,
    u_occ: Optional[np.ndarray] = None,   # i32 [U] within-class occurrence
    u_ov: Optional[np.ndarray] = None,    # i32 [U] 0 base / 1 overlay
    ov_offsets_sh: Optional[np.ndarray] = None,  # i64 [S, V+1]
    ov_starts_sh: Optional[np.ndarray] = None,   # i64 [S] region starts
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-shard (u_starts, u_lens) [S, U] for the batch's tail SEGMENT
    table (the segment/tid layout stays global and replicated; each shard
    fills its own, possibly shorter, posting list into the term's
    segment slots). A shard never needs more segments than the global
    list does, since its local list is a subset.

    With overlay tables, slots flagged ``u_ov`` resolve against the
    per-shard overlay ranges (region at ``ov_starts_sh[s]``) instead of
    the base offsets: the same windowing rule on a different list."""
    s = offsets_sh.shape[0]
    u = len(u_tids)
    if u_occ is not None:
        occ = u_occ.astype(np.int64)
    else:
        # Occurrence index of each segment slot within its term.
        occ = np.zeros(u, dtype=np.int64)
        seen: Dict[int, int] = {}
        for j, t in enumerate(u_tids):
            t = int(t)
            if t < 0:
                continue
            occ[j] = seen.get(t, 0)
            seen[t] = int(occ[j]) + 1

    u_starts_sh = np.zeros((s, u), dtype=np.int32)
    u_lens_sh = np.zeros((s, u), dtype=np.int32)
    real = u_tids >= 0
    if real.any():
        tids = np.maximum(u_tids, 0).astype(np.int64)
        starts = offsets_sh[:, :-1][:, tids]          # [S, U]
        total = offsets_sh[:, 1:][:, tids] - starts
        if u_ov is not None and ov_offsets_sh is not None:
            ov_s = ov_offsets_sh[:, :-1][:, tids]
            ov_total = ov_offsets_sh[:, 1:][:, tids] - ov_s
            ov_flag = (u_ov > 0)[None, :]
            starts = np.where(
                ov_flag, ov_starts_sh[:, None] + ov_s, starts
            )
            total = np.where(ov_flag, ov_total, total)
        seg_off = (occ * r_cap)[None, :]
        ln = np.clip(total - seg_off, 0, r_cap)
        u_starts_sh[:] = (starts + np.minimum(seg_off, total)).astype(np.int32)
        u_lens_sh[:] = np.where(real[None, :], ln, 0).astype(np.int32)
    return u_starts_sh, u_lens_sh


def head_tf_columns(
    lut: np.ndarray,
    c_pad: int,
    term_ids: np.ndarray,   # i32 [R, L] — the changed rows' new content
    tfs: np.ndarray,        # u8  [R, L]
) -> np.ndarray:
    """tf_head columns [c_pad, R] for changed rows under a FROZEN head
    lut — the O(delta) replacement for rebuilding the full [C, N] head
    matrix when only a few rows changed."""
    r, width = term_ids.shape
    cols = np.zeros((c_pad, r), dtype=np.uint8)
    ids = term_ids.ravel()
    tfv = tfs.ravel()
    ok = (ids >= 0) & (ids < len(lut)) & (tfv > 0)
    slots = np.where(ok, lut[np.maximum(ids, 0)], -1)
    sel = slots >= 0
    row_of = np.repeat(np.arange(r), width)
    cols[slots[sel], row_of[sel]] = tfv[sel]
    return cols


def plan_tail_delta(
    lut: np.ndarray,               # FROZEN head lut (may lag the vocab)
    offsets: np.ndarray,           # base per-term ranges [V_base+1]
    post_rows_host: np.ndarray,    # base postings rows (host copy)
    overlay: Dict[int, Dict[int, int]],  # tid -> {row: tf}; MUTATED
    changes: Sequence[Tuple[int, Any, Tuple[np.ndarray, np.ndarray]]],
    reserve: int,
    n_vocab: int,
) -> Optional[Dict[str, np.ndarray]]:
    """O(delta) tail-posting maintenance plan for changed rows.

    ``changes`` is [(row, old, (new_ids, new_tfs))] where ``row`` is in
    the SAME row space as ``post_rows_host`` (shard-local for a sharded
    caller) and ``old`` is the pre-mutation (tids, tfs) or None for a
    fresh slot.

    For each row: every OLD tail entry is neutralized — removed from the
    overlay if it lives there, else its base posting position gets tf=0
    (an Okapi zero-tf contributes exactly nothing, and subset df comes
    from the row-major term matrix, not the postings) — and every NEW
    tail entry goes into the overlay. Head terms are untouched here
    (head_tf_columns covers them); the head/tail PARTITION stays frozen
    between full rebuilds, which costs only performance drift, never
    correctness.

    Returns None when the plan is infeasible (overlay outgrew the
    reserve) — the caller falls back to a full rebuild and clears the
    overlay. Otherwise: ``zero_pos`` (base positions to tf=0),
    ``ov_rows``/``ov_tfs`` (the full overlay region content, per-term
    contiguous, row-sorted) and ``ov_offsets`` [n_vocab+1].

    Within a term's base range, postings are ROW-SORTED (build order is
    row-major and the term sort is stable) — neutralization is a binary
    search, not a scan.
    """
    lut_len = len(lut)
    v_base = len(offsets) - 1
    zero_pos: List[int] = []
    for row, old, (n_ids, n_tfs) in changes:
        pairs = []
        if old is not None:
            o_ids, o_tfs = old
            live = (o_ids >= 0) & (o_tfs > 0)
            pairs = zip(o_ids[live].tolist(), o_tfs[live].tolist())
        for tid, _tf in pairs:
            if tid < lut_len and lut[tid] >= 0:
                continue  # head term: column scatter covers it
            ov_t = overlay.get(tid)
            if ov_t is not None and row in ov_t:
                del ov_t[row]
                continue
            if tid >= v_base:
                return None  # tail term outside the base vocab snapshot
            lo, hi = int(offsets[tid]), int(offsets[tid + 1])
            pos = lo + int(
                np.searchsorted(post_rows_host[lo:hi], row)
            )
            if pos >= hi or int(post_rows_host[pos]) != row:
                return None  # base entry not found: state drifted
            zero_pos.append(pos)
        live = (n_ids >= 0) & (n_tfs > 0)
        for tid, tf in zip(n_ids[live].tolist(), n_tfs[live].tolist()):
            if tid < lut_len and lut[tid] >= 0:
                continue
            overlay.setdefault(int(tid), {})[int(row)] = int(tf)

    total = sum(len(v) for v in overlay.values())
    if total > reserve:
        return None
    ov_offsets = np.zeros(n_vocab + 1, dtype=np.int64)
    ov_rows = np.zeros(total, dtype=np.int32)
    ov_tfs = np.zeros(total, dtype=np.uint8)
    counts = np.zeros(n_vocab, dtype=np.int64)
    for tid, entries in overlay.items():
        counts[tid] = len(entries)
    np.cumsum(counts, out=ov_offsets[1:])
    for tid, entries in overlay.items():
        if not entries:
            continue
        pos = int(ov_offsets[tid])
        for row in sorted(entries):
            ov_rows[pos] = row
            ov_tfs[pos] = entries[row]
            pos += 1
    return {
        "zero_pos": np.asarray(sorted(zero_pos), dtype=np.int64),
        "ov_rows": ov_rows,
        "ov_tfs": ov_tfs,
        "ov_offsets": ov_offsets,
    }


def overlay_diff_span(
    new_rows: np.ndarray,
    new_tfs: np.ndarray,
    prev: Tuple[np.ndarray, np.ndarray],
) -> Tuple[int, int]:
    """[lo, hi) span where the overlay region's new serialization differs
    from the previous one, comparing with zero padding out to the longer
    length (a shrink must zero the stale tail). (0, 0) = nothing to
    write."""
    prev_rows, prev_tfs = prev
    n_new, n_prev = len(new_rows), len(prev_rows)
    n = max(n_new, n_prev)
    if n == 0:
        return 0, 0
    a_r = np.zeros(n, np.int64)
    a_r[:n_new] = new_rows
    a_t = np.zeros(n, np.int64)
    a_t[:n_new] = new_tfs
    b_r = np.zeros(n, np.int64)
    b_r[:n_prev] = prev_rows
    b_t = np.zeros(n, np.int64)
    b_t[:n_prev] = prev_tfs
    diff = np.nonzero((a_r != b_r) | (a_t != b_t))[0]
    if not len(diff):
        return 0, 0
    return int(diff[0]), int(diff[-1]) + 1


# ---------------------------------------------------------------------------
# Scoring on tensors
# ---------------------------------------------------------------------------
# The Okapi idf/ε rule and the saturation have exactly one implementation
# each; the fused step (ops/hybrid_step.py) and the store build on them.

def okapi_idf(df: torch.Tensor, n_sub: torch.Tensor) -> torch.Tensor:
    """idf per BM25Okapi incl. the negative-idf ε replacement (subset
    semantics: ``df``/``n_sub`` are over the active row mask)."""
    raw_idf = torch.log(n_sub - df + 0.5) - torch.log(df + 0.5)
    in_vocab = df > 0
    n_terms = torch.clamp(in_vocab.float().sum(), min=1.0)
    avg_idf = torch.where(in_vocab, raw_idf, 0.0).sum() / n_terms
    eps = EPSILON * avg_idf
    return torch.where(
        in_vocab, torch.where(raw_idf < 0, eps, raw_idf), 0.0
    )


def okapi_query_weights(idf, q_terms, q_counts, vocab_pad: int):
    """[..., vocab_pad+1] weights holding idf × multiplicity at each
    query's terms, zero elsewhere; slot vocab_pad is the padding sink.
    ``q_terms``/``q_counts`` are [M] or [B, M] (one row per query)."""
    q_safe = torch.where(q_terms >= 0, q_terms, vocab_pad).long()
    vals = torch.where(q_terms >= 0, q_counts, 0.0) * idf[q_safe]
    w = torch.zeros(
        q_terms.shape[:-1] + (vocab_pad + 1,),
        dtype=torch.float32, device=idf.device,
    )
    w.scatter_add_(-1, q_safe, vals)
    w[..., vocab_pad] = 0.0
    return w


def okapi_len_term(doc_len, avgdl):
    """The length part of the saturation's denominator,
    k1 · ((1 - b) + b · dl / avgdl), per row."""
    return K1 * (1.0 - B + B * doc_len / avgdl)


def okapi_sat(tf, doc_len, avgdl):
    """BM25 term-frequency saturation; ``tf`` broadcastable against
    ``doc_len`` (caller shapes them)."""
    tf = tf.float()
    return tf * (K1 + 1.0) / (tf + okapi_len_term(doc_len, avgdl))


def okapi_score_rows(term_ids, tfs, doc_len, avgdl, w, vocab_pad: int):
    """scores [..., N] = Σ_l w[term_ids] · sat(tf, dl) — the gather pass.
    ``w`` is [vocab_pad+1] or [B, vocab_pad+1]."""
    ids = torch.where(term_ids >= 0, term_ids, vocab_pad).long()
    gathered = w[..., ids]                                 # [..., N, L]
    sat = okapi_sat(tfs, doc_len[:, None], avgdl)
    return (gathered * torch.where(term_ids >= 0, sat, 0.0)).sum(-1)


def subset_sums(mask_bias: torch.Tensor, doc_len: torch.Tensor):
    """(keep [N] bool, kept rows i64, their length sum f64): exact in any
    order (lengths are token counts), so the sums of a sharded corpus's
    parts add up to the whole corpus's bit for bit."""
    keep = mask_bias == 0.0
    return (keep, keep.sum(),
            torch.where(keep, doc_len, 0.0).to(torch.float64).sum())


def okapi_subset(n_kept: torch.Tensor, dl_sum: torch.Tensor):
    """(n_sub, avgdl) f32 from the exact sums of ``subset_sums``."""
    n_sub = torch.clamp(n_kept.float(), min=1.0)
    return n_sub, dl_sum.float() / n_sub


def subset_stats(mask_bias: torch.Tensor, doc_len: torch.Tensor):
    """(keep [N] bool, n_sub, avgdl) over the rows the mask keeps."""
    keep, n_kept, dl_sum = subset_sums(mask_bias, doc_len)
    return (keep, *okapi_subset(n_kept, dl_sum))


def subset_df(term_ids, tfs, keep, vocab_pad: int) -> torch.Tensor:
    """df over masked rows: scatter-add of term presence → [vocab_pad+1].
    Counts are integers, exact in f32, so the order of the adds does not
    matter."""
    present = (term_ids >= 0) & (tfs > 0) & keep[:, None]
    idx = torch.where(present, term_ids, vocab_pad).long().reshape(-1)
    df = torch.zeros(vocab_pad + 1, dtype=torch.float32,
                     device=term_ids.device)
    df.index_add_(0, idx, present.float().reshape(-1))
    df[vocab_pad] = 0.0
    return df


def _f32_matmul(a: torch.Tensor, b: torch.Tensor, fast: bool):
    """``a @ b`` with f32 results. ``fast`` rounds both operands to bf16
    first (the reference's bf16 operands with f32 accumulation); the
    product of two bf16 values is exact in f32, so upcasting before the
    f32 matmul gives that result without a bf16 output."""
    if fast:
        a = a.to(torch.bfloat16).float()
        b = b.to(torch.bfloat16).float()
    return a @ b


def split_query_weights(idf, h_tids, t_tids, q_tids, q_counts,
                        vocab_pad: int):
    """(w_head [B, H], w_tail [B, T]) f32: each query's idf × multiplicity
    at the batch's head terms ``h_tids`` and tail terms ``t_tids`` (-1
    padding weighs 0)."""
    q_valid = (q_tids >= 0)[:, :, None]
    out = []
    for tids in (h_tids, t_tids):
        t_idf = idf[torch.where(tids >= 0, tids, vocab_pad).long()]
        match = (
            (q_tids[:, :, None] == tids[None, None, :])
            & q_valid & (tids >= 0)[None, None, :]
        )
        out.append(torch.einsum(
            "bmt,bm->bt", match.float(), q_counts
        ) * t_idf[None, :])
    return tuple(out)


def tail_tf_matrix(post_rows, post_tfs, u_starts, u_lens, u_cols, t: int,
                   n: int, r_cap: int):
    """[N, T] f32: the tf of the batch's tail terms over the rows, from
    their posting windows (segment u covers postings clamp(u_starts[u],
    0, P - r_cap) + [0, u_lens[u]) and adds into column u_cols[u])."""
    dev = post_rows.device
    p = post_rows.shape[0]
    starts = torch.clamp(u_starts.long(), 0, max(p - r_cap, 0))
    r_iota = torch.arange(r_cap, device=dev)
    pos = starts[:, None] + r_iota[None, :]                 # [U, R]
    rows_u = post_rows[pos].long()
    tfs_u = post_tfs[pos].float()
    valid_u = (u_lens[:, None] > 0) & (r_iota[None, :] < u_lens[:, None])
    col_u = u_cols.long()[:, None].expand(-1, r_cap)
    col_ok = valid_u & (col_u >= 0)
    tf_tail = torch.zeros((n, t + 1), dtype=torch.float32, device=dev)
    # Integer tfs: the accumulated sums are exact in any order. An add
    # into the flat view, where dead slots land in column t: on CUDA,
    # index_put_(accumulate=True) range-checks its indices with two host
    # reads each, and every batch would wait for the card.
    tf_tail.view(-1).index_add_(
        0, torch.where(col_ok, rows_u * (t + 1) + col_u, t).reshape(-1),
        torch.where(col_ok, tfs_u, 0.0).reshape(-1),
    )
    return tf_tail[:, :t]


def bm25_split_score_core(
    tf_head,      # u8 [C, N] — dense tf of head terms, TERM-major
    post_rows,    # i32 [P] — tail postings: row ids (term-major)
    post_tfs,     # u8 [P]
    doc_len,      # f32 [N]
    keep,         # bool [N] — active-row mask
    idf,          # f32 [vocab_pad+1]
    avgdl,        # f32 scalar
    h_slots,      # i32 [H] — distinct head slots in this batch (-1 pad)
    h_tids,       # i32 [H] — their vocab ids (-1 pad)
    u_starts,     # i32 [U] — posting window start per tail SEGMENT
    u_lens,       # i32 [U] window length ≤ r_cap (0 = padding slot)
    u_cols,       # i32 [U] — segment's column in the per-term tail matrix
    t_tids,       # i32 [T] — the batch's distinct tail term ids (-1 pad)
    q_tids,       # i32 [B, M] query term ids (-1 padded)
    q_counts,     # f32 [B, M] query term multiplicities
    *,
    vocab_pad: int,
    r_cap: int,
    fast: bool = False,
):
    """Split-frequency BM25 scores [B, N] from precomputed subset stats.

    Head terms score as ``W_head [B, H] @ sat(tf_head[h_slots]) [H, N]``;
    tail terms materialize a [N, T] tf matrix from their posting windows
    (segments of one term add into its one column) and score as a second
    matmul. ``fast`` rounds the saturation matrices and weights to bf16
    (only valid when the caller exactly rescores its candidate pool,
    see ops/hybrid_step.bm25_rescore_pool); otherwise every product is
    full f32.

    On CUDA, ``fast`` runs the hand-written kernel instead
    (``ops/bm25_core.fast_scores``: the same bf16 operands, f32 sums in
    another order); this code is its CPU and reference path.
    """
    if fast and tf_head.is_cuda:
        from classmate_rag_tpu_torch.ops import bm25_core

        return bm25_core.fast_scores(
            tf_head, post_rows, post_tfs, doc_len, keep, idf, avgdl,
            h_slots, h_tids, u_starts, u_lens, u_cols, t_tids, q_tids,
            q_counts, vocab_pad=vocab_pad, r_cap=r_cap,
        )
    n = tf_head.shape[1]
    w_head, w_tail = split_query_weights(idf, h_tids, t_tids, q_tids,
                                         q_counts, vocab_pad)

    # ---- head: gather only the batch's head-term rows, then matmul.
    tf_sub = tf_head[torch.clamp(h_slots, min=0).long()]   # [H, N] u8
    sat_sub = okapi_sat(tf_sub, doc_len[None, :], avgdl)
    sat_sub = sat_sub * (tf_sub > 0) * keep[None, :]
    sat_sub = sat_sub * (h_slots >= 0)[:, None]
    scores = _f32_matmul(w_head, sat_sub, fast)

    # ---- tail: batch-union tf matrix + second matmul.
    tf_tail = tail_tf_matrix(post_rows, post_tfs, u_starts, u_lens, u_cols,
                             t_tids.shape[0], n, r_cap)
    sat_tail = okapi_sat(tf_tail, doc_len[:, None], avgdl)
    sat_tail = sat_tail * (tf_tail > 0) * keep[:, None]
    scores = scores + _f32_matmul(w_tail, sat_tail.T, fast)
    return scores * keep[None, :]


# ---------------------------------------------------------------------------
# Pure-Python oracle (tests, benchmarks, tiny corpora)
# ---------------------------------------------------------------------------

def bm25_oracle_scores(
    corpus_tokens: Sequence[Sequence[str]],
    query_tokens: Sequence[str],
) -> List[float]:
    """The published BM25Okapi formula with the negative-idf ε rule, one
    score per document, in plain Python floats: the reference the
    tensor scorers are held against."""
    n = len(corpus_tokens)
    if n == 0:
        return []
    df: Dict[str, int] = {}
    doc_freqs: List[Dict[str, int]] = []
    total_len = 0
    for doc in corpus_tokens:
        freqs: Dict[str, int] = {}
        for t in doc:
            freqs[t] = freqs.get(t, 0) + 1
        doc_freqs.append(freqs)
        total_len += len(doc)
        for t in freqs:
            df[t] = df.get(t, 0) + 1
    avgdl = total_len / n
    idf: Dict[str, float] = {}
    negatives = []
    idf_sum = 0.0
    for t, f in df.items():
        v = math.log(n - f + 0.5) - math.log(f + 0.5)
        idf[t] = v
        idf_sum += v
        if v < 0:
            negatives.append(t)
    avg_idf = idf_sum / len(idf) if idf else 0.0
    for t in negatives:
        idf[t] = EPSILON * avg_idf
    out = []
    for freqs, doc in zip(doc_freqs, corpus_tokens):
        dl = len(doc)
        s = 0.0
        for q in query_tokens:
            tf = freqs.get(q, 0)
            if tf == 0 or q not in idf:
                continue
            s += idf[q] * tf * (K1 + 1) / (tf + K1 * (1 - B + B * dl / avgdl))
        out.append(s)
    return out
