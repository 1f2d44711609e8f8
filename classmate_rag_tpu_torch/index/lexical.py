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

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

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
) -> Dict[str, Any]:
    """Partition the packed lexical matrix into the split-frequency BM25
    layout: a TERM-major dense u8 head matrix [C, cap] for high-df terms
    and term-sorted postings (rows/tfs + per-term offsets) for the tail.

    Returns ``n_overflow`` > 0 when the head budget could not hold every
    term above the df threshold (those fall to the tail as segmented
    posting lists; r_cap stays capped at ``seg_cap``).
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
    # Self-sizing: when more terms qualify than the byte budget holds,
    # the effective threshold rises to the df spectrum's (max_head)-th
    # value; df_threshold reports the derived cut.
    n_overflow = int((df > head_df_threshold).sum()) - len(head_terms)
    eff_threshold = int(head_df_threshold)
    if n_overflow > 0 and len(head_terms):
        eff_threshold = int(df[head_terms].min())
    # Slot order is arbitrary for scoring; sorting by term id keeps the
    # lut stable across small df drifts.
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
    # Pad the postings by r_cap so every window [start, start + r_cap)
    # lies inside the arrays.
    p_base = len(post_rows)
    p_pad = max(8, _round_up(p_base + r_cap, 4096))
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


def split_query_arrays(
    lut: np.ndarray,
    offsets: np.ndarray,
    q_tids: np.ndarray,         # i32 [B, M], -1 padded
    q_counts: np.ndarray,       # f32 [B, M]
    r_cap: int = TAIL_SEG_CAP,
) -> Dict[str, np.ndarray]:
    """Map [B, M] query term ids onto the batch's distinct head-term
    union and tail-term SEGMENT table.

    Tail terms whose posting lists exceed ``r_cap`` emit one segment per
    ``r_cap``-sized window; every segment of a term scatters into that
    term's single column (``u_cols`` maps segment → index into
    ``t_tids``, the batch's distinct tail terms), so the [N, T] tail
    matrix is sized by distinct terms, not segments.
    """
    safe = np.maximum(q_tids, 0)
    slots = np.where(q_tids >= 0, lut[safe], -1).astype(np.int32)
    is_head = slots >= 0
    lens = offsets[safe + 1] - offsets[safe]
    is_rare = (~is_head) & (q_tids >= 0) & (lens > 0)

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
    seg_col, seg_start, seg_len = [], [], []
    for col, t in enumerate(rare_tids):
        start = int(offsets[t])
        ln = int(offsets[t + 1]) - start
        for k in range(0, ln, r_cap):
            seg_col.append(col)
            seg_start.append(start + k)
            seg_len.append(min(r_cap, ln - k))
    u_cols = _pad_pow2(np.asarray(seg_col, np.int32), -1)
    u_starts = np.zeros(len(u_cols), dtype=np.int32)
    u_lens = np.zeros(len(u_cols), dtype=np.int32)
    if seg_col:
        u_starts[: len(seg_col)] = seg_start
        u_lens[: len(seg_col)] = seg_len
    return {
        "h_slots": h_slots,
        "h_tids": h_tids,
        "u_starts": u_starts,
        "u_lens": u_lens,
        "u_cols": u_cols,
        "t_tids": t_tids,
    }


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


def okapi_sat(tf, doc_len, avgdl):
    """BM25 term-frequency saturation; ``tf`` broadcastable against
    ``doc_len`` (caller shapes them)."""
    tf = tf.float()
    return tf * (K1 + 1.0) / (tf + K1 * (1.0 - B + B * doc_len / avgdl))


def okapi_score_rows(term_ids, tfs, doc_len, avgdl, w, vocab_pad: int):
    """scores [..., N] = Σ_l w[term_ids] · sat(tf, dl) — the gather pass.
    ``w`` is [vocab_pad+1] or [B, vocab_pad+1]."""
    ids = torch.where(term_ids >= 0, term_ids, vocab_pad).long()
    gathered = w[..., ids]                                 # [..., N, L]
    sat = okapi_sat(tfs, doc_len[:, None], avgdl)
    return (gathered * torch.where(term_ids >= 0, sat, 0.0)).sum(-1)


def subset_stats(mask_bias: torch.Tensor, doc_len: torch.Tensor):
    """(keep [N] bool, n_sub, avgdl) over the rows the mask keeps."""
    keep = mask_bias == 0.0
    n_sub = torch.clamp(keep.float().sum(), min=1.0)
    avgdl = torch.where(keep, doc_len, 0.0).sum() / n_sub
    return keep, n_sub, avgdl


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
    """
    dev = tf_head.device
    n = tf_head.shape[1]
    q_valid = (q_tids >= 0)[:, :, None]

    # ---- head: gather only the batch's head-term rows, then matmul.
    tf_sub = tf_head[torch.clamp(h_slots, min=0).long()]   # [H, N] u8
    sat_sub = okapi_sat(tf_sub, doc_len[None, :], avgdl)
    sat_sub = sat_sub * (tf_sub > 0) * keep[None, :]
    sat_sub = sat_sub * (h_slots >= 0)[:, None]

    h_idf = idf[torch.where(h_tids >= 0, h_tids, vocab_pad).long()]
    match_h = (
        (q_tids[:, :, None] == h_tids[None, None, :])
        & q_valid & (h_tids >= 0)[None, None, :]
    )
    w_head = torch.einsum(
        "bmh,bm->bh", match_h.float(), q_counts
    ) * h_idf[None, :]
    scores = _f32_matmul(w_head, sat_sub, fast)

    # ---- tail: batch-union tf matrix + second matmul.
    p = post_rows.shape[0]
    starts = torch.clamp(u_starts.long(), 0, max(p - r_cap, 0))
    r_iota = torch.arange(r_cap, device=dev)
    pos = starts[:, None] + r_iota[None, :]                 # [U, R]
    rows_u = post_rows[pos].long()
    tfs_u = post_tfs[pos].float()
    valid_u = (u_lens[:, None] > 0) & (r_iota[None, :] < u_lens[:, None])
    t = t_tids.shape[0]
    col_u = u_cols.long()[:, None].expand(-1, r_cap)
    col_ok = valid_u & (col_u >= 0)
    tf_tail = torch.zeros((n, t + 1), dtype=torch.float32, device=dev)
    # Integer tfs: the accumulated sums are exact in any order.
    tf_tail.index_put_(
        (torch.where(col_ok, rows_u, 0), torch.where(col_ok, col_u, t)),
        torch.where(col_ok, tfs_u, 0.0),
        accumulate=True,
    )
    tf_tail = tf_tail[:, :t]
    sat_tail = okapi_sat(tf_tail, doc_len[:, None], avgdl)
    sat_tail = sat_tail * (tf_tail > 0) * keep[:, None]

    t_idf = idf[torch.where(t_tids >= 0, t_tids, vocab_pad).long()]
    match_t = (
        (q_tids[:, :, None] == t_tids[None, None, :])
        & q_valid & (t_tids >= 0)[None, None, :]
    )
    w_tail = torch.einsum(
        "bmt,bm->bt", match_t.float(), q_counts
    ) * t_idf[None, :]
    scores = scores + _f32_matmul(w_tail, sat_tail.T, fast)
    return scores * keep[None, :]
