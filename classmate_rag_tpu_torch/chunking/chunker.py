"""Sentence-aware chunking with character-budget packing and overlap.

Output is byte-compatible with the reference chunker
(rag/chunking/chunker.py:95-217): the stable chunk IDs hash over
``chunk_index`` and neighbor expansion reconstructs adjacent IDs
arithmetically, so chunk boundaries must agree exactly for dumps, recall
comparisons, and cross-stack interop. The notable semantics preserved:

- sentence boundaries: [.!?] + whitespace + (uppercase | quote | paren |
  newline) lookahead, with an abbreviation guard that merges when the next
  segment starts lowercase;
- greedy packing to ``chunk_size`` chars with a 1-char joiner; oversized
  sentences are hard-split into exact ``chunk_size`` slices, each its own
  chunk;
- overlap is measured in *sentences* re-taken from the previous already-
  overlapped block until ``chunk_overlap`` chars are covered (capped at
  len(prev)-1).

Host copy of the JAX package's ``chunking/chunker.py`` (no JAX).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

_BOUNDARY = re.compile(
    r"(?<=[.!?])\s+(?=[A-ZÀ-ÖØ-Þ]|[\"“‘(]|\n)"
)

_ABBREVIATIONS = frozenset({
    "sig.", "sig.ra", "sig.na", "ing.", "dott.", "dr.", "prof.", "ecc.",
    "etc.", "e.g.", "i.e.",
})

_INLINE_WS = re.compile(r"[ \t]+")
_BLANK_RUNS = re.compile(r"\n{3,}")
_PUNCT_ONLY = set(".!?,;:()[]{}\"'—–-")


@dataclass(frozen=True)
class RagChunk:
    page: int
    chunk_id: int
    text: str


def _normalize(text: str) -> str:
    if not text:
        return ""
    lines = [_INLINE_WS.sub(" ", ln).strip() for ln in text.splitlines()]
    return _BLANK_RUNS.sub("\n\n", "\n".join(lines)).strip()


def _paragraphs(text: str) -> List[str]:
    return [p for p in re.split(r"\n{2,}", text) if p.strip()]


def _sentences_of_paragraph(par: str) -> List[str]:
    parts = _BOUNDARY.split(par)
    out: List[str] = []
    buf = ""
    for part in parts:
        seg = part.strip()
        if not seg:
            continue
        last_word = buf.strip().split()[-1].lower() if buf else ""
        if last_word in _ABBREVIATIONS and not seg[:1].isupper():
            buf = f"{buf} {seg}".strip() if buf else seg
            continue
        if buf:
            out.append(buf.strip())
        buf = seg
    if buf:
        out.append(buf.strip())
    return [s for s in out if s and not all(c in _PUNCT_ONLY for c in s)]


def sentence_split(text: str) -> List[str]:
    """Split into clean sentences across paragraphs."""
    normalized = _normalize(text)
    if not normalized:
        return []
    sents: List[str] = []
    for par in _paragraphs(normalized):
        sents.extend(_sentences_of_paragraph(par))
    return sents


def _pack(sents: Sequence[str], chunk_size: int) -> List[List[str]]:
    groups: List[List[str]] = []
    cur: List[str] = []
    cur_len = 0
    for s in sents:
        n = len(s)
        if n > chunk_size:
            if cur:
                groups.append(cur)
                cur, cur_len = [], 0
            for start in range(0, n, chunk_size):
                groups.append([s[start : start + chunk_size]])
            continue
        joiner = 1 if cur_len > 0 else 0
        if cur_len + joiner + n <= chunk_size:
            cur.append(s)
            cur_len += joiner + n
        else:
            groups.append(cur)
            cur = [s]
            cur_len = n
    if cur:
        groups.append(cur)
    return groups


def _overlap_count(prev_block: List[str], target_chars: int) -> int:
    if not prev_block or target_chars <= 0:
        return 0
    total = 0
    taken = 0
    for s in reversed(prev_block):
        taken += 1
        total += len(s) + (1 if total > 0 else 0)
        if total >= target_chars:
            break
    return min(taken, max(0, len(prev_block) - 1))


def chunk_text(
    text: str,
    *,
    chunk_size: int = 1000,
    chunk_overlap: int = 150,
    page: int = 1,
    starting_chunk_id: int = 0,
) -> List[RagChunk]:
    """Chunk one page of text into overlapping sentence groups."""
    sents = sentence_split(text)
    if not sents:
        stripped = text.strip()
        if stripped:
            return [RagChunk(page=page, chunk_id=starting_chunk_id, text=stripped)]
        return []

    packed = _pack(sents, chunk_size)
    with_overlap: List[List[str]] = []
    for i, block in enumerate(packed):
        if i == 0:
            with_overlap.append(block)
            continue
        prev = with_overlap[-1]
        n = _overlap_count(prev, chunk_overlap)
        with_overlap.append(prev[-n:] + block if n > 0 else block)

    chunks: List[RagChunk] = []
    cid = starting_chunk_id
    for block in with_overlap:
        joined = " ".join(block).strip()
        if joined:
            chunks.append(RagChunk(page=page, chunk_id=cid, text=joined))
            cid += 1
    return chunks


def chunk_pages(
    pages: Iterable[Tuple[int, str]],
    *,
    chunk_size: int = 1000,
    chunk_overlap: int = 150,
    starting_chunk_id: int = 0,
) -> List[Tuple[int, int, str]]:
    """Chunk a sequence of (page, text) pairs with a global running chunk id."""
    out: List[Tuple[int, int, str]] = []
    cid = starting_chunk_id
    for page, text in pages:
        chs = chunk_text(
            text,
            chunk_size=chunk_size,
            chunk_overlap=chunk_overlap,
            page=page,
            starting_chunk_id=cid,
        )
        out.extend((c.page, c.chunk_id, c.text) for c in chs)
        if chs:
            cid = chs[-1].chunk_id + 1
    return out
