"""Citation post-processing: validate [n] refs, compact, optional Sources.

Parity with the reference (rag/generation/post.py:38-101): out-of-range
``[n]`` are removed, adjacent citations compact ("] [" → "]["), whitespace
runs collapse, and an optional Sources/Fonti block lists cited provenance
in first-citation order.

Host copy of the JAX package's ``generation/post.py`` (no JAX).
"""

from __future__ import annotations

import re
from typing import List

_CITE_RE = re.compile(r"\[(\d+)\]")
_ADJACENT_RE = re.compile(r"\]\s*(?:,?\s*)\[")
# \s (not just spaces): the reference collapses newline runs too
# (rag/generation/post.py:49) — enforced by the differential fuzz.
_SPACE_RUNS = re.compile(r"\s{2,}")


def _cited_indices(text: str) -> List[int]:
    return [int(m.group(1)) for m in _CITE_RE.finditer(text or "")]


def enforce_citations(
    answer: str,
    provenance: List[str],
    *,
    add_sources_block: bool = False,
    sources_title: str = "Sources",
) -> str:
    if not (answer or "").strip():
        return ""
    max_idx = len(provenance)

    def drop_invalid(m: re.Match) -> str:
        n = int(m.group(1))
        return m.group(0) if 1 <= n <= max_idx else ""

    cleaned = _CITE_RE.sub(drop_invalid, answer)
    cleaned = _ADJACENT_RE.sub("][", cleaned)
    cleaned = _SPACE_RUNS.sub(" ", cleaned).strip()

    if not add_sources_block:
        return cleaned

    seen = set()
    ordered: List[int] = []
    for n in _cited_indices(cleaned):
        if n not in seen:
            seen.add(n)
            ordered.append(n)
    if not ordered:
        return cleaned
    lines = [sources_title]
    for n in ordered:
        if 1 <= n <= max_idx:
            lines.append(f"[{n}] {provenance[n - 1]}")
    return cleaned + "\n" + "\n".join(lines)
