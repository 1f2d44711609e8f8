"""Whitespace normalization helpers (parity with rag/utils/text.py:14-33).

Host copy of the JAX package's ``utils/text.py`` (no JAX).
"""

from __future__ import annotations

import re

_INLINE_WS = re.compile(r"[ \t]+")
_BLANK_RUNS = re.compile(r"\n{3,}")


def normalize_text(text: str) -> str:
    """Collapse runs of spaces/tabs, trim each line, cap blank runs at one."""
    if not text:
        return ""
    lines = [_INLINE_WS.sub(" ", line).strip() for line in text.splitlines()]
    joined = "\n".join(lines)
    return _BLANK_RUNS.sub("\n\n", joined).strip()
