"""Plain-text, Markdown, HTML, and CSV loaders (host-side, stdlib only).

Parity notes vs the reference:
- txt/md: whole file as page 1 (rag/loaders/__init__.py:76-87). Markdown
  keeps its markup; optionally strips YAML front-matter — the reference had
  this in an orphaned loader (rag/loaders/text_loader.py:49-85) that was
  never wired; here it's on by default because front-matter is metadata,
  not content.
- csv: each row becomes a "- col: val; col: val" bullet, 80 rows per page
  (rag/loaders/csv_bullets.py:41-58).
- html: single page of extracted main-content text
  (rag/loaders/html_readable.py:37-50).

Host copy of the JAX package's ``loaders/textfiles.py`` (no JAX).
"""

from __future__ import annotations

import csv
import re
from pathlib import Path
from typing import List, Tuple

from classmate_rag_tpu_torch.loaders.htmltext import html_to_text

Pages = List[Tuple[int, str]]

_FRONT_MATTER = re.compile(r"\A---\s*\n.*?\n---\s*\n", re.DOTALL)


def load_txt(path: Path) -> Pages:
    text = path.read_text(encoding="utf-8", errors="ignore").strip()
    return [(1, text)] if text else []


def load_md(path: Path, *, strip_front_matter: bool = True) -> Pages:
    text = path.read_text(encoding="utf-8", errors="ignore")
    if strip_front_matter:
        text = _FRONT_MATTER.sub("", text)
    text = text.strip()
    return [(1, text)] if text else []


def load_html(path: Path) -> Pages:
    html = path.read_text(encoding="utf-8", errors="ignore")
    text = html_to_text(html).strip()
    return [(1, text)] if text else []


def _row_bullet(row: dict) -> str:
    parts: List[str] = []
    for key, val in row.items():
        k = (key or "").strip()
        v = (val or "").strip() if isinstance(val, str) else str(val or "")
        if not k and not v:
            continue
        if k and v:
            parts.append(f"{k}: {v}")
        elif k:
            parts.append(f"{k}:")
        else:
            parts.append(v)
    return "- " + "; ".join(parts) if parts else ""


def load_csv(path: Path, *, rows_per_page: int = 80) -> Pages:
    bullets: List[str] = []
    with path.open("r", encoding="utf-8", errors="ignore", newline="") as f:
        for row in csv.DictReader(f):
            b = _row_bullet({k or "": (v or "") for k, v in row.items()})
            if b:
                bullets.append(b)
    if not bullets:
        return []
    pages: Pages = []
    for page, start in enumerate(range(0, len(bullets), rows_per_page), start=1):
        pages.append((page, "\n".join(bullets[start : start + rows_per_page])))
    return pages
