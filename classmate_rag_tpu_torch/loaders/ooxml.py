"""DOCX / PPTX loaders built directly on zipfile + ElementTree.

python-docx / python-pptx are not available in this environment, and the
formats are just zipped XML, so these parse the OOXML parts directly.

Parity with the reference loaders:
- docx: body-level paragraphs joined by newlines into a single page 1
  (rag/loaders/__init__.py:105-112). Tables are ALSO walked (the reference
  kept table support only in an orphaned loader, rag/loaders/docx_loader.py)
  — rows render as tab-joined lines after the paragraph flow.
- pptx: one page per slide; each text-bearing shape contributes its paragraphs
  (rag/loaders/__init__.py:115-133); slide notes are appended when present
  (reference had notes only in the orphaned rag/loaders/pptx_loader.py:41-74).

Host copy of the JAX package's ``loaders/ooxml.py`` (no JAX).
"""

from __future__ import annotations

import re
import zipfile
from pathlib import Path
from typing import List, Tuple
from xml.etree import ElementTree as ET

Pages = List[Tuple[int, str]]

_W = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"
_A = "{http://schemas.openxmlformats.org/drawingml/2006/main}"

_SLIDE_RE = re.compile(r"^ppt/slides/slide(\d+)\.xml$")
_NOTES_RE = re.compile(r"^ppt/notesSlides/notesSlide(\d+)\.xml$")


def _docx_paragraph_text(par: ET.Element) -> str:
    """Concatenate runs of one w:p, mapping tabs/breaks to whitespace."""
    parts: List[str] = []
    for node in par.iter():
        tag = node.tag
        if tag == f"{_W}t":
            parts.append(node.text or "")
        elif tag == f"{_W}tab":
            parts.append("\t")
        elif tag in (f"{_W}br", f"{_W}cr"):
            parts.append("\n")
    return "".join(parts).strip()


def load_docx(path: Path) -> Pages:
    with zipfile.ZipFile(path) as zf:
        with zf.open("word/document.xml") as f:
            root = ET.parse(f).getroot()
    body = root.find(f"{_W}body")
    if body is None:
        return []
    lines: List[str] = []
    for child in body:
        if child.tag == f"{_W}p":
            t = _docx_paragraph_text(child)
            if t:
                lines.append(t)
        elif child.tag == f"{_W}tbl":
            for row in child.iter(f"{_W}tr"):
                cells = []
                for cell in row.iter(f"{_W}tc"):
                    cell_text = " ".join(
                        filter(None, (_docx_paragraph_text(p) for p in cell.iter(f"{_W}p")))
                    )
                    cells.append(cell_text)
                line = "\t".join(cells).strip()
                if line:
                    lines.append(line)
    text = "\n".join(lines).strip()
    return [(1, text)] if text else []


def _drawing_text(xml_root: ET.Element) -> str:
    """Extract paragraphs from every txBody under the given root.

    txBody lives in the presentationml namespace inside slides (p:txBody)
    but in the drawingml namespace in charts/diagrams, so match by local
    name.
    """
    blocks: List[str] = []
    for tx_body in xml_root.iter():
        if not tx_body.tag.endswith("}txBody"):
            continue
        para_lines: List[str] = []
        for par in tx_body.findall(f"{_A}p"):
            runs = [t.text or "" for t in par.iter(f"{_A}t")]
            line = "".join(runs).strip()
            if line:
                para_lines.append(line)
        if para_lines:
            blocks.append("\n".join(para_lines))
    return "\n".join(blocks).strip()


def load_pptx(path: Path, *, include_notes: bool = True) -> Pages:
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        slide_names = sorted(
            (n for n in names if _SLIDE_RE.match(n)),
            key=lambda n: int(_SLIDE_RE.match(n).group(1)),
        )
        notes_by_num = {}
        if include_notes:
            for n in names:
                m = _NOTES_RE.match(n)
                if m:
                    notes_by_num[int(m.group(1))] = n

        pages: Pages = []
        for idx, name in enumerate(slide_names, start=1):
            with zf.open(name) as f:
                root = ET.parse(f).getroot()
            text = _drawing_text(root)
            slide_num = int(_SLIDE_RE.match(name).group(1))
            notes_name = notes_by_num.get(slide_num)
            if notes_name:
                with zf.open(notes_name) as f:
                    notes_root = ET.parse(f).getroot()
                notes = _drawing_text(notes_root)
                # Notes bodies repeat the slide number as a standalone digit
                # shape; keep only substantive lines.
                notes = "\n".join(
                    ln for ln in notes.splitlines() if ln.strip() and not ln.strip().isdigit()
                )
                if notes:
                    text = f"{text}\n{notes}".strip() if text else notes
            if text:
                pages.append((idx, text))
        return pages
