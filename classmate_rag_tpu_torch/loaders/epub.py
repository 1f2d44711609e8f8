"""EPUB loader on zipfile + ElementTree (ebooklib is unavailable here).

EPUB is a zip with an OPF package manifest. Parity target: one "page" per
content document, in spine order (rag/loaders/epub_loader.py:32-44 iterates
DOCUMENT items). Text extraction shares the stdlib HTML extractor.

Host copy of the JAX package's ``loaders/epub.py`` (no JAX).
"""

from __future__ import annotations

import posixpath
import zipfile
from pathlib import Path
from typing import Dict, List, Tuple
from xml.etree import ElementTree as ET

from classmate_rag_tpu_torch.loaders.htmltext import html_to_text

Pages = List[Tuple[int, str]]

_CONTAINER = "META-INF/container.xml"
_CNS = "{urn:oasis:names:tc:opendocument:xmlns:container}"
_OPF = "{http://www.idpf.org/2007/opf}"

_DOC_MEDIA_TYPES = {
    "application/xhtml+xml",
    "text/html",
    "application/x-dtbook+xml",
}


def _opf_path(zf: zipfile.ZipFile) -> str:
    with zf.open(_CONTAINER) as f:
        root = ET.parse(f).getroot()
    rootfile = root.find(f"{_CNS}rootfiles/{_CNS}rootfile")
    if rootfile is None:
        raise ValueError("EPUB container.xml has no rootfile")
    return rootfile.get("full-path", "")


def _manifest_and_spine(zf: zipfile.ZipFile, opf_path: str):
    with zf.open(opf_path) as f:
        root = ET.parse(f).getroot()
    base = posixpath.dirname(opf_path)

    manifest: Dict[str, Tuple[str, str]] = {}
    man_el = root.find(f"{_OPF}manifest")
    if man_el is not None:
        for item in man_el.findall(f"{_OPF}item"):
            iid = item.get("id", "")
            href = item.get("href", "")
            media = item.get("media-type", "")
            full = posixpath.normpath(posixpath.join(base, href)) if base else href
            manifest[iid] = (full, media)

    spine_ids: List[str] = []
    spine_el = root.find(f"{_OPF}spine")
    if spine_el is not None:
        spine_ids = [
            ref.get("idref", "") for ref in spine_el.findall(f"{_OPF}itemref")
        ]
    return manifest, spine_ids


def load_epub(path: Path) -> Pages:
    with zipfile.ZipFile(path) as zf:
        opf = _opf_path(zf)
        manifest, spine = _manifest_and_spine(zf, opf)

        ordered: List[str] = []
        seen = set()
        for iid in spine:
            entry = manifest.get(iid)
            if entry and entry[1] in _DOC_MEDIA_TYPES and entry[0] not in seen:
                ordered.append(entry[0])
                seen.add(entry[0])
        # Any content documents not in the spine come after, manifest order.
        for iid, (href, media) in manifest.items():
            if media in _DOC_MEDIA_TYPES and href not in seen:
                ordered.append(href)
                seen.add(href)

        pages: Pages = []
        # Page numbers COMPACT over empty documents (an image-only cover
        # does not consume page 1) — byte-for-byte the reference's
        # numbering (rag/loaders/epub_loader.py:36-43 increments only on
        # non-empty docs), which stable chunk IDs depend on. Do NOT
        # switch to positional spine indices.
        page = 1
        names = set(zf.namelist())
        for href in ordered:
            if href not in names:
                continue
            with zf.open(href) as f:
                text = html_to_text(f.read()).strip()
            if text:
                pages.append((page, text))
                page += 1
        return pages
