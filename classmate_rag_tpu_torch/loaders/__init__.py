"""Unified document loading: 8 formats → list[(page:int, text:str)].

API parity with the reference (rag/loaders/__init__.py:51-69,140-170):
``infer_doc_type_from_path`` and ``load_document_by_type``. All loaders are
self-contained (stdlib + the in-package HTML extractor) — no pypdf /
python-docx / python-pptx / ebooklib dependencies. Unknown doc types fall
back to plain-text loading, matching the reference.

Host copy of the JAX package's ``loaders/__init__.py`` (no JAX).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

from classmate_rag_tpu_torch.loaders.textfiles import load_csv, load_html, load_md, load_txt
from classmate_rag_tpu_torch.loaders.ooxml import load_docx, load_pptx
from classmate_rag_tpu_torch.loaders.epub import load_epub
from classmate_rag_tpu_torch.loaders.pdf import load_pdf

Pages = List[Tuple[int, str]]

_EXT_TO_TYPE = {
    "htm": "html", "html": "html",
    "csv": "csv",
    "epub": "epub",
    "md": "md", "markdown": "md",
    "txt": "txt", "text": "txt",
    "pdf": "pdf",
    "docx": "docx",
    "pptx": "pptx", "ppt": "pptx",
}


def infer_doc_type_from_path(path: str | Path) -> str:
    ext = Path(path).suffix.lower().lstrip(".")
    return _EXT_TO_TYPE.get(ext, "other")


def load_document_by_type(
    path: str | Path,
    doc_type: str,
    *,
    enable_ocr: bool = False,
) -> Pages:
    """Dispatch to the loader for ``doc_type``; unknown types load as text.

    Malformed documents raise ``ValueError`` with the path and format —
    the error surface callers (CLI/serve) already handle — instead of
    leaking format-library internals like ``zipfile.BadZipFile``.
    """
    import zipfile
    from xml.etree.ElementTree import ParseError

    p = Path(path).expanduser().resolve()
    t = (doc_type or infer_doc_type_from_path(p)).lower()
    try:
        if t == "txt":
            return load_txt(p)
        if t == "md":
            return load_md(p)
        if t == "html":
            return load_html(p)
        if t == "csv":
            return load_csv(p)
        if t == "epub":
            return load_epub(p)
        if t == "pdf":
            return load_pdf(p, enable_ocr=enable_ocr)
        if t == "docx":
            return load_docx(p)
        if t == "pptx":
            return load_pptx(p)
        return load_txt(p)
    except (zipfile.BadZipFile, ParseError, KeyError, ValueError) as exc:
        raise ValueError(f"cannot parse {p} as {t}: {exc}") from exc


__all__ = [
    "infer_doc_type_from_path",
    "load_document_by_type",
    "load_txt",
    "load_md",
    "load_html",
    "load_csv",
    "load_epub",
    "load_pdf",
    "load_docx",
    "load_pptx",
]
