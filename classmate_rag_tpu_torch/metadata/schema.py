"""Metadata schema: enums, document/chunk metadata, CLI normalization.

Behavioral parity with the reference (rag/metadata/schema.py:20-240):
- ``LanguageEnum`` {en,it,auto} and ``DocTypeEnum`` {8 formats + other};
- ``to_dict()`` strips the ``auto``/``other`` sentinels so they never narrow
  downstream filters (the reference's key invariant,
  rag/metadata/schema.py:70-82);
- subject normalization accepts EN+IT aliases for the four routing subjects.

Host copy of the JAX package's ``metadata/schema.py`` (no JAX).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from enum import Enum
from typing import Dict, List, Optional, Tuple


class LanguageEnum(str, Enum):
    en = "en"
    it = "it"
    auto = "auto"


class DocTypeEnum(str, Enum):
    pdf = "pdf"
    docx = "docx"
    pptx = "pptx"
    md = "md"
    txt = "txt"
    html = "html"
    csv = "csv"
    epub = "epub"
    other = "other"


METADATA_FIELDS: Tuple[str, ...] = (
    "course",
    "unit",
    "language",
    "doc_type",
    "author",
    "semester",
    "tags",
    "source_path",
    "page",
    "chunk_id",
    "created_at",
    "subject",
)

# Fields usable in equality filters (plus "tags" handled separately).
FILTER_SIMPLE_FIELDS: Tuple[str, ...] = (
    "course",
    "unit",
    "language",
    "doc_type",
    "author",
    "semester",
)


def _strip_sentinels(d: Dict) -> Dict:
    """Remove None/auto/other placeholders so filters never narrow on them,
    and flatten enums to their plain string values (str(Enum) != value on
    py>=3.11, which would corrupt filter interning).

    ALL None-valued fields drop (not just tags/subject): an unfiltered
    query must yield an EMPTY dict, or every ask would take the filtered
    slow path (bypassing the cached no-filter mask and BM25 df) and report
    noisy null filters."""
    if d.get("language") in ("auto", LanguageEnum.auto):
        d.pop("language", None)
    if d.get("doc_type") in ("other", DocTypeEnum.other):
        d.pop("doc_type", None)
    for key in ("language", "doc_type"):
        v = d.get(key)
        if isinstance(v, Enum):
            d[key] = v.value
    return {k: v for k, v in d.items() if v is not None}


@dataclass(frozen=True)
class DocumentMetadata:
    course: Optional[str] = None
    unit: Optional[str] = None
    language: LanguageEnum = LanguageEnum.auto
    doc_type: DocTypeEnum = DocTypeEnum.other
    author: Optional[str] = None
    semester: Optional[str] = None
    tags: Optional[List[str]] = None
    source_path: Optional[str] = None
    created_at: Optional[str] = None
    subject: Optional[str] = None

    def to_dict(self) -> Dict:
        return _strip_sentinels(asdict(self))


@dataclass(frozen=True)
class ChunkMetadata:
    course: Optional[str] = None
    unit: Optional[str] = None
    language: LanguageEnum = LanguageEnum.auto
    doc_type: DocTypeEnum = DocTypeEnum.other
    author: Optional[str] = None
    semester: Optional[str] = None
    tags: Optional[List[str]] = None
    source_path: Optional[str] = None
    page: Optional[int] = None
    chunk_id: Optional[int] = None
    created_at: Optional[str] = None
    subject: Optional[str] = None

    def to_dict(self) -> Dict:
        return _strip_sentinels(asdict(self))


# ------------------------------------------------------------------
# Normalization helpers
# ------------------------------------------------------------------

def _clean_str(v: Optional[str]) -> Optional[str]:
    if v is None:
        return None
    v = v.strip()
    return v or None


def _parse_tags(v) -> Optional[List[str]]:
    if v is None:
        return None
    if isinstance(v, list):
        tags = [t.strip() for t in v if isinstance(t, str) and t.strip()]
    else:
        tags = [p.strip() for p in str(v).split(",") if p.strip()]
    return tags or None


_LANG_ALIASES = {
    "en": LanguageEnum.en, "eng": LanguageEnum.en, "english": LanguageEnum.en,
    "it": LanguageEnum.it, "ita": LanguageEnum.it, "italian": LanguageEnum.it,
    "italiano": LanguageEnum.it,
    "auto": LanguageEnum.auto, "detect": LanguageEnum.auto,
    "auto-detect": LanguageEnum.auto,
}

_DOC_TYPE_ALIASES = {
    "pdf": DocTypeEnum.pdf,
    "docx": DocTypeEnum.docx,
    "pptx": DocTypeEnum.pptx, "ppt": DocTypeEnum.pptx,
    "md": DocTypeEnum.md, "markdown": DocTypeEnum.md,
    "txt": DocTypeEnum.txt, "text": DocTypeEnum.txt,
    "html": DocTypeEnum.html, "htm": DocTypeEnum.html,
    "csv": DocTypeEnum.csv,
    "epub": DocTypeEnum.epub,
}

_SUBJECT_ALIASES = {
    "math": "math", "mathematics": "math", "matematica": "math",
    "code": "code", "coding": "code", "programming": "code",
    "informatica": "code",
    "translation": "translation", "translate": "translation",
    "traduzione": "translation", "language": "translation",
    "default": "default", "general": "default", "other": "default",
}


def _normalize_language(v: Optional[str]) -> LanguageEnum:
    if not v:
        return LanguageEnum.auto
    return _LANG_ALIASES.get(v.strip().lower(), LanguageEnum.auto)


def _normalize_doc_type(v: Optional[str]) -> DocTypeEnum:
    if not v:
        return DocTypeEnum.other
    return _DOC_TYPE_ALIASES.get(v.strip().lower(), DocTypeEnum.other)


def _normalize_subject(v: Optional[str]) -> Optional[str]:
    if not v:
        return None
    return _SUBJECT_ALIASES.get(v.strip().lower())


def normalize_cli_metadata(
    *,
    course: Optional[str] = None,
    unit: Optional[str] = None,
    language: Optional[str] = None,
    doc_type: Optional[str] = None,
    author: Optional[str] = None,
    semester: Optional[str] = None,
    tags=None,
    subject: Optional[str] = None,
) -> DocumentMetadata:
    """Trim strings, coerce enums, parse + case-fold-dedupe tags."""
    tag_list = _parse_tags(tags)
    if tag_list:
        seen = set()
        deduped = []
        for t in tag_list:
            low = t.lower()
            if low not in seen:
                seen.add(low)
                deduped.append(low)
        tag_list = deduped
    return DocumentMetadata(
        course=_clean_str(course),
        unit=_clean_str(unit),
        language=_normalize_language(language),
        doc_type=_normalize_doc_type(doc_type),
        author=_clean_str(author),
        semester=_clean_str(semester),
        tags=tag_list or None,
        source_path=None,
        created_at=None,
        subject=_normalize_subject(subject),
    )
