"""CLI-boundary metadata validation.

Behavior mirrors the reference (rag/metadata/validation.py:150-242):
- strict path raises ``ValueError`` on unknown language/doc_type or tags with
  characters outside ``[A-Za-z0-9_-]``;
- ``fixup=True`` coerces instead: language -> "auto", unknown doc_type ->
  inferred (or None), tags slugified to ``[a-z0-9_]``;
- doc_type rules: an explicitly-passed invalid doc_type errors even with
  fixup; a missing/"other" doc_type takes ``inferred_doc_type`` when given
  and is never auto-set to "other".

Implemented without pydantic — plain functions are simpler, faster at import
time, and carry no v1/v2 compatibility shim.

Host copy of the JAX package's ``metadata/validation.py`` (no JAX).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

from classmate_rag_tpu_torch.metadata import schema

_LANGS = {"en", "it", "auto"}
_DOC_TYPES = {"pdf", "docx", "pptx", "md", "txt", "html", "csv", "epub", "other"}
# Single alias source of truth: schema.py's enum tables (review r4 — two
# hand-maintained copies would let validation and normalization disagree
# the first time an alias is added to only one of them).
_DOC_TYPE_FIXES = {
    k: v.value for k, v in schema._DOC_TYPE_ALIASES.items()
}
_LANG_FIXES = {k: v.value for k, v in schema._LANG_ALIASES.items()}
_TAG_STRICT_RE = re.compile(r"[A-Za-z0-9_\-]+")
_TAG_SLUG_RE = re.compile(r"[^a-z0-9]+")


def _clean_str(v: Any) -> Optional[str]:
    if v is None:
        return None
    s = str(v).strip()
    return s or None


def _norm_lang(v: Any) -> Optional[str]:
    s = _clean_str(v)
    if s is None:
        return None
    return _LANG_FIXES.get(s.lower())


def _norm_doc_type(v: Any) -> Optional[str]:
    s = _clean_str(v)
    if s is None:
        return None
    s = s.lower()
    if s in _DOC_TYPES:
        return s
    return _DOC_TYPE_FIXES.get(s)


def slug_tag(tag: str) -> str:
    """Lowercase and collapse non-alphanumerics to underscores."""
    s = _TAG_SLUG_RE.sub("_", (tag or "").lower().strip())
    return s.strip("_")


def expand_tag_flags(tags: Any) -> Dict[str, bool]:
    """Tags (list or comma string) → ``{"tag_<slug>": True, ...}``.

    The reference persists tags this way in BOTH stores (its thin Chroma
    client only accepts scalar metadata values — rag/pipeline/rag.py:
    180-202) and its admin filters match on the flags, so interop with
    reference-written catalogs requires the same shape on disk.
    """
    flags: Dict[str, bool] = {}
    for t in _split_tags(tags) or []:
        slug = slug_tag(t)
        if slug:
            flags[f"tag_{slug}"] = True
    return flags


def tags_from_meta(meta: Any) -> List[str]:
    """Tag slugs from persisted metadata, accepting both shapes: the
    reference's ``tag_<slug>: True`` flags and a legacy ``tags`` list
    (catalogs written before the flag alignment)."""
    out: List[str] = []
    seen = set()
    for k, v in (meta or {}).items():
        if k.startswith("tag_") and v and k[4:] and k[4:] not in seen:
            seen.add(k[4:])
            out.append(k[4:])
    # _split_tags, not raw iteration: a legacy tags value may be a comma
    # string, which would otherwise be iterated character by character.
    for t in _split_tags((meta or {}).get("tags")) or []:
        slug = slug_tag(t)
        if slug and slug not in seen:
            seen.add(slug)
            out.append(slug)
    return out


def _split_tags(v: Any) -> Optional[List[str]]:
    if v is None:
        return None
    if isinstance(v, str):
        arr = [p.strip() for p in v.split(",") if p.strip()]
    else:
        arr = [str(x).strip() for x in list(v) if str(x).strip()]
    return arr or None


def validate_cli_metadata(
    raw: Dict[str, Any],
    *,
    fixup: bool = False,
    inferred_doc_type: Optional[str] = None,
    explicit_doc_type: bool = False,
) -> Dict[str, Any]:
    """Validate + normalize CLI metadata; see module docstring for rules."""
    lang_in = raw.get("language")
    lang = _norm_lang(lang_in)
    if _clean_str(lang_in) is not None and lang is None:
        if not fixup:
            raise ValueError(
                f"unsupported language '{lang_in}' (allowed: en/it/auto)"
            )
        lang = "auto"

    dt_in = raw.get("doc_type")
    dt = _norm_doc_type(dt_in)
    if _clean_str(dt_in) is not None and dt is None:
        if explicit_doc_type or not fixup:
            raise ValueError(
                f"unsupported doc_type '{dt_in}' (allowed: {sorted(_DOC_TYPES)})"
            )
        dt = None

    data: Dict[str, Any] = {
        "course": _clean_str(raw.get("course")),
        "unit": _clean_str(raw.get("unit")),
        "language": lang,
        "doc_type": dt,
        "author": _clean_str(raw.get("author")),
        "semester": _clean_str(raw.get("semester")),
        "tags": _split_tags(raw.get("tags")),
    }

    if fixup and data["language"] is None:
        data["language"] = "auto"

    # doc_type inference: never auto-set to "other".
    if data["doc_type"] is None or data["doc_type"] == "other":
        if inferred_doc_type:
            data["doc_type"] = inferred_doc_type
        elif explicit_doc_type and data["doc_type"] == "other":
            data["doc_type"] = "other"
        else:
            data["doc_type"] = None

    tags = data.get("tags")
    if tags:
        cleaned: List[str] = []
        for t in tags:
            if fixup:
                s = slug_tag(t)
                if s:
                    cleaned.append(s)
            else:
                if _TAG_STRICT_RE.fullmatch(t):
                    cleaned.append(t)
                else:
                    raise ValueError(
                        f"invalid tag '{t}'; use letters, numbers, '_' or '-' "
                        "(or pass --fixup)"
                    )
        seen = set()
        deduped = []
        for t in cleaned:
            if t not in seen:
                seen.add(t)
                deduped.append(t)
        data["tags"] = deduped or None

    return data
