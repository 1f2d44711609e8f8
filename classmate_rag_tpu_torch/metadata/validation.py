"""Tag slugs from metadata (copy of the two functions of the JAX
package's ``metadata/validation.py`` that the index needs)."""

from __future__ import annotations

import re
from typing import Any, List, Optional

_TAG_SLUG_RE = re.compile(r"[^a-z0-9]+")


def slug_tag(tag: str) -> str:
    """Lowercase and collapse non-alphanumerics to underscores."""
    s = _TAG_SLUG_RE.sub("_", (tag or "").lower().strip())
    return s.strip("_")


def tags_from_meta(meta: Any) -> List[str]:
    """Tag slugs from persisted metadata, accepting both shapes: the
    reference's ``tag_<slug>: True`` flags and a legacy ``tags`` list."""
    out: List[str] = []
    seen = set()
    for k, v in (meta or {}).items():
        if k.startswith("tag_") and v and k[4:] and k[4:] not in seen:
            seen.add(k[4:])
            out.append(k[4:])
    # A legacy tags value may be a comma string, which would otherwise be
    # iterated character by character.
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
