"""In-memory chunk catalog (port of the lookup surface of the JAX
package's ``index/catalog.py``; its on-disk journal and fold come in a
later slice)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence


@dataclass
class CatalogEntry:
    id: str
    text: str
    tokens: List[str]
    metadata: Dict[str, Any]


@dataclass
class Catalog:
    """id → entry, in first-seen order (re-upserts keep their place)."""

    _entries: Dict[str, CatalogEntry] = field(default_factory=dict)

    def upsert(self, entry: CatalogEntry) -> None:
        self._entries[entry.id] = entry

    def delete(self, ids: Sequence[str]) -> int:
        n = 0
        for cid in ids:
            if self._entries.pop(cid, None) is not None:
                n += 1
        return n

    def get(self, cid: str) -> Optional[CatalogEntry]:
        return self._entries.get(cid)

    def __contains__(self, cid: str) -> bool:
        return cid in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def ids(self) -> List[str]:
        return list(self._entries)
