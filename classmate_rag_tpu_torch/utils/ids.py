"""Deterministic chunk identifiers.

ID scheme is byte-compatible with the reference (rag/utils/ids.py:17-29):
``"cm_" + blake2b(key, digest_size=16)`` over
``"<resolved path>|<page>|<chunk_index>|<course>|<unit>"`` — this keeps
re-ingest idempotent AND lets neighbor expansion reconstruct adjacent chunk
IDs with pure index arithmetic, which is what makes the on-device neighbor
lookup possible.

Host copy of the JAX package's ``utils/ids.py`` (no JAX).
"""

from __future__ import annotations

from hashlib import blake2b
from pathlib import Path
from typing import Optional


def stable_chunk_id(
    *,
    source_path: str | Path,
    page: int,
    chunk_index: int,
    course: Optional[str] = None,
    unit: Optional[str] = None,
    prefix: str = "cm_",
) -> str:
    resolved = str(Path(source_path).resolve())
    key = f"{resolved}|{page}|{chunk_index}|{course or ''}|{unit or ''}"
    digest = blake2b(key.encode("utf-8"), digest_size=16).hexdigest()
    return f"{prefix}{digest}"
