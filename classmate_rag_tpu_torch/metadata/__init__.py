"""Metadata schema + validation (host-side, dependency-light).

Host copy of the JAX package's ``metadata/__init__.py`` (no JAX).
"""

from classmate_rag_tpu_torch.metadata.schema import (
    ChunkMetadata,
    DocTypeEnum,
    DocumentMetadata,
    FILTER_SIMPLE_FIELDS,
    LanguageEnum,
    METADATA_FIELDS,
    normalize_cli_metadata,
)
from classmate_rag_tpu_torch.metadata.validation import slug_tag, validate_cli_metadata

__all__ = [
    "ChunkMetadata",
    "DocTypeEnum",
    "DocumentMetadata",
    "FILTER_SIMPLE_FIELDS",
    "LanguageEnum",
    "METADATA_FIELDS",
    "normalize_cli_metadata",
    "slug_tag",
    "validate_cli_metadata",
]
