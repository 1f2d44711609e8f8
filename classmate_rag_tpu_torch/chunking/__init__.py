"""Host copy of the JAX package's ``chunking/__init__.py`` (no JAX)."""

from classmate_rag_tpu_torch.chunking.chunker import (
    RagChunk,
    chunk_pages,
    chunk_text,
    sentence_split,
)

__all__ = ["RagChunk", "chunk_pages", "chunk_text", "sentence_split"]
