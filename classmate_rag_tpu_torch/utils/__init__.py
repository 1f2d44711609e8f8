"""Host-side utilities: normalization, language detection, IDs, dedup.

Host copy of the JAX package's ``utils/__init__.py`` (no JAX).
"""

from classmate_rag_tpu_torch.utils.text import normalize_text
from classmate_rag_tpu_torch.utils.lang import detect_lang_tag
from classmate_rag_tpu_torch.utils.ids import stable_chunk_id
from classmate_rag_tpu_torch.utils.dedup import dedup_text_blocks

__all__ = [
    "normalize_text",
    "detect_lang_tag",
    "stable_chunk_id",
    "dedup_text_blocks",
]
