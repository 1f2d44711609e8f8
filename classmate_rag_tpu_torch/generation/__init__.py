"""Port of ``classmate_rag_tpu.generation``: prompting, citation
post-processing and the runners (the decoder runner is not ported)."""

from classmate_rag_tpu_torch.generation.prompting import (
    build_general_messages,
    build_grounded_messages,
    format_context_blocks,
)
from classmate_rag_tpu_torch.generation.post import enforce_citations
from classmate_rag_tpu_torch.generation.runner import (
    ExtractiveRunner,
    LlamaCppRunner,
    get_runner,
)

__all__ = [
    "ExtractiveRunner",
    "LlamaCppRunner",
    "build_general_messages",
    "build_grounded_messages",
    "enforce_citations",
    "format_context_blocks",
    "get_runner",
]
