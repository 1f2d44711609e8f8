"""Port of ``classmate_rag_tpu.generation``: prompting, citation
post-processing and the runners (extractive, llama.cpp, the decoder)."""

from classmate_rag_tpu_torch.generation.prompting import (
    build_general_messages,
    build_grounded_messages,
    format_context_blocks,
)
from classmate_rag_tpu_torch.generation.post import enforce_citations
from classmate_rag_tpu_torch.generation.runner import (
    DecodeRunner,
    ExtractiveRunner,
    LlamaCppRunner,
    get_runner,
)

__all__ = [
    "DecodeRunner",
    "ExtractiveRunner",
    "LlamaCppRunner",
    "build_general_messages",
    "build_grounded_messages",
    "enforce_citations",
    "format_context_blocks",
    "get_runner",
]
