"""Port of ``classmate_rag_tpu.retrieval``."""

from classmate_rag_tpu_torch.retrieval.expand import expand_with_neighbors
from classmate_rag_tpu_torch.retrieval.hybrid import HybridRetriever

__all__ = ["HybridRetriever", "expand_with_neighbors"]
