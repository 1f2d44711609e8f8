"""Port of ``classmate_rag_tpu.metadata``."""
