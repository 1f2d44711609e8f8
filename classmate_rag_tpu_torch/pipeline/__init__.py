"""Stable pipeline surface (port of the JAX package's
``pipeline/__init__.py``, parity with rag/pipeline/__init__.py:32-50).

Exports load lazily so importing the package stays cheap for the CLI
parser and slim tests.
"""

from __future__ import annotations

_EXPORTS = {
    "ingest_file": "classmate_rag_tpu_torch.pipeline.ingest",
    "IngestResult": "classmate_rag_tpu_torch.pipeline.ingest",
    "ask_question": "classmate_rag_tpu_torch.pipeline.ask",
    "ask_question_batch": "classmate_rag_tpu_torch.pipeline.ask",
    "AskResult": "classmate_rag_tpu_torch.pipeline.ask",
    "index_stats": "classmate_rag_tpu_torch.pipeline.stats",
    "retrieve_preview": "classmate_rag_tpu_torch.admin.inspect",
    "get_runtime": "classmate_rag_tpu_torch.pipeline.runtime",
    "reset_runtime": "classmate_rag_tpu_torch.pipeline.runtime",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    module_name = _EXPORTS.get(name)
    if module_name is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(module_name), name)
