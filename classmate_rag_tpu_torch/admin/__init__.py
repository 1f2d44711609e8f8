"""Admin plane: backup/restore, curation and inspection (port of the JAX
package's ``admin``).

Imports load lazily via ``__getattr__`` so importing this package does
not pull the device stack.
"""

from __future__ import annotations

_EXPORTS = {
    "dump_index": "classmate_rag_tpu_torch.admin.backup",
    "restore_dump": "classmate_rag_tpu_torch.admin.backup",
    "vacuum_indexes": "classmate_rag_tpu_torch.admin.backup",
    "rebuild_embeddings": "classmate_rag_tpu_torch.admin.backup",
    "list_entries": "classmate_rag_tpu_torch.admin.manage",
    "show_entries_by_id": "classmate_rag_tpu_torch.admin.manage",
    "resolve_ids": "classmate_rag_tpu_torch.admin.manage",
    "delete_by_ids": "classmate_rag_tpu_torch.admin.manage",
    "reingest_paths": "classmate_rag_tpu_torch.admin.manage",
    "list_source_paths": "classmate_rag_tpu_torch.admin.manage",
    "retrieve_preview": "classmate_rag_tpu_torch.admin.inspect",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    module_name = _EXPORTS.get(name)
    if module_name is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(module_name), name)
