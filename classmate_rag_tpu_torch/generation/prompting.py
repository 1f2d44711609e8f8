"""Prompt construction: numbered context blocks + grounded/general messages.

Parity with the reference (rag/generation/prompting.py:13-86), including the
quirky budget rule: provenance for a block is appended *before* the budget
check, and a block that would exceed the budget breaks the loop (so its
provenance is still listed).

Host copy of the JAX package's ``generation/prompting.py`` (no JAX).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple


def format_context_blocks(
    retrieved: Sequence[Dict[str, Any]],
    *,
    max_total_chars: Optional[int] = 2000,
) -> Tuple[str, List[str]]:
    """Return ("[1] text\n\n[2] text…", provenance aligned with block numbers)."""
    blocks: List[str] = []
    provenance: List[str] = []
    used = 0
    for n, item in enumerate(retrieved, start=1):
        text = str(item.get("document") or "").strip()
        meta = item.get("metadata") or {}
        src = str(meta.get("source_path") or "")
        provenance.append(src if src else f"chunk-{n}")
        if not text:
            continue
        block = f"[{n}] {text}"
        if max_total_chars is not None and used + len(block) > max_total_chars:
            break
        blocks.append(block)
        used += len(block)
    return "\n\n".join(blocks), provenance


def build_grounded_messages(
    question: str,
    context_text: str,
    *,
    citations_required: bool = True,
) -> List[Dict[str, str]]:
    system = (
        "You are a helpful assistant that answers questions "
        "using the provided context. "
    )
    if citations_required:
        system += (
            "Include numeric citations [1], [2], ... "
            "next to the statements you make. "
            "Cite only from the provided context."
        )
    else:
        system += "You may use the provided context, but citations are optional."
    user = f"Context:\n{context_text}\n\nQuestion:\n{question}\n\nAnswer:"
    return [
        {"role": "system", "content": system},
        {"role": "user", "content": user},
    ]


def build_general_messages(question: str) -> List[Dict[str, str]]:
    return [
        {"role": "system",
         "content": "You are a helpful assistant that answers general questions."},
        {"role": "user", "content": question},
    ]
