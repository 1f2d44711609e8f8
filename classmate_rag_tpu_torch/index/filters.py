"""Metadata filtering as bitmask columns (port of the JAX package's
``index/filters.py``).

Every filterable field is interned to a small int column [F, N], tags
are packed uint32 bit columns [N, W], and a filter compiles to one
wanted-id vector plus one wanted-bit vector. ``mask_bias_device``
evaluates the predicate on tensors; ``mask_bias_host`` is its numpy twin.

Sentinel semantics: absent fields never match an equality filter,
unknown values (-2) match nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from classmate_rag_tpu_torch.utils.numerics import NEG_INF

FILTER_FIELDS: Tuple[str, ...] = (
    "course", "unit", "language", "doc_type", "author", "semester",
)
ABSENT = 0          # interned id for "field not present"
TAG_WORDS = 4       # 128 distinct tag slugs supported per index


@dataclass
class InternTable:
    """Per-field value ↔ small-int interning (0 reserved for absent)."""

    to_id: Dict[str, int] = field(default_factory=dict)

    def intern(self, value: Optional[str]) -> int:
        if value is None or value == "":
            return ABSENT
        got = self.to_id.get(value)
        if got is None:
            got = len(self.to_id) + 1
            self.to_id[value] = got
        return got

    def lookup(self, value: str) -> int:
        """-2 = unknown value: matches no row (distinct from 'no filter')."""
        return self.to_id.get(value, -2)


def mask_bias_device(field_cols, tag_bits, valid, wanted, tag_want):
    """Mask → additive f32 bias [N] (0 keep / NEG_INF drop) on tensors.

    ``field_cols``: i32 [F, N]; ``tag_bits``: i32 [N, W] (the uint32
    words reinterpreted, torch has no uint32 bitwise ops on every
    device); ``valid``: bool [N]; ``wanted``: i32 [F]; ``tag_want``:
    i32 [W] (same reinterpretation).
    """
    no_constraint = (wanted < 0)[:, None]
    eq = field_cols == wanted[:, None]
    fields_ok = torch.all(no_constraint | eq, dim=0)
    impossible = torch.any(wanted == -2)
    tags_ok = torch.all(
        (tag_bits & tag_want[None, :]) == tag_want[None, :], dim=1
    )
    keep = fields_ok & tags_ok & valid & ~impossible
    return torch.where(
        keep,
        torch.zeros((), dtype=torch.float32, device=keep.device),
        torch.full((), NEG_INF, dtype=torch.float32, device=keep.device),
    )


def mask_bias_host(field_cols, tag_bits, valid, wanted, tag_want):
    """Pure-numpy twin of mask_bias_device."""
    no_constraint = (wanted < 0)[:, None]
    eq = field_cols == wanted[:, None]
    fields_ok = np.all(np.where(no_constraint, True, eq), axis=0)
    impossible = bool(np.any(wanted == -2))
    tags_ok = np.all(
        (tag_bits & tag_want[None, :]) == tag_want[None, :], axis=1
    )
    keep = fields_ok & tags_ok & valid & (not impossible)
    return np.where(keep, 0.0, NEG_INF).astype(np.float32)
