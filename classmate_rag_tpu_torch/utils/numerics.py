"""Shared numeric constants and shape helpers (copy of the JAX package's
``utils/numerics.py``; numpy-only)."""

from __future__ import annotations

import numpy as np

# The mask/sentinel value: f32 min, not -inf. Scores at or below
# NEG_INF/2 mean "masked row".
NEG_INF = float(np.finfo(np.float32).min)


def round_up(x: int, m: int) -> int:
    """Ceil ``x`` to a multiple of ``m``, clamped to at least one ``m``
    (padding semantics: a zero-size input still gets one tile)."""
    return max(m, (x + m - 1) // m * m)
