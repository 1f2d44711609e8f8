"""Routing types (parity with rag/routing/types.py:14-48).

Route values are persisted in chunk metadata ``subject`` — changing them
breaks existing indexes.

Host copy of the JAX package's ``routing/types.py`` (no JAX).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Literal, Tuple

Route = Literal["math", "code", "translation", "default"]
ROUTES: Tuple[Route, ...] = ("math", "code", "translation", "default")
DEFAULT_ROUTE: Route = "default"


@dataclass
class RouteDecision:
    route: Route
    reason: str
    query_scores: Dict[Route, float] = field(default_factory=dict)
    meta_scores: Dict[Route, float] = field(default_factory=dict)
    margin: float = 0.0

    def short_log(self) -> str:
        q = ", ".join(f"{r}={s:.3f}" for r, s in self.query_scores.items())
        m = ", ".join(f"{r}={s:.2f}" for r, s in self.meta_scores.items())
        return (
            f"route={self.route} reason={self.reason} "
            f"margin={self.margin:.3f} q[{q}] meta[{m}]"
        )
