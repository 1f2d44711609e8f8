"""Port of ``classmate_rag_tpu.routing``: the route types and system
prompts the ask pipeline reads. The router, the classifier and the
route models are not ported yet (ROADMAP §1, routing)."""

from classmate_rag_tpu_torch.routing.prompts import system_prompt_for
from classmate_rag_tpu_torch.routing.types import (
    DEFAULT_ROUTE,
    ROUTES,
    Route,
    RouteDecision,
)

__all__ = [
    "DEFAULT_ROUTE",
    "ROUTES",
    "Route",
    "RouteDecision",
    "system_prompt_for",
]
