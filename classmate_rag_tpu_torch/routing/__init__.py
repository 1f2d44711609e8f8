"""Port of ``classmate_rag_tpu.routing``: the subject classifier, the
hybrid router, the route → model registry and the sticky single-resident
model loader, with the route types and system prompts."""

from classmate_rag_tpu_torch.routing.classifier import (
    ClassificationResult,
    SubjectClassifier,
)
from classmate_rag_tpu_torch.routing.loader import StickyModelLoader
from classmate_rag_tpu_torch.routing.prompts import system_prompt_for
from classmate_rag_tpu_torch.routing.registry import ModelSpec, get_model_spec
from classmate_rag_tpu_torch.routing.router import HybridRouter
from classmate_rag_tpu_torch.routing.types import (
    DEFAULT_ROUTE,
    ROUTES,
    Route,
    RouteDecision,
)

__all__ = [
    "ClassificationResult",
    "DEFAULT_ROUTE",
    "HybridRouter",
    "ModelSpec",
    "ROUTES",
    "Route",
    "RouteDecision",
    "StickyModelLoader",
    "SubjectClassifier",
    "get_model_spec",
    "system_prompt_for",
]
