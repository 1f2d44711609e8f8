"""Route → model spec resolution (parity with rag/routing/registry.py:46-94).

A route whose model file is missing falls back to the default route's spec;
if the default is missing too, raise. Specs cover whichever backend serves
the route (GGUF path for llama.cpp, HF dir for the TPU decoder).

Port of the JAX package's ``routing/registry.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from classmate_rag_tpu_torch.config import Config, load_config
from classmate_rag_tpu_torch.routing.types import DEFAULT_ROUTE, Route


@dataclass(frozen=True)
class ModelSpec:
    route: Route
    model_path: Path
    n_ctx: int = 4096
    seed: int = 42


def _route_path(cfg: Config, route: Route) -> Path:
    return Path({
        "math": cfg.route_math_model_path,
        "code": cfg.route_code_model_path,
        "translation": cfg.route_translation_model_path,
        "default": cfg.route_default_model_path,
    }[route]).expanduser()


def get_model_spec(
    route: Route,
    cfg: Optional[Config] = None,
    *,
    require_exists: bool = True,
) -> ModelSpec:
    cfg = cfg or load_config()
    path = _route_path(cfg, route)
    if require_exists and not path.exists():
        fallback = _route_path(cfg, DEFAULT_ROUTE)
        if fallback.exists():
            return ModelSpec(
                route=DEFAULT_ROUTE, model_path=fallback,
                n_ctx=cfg.route_n_ctx, seed=cfg.llm_seed,
            )
        raise FileNotFoundError(
            f"No model file for route '{route}' ({path}) and the default "
            f"route model is missing too ({fallback})."
        )
    return ModelSpec(
        route=route, model_path=path, n_ctx=cfg.route_n_ctx, seed=cfg.llm_seed
    )
