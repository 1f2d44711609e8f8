"""Sticky single-resident model loader.

Parity with the reference (rag/routing/loader.py:40-156): at most ONE
generation model stays resident (the reference's 8 GB VRAM budget; here
the card's memory). A route change evicts the resident model (drop + gc,
and the allocator's cached blocks on CUDA) before loading the target.
Offline, every route resolves to the shared extractive runner — eviction
becomes a no-op but the bookkeeping stays identical, so swapping in real
backends changes nothing.

Port of the JAX package's ``routing/loader.py``: runners are built by the
port's ``get_runner`` on the loader's device (None → CUDA), which the
runtime sets to its store's device.
"""

from __future__ import annotations

import gc
import logging
import threading
from typing import Any, Dict, Optional, Sequence

import torch

from classmate_rag_tpu_torch.config import Config, load_config
from classmate_rag_tpu_torch.device import DeviceLike, resolve_device
from classmate_rag_tpu_torch.generation.runner import ExtractiveRunner, get_runner
from classmate_rag_tpu_torch.routing.registry import get_model_spec
from classmate_rag_tpu_torch.routing.types import Route

log = logging.getLogger(__name__)


class StickyModelLoader:
    def __init__(self, cfg: Optional[Config] = None,
                 device: DeviceLike = None) -> None:
        self.cfg = cfg or load_config()
        self.device = resolve_device(device)
        self._resident_route: Optional[Route] = None
        self._resident_path: str = ""
        self._resident: Any = None
        # Generation lock: the serving daemon runs the generation tail
        # OUTSIDE the device read lock (so it overlaps retrieval), which
        # means concurrent batch leaders reach this loader from several
        # threads. Evict/load must not interleave, and single-context
        # backends (llama.cpp) are not thread-safe — one generation at a
        # time through the resident model.
        self._lock = threading.RLock()

    @property
    def resident_route(self) -> Optional[Route]:
        return self._resident_route

    def _evict(self) -> None:
        if self._resident is not None:
            log.info("evicting resident model for route %s", self._resident_route)
            self._resident = None
            self._resident_route = None
            self._resident_path = ""
            gc.collect()
            if self.device.type == "cuda":
                # Hand the decoder's blocks back to the card, not only to
                # the allocator's cache: the next route's model (or
                # another process) gets the memory.
                torch.cuda.empty_cache()

    def ensure_loaded(self, route: Route) -> Any:
        with self._lock:
            # Residency keys on the RESOLVED spec's route and path (the
            # reference compares target.route + model_path after
            # fallback, rag/routing/loader.py:70-71): when 'math' falls
            # back to the default model, a later 'default'/'code'
            # question must NOT evict and reload the identical model.
            try:
                spec = get_model_spec(route, self.cfg)
                resolved, model_path = spec.route, str(spec.model_path)
            except FileNotFoundError:
                # No model file for ANY route: the extractive fallback is
                # route-independent — share one residency for all routes.
                spec, resolved, model_path = None, "__unresolved__", ""
            if (
                self._resident is not None
                and self._resident_route == resolved
                and self._resident_path == model_path
            ):
                return self._resident
            self._evict()
            if spec is None:
                runner = ExtractiveRunner()
            else:
                try:
                    runner = get_runner(self.cfg, model_path=model_path,
                                        device=self.device)
                except FileNotFoundError:
                    runner = ExtractiveRunner()
            self._resident = runner
            self._resident_route = resolved
            self._resident_path = model_path
            log.info("loaded %s for route %s", type(runner).__name__, resolved)
            return runner

    def chat(
        self,
        *,
        route: Route,
        messages: Sequence[Dict[str, str]],
        max_tokens: int = 768,
        temperature: float = 0.2,
        top_p: float = 0.95,
    ) -> str:
        with self._lock:
            runner = self.ensure_loaded(route)
            return runner.chat(
                messages, max_tokens=max_tokens,
                temperature=temperature, top_p=top_p,
            )

    def chat_batch(
        self,
        *,
        route: Route,
        messages_list: Sequence[Sequence[Dict[str, str]]],
        max_tokens: int = 768,
        temperature: float = 0.2,
        top_p: float = 0.95,
    ) -> list:
        """Batched chat on one route: runners with a real batched decode
        (DecodeRunner) answer the whole list in one device loop;
        host-side runners fall back to a loop."""
        with self._lock:
            runner = self.ensure_loaded(route)
            if hasattr(runner, "chat_batch"):
                return list(runner.chat_batch(
                    messages_list, max_tokens=max_tokens,
                    temperature=temperature, top_p=top_p,
                ))
            return [
                runner.chat(m, max_tokens=max_tokens,
                            temperature=temperature, top_p=top_p)
                for m in messages_list
            ]
