"""Shared pipeline runtime: one set of live components per process (port
of the JAX package's ``pipeline/runtime.py``).

A single ``Runtime`` owns the loaded disk catalog, the device-resident
IndexStore, the caching embedder, the retriever, the generation runner
and the lazy routing singletons (classifier, router, sticky loader);
repeated queries reuse the resident tensors and the runner's weights.
``get_runtime(device=None)`` builds it on CUDA; the tests pass
``device="cpu"``. On a host with more than one card (``N_SHARDS`` 0 =
one shard a card) it also builds the corpus-sharded serving engine
(``parallel.ShardedHybridIndex``), and the retriever asks through it.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from classmate_rag_tpu_torch.config import (
    Config,
    embedding_config_of,
    load_config,
)
from classmate_rag_tpu_torch.device import DeviceLike, resolve_device
from classmate_rag_tpu_torch.embeddings import get_caching_embedder
from classmate_rag_tpu_torch.generation.runner import get_runner
from classmate_rag_tpu_torch.index.catalog import Catalog
from classmate_rag_tpu_torch.index.store import IndexStore
from classmate_rag_tpu_torch.parallel.mesh import corpus_mesh, local_devices
from classmate_rag_tpu_torch.retrieval.hybrid import HybridRetriever

# The JAX package's serving-scale threshold for the background warm-up.
WARMUP_MIN_ROWS = 200_000


@dataclass
class Runtime:
    cfg: Config
    catalog: Catalog
    store: IndexStore
    embedder: Any
    retriever: HybridRetriever
    # The corpus-sharded serving engine (parallel.ShardedHybridIndex)
    # when the host has more than one card, else None.
    sharded: Any = None
    # Cold-start decomposition (seconds) filled by get_runtime:
    # {"catalog_s", "store_s", "sharded_s"} — the catalog scan or sidecar
    # restore vs the slab load.
    load_timings: dict = field(default_factory=dict)
    # Background warm-up thread at serving scale (join it to wait for
    # the resident state; queries are safe regardless).
    warmup_thread: Any = field(default=None, repr=False)
    _runner: Any = field(default=None, repr=False)
    _runner_lock: Any = field(default_factory=threading.Lock, repr=False)
    _classifier: Any = field(default=None, repr=False)
    _router: Any = field(default=None, repr=False)
    _loader: Any = field(default=None, repr=False)

    @property
    def runner(self):
        """The generation runner, built from ``cfg`` on the runtime's
        device at the first ask and reused by every later one. (The JAX
        package calls ``get_runner`` on every ask, which for its decoder
        draws or loads the weights again each time.)"""
        with self._runner_lock:
            if self._runner is None:
                self._runner = get_runner(self.cfg,
                                          device=self.store.device)
            return self._runner

    @property
    def classifier(self):
        """Subject prototypes from the runtime's own embedder."""
        if self._classifier is None:
            from classmate_rag_tpu_torch.routing import SubjectClassifier

            self._classifier = SubjectClassifier(self.embedder)
        return self._classifier

    @property
    def router(self):
        if self._router is None:
            from classmate_rag_tpu_torch.routing import HybridRouter

            self._router = HybridRouter(
                classifier=self.classifier,
                query_margin=self.cfg.route_query_margin,
                metadata_threshold=self.cfg.route_metadata_threshold,
                translation_requires_intent=self.cfg.route_translation_requires_intent,
            )
        return self._router

    @property
    def loader(self):
        """The routed path's single resident model, on the store's
        device. A routed ask goes through it and never builds
        ``runner``; an unrouted one never builds it."""
        if self._loader is None:
            from classmate_rag_tpu_torch.routing import StickyModelLoader

            self._loader = StickyModelLoader(self.cfg,
                                             device=self.store.device)
        return self._loader

    def persist(self) -> None:
        self.catalog.save()
        # Fingerprint of the just-written catalog keys the store's
        # snapshot and delta chain.
        self.store.save(catalog_fingerprint=self.catalog.fingerprint())

    def warmup(self, batch_sizes=(1,), top_k: int = 8) -> dict:
        """Place the serving state before the first real query: runs one
        throwaway question per batch size through the product retrieval
        path, which uploads the slabs and places (or restores) the split
        layout on the device. Returns seconds per batch size (None where
        it failed: a warm-up never breaks serving)."""
        out = {}
        for b in batch_sizes:
            t0 = time.perf_counter()
            try:
                self.retriever.retrieve_batch(
                    questions=["warmup probe"] * int(b), filters={},
                    top_k=top_k, hybrid=True,
                )
                if self.store.device.type == "cuda":
                    torch.cuda.synchronize(self.store.device)
            except Exception as exc:
                logging.getLogger(__name__).warning(
                    "runtime warmup (batch %s) failed: %s", b, exc
                )
                out[int(b)] = None
                continue
            out[int(b)] = round(time.perf_counter() - t0, 3)
        return out


def _pick_n_shards(cfg: Config, slab_rows: int,
                   device: torch.device) -> int:
    """Shard count for the product path: ``N_SHARDS`` 0 = one per local
    card, 1 = one device, n > 1 = n. Clamped to the local cards of
    ``device``'s kind and walked down to a divisor of ``slab_rows`` (the
    store's capacity is always a slab multiple, so a divisor of the slab
    divides every capacity)."""
    n = cfg.n_shards
    if n == 1:
        return 1
    avail = len(local_devices(device))
    n = avail if n <= 0 else min(n, avail)
    while n > 1 and slab_rows % n:
        n -= 1
    return n


def build_sharded_index(cfg: Config, store: IndexStore):
    """The corpus-sharded serving engine over the store's local cards, or
    None when the product path runs on one device."""
    n_sh = _pick_n_shards(cfg, store.slab_rows, store.device)
    if n_sh < 2:
        return None
    from classmate_rag_tpu_torch.parallel.serving import ShardedHybridIndex

    return ShardedHybridIndex(
        store, corpus_mesh(n_sh, local_devices(store.device)),
        k_vector=cfg.k_vector,
        k_bm25=cfg.k_bm25,
        rrf_k=cfg.rrf_k,
        weight_vector=cfg.weight_vector,
        weight_bm25=cfg.weight_bm25,
        use_mmr=cfg.use_mmr,
        mmr_lambda=cfg.mmr_lambda,
        pool=cfg.mmr_max_pool,
    )


_RUNTIME: Optional[Runtime] = None


def get_runtime(reload: bool = False, device: DeviceLike = None) -> Runtime:
    global _RUNTIME
    if _RUNTIME is not None and not reload:
        return _RUNTIME
    dev = resolve_device(device)
    cfg = load_config(reload=reload)
    embedder = get_caching_embedder(embedding_config_of(cfg), device=dev)
    t0 = time.perf_counter()
    catalog = Catalog.load_or_create(cfg.bm25_dir)
    t1 = time.perf_counter()
    store = IndexStore.load_or_create(
        dim=embedder.dim or 768,
        directory=cfg.dense_dir,
        catalog=catalog,
        slab_rows=cfg.dense_slab_rows,
        terms_per_chunk=min(cfg.bm25_terms_per_chunk, 512),
        rescore=cfg.dense_rescore,
        rescore_pool=cfg.dense_rescore_pool,
        select=cfg.dense_select,
        device=dev,
    )
    t2 = time.perf_counter()
    sharded = build_sharded_index(cfg, store)
    t3 = time.perf_counter()
    # Feature-space guard: vectors persisted under a different embedder
    # silently degrade dense retrieval.
    current_model = getattr(embedder, "model_name", None)
    if (
        store.embedding_model
        and current_model
        and store.embedding_model != current_model
    ):
        logging.getLogger(__name__).warning(
            "persisted dense index was embedded with %r but the active "
            "embedder is %r — dense scores mix feature spaces; re-embed "
            "the corpus", store.embedding_model, current_model,
        )
    elif current_model and not store.embedding_model:
        if len(store) == 0:
            store.embedding_model = current_model
        else:
            # A non-empty untagged store is not stamped with the current
            # embedder's name: its vectors live in an unknown space.
            logging.getLogger(__name__).warning(
                "persisted dense index has no recorded embedding model; "
                "if it was built with a different embedder than %r, dense "
                "scores mix feature spaces", current_model,
            )
    timings = {
        "catalog_s": round(t1 - t0, 3),
        "store_s": round(t2 - t1, 3),
        "sharded_s": round(t3 - t2, 3),
    }
    retriever = HybridRetriever(
        store=store,
        catalog=catalog,
        embedder=embedder,
        k_vector=cfg.k_vector,
        k_bm25=cfg.k_bm25,
        rrf_k=cfg.rrf_k,
        weight_vector=cfg.weight_vector,
        weight_bm25=cfg.weight_bm25,
        use_mmr=cfg.use_mmr,
        mmr_lambda=cfg.mmr_lambda,
        mmr_max_pool=cfg.mmr_max_pool,
        use_device_encode=cfg.device_query_encode,
        sharded=sharded,
    )
    _RUNTIME = Runtime(
        cfg=cfg, catalog=catalog, store=store,
        embedder=embedder, retriever=retriever, sharded=sharded,
        load_timings=timings,
    )
    mode = (cfg.runtime_precompile or "auto").lower()
    if mode == "on" or (mode == "auto" and len(store) >= WARMUP_MIN_ROWS):
        # Serving scale: start placing the slabs and the split layout now
        # so the first real query finds them resident. Daemon thread; the
        # store's _sync_lock serializes it against a racing first query.
        t = threading.Thread(
            target=_RUNTIME.warmup, name="rag-warmup", daemon=True
        )
        t.start()
        _RUNTIME.warmup_thread = t
    return _RUNTIME


def reset_runtime() -> None:
    global _RUNTIME
    _RUNTIME = None
