"""The kind ``hybrid``: batched hybrid retrieval through the port's
``IndexStore.hybrid_topk_batch``. The corpus and the pool of batches come
from ``corpus.py``; set-up upserts the corpus into a store in a temporary
directory and serves every batch of the pool once; the traffic's loop
(``loops/closed.py``) drives the store; ``judge.py`` holds a sample of
the window's answers against ``reference/hybrid.py``.

Its readers' values: ``dim``, the vectors' width; ``scope_rows(pool)``,
the rows a pool batch searches; ``postings(pool)``, the posting entries
of its distinct query words over those rows. Its info keys: ``route``
(the store's ``select_mode``), ``rows`` and ``sampled_queries``.
"""

from __future__ import annotations

import tempfile
from typing import Dict

import numpy as np

from rag_bench import judge
from rag_bench.corpus import make_batches, make_corpus
from rag_bench.loops.closed import serve_one
from rag_bench.reference.hybrid import Reference

CONTROL = ("the reference one precision step lower: int8 vectors and "
           "queries, BM25 in bfloat16")
UPSERT_ROWS = 65536
KNOBS = ("k_vector", "k_bm25", "top_k", "pool", "use_mmr", "mmr_lambda",
         "rrf_k")


class Run:
    def __init__(self, cell, seed: int, device):
        if int(cell.traffic.get("clients", 1)) != 1:
            raise ValueError("the closed loop drives one client")
        self.cell, self.seed, self.device = cell, seed, device
        self.r = cell.config["retrieval"]
        self.corpus = make_corpus(cell.config, seed, device)
        self.batches = make_batches(self.corpus, cell.config, cell.traffic,
                                    seed)
        self.knobs = {k: self.r[k] for k in KNOBS}
        self.info: Dict[str, object] = {}
        self.store = self.ref = self._tmp = None

    def build(self, mark) -> None:
        from classmate_rag_tpu_torch.index.store import IndexStore

        corpus, r = self.corpus, self.r
        self._tmp = tempfile.TemporaryDirectory(prefix="rag_bench_")
        self.store = store = IndexStore(
            int(self.cell.config["dim"]), self._tmp.name,
            slab_rows=r["slab_rows"], terms_per_chunk=r["terms_per_chunk"],
            rescore=r["rescore"], rescore_pool=r["rescore_pool"],
            select=r["select"], device=self.device)
        ids = [f"p{i}" for i in range(corpus.n)]
        for s in range(0, corpus.n, UPSERT_ROWS):
            e = min(s + UPSERT_ROWS, corpus.n)
            store.upsert(ids[s:e], corpus.emb[s:e], corpus.token_lists(s, e),
                         corpus.metadata(s, e))
        del ids
        mark("upsert")
        # Warm-up: the first batch places the store; every batch of the
        # pool runs once, so the window meets no shape it has not seen.
        for p, b in enumerate(self.batches):
            if serve_one(store, b, self.knobs, p).out is None:
                raise RuntimeError(f"warm-up batch {p} failed")
            if p == 0:
                mark("first_batch")
        self.info.update(route=store.select_mode, rows=corpus.n)

    def drive(self, loop, seconds: float):
        return loop.drive(self.store, self.batches, seconds, self.knobs)

    def free(self) -> None:
        self.store = None
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None

    def check(self, window, control: bool):
        corpus, batches, limits = self.corpus, self.batches, self.cell.limits
        picks = judge.sample(window, batches, int(limits["sample"]),
                             self.seed)
        self.info["sampled_queries"] = len(picks)
        queries = judge.queries_of(batches, picks)
        served = judge.served_answers(window, picks)
        self.ref = ref = Reference(corpus.tokens, corpus.offsets, corpus.emb,
                                   corpus.course, self.r, self.device)
        want = ref.answer(queries)
        values = judge.readings(ref, queries, want,
                                [served[pj] for pj in picks])
        correct, checks = judge.verdict(values, limits, window.failed)
        readings = None
        if control:
            cref = Reference(corpus.tokens, corpus.offsets, corpus.emb,
                             corpus.course, self.r, self.device,
                             precision="control")
            readings = judge.readings(ref, queries, want,
                                      [[a] for a in cref.answer(queries)])
        return correct and bool(picks), checks, readings

    def values(self) -> Dict[str, object]:
        corpus, batches, ref = self.corpus, self.batches, self.ref

        def scope_rows(pool: int) -> int:
            c = batches[pool].course
            return corpus.n if c is None else len(corpus.course_rows(c))

        postings_of: Dict[int, int] = {}

        def postings(pool: int) -> int:
            if pool not in postings_of:
                df = ref.okapi(batches[pool].course).df
                words = np.unique(np.concatenate(batches[pool].term_ids))
                words = words[words < len(df)]
                postings_of[pool] = int(df[words].sum())
            return postings_of[pool]

        return {"dim": int(self.cell.config["dim"]),
                "scope_rows": scope_rows, "postings": postings}
