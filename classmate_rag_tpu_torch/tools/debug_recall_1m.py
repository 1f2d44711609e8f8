"""Decompose the hybrid query's recall misses against the CPU oracle.

Builds the bench's corpus (seed 42) at ``--chunks``, answers its first
``--queries`` queries with the engine (the store with the bench's knobs,
``bench_hybrid_profile.bench_store``) and with the bench's numpy oracle,
and for every query whose top-8 set differs from the oracle's gives a
per-row decomposition: the dense sims in f32, f16 and bf16 (the row's
embedding rounded by torch), the BM25 score, the oracle's pool and
branch ranks, the oracle's fused (RRF) score and the engine's: enough
to call each miss an exact tie, an f16 rescore flip, a pool-boundary
case or an MMR order divergence. ``decompose`` returns it as data
(``n_miss`` and the misses); ``main`` prints it too.

    python -m classmate_rag_tpu_torch.tools.debug_recall_1m \\
        [--chunks 1000000] [--queries 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from classmate_rag_tpu_torch import bench


def engine_answers(store, queries):
    """(rows [Q, K] int, fused [Q, K] f32) of the engine, in batches of
    the bench's ``BATCH``."""
    rows, fused = [], []
    for s in range(0, len(queries), bench.BATCH):
        sl = queries[s: s + bench.BATCH]
        out = store.hybrid_topk_batch(
            np.stack([q for q, _t in sl]), [t for _q, t in sl], None,
            k_vector=bench.K, k_bm25=bench.K, top_k=bench.K,
            pool=bench.POOL)
        rows.append(out.rows.cpu().numpy())
        fused.append(out.fused.cpu().numpy())
    return np.concatenate(rows), np.concatenate(fused)


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        torch.bfloat16).float().numpy()


def decompose(emb, queries, engine_rows, engine_fused, bm25) -> dict:
    """Every query whose engine top-K set differs from ``oracle_query``'s,
    decomposed row by row (``bm25``: a ``FastOracleBM25`` of the docs)."""
    k, rrf_k = bench.K, bench.RRF_K
    misses = []
    for qi, (qv, terms) in enumerate(queries):
        want = bench.oracle_query(qv, terms, emb, bm25)
        got = [int(r) for r in engine_rows[qi] if r >= 0]
        if set(got) == set(want):
            continue
        sims = emb @ qv
        bs = bm25.get_scores(terms)
        pool_idx = np.argpartition(-sims, bench.POOL)[: bench.POOL]
        pool_idx = pool_idx[np.argsort(-sims[pool_idx], kind="stable")]
        order = bench.oracle_mmr(qv, emb[pool_idx], k)
        vec_ids = [int(pool_idx[i]) for i in order]
        bm_ids = np.argsort(-bs, kind="stable")[:k].tolist()
        oracle_fused = {}
        for ranked in (vec_ids, bm_ids):
            for rank, r in enumerate(ranked):
                oracle_fused[r] = oracle_fused.get(r, 0.0) + 1.0 / (
                    rrf_k + rank + 1)
        only_e = [r for r in got if r not in want]
        only_o = [r for r in want if r not in got]
        rows = sorted(set(only_e + only_o))
        in_pool = {int(x) for x in pool_idx}
        sims16 = emb[rows].astype(np.float16).astype(np.float32) @ qv
        sims_bf = _bf16(emb[rows]) @ qv
        engine_of = dict(zip(engine_rows[qi].tolist(),
                             engine_fused[qi].tolist()))
        misses.append({
            "query": qi,
            "engine_only": only_e,
            "oracle_only": only_o,
            "engine_top": got,
            "oracle_top": want,
            "oracle_vec_branch": vec_ids,
            "oracle_bm25_branch": bm_ids,
            "rows": [{
                "row": r,
                "sim_f32": float(sims[r]),
                "sim_f16": float(sims16[j]),
                "sim_bf16": float(sims_bf[j]),
                "bm25": float(bs[r]),
                "oracle_pool": r in in_pool,
                "oracle_vec_rank": vec_ids.index(r) if r in vec_ids else -1,
                "oracle_bm_rank": bm_ids.index(r) if r in bm_ids else -1,
                "oracle_fused": oracle_fused.get(r, 0.0),
                "engine_fused": engine_of.get(r),
            } for j, r in enumerate(rows)],
            # The oracle's pool boundary (ranks 20-26) and BM25's top 10.
            "pool_tail_sims": np.sort(sims)[::-1][20:27].tolist(),
            "bm25_top10": np.sort(bs)[::-1][:10].tolist(),
        })
    return {"n_miss": len(misses), "queries": len(queries),
            "misses": misses}


def run(chunks: int, n_queries: int = 64, device=None, corpus=None) -> dict:
    """Build, answer, decompose (``corpus``: ``(docs, emb, queries)``
    of the bench's functions, built here when None)."""
    from classmate_rag_tpu_torch.tools.bench_hybrid_profile import (
        bench_store,
    )

    if corpus is None:
        rng = np.random.default_rng(42)
        docs, emb = bench.build_corpus(rng, chunks)
        queries = bench.make_queries(rng, docs, emb)
    else:
        docs, emb, queries = corpus
    queries = queries[:n_queries]
    store = bench_store(docs, emb, device)
    rows, fused = engine_answers(store, queries)
    out = decompose(emb, queries, rows, fused, bench.FastOracleBM25(docs))
    out.update(chunks=len(docs), device=str(store.device),
               select_mode=store.select_mode)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    print(f"building corpus n={args.chunks} ...", flush=True)
    out = run(args.chunks, args.queries, args.device)
    for m in out["misses"]:
        print(f"\n=== query {m['query']}: engine-only {m['engine_only']}, "
              f"oracle-only {m['oracle_only']}")
        print(f"oracle vec branch (MMR order): {m['oracle_vec_branch']}")
        print(f"oracle bm25 branch: {m['oracle_bm25_branch']}")
        for r in m["rows"]:
            print(" ".join(f"{k}={v}" for k, v in r.items()))
        print("oracle pool tail sims (ranks 20-26):", m["pool_tail_sims"])
        print("bm25 top-10 scores:", m["bm25_top10"])
    print(f"\n{out['n_miss']}/{out['queries']} queries differ", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
