"""Stage-level timing of the fused hybrid query step.

Builds the bench corpus at ``BENCH_CHUNKS`` (or ``--chunks``) into a
store with the bench's knobs (``DENSE_RESCORE``, ``DENSE_RESCORE_POOL``,
``DENSE_SELECT``), makes one batch's inputs (``BENCH_BATCH`` queries,
``IndexStore.hybrid_step_inputs``: the packed metadata buffer, unpacked
once into views by ``unpack_query_arrays``), and times each stage of
``hybrid_query_step_split`` on them alone:

  dense_mm          the bf16 [B, d] x [d, N] product (a library
                    reference point, not a port of a kernel)
  dense_topk        ``masked_topk``: the scan and merge kernels, at the
                    pool the dense branch selects
  dense_full        ``_dense_branch``: the scan, the f16 rescore, MMR
  bm25_core         ``bm25_split_score_core``, head and tail; bm25_head
                    and bm25_tail with the other part emptied
  bm25_topk         the core plus the exact selection (``bm25_select``)
  full_step         ``hybrid_query_step_split`` on the exact route
  full_step_packed  ``hybrid_query_step_split_packed`` (the store's
                    step) on the packed buffer, exact route
  bm25_fast         the approx route's fast core plus ``bm25_select``
                    with its exact pool rescore (``bm25_rescore_pool``)
  full_step_approx  the step on the approx route

The approx stages need the f16 slab (the store's rescore). The port's
scan serves both routes, so the approx route's dense selection and
dense branch are ``dense_topk`` and ``dense_full``: their keys
(``dense_approx_sel``, ``dense_full_approx``) say ``same_as``.

``host`` splits one whole ``hybrid_topk_batch`` (one caller, warm) by
the store's own spans (``utils.metrics`` tracing): making the inputs
(``store.inputs``: tokens to ids, the split query arrays, the pack and
its upload), queueing the step's ops (``step``), and the fetch of the
rows, which waits for the card; the share of the tail gather's window
that holds a posting (``store.inputs.split``'s counts); and, from a
torch.profiler trace of one such batch, its host-to-device copies and bytes, the torch
ops and kernels it runs, the host time inside torch ops beside the
traced span from its first op to its last (both with the profiler's
overhead in them) and the card's busy time.

Each stage's time is ``utils.profiling.held_stream_ms``'s: CUDA-event
time of calls queued behind a spin kernel (``held``), or, where a call
made the host wait (``held`` false: the spin ran out before the call
was queued), the event time with the wait in it beside the profiler's
device time (``profiler_ms``). Eager PyTorch runs every call, so unlike
the JAX tool's chained scan nothing perturbs the inputs between calls.

    BENCH_CHUNKS=200000 python -m \\
        classmate_rag_tpu_torch.tools.bench_hybrid_profile [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from classmate_rag_tpu_torch.device import resolve_device

ITERS = int(os.getenv("PROFILE_ITERS", "8"))
BATCH = int(os.getenv("BENCH_BATCH", "256"))


def bench_store(docs, emb, device=None):
    """The bench's index of ``docs``/``emb``: ``run_scale``'s store (128
    terms a chunk, the ``DENSE_*`` knobs), rows ``c0``, ``c1``, ..."""
    from classmate_rag_tpu_torch.bench import DIM
    from classmate_rag_tpu_torch.index.store import IndexStore

    store = IndexStore(
        DIM, tempfile.mkdtemp(prefix="prof_idx_"), slab_rows=4096,
        terms_per_chunk=128,
        rescore=os.getenv("DENSE_RESCORE", "auto"),
        rescore_pool=int(os.getenv("DENSE_RESCORE_POOL", "32")),
        select=os.getenv("DENSE_SELECT", "auto"),
        device=resolve_device(device),
    )
    ids = [f"c{i}" for i in range(len(docs))]
    for s in range(0, len(docs), 8192):
        e = min(s + 8192, len(docs))
        store.upsert(ids[s:e], emb[s:e], docs[s:e], [{} for _ in range(s, e)])
    return store


def build(chunks: int, device=None):
    """(store, queries): the bench corpus of ``chunks`` (seed 42) in
    ``bench_store``, and its first ``BATCH`` queries."""
    from classmate_rag_tpu_torch.bench import build_corpus, make_queries

    rng = np.random.default_rng(42)
    docs, emb = build_corpus(rng, chunks)
    queries = make_queries(rng, docs, emb)
    return bench_store(docs, emb, device), queries[:BATCH]


def stage_fns(store, queries, k: int = 8, pool: int = 24):
    """(shape, {stage: call}) for one batch of ``queries``: each call
    returns its stage's output, computed as ``hybrid_query_step_split``
    computes that part."""
    from classmate_rag_tpu_torch.index.lexical import (
        bm25_split_score_core, okapi_idf, subset_stats,
    )
    from classmate_rag_tpu_torch.ops.hybrid_step import (
        _bm25_postprocess, _dense_branch, hybrid_query_step_split,
        hybrid_query_step_split_packed, unpack_query_arrays,
    )
    from classmate_rag_tpu_torch.ops.topk import masked_topk

    packed_args, packed_kw = store.hybrid_step_inputs(
        np.stack([q for q, _t in queries]), [t for _q, t in queries], None,
        k_vector=k, k_bm25=k, top_k=k, pool=pool)
    (emb, tf_head, post_rows, post_tfs, doc_len, df, bias, q_vecs,
     packed, emb16, term_ids, tfs) = packed_args
    statics = {s: packed_kw[s] for s in ("h", "u", "t", "b", "m")}
    kw = {k: v for k, v in packed_kw.items() if k not in statics}
    qa = unpack_query_arrays(packed, **statics)
    h_slots, h_tids, u_starts, u_lens, u_cols, t_tids = (
        qa[c] for c in ("h_slots", "h_tids", "u_starts", "u_lens", "u_cols",
                        "t_tids"))
    q_tids, q_counts, has_terms = qa["q_tids"], qa["q_counts"], qa["has_terms"]
    args = (*packed_args[:8], h_slots, h_tids, u_starts, u_lens, u_cols,
            t_tids, q_tids, q_counts, has_terms, emb16, term_ids, tfs)
    vpad, r_cap = kw["vocab_pad"], kw["r_cap"]
    rp = kw["rescore_pool"]
    shape = {
        "vpad": vpad, "r_cap": r_cap,
        "H": len(h_slots), "H_real": int((h_slots >= 0).sum()),
        "U": len(u_starts), "U_real": int((u_lens > 0).sum()),
        "T": len(t_tids), "head_rows": list(tf_head.shape),
        "rescore_pool": rp, "f16_slab": emb16 is not None,
    }
    no_head = torch.full_like(h_slots, -1)
    no_tail = torch.zeros_like(u_lens)
    n = emb.shape[0]
    pool_eff = min(kw["pool"], n)
    sel = pool_eff if emb16 is None else min(max(rp, pool_eff), n)

    def bm25(head=True, tail=True, fast=False, select=None):
        keep, n_sub, avgdl = subset_stats(bias, doc_len)
        idf = okapi_idf(df, n_sub)
        s = bm25_split_score_core(
            tf_head, post_rows, post_tfs, doc_len, keep, idf, avgdl,
            h_slots if head else no_head, h_tids, u_starts,
            u_lens if tail else no_tail, u_cols, t_tids, q_tids, q_counts,
            vocab_pad=vpad, r_cap=r_cap, fast=fast)
        if select is None:
            return s
        ctx = ((term_ids, tfs, doc_len, avgdl, idf, q_tids, q_counts)
               if fast else None)
        return _bm25_postprocess(s, bias, has_terms, k_bm25=kw["k_bm25"],
                                 select=select, rescore_ctx=ctx)

    def step(select):
        return lambda: hybrid_query_step_split(*args,
                                               **{**kw, "select": select})

    fns = {
        "dense_mm": lambda: (q_vecs.to(torch.bfloat16) @ emb.T).float()
        + bias[None, :],
        "dense_topk": lambda: masked_topk(emb, q_vecs, bias, sel),
        "dense_full": lambda: _dense_branch(
            emb, bias, q_vecs, k_vector=kw["k_vector"], pool=kw["pool"],
            use_mmr=kw["use_mmr"], mmr_lambda=kw["mmr_lambda"],
            emb16=emb16, rescore_pool=rp),
        "bm25_head": lambda: bm25(tail=False),
        "bm25_tail": lambda: bm25(head=False),
        "bm25_core": lambda: bm25(),
        "bm25_topk": lambda: bm25(select="exact"),
        "full_step": step("exact"),
        "full_step_packed": lambda: hybrid_query_step_split_packed(
            *packed_args, **{**packed_kw, "select": "exact"}),
    }
    if emb16 is not None and term_ids is not None:
        fns["bm25_fast"] = lambda: bm25(fast=True, select="approx")
        fns["full_step_approx"] = step("approx")
    return shape, fns


def _torch_op_ms(events) -> float:
    """Host time inside torch ops: the union of the trace's outermost
    ``cpu_op`` spans, thread by thread, in ms."""
    total, ends = 0.0, {}
    for e in sorted((e for e in events if e.get("cat") == "cpu_op"),
                    key=lambda e: e["ts"]):
        tid, end = e["tid"], e["ts"] + e["dur"]
        if e["ts"] >= ends.get(tid, float("-inf")):
            total += e["dur"]
            ends[tid] = end
        elif end > ends[tid]:
            total += end - ends[tid]
            ends[tid] = end
    return total / 1e3


def _span_ms(events) -> float:
    """From the first torch op's start to the last one's end, in ms: the
    traced batch's host time, profiler overhead included."""
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    return (max(e["ts"] + e["dur"] for e in ops)
            - min(e["ts"] for e in ops)) / 1e3


def host_batch(store, queries, iters: int = ITERS, k: int = 8,
               pool: int = 24) -> dict:
    """One caller's ``hybrid_topk_batch`` split by its spans, the medians
    over ``iters`` warm batches (``inputs_ms``: ``store.inputs``,
    ``queue_ms``: ``step``, ``fetch_ms``: the call's end to the rows on
    the host, ``wall_ms``), the share of the tail gather's
    ``[segments, r_cap]`` window that holds a posting
    (``tail_slot_use_pct``: ``store.inputs.split``'s ``tail_postings``
    over its ``tail_slots``; None with no tail segment), and the counts
    of a trace of one batch."""
    from classmate_rag_tpu_torch.device import synchronize
    from classmate_rag_tpu_torch.utils.metrics import metrics
    from classmate_rag_tpu_torch.utils.profiling import (
        chrome_events, h2d_copies,
    )

    q = np.stack([qv for qv, _t in queries])
    terms = [t for _q, t in queries]
    knobs = dict(k_vector=k, k_bm25=k, top_k=k, pool=pool)

    def batch():
        return store.hybrid_topk_batch(q, terms, None, **knobs).rows.cpu()

    batch()
    parts = {"inputs_ms": [], "queue_ms": [], "fetch_ms": [], "wall_ms": []}
    tail = {"tail_postings": 0, "tail_slots": 0}
    for _ in range(iters):
        synchronize(store.device)
        with metrics.tracing() as spans:
            batch()
            t_fetched = time.perf_counter_ns()
        by_name = {sp.name: sp for sp in spans}
        call = by_name["store.batch"]
        for key, sp in (("inputs_ms", by_name["store.inputs"]),
                        ("queue_ms", by_name["step"])):
            parts[key].append((sp.t1_ns - sp.t0_ns) / 1e6)
        parts["fetch_ms"].append((t_fetched - call.t1_ns) / 1e6)
        parts["wall_ms"].append((t_fetched - call.t0_ns) / 1e6)
        for key in tail:
            tail[key] += by_name["store.inputs.split"].counts[key]
    out = {key: float(np.median(v)) for key, v in parts.items()}
    out["tail_slot_use_pct"] = (
        100.0 * tail["tail_postings"] / tail["tail_slots"]
        if tail["tail_slots"] else None)
    events = chrome_events(batch)
    h2d = h2d_copies(events)
    out.update(
        h2d_copies=h2d["copies"], h2d_bytes=h2d["bytes"],
        h2d_kinds=h2d["kinds"],
        torch_ops=sum(e.get("cat") == "cpu_op" for e in events),
        kernels=sum(e.get("cat") == "kernel" for e in events),
        torch_op_ms=_torch_op_ms(events),
        traced_span_ms=_span_ms(events),
        device_busy_ms=sum(e["dur"] for e in events
                           if e.get("cat") == "kernel") / 1e3,
    )
    return out


def profile(store, queries, iters: int = ITERS) -> dict:
    """Every stage of ``stage_fns`` timed alone, the store's own
    ``device_seconds_per_batch`` on the same batch (its route), and the
    host's share of one whole batch (``host_batch``)."""
    from classmate_rag_tpu_torch.utils.profiling import held_stream_ms

    shape, fns = stage_fns(store, queries)
    stages = {name: held_stream_ms(fn, iters, store.device)
              for name, fn in fns.items()}
    if "bm25_fast" in fns:
        stages["dense_approx_sel"] = {"same_as": "dense_topk"}
        stages["dense_full_approx"] = {"same_as": "dense_full"}
    step_s = store.device_seconds_per_batch(
        np.stack([q for q, _t in queries]), [t for _q, t in queries],
        iters=iters)
    return {"chunks": store.n_rows, "batch": len(queries),
            "device": str(store.device), "select_mode": store.select_mode,
            "iters": iters, "shape": shape, "stages": stages,
            "step_device_ms": step_s * 1e3,
            "step_device_timing": store.device_timing,
            "host": host_batch(store, queries, iters)}


def main(argv=None) -> int:
    from classmate_rag_tpu_torch.bench import N_CHUNKS

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", type=int, default=N_CHUNKS,
                    help="corpus size (default: BENCH_CHUNKS)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    print(f"corpus: {args.chunks} chunks, building...", flush=True)
    store, queries = build(args.chunks, args.device)
    build_s = time.perf_counter() - t0
    out = profile(store, queries, ITERS)
    out["build_s"] = round(build_s, 3)
    print(" ".join(f"{k}={v}" for k, v in out["shape"].items()), flush=True)
    for name, t in out["stages"].items():
        if "ms" in t:
            extra = ("" if t["held"] else
                     f"  (not held; profiler {t.get('profiler_ms')} ms)")
            print(f"{name:20s} {t['ms']:10.4f} ms/batch{extra}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
