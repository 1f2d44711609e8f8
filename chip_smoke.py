"""Chip smoke test of the PyTorch/CUDA port (classmate_rag_tpu_torch).

Drives the port's main path, the batched fused hybrid query, on one
CUDA card at the E5-base width (d = 768) over a 200,000-chunk corpus,
and holds every kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py            # on a machine with one NVIDIA GPU

Phases, one JSON line each; any failure exits non-zero with no result:

1. device    card name and power limit (nvidia-smi), kernel build seconds;
2. kernels   each kernel vs its plain version at the main path's shape
             and at edge cases; its time, the plain version's, one
             PyTorch library call's, and the card's bound;
3. slice     4 batches of 256 queries through IndexStore.hybrid_topk_batch
             (launch counts reset just before, read just after), each
             held against the same step on CPU copies of its inputs;
             recall@8 against a numpy oracle; warm batch latency;
4. approx    one batch with the approx route forced (fast BM25 + exact
             pool rescore), held against the CPU the same way;
5. retriever HybridRetriever over the same store vs a CPU copy of it.

Then the kernels line ({"kernels": [...]}), the nvidia-smi line, and
last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

DIM = 768
CHUNKS = 200_000
BATCH = 256
N_BATCHES = 4
K = 8
POOL = 24
RRF_K = 60
N_ORACLE = 64
RECALL_MIN = 0.99
ROWS_AGREE_MIN = 0.999
STEP_TOL = 1e-4        # GPU vs CPU fused-step scores (f32, other sum order)
KERNEL_TOL = 1e-5      # kernel vs plain scores (f32 sums of bf16 products)

# Published dense peaks (NVIDIA data sheets): memory bytes/s, bf16 FLOP/s.
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12),
    "H100 NVL": (3.9e12, 835e12),
    "H100": (3.35e12, 989e12),      # SXM5, 80 GB HBM3
    "H200": (4.8e12, 989e12),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    raise SmokeFailure(f"no published peaks for card {name!r}")


# ---------------------------------------------------------------------------
# Corpus (the shape of bench.py's: zipf over 5,000 words, 40-120 words a
# chunk, unit-norm vectors; words are letters only so the tokenizer keeps
# them for the retriever phase)
# ---------------------------------------------------------------------------

def word(i: int) -> str:
    s = ""
    i += 26
    while i:
        i, r = divmod(i, 26)
        s = chr(97 + r) + s
    return "zx" + s


def build_corpus(rng, n_chunks: int):
    vocab = [word(i) for i in range(5000)]
    weights = 1.0 / np.arange(1, len(vocab) + 1)
    weights /= weights.sum()
    lengths = rng.integers(40, 120, size=n_chunks)
    all_idx = rng.choice(len(vocab), size=int(lengths.sum()), p=weights)
    docs = []
    pos = 0
    for n_words in lengths:
        docs.append([vocab[i] for i in all_idx[pos: pos + n_words]])
        pos += n_words
    emb = rng.standard_normal((n_chunks, DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return docs, emb


def make_queries(rng, docs, emb, n_queries: int):
    qs = []
    for _ in range(n_queries):
        doc_i = int(rng.integers(0, len(docs)))
        qv = emb[doc_i] + 0.25 * rng.standard_normal(DIM).astype(np.float32)
        qv /= np.linalg.norm(qv)
        terms = list(rng.choice(docs[doc_i], size=min(5, len(docs[doc_i])),
                                replace=False))
        qs.append((qv.astype(np.float32), terms))
    return qs


def chunk_meta(i: int) -> dict:
    meta = {"course": f"c{i % 7}", "language": "it" if i % 2 else "en",
            "doc_type": "txt"}
    if i % 3 != 0:
        meta[f"tag_tag{i % 5}"] = True
    return meta


# ---------------------------------------------------------------------------
# numpy oracle: f32 cosine scan, BM25Okapi with ε, greedy MMR, RRF
# ---------------------------------------------------------------------------

class OracleBM25:
    K1, B, EPS = 1.5, 0.75, 0.25

    def __init__(self, corpus_tokens):
        self.n_docs = len(corpus_tokens)
        self.doc_len = np.array([len(d) for d in corpus_tokens], np.float32)
        self.avgdl = float(self.doc_len.mean())
        vocab = {}
        rows, tids, tfs = [], [], []
        for di, doc in enumerate(corpus_tokens):
            freqs = {}
            for t in doc:
                freqs[t] = freqs.get(t, 0) + 1
            for t, f in freqs.items():
                rows.append(di)
                tids.append(vocab.setdefault(t, len(vocab)))
                tfs.append(f)
        self.vocab = vocab
        tids = np.asarray(tids, np.int64)
        order = np.argsort(tids, kind="stable")
        self.post_rows = np.asarray(rows, np.int64)[order]
        self.post_tfs = np.asarray(tfs, np.float32)[order]
        df = np.bincount(tids, minlength=len(vocab)).astype(np.float64)
        self.offsets = np.zeros(len(vocab) + 1, np.int64)
        np.cumsum(df.astype(np.int64), out=self.offsets[1:])
        idf = np.log(self.n_docs - df + 0.5) - np.log(df + 0.5)
        idf[idf < 0] = self.EPS * (idf.mean() if len(idf) else 0.0)
        self.idf = idf.astype(np.float32)
        self._denom = self.K1 * (1 - self.B + self.B * self.doc_len
                                 / self.avgdl)

    def get_scores(self, query):
        score = np.zeros(self.n_docs, np.float32)
        for q in query:
            tid = self.vocab.get(q)
            if tid is None:
                continue
            s, e = self.offsets[tid], self.offsets[tid + 1]
            r = self.post_rows[s:e]
            f = self.post_tfs[s:e]
            score[r] += self.idf[tid] * (f * (self.K1 + 1)
                                         / (f + self._denom[r]))
        return score


def oracle_mmr(qv, cand_vecs, k, lam=0.5):
    sims_q = cand_vecs @ qv
    sims_cc = cand_vecs @ cand_vecs.T
    selected = [int(np.argmax(sims_q))]
    remaining = set(range(len(cand_vecs))) - set(selected)
    while remaining and len(selected) < k:
        best, best_s = None, -1e18
        for i in sorted(remaining):
            s = lam * sims_q[i] - (1 - lam) * sims_cc[i, selected].max()
            if s > best_s:
                best, best_s = i, s
        selected.append(best)
        remaining.discard(best)
    return selected


def oracle_query(qv, terms, emb, bm25, sims):
    pool_idx = np.argpartition(-sims, POOL)[:POOL]
    pool_idx = pool_idx[np.argsort(-sims[pool_idx], kind="stable")]
    vec_ids = [int(pool_idx[i]) for i in oracle_mmr(qv, emb[pool_idx], K)]
    bscores = bm25.get_scores(terms)
    bm_ids = np.argsort(-bscores, kind="stable")[:K].tolist()
    fused = {}
    for lst in (vec_ids, bm_ids):
        for rank, i in enumerate(lst):
            fused[i] = fused.get(i, 0.0) + 1.0 / (RRF_K + rank + 1)
    vec_set = set(vec_ids)
    ranked = sorted(
        fused.items(),
        key=lambda kv: (kv[1],
                        -(1.0 - sims[kv[0]]) if kv[0] in vec_set else 0.0,
                        -kv[0]),
        reverse=True,
    )
    return [i for i, _ in ranked[:K]]


# ---------------------------------------------------------------------------
# Timing and comparison helpers
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_topk(ttopk, emb, q, bias, k):
    """Kernel vs plain on the card. Rows must be equal except where the
    plain scores of neighbouring positions (the (k+1)-th included) lie
    within KERNEL_TOL: a different summation order may swap those, so
    they are compared as sets. Returns max |Δscore|."""
    v1, i1 = ttopk.masked_topk(emb, q, bias, k)
    v0, i0 = ttopk.topk_reference(emb, q, bias, k + 1)
    torch.cuda.synchronize()
    err = (v1 - v0[:, :k]).abs().max().item()
    check(err < KERNEL_TOL, f"topk_scan k={k}: max |dscore| {err}")
    near = (v0[:, 1:] - v0[:, :-1]).abs() < KERNEL_TOL          # [Q, k]
    tied = near | torch.nn.functional.pad(near[:, :-1], (1, 0))
    same = i1 == i0[:, :k]
    check(bool((same | tied).all()), f"topk_scan k={k}: rows differ")
    for qi in torch.nonzero(~same.all(dim=1)).flatten().tolist():
        pos = (~same[qi]).nonzero().flatten().tolist()
        check(set(i1[qi, pos].tolist()) <= set(i0[qi].tolist()),
              f"topk_scan k={k}: query {qi} picked a row outside the ties")
    return err


def kernel_phase(ttopk, store, q_dev, peaks):
    """topk_scan at the main path's shape and at its edges."""
    dev = store._sync_device()
    emb = dev["emb"]
    n, d = emb.shape
    sel = min(max(store.rescore_pool, POOL), n)
    # The main path's unfiltered bias with ~10% of the rows masked on top.
    g = torch.Generator(device="cuda").manual_seed(7)
    bias = store._mask_bias(None).clone()
    bias[torch.rand(n, device="cuda", generator=g) < 0.1] = ttopk.NEG_INF
    errs = [compare_topk(ttopk, emb, q_dev, bias, sel)]

    rng = np.random.default_rng(3)

    def unit(rows, dd):
        x = rng.standard_normal((rows, dd)).astype(np.float32)
        return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))

    small = unit(5000 + 77, DIM).to(torch.bfloat16).cuda()  # ragged tile
    sq = unit(70, DIM).cuda()
    sb = torch.zeros(small.shape[0], device="cuda")
    sb[::9] = ttopk.NEG_INF
    for k in (1, 128):
        errs.append(compare_topk(ttopk, small, sq, sb, k))
    all_masked = torch.full_like(sb, ttopk.NEG_INF)
    v1, i1 = ttopk.masked_topk(small, sq, all_masked, 16)
    v0, i0 = ttopk.topk_reference(small, sq, all_masked, 16)
    check(torch.equal(i1, i0) and bool((v1 <= ttopk.NEG_INF / 2).all()),
          "topk_scan: all-masked corpus")
    dup = small.clone()
    dup[4100:4108] = dup[10:18]          # copies two chunks later
    v1, i1 = ttopk.masked_topk(dup, dup[10:12].float(), torch.zeros_like(sb),
                               12)
    v0, i0 = ttopk.topk_reference(dup, dup[10:12].float(),
                                  torch.zeros_like(sb), 12)
    check(torch.equal(i1, i0) and i1[0, :2].tolist() == [10, 4100],
          f"topk_scan: cross-chunk ties {i1[0, :4].tolist()}")

    ms = time_ms(lambda: ttopk.masked_topk(emb, q_dev, bias, sel))
    plain_ms = time_ms(lambda: ttopk.topk_reference(emb, q_dev, bias, sel))
    q16 = q_dev.to(torch.bfloat16)
    library_ms = time_ms(
        lambda: torch.topk(torch.matmul(q16, emb.T).float() + bias, sel)
    )
    nq = q_dev.shape[0]
    bytes_moved = n * d * 2 + nq * d * 4 + n * 4 + nq * sel * 8
    flops = 2.0 * nq * n * d
    bw, peak = peaks
    t_bytes = bytes_moved / bw * 1e3
    t_ops = flops / peak * 1e3
    return {
        "name": "topk_scan",
        "route": "cuda",
        "source": "classmate_rag_tpu_torch/ops/csrc/topk_scan.cu",
        "replaces": "classmate_rag_tpu/ops/topk.py:170",
        "shape": {"N": n, "d": d, "Q": nq, "k": sel},
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": bytes_moved,
        "flops": flops,
    }


def step_on_cpu(step, store, q, terms, **knobs):
    """The fused step on CPU copies of the same device inputs."""
    args, kwargs = store.hybrid_step_inputs(q, terms, None, **knobs)
    cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    return step(*cpu_args, **kwargs)


def compare_steps(gpu, cpu):
    """(queries with identical rows, max score diff where rows agree)."""
    rows_g, rows_c = gpu.rows.cpu(), cpu.rows
    agree = (rows_g == rows_c).all(dim=1)
    worst = 0.0
    for name in ("fused", "vec_dist", "bm25_score"):
        a = getattr(gpu, name).cpu()[agree]
        b = getattr(cpu, name)[agree]
        check(bool((torch.isnan(a) == torch.isnan(b)).all()),
              f"{name}: NaN pattern differs where rows agree")
        ok = ~torch.isnan(a)
        if ok.any():
            diff = (a[ok] - b[ok]).abs()
            check(bool((diff <= STEP_TOL * (1 + b[ok].abs())).all()),
                  f"{name}: max diff {diff.max().item()} beyond {STEP_TOL}")
            worst = max(worst, diff.max().item())
    return int(agree.sum()), worst


def profile_batch(fn, path: str, wall_ms: float) -> dict:
    """Device time by op for one warm batch, and the device's idle share
    of the batch's unprofiled wall time ``wall_ms`` (kernel times summed:
    one stream, so kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):   # the first trace pays the tracer's start-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    events = prof.key_averages()
    with open(path, "w") as f:
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=60))
    cuda = torch.autograd.DeviceType.CUDA
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == cuda) / 1e3
    ops = [e for e in events
           if e.device_type != cuda and e.self_device_time_total > 0]
    top = sorted(ops, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    return {
        "phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "top_ops": [{"op": e.key, "self_device_ms":
                     e.self_device_time_total / 1e3, "count": e.count}
                    for e in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--profile", metavar="PATH",
                    help="also trace one warm batch with torch.profiler, "
                         "print a 'profile' phase line and write the "
                         "per-op table to PATH")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    from classmate_rag_tpu_torch.embeddings.hashing import HashingEmbedder
    from classmate_rag_tpu_torch.index.catalog import Catalog, CatalogEntry
    from classmate_rag_tpu_torch.index.store import IndexStore
    from classmate_rag_tpu_torch.ops import _build
    from classmate_rag_tpu_torch.ops import topk as ttopk
    from classmate_rag_tpu_torch.ops.hybrid_step import (
        hybrid_query_step_split,
    )
    from classmate_rag_tpu_torch.retrieval.hybrid import HybridRetriever

    # ---- 1. device ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peak_key, peaks = peaks_for(kind)
    t0 = time.perf_counter()
    ptxas = _build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks_of": peak_key,
          "build_s": build_s,
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in ptxas.items()}})

    # ---- set-up: corpus, store, queries --------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    docs, emb = build_corpus(rng, CHUNKS)
    queries = make_queries(rng, docs, emb, N_BATCHES * BATCH)
    t_corpus = time.perf_counter() - t0
    store = IndexStore(DIM, slab_rows=4096, terms_per_chunk=128)
    ids = [f"c{i}" for i in range(CHUNKS)]
    step = 8192
    for s in range(0, CHUNKS, step):
        e = min(s + step, CHUNKS)
        store.upsert(ids[s:e], emb[s:e], docs[s:e],
                     [chunk_meta(i) for i in range(s, e)])
    t_upsert = time.perf_counter() - t0 - t_corpus
    batches = [queries[i: i + BATCH] for i in range(0, len(queries), BATCH)]
    knobs = dict(k_vector=K, k_bm25=K, top_k=K, pool=POOL)

    def run_batch(batch):
        q = np.stack([qv for qv, _t in batch])
        return store.hybrid_topk_batch(q, [t for _q, t in batch], None,
                                       **knobs)

    t0 = time.perf_counter()
    run_batch(batches[0]).rows.cpu()         # uploads + split-layout build
    t_first = time.perf_counter() - t0
    check(store.select_mode == "exact", "expected the exact route")

    # ---- 2. kernels ----------------------------------------------------
    q0 = torch.from_numpy(np.stack([qv for qv, _t in batches[0]])).cuda()
    kern = kernel_phase(ttopk, store, q0, peaks)
    emit({"phase": "kernels", "kernels": [kern]})

    # ---- 3. slice: the main path -----------------------------------------
    for name in ttopk.LAUNCHES:
        ttopk.LAUNCHES[name] = 0
    outs, walls, events = [], [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = run_batch(batch)
        rows = out.rows.cpu()                # host fetch ends the batch
        end.record()
        end.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
        outs.append((out, rows))
    launches = dict(ttopk.LAUNCHES)
    check(launches["topk_scan"] == len(batches),
          f"topk_scan launches {launches['topk_scan']} != {len(batches)}")

    agree_total, worst = 0, 0.0
    t0 = time.perf_counter()
    for batch, (out, _rows) in zip(batches, outs):
        q = np.stack([qv for qv, _t in batch])
        cpu = step_on_cpu(hybrid_query_step_split, store, q,
                          [t for _q, t in batch], **knobs)
        n_agree, diff = compare_steps(out, cpu)
        agree_total += n_agree
        worst = max(worst, diff)
    t_cpu = time.perf_counter() - t0
    agree_frac = agree_total / (len(batches) * BATCH)
    check(agree_frac >= ROWS_AGREE_MIN,
          f"GPU vs CPU rows agree on {agree_frac:.4f} of queries")

    t0 = time.perf_counter()
    bm25 = OracleBM25(docs)
    q_or = np.stack([qv for qv, _t in queries[:N_ORACLE]])
    sims_all = emb @ q_or.T                                   # [N, 64]
    got = torch.cat([r for _o, r in outs]).numpy()
    overlaps = []
    for j, (qv, terms) in enumerate(queries[:N_ORACLE]):
        want = set(oracle_query(qv, terms, emb, bm25, sims_all[:, j]))
        have = {int(r) for r in got[j] if r >= 0}
        overlaps.append(len(have & want) / max(len(want), 1))
    recall = float(np.mean(overlaps))
    t_oracle = time.perf_counter() - t0
    check(recall >= RECALL_MIN, f"recall@8 {recall} < {RECALL_MIN}")
    warm_wall = statistics.median(walls)
    emit({"phase": "slice", "chunks": CHUNKS,
          "capacity": store.capacity, "batch": BATCH,
          "batches": len(batches), "select": store.select_mode,
          "launches": launches, "rows_agree_gpu_cpu": agree_frac,
          "max_score_diff_gpu_cpu": worst, "recall_at_8": recall,
          "n_oracle": N_ORACLE, "batch_wall_ms": walls,
          "batch_event_ms": events, "warm_batch_ms": warm_wall,
          "qps": BATCH / (warm_wall / 1e3),
          "setup_s": {"corpus": t_corpus, "upsert": t_upsert,
                      "first_batch": t_first, "cpu_steps": t_cpu,
                      "oracle": t_oracle},
          "device_full_uploads": store.device_full_uploads,
          "split_full_builds": store.split_full_builds})

    if args.profile:
        emit(profile_batch(lambda: run_batch(batches[2]).rows.cpu(),
                           args.profile, warm_wall))

    # ---- 4. approx route ------------------------------------------------
    store.select = "approx"
    check(store.select_mode == "approx", "approx route not taken")
    batch = batches[1]
    q = np.stack([qv for qv, _t in batch])
    terms = [t for _q, t in batch]
    for name in ttopk.LAUNCHES:
        ttopk.LAUNCHES[name] = 0
    out = run_batch(batch)
    out.rows.cpu()
    approx_launches = dict(ttopk.LAUNCHES)
    check(approx_launches["topk_scan"] == 1, "approx: scan not launched")
    cpu = step_on_cpu(hybrid_query_step_split, store, q, terms, **knobs)
    n_agree, diff = compare_steps(out, cpu)
    exact_rows = outs[1][1]
    same_as_exact = float((out.rows.cpu() == exact_rows).all(dim=1)
                          .float().mean())
    check(n_agree / BATCH >= ROWS_AGREE_MIN,
          f"approx: GPU vs CPU rows agree on {n_agree / BATCH:.4f}")
    store.select = "auto"
    emit({"phase": "approx", "launches": approx_launches,
          "rows_agree_gpu_cpu": n_agree / BATCH,
          "max_score_diff_gpu_cpu": diff,
          "rows_equal_to_exact_route": same_as_exact})

    # ---- 5. retriever -----------------------------------------------------
    catalog = Catalog()
    for i, cid in enumerate(ids):
        catalog.upsert(CatalogEntry(cid, " ".join(docs[i]), docs[i],
                                    chunk_meta(i)))
    questions = [" ".join(rng.choice(docs[int(rng.integers(0, len(docs)))],
                                     size=4)) for _ in range(8)]
    cpu_store = IndexStore.from_host_state(
        store.host_state(), device="cpu", slab_rows=4096)
    embedder = HashingEmbedder(DIM)
    gpu_ret = HybridRetriever(store, catalog, embedder)
    cpu_ret = HybridRetriever(cpu_store, catalog, embedder)
    course = chunk_meta(5)["course"]
    got = gpu_ret.retrieve_batch(questions=questions)
    got.append(gpu_ret.retrieve(question=questions[0],
                                filters={"course": course}))
    want = cpu_ret.retrieve_batch(questions=questions)
    want.append(cpu_ret.retrieve(question=questions[0],
                                 filters={"course": course}))
    n_bm25 = 0
    for g, w in zip(got, want):
        check(len(g) == K, f"retriever returned {len(g)} results")
        check(all(x["id"] in store.id_to_row for x in g), "unknown id")
        check([x["id"] for x in g] == [x["id"] for x in w],
              "retriever: GPU and CPU ids differ")
        for x, y in zip(g, w):
            for key in ("fused", "vector_distance", "bm25_score"):
                a, b = x["scores"][key], y["scores"][key]
                check((a is None) == (b is None)
                      and (a is None or abs(a - b) <= STEP_TOL * (1 + abs(b))),
                      f"retriever: {key} {a} vs {b}")
            n_bm25 += x["scores"]["bm25_score"] is not None
    check(all(x["metadata"]["course"] == course for x in got[-1]),
          "filtered retrieve returned another course")
    check(n_bm25 > 0, "retriever: the BM25 branch returned nothing")
    emit({"phase": "retriever", "questions": len(questions) + 1,
          "results": sum(len(g) for g in got), "bm25_hits": n_bm25,
          "filter": {"course": course}})

    kern_line = dict(kern)
    kern_line["launches"] = launches["topk_scan"]
    emit({"kernels": [{k: kern_line[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
