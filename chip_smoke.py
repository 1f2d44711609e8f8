"""Chip smoke test of the PyTorch/CUDA port (classmate_rag_tpu_torch).

Drives the port's two main paths on one CUDA card and holds every kernel
of them against its plain PyTorch version: the batched fused hybrid
query at the E5-base width (d = 768) over a 200,000-chunk corpus, and
the E5-base encoder (full width, 12 layers, random weights from the
model name) that ingests passages and encodes the questions it answers.

    python3 chip_smoke.py            # on a machine with one NVIDIA GPU

Phases, one JSON line each; any failure exits non-zero with no result:

1. device     card name and power limit (nvidia-smi), kernel build seconds;
2. kernels    each kernel vs its plain version at the main paths' shapes
              and at edge cases (topk_scan also at 1,048,576 rows;
              topk_merge, its second launch, merges its lists); its
              time, the plain version's, one PyTorch library call's,
              and the card's bound;
3. slice      4 batches of 256 queries through IndexStore.hybrid_topk_batch
              (launch counts reset just before, read just after), each
              held against the same step on CPU copies of its inputs;
              recall@8 against a numpy oracle; warm batch latency;
4. approx     one batch with the approx route forced (fast BM25 + exact
              pool rescore), held against the CPU the same way;
5. retriever  HybridRetriever over the same store vs a CPU copy of it;
6. encoder    E5-base with the fused epilogues and flash attention
              (fused_epilogue=True, flash_min_seq=128; launch counts reset
              just before, read just after, 12/24/12 a forward) and with
              the default configuration (none of the three kernels) on
              8,192 passages, 32 long texts and 256 questions: cosine
              between the two, and against a CPU copy on a subset;
              tokens/s, ms a forward by bucket, share of the bf16 peak;
7. ingest_ask E5 passage vectors into a new store, then 256 questions
              through HybridRetriever with the encoder's query tensor
              handed to the store on the card (launch counts reset just
              before the ingest, read after the first ask); ids equal to
              the host-encode path's; recall@8 against the oracle fed the
              port's own vectors; encode, step and warm batch latency.

Then the kernels line ({"kernels": [...]}), the nvidia-smi line, and
last {"ok": true, "device": {...}}. A kernel's ``ms`` (and the plain
and library times beside it) is CUDA-event time over 20 calls in a row
after warm-up, divided by 20; ``ms_single`` is the median of 20 calls
timed one by one, host launch overhead included; ``device_ms`` (and
``library_device_ms``) the device time of the kernels one call
launches, from torch.profiler over 20 calls: the card's busy time
where the host cannot keep 20 short calls back to back. ``--profile PATH``
also traces one warm batch (table in PATH) and one encoder forward
(table in PATH_encoder).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
LN_TOL = 1e-5          # residual_ln kernel vs plain (f32, other sum order)
ATTN_TOL = 1e-2        # flash_attn vs plain for |v| <= 1 (bf16 weights)
ENC_COS_MIN = 0.9999   # encoder rows: slice vs default config, card vs CPU
MODEL_NAME = "intfloat/multilingual-e5-base"
ENC_CHUNKS = 8192      # passages the encoder phases ingest
N_LONG = 32            # long texts (> 256 tokens: bucket 512)
N_QUESTIONS = 256
CPU_SUBSET = (16, 8, 4)  # queries, passages, long texts the CPU copy encodes

# Published dense peaks (NVIDIA data sheets): memory bytes/s, bf16
# tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100": (3.35e12, 989e12, 67e12),      # SXM5, 80 GB HBM3
    "H200": (4.8e12, 989e12, 67e12),
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
    """The card's time for one call of ``fn``: CUDA events around
    ``reps`` calls in a row after warm-up, over ``reps`` (the host
    queues the next launch while the card runs the last)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_single_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` calls of ``fn`` each timed alone with CUDA
    events: the card's time plus the host's before the first launch."""
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


def slice_edges(ttopk):
    """topk_scan at the edges of its slice walk; returns max |dscore|."""
    rng = np.random.default_rng(3)

    def unit(rows, dd=DIM):
        x = rng.standard_normal((rows, dd)).astype(np.float32)
        return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))

    # Q not a multiple of the 64-query block; k = 1 and k = 128; a
    # ragged last tile; every 9th row masked.
    small = unit(5000 + 77).to(torch.bfloat16).cuda()
    sq = unit(70).cuda()
    sb = torch.zeros(small.shape[0], device="cuda")
    sb[::9] = ttopk.NEG_INF
    errs = [compare_topk(ttopk, small, sq, sb, k) for k in (1, 128)]
    all_masked = torch.full_like(sb, ttopk.NEG_INF)
    v1, i1 = ttopk.masked_topk(small, sq, all_masked, 16)
    v0, i0 = ttopk.topk_reference(small, sq, all_masked, 16)
    check(torch.equal(i1, i0) and bool((v1 <= ttopk.NEG_INF / 2).all()),
          "topk_scan: all-masked corpus")
    # A duplicate row in another slice: the lower row first.
    n = 50_000
    dup = unit(n).to(torch.bfloat16).cuda()
    dup[n // 2] = dup[10]
    zeros = torch.zeros(n, device="cuda")
    _s, rows = ttopk.kernel_slices(n, 2, DIM, 12, dup.device)
    check(10 // rows != (n // 2) // rows, "duplicate not in another slice")
    v1, i1 = ttopk.masked_topk(dup, dup[10:12].float(), zeros, 12)
    v0, i0 = ttopk.topk_reference(dup, dup[10:12].float(), zeros, 12)
    check(torch.equal(i1, i0) and i1[0, :2].tolist() == [10, n // 2],
          f"topk_scan: cross-slice ties {i1[0, :4].tolist()}")
    # Identical rows: every score ties, the lowest k rows in order.
    same = unit(1).to(torch.bfloat16).cuda().expand(3000, DIM).contiguous()
    v1, i1 = ttopk.masked_topk(same, sq[:5], zeros[:3000], 32)
    want = torch.arange(32, dtype=torch.int32, device="cuda").expand(5, 32)
    check(torch.equal(i1, want), "topk_scan: identical rows")
    # A corpus below one tile, and one whose last slice holds one row.
    errs.append(compare_topk(ttopk, small[:77].contiguous(), sq[:5], sb[:77],
                             16))
    n_edge = next(t * 128 + 1 for t in range(2, 4096)
                  if (t * 128 + 1) % ttopk.kernel_slices(
                      t * 128 + 1, BATCH, DIM, 32, small.device)[1] == 1)
    edge = unit(n_edge).to(torch.bfloat16).cuda()
    errs.append(compare_topk(ttopk, edge, unit(BATCH).cuda(),
                             torch.zeros(n_edge, device="cuda"), 32))
    return max(errs)


def scan_row(ttopk, emb, q, bias, k, peaks, err):
    """topk_scan's numbers at one shape: the wrapper (scan + merge), the
    scan alone, the plain version and one PyTorch library call."""
    n, d = emb.shape
    nq = q.shape[0]
    q16 = q.to(torch.bfloat16)
    row = kernel_row(
        "topk_scan", "topk_scan.cu", "classmate_rag_tpu/ops/topk.py:170",
        {"N": n, "d": d, "Q": nq, "k": k}, err,
        lambda: ttopk.masked_topk(emb, q, bias, k),
        time_ms(lambda: ttopk.topk_reference(emb, q, bias, k), reps=5),
        lambda: torch.topk(torch.matmul(q16, emb.T).float() + bias, k),
        n * d * 2 + nq * d * 4 + n * 4 + nq * k * 8,
        2.0 * nq * n * d, peaks[0], peaks[1])
    row["scan_ms"] = time_ms(lambda: ttopk.scan_partials(emb, q, bias, k))
    row["slices"] = ttopk.kernel_slices(n, nq, d, k, emb.device)[0]
    return row


def merge_row(ttopk, emb, q, bias, k, peaks):
    """topk_merge (the scan's lists -> the top-k) vs merge_partials, its
    plain version, on one scan's lists at the main path's shape."""
    part_vals, part_rows, bounds = ttopk.scan_partials(emb, q, bias, k)
    got_v, got_r = ttopk.merge_slices(part_vals, part_rows, bounds, k)
    want_v, want_r = ttopk.merge_partials(part_vals, part_rows, k)
    torch.cuda.synchronize()
    check(torch.equal(got_r, want_r), "topk_merge: rows differ")
    err = (got_v - want_v).abs().max().item()
    check(err == 0.0, f"topk_merge: max |dscore| {err}")
    nq, lists, _ = part_vals.shape
    flat = part_vals.reshape(nq, -1)
    return kernel_row(
        "topk_merge", "topk_scan.cu", "classmate_rag_tpu/ops/topk.py:170",
        {"Q": nq, "lists": lists, "k": k}, err,
        lambda: ttopk.merge_slices(part_vals, part_rows, bounds, k),
        time_ms(lambda: ttopk.merge_partials(part_vals, part_rows, k)),
        # One call, the same top-k up to the order of equal scores.
        lambda: torch.topk(flat, k),
        nq * lists * k * 8 + nq * 4 + nq * k * 8, 0.0, peaks[0], peaks[1])


def kernel_phase(ttopk, store, q_dev, peaks):
    """topk_scan at the main path's shape, at the reference's 1M-row
    bench scale and at the edges of its slice walk."""
    dev = store._sync_device()
    emb = dev["emb"]
    n = emb.shape[0]
    sel = min(max(store.rescore_pool, POOL), n)
    # The main path's unfiltered bias with ~10% of the rows masked on top.
    g = torch.Generator(device="cuda").manual_seed(7)
    bias = store._mask_bias(None).clone()
    bias[torch.rand(n, device="cuda", generator=g) < 0.1] = ttopk.NEG_INF
    err = max(compare_topk(ttopk, emb, q_dev, bias, sel), slice_edges(ttopk))
    serving = scan_row(ttopk, emb, q_dev, bias, sel, peaks, err)
    merge = merge_row(ttopk, emb, q_dev, bias, sel, peaks)

    # 1,048,576 rows (BENCH_r04's scale, the approx route's shape): unit
    # rows made on the card, 256 queries made from rows as make_queries
    # makes them.
    big_n = 1 << 20
    big = torch.randn(big_n, DIM, device="cuda", generator=g)
    big = (big / big.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    bq = big[:: big_n // BATCH][:BATCH].float()
    bq = bq + 0.25 * torch.randn(bq.shape, device="cuda", generator=g)
    bq = (bq / bq.norm(dim=1, keepdim=True)).contiguous()
    bb = torch.zeros(big_n, device="cuda")
    bb[torch.rand(big_n, device="cuda", generator=g) < 0.1] = ttopk.NEG_INF
    big_err = compare_topk(ttopk, big, bq, bb, sel)
    big_row = scan_row(ttopk, big, bq, bb, sel, peaks, big_err)
    del big
    torch.cuda.empty_cache()
    return serving, big_row, merge


def device_ms(fn, reps: int = 20) -> float:
    """The card's busy time for one call of ``fn``: the device time of
    every kernel it launches over ``reps`` calls (torch.profiler), over
    ``reps``. Unlike ``time_ms`` it leaves out the gaps where the card
    waits for the host between short calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda) / reps / 1e3


def kernel_row(name, source, replaces, shape, err, fn, plain_ms, library,
               bytes_moved, ops, bw, op_peak):
    """One kernel's numbers: ``fn`` calls its wrapper, ``library`` the one
    PyTorch call that computes the same function; the bound is the
    larger of bytes over the memory rate and operations over the peak
    rate of their type."""
    t_bytes = bytes_moved / bw * 1e3
    t_ops = ops / op_peak * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": f"classmate_rag_tpu_torch/ops/csrc/{source}",
        "replaces": replaces,
        "shape": shape,
        "max_abs_err": err,
        "ms": time_ms(fn),
        "ms_single": time_single_ms(fn),
        "device_ms": device_ms(fn),
        "plain_ms": plain_ms,
        "library_ms": time_ms(library),
        "library_device_ms": device_ms(library),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": bytes_moved,
        "flops": ops,
    }


def bf16_spacing(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    _m, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


def epilogue_kernels(tef, peaks):
    """bias_gelu and residual_ln at the encoder's shapes (B·T = 16,384
    tokens of E5-base) and at ragged ones."""
    import torch.nn.functional as F

    bw, _bf16_peak, f32_peak = peaks
    g = torch.Generator(device="cuda").manual_seed(11)

    def normal(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, device="cuda", generator=g) * std + mean

    n, f, h = 16384, 3072, 768
    err = 0.0
    for rows, cols in ((n, f), (1021, f), (7, 24)):
        y, b = normal(rows, cols, std=2.0), normal(cols, std=0.5)
        got, want = tef.bias_gelu(y, b), tef.bias_gelu_reference(y, b)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        check(bool((diff <= bf16_spacing(want.float())).all()),
              f"bias_gelu [{rows}, {cols}]: beyond 1 bf16 spacing")
        err = max(err, diff.max().item())
    y, b = normal(n, f, std=2.0), normal(f, std=0.5)
    gelu = kernel_row(
        "bias_gelu", "bias_gelu.cu",
        "classmate_rag_tpu/ops/encoder_fused.py:104", {"N": n, "F": f}, err,
        lambda: tef.bias_gelu(y, b),
        time_ms(lambda: tef.bias_gelu_reference(y, b)),
        lambda: F.gelu(y + b).to(torch.bfloat16),
        n * f * (4 + 2) + 4 * f,
        5.0 * n * f,          # add, 3 multiplies, erfc counted as one
        bw, f32_peak)

    err = 0.0
    for rows in (n, 77):
        args = (normal(rows, h), normal(rows, h), normal(h, std=0.1),
                normal(h, std=0.1, mean=1.0), normal(h, std=0.1))
        got = tef.residual_ln(*args, eps=1e-5)
        want = tef.residual_ln_reference(*args, eps=1e-5)
        torch.cuda.synchronize()
        err = max(err, (got - want).abs().max().item())
    check(err <= LN_TOL, f"residual_ln: max |d| {err} > {LN_TOL}")
    resid, y, b, gg, beta = args = (
        normal(n, h), normal(n, h), normal(h, std=0.1),
        normal(h, std=0.1, mean=1.0), normal(h, std=0.1))
    ln = kernel_row(
        "residual_ln", "residual_ln.cu",
        "classmate_rag_tpu/ops/encoder_fused.py:145", {"N": n, "H": h}, err,
        lambda: tef.residual_ln(*args, eps=1e-5),
        time_ms(lambda: tef.residual_ln_reference(*args, eps=1e-5)),
        lambda: F.layer_norm(resid + y + b, (h,), gg, beta, 1e-5),
        3 * n * h * 4 + 3 * h * 4,
        10.0 * n * h,         # 2 adds, 2 reduction passes, normalise
        bw, f32_peak)
    return gelu, ln


def flash_kernel(tatt, peaks):
    """flash_attn at the encoder's (B, T) of the three buckets the flash
    gate takes (512, 256, 128), with per-row lengths from 1 to T and rows
    whose last key tiles are all padding; returns the (B = 128, T = 128)
    row (the bucket the passage ingest runs most) and every shape's
    numbers."""
    import torch.nn.functional as F

    bw, bf16_peak, _f32 = peaks
    nh, hd = 12, 64
    rng = np.random.default_rng(12)
    rows = {}
    for b, t in ((32, 512), (64, 256), (128, 128)):
        qkv = rng.normal(0, 1.0, (b, t, 3, nh, hd)).astype(np.float32)
        qkv[:, :, 2] = rng.uniform(-1, 1, (b, t, nh, hd))
        qkv = torch.from_numpy(qkv).to(torch.bfloat16).cuda()
        q, k, v = qkv.unbind(2)
        lengths = rng.integers(1, t + 1, b)
        lengths[:3] = (40, t, 1)   # row 0: the last key tiles all padding
        mask = torch.from_numpy(
            (np.arange(t)[None, :] < lengths[:, None]).astype(np.int32)
        ).cuda()
        got = tatt.flash_attention(q, k, v, mask, 0.125)
        want = tatt.attention_reference(q, k, v, mask, 0.125)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()),
              f"flash_attn B={b} T={t}: non-finite rows")
        err = (got.float() - want.float()).abs().max().item()
        check(err <= ATTN_TOL, f"flash_attn B={b} T={t}: max |d| {err}")
        keep = mask.bool()[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        real = int(lengths.sum())
        h = nh * hd
        rows[(b, t)] = kernel_row(
            "flash_attn", "flash_attn.cu",
            "classmate_rag_tpu/embeddings/model.py:272",
            {"B": b, "T": t, "heads": nh, "head_dim": hd,
             "real_keys": real}, err,
            lambda: tatt.flash_attention(q, k, v, mask, 0.125),
            time_ms(lambda: tatt.attention_reference(q, k, v, mask, 0.125)),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=keep),
            # q read and out written for every row; k and v only where
            # a key is real (the rest weighs exactly 0); the mask.
            2 * b * t * h * 2 + 2 * real * h * 2 + b * t * 4,
            # QK^T and PV over the real keys of every query row.
            4.0 * nh * hd * t * real,
            bw, bf16_peak)
        # The persistent grid: (batch row, head, 128-query) items walked
        # by the CTAs the card holds at once.
        rows[(b, t)].update(items=b * nh * -(-t // 128),
                            resident_ctas=tatt.resident_ctas())
    return rows[(128, 128)], list(rows.values())


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


def profile_batch(fn, path: str, wall_ms: float,
                  phase: str = "profile") -> dict:
    """Device time by op for one warm run of ``fn`` (a batch, a forward),
    and the device's idle share of its unprofiled wall time ``wall_ms``
    (kernel times summed: one stream, so kernels do not overlap)."""
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
    def top(keep):
        rows = [e for e in events
                if keep(e) and e.self_device_time_total > 0]
        return sorted(rows, key=lambda e: e.self_device_time_total,
                      reverse=True)[:12]

    return {
        "phase": phase, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "top_ops": [{"op": e.key, "self_device_ms":
                     e.self_device_time_total / 1e3, "count": e.count}
                    for e in top(lambda e: e.device_type != cuda)],
        # Kernels by name: the port's own (launched through ctypes, with
        # no aten op above them) show only here.
        "top_kernels": [{"kernel": e.key[:60], "device_ms":
                         e.self_device_time_total / 1e3, "count": e.count}
                        for e in top(lambda e: e.device_type == cuda)],
    }


# ---------------------------------------------------------------------------
# The encoder path
# ---------------------------------------------------------------------------

class Counts:
    """Every kernel's launch count, set to 0 and read around a run."""

    def __init__(self, *modules):
        self.tables = [m.LAUNCHES for m in modules]

    def reset(self) -> None:
        for table in self.tables:
            for name in table:
                table[name] = 0

    def read(self) -> dict:
        return {k: v for table in self.tables for k, v in table.items()}


def encoder_texts(rng, docs):
    """Passages (E5 buckets 64 and 128), long texts (> 256 tokens, bucket
    512) and questions (5 words of a passage, bucket 32)."""
    passages = [" ".join(d) for d in docs[:ENC_CHUNKS]]
    longs = []
    for i in range(N_LONG):
        words, j = [], i * 16
        while len(words) < 320:
            words += docs[j]
            j += 1
        longs.append(" ".join(words))
    src = rng.integers(0, ENC_CHUNKS, N_QUESTIONS)
    questions = [" ".join(rng.choice(docs[i], size=5, replace=False))
                 for i in src]
    return passages, longs, questions


def row_cos(a: np.ndarray, b: np.ndarray) -> float:
    """Least per-row cosine of two row-normalised matrices."""
    return float((a * b).sum(axis=1).min())


def encode_all(enc, sets):
    """Encode each named set on the card; (vectors, seconds, forward
    shapes) with the card synchronised at the end of each set."""
    shapes = []
    orig = enc._dispatch_bucket

    def record(ids, mask):
        shapes.append(ids.shape)
        return orig(ids, mask)

    enc._dispatch_bucket = record
    vecs, secs = {}, {}
    try:
        for name, (texts, fn) in sets.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = getattr(enc, fn)(texts)
            vecs[name] = (out.cpu().numpy() if isinstance(out, torch.Tensor)
                          else out)
            secs[name] = time.perf_counter() - t0
    finally:
        del enc._dispatch_bucket
    return vecs, secs, shapes


def encoder_phase(rng, docs, counts, peaks, profile_path):
    """E5-base at full width with the slice configuration and the
    default one, on the card, and the slice configuration on the CPU."""
    from classmate_rag_tpu_torch.embeddings.encoder import E5Encoder
    from classmate_rag_tpu_torch.embeddings.model import (
        EncoderConfig,
        encoder_flops,
        init_params,
    )

    t0 = time.perf_counter()
    base = EncoderConfig.base()
    slice_cfg = dataclasses.replace(base, fused_epilogue=True,
                                    flash_min_seq=128)
    tree = init_params(base, MODEL_NAME)
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc = E5Encoder(model_name=MODEL_NAME, config=slice_cfg, params=tree)
    enc_default = E5Encoder(model_name=MODEL_NAME, config=base, params=tree)
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    passages, longs, questions = encoder_texts(rng, docs)
    sets = {"passages": (passages, "encode_passages"),
            "long": (longs, "encode_passages"),
            "queries": (questions, "encode_queries_device")}

    # The main path: every count 0 just before, read just after.
    counts.reset()
    vecs, secs, shapes = encode_all(enc, sets)
    launches = counts.read()
    n_fwd = len(shapes)
    n_flash = sum(1 for _b, t in shapes
                  if t >= slice_cfg.flash_min_seq and t % 128 == 0)
    n_layers = slice_cfg.layers      # 12: 12 / 24 / 12 a forward
    want = {"bias_gelu": n_layers * n_fwd, "residual_ln": 2 * n_layers * n_fwd,
            "flash_attn": n_layers * n_flash, "topk_scan": 0,
            "topk_merge": 0}
    check(launches == want, f"encoder launches {launches} != {want}")
    check(n_flash > 0 and n_flash < n_fwd, "expected flash and non-flash "
          f"buckets, got {sorted(set(t for _b, t in shapes))}")

    counts.reset()
    vecs_default, secs_default, _ = encode_all(enc_default, sets)
    default_launches = counts.read()
    check(not any(default_launches.values()),
          f"the default configuration launched {default_launches}")
    cos_configs = {}
    for name, v in vecs.items():
        check(v.shape == (len(sets[name][0]), DIM)
              and bool(np.isfinite(v).all()), f"encoder {name}: bad output")
        cos_configs[name] = row_cos(v, vecs_default[name])
        check(cos_configs[name] >= ENC_COS_MIN,
              f"encoder {name}: slice vs default cosine {cos_configs[name]}")

    t0 = time.perf_counter()
    enc_cpu = E5Encoder(model_name=MODEL_NAME, config=slice_cfg,
                        params=tree, device="cpu")
    nq, npas, nlong = CPU_SUBSET
    cos_cpu = {
        "queries": row_cos(enc_cpu.encode_queries(questions[:nq]),
                           vecs["queries"][:nq]),
        "passages": row_cos(enc_cpu.encode_passages(passages[:npas]),
                            vecs["passages"][:npas]),
        "long": row_cos(enc_cpu.encode_passages(longs[:nlong]),
                        vecs["long"][:nlong]),
    }
    t_cpu = time.perf_counter() - t0
    del enc_cpu
    for name, c in cos_cpu.items():
        check(c >= ENC_COS_MIN, f"encoder {name}: card vs CPU cosine {c}")

    # One forward per bucket at its full batch, both configurations.
    by_bucket = {}
    for t in (32, 64, 128, 256, 512):
        b = max(8, 16384 // t)
        ids = torch.randint(4, base.vocab_size, (b, t), device=enc.device,
                            dtype=torch.int32)
        ids[:, 0] = 0
        mask = torch.ones_like(ids)
        row = {"batch": b}
        for name, e in (("slice", enc), ("default", enc_default)):
            with torch.no_grad():
                ms = time_ms(lambda: e.model(ids, mask), reps=5, warmup=2)
            row[f"{name}_ms"] = ms
            row[f"{name}_tokens_per_s"] = b * t / (ms / 1e3)
            row[f"{name}_bf16_peak_share"] = (
                encoder_flops(base, b, t) / (ms / 1e3) / peaks[1])
        by_bucket[t] = row

    total_s = sum(secs.values())
    real_tokens = sum(len(enc.tokenizer.encode(x, enc.max_length))
                      for texts in (passages, longs) for x in texts)
    line = {
        "phase": "encoder", "model": MODEL_NAME, "layers": base.layers,
        "hidden": base.hidden, "heads": base.heads,
        "vocab": base.vocab_size,
        "texts": {k: len(v[0]) for k, v in sets.items()},
        "forwards": n_fwd, "flash_forwards": n_flash,
        "buckets": sorted({t for _b, t in shapes}),
        "launches": launches, "default_launches": default_launches,
        "cos_slice_vs_default": cos_configs, "cos_card_vs_cpu": cos_cpu,
        "encode_s": secs, "encode_s_default": secs_default,
        "padded_tokens_per_s": sum(b * t for b, t in shapes) / total_s,
        "passage_tokens_per_s": real_tokens / (secs["passages"]
                                               + secs["long"]),
        "bf16_peak_share": enc.last_flops / total_s / peaks[1],
        "by_bucket": by_bucket,
        "setup_s": {"init_params": t_init, "upload_two": t_upload,
                    "cpu_copy": t_cpu},
    }
    emit(line)
    if profile_path:
        path = Path(profile_path)
        path = path.with_name(f"{path.stem}_encoder{path.suffix}")
        ids = torch.randint(4, base.vocab_size, (128, 128),
                            device=enc.device, dtype=torch.int32)
        mask = torch.ones_like(ids)

        def forward():
            with torch.no_grad():
                enc.model(ids, mask)

        emit(profile_batch(forward, str(path),
                           time_single_ms(forward, reps=5, warmup=2),
                           phase="profile_encoder"))
    return enc, launches


def ingest_ask_phase(enc, docs, rng, counts, knobs):
    """Ingest E5 passage vectors, then answer questions through the
    retriever with the encoder's query tensor handed over on the card."""
    from classmate_rag_tpu_torch.embeddings.cache import CachingEmbedder
    from classmate_rag_tpu_torch.index.catalog import Catalog, CatalogEntry
    from classmate_rag_tpu_torch.index.lexical import tokenize_py
    from classmate_rag_tpu_torch.index.store import IndexStore
    from classmate_rag_tpu_torch.retrieval.hybrid import HybridRetriever
    from classmate_rag_tpu_torch.utils.lang import detect_lang_tag

    texts, _longs, questions = encoder_texts(rng, docs)
    ids = [f"e{i}" for i in range(ENC_CHUNKS)]
    with tempfile.TemporaryDirectory() as cache_dir:
        cached = CachingEmbedder(enc, cache_dir=cache_dir)
        store = IndexStore(DIM, slab_rows=4096, terms_per_chunk=128)
        catalog = Catalog()
        for i, cid in enumerate(ids):
            catalog.upsert(CatalogEntry(cid, texts[i], docs[i],
                                        chunk_meta(i)))
        ret = HybridRetriever(store, catalog, cached)
        seen = []
        step = store.hybrid_topk_batch

        def spy(q, *a, **kw):
            seen.append(q.device.type if isinstance(q, torch.Tensor)
                        else type(q).__name__)
            return step(q, *a, **kw)

        store.hybrid_topk_batch = spy

        # The main path: every count 0 just before, read just after.
        counts.reset()
        t0 = time.perf_counter()
        vecs = cached.encode_passages(texts)
        t_encode = time.perf_counter() - t0
        store.upsert(ids, vecs, [docs[i] for i in range(ENC_CHUNKS)],
                     [chunk_meta(i) for i in range(ENC_CHUNKS)])
        t_ingest = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = ret.retrieve_batch(questions=questions)
        t_first = time.perf_counter() - t0
        launches = counts.read()
        for name, n in launches.items():
            check(n > 0, f"ingest+ask: {name} was not launched")
        check(seen == ["cuda"], f"the query tensor reached the store as "
              f"{seen}, not on the card")

        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            again = ret.retrieve_batch(questions=questions)
            walls.append((time.perf_counter() - t0) * 1e3)
        check([[x["id"] for x in r] for r in again]
              == [[x["id"] for x in r] for r in got], "ask is not stable")

        def encode():
            q = cached.encode_queries_device(questions)
            torch.cuda.synchronize()
            return q

        encode_ms, q_dev = [], None
        for _ in range(3):
            t0 = time.perf_counter()
            q_dev = encode()
            encode_ms.append((time.perf_counter() - t0) * 1e3)
        terms = [tokenize_py(q, detect_lang_tag(q)) for q in questions]
        step_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(q_dev, terms, None, **knobs).rows.cpu()
            step_ms.append((time.perf_counter() - t0) * 1e3)

        host = dataclasses.replace(ret, use_device_encode=False)
        want = host.retrieve_batch(questions=questions)
        check(seen[-1] == "ndarray", "host path did not take the host")
        check([[x["id"] for x in r] for r in want]
              == [[x["id"] for x in r] for r in got],
              "device handoff ids differ from the host-encode path's")
        cache_files = sum(1 for _ in Path(cache_dir).rglob("*.npy"))
        del store.hybrid_topk_batch

    bm25 = OracleBM25(docs[:ENC_CHUNKS])
    qv = q_dev.cpu().numpy()
    sims = vecs @ qv.T
    overlaps = []
    for j, q in enumerate(questions):
        oracle = set(oracle_query(qv[j], terms[j], vecs, bm25, sims[:, j]))
        have = {int(x["id"][1:]) for x in got[j]}
        overlaps.append(len(have & oracle) / max(len(oracle), 1))
    recall = float(np.mean(overlaps))
    check(recall >= RECALL_MIN, f"ingest+ask recall@8 {recall}")
    emit({"phase": "ingest_ask", "chunks": ENC_CHUNKS,
          "questions": N_QUESTIONS, "launches": launches,
          "query_tensor_at_store": seen[0], "ids_equal_host_path": True,
          "recall_at_8": recall, "n_oracle": N_QUESTIONS,
          "encode_ms": statistics.median(encode_ms),
          "step_ms": statistics.median(step_ms),
          "warm_batch_ms": statistics.median(walls),
          "batch_wall_ms": walls, "first_ask_s": t_first,
          "ingest_s": {"encode": t_encode, "encode_and_upsert": t_ingest},
          "cache_files": cache_files})
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--profile", metavar="PATH",
                    help="also trace one warm batch and one encoder "
                         "forward (slice configuration, bucket 128) with "
                         "torch.profiler, print 'profile' and "
                         "'profile_encoder' phase lines and write the "
                         "per-op tables to PATH and PATH_encoder")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    from classmate_rag_tpu_torch.embeddings.hashing import HashingEmbedder
    from classmate_rag_tpu_torch.index.catalog import Catalog, CatalogEntry
    from classmate_rag_tpu_torch.index.store import IndexStore
    from classmate_rag_tpu_torch.ops import _build
    from classmate_rag_tpu_torch.ops import attention as tatt
    from classmate_rag_tpu_torch.ops import encoder_fused as tef
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
    kern, kern_1m, merge = kernel_phase(ttopk, store, q0, peaks)
    gelu, ln = epilogue_kernels(tef, peaks)
    flash, flash_rows = flash_kernel(tatt, peaks)
    emit({"phase": "kernels",
          "kernels": [kern, kern_1m, merge, gelu, ln, *flash_rows]})
    counts = Counts(ttopk, tef, tatt)

    # ---- 3. slice: the main path -----------------------------------------
    counts.reset()
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
    launches = counts.read()
    for name in ("topk_scan", "topk_merge"):
        check(launches[name] == len(batches),
              f"{name} launches {launches[name]} != {len(batches)}")

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
    counts.reset()
    out = run_batch(batch)
    out.rows.cpu()
    approx_launches = counts.read()
    check(approx_launches["topk_scan"] == approx_launches["topk_merge"] == 1,
          "approx: scan or merge not launched")
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

    # ---- 6. encoder, 7. ingest + ask --------------------------------------
    enc, enc_launches = encoder_phase(rng, docs, counts, peaks, args.profile)
    ingest_ask_phase(enc, docs, rng, counts, knobs)

    line = []
    for row, n in ((kern, launches["topk_scan"]),
                   (merge, launches["topk_merge"]),
                   (gelu, enc_launches["bias_gelu"]),
                   (ln, enc_launches["residual_ln"]),
                   (flash, enc_launches["flash_attn"])):
        row = {**row, "launches": n}
        line.append({k: row[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    emit({"kernels": line})
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
