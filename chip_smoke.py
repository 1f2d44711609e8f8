"""Chip smoke test of the PyTorch/CUDA port (classmate_rag_tpu_torch).

Drives the port's main paths on one CUDA card and holds every kernel
of them against its plain PyTorch version: the batched fused hybrid
query at the E5-base width (d = 768) over a 200,000-chunk corpus, the
E5-base encoder (full width, 12 layers, random weights from the model
name) that ingests passages and encodes the questions it answers, the
product path, the answer generator (Llama-3.1-8B at full width; it
runs no hand-written kernel), the encoder's fine-tuning with the
flash attention backward kernels, the routed ask with the index's
admin verbs through the port's command line, the corpus-sharded
serving engine with data-parallel encode, dp×tp training and decode
over ("data", "model") meshes of logical ranks on the one card, the
same sharded engine served by two processes, the int8 scan, the port's
benchmark at 1,000,000 chunks, the port's measurement tools, and its
driver entry points (``graft_entry``: the E5-base forward and the
six-stage multi-device dryrun).

    python3 chip_smoke.py            # on a machine with one NVIDIA GPU
    python3 chip_smoke.py --product-child DIR   # phase 8's child alone
    python3 chip_smoke.py --decode-child        # phase 9's child alone
    python3 chip_smoke.py --row-select-child    # phase 2's row_select part
    python3 chip_smoke.py --bm25-core-child     # phase 2's bm25_sat_gemm part
    python3 chip_smoke.py --multihost-child RANK DIR ADDR   # a phase 14 rank
    python3 chip_smoke.py --tools-child cold|serve DIR      # a phase 17 child

Phases, one JSON line each; any failure exits non-zero with no result:

1. device     card name and power limit (nvidia-smi), kernel build seconds,
              the chip utils/profiling.py detects (its peak table gives
              every bound);
2. kernels    each kernel vs its plain version at the main paths' shapes
              and at edge cases (topk_scan also at 1,048,576 rows, and
              at k equal to the corpus's 16 rows at d 64;
              topk_merge, its second launch, merges its lists); its
              time, the plain version's, one PyTorch library call's,
              and the card's bound; then phase 10's and phase 13's
              kernel checks (their 'kernels' line, part 'train'), here
              while the process is young; its row_select part runs
              after phase 16, in a child (--row-select-child; line part
              'row_select'): BM25's selection bit-equal to the stable
              sort it replaces on BM25-shaped [256, 1,048,576] and
              [256, 262,144] scores at k 8, 64 and 128 and at its edges,
              with the share of entries its filter let through; then its
              bm25_sat_gemm part, in a child (--bm25-core-child; line part
              'bm25_core'): the approx route's BM25 core at the 1M cell's
              shapes (BM25_SHAPE) against its plain version and its bound,
              with the tail posting list's and the whole core's times;
3. slice      4 batches of 256 queries through IndexStore.hybrid_topk_batch
              (launch counts reset just before, read just after), all 4
              held against the same packed step on CPU copies of their
              inputs, and against the unpacked step on the card (rows
              equal, scores within 1e-6);
              recall@8 against a numpy oracle; warm batch latency; the
              host-to-device copies of one warm batch (the Memcpy HtoD
              events of a torch.profiler trace: 2, the packed metadata
              and the query vectors) and their bytes, equal to the copy
              ops the batch dispatches; whether making a
              batch's inputs waits for work queued on the stream, for
              the packed upload and for the pageable one-array-a-copy
              upload bm25_topk still makes (and that upload's copies);
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
              port's own vectors; encode, step and warm batch latency;
              the host-to-device copies of one step on the encoder's
              query tensor (1: the packed metadata), counted by the
              torch ops that copy (phase 3 holds that count equal to its
              trace's; the profiler loses kernels at this age).
8. product    the product path at bench.py's scale-2 size (200,000 chunks
              of the slice corpus, d 768, stable_chunk_id ids, 10 chunks a
              document, BM25_TERMS_PER_CHUNK 256, capacity 262,144): a
              catalog JSONL and a saved store (with the persisted split
              layout) in a temporary directory, then a child process
              (--product-child DIR) that cold-starts get_runtime from it,
              answers 2 + 32 zipf questions with ask_question, ingests and
              persists one new document (a delta: the base files stay),
              asks 16 more with no O(corpus) counter moving and rows equal
              to a store loaded anew on the CPU, and serves three rounds
              of 8 concurrent /asks, a /delete and /stats through
              make_server; then a second runtime on the same index
              answers with the decoder (LLM_BACKEND=tpu, temperature 0,
              64 new tokens): 8 asks and 8 concurrent /asks, every
              answer non-empty, one runner built (a "decode" line,
              part "product"); the native tokenizer and packer loaded
              (native/; the add packs with it) and equal to the
              Python path on the first 20,000 chunks (cut from 200,000),
              seconds each way;
9. decode     in a child (--decode-child): Llama-3.1-8B at full width
              (32 layers, weights drawn on the card from a seed) decodes
              8 prompts left-padded to 1,024 (real lengths 512-1,024),
              128 new tokens greedy, in bf16 and in W8A8 (the weights
              quantized on the card): prefill ms, tokens/s and share of
              the bf16 peak, decode ms a step against its bandwidth
              bound, peak memory, the device's idle share over 4 steps;
              W8A8's products exact to the int8 formula in f32, its
              logits teacher-forced against bf16 (printed); 2 layers at
              full width on the card against the CPU (cosine >= 0.9999,
              argmax flips only at near-ties); get_runner
              with LLM_BACKEND=tpu (a chat_batch of 8 against 8 chats at
              temperature 0) and a Q8_0 GGUF written by the port loaded
              by DecodeRunner. One JSON line a part, each beside the
              card's name and power limit.
10. train     (its kernel checks run in phase 2) the backward kernels
              (flash_attn_bwd_delta, then the fused
              flash_attn_bwd) against the plain version's autograd at
              (B 32, T 128), (16, 256), (8, 512) and (4, 200), 12 heads,
              padded rows and a row with no real key (cosine >= 0.9999,
              max |d| <= 2e-2 of the largest plain value), the
              LSE-writing forward bit-equal to the serving one, and their
              times at the first three shapes, with the held-stream times
              of D (kernel and four torch ops), of the whole backward,
              of SDPA's backward and of the f32 workspace's conversion
              (a 'kernels' line, part 'train'); one train step at full
              width and 2 layers on the
              card against a CPU copy (loss rel. 1e-3, each gradient
              leaf cosine >= 0.999); then E5-base fine-tuned at full
              width and depth (flash_min_seq 128, B 32 pairs mined from
              the slice corpus, T 128, warm-up 10, 30 steps): launch
              counts around one step (24 flash_attn, 24 + 24 backward)
              and over all 30, the loss falling and the in-batch accuracy
              not, step ms, pairs/s, share of the bf16 peak, the f32
              GEMM kernels' share of 4 traced steps (the backward
              products), peak memory, the idle share over 4 steps; the
              checkpoint served by get_embedder on the card
              (256 query vectors, cosine >= 0.99999 to the trained
              model's, tag ckpt-step_30-<digest>); the checkpoint is
              kept for phase 11;
11. routed    the routed ask and the admin verbs through the port's CLI
              (classmate_rag_tpu_torch.cli.main): a fresh index, routing
              on, E5-base at full width in the kernel configuration (the
              runtime's embedder, handed over as in phase 7), the small
              decoder (64 new tokens, temperature 0) behind route files
              for math, code and default (translation falls back to
              default); the encoder corpus (8,192 passages, 64 courses)
              loaded with `restore` from a JSONL dump, four files added
              with `add` (--subject, a code/ folder, two classified);
              32 questions in one ask_question_batch, 8 asked one at a
              time, 4 CLI asks forcing math, code, translation and
              default (launch counts reset just before the restore, read
              after the last ask: one scan a routed ask); every build
              and eviction of a decoder watched (one resident at a time,
              memory back within 5 % after each eviction); the 8 asked
              again with routing off; decisions and retrieved ids held
              against a CPU copy of the runtime on the same directory;
              then `dump`, `delete` + `vacuum`, `rebuild --model` phase
              10's checkpoint (vectors against a CPU encode of it),
              `restore` into a second directory (the same ids for every
              question, every text_sha1 kept) and
              `python -m classmate_rag_tpu_torch.cli stats` as a
              subprocess.
12. sharded   (run after phase 7, on the slice store it still holds)
              ShardedHybridIndex over the slice store with 4 logical
              shards on cuda:0 (65,536 rows a shard; the code that puts
              one shard on each of 4 cards): the 4 slice batches and
              one filtered batch (launch counts reset just before, read
              just after: 4 scans and 4 merges a batch), rows equal to
              store.hybrid_topk_batch on the card for >= 99.9 % of
              queries and every other query a near-tie (one fused score,
              branch scores within 1e-4), recall@8 against the oracle,
              warm batch latency against the single-device step in turns;
              then a 10-chunk document added, a chunk deleted, a tag
              edited and 64 embeddings updated, each refreshed from the
              store's journal with bytes placed under a quarter of the
              initial placement and answers equal to the store's; 8
              ask_question calls through a HybridRetriever on the engine
              (ids equal to one device's); then E5-base in the kernel
              configuration with 2 data-parallel replicas on cuda:0
              encodes 1,024 passages (launch counts 12/24/12 a forward a
              replica; cosine >= 0.99999 to the single-device encode);
              placed bytes and peak memory.
13. mesh      dp×tp over ("data", "model") meshes whose ranks are
              logical devices, all on cuda:0 (the code that puts one
              rank on each card; the machine has one). Decode, in phase
              9's child after its W8A8 part, from its bf16 weights:
              Llama-3.1-8B at full depth on auto_mesh_for over 4 ranks,
              (1, 4), then at 2 layers on (2, 2); phase 9's 8 prompts,
              32 greedy tokens; the first step's logits against the
              single-device forward (row cosine >= 0.999) and against an
              f32 evaluation of the same weights (within 1.25x of the
              single device's distance; see MESH_COS_MIN), the tokens
              equal to the single-device decode's up to a near-tie
              (MESH_NEAR_TIE), ms a step against the single device, each
              rank's weight bytes.
              Train, after phase 10: E5-base at full width
              (flash_min_seq 128) on training_mesh over 8 ranks, (2, 4),
              5 steps on phase 10's first batches against the
              single-device step from the same initial parameters (loss
              rel. 1e-3 each step; the first step's gradient leaves at
              cosine >= 0.999, k_b reported), launch counts around one
              step (192 flash_attn, 192 + 192 backward: 24 each a
              logical device), step ms and peak memory against one
              device, and the mesh's checkpoint restored on one device
              bit-equal to the gathered parameters. The 'kernels' line,
              part 'train', also holds the flash forward and both
              backward kernels at 3 and 6 heads (a rank's share of
              E5-base's 12 at tp 4 and 2), with padded rows, against the
              plain version (phase 2's and phase 10's bars).

14. multihost (run after phase 12) phase 3's store, saved with the
              port's persistence right after phase 3 with its 4 batches
              and their single-device results, served by 2 processes
              (--multihost-child, gloo: NCCL refuses two ranks on one
              card) × 2 shards on cuda:0 through a 4-shard
              ShardedHybridIndex over process_corpus_mesh: the 4 batches
              and one filtered batch (launch counts reset just before,
              read just after: 2 scans and 2 merges a batch a rank),
              rows equal to the single-device rows as in phase 12, equal
              on both ranks; then both ranks replay one add and one
              delete: an O(delta) refresh (0 < bytes < half the base,
              equal on both ranks, no full lexical rebuild), rows equal
              the store's own single-device step; warm batch ms beside
              phase 12's, the bytes each rank receives a batch.
15. int8      (run after phase 5) ops/quant.py's topk_int8_rescore at N
              262,144 (the slice store) and 1,048,576, d 768, Q 256,
              pool 64, k 8: the card against the port's CPU version on
              16 queries (rows equal but at near-ties within 1e-5), set
              recall@8 against topk_scan's exact top-8, its time, its
              int8 product's alone and topk_scan's at k 8 and 64 beside
              its bytes bound, peak memory.

16. bench     (run last) the port's benchmark at serving scale:
              classmate_rag_tpu_torch.bench.run_scale at 1,000,000 chunks
              (bench.py's corpus and oracle, seed 42, d 768, terms 128 a
              chunk; 1,024 queries in batches of 256, 4 workers, 4 timed
              passes of >= 2 s; 64 oracle queries; the 7 filter cases at
              16 queries; launch counts reset just before, read just
              after): the store takes the approx route by its size,
              recall@8 >= 0.99 against the oracle and in every filter
              case (no row outside its subset; the two empty cases all
              dead slots), 1 scan + 1 merge a timed batch, the wall QPS
              at most 1.05x the device ceiling; the seconds of each part,
              the store's device bytes.
17. tools     (run after phase 10, on what earlier phases hold) each of
              the 14 tools of classmate_rag_tpu_torch/tools/ on the card,
              one 'tools' line each (its report, its launch counts reset
              just before and read just after, the card's name and power
              limit): on phase 8's index (200,000 chunks) in fresh
              processes (--tools-child), probe_cold_start (after its add,
              1 full upload and no split build), then
              probe_first_dispatch, bench_ask (9 asks, 9 scans),
              bench_serve (32 clients, 3 s warm-up, a 5 s window, 4
              /add + /delete rounds: no error, every round 200, the
              served rows equal a reload's) and probe_fold_1m (the
              entries plus its two); build_product_index at 20,000 rows;
              on phase 3's store, bench_hybrid_profile (the step's
              stage within 15 % of device_seconds_per_batch) and
              bench_scan; with the E5-base encoder in the kernel
              configuration, bench_embed, bench_encoder_roofline and
              bench_ingest (a runtime it serves; the three encoder
              kernels launched); bench_decode (the 768-wide decoder); on
              the bench corpus at 200,000 chunks, probe_mutation_sync (no
              full upload or split build over its 3 trials) and
              debug_recall_1m (16 queries, n_miss reported).
18. graft     (run after phase 12) the port's driver entry points
              (classmate_rag_tpu_torch/graft_entry.py): entry() on the
              card (E5-base, B 8, T 128; no kernel on its path) against
              the same model on the CPU (per-row cosine >= 0.9999), then
              dryrun_multichip(4) over 4 logical ranks of cuda:0 (the
              cards, where a machine has 4) with every stage's assertion:
              (a) a dp×tp train step, (b) and (c) the sharded hybrid step
              with either BM25 equal to one device's, (d) dp×tp greedy
              decode, (e) the product path's sharded runtime with a
              delete seen through the journal, (f) data-parallel encode
              (launch counts reset just before, read just after:
              topk_scan and topk_merge in b, c and e); seconds a stage;
              no environment variable or runtime left behind.

Then the kernels line ({"kernels": [...]}), the nvidia-smi line, and
last {"ok": true, "device": {...}}. A kernel's ``ms`` (and the plain
and library times beside it) is CUDA-event time over 20 calls in a row
after warm-up, divided by 20; ``ms_single`` is the median of 20 calls
timed one by one, host launch overhead included; ``device_ms`` the
device time of the kernels one call launches, from torch.profiler over
20 calls: the card's busy time where the host cannot keep 20 short
calls back to back. The trace must hold one kernel of the port per
launch counted (a trace short of kernels is run again), two whole
traces must agree within 5 %, and no device time may fall under 0.95
of the bound. ``queued_ms`` (and ``library_device_ms``) is CUDA-event
time over 20 calls the host queued while a spin kernel held the card.
``--profile PATH`` also traces one warm batch (table in PATH) and one
encoder forward (table in PATH_encoder).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
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
CPU_BATCHES = 4        # of them held against the CPU
K = 8
POOL = 24
RRF_K = 60
N_ORACLE = 64
RECALL_MIN = 0.99
ROWS_AGREE_MIN = 0.999
STEP_TOL = 1e-4        # GPU vs CPU fused-step scores (f32, other sum order)
PACKED_TOL = 1e-6      # packed vs unpacked step on the card (the same ops
                       # on the same values)
BOUND_FLOOR = 0.95     # a kernel's device time may not fall under this x bound
KERNEL_TOL = 1e-5      # kernel vs plain scores (f32 sums of bf16 products)
BM25_TOL = 4e-5        # bm25_sat_gemm vs plain, over the row's |w| @ sat
# The 1M cell's BM25 core as a hybrid-b256 batch of msmarco-1m makes it
# (the median of its 64 pool batches): queries, rows, live and padded head
# slots and tail terms, live tail segments and their postings, the
# segment cap.
BM25_SHAPE = {"b": 256, "n": 1 << 20, "h_live": 459, "h": 512,
              "t_live": 478, "t": 512, "u_live": 602, "postings": 142_106,
              "r_cap": 512}
LN_TOL = 1e-5          # residual_ln kernel vs plain (f32, other sum order)
ATTN_TOL = 1e-2        # flash_attn vs plain for |v| <= 1 (bf16 weights)
ENC_COS_MIN = 0.9999   # encoder rows: slice vs default config, card vs CPU
MODEL_NAME = "intfloat/multilingual-e5-base"
ENC_CHUNKS = 8192      # passages the encoder phases ingest
N_LONG = 32            # long texts (> 256 tokens: bucket 512)
N_QUESTIONS = 256
CPU_SUBSET = (16, 8, 4)  # queries, passages, long texts the CPU copy encodes
PRODUCT_TERMS = 256    # BM25_TERMS_PER_CHUNK of the product phase
CHUNKS_PER_DOC = 10
PRODUCT_ASKS = 32
PRODUCT_CPU_ASKS = 8   # asks held against a store loaded anew on the CPU
BACKWARD_KERNELS = ("flash_attn_bwd_delta", "flash_attn_bwd")  # training
# Launched only where a batch's rows do not fill the card (fewer than
# its SMs): row_select then cuts each row into slices and merges them.
SPLIT_ONLY_KERNELS = ("row_select_merge",)
# Launched only on the approx route (stores of 500,000 rows or more): the
# smaller stores of the ingest+ask and routed phases never launch it.
APPROX_ONLY_KERNELS = ("bm25_sat_gemm",)



class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def peaks_for(name: str):
    """The card's published peaks from the port's table
    (utils/profiling.py): (its key, (memory bytes/s, bf16 tensor-core
    FLOP/s, f32 FLOP/s outside the tensor cores, int8 tensor-core
    ops/s))."""
    from classmate_rag_tpu_torch.utils.profiling import (
        _detect_chip,
        device_peaks,
    )

    key = _detect_chip(name)
    if key == "cpu":
        raise SmokeFailure(f"no published peaks for card {name!r}")
    bf16_tflops, gbs, f32_tflops, int8_tops = device_peaks(key)
    return key, (gbs * 1e9, bf16_tflops * 1e12, f32_tflops * 1e12,
                 int8_tops * 1e12)


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
    # k equal to the corpus's rows, at d 64: one shard of the graft
    # phase's sharded steps (16 rows, 2 queries, k 16).
    errs.append(compare_topk(ttopk, unit(16, 64).to(torch.bfloat16).cuda(),
                             unit(2, 64).cuda(),
                             torch.zeros(16, device="cuda"), 16))
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
        lambda: ttopk.masked_topk(emb, q, bias, k), ttopk.LAUNCHES,
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
        ttopk.LAUNCHES,
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


def bm25_shaped(g, b, n):
    """[b, n] f32 scores shaped like BM25's: ~0.1 % of the entries
    positive, from 36 levels (ties), the rest exact zeros."""
    live = torch.rand(b, n, device="cuda", generator=g) < 1e-3
    level = torch.randint(1, 37, (b, n), device="cuda", generator=g,
                          dtype=torch.int32).float() * 0.4375
    return torch.where(live, level, 0.0)


def row_select_same(ttopk, scores, bias, k, what) -> float:
    """row_select vs the stable sort it replaces, on the card: rows equal,
    values equal bit for bit. Returns the share of entries the kernel's
    filter let through."""
    got_v, got_r, admitted = ttopk.row_select(scores, bias, k)
    want_v, want_r = ttopk.stable_topk(scores + bias[None, :], k)
    torch.cuda.synchronize()
    check(got_r.shape == want_r.shape and torch.equal(got_r, want_r)
          and torch.equal(got_v.view(torch.int32), want_v.view(torch.int32)),
          f"row_select {what}: differs from the stable sort")
    return admitted.item() / scores.numel()


def row_select_rows(ttopk, peaks):
    """row_select at the two cells' shapes ([256, 1,048,576] k 64, the
    approx route's pool; [256, 262,144] k 8, the exact route): both
    kernel rows first, their device time from held-stream CUDA events
    (the profiler dropped 2 of 20 kernels in 7 of 8 traces of the 262,144
    row, even in a young process), then k 8, 64, 128 on each, bit-equal to
    ``stable_topk`` of the biased scores; then its edges: k 257 refused
    before a launch, fewer live rows than k, every ninth bias NEG_INF,
    all masked, N < k, N not a multiple of the 4-column load, B 1 and 4
    (the slice-and-merge grid). Returns the two kernel rows and the
    edges' admitted shares."""
    g = torch.Generator(device="cuda").manual_seed(11)
    shapes = ((1 << 20, 64), (1 << 18, 8))
    scores = {n: bm25_shaped(g, BATCH, n) for n, _k in shapes}
    zeros = {n: torch.zeros(n, device="cuda") for n, _k in shapes}
    rows, edges = [], {}
    for n, k_main in shapes:
        s, bias = scores[n], zeros[n]
        row = kernel_row(
            "row_select", "row_select.cu",
            "none (XLA's lax.top_k / approx_max_k, "
            "classmate_rag_tpu/ops/hybrid_step.py)",
            {"B": BATCH, "N": n, "k": k_main}, 0.0,
            lambda: ttopk.row_select(s, bias, k_main), ttopk.LAUNCHES,
            time_ms(lambda: ttopk.stable_topk(s + bias[None, :], k_main),
                    reps=5),
            lambda: ttopk.stable_topk(s + bias[None, :], k_main),
            BATCH * n * 4 + n * 4 + BATCH * k_main * 12, 0.0,
            peaks[0], peaks[1], held=True)
        rows.append(row)
    for (n, k_main), row in zip(shapes, rows):
        s, bias = scores[n], zeros[n]
        row["admitted_share"] = {
            k: row_select_same(ttopk, s, bias, k, f"N {n} k {k}")
            for k in (8, 64, 128)}
        masked = bias.clone()
        masked[::9] = ttopk.NEG_INF
        edges[f"ninth_masked_{n}"] = row_select_same(
            ttopk, s, masked, 64, f"N {n}, every ninth masked")
        for b in (1, 4):
            edges[f"b{b}_{n}"] = row_select_same(
                ttopk, s[:b].contiguous(), masked, k_main, f"B {b}, N {n}")
    n = 1 << 18
    s = scores[n]
    before = dict(ttopk.LAUNCHES)
    try:
        ttopk.row_select(s, zeros[n], 257)
        check(False, "row_select: k 257 was taken")
    except ValueError:
        pass
    check(ttopk.LAUNCHES == before, "row_select: k 257 launched")
    few = torch.full((n,), ttopk.NEG_INF, device="cuda")
    few[1000:1040] = 0.0                            # 40 live rows, k 64
    edges["fewer_live_than_k"] = row_select_same(
        ttopk, s, few, 64, "40 live rows, k 64")
    edges["all_masked"] = row_select_same(
        ttopk, s, torch.full((n,), ttopk.NEG_INF, device="cuda"), 64,
        "all masked")
    edges["n_below_k"] = row_select_same(
        ttopk, s[:, :100].contiguous(), zeros[n][:100].contiguous(), 128,
        "N 100, k 128")
    for n_odd in (n + 77, 5077):
        odd = bm25_shaped(g, BATCH, n_odd)
        odd_bias = torch.zeros(n_odd, device="cuda")
        odd_bias[::9] = ttopk.NEG_INF
        edges[f"n_{n_odd}"] = row_select_same(
            ttopk, odd, odd_bias, 64, f"N {n_odd}")
        edges[f"b4_n_{n_odd}"] = row_select_same(
            ttopk, odd[:4].contiguous(), odd_bias, 64, f"B 4, N {n_odd}")
    return rows, edges


def row_select_child() -> int:
    """Phase 2's row_select part in its own young process: one 'kernels'
    line, part 'row_select'."""
    from classmate_rag_tpu_torch.ops import topk as ttopk

    rows, edges = row_select_rows(
        ttopk, peaks_for(torch.cuda.get_device_name(0))[1])
    emit({"phase": "kernels", "part": "row_select", "kernels": rows,
          "edges_admitted_share": edges})
    return 0


def row_select_phase() -> list:
    """Run the row_select child and relay its line; returns its rows."""
    cmd = [sys.executable, str(Path(__file__).resolve()),
           "--row-select-child"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    for line in lines:
        emit(line)
    check(proc.returncode == 0,
          f"row_select child failed (rc={proc.returncode}):\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    rows = [r for ln in lines if ln.get("part") == "row_select"
            for r in ln["kernels"]]
    check(len(rows) == 2, "row_select child: its kernel rows are missing")
    return rows


def bm25_tail_windows(rng, n, t_live, u_live, postings, r_cap):
    """Term-sorted tail postings over ``n`` rows: ``t_live`` terms in
    ``u_live`` windows of at most ``r_cap`` entries, ``postings`` entries
    in all (each window at least one; tf 1 + Poisson(0.05), a rare word's
    count in a passage), and the window table padded as
    ``split_query_arrays`` pads it. Returns numpy arrays (post_rows,
    post_tfs, u_starts, u_lens, u_cols, t_tids) padded to powers of two."""
    lens = np.ones(u_live, np.int64)
    extra = max(postings - u_live, 0)
    lens += rng.multinomial(extra, np.full(u_live, 1.0 / u_live))
    lens = np.minimum(lens, r_cap)
    owner = np.sort(np.concatenate([np.arange(t_live),
                                    rng.integers(0, t_live,
                                                 u_live - t_live)]))
    rows_all, starts, pos = [], [], 0
    for j in range(t_live):
        segs = np.flatnonzero(owner == j)
        m = int(lens[segs].sum())
        rows_all.append(np.sort(rng.choice(n, size=m, replace=False)))
        for s in segs:
            starts.append(pos)
            pos += int(lens[s])
    size = pos + r_cap + 64
    post_rows = np.zeros(size, np.int32)
    post_rows[:pos] = np.concatenate(rows_all)
    post_tfs = np.zeros(size, np.uint8)
    post_tfs[:pos] = 1 + rng.poisson(0.05, size=pos)
    pad = lambda k: max(8, 1 << int(np.ceil(np.log2(max(k, 1)))))
    u = pad(u_live)
    u_starts = np.zeros(u, np.int32)
    u_starts[:u_live] = starts
    u_lens = np.zeros(u, np.int32)
    u_lens[:u_live] = lens
    u_cols = np.full(u, -1, np.int32)
    u_cols[:u_live] = owner
    t_tids = np.full(pad(t_live), -1, np.int32)
    t_tids[:t_live] = np.arange(t_live)
    return post_rows, post_tfs, u_starts, u_lens, u_cols, t_tids


def bm25_head_rows(rng, g, h_live, n, words=56, vocab=200_000, head=3584):
    """A head matrix [h_live, n] u8 shaped like the 1M cell's: slot k holds
    a word of Zipf rank r_k (the distinct head ranks, <= ``head``, that
    Zipf draws of query words reach first), in a row with probability
    1 - exp(-lam_k), lam_k = words / (H_vocab r_k), H_vocab the harmonic
    number of ``vocab``; its tf there 1 + Poisson(lam_k / 2)."""
    h_vocab = float(np.sum(1.0 / np.arange(1, vocab + 1)))
    ranks = []
    while len(ranks) < h_live:
        for r in rng.zipf(1.0001, size=4 * h_live):
            if r <= head and r not in ranks:
                ranks.append(int(r))
                if len(ranks) == h_live:
                    break
    lam = torch.tensor(words / (h_vocab * np.asarray(ranks, np.float64)),
                       dtype=torch.float32, device="cuda")
    rows = torch.empty((h_live, n), dtype=torch.uint8, device="cuda")
    for i in range(0, h_live, 64):
        lk = lam[i:i + 64, None].expand(-1, n)
        live = torch.rand(lk.shape, device="cuda", generator=g) < (
            1.0 - torch.exp(-lk))
        tf = 1.0 + torch.poisson(lk / 2.0, generator=g)
        rows[i:i + 64] = torch.where(live, tf.clamp(max=255), 0).to(
            torch.uint8)
    return rows


def bm25_core_rows(peaks):
    """bm25_sat_gemm at the 1M cell's shapes (BM25_SHAPE): a head matrix
    from ``bm25_head_rows`` (Zipf words at its densities and tf), the
    tail's windows, row lengths 12-100, every row kept, random weights.
    Checks the kernel against its plain version
    (``bm25_core.sat_gemm_reference``, within BM25_TOL of |w| @ sat) and
    times it beside its bound (the live head slots' u8 rows and the tail's
    postings read once, the rows' length terms and keep flags, the f32
    scores written once; 2 B FLOP a head tf byte and a posting), the plain
    version and ``library_ms``, a bf16 ``torch.matmul`` of the head's
    ready operands (the yardstick only: the port never calls it); its
    device time from held-stream CUDA events. Also times the tail's
    posting list (``bm25_core.tail_postings``) and the whole core from the
    step's arrays (``bm25_core.fast_scores``'s weights, postings and
    product). Returns the kernel row and the extras."""
    from classmate_rag_tpu_torch.ops import bm25_core

    sh = BM25_SHAPE
    b, n, r_cap = sh["b"], sh["n"], sh["r_cap"]
    h_live, h, t_live, t = sh["h_live"], sh["h"], sh["t_live"], sh["t"]
    rng = np.random.default_rng(24)
    g = torch.Generator(device="cuda").manual_seed(24)
    tf_head = torch.zeros((h + 8, n), dtype=torch.uint8, device="cuda")
    perm = rng.permutation(h + 8)[:h_live]
    tf_head[torch.from_numpy(perm).to("cuda")] = bm25_head_rows(
        rng, g, h_live, n)
    h_slots = np.full(h, -1, np.int32)
    h_slots[:h_live] = perm
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to("cuda")
    post_rows, post_tfs, u_starts, u_lens, u_cols, t_tids = map(
        up, bm25_tail_windows(rng, n, t_live, sh["u_live"], sh["postings"],
                              r_cap))
    h_slots = up(h_slots)
    doc_len = up(rng.integers(12, 101, size=n).astype(np.float32))
    keep = torch.ones(n, dtype=torch.bool, device="cuda")
    avgdl = doc_len.mean().reshape(())
    w = torch.rand(b, h + t, device="cuda", generator=g) * 8.0
    w[:, h_live:h] = 0.0
    w[:, h + t_live:] = 0.0
    w = w.to(torch.bfloat16)
    win = (post_rows, post_tfs, u_starts, u_lens, u_cols)
    tail = bm25_core.tail_postings(*win, n, r_cap)
    args = (tf_head, h_slots, tail, doc_len, keep, avgdl, w)
    got = bm25_core.sat_gemm(*args)
    want = bm25_core.sat_gemm_reference(*args)
    rows = torch.cat((
        tf_head[h_slots.clamp(min=0).long()] * (h_slots >= 0)[:, None],
        bm25_core.tail_matrix(tail, t, n)), 0)
    sat = bm25_core.sat_operand(rows, doc_len, keep, avgdl)
    del rows
    scale = w.float().abs() @ sat.float()
    err = float(((got - want).abs() / (scale + 1e-6)).max())
    check(err <= BM25_TOL, f"bm25_sat_gemm: {err} of |w| @ sat from plain")
    del got, want, scale
    torch.cuda.empty_cache()
    live = int(tail.off[-1])
    check(live == int(u_lens.sum()), f"bm25_sat_gemm: {live} live tail "
          f"postings, {int(u_lens.sum())} made")
    sat_head = sat[:h].contiguous()
    row = kernel_row(
        "bm25_sat_gemm", "bm25_sat_gemm.cu",
        "none (XLA's bf16 einsum, classmate_rag_tpu/index/lexical.py "
        "bm25_split_score_core)",
        {"B": b, "N": n, "H": h, "H_live": h_live, "T": t, "T_live": t_live,
         "tail_postings": live}, err,
        lambda: bm25_core.sat_gemm(*args), bm25_core.LAUNCHES,
        time_ms(lambda: bm25_core.sat_gemm_reference(*args), reps=3,
                warmup=1),
        lambda: torch.matmul(w[:, :h], sat_head),
        h_live * n + live * 12 + (n // 128 + 1) * 4 + n * 5 + b * n * 4,
        2 * b * (h_live * n + live), peaks[0], peaks[1], held=True)
    # Vocabulary ids: head terms 0 .. h_live - 1, tail terms h + j.
    ids = np.concatenate([np.arange(h_live), h + np.arange(t_live)])
    q_tids = up(rng.choice(ids, size=(b, 8)).astype(np.int32))
    q_counts = torch.ones(b, 8, device="cuda")
    idf = torch.rand(h + t + 1, device="cuda", generator=g) + 0.5
    h_tids = up(np.where(np.arange(h) < h_live, np.arange(h), -1)
                .astype(np.int32))
    t_ids = torch.where(t_tids >= 0, t_tids + h, -1).int()
    core = lambda: bm25_core.fast_scores(
        tf_head, post_rows, post_tfs, doc_len, keep, idf, avgdl, h_slots,
        h_tids, u_starts, u_lens, u_cols, t_ids, q_tids, q_counts,
        vocab_pad=h + t, r_cap=r_cap)
    extras = {
        "tail_postings_ms": time_ms(
            lambda: bm25_core.tail_postings(*win, n, r_cap)),
        "tail_postings_queued_ms": queued_ms(
            lambda: bm25_core.tail_postings(*win, n, r_cap)),
        "fast_scores_ms": time_ms(core),
        "fast_scores_queued_ms": queued_ms(core),
        "operand_nonzero_share": float((sat != 0).float().mean()),
        "shape": sh,
    }
    return row, extras


def bm25_core_child() -> int:
    """Phase 2's bm25_sat_gemm part in its own young process: one
    'kernels' line, part 'bm25_core'."""
    row, extras = bm25_core_rows(peaks_for(torch.cuda.get_device_name(0))[1])
    emit({"phase": "kernels", "part": "bm25_core", "kernels": [row],
          **extras, "nvidia_smi": smi_line()})
    return 0


def bm25_core_phase() -> dict:
    """Run the bm25_sat_gemm child and relay its line; returns its row."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--bm25-core-child"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    for line in lines:
        emit(line)
    check(proc.returncode == 0,
          f"bm25_core child failed (rc={proc.returncode}):\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    rows = [r for ln in lines if ln.get("part") == "bm25_core"
            for r in ln["kernels"]]
    check(len(rows) == 1, "bm25_core child: its kernel row is missing")
    return rows[0]


# The port's kernels by the names the profiler gives them.
PORT_KERNELS = ("topk_scan_kernel", "topk_merge_kernel", "bias_gelu_kernel",
                "residual_ln_kernel", "flash_attn_kernel",
                "flash_attn_bwd_kernel", "flash_attn_bwd_delta_kernel",
                "row_select_kernel", "row_select_merge_kernel",
                "bm25_sat_gemm_kernel")
TRACES = 4          # profiler sessions tried for one whole trace
TRACE_AGREE = 0.05  # two whole traces' device times agree within this


def cuda_events(events) -> list:
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in events if e.device_type == cuda]


def busy_us(events) -> float:
    return sum(e.self_device_time_total for e in cuda_events(events))


def traced(fn, launches, cpu: bool = False, tries: int = TRACES,
           agree: bool = False):
    """A torch.profiler trace of one run of ``fn`` that holds every
    kernel of the port it launched: one per launch counted in
    ``launches`` (a wrapper's LAUNCHES table) during the session. In a
    long-lived process the profiler loses kernels in some sessions,
    more the older the process, and now and then cuts a kernel's time
    short (tools/torch_profiler_drops.py): a session short of kernels
    is run again, up to ``tries`` in all, and with ``agree`` the trace
    taken is the first whole one whose device time agrees within
    TRACE_AGREE with an earlier whole one's (a trace cut short agrees
    with none, and does not hide a later pair that agrees). The run
    fails if there is none. Returns the trace's ``key_averages()`` and
    the number of sessions run."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    whole = []      # the device times of the whole traces so far
    for n in range(1, tries + 1):
        before = sum(launches.values())
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        want = sum(launches.values()) - before
        events = prof.key_averages()
        seen = sum(e.count for e in cuda_events(events)
                   if any(k in e.key for k in PORT_KERNELS))
        if not (want > 0 and seen == want):
            continue
        if not agree:
            return events, n
        busy = busy_us(events)
        if any(abs(busy - b) <= TRACE_AGREE * b for b in whole):
            return events, n
        whole.append(busy)
    raise SmokeFailure(f"{tries} traces, none whole{' twice' * agree}: the "
                       f"last holds {seen} of the port's kernels, {want} "
                       f"launched; whole traces' device us {whole}")


def device_ms(fn, launches, reps: int = 20):
    """The card's busy time for one call of ``fn``: the device time of
    every kernel it launches over ``reps`` calls, from a trace that
    ``traced`` found whole twice (``launches`` is the wrapper's LAUNCHES
    table), over ``reps``; and the number of traces it took. Unlike
    ``time_ms`` it leaves out the gaps where the card waits for the
    host between short calls."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            fn()

    events, n = traced(calls, launches, tries=2 * TRACES, agree=True)
    return busy_us(events) / reps / 1e3, n


def queued_ms(fn, reps: int = 20):
    """The card's time for one call of ``fn`` with the host out of its
    way: a spin kernel holds the stream while the host queues ``reps``
    calls between two CUDA events, so the card runs them back to back
    (small gaps between kernels included); over ``reps``. For a library
    call, whose kernels no count checks in a trace. None where the host
    never gets ahead of the card (a call that waits for it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    for spin in (4, 16, 64):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin * host_s * 2e9))   # cycles, ~1-2 GHz
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()    # the card had not reached the calls
        end.synchronize()
        if held:
            return start.elapsed_time(end) / reps
    return None


def kernel_row(name, source, replaces, shape, err, fn, launches, plain_ms,
               library, bytes_moved, ops, bw, op_peak, held=False):
    """One kernel's numbers: ``fn`` calls its wrapper, which counts its
    launches in ``launches``; ``library`` the one PyTorch call that
    computes the same function (None where there is none); the bound is the larger of bytes over
    the memory rate and operations over the peak rate of their type. No
    device time may fall under the bound. With ``held`` the device time
    is ``queued_ms``'s (CUDA events around calls queued behind a spin),
    not a whole profiler trace's: for a kernel whose traces the profiler
    drops kernels from."""
    t_bytes = bytes_moved / bw * 1e3
    t_ops = ops / op_peak * 1e3
    dev, traces = (queued_ms(fn), 0) if held else device_ms(fn, launches)
    check(dev is not None, f"{name} {shape}: no held-stream time (the host "
          "never got ahead of the card)")
    row = {
        "name": name,
        "route": "cuda",
        "source": f"classmate_rag_tpu_torch/ops/csrc/{source}",
        "replaces": replaces,
        "shape": shape,
        "max_abs_err": err,
        "ms": time_ms(fn),
        "ms_single": time_single_ms(fn),
        "plain_ms": plain_ms,
        "library_ms": time_ms(library) if library else None,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": bytes_moved,
        "flops": ops,
        "device_ms": dev,
        "device_traces": traces,
        "queued_ms": queued_ms(fn),
        "library_device_ms": queued_ms(library) if library else None,
    }
    check(row["device_ms"] >= BOUND_FLOOR * row["bound_ms"],
          f"{name} {shape}: device time {row['device_ms']} ms under its "
          f"bound {row['bound_ms']} ms")
    return row


def bf16_spacing(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    _m, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


def epilogue_kernels(tef, peaks):
    """bias_gelu and residual_ln at the encoder's shapes (B·T = 16,384
    tokens of E5-base) and at ragged ones."""
    import torch.nn.functional as F

    bw, _bf16_peak, f32_peak, _int8_peak = peaks
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
        lambda: tef.bias_gelu(y, b), tef.LAUNCHES,
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
        lambda: tef.residual_ln(*args, eps=1e-5), tef.LAUNCHES,
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

    bw, bf16_peak, _f32, _int8_peak = peaks
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
            lambda: tatt.flash_attention(q, k, v, mask, 0.125), tatt.LAUNCHES,
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


def step_on_cpu(store, q, terms, **knobs):
    """The packed fused step on CPU copies of the same device inputs."""
    from classmate_rag_tpu_torch.ops.hybrid_step import (
        hybrid_query_step_split_packed,
    )

    args, kwargs = store.hybrid_step_inputs(q, terms, None, **knobs)
    cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    return hybrid_query_step_split_packed(*cpu_args, **kwargs)


def packed_vs_unpacked(store, q, terms, **knobs):
    """The store's packed step and the unpacked step on views of the same
    packed buffer, on the card: (rows equal, max score diff)."""
    from classmate_rag_tpu_torch.ops.hybrid_step import (
        hybrid_query_step_split,
        hybrid_query_step_split_packed,
        unpack_query_arrays,
    )

    args, kwargs = store.hybrid_step_inputs(q, terms, None, **knobs)
    statics = {s: kwargs.pop(s) for s in ("h", "u", "t", "b", "m")}
    qa = unpack_query_arrays(args[8], **statics)
    want = hybrid_query_step_split(
        *args[:8], *(qa[c] for c in (
            "h_slots", "h_tids", "u_starts", "u_lens", "u_cols", "t_tids",
            "q_tids", "q_counts", "has_terms")), *args[9:], **kwargs)
    got = hybrid_query_step_split_packed(*args, **statics, **kwargs)
    rows_equal = bool(torch.equal(got.rows, want.rows))
    worst = 0.0
    for name in ("fused", "vec_dist", "bm25_score"):
        a, b = getattr(got, name).cpu(), getattr(want, name).cpu()
        check(bool((torch.isnan(a) == torch.isnan(b)).all()),
              f"packed vs unpacked: {name} NaN pattern differs")
        ok = ~torch.isnan(a)
        if ok.any():
            worst = max(worst, (a[ok] - b[ok]).abs().max().item())
    return rows_equal, worst


def h2d_per_batch(fn, counts, tries: int = 2 * TRACES) -> dict:
    """The host-to-device copies of one run of ``fn``: the ``Memcpy
    HtoD`` events of a torch.profiler trace that holds every kernel of
    the port the run launched (``counts``: a ``Counts``; a trace short
    of them is taken again, up to ``tries``)."""
    from classmate_rag_tpu_torch.utils.profiling import (
        chrome_events, h2d_copies,
    )

    for _ in range(tries):
        before = sum(counts.read().values())
        events = chrome_events(fn)
        want = sum(counts.read().values()) - before
        seen = sum(1 for e in events if e.get("cat") == "kernel"
                   and any(k in e.get("name", "") for k in PORT_KERNELS))
        if want > 0 and seen == want:
            return h2d_copies(events)
    raise SmokeFailure(f"{tries} traces, none whole: the last holds "
                       f"{seen} of the port's kernels, {want} launched")


def waits_for_stream(fn, spin_cycles: int = 100_000_000) -> dict:
    """Whether ``fn()`` made the host wait for work queued before it: a
    spin kernel (~50-100 ms) holds the stream, and the card is checked
    the moment ``fn`` returns. {"waited", "host_ms"}."""
    torch.cuda.synchronize()
    torch.cuda._sleep(spin_cycles)
    after_spin = torch.cuda.Event()
    after_spin.record()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    waited = after_spin.query()
    torch.cuda.synchronize()
    return {"waited": waited, "host_ms": host_ms}


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
    return profile_summary(events, wall_ms, phase)


def profile_summary(events, wall_ms: float, phase: str) -> dict:
    """Device busy time, idle share of ``wall_ms`` and the top ops and
    kernels of a profiler's ``key_averages()``."""
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
    default one, on the card, and the slice configuration on the CPU.
    Returns the slice encoder, its launch counts and the parameter tree
    (numpy, random init from the model name; phase 11 serves it)."""
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
            "topk_merge": 0, "row_select": 0, "row_select_merge": 0,
            "bm25_sat_gemm": 0, **{k: 0 for k in BACKWARD_KERNELS}}
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
    return enc, launches, tree


def ingest_ask_phase(enc, docs, rng, counts, knobs):
    """Ingest E5 passage vectors, then answer questions through the
    retriever with the encoder's query tensor handed over on the card."""
    from classmate_rag_tpu_torch.embeddings.cache import CachingEmbedder
    from classmate_rag_tpu_torch.index.catalog import Catalog, CatalogEntry
    from classmate_rag_tpu_torch.index.lexical import tokenize_py
    from classmate_rag_tpu_torch.index.store import IndexStore
    from classmate_rag_tpu_torch.retrieval.hybrid import HybridRetriever
    from classmate_rag_tpu_torch.utils.lang import detect_lang_tag
    from classmate_rag_tpu_torch.utils.profiling import HostToDeviceOps

    texts, _longs, questions = encoder_texts(rng, docs)
    ids = [f"e{i}" for i in range(ENC_CHUNKS)]
    with tempfile.TemporaryDirectory() as cache_dir:
        cached = CachingEmbedder(enc, cache_dir=cache_dir)
        store = IndexStore(DIM, slab_rows=4096, terms_per_chunk=128)
        catalog = Catalog.load_or_create(Path(cache_dir) / "bm25")
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
            if name in BACKWARD_KERNELS + APPROX_ONLY_KERNELS:
                check(n == 0, f"ingest+ask: {name} was launched")
            elif name not in SPLIT_ONLY_KERNELS:
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
        # The query tensor is on the card: the packed metadata is the
        # step's one upload. Counted by the ops that copy (phase 3 holds
        # that count equal to its trace's): at this age of the process
        # the profiler loses every kernel of a step's trace.
        with HostToDeviceOps() as h2d:
            step(q_dev, terms, None, **knobs).rows.cpu()
        check(h2d.copies == 1, f"ingest+ask: {h2d.copies} host-to-device "
              f"copies a step, not 1")

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
          "h2d_copies_per_batch": h2d.copies,
          "h2d_bytes_per_batch": h2d.bytes, "h2d_counted_by": "copy ops",
          "warm_batch_ms": statistics.median(walls),
          "batch_wall_ms": walls, "first_ask_s": t_first,
          "ingest_s": {"encode": t_encode, "encode_and_upsert": t_ingest},
          "cache_files": cache_files})
    return launches


# ---------------------------------------------------------------------------
# Corpus-sharded serving (phase 12): the slice store behind 4 logical
# shards on the one card, and the data-parallel encoder
# ---------------------------------------------------------------------------

SHARDS = 4             # logical shards of phase 12, all on SHARD_DEVICE
SHARD_DEVICE = "cuda:0"
DP = 2                 # data-parallel encoder replicas, both on cuda:0
DP_PASSAGES = 1024
DP_COS_MIN = 0.99999   # data-parallel vs single-device encode, each row
FUSED_TIE = 1e-6       # two picks at one RRF rank hold one fused score


def compare_engine(got, want) -> dict:
    """The sharded engine's batch against the single-device step's:
    queries with equal rows, the largest score difference over them, and
    each query that differs with whether every differing pick is a
    near-tie (one fused score, vector distance and BM25 score within
    STEP_TOL: two rows whose branch scores part by rounding)."""
    g = [t.cpu().numpy() for t in got]
    w = [t.cpu().numpy() for t in want]
    same = (g[0] == w[0]).all(axis=1)
    worst = 0.0
    for a, b in zip(g[1:], w[1:]):
        ok = same[:, None] & ~np.isnan(a) & ~np.isnan(b)
        check(bool(((np.isnan(a) == np.isnan(b)) | ~same[:, None]).all()),
              "sharded: a branch returned a row on one side only")
        if ok.any():
            worst = max(worst, float(np.abs(a - b)[ok].max()))
    differing = []
    for q in np.nonzero(~same)[0]:
        cols = np.nonzero(g[0][q] != w[0][q])[0]
        tie = bool(
            (np.abs(g[1][q, cols] - w[1][q, cols]) <= FUSED_TIE).all()
            and all(np.allclose(g[i][q, cols], w[i][q, cols], equal_nan=True,
                                rtol=STEP_TOL, atol=STEP_TOL)
                    for i in (2, 3)))
        differing.append({"query": int(q), "cols": cols.tolist(),
                          "engine": g[0][q, cols].tolist(),
                          "single": w[0][q, cols].tolist(),
                          "near_tie": tie})
    check(all(d["near_tie"] for d in differing),
          f"sharded: rows differ beyond a near-tie: {differing[:3]}")
    return {"rows_equal": int(same.sum()), "queries": len(same),
            "max_score_diff": worst, "differing": differing}


def sharded_phase(store, catalog, batches, oracle_sets, questions, enc,
                  tree, docs, rng, counts, knobs) -> dict:
    """The corpus-sharded engine (ShardedHybridIndex) over the slice
    store with 4 logical shards on cuda:0, then data-parallel encode."""
    from classmate_rag_tpu_torch.config import load_config
    from classmate_rag_tpu_torch.embeddings.encoder import E5Encoder
    from classmate_rag_tpu_torch.embeddings.hashing import HashingEmbedder
    from classmate_rag_tpu_torch.index.catalog import CatalogEntry
    from classmate_rag_tpu_torch.metadata import normalize_cli_metadata
    from classmate_rag_tpu_torch.parallel import (
        ShardedHybridIndex,
        corpus_mesh,
    )
    from classmate_rag_tpu_torch.pipeline.ask import ask_question
    from classmate_rag_tpu_torch.pipeline.runtime import Runtime
    from classmate_rag_tpu_torch.retrieval.hybrid import HybridRetriever

    t_phase = time.perf_counter()
    dev = torch.device(SHARD_DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = ShardedHybridIndex(store, corpus_mesh(devices=[dev] * SHARDS),
                                **knobs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    placed = engine.bytes_placed_total
    where = {"course": chunk_meta(5)["course"]}
    runs = [(b, None) for b in batches] + [(batches[0], where)]

    def ask(path, batch, w):
        q = np.stack([qv for qv, _t in batch])
        terms = [t for _q, t in batch]
        if path == "engine":
            return engine.query_batch(q, terms, w, **knobs)
        return store.hybrid_topk_batch(q, terms, w, **knobs)

    ask("engine", batches[0], None).rows.cpu()         # first use: warm
    # The main path: every count 0 just before, read just after.
    counts.reset()
    outs = [ask("engine", b, w) for b, w in runs]
    rows = [o.rows.cpu() for o in outs]
    launches = counts.read()
    for name in ("topk_scan", "topk_merge"):
        check(launches[name] == SHARDS * len(runs),
              f"sharded: {name} launches {launches[name]} != "
              f"{SHARDS * len(runs)}")
    batch_cmp = [compare_engine(o, ask("single", b, w))
                 for o, (b, w) in zip(outs, runs)]
    n_equal = sum(c["rows_equal"] for c in batch_cmp)
    n_total = sum(c["queries"] for c in batch_cmp)
    check(n_equal / n_total >= ROWS_AGREE_MIN,
          f"sharded: rows equal one device on {n_equal}/{n_total}")
    worst = max(c["max_score_diff"] for c in batch_cmp)
    check(worst <= STEP_TOL, f"sharded: scores differ by {worst}")
    got = torch.cat(rows[: len(batches)]).numpy()
    overlaps = [len({int(r) for r in got[j] if r >= 0} & want)
                / max(len(want), 1) for j, want in enumerate(oracle_sets)]
    recall = float(np.mean(overlaps))
    check(recall >= RECALL_MIN, f"sharded: recall@8 {recall}")
    filtered = rows[-1].numpy()
    check(all(chunk_meta(int(r))["course"] == where["course"]
              for r in filtered.ravel() if r >= 0),
          "sharded: the filtered batch returned another course")

    # Warm batch latency, the engine and one device in turns.
    walls = {"engine": [], "single": []}
    for b in batches:
        for path in ("single", "engine", "engine", "single"):
            t0 = time.perf_counter()
            ask(path, b, None).rows.cpu()
            walls[path].append((time.perf_counter() - t0) * 1e3)

    # Mutations through the store's journal, each refreshed O(delta).
    new_ids = [f"n{i}" for i in range(CHUNKS_PER_DOC)]
    new_docs = [docs[int(i)] for i in rng.integers(0, len(docs),
                                                   CHUNKS_PER_DOC)]
    new_emb = rng.standard_normal((CHUNKS_PER_DOC, DIM)).astype(np.float32)
    new_emb /= np.linalg.norm(new_emb, axis=1, keepdims=True)
    victim = store.ids[17]
    probe = ask("engine", [(store.emb[17].astype(np.float32), docs[17][:5])],
                None).rows.cpu().numpy()
    check(probe[0, 0] == 17, f"sharded: row 17's own vector found {probe}")
    tag_row = 23
    upd = rng.choice(len(docs), 64, replace=False)
    upd_emb = rng.standard_normal((64, DIM)).astype(np.float32)
    upd_emb /= np.linalg.norm(upd_emb, axis=1, keepdims=True)

    def add_doc():
        store.upsert(new_ids, new_emb, new_docs,
                     [chunk_meta(i) for i in range(CHUNKS_PER_DOC)])
        for cid, toks in zip(new_ids, new_docs):
            catalog.upsert(CatalogEntry(cid, " ".join(toks), toks,
                                        chunk_meta(0)))

    def delete_one():
        store.delete([victim])
        catalog.delete([victim])

    def edit_tag():
        meta = {**chunk_meta(tag_row), "tag_phase12": True}
        store.upsert([store.ids[tag_row]],
                     store.emb[tag_row:tag_row + 1].astype(np.float32),
                     [docs[tag_row]], [meta])

    def update_embeddings():
        store.upsert([store.ids[int(i)] for i in upd], upd_emb,
                     [docs[int(i)] for i in upd],
                     [chunk_meta(int(i)) for i in upd])

    mutations = {}
    for name, fn in (("add_doc", add_doc), ("delete", delete_one),
                     ("tag", edit_tag), ("embeddings", update_embeddings)):
        fn()
        t0 = time.perf_counter()
        engine.ensure_fresh()
        torch.cuda.synchronize()
        refresh_ms = (time.perf_counter() - t0) * 1e3
        moved = engine.bytes_placed_last_refresh
        check(moved < placed / 4,
              f"sharded: {name} moved {moved} B of {placed} placed")
        cmp = [compare_engine(ask("engine", b, w), ask("single", b, w))
               for b, w in ((batches[1], None), (batches[1], where))]
        check(all(c["rows_equal"] / c["queries"] >= ROWS_AGREE_MIN
                  for c in cmp), f"sharded: rows after {name}: {cmp}")
        mutations[name] = {"bytes_placed_last_refresh": moved,
                           "refresh_ms": refresh_ms,
                           "rows_equal": [c["rows_equal"] for c in cmp],
                           "max_score_diff": max(c["max_score_diff"]
                                                 for c in cmp)}
    check(engine.full_lexical_rebuilds == 0,
          "sharded: a small mutation rebuilt the whole split layout")
    probe = ask("engine", [(store.emb[17].astype(np.float32), docs[17][:5])],
                None).rows.cpu().numpy()
    check(17 not in probe, "sharded: the deleted chunk came back")

    # ask_question through a runtime whose retriever asks the engine.
    cfg = dataclasses.replace(load_config(), llm_backend="extractive")
    embedder = HashingEmbedder(DIM)
    answers = {}
    for name, sh in (("engine", engine), ("single", None)):
        ret = HybridRetriever(store, catalog, embedder, sharded=sh)
        rt = Runtime(cfg=cfg, catalog=catalog, store=store,
                     embedder=embedder, retriever=ret, sharded=sh)
        counts.reset()
        answers[name] = [ask_question(question=q,
                                      filters=normalize_cli_metadata(),
                                      runtime=rt) for q in questions]
        if name == "engine":
            ask_launches = counts.read()
    ids = {k: [[r["id"] for r in a.retrieved] for a in v]
           for k, v in answers.items()}
    check(ids["engine"] == ids["single"],
          "sharded: ask_question ids differ from one device's")
    check(ask_launches["topk_scan"] == SHARDS * len(questions),
          f"sharded: asks launched {ask_launches['topk_scan']} scans")
    engine_stats = engine.stats()
    peak = torch.cuda.max_memory_allocated()
    del engine

    # Data-parallel encode: DP replicas on cuda:0, the kernel config.
    passages = [" ".join(d) for d in docs[:DP_PASSAGES]]
    dp_enc = E5Encoder(model_name=MODEL_NAME, config=enc.config,
                       params=tree, data_parallel=DP, device=dev,
                       devices=[dev] * DP)
    check(dp_enc._dp == DP, f"data-parallel degree {dp_enc._dp}")
    dp_enc.encode_passages(passages[:64])        # first use: warm
    counts.reset()
    vecs, secs, shapes = encode_all(dp_enc, {"passages": (
        passages, "encode_passages")})
    dp_launches = counts.read()
    n_fwd = DP * len(shapes)          # every padded batch splits in DP
    n_flash = DP * sum(1 for _b, t in shapes
                       if t >= enc.config.flash_min_seq and t % 128 == 0)
    n_layers = enc.config.layers
    want = {"bias_gelu": n_layers * n_fwd, "residual_ln": 2 * n_layers * n_fwd,
            "flash_attn": n_layers * n_flash}
    check(all(dp_launches[k] == v for k, v in want.items()),
          f"data-parallel launches {dp_launches} != {want}")
    single, single_s, _ = encode_all(enc, {"passages": (
        passages, "encode_passages")})
    cos = row_cos(vecs["passages"], single["passages"])
    check(cos >= DP_COS_MIN, f"data-parallel cosine {cos}")
    del dp_enc
    torch.cuda.empty_cache()

    line = {
        "phase": "sharded", "shards": SHARDS, "devices": [str(dev)] * SHARDS,
        "chunks": CHUNKS, "capacity": store.capacity, "batch": BATCH,
        "batches": len(runs), "filter": where, "launches": launches,
        "rows_equal_one_device": [n_equal, n_total],
        "differing": [d for c in batch_cmp for d in c["differing"]],
        "max_score_diff": worst, "recall_at_8": recall,
        "n_oracle": len(oracle_sets),
        "batch_wall_ms": walls,
        "warm_batch_ms": {k: statistics.median(v) for k, v in walls.items()},
        "build_s": build_s, "bytes_placed_initial": placed,
        "bytes_placed_total": engine_stats["bytes_placed_total"],
        "mutations": mutations, "asks": len(questions),
        "ask_ids_equal": True, "ask_launches": ask_launches,
        "stats": engine_stats, "max_memory_allocated": peak,
        "data_parallel": {"replicas": DP, "passages": DP_PASSAGES,
                          "forwards": len(shapes), "launches": dp_launches,
                          "cos_vs_single_device": cos,
                          "encode_s": secs["passages"],
                          "single_device_encode_s": single_s["passages"]},
        "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi_line(),
    }
    emit(line)
    return line


# ---------------------------------------------------------------------------
# The driver entry points (phase 18, graft): entry() and dryrun_multichip
# ---------------------------------------------------------------------------

GRAFT_RANKS = 4                  # dryrun_multichip's devices: logical ranks
GRAFT_SCAN_STAGES = ("b", "c", "e")   # the stages that run the dense scan


def graft_phase(counts) -> dict:
    """graft_entry.entry() on the card against the same model on the CPU
    (per-row cosine >= ENC_COS_MIN; no kernel on its path), then
    dryrun_multichip(GRAFT_RANKS) with every stage's assertion (launch
    counts reset just before, read just after: topk_scan and topk_merge
    in stages b, c and e), leaving no environment variable or runtime
    behind."""
    from classmate_rag_tpu_torch import graft_entry
    from classmate_rag_tpu_torch.embeddings.model import params_from_numpy
    from classmate_rag_tpu_torch.pipeline import runtime

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    build_s = time.perf_counter() - t0
    counts.reset()
    with torch.inference_mode():
        out = fn(*args)
        torch.cuda.synchronize()
        fwd_ms = time_ms(lambda: fn(*args), reps=10, warmup=2)
    entry_launches = counts.read()
    check(tuple(out.shape) == (8, 768) and out.dtype == torch.float32,
          f"entry forward {tuple(out.shape)} {out.dtype}")
    got = out.cpu().numpy()
    check(bool(np.isfinite(got).all()), "entry forward: non-finite values")
    check(not any(entry_launches.values()),
          f"entry forward launched kernels: {entry_launches}")
    t0 = time.perf_counter()
    cpu_model = params_from_numpy(fn.params_numpy(), fn.config, "cpu")
    with torch.inference_mode():
        want = cpu_model(*(a.cpu() for a in args)).numpy()
    cpu_s = time.perf_counter() - t0
    cos = row_cos(got, want)
    check(cos >= ENC_COS_MIN, f"entry forward card vs CPU cosine {cos}")
    del fn, args, out, cpu_model
    torch.cuda.empty_cache()

    env = dict(os.environ)
    rt, local = runtime._RUNTIME, runtime.local_devices
    counts.reset()
    t0 = time.perf_counter()
    res = graft_entry.dryrun_multichip(GRAFT_RANKS)
    dryrun_s = time.perf_counter() - t0
    launches = counts.read()
    for stage in GRAFT_SCAN_STAGES:
        for name in ("topk_scan", "topk_merge"):
            n = res["launches"][stage][name]
            check(n > 0, f"graft stage {stage}: {name} launched {n} times")
    check(all(sum(s[k] for s in res["launches"].values()) == v
              for k, v in launches.items()),
          f"graft stage launches {res['launches']} != {launches}")
    check(dict(os.environ) == env, "dryrun left the environment changed")
    check(runtime._RUNTIME is rt and runtime.local_devices is local,
          "dryrun left a runtime behind")
    torch.cuda.empty_cache()
    line = {
        "phase": "graft", "entry": {
            "shape": [8, 768], "build_s": build_s, "forward_ms": fwd_ms,
            "cos_vs_cpu": cos, "cpu_s": cpu_s,
            "launches": entry_launches},
        "dryrun": {"n_devices": GRAFT_RANKS, "devices": res["devices"],
                   "loss": res["a"], "rows_b": res["b"][0].tolist(),
                   "rows_c": res["c"][0].tolist(),
                   "tokens_d": res["d"].tolist(),
                   "retrieved_e": res["e"]["got"],
                   "stage_s": res["seconds"],
                   "stage_launches": res["launches"], "launches": launches,
                   "dryrun_s": dryrun_s},
        "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi_line(),
    }
    emit(line)
    return line


# ---------------------------------------------------------------------------
# Multi-process serving (phase 14): the slice store saved as phase 3 left
# it, served by 2 processes × 2 shards on cuda:0 over gloo
# ---------------------------------------------------------------------------

MH_RANKS = 2            # processes, each on SHARD_DEVICE (gloo: one card)
MH_SHARDS = 2           # shards a process: 4 in all, as in phase 12
MH_TIMEOUT_S = 300      # the process group's timeout (a collective's)
MH_CHILD_S = 600        # the children's deadline
MH_NEW_CHUNKS = 10      # the document both ranks add


def multihost_save(root: Path, store, docs, batches, outs, where,
                   knobs) -> None:
    """Phase 3's store persisted in ``root`` with the port's persistence
    (a catalog JSONL in bm25/, the saved store in dense/), with phase 3's
    4 batches and their single-device results, and one filtered batch's
    (queries.npz, terms.json)."""
    from classmate_rag_tpu_torch.index.catalog import Catalog
    from classmate_rag_tpu_torch.index.store import IndexStore

    bm25 = root / "bm25"
    bm25.mkdir(parents=True)
    with (bm25 / "bm25_index.jsonl").open("w", encoding="utf-8") as f:
        for i, cid in enumerate(store.ids):
            f.write(json.dumps({"id": cid, "text": " ".join(docs[i]),
                                "tokens": docs[i],
                                "metadata": chunk_meta(i)}) + "\n")
    catalog = Catalog.load_or_create(bm25)
    copy = IndexStore.from_host_state(
        store.host_state(), device="cpu", directory=root / "dense",
        slab_rows=store.slab_rows)
    copy.save(catalog_fingerprint=catalog.fingerprint())
    q = np.stack([qv for b in batches for qv, _t in b])
    filt = store.hybrid_topk_batch(q[:BATCH], [t for _q, t in batches[0]],
                                   where, **knobs)
    res = [o for o, _rows in outs] + [filt]
    arrays = {"q": q}
    for field in ("rows", "fused", "vec_dist", "bm25_score"):
        arrays[field] = np.stack([getattr(o, field).cpu().numpy()
                                  for o in res])
    np.savez(root / "queries.npz", **arrays)
    (root / "terms.json").write_text(json.dumps(
        {"terms": [t for b in batches for _q, t in b], "where": where}))


def multihost_child(rank: int, root: Path, addr: str) -> int:
    """One rank of phase 14: join the group (gloo), load the saved store
    on cuda:0, serve it through a 4-shard ShardedHybridIndex over both
    processes (2 shards each), hold the rows against the saved
    single-device results, then replay one add and one delete and hold
    the refresh. Prints one ``MULTIHOST_CHILD_JSON:`` line and saves its
    rows to ``root/rows<rank>.npz``."""
    import torch.distributed as dist

    from classmate_rag_tpu_torch.index.catalog import Catalog
    from classmate_rag_tpu_torch.index.store import IndexStore
    from classmate_rag_tpu_torch.ops import attention as tatt
    from classmate_rag_tpu_torch.ops import encoder_fused as tef
    from classmate_rag_tpu_torch.ops import topk as ttopk
    from classmate_rag_tpu_torch.parallel import ShardedHybridIndex, multihost

    report: dict = {"rank": rank}
    t0 = time.perf_counter()
    multihost.initialize(addr, MH_RANKS, rank, backend="gloo",
                         timeout_s=MH_TIMEOUT_S)
    check(multihost.process_count() == MH_RANKS, "multihost: no group")
    report["init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    catalog = Catalog.load_or_create(root / "bm25")
    store = IndexStore.load_or_create(DIM, root / "dense", catalog,
                                      slab_rows=4096, terms_per_chunk=128,
                                      device=SHARD_DEVICE)
    check(len(store) == CHUNKS, f"multihost: loaded {len(store)} chunks")
    report["load_s"] = time.perf_counter() - t0
    saved = np.load(root / "queries.npz")
    meta = json.loads((root / "terms.json").read_text())
    q, terms, where = saved["q"], meta["terms"], meta["where"]
    runs = [(q[i:i + BATCH], terms[i:i + BATCH], None)
            for i in range(0, len(q), BATCH)]
    runs.append((q[:BATCH], terms[:BATCH], where))
    wants = [[torch.from_numpy(saved[f][i]) for f in (
        "rows", "fused", "vec_dist", "bm25_score")] for i in range(len(runs))]
    knobs = dict(k_vector=K, k_bm25=K, top_k=K, pool=POOL)

    t0 = time.perf_counter()
    mesh = multihost.process_corpus_mesh([SHARD_DEVICE] * MH_SHARDS)
    engine = ShardedHybridIndex(store, mesh, **knobs)
    torch.cuda.synchronize()
    report["build_s"] = time.perf_counter() - t0
    check(engine._shards.owned == [MH_SHARDS * rank + j
                                   for j in range(MH_SHARDS)],
          f"multihost: rank {rank} owns {engine._shards.owned}")
    engine.query_batch(*runs[0], **knobs).rows.cpu()     # first use: warm

    # The main path: every count 0 just before, read just after.
    counts = Counts(ttopk, tef, tatt)
    counts.reset()
    outs, walls, moved = [], [], []
    for qb, tb, w in runs:
        before = engine.bytes_exchanged_total
        t0 = time.perf_counter()
        out = engine.query_batch(qb, tb, w, **knobs)
        out.rows.cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
        moved.append(engine.bytes_exchanged_total - before)
        outs.append(out)
    launches = counts.read()
    for name in ("topk_scan", "topk_merge"):
        check(launches[name] == MH_SHARDS * len(runs),
              f"multihost: {name} launches {launches[name]} != "
              f"{MH_SHARDS * len(runs)}")
    cmp = [compare_engine(o, w) for o, w in zip(outs, wants)]
    n_equal = sum(c["rows_equal"] for c in cmp)
    n_total = sum(c["queries"] for c in cmp)
    check(n_equal / n_total >= ROWS_AGREE_MIN,
          f"multihost: rows equal one device on {n_equal}/{n_total}")
    worst = max(c["max_score_diff"] for c in cmp)
    check(worst <= STEP_TOL, f"multihost: scores differ by {worst}")
    warm = []
    for qb, tb, w in runs[:-1]:
        t0 = time.perf_counter()
        engine.query_batch(qb, tb, w, **knobs).rows.cpu()
        warm.append((time.perf_counter() - t0) * 1e3)

    # Both ranks replay the same add and delete (the SPMD contract).
    base = engine.bytes_placed_total
    rng = np.random.default_rng(11)
    new_docs = [[word(int(i)) for i in rng.integers(0, 5000, 60)]
                for _ in range(MH_NEW_CHUNKS)]
    new_emb = rng.standard_normal((MH_NEW_CHUNKS, DIM)).astype(np.float32)
    new_emb /= np.linalg.norm(new_emb, axis=1, keepdims=True)
    store.upsert([f"mh{i}" for i in range(MH_NEW_CHUNKS)], new_emb,
                 new_docs, [chunk_meta(i) for i in range(MH_NEW_CHUNKS)])
    store.delete([store.ids[17]])
    after = []
    for qb, tb, w in (runs[1], runs[-1]):
        t0 = time.perf_counter()
        out = engine.query_batch(qb, tb, w, **knobs)   # drains the journal
        out.rows.cpu()
        if not after:
            report["refresh_batch_ms"] = (time.perf_counter() - t0) * 1e3
            delta = engine.bytes_placed_last_refresh
        after.append((out, store.hybrid_topk_batch(qb, tb, w, **knobs)))
    check(0 < delta < base / 2,
          f"multihost: the refresh moved {delta} B of {base}")
    check(engine.full_lexical_rebuilds == 0,
          "multihost: a small mutation rebuilt the whole split layout")
    deltas = multihost.process_allgather(np.asarray([delta], np.int64))
    check(int(deltas.min()) == int(deltas.max()),
          f"multihost: ranks moved {deltas.ravel().tolist()} B")
    cmp_after = [compare_engine(o, w) for o, w in after]
    check(all(c["rows_equal"] / c["queries"] >= ROWS_AGREE_MIN
              for c in cmp_after), f"multihost: rows after the mutations")
    check(17 not in after[0][0].rows.cpu().numpy(),
          "multihost: the deleted chunk came back")
    np.savez(root / f"rows{rank}.npz",
             rows=np.stack([o.rows.cpu().numpy() for o in outs]),
             after=np.stack([o.rows.cpu().numpy() for o, _w in after]))
    report.update({
        "launches": launches, "batches": len(runs),
        "rows_equal_one_device": [n_equal, n_total],
        "differing": [d for c in cmp for d in c["differing"]],
        "max_score_diff": worst, "batch_wall_ms": walls,
        "warm_batch_wall_ms": warm,
        "warm_batch_ms": statistics.median(warm),
        "bytes_exchanged_a_batch": moved,
        "bytes_placed_base": base, "bytes_placed_last_refresh": delta,
        "full_lexical_rebuilds": engine.full_lexical_rebuilds,
        "rows_equal_after_mutations": [c["rows_equal"] for c in cmp_after],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    })
    dist.barrier()
    dist.destroy_process_group()
    print("MULTIHOST_CHILD_JSON:" + json.dumps(report), flush=True)
    return 0


def multihost_phase(root: Path, sharded: dict, save_s: float) -> dict:
    """Start the two ranks on the saved store, wait for both (each under
    the deadline; a rank that hangs is killed and the phase fails), and
    hold their results against each other."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        addr = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    t0 = time.perf_counter()
    logs = [(root / f"child{r}.out", root / f"child{r}.err")
            for r in range(MH_RANKS)]
    procs = []
    try:
        for r, (out, err) in enumerate(logs):
            with out.open("w") as fo, err.open("w") as fe:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--multihost-child", str(r), str(root), addr],
                    stdout=fo, stderr=fe))
        deadline = time.perf_counter() + MH_CHILD_S
        for p in procs:
            p.communicate(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"multihost: a rank passed {MH_CHILD_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    child_s = time.perf_counter() - t0
    reports = []
    for r, (p, (out, err)) in enumerate(zip(procs, logs)):
        text = out.read_text()
        found = [ln for ln in text.splitlines()
                 if ln.startswith("MULTIHOST_CHILD_JSON:")]
        check(p.returncode == 0 and len(found) == 1,
              f"multihost rank {r} failed (rc={p.returncode}):\n"
              f"{text[-2000:]}\n{err.read_text()[-3000:]}")
        reports.append(json.loads(found[0].split(":", 1)[1]))
    ranks = [np.load(root / f"rows{r}.npz") for r in range(MH_RANKS)]
    for key in ("rows", "after"):
        check(all(np.array_equal(ranks[0][key], x[key]) for x in ranks[1:]),
              f"multihost: ranks return different {key}")
    line = {
        "phase": "multihost", "ranks": MH_RANKS,
        "shards_per_rank": MH_SHARDS, "devices": [SHARD_DEVICE] * MH_RANKS,
        "backend": "gloo",
        "nccl": "unverified: NCCL refuses two ranks on one card, so the "
                "ranks share it over gloo",
        "chunks": CHUNKS, "batch": BATCH, "rows_equal_across_ranks": True,
        "save_s": save_s, "child_s": child_s, "ranks_report": reports,
        "warm_batch_ms": [x["warm_batch_ms"] for x in reports],
        "phase12_warm_batch_ms": sharded["warm_batch_ms"],
        "bytes_exchanged_a_batch": [x["bytes_exchanged_a_batch"]
                                    for x in reports],
        "launches_a_batch": [{k: v / x["batches"] for k, v in
                              x["launches"].items()
                              if k in ("topk_scan", "topk_merge")}
                             for x in reports],
        "nvidia_smi": smi_line(),
    }
    emit(line)
    return line


# ---------------------------------------------------------------------------
# The int8 scan with exact rescore (phase 15), against topk_scan
# ---------------------------------------------------------------------------

INT8_SIZES = (262_144, 1_048_576)
INT8_POOL = 64
INT8_CPU_QUERIES = 16       # queries held against the port's CPU version
INT8_TIE = 1e-5             # card vs CPU: differing picks' scores this close


def int8_phase(ttopk, store, q0, peaks) -> dict:
    """ops/quant.py's topk_int8_rescore at N 262,144 (the slice store)
    and 1,048,576 (unit rows made on the card), d 768, Q 256, pool 64,
    k 8: the card against the port's CPU version on a subset of queries,
    set recall@8 against topk_scan's exact top-8, its time beside
    topk_scan's and beside its own bound, peak memory."""
    from classmate_rag_tpu_torch.ops.quant import (
        int8_scores,
        quantize_queries,
        quantize_rows,
        topk_int8_rescore,
    )

    bw, int8_peak = peaks[0], peaks[3]
    g = torch.Generator(device="cuda").manual_seed(15)
    parts = []
    for n in INT8_SIZES:
        if n == store.capacity:
            host = store.emb.astype(np.float32)
            emb16 = store._sync_device()["emb"]
            bias = store._mask_bias(None)
            q = q0
        else:
            big = torch.randn(n, DIM, device="cuda", generator=g)
            big = big / big.norm(dim=1, keepdim=True)
            host = big.cpu().numpy()
            emb16 = big.to(torch.bfloat16)
            del big
            q = emb16[:: n // BATCH][:BATCH].float()
            q = q + 0.25 * torch.randn(q.shape, device="cuda", generator=g)
            q = (q / q.norm(dim=1, keepdim=True)).contiguous()
            bias = torch.zeros(n, device="cuda")
            bias[torch.rand(n, device="cuda", generator=g) < 0.1] = (
                ttopk.NEG_INF)
        t0 = time.perf_counter()
        e8_host, sc_host = quantize_rows(host)
        quant_s = time.perf_counter() - t0
        del host
        e8, sc = torch.from_numpy(e8_host).cuda(), torch.from_numpy(
            sc_host).cuda()

        def run():
            return topk_int8_rescore(e8, sc, emb16, q, bias, K,
                                     rescore_pool=INT8_POOL)

        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        vals, rows = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base_mem

        sub = slice(0, INT8_CPU_QUERIES)
        cv, cr = topk_int8_rescore(e8.cpu(), sc.cpu(), emb16.cpu(),
                                   q[sub].cpu(), bias.cpu(), K,
                                   rescore_pool=INT8_POOL)
        gv, gr = vals[sub].cpu(), rows[sub].cpu()
        differ = gr != cr
        err = (gv - cv).abs().max().item()
        check(bool((~differ | ((gv - cv).abs() <= INT8_TIE)).all())
              and err <= INT8_TIE,
              f"int8 N {n}: card vs CPU beyond a near-tie (max |d| {err})")

        _ev, er = ttopk.masked_topk(emb16, q, bias, K)
        exact = er.cpu().numpy()
        got = rows.cpu().numpy()
        recall = float(np.mean([
            len(set(got[i][got[i] >= 0]) & set(exact[i][exact[i] >= 0]))
            / max(int((exact[i] >= 0).sum()), 1) for i in range(len(got))]))

        q_i8, _q_scale = quantize_queries(q)
        nq = q.shape[0]
        bytes_moved = (n * DIM + n * 4 + n * 4 + nq * DIM * 4
                       + nq * INT8_POOL * DIM * 2 + nq * K * 8)
        ops = 2.0 * nq * n * DIM
        t_bytes, t_ops = bytes_moved / bw * 1e3, ops / int8_peak * 1e3
        parts.append({
            "N": n, "d": DIM, "Q": nq, "pool": INT8_POOL, "k": K,
            "ms": time_ms(run, reps=10),
            "stage1_int_mm_ms": time_ms(lambda: int8_scores(q_i8, e8)),
            "topk_scan_k8_ms": time_ms(
                lambda: ttopk.masked_topk(emb16, q, bias, K)),
            "topk_scan_k64_ms": time_ms(
                lambda: ttopk.masked_topk(emb16, q, bias, INT8_POOL)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "ops": ops,
            "recall_at_8_vs_topk_scan": recall,
            "cpu_queries": INT8_CPU_QUERIES,
            "rows_equal_cpu": int((~differ).all(dim=1).sum()),
            "max_abs_err_cpu": err,
            "peak_memory_bytes": peak, "quantize_rows_s": quant_s,
        })
        del e8, sc, emb16, q, bias, vals, rows
        torch.cuda.empty_cache()
    line = {"phase": "int8", "parts": parts, "nvidia_smi": smi_line()}
    emit(line)
    return line


# ---------------------------------------------------------------------------
# The product path (phase 8): persisted index → runtime → ask / add /
# persist → server, in a child process as bench.py's product stage runs it
# ---------------------------------------------------------------------------

def product_build(root: Path, docs, emb) -> dict:
    """A persisted product index in ``root``: the catalog JSONL (bm25/)
    in the canonical on-disk format and a saved store (dense/), ids
    ``stable_chunk_id`` over 10 chunks a document, as bench.py builds it."""
    from classmate_rag_tpu_torch.index.catalog import Catalog
    from classmate_rag_tpu_torch.index.store import IndexStore
    from classmate_rag_tpu_torch.utils.ids import stable_chunk_id

    t0 = time.perf_counter()
    bm25 = root / "bm25"
    bm25.mkdir(parents=True)
    ids, metas = [], []
    with (bm25 / "bm25_index.jsonl").open("w", encoding="utf-8") as f:
        for i, toks in enumerate(docs):
            d, c = divmod(i, CHUNKS_PER_DOC)
            sp = f"/bench/doc_{d}.txt"
            cid = stable_chunk_id(source_path=Path(sp), page=1,
                                  chunk_index=c, course="bench", unit=None)
            meta = {"course": "bench", "language": "en", "doc_type": "txt",
                    "source_path": sp, "page": 1, "chunk_id": c}
            f.write(json.dumps({"id": cid, "text": " ".join(toks),
                                "tokens": toks, "metadata": meta},
                               ensure_ascii=False) + "\n")
            ids.append(cid)
            metas.append(meta)
    t_catalog = time.perf_counter() - t0
    catalog = Catalog.load_or_create(bm25)
    # The shape get_runtime() constructs, or the snapshot is refused.
    store = IndexStore(DIM, root / "dense", slab_rows=4096,
                       terms_per_chunk=PRODUCT_TERMS, device="cpu")
    for s in range(0, len(docs), 8192):
        e = min(s + 8192, len(docs))
        store.upsert(ids[s:e], emb[s:e], docs[s:e], metas[s:e])
    t_upsert = time.perf_counter() - t0 - t_catalog
    store.save(catalog_fingerprint=catalog.fingerprint())
    check((root / "dense" / "split.tf_head.npy").exists(),
          "product: the split layout was not persisted")
    out = {"catalog_s": t_catalog, "upsert_s": t_upsert,
           "save_s": time.perf_counter() - t0 - t_catalog - t_upsert,
           "capacity": store.capacity, "n_rows": store.n_rows,
           "bytes": sum(p.stat().st_size for p in root.rglob("*")
                        if p.is_file())}
    return out


def product_phase(root: Path, docs, emb, counts, profile_path) -> dict:
    """Build the persisted index in ``root`` (kept for phase 17), then
    run the child against it."""
    build = product_build(root, docs[:CHUNKS], emb[:CHUNKS])
    cmd = [sys.executable, str(Path(__file__).resolve()),
           "--product-child", str(root)]
    if profile_path:
        cmd += ["--profile", profile_path]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    child_s = time.perf_counter() - t0
    report = None
    for line in proc.stdout.splitlines():
        if line.startswith("PRODUCT_CHILD_JSON:"):
            report = json.loads(line[len("PRODUCT_CHILD_JSON:"):])
        elif line.startswith("{"):
            print(line, flush=True)         # the child's profile line
    check(proc.returncode == 0 and report is not None,
          f"product child failed (rc={proc.returncode}):\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    line = {"phase": "product", "build": build, "child_s": child_s,
            **report}
    emit(line)
    return line


def product_child(root: Path, profile_path) -> int:
    """Cold-start the runtime from ``root``, ask, add, persist, ask again,
    hold the asks against a CPU load of the persisted directory, serve.
    Prints one ``PRODUCT_CHILD_JSON:`` line; any failed check raises."""
    import os
    import threading
    import urllib.request

    os.environ.update(
        INDEX_DIR=str(root), BM25_DIR=str(root / "bm25"),
        DENSE_DIR=str(root / "dense"), EMB_CACHE_DIR=str(root / "emb"),
        EMBEDDING_BACKEND="hash", LLM_BACKEND="extractive",
        BM25_TERMS_PER_CHUNK=str(PRODUCT_TERMS),
    )
    from classmate_rag_tpu_torch.index.catalog import Catalog
    from classmate_rag_tpu_torch.index.store import IndexStore
    from classmate_rag_tpu_torch.metadata import DocumentMetadata
    from classmate_rag_tpu_torch.ops import topk as ttopk
    from classmate_rag_tpu_torch.pipeline.ask import ask_question
    from classmate_rag_tpu_torch.pipeline.ingest import ingest_file
    from classmate_rag_tpu_torch.pipeline.runtime import get_runtime
    from classmate_rag_tpu_torch.retrieval.hybrid import HybridRetriever
    from classmate_rag_tpu_torch.serve import make_server
    from classmate_rag_tpu_torch.utils.metrics import metrics

    report: dict = {}
    t0 = time.perf_counter()
    rt = get_runtime(reload=True)
    report["runtime_load_s"] = time.perf_counter() - t0
    report["load_timings"] = rt.load_timings
    report["n_rows"] = rt.store.n_rows
    check(rt.store.device.type == "cuda", "product: runtime not on CUDA")
    check(rt.warmup_thread is not None,
          "product: no background warm-up at serving scale")
    t0 = time.perf_counter()
    rt.warmup_thread.join()
    report["ready_s"] = time.perf_counter() - t0
    report["after_warmup"] = counters(rt.store)
    report["native"] = native_part(rt)

    rng = np.random.default_rng(7)
    vocab = [word(i) for i in range(5000)]
    weights = 1.0 / np.arange(1, len(vocab) + 1)
    weights /= weights.sum()

    def question():
        return "what about " + " ".join(
            vocab[i] for i in rng.choice(len(vocab), size=4, p=weights))

    def ask(q):
        res = ask_question(question=q, filters=DocumentMetadata(), top_k=K,
                           runtime=rt)
        check(bool(res.answer), f"product: empty answer to {q!r}")
        check(len(res.retrieved) >= 1, f"product: nothing retrieved: {q!r}")
        return res

    t0 = time.perf_counter()
    ask(question())
    report["first_ask_s"] = time.perf_counter() - t0
    for _ in range(2):
        ask(question())
    for table in (ttopk.LAUNCHES,):
        for name in table:
            table[name] = 0
    metrics.reset()  # the ask's own timers: "ask" and its "retrieve"
    lat = []
    asked = []
    for _ in range(PRODUCT_ASKS):
        q = question()
        t0 = time.perf_counter()
        ask(q)
        lat.append((time.perf_counter() - t0) * 1e3)
        asked.append(q)
    report["ask_launches"] = dict(ttopk.LAUNCHES)
    check(ttopk.LAUNCHES["topk_scan"] == PRODUCT_ASKS,
          f"product: topk_scan launched {ttopk.LAUNCHES['topk_scan']} "
          f"times in {PRODUCT_ASKS} asks")
    report["ask_ms"] = lat
    report["ask_p50_ms"] = float(np.percentile(lat, 50))
    report["ask_p95_ms"] = float(np.percentile(lat, 95))
    snap = metrics.snapshot()
    report["ask_parts_mean_ms"] = {
        "ask": snap.get("ask_mean_ms"),
        "retrieve": snap.get("retrieve_mean_ms"),
        "retrieve_count": snap.get("retrieve_count", 0),
    }
    check(report["ask_parts_mean_ms"]["retrieve_count"] == PRODUCT_ASKS,
          f"product: {snap.get('retrieve_count')} retrieves in "
          f"{PRODUCT_ASKS} asks")
    if profile_path:
        emit(profile_batch(lambda: ask(asked[0]),
                           f"{profile_path}_product",
                           report["ask_p50_ms"], phase="profile_product"))

    # ---- /add probe: one new document, then persist.
    dirs = (Path(rt.cfg.bm25_dir), Path(rt.cfg.dense_dir))
    files0 = {p: p.stat() for d in dirs for p in d.iterdir()}
    before = counters(rt.store)
    doc = root / "new_doc.txt"
    new_words = ["quokka", "zeppelin", "marzipan", "xylophone"]
    doc.write_text(
        "A freshly added document about " + " ".join(new_words) + ". "
        "It gives the product add probe more context to answer from.",
        encoding="utf-8")
    t0 = time.perf_counter()
    added = ingest_file(path=doc, doc_meta=DocumentMetadata(course="bench"),
                        runtime=rt)
    report["add_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt.persist()
    report["persist_s"] = time.perf_counter() - t0
    # bench.py's measure (size changes) and every byte of every file
    # the add wrote (new, or rewritten in place).
    delta, written, rewrote = 0, {}, False
    for d in dirs:
        for p in d.iterdir():
            old, now = files0.get(p), p.stat()
            if old is None:
                delta += now.st_size
            elif now.st_size != old.st_size:
                delta += abs(now.st_size - old.st_size)
            if old is None or (now.st_size, now.st_mtime_ns) != (
                    old.st_size, old.st_mtime_ns):
                written[p.name] = now.st_size
                rewrote |= p.name in ("embeddings.npy", "bm25_index.jsonl",
                                      "lexical.npz")
    report["persist_delta_bytes"] = delta
    report["persist_files_written"] = written
    report["persist_rewrote_base"] = rewrote
    check(not rewrote, "product: the persist rewrote a base file")
    check(added.chunk_ids, "product: the new document gave no chunk")
    check(rt.store.packs_natively,
          "product: the add packed its rows on the Python path")
    report["native"]["packed_the_add"] = True

    # ---- asks after the add.
    lat = []
    after = []
    for _ in range(17):
        q = question()
        t0 = time.perf_counter()
        ask(q)
        lat.append((time.perf_counter() - t0) * 1e3)
        after.append(q)
    report["ask_after_add_first_ms"] = lat[0]
    report["ask_after_add_p50_ms"] = float(np.percentile(lat[1:], 50))
    new_q = "tell me about " + " ".join(new_words)
    hit = ask(new_q)
    check(added.chunk_ids[0] in [r["id"] for r in hit.retrieved],
          "product: the new document's chunk was not retrieved")
    report["after_add"] = counters(rt.store)
    for name in ("device_full_uploads", "split_full_builds"):
        check(report["after_add"][name] == before[name],
              f"product: {name} moved across the add "
              f"({before[name]} -> {report['after_add'][name]})")

    # ---- the same asks against a store loaded anew on the CPU.
    t0 = time.perf_counter()
    cpu_store = IndexStore.load_or_create(
        DIM, rt.cfg.dense_dir, Catalog.load_or_create(rt.cfg.bm25_dir),
        slab_rows=rt.cfg.dense_slab_rows, terms_per_chunk=PRODUCT_TERMS,
        device="cpu")
    cpu_ret = dataclasses.replace(rt.retriever, store=cpu_store)
    worst = 0.0
    for q in after[:PRODUCT_CPU_ASKS - 1] + [new_q]:
        got = rt.retriever.retrieve(question=q, top_k=K)
        want = cpu_ret.retrieve(question=q, top_k=K)
        check([r["id"] for r in got] == [r["id"] for r in want],
              f"product: card and CPU load differ on {q!r}")
        for x, y in zip(got, want):
            for key in ("fused", "vector_distance", "bm25_score"):
                a, b = x["scores"][key], y["scores"][key]
                check((a is None) == (b is None), f"product: {key} None")
                if a is not None:
                    worst = max(worst, abs(a - b))
    check(worst <= STEP_TOL, f"product: card vs CPU load score diff {worst}")
    report["cpu_load"] = {"asks": PRODUCT_CPU_ASKS, "rows_equal": True,
                          "max_score_diff": worst,
                          "seconds": time.perf_counter() - t0,
                          **counters(cpu_store)}
    del cpu_store, cpu_ret

    # ---- the server.
    srv = make_server("127.0.0.1", 0, runtime=rt)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def call(route, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            base + route, data=data,
            headers={"Content-Type": "application/json"},
            method="GET" if payload is None else "POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
            return r.status, body, (time.perf_counter() - t0) * 1e3

    def concurrent_asks():
        """8 concurrent /asks, each answer held against ask_question's;
        returns (ms per reply, micro-batches they made)."""
        qs = [question() for _ in range(8)]
        expect = [ask(q).answer for q in qs]
        batches0 = metrics.snapshot().get("retrieve_batch_count", 0)
        replies = [None] * len(qs)

        def worker(i):
            replies[i] = call("/ask", {"question": qs[i], "k": K})

        workers = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(qs))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        batches = metrics.snapshot().get("retrieve_batch_count", 0) - batches0
        for i, rep in enumerate(replies):
            check(rep is not None and rep[0] == 200,
                  f"product: /ask {i} failed: {rep}")
            check(rep[1]["answer"] == expect[i],
                  "product: /ask answer differs from ask_question's")
        return [r[2] for r in replies], batches

    try:
        rounds = [concurrent_asks() for _ in range(3)]
        gone = added.chunk_ids[0]
        code, body, _ = call("/delete", {"ids": [gone]})
        check(code == 200 and body["vector_deleted"] == 1,
              f"product: /delete {code} {body}")
        code, stats, _ = call("/stats")
        check(code == 200, f"product: /stats {code}")
        code, body, _ = call("/ask", {"question": new_q, "k": K})
        check(code == 200 and gone not in [r["id"] for r in
                                           body["retrieved"]],
              "product: the deleted id came back")
        report["server"] = {
            "rounds_of_8": len(rounds),
            "batches": [b for _ms, b in rounds],
            "ask_ms": [ms for ms, _b in rounds],
            "ask_p50_ms_by_round": [float(np.percentile(ms, 50))
                                    for ms, _b in rounds],
            "ask_p50_ms": float(np.percentile(
                [x for ms, _b in rounds[1:] for x in ms], 50)),
            "stats_maintenance": stats["maintenance"],
        }
    finally:
        srv.shutdown()
        srv.server_close()
    report["final"] = counters(rt.store)
    emit(product_decoder(question))
    print("PRODUCT_CHILD_JSON:" + json.dumps(report), flush=True)
    return 0


NATIVE_CHUNKS = 20_000   # chunks tokenized and packed both ways


def native_part(rt) -> dict:
    """The C++ tokenizer and packer (native/) loaded, and equal to the
    Python path on the first NATIVE_CHUNKS chunks of the persisted
    corpus: the same tokens, the same packed arrays and vocabulary; the
    seconds each way."""
    from classmate_rag_tpu_torch import native
    from classmate_rag_tpu_torch.index.lexical import pack_tokens, tokenize_py

    tok = native.get_native_tokenizer()
    check(tok is not None, "product: the native library did not load")
    texts = [rt.catalog.get(cid).text
             for cid in rt.store.ids[:NATIVE_CHUNKS]]
    secs = {}
    t0 = time.perf_counter()
    nat = [tok.tokenize(t, "en") for t in texts]
    secs["tokenize_native"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = [tokenize_py(t, "en") for t in texts]
    secs["tokenize_python"] = time.perf_counter() - t0
    check(nat == py, "native: tokens differ from the Python path's")
    packer = native.make_native_packer()
    check(packer is not None, "native: no packer")
    vocab_n, vocab_p = {}, {}
    t0 = time.perf_counter()
    got = packer.pack_batch(nat, vocab_n, PRODUCT_TERMS)
    secs["pack_native"] = time.perf_counter() - t0
    check(got is not None, "native: the packer refused the batch")
    t0 = time.perf_counter()
    want = [np.empty((len(py), PRODUCT_TERMS), np.int32),
            np.empty((len(py), PRODUCT_TERMS), np.uint8),
            np.empty(len(py), np.float32)]
    for i, tokens in enumerate(py):
        want[0][i], want[1][i], want[2][i] = pack_tokens(
            tokens, vocab_p, PRODUCT_TERMS)
    secs["pack_python"] = time.perf_counter() - t0
    check(all(np.array_equal(g, w) for g, w in zip(got, want))
          and vocab_n == vocab_p, "native: packed arrays differ")
    return {"loaded": True, "library": native.lib_path().name,
            "chunks": len(texts), "cut": f"{CHUNKS} -> {len(texts)} chunks",
            "tokens": sum(map(len, py)), "vocab": len(vocab_n),
            "seconds": secs}


def product_decoder(question) -> dict:
    """Phase 9's product part: a second runtime on the same persisted
    index answering with the decoder (LLM_BACKEND=tpu, the default small
    config, temperature 0, RUNNER_NEW new tokens): 8 asks through
    ask_question and one round of 8 concurrent /asks. Every answer is
    non-empty and the runtime builds its runner once."""
    import os
    import threading
    import urllib.request

    from classmate_rag_tpu_torch.generation.runner import DecodeRunner
    from classmate_rag_tpu_torch.metadata import DocumentMetadata
    from classmate_rag_tpu_torch.pipeline import runtime as R
    from classmate_rag_tpu_torch.pipeline.ask import ask_question
    from classmate_rag_tpu_torch.serve import make_server
    from classmate_rag_tpu_torch.utils.metrics import metrics

    os.environ.update(LLM_BACKEND="tpu", LLM_TEMPERATURE="0",
                      LLM_MAX_TOKENS=str(RUNNER_NEW))
    built = []
    real = R.get_runner

    def counting(cfg, **kw):
        built.append(1)
        return real(cfg, **kw)

    R.get_runner = counting
    try:
        rt = R.get_runtime(reload=True)
        if rt.warmup_thread is not None:
            rt.warmup_thread.join()
        qs = [question() for _ in range(8)]
        t0 = time.perf_counter()
        first = ask_question(question=qs[0], filters=DocumentMetadata(),
                             top_k=K, runtime=rt)
        first_s = time.perf_counter() - t0      # the runner's build included
        lat, answers = [], [first.answer]
        for q in qs[1:]:
            t0 = time.perf_counter()
            res = ask_question(question=q, filters=DocumentMetadata(),
                               top_k=K, runtime=rt)
            lat.append((time.perf_counter() - t0) * 1e3)
            answers.append(res.answer)
        check(all(answers), "decode product: an empty answer")
        check(isinstance(rt.runner, DecodeRunner)
              and rt.runner.device.type == "cuda",
              f"decode product: runner {rt.runner!r}")
        srv = make_server("127.0.0.1", 0, runtime=rt)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        replies = [None] * len(qs)

        def worker(i):
            req = urllib.request.Request(
                base + "/ask", data=json.dumps(
                    {"question": qs[i], "k": K}).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                replies[i] = (r.status, json.loads(r.read()),
                              (time.perf_counter() - t0) * 1e3)

        batches0 = metrics.snapshot().get("retrieve_batch_count", 0)
        try:
            workers = [threading.Thread(target=worker, args=(i,))
                       for i in range(len(qs))]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=300)
        finally:
            srv.shutdown()
            srv.server_close()
        batches = metrics.snapshot().get("retrieve_batch_count", 0) - batches0
        for i, rep in enumerate(replies):
            check(rep is not None and rep[0] == 200 and rep[1]["answer"],
                  f"decode product: /ask {i} failed or empty: {rep}")
        check(len(built) == 1, f"decode product: {len(built)} runners built")
        return {
            "phase": "decode", "part": "product", "card": smi_line(),
            "runner": rt.runner.model_name, "max_new": rt.runner.max_new,
            "max_seq": rt.runner.max_seq, "runners_built": len(built),
            "first_ask_s": first_s, "ask_ms": lat,
            "ask_p50_ms": float(np.percentile(lat, 50)),
            "server_ask_ms": [r[2] for r in replies],
            "server_batches": batches,
            "server_ask_p50_ms": float(np.percentile(
                [r[2] for r in replies], 50)),
            "server_equal_to_ask": sum(
                r[1]["answer"] == a for r, a in zip(replies, answers)),
            "answer_chars": [len(a) for a in answers],
        }
    finally:
        R.get_runner = real


def counters(store) -> dict:
    return {name: getattr(store, name) for name in (
        "device_full_uploads", "split_full_builds",
        "split_snapshot_restores", "df_full_builds")}



# ---------------------------------------------------------------------------
# The decoder (phase 9): Llama-3.1-8B at full width, W8A8, card vs CPU,
# the runner and a GGUF, in a child process
# ---------------------------------------------------------------------------

DEC_BATCH = 8
DEC_PROMPT = 1024          # left-padded width; real lengths 512-1,024
DEC_MAX_SEQ = 2048
DEC_NEW = 128
DEC_EOS = [128001, 128009]  # Llama-3's <|end_of_text|>, <|eot_id|>
DEC_PROFILE_STEPS = 4
# W8A8 at full width, checked product by product on the prompts' own
# activations (layer 0's seven products and lm_head): the int8 path
# must equal the f32 evaluation of the same int8 formula (f32 sums of
# exact int products; only the order of the sums may differ). Its
# distance to the bf16 product and the teacher-forced W8A8 logits
# against bf16 (1 and 32 layers) are printed, not held to a bar: with
# weights drawn at random the reference's own scheme (per-token int8
# activations, per-channel int8 weights; equal to the port's bit for
# bit on the CPU, tests/test_torch_decoder.py) misses the bars of the
# JAX package's tiny-model test (logit row cosine >= 0.999, argmax
# agreement >= 0.90, tests/test_quant_decoder.py) at every depth from
# one layer on, and down_proj's 14,336-wide SwiGLU input alone costs
# ~3 % (PERF.md §6). The CPU tests hold those bars at tiny_test.
W8A8_EXACT_RTOL = 1e-5
DEC_CPU_LAYERS = 2
DEC_CPU_PROMPT = 64
DEC_CPU_COS_MIN = 0.9999   # card vs CPU prefill logit rows
# Card vs CPU argmax: the same bf16 roundings, sums in another order; a
# row may flip only where the CPU's top two logits are closer than twice
# the largest logit difference, and at most 5 % of the rows.
DEC_CPU_ARGMAX_MIN = 0.95
RUNNER_NEW = 64            # LLM_MAX_TOKENS of the runner and product parts
# Phase 13's decode: 4 logical ranks (auto_mesh_for gives (1, 4) for
# Llama-3.1-8B's 8 KV heads) at full depth, (2, 2) at 2 layers.
MESH_NEW = 32
MESH_DECODE_RANKS = 4
MESH_DECODE_LAYERS_2x2 = 2
# First-step logit rows. Both bf16 paths stand ~1e-3 (1 - cosine) from
# an f32 evaluation of the same weights at 32 layers (bf16 roundings of
# every product's operands), and apart from each other by ~2e-4 there:
# the mesh's partial sums add in another order, and each bf16 rounding
# a changed ulp crosses carries on through the layers. So the mesh is
# held to be as close to the f32 evaluation as one device is (1 - cos
# within MESH_REF_RATIO of it, plus MESH_REF_FLOOR at shallow depth
# where both are ~1e-6), and to one device at MESH_COS_MIN.
MESH_COS_MIN = 0.999
MESH_REF_RATIO = 1.25
MESH_REF_FLOOR = 1e-5
# Mesh vs one device, greedy: a row may part only where the tokens the
# two took score within this of the best in the single device's logits
# (tests/test_torch_decode_runner.py's NEAR_TIE), or within twice the
# largest first-step logit difference of the two paths (phase 9's
# card-vs-CPU rule), whichever is larger: the ranks' partial sums add in
# another order, and bf16 roundings of the residual stream carry that
# through 32 layers.
MESH_NEAR_TIE = 2e-2
# A batch of 8 and a batch of 1 run cuBLAS kernels chosen by row count,
# so their sums differ in order: a greedy step may differ between them
# only where the top two logits are within this.
DEC_NEAR_TIE = 1e-2


def draw_decoder_params(cfg, seed: int, dev) -> dict:
    """A decoder tree drawn on ``dev`` from a seeded generator with the
    distribution of ``init_params``: matmul weights N(0, 0.02) in the
    compute dtype, tok_emb N(0, 0.02) in f32, gains 1, Qwen2 biases
    N(0, 0.02)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    h, L, ff = cfg.hidden, cfg.layers, cfg.ffn
    qh, kvh = cfg.heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim

    def normal(*shape, dtype=cfg.compute_dtype):
        return torch.empty(shape, dtype=dtype, device=dev).normal_(
            0.0, 0.02, generator=g)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    layers = {"attn_norm": ones(L, h), "q_w": normal(L, h, qh),
              "k_w": normal(L, h, kvh), "v_w": normal(L, h, kvh),
              "o_w": normal(L, qh, h), "ffn_norm": ones(L, h),
              "gate_w": normal(L, h, ff), "up_w": normal(L, h, ff),
              "down_w": normal(L, ff, h)}
    if cfg.qkv_bias:
        for k, n in (("q_b", qh), ("k_b", kvh), ("v_b", kvh)):
            layers[k] = normal(L, n, dtype=torch.float32)
    if cfg.qk_norm:
        layers["q_norm"] = ones(L, cfg.head_dim)
        layers["k_norm"] = ones(L, cfg.head_dim)
    return {"tok_emb": normal(cfg.vocab_size, h, dtype=torch.float32),
            "final_norm": ones(h), "lm_head": normal(h, cfg.vocab_size),
            "layers": layers}


def decoder_prompts(rng, cfg, batch, width, lo, hi):
    """Left-padded prompts: ids [B, width] (pad 0) and real lengths."""
    lens = rng.integers(lo, hi + 1, size=batch)
    ids = np.zeros((batch, width), np.int64)
    for i, n in enumerate(lens):
        ids[i, width - n:] = rng.integers(3, cfg.vocab_size, size=n)
    return ids, lens


def prefill_mask(lens, width, max_seq, dev):
    """The generate loop's prefill positions and mask (make_generate_fn)."""
    from classmate_rag_tpu_torch.utils.numerics import NEG_INF

    pad = width - torch.as_tensor(lens, device=dev)
    slot = torch.arange(width, device=dev)[None, :]
    pos = slot - pad[:, None]
    key = torch.arange(max_seq, device=dev)[None, None, :]
    ok = (key >= pad[:, None, None]) & (key <= slot[:, :, None]) & (
        pos[:, :, None] >= 0)
    return pos.clamp_min(0), torch.where(ok, 0.0, NEG_INF), pad


def timed_generate(D, gen, params, ids, lens, eos, forward="forward"):
    """Run ``gen`` once with a CUDA event recorded after every forward it
    makes (the prefill, then one a step; ``forward`` names the function
    of module ``D`` it calls): prefill ms and each step's ms on the
    device's clock (host gaps included), and the wall time."""
    marks = []
    real = getattr(D, forward)

    def marked(*a, **kw):
        out = real(*a, **kw)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        return out

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    setattr(D, forward, marked)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        toks = gen(params, ids, lens, 0, 0.0, 0.95, eos)
        end.record()
        end.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        setattr(D, forward, real)
    steps = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return toks.cpu(), {"prefill_ms": start.elapsed_time(marks[0]),
                        "step_ms": steps, "wall_ms": wall_ms}


def teacher_forced(D, cfg, params, ids, lens, max_seq, dev):
    """Logits [rows, V] of the real prompt positions, prefilled as the
    generate loop prefills them."""
    width = ids.shape[1]
    pos, mask, _pad = prefill_mask(lens, width, max_seq, dev)
    cache = D.empty_cache(cfg, ids.shape[0], max_seq, device=dev)
    logits, _ = D.forward(params, torch.as_tensor(ids, device=dev), pos,
                          cache, 0, cfg, attn_mask=mask)
    real = (torch.arange(width)[None, :]
            >= (width - torch.as_tensor(lens))[:, None]).to(dev)
    return logits[real]


def first_layers(tree, n: int) -> dict:
    """The tree of the first ``n`` layers (views, no copy)."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: type(v)(*(x[:n] for x in v))
                     if isinstance(v, tuple) else v[:n]
                     for k, v in tree["layers"].items()}
    return out


def w8a8_products(D, cfg, params, q8, ids, dev) -> dict:
    """Layer 0's seven products and lm_head on the activations of one
    prompt: the W8A8 ``_mm`` against the f32 evaluation of the same int8
    formula (TF32 is off) and against the bf16 product."""
    import torch.nn.functional as F

    bf = cfg.compute_dtype
    l0 = {k: v[0] for k, v in params["layers"].items()}
    q0 = {k: D.QTensor(v.q[0], v.scale[0]) if isinstance(v, D.QTensor)
          else v[0] for k, v in q8["layers"].items()}
    x = D._embed(params["tok_emb"], torch.as_tensor(ids, device=dev))[0]
    normed = D._rms_norm(x, l0["attn_norm"], cfg.norm_eps).to(bf)
    ff = (F.silu(D._mm(normed, l0["gate_w"], bf))
          * D._mm(normed, l0["up_w"], bf)).to(bf)
    final = D._rms_norm(x, params["final_norm"], cfg.norm_eps).to(bf)
    cases = [(k, normed, l0[k], q0[k]) for k in (
        "q_w", "k_w", "v_w", "o_w", "gate_w", "up_w")]
    cases += [("down_w", ff, l0["down_w"], q0["down_w"]),
              ("lm_head", final, params["lm_head"], q8["lm_head"])]
    out = {}
    for name, inp, w, qw in cases:
        got = D._mm(inp, qw, bf)
        xf = inp.float()
        sx = xf.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
        xq = torch.round(xf / sx).clamp(-127, 127)
        plain = (xq @ qw.q.float()) * sx * qw.scale
        dense = D._mm(inp, w, bf)
        cos = (got * dense).sum(-1) / (got.norm(dim=-1) * dense.norm(dim=-1))
        out[name] = {
            "rows": int(inp.shape[0]), "k": int(inp.shape[1]),
            "n": int(got.shape[1]),
            "rel_diff_to_f32": float((got - plain).abs().max()
                                     / plain.abs().max()),
            "cos_min_to_bf16": float(cos.min()),
            "rel_err_to_bf16": float((got - dense).norm()
                                     / dense.norm())}
    return out


def rows_agree(a, b) -> dict:
    a, b = a.float(), b.float()
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    return {"rows": int(a.shape[0]), "cos_min": float(cos.min()),
            "cos_mean": float(cos.mean()),
            "argmax_agree": float((a.argmax(-1) == b.argmax(-1))
                                  .float().mean()),
            "max_abs_diff": float((a - b).abs().max())}


def decode_full_width(D, cfg, dev, card: str) -> None:
    """Parts 1-3, each emitted as it ends: full-width bf16 and W8A8
    decode of B prompts, the W8A8 logits against bf16, and the card
    against the CPU at 2 layers."""
    from classmate_rag_tpu_torch.utils.numerics import NEG_INF

    peak_bw, peak_bf16 = peaks_for(torch.cuda.get_device_name(0))[1][:2]
    rng = np.random.default_rng(9)
    B, P, S, N = DEC_BATCH, DEC_PROMPT, DEC_MAX_SEQ, DEC_NEW
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = draw_decoder_params(cfg, 1, dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    ids, lens = decoder_prompts(rng, cfg, B, P, P // 2, P)
    gen = D.make_generate_fn(cfg, S, N)
    D.make_generate_fn(cfg, S, 2)(params, ids, lens, 0, 0.0, 0.95,
                                  DEC_EOS)          # warm-up
    toks, t = timed_generate(D, gen, params, ids, lens, DEC_EOS)
    check(toks.shape == (B, N), f"decode: tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "decode: token ids out of range")
    h, qh = cfg.hidden, cfg.heads * cfg.head_dim
    kvh = cfg.kv_heads * cfg.head_dim
    mm_params = cfg.layers * (h * qh + 2 * h * kvh + qh * h
                              + 3 * h * cfg.ffn) + h * cfg.vocab_size
    attn_flops = 4.0 * B * cfg.heads * P * S * cfg.head_dim
    prefill_flops = 2.0 * B * P * mm_params + attn_flops
    kv_bytes = 2 * cfg.layers * B * cfg.kv_heads * S * cfg.head_dim * 2

    def step_bound_ms(tree) -> float:
        # Every weight but the embedding table is read once a step (the
        # step gathers B of its rows), and the whole cache: attention
        # runs over all S slots.
        emb_bytes = D.quantized_param_bytes({"tok_emb": tree["tok_emb"]})
        return ((D.quantized_param_bytes(tree) - emb_bytes + kv_bytes)
                / peak_bw * 1e3)

    step_ms = statistics.median(t["step_ms"])
    bound = step_bound_ms(params)
    # The device's idle share over a few decode steps.
    pos, mask, pad = prefill_mask(lens, P, S, dev)
    cache = D.empty_cache(cfg, B, S, device=dev)
    prefix = torch.as_tensor(ids, device=dev)
    logits, _ = D.forward(params, prefix, pos, cache, 0, cfg, attn_mask=mask)
    tok = logits[:, -1].argmax(-1)
    del logits
    key = torch.arange(S, device=dev)[None, None, :]

    def steps():
        for i in range(DEC_PROFILE_STEPS):
            step_mask = torch.where((key >= pad[:, None, None])
                                    & (key <= P + i), 0.0, NEG_INF)
            D.forward(params, tok[:, None], (P + i - pad)[:, None], cache,
                      P + i, cfg, attn_mask=step_mask)

    steps()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    steps_wall = (time.perf_counter() - t1) * 1e3
    prof = profile_batch(steps, "/dev/null", steps_wall,
                         phase="profile_decode")
    del cache
    emit({
        "phase": "decode", "part": "bf16", "card": card,
        "model": "llama3_8b", "layers": cfg.layers, "batch": B,
        "prompt_width": P, "prompt_tokens": int(lens.sum()),
        "max_seq": S, "max_new": N, "draw_s": draw_s,
        "prefill_ms": t["prefill_ms"],
        "prefill_tokens_per_s": B * P / (t["prefill_ms"] / 1e3),
        "prefill_flops": prefill_flops,
        "prefill_share_of_bf16_peak":
            prefill_flops / (t["prefill_ms"] / 1e3) / peak_bf16,
        "decode_step_ms_median": step_ms,
        "decode_step_ms_p10_p90": [float(np.percentile(t["step_ms"], q))
                                   for q in (10, 90)],
        "decode_tokens_per_s": B / (step_ms / 1e3),
        "generate_wall_ms": t["wall_ms"],
        "step_bound_ms": bound, "step_bound_by": "bytes",
        "step_share_of_bound": bound / step_ms,
        "weight_bytes": D.quantized_param_bytes(params),
        "kv_bytes": kv_bytes,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "profile_steps": DEC_PROFILE_STEPS, "steps_wall_ms": steps_wall,
        "steps_device_busy_ms": prof["device_busy_ms"],
        "steps_device_idle_share": prof["device_idle_share"],
        "top_kernels": prof["top_kernels"][:6],
        "tokens_row0": toks[0, :16].tolist()})


    # ---- 2. W8A8: the same weights quantized on the card.
    t0 = time.perf_counter()
    q8 = D.quantize_decoder_params(params, cfg)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    D.make_generate_fn(cfg, S, 2)(q8, ids, lens, 0, 0.0, 0.95, DEC_EOS)
    toks8, t8 = timed_generate(D, gen, q8, ids, lens, DEC_EOS)
    check(toks8.shape == (B, N), "decode w8a8: tokens shape")
    step8 = statistics.median(t8["step_ms"])
    bound8 = step_bound_ms(q8)
    with torch.inference_mode():
        products = w8a8_products(D, cfg, params, q8, ids[:1], dev)
        ref = teacher_forced(D, cfg, params, ids, lens, S, dev)
        got = teacher_forced(D, cfg, q8, ids, lens, S, dev)
        agree = rows_agree(got, ref)
        del ref, got
        one = dataclasses.replace(cfg, layers=1)
        agree_1 = rows_agree(
            teacher_forced(D, one, first_layers(q8, 1), ids, lens, S, dev),
            teacher_forced(D, one, first_layers(params, 1), ids, lens, S,
                           dev))
    emit({
        "phase": "decode", "part": "w8a8", "card": card, "batch": B,
        "quantize_s": quant_s, "prefill_ms": t8["prefill_ms"],
        "decode_step_ms_median": step8,
        "decode_tokens_per_s": B / (step8 / 1e3),
        "step_bound_ms": bound8, "step_bound_by": "bytes",
        "step_share_of_bound": bound8 / step8,
        "speedup_vs_bf16": step_ms / step8,
        "weight_bytes": D.quantized_param_bytes(q8),
        "products": products, "exact_rtol": W8A8_EXACT_RTOL,
        "teacher_forced_vs_bf16": agree,
        "teacher_forced_vs_bf16_1_layer": agree_1,
        "tokens_equal_to_bf16": float((toks8 == toks).float().mean()),
        "max_memory_allocated": torch.cuda.max_memory_allocated()})
    for name, row in products.items():
        check(row["rel_diff_to_f32"] <= W8A8_EXACT_RTOL,
              f"decode w8a8: {name} int8 path vs f32 {row}")
    check(math.isfinite(agree["cos_min"]) and agree["cos_min"] > 0,
          "decode w8a8: logits not finite")
    del q8
    torch.cuda.empty_cache()

    # ---- phase 13: dp×tp decode from the same bf16 weights.
    decode_mesh(D, cfg, params, ids, lens, dev, card)

    # ---- 3. the card against the CPU, full width at 2 layers.
    cfg2 = dataclasses.replace(cfg, layers=DEC_CPU_LAYERS)
    p2 = first_layers(params, DEC_CPU_LAYERS)
    del params
    torch.cuda.empty_cache()
    cpu = {k: v.cpu() for k, v in p2.items() if k != "layers"}
    cpu["layers"] = {k: v.cpu() for k, v in p2["layers"].items()}
    ids2, lens2 = decoder_prompts(rng, cfg, 2, DEC_CPU_PROMPT,
                                  DEC_CPU_PROMPT, DEC_CPU_PROMPT)
    t0 = time.perf_counter()
    with torch.inference_mode():
        card_rows = teacher_forced(D, cfg2, p2, ids2, lens2,
                                   DEC_CPU_PROMPT, dev).cpu()
        cpu_rows = teacher_forced(D, cfg2, cpu, ids2, lens2,
                                  DEC_CPU_PROMPT, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    agree = rows_agree(card_rows, cpu_rows)
    top = cpu_rows.topk(2, dim=-1).values
    near = (top[:, 0] - top[:, 1]) < 2 * agree["max_abs_diff"]
    flips = card_rows.argmax(-1) != cpu_rows.argmax(-1)
    agree["flips"] = int(flips.sum())
    agree["flips_past_near_ties"] = int((flips & ~near).sum())
    emit({"phase": "decode", "part": "card_vs_cpu", "card": card,
          "layers": DEC_CPU_LAYERS, "prompts": 2,
          "prompt_tokens": DEC_CPU_PROMPT, **agree,
          "cos_bar": DEC_CPU_COS_MIN, "argmax_bar": DEC_CPU_ARGMAX_MIN,
          "seconds": cpu_s})
    check(agree["cos_min"] >= DEC_CPU_COS_MIN,
          f"decode card vs CPU: cosine {agree['cos_min']}")
    check(agree["argmax_agree"] >= DEC_CPU_ARGMAX_MIN
          and agree["flips_past_near_ties"] == 0,
          f"decode card vs CPU: argmax {agree}")


def last_logits(params, cfg, seq, dev) -> torch.Tensor:
    """The logits [V] after ``seq``, one sequence on ``dev``."""
    from classmate_rag_tpu_torch.models import decoder as D
    from classmate_rag_tpu_torch.utils.numerics import NEG_INF

    n = len(seq)
    pos = torch.arange(n, device=dev)[None]
    mask = torch.where(torch.arange(n, device=dev)[None, None]
                       <= pos[:, :, None], 0.0, NEG_INF)
    with torch.inference_mode():
        logits, _ = D.forward(params, torch.tensor([seq], device=dev), pos,
                              D.empty_cache(cfg, 1, n, device=dev), 0, cfg,
                              attn_mask=mask)
    return logits[0, -1]


def near_tie_margin(runner, prompt_ids, prefix) -> float:
    """Top-1 minus top-2 logit after ``prompt_ids + prefix``, computed on
    the runner's card as one sequence."""
    top = last_logits(runner.params, runner.config,
                      list(prompt_ids) + list(prefix),
                      runner.device).topk(2).values
    return float(top[0] - top[1])


def agree_until_near_tie(params, cfg, dev, ids, lens, want, got,
                         bar: float) -> dict:
    """Greedy rows ``got`` against the reference's ``want`` ([B, N]):
    each row equal, or equal up to a step where both tokens taken score
    within ``bar`` of the best one in the reference's logits there (one
    sequence, teacher-forced): a near-tie, the rule of
    tests/test_torch_decode_runner.py."""
    want, got = want.cpu(), got.cpu()
    width = ids.shape[1]
    out = {"rows_equal": 0, "first_difference": [], "gaps": [],
           "bar": bar, "tokens_equal": float((want == got).float().mean())}
    for r in range(want.shape[0]):
        diff = (want[r] != got[r]).nonzero()
        if not len(diff):
            out["rows_equal"] += 1
            continue
        k = int(diff[0])
        logits = last_logits(params, cfg, list(ids[r, width - lens[r]:])
                             + want[r, :k].tolist(), dev)
        best = logits.max()
        gaps = [float(best - logits[int(x[r, k])]) for x in (want, got)]
        out["first_difference"].append(k)
        out["gaps"].append(gaps)
        check(max(gaps) < bar, f"row {r} differs at step {k} past a "
              f"near-tie: the tokens taken score {gaps} under the best "
              f"(bar {bar})")
    return out


def f32_last_logits(D, cfg, params, ids, pos, mask, dev) -> torch.Tensor:
    """The last position's logits [B, V] of ``decoder.forward`` in f32
    (each layer's weights upcast in turn; the KV cache stays bf16, as
    the decoder keeps it)."""
    c32 = dataclasses.replace(cfg, compute_dtype=torch.float32, layers=1)
    cos, sin = D._rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    k, v = D.empty_cache(c32, ids.shape[0], mask.shape[-1], device=dev)
    x = D._embed(params["tok_emb"], ids)
    for i in range(cfg.layers):
        lp = {key: w[i].float() for key, w in params["layers"].items()}
        x = D._layer(lp, x, cos, sin, (k[0], v[0]), 0, mask, c32, i)
    x = D._rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return D._mm(x, params["lm_head"].float(), torch.float32)


def decode_mesh(D, cfg, params, ids, lens, dev, card: str) -> None:
    """Phase 13, decode: dp×tp decode of phase 9's prompts on logical
    ranks of the one card against the single-device decode, at full
    depth on ``auto_mesh_for`` over 4 ranks, then at 2 layers on (2, 2)."""
    from classmate_rag_tpu_torch.parallel import tp_decode as TTP
    from classmate_rag_tpu_torch.parallel.mesh import DeviceMesh

    t_phase = time.perf_counter()
    B, P, S, N = DEC_BATCH, DEC_PROMPT, DEC_MAX_SEQ, MESH_NEW
    pos, mask, _pad = prefill_mask(lens, P, S, dev)
    prefix = torch.as_tensor(ids, device=dev)
    parts = []
    for c, mesh in (
            (cfg, TTP.auto_mesh_for(cfg, [dev] * MESH_DECODE_RANKS)),
            (dataclasses.replace(cfg, layers=MESH_DECODE_LAYERS_2x2),
             DeviceMesh([[dev] * 2] * 2))):
        tree = first_layers(params, c.layers)
        t0 = time.perf_counter()
        shards = TTP.shard_decoder_params(tree, c, mesh)
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        with torch.inference_mode():
            cache = D.empty_cache(c, B, S, device=dev)
            one = D.forward(tree, prefix, pos, cache, 0, c,
                            attn_mask=mask)[0][:, -1].clone()
            del cache
            caches = TTP.empty_tp_cache(c, mesh, B, S)
            many = TTP.tp_forward(shards, prefix, pos, caches, 0, c, mesh,
                                  mask)[:, -1].clone()
            del caches
            ref = f32_last_logits(D, c, tree, prefix, pos, mask, dev)
            agree = rows_agree(many, one)
            one_ref, many_ref = rows_agree(one, ref), rows_agree(many, ref)
            del one, many, ref
            gen1 = D.make_generate_fn(c, S, N)
            gen = TTP.make_tp_generate_fn(c, mesh, S, N)
            gen(shards, ids, lens, 0, 0.0, 0.95, DEC_EOS)      # warm-up
            want, t1 = timed_generate(D, gen1, tree, ids, lens, DEC_EOS)
            got, tm = timed_generate(TTP, gen, shards, ids, lens, DEC_EOS,
                                     forward="tp_forward")
        tokens = agree_until_near_tie(
            tree, c, dev, ids, lens, want, got,
            max(MESH_NEAR_TIE, 2 * agree["max_abs_diff"]))
        check(agree["cos_min"] >= MESH_COS_MIN,
              f"mesh decode {mesh.shape}: first-step logits cosine "
              f"{agree['cos_min']} to one device")
        check(1 - many_ref["cos_min"] <= MESH_REF_RATIO
              * (1 - one_ref["cos_min"]) + MESH_REF_FLOOR,
              f"mesh decode {mesh.shape}: {many_ref} from the f32 "
              f"evaluation, one device {one_ref}")
        whole = D.quantized_param_bytes(tree)
        first = D.quantized_param_bytes(
            {k: tree[k] for k in TTP.FIRST_RANK_KEYS})
        parts.append({
            "mesh": mesh.shape, "layers": c.layers, "shard_s": shard_s,
            "first_step_logits": agree, "f32_vs_mesh": many_ref,
            "f32_vs_one_device": one_ref, "tokens": tokens,
            "step_ms_median": statistics.median(tm["step_ms"]),
            "single_step_ms_median": statistics.median(t1["step_ms"]),
            "prefill_ms": tm["prefill_ms"],
            "single_prefill_ms": t1["prefill_ms"],
            # Each rank's bytes; the first of a row also holds the token
            # embedding and the final norm (the rest is split).
            "rank_weight_bytes": TTP.rank_param_bytes(shards),
            "whole_weight_bytes": whole,
            "first_rank_only_bytes": first,
            "split_bytes_per_rank_ideal": (whole - first)
            / mesh.shape["model"]})
        del shards
        torch.cuda.empty_cache()
    emit({"phase": "mesh", "part": "decode", "card": card,
          "ranks": "logical devices, all on cuda:0 (the machine's one card)",
          "model": "llama3_8b", "batch": B, "prompt_width": P,
          "max_new": N, "parts": parts, "cos_bar": MESH_COS_MIN,
          "f32_ratio_bar": MESH_REF_RATIO, "near_tie_bar": MESH_NEAR_TIE,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "seconds": time.perf_counter() - t_phase})


def decode_runner(card: str) -> None:
    """Part 4: get_runner with LLM_BACKEND=tpu on the card (the default
    small config): a chat_batch of 8 against 8 chats at temperature 0;
    and a small decoder written as a Q8_0 GGUF by the port, loaded by
    DecodeRunner and answering."""
    import os

    from classmate_rag_tpu_torch.config import load_config
    from classmate_rag_tpu_torch.generation.runner import (
        DecodeRunner, get_runner,
    )
    from classmate_rag_tpu_torch.models import decoder as D
    from classmate_rag_tpu_torch.models import gguf as G

    os.environ.update(LLM_BACKEND="tpu", LLM_TEMPERATURE="0",
                      LLM_MAX_TOKENS=str(RUNNER_NEW))
    t0 = time.perf_counter()
    runner = get_runner(load_config(reload=True))
    build_s = time.perf_counter() - t0
    check(isinstance(runner, DecodeRunner) and runner.device.type == "cuda",
          f"decode runner: {runner!r}")
    topics = ["derivatives", "eigenvalues", "pasta", "relativity",
              "photosynthesis", "sorting", "the french revolution",
              "integrals"]
    convs = [[{"role": "system", "content": "Answer with citations."},
              {"role": "user", "content": f"Explain {t} in two lines."}]
             for t in topics]
    prompts = [runner._encode_prompt(c) for c in convs]
    t0 = time.perf_counter()
    singles = [runner.chat(c, temperature=0.0, max_tokens=RUNNER_NEW)
               for c in convs]
    singles_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batched = runner.chat_batch(convs, temperature=0.0,
                                max_tokens=RUNNER_NEW)
    batch_s = time.perf_counter() - t0
    ids_1 = [runner.generate_ids_batch([p])[0] for p in prompts]
    ids_8 = runner.generate_ids_batch(prompts)
    margins = []
    for p, a, b in zip(prompts, ids_1, ids_8):
        if a == b:
            continue
        k = next(i for i in range(max(len(a), len(b)))
                 if a[i:i + 1] != b[i:i + 1])
        margins.append(near_tie_margin(runner, p, b[:k]))
    emit({"phase": "decode", "part": "runner", "card": card,
          "model": runner.model_name, "max_seq": runner.max_seq,
          "max_new": runner.max_new, "build_s": build_s,
          "chat_s_each": singles_s / len(convs), "chat_batch_s": batch_s,
          "strings_equal": sum(a == b for a, b in zip(singles, batched)),
          "ids_equal": sum(a == b for a, b in zip(ids_1, ids_8)),
          "near_tie_margins": margins, "near_tie_bar": DEC_NEAR_TIE})
    check(all(m < DEC_NEAR_TIE for m in margins),
          f"decode runner: batch of 8 and of 1 differ past a near-tie "
          f"({margins})")
    check(all(isinstance(x, str) for x in batched), "decode runner: output")
    del runner
    torch.cuda.empty_cache()

    # ---- a GGUF written by the port.
    with tempfile.TemporaryDirectory() as tmp:
        cfg = D.DecoderConfig.small()
        tokens = ["<unk>", "<s>", "</s>"] + [
            f"<0x{b:02X}>" for b in range(256)]
        tokens += [f"\u2581w{i}" for i in range(cfg.vocab_size - len(tokens))]
        t0 = time.perf_counter()
        path = Path(tmp) / "small.Q8_0.gguf"
        G.export_decoder_to_gguf(
            path, D.init_params(cfg, "chip-smoke-gguf"), cfg,
            quant_type=G.GGML_Q8_0, extra_metadata={
                "tokenizer.ggml.model": "llama",
                "tokenizer.ggml.tokens": (G.T_ARRAY, (G.T_STRING, tokens)),
                "tokenizer.ggml.scores": (
                    G.T_ARRAY, (G.T_FLOAT32, [0.0] * len(tokens))),
                "tokenizer.ggml.bos_token_id": 1,
                "tokenizer.ggml.eos_token_id": 2})
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gr = DecodeRunner(model_dir=str(path), max_seq=512,
                          max_new_tokens=32)
        load_s = time.perf_counter() - t0
        answer = gr.chat(convs[0], temperature=0.0)
        check(gr.has_pretrained_weights and isinstance(
            gr.tokenizer, G.GGUFTokenizer), "decode gguf: not loaded")
        check(bool(answer), "decode gguf: empty answer")
        emit({"phase": "decode", "part": "gguf", "card": card,
              "model": gr.model_name, "file_bytes": path.stat().st_size,
              "write_s": write_s, "load_s": load_s,
              "answer_chars": len(answer), "eos_ids": gr.eos_ids})


def decode_child() -> int:
    """Phase 9 in its own process: one JSON line per part."""
    from classmate_rag_tpu_torch.device import pin_fp32_matmul
    from classmate_rag_tpu_torch.models import decoder as D

    pin_fp32_matmul()        # f32 products in full f32 (the W8A8 check)
    card = smi_line()
    decode_full_width(D, D.DecoderConfig.llama3_8b(), torch.device("cuda"),
                      card)
    torch.cuda.empty_cache()
    decode_runner(card)
    return 0


def decode_phase() -> list:
    """Run the decode child and relay its lines."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--decode-child"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    for line in lines:
        emit(line)
    check(proc.returncode == 0,
          f"decode child failed (rc={proc.returncode}):\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    check({ln.get("part") for ln in lines} >= {
        "bf16", "w8a8", "card_vs_cpu", "runner", "gguf"},
        "decode child: a part is missing")
    check(any(ln.get("phase") == "mesh" for ln in lines),
          "decode child: phase 13's decode line is missing")
    emit({"phase": "decode", "part": "child",
          "seconds": time.perf_counter() - t0})
    return lines


# ---------------------------------------------------------------------------
# Training (phase 10): E5-base fine-tuned on the card, flash attention
# forward and backward, then served from its checkpoint
# ---------------------------------------------------------------------------

TRAIN_BATCH = 32           # pairs a step
TRAIN_SEQ = 128            # the smallest bucket the flash gate takes
TRAIN_STEPS = 30
TRAIN_WARMUP = 10
TRAIN_LR = 1e-4
TRAIN_BATCHES = 8          # a fixed set of batches, cycled
TRAIN_PROFILE_STEPS = 4
TRAIN_CPU_LAYERS = 2       # the card vs CPU step
TRAIN_CPU_BATCH = 8
BWD_COS_MIN = 0.9999       # backward kernels vs the plain autograd
BWD_ERR_REL = 2e-2         # max |d| <= this * max |plain|
TRAIN_LOSS_REL = 1e-3      # card vs CPU loss (bf16 sums in other orders)
TRAIN_GRAD_COS = 0.999     # card vs CPU, each gradient leaf
SERVE_COS_MIN = 0.99999    # the checkpoint's embedder vs the trained model
FLASH_LIB = "jax/experimental/pallas/ops/tpu/flash_attention.py"
# cuBLAS's and CUTLASS's f32 GEMM kernels, by the names the profiler
# gives them (sm80_xmma_gemm_f32f32_*, cutlass_80_simt_sgemm_*).
F32_GEMM_KERNELS = ("gemm_f32f32", "sgemm")


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()).clamp_min(1e-300))


def flash_bwd_kernels(tatt, peaks):
    """The D kernel and the fused backward kernel against the plain
    version's autograd at (B 32, T 128), (16, 256), (8, 512) and
    (4, 200), 12 heads, with padded rows, a row of one real key and a
    row of none; the LSE-writing forward bit-equal to the serving
    forward. Times at the first three shapes: the fused kernel's
    ``library`` is the backward of ``F.scaled_dot_product_attention``
    with the same boolean key mask (dq, dk and dv in one call, its own D
    included), ``plain`` the plain version's backward; the D kernel's
    plain version is four torch ops (out·dout in f32, summed). Beside
    them, on a held stream: the whole backward (``flash_attn_bwd``: D
    kernel + fused kernel) and, where T > 128, the fused kernel with its
    counters set past any key-block count, so that no CTA converts the
    f32 workspace (the difference is the conversion). Returns the
    (32, 128) rows of both kernels and every shape's."""
    import torch.nn.functional as F

    bw, bf16_peak, _f32, _int8_peak = peaks
    nh, hd, scale = 12, 64, 0.125
    h = nh * hd
    rng = np.random.default_rng(13)
    worst = {"dq": (1.0, 0.0), "dk": (1.0, 0.0), "dv": (1.0, 0.0)}
    rows = {}
    for b, t in ((32, 128), (16, 256), (8, 512), (4, 200)):
        qkv = torch.from_numpy(rng.normal(0, 1.0, (b, t, 3, nh, hd))
                               .astype(np.float32)).to(torch.bfloat16).cuda()
        qkv.requires_grad_(True)
        lengths = rng.integers(1, t + 1, b)
        lengths[:3] = (0, 1, t)
        mask = torch.from_numpy((np.arange(t)[None, :] < lengths[:, None])
                                .astype(np.int32)).cuda()
        dout = torch.from_numpy(rng.normal(0, 1.0, (b, t, h))
                                .astype(np.float32)).to(torch.bfloat16).cuda()
        q, k, v = qkv.unbind(2)
        qd, kd, vd = (x.detach() for x in (q, k, v))
        serving = tatt.flash_attn(qd, kd, vd, mask, scale)
        out, lse = tatt.flash_attn(qd, kd, vd, mask, scale, with_lse=True)
        torch.cuda.synchronize()
        check(torch.equal(out, serving),
              f"flash_attn B={b} T={t}: the LSE forward's output differs "
              "from the serving forward's")
        got = torch.autograd.grad(tatt.flash_attention(q, k, v, mask, scale),
                                  qkv, dout)[0].float()
        want = torch.autograd.grad(
            tatt.attention_reference(q, k, v, mask, scale), qkv,
            dout)[0].float()
        torch.cuda.synchronize()
        for i, name in enumerate(("dq", "dk", "dv")):
            g, w = got[:, :, i], want[:, :, i]
            check(bool(torch.isfinite(g).all()),
                  f"flash_attn_bwd B={b} T={t}: non-finite {name}")
            c, err = cosine(g, w), (g - w).abs().max().item()
            check(c >= BWD_COS_MIN and err <= BWD_ERR_REL * w.abs().max()
                  .item(), f"flash_attn_bwd B={b} T={t} {name}: cosine {c}, "
                  f"max |d| {err} (max |plain| {w.abs().max().item()})")
            worst[name] = (min(worst[name][0], c), max(worst[name][1], err))
        if t == 200:
            continue
        mask_i = mask.contiguous()
        delta, ws, count = tatt.flash_attn_bwd_delta(out, dout, nh)

        def torch_delta():  # the plain D: four torch ops
            return (out.float() * dout.float()).view(b, t, nh, hd).sum(-1)

        d_err = (delta - torch_delta().permute(0, 2, 1)).abs().max().item()
        check(d_err <= 1e-5 * torch_delta().abs().max().item(),
              f"flash_attn_bwd_delta B={b} T={t}: max |d| {d_err}")
        keys = int(np.where(lengths > 0, lengths, t).sum())  # what P covers
        qr, kr, vr = (x.clone().requires_grad_(True) for x in (qd, kd, vd))
        ref = tatt.attention_reference(qr, kr, vr, mask, scale)
        plain_ms = time_ms(lambda: torch.autograd.grad(
            ref, (qr, kr, vr), dout, retain_graph=True))
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (qd, kd, vd))
        lib = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask.bool()[:, None, None, :])
        dout_t = dout.view(b, t, nh, hd).transpose(1, 2)

        def library():
            return torch.autograd.grad(lib, (qt, kt, vt), dout_t,
                                       retain_graph=True)

        def fused():
            return tatt.flash_attn_bwd_fused(qd, kd, vd, dout, mask_i, lse,
                                             delta, ws, count, scale)

        shape = {"B": b, "T": t, "heads": nh, "head_dim": hd, "keys": keys}
        err = max(e for _c, e in worst.values())
        fused_row = kernel_row(
            "flash_attn_bwd", "flash_attn_bwd.cu",
            f"{FLASH_LIB}:941 (_flash_attention_bwd_dkv) and :1287 "
            "(_flash_attention_bwd_dq)", shape, err, fused, tatt.LAUNCHES,
            plain_ms, library,
            # q and dO read for every row, k and v where P covers them;
            # dq, dk, dv written; lse, D and the mask.
            2 * b * t * h * 2 + 2 * keys * h * 2 + 3 * b * t * h * 2
            + 2 * b * t * nh * 4 + b * t * 4,
            # S, dP, dV, dK and dQ over the keys P covers, every query row.
            10.0 * nh * hd * t * keys, bw, bf16_peak)
        delta_row = kernel_row(
            "flash_attn_bwd_delta", "flash_attn_bwd.cu", f"{FLASH_LIB}:273",
            shape, d_err, lambda: tatt.flash_attn_bwd_delta(out, dout, nh),
            tatt.LAUNCHES, time_ms(torch_delta), None,
            2 * b * t * h * 2 + b * t * nh * 4,   # out, dout read; D written
            2.0 * b * t * h, bw, bf16_peak)
        delta_row["plain_queued_ms"] = queued_ms(torch_delta)
        fused_row.update(
            items=b * nh * -(-t // 128), resident_ctas=tatt.bwd_resident_ctas(),
            workspace=ws is not None,
            whole_queued_ms=queued_ms(lambda: tatt.flash_attn_bwd(
                qd, kd, vd, out, dout, mask_i, lse, scale)))
        if ws is not None:
            count.fill_(1 << 30)     # no CTA reaches the last count
            fused_row["no_conversion_queued_ms"] = queued_ms(fused)
            count.zero_()
        rows[(b, t)] = (fused_row, delta_row)
    for fused_row, _d in rows.values():
        fused_row["worst"] = {n: {"cosine": c, "max_abs_err": e}
                              for n, (c, e) in worst.items()}
    return rows[(32, 128)], [r for pair in rows.values() for r in pair]


MESH_HEAD_SHAPES = ((16, 128, 3), (16, 128, 6), (4, 256, 3))


def flash_heads(tatt) -> list:
    """Phase 13's kernel checks: the flash forward and both backward
    kernels at a tensor-parallel rank's head counts (E5-base's 12 heads
    over tp 4 and 2), with padded rows, a row of one real key and a row
    of none, against the plain version: the forward within ATTN_TOL
    (|v| <= 1, phase 2's bar) and bit-equal to the LSE-writing forward,
    dq, dk and dv at phase 10's bars."""
    rng = np.random.default_rng(14)
    out = []
    for b, t, nh in MESH_HEAD_SHAPES:
        x = rng.normal(0, 1.0, (b, t, 3, nh, 64)).astype(np.float32)
        x[:, :, 2] = rng.uniform(-1, 1, (b, t, nh, 64))
        qkv = torch.from_numpy(x).to(torch.bfloat16).cuda()
        qkv.requires_grad_(True)
        lengths = rng.integers(1, t + 1, b)
        lengths[:3] = (0, 1, t)
        mask = torch.from_numpy((np.arange(t)[None, :] < lengths[:, None])
                                .astype(np.int32)).cuda()
        dout = torch.from_numpy(rng.normal(0, 1.0, (b, t, nh * 64))
                                .astype(np.float32)).to(torch.bfloat16).cuda()
        q, k, v = qkv.unbind(2)
        qd, kd, vd = (y.detach() for y in (q, k, v))
        serving = tatt.flash_attn(qd, kd, vd, mask, 0.125)
        with_lse, _lse = tatt.flash_attn(qd, kd, vd, mask, 0.125,
                                         with_lse=True)
        plain = tatt.attention_reference(qd, kd, vd, mask, 0.125)
        torch.cuda.synchronize()
        name = f"flash_attn B={b} T={t} heads={nh}"
        check(torch.equal(serving, with_lse),
              f"{name}: the LSE forward's output differs from serving")
        fwd_err = (serving.float() - plain.float()).abs().max().item()
        check(bool(torch.isfinite(serving.float()).all())
              and fwd_err <= ATTN_TOL, f"{name}: max |d| {fwd_err}")
        got = torch.autograd.grad(tatt.flash_attention(q, k, v, mask, 0.125),
                                  qkv, dout)[0].float()
        want = torch.autograd.grad(
            tatt.attention_reference(q, k, v, mask, 0.125), qkv,
            dout)[0].float()
        torch.cuda.synchronize()
        row = {"B": b, "T": t, "heads": nh, "fwd_max_abs_err": fwd_err}
        for i, g_name in enumerate(("dq", "dk", "dv")):
            g, w = got[:, :, i], want[:, :, i]
            c, err = cosine(g, w), (g - w).abs().max().item()
            check(bool(torch.isfinite(g).all()) and c >= BWD_COS_MIN
                  and err <= BWD_ERR_REL * w.abs().max().item(),
                  f"flash_attn_bwd B={b} T={t} heads={nh} {g_name}: cosine "
                  f"{c}, max |d| {err}")
            row[g_name] = {"cosine": c, "max_abs_err": err}
        out.append(row)
    return out


def train_batches(docs, tokenizer):
    """TRAIN_BATCHES fixed batches of TRAIN_BATCH (query, passage) pairs
    mined from the slice corpus (``mine_pairs``: each passage's top
    tf-idf terms query it) and padded to TRAIN_SEQ (``encode_pairs``)."""
    from classmate_rag_tpu_torch.index.catalog import Catalog, CatalogEntry
    from classmate_rag_tpu_torch.training.data import encode_pairs, mine_pairs

    n = TRAIN_BATCH * TRAIN_BATCHES
    with tempfile.TemporaryDirectory() as d:
        catalog = Catalog.load_or_create(d)
        for i, words in enumerate(docs[:n]):
            catalog.upsert(CatalogEntry(f"t{i}", " ".join(words), words, {}))
        pairs = mine_pairs(catalog, max_pairs=n)
    batches = list(encode_pairs(pairs, tokenizer, batch_size=TRAIN_BATCH,
                                seq_len=TRAIN_SEQ))
    check(len(batches) == TRAIN_BATCHES, f"{len(batches)} training batches")
    return batches


def train_card_vs_cpu(tree, cfg, batch) -> dict:
    """One step's loss and gradients at full width and TRAIN_CPU_LAYERS
    layers, on the card (flash kernels forward and backward) and on a
    CPU copy (the plain versions). ``k_b``'s gradient is exactly 0 in
    exact arithmetic (the softmax ignores a shift common to all keys),
    so both sides hold rounding noise there: reported, not barred."""
    from classmate_rag_tpu_torch.embeddings.model import params_from_numpy
    from classmate_rag_tpu_torch.training import contrastive as T

    cfg2 = dataclasses.replace(cfg, layers=TRAIN_CPU_LAYERS)
    tree2 = {**tree, "layers": {k: v[:TRAIN_CPU_LAYERS]
                                for k, v in tree["layers"].items()}}
    names = [f"{n[0]}/{n[1]}[{i}]" if n[0] == "layers" else n[0]
             for n in T.param_names()
             for i in (range(TRAIN_CPU_LAYERS) if n[0] == "layers" else [0])]
    out = {}
    for dev in ("cuda", "cpu"):
        model = params_from_numpy(tree2, cfg2, dev, trainable=True)
        arrays = [torch.as_tensor(a[:TRAIN_CPU_BATCH])
                  .to(model.word_emb.device) for a in batch]
        loss, _ = T.info_nce(model, 0.05, *arrays)
        grads = torch.autograd.grad(loss, T.param_leaves(model))
        out[dev] = (loss.item(), [g.float().cpu() for g in grads])
        del model, grads
    (l_card, g_card), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    check(rel <= TRAIN_LOSS_REL, f"train card vs CPU: loss {l_card} vs "
          f"{l_cpu}")
    cos = {n: cosine(a, b) for n, a, b in zip(names, g_card, g_cpu,
                                              strict=True)}
    barred = {n: c for n, c in cos.items() if "/k_b[" not in n}
    worst = min(barred, key=barred.get)
    check(barred[worst] >= TRAIN_GRAD_COS,
          f"train card vs CPU: gradient {worst} cosine {barred[worst]}")
    return {"layers": TRAIN_CPU_LAYERS, "batch": TRAIN_CPU_BATCH,
            "loss_card": l_card, "loss_cpu": l_cpu, "loss_rel": rel,
            "grad_cos_min": barred[worst], "grad_cos_min_leaf": worst,
            "k_b_cos": {n: c for n, c in cos.items() if "/k_b[" in n}}


def f32_gemm_ms(events) -> float:
    """Device time of the f32 GEMM kernels in a profiler's
    ``key_averages()``: the f32 backward products of ``_MmF32`` (and
    the [B, B] logits, a rounding error beside them)."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in events
               if e.device_type == cuda
               and any(n in e.key for n in F32_GEMM_KERNELS)) / 1e3


def train_phase(tatt, docs, counts, peaks, ckpt_dir: Path) -> dict:
    """Phase 10: the training path at E5-base's full width and depth;
    the trained state is saved to ``ckpt_dir`` (phase 11 rebuilds onto
    it)."""
    from classmate_rag_tpu_torch.config import EmbeddingConfig
    from classmate_rag_tpu_torch.embeddings import get_embedder
    from classmate_rag_tpu_torch.embeddings.model import (
        EncoderConfig,
        encoder_flops,
        init_params,
    )
    from classmate_rag_tpu_torch.embeddings.tokenizer import (
        bucket_length,
        load_tokenizer,
        pad_to_bucket,
    )
    from classmate_rag_tpu_torch.training import checkpoint as C
    from classmate_rag_tpu_torch.training import contrastive as T

    t_phase = time.perf_counter()
    card = smi_line()
    cfg = dataclasses.replace(EncoderConfig.base(), flash_min_seq=TRAIN_SEQ)
    t0 = time.perf_counter()
    tree = init_params(cfg, MODEL_NAME)
    tok = load_tokenizer(None, max_length=TRAIN_SEQ,
                         vocab_size=cfg.vocab_size)
    batches = train_batches(docs, tok)
    setup_s = time.perf_counter() - t0
    card_vs_cpu = train_card_vs_cpu(tree, cfg, batches[0])

    init, step = T.make_train_step(cfg, learning_rate=TRAIN_LR,
                                   warmup_steps=TRAIN_WARMUP,
                                   total_steps=TRAIN_STEPS)
    evaluate = T.make_eval_step(cfg)
    state = init(tree)

    def eval_all():
        res = [evaluate(state.params, *bt) for bt in batches]
        return (float(np.mean([float(lo) for lo, _a in res])),
                float(np.mean([float(a) for _l, a in res])))

    eval0 = eval_all()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # The main path: every count 0 just before, read after one step and
    # after all of them.
    counts.reset()
    state, loss = step(state, *batches[0])
    torch.cuda.synchronize()
    one = counts.read()
    per_step = 2 * cfg.layers      # 2 encodes x 12 layers
    want = {k: 0 for k in one}
    want.update(flash_attn=per_step, flash_attn_bwd_delta=per_step,
                flash_attn_bwd=per_step)
    check(one == want, f"one train step launched {one}, want {want}")
    losses = [float(loss)]

    def steps():
        nonlocal state
        for _ in range(TRAIN_PROFILE_STEPS):
            state, lo = step(state, *batches[state.step % TRAIN_BATCHES])
            losses.append(float(lo))

    # 4 steps timed on the host, then 4 (or, for a whole trace, up to
    # 4 * TRACES) traced; the rest of the 30 timed one by one.
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events, traces = traced(steps, tatt.LAUNCHES, cpu=True)
    prof_line = profile_summary(events, wall_ms, "profile_train")
    step_ms = []
    while state.step < TRAIN_STEPS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step(state, *batches[state.step % TRAIN_BATCHES])
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    f32_ms = f32_gemm_ms(events) / TRAIN_PROFILE_STEPS
    check(f32_ms > 0, "profile_train: no f32 GEMM kernel in the trace")
    launches = counts.read()
    check(state.step == TRAIN_STEPS, f"trained {state.step} steps")
    for name in ("flash_attn", *BACKWARD_KERNELS):
        check(launches[name] == per_step * TRAIN_STEPS,
              f"{name}: {launches[name]} launches in {TRAIN_STEPS} steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eval1 = eval_all()
    check(all(math.isfinite(x) for x in losses), "train: non-finite loss")
    check(eval1[0] < eval0[0], f"train: eval loss {eval0[0]} -> {eval1[0]}")
    check(eval1[1] >= eval0[1], f"train: in-batch accuracy {eval0[1]} -> "
          f"{eval1[1]}")

    med = statistics.median(step_ms)
    flops = 3 * 2 * encoder_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)

    # Train -> serve: the checkpoint through get_embedder on the card.
    rng = np.random.default_rng(21)
    questions = [" ".join(rng.choice(docs[int(i)], size=5, replace=False))
                 for i in rng.integers(0, len(docs), N_QUESTIONS)]
    t0 = time.perf_counter()
    C.save_train_state(state, ckpt_dir, config=cfg)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc = get_embedder(EmbeddingConfig(embedding_backend="e5"),
                       checkpoint=str(ckpt_dir))
    load_s = time.perf_counter() - t0
    digest = C._params_digest(state.params.params_numpy())
    check(enc.model_name.endswith(f"@ckpt-step_{TRAIN_STEPS}-{digest}"),
          f"served model name {enc.model_name}")
    got = enc.encode_queries(questions)
    rows = [enc.tokenizer.encode(f"query: {q}", enc.max_length)
            for q in questions]
    ids, mask = pad_to_bucket(rows, bucket_length(max(map(len, rows))))
    with torch.no_grad():
        want_v = state.params(torch.from_numpy(ids).cuda(),
                              torch.from_numpy(mask).cuda()).cpu().numpy()
    serve_cos = row_cos(got, want_v)
    check(got.shape == (N_QUESTIONS, DIM) and bool(np.isfinite(got).all()),
          "served vectors: bad output")
    check(serve_cos >= SERVE_COS_MIN,
          f"served vs trained query vectors: cosine {serve_cos}")
    del enc, state
    torch.cuda.empty_cache()
    line = {
        "phase": "train", "card": card, "model": MODEL_NAME,
        "layers": cfg.layers, "hidden": cfg.hidden,
        "vocab": cfg.vocab_size, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "steps": TRAIN_STEPS, "warmup": TRAIN_WARMUP, "lr": TRAIN_LR,
        "launches_one_step": one, "launches": launches,
        "train_loss_first_last": [losses[0], losses[-1]],
        "eval_loss": [eval0[0], eval1[0]],
        "eval_in_batch_acc": [eval0[1], eval1[1]],
        "step_ms_median": med, "step_ms": step_ms,
        "pairs_per_s": TRAIN_BATCH / (med / 1e3),
        "step_flops": flops,
        "bf16_peak_share": flops / (med / 1e3) / peaks[1],
        "f32_gemm_ms_per_step": f32_ms,
        "f32_gemm_share": f32_ms / (wall_ms / TRAIN_PROFILE_STEPS),
        "peak_memory_gb": peak_gb,
        "profile_steps": TRAIN_PROFILE_STEPS, "profile_traces": traces,
        "profile_wall_ms": wall_ms,
        "profile_busy_ms": prof_line["device_busy_ms"],
        "device_idle_share": prof_line["device_idle_share"],
        "card_vs_cpu": card_vs_cpu,
        "serve": {"model_name": f"...@ckpt-step_{TRAIN_STEPS}-{digest}",
                  "questions": N_QUESTIONS, "cos_min": serve_cos,
                  "save_s": save_s, "load_s": load_s},
        "setup_s": setup_s, "seconds": time.perf_counter() - t_phase,
    }
    emit(line)
    emit(prof_line)
    return line


MESH_TRAIN_RANKS = 8        # training_mesh over 8 logical ranks: (2, 4)
MESH_TRAIN_STEPS = 5
MESH_DEVICE = "cuda:0"      # the device every logical rank is on


def mesh_train_phase(docs, counts) -> dict:
    """Phase 13, train: E5-base at full width on training_mesh over 8
    logical ranks of the one card, (2, 4), against the single-device
    step from the same initial parameters on phase 10's first batches;
    the mesh's checkpoint restored on one device."""
    from classmate_rag_tpu_torch.embeddings.model import (
        EncoderConfig,
        init_params,
    )
    from classmate_rag_tpu_torch.embeddings.tokenizer import load_tokenizer
    from classmate_rag_tpu_torch.parallel.mesh import training_mesh
    from classmate_rag_tpu_torch.training import checkpoint as C
    from classmate_rag_tpu_torch.training import contrastive as T

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(EncoderConfig.base(), flash_min_seq=TRAIN_SEQ)
    tree = init_params(cfg, MODEL_NAME)
    batches = train_batches(docs, load_tokenizer(
        None, max_length=TRAIN_SEQ,
        vocab_size=cfg.vocab_size))[:MESH_TRAIN_STEPS]
    mesh = training_mesh(devices=[MESH_DEVICE] * MESH_TRAIN_RANKS)
    check(mesh.shape == {"data": 2, "model": 4}, f"mesh {mesh.shape}")
    kw = dict(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
              total_steps=TRAIN_STEPS)
    names = [f"{n[0]}/{n[1]}[{i}]" if n[0] == "layers" else n[0]
             for n in T.param_names()
             for i in (range(cfg.layers) if n[0] == "layers" else [0])]

    def run(device):
        init, step = T.make_train_step(cfg, device, **kw)
        state = init(tree)
        arrays = [torch.as_tensor(a).cuda() for a in batches[0]]
        loss, _ = T.info_nce(state.params, 0.05, *arrays)
        grads = [g for _key, g in T.full_leaves(
            state.params, torch.autograd.grad(
                loss, T.param_leaves(state.params)))]
        del loss, arrays
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for i, bt in enumerate(batches):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if i == 0:
                counts.reset()
            start.record()
            state, loss = step(state, *bt)
            end.record()
            end.synchronize()
            if i == 0:
                launches = counts.read()
            ms.append(start.elapsed_time(end))
            losses.append(float(loss))
        return state, grads, losses, ms, launches, \
            torch.cuda.max_memory_allocated()

    one = run(None)
    one_state, g_one, l_one, ms_one, n_one, peak_one = one
    del one, one_state
    torch.cuda.empty_cache()
    state, g_mesh, l_mesh, ms_mesh, n_mesh, peak_mesh = run(mesh)
    per_step = 2 * cfg.layers * MESH_TRAIN_RANKS
    want = {k: 0 for k in n_mesh}
    want.update(flash_attn=per_step, flash_attn_bwd_delta=per_step,
                flash_attn_bwd=per_step)
    check(n_mesh == want, f"mesh train step launched {n_mesh}, want {want}")
    rel = [abs(a - b) / abs(b) for a, b in zip(l_mesh, l_one)]
    check(max(rel) <= TRAIN_LOSS_REL,
          f"mesh train: losses {l_mesh} vs one device {l_one}")
    cos = {n: cosine(a, b) for n, a, b in zip(names, g_mesh, g_one,
                                              strict=True)}
    barred = {n: c for n, c in cos.items() if "/k_b[" not in n}
    worst = min(barred, key=barred.get)
    check(barred[worst] >= TRAIN_GRAD_COS,
          f"mesh train: gradient {worst} cosine {barred[worst]}")
    del g_mesh, g_one

    # A checkpoint saved from the mesh, restored on one device.
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        C.save_train_state(state, d, config=cfg)
        save_s = time.perf_counter() - t0
        gathered = state.params.params_numpy()
        del state
        torch.cuda.empty_cache()
        init, _ = T.make_train_step(cfg, **kw)
        t0 = time.perf_counter()
        restored = C.restore_train_state(d, init(tree))
        restore_s = time.perf_counter() - t0
        back = restored.params.params_numpy()
        equal = all(np.array_equal(back["layers"][k], gathered["layers"][k])
                    for k in gathered["layers"]) and all(
            np.array_equal(back[k], gathered[k])
            for k in gathered if k != "layers")
        check(equal and restored.step == MESH_TRAIN_STEPS,
              "mesh checkpoint restored on one device differs")
        del restored, back, gathered
    torch.cuda.empty_cache()
    line = {
        "phase": "mesh", "part": "train", "card": smi_line(),
        "ranks": "logical devices, all on cuda:0 (the machine's one card)",
        "mesh": mesh.shape, "model": MODEL_NAME, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "steps": MESH_TRAIN_STEPS,
        "launches_one_step": n_mesh,
        "launches_one_step_single_device": n_one,
        "loss_mesh": l_mesh, "loss_single_device": l_one,
        "loss_rel_max": max(rel), "loss_bar": TRAIN_LOSS_REL,
        "grad_cos_min": barred[worst], "grad_cos_min_leaf": worst,
        "grad_bar": TRAIN_GRAD_COS,
        "k_b_cos_min": min(c for n, c in cos.items() if "/k_b[" in n),
        "step_ms": ms_mesh, "step_ms_single_device": ms_one,
        "step_ms_median": statistics.median(ms_mesh[1:]),
        "step_ms_median_single_device": statistics.median(ms_one[1:]),
        "peak_memory_gb": peak_mesh / 1e9,
        "peak_memory_gb_single_device": peak_one / 1e9,
        "checkpoint": {"restored_on_one_device_equal": equal,
                       "save_s": save_s, "restore_s": restore_s},
        "seconds": time.perf_counter() - t_phase}
    emit(line)
    return line


def train_kernels(tatt, peaks) -> list:
    """Phase 10's kernel checks: the backward kernels against the plain
    autograd, and phase 13's at a tensor-parallel rank's head counts (a
    'kernels' line, part 'train'). Run in phase 2, while the process is
    young: torch.profiler drops more kernels from an older process's
    traces (tools/torch_profiler_drops.py). Returns each backward
    kernel's (B 32, T 128) row, D's first."""
    t0 = time.perf_counter()
    (fused, delta), all_rows = flash_bwd_kernels(tatt, peaks)
    heads = flash_heads(tatt)
    emit({"phase": "kernels", "part": "train", "card": smi_line(),
          "kernels": all_rows, "mesh_heads": heads,
          "seconds": time.perf_counter() - t0})
    return [delta, fused]


# ---------------------------------------------------------------------------
# Routing and the admin verbs (phase 11): the routed ask through the
# sticky loader, and dump / delete / vacuum / rebuild / restore through
# the port's command line
# ---------------------------------------------------------------------------

ROUTED_FORCED = ("math", "code", "translation", "default")
ROUTED_SINGLE = 8          # questions asked one at a time, routed and not
ROUTE_BAND = 1e-4          # a margin this close to its threshold may flip
EVICT_MEM_TOL = 0.05       # memory after an eviction vs before the load
REBUILD_CPU_PASSAGES = 64
ROUTED_FILES = {
    # name: (text, CLI flags); the folder "code/" is the code file's hint
    "calculus.md": (
        "Limits and derivatives. The derivative of a function at a point "
        "is the limit of the difference quotient as the step goes to zero. "
        "It measures the instantaneous rate of change and the slope of the "
        "tangent line. The product rule, the quotient rule and the chain "
        "rule compute derivatives of products, quotients and compositions."
        "\n\n"
        "Integrals. The definite integral accumulates the signed area under "
        "a curve between two bounds, as the limit of Riemann sums. The "
        "fundamental theorem of calculus says that differentiation and "
        "integration are inverse operations: an antiderivative evaluated at "
        "the bounds gives the integral. Substitution and integration by "
        "parts reverse the chain rule and the product rule.\n\n"
        "Series. A power series converges inside its radius of convergence; "
        "the Taylor polynomial of degree n approximates a smooth function "
        "near a point, with a remainder bounded by the next derivative. "
        "Eigenvalues of a matrix solve the characteristic polynomial; a "
        "differential equation y' = ky has exponential solutions.",
        ["--course", "calc101", "--subject", "math"]),
    "code/sorting.md": (
        "Sorting algorithms. Quicksort partitions the array around a pivot "
        "and sorts each side recursively; its average time complexity is "
        "O(n log n) and its worst case O(n^2). Merge sort splits the list "
        "in halves, sorts them and merges the sorted halves in linear "
        "time.\n\n"
        "def quicksort(xs):\n    if len(xs) <= 1:\n        return xs\n"
        "    pivot = xs[len(xs) // 2]\n"
        "    left = [x for x in xs if x < pivot]\n"
        "    right = [x for x in xs if x > pivot]\n"
        "    return quicksort(left) + [x for x in xs if x == pivot] + "
        "quicksort(right)\n\n"
        "Debugging. A stack trace lists the frames active when the "
        "exception was raised; read it from the bottom to find the failing "
        "line. Unit tests with pytest assert the expected output of a "
        "function; a linked list or a binary tree needs tests for the "
        "empty structure and a single node.",
        ["--course", "cs102"]),
    "lezioni/storia.md": (
        "La rivoluzione industriale. Nel Settecento l'Inghilterra conobbe "
        "una trasformazione profonda dell'economia: la macchina a vapore, "
        "perfezionata da James Watt, mosse i telai delle fabbriche tessili "
        "e poi le locomotive. Le città crebbero rapidamente e le "
        "condizioni di lavoro degli operai furono durissime.\n\n"
        "Le conseguenze sociali. Nacquero i sindacati e i primi partiti "
        "operai; le leggi sul lavoro minorile limitarono l'orario nelle "
        "fabbriche. La ferrovia ridusse i tempi di viaggio e unì i mercati "
        "nazionali, mentre il carbone divenne la fonte di energia "
        "principale dell'Europa.",
        ["--course", "storia1", "--language", "it"]),
    "guide/library.md": (
        "Campus library guide. The main library opens at eight in the "
        "morning and closes at midnight during the exam session. Students "
        "borrow up to ten books for four weeks and renew them online. "
        "Group study rooms are booked through the student portal for at "
        "most two hours a day.\n\n"
        "Printing and scanning. Each student account receives printing "
        "credit every semester; the scanners on the second floor send "
        "files to the university email address. Quiet zones are on the "
        "third floor; phone calls are allowed only in the lobby.",
        ["--course", "orientation"]),
}
ROUTED_QUESTIONS = [
    "what does the derivative of a function measure",
    "how does the chain rule compute derivatives of compositions",
    "what does the fundamental theorem of calculus say",
    "how do Riemann sums define the definite integral",
    "when does a power series converge inside its radius",
    "how does integration by parts reverse the product rule",
    "what is the average time complexity of quicksort",
    "how does merge sort merge the sorted halves",
    "how do I read a stack trace to find the failing line",
    "what should unit tests with pytest assert",
    "which tests does a linked list or binary tree need",
    "what is the worst case of quicksort partitions",
    "chi perfezionò la macchina a vapore",
    "quali furono le conseguenze sociali della rivoluzione industriale",
    "come la ferrovia unì i mercati nazionali",
    "translate into english: le leggi sul lavoro minorile",
    "when does the main library close during the exam session",
    "how many books can students borrow and for how long",
    "how are group study rooms booked through the portal",
    "where do the scanners send the scanned files",
]


def _cli_json(cli, argv) -> dict:
    """Run one verb of the port's command line; its JSON (rc 0 required)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    check(rc == 0, f"routed: `{' '.join(argv[:2])}` exited {rc}")
    return json.loads(buf.getvalue())


def _ask_ids(results) -> list:
    return [[r["id"] for r in res] for res in results]


def _first_difference(card, cpu):
    """Where two retrieved lists first differ: the rank and each side's
    id, fused score and vector distance there (None where they are
    equal)."""
    import itertools

    def at(r):
        return None if r is None else [r["id"], r["scores"].get("fused"),
                                       r["scores"].get("vector_distance")]

    for rank, (x, y) in enumerate(itertools.zip_longest(card, cpu)):
        if (x or {}).get("id") != (y or {}).get("id"):
            return {"rank": rank, "card": at(x), "cpu": at(y),
                    "lengths": [len(card), len(cpu)]}
    return None


def routed_phase(tree, ckpt_dir: Path, docs, counts) -> dict:
    """Phase 11: a routed runtime on a fresh index (E5-base at full
    width in the kernel configuration, the small decoder behind three
    route files), loaded from a dump of the encoder corpus and four files
    added through the CLI, asked 32 + 8 + 4 questions; then the admin
    verbs, a CPU copy of the runtime and the CLI as a subprocess."""
    import gc
    import os
    import weakref

    from classmate_rag_tpu_torch.cli.main import main as cli
    from classmate_rag_tpu_torch.config import embedding_config_of
    from classmate_rag_tpu_torch.embeddings import get_embedder
    from classmate_rag_tpu_torch.embeddings.cache import CachingEmbedder
    from classmate_rag_tpu_torch.embeddings.encoder import E5Encoder
    from classmate_rag_tpu_torch.embeddings.model import EncoderConfig
    from classmate_rag_tpu_torch.generation.runner import DecodeRunner
    from classmate_rag_tpu_torch.index.catalog import Catalog
    from classmate_rag_tpu_torch.index.store import IndexStore
    from classmate_rag_tpu_torch.metadata import DocumentMetadata
    from classmate_rag_tpu_torch.pipeline import ask as A
    from classmate_rag_tpu_torch.pipeline import runtime as R
    from classmate_rag_tpu_torch.routing import loader as L

    t_phase = time.perf_counter()
    saved_env = dict(os.environ)
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    models = root / "models"
    models.mkdir()
    for route in ("math", "code", "default"):
        # Any file resolves a route; the decoder backend never reads it.
        (models / f"{route}.gguf").write_bytes(b"route model placeholder")
    os.environ.update(
        ENABLE_ROUTING="1", EMBEDDING_BACKEND="e5", LLM_BACKEND="tpu",
        LLM_TEMPERATURE="0", ROUTE_TEMPERATURE="0",
        LLM_MAX_TOKENS=str(RUNNER_NEW), ROUTE_MAX_TOKENS=str(RUNNER_NEW),
        LOG_LEVEL="WARNING", N_SHARDS="1",
        **{f"ROUTE_{r.upper()}_MODEL_PATH": str(models / f"{r}.gguf")
           for r in ROUTED_FORCED})   # translation.gguf is absent

    def point(d: Path) -> None:
        os.environ.update(INDEX_DIR=str(d), BM25_DIR=str(d / "bm25"),
                          DENSE_DIR=str(d / "dense"),
                          EMB_CACHE_DIR=str(d / "emb"))

    slice_cfg = dataclasses.replace(EncoderConfig.base(), fused_epilogue=True,
                                    flash_min_seq=128)
    enc = E5Encoder(model_name=MODEL_NAME, config=slice_cfg, params=tree)

    def runtime_on(d: Path):
        """get_runtime on ``d``, then the kernel-configuration encoder
        handed to it (as phase 7 hands one to the retriever)."""
        point(d)
        rt = R.get_runtime(reload=True)
        emb = CachingEmbedder(enc, cache_dir=str(d / "emb"))
        check(emb.model_name == rt.store.embedding_model,
              f"routed: embedder {emb.model_name} vs store "
              f"{rt.store.embedding_model}")
        rt.embedder = rt.retriever.embedder = emb
        return rt

    # ---- set-up: the runtime, and every decoder build and eviction
    # watched (one decoder on the card at a time).
    a, b = root / "a", root / "b"
    t0 = time.perf_counter()
    rt = runtime_on(a)
    runtime_s = time.perf_counter() - t0
    check(rt.store.device.type == "cuda", "routed: runtime not on CUDA")
    live = weakref.WeakSet()
    builds, evictions = [], []

    def watched(real):
        def build(cfg, **kw):
            gc.collect()
            check(not any(isinstance(r, DecodeRunner) for r in live),
                  "routed: a decoder built while another is resident")
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            runner = real(cfg, **kw)
            torch.cuda.synchronize()
            builds.append({"s": time.perf_counter() - t0, "mem_before": mem0,
                           "mem_after": torch.cuda.memory_allocated()})
            live.add(runner)
            return runner
        return build

    real_l, real_r = L.get_runner, R.get_runner
    L.get_runner, R.get_runner = watched(real_l), watched(real_r)
    loader = rt.loader
    check(loader.device.type == "cuda", "routed: loader not on CUDA")
    real_evict, real_ensure = loader._evict, loader.ensure_loaded
    resident = []

    def evict():
        had = loader._resident is not None
        real_evict()
        if had:
            torch.cuda.synchronize()
            evictions.append(torch.cuda.memory_allocated())

    def ensure(route):
        runner = real_ensure(route)
        # Every route resolves to a file (translation to default's), so
        # every answer must come from the decoder on the card.
        check(isinstance(runner, DecodeRunner)
              and runner.device.type == "cuda",
              f"routed: route {route} answered by {runner!r}")
        key = [loader.resident_route, Path(loader._resident_path).name]
        if not resident or resident[-1] != key:
            resident.append(key)
        return runner

    loader._evict, loader.ensure_loaded = evict, ensure
    t0 = time.perf_counter()
    clf = rt.classifier                  # prototypes from the E5 encoder
    prototype_s = time.perf_counter() - t0
    clf_ms, decided = [], []
    real_scores, real_decide = clf.score_queries, rt.router.decide_batch

    def scores(qs):
        t0 = time.perf_counter()
        out = real_scores(qs)
        clf_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def decide(questions, metas_list, *, forced_subject=None):
        out = real_decide(questions, metas_list,
                          forced_subject=forced_subject)
        decided.extend(out)
        return out

    clf.score_queries, rt.router.decide_batch = scores, decide

    try:
        # ---- the main path: every count 0 just before, read just after.
        counts.reset()
        corpus = root / "corpus.jsonl"
        with corpus.open("w", encoding="utf-8") as f:
            for i in range(ENC_CHUNKS):       # 64 courses of 128 chunks
                c, k = divmod(i, 128)
                f.write(json.dumps({"id": f"e{i}", "text": " ".join(docs[i]),
                                    "metadata": {
                    "course": f"course{c}", "language": "en",
                    "doc_type": "txt", "page": 1, "chunk_id": k % 8,
                    "source_path": f"/corpus/course{c}/doc{k // 8}.txt"}})
                        + "\n")
        t0 = time.perf_counter()
        out = _cli_json(cli, ["restore", "--path", str(corpus)])
        corpus_s = time.perf_counter() - t0
        check(out["restored"] == ENC_CHUNKS, f"routed: restored {out}")
        added = {}
        files = root / "files"
        for name, (text, flags) in ROUTED_FILES.items():
            path = files / name
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(text, encoding="utf-8")
            t0 = time.perf_counter()
            out = _cli_json(cli, ["add", str(path), *flags])
            added[name] = {"chunks": out["upserted"],
                           "s": time.perf_counter() - t0}
            check(out["upserted"] > 0, f"routed: add {name}: {out}")
        subjects = {Path(str(e.metadata["source_path"])).name:
                    e.metadata.get("subject")
                    for e in rt.catalog.entries()
                    if not str(e.metadata["source_path"]).startswith(
                        "/corpus/")}
        check(subjects["calculus.md"] == "math"
              and subjects["sorting.md"] == "code",
              f"routed: subjects at ingest {subjects}")

        rng = np.random.default_rng(11)
        questions = ROUTED_QUESTIONS + [
            " ".join(rng.choice(docs[int(i)], size=5, replace=False))
            for i in rng.integers(0, ENC_CHUNKS,
                                  32 - len(ROUTED_QUESTIONS))]
        t0 = time.perf_counter()
        batch = A.ask_question_batch(questions=questions,
                                     filters=DocumentMetadata(), top_k=K,
                                     runtime=rt)
        batch_s = time.perf_counter() - t0
        n_asks = 1
        check(all(r.answer for r in batch), "routed: an empty answer")
        batch_routes = [r.route for r in batch]
        check({"math", "code", "default"} <= set(batch_routes),
              f"routed: the batch decided only {sorted(set(batch_routes))}")
        single_ms, single_reload = [], []
        for q in questions[:ROUTED_SINGLE]:
            n_builds = len(builds)
            t0 = time.perf_counter()
            res = A.ask_question(question=q, filters=DocumentMetadata(),
                                 top_k=K, runtime=rt)
            single_ms.append((time.perf_counter() - t0) * 1e3)
            single_reload.append(len(builds) > n_builds)
            check(bool(res.answer) and res.route == batch[
                questions.index(q)].route, f"routed: single ask of {q!r}")
            n_asks += 1
        cli_asks = []
        for q, subject in zip(questions[-4:], ROUTED_FORCED):
            n_builds = len(builds)
            t0 = time.perf_counter()
            out = _cli_json(cli, ["ask", q, "--subject", subject])
            cli_asks.append({"subject": subject, "route": out["route"],
                             "reason": out["route_reason"],
                             "reloaded": len(builds) > n_builds,
                             "s": time.perf_counter() - t0,
                             "filters": out["filters"],
                             "retrieved": out["retrieved"]})
            check(out["route"] == subject and out["route_reason"] == "forced"
                  and out["answer"], f"routed: CLI ask --subject {subject}")
            n_asks += 1
        launches = counts.read()
        check(launches["topk_scan"] == launches["topk_merge"] == n_asks,
              f"routed: {launches} for {n_asks} asks")
        for name, n in launches.items():
            if name in BACKWARD_KERNELS + APPROX_ONLY_KERNELS:
                check(n == 0, f"routed: {name} was launched")
            elif name not in SPLIT_ONLY_KERNELS:
                check(n > 0, f"routed: {name} was not launched")
        check(rt._runner is None, "routed: the runtime built its own runner")

        # ---- the same questions with routing off: the loader's decoder
        # goes first, then the runtime's own runner is built and dropped.
        loader._evict()
        rt.cfg = dataclasses.replace(rt.cfg, enable_routing=False)
        plain_ms = []
        for q in questions[:ROUTED_SINGLE]:
            t0 = time.perf_counter()
            res = A.ask_question(question=q, filters=DocumentMetadata(),
                                 top_k=K, runtime=rt)
            plain_ms.append((time.perf_counter() - t0) * 1e3)
            check(bool(res.answer) and res.route is None,
                  f"routed: unrouted ask of {q!r}")
        check(isinstance(rt._runner, DecodeRunner), "routed: no own runner")
        rt._runner = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        evictions.append(torch.cuda.memory_allocated())
        rt.cfg = dataclasses.replace(rt.cfg, enable_routing=True)
        check(loader._resident is None, "routed: two decoders resident")

        # ---- a CPU copy of the runtime on the same persisted directory.
        t0 = time.perf_counter()
        cpu_catalog = Catalog.load_or_create(rt.cfg.bm25_dir)
        cpu_store = IndexStore.load_or_create(
            DIM, rt.cfg.dense_dir, cpu_catalog,
            slab_rows=rt.store.slab_rows, terms_per_chunk=rt.store.term_width,
            rescore=rt.store.rescore, rescore_pool=rt.store.rescore_pool,
            select=rt.store.select, device="cpu")
        cpu_emb = E5Encoder(model_name=MODEL_NAME, config=slice_cfg,
                            params=tree, device="cpu")
        cpu_rt = dataclasses.replace(
            rt, catalog=cpu_catalog, store=cpu_store, embedder=cpu_emb,
            retriever=dataclasses.replace(rt.retriever, store=cpu_store,
                                          catalog=cpu_catalog,
                                          embedder=cpu_emb),
            _classifier=None, _router=None, _loader=None, _runner=None)
        # The plain retrieval on the card's query vectors: the product
        # phase's bar (a store loaded anew on the CPU, the same queries).
        same_rt = dataclasses.replace(cpu_rt, retriever=dataclasses.replace(
            cpu_rt.retriever, embedder=rt.embedder, use_device_encode=False))

        def cpu_asks(crt) -> list:
            got = A.retrieve_batch_for_ask(
                questions=questions, filters=DocumentMetadata(), top_k=K,
                runtime=crt)
            # --subject is also a metadata filter, as in the JAX CLI.
            got += [crt.retriever.retrieve(question=q, top_k=K,
                                           filters=ask["filters"])
                    for q, ask in zip(questions[-4:], cli_asks)]
            return [A._apply_expansion_and_diversity(list(r), crt)
                    for r in got]

        card_results = [r.retrieved for r in batch] + [
            ask["retrieved"] for ask in cli_asks]
        asked = questions + questions[-4:]

        def differences(cpu_results) -> list:
            return [{"question": q, **d} for q, card, cpu in zip(
                asked, card_results, cpu_results)
                for d in [_first_difference(card, cpu)] if d]

        same_results = cpu_asks(same_rt)
        same_diff = differences(same_results)
        n_compared = len(asked)
        ids_equal = n_compared - len(same_diff)
        check(ids_equal / n_compared >= ROWS_AGREE_MIN,
              f"routed: card and CPU copy retrieved the same ids for "
              f"{ids_equal} of {n_compared} questions: {same_diff}")
        # The CPU copy's own query encode (the plain encoder): the same
        # vectors to the encoder's tolerance, and the same ids except
        # where the dense branch ranks two chunks the other way round
        # because their distances lie closer than the two query vectors
        # differ (|q - q'| bounds every distance's change): both picks
        # then hold the same rank, so the same fused score.
        card_q = rt.embedder.encode_queries(questions)
        query_cos = row_cos(card_q, cpu_emb.encode_queries(questions))
        check(query_cos >= ENC_COS_MIN,
              f"routed: card vs CPU query vectors: cosine {query_cos}")
        noise = math.sqrt(2.0 * (1.0 - query_cos))
        own_diff = differences(cpu_asks(cpu_rt))
        check(all(d["card"] and d["cpu"] and d["card"][1] == d["cpu"][1]
                  and d["card"][2] is not None and d["cpu"][2] is not None
                  and abs(d["card"][2] - d["cpu"][2]) <= noise
                  for d in own_diff),
              f"routed: the CPU copy's own encode ranks otherwise than "
              f"query noise {noise} allows: {own_diff}")
        # Decisions: the CPU copy's router (its classifier encoding on
        # the CPU) on the CPU retrieval's metadata.
        cpu_decisions = cpu_rt.router.decide_batch(
            questions, [[r.get("metadata") or {} for r in res]
                        for res in same_results[:len(questions)]])
        in_band = 0
        for q, card, cpu in zip(questions, decided[:len(questions)],
                                cpu_decisions):
            if abs(cpu.margin - rt.cfg.route_query_margin) <= ROUTE_BAND:
                in_band += 1
                continue
            check((card.route, card.reason) == (cpu.route, cpu.reason),
                  f"routed: {q!r} decided {card.route}/{card.reason} on the "
                  f"card, {cpu.route}/{cpu.reason} on the CPU")
        worst_score = max(abs(x - y) for card, cpu in zip(decided, cpu_decisions)
                          for x, y in zip(card.query_scores.values(),
                                          cpu.query_scores.values()))
        cpu_s = time.perf_counter() - t0
        del cpu_rt, same_rt, cpu_store, cpu_catalog, cpu_emb

        # ---- the admin verbs through the CLI.
        dump = root / "dump.jsonl"
        t0 = time.perf_counter()
        out = _cli_json(cli, ["dump", "--path", str(dump)])
        dump_s = time.perf_counter() - t0
        n_rows = out["written"]
        check(n_rows == ENC_CHUNKS + sum(v["chunks"] for v in added.values()),
              f"routed: dump wrote {n_rows}")
        library = str(files / "guide/library.md")
        deleted = _cli_json(cli, ["delete", "--path", library])
        t0 = time.perf_counter()
        out = _cli_json(cli, ["vacuum"])
        vacuum_s = time.perf_counter() - t0
        reclaimed = int(out["dense"].split("(")[1].split()[0])
        check(reclaimed == added["guide/library.md"]["chunks"]
              == len(deleted["ids"]), f"routed: vacuum {out}")
        ckpt_cpu = get_embedder(embedding_config_of(rt.cfg),
                                checkpoint=str(ckpt_dir), device="cpu")
        cache = Path(rt.cfg.emb_cache_dir)
        before = set(cache.iterdir())
        t0 = time.perf_counter()
        out = _cli_json(cli, ["rebuild", "--model", str(ckpt_dir)])
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t0
        check(out["updated"] == n_rows - reclaimed, f"routed: rebuild {out}")
        check("@ckpt-step_" in rt.embedder.model_name
              and rt.store.embedding_model == rt.embedder.model_name,
              f"routed: rebuilt onto {rt.embedder.model_name}")
        # A cache miss for every text: the checkpoint's own cache
        # directory holds one vector per distinct text, and no other
        # model's vectors were read.
        new_dirs = set(cache.iterdir()) - before
        distinct = {e.text.strip() for e in rt.catalog.entries()}
        check(len(new_dirs) == 1 and sum(1 for _ in next(iter(new_dirs))
                                         .rglob("*.npy")) == len(distinct),
              f"routed: the rebuild's cache {new_dirs}")
        entries = list(rt.catalog.entries())[:REBUILD_CPU_PASSAGES]
        want = ckpt_cpu.encode_passages([e.text for e in entries])
        rows = [rt.store.id_to_row[e.id] for e in entries]
        have = rt.store.emb[rows].astype(np.float32)
        have /= np.linalg.norm(have, axis=1, keepdims=True)
        rebuild_cos = row_cos(have, want)
        check(rebuild_cos >= ENC_COS_MIN,
              f"routed: rebuilt vs CPU checkpoint cosine {rebuild_cos}")
        del ckpt_cpu
        # The entry point as a user runs it, on the rebuilt index served
        # with its checkpoint; it runs while the restore below does.
        stats_proc = subprocess.Popen(
            [sys.executable, "-m", "classmate_rag_tpu_torch.cli", "stats"],
            cwd=str(Path(__file__).resolve().parent),
            env={**os.environ, "ENCODER_CHECKPOINT": str(ckpt_dir)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        restore_rt = None
        try:
            t0 = time.perf_counter()
            restore_rt = runtime_on(b)
            restore_runtime_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = _cli_json(cli, ["restore", "--path", str(dump)])
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            check(out["restored"] == n_rows, f"routed: restore {out}")
            again = A.retrieve_batch_for_ask(
                questions=questions, filters=DocumentMetadata(), top_k=K,
                runtime=restore_rt)
            again = [A._apply_expansion_and_diversity(list(r), restore_rt)
                     for r in again]
            check(_ask_ids(again) == _ask_ids([r.retrieved for r in batch]),
                  "routed: the restored index answers other ids")
            redump = root / "redump.jsonl"
            _cli_json(cli, ["dump", "--path", str(redump), "--no-emb"])

            def sha(p):
                return {r["id"]: r["text_sha1"] for r in map(
                    json.loads, p.read_text(encoding="utf-8").splitlines())}

            check(sha(redump) == sha(dump), "routed: text_sha1 differ after "
                  "a restore")
            stdout, stderr = stats_proc.communicate(timeout=300)
        finally:
            if stats_proc.poll() is None:
                stats_proc.kill()
                stats_proc.wait()
        check(stats_proc.returncode == 0,
              f"routed: CLI stats failed: {stderr[-2000:]}")
        stats = json.loads(stdout)
        check(stats["action"] == "stats"
              and stats["vectors"] == n_rows - reclaimed,
              f"routed: CLI stats {stats}")
    finally:
        L.get_runner, R.get_runner = real_l, real_r
        os.environ.clear()
        os.environ.update(saved_env)
        R.reset_runtime()

    # At most one decoder at a time, and each eviction gave its memory
    # back.
    check(len(evictions) == len(builds),
          f"routed: {len(builds)} decoders built, {len(evictions)} freed")
    mem_back = [abs(e - bld["mem_before"]) / bld["mem_before"]
                for bld, e in zip(builds, evictions)]
    check(max(mem_back) <= EVICT_MEM_TOL,
          f"routed: memory after eviction off by {max(mem_back):.3f}")
    reasons = {}
    for d in decided:
        reasons[d.reason] = reasons.get(d.reason, 0) + 1
    line = {
        "phase": "routed", "card": smi_line(), "model": MODEL_NAME,
        "encoder": "slice configuration (fused_epilogue, flash_min_seq 128)",
        "decoder": "small (default config), 64 new tokens, temperature 0",
        "corpus": ENC_CHUNKS, "files": added, "subjects": subjects,
        "questions": len(questions), "launches": launches, "asks": n_asks,
        "decisions_by_reason": reasons, "batch_routes": batch_routes,
        "resident_sequence": resident, "decoder_builds": len(builds),
        "reload_s": [bld["s"] for bld in builds],
        "decoder_bytes": [bld["mem_after"] - bld["mem_before"]
                          for bld in builds],
        "memory_back_max_rel": max(mem_back),
        "batch_ask_s": batch_s,
        "routed_ask_ms": single_ms, "routed_reloaded": single_reload,
        "routed_ask_p50_ms": float(np.percentile(single_ms, 50)),
        "unrouted_ask_ms": plain_ms,
        "unrouted_ask_p50_ms": float(np.percentile(plain_ms, 50)),
        "cli_asks": [{k: v for k, v in x.items()
                      if k not in ("retrieved", "filters")}
                     for x in cli_asks],
        "classifier_ms": clf_ms, "prototype_s": prototype_s,
        "cpu_copy": {"ids_equal": ids_equal, "compared": n_compared,
                     "query_cos_min": query_cos, "distance_noise": noise,
                     "own_encode_ids_equal": n_compared - len(own_diff),
                     "own_encode_differences": own_diff,
                     "decisions_in_band": in_band,
                     "max_query_score_diff": worst_score, "s": cpu_s},
        "dump": {"rows": n_rows, "s": dump_s},
        "vacuum": {"reclaimed": reclaimed, "s": vacuum_s},
        "rebuild": {"rows": n_rows - reclaimed, "s": rebuild_s,
                    "passages_per_s": (n_rows - reclaimed) / rebuild_s,
                    "cos_vs_cpu": rebuild_cos,
                    "cpu_passages": REBUILD_CPU_PASSAGES},
        "restore": {"rows": n_rows, "s": restore_s,
                    "runtime_s": restore_runtime_s, "ids_equal": True,
                    "text_sha1_equal": True},
        "cli_stats_subprocess": {"vectors": stats["vectors"]},
        "setup_s": {"runtime": runtime_s, "corpus_restore": corpus_s},
        "seconds": time.perf_counter() - t_phase,
    }
    del rt, restore_rt, enc
    tmp.cleanup()
    gc.collect()
    torch.cuda.empty_cache()
    emit(line)
    return line


# ---------------------------------------------------------------------------
# 16. bench: classmate_rag_tpu_torch/bench.py's run_scale at serving scale
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# The port's tools (phase 17): each of the 14 on the card, on what earlier
# phases hold (phase 3's store, the E5-base encoder, phase 8's index)
# ---------------------------------------------------------------------------

TOOLS_DEVICE = "cuda"
TOOLS_ROWS = 200_000         # probe_mutation_sync, debug_recall_1m
TOOLS_RECALL_QUERIES = 16
TOOLS_BUILD_ROWS = 20_000    # build_product_index
TOOLS_ENC_SHAPE = (64, 256)  # bench_embed, bench_encoder_roofline: B, T
PROFILE_TOL = 0.15           # full_step vs device_seconds_per_batch
SERVE_ARGV = ["--clients", "32", "--seconds", "5", "--warmup-seconds", "3",
              "--port", "0", "--mutate", "4"]
ASK_QUESTIONS = ["what about zxaa zxab zxac", "zxba zxbb compute the rate"]


def tools_env(root: Path) -> dict:
    """The product runtime's environment on phase 8's index."""
    return dict(INDEX_DIR=str(root), BM25_DIR=str(root / "bm25"),
                DENSE_DIR=str(root / "dense"), EMB_CACHE_DIR=str(root / "emb"),
                EMBEDDING_BACKEND="hash", LLM_BACKEND="extractive",
                BM25_TERMS_PER_CHUNK=str(PRODUCT_TERMS), N_SHARDS="1",
                RUNTIME_PRECOMPILE="off")


def tool_line(name: str, report, launches: dict, seconds: float) -> dict:
    line = {"phase": "tools", "tool": name, "seconds": seconds,
            "launches": launches, "report": report,
            "nvidia_smi": smi_line()}
    emit(line)
    return line


def run_tool(name: str, counts, fn):
    """``fn()`` with every launch count 0 just before and read just
    after; prints the tool's line and returns its report."""
    counts.reset()
    t0 = time.perf_counter()
    report = fn()
    torch.cuda.synchronize()
    tool_line(name, report, counts.read(), time.perf_counter() - t0)
    return report


def tools_child(part: str, root: Path) -> int:
    """A fresh process on phase 8's index: 'cold' runs probe_cold_start;
    'serve' runs probe_first_dispatch, bench_ask, bench_serve (the storm)
    and probe_fold_1m. Prints one TOOLS_CHILD_JSON line: each tool's
    report and launch counts."""
    import os

    os.environ.update(tools_env(root))
    from classmate_rag_tpu_torch.ops import attention as tatt
    from classmate_rag_tpu_torch.ops import encoder_fused as tef
    from classmate_rag_tpu_torch.ops import topk as ttopk

    counts = Counts(ttopk, tef, tatt)
    out = {}

    def run(name, fn):
        counts.reset()
        t0 = time.perf_counter()
        report = fn()
        torch.cuda.synchronize()
        out[name] = {"report": report, "launches": counts.read(),
                     "seconds": time.perf_counter() - t0}

    if part == "cold":
        from classmate_rag_tpu_torch.tools import probe_cold_start

        run("probe_cold_start", lambda: probe_cold_start.probe(TOOLS_DEVICE))
    else:
        from classmate_rag_tpu_torch.config import load_config
        from classmate_rag_tpu_torch.pipeline.runtime import get_runtime
        from classmate_rag_tpu_torch.tools import (
            bench_ask, bench_serve, probe_first_dispatch, probe_fold_1m,
        )

        run("probe_first_dispatch",
            lambda: probe_first_dispatch.probe(TOOLS_DEVICE))
        rt = get_runtime()
        run("bench_ask", lambda: bench_ask.run(ASK_QUESTIONS, n=8,
                                               runtime=rt))
        run("bench_serve", lambda: bench_serve.run(
            bench_serve.parse_args(SERVE_ARGV), runtime=rt))
        run("probe_fold_1m", lambda: probe_fold_1m.run(
            load_config().bm25_dir))
    print("TOOLS_CHILD_JSON:" + json.dumps(out), flush=True)
    return 0


def tools_children(root: Path, part: str) -> dict:
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--tools-child",
         part, str(root)], capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        if line.startswith("TOOLS_CHILD_JSON:"):
            out = json.loads(line[len("TOOLS_CHILD_JSON:"):])
            for name, r in out.items():
                tool_line(name, r["report"], r["launches"], r["seconds"])
            return out
    raise SmokeFailure(f"tools child {part} failed (rc={proc.returncode}):\n"
                       f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")


def tools_ingest(enc, docs, counts) -> None:
    """bench_ingest on a fresh runtime that E5-base in the kernel
    configuration serves (handed over as phase 11 hands it)."""
    import os

    from classmate_rag_tpu_torch.config import load_config
    from classmate_rag_tpu_torch.embeddings.cache import CachingEmbedder
    from classmate_rag_tpu_torch.pipeline import runtime as R
    from classmate_rag_tpu_torch.tools import bench_ingest

    saved = dict(os.environ)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            os.environ.update(tools_env(root / "idx"))
            rt = R.get_runtime(reload=True, device=TOOLS_DEVICE)
            emb = CachingEmbedder(enc, cache_dir=str(root / "emb"))
            rt.embedder = rt.retriever.embedder = emb
            rt.store.embedding_model = emb.model_name
            files = []
            for f in range(4):
                path = root / f"lecture_{f}.txt"
                path.write_text("\n\n".join(
                    " ".join(docs[f * 40 + i]) for i in range(40)))
                files.append(path)
            report = run_tool("bench_ingest", counts,
                              lambda: bench_ingest.run(files, 2,
                                                       runtime=rt)[0])
            launches = counts.read()
    finally:
        os.environ.clear()
        os.environ.update(saved)
        R.reset_runtime()
        load_config(reload=True)
    check(report["total_chunks"] > 0
          and report["embedder"].startswith(MODEL_NAME),
          f"tools: bench_ingest {report}")
    check(min(launches[k] for k in ("bias_gelu", "residual_ln",
                                    "flash_attn")) > 0,
          f"tools: bench_ingest launched {launches}")


def tools_phase(product_root: Path, store, batches, enc, docs,
                counts) -> None:
    """Phase 17: every tool of classmate_rag_tpu_torch/tools/ on the card,
    a JSON line each, held to the phase's bars."""
    from classmate_rag_tpu_torch import bench
    from classmate_rag_tpu_torch.tools import (
        bench_decode, bench_embed, bench_encoder_roofline,
        bench_hybrid_profile, bench_scan, build_product_index,
        debug_recall_1m, probe_mutation_sync,
    )

    t_phase = time.perf_counter()
    scan_keys = ("topk_scan", "topk_merge")
    enc_keys = ("bias_gelu", "residual_ln", "flash_attn")

    def launched(keys, name):
        got = {k: counts.read()[k] for k in keys}
        check(min(got.values()) > 0, f"tools: {name} launched {got}")

    # The index tools on phase 8's index, in fresh processes.
    cold = tools_children(product_root, "cold")["probe_cold_start"]
    c = cold["report"]["counters"]
    check(c["device_full_uploads"] == 1 and c["split_full_builds"] == 0,
          f"tools: probe_cold_start counters {c}")
    check(cold["launches"]["topk_scan"] > 0, "tools: cold start, no scan")
    served = tools_children(product_root, "serve")
    serve = served["bench_serve"]["report"]
    check(serve["errors"] == 0, f"tools: bench_serve errors {serve}")
    check(serve["mutation"]["rounds_ok"],
          f"tools: storm rounds {serve['mutation']['rounds']}")
    check(serve["mutation"]["reload"]["equal"],
          f"tools: served rows vs reload {serve['mutation']['reload']}")
    fold = served["probe_fold_1m"]["report"]
    check(fold["post_fold_entries"] == fold["entries_before"] + 2,
          f"tools: fold entries {fold}")
    ask = served["bench_ask"]
    check(ask["launches"]["topk_scan"] == 8 + 1,
          f"tools: bench_ask launches {ask['launches']}")
    for name in ("probe_first_dispatch", "bench_serve"):
        check(served[name]["launches"]["topk_scan"] > 0,
              f"tools: {name} launched no scan")

    with tempfile.TemporaryDirectory() as tmp:
        built = run_tool("build_product_index", counts,
                         lambda: build_product_index.build(
                             Path(tmp), TOOLS_BUILD_ROWS, TOOLS_DEVICE))
    check(built["rows"] == TOOLS_BUILD_ROWS, f"tools: built {built}")

    # Phase 3's store: the stage profile and the scan's routes.
    prof = run_tool("bench_hybrid_profile", counts,
                    lambda: bench_hybrid_profile.profile(store, batches[0]))
    launched(scan_keys, "bench_hybrid_profile")
    step = "full_step_packed" if prof["select_mode"] == "exact" else (
        "full_step_approx")
    st = prof["stages"][step]
    stage_ms = st.get("profiler_ms", st["ms"])
    check(abs(stage_ms - prof["step_device_ms"])
          <= PROFILE_TOL * prof["step_device_ms"],
          f"tools: {step} {stage_ms} ms vs device_seconds_per_batch "
          f"{prof['step_device_ms']} ms")
    n = store.n_rows
    q = np.stack([qv for qv, _t in batches[0]])
    run_tool("bench_scan", counts,
             lambda: bench_scan.run(store.emb[:n], q, TOOLS_DEVICE))
    launched(scan_keys, "bench_scan")

    # The encoder of phases 6-7 (kernel configuration).
    run_tool("bench_embed", counts,
             lambda: bench_embed.run(enc.model, *TOOLS_ENC_SHAPE, 8))
    launched(enc_keys, "bench_embed")
    run_tool("bench_encoder_roofline", counts,
             lambda: bench_encoder_roofline.run(enc.model,
                                                *TOOLS_ENC_SHAPE, 8))
    launched(enc_keys, "bench_encoder_roofline")
    tools_ingest(enc, docs, counts)
    run_tool("bench_decode", counts, lambda: bench_decode.run(
        bench_decode.parse_args(["--batch", "8", "--prompt", "256",
                                 "--new", "32", "--device", TOOLS_DEVICE])))

    # The bench corpus at 200,000 chunks, built once for both.
    rng = np.random.default_rng(42)
    bdocs, bemb = bench.build_corpus(rng, TOOLS_ROWS)
    bqueries = bench.make_queries(rng, bdocs, bemb)
    mut = run_tool("probe_mutation_sync", counts,
                   lambda: probe_mutation_sync.run(
                       TOOLS_ROWS, 192, TOOLS_DEVICE, corpus=(bdocs, bemb)))
    launched(scan_keys, "probe_mutation_sync")
    for name in ("device_full_uploads", "split_full_builds"):
        check(mut["counters_after"][name] == mut["counters_before"][name],
              f"tools: probe_mutation_sync moved {name}: "
              f"{mut['counters_before']} -> {mut['counters_after']}")
    rec = run_tool("debug_recall_1m", counts, lambda: debug_recall_1m.run(
        TOOLS_ROWS, TOOLS_RECALL_QUERIES, TOOLS_DEVICE,
        corpus=(bdocs, bemb, bqueries)))
    launched(scan_keys, "debug_recall_1m")
    check(isinstance(rec["n_miss"], int), f"tools: n_miss {rec}")
    del bdocs, bemb, bqueries
    torch.cuda.empty_cache()
    emit({"phase": "tools", "tools": 14,
          "seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi_line()})


BENCH_CHUNKS = 1_000_000
BENCH_ORACLE = 64          # oracle queries (bench.py's scale-3 floor)
BENCH_FILTERED = "16"      # BENCH_FILTERED_QUERIES: bench.py's above 100k
WALL_OVER_CEILING = 1.05   # wall QPS over the device ceiling, at most


def bench_phase(counts) -> dict:
    """The port's benchmark at 1,000,000 chunks on the card, held to
    bench.py's bars: the approx route chosen by size, recall@8 against
    the oracle unfiltered and in every filter case, 1 + 1 scan launches
    and 1 row_select and 1 bm25_sat_gemm a timed batch, and a wall QPS the
    card's own time can account for."""
    import os

    from classmate_rag_tpu_torch import bench

    os.environ["BENCH_FILTERED_QUERIES"] = BENCH_FILTERED
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    detail = {}
    t0 = time.perf_counter()
    counts.reset()
    out = bench.run_scale(BENCH_CHUNKS, n_oracle=BENCH_ORACLE,
                          filtered_oracle=True, detail=detail)
    launches = counts.read()
    phase_s = time.perf_counter() - t0
    check(detail["device"].startswith("cuda"), "bench: not on the card")
    check(detail["select"] == "auto" and detail["select_mode"] == "approx",
          f"bench: route {detail['select_mode']!r} (select "
          f"{detail['select']!r}) at {BENCH_CHUNKS} chunks")
    check(out["recall_vs_oracle@8"] >= RECALL_MIN,
          f"bench: recall@8 {out['recall_vs_oracle@8']} < {RECALL_MIN}")
    for name, case in out["filtered"].items():
        # A row outside the subset scores its query 0 (16 queries: a leak
        # alone takes the case under the bar); an empty case scores 1.0
        # only if every slot is dead.
        check(case["recall@8"] >= RECALL_MIN,
              f"bench: filter case {name} recall@8 {case['recall@8']}")
    per_batch = {k: v / detail["timed_batches"]
                 for k, v in detail["timed_launches"].items()}
    check(per_batch["topk_scan"] == per_batch["topk_merge"]
          == per_batch["row_select"] == per_batch["bm25_sat_gemm"] == 1.0,
          f"bench: launches a timed batch {per_batch}")
    check(out["value"] <= WALL_OVER_CEILING * out["device_ceiling_qps"],
          f"bench: wall {out['value']} QPS over the device ceiling "
          f"{out['device_ceiling_qps']}")
    line = {"phase": "bench", "chunks": BENCH_CHUNKS,
            "value": out["value"],
            "device_ceiling_qps": out["device_ceiling_qps"],
            "baseline_qps": out["baseline_qps"],
            "vs_baseline": out["vs_baseline"],
            "recall_vs_oracle@8": out["recall_vs_oracle@8"],
            "recall_filtered@8": out["recall_filtered@8"],
            "filtered": out["filtered"],
            "n_oracle_queries": out["n_oracle_queries"],
            "timed_pass_s": out["timed_pass_s"],
            "select_mode": detail["select_mode"],
            "capacity": detail["capacity"],
            "device_timing": detail["device_timing"],
            "timed_batches": detail["timed_batches"],
            "launches_a_timed_batch": per_batch,
            "launches": launches,
            "device_bytes": detail["device_bytes"],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "seconds": {**detail["seconds"], "phase": phase_s},
            "nvidia_smi": smi_line()}
    emit(line)
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--profile", metavar="PATH",
                    help="also trace one warm batch and one encoder "
                         "forward (slice configuration, bucket 128) with "
                         "torch.profiler, print 'profile' and "
                         "'profile_encoder' phase lines and write the "
                         "per-op tables to PATH and PATH_encoder (and "
                         "one product ask's, 'profile_product', to "
                         "PATH_product)")
    ap.add_argument("--product-child", metavar="DIR",
                    help="run only the product phase's child against the "
                         "persisted index in DIR (bm25/, dense/)")
    ap.add_argument("--decode-child", action="store_true",
                    help="run only the decode phase's child")
    ap.add_argument("--row-select-child", action="store_true",
                    help="run only phase 2's row_select part (a child)")
    ap.add_argument("--bm25-core-child", action="store_true",
                    help="run only phase 2's bm25_sat_gemm part (a child)")
    ap.add_argument("--tools-child", nargs=2, metavar=("PART", "DIR"),
                    help="run one of phase 17's children (PART 'cold' or "
                         "'serve') against the product index in DIR")
    ap.add_argument("--multihost-child", nargs=3,
                    metavar=("RANK", "DIR", "ADDR"),
                    help="run one rank of the multihost phase against the "
                         "store saved in DIR, joining the group at ADDR")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if args.product_child:
        return product_child(Path(args.product_child), args.profile)
    if args.decode_child:
        return decode_child()
    if args.row_select_child:
        return row_select_child()
    if args.bm25_core_child:
        return bm25_core_child()
    if args.tools_child:
        part, root = args.tools_child
        return tools_child(part, Path(root))
    if args.multihost_child:
        rank, root, addr = args.multihost_child
        return multihost_child(int(rank), Path(root), addr)

    from classmate_rag_tpu_torch.embeddings.hashing import HashingEmbedder
    from classmate_rag_tpu_torch.index.catalog import Catalog, CatalogEntry
    from classmate_rag_tpu_torch.index.lexical import pack_query_terms
    from classmate_rag_tpu_torch.index.store import IndexStore
    from classmate_rag_tpu_torch.ops import _build
    from classmate_rag_tpu_torch.ops import attention as tatt
    from classmate_rag_tpu_torch.ops import bm25_core
    from classmate_rag_tpu_torch.ops import encoder_fused as tef
    from classmate_rag_tpu_torch.ops import topk as ttopk
    from classmate_rag_tpu_torch.retrieval.hybrid import HybridRetriever
    from classmate_rag_tpu_torch.utils.profiling import (
        HostToDeviceOps,
        Throughput,
        chrome_events,
        h2d_copies,
    )

    # ---- 1. device ---------------------------------------------------
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    peak_key, peaks = peaks_for(kind)
    detected = Throughput(1.0).report()["chip"]
    check(detected == peak_key, f"profiling detects {detected!r}, the "
          f"card is {peak_key!r}")
    t0 = time.perf_counter()
    ptxas = _build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks_of": peak_key,
          "profiling_chip": detected,
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
    bwd_rows = train_kernels(tatt, peaks)
    counts = Counts(ttopk, tef, tatt, bm25_core)

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
    for name in ("topk_scan", "topk_merge", "row_select"):
        check(launches[name] == len(batches),
              f"{name} launches {launches[name]} != {len(batches)}")
    check(launches["bm25_sat_gemm"] == 0,
          "slice: the exact route launched bm25_sat_gemm")

    # One warm batch's host-to-device copies: the packed metadata and
    # the query vectors.
    h2d = h2d_per_batch(lambda: run_batch(batches[2]).rows.cpu(), counts)
    check(h2d["copies"] == 2, f"slice: {h2d['copies']} host-to-device "
          f"copies a batch, not 2 ({h2d['kinds']})")
    with HostToDeviceOps() as h2d_ops:   # phase 7's count, held to the trace
        run_batch(batches[2]).rows.cpu()
    check((h2d_ops.copies, h2d_ops.bytes) == (h2d["copies"], h2d["bytes"]),
          f"slice: copy ops {h2d_ops.copies} ({h2d_ops.bytes} B) vs the "
          f"trace's {h2d['copies']} ({h2d['bytes']} B)")
    q2 = np.stack([qv for qv, _t in batches[2]])
    terms2 = [t for _q, t in batches[2]]
    q_terms2, q_counts2 = pack_query_terms(store.vocab, terms2, 32)
    inputs_wait = {
        "packed": waits_for_stream(lambda: store.hybrid_step_inputs(
            q2, terms2, None, **knobs)),
        "pageable": waits_for_stream(lambda: store._split_query_tensors(
            q_terms2, q_counts2)),
    }
    inputs_wait["pageable"]["h2d_copies"] = h2d_copies(chrome_events(
        lambda: store._split_query_tensors(q_terms2, q_counts2)))["copies"]

    agree_total, worst = 0, 0.0
    packed_rows_equal, packed_worst = True, 0.0
    t0 = time.perf_counter()
    for batch, (out, _rows) in list(zip(batches, outs))[:CPU_BATCHES]:
        q = np.stack([qv for qv, _t in batch])
        terms = [t for _q, t in batch]
        cpu = step_on_cpu(store, q, terms, **knobs)
        n_agree, diff = compare_steps(out, cpu)
        agree_total += n_agree
        worst = max(worst, diff)
        equal, diff = packed_vs_unpacked(store, q, terms, **knobs)
        packed_rows_equal &= equal
        packed_worst = max(packed_worst, diff)
    t_cpu = time.perf_counter() - t0
    agree_frac = agree_total / (CPU_BATCHES * BATCH)
    check(agree_frac >= ROWS_AGREE_MIN,
          f"GPU vs CPU rows agree on {agree_frac:.4f} of queries")
    check(packed_rows_equal, "packed vs unpacked step: rows differ")
    check(packed_worst <= PACKED_TOL, f"packed vs unpacked step: max "
          f"score diff {packed_worst} > {PACKED_TOL}")

    t0 = time.perf_counter()
    bm25 = OracleBM25(docs)
    q_or = np.stack([qv for qv, _t in queries[:N_ORACLE]])
    sims_all = emb @ q_or.T                                   # [N, 64]
    got = torch.cat([r for _o, r in outs]).numpy()
    overlaps, oracle_sets = [], []
    for j, (qv, terms) in enumerate(queries[:N_ORACLE]):
        want = set(oracle_query(qv, terms, emb, bm25, sims_all[:, j]))
        have = {int(r) for r in got[j] if r >= 0}
        overlaps.append(len(have & want) / max(len(want), 1))
        oracle_sets.append(want)
    recall = float(np.mean(overlaps))
    t_oracle = time.perf_counter() - t0
    check(recall >= RECALL_MIN, f"recall@8 {recall} < {RECALL_MIN}")
    warm_wall = statistics.median(walls)
    emit({"phase": "slice", "chunks": CHUNKS,
          "capacity": store.capacity, "batch": BATCH,
          "batches": len(batches), "select": store.select_mode,
          "launches": launches, "rows_agree_gpu_cpu": agree_frac,
          "cpu_batches": CPU_BATCHES,
          "max_score_diff_gpu_cpu": worst, "recall_at_8": recall,
          "packed_vs_unpacked": {"rows_equal": packed_rows_equal,
                                 "max_score_diff": packed_worst},
          "h2d_copies_per_batch": h2d["copies"],
          "h2d_bytes_per_batch": h2d["bytes"], "h2d_kinds": h2d["kinds"],
          "h2d_copy_ops_per_batch": h2d_ops.copies,
          "inputs_wait_for_stream": inputs_wait,
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

    # ---- phase 14's input: the store as phase 3 left it -----------------
    t0 = time.perf_counter()
    mh_dir = tempfile.TemporaryDirectory()
    multihost_save(Path(mh_dir.name), store, docs, batches, outs,
                   {"course": chunk_meta(5)["course"]}, knobs)
    mh_save_s = time.perf_counter() - t0

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
    cpu = step_on_cpu(store, q, terms, **knobs)
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
    catalog_dir = tempfile.TemporaryDirectory()
    catalog = Catalog.load_or_create(catalog_dir.name)
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
    del cpu_store, gpu_ret, cpu_ret      # the catalog serves phase 12

    # ---- 15. int8 --------------------------------------------------------
    int8_phase(ttopk, store, q0, peaks)

    # ---- 6. encoder, 7. ingest + ask --------------------------------------
    enc, enc_launches, enc_tree = encoder_phase(rng, docs, counts, peaks,
                                                args.profile)
    ingest_ask_phase(enc, docs, rng, counts, knobs)

    # ---- 12. sharded: on the slice store, so it runs here -----------------
    sharded = sharded_phase(store, catalog, batches, oracle_sets, questions,
                            enc, enc_tree, docs, rng, counts, knobs)
    del catalog                  # phase 17 takes the store and the encoder
    catalog_dir.cleanup()
    torch.cuda.empty_cache()

    # ---- 18. graft: the driver entry points -------------------------------
    graft_phase(counts)

    # ---- 14. multihost ---------------------------------------------------
    multihost_phase(Path(mh_dir.name), sharded, mh_save_s)
    mh_dir.cleanup()

    # ---- 8. product (its index kept for phase 17) -------------------------
    product_dir = tempfile.TemporaryDirectory()
    product_phase(Path(product_dir.name), docs, emb, counts, args.profile)

    # ---- 9. decode -------------------------------------------------------
    decode_phase()

    # ---- 10. train, 17. tools, 11. routed ---------------------------------
    with tempfile.TemporaryDirectory() as ckpt_dir:
        launches_10 = train_phase(tatt, docs, counts, peaks,
                                  Path(ckpt_dir))["launches"]
        mesh_train_phase(docs, counts)
        # After phase 10's trace, which the profiler cuts short of kernels
        # in an older process (tools/torch_profiler_drops.py); before
        # phase 11, whose memory bars read the card without these.
        tools_phase(Path(product_dir.name), store, batches, enc, docs,
                    counts)
        product_dir.cleanup()
        del enc, store
        torch.cuda.empty_cache()
        routed_phase(enc_tree, Path(ckpt_dir), docs, counts)
    del enc_tree, docs, emb

    # ---- 16. bench ---------------------------------------------------------
    bench = bench_phase(counts)
    # Phase 2's row_select and bm25_sat_gemm parts, last, so that no phase
    # runs later in the process's life for them (an older process's
    # traces drop more).
    select_rows = row_select_phase()
    bm25_row = bm25_core_phase()

    line = []
    for row, n in ((kern, launches["topk_scan"]),
                   (merge, launches["topk_merge"]),
                   *((row, launches["row_select"]) for row in select_rows),
                   (bm25_row, bench["launches"]["bm25_sat_gemm"]),
                   (gelu, enc_launches["bias_gelu"]),
                   (ln, enc_launches["residual_ln"]),
                   (flash, enc_launches["flash_attn"]),
                   *((row, launches_10[row["name"]]) for row in bwd_rows)):
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
