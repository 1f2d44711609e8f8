"""The port's measurement harnesses (``classmate_rag_tpu_torch/tools/``)
on the CPU, at small sizes, against the JAX side where a tool computes a
result: a product index the JAX package loads, ingest counts and chunk
ids equal to the JAX package's, the catalog fold equal to the root
tool's, a recall miss decomposed into the root ``bench.py``'s oracle
numbers, and the profile's stages equal to the parts of the fused step;
then every tool's ``main`` with ``--device cpu`` (the root tool's keys in
its last line) and the load harness with a mutation storm.
"""

import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as root_bench
from classmate_rag_tpu_torch import bench
from classmate_rag_tpu_torch.tools import (
    bench_hybrid_profile,
    bench_ingest,
    build_product_index,
    debug_recall_1m,
    probe_fold_1m,
)

ROOT = Path(__file__).resolve().parents[1]
N = 1500          # chunks of the shared bench corpus
N_QUERIES = 32


@pytest.fixture(autouse=True)
def _fresh_configs():
    yield
    from classmate_rag_tpu.config import load_config as jload
    from classmate_rag_tpu_torch.config import load_config as tload
    from classmate_rag_tpu_torch.pipeline.runtime import reset_runtime

    reset_runtime()
    jload(reload=True)
    tload(reload=True)


def _env(monkeypatch, root: Path) -> dict:
    env = {"INDEX_DIR": str(root), "DENSE_DIR": str(root / "dense"),
           "BM25_DIR": str(root / "bm25"), "EMB_CACHE_DIR": str(root / "emb"),
           "EMBEDDING_BACKEND": "hash", "LLM_BACKEND": "extractive",
           "N_SHARDS": "1", "RUNTIME_PRECOMPILE": "off"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    from classmate_rag_tpu_torch.config import load_config

    load_config(reload=True)
    return env


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(42)
    docs, emb = bench.build_corpus(rng, N)
    queries = bench.make_queries(rng, docs, emb)[:N_QUERIES]
    return docs, emb, queries


@pytest.fixture(scope="module")
def store(corpus):
    docs, emb, _ = corpus
    return bench_hybrid_profile.bench_store(docs, emb, "cpu")


@pytest.fixture(scope="module")
def product_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("prod")
    build_product_index.build(root, 1200, "cpu")
    return root


# ---------------------------------------------------------------------------
# Tools that compute a result, against the JAX side
# ---------------------------------------------------------------------------

def test_build_product_index_loads_in_jax(product_dir):
    from classmate_rag_tpu.index.catalog import Catalog as JCatalog
    from classmate_rag_tpu.index.store import IndexStore as JStore
    from classmate_rag_tpu_torch.index.catalog import Catalog
    from classmate_rag_tpu_torch.index.store import IndexStore

    jcat = JCatalog.load_or_create(product_dir / "bm25")
    tcat = Catalog.load_or_create(product_dir / "bm25")
    jstore = JStore.load_or_create(bench.DIM, product_dir / "dense", jcat,
                                   terms_per_chunk=256)
    tstore = IndexStore.load_or_create(bench.DIM, product_dir / "dense",
                                       tcat, terms_per_chunk=256,
                                       device="cpu")
    assert jstore.ids == tstore.ids and len(tstore.ids) == 1200
    assert list(jcat.ids) == list(tcat.ids)
    for cid in tstore.ids[::97]:
        a, b = jcat.get(cid), tcat.get(cid)
        assert (a.text, a.tokens, a.metadata) == (b.text, b.tokens,
                                                  b.metadata)
    assert np.array_equal(np.asarray(jstore.emb), tstore.emb)


def test_bench_ingest_equals_jax_ingest(monkeypatch, tmp_path, capsys):
    import classmate_rag_tpu.pipeline.ingest as j_ingest
    from classmate_rag_tpu.metadata import normalize_cli_metadata as jmeta
    from test_torch_pipeline import make_runtimes

    jrt, trt, docs = make_runtimes(monkeypatch, tmp_path)
    files = [docs / "calc.md", docs / "algebra.md"]
    out, results = bench_ingest.run(files, repeat=2, course="bench",
                                    runtime=trt)
    want = [j_ingest.ingest_file(path=f, doc_meta=jmeta(course="bench"),
                                 runtime=jrt)
            for _ in range(2) for f in files]
    assert out["total_chunks"] == sum(r.total_chunks for r in want) > 2
    assert [r.chunk_ids for r in results] == [r.chunk_ids for r in want]
    assert out["files"] == 2 and out["repeat"] == 2
    assert out["chunks_per_sec"] > 0
    # The command line, on the port's runtime of the same directory.
    assert bench_ingest.main([str(files[0]), "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"files", "repeat", "total_chunks", "seconds",
            "chunks_per_sec"} <= line.keys()


def _root_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"root_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_probe_fold_equals_root_tool(tmp_path, monkeypatch, capsys):
    import classmate_rag_tpu.index.catalog as jcat
    from classmate_rag_tpu.config import load_config as jload
    from classmate_rag_tpu_torch.index.catalog import Catalog, CatalogEntry

    src = tmp_path / "src"
    cat = Catalog.load_or_create(src)
    for i in range(300):
        cat.upsert(CatalogEntry(f"c{i}", f"text {i} w{i % 17}",
                                ["text", f"w{i % 17}"], {"course": "x"}))
    cat.save()
    shutil.copytree(src, tmp_path / "root")
    shutil.copytree(src, tmp_path / "port")
    # The root tool sets the JAX catalog's thresholds for good: restore
    # them after the test.
    for name in ("_COMPACT_MIN_BYTES", "_COMPACT_RATIO"):
        monkeypatch.setattr(jcat, name, getattr(jcat, name))
    monkeypatch.setenv("BM25_DIR", str(tmp_path / "root"))
    jload(reload=True)
    assert _root_tool("probe_fold_1m").main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    want = json.loads(lines[-1][len("REPORT "):])
    import classmate_rag_tpu_torch.index.catalog as tcat

    before = (tcat._COMPACT_MIN_BYTES, tcat._COMPACT_RATIO)
    got = probe_fold_1m.run(tmp_path / "port")
    assert (tcat._COMPACT_MIN_BYTES, tcat._COMPACT_RATIO) == before
    for key in ("post_fold_entries", "journal_after", "fold_alias"):
        assert got[key] == want[key], key
    assert got["post_fold_entries"] == got["entries_before"] + 2 == 302


def test_debug_recall_decomposes_an_injected_miss(corpus, store):
    docs, emb, queries = corpus
    queries = queries[:4]
    rows, fused = debug_recall_1m.engine_answers(store, queries)
    bm = bench.FastOracleBM25(docs)
    assert debug_recall_1m.decompose(emb, queries, rows, fused,
                                     bm)["n_miss"] == 0
    # Inject: the engine's last pick of query 1 becomes a row the oracle
    # did not pick.
    rbm = root_bench.FastOracleBM25(docs)
    qv, terms = queries[1]
    want = root_bench.oracle_query(qv, terms, emb, rbm)
    intruder = next(r for r in range(N) if r not in want)
    rows = rows.copy()
    dropped = int(rows[1, -1])
    rows[1, -1] = intruder
    out = debug_recall_1m.decompose(emb, queries, rows, fused, bm)
    assert out["n_miss"] == 1
    (miss,) = out["misses"]
    assert miss["query"] == 1
    assert miss["oracle_top"] == want
    assert miss["engine_only"] == [intruder]
    assert miss["oracle_only"] == [dropped]
    sims = emb @ qv
    bs = rbm.get_scores(terms)
    pool = np.argpartition(-sims, root_bench.POOL)[: root_bench.POOL]
    pool = pool[np.argsort(-sims[pool], kind="stable")]
    vec = [int(pool[i]) for i in root_bench.oracle_mmr(qv, emb[pool],
                                                       root_bench.K)]
    bm_ids = np.argsort(-bs, kind="stable")[: root_bench.K].tolist()
    assert miss["oracle_vec_branch"] == vec
    assert miss["oracle_bm25_branch"] == bm_ids
    import ml_dtypes

    for r in miss["rows"]:
        row = r["row"]
        assert r["sim_f32"] == float(sims[row])
        np.testing.assert_allclose(
            r["sim_f16"], emb[row].astype(np.float16).astype(np.float32)
            @ qv, rtol=1e-6)
        np.testing.assert_allclose(
            r["sim_bf16"], emb[row].astype(ml_dtypes.bfloat16)
            .astype(np.float32) @ qv, rtol=1e-6)
        assert r["bm25"] == float(bs[row])
        assert r["oracle_pool"] == (row in set(pool.tolist()))
        assert r["oracle_vec_rank"] == (vec.index(row) if row in vec else -1)
        assert r["oracle_bm_rank"] == (bm_ids.index(row) if row in bm_ids
                                       else -1)
        rrf = sum(1.0 / (root_bench.RRF_K + ranked.index(row) + 1)
                  for ranked in (vec, bm_ids) if row in ranked)
        assert r["oracle_fused"] == pytest.approx(rrf, rel=1e-12)
    assert miss["rows"][[r["row"] for r in miss["rows"]].index(dropped)][
        "engine_fused"] is None


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_profile_stages_equal_the_step(store, corpus):
    from classmate_rag_tpu_torch.ops.hybrid_step import _fuse

    _, _, queries = corpus
    shape, fns = bench_hybrid_profile.stage_fns(store, queries)
    assert shape["H_real"] > 0 and shape["U_real"] > 0
    knobs = dict(weight_vector=1.0, weight_bm25=1.0, rrf_k=60, top_k=8)
    dense = fns["dense_full"]()
    for bm_stage, step in (("bm25_topk", "full_step"),
                           ("bm25_fast", "full_step_approx")):
        got = _fuse(*dense, *fns[bm_stage](), **knobs)
        want = fns[step]()
        for g, w in zip(got, want):
            _same(g, w)
    for g, w in zip(fns["full_step_packed"](), fns["full_step"]()):
        _same(g, w)
    _same(fns["bm25_head"]() + fns["bm25_tail"](), fns["bm25_core"]())
    vals, rows = fns["dense_topk"]()
    assert rows.shape == (len(queries), store.rescore_pool)
    out = bench_hybrid_profile.profile(store, queries, iters=1)
    assert out["stages"]["dense_approx_sel"] == {"same_as": "dense_topk"}
    for name in fns:
        assert out["stages"][name]["ms"] > 0
        assert out["stages"][name]["timing"] == "wall"
    host = out["host"]
    assert host["wall_ms"] >= host["inputs_ms"] > 0
    assert host["h2d_copies"] == 0 and host["torch_ops"] > 0
    assert 0 < host["torch_op_ms"] <= host["traced_span_ms"]
    assert 0 < host["tail_slot_use_pct"] <= 100


def test_bench_serve_with_a_mutation_storm(tmp_path, monkeypatch):
    from classmate_rag_tpu_torch.tools import bench_serve

    _env(monkeypatch, tmp_path / "idx")
    args = bench_serve.parse_args(
        ["--clients", "4", "--seconds", "1.5", "--warmup-seconds", "1.0",
         "--port", "0", "--synthetic", "256", "--mutate", "2",
         "--device", "cpu"])
    out = bench_serve.run(args)
    assert out["errors"] == 0 and out["requests"] > 0
    assert out["http_ask_qps"] > 0 and out["p95_ms"] > 0
    mut = out["mutation"]
    assert mut["rounds_ok"] and len(mut["rounds"]) == 2
    assert mut["reload"]["equal"] and mut["reload"]["reloaded_rows"] >= 256
    assert bench_serve.passed(out)


# ---------------------------------------------------------------------------
# Every tool's command line on the CPU: exit 0, the root tool's keys
# ---------------------------------------------------------------------------

MAINS = {
    "probe_mutation_sync": (
        ["--rows", "1200"],
        {"rows", "steady_ask_ms", "trial0", "trial2", "counters_after"}),
    "bench_hybrid_profile": (
        ["--chunks", "1200"], {"shape", "stages", "step_device_ms"}),
    "debug_recall_1m": (
        ["--chunks", "1200", "--queries", "4"], {"n_miss", "misses"}),
    "bench_embed": (
        ["--tiny", "--batch", "4", "--seq", "32", "--iters", "2"],
        {"model", "batch", "seq", "ms_per_batch", "chunks_per_sec",
         "tokens_per_sec", "mfu"}),
    "bench_encoder_roofline": (
        ["--config", "small_test", "--batch", "2", "--seq", "32",
         "--iters", "1"],
        {"config", "full_step_ms", "mfu", "components_ms",
         "achieved_tflops", "mfu_if_only_matmuls", "peak_tflops_assumed"}),
    "bench_decode": (
        ["--batch", "2", "--prompt", "8", "--new", "4", "--hidden", "64"],
        {"layers", "hidden", "batch", "new_tokens", "param_bytes",
         "transfer_seconds", "seconds", "decode_tokens_per_sec"}),
    "bench_scan": ([], {"routes", "int8_recall_vs_scan"}),
    "probe_first_dispatch": (
        [], {"load_s", "all_uploads_s", "kernel_build_s", "kernel_load_s",
             "step_first_call_s", "step_second_call_s"}),
    "bench_ask": (
        ["what about w3 w17", "w5 w9 rate", "--n", "3", "--retrieval-only"],
        {"n", "retrieval_only", "per_ask_ms", "mean_ms", "p95_ms"}),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_on_the_cpu(name, product_dir, tmp_path, monkeypatch, capsys):
    argv, keys = MAINS[name]
    mod = importlib.import_module(f"classmate_rag_tpu_torch.tools.{name}")
    if name in ("probe_first_dispatch", "bench_ask"):
        shutil.copytree(product_dir, tmp_path / "prod")
        _env(monkeypatch, tmp_path / "prod")
    if name == "bench_scan":
        monkeypatch.setattr(mod, "N", 1200)
        monkeypatch.setattr(mod, "Q", 8)
    if name == "bench_hybrid_profile":
        monkeypatch.setattr(mod, "BATCH", 16)
        monkeypatch.setattr(mod, "ITERS", 1)
    assert mod.main(argv + ["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert keys <= line.keys(), keys - line.keys()
    if name == "probe_mutation_sync":
        before, after = line["counters_before"], line["counters_after"]
        assert after["device_full_uploads"] == before["device_full_uploads"]
        assert after["split_full_builds"] == before["split_full_builds"]


def test_probe_cold_start_in_a_fresh_process(product_dir, tmp_path,
                                             monkeypatch):
    shutil.copytree(product_dir, tmp_path / "prod")
    env = {**os.environ, **_env(monkeypatch, tmp_path / "prod"),
           "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-m", "classmate_rag_tpu_torch.tools.probe_cold_start",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for key in ("runtime_load", "load_split", "upload_link_probe_1gb",
                "sync_device_upload", "sync_split_upload", "df_upload",
                "bias", "first_ask", "second_ask", "add_load_chunk",
                "add_classifier_first", "add_encode_passages",
                "add_ingest_file", "persist_after_add",
                "ask_after_add_first", "ask_after_add_second", "counters"):
        assert key in out, key
    assert out["n_rows"] == 1200 and out["kernel_load"] is None
    assert out["counters"]["device_full_uploads"] == 1
