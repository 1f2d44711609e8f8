"""The port stands alone: it imports neither JAX (nor optax or orbax) nor
the JAX package, nor the JAX package's command line (``cli``), with every
module of it imported and its paths driven (the sharded engine, the
dp×tp train step and tp decode of ``parallel/`` too; the multi-process
mesh, the native tokenizer, the int8 scan and the profiling helpers;
the port's benchmark, which pulls in neither the root ``bench`` either;
the port's measurement tools, which import neither the root ``bench``
nor the root ``tools/``; the driver entry points, which do not import
the root ``__graft_entry__``), and a
default-device call without CUDA (a training mesh without devices
too) raises instead of running on the CPU. Both checks run in a fresh interpreter."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_HOOK = textwrap.dedent("""
    import importlib.abc, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "optax", "orbax",
                       "classmate_rag_tpu", "cli", "bench", "tools",
                       "__graft_entry__"):
                raise ImportError(f"the port must not import {name}")
            return None

    sys.meta_path.insert(0, Refuse())
""")


def _run(code, **env):
    return subprocess.run(
        [sys.executable, "-c", _HOOK + textwrap.dedent(code)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT), **env},
    )


def test_port_imports_and_queries_without_jax():
    proc = _run("""
        import importlib, pkgutil
        import numpy as np
        import classmate_rag_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke  # the chip script imports no JAX either
        from classmate_rag_tpu_torch.index.store import IndexStore
        rng = np.random.default_rng(0)
        emb = rng.standard_normal((50, 16)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        s = IndexStore(16, slab_rows=64, terms_per_chunk=8, device="cpu")
        s.upsert([f"c{i}" for i in range(50)], emb,
                 [["alpha", "beta"][: 1 + i % 2] for i in range(50)],
                 [{"course": "x"}] * 50)
        out = s.hybrid_topk_batch(emb[:2], [["alpha"], []])
        assert (out.rows >= 0).all(), out.rows
        # The corpus-sharded engine, on two logical shards of the CPU.
        from classmate_rag_tpu_torch.parallel import ShardedHybridIndex
        sh = ShardedHybridIndex(s, ["cpu", "cpu"])
        assert (sh.query_batch(emb[:2], [["alpha"], []]).rows
                == out.rows).all()
        # Multihost (a process that stays local, its mesh over
        # processes), the native tokenizer and packer, the int8 scan,
        # the profiling helpers.
        from classmate_rag_tpu_torch.parallel import multihost
        multihost.initialize()
        sh = ShardedHybridIndex(s, multihost.process_corpus_mesh(
            ["cpu", "cpu"]))
        assert (sh.query_batch(emb[:2], [["alpha"], []]).rows
                == out.rows).all()
        assert multihost.dcn_training_mesh(["cpu"] * 4).shape == {
            "replica": 1, "data": 1, "model": 4}
        from classmate_rag_tpu_torch import native
        from classmate_rag_tpu_torch.index.lexical import tokenize
        assert tokenize("Derivatives measure change", "en") == [
            "derivatives", "measure", "change"]
        native.make_native_packer()
        import torch
        from classmate_rag_tpu_torch.ops.quant import (
            quantize_rows, topk_int8_rescore)
        e8, sc = quantize_rows(emb)
        _v, r8 = topk_int8_rescore(
            torch.from_numpy(e8), torch.from_numpy(sc),
            torch.from_numpy(emb).bfloat16(), torch.from_numpy(emb[:2]),
            torch.zeros(50), 4, rescore_pool=8)
        assert r8[:, 0].tolist() == [0, 1], r8
        import tempfile
        from classmate_rag_tpu_torch.utils.profiling import (
            Throughput, trace)
        assert Throughput(1.0, 1e9, chip="h100-sxm").report()["chip"] == (
            "h100-sxm")
        with trace(tempfile.mkdtemp()):
            torch.ones(4).sum()
        # The product path: runtime, ingest, ask, persist, server.
        import os, pathlib, tempfile
        root = pathlib.Path(tempfile.mkdtemp())
        os.environ.update(INDEX_DIR=str(root), DENSE_DIR=str(root / "d"),
                          BM25_DIR=str(root / "b"),
                          EMB_CACHE_DIR=str(root / "e"),
                          EMBEDDING_BACKEND="hash", LLM_BACKEND="auto")
        from classmate_rag_tpu_torch.metadata import normalize_cli_metadata
        from classmate_rag_tpu_torch.pipeline import (
            ask_question, get_runtime, ingest_file)
        from classmate_rag_tpu_torch.serve import make_server
        rt = get_runtime(reload=True, device="cpu")
        doc = root / "a.txt"
        doc.write_text("The derivative measures the rate of change.")
        ingest_file(path=doc, doc_meta=normalize_cli_metadata(), runtime=rt)
        res = ask_question(question="what does the derivative measure",
                           filters=normalize_cli_metadata(), runtime=rt)
        assert "[1]" in res.answer, res.answer
        make_server("127.0.0.1", 0, runtime=rt).server_close()
        # Routing, the backup verbs and the command line.
        from classmate_rag_tpu_torch.cli.main import main as cli_main
        os.environ.update(ENABLE_ROUTING="1")
        rt = get_runtime(reload=True, device="cpu")
        for argv in (["ask", "what does the derivative measure",
                      "--subject", "math"],
                     ["dump", "--path", str(root / "dump.jsonl")],
                     ["vacuum"], ["stats"]):
            assert cli_main(argv, device="cpu") == 0, argv
        assert rt.loader.resident_route == "__unresolved__"
        assert rt._runner is None
        del os.environ["ENABLE_ROUTING"]
        # The decoder: a tiny GGUF written by the port, answered with
        # LLM_BACKEND=tpu.
        from classmate_rag_tpu_torch.generation import DecodeRunner
        from classmate_rag_tpu_torch.models import decoder, gguf
        cfg = decoder.DecoderConfig.tiny_test()
        toks = ["<unk>", "<s>", "</s>"] + [f"t{i}" for i in range(509)]
        gguf.export_decoder_to_gguf(
            root / "tiny.gguf", decoder.init_params(cfg, "iso"), cfg,
            quant_type=gguf.GGML_Q8_0, extra_metadata={
                "tokenizer.ggml.model": "llama",
                "tokenizer.ggml.tokens": (gguf.T_ARRAY,
                                          (gguf.T_STRING, toks)),
                "tokenizer.ggml.scores": (gguf.T_ARRAY,
                                          (gguf.T_FLOAT32, [0.0] * 512)),
                "tokenizer.ggml.bos_token_id": 1,
                "tokenizer.ggml.eos_token_id": 2})
        os.environ.update(LLM_BACKEND="tpu", LLM_TEMPERATURE="0",
                          LLM_MODEL_PATH=str(root / "tiny.gguf"),
                          LLM_MAX_TOKENS="4", TPU_DECODE_MAX_SEQ="64")
        rt = get_runtime(reload=True, device="cpu")
        res = ask_question(question="what does the derivative measure",
                           filters=normalize_cli_metadata(), runtime=rt)
        assert isinstance(rt.runner, DecodeRunner), rt.runner
        assert rt.runner.model_name == "tiny.gguf"
        assert isinstance(res.answer, str)
        # Training: a step, a checkpoint, and the embedder serving it.
        from classmate_rag_tpu_torch.embeddings import get_embedder
        from classmate_rag_tpu_torch.embeddings.model import (
            EncoderConfig, init_params)
        from classmate_rag_tpu_torch.training import make_train_step
        from classmate_rag_tpu_torch.training.checkpoint import (
            save_train_state)
        ecfg = EncoderConfig.small_test()
        init, step = make_train_step(ecfg, "cpu", accum_steps=2)
        state = init(init_params(ecfg, "iso"))
        ids = np.ones((4, 16), np.int32)
        state, loss = step(state, ids, ids, ids, ids)
        save_train_state(state, root / "ck", config=ecfg)
        # dp×tp: a train step on a (2, 4) mesh and a tp decode.
        from classmate_rag_tpu_torch.parallel import (
            DeviceMesh, make_tp_generate_fn, shard_decoder_params,
            training_mesh)
        from classmate_rag_tpu_torch.parallel import tensor, tp_decode
        mesh = training_mesh(devices=["cpu"] * 8)
        assert mesh.shape == {"data": 2, "model": 4}
        init, step = make_train_step(ecfg, mesh)
        _, loss = step(init(init_params(ecfg, "iso")), ids, ids, ids, ids)
        assert np.isfinite(float(loss))
        tp = DeviceMesh([["cpu", "cpu"]])
        toks = make_tp_generate_fn(cfg, tp, 16, 4)(
            shard_decoder_params(decoder.init_params(cfg, "iso"), cfg, tp),
            np.full((1, 4), 5), np.array([4]), 0, 0.0, 1.0, 2)
        assert toks.shape == (1, 4)
        os.environ.update(EMBEDDING_BACKEND="e5")
        enc = get_embedder(checkpoint=str(root / "ck"), device="cpu")
        assert enc.encode_queries(["a b"]).shape == (1, 64)
        # The driver entry points' six stages, on two logical CPU ranks.
        from classmate_rag_tpu_torch import graft_entry
        assert set("abcdef") <= set(graft_entry.dryrun_multichip(2, "cpu"))
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "optax",
                                               "orbax", "classmate_rag_tpu",
                                               "cli"))
        assert not loaded, loaded
        print("modules", len(names))
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "modules" in proc.stdout


def test_bench_runs_without_jax_or_root_bench():
    proc = _run("""
        import sys
        import classmate_rag_tpu_torch.bench as b
        b.N_QUERIES, b.BATCH, b.MIN_PASS_S = 16, 8, 0.01
        out = b.run_scale(400, n_oracle=8, filtered_oracle=True,
                          device="cpu")
        assert out["recall_vs_oracle@8"] >= 0.99, out
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib",
                                               "classmate_rag_tpu", "cli",
                                               "bench"))
        assert not loaded, loaded
        print("bench ran")
    """, BENCH_PASSES="1")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "bench ran" in proc.stdout


def test_tools_import_no_root_bench_or_tools():
    """Every import statement of ``classmate_rag_tpu_torch/tools/``, at
    any depth (the tools import lazily, inside their functions), names
    the port, torch or the standard library: never JAX, the JAX
    package, the root ``bench`` or the root ``tools/``."""
    import ast

    refused = ("jax", "jaxlib", "classmate_rag_tpu", "cli", "bench", "tools")
    files = sorted((ROOT / "classmate_rag_tpu_torch" / "tools").glob("*.py"))
    assert len(files) == 15, [f.name for f in files]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, (path.name, node.module)
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in refused, (path.name, name)


def test_default_device_without_cuda_raises():
    proc = _run("""
        import numpy as np
        import torch
        assert not torch.cuda.is_available()
        from classmate_rag_tpu_torch.index.store import IndexStore
        from classmate_rag_tpu_torch.device import resolve_device
        from classmate_rag_tpu_torch.pipeline.runtime import get_runtime
        from classmate_rag_tpu_torch.serve import make_server
        from classmate_rag_tpu_torch.embeddings.model import EncoderConfig
        from classmate_rag_tpu_torch.training import make_train_step
        from classmate_rag_tpu_torch.cli.main import main as cli_main
        from classmate_rag_tpu_torch.parallel import (
            corpus_mesh, training_mesh)
        from classmate_rag_tpu_torch.parallel.multihost import (
            dcn_training_mesh, process_corpus_mesh)
        from classmate_rag_tpu_torch import graft_entry
        for call in (lambda: IndexStore(8), lambda: resolve_device(None),
                     lambda: corpus_mesh(), lambda: training_mesh(),
                     lambda: process_corpus_mesh(),
                     lambda: dcn_training_mesh(),
                     lambda: cli_main(["stats"]),
                     lambda: make_train_step(EncoderConfig.small_test()),
                     lambda: resolve_device("cuda"),
                     lambda: get_runtime(reload=True),
                     lambda: make_server("127.0.0.1", 0),
                     lambda: graft_entry.entry(),
                     lambda: graft_entry.dryrun_multichip(2)):
            try:
                call()
            except RuntimeError as e:
                assert "CUDA" in str(e)
            else:
                raise SystemExit("default device ran without CUDA")
        assert resolve_device("cpu").type == "cpu"
        print("raised")
    """, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "raised" in proc.stdout
