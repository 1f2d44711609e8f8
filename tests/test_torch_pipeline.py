"""The port's product path (get_runtime → ingest_file → ask_question /
ask_question_batch → persist, stats, admin) against the JAX package's.

Both runtimes run with EMBEDDING_BACKEND=hash and LLM_BACKEND=extractive
in their own temporary index directories and ingest the same files (the
documents of tests/test_pipeline.py), so chunk ids — hashed over the
source path — must be EQUAL, and so must every answer, its citations and
the retrieved ids, with and without filters and neighbour expansion.
Scores agree within atol/rtol 1e-5. The port's runtime runs on the CPU
(``device="cpu"``). The decoder backends answer through the port's
DecodeRunner; with routing on, both route every ask through their sticky
loaders. The shard count of a host with more cards is the JAX
package's (tests/test_torch_runtime_sharded.py drives the engine).
"""

import dataclasses
import datetime as _dt

import numpy as np
import pytest
import torch

import classmate_rag_tpu.pipeline.ingest as j_ingest
import classmate_rag_tpu_torch.pipeline.ingest as t_ingest

CALC = (
    "The derivative of a function measures its rate of change. "
    "It is the limit of the difference quotient.\n\n"
    "The product rule and the chain rule compute derivatives of "
    "products and compositions. Practice with polynomial examples.\n\n"
    "Integrals accumulate the area under a curve. The fundamental "
    "theorem of calculus links both operations."
)
PASTA = (
    "Boil salted water in a large pot. Cook the pasta nine minutes. "
    "Drain it and toss with tomato sauce and basil."
)
LONG = "\n\n".join(
    f"Section {k}. Linear algebra studies vector spaces and linear maps "
    f"between them; topic{k} covers matrices, bases and eigenvalues in "
    "depth with many worked examples for the reader. " * 3
    for k in range(6)
)
QUESTIONS = [
    "what is the derivative",
    "how long do I cook the pasta",
    "explain general relativity tensors",
    "eigenvalues of matrices topic3",
    "cosa misura la derivata",
]


@pytest.fixture(autouse=True)
def _fresh_configs():
    """Set up before monkeypatch, so torn down after it: both packages'
    config singletons are re-read from the restored environment."""
    yield
    from classmate_rag_tpu.config import load_config as jload
    from classmate_rag_tpu_torch.config import load_config as tload

    jload(reload=True)
    tload(reload=True)


class _FixedNow(_dt.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5, tzinfo=tz)


def _env(monkeypatch, root, **extra):
    for var, rel in (("INDEX_DIR", ""), ("DENSE_DIR", "/dense"),
                     ("BM25_DIR", "/bm25"), ("EMB_CACHE_DIR", "/emb")):
        monkeypatch.setenv(var, str(root) + rel)
    monkeypatch.setenv("EMBEDDING_BACKEND", "hash")
    monkeypatch.setenv("LLM_BACKEND", "extractive")
    # One device on both sides: the JAX package would otherwise shard the
    # corpus over the test platform's virtual devices.
    monkeypatch.setenv("N_SHARDS", "1")
    for k, v in extra.items():
        monkeypatch.setenv(k, v)


def make_runtimes(monkeypatch, tmp_path):
    """(JAX runtime, port runtime) over the same ingested documents."""
    from classmate_rag_tpu.pipeline.runtime import get_runtime as j_get
    from classmate_rag_tpu_torch.pipeline.runtime import get_runtime as t_get

    monkeypatch.setattr(j_ingest, "datetime", _FixedNow)
    monkeypatch.setattr(t_ingest, "datetime", _FixedNow)
    docs = tmp_path / "docs"
    docs.mkdir(exist_ok=True)
    for name, text in (("calc.md", CALC), ("pasta.txt", PASTA),
                       ("algebra.md", LONG)):
        (docs / name).write_text(text)
    _env(monkeypatch, tmp_path / "j")
    jrt = j_get(reload=True)
    _env(monkeypatch, tmp_path / "t")
    trt = t_get(reload=True, device="cpu")
    # Small chunks, so neighbour expansion has neighbours to add.
    for rt in (jrt, trt):
        rt.cfg = dataclasses.replace(rt.cfg, chunk_size=200,
                                     chunk_overlap=30)
    return jrt, trt, docs


def _ingest_all(jrt, trt, docs):
    from classmate_rag_tpu.metadata import normalize_cli_metadata as jmeta
    from classmate_rag_tpu_torch.metadata import (
        normalize_cli_metadata as tmeta,
    )

    out = []
    for name, meta in (("calc.md", dict(course="calc101", tags="week1")),
                       ("pasta.txt", dict(course="cooking")),
                       ("algebra.md", dict(course="calc101"))):
        a = j_ingest.ingest_file(path=docs / name, doc_meta=jmeta(**meta),
                                 runtime=jrt)
        b = t_ingest.ingest_file(path=docs / name, doc_meta=tmeta(**meta),
                                 runtime=trt)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        out.append(b)
    return out


def _same_result(a, b):
    assert (a.question, a.answer, a.language, a.sources, a.top_k,
            a.filters_applied, a.hybrid, a.route) == (
        b.question, b.answer, b.language, b.sources, b.top_k,
        b.filters_applied, b.hybrid, b.route)
    assert [r["id"] for r in a.retrieved] == [r["id"] for r in b.retrieved]
    for x, y in zip(a.retrieved, b.retrieved):
        assert x["metadata"] == y["metadata"] and x["document"] == y[
            "document"]
        for k in ("fused", "vector_distance", "bm25_score"):
            u, v = x["scores"].get(k), y["scores"].get(k)
            assert (u is None) == (v is None), k
            if u is not None:
                np.testing.assert_allclose(u, v, rtol=1e-5, atol=1e-5)


@pytest.fixture()
def runtimes(monkeypatch, tmp_path):
    jrt, trt, docs = make_runtimes(monkeypatch, tmp_path)
    results = _ingest_all(jrt, trt, docs)
    assert sum(r.total_chunks for r in results) > 6
    yield jrt, trt, docs
    from classmate_rag_tpu.pipeline.runtime import reset_runtime as jr
    from classmate_rag_tpu_torch.pipeline.runtime import reset_runtime as tr

    jr()
    tr()


FILTERS = [{}, {"course": "calc101"}, {"course": "cooking"},
           {"tags": "week1"}, {"language": "it"}]


@pytest.mark.parametrize("expand", [True, False])
@pytest.mark.parametrize("fidx", range(len(FILTERS)))
def test_ask_matches(runtimes, expand, fidx):
    from classmate_rag_tpu.metadata import normalize_cli_metadata as jmeta
    from classmate_rag_tpu.pipeline.ask import ask_question as jask
    from classmate_rag_tpu_torch.metadata import (
        normalize_cli_metadata as tmeta,
    )
    from classmate_rag_tpu_torch.pipeline.ask import ask_question as task

    jrt, trt, _ = runtimes
    for rt in (jrt, trt):
        rt.cfg = dataclasses.replace(rt.cfg,
                                     enable_neighbor_expansion=expand)
    f = FILTERS[fidx]
    for q in QUESTIONS:
        a = jask(question=q, filters=jmeta(**f), top_k=3, runtime=jrt)
        b = task(question=q, filters=tmeta(**f), top_k=3, runtime=trt)
        _same_result(a, b)


def test_batch_ask_and_spec_path_match(runtimes):
    from classmate_rag_tpu.metadata import normalize_cli_metadata as jmeta
    from classmate_rag_tpu.pipeline.ask import ask_question_batch as jb
    from classmate_rag_tpu_torch.metadata import (
        normalize_cli_metadata as tmeta,
    )
    from classmate_rag_tpu_torch.pipeline.ask import (
        ask_question, ask_question_batch,
    )

    jrt, trt, _ = runtimes
    a = jb(questions=QUESTIONS, filters=jmeta(), top_k=4, runtime=jrt)
    b = ask_question_batch(questions=QUESTIONS, filters=tmeta(), top_k=4,
                           runtime=trt)
    for x, y in zip(a, b):
        _same_result(x, y)
    singles = [ask_question(question=q, filters=tmeta(), top_k=4,
                            runtime=trt) for q in QUESTIONS]
    for x, y in zip(singles, b):
        _same_result(x, y)
    # The per-question spec path (bf16 scan, no f16 pool rescore) gives
    # the JAX package's spec path's rows and scores.
    for q in QUESTIONS:
        for hybrid in (True, False):
            want = jrt.retriever.retrieve(question=q, top_k=4,
                                          hybrid=hybrid, use_fused=False)
            got = trt.retriever.retrieve(question=q, top_k=4,
                                         hybrid=hybrid, use_fused=False)
            assert [r["id"] for r in got] == [r["id"] for r in want]
            for x, y in zip(got, want):
                for k, v in y["scores"].items():
                    if v is None:
                        assert x["scores"][k] is None
                    else:
                        np.testing.assert_allclose(
                            x["scores"][k], v, rtol=1e-5, atol=1e-5)


def test_reingest_delete_and_stats(runtimes):
    from classmate_rag_tpu.admin import manage as jm
    from classmate_rag_tpu.metadata import normalize_cli_metadata as jmeta
    from classmate_rag_tpu.pipeline.stats import index_stats as jstats
    from classmate_rag_tpu_torch.admin import manage as tm
    from classmate_rag_tpu_torch.metadata import (
        normalize_cli_metadata as tmeta,
    )
    from classmate_rag_tpu_torch.pipeline.stats import index_stats as tstats

    jrt, trt, docs = runtimes
    before = len(trt.store)
    b = t_ingest.ingest_file(path=docs / "calc.md",
                             doc_meta=tmeta(course="calc101", tags="week1"),
                             runtime=trt)
    j_ingest.ingest_file(path=docs / "calc.md",
                         doc_meta=jmeta(course="calc101", tags="week1"),
                         runtime=jrt)
    assert len(trt.store) == before and b.upserted > 0

    def stats_view(s):
        return {k: s[k] for k in ("vectors", "bm25", "tombstones",
                                  "vocab_terms", "maintenance")}

    def port_view(s):
        # The filtered-df cache's lookups: counters only the port keeps.
        m = s["maintenance"]
        assert m.pop("df_filter_cache_hits") >= 0
        assert m.pop("df_filter_cache_misses") >= 0
        return stats_view(s)

    assert stats_view(jstats(jrt)) == port_view(tstats(trt))
    ids_j = jm.resolve_ids(path=str(docs / "pasta.txt"), runtime=jrt)
    ids_t = tm.resolve_ids(path=str(docs / "pasta.txt"), runtime=trt)
    assert ids_j == ids_t and ids_t
    assert jm.delete_by_ids(ids_j, runtime=jrt) == tm.delete_by_ids(
        ids_t, runtime=trt)
    assert stats_view(jstats(jrt)) == port_view(tstats(trt))
    assert tm.list_entries({"course": "calc101"}, runtime=trt) == (
        jm.list_entries({"course": "calc101"}, runtime=jrt))
    res_t = tm.reingest_paths([str(docs / "calc.md")], runtime=trt)
    res_j = jm.reingest_paths([str(docs / "calc.md")], runtime=jrt)
    assert res_t == res_j
    hit = trt.retriever.retrieve(question="boil salted water pasta")
    assert not {r["id"] for r in hit} & set(ids_t)
    # A cold start from the persisted directory answers the same.
    from classmate_rag_tpu_torch.pipeline.runtime import get_runtime

    again = get_runtime(reload=True, device="cpu")
    assert again.store.n_rows == trt.store.n_rows
    for q in QUESTIONS:
        x = trt.retriever.retrieve(question=q)
        y = again.retriever.retrieve(question=q)
        assert [r["id"] for r in x] == [r["id"] for r in y]


def _gguf(tmp_path):
    p = tmp_path / "model.gguf"
    p.write_bytes(b"GGUF")
    return str(p)


def _encoder_checkpoint(tmp_path):
    """A port training checkpoint of the small test encoder."""
    from classmate_rag_tpu_torch.embeddings.model import (
        EncoderConfig,
        init_params,
    )
    from classmate_rag_tpu_torch.training import make_train_step
    from classmate_rag_tpu_torch.training.checkpoint import save_train_state

    cfg = EncoderConfig.small_test()
    init, _step = make_train_step(cfg, "cpu")
    return save_train_state(init(init_params(cfg, "ckpt")),
                            tmp_path / "ckpt", config=cfg)


# Backend and runtime paths beyond the extractive one: (name, env, what
# the port does). The decoder paths build the port's DecodeRunner where
# the JAX package builds its TPUDecodeRunner (bounded by
# TPU_DECODE_MAX_SEQ and LLM_MAX_TOKENS, which both runners honour); a
# GGUF that does not parse falls through to the extractive runner, as
# the JAX package's get_runner does; an encoder checkpoint of the port
# (ENCODER_CHECKPOINT) serves the runtime's embedder; routing answers
# through the sticky loader (no route model file here: extractive) and
# never builds the runtime's own runner.
BOUNDED = dict(TPU_DECODE_MAX_SEQ="96", LLM_MAX_TOKENS="4",
               LLM_TEMPERATURE="0")
BACKEND_PATHS = [
    ("LLM_BACKEND=tpu", dict(LLM_BACKEND="tpu", **BOUNDED), "decoder"),
    ("decoder dir", dict(LLM_BACKEND="auto", TPU_DECODER_MODEL_DIR="{tmp}",
                         **BOUNDED), "decoder"),
    ("gguf", dict(LLM_BACKEND="auto", LLM_MODEL_PATH="{gguf}"),
     "extractive"),
    ("routing", dict(ENABLE_ROUTING="1"), "routed"),
    ("encoder checkpoint", dict(ENCODER_CHECKPOINT="{ckpt}",
                                EMBEDDING_BACKEND="e5"), "extractive"),
]


@pytest.mark.parametrize("name,env,expect", BACKEND_PATHS,
                         ids=[n for n, _e, _x in BACKEND_PATHS])
def test_backend_paths_answer_or_raise(monkeypatch, tmp_path, name, env,
                                       expect):
    from classmate_rag_tpu.config import load_config as jload
    from classmate_rag_tpu.generation.runner import get_runner as j_runner
    from classmate_rag_tpu_torch.generation.runner import (
        DecodeRunner,
        ExtractiveRunner,
        _FAILED_GGUF_RESOLVES,
    )
    from classmate_rag_tpu_torch.metadata import normalize_cli_metadata
    from classmate_rag_tpu_torch.pipeline.ask import ask_question
    from classmate_rag_tpu_torch.pipeline.runtime import get_runtime

    _env(monkeypatch, tmp_path / "t")
    subst = {"tmp": str(tmp_path), "gguf": _gguf(tmp_path),
             "ckpt": _encoder_checkpoint(tmp_path)}
    for k, v in env.items():
        monkeypatch.setenv(k, v.format(**subst))
    monkeypatch.delenv("LLAMA_CPP_LIB", raising=False)
    _FAILED_GGUF_RESOLVES.clear()
    rt = get_runtime(reload=True, device="cpu")
    if "ENCODER_CHECKPOINT" in env:
        assert "@ckpt-step_0-" in rt.embedder.model_name
    (tmp_path / "d.txt").write_text("The derivative measures change.")
    t_ingest.ingest_file(path=tmp_path / "d.txt",
                         doc_meta=normalize_cli_metadata(), runtime=rt)
    res = ask_question(question="what does the derivative measure",
                       filters=normalize_cli_metadata(), runtime=rt)
    assert res.answer
    if expect == "routed":
        from classmate_rag_tpu.routing import StickyModelLoader as JLoader
        from classmate_rag_tpu_torch.routing import ROUTES

        assert res.route in ROUTES and res.route_reason
        assert next(rt.catalog.entries()).metadata["subject"] in ROUTES
        assert rt._runner is None
        assert type(rt.loader.ensure_loaded(res.route)) is ExtractiveRunner
        assert type(JLoader(jload(reload=True)).ensure_loaded(
            res.route)).__name__ == "ExtractiveRunner"
        return
    want = {"decoder": DecodeRunner, "extractive": ExtractiveRunner}[expect]
    assert type(rt.runner) is want
    # The JAX package builds the counterpart on the same configuration.
    jtype = type(j_runner(jload(reload=True))).__name__
    assert jtype == {"decoder": "TPUDecodeRunner",
                     "extractive": "ExtractiveRunner"}[expect]
    _FAILED_GGUF_RESOLVES.clear()


def test_routed_ask_and_more_cards_raise(runtimes, monkeypatch):
    from classmate_rag_tpu.metadata import normalize_cli_metadata as jmeta
    from classmate_rag_tpu.pipeline.ask import ask_question as jask
    from classmate_rag_tpu.pipeline.ask import ask_question_batch as jb
    from classmate_rag_tpu_torch.metadata import normalize_cli_metadata
    from classmate_rag_tpu_torch.pipeline.ask import (
        ask_question,
        ask_question_batch,
    )
    from classmate_rag_tpu.pipeline.runtime import _pick_n_shards as jpick
    from classmate_rag_tpu_torch.pipeline.runtime import _pick_n_shards

    jrt, trt, _ = runtimes
    for rt in (jrt, trt):
        rt.cfg = dataclasses.replace(rt.cfg, enable_routing=True)
    # A routed ask answers as the JAX package's does: the same route,
    # reason and retrieved ids, forced or decided by the router.
    for forced in (None, "math", "matematica", "bogus"):
        for q in QUESTIONS:
            a = jask(question=q, filters=jmeta(), forced_subject=forced,
                     runtime=jrt)
            b = ask_question(question=q, filters=normalize_cli_metadata(),
                             forced_subject=forced, runtime=trt)
            assert (b.route, b.route_reason) == (a.route, a.route_reason)
            _same_result(a, b)
    a = jb(questions=QUESTIONS, filters=jmeta(subject="code"), runtime=jrt)
    b = ask_question_batch(questions=QUESTIONS,
                           filters=normalize_cli_metadata(subject="code"),
                           runtime=trt)
    assert [(x.route, x.route_reason) for x in b] == [
        (x.route, x.route_reason) for x in a] and b[0].route == "code"
    for x, y in zip(a, b):
        _same_result(x, y)
    assert trt._runner is None
    # More cards no longer raise: the shard count is the JAX package's
    # (8 cards as its 8 virtual devices; walked down to a slab divisor).
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for n in (0, 1, 2, 3, 12):
        for slab in (4096, 12):
            assert _pick_n_shards(
                dataclasses.replace(trt.cfg, n_shards=n), slab,
                torch.device("cuda"),
            ) == jpick(dataclasses.replace(jrt.cfg, n_shards=n), slab)
    assert _pick_n_shards(dataclasses.replace(trt.cfg, n_shards=0), 4096,
                          torch.device("cpu")) == 1
