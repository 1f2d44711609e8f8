"""The port's routing (classmate_rag_tpu_torch/routing/) against the JAX
package's, on the CPU.

- With the hashing embedder (a bit-equal copy in both packages) the
  prototypes, every score and every decision are EQUAL: the classifier
  scores in host numpy f32 in both.
- With the E5 ``small_test`` encoder (the JAX package's numpy tree
  carried to the port with ``params_from_numpy``), scores agree within
  1e-5 and decisions are compared only where the margin lies more than
  1e-4 from the threshold it is held to (a margin inside that band may
  decide either way on float noise). The test counts those and requires
  most of the grid to be outside the band.
- The registry's fallback and raise, and the sticky loader: one sequence
  of routes through both packages' loaders, with the extractive backend
  and with route files on the decoder backend, keeping or rebuilding the
  same runner at each step.
"""

import gc
import weakref

import numpy as np
import pytest

from classmate_rag_tpu.embeddings.hashing import HashingEmbedder as JHash
from classmate_rag_tpu.routing import classifier as jcls
from classmate_rag_tpu.routing import prototypes as jproto
from classmate_rag_tpu.routing import router as jrouter
from classmate_rag_tpu_torch.embeddings.hashing import HashingEmbedder as THash
from classmate_rag_tpu_torch.routing import classifier as tcls
from classmate_rag_tpu_torch.routing import prototypes as tproto
from classmate_rag_tpu_torch.routing import router as trouter

SCORE_TOL = 1e-5
BAND = 1e-4

QUESTIONS = [
    "solve the differential equation for x",
    "prove the theorem by induction on n",
    "write a python function to sort a list",
    "explain this stack trace in my C++ code",
    "translate this sentence into italian please",
    "traduci questo testo in inglese",
    "frase in lingua straniera qualsiasi",
    "what does this Italian phrase mean in English",
    "come si dice derivata in inglese",
    "zqx wvut completely unrelated nonsense",
    "calculus derivative integral limit",
    "regex parse string javascript typescript",
    "",
    "   ",
]
METAS = [
    [],
    [{}],
    [{"subject": "math"}] * 5,
    [{"subject": "code"}] * 2 + [{"subject": "math"}],
    [{"subject": "translation"}] * 3 + [{}],
    [{"subject": "code"}] * 8,
    [{"subject": "bogus"}, "not a dict", {"subject": "default"}],
]
PASSAGES = [
    "The derivative of a function measures its rate of change.",
    "def sort(xs): return sorted(xs)  # python helper",
    "La traduzione del testo in italiano e in inglese.",
    "",
    "Boil salted water and cook the pasta nine minutes.",
]
CHUNK_SETS = [
    [],
    ["", "  "],
    ["calculus derivative integral limit equation"] * 30,
    [f"chunk {i} about linked list binary tree code" for i in range(20)],
    PASSAGES,
    [f"passage {i}: " + PASSAGES[i % len(PASSAGES)] for i in range(17)],
]
ROUTER_KNOBS = [
    {},
    dict(query_margin=1e-3),
    dict(query_margin=0.99, metadata_threshold=0.5),
    dict(query_margin=1e-3, translation_requires_intent=False),
]


def test_prototypes_are_byte_equal():
    assert tproto.SUBJECT_PROTOTYPES == jproto.SUBJECT_PROTOTYPES
    assert (tproto.TRANSLATION_INTENT_KEYWORDS
            == jproto.TRANSLATION_INTENT_KEYWORDS)
    for route, seeds in jproto.SUBJECT_PROTOTYPES.items():
        assert [s.encode() for s in tproto.SUBJECT_PROTOTYPES[route]] == [
            s.encode() for s in seeds]


@pytest.fixture(scope="module")
def hashing_pair():
    return (jcls.SubjectClassifier(JHash(dim=512)),
            tcls.SubjectClassifier(THash(dim=512)))


def test_hashing_prototypes_equal(hashing_pair):
    j, t = hashing_pair
    assert set(t._protos) == set(j._protos) == {"math", "code",
                                                "translation"}
    for r in j._protos:
        assert t._protos[r].dtype == np.float32
        assert np.array_equal(t._protos[r], j._protos[r]), r


def test_hashing_scores_and_classes_equal(hashing_pair):
    j, t = hashing_pair
    for q in QUESTIONS:
        assert t.score_query(q) == j.score_query(q), q
    assert t.score_queries(QUESTIONS) == j.score_queries(QUESTIONS)
    assert t.score_queries([]) == j.score_queries([]) == []
    for text in PASSAGES + QUESTIONS:
        assert t.score_passage(text) == j.score_passage(text), text
        for margin in (0.05, 0.0):
            a = t.classify_text(text, min_margin=margin)
            b = j.classify_text(text, min_margin=margin)
            assert (a.subject, a.scores, a.margin) == (
                b.subject, b.scores, b.margin), text
    for chunks in CHUNK_SETS:
        for kw in ({}, dict(sample_size=3, min_margin=0.0)):
            a = t.classify_chunks(chunks, **kw)
            b = j.classify_chunks(chunks, **kw)
            assert (a.subject, a.scores, a.margin) == (
                b.subject, b.scores, b.margin), (chunks[:1], kw)
    # The even sampling takes every (n // sample_size)-th chunk.
    seen = []

    class Spy:
        def encode_passages(self, texts):
            seen.append(list(texts))
            return t.embedder.encode_passages(texts)

    spy = tcls.SubjectClassifier.__new__(tcls.SubjectClassifier)
    spy.embedder, spy._protos = Spy(), t._protos
    spy.classify_chunks([f"c{i}" for i in range(20)], sample_size=8)
    assert seen == [[f"c{i}" for i in range(0, 20, 2)][:8]]


def _decision(d):
    return (d.route, d.reason, d.query_scores, d.meta_scores, d.margin)


@pytest.mark.parametrize("knobs", ROUTER_KNOBS,
                         ids=[str(k) or "defaults" for k in ROUTER_KNOBS])
def test_hashing_decisions_equal(hashing_pair, knobs):
    j, t = hashing_pair
    jr = jrouter.HybridRouter(classifier=j, **knobs)
    tr = trouter.HybridRouter(classifier=t, **knobs)
    reasons = set()
    for forced in (None, "math", "translation", "bogus"):
        for q in QUESTIONS:
            for metas in METAS:
                a = tr.decide(q, metas, forced_subject=forced)
                b = jr.decide(q, metas, forced_subject=forced)
                assert _decision(a) == _decision(b), (q, metas, forced)
                reasons.add(a.reason)
        metas_list = [METAS[i % len(METAS)] for i in range(len(QUESTIONS))]
        got = tr.decide_batch(QUESTIONS, metas_list, forced_subject=forced)
        want = jr.decide_batch(QUESTIONS, metas_list, forced_subject=forced)
        assert [_decision(d) for d in got] == [_decision(d) for d in want]
        # One classifier encode for the batch: the same decisions as
        # one decide() a question.
        assert [_decision(d) for d in got] == [
            _decision(tr.decide(q, m, forced_subject=forced))
            for q, m in zip(QUESTIONS, metas_list)]
    assert "forced" in reasons and len(reasons) >= 3, reasons
    for q in QUESTIONS:
        assert (trouter.has_translation_intent(q)
                == jrouter.has_translation_intent(q))
    for metas in METAS:
        assert (trouter._meta_fractions(metas)
                == jrouter._meta_fractions(metas))


@pytest.fixture(scope="module")
def e5_pair():
    """Both packages' classifiers over the E5 small_test encoder, the
    port's built from the JAX package's numpy tree."""
    from classmate_rag_tpu.embeddings.encoder import E5Encoder as JE5
    from classmate_rag_tpu.embeddings.model import EncoderConfig as JCfg
    from classmate_rag_tpu.embeddings.model import init_params
    from classmate_rag_tpu_torch.embeddings.encoder import E5Encoder as TE5
    from classmate_rag_tpu_torch.embeddings.model import EncoderConfig as TCfg

    tree = init_params(JCfg.small_test(), "routing-e5")
    j = JE5(model_name="routing-e5", config=JCfg.small_test(), params=tree)
    t = TE5(model_name="routing-e5", config=TCfg.small_test(), params=tree,
            device="cpu")
    return jcls.SubjectClassifier(j), tcls.SubjectClassifier(t)


def _close(a, b):
    assert a.keys() == b.keys()
    for r in a:
        assert abs(a[r] - b[r]) <= SCORE_TOL, (r, a[r], b[r])


def test_e5_scores_within_tolerance(e5_pair):
    j, t = e5_pair
    for r in j._protos:
        np.testing.assert_allclose(t._protos[r], j._protos[r],
                                   atol=SCORE_TOL)
    for a, b in zip(t.score_queries(QUESTIONS), j.score_queries(QUESTIONS)):
        _close(a, b)
    for text in PASSAGES:
        _close(t.score_passage(text), j.score_passage(text))
    outside = inside = 0
    for chunks in CHUNK_SETS + [[p] for p in PASSAGES]:
        for margin in (0.05, 1e-3):
            a = t.classify_chunks(chunks, min_margin=margin)
            b = j.classify_chunks(chunks, min_margin=margin)
            _close(a.scores, b.scores)
            assert abs(a.margin - b.margin) <= 2 * SCORE_TOL
            if abs(b.margin - margin) <= BAND:
                inside += 1
                continue
            outside += 1
            assert a.subject == b.subject, (chunks[:1], margin)
    assert outside > 3 * inside, (outside, inside)


@pytest.mark.parametrize("knobs", ROUTER_KNOBS[:2],
                         ids=["defaults", "query_margin=1e-3"])
def test_e5_decisions_outside_band(e5_pair, knobs):
    j, t = e5_pair
    jr = jrouter.HybridRouter(classifier=j, **knobs)
    tr = trouter.HybridRouter(classifier=t, **knobs)
    threshold = knobs.get("query_margin", 0.10)
    metas_list = [METAS[i % len(METAS)] for i in range(len(QUESTIONS))]
    got = tr.decide_batch(QUESTIONS, metas_list)
    want = jr.decide_batch(QUESTIONS, metas_list)
    inside = 0
    for q, a, b in zip(QUESTIONS, got, want):
        _close(a.query_scores, b.query_scores)
        assert a.meta_scores == b.meta_scores
        if abs(b.margin - threshold) <= BAND:
            inside += 1
            continue
        assert (a.route, a.reason) == (b.route, b.reason), q
    assert inside <= len(QUESTIONS) // 4, inside


# ---------------------------------------------------------------------------
# Registry and sticky loader
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def _fresh_configs():
    yield
    from classmate_rag_tpu.config import load_config as jload
    from classmate_rag_tpu_torch.config import load_config as tload

    jload(reload=True)
    tload(reload=True)


def _configs():
    from classmate_rag_tpu.config import load_config as jload
    from classmate_rag_tpu_torch.config import load_config as tload

    return jload(reload=True), tload(reload=True)


def test_registry_falls_back_and_raises(tmp_path, monkeypatch):
    from classmate_rag_tpu.routing import get_model_spec as jspec
    from classmate_rag_tpu_torch.routing import ModelSpec, get_model_spec

    default = tmp_path / "default.gguf"
    default.write_bytes(b"gguf")
    monkeypatch.setenv("ROUTE_DEFAULT_MODEL_PATH", str(default))
    monkeypatch.setenv("ROUTE_MATH_MODEL_PATH", str(tmp_path / "missing.gguf"))
    monkeypatch.setenv("ROUTE_CODE_MODEL_PATH", str(tmp_path / "code.gguf"))
    (tmp_path / "code.gguf").write_bytes(b"gguf")
    monkeypatch.setenv("ROUTE_N_CTX", "2048")
    jcfg, tcfg = _configs()
    for route in ("math", "code", "translation", "default"):
        got, want = get_model_spec(route, tcfg), jspec(route, jcfg)
        assert isinstance(got, ModelSpec)
        assert (got.route, got.model_path, got.n_ctx, got.seed) == (
            want.route, want.model_path, want.n_ctx, want.seed), route
    spec = get_model_spec("math", tcfg)
    assert spec.route == "default" and spec.model_path == default
    assert spec.n_ctx == 2048
    unchecked = get_model_spec("math", tcfg, require_exists=False)
    assert unchecked.route == "math"

    monkeypatch.setenv("ROUTE_DEFAULT_MODEL_PATH", str(tmp_path / "no.gguf"))
    jcfg, tcfg = _configs()
    with pytest.raises(FileNotFoundError):
        get_model_spec("math", tcfg)
    with pytest.raises(FileNotFoundError):
        jspec("math", jcfg)


ROUTE_SEQUENCE = ["math", "math", "translation", "default", "code"]
BOUNDED = dict(TPU_DECODE_MAX_SEQ="96", LLM_MAX_TOKENS="4",
               LLM_TEMPERATURE="0")


@pytest.mark.parametrize("backend", ["extractive", "tpu"])
def test_sticky_loader_matches_jax(tmp_path, monkeypatch, backend):
    """The same route sequence through both loaders: the same resident
    route and path after each step, and the runner kept (``is``) or
    rebuilt (``is not``) at the same steps."""
    from classmate_rag_tpu.routing import StickyModelLoader as JLoader
    from classmate_rag_tpu_torch.generation.runner import (
        DecodeRunner,
        ExtractiveRunner,
    )
    from classmate_rag_tpu_torch.routing import StickyModelLoader

    monkeypatch.setenv("LLM_BACKEND", backend)
    for k, v in BOUNDED.items():
        monkeypatch.setenv(k, v)
    for route in ("math", "code", "translation", "default"):
        path = tmp_path / f"{route}.gguf"
        if route != "translation":      # translation falls back
            path.write_bytes(b"not read on the decoder backend")
        monkeypatch.setenv(f"ROUTE_{route.upper()}_MODEL_PATH", str(path))
    jcfg, tcfg = _configs()
    jl = JLoader(jcfg)
    tl = StickyModelLoader(tcfg, device="cpu")
    want_type = DecodeRunner if backend == "tpu" else ExtractiveRunner
    prev_j = prev_t = None
    kept = []
    for route in ROUTE_SEQUENCE:
        rj, rt = jl.ensure_loaded(route), tl.ensure_loaded(route)
        assert type(rt) is want_type
        assert (tl.resident_route, tl._resident_path) == (
            jl.resident_route, jl._resident_path), route
        assert (rt is prev_t) == (rj is prev_j), route
        kept.append(rt is prev_t)
        if backend == "tpu":
            assert rt.device.type == "cpu"
        prev_j, prev_t = rj, rt
    # Kept for a repeat and for translation's fallback to default;
    # rebuilt for every other change of the resolved route (the decoder
    # backend reads no route file, so it rebuilds the same decoder).
    assert kept == [False, True, False, True, False]
    # Eviction drops the last reference: the runner is collected.
    gone = weakref.ref(prev_t)
    del prev_j, rj, prev_t, rt
    tl._evict()
    gc.collect()
    assert gone() is None and tl.resident_route is None


def test_loader_without_any_route_file(tmp_path, monkeypatch):
    """No model file for any route: one shared extractive residency."""
    from classmate_rag_tpu.routing import StickyModelLoader as JLoader
    from classmate_rag_tpu_torch.generation.runner import ExtractiveRunner
    from classmate_rag_tpu_torch.routing import StickyModelLoader

    monkeypatch.setenv("LLM_BACKEND", "tpu")
    for route in ("math", "code", "translation", "default"):
        monkeypatch.setenv(f"ROUTE_{route.upper()}_MODEL_PATH",
                           str(tmp_path / f"{route}.gguf"))
    jcfg, tcfg = _configs()
    jl, tl = JLoader(jcfg), StickyModelLoader(tcfg, device="cpu")
    first = tl.ensure_loaded("math")
    assert isinstance(first, ExtractiveRunner)
    for route in ROUTE_SEQUENCE:
        assert tl.ensure_loaded(route) is first
        jl.ensure_loaded(route)
        assert tl.resident_route == jl.resident_route == "__unresolved__"
    msgs = [[{"role": "user", "content": "Context:\n[1] x\n\nQuestion:\ny"}]]
    assert tl.chat_batch(route="code", messages_list=msgs) == (
        jl.chat_batch(route="code", messages_list=msgs))
    assert tl.chat(route="code", messages=msgs[0]) == jl.chat(
        route="code", messages=msgs[0])
