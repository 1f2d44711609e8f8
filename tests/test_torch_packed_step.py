"""The port's packed single-transfer step
(classmate_rag_tpu_torch/ops/hybrid_step.py ``pack_query_arrays``,
``unpack_query_arrays``, ``hybrid_query_step_split_packed``) and the
store's packed inputs, against the JAX package's packed step on the same
numpy-seeded arrays.

Batches: head terms only; tail terms only; a tail term with overlay
postings (``ov_offsets``, the O(delta) region after the base postings);
tail terms longer than ``r_cap`` (several segments each); and queries
with no known term or none at all (``has_terms`` False).

Tolerances:
- the packed i32 buffer and its statics: EQUAL to the JAX package's,
  element for element;
- the port's packed step vs the JAX package's: rows EQUAL (ties resolve
  to the lowest row on both sides); vector distances and BM25 scores
  within atol/rtol 1e-5 (f32, sums in another order); RRF fused scores
  within 1e-6; NaN where a branch did not return the row on both sides;
- the port's packed step vs its unpacked step: EQUAL, NaN pattern too
  (the same ops on the same values).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from classmate_rag_tpu.index import lexical as jlex
from classmate_rag_tpu.ops import hybrid_step as jstep
from classmate_rag_tpu_torch.index import lexical as tlex
from classmate_rag_tpu_torch.index.store import IndexStore
from classmate_rag_tpu_torch.ops import hybrid_step as tstep
from classmate_rag_tpu_torch.utils.numerics import NEG_INF

CAP, WIDTH, D, VPAD = 1024, 16, 64, 4096
SEG_CAP = 16          # tail terms above 16 postings take several segments
RESERVE = 64          # the overlay region after the base postings
BATCHES = ("head", "tail", "overlay", "long_tail", "no_terms")
ROUTES = [  # select, emb16, filtered
    ("exact", True, False), ("exact", False, False), ("exact", True, True),
    ("approx", True, False), ("approx", True, True), ("exact", False, True),
]


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol, equal_nan=True)


def _corpus(seed=3, n=900):
    """Zipf docs over 300 words packed into [CAP, WIDTH]; the split layout
    of that base (head df > 20, segments of SEG_CAP, RESERVE overlay
    slots); then one tail term added to 6 rows through the overlay, as
    the O(delta) sync adds a term to changed rows."""
    rng = np.random.default_rng(seed)
    words = [f"t{i}" for i in range(300)]
    w = 1.0 / np.arange(1, 301)
    w /= w.sum()
    docs = [list(rng.choice(words, size=int(rng.integers(5, 30)), p=w))
            for _ in range(n)]
    vocab = {}
    ids = np.full((CAP, WIDTH), -1, np.int32)
    tfs = np.zeros((CAP, WIDTH), np.uint8)
    dl = np.zeros(CAP, np.float32)
    for i, doc in enumerate(docs):
        ids[i], tfs[i], dl[i] = tlex.pack_tokens(doc, vocab, WIDTH)
    lay = tlex.build_split_layout(ids, tfs, len(vocab),
                                  head_bytes_budget=40 * CAP,
                                  head_df_threshold=20, seg_cap=SEG_CAP,
                                  reserve=RESERVE)
    assert lay["r_cap"] == SEG_CAP
    lens = np.diff(lay["offsets"])
    tail = np.flatnonzero((lay["lut"] < 0) & (lens > 0))
    long_tail = tail[lens[tail] > SEG_CAP]
    short_tail = tail[(lens[tail] <= SEG_CAP) & (lens[tail] >= 2)]
    assert len(long_tail) >= 2 and len(short_tail) >= 8
    # The overlay: a short tail term joins 6 rows that lack it and have a
    # free slot; the row-major matrix and doc lengths take it too.
    t_ov = int(short_tail[0])
    rows = [r for r in range(n)
            if t_ov not in ids[r] and (ids[r] < 0).any()][:6]
    post_rows, post_tfs = lay["post_rows"].copy(), lay["post_tfs"].copy()
    for j, r in enumerate(rows):
        slot = int(np.flatnonzero(ids[r] < 0)[0])
        ids[r, slot], tfs[r, slot] = t_ov, 2
        dl[r] += 2
        post_rows[lay["p_base"] + j], post_tfs[lay["p_base"] + j] = r, 2
    ov_offsets = np.zeros(len(lay["offsets"]), np.int64)
    ov_offsets[t_ov + 1:] = len(rows)
    emb16 = np.zeros((CAP, D), np.float16)
    emb16[:n] = _unit(rng, n, D)
    inv = {v: k for k, v in vocab.items()}
    head = np.flatnonzero(lay["lut"] >= 0)
    return dict(n=n, rng=rng, ids=ids, tfs=tfs, dl=dl, emb16=emb16, lay=lay,
                post_rows=post_rows, post_tfs=post_tfs, ov_offsets=ov_offsets,
                vocab=vocab, t_ov=t_ov,
                words={"head": [inv[t] for t in head],
                       "tail": [inv[t] for t in short_tail[1:]],
                       "long_tail": [inv[t] for t in long_tail]})


@pytest.fixture(scope="module")
def corpus():
    return _corpus()


def _batch(cx, kind, b=8):
    """(q [b, D] f32, terms) of one batch kind, seeded by the kind."""
    rng = np.random.default_rng(BATCHES.index(kind) + 11)
    inv = {v: k for k, v in cx["vocab"].items()}
    pick = {"head": ["head"], "tail": ["tail"],
            "overlay": ["tail", "head"], "long_tail": ["long_tail", "tail"],
            "no_terms": ["head", "tail"]}[kind]
    terms = []
    for i in range(b):
        pool = cx["words"][pick[i % len(pick)]]
        terms.append(list(rng.choice(pool, size=min(3, len(pool)),
                                     replace=False)))
    if kind == "overlay":
        for i in range(0, b, 2):
            terms[i].append(inv[cx["t_ov"]])
    if kind == "no_terms":
        terms[1] = ["nowhere"]
        terms[4] = []
    which = rng.integers(0, cx["n"], size=b)
    q = cx["emb16"][which].astype(np.float32) + 0.3 * rng.standard_normal(
        (b, D)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True), terms


def _query_arrays(cx, kind, split_query_arrays=tlex.split_query_arrays):
    q, terms = _batch(cx, kind)
    q_terms, q_counts = tlex.pack_query_terms(cx["vocab"], terms, 8)
    lay = cx["lay"]
    qa = split_query_arrays(
        lay["lut"], lay["offsets"], q_terms, q_counts, r_cap=lay["r_cap"],
        ov_offsets=cx["ov_offsets"] if kind == "overlay" else None,
        ov_start=lay["p_base"])
    has_terms = np.any(q_terms >= 0, axis=1, keepdims=True)
    return q, q_terms, q_counts, qa, has_terms


def _bias_df(cx, filtered):
    bias = np.full(CAP, NEG_INF, np.float32)
    bias[: cx["n"]] = 0.0
    if filtered:
        bias[: cx["n"]: 3] = NEG_INF
    df = tlex.subset_df(torch.from_numpy(cx["ids"]),
                        torch.from_numpy(cx["tfs"]),
                        torch.from_numpy(bias == 0.0), VPAD).numpy()
    return bias, df


def _step_arrays(cx, kind, select, with16, filtered):
    """(base arrays, q, packed, tail arrays, statics, knobs) of the packed
    step for one batch on one route."""
    q, q_terms, q_counts, qa, has_terms = _query_arrays(cx, kind)
    packed, statics = tstep.pack_query_arrays(qa, q_terms, q_counts,
                                              has_terms)
    bias, df = _bias_df(cx, filtered)
    lay = cx["lay"]
    base = [lay["tf_head"], cx["post_rows"], cx["post_tfs"], cx["dl"], df,
            bias]
    tail = [cx["emb16"] if with16 else None, cx["ids"], cx["tfs"]]
    knobs = dict(k_vector=8, k_bm25=8, top_k=8, pool=24, vocab_pad=VPAD,
                 r_cap=lay["r_cap"], rescore_pool=32, select=select)
    return base, q, packed, tail, statics, knobs


def _torch_packed_step(cx, base, q, packed, tail, statics, knobs):
    return tstep.hybrid_query_step_split_packed(
        torch.from_numpy(cx["emb16"]).to(torch.bfloat16),
        *[torch.from_numpy(np.asarray(x)) for x in base],
        torch.from_numpy(q), torch.from_numpy(packed),
        *[None if x is None else torch.from_numpy(x) for x in tail],
        **statics, **knobs)


def test_corpus_has_every_batch_kind(corpus):
    """Each batch reaches the part of the step it is named for."""
    for kind in BATCHES:
        _q, q_terms, _c, qa, has_terms = _query_arrays(corpus, kind)
        n_head = int((qa["h_slots"] >= 0).sum())
        n_seg = int((qa["u_lens"] > 0).sum())
        n_tail = int((qa["t_tids"] >= 0).sum())
        if kind == "head":
            assert n_head > 0 and n_seg == 0
        elif kind == "tail":
            assert n_head == 0 and n_seg == n_tail > 0
        elif kind == "overlay":
            assert int(qa["u_ov"][: n_seg].sum()) == 1
        elif kind == "long_tail":
            assert n_seg > n_tail > 0
        else:
            assert not has_terms[1, 0] and not has_terms[4, 0]
            assert has_terms.sum() == len(has_terms) - 2


@pytest.mark.parametrize("kind", BATCHES)
def test_pack_equals_reference(corpus, kind):
    """(a) One i32 buffer element-equal to the JAX package's, from the
    same split arrays and from each package's own."""
    _q, q_terms, q_counts, qa, has_terms = _query_arrays(corpus, kind)
    got, statics = tstep.pack_query_arrays(qa, q_terms, q_counts, has_terms)
    want, want_statics = jstep.pack_query_arrays(qa, q_terms, q_counts,
                                                 has_terms)
    assert got.dtype == np.int32 and got.ndim == 1
    assert np.array_equal(got, want) and statics == want_statics
    h, u, t, b, m = (statics[k] for k in "hutbm")
    assert len(got) == 2 * h + 3 * u + t + 2 * b * m + b
    _q, jq_terms, jq_counts, jqa, jhas = _query_arrays(
        corpus, kind, jlex.split_query_arrays)
    own, own_statics = jstep.pack_query_arrays(jqa, jq_terms, jq_counts,
                                               jhas)
    assert np.array_equal(got, own) and statics == own_statics


@pytest.mark.parametrize("kind", BATCHES)
def test_unpack_gives_views_of_the_buffer(corpus, kind):
    """Every array comes back equal, as a view of the one tensor."""
    _q, q_terms, q_counts, qa, has_terms = _query_arrays(corpus, kind)
    packed, statics = tstep.pack_query_arrays(qa, q_terms, q_counts,
                                              has_terms)
    buf = torch.from_numpy(packed)
    got = tstep.unpack_query_arrays(buf, **statics)
    want = {**{k: qa[k] for k in tlex.STEP_COLUMNS}, "q_tids": q_terms,
            "q_counts": q_counts}
    for name, arr in want.items():
        assert got[name].dtype == torch.from_numpy(arr).dtype, name
        assert np.array_equal(got[name].numpy(), arr), name
        assert (got[name].untyped_storage().data_ptr()
                == buf.untyped_storage().data_ptr()), name
    assert got["has_terms"].dtype == torch.bool
    assert np.array_equal(got["has_terms"].numpy(), has_terms)


@pytest.mark.parametrize("select,with16,filtered", ROUTES)
@pytest.mark.parametrize("kind", BATCHES)
def test_packed_step_matches_reference(corpus, kind, select, with16,
                                       filtered):
    """(b) The port's packed step vs the JAX package's packed step."""
    base, q, packed, tail, statics, knobs = _step_arrays(
        corpus, kind, select, with16, filtered)
    want = jax.device_get(jstep.hybrid_query_step_split_packed(
        jnp.asarray(corpus["emb16"]).astype(jnp.bfloat16),
        *[jnp.asarray(x) for x in base], jnp.asarray(q), jnp.asarray(packed),
        *[None if x is None else jnp.asarray(x) for x in tail],
        **statics, **knobs))
    got = _torch_packed_step(corpus, base, q, packed, tail, statics, knobs)
    assert got.rows.numpy().tolist() == np.asarray(want.rows).tolist()
    _close(got.fused.numpy(), want.fused, 1e-6)
    _close(got.vec_dist.numpy(), want.vec_dist)
    _close(got.bm25_score.numpy(), want.bm25_score)
    live = got.rows.numpy()[got.rows.numpy() >= 0]
    assert len(live) > 8 * 4
    if filtered:
        assert np.all(live % 3 != 0)
    if kind == "no_terms":
        assert np.all(np.isnan(got.bm25_score.numpy()[[1, 4]]))
    else:
        assert np.isfinite(got.bm25_score.numpy()).any()


@pytest.mark.parametrize("select,with16,filtered", ROUTES)
@pytest.mark.parametrize("kind", BATCHES)
def test_packed_step_equals_unpacked(corpus, kind, select, with16,
                                     filtered):
    """(c) The packed step is the unpacked step on the same arrays."""
    base, q, packed, tail, statics, knobs = _step_arrays(
        corpus, kind, select, with16, filtered)
    got = _torch_packed_step(corpus, base, q, packed, tail, statics, knobs)
    _q, q_terms, q_counts, qa, has_terms = _query_arrays(corpus, kind)
    want = tstep.hybrid_query_step_split(
        torch.from_numpy(corpus["emb16"]).to(torch.bfloat16),
        *[torch.from_numpy(np.asarray(x)) for x in base],
        torch.from_numpy(q),
        *[torch.from_numpy(qa[k]) for k in tlex.STEP_COLUMNS],
        torch.from_numpy(q_terms), torch.from_numpy(q_counts),
        torch.from_numpy(has_terms),
        *[None if x is None else torch.from_numpy(x) for x in tail], **knobs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def _store(rng, n=400):
    words = [f"w{i}" for i in range(120)]
    p = 1.0 / np.arange(1, 121)
    p /= p.sum()
    docs = [list(rng.choice(words, size=int(rng.integers(4, 20)), p=p))
            for _ in range(n)]
    emb = _unit(rng, n, 32)
    store = IndexStore(32, slab_rows=128, terms_per_chunk=64, device="cpu")
    store.upsert([f"c{i}" for i in range(n)], emb, docs,
                 [{"course": f"c{i % 3}"} for i in range(n)])
    return store, docs, emb


@pytest.mark.parametrize("where", [None, {"course": "c1"}])
def test_store_hands_the_step_one_metadata_tensor(where):
    """(d) ``hybrid_step_inputs`` gives the packed step one 1-D int32
    tensor of 2H + 3U + T + 2BM + B metadata elements (the reference's
    packed buffer for the same batch), the query vectors as the only
    other batch tensor; ``hybrid_topk_batch`` runs that step."""
    rng = np.random.default_rng(5)
    store, docs, emb = _store(rng)
    which = rng.integers(0, len(docs), size=6)
    q = emb[which] + 0.2 * _unit(rng, 6, 32)
    terms = [list(docs[i][:3]) for i in which]
    terms[2] = ["unknown"]
    args, kwargs = store.hybrid_step_inputs(q, terms, where)
    assert len(args) == 12
    packed = args[8]
    h, u, t, b, m = (kwargs[k] for k in "hutbm")
    assert packed.dtype == torch.int32 and packed.ndim == 1
    assert packed.device == store.device
    assert packed.numel() == 2 * h + 3 * u + t + 2 * b * m + b
    assert (b, m) == (6, 32)
    assert args[7].shape == (6, 32) and args[7].dtype == torch.float32
    q_terms, q_counts = tlex.pack_query_terms(store.vocab, terms, 32)
    qa = store._split_query_arrays(q_terms, q_counts)
    want, statics = jstep.pack_query_arrays(
        qa, q_terms, q_counts, np.any(q_terms >= 0, axis=1, keepdims=True))
    assert np.array_equal(packed.numpy(), want)
    assert statics == {k: kwargs[k] for k in "hutbm"}
    got = store.hybrid_topk_batch(q, terms, where)
    step = tstep.hybrid_query_step_split_packed(*args, **kwargs)
    for g, w in zip(got, step):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert (got.rows[2] >= 0).any()   # the dense branch still answers
    assert torch.isnan(got.bm25_score[2]).all()
