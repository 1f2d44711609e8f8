"""The port's HTTP server (classmate_rag_tpu_torch/serve.py) against the
JAX package's: both servers run on port 0 over runtimes that ingested
the same documents (see test_torch_pipeline.make_runtimes), and every
endpoint must answer with the same status and the same JSON — strings,
ids and integers equal, floats (scores) within atol/rtol 1e-5. /stats is
compared without its process metrics (latency timers).
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_pipeline import _ingest_all, make_runtimes


@pytest.fixture(autouse=True)
def _fresh_configs():
    yield
    from classmate_rag_tpu.config import load_config as jload
    from classmate_rag_tpu_torch.config import load_config as tload

    jload(reload=True)
    tload(reload=True)


def _start(make_server, rt, **kw):
    srv = make_server("127.0.0.1", 0, runtime=rt, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _server_pair(monkeypatch, tmp_path, **kw):
    """The JAX server and the port's on one ingested corpus, both built
    with ``make_server(**kw)``; yields their URLs and the documents."""
    from classmate_rag_tpu.pipeline.runtime import reset_runtime as jr
    from classmate_rag_tpu.serve import make_server as jmake
    from classmate_rag_tpu_torch.pipeline.runtime import reset_runtime as tr
    from classmate_rag_tpu_torch.serve import make_server as tmake

    jrt, trt, docs = make_runtimes(monkeypatch, tmp_path)
    _ingest_all(jrt, trt, docs)
    js, jurl = _start(jmake, jrt, **kw)
    ts, turl = _start(tmake, trt, **kw)
    yield jurl, turl, docs
    for srv in (js, ts):
        srv.shutdown()
        srv.server_close()
    jr()
    tr()


@pytest.fixture()
def servers(monkeypatch, tmp_path):
    yield from _server_pair(monkeypatch, tmp_path)


@pytest.fixture()
def patient_servers(monkeypatch, tmp_path):
    """The pair with a follower deadline of 60 s instead of the
    extractive default of 8 s: on a loaded machine the first concurrent
    batch (the JAX server compiling for that batch) can outlast 8 s, and
    the server then answers 503 by design."""
    yield from _server_pair(monkeypatch, tmp_path, follower_timeout_s=60.0)


def _call(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"},
        method="GET" if payload is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _same_json(a, b, path="$"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _same_json(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_json(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=path)
    else:
        assert a == b, path


# Maintenance counters only the port's stats carry: the filtered-df
# cache's hits and misses.
PORT_ONLY_MAINTENANCE = ("df_filter_cache_hits", "df_filter_cache_misses")


def both(servers, route, payload=None, drop=()):
    jurl, turl, _ = servers
    (jc, jb), (tc, tb) = _call(jurl + route, payload), _call(
        turl + route, payload)
    assert jc == tc, (route, jb, tb)
    for key in drop:
        jb.pop(key, None)
        tb.pop(key, None)
    if "maintenance" in tb:
        for key in PORT_ONLY_MAINTENANCE:
            assert tb["maintenance"].pop(key) >= 0
    _same_json(jb, tb)
    return tc, tb


REQUESTS = [
    ("/healthz", None),
    ("/ask", {"question": "what is the derivative", "k": 3}),
    ("/ask", {"question": "cook the pasta", "filters": {"course": "cooking"}}),
    ("/ask", {"question": "eigenvalues topic2", "hybrid": False, "k": 4}),
    ("/ask", {"question": "tensor relativity", "tags": "week1"}),
    ("/ask", {}),                                   # 400: no question
    ("/preview", {"question": "chain rule", "filters": {"course": "calc101"}}),
    ("/preview", {"question": "pasta", "filters": {"course": "nope"}}),
    ("/nope", {"x": 1}),                             # 404
]


@pytest.mark.parametrize("route,payload", REQUESTS,
                         ids=[f"{r}-{i}" for i, (r, _p) in
                              enumerate(REQUESTS)])
def test_endpoint_json_matches(servers, route, payload):
    both(servers, route, payload)


def test_mutations_and_stats_match(servers):
    _jurl, _turl, docs = servers
    code, _ = both(servers, "/stats", drop=("metrics",))
    assert code == 200
    new = docs / "new.txt"
    new.write_text("Convolutional networks share weights across positions.")
    code, body = both(servers, "/add", {"path": str(new), "course": "ml"})
    assert code == 200 and body["upserted"] == 1
    code, body = both(servers, "/delete", {"path": str(docs / "pasta.txt")})
    assert code == 200 and body["ids_resolved"] > 0
    both(servers, "/delete", {})                     # 400: no selector
    code, body = both(servers, "/ask", {"question": "boil salted water"})
    assert all("pasta" not in str(r["metadata"].get("source_path"))
               for r in body["retrieved"])
    code, body = both(servers, "/stats", drop=("metrics",))
    assert body["maintenance"]["device_full_uploads"] >= 1


def test_concurrent_asks_batch_like_single_asks(patient_servers):
    """Concurrent /asks go through the micro-batcher; each answer equals
    the JAX server's answer to the same question. One /ask to each
    server first, so that the concurrent batch does not also carry the
    first request's set-up."""
    jurl, turl, _ = patient_servers
    for url in (jurl, turl):
        assert _call(url + "/ask", {"question": "warm up"})[0] == 200
    questions = [f"derivative rate of change {i}" for i in range(8)]
    out = {}

    def worker(i, url, tag):
        out[(tag, i)] = _call(url + "/ask", {"question": questions[i]})

    threads = [threading.Thread(target=worker, args=(i, u, t))
               for i in range(8) for u, t in ((jurl, "j"), (turl, "t"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for i in range(8):
        (jc, jb), (tc, tb) = out[("j", i)], out[("t", i)]
        assert jc == tc == 200
        _same_json(jb, tb)
