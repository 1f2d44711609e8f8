"""The port's command line (classmate_rag_tpu_torch/cli/) against the JAX
package's ``cli/main.py``, on the CPU.

- The parsers are compared programmatically: every subcommand, every
  option string, default, choice, ``nargs`` and ``required`` flag.
- The 14 verbs run end to end through ``main(argv, device="cpu")`` and
  the JAX CLI's ``main(argv)``, each package in its own temporary index
  over the same files, with routing on (no route model: extractive).
  Exit codes are equal, and so is the JSON each prints (on stdout, or
  the error object on stderr), after replacing each index's root with
  one placeholder and dropping the timings (the process metrics of
  ``stats``, the seconds of ``warmup``); floats, the retrieval scores,
  agree within 1e-5 (f32 sums in other orders, as in
  test_torch_pipeline), everything else exactly.
"""

import argparse
import datetime as _dt
import json
import socketserver

import pytest

from cli import main as jcli
from classmate_rag_tpu_torch.cli import main as tcli


class _FixedNow(_dt.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5, tzinfo=tz)


def _subparsers(parser):
    action = next(a for a in parser._actions
                  if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _options(parser):
    return sorted(
        (tuple(a.option_strings), a.dest, repr(a.default),
         tuple(a.choices) if a.choices else None, a.nargs, a.required,
         type(a).__name__, getattr(a.type, "__name__", None))
        for a in parser._actions
        if not isinstance(a, (argparse._SubParsersAction,
                              argparse._HelpAction))
    )


def test_parser_equals_the_jax_cli():
    j, t = jcli.build_parser(), tcli.build_parser()
    jsub, tsub = _subparsers(j), _subparsers(t)
    assert list(tsub) == list(jsub)
    assert len(tsub) == 14
    assert _options(t) == _options(j)
    for name in jsub:
        assert _options(tsub[name]) == _options(jsub[name]), name
        assert (tsub[name]._defaults["func"].__name__
                == jsub[name]._defaults["func"].__name__)
    with pytest.raises(SystemExit):
        t.parse_args(["ask", "q", "--hybrid", "maybe"])


@pytest.fixture(autouse=True)
def _fresh_state():
    from classmate_rag_tpu.pipeline.runtime import reset_runtime as jr
    from classmate_rag_tpu_torch.pipeline.runtime import reset_runtime as tr

    jr()
    tr()
    yield
    from classmate_rag_tpu.config import load_config as jload
    from classmate_rag_tpu_torch.config import load_config as tload

    jr()
    tr()
    jload(reload=True)
    tload(reload=True)


def _docs(tmp_path):
    docs = tmp_path / "docs"
    (docs / "code").mkdir(parents=True)
    (docs / "calc.md").write_text(
        "The derivative of a function measures its rate of change. "
        "It is the limit of the difference quotient.\n\n"
        "Integrals accumulate the area under a curve.")
    (docs / "code" / "sort.md").write_text(
        "Quicksort partitions the list around a pivot and sorts each "
        "side recursively. Its average time complexity is O(n log n).")
    (docs / "pasta.txt").write_text(
        "Boil salted water in a large pot. Cook the pasta nine minutes.")
    (docs / "lezione.md").write_text(
        "La derivata misura la velocità di variazione di una funzione.")
    return docs


def _verbs(docs, root):
    calc, sort = str(docs / "calc.md"), str(docs / "code" / "sort.md")
    pasta, dump = str(docs / "pasta.txt"), str(root / "dump.jsonl")
    return [
        ["add", calc, "--course", "calc101", "--tags", "week1"],
        ["add", sort, "--course", "cs101"],
        ["add", pasta, "--subject", "default", "--doc-type", "txt"],
        ["add", str(docs / "lezione.md"), "--language", "it",
         "--subject", "matematica"],
        ["add", str(docs / "missing.md")],
        ["add", calc, "--tags", "bad tag!!"],
        ["ask", "what does the derivative measure"],
        ["ask", "how do I sort a list", "--subject", "code", "--k", "2"],
        ["ask", "cosa misura la derivata", "--course", "calc101",
         "--hybrid", "off"],
        ["preview", "pivot partitions", "--k", "2"],
        ["stats"],
        ["list", "--course", "calc101"],
        ["list", "--limit", "2", "--offset", "1"],
        ["list", "--tags", "bad tag!!"],
        ["show", "--path", calc],
        ["show"],
        ["dump", "--path", dump],
        ["dump", "--path", str(root / "plain.jsonl"), "--no-emb",
         "--batch-size", "2"],
        ["delete"],
        ["delete", "--path", pasta, "--dry-run"],
        ["delete", "--path", pasta],
        ["vacuum"],
        ["reingest", "--path", calc, "--dry-run"],
        ["reingest", "--course", "cs101"],
        ["reingest", "--course", "nothing-here"],
        ["rebuild", "--model", "other-model", "--batch-size", "3"],
        ["restore", "--path", dump, "--batch-size", "2"],
        ["restore", "--path", str(root / "missing.jsonl")],
        ["stats"],
        ["warmup", "--batch", "1", "2"],
        ["serve", "--port", "0"],
    ]


def _normal(obj, root):
    """The JSON with ``root`` replaced and the timings dropped."""
    if isinstance(obj, dict):
        return {k: _normal(v, root) for k, v in obj.items()
                if k not in ("metrics", "seconds_per_batch", "load_split_s")}
    if isinstance(obj, list):
        return [_normal(v, root) for v in obj]
    if isinstance(obj, str):
        return obj.replace(str(root), "<root>")
    return obj


def _same(a, b, where):
    """Equal JSON, floats (the retrieval scores) within 1e-5."""
    if isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-5, abs=1e-5), where
    elif isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), where
        for k in b:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _run_all(main, load_config, docs, root, capsys, monkeypatch, **kw):
    for var, rel in (("INDEX_DIR", ""), ("DENSE_DIR", "/dense"),
                     ("BM25_DIR", "/bm25"), ("EMB_CACHE_DIR", "/emb")):
        monkeypatch.setenv(var, str(root) + rel)
    load_config(reload=True)
    out = []
    for argv in _verbs(docs, root):
        rc = main(argv, **kw)
        cap = capsys.readouterr()
        stdout = json.loads(cap.out) if cap.out.strip() else None
        errs = [json.loads(x) for x in cap.err.splitlines()
                if x.startswith("{")]
        out.append((argv[0], rc, _normal(stdout, root), _normal(errs, root)))
    return out


def test_fourteen_verbs_match_the_jax_cli(tmp_path, monkeypatch, capsys):
    import classmate_rag_tpu.pipeline.ingest as j_ingest
    import classmate_rag_tpu_torch.pipeline.ingest as t_ingest
    from classmate_rag_tpu.config import load_config as jload
    from classmate_rag_tpu_torch.config import load_config as tload

    for var, value in (("EMBEDDING_BACKEND", "hash"),
                       ("LLM_BACKEND", "extractive"), ("N_SHARDS", "1"),
                       ("ENABLE_ROUTING", "1"), ("RUNTIME_PRECOMPILE", "off"),
                       ("LOG_LEVEL", "WARNING")):
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(j_ingest, "datetime", _FixedNow)
    monkeypatch.setattr(t_ingest, "datetime", _FixedNow)

    def interrupted(self, *a, **kw):
        raise KeyboardInterrupt    # the operator's Ctrl-C, at once

    monkeypatch.setattr(socketserver.BaseServer, "serve_forever",
                        interrupted)
    docs = _docs(tmp_path)
    want = _run_all(jcli.main, jload, docs, tmp_path / "j", capsys,
                    monkeypatch)
    got = _run_all(tcli.main, tload, docs, tmp_path / "t", capsys,
                   monkeypatch, device="cpu")
    for verb, _rc, stdout, _errs in got:
        if verb == "stats":       # counters only the port's stats carry
            m = stdout["maintenance"]
            assert m.pop("df_filter_cache_hits") >= 0
            assert m.pop("df_filter_cache_misses") >= 0
    assert {v for v, *_ in got} == set(_subparsers(tcli.build_parser()))
    for g, w in zip(got, want):
        _same(g, w, g[0])
    by_verb = {}
    for verb, rc, stdout, errs in got:
        by_verb.setdefault(verb, []).append((rc, stdout, errs))
    # The run did real work: routed answers, a delete, a restore.
    assert by_verb["ask"][1][1]["route"] == "code"
    assert by_verb["add"][1][1]["upserted"] > 0
    assert by_verb["delete"][0][0] == 1 and by_verb["delete"][2][1][
        "vector_deleted"] > 0
    assert by_verb["restore"][0][1]["restored"] > 0
    assert by_verb["restore"][1][0] == 1
    assert by_verb["serve"][0][1] == {"serving": "http://127.0.0.1:0"}


def test_default_device_is_cuda(tmp_path, monkeypatch, capsys):
    """Without a card the CLI raises; it never runs on the CPU instead."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("INDEX_DIR", str(tmp_path))
    monkeypatch.setenv("EMBEDDING_BACKEND", "hash")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["stats"])
    assert capsys.readouterr().out == ""
