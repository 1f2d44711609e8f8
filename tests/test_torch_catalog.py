"""The port's disk catalog (classmate_rag_tpu_torch/index/catalog.py)
against the JAX package's.

The same operations in two directories give the same base bytes, the
same journal bytes (up to the base marker's mtime, which each directory
has its own of), the same sidecar contents, the same fold alias and the
same fingerprint wherever it does not hash a marker; and in one shared
directory the two packages take turns — each reads what the other wrote
and both report the same ids, entries and fingerprint.
"""

import json

import numpy as np
import pytest

import classmate_rag_tpu.index.catalog as jcat
import classmate_rag_tpu_torch.index.catalog as tcat


def _entries(k0, n, word="alpha"):
    return [(f"id{i}", f"text {i} {word} ümlaut", [word, f"t{i}"],
             {"course": f"c{i % 2}", "source_path": f"/docs/d{i % 3}.txt",
              "page": 1, "chunk_id": i})
            for i in range(k0, k0 + n)]


OPS = [
    ("upsert", _entries(0, 5)),
    ("save", None),
    ("upsert", _entries(3, 4, "beta")),     # re-upserts + new ids
    ("delete", ["id1", "id9", "nope"]),
    ("save", None),
    ("compact", None),
    ("upsert", _entries(10, 2, "gamma")),
    ("delete", ["id0"]),
    ("save", None),
]


def _apply(mod, cat, op, arg):
    if op == "upsert":
        for cid, text, toks, meta in arg:
            cat.upsert(mod.CatalogEntry(cid, text, list(toks), dict(meta)))
    elif op == "delete":
        return cat.delete(arg)
    elif op == "save":
        cat.save()
    elif op == "compact":
        cat.compact()


def _journal_masked(path):
    if not path.exists():
        return None
    lines = path.read_bytes().splitlines(keepends=True)
    if lines and b'"op": "base"' in lines[0]:
        rec = json.loads(lines[0])
        rec["stat"] = [rec["stat"][0], 0]
        lines[0] = (json.dumps(rec) + "\n").encode()
    return b"".join(lines)


def _sidecar(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: str(z[k]) if z[k].dtype.kind == "U" else z[k].tolist()
                for k in ("ids", "srcs", "offs", "lens", "base_sha")}


def _view(cat):
    return [(c, e.text, e.tokens, e.metadata) for c, e in cat.items()]


@pytest.mark.parametrize("upto", [2, 5, 6, 9])
def test_same_files_for_same_operations(tmp_path, upto):
    j = jcat.Catalog.load_or_create(tmp_path / "j")
    t = tcat.Catalog.load_or_create(tmp_path / "t")
    for op, arg in OPS[:upto]:
        assert _apply(jcat, j, op, arg) == _apply(tcat, t, op, arg)
    assert _view(j) == _view(t) and len(j) == len(t)
    assert j.path.read_bytes() == t.path.read_bytes()
    assert _journal_masked(j.journal_path) == _journal_masked(t.journal_path)
    assert _sidecar(j._sidecar_path) == _sidecar(t._sidecar_path)
    if not j.journal_path.exists():
        assert j.fingerprint() == t.fingerprint()
    assert (j.fold_alias is None) == (t.fold_alias is None)
    assert j.ids_for_path("/docs/d1.txt") == t.ids_for_path("/docs/d1.txt")
    assert j.contains_many(["id2", "id0", "x"]) == t.contains_many(
        ["id2", "id0", "x"])


def test_packages_take_turns_in_one_directory(tmp_path):
    mods = (jcat, tcat)
    for step, (op, arg) in enumerate(OPS):
        mod = mods[step % 2]
        cat = mod.Catalog.load_or_create(tmp_path)
        _apply(mod, cat, op, arg)
        cat.save()
        a = jcat.Catalog.load_or_create(tmp_path)
        b = tcat.Catalog.load_or_create(tmp_path)
        assert _view(a) == _view(b), step
        assert a.fingerprint() == b.fingerprint() == cat.fingerprint()
        assert a.fold_alias == b.fold_alias


def test_background_fold_alias(tmp_path, monkeypatch):
    """A save past the compaction ratio folds the journal in the
    background; both packages record and read the same pre → post alias,
    and the post-fold fingerprint matches."""
    for mod in (jcat, tcat):
        monkeypatch.setattr(mod, "_COMPACT_MIN_BYTES", 0)
    cats = {}
    for name, mod in (("j", jcat), ("t", tcat)):
        cat = mod.Catalog.load_or_create(tmp_path / name)
        _apply(mod, cat, "upsert", _entries(0, 6))
        cat.save()                        # everything in the journal: fold
        _apply(mod, cat, "upsert", _entries(0, 3, "delta"))
        cat.save()                        # journal > 0.25 base: background
        cat.join_fold(30)
        cats[name] = cat
    j, t = cats["j"], cats["t"]
    assert j.fold_alias and t.fold_alias
    assert j.fingerprint() == t.fingerprint()
    assert j.fold_alias[1] == t.fold_alias[1] == t.fingerprint()
    again = tcat.Catalog.load_or_create(tmp_path / "j")
    assert again.fold_alias == j.fold_alias
    assert again.fingerprint_matches(j.fold_alias[0])
