"""The port's own copies of the JAX package's host modules give the same
outputs on the same inputs: the loaders (on the synthetic files of
tests/test_loaders.py), the chunker, the metadata schema and validation,
the ids/dedup/text utilities, prompting and citations, and neighbour
expansion over each package's disk catalog. Outputs must be EQUAL (enum
members compare by value).
"""

import dataclasses

import pytest

from test_loaders import make_docx, make_epub, make_pdf, make_pptx

import classmate_rag_tpu.chunking as jchunk
import classmate_rag_tpu.generation.post as jpost
import classmate_rag_tpu.generation.prompting as jprompt
import classmate_rag_tpu.index.catalog as jcat
import classmate_rag_tpu.loaders as jload
import classmate_rag_tpu.metadata as jmeta
import classmate_rag_tpu.metadata.validation as jval
import classmate_rag_tpu.retrieval.expand as jexp
import classmate_rag_tpu.utils as jutil
import classmate_rag_tpu_torch.chunking as tchunk
import classmate_rag_tpu_torch.generation.post as tpost
import classmate_rag_tpu_torch.generation.prompting as tprompt
import classmate_rag_tpu_torch.index.catalog as tcat
import classmate_rag_tpu_torch.loaders as tload
import classmate_rag_tpu_torch.metadata as tmeta
import classmate_rag_tpu_torch.metadata.validation as tval
import classmate_rag_tpu_torch.retrieval.expand as texp
import classmate_rag_tpu_torch.utils as tutil

TEXT = (
    "Eigenvalues describe how a linear map stretches space. "
    "Each eigenvector keeps its direction!\n\n"
    "La matrice diagonale ha autovalori sulla diagonale. "
    "Perché? Perché il prodotto è semplice.\n\n"
    + "A long paragraph of filler words about spectra and bases. " * 30
)


def _files(tmp_path):
    out = {}
    p = tmp_path / "a.txt"
    p.write_text("hello world\n\nsecond paragraph")
    out["txt"] = p
    p = tmp_path / "a.md"
    p.write_text("# Title\n\nSome *markdown* text.")
    out["md"] = p
    p = tmp_path / "a.html"
    p.write_text("<html><nav>menu</nav><p>Body text</p>"
                 "<script>x()</script></html>")
    out["html"] = p
    p = tmp_path / "a.csv"
    p.write_text("name,score\nada,3\nbob,4\n")
    out["csv"] = p
    make_docx(tmp_path / "a.docx", ["First paragraph.", "Second."],
              table_rows=[["a", "b"], ["c", "d"]])
    out["docx"] = tmp_path / "a.docx"
    make_pptx(tmp_path / "a.pptx", [["Title", "Sub"], ["Two"]],
              notes={1: "note one"})
    out["pptx"] = tmp_path / "a.pptx"
    make_epub(tmp_path / "a.epub", ["Chapter one.", "Chapter two."])
    out["epub"] = tmp_path / "a.epub"
    make_pdf(tmp_path / "a.pdf", ["Hello PDF (x) world.", "Page two."],
             compress=True)
    out["pdf"] = tmp_path / "a.pdf"
    return out


@pytest.mark.parametrize("kind", ["txt", "md", "html", "csv", "docx",
                                  "pptx", "epub", "pdf"])
def test_loaders(tmp_path, kind):
    path = _files(tmp_path)[kind]
    assert jload.infer_doc_type_from_path(path) == (
        tload.infer_doc_type_from_path(path))
    want = jload.load_document_by_type(path, kind)
    assert want and tload.load_document_by_type(path, kind) == want


def _as_plain(x):
    if dataclasses.is_dataclass(x):
        return {k: _as_plain(v) for k, v in dataclasses.asdict(x).items()}
    if isinstance(x, dict):
        return {k: _as_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_as_plain(v) for v in x]
    return getattr(x, "value", x)


CASES = {
    "chunk_text": lambda m: m["chunk"].chunk_text(
        TEXT, chunk_size=200, chunk_overlap=40, page=3,
        starting_chunk_id=5),
    "chunk_pages": lambda m: m["chunk"].chunk_pages(
        [(1, TEXT), (2, "short page.")], chunk_size=300, chunk_overlap=50),
    "sentence_split": lambda m: m["chunk"].sentence_split(TEXT),
    "normalize_cli_metadata": lambda m: m["meta"].normalize_cli_metadata(
        course=" calc ", language="Italiano", doc_type="PDF",
        tags="Week-1, week-1,Exam", subject="matematica"),
    "to_dict": lambda m: m["meta"].normalize_cli_metadata(
        course="c", language="auto", doc_type="other").to_dict(),
    "validate_cli_metadata": lambda m: m["val"].validate_cli_metadata(
        {"language": "EN", "doc_type": "slides", "tags": "a b,c-d"},
        fixup=True, inferred_doc_type="pdf"),
    "expand_tag_flags": lambda m: m["val"].expand_tag_flags("Week 1,exam"),
    "stable_chunk_id": lambda m: m["util"].stable_chunk_id(
        source_path="/x/y.pdf", page=2, chunk_index=7, course="c",
        unit=None),
    "dedup": lambda m: m["util"].dedup_text_blocks(
        ["alpha beta gamma delta epsilon zeta"] * 2 + ["other text here"],
        jaccard_threshold=0.9),
    "normalize_text": lambda m: m["util"].normalize_text(
        "a b\r\n\n\n\nc  d"),
    "format_context_blocks": lambda m: m["prompt"].format_context_blocks(
        [{"document": "Doc one text.", "metadata": {
            "source_path": "/d/a.pdf", "page": 2, "chunk_id": 1}},
         {"document": "Doc two.", "metadata": {"source_path": "/d/b.md"}}],
        max_total_chars=40),
    "build_grounded_messages": lambda m: m["prompt"].build_grounded_messages(
        question="why?", context_text="[1] ctx", citations_required=True),
    "enforce_citations": lambda m: m["post"].enforce_citations(
        "Claim one. Claim two [3].", ["a.pdf p1", "b.md"],
        add_sources_block=True, sources_title="Sources"),
}

MODS = {
    "jax": dict(chunk=jchunk, meta=jmeta, val=jval, util=jutil,
                prompt=jprompt, post=jpost),
    "torch": dict(chunk=tchunk, meta=tmeta, val=tval, util=tutil,
                  prompt=tprompt, post=tpost),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_functions(name):
    want = _as_plain(CASES[name](MODS["jax"]))
    assert _as_plain(CASES[name](MODS["torch"])) == want


@pytest.mark.parametrize("radius,cap", [(1, None), (2, 3), (0, 1)])
def test_expand_with_neighbors(tmp_path, radius, cap):
    ids = {}
    cats = {}
    for name, cat_mod, util in (("j", jcat, jutil), ("t", tcat, tutil)):
        cat = cat_mod.Catalog.load_or_create(tmp_path / name)
        for doc in ("/d/a.pdf", "/d/b.pdf"):
            for c in range(6):
                cid = util.stable_chunk_id(source_path=doc, page=1,
                                           chunk_index=c, course="x",
                                           unit=None)
                ids[(doc, c)] = cid
                cat.upsert(cat_mod.CatalogEntry(
                    cid, f"{doc} chunk {c}", ["t"],
                    {"source_path": doc, "page": 1, "chunk_id": c,
                     "course": "x"}))
        cat.save()
        cats[name] = cat
    hits = [{"id": ids[(d, c)], "document": "", "scores": {"fused": s},
             "metadata": {"source_path": d, "page": 1, "chunk_id": c,
                          "course": "x"}}
            for d, c, s in (("/d/a.pdf", 2, 0.5), ("/d/b.pdf", 0, 0.4),
                            ("/d/a.pdf", 3, 0.3))]
    want = jexp.expand_with_neighbors(hits, cats["j"], radius=radius,
                                      max_per_doc=cap)
    got = texp.expand_with_neighbors(hits, cats["t"], radius=radius,
                                     max_per_doc=cap)
    assert got == want and len(want) >= 3 - (cap is not None)
