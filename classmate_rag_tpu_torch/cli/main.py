"""Command line of the PyTorch/CUDA port (port of the JAX package's
``cli/main.py``).

The same 14 subcommands, flags, choices, defaults and JSON as the JAX
package's CLI (the reference's 12 — add, ask, preview, stats, dump,
restore, vacuum, rebuild, list, show, delete, reingest — plus serve and
warmup). Every command prints machine-readable JSON. Heavy dependencies
(torch, the device index) import lazily inside the handlers so
``build_parser`` works in a slim environment.

    python -m classmate_rag_tpu_torch.cli ask "what is a derivative"

The runtime runs on CUDA: ``main(argv, device=None)`` never falls back
to the CPU; callers that want the CPU (the tests) pass ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Optional

from classmate_rag_tpu_torch.metadata import (
    DocumentMetadata,
    normalize_cli_metadata,
    validate_cli_metadata,
)

_DOC_TYPES = ["pdf", "docx", "pptx", "md", "txt", "html", "csv", "epub", "other"]
_LANGS = ["en", "it", "auto"]


def _emit(obj, *, indent: int = 2) -> None:
    print(json.dumps(obj, ensure_ascii=False, indent=indent, default=str))


def _fail(action: str, err: Exception) -> int:
    print(json.dumps({"action": action, "error": str(err)}), file=sys.stderr)
    return 1


def _meta_from_args(
    args: argparse.Namespace,
    *,
    inferred_doc_type: Optional[str] = None,
) -> DocumentMetadata:
    raw = {
        "course": getattr(args, "course", None),
        "unit": getattr(args, "unit", None),
        "language": getattr(args, "language", None),
        "doc_type": getattr(args, "doc_type", None),
        "author": getattr(args, "author", None),
        "semester": getattr(args, "semester", None),
        "tags": getattr(args, "tags", None),
    }
    clean = validate_cli_metadata(
        raw,
        fixup=bool(getattr(args, "fixup", False)),
        inferred_doc_type=inferred_doc_type,
        explicit_doc_type=getattr(args, "doc_type", None) is not None,
    )
    return normalize_cli_metadata(
        course=clean.get("course"),
        unit=clean.get("unit"),
        language=clean.get("language"),
        doc_type=clean.get("doc_type"),
        author=clean.get("author"),
        semester=clean.get("semester"),
        tags=clean.get("tags"),
        subject=getattr(args, "subject", None),
    )


def _where_from_args(args: argparse.Namespace) -> dict:
    """Filters dict with all empty values stripped: an un-flagged command
    yields {}, so "no filters" stays falsy (a bare ``delete`` must refuse,
    not match-all)."""
    return {
        k: v for k, v in _meta_from_args(args).to_dict().items()
        if v is not None and v != [] and v != ""
    }


def _runtime(args: argparse.Namespace):
    """The process's runtime, on ``main``'s device (None → CUDA)."""
    from classmate_rag_tpu_torch.pipeline.runtime import get_runtime

    return get_runtime(device=args.device)


# ---------------------------------------------------------------------------
# Command handlers
# ---------------------------------------------------------------------------

def cmd_add(args: argparse.Namespace) -> int:
    from classmate_rag_tpu_torch.loaders import infer_doc_type_from_path
    from classmate_rag_tpu_torch.pipeline import ingest_file

    path = Path(args.path)
    try:
        meta = _meta_from_args(args, inferred_doc_type=infer_doc_type_from_path(path))
        result = ingest_file(path=path, doc_meta=meta,
                             runtime=_runtime(args))
    except (FileNotFoundError, ValueError) as exc:
        return _fail("add", exc)
    out = dataclasses.asdict(result)
    out.pop("chunk_ids", None)  # thousands of ids for a big PDF
    _emit({"action": "add", **out})
    return 0


def cmd_ask(args: argparse.Namespace) -> int:
    from classmate_rag_tpu_torch.pipeline import ask_question

    try:
        meta = _meta_from_args(args)
        result = ask_question(
            question=args.question,
            filters=meta,
            top_k=args.k,
            hybrid=(args.hybrid == "on"),
            forced_subject=getattr(args, "subject", None),
            runtime=_runtime(args),
        )
    except ValueError as exc:
        return _fail("ask", exc)
    _emit({
        "action": "ask",
        "question": result.question,
        "answer": result.answer,
        "language": result.language,
        "top_k": result.top_k,
        "sources": result.sources,
        "filters": result.filters_applied,
        "hybrid": result.hybrid,
        "route": result.route,
        "route_reason": result.route_reason,
        "retrieved": [
            {"id": r.get("id"), "scores": r.get("scores"),
             "metadata": r.get("metadata")}
            for r in result.retrieved
        ],
    })
    return 0


def cmd_preview(args: argparse.Namespace) -> int:
    from classmate_rag_tpu_torch.pipeline import retrieve_preview

    try:
        meta = _meta_from_args(args)
        result = retrieve_preview(
            question=args.question, filters=meta,
            top_k=args.k, hybrid=(args.hybrid == "on"),
            runtime=_runtime(args),
        )
    except ValueError as exc:
        return _fail("preview", exc)
    _emit({"action": "preview", **result})
    return 0


def cmd_stats(args: argparse.Namespace) -> int:
    from classmate_rag_tpu_torch.pipeline import index_stats

    _emit({"action": "stats", **index_stats(_runtime(args))})
    return 0


def cmd_dump(args: argparse.Namespace) -> int:
    from classmate_rag_tpu_torch.admin import dump_index

    try:
        written = dump_index(
            args.path,
            include_embedding_checksum=not args.no_emb,
            batch_size=args.batch_size,
            runtime=_runtime(args),
        )
    except OSError as exc:
        return _fail("dump", exc)
    _emit({"action": "dump", "path": args.path, "written": written})
    return 0


def cmd_restore(args: argparse.Namespace) -> int:
    from classmate_rag_tpu_torch.admin import restore_dump

    try:
        restored = restore_dump(args.path, batch_size=args.batch_size,
                                runtime=_runtime(args))
    except (FileNotFoundError, OSError) as exc:
        return _fail("restore", exc)
    _emit({"action": "restore", "path": args.path, "restored": restored})
    return 0


def cmd_vacuum(args: argparse.Namespace) -> int:
    from classmate_rag_tpu_torch.admin import vacuum_indexes

    _emit({"action": "vacuum", **vacuum_indexes(_runtime(args))})
    return 0


def cmd_rebuild(args: argparse.Namespace) -> int:
    from classmate_rag_tpu_torch.admin import rebuild_embeddings

    result = rebuild_embeddings(args.model, batch_size=args.batch_size,
                                runtime=_runtime(args))
    _emit({"action": "rebuild", **result})
    return 0


def cmd_list(args: argparse.Namespace) -> int:
    from classmate_rag_tpu_torch.admin import list_entries

    where = _where_from_args(args)
    items = list_entries(where or None, limit=args.limit, offset=args.offset,
                         runtime=_runtime(args))
    _emit({"action": "list", "count": len(items), "items": items})
    return 0


def cmd_show(args: argparse.Namespace) -> int:
    from classmate_rag_tpu_torch.admin import resolve_ids, show_entries_by_id

    ids = list(args.id or [])
    if args.path:
        ids.extend(resolve_ids(path=args.path, runtime=_runtime(args)))
    if not ids:
        return _fail("show", ValueError("provide --id or --path"))
    _emit({"action": "show",
           "items": show_entries_by_id(ids, runtime=_runtime(args))})
    return 0


def cmd_delete(args: argparse.Namespace) -> int:
    from classmate_rag_tpu_torch.admin import delete_by_ids, resolve_ids

    where = _where_from_args(args)
    targets = resolve_ids(
        ids=args.id, path=args.path, where=where or None,
        runtime=_runtime(args),
    )
    if args.id is None and args.path is None and not where:
        return _fail(
            "delete", ValueError("refusing to delete without --id/--path/filters")
        )
    if args.dry_run:
        _emit({"action": "delete", "dry_run": True, "would_delete": targets})
        return 0
    result = delete_by_ids(targets, runtime=_runtime(args))
    _emit({"action": "delete", "ids": targets, **result})
    return 0


def cmd_reingest(args: argparse.Namespace) -> int:
    from classmate_rag_tpu_torch.admin import reingest_paths, resolve_ids

    where = _where_from_args(args)
    paths = list(args.path or [])
    if args.id or where:
        rt = _runtime(args)
        ids = resolve_ids(ids=args.id, where=where or None, runtime=rt)
        for cid in ids:
            entry = rt.catalog.get(cid)
            sp = entry.metadata.get("source_path") if entry else None
            if sp and sp not in paths:
                paths.append(str(sp))
    if not paths:
        return _fail("reingest", ValueError("nothing to reingest"))
    if args.dry_run:
        _emit({"action": "reingest", "dry_run": True, "paths": paths})
        return 0
    try:
        results = reingest_paths(paths, runtime=_runtime(args))
    except (FileNotFoundError, OSError) as exc:
        return _fail("reingest", exc)
    _emit({"action": "reingest", "reingested": len(results), "results": results})
    return 0


def cmd_serve(args: argparse.Namespace) -> int:
    from classmate_rag_tpu_torch.serve import serve

    serve(host=args.host, port=args.port, device=args.device)
    return 0


def cmd_warmup(args: argparse.Namespace) -> int:
    """Deployment prep: place the serving state (the slabs, the split
    layout) on the card with one throwaway query per batch size, and
    report how long each took (run after building or snapshotting a
    large index)."""
    rt = _runtime(args)
    if rt.warmup_thread is not None:
        rt.warmup_thread.join()   # don't place the same state twice
    secs = rt.warmup(batch_sizes=tuple(args.batch))
    _emit({
        "action": "warmup",
        "rows": rt.store.n_rows,
        "seconds_per_batch": secs,
        "load_split_s": rt.load_timings,
    })
    return 0


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

def _add_meta_flags(p: argparse.ArgumentParser, *, lang_default=None) -> None:
    p.add_argument("--course", type=str, help="Course code or name")
    p.add_argument("--unit", type=str, help="Unit/module name")
    p.add_argument("--language", type=str, choices=_LANGS, default=lang_default,
                   help="Language (en/it/auto)")
    p.add_argument("--doc-type", dest="doc_type", type=str, choices=_DOC_TYPES,
                   help="Document type")
    p.add_argument("--author", type=str, help="Author or source")
    p.add_argument("--semester", type=str, help="Semester label (e.g., 2025S)")
    p.add_argument("--tags", type=str, help="Comma-separated tags")
    p.add_argument("--fixup", action="store_true",
                   help="Auto-trim fields and slug tags if needed")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="classmate", description="classmate_rag_tpu_torch CLI"
    )
    sub = p.add_subparsers(dest="command", required=True)

    pa = sub.add_parser("add", help="Ingest a file with metadata")
    pa.add_argument("path", help="Path to the document to ingest")
    _add_meta_flags(pa, lang_default="auto")
    pa.add_argument("--subject", type=str,
                    help="Routing subject (math|code|translation|default)")
    pa.set_defaults(func=cmd_add)

    pq = sub.add_parser("ask", help="Ask a question with optional filters")
    pq.add_argument("question", help="The question (quote it)")
    _add_meta_flags(pq, lang_default="auto")
    pq.add_argument("--k", type=int, default=8, help="Top-K after fusion")
    pq.add_argument("--hybrid", type=str, choices=["on", "off"], default="on",
                    help="Hybrid retrieval (vector+BM25)")
    pq.add_argument("--subject", type=str,
                    help="Force a routing subject")
    pq.set_defaults(func=cmd_ask)

    pp = sub.add_parser("preview", help="Preview retrieval (no generation)")
    pp.add_argument("question", help="The query")
    _add_meta_flags(pp, lang_default="auto")
    pp.add_argument("--k", type=int, default=8, help="Top-K to preview")
    pp.add_argument("--hybrid", type=str, choices=["on", "off"], default="on")
    pp.set_defaults(func=cmd_preview)

    ps = sub.add_parser("stats", help="Index health and disk usage")
    ps.set_defaults(func=cmd_stats)

    pd = sub.add_parser("dump", help="Export corpus to JSONL")
    pd.add_argument("--path", required=True, help="Output JSONL path")
    pd.add_argument("--batch-size", type=int, default=256)
    pd.add_argument("--no-emb", action="store_true",
                    help="Skip embedding checksums")
    pd.set_defaults(func=cmd_dump)

    pr = sub.add_parser("restore", help="Restore indexes from a JSONL dump")
    pr.add_argument("--path", required=True, help="Input JSONL path")
    pr.add_argument("--batch-size", type=int, default=256)
    pr.set_defaults(func=cmd_restore)

    pv = sub.add_parser("vacuum", help="Compact indexes")
    pv.set_defaults(func=cmd_vacuum)

    pb = sub.add_parser("rebuild", help="Re-embed with a new model")
    pb.add_argument("--model", required=True, help="New embedding model")
    pb.add_argument("--batch-size", type=int, default=256)
    pb.set_defaults(func=cmd_rebuild)

    pl = sub.add_parser("list", help="List indexed chunks by filters")
    _add_meta_flags(pl)
    pl.add_argument("--limit", type=int, default=50)
    pl.add_argument("--offset", type=int, default=0)
    pl.set_defaults(func=cmd_list)

    pshow = sub.add_parser("show", help="Show chunks by id or path")
    pshow.add_argument("--id", nargs="+", help="One or more chunk IDs")
    pshow.add_argument("--path", type=str, help="Source file path")
    pshow.set_defaults(func=cmd_show)

    pdel = sub.add_parser("delete", help="Delete chunks from all indexes")
    pdel.add_argument("--id", nargs="+", help="Chunk IDs to delete")
    pdel.add_argument("--path", type=str, help="Delete all chunks of a file")
    _add_meta_flags(pdel)
    pdel.add_argument("--dry-run", action="store_true")
    pdel.set_defaults(func=cmd_delete)

    pserve = sub.add_parser("serve", help="Run the HTTP serving daemon")
    pserve.add_argument("--host", type=str, default="127.0.0.1")
    pserve.add_argument("--port", type=int, default=8080)
    pserve.set_defaults(func=cmd_serve)

    pw = sub.add_parser(
        "warmup", help="Place the serving state on the card"
    )
    pw.add_argument("--batch", type=int, nargs="+", default=[1],
                    help="Batch sizes to warm up (one query batch each)")
    pw.set_defaults(func=cmd_warmup)

    pre = sub.add_parser("reingest", help="Reingest whole files")
    pre.add_argument("--path", nargs="+", help="File paths to reingest")
    pre.add_argument("--id", nargs="+", help="Chunk IDs (their files reingest)")
    _add_meta_flags(pre)
    pre.add_argument("--dry-run", action="store_true")
    pre.set_defaults(func=cmd_reingest)

    return p


def _configure_logging() -> None:
    """Honor LOG_LEVEL (the reference declared the knob but never
    configured the root logger — here it actually applies). Reads the
    environment directly so the parser needs no config import."""
    import logging
    import os

    level = (os.environ.get("LOG_LEVEL") or "INFO").upper()
    logging.basicConfig(
        level=getattr(logging, level, logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )


def main(argv: Optional[list] = None, device=None) -> int:
    """Run one command; the runtime it needs lives on ``device`` (None →
    CUDA, raising where there is no card)."""
    _configure_logging()
    parser = build_parser()
    args = parser.parse_args(argv)
    args.device = device
    try:
        return args.func(args)
    except ValueError as exc:
        # Machine-readable JSON error for EVERY verb (an invalid --tags
        # on `list`/`delete`/`reingest` raised out of _where_from_args
        # uncaught and dumped a raw traceback, while `add`/`ask` handled
        # the identical input).
        action = args.func.__name__.removeprefix("cmd_")
        return _fail(action, exc)


if __name__ == "__main__":
    raise SystemExit(main())
