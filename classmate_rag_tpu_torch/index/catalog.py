"""Chunk catalog: the durable source of truth for all admin operations.

Persists as JSONL with one ``{"id", "text", "tokens", "metadata"}`` object
per line at ``<bm25_dir>/bm25_index.jsonl`` — the exact format and location
of the reference's BM25 store (rag/retrieval/bm25.py:220-248), so dumps and
catalogs interoperate across the two stacks.

Unlike the reference — which holds every chunk's text + tokens + metadata
in one Python dict, parses the whole file on startup and rewrites it on
every save (rag/retrieval/bm25.py:14,189,220-248) — this catalog is
DISK-BACKED and scales to serving-size corpora:

- The base JSONL is indexed by byte offset per id in ONE binary scan (no
  JSON parse of entry bodies; seconds at 1M chunks vs minutes), and
  entries are fetched lazily per line with an LRU cache for hot ids.
  Host RSS is O(ids), not O(corpus text).
- Mutations append to a sidecar journal (``bm25_index.journal.jsonl``):
  an ``/add`` or ``delete`` writes O(delta) bytes, never the whole file.
  The journal folds back into the base (atomic tmp+rename) once it
  outgrows ``_COMPACT_RATIO`` of the base, restoring the single-file
  reference-interoperable layout; ``compact()`` forces the fold for an
  immediate handoff to a reference stack.
- The offset index + content fingerprint persist in a sidecar
  (``catalog.offsets.npz``) validated by exact (size, mtime_ns) of both
  files, so a warm cold start skips even the binary scan.

``fingerprint()`` hashes base bytes then journal bytes; with an empty
journal it equals the historical sha1-of-file, so existing store
snapshots stay valid.

Host copy of the JAX package's ``index/catalog.py`` (no JAX).
"""

from __future__ import annotations

import json
import os
import re
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from hashlib import sha1
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple
from zipfile import BadZipFile

# (source, offset, length): where the current version of an id's line
# lives. Source 0 = base file, 1 = journal file, 2 = RAM-pending (offset
# and length unused for pending).
_BASE, _JOURNAL, _PENDING = 0, 1, 2

# Fast id extraction for lines in our canonical key order; falls back to
# a full JSON parse when the pattern misses (foreign writers).
_ID_RE = re.compile(rb'^\{"id":\s*"([^"\\]+)"')

_SCAN_BLOCK = 1 << 22  # 4 MiB

# The journal folds into the base once it exceeds this fraction of the
# base size, with an absolute floor so classroom-scale catalogs don't
# rewrite on every add.
_COMPACT_RATIO = 0.25
_COMPACT_MIN_BYTES = 4 << 20


@dataclass
class CatalogEntry:
    id: str
    text: str
    tokens: List[str]
    metadata: Dict[str, Any]


def _entry_line(e: CatalogEntry) -> str:
    return json.dumps(
        {"id": e.id, "text": e.text, "tokens": e.tokens,
         "metadata": e.metadata},
        ensure_ascii=False,
    )


def _parse_entry(line: bytes | str) -> Optional[CatalogEntry]:
    try:
        rec = json.loads(line)
    except (json.JSONDecodeError, UnicodeDecodeError, ValueError):
        return None
    if not isinstance(rec, dict):
        return None
    cid = str(rec.get("id") or "")
    if not cid:
        return None
    return CatalogEntry(
        id=cid,
        text=str(rec.get("text") or ""),
        tokens=list(rec.get("tokens") or []),
        metadata=dict(rec.get("metadata") or {}),
    )


def _stat_key(path: Path) -> Tuple[int, int]:
    try:
        st = path.stat()
        return (st.st_size, st.st_mtime_ns)
    except OSError:
        return (0, 0)


_EMPTY_SHA = sha1(b"").hexdigest()


@dataclass
class Catalog:
    """Disk-backed catalog. The public surface (load_or_create / load /
    save / fingerprint / upsert / delete / get / ``in`` / len / ids /
    entries / items) is unchanged from the all-in-RAM round-3 version;
    only the storage strategy differs."""

    path: Path
    cache_entries: int = field(
        default_factory=lambda: int(
            os.getenv("CATALOG_CACHE_ENTRIES", "8192")
        )
    )
    # id -> (source, offset, length); insertion order = first-seen order,
    # preserved across upserts (dict semantics), matching the old
    # dict-of-entries iteration order.
    _index: Dict[str, Tuple[int, int, int]] = field(default_factory=dict)
    _pending: Dict[str, CatalogEntry] = field(default_factory=dict)
    _pending_deletes: List[str] = field(default_factory=list)
    _cache: "OrderedDict[str, CatalogEntry]" = field(
        default_factory=OrderedDict
    )
    _lock: threading.RLock = field(default_factory=threading.RLock)
    _base_sha: Optional[str] = None  # hex sha1 of base-file bytes
    _journal_hash: Any = field(default_factory=sha1)  # running, journal bytes
    _sidecar_dirty: bool = False
    # Background journal fold (see _fold_concurrent): the O(corpus)
    # rewrite runs OFF the lock so an /add that trips the compaction
    # ratio returns in O(delta) time while serving continues.
    _fold_thread: Any = field(default=None, repr=False)
    # Bumped by anything that restructures the files under a running
    # fold (synchronous compact, reload): the fold validates it at swap
    # time and aborts instead of clobbering newer state.
    _structure_gen: int = 0
    # Last fold's (pre_fp, post_fp): a fold rewrites bytes without
    # changing logical content, so artifacts keyed to the PRE-fold
    # fingerprint (the store's snapshot/delta chain) stay valid against
    # the post-fold catalog. Persisted in catalog.fold.json.
    _fold_alias: Optional[Tuple[str, str]] = None

    # ------------------------------------------------------------------
    @property
    def journal_path(self) -> Path:
        stem = self.path.name.rsplit(".", 1)[0]
        return self.path.with_name(stem + ".journal.jsonl")

    @property
    def _sidecar_path(self) -> Path:
        return self.path.with_name("catalog.offsets.npz")

    @property
    def _fold_alias_path(self) -> Path:
        return self.path.with_name("catalog.fold.json")

    @property
    def _pending_journal_path(self) -> Path:
        return self.journal_path.with_suffix(".jsonl.pending")

    @classmethod
    def load_or_create(
        cls, directory: str | Path, filename: str = "bm25_index.jsonl"
    ) -> "Catalog":
        cat = cls(path=Path(directory) / filename)
        cat.load()
        return cat

    # ------------------------------------------------------------------
    # Loading: sidecar restore, else one binary offset scan — never a
    # full JSON parse of entry bodies.
    # ------------------------------------------------------------------

    def load(self) -> None:
        with self._lock:
            self._structure_gen += 1   # abort any in-flight fold
            self._index.clear()
            self._pending.clear()
            self._pending_deletes.clear()
            self._cache.clear()
            self._base_sha = None
            self._journal_hash = sha1()
            self._sidecar_dirty = False
            self._recover_pending_journal()
            self._load_fold_alias()
            # A fold that died in phase 2 leaves its streaming tmp
            # behind; it was never installed, so it is pure garbage.
            self.path.with_name(self.path.name + ".fold.tmp").unlink(
                missing_ok=True
            )
            if not self.path.exists():
                self._base_sha = _EMPTY_SHA
                self._legacy_journal_guard()
                self._replay_journal()
                return
            if not self._load_sidecar():
                self._legacy_journal_guard()
                self._scan_base()
                self._replay_journal()
                self._save_sidecar()

    def _scan_base(self) -> None:
        """One binary pass over the base JSONL: byte offsets + ids +
        sha1, all in the same read."""
        h = sha1()
        offset = 0  # absolute offset of the next unconsumed byte
        carry = b""
        with self.path.open("rb") as f:
            while True:
                block = f.read(_SCAN_BLOCK)
                if not block:
                    break
                h.update(block)
                data = carry + block
                start = 0
                while True:
                    nl = data.find(b"\n", start)
                    if nl < 0:
                        carry = data[start:]
                        break
                    self._index_line(data[start:nl], offset, _BASE)
                    offset += (nl - start) + 1
                    start = nl + 1
            if carry.strip():
                self._index_line(carry, offset, _BASE)
        self._base_sha = h.hexdigest()

    def _index_line(self, line: bytes, off: int, src: int) -> None:
        stripped = line.strip()
        if not stripped:
            return
        m = _ID_RE.match(stripped)
        if m is not None:
            cid = m.group(1).decode("utf-8", errors="ignore")
        else:
            e = _parse_entry(stripped)
            if e is None:
                return
            cid = e.id
        self._index[cid] = (src, off, len(line))

    def _journal_has_marker(self) -> bool:
        """True when the journal's first line is a base-binding marker."""
        jp = self.journal_path
        try:
            with jp.open("rb") as f:
                first = f.readline().strip()
        except OSError:
            return False
        if not first:
            return False
        try:
            rec = json.loads(first)
        except (json.JSONDecodeError, ValueError):
            return False
        return isinstance(rec, dict) and rec.get("op") == "base"

    def _legacy_journal_guard(self) -> None:
        """Stale-check MARKER-LESS journals (written before the
        base-binding marker existed). Such a journal carries no record of
        which base it extended, so a foreign base rewrite under it would
        replay stale ops and resurrect deleted entries — the exact bug
        the marker fixes, otherwise left open for upgraded deployments.
        The sidecar's (size, mtime_ns) records witness the pairing: a
        journal that matches the sidecar's journal_stat while the base
        does NOT match its base_stat was written against a base that no
        longer exists → set it aside as ``.stale``. (Marker-bearing
        journals are validated by _replay_journal; journals whose first
        mutation postdates this fix always carry a marker.)"""
        jp = self.journal_path
        if not jp.exists() or self._journal_has_marker():
            return
        import numpy as np

        sp = self._sidecar_path
        if not sp.exists():
            return
        try:
            with np.load(sp, allow_pickle=False) as z:
                base_stat = tuple(int(v) for v in z["base_stat"])
                journal_stat = tuple(int(v) for v in z["journal_stat"])
        except (OSError, ValueError, KeyError, BadZipFile):
            return
        if (
            journal_stat == _stat_key(jp)
            and base_stat != _stat_key(self.path)
        ):
            try:
                os.replace(jp, jp.with_suffix(".jsonl.stale"))
            except OSError:
                pass

    @staticmethod
    def _marker_stat(path: Path) -> Optional[Tuple[int, ...]]:
        """The (size, mtime_ns) a journal-style file's base marker
        records, or None when there is no marker."""
        try:
            with path.open("rb") as f:
                first = f.readline().strip()
            rec = json.loads(first) if first else None
        except (OSError, ValueError):
            return None
        if isinstance(rec, dict) and rec.get("op") == "base":
            return tuple(int(v) for v in rec.get("stat") or ())
        return None

    def _recover_pending_journal(self) -> None:
        """Crash recovery for the background fold's two-rename swap: the
        post-fold journal is staged at ``*.pending`` BEFORE the base
        replace. A crash between the renames leaves a new base whose
        stat the OLD journal's marker no longer matches while the
        pending one does — adopt it (otherwise durable tail ops written
        during the fold would be demoted as stale). Any other
        combination means the pending file is leftover staging."""
        pp = self._pending_journal_path
        if not pp.exists():
            return
        base_stat = _stat_key(self.path)
        jp = self.journal_path
        jp_ok = jp.exists() and self._marker_stat(jp) == base_stat
        if not jp_ok and self._marker_stat(pp) == base_stat:
            try:
                os.replace(pp, jp)
                return
            except OSError:
                pass
        pp.unlink(missing_ok=True)

    # -- fold alias: bytes changed, content didn't ----------------------

    def _load_fold_alias(self) -> None:
        self._fold_alias = None
        try:
            rec = json.loads(
                self._fold_alias_path.read_text(encoding="utf-8")
            )
            pre, post = str(rec["pre"]), str(rec["post"])
            if pre and post:
                self._fold_alias = (pre, post)
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            pass

    def _write_fold_alias(self, pre: str, post: str) -> None:
        self._fold_alias = (pre, post)
        try:
            tmp = self._fold_alias_path.with_suffix(".json.tmp")
            tmp.write_text(
                json.dumps({"pre": pre, "post": post}), encoding="utf-8"
            )
            os.replace(tmp, self._fold_alias_path)
        except OSError:
            pass  # alias is an accelerator; a missed write only costs a rebuild

    @property
    def fold_alias(self) -> Optional[Tuple[str, str]]:
        """Last fold's (pre_fp, post_fp), or None."""
        return self._fold_alias

    def fingerprint_matches(self, candidate: str) -> bool:
        """True when ``candidate`` identifies the catalog's CURRENT
        logical content: the live fingerprint, or the pre-fold
        fingerprint when the only change since was a journal fold
        (byte rewrite, same entries). Artifacts derived from the
        pre-fold state — the store's lexical snapshot and delta
        chain — stay valid across a fold."""
        live = self.fingerprint()
        if candidate == live:
            return True
        alias = self._fold_alias
        return (
            alias is not None
            and candidate == alias[0]
            and live == alias[1]
        )

    def _replay_journal(self) -> None:
        """Apply journal ops in order; rebuilds the running journal hash
        so later appends extend it incrementally.

        The journal's first line records the (size, mtime_ns) of the base
        it was written against. A base rewritten by a foreign writer (a
        reference stack knows nothing about the sidecar journal —
        rag/retrieval/bm25.py:220-248 rewrites the whole file) must NOT
        have a stale journal replayed on top: deleted entries would
        resurrect into query results. On mismatch the journal is set
        aside as ``*.stale`` and ignored.
        """
        self._journal_hash = sha1()
        jp = self.journal_path
        if not jp.exists():
            return
        off = 0
        with jp.open("rb") as f:
            for raw in f:
                line = raw.rstrip(b"\n")
                stripped = line.strip()
                if stripped:
                    try:
                        rec = json.loads(stripped)
                    except (json.JSONDecodeError, ValueError):
                        rec = None
                    if (
                        off == 0
                        and isinstance(rec, dict)
                        and rec.get("op") == "base"
                    ):
                        want = tuple(int(v) for v in rec.get("stat") or ())
                        if want != _stat_key(self.path):
                            # Foreign base rewrite: this journal belongs
                            # to a base that no longer exists.
                            try:
                                os.replace(
                                    jp, jp.with_suffix(".jsonl.stale")
                                )
                            except OSError:
                                pass
                            self._journal_hash = sha1()
                            return
                    elif isinstance(rec, dict) and rec.get("id"):
                        if rec.get("op") == "delete":
                            self._index.pop(str(rec["id"]), None)
                        else:
                            self._index[str(rec["id"])] = (
                                _JOURNAL, off, len(line)
                            )
                self._journal_hash.update(raw)
                off += len(raw)

    # ------------------------------------------------------------------
    # Sidecar: persisted offset index for O(index) warm cold starts.
    # ------------------------------------------------------------------

    def _load_sidecar(self) -> bool:
        import numpy as np

        sp = self._sidecar_path
        if not sp.exists():
            return False
        try:
            with np.load(sp, allow_pickle=False) as z:
                if (
                    tuple(int(v) for v in z["base_stat"])
                    != _stat_key(self.path)
                    or tuple(int(v) for v in z["journal_stat"])
                    != _stat_key(self.journal_path)
                ):
                    return False
                blob = str(z["ids"])
                ids = [i for i in blob.split("\n") if i] if blob else []
                srcs, offs, lens = z["srcs"], z["offs"], z["lens"]
                if not (len(ids) == len(srcs) == len(offs) == len(lens)):
                    return False
                base_sha = str(z["base_sha"])
                # The running journal hash can't resume from a digest;
                # re-read journal bytes (small by construction).
                jh = sha1()
                jp = self.journal_path
                if jp.exists():
                    with jp.open("rb") as f:
                        for blk in iter(lambda: f.read(_SCAN_BLOCK), b""):
                            jh.update(blk)
                if jh.hexdigest() != str(z["journal_sha"]):
                    return False
                index = {
                    cid: (int(srcs[i]), int(offs[i]), int(lens[i]))
                    for i, cid in enumerate(ids)
                }
        except (OSError, ValueError, KeyError, BadZipFile):
            return False
        self._index = index
        self._base_sha = base_sha
        self._journal_hash = jh
        return True

    def _save_sidecar(self) -> None:
        import numpy as np

        try:
            n = len(self._index)
            srcs = np.fromiter(
                (v[0] for v in self._index.values()), np.int8, n
            )
            offs = np.fromiter(
                (v[1] for v in self._index.values()), np.int64, n
            )
            lens = np.fromiter(
                (v[2] for v in self._index.values()), np.int64, n
            )
            tmp = self._sidecar_path.with_suffix(".npz.tmp")
            self._sidecar_path.parent.mkdir(parents=True, exist_ok=True)
            with tmp.open("wb") as f:
                np.savez(
                    f,
                    ids=np.str_("\n".join(self._index.keys())),
                    srcs=srcs, offs=offs, lens=lens,
                    base_sha=np.str_(self._base_sha or ""),
                    journal_sha=np.str_(self._journal_hash.hexdigest()),
                    base_stat=np.asarray(_stat_key(self.path), np.int64),
                    journal_stat=np.asarray(
                        _stat_key(self.journal_path), np.int64
                    ),
                )
            os.replace(tmp, self._sidecar_path)
            self._sidecar_dirty = False
        except OSError:
            pass  # the sidecar is a pure accelerator; next load re-scans

    # ------------------------------------------------------------------
    # Fingerprint
    # ------------------------------------------------------------------

    def fingerprint(self) -> str:
        """sha1 over base bytes then journal bytes — keys the store's
        fast-load lexical snapshot to the exact on-disk catalog state.
        Empty journal == the historical sha1-of-file value."""
        with self._lock:
            if not self.path.exists() and not self.journal_path.exists():
                return ""
            if self._base_sha is None:
                h = sha1()
                if self.path.exists():
                    with self.path.open("rb") as f:
                        for blk in iter(lambda: f.read(_SCAN_BLOCK), b""):
                            h.update(blk)
                self._base_sha = h.hexdigest()
            jdigest = self._journal_hash.hexdigest()
            if jdigest == _EMPTY_SHA:
                return self._base_sha
            h = sha1()
            h.update(bytes.fromhex(self._base_sha))
            h.update(bytes.fromhex(jdigest))
            return h.hexdigest()

    # ------------------------------------------------------------------
    # Persistence: O(delta) journal appends; compaction folds the
    # journal into an atomic base rewrite when it outgrows the ratio.
    # ------------------------------------------------------------------

    def save(self) -> None:
        with self._lock:
            self._flush_pending_locked()
            jsize = (
                self.journal_path.stat().st_size
                if self.journal_path.exists() else 0
            )
            bsize = self.path.stat().st_size if self.path.exists() else 0
            if jsize and not bsize:
                # Everything lives in the journal (fresh restore / first
                # adds): fold immediately so the reference-visible base
                # file exists from the start.
                self._compact_locked()
            elif jsize > max(
                _COMPACT_MIN_BYTES, int(_COMPACT_RATIO * bsize)
            ):
                # De-cliffed: the fold is an O(corpus) rewrite (a ~GB
                # atomic file at 1M chunks) — it runs in a background
                # thread OFF the lock, so the /add that tripped the
                # ratio returns in O(delta) time and queries keep
                # serving; only the final swap takes the lock.
                self._start_fold_locked()
            if self._sidecar_dirty:
                self._save_sidecar()

    def _start_fold_locked(self) -> None:
        t = self._fold_thread
        if t is not None and t.is_alive():
            return
        t = threading.Thread(
            target=self._fold_concurrent, name="catalog-fold", daemon=True
        )
        self._fold_thread = t
        t.start()

    def join_fold(self, timeout: Optional[float] = None) -> None:
        """Wait for an in-flight background fold (tests/shutdown)."""
        t = self._fold_thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def _fold_concurrent(self) -> None:
        """Background journal fold. Three phases:

        1. (lock) snapshot the index + open the current file inodes +
           record the journal length J0 and the structure generation;
        2. (no lock) stream every snapshotted on-disk entry to a tmp
           base in index order — concurrent /adds keep appending to the
           journal past J0, reads keep serving from the old files;
        3. (lock) validate the generation, stage the post-fold journal
           (fresh base marker + the ops appended after J0) at
           ``*.pending``, swap base then journal (crash between the two
           renames is healed by _recover_pending_journal), rewrite the
           in-memory index against the new locations, and record the
           pre→post fingerprint alias so store snapshots keyed to the
           pre-fold catalog stay valid.
        """
        import logging

        try:
            with self._lock:
                gen = self._structure_gen
                pre_fp = self.fingerprint()
                snapshot = list(self._index.items())
                j0 = (
                    self.journal_path.stat().st_size
                    if self.journal_path.exists() else 0
                )
                handles: Dict[int, Any] = {}
                for src, fpath in (
                    (_BASE, self.path), (_JOURNAL, self.journal_path),
                ):
                    try:
                        handles[src] = fpath.open("rb")
                    except OSError:
                        pass

            # Distinct tmp from _compact_locked's: phase 2 runs WITHOUT
            # the lock, and a synchronous compact() racing an in-flight
            # fold on one shared tmp path would interleave two writers
            # on the same inode (the compact's rename then installs the
            # fold's partial bytes as the live base).
            tmp = self.path.with_name(self.path.name + ".fold.tmp")
            h = sha1()
            new_index: Dict[str, Tuple[int, int, int]] = {}
            off = 0
            try:
                with tmp.open("wb") as out:
                    for cid, (src, loc_off, length) in snapshot:
                        if src == _PENDING:
                            continue  # not yet journaled: stays pending
                        f = handles.get(src)
                        if f is None:
                            continue
                        f.seek(loc_off)
                        e = _parse_entry(f.read(length))
                        if e is None:
                            continue
                        raw = (_entry_line(e) + "\n").encode("utf-8")
                        out.write(raw)
                        h.update(raw)
                        new_index[cid] = (_BASE, off, len(raw) - 1)
                        off += len(raw)
                    out.flush()
                    os.fsync(out.fileno())
            finally:
                for f in handles.values():
                    f.close()

            with self._lock:
                if self._structure_gen != gen:
                    tmp.unlink(missing_ok=True)   # state moved under us
                    return
                self._swap_fold_locked(tmp, h, new_index, j0, pre_fp)
        except Exception:
            logging.getLogger(__name__).exception("background fold failed")

    def _swap_fold_locked(self, tmp: Path, h, new_index, j0: int,
                          pre_fp: str) -> None:
        jp = self.journal_path
        tail = b""
        if jp.exists() and j0 >= 0:
            with jp.open("rb") as f:
                f.seek(j0)
                tail = f.read()
        st_tmp = tmp.stat()   # os.replace preserves size+mtime (inode)
        marker = (json.dumps(
            {"op": "base",
             "stat": [int(st_tmp.st_size), int(st_tmp.st_mtime_ns)]}
        ) + "\n").encode("utf-8")
        pp = self._pending_journal_path
        new_journal = (marker + tail) if tail else b""
        if new_journal:
            with pp.open("wb") as f:
                f.write(new_journal)
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, self.path)
        if new_journal:
            os.replace(pp, jp)
        else:
            jp.unlink(missing_ok=True)
            pp.unlink(missing_ok=True)
        try:
            dfd = os.open(str(self.path.parent), os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
        # Rewrite the in-memory index against the new locations; ids
        # deleted or re-journaled during the fold keep their CURRENT
        # state (tail offsets shift by marker_len - j0).
        shift = len(marker) - j0
        rebuilt: Dict[str, Tuple[int, int, int]] = {}
        for cid, (src, o, ln) in self._index.items():
            if src == _PENDING:
                rebuilt[cid] = (src, o, ln)
            elif src == _JOURNAL and o >= j0:
                rebuilt[cid] = (_JOURNAL, o + shift, ln)
            else:
                loc = new_index.get(cid)
                if loc is not None:
                    rebuilt[cid] = loc
        self._index = rebuilt
        self._cache.clear()
        self._base_sha = h.hexdigest()
        jh = sha1()
        jh.update(new_journal)
        self._journal_hash = jh
        self._sidecar_dirty = True
        self._save_sidecar()
        self._write_fold_alias(pre_fp, self.fingerprint())

    def _flush_pending_locked(self) -> None:
        if not self._pending and not self._pending_deletes:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        jp = self.journal_path
        off = jp.stat().st_size if jp.exists() else 0
        if off and not self._journal_has_marker():
            # Legacy journal (predates the base-binding marker): upgrade
            # it in place — rewrite with a marker bound to the CURRENT
            # base — so future foreign base rewrites are caught. Done at
            # mutation time, when journal bytes (and the fingerprint that
            # keys the store snapshot) change anyway.
            try:
                body = jp.read_bytes()
                marker = (json.dumps(
                    {"op": "base", "stat": list(_stat_key(self.path))}
                ) + "\n").encode("utf-8")
                tmp = jp.with_suffix(".jsonl.tmp")
                with tmp.open("wb") as f:
                    f.write(marker)
                    f.write(body)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, jp)
                h = sha1()
                h.update(marker)
                h.update(body)
                self._journal_hash = h
                # Journaled entries shifted by len(marker): fix offsets.
                self._index = {
                    cid: (
                        (src, o + len(marker), ln)
                        if src == _JOURNAL else (src, o, ln)
                    )
                    for cid, (src, o, ln) in self._index.items()
                }
                off += len(marker)
            except OSError:
                pass  # keep the legacy journal as-is; appends still work
        with jp.open("ab") as f:
            if off == 0:
                # Bind a fresh journal to the exact base it extends (see
                # _replay_journal): a later foreign rewrite of the base
                # invalidates these deltas instead of resurrecting them.
                marker = (json.dumps(
                    {"op": "base", "stat": list(_stat_key(self.path))}
                ) + "\n").encode("utf-8")
                f.write(marker)
                self._journal_hash.update(marker)
                off += len(marker)
            # Tombstones first: within one batch a pending upsert is
            # always the final live state for its id, so it must land
            # after any tombstone for the same id.
            for cid in self._pending_deletes:
                raw = (json.dumps({"id": cid, "op": "delete"},
                                  ensure_ascii=False) + "\n").encode("utf-8")
                f.write(raw)
                self._journal_hash.update(raw)
                off += len(raw)
            for cid, e in self._pending.items():
                raw = (_entry_line(e) + "\n").encode("utf-8")
                f.write(raw)
                self._journal_hash.update(raw)
                self._index[cid] = (_JOURNAL, off, len(raw) - 1)
                off += len(raw)
            f.flush()
            os.fsync(f.fileno())
        self._pending_deletes.clear()
        self._pending.clear()
        self._sidecar_dirty = True

    def _compact_locked(self) -> None:
        """Fold the journal into the base: stream every live entry to a
        tmp file in index order, atomically replace the base, drop the
        journal. Restores the single-file reference layout."""
        self._structure_gen += 1   # abort any in-flight background fold
        pre_fp = self.fingerprint()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".jsonl.tmp")
        h = sha1()
        new_index: Dict[str, Tuple[int, int, int]] = {}
        off = 0
        handles: Dict[int, Any] = {}
        try:
            with tmp.open("wb") as out:
                for cid, (src, loc_off, length) in self._index.items():
                    if src == _PENDING:
                        e = self._pending.get(cid)
                    else:
                        f = handles.get(src)
                        if f is None:
                            fp = (self.path if src == _BASE
                                  else self.journal_path)
                            try:
                                f = fp.open("rb")
                            except OSError:
                                continue
                            handles[src] = f
                        f.seek(loc_off)
                        e = _parse_entry(f.read(length))
                    if e is None:
                        continue
                    raw = (_entry_line(e) + "\n").encode("utf-8")
                    out.write(raw)
                    h.update(raw)
                    new_index[cid] = (_BASE, off, len(raw) - 1)
                    off += len(raw)
                # Compaction converts DURABLE journaled mutations (the
                # appends were fsync'd) into base bytes, then deletes the
                # journal — the new base must be on disk before the old
                # copy of the data goes away.
                out.flush()
                os.fsync(out.fileno())
        finally:
            for f in handles.values():
                f.close()
        os.replace(tmp, self.path)
        try:
            dfd = os.open(str(self.path.parent), os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
        # If we crash between the (synced) rename and this unlink, the
        # leftover journal carries a base-stat marker that no longer
        # matches the new base — _replay_journal discards it as stale.
        jp = self.journal_path
        if jp.exists():
            jp.unlink()
        self._index = new_index
        self._cache.clear()  # cached entries are re-read from new offsets
        self._base_sha = h.hexdigest()
        self._journal_hash = sha1()
        self._sidecar_dirty = True
        # Same logical content, new bytes: key the store's pre-fold
        # snapshot chain to the post-fold catalog.
        self._write_fold_alias(pre_fp, self.fingerprint())

    def compact(self) -> None:
        """Force-fold journal + pending into the base JSONL (immediate
        handoff to a reference stack, which reads only the base)."""
        with self._lock:
            self._flush_pending_locked()
            self._compact_locked()
            self._save_sidecar()

    # ------------------------------------------------------------------
    # Mutation
    # ------------------------------------------------------------------

    def upsert(self, entry: CatalogEntry) -> None:
        with self._lock:
            self._pending[entry.id] = entry
            self._index[entry.id] = (_PENDING, 0, 0)
            self._cache.pop(entry.id, None)

    def delete(self, ids: Sequence[str]) -> int:
        n = 0
        with self._lock:
            for cid in ids:
                if cid in self._index:
                    self._index.pop(cid)
                    self._cache.pop(cid, None)
                    self._pending.pop(cid, None)
                    # Always journal the tombstone: the id may also have
                    # an on-disk version the pending upsert shadowed.
                    self._pending_deletes.append(cid)
                    n += 1
        return n

    # ------------------------------------------------------------------
    # Lookup
    # ------------------------------------------------------------------

    def get(self, cid: str) -> Optional[CatalogEntry]:
        with self._lock:
            return self._fetch_locked(cid)

    def _fetch_locked(self, cid: str) -> Optional[CatalogEntry]:
        loc = self._index.get(cid)
        if loc is None:
            return None
        if loc[0] == _PENDING:
            return self._pending.get(cid)
        hit = self._cache.get(cid)
        if hit is not None:
            self._cache.move_to_end(cid)
            return hit
        src, off, length = loc
        fpath = self.path if src == _BASE else self.journal_path
        try:
            with fpath.open("rb") as f:
                f.seek(off)
                line = f.read(length)
        except OSError:
            return None
        e = _parse_entry(line)
        if e is None:
            return None
        self._cache[cid] = e
        if len(self._cache) > max(self.cache_entries, 1):
            self._cache.popitem(last=False)
        return e

    def __contains__(self, cid: str) -> bool:
        with self._lock:
            return cid in self._index

    def contains_many(self, cids: Sequence[str]) -> List[bool]:
        """Bulk membership under ONE lock acquisition — the store's
        cold-start validity recheck calls this for every row (1M ids in
        ~0.1 s vs ~1 s of per-call locking)."""
        with self._lock:
            idx = self._index
            return [cid in idx for cid in cids]

    def __len__(self) -> int:
        return len(self._index)

    @property
    def ids(self) -> List[str]:
        with self._lock:
            return list(self._index.keys())

    def ids_for_path(self, resolved_path: str) -> List[str]:
        """ids whose ``metadata.source_path`` equals ``resolved_path``.

        Raw-line regex scan instead of JSON-parsing every body (~10x at
        1M chunks — path-scoped admin ops like delete/reingest resolve
        against this): the unescaped pattern ``"source_path": "`` can
        only occur as a real KEY somewhere in the document (any
        occurrence inside a JSON string value has its quotes escaped) —
        but not necessarily the TOP-LEVEL metadata key (a nested object
        under metadata could carry one), and foreign writers may use
        different separators. So the regex tolerates any whitespace
        around the colon, zero matches mean "no such key anywhere" (safe
        to skip), and every candidate HIT is confirmed by a full parse
        of that one line — O(matches) parses, not O(corpus)."""
        pat = re.compile(rb'"source_path"\s*:\s*"((?:[^"\\]|\\.)*)"')
        out: List[str] = []
        with self._lock:
            snapshot = list(self._index.items())
            pending = dict(self._pending)
            handles: Dict[int, Any] = {}
            for src, fpath in (
                (_BASE, self.path), (_JOURNAL, self.journal_path),
            ):
                try:
                    handles[src] = fpath.open("rb")
                except OSError:
                    pass
        try:
            for cid, (src, off, length) in snapshot:
                if src == _PENDING:
                    e = pending.get(cid)
                    if e is not None and str(
                        e.metadata.get("source_path")
                    ) == resolved_path:
                        out.append(cid)
                    continue
                f = handles.get(src)
                if f is None:
                    continue
                f.seek(off)
                line = f.read(length)
                ms = pat.findall(line)
                if not ms:
                    continue  # no source_path key anywhere: cannot match
                hit = False
                for m in ms:
                    try:
                        val = json.loads('"' + m.decode("utf-8") + '"')
                    except (ValueError, UnicodeDecodeError):
                        continue
                    if val == resolved_path:
                        hit = True
                        break
                if not hit:
                    continue
                # Confirm the hit is the TOP-LEVEL metadata key (not a
                # same-named key inside a nested metadata value).
                e = _parse_entry(line)
                if e is not None and str(
                    e.metadata.get("source_path")
                ) == resolved_path:
                    out.append(cid)
        finally:
            for f in handles.values():
                f.close()
        return out

    def entries(self) -> Iterator[CatalogEntry]:
        """Stream live entries in first-seen order; full scans do NOT
        populate (or evict) the hot-id LRU cache."""
        for _, e in self.items():
            yield e

    def items(self) -> Iterator[Tuple[str, CatalogEntry]]:
        # Snapshot the index, the pending dict AND the file handles under
        # ONE lock hold: a concurrent save() may compact (os.replace the
        # base + unlink the journal) mid-iteration, and offsets snapshotted
        # against the OLD files are garbage against the new ones. Handles
        # opened here keep the old inodes alive (POSIX), so the iteration
        # reads the exact point-in-time state the snapshot indexed —
        # entries can't be silently skipped (the old lazy open re-resolved
        # the path post-compaction and mis-seeked).
        with self._lock:
            snapshot = list(self._index.items())
            pending = dict(self._pending)
            handles: Dict[int, Any] = {}
            for src, fpath in (
                (_BASE, self.path), (_JOURNAL, self.journal_path),
            ):
                try:
                    handles[src] = fpath.open("rb")
                except OSError:
                    pass
        try:
            for cid, (src, off, length) in snapshot:
                if src == _PENDING:
                    e = pending.get(cid)
                    if e is not None:
                        yield cid, e
                    continue
                f = handles.get(src)
                if f is None:
                    continue
                f.seek(off)
                e = _parse_entry(f.read(length))
                if e is not None:
                    yield cid, e
        finally:
            for f in handles.values():
                f.close()
