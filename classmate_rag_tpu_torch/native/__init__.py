"""ctypes bindings for the native host kernels, with the pure-Python
path as the fallback (port of the JAX package's ``native/__init__.py``).

``csrc/classmate_native.cpp`` (the port's own copy of the C++) builds
at first use, never at import:

    g++ -O3 -std=c++17 -shared -fPIC -o build/libclassmate_native-<hash>.so \\
        csrc/classmate_native.cpp

The library's name carries a hash of the source and the flags, so a
library built from another source is never loaded, and the build writes
a temporary file renamed into place, so processes building at once
(test workers) never load a half-written one. Every entry point has
the semantics of its Python twin in ``index/lexical.py``
(``tokenize_py``, ``pack_tokens``; tests/test_torch_native.py fuzzes
them against each other): without a compiler the Python path runs and
gives the same results.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc" / "classmate_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.RLock()  # reentrant: get_native_tokenizer → _load
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def lib_path() -> Path:
    """Where the library of the current source lives (hash-named)."""
    digest = hashlib.sha1(CSRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libclassmate_native-{digest.hexdigest()[:12]}.so"


def _ensure_built() -> Optional[Path]:
    """The library's path, built now if missing; None when it cannot be
    built here (no g++, or the compiler failed)."""
    out = lib_path()
    if out.exists():
        return out
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
    except OSError:
        return None
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(CSRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        Path(tmp).unlink(missing_ok=True)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = _ensure_built()
        if path is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _load_failed = True
            return None
        _declare_symbols(lib)
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is loaded (building it if needed)."""
    return _load() is not None


def _declare_symbols(lib: ctypes.CDLL) -> None:
    lib.tokenizer_create.restype = ctypes.c_void_p
    lib.tokenizer_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
    ]
    lib.tokenizer_destroy.argtypes = [ctypes.c_void_p]
    lib.tokenize_join.restype = ctypes.c_int64
    lib.tokenize_join.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.packer_create.restype = ctypes.c_void_p
    lib.packer_create.argtypes = []
    lib.packer_destroy.argtypes = [ctypes.c_void_p]
    lib.packer_vocab_size.restype = ctypes.c_int32
    lib.packer_vocab_size.argtypes = [ctypes.c_void_p]
    lib.packer_pack_batch.restype = ctypes.c_int32
    lib.packer_pack_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.packer_export_terms.restype = ctypes.c_int64
    lib.packer_export_terms.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.packer_import_terms.restype = ctypes.c_int32
    lib.packer_import_terms.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
    ]


class NativeTokenizer:
    """BM25 tokenizer backed by the C++ kernel."""

    def __init__(self, stop_en: List[str], stop_it: List[str]) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib

        def arr(words: List[str]):
            encoded = [w.encode("utf-8") for w in words]
            a = (ctypes.c_char_p * len(encoded))(*encoded)
            return a, encoded  # keep the bytes alive

        en_arr, self._keep_en = arr(stop_en)
        it_arr, self._keep_it = arr(stop_it)
        self._handle = lib.tokenizer_create(
            en_arr, len(stop_en), it_arr, len(stop_it)
        )
        self._buf_cap = 1 << 16
        self._buf = ctypes.create_string_buffer(self._buf_cap)
        # One shared instance serves the server's handler threads: the
        # output buffer and its grow-and-retry swap must not interleave
        # (a thread pairing the old small buffer with the new capacity
        # would let C write past its end).
        self._buf_lock = threading.Lock()

    def __del__(self) -> None:  # pragma: no cover - interpreter teardown
        try:
            if getattr(self, "_handle", None):
                self._lib.tokenizer_destroy(self._handle)
        except Exception:
            pass

    def tokenize(self, text: str, lang: Optional[str] = None) -> List[str]:
        data = (text or "").encode("utf-8")
        lang_it = 1 if (lang or "").lower().startswith("it") else 0
        with self._buf_lock:
            n = self._lib.tokenize_join(
                self._handle, data, len(data), lang_it,
                self._buf, self._buf_cap,
            )
            if n < 0:  # grow and retry
                self._buf_cap = max(self._buf_cap * 2, -n + 1)
                self._buf = ctypes.create_string_buffer(self._buf_cap)
                n = self._lib.tokenize_join(
                    self._handle, data, len(data), lang_it,
                    self._buf, self._buf_cap,
                )
                if n < 0:
                    raise RuntimeError("native tokenize buffer error")
            if n == 0:
                return []
            return self._buf.raw[:n].decode("utf-8").split(" ")


class NativePacker:
    """Batch term-frequency packer and vocabulary interner (C++ kernel).

    Owns the authoritative term → id interner; ``pack_batch`` mirrors
    newly created terms into the caller's dict, so lookups through
    ``store.vocab`` work unchanged. Packing equals ``lexical.pack_tokens``
    bit for bit."""

    def __init__(self) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._handle = lib.packer_create()

    def __del__(self) -> None:  # pragma: no cover - interpreter teardown
        try:
            if getattr(self, "_handle", None):
                self._lib.packer_destroy(self._handle)
        except Exception:
            pass

    def pack_batch(self, tokens_list, vocab: dict, width: int):
        """Pack a batch of token lists → (term_ids [B, W] i32, tfs [B, W]
        u8, doc_len [B] f32), interning into the shared vocabulary and
        extending ``vocab`` with any new terms.

        Returns None (the caller takes the Python path) when a token
        holds the ' ' / '\\n' separators or is empty: impossible for the
        tokenizer's output, possible for tokens a caller supplies."""
        import numpy as np

        try:
            docs = []
            for tokens in tokens_list:
                joined = " ".join(tokens)
                if "\n" in joined:
                    return None
                docs.append(joined)
            # The C++ splitter would drop empty tokens that pack_tokens
            # counts, and split tokens holding a space: both fall back.
            for tokens, joined in zip(tokens_list, docs):
                n = len(tokens)
                if n and (not joined or joined.count(" ") != n - 1
                          or joined[0] == " " or joined[-1] == " "
                          or "  " in joined):
                    return None
            blob = "\n".join(docs).encode("utf-8")
        except TypeError:
            return None

        b = len(tokens_list)
        term_ids = np.empty((b, width), dtype=np.int32)
        tfs = np.empty((b, width), dtype=np.uint8)
        doc_len = np.empty(b, dtype=np.float32)
        rc = self._lib.packer_pack_batch(
            self._handle, blob, len(blob), b, width,
            term_ids.ctypes.data_as(ctypes.c_void_p),
            tfs.ctypes.data_as(ctypes.c_void_p),
            doc_len.ctypes.data_as(ctypes.c_void_p),
        )
        if rc != 0:
            return None
        self._sync_vocab(vocab)
        return term_ids, tfs, doc_len

    def _sync_vocab(self, vocab: dict) -> None:
        n_native = self._lib.packer_vocab_size(self._handle)
        start = len(vocab)
        if n_native <= start:
            return
        cap = 1 << 20
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.packer_export_terms(self._handle, start, buf, cap)
            if n >= 0:
                break
            cap = -n + 1
        new_terms = buf.raw[:n].decode("utf-8").split("\n") if n else []
        for i, term in enumerate(new_terms):
            vocab[term] = start + i

    def vocab_size(self) -> int:
        return int(self._lib.packer_vocab_size(self._handle))

    def import_vocab(self, vocab: dict) -> bool:
        """Seed a fresh packer from a restored vocab (terms appended in
        id order, so both interners agree). False on failure."""
        if self.vocab_size() != 0:
            return False
        terms = sorted(vocab, key=vocab.__getitem__)
        if any("\n" in t for t in terms):
            return False
        blob = "\n".join(terms).encode("utf-8")
        n = self._lib.packer_import_terms(self._handle, blob, len(blob))
        return n == len(vocab)


def make_native_packer() -> Optional[NativePacker]:
    """A fresh packer (one per IndexStore), or None."""
    try:
        return NativePacker()
    except (RuntimeError, OSError):
        return None


_tokenizer: Optional[NativeTokenizer] = None
_tokenizer_failed = False


def get_native_tokenizer() -> Optional[NativeTokenizer]:
    """The shared tokenizer, or None when the library is unavailable."""
    global _tokenizer, _tokenizer_failed
    if _tokenizer is not None or _tokenizer_failed:
        return _tokenizer
    with _lock:
        if _tokenizer is not None or _tokenizer_failed:
            return _tokenizer
        from classmate_rag_tpu_torch.index.lexical import (
            STOPWORDS_EN,
            STOPWORDS_IT,
        )

        try:
            _tokenizer = NativeTokenizer(
                sorted(STOPWORDS_EN), sorted(STOPWORDS_IT)
            )
        except (RuntimeError, OSError):
            _tokenizer_failed = True
    return _tokenizer


__all__ = [
    "NativePacker",
    "NativeTokenizer",
    "available",
    "get_native_tokenizer",
    "lib_path",
    "make_native_packer",
]
