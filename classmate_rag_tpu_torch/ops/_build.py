"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each ``ops/csrc/<name>.cu`` compiles on its own into a shared library
with a plain C interface, for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and of the shared
headers (``csrc/*.cuh``, included by the sources), so an edited kernel
or header rebuilds and an unchanged one loads from ``ops/build/``.
Nothing builds when a module is imported: the first launch builds, or
``build_all`` builds every source at once (one nvcc process each, all
started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives: named by a hash of
    the source, every shared header (``csrc/*.cuh``) and the flags, so an
    edit to any of them builds anew."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start one nvcc; returns (process, tmp output path, final path)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _lib_path(name)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, Path(tmp), out


def _finish(name: str, proc, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees old or new
    out.with_suffix(".log").write_text(log)
    return log


def build_all() -> Dict[str, str]:
    """Build every missing library in parallel; returns each source's
    ptxas report (registers, shared memory, spills), a cached library's
    from the log saved beside it ("" if there is none)."""
    with _lock:
        todo = [n for n in sources() if not _lib_path(n).exists()]
        started = [(n, *_start(n)) for n in todo]
        logs = {}
        for n in sources():
            saved = _lib_path(n).with_suffix(".log")
            logs[n] = saved.read_text() if saved.exists() else ""
        for n, proc, tmp, out in started:
            logs[n] = _finish(n, proc, tmp, out)
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        path = _lib_path(name)
        if not path.exists():
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
        return lib
