"""The port stands alone: it imports neither JAX nor the JAX package, and
a default-device call without CUDA raises instead of running on the CPU.
Both checks run in a fresh interpreter."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_HOOK = textwrap.dedent("""
    import importlib.abc, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "classmate_rag_tpu"):
                raise ImportError(f"the port must not import {name}")
            return None

    sys.meta_path.insert(0, Refuse())
""")


def _run(code, **env):
    return subprocess.run(
        [sys.executable, "-c", _HOOK + textwrap.dedent(code)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT), **env},
    )


def test_port_imports_and_queries_without_jax():
    proc = _run("""
        import importlib, pkgutil
        import numpy as np
        import classmate_rag_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke  # the chip script imports no JAX either
        from classmate_rag_tpu_torch.index.store import IndexStore
        rng = np.random.default_rng(0)
        emb = rng.standard_normal((50, 16)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        s = IndexStore(16, slab_rows=64, terms_per_chunk=8, device="cpu")
        s.upsert([f"c{i}" for i in range(50)], emb,
                 [["alpha", "beta"][: 1 + i % 2] for i in range(50)],
                 [{"course": "x"}] * 50)
        out = s.hybrid_topk_batch(emb[:2], [["alpha"], []])
        assert (out.rows >= 0).all(), out.rows
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "classmate_rag_tpu"))
        assert not loaded, loaded
        print("modules", len(names))
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "modules" in proc.stdout


def test_default_device_without_cuda_raises():
    proc = _run("""
        import numpy as np
        import torch
        assert not torch.cuda.is_available()
        from classmate_rag_tpu_torch.index.store import IndexStore
        from classmate_rag_tpu_torch.device import resolve_device
        for call in (lambda: IndexStore(8), lambda: resolve_device(None),
                     lambda: resolve_device("cuda")):
            try:
                call()
            except RuntimeError as e:
                assert "CUDA" in str(e)
            else:
                raise SystemExit("default device ran without CUDA")
        assert resolve_device("cpu").type == "cpu"
        print("raised")
    """, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "raised" in proc.stdout
