"""Build (once) a persisted product index for load and serve tests.

Uses the port bench's product corpus function
(``classmate_rag_tpu_torch.bench._build_product_corpus``), so the layout
on disk is the one the bench's product stage measures; a directory saved
by either package loads in the other.

    python -m classmate_rag_tpu_torch.tools.build_product_index DIR \\
        [--rows 1000000] [--device cpu]

Then point ``INDEX_DIR=DIR BM25_DIR=DIR/bm25 DENSE_DIR=DIR/dense`` at it.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from classmate_rag_tpu_torch.device import DeviceLike, resolve_device


def build(root: str | Path, rows: int, device: DeviceLike = None) -> dict:
    """Build ``rows`` chunks into ``root`` (bm25/, dense/); the report."""
    from classmate_rag_tpu_torch.bench import _build_product_corpus

    dev = resolve_device(device)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    secs = _build_product_corpus(root, rows, device=dev)
    return {"root": str(root), "rows": rows, "seconds": round(secs, 3),
            "wall_s": round(time.perf_counter() - t0, 3),
            "bytes": sum(p.stat().st_size for p in root.rglob("*")
                         if p.is_file())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    out = build(args.root, args.rows, args.device)
    print(f"built {args.rows} rows at {args.root} in {out['seconds']:.1f}s",
          flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
