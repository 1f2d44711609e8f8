"""The readings the correctness limits are set from, in one process:

    python3 -m rag_bench.calibrate --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, one run of the cell as ``run.py`` makes it (the cell's own
sizes and load, a window of ``--seconds``), then the program's numbers
and the control's, both from the cell's kind (``kinds/<kind>.py``: its
``check`` and its ``CONTROL``, for ``hybrid`` the reference one precision
step lower put in the program's place and judged the same way). A kind
without a control gets ``"control": null`` and a note on standard
error. One JSON line a seed. The benchmark's own runs never run the
control. Like a run of the benchmark, it needs a CUDA card: without one
it exits 2 and prints nothing.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from rag_bench import run, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"rag_bench: {args.workload} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    control = spec.load_kind(cell.kind).CONTROL
    print(f"rag_bench: control of the kind {cell.kind}: {control}",
          file=sys.stderr)
    t0 = _T0
    for seed in args.seeds:
        res = run.run_cell(cell, seed, args.seconds, False, "cuda:0", t0,
                           control=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": res["correct"],
            "program": {k: v["value"] for k, v in res["checks"].items()},
            "control": res.get("control"),
            "limits": {k: v["limit"] for k, v in res["checks"].items()},
            "info": res["info"],
        }), flush=True)
        gc.collect()
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
