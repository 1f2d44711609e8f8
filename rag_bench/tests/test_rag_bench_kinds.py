"""A cell of a new kind is added with new files and BENCHMARK.json entries
alone: a copy of the benchmark gains a toy kind (its program built in
set-up, its loop, its plain reference, configuration, traffic, limits and
reader), runs the cell through the copy's own harness on the CPU, and
leaves every file the benchmark had as it was."""

import filecmp
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from rag_bench import spec

CELL = "toy-linear.toy-mix"
READER = "toy_flops_per_s"

NEW_FILES = {
    "kinds/toy.py": '''
"""A toy kind: the program is a linear map whose weights, drawn from the
seed with the inputs, are packed on the device in set-up."""

import torch

from rag_bench.reference.toy import answer

CONTROL = None


class Program:
    def __init__(self, weight, device):
        self.packed = weight.t().contiguous().to(device)

    def forward(self, x):
        return torch.nn.functional.linear(x, self.packed)


class Run:
    def __init__(self, cell, seed, device):
        width, batch = int(cell.config["width"]), int(cell.traffic["batch"])
        g = torch.Generator().manual_seed(seed % 2**63)
        self.cell, self.device = cell, device
        self.weight = torch.randn(width, width, generator=g) / width ** 0.5
        self.pool = [torch.randn(batch, width, generator=g).to(device)
                     for _ in range(int(cell.traffic["pool_batches"]))]
        self.program = None
        self.info = {"width": width}

    def build(self, mark):
        self.program = Program(self.weight, self.device)
        mark("weights")
        for x in self.pool:
            self.program.forward(x)

    def drive(self, loop, seconds):
        return loop.drive(self.program, self.pool, seconds)

    def free(self):
        self.program = None

    def check(self, window, control):
        gap = 0.0
        for s in window.served:
            if s.out is not None:
                want = answer(self.weight.numpy(), self.pool[s.pool].numpy())
                gap = max(gap, float(abs(s.out - want).max()))
        limit = float(self.cell.limits["max_abs_gap"])
        ok = bool(window.served) and window.failed == 0 and gap <= limit
        return ok, {"max_abs_gap": {"value": gap, "limit": limit}}, None

    def values(self):
        return {"width": int(self.cell.config["width"])}
''',
    "reference/toy.py": '''
"""The toy kind's plain reference: the linear map in float64."""

import numpy as np


def answer(weight, x):
    return np.asarray(x, np.float64) @ np.asarray(weight, np.float64)
''',
    "loops/toyloop.py": '''
"""The toy kind's loop: the pool in turn, one batch a call."""

import time

from rag_bench.window import Served, Window


def drive(program, pool, seconds):
    win = Window()
    end = time.perf_counter_ns() + int(seconds * 1e9)
    i = 0
    while True:
        x = pool[i % len(pool)]
        t0 = time.perf_counter_ns()
        y = program.forward(x)
        t1 = time.perf_counter_ns()
        out = y.cpu().numpy()
        t2 = time.perf_counter_ns()
        win.served.append(Served(i % len(pool), t0, t1, t2, len(x), out))
        i += 1
        if t2 >= end:
            return win
''',
    f"metrics/{READER}.py": '''
"""The toy map's FLOP over the window's seconds."""


def read(ctx):
    w = ctx.window
    if not w.seconds:
        return None
    return sum(2.0 * s.queries * ctx.width ** 2 for s in w.served) / w.seconds
''',
    "configs/toy-linear.json": json.dumps({"kind": "toy", "width": 64}),
    "traffic/toy-mix.json": json.dumps(
        {"loop": "toyloop", "clients": 1, "batch": 8, "pool_batches": 3}),
    f"limits/{CELL}.json": json.dumps({"max_abs_gap": 1e-4}),
}

ENTRIES = {
    "configs": {"name": "toy-linear", "source": "a toy for the harness's test",
                "file": "rag_bench/configs/toy-linear.json", "reduced": [],
                "why": "a linear map of width 64"},
    "workloads": {"name": CELL, "config": "toy-linear",
                  "traffic": "toy-mix", "chips": 1,
                  "why": "batches of 8 rows through the toy map"},
    "per_layer": {"name": READER, "unit": "FLOP/s", "better": "higher",
                  "source": "host_clock", "layer": "toy", "moves": "query_qps",
                  "workloads": [CELL]},
}

_RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
from rag_bench import run, spec
assert run.__file__.startswith({root!r}), run.__file__
cell = spec.load_cell({cell!r})
if {fault!r}:
    from rag_bench.kinds import toy
    forward = toy.Program.forward

    def altered(self, x):
        y = forward(self, x)
        y[0, 0] += 1.0
        return y

    toy.Program.forward = altered
out = []
for trace in (False, True):
    res = run.run_cell(cell, 2**33 + 11, 0.3, trace, "cpu",
                       time.perf_counter(), control=True)
    info = res.pop("info")          # to standard error, not in the line
    out.append(dict(keys=list(res), info=info, res=res))
print(json.dumps(out))
"""

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(spec.BENCH_DIR, root / "rag_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.CHECKOUT / "BENCHMARK.json", root / "BENCHMARK.json")
    for rel, text in NEW_FILES.items():
        path = root / "rag_bench" / rel
        assert not path.exists(), rel
        path.write_text(text.lstrip())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for key, entry in ENTRIES.items():
        bench[key].append(entry)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def _run(root: Path, fault: bool):
    proc = subprocess.run(
        [sys.executable, "-c",
         _RUN.format(root=str(root), cell=CELL, fault=fault)],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def sound(copy):
    return _run(copy, fault=False)


def test_new_kind_runs_through_the_harness(sound):
    plain, traced = sound
    for r in (plain, traced):
        # No control (the toy's CONTROL is None), no device trace here.
        assert r["keys"] == KEYS
        assert r["res"]["correct"], r["res"]["checks"]
        assert set(r["res"]["checks"]) == {"max_abs_gap"}
        assert r["res"]["attempted"] >= 8 and r["res"]["failed"] == 0
        assert r["info"]["width"] == 64
        phases = r["info"]["setup_phases_end_s"]
        assert phases["inputs"] < phases["weights"] <= phases["warm_up"]
    assert set(plain["res"]["metrics"]) == {"query_qps", "setup_s"}
    assert plain["res"]["metrics"]["query_qps"]["value"] > 0
    assert set(traced["res"]["metrics"]) == {READER}
    assert traced["res"]["metrics"][READER]["value"] > 0


def test_new_kind_fault_is_not_correct(copy):
    for r in _run(copy, fault=True):
        assert not r["res"]["correct"]
        assert r["res"]["checks"]["max_abs_gap"]["value"] > 0.5


def test_new_kind_leaves_the_benchmark_files_as_they_were(copy, sound):
    ours = [p.relative_to(spec.BENCH_DIR) for p in spec.BENCH_DIR.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts]
    assert ours
    for rel in ours:
        assert filecmp.cmp(spec.BENCH_DIR / rel, copy / "rag_bench" / rel,
                           shallow=False), rel
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    for key, entry in ENTRIES.items():
        assert bench[key].pop() == entry
    assert bench == spec.load_json(spec.CHECKOUT / "BENCHMARK.json")
