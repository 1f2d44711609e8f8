"""The benchmark's definitions, found by name: ``BENCHMARK.json`` at the
root of the checkout names each cell's configuration and traffic mix,
whose files are ``configs/<config>.json`` and ``traffic/<traffic>.json``;
the configuration's ``"kind"`` (``hybrid`` where it has none) names the
module ``kinds/<kind>.py`` that sets up, drives and checks the cell; a
cell's correctness limits are ``limits/<cell>.json``; a metric's reader
is ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parent
CHECKOUT = BENCH_DIR.parent
DEFAULT_KIND = "hybrid"


def load_json(path: Path) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    kind: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_kind(name: str) -> ModuleType:
    """The kind module ``rag_bench.kinds.<name>`` (``kinds/__init__.py``
    states what it provides)."""
    if not name.isidentifier():
        raise ValueError(f"kind {name!r} is not a module name")
    return importlib.import_module(f"rag_bench.kinds.{name}")


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, checkout: Path = CHECKOUT) -> Cell:
    """The cell ``name`` of ``checkout``'s BENCHMARK.json, with its files
    read and the metrics it reports."""
    bench = load_json(checkout / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    (w,) = found
    (cfg_entry,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    config = load_json(checkout / cfg_entry["file"])
    kind = config.get("kind", DEFAULT_KIND)
    load_kind(kind)
    return Cell(
        name=name,
        config_name=w["config"],
        traffic_name=w["traffic"],
        chips=int(w["chips"]),
        kind=kind,
        config=config,
        traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )
