"""Shared helpers of the benchmark's tests: a cell of BENCHMARK.json cut
to a size the CPU runs in seconds (rows, batch, pool and sample only;
every width and retrieval setting stays)."""

import copy
import dataclasses
import time

import pytest

from rag_bench import spec

CELLS = ("msmarco-1m.hybrid-b256", "trec-covid-171k.hybrid-b256")
# A course filter is not a cell of BENCHMARK.json (no source gives the
# number of courses an index holds): its case here is the TREC-COVID
# cell under the ``course-b256`` traffic over 20 courses, so that the
# generator's filter path, the reference's masked query and the judge's
# filter checks stay tested for a later cell.
COURSE = "trec-covid-171k.course-b256"
CASES = CELLS + (COURSE,)


def load_case(name: str) -> spec.Cell:
    if name != COURSE:
        return spec.load_cell(name)
    cell = spec.load_cell("trec-covid-171k.hybrid-b256")
    return dataclasses.replace(
        cell, name=COURSE, traffic_name="course-b256",
        config=dict(cell.config, courses=20),
        traffic=spec.load_json(spec.BENCH_DIR / "traffic" / "course-b256.json"))


def tiny(name: str, rows: int = 3000, batch: int = 16, pool: int = 2,
         sample: int = 24, **retrieval):
    cell = load_case(name)
    cfg = copy.deepcopy(cell.config)
    cfg["passages"] = rows
    cfg["retrieval"].update(retrieval)
    return dataclasses.replace(
        cell, config=cfg,
        traffic=dict(cell.traffic, batch=batch, pool_batches=pool),
        limits=dict(cell.limits, sample=sample))


SEED = 2**33 + 7


def run_tiny(cell, seed=SEED, trace=False, control=False,
             seconds=0.2):
    from rag_bench import run

    return run.run_cell(cell, seed, seconds, trace, "cpu",
                        time.perf_counter(), control=control)


@pytest.fixture
def tiny_cell():
    return tiny
