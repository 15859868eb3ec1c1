"""Shared pieces of the benchmark's CPU tests: small configurations of the
benchmark's cells, proved once a test run into a temporary cache."""

import json
import time
from pathlib import Path

import pytest

from benchmark import harness

SPEC = json.loads((Path(harness.__file__).parent.parent
                   / "BENCHMARK.json").read_text())

SMALL = {"log_steps": 9, "num_constants": 64, "power": 3, "fri_queries": 40,
         "spot_checks": 80, "strict": False}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips where there is none")


def small_cell(workload: str, blk: dict | None = None) -> dict:
    """The cell's entries with a 2^9-step statement and a mix whose block
    of 8 is one chunk: each window of one chunk holds every kind.  Its few
    flips land in witnesses and siblings, which only the Merkle walks check
    (the reference's tests flip every site)."""
    c = harness.cell_of(SPEC, workload)
    cfg = dict(SMALL, name="small_" + c["config"]["name"],
               statement=c["config"]["statement"])
    if cfg["statement"] == "runtime":
        cfg["inputs"] = [3, 4, 5, 6]
        block = {"honest": 3, "flip": 3, "wrong_output": 1,
                 "other_statement": 1}
    else:
        cfg["input"] = 3
        block = {"honest": 3, "flip": 2, "truncated": 1, "empty": 1,
                 "small_family": 1}
    tr = dict(c["traffic"], chunk=8, batch=8, threads=2, warm_chunks=1,
              warm_batches=1, warm_calls=1, ring=8, block=blk or block,
              small_family_log_steps=7, reference_sample=64,
              flip_sites=["main_witness", "col_sibling", "lincomb_sibling"],
              trace_seconds=0.1)
    return dict(c, config=cfg, traffic=tr)


@pytest.fixture(scope="session")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("proofs")


@pytest.fixture(scope="session")
def run_small(cache):
    """run_small(workload, seed, trace=False, seconds=0.05, block=None) ->
    the result of a run of the small cell on the CPU (its own block of
    requests where given), its window one chunk or a few calls long."""
    def run(workload, seed, trace=False, seconds=0.05, block=None):
        return harness.run_cell(workload, seed, seconds, trace,
                                t_start=time.perf_counter(), device="cpu",
                                cell=small_cell(workload, block), cache=cache,
                                workers=2)
    return run
