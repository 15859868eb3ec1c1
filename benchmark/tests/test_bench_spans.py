"""The readers of the port's spans on the CPU: each gives a number in a
traced run of each of its cells at 2^9 steps, and nothing, without
raising, where the port keeps no spans."""

import pytest

from benchmark import harness
from benchmark.tests.conftest import SPEC, small_cell

SPAN_METRICS = [m for m in SPEC["per_layer"] if m["source"] == "program_span"]
CELLS = sorted({w for m in SPAN_METRICS for w in m["workloads"]})


@pytest.mark.parametrize("workload", CELLS)
def test_each_span_reader_reads_its_cells_traced_run(run_small, workload):
    # the single cell's traced window holds one call: one that parses
    block = {"honest": 4, "flip": 4} if workload.endswith(".single") else None
    r = run_small(workload, 2**31 + 777, trace=True, block=block)
    assert r["failed"] == 0, r["checks"]
    want = {m["name"] for m in SPAN_METRICS if workload in m["workloads"]}
    got = {n: v["value"] for n, v in r["metrics"].items() if n in want}
    assert set(got) == want
    assert all(v > 0 for v in got.values()), got
    assert all(r["metrics"][n]["unit"] == "ms/proof" for n in want)


def test_a_port_without_spans_reads_nothing(run_small, monkeypatch):
    """The parent of the spans' change runs these readers too: they find
    nothing to read there and give nothing."""
    from stark_verifier_tpu_torch import profiling
    monkeypatch.delattr(profiling, "spans")
    r = run_small("mimc13_fixed.stream", 2**31 + 778, trace=True)
    assert r["correct"], r["checks"]
    assert not {m["name"] for m in SPAN_METRICS} & set(r["metrics"])
    assert "device_idle.throughput" not in r["metrics"]    # no card here
    assert harness.load_module("metrics", "glue_kernels_per_proof.throughput")


def test_the_readers_are_found_by_their_full_names():
    for m in SPAN_METRICS:
        mod = harness.load_module("metrics", m["name"])
        assert callable(mod.read)
    assert small_cell(CELLS[0])["per_layer"]
