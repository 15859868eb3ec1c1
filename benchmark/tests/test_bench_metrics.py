"""The harness's arithmetic on the CPU: rates and percentiles over all
requests of a window, the device's idle share as the union of overlapping
intervals, the split of device kernels into the port's own and the glue,
reading a real profiler's events, and finding each cell's files by name."""

import os
import statistics
import threading

import pytest

from benchmark import cores, harness, mix, trace as T, window
from benchmark.tests.conftest import SPEC, small_cell


def test_rate_is_all_the_work_over_all_the_time():
    assert window.rate(3000, 1.5) == 2000.0
    with pytest.raises(ValueError):
        window.rate(1, 0)


def test_percentiles_over_all_requests():
    xs = list(range(1, 101))
    assert window.percentile(xs, 50) == statistics.median(xs)
    assert window.percentile(xs, 95) == pytest.approx(95.05)
    assert window.percentile([7.0], 95) == 7.0
    # order does not matter, every request counts
    assert window.percentile(list(reversed(xs)) + [1000], 50) == 51
    with pytest.raises(ValueError):
        window.percentile([], 50)


def test_idle_share_is_the_union_of_overlapping_intervals():
    ops = [("a", 0, 40), ("b", 10, 30), ("c", 35, 50), ("Memcpy HtoD", 80, 90)]
    t = T.Traced((0, 100), ops)
    # covered: [0, 50) and [80, 90) = 60 of 100, not the 85 a sum would give
    assert T.busy_ns(ops) == 60
    assert T.idle_share(t) == pytest.approx(40.0)
    assert T.gaps(t) == [(50, 80), (90, 100)]


def test_glue_and_own_kernels_split():
    ops = [("void stark_walk_groups_kernel<0>(WalkGroup const*, int)", 0, 5),
           ("stark_spot_kernel", 5, 8),
           ("void at::native::vectorized_elementwise_kernel<4>(int)", 8, 9),
           ("void at::native::index_elementwise_kernel<128, 4>(int)", 9, 10),
           ("Memcpy HtoD (Pinned -> Device)", 10, 20),
           ("Memset (Device)", 20, 21)]
    t = T.Traced((0, 30), ops, requests=2)
    assert T.glue_kernels(t) == 2
    assert T.own_kernel_ns(t) == 8
    assert [T.is_own(n) for n, _, _ in ops] == [True, True, False, False,
                                               False, False]


def test_breakdown_names_gaps_by_the_host_op_running():
    ops = [("k", 10, 20), ("void stark_x(int)", 60, 70)]
    host = [("aten::add", 0, 30), ("cudaLaunchKernel", 5, 8),
            ("ingest", 30, 55)]
    b = T.breakdown(T.Traced((0, 100), ops, host))
    assert dict(b["device_ops"]) == pytest.approx({"k": 1e-8,
                                                   "void stark_x(int)": 1e-8})
    # gaps: [0, 10) mid 5 -> cudaLaunchKernel, [20, 60) mid 40 -> ingest,
    # [70, 100) mid 85 -> no host op
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"cudaLaunchKernel": 1e-8, "ingest": 4e-8, "python": 3e-8})


def test_reads_a_real_profile():
    import torch
    tr = T.Tracer(True)
    tr.start()
    x = torch.arange(1000) * 3 + 1
    assert int(x[-1]) == 2998
    tr.stop(requests=1)
    t = tr.traced
    assert t.window[1] > t.window[0] and t.requests == 1
    assert any(n.startswith("aten::") for n, _, _ in t.host)
    assert T.Tracer(False).traced is None


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_the_harness_finds_each_cells_files_by_name(workload):
    c = harness.cell_of(SPEC, workload)
    assert c["config"]["name"] == c["workload"]["config"]
    harness.load_module("drivers", c["traffic"]["driver"]).drive
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s"}
    assert c["per_layer"]
    for m in c["end_to_end"]:
        assert callable(harness.load_module("end_to_end", m["name"]).read)
    for m in c["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
        assert m["moves"] in {e["name"] for e in c["end_to_end"]}


def test_a_split_metric_reads_from_its_base_file():
    lat = harness.load_module("metrics", "device_idle.latency")
    assert lat is harness.load_module("metrics", "device_idle.throughput")
    assert lat.__file__.endswith("device_idle.py")
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric.latency")


def test_request_kinds_are_found_by_name():
    assert mix.kind("honest").key(("honest", 2, 5, 0)) == ("honest", 2, 0, 0)
    assert mix.content_key(("flip", 1, 77, 3)) == ("flip", 1, 77, 3)
    assert not mix.shares_content(("flip", 1, 77, 3))
    with pytest.raises(FileNotFoundError):
        mix.kind("ragged")


def test_a_strict_configuration_is_refused():
    """The reference judges only the non-strict verifier."""
    c = small_cell("mimc13_fixed.stream")
    c["config"]["strict"] = True
    with pytest.raises(ValueError, match="non-strict"):
        harness.run_cell("mimc13_fixed.stream", 1, 0.05, False, t_start=0.0,
                         device="cpu", cell=c)


def test_the_launching_thread_gets_a_core_of_its_own():
    c = cores.Cores()
    if c.launch is None:
        pytest.skip("fewer than two cores")
    assert c.launch.isdisjoint(c.rest) and len(c.rest) >= 1
    go, seen = threading.Event(), {}

    def other():
        go.wait()
        seen["before"] = os.sched_getaffinity(0)

    t = threading.Thread(target=other)
    t.start()
    try:
        c.bind()
        assert os.sched_getaffinity(0) == c.launch
        go.set()
        t.join()
        assert seen["before"] == c.rest
        with c.spawning():
            t2 = threading.Thread(
                target=lambda: seen.update(spawned=os.sched_getaffinity(0)))
            t2.start()
            t2.join()
        assert seen["spawned"] == c.rest
        assert os.sched_getaffinity(0) == c.launch
    finally:
        c.release()
    assert os.sched_getaffinity(0) == c.all


@pytest.mark.card
def test_a_traced_run_on_the_card():
    """A short traced run of the stream cell on the card: the trace holds
    the port's kernels and the glue, and the verdicts are the reference's."""
    import time
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this machine")
    r = harness.run_cell("mimc13_fixed.stream", 7, 3, True,
                         t_start=time.perf_counter())
    assert r["correct"]
    assert r["device"]["busy_s"] > 0
    assert r["metrics"]["own_kernel_ms_per_proof.throughput"]["value"] > 0
    assert r["metrics"]["glue_kernels_per_proof.throughput"]["value"] > 0
