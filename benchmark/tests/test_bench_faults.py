"""`correct` on the CPU at 2^9 steps: a sound run of each driver comes out
correct, and the control and each planted fault that a cell can have come
out not correct, the rest of the run driven as on the card."""

import pytest

from benchmark import control

STREAM, BATCH, SINGLE = ("mimc13_fixed.stream", "mimc13_runtime.distinct",
                         "mimc13_fixed.single")


@pytest.mark.parametrize("workload,seconds", [(STREAM, 0.05), (BATCH, 0.05),
                                              (SINGLE, 6)])
def test_sound_runs_are_correct(run_small, workload, seconds):
    r = run_small(workload, 2**31 + 12345, seconds=seconds)
    assert r["correct"], r["checks"]
    assert r["compared"] == r["attempted"] >= 8
    assert r["failed"] == 0


# the faults alter the verifier's answers, which the host's parse verdict
# masks for blobs it rejects: their runs send only blobs that parse
PARSED = {"honest": 4, "flip": 4}


@pytest.mark.parametrize("workload,patch,seconds,block", [
    (STREAM, "control", 0.05, None),
    (BATCH, "control", 0.05, None),
    (SINGLE, "control", 4, PARSED),
    (STREAM, "flipped_answer", 0.3, PARSED),
    (BATCH, "flipped_answer", 0.3, PARSED),
    (SINGLE, "flipped_answer", 0.05, PARSED),
    (STREAM, "half_batch", 0.3, PARSED),
    (BATCH, "half_batch", 0.3, PARSED),
])
def test_control_and_faults_are_not_correct(run_small, workload, patch,
                                            seconds, block):
    with control.PATCHES[patch]():
        r = run_small(workload, 4242, seconds=seconds, block=block)
    assert not r["correct"]
    assert r["checks"]["wrong_verdicts"]["value"] > 0


def test_a_traced_run_reports_the_layers_it_reads(run_small):
    r = run_small(BATCH, 99, trace=True)
    assert r["correct"], r["checks"]
    assert "window_s" in r["device"] and "breakdown" in r
    # the CPU has no device trace: only the host span's metric is read
    assert set(r["metrics"]) == {"host_parse_ms_per_proof.throughput"}
