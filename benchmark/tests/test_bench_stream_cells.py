"""The two stream cells of one constant a round and of the device parse on
the CPU at 2^9 steps: a sound run of each comes out correct, the control
does not, a traced run of the round cell reads the statement packing, and a
port whose stream takes no statements fails at the call."""

import time

import pytest

from benchmark import control, harness
from benchmark.tests.conftest import small_cell

ROUND, DEVPARSE = "mimc13_round.stream", "mimc13_fixed.stream_devparse"


def _cell(workload):
    """The small cell; the round cell keeps one constant a round (512 at
    2^9 steps) and the device-parse cell its mix of honest proofs and
    same-length flips."""
    if workload == ROUND:
        c = small_cell(workload)
        return dict(c, config=dict(c["config"], num_constants=512))
    return small_cell(workload, {"honest": 5, "flip": 3})


def _run(cache, workload, seed, trace=False, seconds=0.05):
    return harness.run_cell(workload, seed, seconds, trace,
                            t_start=time.perf_counter(), device="cpu",
                            cell=_cell(workload), cache=cache, workers=2)


@pytest.mark.parametrize("workload", [ROUND, DEVPARSE])
def test_sound_runs_are_correct(cache, workload):
    r = _run(cache, workload, 2**31 + 4321)
    assert r["correct"], r["checks"]
    assert r["compared"] == r["attempted"] >= 8
    assert r["failed"] == 0


@pytest.mark.parametrize("workload", [ROUND, DEVPARSE])
def test_the_control_is_not_correct(cache, workload):
    with control.unbound_openings():
        r = _run(cache, workload, 4242)
    assert not r["correct"]
    assert r["checks"]["wrong_verdicts"]["value"] > 0


def test_a_traced_round_run_reads_the_statement_packing(cache):
    r = _run(cache, ROUND, 2**31 + 99, trace=True)
    assert r["correct"], r["checks"]
    got = r["metrics"]["statement_pack_ms_per_proof.throughput"]
    assert got["value"] > 0 and got["unit"] == "ms/proof"


def test_a_stream_without_statements_fails_at_the_call(cache, monkeypatch):
    """The parent of run-time statements in the stream: its verify_stream
    has no `statements`, so the round cell stops before any chunk."""
    from stark_verifier_tpu_torch.parallel import mesh

    def fixed_only(proof_blobs, chunk=None, cfg=None, inp=3, manifest=None,
                   threads=4, device_parse=False, device=None, mesh=None):
        raise AssertionError("not reached")

    monkeypatch.setattr(mesh, "verify_stream", fixed_only)
    with pytest.raises(TypeError, match="statements"):
        _run(cache, ROUND, 7)
