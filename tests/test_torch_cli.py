"""The port's command line (cli.py) and metrics (profiling.py) on the CPU:
exit codes 0 / 1 / 2 on log_steps=9 blobs from tests/prover.py, the JSON
lines' keys against the JAX package's, the compressions count against the
JAX package's, and that every entry point asked for the card raises where
there is none."""

import functools
import json

import pytest
import torch

import prover
from stark_verifier_tpu import profiling as jprofiling
from stark_verifier_tpu.config import StarkConfig as JCfg
from stark_verifier_tpu_torch import cli, profiling
from stark_verifier_tpu_torch.config import StarkConfig
from stark_verifier_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)
CONSTS = [(i ** 7) ^ 42 for i in range(64)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    pb = prover.prove_to_bytes(3, 512, CONSTS)[0]
    d = tmp_path_factory.mktemp("proofs")
    flip = bytearray(pb)
    flip[110] ^= 1
    out = {}
    for name, data in (("golden", pb), ("flipped", bytes(flip)),
                       ("truncated", pb[:1000]), ("trailing", pb + b"xyz")):
        out[name] = d / f"{name}.bin"
        out[name].write_bytes(data)
    return out


CPU9 = ["--device", "cpu", "--log-steps", "9"]


@pytest.mark.parametrize("name,extra,code", [
    ("golden", [], 0), ("flipped", [], 1), ("truncated", [], 2),
    ("trailing", [], 0), ("trailing", ["--strict"], 2),
    ("golden", ["--batch", "2"], 0), ("flipped", ["--batch", "2"], 1)])
def test_verify_exit_codes(files, capsys, name, extra, code):
    assert cli.main(["verify", str(files[name]), *CPU9, *extra]) == code
    out = capsys.readouterr()
    if code == 0:
        assert "proof verified" in out.out
    elif code == 1:
        assert "proof REJECTED" in out.out
    else:
        assert "malformed proof" in out.err


def test_verify_profile_writes_a_trace(files, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["verify", str(files["golden"]), *CPU9, "--profile"]) == 0
    assert len(list((tmp_path / "trace").glob("*.json"))) == 1


def test_bench_prints_the_report(files, capsys):
    assert cli.main(["bench", str(files["golden"]), *CPU9, "--batch", "2",
                     "--iters", "2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jrep = jprofiling.BenchReport(batch=2, iters=2, p50_s=1.0, device="x")
    assert set(rec) == set(json.loads(jrep.to_json()))
    assert rec["batch"] == 2 and rec["device"] == "cpu"
    assert rec["comp_per_proof"] == profiling.compressions_per_proof(
        StarkConfig(log_steps=9))
    assert cli.main(["bench", str(files["flipped"]), *CPU9,
                     "--iters", "1"]) == 1


def _bench_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_bench_devices_runs_gloo_ranks(files, capsys, monkeypatch):
    """--devices 2 --device cpu: two gloo ranks, one proof each; the report
    counts both, and the scaling line divides its per-rank rate by the
    reference.  The world took 4.4 s in a whole suite's run on six workers:
    it gets 60 s, not the launcher's default for users' worlds."""
    monkeypatch.setattr(M, "launch", functools.partial(M.launch, timeout_s=60))
    assert cli.main(["bench", str(files["golden"]), *CPU9, "--batch", "2",
                     "--devices", "2", "--iters", "1",
                     "--ref-single-chip", "100"]) == 0
    report, scaling = _bench_lines(capsys)
    assert report["n_devices"] == 2 and report["batch"] == 2
    assert report["device"] == "cpu"
    assert report["proofs_per_s_per_chip"] == pytest.approx(
        report["proofs_per_s"] / 2, abs=0.01)
    assert scaling == {
        "scaling_efficiency": round(report["proofs_per_s_per_chip"] / 100, 4),
        "n_devices": 2, "ref_single_chip_proofs_per_s": 100.0}


def test_bench_scaling_line_at_one_device(files, capsys):
    assert cli.main(["bench", str(files["golden"]), *CPU9, "--iters", "1",
                     "--ref-single-chip", "100"]) == 0
    report, scaling = _bench_lines(capsys)
    assert report["n_devices"] == 1 and scaling["n_devices"] == 1
    assert scaling["scaling_efficiency"] > 0


@pytest.mark.parametrize("case", ["uneven_batch", "more_than_the_cards",
                                  "malformed"])
def test_bench_devices_refusals(files, capsys, monkeypatch, case):
    """A batch that is not a multiple of --devices, (on the card's path)
    more ranks than cards, and a malformed proof exit 2 with a message and
    start no rank."""
    proof = files["golden"]
    if case == "uneven_batch":
        argv = [*CPU9, "--batch", "3", "--devices", "2"]
        message = "--batch 3 must be a multiple of --devices 2"
    elif case == "malformed":
        proof = files["truncated"]
        argv = [*CPU9, "--batch", "2", "--devices", "2"]
        message = "malformed proof"
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        argv = ["--log-steps", "9", "--batch", "2", "--devices", "2"]
        message = "--devices 2: this machine has 1 cards"
    monkeypatch.setattr(cli, "bench_rank", None)     # no rank may start
    assert cli.main(["bench", str(proof), *argv]) == 2
    assert message in capsys.readouterr().err


def test_entry_points_default_to_the_card(files):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for argv in (["verify", str(files["golden"]), "--log-steps", "9"],
                 ["bench", str(files["golden"]), "--log-steps", "9"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)


@pytest.mark.parametrize("log_steps", [9, 11, 13])
def test_compressions_per_proof_equal_jax(log_steps):
    assert profiling.compressions_per_proof(StarkConfig(log_steps=log_steps)) \
        == jprofiling.compressions_per_proof(JCfg(log_steps=log_steps))
    assert profiling.COMPRESSIONS_PER_PROOF == \
        jprofiling.COMPRESSIONS_PER_PROOF


def test_report_and_phase_times():
    mine = profiling.BenchReport(batch=8, iters=3, p50_s=0.5, device="cpu",
                                 n_devices=2, comp_per_proof=10)
    ref = jprofiling.BenchReport(batch=8, iters=3, p50_s=0.5, device="cpu",
                                 n_devices=2, comp_per_proof=10)
    assert json.loads(mine.to_json()) == json.loads(ref.to_json())
    times = profiling.PhaseTimes()
    for _ in range(2):
        with times.phase("parse"):
            pass
    assert set(times.phases) == {"parse"} and times.phases["parse"] >= 0
