"""The port's proof stream (parallel/mesh.verify_stream, verify_batch) on the
CPU: per-blob verdicts in both parse modes equal the port's own
verify_proof_bytes (which tests/test_torch_verify_e2e.py holds to the JAX
package), the device-parse reroutes of tests/test_device_parse.py, and a
seeded property test of the stream's state machine with a stub verifier,
after tests/test_stream_independence.py.  log_steps=9 proofs from
tests/prover.py; tolerance 0."""

import random

import numpy as np
import pytest
import torch

import prover
import stark_verifier_tpu_torch as svt
from stark_verifier_tpu.config import StarkConfig as JCfg
from stark_verifier_tpu_torch.config import StarkConfig
from stark_verifier_tpu_torch.parallel import mesh as M
from stark_verifier_tpu_torch.proofio import device, ingest, wire
from stark_verifier_tpu_torch.proofio import static_layout as SL
from stark_verifier_tpu_torch.protocol import verify as V
from test_stream_independence import _synthetic_family_blob, _zero_level_proof

torch.set_num_threads(1)
CONSTS = [(i ** 7) ^ 42 for i in range(64)]
CFG, JCFG = StarkConfig(log_steps=9), JCfg(log_steps=9)


def _flip(blob, at):
    b = bytearray(blob)
    b[at] ^= 1
    return bytes(b)


def _ragged(blob, depth=11):
    """The last (lincomb) branch with one witness fewer than its group."""
    at = len(blob) - 32 * depth - 4
    assert int.from_bytes(blob[at:at + 4], "little") == 32 * depth
    return (blob[:at] + (32 * (depth - 1)).to_bytes(4, "little")
            + blob[at + 4:-32])


@pytest.fixture(scope="module")
def pb():
    return prover.prove_to_bytes(3, 512, CONSTS)[0]


@pytest.fixture(scope="module")
def kinds(pb):
    """{kind: (blob, verify_proof_bytes' verdict)}."""
    blobs = {
        "golden": pb,
        "flipped": _flip(pb, 110),
        "trailing": pb + b"trailing",
        "truncated": pb[:1000],
        "short_tail": pb[:-2],
        "ragged": _ragged(pb),
        "zero_levels": _zero_level_proof(),
        "synthetic": _synthetic_family_blob(JCFG, 1),
        "other_family": prover.prove_to_bytes(3, 128, CONSTS)[0],
        "empty": b"",
    }
    return {k: (b, svt.verify_proof_bytes(b, log_steps=9, device="cpu"))
            for k, b in blobs.items()}


def test_kinds_have_the_expected_verdicts(kinds):
    assert {k: v for k, (_, v) in kinds.items()} == {
        "golden": True, "flipped": False, "trailing": True,
        "truncated": False, "short_tail": False, "ragged": False,
        "zero_levels": False, "synthetic": False, "other_family": False,
        "empty": False}


@pytest.mark.parametrize("device_parse,chunk,seed", [
    (False, 2, 0), (False, 4, 1), (True, 3, 2), (True, 4, 3)])
def test_stream_verdicts_equal_verify_proof_bytes(kinds, device_parse, chunk,
                                                  seed):
    names = sorted(kinds) + ["golden", "flipped"]
    random.Random(seed).shuffle(names)
    blobs = [kinds[k][0] for k in names]
    manifest = {}
    got = dict(M.verify_stream(blobs, chunk=chunk, cfg=CFG, manifest=manifest,
                               threads=2, device_parse=device_parse,
                               device="cpu"))
    assert got == {i: kinds[k][1] for i, k in enumerate(names)}
    assert sorted(manifest) == list(range(-(-len(blobs) // chunk)))


def test_strict_trailing_reroutes_in_both_modes(pb):
    """Strict mode: the packed prefix cannot see trailing bytes, so
    non-exact lengths reroute to the host parser and reject."""
    cfg = StarkConfig(log_steps=9, strict=True)
    for dp in (False, True):
        got = dict(M.verify_stream([pb + b"x", pb], chunk=2, cfg=cfg,
                                   device_parse=dp, device="cpu"))
        assert got == {0: False, 1: True}, dp


def test_short_blob_always_reroutes_to_host(pb, monkeypatch):
    """A truncated blob whose missing tail bytes were zero would be
    reconstructed by pack()'s zero padding and pass every shape lane; the
    host parser rejects it, so short blobs reroute in EVERY mode.  The blob
    verifier is stubbed to claim every row canonical and accepted: the
    reroute must still hand the short blob to the host parser, and verify
    only that row there."""
    lay = SL.canonical_layout(CFG)
    rerouted = []

    def fake_blob_verifier(cfg, inp=3, device=None):
        def fn(words):
            n = words.shape[0]
            return torch.ones(n, dtype=torch.bool), torch.ones(n, dtype=torch.bool)
        return fn, lay

    real_ingest = ingest.ingest_chunk

    def spy(blobs, *a, **k):
        rerouted.append(len(blobs))
        return real_ingest(blobs, *a, **k)

    monkeypatch.setattr(SL, "make_blob_verifier", fake_blob_verifier)
    monkeypatch.setattr(ingest, "ingest_chunk", spy)
    got = dict(M.verify_stream([pb, pb[:-2], pb], chunk=3, cfg=CFG,
                               device_parse=True, device="cpu"))
    assert got == {0: True, 1: False, 2: True}
    assert rerouted == [1]


def test_verify_batch(pb):
    trees = [device.proof_tree(wire.parse_proof(b))
             for b in (pb, _flip(pb, 110))]
    assert M.verify_batch(trees, CFG, device="cpu").tolist() == [True, False]


def test_stream_defaults_to_the_card(pb):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(M.verify_stream([pb], cfg=CFG))
    with pytest.raises(RuntimeError, match="CUDA"):
        M.verify_batch([device.proof_tree(wire.parse_proof(pb))], CFG)


@pytest.mark.parametrize("device_parse", [False, True])
def test_stream_state_machine_randomized(pb, kinds, monkeypatch,
                                         device_parse):
    """110 seeded schedules (blob mixes x chunk sizes x partial-manifest
    resumes, which break the parity alternation and leave same-parity
    chunks in flight) through verify_stream, with the verifier stubbed by a
    root comparison so that the double buffer / pending / manifest-skip
    interplay runs at interactive speed -- in both parse modes (the
    device-parse stub keeps the real static-layout parse for shape_ok, so
    the reroute runs too).  Expected verdicts come from one blob at a time
    through ingest_chunk and the same stub."""
    golden_root = torch.from_numpy(
        np.frombuffer(pb[:32], dtype="<u4").view(np.int32).copy())
    categories = [kinds[k][0] for k in sorted(kinds)]
    categories.append(_flip(pb, 5))        # merkle_root: parses, stub False
    categories.append(_synthetic_family_blob(JCFG, 20))
    calls = []

    def fake_make_verifier(cfg, inp=3, shared_merkle=True, device=None):
        def fn(tree):
            calls.append(tree["merkle_root"].shape[0])
            return (tree["merkle_root"] == golden_root).all(dim=-1)
        return fn, None

    monkeypatch.setattr(V, "make_verifier", fake_make_verifier)
    lay = SL.canonical_layout(CFG)

    def fake_make_blob_verifier(cfg, inp=3, device=None):
        def fn(words):
            _, shape_ok = lay.parse(words)
            return ((words[:, :8] == golden_root).all(dim=1) & shape_ok,
                    shape_ok)
        return fn, lay

    monkeypatch.setattr(SL, "make_blob_verifier", fake_make_blob_verifier)

    def naive_verdict(blob):
        tree, ok, _ = ingest.ingest_chunk([blob], CFG)
        return bool(ok[0]) and bool(
            (tree["merkle_root"][0] == golden_root).all())

    expected = [naive_verdict(b) for b in categories]
    assert sum(expected) == 4              # golden, flipped, trailing, ragged
    rng = random.Random(1234)
    for trial in range(110):
        n = rng.randint(1, 9)
        picks = [rng.randrange(len(categories)) for _ in range(n)]
        blobs = [categories[p] for p in picks]
        want = {i: expected[p] for i, p in enumerate(picks)}
        chunk = rng.randint(1, 5)
        manifest = {}
        got = dict(M.verify_stream(blobs, chunk=chunk, cfg=CFG,
                                   manifest=manifest, threads=2,
                                   device_parse=device_parse, device="cpu"))
        assert got == want, (trial, picks, chunk, got, want)
        kept = {k: v for k, v in manifest.items() if rng.random() < 0.5}
        got2 = dict(M.verify_stream(blobs, chunk=chunk, cfg=CFG,
                                    manifest=kept, threads=2,
                                    device_parse=device_parse, device="cpu"))
        assert got2 == want, (trial, "resume", picks, chunk, got2, want)
    assert calls and max(calls) <= 5        # a call verifies one chunk's rows


def test_stream_under_thread_stress(pb, monkeypatch):
    """More ingest threads than cores and a switch interval of a
    microsecond: the worker that fills chunk k + 1's slot races the main
    thread that verifies chunk k's; every verdict must stay its own blob's
    (a slot refilled too early would hand one chunk another's roots)."""
    import sys
    golden_root = torch.from_numpy(
        np.frombuffer(pb[:32], dtype="<u4").view(np.int32).copy())

    def fake_make_verifier(cfg, inp=3, shared_merkle=True, device=None):
        return (lambda tree: (tree["merkle_root"] == golden_root).all(-1),
                None)

    lay = SL.canonical_layout(CFG)

    def fake_make_blob_verifier(cfg, inp=3, device=None):
        def fn(words):
            _, shape_ok = lay.parse(words)
            return ((words[:, :8] == golden_root).all(1) & shape_ok, shape_ok)
        return fn, lay

    monkeypatch.setattr(V, "make_verifier", fake_make_verifier)
    monkeypatch.setattr(SL, "make_blob_verifier", fake_make_blob_verifier)
    blobs = [pb if i % 3 else _flip(pb, 5 + i % 20) for i in range(36)]
    want = {i: bool(i % 3) for i in range(36)}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for dp in (False, True):
            for chunk in (2, 5):
                got = dict(M.verify_stream(blobs, chunk=chunk, cfg=CFG,
                                           threads=16, device_parse=dp,
                                           device="cpu"))
                assert got == want, (dp, chunk)
    finally:
        sys.setswitchinterval(old)
