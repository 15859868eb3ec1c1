"""The port's spans (profiling.span) on the CPU: nothing recorded and the
shared no-op returned while no profiler runs; under torch.profiler the
spans of the stream pipeline (both threads), the host parse, the
verifier's phases and the one-proof entry, nested and named by chunk, with
the parse's counts equal to its verdicts, stamped on the profiler's clock;
the worker's spans in the Chrome trace of `maybe_trace`; PhaseTimes on top.
log_steps=9 proofs from tests/prover.py."""

import itertools
import json
import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import prover
import stark_verifier_tpu_torch as svt
from stark_verifier_tpu_torch import profiling
from stark_verifier_tpu_torch.config import StarkConfig
from stark_verifier_tpu_torch.ops import blake2s, blake2s_cuda, prg
from stark_verifier_tpu_torch.parallel import mesh as M
from stark_verifier_tpu_torch.proofio import ingest
from stark_verifier_tpu_torch.protocol import verify as V

torch.set_num_threads(1)
CONSTS = [(i ** 7) ^ 42 for i in range(64)]
CFG = StarkConfig(log_steps=9)
VERIFY_PHASES = {"verify.prg", "verify.fri", "verify.khash", "verify.merkle",
                 "verify.boundary", "verify.spot"}


@pytest.fixture(scope="module")
def pb():
    return prover.prove_to_bytes(3, 512, CONSTS)[0]


# three chunks: the first with a truncated blob, the second with nothing
# that parses (a truncated and an empty blob), the last one blob long
STREAM = ["pb", 1000, 1000, 0, "pb"]


def _blobs(pb, kinds):
    return [pb if k == "pb" else pb[:k] for k in kinds]


@pytest.fixture(scope="module")
def traced(pb):
    """One profiler run: a stream of three chunks, an ingest of its
    own, two calls of verify_proof_bytes (one that parses, one that does
    not) and a verifier built.  Returns what each gave, the spans it
    recorded, by id, and the profiler's (name, start, end) host ranges."""
    assert svt.verify_proof_bytes(pb, log_steps=9, device="cpu")  # built
    since = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stream = dict(M.verify_stream(_blobs(pb, STREAM), chunk=2, cfg=CFG,
                                      threads=2, device="cpu"))
        parsed = ingest.ingest_chunk(_blobs(pb, ["pb", 1000, 0, "pb"]), CFG,
                                     threads=2)
        entry = [svt.verify_proof_bytes(b, log_steps=9, device="cpu")
                 for b in (pb, pb[:1000])]
        V.make_verifier(CFG, inp=12345, shared_merkle=False, device="cpu")
    until = time.time_ns()
    spans = {s.id: s for s in profiling.spans()
             if since <= s.start_ns and s.end_ns <= until}
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return dict(stream=stream, parsed=parsed, entry=entry, spans=spans,
                ranges=ranges)


def _children(spans, sp):
    return [s for s in spans.values() if s.parent == sp.id]


def _named(spans, name):
    return sorted((s for s in spans.values() if s.name == name),
                  key=lambda s: s.start_ns)


@pytest.mark.parametrize("attrs", [{}, {"chunk": 1}])
def test_no_profiler_no_spans(attrs):
    assert not torch.autograd.profiler._is_profiler_enabled
    before = len(profiling.spans())
    tracemalloc.start()
    try:
        with profiling.span("x", **attrs) as sp:
            sp.set(proofs=3)
        start, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        for _ in itertools.repeat(None, 10_000):
            with profiling.span("x", **attrs) as sp:
                sp.set(proofs=3)
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert sp is profiling.NO_SPAN and not sp
    assert len(profiling.spans()) == before
    # 10,000 spans keep nothing: what grows is the interpreter's own
    # caches, once, under a byte a call
    assert now - start < 4096 and peak - start < 4096, (start, now, peak)


def test_stream_spans_nest_by_layer_and_name_their_chunk(traced):
    spans = traced["spans"]
    assert traced["stream"] == {0: True, 1: False, 2: False, 3: False,
                                4: True}
    main = threading.get_native_id()
    prepares = _named(spans, "stream.prepare")
    assert [s.attrs for s in prepares] == [{"chunk": c, "proofs": n}
                                           for c, n in ((0, 2), (1, 2),
                                                        (2, 1))]
    worker = {s.thread for s in prepares}
    assert len(worker) == 1 and main not in worker
    for p in prepares:
        kids = _children(spans, p)
        assert [k.name for k in sorted(kids, key=lambda s: s.start_ns)] == [
            "stream.wait_slot", "parse"]
        parse, = (k for k in kids if k.name == "parse")
        steps = {k.name for k in _children(spans, parse)}
        if p.attrs["chunk"] == 1:      # nothing in it is of the family
            assert steps == {"parse.scan"}
        elif p.attrs["chunk"] == 2:    # slot 0's layout, kept: one pass
            assert steps == {"parse.pass", "parse.validate", "parse.pad"}
        else:
            assert steps >= {"parse.scan", "parse.fill", "parse.validate",
                             "parse.pad"}
        assert p.parent is None and all(k.thread == p.thread for k in kids)

    dispatches = _named(spans, "stream.dispatch")
    assert [s.attrs for s in dispatches] == [
        {"chunk": 0, "proofs": 2, "walk": "shared"}, {"chunk": 1, "proofs": 2},
        {"chunk": 2, "proofs": 1, "walk": "shared"}]
    for d in dispatches:
        assert d.thread == main and d.parent is None
        kids = sorted(_children(spans, d), key=lambda s: s.start_ns)
        if d.attrs["chunk"] == 1:      # nothing to verify
            assert [k.name for k in kids] == ["stream.wait_prepared"]
            continue
        assert [k.name for k in kids] == ["stream.wait_prepared",
                                          "stream.stage", "verify"]
        assert kids[1].attrs == {}            # no device buffers here
        assert kids[2].attrs == {"proofs": d.attrs["proofs"],
                                 "shared_merkle": True, "runtime": False,
                                 "hash_launches": 0}
        assert {k.name for k in _children(spans, kids[2])} == VERIFY_PHASES

    collects = _named(spans, "stream.collect")
    assert [s.attrs for s in collects] == [
        {"chunk": 0, "proofs": 2}, {"chunk": 1, "proofs": 2},
        {"chunk": 2, "proofs": 1}]
    assert [[k.name for k in _children(spans, c)] for c in collects] == [
        ["stream.wait_verdicts"], [], ["stream.wait_verdicts"]]
    # the pipeline: a chunk's parse overlaps the dispatch before it
    assert prepares[1].start_ns < dispatches[0].end_ns


def test_parse_counts_equal_the_verdicts(traced):
    tree, ok, layout = traced["parsed"]
    assert ok.tolist() == [True, False, False, True]
    parse = [s for s in _named(traced["spans"], "parse")
             if s.parent is None or
             traced["spans"][s.parent].name != "stream.prepare"]
    assert len(parse) == 1
    a = parse[0].attrs
    assert a == {"proofs": 4, "scan_rejected": 2, "family_rejected": 0,
                 "native_filled": 2, "one_pass": 0, "slow": 0,
                 "ok": int(ok.sum()), "layout": "built"}
    assert {k.name for k in _children(traced["spans"], parse[0])} == {
        "parse.scan", "parse.layout", "parse.fill", "parse.validate",
        "parse.pad"}
    # the stream's chunks: a slot builds its layout once, and keeps it; on
    # the kept layout the one pass fills every blob it fills
    in_stream = [s.attrs for s in _named(traced["spans"], "parse")
                 if s is not parse[0]]
    assert [(a["proofs"], a["scan_rejected"], a["ok"], a["layout"],
             a["one_pass"], a["native_filled"]) for a in in_stream] == [
        (2, 1, 1, "built", 0, 1), (2, 2, 0, "none", 0, 0),
        (1, 0, 1, "kept", 1, 1)]


def test_a_verifier_built_on_a_miss_opens_its_span(traced):
    build, = _named(traced["spans"], "verify.build")
    assert build.attrs == {"log_steps": 9, "shared_merkle": False}
    assert build.parent is None


def test_the_entry_opens_its_phases(traced):
    spans = traced["spans"]
    assert traced["entry"] == [True, False]
    good, bad = _named(spans, "entry")
    assert good.attrs == bad.attrs == {"proofs": 1}
    kids = sorted(_children(spans, good), key=lambda s: s.start_ns)
    assert [k.name for k in kids] == ["entry.parse", "entry.lookup",
                                      "entry.h2d", "verify", "entry.wait"]
    assert kids[1].attrs == {"built": False}
    assert {k.name for k in _children(spans, kids[3])} == VERIFY_PHASES
    assert [k.name for k in _children(spans, bad)] == ["entry.parse"]


def test_the_verify_span_counts_the_hash_kernels_launches(traced, pb,
                                                         monkeypatch):
    """On the CPU no hash kernel launches: every verify span reads 0.  With
    each hash call counted as a launch of the kernel, a shared-walk verify
    reads one chain, one k-hash and the dense tails' levels, and nothing
    the plain hashes do besides."""
    verifies = _named(traced["spans"], "verify")
    assert len(verifies) == 3
    assert all(s.attrs["hash_launches"] == 0 for s in verifies)

    def counting(fn, mode):
        def call(*args):
            blake2s_cuda.launches[mode] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(blake2s, "hash_words",
                        counting(blake2s.hash_words, "hash_words"))
    monkeypatch.setattr(prg, "chain_entries",
                        counting(prg.chain_entries, "hash_chain"))
    since = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        assert svt.verify_proof_bytes(pb, log_steps=9, device="cpu")
    verify, = (s for s in profiling.spans()
               if s.name == "verify" and s.start_ns >= since)
    assert verify.attrs["hash_launches"] == 8


def test_spans_lie_on_the_profilers_clock(traced):
    """Every span the profiler saw starts and ends within 50 us of the
    profiler's own range of the same name."""
    ranges = {}
    for name, s, e in traced["ranges"]:
        ranges.setdefault(name, []).append((s, e))
    seen = [s for s in traced["spans"].values() if s.seen]
    assert {s.name for s in seen} >= {"stream.dispatch", "verify", "entry",
                                      "entry.wait"} | VERIFY_PHASES
    for sp in seen:
        s, e = min(ranges[sp.name], key=lambda r: abs(r[0] - sp.start_ns))
        assert abs(sp.start_ns - s) < 50_000 and abs(sp.end_ns - e) < 50_000, (
            sp.name, sp.start_ns - s, sp.end_ns - e)
    # the worker's spans the profiler did not see, and still recorded
    assert not any(s.seen for s in _named(traced["spans"], "stream.prepare"))


def test_the_chrome_trace_carries_the_workers_spans(pb, tmp_path):
    # blobs that do not parse: the worker's spans without a verify's ops
    with profiling.maybe_trace(True, str(tmp_path)):
        got = dict(M.verify_stream(_blobs(pb, [1000, 0, 500, 0]), chunk=2,
                                   cfg=CFG, threads=2, device="cpu"))
    assert got == {0: False, 1: False, 2: False, 3: False}
    path, = tmp_path.glob("*.json")
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    main = threading.get_native_id()
    mine = [e for e in events if e.get("cat") == "span"]
    assert {e["name"] for e in mine} == {"stream.prepare", "stream.wait_slot",
                                         "parse", "parse.scan"}
    workers = {e["tid"] for e in mine}
    assert len(workers) == 1 and main not in workers
    assert any(e["ph"] == "M" and e["name"] == "thread_name"
               and e["tid"] in workers for e in events)
    assert [e["args"]["chunk"] for e in mine
            if e["name"] == "stream.prepare"] == [0, 1]
    # the same time base: the worker's first parse runs inside the
    # launching thread's wait for it
    waits = sorted((e for e in events if e.get("name") ==
                    "stream.wait_prepared"), key=lambda e: e["ts"])
    parse = min((e for e in mine if e["name"] == "parse"),
                key=lambda e: e["ts"])
    assert waits and waits[0]["ts"] <= parse["ts"] + parse["dur"] \
        <= waits[0]["ts"] + waits[0]["dur"] + 50
    # the launching thread's spans come from the profiler alone, once,
    # with their ids and counts in its ranges' args
    assert not any(e.get("cat") == "span" and e["tid"] == main
                   for e in events)
    dispatch = sorted((e for e in events if e.get("name") ==
                       "stream.dispatch"), key=lambda e: e["ts"])
    assert [(e["tid"], e["args"]["chunk"], e["args"]["proofs"])
            for e in dispatch] == [(main, 0, 2), (main, 1, 2)]
    assert all(e["args"]["parent"] is None for e in dispatch)
    assert waits[0]["args"]["parent"] == dispatch[0]["args"]["id"]


def test_the_chrome_trace_carries_the_counts_of_seen_spans(pb, tmp_path):
    svt.verify_proof_bytes(pb, log_steps=9, device="cpu")      # built
    with profiling.maybe_trace(True, str(tmp_path)):
        assert svt.verify_proof_bytes(pb, log_steps=9, device="cpu")
    path, = tmp_path.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    args = {e["name"]: e["args"] for e in events
            if e.get("ph") == "X" and e.get("name", "").startswith(
                ("entry", "verify"))}
    assert args["entry"]["proofs"] == 1 and args["entry"]["parent"] is None
    assert args["entry.lookup"]["built"] is False
    assert args["verify"]["proofs"] == 1
    assert args["verify"]["shared_merkle"] is True
    assert args["verify"]["parent"] == args["entry"]["id"]
    assert args["verify.spot"]["parent"] == args["verify"]["id"]
    assert not any(e.get("cat") == "span" for e in events)


def test_phase_times_sum_their_phases_and_open_spans():
    times = profiling.PhaseTimes()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with times.phase("h2d"):
                time.sleep(0.001)
    with times.phase("h2d"):
        time.sleep(0.001)
    assert set(times.phases) == {"h2d"} and times.phases["h2d"] >= 0.003
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("h2d") == 2
    assert len([s for s in profiling.spans()[-3:] if s.name == "h2d"]) == 2


def test_threads_keep_their_own_nesting():
    """Many threads opening spans at once: every id is new and every
    parent is the innermost span open on the span's own thread."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n_threads, depth, rounds = 16, 3, 50
    go = threading.Event()

    def work(k):
        go.wait()
        for _ in range(rounds):
            with profiling.span("t.outer", k=k):
                for _ in range(depth):
                    with profiling.span("t.inner", k=k):
                        pass

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for t in threads:
                t.start()
            go.set()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    mine = [s for s in profiling.spans() if s.name.startswith("t.")]
    by_id = {s.id: s for s in mine}
    assert len(mine) == len(by_id) == n_threads * rounds * (depth + 1)
    for s in mine:
        if s.name == "t.inner":
            p = by_id[s.parent]
            assert p.name == "t.outer" and p.thread == s.thread
            assert p.attrs["k"] == s.attrs["k"]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert np.unique([s.thread for s in mine]).size == n_threads
