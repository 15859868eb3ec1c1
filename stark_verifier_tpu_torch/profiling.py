"""Tracing and metrics for verification runs.

Spans at the boundaries of the port's layers (`span`, read back with
`spans`), named phase timers built on them, a structured report for
benchmark runs (proofs/s, proofs/s a card, Blake2s compressions/s, p50 time
of a call) and an optional torch.profiler trace.  The reference's only
instrumentation is two wall-clock prints (src/main.rs:214-226).  The host
clock times what the caller sees: callers synchronize the device inside a
phase whose device work it must cover.

A span records only while a torch.profiler runs in the process; otherwise
opening one costs a read of the profiler's flag.  Its times are
`time.time_ns()`, the epoch clock the profiler stamps its host events with,
so a reader can clip the spans to a profiled window.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field, asdict

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_BUFFER = 65_536           # the newest spans kept
# a profiler range entered and left in C++, stamped within a microsecond of
# the span's own clock reads (record_function goes through the dispatcher:
# tens of microseconds each way under the profiler)
_Range = torch._C._profiler._RecordFunctionFast


class Span:
    """One span: `name`, `id`, `parent` (the id of the innermost span open
    on the same thread when it opened, or None), `thread` (the OS thread
    id, as the profiler's trace names threads), `start_ns` / `end_ns` on
    the epoch clock, `attrs` (the counts of its boundary) and `seen`
    (whether the profiler recorded a host range of the same name around
    it: only on a thread the profiler sees)."""

    __slots__ = ("name", "id", "parent", "thread", "start_ns", "end_ns",
                 "attrs", "seen", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self.thread = threading.get_native_id()
        self.parent = self.start_ns = self.end_ns = self._range = None
        self.seen = False

    def set(self, **counts) -> None:
        self.attrs.update(counts)

    def __enter__(self):
        stack = _open.ids
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        if torch.autograd._profiler_enabled():   # this thread is profiled
            self._range = _Range(self.name)
            self._range.__enter__()
            self.seen = True
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _open.ids.pop()
        _buffer.append(self)
        return False


class _NoSpan:
    """The span opened while nothing traces: records nothing.  False, so
    that a boundary computes its counts only for a span that records."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def set(self, **counts) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Open(threading.local):
    def __init__(self):
        self.ids = []          # the spans open on this thread, innermost last


NO_SPAN = _NoSpan()
_buffer = collections.deque(maxlen=SPAN_BUFFER)
_ids = itertools.count(1)
_open = _Open()


def span(name: str, **attrs):
    """A context manager around one boundary of a layer.  While a
    torch.profiler runs, a new `Span` that is appended to the buffer when
    it closes and, on a thread the profiler sees, a profiler range of the
    same name around it; otherwise the shared `NO_SPAN`."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return Span(name, attrs)


def spans() -> list:
    """The newest `SPAN_BUFFER` closed spans, oldest first."""
    return list(_buffer)


def compressions_per_proof(cfg=None) -> int:
    """Blake2s compressions one verification performs, derived from the
    statement family.

    With log_p = log2(precision), the level-l column tree has
    precision/4^(l+1) leaves quad-packed into 2^(log_p-2l-4) nodes ->
    log_p-2l-3 witness hashes after the leaf-pair hash; row trees sit one
    fold higher (log_p-2l-1); main/lincomb walk the full domain tree
    (log_p-1).  Each branch pays 1 leaf-pair compression (3 for the 96-byte
    main leaves: H(value||sibling) over 192 bytes = 3 64-byte blocks) plus
    one per witness.  Index PRGs read 8 indices per 32-byte digest starting
    from the seed root itself (utils.rs:67), so a group of n indices costs
    ceil(n/8)-1 hashes; k1..k4 are 4 more (main.rs:131-146)."""
    from .config import StarkConfig
    cfg = cfg or StarkConfig()
    log_p = cfg.precision.bit_length() - 1
    q, s = cfg.fri_queries, cfg.spot_checks
    total = 4                                      # k1..k4
    for l in range(cfg.fri_levels):
        total += q * (1 + (log_p - 2 * l - 3))     # column branches
        total += 4 * q * (1 + (log_p - 2 * l - 1))  # row branches
        total += -(-q // 8) - 1                    # per-level index PRG
    total += 2 * s * (3 + (log_p - 1))             # main (3-block leaves)
    total += s * (1 + (log_p - 1))                 # lincomb
    total += -(-s // 8) - 1                        # spot-check index PRG
    return total


# default-family constant kept for callers that don't thread a cfg
COMPRESSIONS_PER_PROOF = compressions_per_proof()


@dataclass
class PhaseTimes:
    phases: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        with span(name):
            t = time.perf_counter()
            yield
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t)


@dataclass
class BenchReport:
    batch: int
    iters: int
    p50_s: float
    device: str
    n_devices: int = 1
    comp_per_proof: int = COMPRESSIONS_PER_PROOF   # cfg-derived: pass
    # compressions_per_proof(cfg) for non-default families

    @property
    def proofs_per_s(self) -> float:
        return self.batch / self.p50_s

    @property
    def proofs_per_s_per_chip(self) -> float:
        return self.proofs_per_s / max(self.n_devices, 1)

    @property
    def compressions_per_s(self) -> float:
        return self.proofs_per_s * self.comp_per_proof

    def to_json(self) -> str:
        d = asdict(self)
        d.update(proofs_per_s=round(self.proofs_per_s, 2),
                 proofs_per_s_per_chip=round(self.proofs_per_s_per_chip, 2),
                 compressions_per_s=round(self.compressions_per_s))
        return json.dumps(d)


@contextlib.contextmanager
def maybe_trace(enable: bool, out_dir: str = "./trace"):
    """With enable, run torch.profiler over the host and (where there is
    one) the card, and write a Chrome trace under out_dir that holds every
    span's id, parent and counts: in the args of the profiler's own range
    of a span it saw, and as events of their own, each on its thread's row,
    for the spans of the threads it did not see (the stream's worker)."""
    if not enable:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    since = time.time_ns()
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"trace-{os.getpid()}-{time.strftime('%Y%m%d-%H%M%S')}.json")
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in spans() if s.start_ns >= since])


def _add_spans(path: str, recorded: list) -> None:
    """Write `recorded` spans into the Chrome trace at `path`, on the
    trace's own time base (microseconds after its baseTimeNanoseconds): a
    seen span's id, parent and counts into the args of the profiler's range
    of its name and thread that starts within 50 µs of it; an unseen
    span as an event of its own."""
    if not recorded:
        return
    with open(path) as f:
        doc = json.load(f)
    base, pid = doc.get("baseTimeNanoseconds", 0), os.getpid()
    events = doc.setdefault("traceEvents", [])
    ranges = collections.defaultdict(list)      # (name, tid) -> by start
    for e in sorted((e for e in events if e.get("ph") == "X" and "ts" in e),
                    key=lambda e: e["ts"]):
        ranges[(e.get("name"), e.get("tid"))].append(e)
    unseen = []
    for s in recorded:
        args = dict(s.attrs, id=s.id, parent=s.parent)
        ts = (s.start_ns - base) / 1e3
        if not s.seen:
            unseen.append((s, ts, args))
            continue
        mine = ranges.get((s.name, s.thread), [])
        k = bisect.bisect_left(mine, ts, key=lambda e: e["ts"])
        near = min(mine[max(k - 1, 0):k + 1], default=None,
                   key=lambda e: abs(e["ts"] - ts))
        if near is not None and abs(near["ts"] - ts) < 50.0:
            near.setdefault("args", {}).update(args)
    for tid in sorted({s.thread for s, _, _ in unseen}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": f"thread {tid} (spans)"}})
    for s, ts, args in unseen:
        events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                       "tid": s.thread, "ts": ts,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)
