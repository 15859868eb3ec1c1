"""The traced window: `torch.profiler` over part of the measured window, and
the reductions the per-layer metrics and the breakdown read from it.

A device operation is a kernel, a copy or a memset that ran on the card.
Times are in nanoseconds on the profiler's clock, which it shares between
host and device events.  Device operations are clipped to the traced
window, which a host annotation marks.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

MARK = "bench.traced_window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Traced:
    """What the traced window holds."""
    window: tuple                     # (start, end) ns
    ops: list                         # [(name, start, end)] device ops
    host: list = field(default_factory=list)  # [(name, start, end)] host ops
                                      # of the launching thread
    requests: int = 0                 # verdicts delivered inside the window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def is_own(name: str) -> bool:
    """A kernel of the port's own (`stark_*`), by its demangled name."""
    if name.startswith("void "):
        name = name[5:]
    return name.startswith("stark_")


def merge(intervals) -> list:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_ns(ops) -> int:
    return sum(b - a for a, b in merge((s, e) for _, s, e in ops))


def idle_share(t: Traced) -> float:
    """Percent of the window that no device operation covers."""
    w = t.window[1] - t.window[0]
    return 100.0 * (1.0 - busy_ns(t.ops) / w)


def glue_kernels(t: Traced) -> int:
    """Device kernels that are not the port's own and not copies."""
    return sum(1 for n, _, _ in t.ops if not is_own(n) and not is_copy(n))


def own_kernel_ns(t: Traced) -> int:
    """Summed device time of the port's own kernels."""
    return sum(e - s for n, s, e in t.ops if is_own(n))


def gaps(t: Traced) -> list:
    """[(start, end)] stretches of the window that no device op covers."""
    out, at = [], t.window[0]
    for a, b in merge((s, e) for _, s, e in t.ops):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if t.window[1] > at:
        out.append((at, t.window[1]))
    return out


def _innermost(host) -> list:
    """[(start, end, name)] segments of the host timeline, each named by the
    innermost host op that covers it (the ops of one thread nest)."""
    segs, stack, at = [], [], None

    def close_until(t):
        nonlocal at
        while stack and stack[-1][1] <= t:
            name, end = stack.pop()
            if end > at:
                segs.append((at, end, name))
                at = end

    for name, s, e in sorted(host, key=lambda x: (x[1], -x[2])):
        if at is None:
            at = s
        close_until(s)
        if stack and s > at:
            segs.append((at, s, stack[-1][0]))
        at = max(at, s)
        stack.append((name, min(e, stack[-1][1]) if stack else e))
    close_until(float("inf"))
    return segs


def breakdown(t: Traced, top: int = 10) -> dict:
    """The device ops that took most time, and the idle gaps summed by the
    innermost host op running at each gap's middle ("python" where none
    ran), as [[name, seconds], ...] lists of at most `top` entries."""
    import bisect
    by_op = {}
    for n, s, e in t.ops:
        by_op[n[:120]] = by_op.get(n[:120], 0) + (e - s)
    segs = _innermost(t.host)
    starts = [a for a, _, _ in segs]
    by_gap = {}
    for a, b in gaps(t):
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "python"
        if i >= 0 and segs[i][0] <= mid < segs[i][1]:
            name = segs[i][2][:120]
        by_gap[name] = by_gap.get(name, 0) + (b - a)

    def ranked(d):
        return [[n, v * 1e-9] for n, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_gap)}


class Tracer:
    """Profiles the part of the window between start() and stop()."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.traced = None
        self.started = None               # perf_counter() once tracing
        self._prof = self._mark = None

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._mark = torch.profiler.record_function(MARK)
        self._mark.__enter__()
        self.started = time.perf_counter()  # the profiler's start is slow

    @property
    def running(self) -> bool:
        return self._prof is not None and self.traced is None

    def stop(self, requests: int) -> None:
        if not self.running:
            return
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        self.traced = read_profile(self._prof)
        self.traced.requests = requests
        self._prof = self._mark = None


def _activity(name: str, dev: bool, act) -> str:
    """The event's kineto activity, or what its name tells where the
    profiler does not say."""
    if act:
        return act
    if dev:
        return "gpu_memcpy" if is_copy(name) else "kernel"
    return "cpu_op"


def _event_rows(prof):
    """(name, activity, is_device, start ns, end ns, thread) of each event."""
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).endswith("CUDA")
        name, s = e.name(), e.start_ns()
        act = e.activity_type() if hasattr(e, "activity_type") else None
        yield (name, _activity(name, dev, act), dev, s, s + e.duration_ns(),
               e.start_thread_id())


def read_profile(prof) -> Traced:
    """The traced window of a stopped profiler."""
    window, ops, host, launches = None, [], [], {}
    for name, act, dev, s, e, tid in _event_rows(prof):
        if name == MARK and not dev:
            window = (s, e)
        elif dev:
            if act in DEVICE_ACTIVITIES and name != MARK:
                ops.append((name, s, e))
        elif act in ("cpu_op", "user_annotation", "cuda_runtime",
                     "cuda_driver"):
            host.append((name, s, e, tid))
            if name in ("cudaLaunchKernel", "cuLaunchKernel",
                        "cudaLaunchKernelExC", "cuLaunchKernelEx"):
                launches[tid] = launches.get(tid, 0) + 1
    if window is None:
        raise RuntimeError("the profiler recorded no traced window")
    a, b = window
    ops = [(n, max(s, a), min(e, b)) for n, s, e in ops if e > a and s < b]
    # the launching thread: most kernel launches, else most host ops
    counts = launches or {}
    if not counts:
        for *_, tid in host:
            counts[tid] = counts.get(tid, 0) + 1
    main = max(counts, key=counts.get) if counts else None
    host = [(n, max(s, a), min(e, b)) for n, s, e, tid in host
            if tid == main and e > a and s < b and n != MARK]
    return Traced(window, ops, host)
