"""The port's own spans in the traced window.

The port records a span at each boundary of its layers while a profiler
runs (`stark_verifier_tpu_torch.profiling.spans()`), stamped with
`time.time_ns()`, the epoch clock of the profiler's host events, so the
spans clip to the traced window as they are.  Where the port keeps no spans
(a checkout from before they were added) or the run was not traced, a
reader finds nothing and returns nothing.
"""

from __future__ import annotations

from collections import Counter


def in_window(run) -> list:
    """[(span, ns of it inside the traced window, that share of the
    span)] for every span of the port that overlaps the window."""
    t = run.traced
    if t is None:
        return []
    from stark_verifier_tpu_torch import profiling
    read = getattr(profiling, "spans", None)
    if read is None:
        return []
    a, b = t.window
    out = []
    for s in read():
        lo, hi = max(s.start_ns, a), min(s.end_ns, b)
        if s.end_ns > s.start_ns and hi > lo:
            out.append((s, hi - lo, (hi - lo) / (s.end_ns - s.start_ns)))
    return out


def launching_thread(clipped):
    """The thread that ran most `verify` spans: the one that launches the
    port's kernels (None where no `verify` span lies in the window)."""
    n = Counter(s.thread for s, _, _ in clipped if s.name == "verify")
    return n.most_common(1)[0][0] if n else None


def ms_per(run, name: str, per: str, launching: bool = False):
    """Milliseconds inside the spans called `name` in the traced window
    (on the launching thread alone with `launching`), over `per`:
    "verdicts" (the window's verdicts), "proofs" (the `proofs` each span
    names, times its share inside the window) or "calls" (the spans, each
    counted by its share inside the window).  None where no such span lies
    in the window."""
    clipped = in_window(run)
    if launching:
        thread = launching_thread(clipped)
        clipped = [c for c in clipped if c[0].thread == thread]
    mine = [c for c in clipped if c[0].name == name]
    if not mine:
        return None
    if per == "verdicts":
        count = run.traced.requests
    elif per == "proofs":
        count = sum(s.attrs.get("proofs", 0) * share for s, _, share in mine)
    elif per == "calls":
        count = sum(share for _, _, share in mine)
    else:
        raise ValueError(f"per {per!r}")
    if not count:
        return None
    return sum(ns for _, ns, _ in mine) * 1e-6 / count
