"""Where the run's threads run.

The thread that launches the port's kernels binds every cell, so through
the window it has a core of its own: `bind()`, as the window opens, puts
it there, leaves that core's SMT siblings idle where the machine has cores
to spare, and moves every other thread of the process to the remaining
cores.  A thread inherits the mask of the thread that creates it, so a
driver whose launching thread creates threads in the window (a parse pool)
creates them inside `spawning()`.  `release()`, as the window closes,
hands every thread all the cores again, before the reference's processes
start.  Where the process may use fewer than two cores nothing is bound.
"""

from __future__ import annotations

import contextlib
import os
import threading
from pathlib import Path


def _siblings(cpu: int) -> set:
    """The cpu's SMT siblings, itself included (just itself where the
    topology cannot be read)."""
    path = Path(f"/sys/devices/system/cpu/cpu{cpu}/topology/"
                "thread_siblings_list")
    try:
        text = path.read_text().strip()
    except OSError:
        return {cpu}
    out = set()
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.update(range(int(lo), int(hi or lo) + 1))
    return out


class Cores:
    def __init__(self):
        self.all = set(os.sched_getaffinity(0))
        self.launch = self.rest = None
        self.active = False
        if len(self.all) < 2:
            return
        cpu = max(self.all)
        rest = self.all - _siblings(cpu)
        if len(rest) < 2:                  # no core to spare: share siblings
            rest = self.all - {cpu}
        self.launch, self.rest = {cpu}, rest

    def bind(self) -> None:
        """The calling thread to the launch core, every other thread of the
        process to the rest."""
        if self.launch is None:
            return
        self.active = True
        me = threading.get_native_id()
        for tid in os.listdir("/proc/self/task"):
            if int(tid) != me:
                with contextlib.suppress(OSError):
                    os.sched_setaffinity(int(tid), self.rest)
        os.sched_setaffinity(0, self.launch)

    @contextlib.contextmanager
    def spawning(self):
        """Threads the calling thread creates inside go to the rest."""
        if not self.active:
            yield
            return
        os.sched_setaffinity(0, self.rest)
        try:
            yield
        finally:
            os.sched_setaffinity(0, self.launch)

    def release(self) -> None:
        """Every thread of the process back to all its cores."""
        if not self.active:
            return
        self.active = False
        for tid in os.listdir("/proc/self/task"):
            with contextlib.suppress(OSError):
                os.sched_setaffinity(int(tid), self.all)
