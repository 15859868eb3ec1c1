"""Debug mode: the representation invariants the kernels rely on, checked.

Counterpart of the JAX package's debug.py.  Every limb of a field element
must be a 16-bit value (a wider limb corrupts its neighbours in the carry
arithmetic of the plain versions and is rejected or poisoned by the
kernels), and every gather index must lie in its table.  With STARK_DEBUG=1
in the environment:

  * check_limbs(x, name) raises if a word of x lies outside [0, 0xFFFF]
    (words are int32 bit patterns, so a negative word is a violation);
  * check_bounds(idx, n, name) raises if an index is not in [0, n), read as
    an unsigned value (so a negative index is out of bounds);
  * checked(fn) wraps fn so that the device is synchronized after each
    call, and a fault of the call's kernels shows at that call.

The switch is read at CALL time: each check looks it up when it runs, and
checked() when it wraps.  (The JAX package reads it at trace time and bakes
the checks into the compiled graph; PyTorch runs eagerly, so there is no
graph to bake them into.)  With the switch off a check costs one lookup of
the environment and no synchronization, and checked(fn) is fn itself.  A
check that runs synchronizes the host with the device (it reads a flag
back), so the stream's worker thread, which only prepares batches, runs
none.
"""

from __future__ import annotations

import os

import torch


def enabled() -> bool:
    return os.environ.get("STARK_DEBUG", "") == "1"


def check_limbs(x: torch.Tensor, name: str) -> None:
    """Raise if any limb of x is not a normalized 16-bit value (no-op
    unless STARK_DEBUG=1)."""
    if enabled() and bool(((x < 0) | (x > 0xFFFF)).any()):
        raise ValueError("limb invariant violated (>= 2^16) in " + name)


def check_bounds(idx: torch.Tensor, n: int, name: str) -> None:
    """Raise if any index is not in [0, n) (no-op unless STARK_DEBUG=1)."""
    if enabled() and bool(((idx < 0) | (idx >= n)).any()):
        raise IndexError("index out of bounds in " + name)


class _Checked:
    """fn, with the device synchronized after each call; attributes are
    fn's (a verifier module's tables, its config)."""

    def __init__(self, fn):
        self.__wrapped__ = fn

    def __call__(self, *args, **kwargs):
        out = self.__wrapped__(*args, **kwargs)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return out

    def __getattr__(self, name):
        return getattr(self.__wrapped__, name)


def checked(fn):
    """fn itself when STARK_DEBUG is off; else fn wrapped so that a fault of
    its kernels raises at the call (the device is synchronized after it)."""
    if not enabled():
        return fn
    return _Checked(fn)
