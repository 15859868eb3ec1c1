"""MiMC statement helpers (host side).

Reference: src/utils.rs:8-16 -- note the reference iterates steps-1 times
(utils.rs:11), i.e. the trace has `steps` states and steps-1 transitions.
The claimed output is a statement-level constant, so the verifier computes
it once on the host; the device trace scan of the JAX package is not ported
yet.
"""

from __future__ import annotations

import numpy as np

from .. import fp


def round_constants_mimc(n: int = 64) -> np.ndarray:
    """(i^7) XOR 42 for i < n (reference: src/main.rs:209-212).  Host-side;
    returns [n, 16] uint32 limbs."""
    return fp.ints_to_limbs([(i ** 7) ^ 42 for i in range(n)])


def mimc_host(inp: int, steps: int, constants: list[int] | None = None,
              modulus: int = fp.MODULUS, power: int = 3) -> int:
    """Host (exact-int) MiMC output: steps-1 rounds of
    x <- x^power + c_{i mod k} (mod p)."""
    if constants is None:
        constants = [(i ** 7) ^ 42 for i in range(64)]
    out = inp
    n = len(constants)
    for i in range(steps - 1):
        out = (out ** power + constants[i % n]) % modulus
    return out
