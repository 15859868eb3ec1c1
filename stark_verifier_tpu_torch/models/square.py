"""The square-permutation STARK statement family (x <- x^2 + k_i).

A second AIR over the same field/proof machinery as models/mimc.py --
identical wire format, Merkle/FRI structure, and spot-check skeleton, but a
quadratic transition constraint P(g1 x) == P(x)^2 + K(x) + Z(x) D(x) instead
of the reference's cubic (reference AIR: src/main.rs:163-182 with
utils.rs:12's x^3).  The protocol layer takes the transition power from
StarkConfig.power, which on the card selects the spot-check kernel's power-2
instantiation.

Note x -> x^2 is not a permutation of F_p (gcd(2, p-1) = 2), but a STARK
over the trace does not need one -- the statement is about the execution
trace, not invertibility.
"""

from __future__ import annotations

from ..config import StarkConfig
from .base import StatementFamily


class SquareStatement(StatementFamily):
    name = "square"

    def __init__(self, cfg: StarkConfig | None = None):
        cfg = cfg or StarkConfig(power=2)
        if cfg.power != 2:
            raise ValueError("SquareStatement requires cfg.power == 2")
        super().__init__(cfg)
