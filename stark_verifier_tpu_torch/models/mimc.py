"""The MiMC-permutation STARK statement family.

Statement (reference: src/main.rs:205-218): "I know the execution trace of
`num_steps` rounds of x <- x^3 + k_{i mod 64} (mod p), starting at `inp` and
ending at the claimed output", with round constants k_i = (i^7) XOR 42 and
steps-1 actual transitions (utils.rs:11).
"""

from __future__ import annotations

from ..config import StarkConfig
from .base import StatementFamily


class MimcStatement(StatementFamily):
    name = "mimc"

    def __init__(self, cfg: StarkConfig | None = None):
        super().__init__(cfg or StarkConfig())
