"""The reference's verdict on one blob and statement.

Plain Python on the frozen oracle: it imports nothing of torch, of the port
or of the JAX package.  An assertion of the reference verifier, or a blob it
cannot parse, is a reject (the reference panics).
"""

from __future__ import annotations

from . import oracle


def constants(count: int) -> list:
    """The configuration's round constants (i^7) XOR 42 (src/main.rs:209-212)."""
    return [(i ** 7) ^ 42 for i in range(count)]


def mimc_output(inp: int, log_steps: int, num_constants: int,
                power: int = 3) -> int:
    """The statement's MiMC output (steps - 1 rounds, src/utils.rs:8-16)."""
    return oracle.mimc(inp, 1 << log_steps, constants(num_constants),
                       power=power)


def verdict(blob: bytes, inp: int, output: int, log_steps: int,
            num_constants: int, power: int = 3) -> bool:
    """Does the reference accept `blob` as a proof that MiMC takes `inp` to
    `output`?  The literal shape guards of the reference verifier
    (src/main.rs:50, 120) hold at 2^13 steps, its own family."""
    try:
        proof, _ = oracle.parse_proof(blob)
        return bool(oracle.verify_mimc_proof(
            inp, 1 << log_steps, constants(num_constants), output, proof,
            parity_guards=log_steps == 13, power=power))
    except (AssertionError, ValueError, IndexError):
        return False


def prove(inp: int, log_steps: int, num_constants: int,
          power: int = 3) -> tuple:
    """(wire bytes, claimed output) of an honest proof."""
    from . import prover
    return prover.prove_to_bytes(inp, 1 << log_steps, constants(num_constants),
                                 power=power)
