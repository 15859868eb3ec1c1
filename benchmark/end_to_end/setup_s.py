"""setup_s: seconds from the start of the process to the opening of the
window (imports, the card, the kernel build on a miss, the proofs, the
statement tables and the warm-up)."""


def read(run):
    return run.setup_s
