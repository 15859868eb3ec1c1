"""proofs_per_s: verdicts delivered in the window over its seconds."""

from benchmark.window import rate


def read(run):
    return rate(len(run.delivered), run.window_s)
