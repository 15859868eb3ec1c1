"""glue_kernels_per_proof.throughput and .latency: device kernels that are
not the port's own (`stark_*`), copies and memsets left out, over the
verdicts delivered in the traced window."""

from benchmark.trace import glue_kernels


def read(run):
    t = run.traced
    if not t or not t.ops or not t.requests:
        return None
    return glue_kernels(t) / t.requests
