"""own_kernel_ms_per_proof.throughput: summed device time of the port's
own kernels (`stark_*`) in the traced window, over its verdicts."""

from benchmark.trace import own_kernel_ns


def read(run):
    t = run.traced
    if not t or not t.ops or not t.requests:
        return None
    return own_kernel_ns(t) * 1e-6 / t.requests
