"""latency_p50_ms: the median, over all requests of the window, of the
time from the call to the verdict on the host."""

from benchmark.window import percentile


def read(run):
    return percentile(run.latencies, 50) * 1e3 if run.latencies else None
