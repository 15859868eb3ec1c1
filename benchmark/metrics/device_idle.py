"""device_idle.throughput and device_idle.latency: percent of the traced
window that no device operation (kernel, copy or memset) covers."""

from benchmark.trace import idle_share


def read(run):
    return idle_share(run.traced) if run.traced and run.traced.ops else None
