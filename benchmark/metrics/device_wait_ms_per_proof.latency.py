"""device_wait_ms_per_proof.latency: time inside the port's `entry.wait`
span (`verify_proof_bytes` fetching its verdict, which waits on the card)
in the traced window, over its calls."""

from benchmark.spans import ms_per


def read(run):
    return ms_per(run, "entry.wait", "calls")
