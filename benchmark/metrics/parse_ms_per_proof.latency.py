"""parse_ms_per_proof.latency: time inside the port's `entry.parse` span
(`verify_proof_bytes` parsing and validating one blob) in the traced window,
over its calls."""

from benchmark.spans import ms_per


def read(run):
    return ms_per(run, "entry.parse", "calls")
