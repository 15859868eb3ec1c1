"""parse_ms_per_proof.throughput: time inside the port's `parse` span
(`proofio.ingest.ingest_chunk`) on any thread in the traced window, over the
proofs those spans parsed."""

from benchmark.spans import ms_per


def read(run):
    return ms_per(run, "parse", "proofs")
