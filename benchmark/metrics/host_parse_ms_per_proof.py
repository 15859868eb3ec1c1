"""host_parse_ms_per_proof.throughput: the benchmark's span around
`proofio.ingest.ingest_chunk`, summed over the window's batches, over the
blobs it parsed."""


def read(run):
    spans = run.spans.get("host_parse")
    if not spans:
        return None
    return sum(s for s, _ in spans) * 1e3 / sum(n for _, n in spans)
