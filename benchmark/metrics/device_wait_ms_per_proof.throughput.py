"""device_wait_ms_per_proof.throughput: time inside the port's
`stream.wait_verdicts` span (`verify_stream` fetching a chunk's verdicts,
which waits on the card) in the traced window, over the window's
verdicts."""

from benchmark.spans import ms_per


def read(run):
    return ms_per(run, "stream.wait_verdicts", "verdicts")
