"""stream_wait_ms_per_proof.throughput: the launching thread's time inside
the port's `stream.wait_prepared` span (`verify_stream` waiting for the
worker to finish parsing a chunk) in the traced window, over the window's
verdicts: the part of the parse that the worker did not hide."""

from benchmark.spans import ms_per


def read(run):
    return ms_per(run, "stream.wait_prepared", "verdicts", launching=True)
