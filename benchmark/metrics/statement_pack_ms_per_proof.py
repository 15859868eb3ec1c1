"""statement_pack_ms_per_proof.throughput: the stream worker's time inside
the port's `stream.statements` span (`verify_stream` packing a chunk's
run-time statements as limbs beside its tree) in the traced window, over
the window's verdicts.  Nothing where the port has no such span."""

from benchmark.spans import ms_per


def read(run):
    return ms_per(run, "stream.statements", "verdicts")
