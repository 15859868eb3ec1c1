"""glue_dispatch_ms_per_proof.throughput and .latency: the launching
thread's time inside the port's `verify` span (`verify_mimc_proof`: the
host dispatching the protocol glue and the kernels) in the traced window,
over the window's verdicts."""

from benchmark.spans import ms_per


def read(run):
    return ms_per(run, "verify", "verdicts", launching=True)
