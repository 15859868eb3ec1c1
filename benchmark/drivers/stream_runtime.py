"""Driver `stream_runtime`: the service's path from bytes to verdicts when
each proof comes with its own statement.

`parallel.mesh.verify_stream` over an endless iterator of the mix's blobs
and, in step with it, each request's (input, claimed output), with the
configuration's round constants, in chunks of the mix's `chunk` with the
host parse on `threads` threads.  The window and the delivery checks are
the `stream` driver's: the first `warm_chunks` chunks are set-up; the
window runs from the delivery of the last warm verdict to the delivery of
the first whole chunk after `seconds`; a missing or repeated index counts
as unanswered.  A port whose stream takes no statements fails at the
call, before any chunk.
"""

import itertools
import time


def drive(run):
    from stark_verifier_tpu_torch.parallel import mesh

    from benchmark.reference.verdict import constants

    t = run.traffic
    chunk = int(t["chunk"])
    sent = []                                 # request of each global index

    def requests():
        for req in run.mix.requests():
            sent.append(req)
            yield req

    for_blobs, for_statements = itertools.tee(requests())
    stream = mesh.verify_stream(
        map(run.mix.blob, for_blobs), chunk=chunk, cfg=run.stark_config(),
        statements=map(run.mix.statement, for_statements),
        constants=constants(int(run.config["num_constants"])),
        threads=int(t["threads"]), device=run.device)
    warm = int(t["warm_chunks"]) * chunk
    expect = 0
    try:
        for gi, _ in stream:
            expect = gi + 1
            if expect >= warm:
                break
        run.open()
        for gi, verdict in stream:
            if gi != expect:
                run.unanswered += abs(gi - expect)
            run.delivered.append((sent[gi], verdict))
            expect = gi + 1
            if expect % chunk:
                continue
            now = time.perf_counter()
            run.maybe_stop_trace(len(run.delivered))
            if now - run.t_open >= run.seconds:
                run.close(now)
                break
    finally:
        stream.close()
