"""Driver `stream`: the service's path from bytes to verdicts.

`parallel.mesh.verify_stream` over an endless iterator of the mix's blobs,
in chunks of the mix's `chunk` with the host parse on `threads` threads (or
the device parse with `device_parse`).  The first `warm_chunks` chunks are
set-up; the window then runs from the delivery of the last warm verdict to
the delivery of the first whole chunk after `seconds`.  Verdicts arrive one
chunk behind the dispatch, in order; a missing or repeated index counts as
unanswered.
"""

import time


def drive(run):
    from stark_verifier_tpu_torch.parallel import mesh

    t = run.traffic
    chunk = int(t["chunk"])
    sent = []                                 # request of each global index

    def blobs():
        for req in run.mix.requests():
            sent.append(req)
            yield run.mix.blob(req)

    stream = mesh.verify_stream(
        blobs(), chunk=chunk, cfg=run.stark_config(),
        inp=int(run.config["input"]), threads=int(t["threads"]),
        device_parse=bool(t.get("device_parse", False)), device=run.device)
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
