"""Driver `single`: a light client checking one proof at a time.

One client calls `verify_proof_bytes(blob, inp, log_steps)` on the mix's
blobs in a closed loop; a request's latency runs from the call to the
verdict on the host.  `warm_calls` calls on an honest proof are set-up; the
window closes at the end of the first request that ends after `seconds`.
"""

import time


def drive(run):
    from stark_verifier_tpu_torch import verify_proof_bytes

    c = run.config
    inp, log_steps = int(c["input"]), int(c["log_steps"])
    honest = run.mix.blob(("honest", 0, 0, 0))
    for _ in range(int(run.traffic["warm_calls"])):
        verify_proof_bytes(honest, inp=inp, log_steps=log_steps,
                           device=run.device)
    run.open()
    for req in run.mix.requests():
        blob = run.mix.blob(req)
        t0 = time.perf_counter()
        verdict = verify_proof_bytes(blob, inp=inp, log_steps=log_steps,
                                     device=run.device)
        t1 = time.perf_counter()
        run.latencies.append(t1 - t0)
        run.delivered.append((req, verdict))
        run.maybe_stop_trace(len(run.delivered))
        if t1 - run.t_open >= run.seconds:
            run.close(t1)
            return
