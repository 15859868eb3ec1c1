"""Driver `batch`: a library user verifying many statements at once.

Each batch of the mix's `batch` blobs is parsed on the host by
`proofio.ingest.ingest_chunk` (`threads` threads, pinned buffers), copied to
the card and verified by `protocol.verify.make_general_verifier` with one
statement a proof (input and claimed output limbs [B, 16], the round
constants [k, 16]); the verdicts are ANDed with the parse's on the host.
Batches run one after another: the parse is not overlapped.  The first
`warm_batches` are set-up; the window closes at the end of the first batch
that ends after `seconds`.  The benchmark's span around `ingest_chunk` is
`host_parse`; the parse pool runs off the launching thread's core.
"""

import time


def drive(run):
    import numpy as np
    import torch
    from stark_verifier_tpu_torch import fp
    from stark_verifier_tpu_torch.proofio import device as pdev, ingest
    from stark_verifier_tpu_torch.protocol.verify import make_general_verifier

    from benchmark.reference.verdict import constants

    t, c = run.traffic, run.config
    cfg = run.stark_config()
    dev = pdev.resolve_device(run.device)
    size, threads = int(t["batch"]), int(t["threads"])
    fn, _ = make_general_verifier(cfg, shared_merkle=True, device=dev)
    consts = pdev.to_tensor(fp.ints_to_limbs(constants(int(c["num_constants"]))),
                            dev)
    rows = {}

    def limbs(xs):
        for x in xs:
            if x not in rows:
                rows[x] = fp.int_to_limbs(x)
        return pdev.to_tensor(np.stack([rows[x] for x in xs]), dev)

    requests = run.mix.requests()
    layout = None

    def one_batch():
        nonlocal layout
        reqs = [next(requests) for _ in range(size)]
        blobs = [run.mix.blob(r) for r in reqs]
        inp, out = zip(*(run.mix.statement(r) for r in reqs))
        t0 = time.perf_counter()
        with run.cores.spawning():          # the parse pool's threads
            tree, ok, layout = ingest.ingest_chunk(blobs, cfg, layout,
                                                   threads=threads,
                                                   pin=dev.type == "cuda")
        run.span("host_parse", time.perf_counter() - t0, len(blobs))
        if tree is None:
            return reqs, np.zeros(len(reqs), dtype=bool)
        dtree = pdev.tree_map(lambda x: x.to(dev, non_blocking=True), tree)
        verdicts = fn(dtree, limbs(inp), consts, limbs(out))
        return reqs, verdicts.cpu().numpy() & ok

    for _ in range(int(t["warm_batches"])):
        one_batch()
    run.open()
    while True:
        reqs, verdicts = one_batch()
        run.unanswered += max(0, len(reqs) - len(verdicts))
        run.delivered.extend(zip(reqs, (bool(v) for v in verdicts)))
        now = time.perf_counter()
        run.maybe_stop_trace(len(run.delivered))
        if now - run.t_open >= run.seconds:
            run.close(now)
            return
