"""The port's host parse against its floor, a plain copy of each blob, in ms a
proof.

    python3 tools/parse_floor.py [--log-steps 13] [--ring 1024] [--chunk 512]
                                 [--reps 7] [--threads 2 4]

Proves one proof (tests/prover.py, input 3, the constants (i^7) XOR 42),
copies it into a ring of `ring` distinct blobs (out of the caches, as the
benchmark's batch cell cycles its blobs) and times, on each thread count,
over chunks taken in turn from the ring: `copy` (svt_pack_many, one memcpy a
blob into a row of its size), `one_pass` (svt_pass_many on a kept layout),
`scan` and `fill` (svt_scan_many, svt_fill_many: the two-pass route) and
`ingest_chunk` whole on the kept layout.  Each is the median of `reps`
calls.  Prints one JSON line.  Imports the port only (host code; no card).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from stark_verifier_tpu_torch import native                    # noqa: E402
from stark_verifier_tpu_torch.config import StarkConfig        # noqa: E402
from stark_verifier_tpu_torch.proofio import ingest            # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-steps", type=int, default=13)
    ap.add_argument("--ring", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--threads", type=int, nargs="+", default=[2, 4])
    args = ap.parse_args(argv)

    import prover
    pb = prover.prove_to_bytes(3, 1 << args.log_steps,
                               [(i ** 7) ^ 42 for i in range(64)])[0]
    ring = [bytes(bytearray(pb)) for _ in range(args.ring)]
    cfg = StarkConfig(log_steps=args.log_steps)
    lib = native.get_lib()
    B = args.chunk
    _t, ok, layout = ingest.ingest_chunk(ring[:B], cfg, threads=2)
    if not ok.all():
        raise RuntimeError("the parse rejected a copy of the proof")
    out = np.zeros((B, -(-len(pb) // 4)), dtype=np.uint32)
    rows = np.arange(B)
    at = 0

    def chunk():
        nonlocal at
        blobs = [ring[(at + j) % len(ring)] for j in range(B)]
        at = (at + B) % len(ring)
        return blobs

    def ms(fn):
        """Median ms a proof of fn(blobs) over `reps` fresh chunks."""
        times = []
        for _ in range(args.reps):
            blobs = chunk()
            t0 = time.perf_counter()
            fn(blobs)
            times.append((time.perf_counter() - t0) * 1e3 / B)
        return statistics.median(times)

    def checked(rcs):
        if np.any(rcs):
            raise RuntimeError(f"return codes {sorted(set(rcs.tolist()))}")

    res = {"blob_bytes": len(pb), "ring": len(ring), "chunk": B}
    for t in args.threads:
        res[f"threads_{t}"] = {
            "copy": ms(lambda b: native.pack_many(lib, native.Blobs(b), out,
                                                  t)),
            "one_pass": ms(lambda b: checked(layout.one_pass(
                lib, native.Blobs(b), False, t))),
            "scan": ms(lambda b: checked(native.scan_many(
                lib, native.Blobs(b), t)[1])),
            "fill": ms(lambda b: checked(layout.fill(
                lib, native.Blobs(b), rows, t))),
            "ingest_chunk": ms(lambda b: ingest.ingest_chunk(
                b, cfg, layout, threads=t)),
        }
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
