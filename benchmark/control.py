"""The control and the planted faults that `correct` has to catch.

The system runs no model and states no precision, so the control breaks
one guarantee the configurations state: every Merkle opening is bound to
its committed root.  `unbound_openings` makes the port's Merkle walks
report every branch as matching its root, as a verifier that skipped them
would; flips in witnesses and siblings then pass.  The faults plant what
can go wrong in a cell that answers requests: an answer altered where it
is produced (`flipped_answer`: the first verdict of each verifier
call inverted) and half of the batch left out (`half_batch`: the second
half of each call's batch never verified and reported as accepted).

    python3 -m benchmark.control --workload <cell> --patch <name> \
        --seeds <n> [<n> ...] --seconds <s>

runs the cell once a seed in this one process with the patch in place and
prints each run's compared numbers.  The benchmark's own runs never load
this module.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


@contextlib.contextmanager
def unbound_openings():
    import torch
    from stark_verifier_tpu_torch.ops import merkle
    from stark_verifier_tpu_torch.protocol import verify as V

    shared, groups = merkle.verify_groups_shared, V._verify_groups

    def all_ok(fn):
        return lambda gs: [torch.ones_like(c) for c in fn(gs)]

    merkle.verify_groups_shared = all_ok(shared)
    V._verify_groups = all_ok(groups)
    try:
        yield
    finally:
        merkle.verify_groups_shared, V._verify_groups = shared, groups


@contextlib.contextmanager
def _wrapped_forward(wrap):
    from stark_verifier_tpu_torch.protocol import verify as V
    classes = (V.MimcVerifier, V.GeneralMimcVerifier)
    real = {c: c.forward for c in classes}
    for c in classes:
        c.forward = wrap(real[c])
    try:
        yield
    finally:
        for c in classes:
            c.forward = real[c]


def flipped_answer():
    def wrap(fwd):
        def forward(self, tree, *args, **kw):
            out = fwd(self, tree, *args, **kw).clone()
            flat = out.view(-1)
            flat[0] = ~flat[0]
            return out
        return forward
    return _wrapped_forward(wrap)


def half_batch():
    import torch
    from stark_verifier_tpu_torch.proofio.device import tree_map

    def wrap(fwd):
        def forward(self, tree, *args, **kw):
            lead = tree["merkle_root"].shape[:-1]
            if not lead or lead[0] < 2:
                return torch.ones(lead, dtype=torch.bool,
                                  device=tree["merkle_root"].device)
            half = lead[0] // 2

            def cut(x):
                return x[:half] if x.dim() > 1 and x.shape[0] == lead[0] \
                    else x
            if len(args) == 3:          # the statement's input and output
                args = (cut(args[0]), args[1], cut(args[2]))
            got = fwd(self, tree_map(cut, tree), *args, **kw)
            rest = torch.ones((lead[0] - half,) + tuple(lead[1:]),
                              dtype=got.dtype, device=got.device)
            return torch.cat([got, rest])
        return forward
    return _wrapped_forward(wrap)


PATCHES = {"control": unbound_openings, "flipped_answer": flipped_answer,
           "half_batch": half_batch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run a cell with the control "
                                 "or a planted fault in the port's place")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--patch", required=True, choices=sorted(PATCHES))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from . import harness
    for seed in args.seeds:
        t0 = time.perf_counter()
        with PATCHES[args.patch]():
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 t_start=t0)
        print(json.dumps({"workload": args.workload, "patch": args.patch,
                          "seed": seed, "correct": r["correct"],
                          "compared": r["compared"],
                          "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
