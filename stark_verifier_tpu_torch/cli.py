"""The command line, mirroring the reference binary's behaviour.

Reference: src/main.rs:199-227 -- reads proof.bin, recomputes the MiMC
output, verifies, prints phase timings and `proof verified`.  This CLI adds
a proof path argument, batch mode, strictness and profiling flags, and exit
codes instead of a panic: 0 when every proof verifies, 1 when one is
rejected, 2 when the proof is malformed (or the arguments ask for what is
not ported).

Usage:
  python -m stark_verifier_tpu_torch.cli verify [PROOF.bin] [--batch N]
      [--profile] [--device cpu|cuda]
  python -m stark_verifier_tpu_torch.cli bench  [PROOF.bin] [--batch N]
      [--iters K] [--device cpu|cuda]

--device defaults to the card; without one the command raises.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np
import torch

log = logging.getLogger("stark_verifier_tpu_torch")

MULTI_GPU = "multi-GPU is not ported yet"


class Malformed(Exception):
    """The proof file does not parse as a proof of the family."""


def _build_parser():
    ap = argparse.ArgumentParser(prog="stark_verifier_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("verify", "bench"):
        sp = sub.add_parser(name)
        sp.add_argument("proof", nargs="?", default="proof.bin",
                        help="path to serialized proof (default: ./proof.bin)")
        sp.add_argument("--batch", type=int, default=1,
                        help="replicate the proof to a batch of this size")
        sp.add_argument("--input", type=int, default=3,
                        help="MiMC input (reference hardcodes 3, main.rs:206)")
        sp.add_argument("--log-steps", type=int, default=13)
        sp.add_argument("--strict", action="store_true",
                        help="also bind the FRI POINTS element to the final "
                             "committed root (the check the reference skips)")
        sp.add_argument("--profile", action="store_true",
                        help="write a torch.profiler trace to ./trace")
        sp.add_argument("--device", default=None,
                        help="torch device (default: the card)")
        if name == "bench":
            sp.add_argument("--iters", type=int, default=20)
            sp.add_argument("--devices", type=int, default=1,
                            help=f"cards to shard over ({MULTI_GPU}: only 1)")
            sp.add_argument("--ref-single-chip", type=float, default=None,
                            help=f"proofs/s of a 1-card run ({MULTI_GPU})")
    return ap


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _prepare(args, times):
    """Parse the proof file, replicate it to the batch and copy it to the
    device.  Returns (device, verifier, batch tree on the device)."""
    from .config import StarkConfig
    from .proofio import device, wire
    from .protocol import verify as V

    dev = device.resolve_device(args.device)
    cfg = StarkConfig(log_steps=args.log_steps, strict=args.strict)
    with times.phase("parse"):
        with open(args.proof, "rb") as f:
            proof_bytes = f.read()
        try:
            parsed = wire.parse_and_validate(proof_bytes, cfg)
        except wire.WireFormatError as e:
            raise Malformed(str(e)) from e
        tree = parsed_tree = device.proof_tree(parsed)
        if args.batch > 1:
            tree = device.replicate_proof(tree, args.batch)
    shared = device.is_rectangular(parsed_tree)
    with times.phase("h2d"):
        tree = device.to_device(tree, dev)
        _sync(dev)
    fn, _tables = V.make_verifier(cfg, inp=args.input, shared_merkle=shared,
                                  device=dev)
    return dev, fn, tree


def _device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def cmd_verify(args):
    from .profiling import PhaseTimes, maybe_trace
    times = PhaseTimes()
    dev, fn, tree = _prepare(args, times)

    with times.phase("verify (first call)"):
        verdicts = fn(tree).cpu().numpy()

    if args.profile:
        with maybe_trace(True):
            with times.phase("verify (steady state)"):
                fn(tree).cpu()

    for name, secs in times.phases.items():
        print(f"{name}: {secs * 1e3:.1f} ms")
    if bool(verdicts.all()):
        print("proof verified")
        return 0
    bad = np.flatnonzero(~np.atleast_1d(verdicts))
    print(f"proof REJECTED (batch indices: {bad.tolist()})")
    return 1


def cmd_bench(args):
    from .config import StarkConfig
    from .profiling import (BenchReport, PhaseTimes, compressions_per_proof,
                            maybe_trace)
    if args.devices != 1 or args.ref_single_chip is not None:
        print(MULTI_GPU, file=sys.stderr)
        return 2
    times = PhaseTimes()
    dev, fn, tree = _prepare(args, times)
    with times.phase("first call + warm"):
        verdicts = fn(tree).cpu().numpy()
    if not verdicts.all():
        print("proof rejected; refusing to bench a failing verify",
              file=sys.stderr)
        return 1
    samples = []
    with maybe_trace(args.profile):
        for _ in range(args.iters):
            _sync(dev)
            t = time.perf_counter()
            fn(tree)
            _sync(dev)
            samples.append(time.perf_counter() - t)
    report = BenchReport(
        batch=max(args.batch, 1), iters=args.iters,
        p50_s=float(np.percentile(samples, 50)),
        device=_device_name(dev), n_devices=1,
        comp_per_proof=compressions_per_proof(
            StarkConfig(log_steps=args.log_steps)),
    )
    log.info("phases: %s",
             {k: round(v * 1e3, 1) for k, v in times.phases.items()})
    print(report.to_json())
    return 0


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    args = _build_parser().parse_args(argv)
    try:
        if args.cmd == "verify":
            return cmd_verify(args)
        return cmd_bench(args)
    except Malformed as e:
        print(f"malformed proof: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
