"""The command line, mirroring the reference binary's behaviour.

Reference: src/main.rs:199-227 -- reads proof.bin, recomputes the MiMC
output, verifies, prints phase timings and `proof verified`.  This CLI adds
a proof path argument, batch mode, strictness and profiling flags, and exit
codes instead of a panic: 0 when every proof verifies, 1 when one is
rejected, 2 when the proof is malformed (or the arguments cannot be met).

Usage:
  python -m stark_verifier_tpu_torch.cli verify [PROOF.bin] [--batch N]
      [--profile] [--device cpu|cuda]
  python -m stark_verifier_tpu_torch.cli bench  [PROOF.bin] [--batch N]
      [--iters K] [--device cpu|cuda] [--devices N] [--ref-single-chip R]

--device defaults to the card; without one the command raises.  bench
--devices N > 1 verifies the batch on N ranks, one process each
(parallel/mesh.launch): on N cards over NCCL, or with --device cpu on N gloo
ranks on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np
import torch

log = logging.getLogger("stark_verifier_tpu_torch")


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
                            help="ranks to shard the batch over, one "
                                 "process and one card each (with --device "
                                 "cpu: gloo ranks on the CPU); 1 runs in "
                                 "this process")
            sp.add_argument("--ref-single-chip", type=float, default=None,
                            help="proofs/s of a 1-card run, for the "
                                 "scaling-efficiency line")
    return ap


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _parse(args, cfg):
    """The proof file, parsed and checked against the family."""
    from .proofio import wire
    with open(args.proof, "rb") as f:
        proof_bytes = f.read()
    try:
        return wire.parse_and_validate(proof_bytes, cfg)
    except wire.WireFormatError as e:
        raise Malformed(str(e)) from e


def _prepare(args, times, batch=None):
    """Parse the proof file, replicate it to the batch (args.batch, or
    `batch` proofs with a batch axis even for one) and copy it to the
    device.  Returns (device, verifier, batch tree on the device)."""
    from .config import StarkConfig
    from .proofio import device
    from .protocol import verify as V

    dev = device.resolve_device(args.device)
    cfg = StarkConfig(log_steps=args.log_steps, strict=args.strict)
    with times.phase("parse"):
        tree = parsed_tree = device.proof_tree(_parse(args, cfg))
        if batch is not None or args.batch > 1:
            tree = device.replicate_proof(tree, batch or args.batch)
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


def _bench_samples(args, fn, dev, times):
    """(seconds of each of args.iters calls of fn, or None when the warm
    call rejects)."""
    from .profiling import maybe_trace
    with times.phase("first call + warm"):
        if not fn():
            return None
    samples = []
    with maybe_trace(args.profile):
        for _ in range(args.iters):
            _sync(dev)
            t = time.perf_counter()
            fn()
            _sync(dev)
            samples.append(time.perf_counter() - t)
    return samples


def bench_rank(mesh, args):
    """One rank of `bench --devices N`: its share of the batch (the proof
    replicated), the sharded verifier, args.iters timed calls.  Returns
    (seconds of each call or None when the proof rejects, device name)."""
    from .parallel import mesh as M
    from .profiling import PhaseTimes
    times = PhaseTimes()
    args.device = str(mesh.device)
    _dev, one, tree = _prepare(args, times, batch=args.batch // mesh.size)
    fn = M.make_sharded_verifier(mesh, one.cfg, args.input,
                                 shared_merkle=one.shared_merkle)
    return (_bench_samples(args, lambda: fn(tree)[1], mesh.device, times),
            _device_name(mesh.device))


def _bench_devices(args):
    """bench --devices N > 1: N ranks through parallel/mesh.launch.
    Returns (exit code or None, (seconds of each call on the slowest rank,
    device name) or None when the proof rejects)."""
    from .config import StarkConfig
    from .parallel import mesh as M
    n = args.devices
    _parse(args, StarkConfig(log_steps=args.log_steps, strict=args.strict))
    if args.batch % n:
        print(f"--batch {args.batch} must be a multiple of --devices {n}",
              file=sys.stderr)
        return 2, None
    on_card = torch.device(args.device or "cuda").type == "cuda"
    if on_card:
        from .proofio import device
        device.resolve_device(args.device)        # raises without a card
        if n > torch.cuda.device_count():
            print(f"--devices {n}: this machine has "
                  f"{torch.cuda.device_count()} cards (several ranks on one "
                  f"card: parallel.mesh.launch with backend='gloo')",
                  file=sys.stderr)
            return 2, None
    ranks = M.launch(n, bench_rank, args, devices="cuda" if on_card else "cpu")
    if any(samples is None for samples, _ in ranks):
        return None, None
    p50 = [float(np.percentile(samples, 50)) for samples, _ in ranks]
    return None, ranks[int(np.argmax(p50))]


def cmd_bench(args):
    from .config import StarkConfig
    from .profiling import BenchReport, PhaseTimes, compressions_per_proof
    times = PhaseTimes()
    if args.devices > 1:
        code, got = _bench_devices(args)
        if code is not None:
            return code
    else:
        dev, fn, tree = _prepare(args, times)
        samples = _bench_samples(args, lambda: bool(fn(tree).all()), dev,
                                 times)
        got = None if samples is None else (samples, _device_name(dev))
    if got is None:
        print("proof rejected; refusing to bench a failing verify",
              file=sys.stderr)
        return 1
    samples, name = got
    report = BenchReport(
        batch=max(args.batch, 1), iters=args.iters,
        p50_s=float(np.percentile(samples, 50)),
        device=name, n_devices=args.devices,
        comp_per_proof=compressions_per_proof(
            StarkConfig(log_steps=args.log_steps)),
    )
    log.info("phases: %s",
             {k: round(v * 1e3, 1) for k, v in times.phases.items()})
    print(report.to_json())
    if args.ref_single_chip:
        eff = report.proofs_per_s_per_chip / args.ref_single_chip
        print(json.dumps({"scaling_efficiency": round(eff, 4),
                          "n_devices": args.devices,
                          "ref_single_chip_proofs_per_s":
                              args.ref_single_chip}))
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
