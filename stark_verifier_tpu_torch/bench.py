"""Benchmark: batched MiMC-STARK verifications/s on one card.

    python -m stark_verifier_tpu_torch.bench PROOF [BATCH ITERS]
    python -m stark_verifier_tpu_torch.bench PROOF --stream [N CHUNK]
        [--device-parse]
    python -m stark_verifier_tpu_torch.bench --ntt [LO HI]

(plus --log-steps L for a proof of another family, and --device; the
default device is the card, and without one the bench raises.)

Batch mode replicates the proof to BATCH (default 8,192) proofs on the
device and times ITERS (default 10) verifier calls, chunked by STARK_CHUNK
(default 512) proofs; STARK_SHARED_MERKLE=0 takes the independent Merkle
walk.  It then times single-proof latency (STARK_BENCH_LATENCY=0 skips):
the tree already on the device, with its host-to-device copy, and from the
proof's bytes (parse included).  Stream mode verifies N (default 4,096)
distinct byte blobs in chunks of CHUNK (default 512) through
parallel.mesh.verify_stream: parse -> host-to-device copy -> verify, or with
--device-parse pack -> one copy -> parse on the device -> verify.

NTT mode (the counterpart of the JAX package's tools/bench_ntt.py) times
the standalone n-point NTT (ops/ntt.ntt) for n = 2^LO .. 2^HI (default 13
to 20) on seeded values resident on the device: for each size a line with
ms a transform (the device synchronized around the timed calls; nothing is
copied to the host), Melem/s, the seconds to build the host twiddle tables
and the kernel launches a transform; then one JSON line with every size and
the card's name and power limit.

Prints ONE JSON line on stdout (batch mode: the BenchReport on stderr too):
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
vs_baseline is throughput over 5.56 proofs/s, the pure-Python oracle's 0.18 s
a verification on one CPU core.  A proof that rejects is not benched.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

BASELINE_PROOFS_PER_S = 1 / 0.18  # Python oracle, 1 CPU core


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def bench_stream(proof_bytes: bytes, n_proofs: int, chunk: int, cfg, dev,
                 device_parse: bool = False) -> dict:
    """System throughput: N DISTINCT byte blobs through the full ingestion
    path, the honest end-to-end figure (the reference's main() times
    deserialization too, main.rs:200-204)."""
    from .parallel import mesh as M

    blobs = [bytes(bytearray(proof_bytes)) for _ in range(n_proofs)]
    warm = list(M.verify_stream(blobs[:chunk], chunk=chunk, cfg=cfg,
                                device_parse=device_parse, device=dev))
    if not all(v for _, v in warm):
        raise SystemExit("the proof rejects; refusing to bench")

    _sync(dev)
    t0 = time.perf_counter()
    results = list(M.verify_stream(blobs, chunk=chunk, cfg=cfg,
                                   device_parse=device_parse, device=dev))
    dt = time.perf_counter() - t0
    if len(results) != n_proofs or not all(v for _, v in results):
        raise SystemExit("the stream rejected a copy of the proof")
    rate = n_proofs / dt
    return {
        "metric": "stream MiMC-STARK verifications/s (1 card, "
                  + ("device-parse+H2D+verify)" if device_parse
                     else "parse+H2D+verify)"),
        "value": round(rate, 2),
        "unit": "proofs/s",
        "vs_baseline": round(rate / BASELINE_PROOFS_PER_S, 2),
        "n_proofs": n_proofs, "chunk": chunk,
        "device_parse": device_parse,
        "wire_MBps": round(len(proof_bytes) * n_proofs / dt / 1e6, 1),
        "device": _device_name(dev),
    }


def bench_batch(proof_bytes: bytes, batch: int, iters: int, cfg, dev) -> dict:
    from .profiling import BenchReport, compressions_per_proof
    from .proofio import device, wire
    from .protocol import verify as V

    one = device.proof_tree(wire.parse_proof_fast(proof_bytes))
    tree = device.to_device(device.replicate_proof(one, batch), dev)
    shared = os.environ.get("STARK_SHARED_MERKLE", "1") == "1"
    chunk = int(os.environ.get("STARK_CHUNK", "512"))
    if batch > chunk and batch % chunk:
        raise SystemExit(f"STARK_CHUNK={chunk} does not divide batch {batch}")
    if batch > chunk:
        fn, _ = V.make_chunked_verifier(cfg, chunk=chunk,
                                        shared_merkle=shared, device=dev)
    else:
        fn, _ = V.make_verifier(cfg, shared_merkle=shared, device=dev)
    if not bool(fn(tree).all()):
        raise SystemExit("golden proof rejected -- refusing to bench")

    times = []
    for _ in range(iters):
        _sync(dev)
        t = time.perf_counter()
        ok = fn(tree).cpu()          # the verdicts on the host end the call
        times.append(time.perf_counter() - t)
        if not bool(ok.all()):
            raise SystemExit("a timed call rejected the golden proof")

    lat = {}
    if os.environ.get("STARK_BENCH_LATENCY", "1") == "1":
        fn1, _ = V.make_verifier(cfg, shared_merkle=shared, device=dev)
        dev1 = device.to_device(one, dev)

        def p50(f, n=30):
            f()                                      # warm
            ts = []
            for _ in range(n):
                _sync(dev)
                t = time.perf_counter()
                if not bool(f().cpu().all()):
                    raise SystemExit("a latency call rejected the proof")
                ts.append(time.perf_counter() - t)
            return round(float(np.percentile(ts, 50)) * 1e3, 2)

        lat["latency_p50_ms_device"] = p50(lambda: fn1(dev1))
        lat["latency_p50_ms_e2e"] = p50(
            lambda: fn1(device.to_device(one, dev)))
        lat["latency_p50_ms_bytes"] = p50(lambda: fn1(device.to_device(
            device.proof_tree(wire.parse_and_validate(proof_bytes, cfg)),
            dev)))

    report = BenchReport(batch=batch, iters=iters,
                         p50_s=float(np.percentile(times, 50)),
                         device=_device_name(dev), n_devices=1,
                         comp_per_proof=compressions_per_proof(cfg))
    print(report.to_json(), file=sys.stderr)   # full metrics report
    return {
        "metric": "batched MiMC-STARK verifications/s (1 card)",
        "value": round(report.proofs_per_s, 2),
        "unit": "proofs/s",
        "vs_baseline": round(report.proofs_per_s / BASELINE_PROOFS_PER_S, 2),
        **lat,
    }


def _card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e.__class__.__name__})"
    return out.strip().splitlines()[0]


def bench_ntt(lo: int, hi: int, dev) -> dict:
    """ms a transform, Melem/s, host table seconds and launches a transform
    of ops/ntt.ntt at 2^lo .. 2^hi points."""
    from . import fp
    from .ops import field_cuda, ntt

    P = fp.MODULUS
    sizes = {}
    for logn in range(lo, hi + 1):
        n = 1 << logn
        root = pow(7, (P - 1) // n, P)
        rng = np.random.RandomState(logn)
        limbs = rng.randint(0, 1 << 16, (n, fp.NLIMBS)).astype(np.int32)
        limbs[:, -1] %= 0xFFFF                    # canonical values, < p
        x = torch.from_numpy(limbs).to(dev)
        t0 = time.perf_counter()
        if dev.type == "cuda":
            ntt._card_tables(root, n, P, str(x.device))
        else:
            ntt._twiddle_stages(root, n, P)
        tables_s = time.perf_counter() - t0
        counts = sum(ntt.launches.values()) + field_cuda.launches["mul_mod"]
        ntt.ntt(x, root)                          # warm
        launches = (sum(ntt.launches.values())
                    + field_cuda.launches["mul_mod"] - counts)
        iters = max(3, min(50, (1 << 24) // n))
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            ntt.ntt(x, root)
        _sync(dev)
        dt = (time.perf_counter() - t0) / iters
        sizes[f"2^{logn}"] = {"ms": dt * 1e3, "Melem_per_s": n / dt / 1e6,
                              "tables_s": tables_s, "launches": launches,
                              "iters": iters}
        print(f"2^{logn:2d}: {dt * 1e3:9.4f} ms  {n / dt / 1e6:9.1f} Melem/s"
              f"  tables {tables_s:.3f} s  {launches} launches a transform",
              flush=True)
    return {"metric": "standalone NTT (ops/ntt.ntt, forward)",
            "sizes": sizes, "device": _device_name(dev),
            "card": _card_line() if dev.type == "cuda" else "cpu"}


def main(argv=None):
    from .config import StarkConfig
    from .proofio import device

    ap = argparse.ArgumentParser(prog="stark_verifier_tpu_torch.bench")
    ap.add_argument("proof", nargs="?", help="path to a serialized proof")
    ap.add_argument("numbers", nargs="*", type=int,
                    help="BATCH ITERS, or with --stream N CHUNK")
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--ntt", nargs="*", type=int, metavar="LOG",
                    help="NTT mode: log2 of the first and last size "
                    "(default 13 20)")
    ap.add_argument("--device-parse", action="store_true")
    ap.add_argument("--log-steps", type=int, default=13)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_intermixed_args(argv)
    dev = device.resolve_device(args.device)
    if args.ntt is not None:
        lo, hi = (args.ntt + [13, 20][len(args.ntt):])[:2]
        print(json.dumps(bench_ntt(lo, hi, dev)))
        return
    if args.proof is None:
        ap.error("a proof is needed (or --ntt)")
    cfg = StarkConfig(log_steps=args.log_steps)
    with open(args.proof, "rb") as f:
        proof_bytes = f.read()
    nums = args.numbers
    if args.stream:
        out = bench_stream(proof_bytes, nums[0] if nums else 4096,
                           nums[1] if len(nums) > 1 else 512, cfg, dev,
                           device_parse=args.device_parse)
    else:
        out = bench_batch(proof_bytes, nums[0] if nums else 8192,
                          nums[1] if len(nums) > 1 else 10, cfg, dev)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
