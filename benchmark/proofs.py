"""Honest proofs for a configuration, proved once and then read from a cache.

One statement has exactly one proof, and proving thousands of statements
does not fit in a set-up, so the traffic is built from one proof per
statement of the configuration (and one of a smaller family).  They are
proved by the frozen reference prover in parallel processes at the first run
in a checkout and kept in `cache/proofs/` beside this file; later runs only
read them.  A proof's file is named by its statement, so a changed
configuration proves only what it lacks.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from pathlib import Path

from .reference import verdict as ref
from .reference import wire_sites

CACHE = Path(__file__).resolve().parent / "cache" / "proofs"


@dataclass
class Proofs:
    inputs: list        # the statements' inputs
    outputs: list       # their claimed outputs, as the prover gives them
    blobs: list         # their proofs' wire bytes
    sites: list         # each proof's protocol-site byte ranges
    small: bytes        # the small family's proof of inputs[0] (or b"")


def _name(inp: int, log_steps: int, nc: int, power: int) -> str:
    return f"mimc_p{power}_s{log_steps}_c{nc}_in{inp}"


def _prove_to(path_stem: str, inp: int, log_steps: int, nc: int,
              power: int) -> None:
    """Worker: prove one statement and write `<stem>.bin` and `<stem>.out`."""
    blob, out = ref.prove(inp, log_steps, nc, power)
    stem = Path(path_stem)
    for suffix, data in ((".bin", blob), (".out", str(out).encode())):
        tmp = stem.with_name(f"{stem.name}{suffix}.tmp{os.getpid()}")
        tmp.write_bytes(data)
        os.replace(tmp, stem.with_suffix(suffix))   # whole or absent


def load(config: dict, traffic: dict, cache: Path | None = None,
         workers: int | None = None) -> Proofs:
    """The configuration's proofs, proving those not yet in the cache."""
    cache = Path(cache or CACHE)
    log_steps, nc = int(config["log_steps"]), int(config["num_constants"])
    power = int(config.get("power", 3))
    inputs = [int(x) for x in config.get("inputs", [config.get("input")])]
    wanted = [(i, log_steps) for i in inputs]
    small_log = traffic.get("small_family_log_steps")
    if traffic["block"].get("small_family"):
        wanted.append((inputs[0], int(small_log)))
    stems = {w: cache / _name(w[0], w[1], nc, power) for w in wanted}
    missing = [w for w, st in stems.items()
               if not (st.with_suffix(".bin").exists()
                       and st.with_suffix(".out").exists())]
    if missing:
        cache.mkdir(parents=True, exist_ok=True)
        n = max(1, min(len(missing), workers or os.cpu_count() or 1))
        with ProcessPoolExecutor(
                n, mp_context=multiprocessing.get_context("spawn")) as ex:
            futs = [ex.submit(_prove_to, str(stems[w]), w[0], w[1], nc,
                              power) for w in missing]
            for f in futs:
                f.result()
    blobs, outputs = [], []
    for i in inputs:
        st = stems[(i, log_steps)]
        blobs.append(st.with_suffix(".bin").read_bytes())
        outputs.append(int(st.with_suffix(".out").read_text()))
    small = b""
    if len(wanted) > len(inputs):
        small = stems[wanted[-1]].with_suffix(".bin").read_bytes()
    return Proofs(inputs, outputs, blobs,
                  [wire_sites.site_ranges(b) for b in blobs], small)
