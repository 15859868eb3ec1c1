"""Tracing and metrics for verification runs.

Named phase timers (torch.profiler record_function ranges when tracing), a
structured report for benchmark runs (proofs/s, proofs/s a card, Blake2s
compressions/s, p50 time of a call) and an optional torch.profiler trace.
The reference's only instrumentation is two wall-clock prints
(src/main.rs:214-226).  The host clock times what the caller sees: callers
synchronize the device inside a phase whose device work it must cover.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field, asdict

import torch


def compressions_per_proof(cfg=None) -> int:
    """Blake2s compressions one verification performs, derived from the
    statement family.

    With log_p = log2(precision), the level-l column tree has
    precision/4^(l+1) leaves quad-packed into 2^(log_p-2l-4) nodes ->
    log_p-2l-3 witness hashes after the leaf-pair hash; row trees sit one
    fold higher (log_p-2l-1); main/lincomb walk the full domain tree
    (log_p-1).  Each branch pays 1 leaf-pair compression (3 for the 96-byte
    main leaves: H(value||sibling) over 192 bytes = 3 64-byte blocks) plus
    one per witness.  Index PRGs read 8 indices per 32-byte digest starting
    from the seed root itself (utils.rs:67), so a group of n indices costs
    ceil(n/8)-1 hashes; k1..k4 are 4 more (main.rs:131-146)."""
    from .config import StarkConfig
    cfg = cfg or StarkConfig()
    log_p = cfg.precision.bit_length() - 1
    q, s = cfg.fri_queries, cfg.spot_checks
    total = 4                                      # k1..k4
    for l in range(cfg.fri_levels):
        total += q * (1 + (log_p - 2 * l - 3))     # column branches
        total += 4 * q * (1 + (log_p - 2 * l - 1))  # row branches
        total += -(-q // 8) - 1                    # per-level index PRG
    total += 2 * s * (3 + (log_p - 1))             # main (3-block leaves)
    total += s * (1 + (log_p - 1))                 # lincomb
    total += -(-s // 8) - 1                        # spot-check index PRG
    return total


# default-family constant kept for callers that don't thread a cfg
COMPRESSIONS_PER_PROOF = compressions_per_proof()


@dataclass
class PhaseTimes:
    phases: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        with torch.profiler.record_function(name):
            t = time.perf_counter()
            yield
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t)


@dataclass
class BenchReport:
    batch: int
    iters: int
    p50_s: float
    device: str
    n_devices: int = 1
    comp_per_proof: int = COMPRESSIONS_PER_PROOF   # cfg-derived: pass
    # compressions_per_proof(cfg) for non-default families

    @property
    def proofs_per_s(self) -> float:
        return self.batch / self.p50_s

    @property
    def proofs_per_s_per_chip(self) -> float:
        return self.proofs_per_s / max(self.n_devices, 1)

    @property
    def compressions_per_s(self) -> float:
        return self.proofs_per_s * self.comp_per_proof

    def to_json(self) -> str:
        d = asdict(self)
        d.update(proofs_per_s=round(self.proofs_per_s, 2),
                 proofs_per_s_per_chip=round(self.proofs_per_s_per_chip, 2),
                 compressions_per_s=round(self.compressions_per_s))
        return json.dumps(d)


@contextlib.contextmanager
def maybe_trace(enable: bool, out_dir: str = "./trace"):
    """With enable, run torch.profiler over the host and (where there is
    one) the card, and write a Chrome trace under out_dir."""
    if not enable:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        out_dir, f"trace-{os.getpid()}-{time.strftime('%Y%m%d-%H%M%S')}.json"))
