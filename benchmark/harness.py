"""One run of one cell of `BENCHMARK.json`.

Everything a cell uses is found by its name (`found.py`): the
configuration in `configs/<name>.json`, the traffic mix in
`traffic/<name>.json` (data read by the one generator, `mix.py`, whose kinds
of request are `kinds/<kind>.py`), the loop that drives the port's entry in
`drivers/<driver>.py` (named by the mix), and each metric's reader in
`end_to_end/<name>.py` or `metrics/<name>.py`.  A later cell, mix or metric
is new files and new entries in `BENCHMARK.json`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

from . import check, proofs as proofmod
from .cores import Cores
from .found import HERE, load_json, load_module
from .mix import Mix
from .trace import Tracer, busy_ns

SPEC = HERE.parent / "BENCHMARK.json"
# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "stark_verifier_tpu")


class Unavailable(Exception):
    """The machine lacks what the cell asks for."""


def _listed(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_of(spec: dict, workload: str) -> dict:
    """The cell's entry, configuration, mix and metric entries."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    config = load_json("configs", w["config"])
    e2e = [m for m in spec["end_to_end"] if _listed(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return {"workload": w, "config": config,
            "traffic": load_json("traffic", w["traffic"]),
            "end_to_end": e2e, "per_layer": per_layer}


class Run:
    """The state of one run, shared by the cell's loop and the readers."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device, mix: Mix, t_start: float):
        self.name = cell["workload"]["name"]
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.seed, self.seconds, self.device, self.mix = seed, seconds, \
            device, mix
        self.tracer = Tracer(trace)
        self.cores = Cores()
        self.trace_seconds = float(self.traffic.get("trace_seconds", 2))
        self.t_start = t_start
        self.t_open = self.t_close = None
        self.setup_s = None
        self.delivered = []       # [(request, verdict)] in the window
        self.latencies = []       # seconds from call to verdict a request
        self.unanswered = 0       # requests due in the window with no verdict
        self.spans = {}           # name -> [(seconds, items)] in the window

    def stark_config(self):
        from stark_verifier_tpu_torch.config import StarkConfig
        c = self.config
        return StarkConfig(log_steps=int(c["log_steps"]),
                           num_constants=int(c["num_constants"]),
                           spot_checks=int(c["spot_checks"]),
                           fri_queries=int(c["fri_queries"]),
                           strict=bool(c["strict"]), power=int(c["power"]))

    def open(self) -> None:
        """Set-up ends and the window opens."""
        self.cores.bind()
        self.t_open = time.perf_counter()
        self.setup_s = self.t_open - self.t_start
        self.tracer.start()

    def maybe_stop_trace(self, requests: int) -> None:
        """At a delivery: end the traced part once it has lasted long
        enough."""
        tr = self.tracer
        if tr.running and time.perf_counter() - tr.started >= \
                self.trace_seconds:
            tr.stop(requests)

    def close(self, t: float) -> None:
        self.tracer.stop(len(self.delivered))
        self.t_close = t
        self.cores.release()

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def span(self, name: str, seconds: float, items: int) -> None:
        if self.t_open is not None and self.t_close is None:
            self.spans.setdefault(name, []).append((seconds, items))

    @property
    def traced(self):
        return self.tracer.traced


def _device_info(device) -> dict:
    import torch
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device=None, cell: dict | None = None,
             cache=None, workers: int | None = None) -> dict:
    """Set up, measure and check one run; the result's line as a dict.

    device=None asks for the card and raises Unavailable without one;
    tests pass device="cpu" and a `cell` of their own (cell_of's form) to
    drive the rest of a run on the CPU at a small size."""
    cell = cell or cell_of(json.loads(SPEC.read_text()), workload)
    if device is None:
        import torch
        need = int(cell["workload"]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise Unavailable(f"{workload} needs {need} CUDA device(s)")
    import stark_verifier_tpu_torch  # noqa: F401  (fails fast without it)
    if cell["config"].get("strict"):
        raise ValueError("the reference judges only non-strict verification "
                         "(trailing bytes tolerated, POINTS unchecked)")

    proofs = proofmod.load(cell["config"], cell["traffic"], cache, workers)
    mix = Mix(cell["traffic"], proofs, seed)
    run = Run(cell, seed, seconds, trace, device, mix, t_start)
    try:
        load_module("drivers", cell["traffic"]["driver"]).drive(run)
    finally:
        run.cores.release()

    dev_info = _device_info(device)
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"loaded once the window closed: {bad}")
    if dev_info["platform"] == "gpu":
        import torch
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    keys = check.choose([r for r, _ in run.delivered],
                        int(cell["traffic"]["reference_sample"]), seed)
    truth = check.reference_verdicts(keys, mix, cell["config"], workers)
    compared, wrong = check.compare(run.delivered, truth)
    reference_s = time.perf_counter() - t_ref
    kinds = {r[0] for r, _ in run.delivered
             if check.mixmod.content_key(r) in truth}
    missed = len(set(mix.block) - kinds)

    metrics = {}
    entries = cell["per_layer"] if trace else cell["end_to_end"]
    for m in entries:
        kind = "metrics" if trace else "end_to_end"
        v = load_module(kind, m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if trace and run.traced is not None:
        dev_info["busy_s"] = busy_ns(run.traced.ops) * 1e-9
        dev_info["window_s"] = run.traced.window_s

    checks = {
        "wrong_verdicts": {"value": wrong, "limit": 0},
        "unanswered": {"value": run.unanswered, "limit": 0},
        "kinds_not_compared": {"value": missed, "limit": 0},
    }
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(run.delivered) + run.unanswered,
        "failed": wrong + run.unanswered,
        "metrics": metrics,
        "device": dev_info,
        "card": _card() if dev_info["platform"] == "gpu" else "cpu",
        "compared": compared,
        "window_s": run.window_s,
        "reference_s": reference_s,
    }
    if trace and run.traced is not None:
        from .trace import breakdown
        result["breakdown"] = breakdown(run.traced)
    result["checks"] = checks
    return result
