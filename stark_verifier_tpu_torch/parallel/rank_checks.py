"""Rank programs: what every rank of a launched world runs to check and time
the multi-rank paths of parallel/mesh.py (the sharded verifier, the sharded
blob verifier, the stream and point parallelism).  chip_smoke.py and the
tests launch them; a spawned rank imports them by name, so they live here
and not in a script's __main__.

    mesh.launch(n, run_steps, [(step_fn, kwargs), ...], devices=...)

runs the steps on every rank in order.  A step function takes the rank's
Mesh first and returns something picklable; run_steps records, a step each,
its result, the rank's own kernel launches by name during it (every count
set to 0 just before, read just after), its verify calls by walk and by
how they ran (a replayed CUDA graph launches nothing from Python) and its
seconds.  Proofs cross to
the ranks as a few distinct blobs by kind (`kinds`, {name: bytes}) and a
list of kind names, so that a batch of thousands of full-width proofs costs
a few megabytes to send; each rank parses a kind once.
"""

from __future__ import annotations

import ctypes
import statistics
import time

import torch
import torch.distributed as dist

from ..config import StarkConfig
import numpy as np

from .. import _build, fp
from ..ops import (blake2s_cuda, field_cuda, fri_cuda, merkle_cuda, mimc, ntt,
                   spot_cuda)
from ..proofio import device as pdevice
from ..proofio import wire
from ..protocol import verify as V
from . import mesh as M
from . import ntt as pntt

KERNEL_MODULES = (merkle_cuda, fri_cuda, spot_cuda, field_cuda, ntt, mimc,
                  blake2s_cuda)


def _sync(mesh: M.Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def launch_counts() -> dict:
    """Every kernel's launches since the last reset, by name."""
    counts = {}
    for mod in KERNEL_MODULES:
        counts.update(mod.launches)
    return counts


def reset_counts() -> None:
    for mod in KERNEL_MODULES:
        for name in mod.launches:
            mod.launches[name] = 0


def run_steps(mesh: M.Mesh, steps) -> dict:
    """Run [(fn, kwargs), ...] in order: {"joined": the wall clock when this
    rank had joined its world, "steps": [{"result", "launches", "calls",
    "seconds"} a step]}, `calls` the step's verify calls as
    protocol/verify.graph_counts counts them, by (walk, how they ran)."""
    joined = time.time()
    out = []
    for fn, kwargs in steps:
        _sync(mesh)
        reset_counts()
        calls = V.graph_counts.copy()
        t0 = time.perf_counter()
        result = fn(mesh, **kwargs)
        _sync(mesh)
        out.append({"result": result, "launches": launch_counts(),
                    "calls": V.graph_counts - calls,
                    "seconds": time.perf_counter() - t0})
    return {"joined": joined, "steps": out}


def _trees(kinds: dict, names, cfg: StarkConfig) -> dict:
    """{kind: numpy proof tree} for the kinds `names` use, each parsed once."""
    return {k: pdevice.proof_tree(wire.parse_and_validate(kinds[k], cfg))
            for k in dict.fromkeys(names)}


def _flip(tree: dict, path, row: int) -> None:
    """Flip one bit in the middle of proof `row`'s leaf at `path`."""
    node = tree
    for k in path[:-1]:
        node = node[k]
    flat = node[path[-1]][row].reshape(-1)
    flat[flat.size // 2] ^= 1


def sharded_batch(mesh: M.Mesh, cfg: StarkConfig, kinds: dict, names,
                  flips=(), shared=None, per_host: bool = False) -> dict:
    """The sharded verifier on the global batch `names` (a multiple of the
    mesh size), the proofs at `flips` [(global index, leaf path)] with one
    bit flipped.  per_host=False: every rank stacks the global batch and
    takes its slice with shard_batch; True: each stacks only its own and
    joins them with shard_batch_per_host.  shared=None picks the walk by
    the rank's slice.  {"verdicts": global list, "all_ok"}."""
    trees = _trees(kinds, names, cfg)
    lo, hi = (M.part_bounds(len(names), mesh) if per_host
              else (0, len(names)))
    batch = pdevice.stack_proofs([trees[k] for k in names[lo:hi]])
    for at, path in flips:
        if lo <= at < hi:
            _flip(batch, path, at - lo)
    if shared is None:
        mine = names[slice(*M.part_bounds(len(names), mesh))]
        shared = all(pdevice.is_rectangular(trees[k]) for k in mine)
    if not per_host:
        return sharded_tree(mesh, cfg, batch, shared)
    local, _offset = M.shard_batch_per_host(batch, mesh)
    verdicts, all_ok = M.make_sharded_verifier(
        mesh, cfg, shared_merkle=shared)(local)
    return {"verdicts": verdicts.cpu().tolist(), "all_ok": all_ok}


def sharded_tree(mesh: M.Mesh, cfg: StarkConfig, tree: dict,
                 shared: bool = True) -> dict:
    """The sharded verifier on a global batch tree (numpy uint32 words, the
    same on every rank), each rank's slice by shard_batch.  {"verdicts":
    global list, "all_ok"}."""
    fn = M.make_sharded_verifier(mesh, cfg, shared_merkle=shared)
    verdicts, all_ok = fn(M.shard_batch(tree, mesh))
    return {"verdicts": verdicts.cpu().tolist(), "all_ok": all_ok}


def point_rows(mesh: M.Mesh, cfg: StarkConfig, tree: dict, rows) -> list:
    """verify_point_parallel on the proofs `rows` of a batch tree."""
    return [M.verify_point_parallel(
        pdevice.tree_map(lambda x: x[r], tree), mesh, cfg) for r in rows]


def blob_batch(mesh: M.Mesh, cfg: StarkConfig, kinds: dict, names,
               chunk=None) -> dict:
    """The sharded blob verifier: each rank packs its part of the blobs
    `names` (a multiple of the mesh size) and parses and verifies it on its
    device.  {"verdict", "shape_ok"}: global lists."""
    lo, hi = M.part_bounds(len(names), mesh)
    fn, lay = M.make_sharded_blob_verifier(mesh, cfg, chunk=chunk)
    packed, _lens = lay.pack([kinds[k] for k in names[lo:hi]])
    verdict, shape_ok = fn(packed.to(mesh.device))
    return {"verdict": verdict.cpu().tolist(),
            "shape_ok": shape_ok.cpu().tolist()}


def stream(mesh: M.Mesh, cfg: StarkConfig, kinds: dict, names, chunk: int,
           device_parse: bool) -> list:
    """verify_stream(mesh=...) over the blobs `names`: the verdicts in
    index order (the stream must yield every index once, in order)."""
    out = []
    for i, v in M.verify_stream([kinds[k] for k in names], chunk=chunk,
                                cfg=cfg, device_parse=device_parse,
                                mesh=mesh):
        if i != len(out):
            raise RuntimeError(f"verify_stream yielded index {i} after "
                               f"{len(out)} verdicts")
        out.append(v)
    return out


def point(mesh: M.Mesh, cfg: StarkConfig, kinds: dict, names) -> list:
    """verify_point_parallel on each proof of `names`: verdicts."""
    trees = _trees(kinds, names, cfg)
    return [M.verify_point_parallel(trees[k], mesh, cfg) for k in names]


def _alone(mesh: M.Mesh) -> M.Mesh:
    """A one-rank mesh on this rank's device (no collective)."""
    return M.Mesh(1, 0, mesh.device)


def _timed(mesh: M.Mesh, call, active: bool):
    """Seconds of call() on this rank, between barriers that hold every
    rank of the world; None where the rank sits out."""
    dist.barrier()
    secs = None
    if active:
        _sync(mesh)
        t0 = time.perf_counter()
        call()
        _sync(mesh)
        secs = time.perf_counter() - t0
    dist.barrier()
    return secs


def _replicated(tree: dict, n: int, dev) -> dict:
    """One proof tree replicated to n proofs on the device."""
    one = pdevice.to_device(tree, dev)
    return pdevice.tree_map(
        lambda x: x.unsqueeze(0).expand((n,) + x.shape).contiguous(), one)


def time_resident(mesh: M.Mesh, cfg: StarkConfig, kinds: dict, kind: str,
                  batch: int, turns: int = 3) -> dict:
    """Seconds of one call of the global batch of `batch` copies of a
    proof: on rank 0 alone (its one-device sharded verifier on the whole
    batch, the others idle) and on every rank (each its slice, verdicts
    gathered), in turns: alone, all, all, alone, ...  {"alone": [s] on rank
    0, "all": [s] on every rank}."""
    tree = _trees(kinds, [kind], cfg)[kind]
    whole = _replicated(tree, batch, mesh.device) if mesh.rank == 0 else None
    local = _replicated(tree, batch // mesh.size, mesh.device)
    one = M.make_sharded_verifier(_alone(mesh), cfg)
    every = M.make_sharded_verifier(mesh, cfg)

    def check(fn, t):
        if not fn(t)[1]:
            raise RuntimeError("a timed call rejected the proof")

    for fn, t, active in ((one, whole, mesh.rank == 0),
                          (every, local, True)):
        _timed(mesh, lambda: check(fn, t), active)            # warm
    out = {"alone": [], "all": []}
    for t_ in range(turns):
        for which in (("alone", "all") if t_ % 2 == 0 else ("all", "alone")):
            if which == "alone":
                s = _timed(mesh, lambda: check(one, whole), mesh.rank == 0)
            else:
                s = _timed(mesh, lambda: check(every, local), True)
            if s is not None:
                out[which].append(s)
    return out


def time_point(mesh: M.Mesh, cfg: StarkConfig, kinds: dict, kind: str,
               reps: int = 5) -> dict:
    """Latency of one proof resident on the card, in turns: the one-device
    shared verifier (rank 0 alone), point parallelism on rank 0 alone, and
    point parallelism over every rank.  {name: median s, name + "_s":
    every sample}."""
    tree = pdevice.to_device(_trees(kinds, [kind], cfg)[kind], mesh.device)
    single, _ = V.make_verifier(cfg, device=mesh.device)
    calls = {
        "single_process": (lambda: bool(single(tree)), mesh.rank == 0),
        "point_alone": (lambda: M.verify_point_parallel(
            tree, _alone(mesh), cfg), mesh.rank == 0),
        "point_all": (lambda: M.verify_point_parallel(tree, mesh, cfg), True),
    }
    samples = {k: [] for k in calls}
    for rep in range(reps + 1):                 # the first pass warms
        order = list(calls) if rep % 2 == 0 else list(reversed(calls))
        for name in order:
            call, active = calls[name]
            ok = []
            s = _timed(mesh, lambda: ok.append(call()), active)
            if active and not ok[0]:
                raise RuntimeError(f"{name} rejected the proof")
            if s is not None and rep:
                samples[name].append(s)
    out = {k + "_s": v for k, v in samples.items()}
    out.update({k: statistics.median(v) for k, v in samples.items() if v})
    return out


def ntt_values(n: int, seed: int) -> np.ndarray:
    """[n, 16] uint32 limbs made from a seed, the same on every rank: raw
    values below 2^256 (not all canonical), the first ones 0, p - 1, p,
    p + 1 and 2^256 - 1."""
    rng = np.random.RandomState(seed)
    v = rng.randint(0, 1 << 16, (n, fp.NLIMBS)).astype(np.uint32)
    edges = [0, fp.MODULUS - 1, fp.MODULUS, fp.MODULUS + 1, 2**256 - 1]
    k = min(n, len(edges))
    v[:k] = fp.ints_to_limbs(edges[:k])
    return v


def sharded_ntt(mesh: M.Mesh, cases, seed: int = 0, values: bool = False,
                host_lib: str | None = None) -> list:
    """For each (n, inverse) of `cases`: the sharded NTT of ntt_values(n,
    seed + n) on every rank, held against the one-process ntt of the same
    values on this rank's device.  A record a case: "slice_equal" (this
    rank's slice), "gathered_equal" (gather_points' whole result),
    "seconds" (one call after a warm one), and with `values` the gathered
    result as uint32 limbs.  host_lib: the path of a host build of
    csrc/ntt_stage.cu and csrc/ntt_block.cu, through which CPU ranks take
    the kernel path."""
    lib = None
    if host_lib is not None:
        lib = ctypes.CDLL(host_lib)
        for name in ("stark_ntt_stage", "stark_ntt_block"):
            getattr(lib, name).argtypes = _build.SIGNATURES[name]
    out = []
    for n, inverse in cases:
        host = ntt_values(n, seed + n)
        x = torch.from_numpy(host.view(np.int32)).to(mesh.device)
        root = pow(7, (fp.MODULUS - 1) // n, fp.MODULUS)
        fn = pntt.make_sharded_ntt(n, root, mesh, inverse=inverse, lib=lib)
        fn(x)                                           # warm
        _sync(mesh)
        t0 = time.perf_counter()
        local = fn(x)
        _sync(mesh)
        secs = time.perf_counter() - t0
        whole = pntt.gather_points(mesh, local)
        want = ntt.ntt(x, root, inverse=inverse)
        lo, hi = M.part_bounds(n, mesh)
        rec = {"n": n, "inverse": inverse, "seconds": secs,
               "slice_equal": bool(torch.equal(local, want[lo:hi])),
               "gathered_equal": bool(torch.equal(whole, want))}
        if values:
            rec["values"] = whole.cpu().numpy().view(np.uint32)
        out.append(rec)
    return out
