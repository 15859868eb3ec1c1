"""Batched and streamed verification, on one device or one rank per device.

verify_batch stacks proof trees and verifies them in one call.  verify_stream
is the path from proof bytes to verdicts: it cuts an iterable of blobs into
chunks, parses each chunk into a batch (host parse: proofio.ingest; device
parse: proofio.static_layout), copies it to the card and verifies it, and
yields (index, verdict) pairs.

The stream is a three-stage pipeline.  While the main thread launches chunk
k's verification, a worker thread prepares chunk k+1 (native scan + fill,
or packing, into one of two pinned host slots); chunk k's verdicts are
fetched only once chunk k+1 has been dispatched.  Each slot's host-to-device
copy runs asynchronously on a copy stream and ends in a CUDA event the
compute stream waits on; before the host refills a slot it waits on that
slot's copy event, and before the copy stream overwrites a slot's device
buffers it waits on the event recorded after the verify that read them.
On the CPU the same pipeline runs without copies or events.

Several devices: one process per device (a rank), joined in one
torch.distributed process group, described to the code by a Mesh.  Every
path is bound by the host launching small kernels, so each rank has its own
process and launch thread rather than one process driving several cards.
Verification is parallel over the batch: each rank verifies its contiguous
slice of the global batch with the one-device verifier (make_sharded_verifier,
make_sharded_blob_verifier; verify_batch and verify_stream with mesh=), and
the only traffic between ranks is the verdicts: each rank writes its slice
into a zero buffer of the global batch and one all_reduce sums them (on the
card with NCCL, on a host copy with gloo).  Point parallelism splits ONE
proof's FRI queries, Merkle branches and spot checks over the ranks instead
(shard_point_proof, verify_point_parallel); its verdict is the AND over the
ranks.  launch() starts a world of ranks on this host; init_distributed
joins one started by another launcher.
"""

from __future__ import annotations

import functools
import multiprocessing
import os
import queue
import socket
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .. import _build, fp, native
from ..config import StarkConfig
from ..profiling import NO_SPAN, span
from ..proofio import device as pdevice
from ..proofio import ingest
from ..proofio import static_layout as SL
from ..protocol import verify as V


# ---------------------------------------------------------------------------
# ranks: the mesh, the process group and its launcher
# ---------------------------------------------------------------------------

# seconds a collective (and the rendezvous) may wait for a peer before the
# process group raises: a rank that died must not block the others forever
TIMEOUT_S = 600.0


@dataclass(frozen=True)
class Mesh:
    """The ranks verifying together, as one rank sees them: `size` ranks,
    this one's `rank` and its `device`; `backend` is the process group's
    ("nccl" or "gloo"), None for one rank without a group."""
    size: int
    rank: int
    device: torch.device
    backend: str | None = None


_joined = {"mesh": None}     # the mesh init_distributed joined in this process


def _rank_device(rank: int, device=None) -> torch.device:
    """The device of rank `rank`: `device` as given, except that the card
    without an index means cuda:(LOCAL_RANK, else rank % cards)."""
    dev = pdevice.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else rank % torch.cuda.device_count())
    return dev


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     device=None, timeout_s: float = TIMEOUT_S) -> Mesh:
    """Join this process to a process group of one rank per process and
    return its Mesh.

    The arguments default to STARK_COORDINATOR ("host:port" or
    "tcp://host:port", where rank 0 listens), STARK_NUM_PROCS and
    STARK_PROC_ID.  Without a coordinator this joins nothing and returns
    the one-rank mesh.  device=None means the card: rank r takes
    cuda:(LOCAL_RANK, else r % cards); pass "cpu" for gloo ranks on the CPU.
    backend=None is nccl on the card and gloo on the CPU; several ranks on
    one card need "gloo" (NCCL refuses two ranks on one device).  Every
    collective fails after timeout_s instead of waiting for a dead peer."""
    if coordinator is None:
        coordinator = os.environ.get("STARK_COORDINATOR")
    n = num_processes or int(os.environ.get("STARK_NUM_PROCS", "1"))
    rank = (process_id if process_id is not None
            else int(os.environ.get("STARK_PROC_ID", "0")))
    if coordinator is None:
        return make_mesh(device=device)
    dev = _rank_device(rank, device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs ranks on the card")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)       # before anything is allocated
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    # NCCL is told its rank's card, so that no collective guesses it
    bind = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init, world_size=n,
                            rank=rank, timeout=timedelta(seconds=timeout_s),
                            **bind)
    _joined["mesh"] = Mesh(n, rank, dev, backend)
    return _joined["mesh"]


def _shutdown() -> None:
    """Leave the process group init_distributed joined (if any)."""
    if _joined["mesh"] is not None and dist.is_initialized():
        dist.destroy_process_group()
    _joined["mesh"] = None


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh of this process: the process group's, once init_distributed
    (or launch) has joined one; else one rank on `device` (None: the card).
    n_devices > 1 without a group raises: start the ranks with launch()."""
    mesh = _joined["mesh"]
    if mesh is not None:
        if n_devices not in (None, mesh.size):
            raise ValueError(f"the process group has {mesh.size} ranks, "
                             f"not {n_devices}")
        return mesh
    if n_devices not in (None, 1):
        raise RuntimeError(
            f"a mesh of {n_devices} ranks needs a process group of one "
            f"process a rank: start them with parallel.mesh.launch (or call "
            f"init_distributed in each)")
    return Mesh(1, 0, pdevice.resolve_device(device))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, addr, backend, device, timeout_s, work,
               results):
    """A launched rank: take (fn, args) from the work queue, join, run
    fn(mesh, *args), report (rank, ok, result or traceback) on the results
    queue, leave.  A rank on the CPU runs torch on one thread: the ranks
    are the parallelism."""
    if device == "cpu":
        torch.set_num_threads(1)
    try:
        fn, args = work.get()
        mesh = init_distributed(addr, world, rank, backend=backend,
                                device=device, timeout_s=timeout_s)
        value = fn(mesh, *args)
        dist.barrier()               # no rank leaves while a peer still reads
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)
    results.put((rank, True, value))
    _shutdown()


def launch(n_ranks: int, fn, *args, backend: str | None = None, devices=None,
           timeout_s: float = TIMEOUT_S) -> list:
    """Run fn(mesh, *args) on n_ranks new processes of this host, one rank
    each, joined in one process group on a free localhost port; return the
    ranks' results in rank order.

    fn must be importable by name (a spawned process imports it afresh):
    a function of a module, not of __main__.  devices: None or "cuda" (the
    card: rank r on cuda:(r % cards)) or "cpu"; backend as in
    init_distributed.  The kernels and the native parser are built here,
    once, before the ranks start.  If a rank raises, exits without a result
    or the world outlasts timeout_s, every rank is killed and this raises
    with the failing rank's traceback: never a partial result.  A rank that
    gave its result but has not exited by then is killed too, and the
    results stand."""
    devs = [_rank_device(r, devices) for r in range(n_ranks)]
    if any(d.type == "cuda" for d in devs):
        _build.load()
    native.get_lib()
    ctx = multiprocessing.get_context("spawn")   # fork is unsafe after CUDA
    work, results = ctx.Queue(), ctx.Queue()
    addr = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n_ranks, addr, backend, str(devs[r]),
                               timeout_s, work, results))
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    # the work goes through a queue, not the processes' arguments: a spawned
    # process reads those only after its imports, so a start with megabytes
    # of arguments would wait for them, rank after rank
    for _ in procs:
        work.put((fn, args))
    got = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < n_ranks:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                ended = [r for r, p in enumerate(procs)
                         if r not in got and p.exitcode is not None]
                if ended:
                    # what it put may still be in the pipe: one more look
                    try:
                        rank, ok, value = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"launch: rank {ended[0]} of {n_ranks} exited "
                            f"with code {procs[ended[0]].exitcode} and no "
                            f"result") from None
                elif time.monotonic() > deadline:
                    late = [r for r in range(n_ranks) if r not in got]
                    raise TimeoutError(
                        f"launch: ranks {late} of {n_ranks} did not finish "
                        f"within {timeout_s} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(
                    f"launch: rank {rank} of {n_ranks} failed:\n{value}")
            got[rank] = value
        for p in procs:              # the world's one deadline bounds them all
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        for q in (work, results):
            q.close()
            q.cancel_join_thread()   # work a killed rank never took
    return [got[r] for r in range(n_ranks)]


# ---------------------------------------------------------------------------
# batch parallelism: each rank its contiguous slice, verdicts gathered
# ---------------------------------------------------------------------------

def _dense(x, dev: torch.device) -> torch.Tensor:
    """A leaf (numpy uint32 or tensor) as a fresh tensor on `dev` with
    canonical strides: a slice of a batch is never handed to the kernels
    as a view (they refuse foreign row strides, _build.proof_stride)."""
    t = pdevice.to_tensor(x, "cpu") if isinstance(x, np.ndarray) else x
    return torch.empty(t.shape, dtype=t.dtype, device=dev).copy_(t)


def _batch_size(tree) -> int:
    return int(tree["merkle_root"].shape[0])


def part_bounds(n: int, mesh: Mesh) -> tuple:
    """[lo, hi) of this rank's contiguous part of n items: the parts differ
    in size by at most one, the first ones larger."""
    base, extra = divmod(n, mesh.size)
    lo = mesh.rank * base + min(mesh.rank, extra)
    return lo, lo + base + (mesh.rank < extra)


def shard_batch(tree, mesh: Mesh):
    """This rank's contiguous slice of a global batch tree (numpy uint32
    words or tensors; every rank passes the same batch), on its device.
    The batch must be a multiple of the mesh size."""
    b = _batch_size(tree)
    if b % mesh.size:
        raise ValueError(f"batch {b} is not a multiple of the mesh's "
                         f"{mesh.size} ranks")
    lo, hi = part_bounds(b, mesh)
    return pdevice.tree_map(lambda x: _dense(x[lo:hi], mesh.device), tree)


def _all_reduce(mesh: Mesh, t: torch.Tensor, op=None) -> torch.Tensor:
    """All-reduce t (a sum unless `op`) on the collective's device: the
    rank's card with NCCL, the host with gloo.  Returns it there."""
    where = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    t = t.to(where)
    dist.all_reduce(t, op=op or dist.ReduceOp.SUM)
    return t


def shard_batch_per_host(local_tree, mesh: Mesh):
    """This rank's own proofs (the ones it parsed) on its device, and the
    global index of the first: (tree, offset).  Every rank must hold the
    same number of proofs; the global batch is their concatenation in rank
    order."""
    n = _batch_size(local_tree)
    if mesh.size > 1:
        span = _all_reduce(mesh, torch.tensor([n, -n], dtype=torch.int64),
                           dist.ReduceOp.MAX).tolist()
        if span[0] != -span[1]:
            raise ValueError(f"the ranks hold {-span[1]} to {span[0]} local "
                             f"proofs; every rank must hold as many")
    return (pdevice.tree_map(lambda x: _dense(x, mesh.device), local_tree),
            mesh.rank * n)


def _gather(mesh: Mesh, parts, lo: int, total: int) -> list:
    """Global [total] bool vectors from each rank's rows [lo, lo + len) of
    them: every rank writes its rows into a zero [len(parts), total] buffer,
    and one all_reduce sums the buffers (all_gather would need equal parts,
    and gloo has none for CUDA tensors).  Returns them on the rank's
    device."""
    if mesh.size == 1:
        return [p.to(mesh.device, torch.bool) for p in parts]
    buf = torch.zeros((len(parts), total), dtype=torch.int32)
    if mesh.backend == "nccl":
        buf = buf.to(mesh.device)
    for row, p in zip(buf, parts):
        row[lo:lo + p.numel()] = p.reshape(-1).to(buf.device, torch.int32)
    buf = _all_reduce(mesh, buf).to(mesh.device) != 0
    return list(buf)


def _all_and(mesh: Mesh, ok) -> bool:
    """The AND of every rank's `ok` (an all_reduce with MIN)."""
    flag = torch.tensor([int(bool(ok))], dtype=torch.int32)
    if mesh.size == 1:
        return bool(flag)
    return bool(_all_reduce(mesh, flag, dist.ReduceOp.MIN).item())


def make_sharded_verifier(mesh: Mesh, cfg: StarkConfig | None = None,
                          inp: int = 3, shared_merkle: bool = True):
    """fn(local_tree) -> (verdicts [global B] bool, all_ok): each rank
    verifies its slice (shard_batch / shard_batch_per_host: every rank
    holds as many proofs, so rank r's slice starts at r * its size) with
    the one-device verifier, and the verdicts are gathered into the global
    order on every rank; all_ok is their AND over all ranks.  Memoized on
    (mesh, cfg, inp, shared_merkle), each rank's tables on its own
    device."""
    return _make_sharded_cached(mesh, cfg or StarkConfig(), inp,
                                shared_merkle)


@functools.lru_cache(maxsize=8)
def _make_sharded_cached(mesh: Mesh, cfg: StarkConfig, inp: int,
                         shared_merkle: bool):
    inner, _tables = V.make_verifier(cfg, inp, shared_merkle=shared_merkle,
                                     device=mesh.device)

    def fn(local_tree):
        local = inner(local_tree)
        b = local.shape[0]
        verdicts, = _gather(mesh, [local], mesh.rank * b, mesh.size * b)
        return verdicts, bool(verdicts.all())

    return fn


def make_sharded_blob_verifier(mesh: Mesh, cfg: StarkConfig | None = None,
                               inp: int = 3, chunk: int | None = None):
    """The device-parse verifier over the mesh: fn(local_words [b,
    layout.words] int32 on the rank's device) -> (verdict [global B],
    shape_ok [global B]), each rank's rows parsed on its device
    (proofio.static_layout), verified and gathered as in
    make_sharded_verifier.  Returns (fn, layout).  With `chunk`, a rank
    verifies its rows in calls of `chunk` (its batch must be a multiple).
    The reroutes of static_layout.make_blob_verifier apply.  Memoized."""
    return _make_sharded_blob_cached(mesh, cfg or StarkConfig(), inp, chunk)


@functools.lru_cache(maxsize=8)
def _make_sharded_blob_cached(mesh: Mesh, cfg: StarkConfig, inp: int,
                              chunk: int | None):
    one, lay = SL.make_blob_verifier(cfg, inp, device=mesh.device)

    def fn(local_words):
        b = local_words.shape[0]
        if chunk is None or b <= chunk:
            verdict, shape_ok = one(local_words)
        else:
            if b % chunk:
                raise ValueError(
                    f"batch {b} must be a multiple of chunk {chunk}")
            parts = [one(local_words[i:i + chunk]) for i in range(0, b, chunk)]
            verdict = torch.cat([v for v, _ in parts])
            shape_ok = torch.cat([so for _, so in parts])
        verdict, shape_ok = _gather(mesh, [verdict, shape_ok], mesh.rank * b,
                                   mesh.size * b)
        return verdict, shape_ok

    return fn, lay


# ---------------------------------------------------------------------------
# point parallelism: one proof's queries, branches and spot checks
# ---------------------------------------------------------------------------

def shard_point_proof(tree, mesh: Mesh):
    """This rank's share of ONE proof (a tree without a batch axis, numpy or
    tensors), on its device: its contiguous slice of the FRI queries (with
    their 4 poly rows and per-level witnesses), of the main branches (two a
    spot check) and of the lincomb branches (one a spot check).  The roots
    and POINTS stay whole.  The mesh size must divide every cut axis (the
    default family's 40 queries, 160 and 80 branches: 2, 4, 5, 8, ... ranks,
    not 3 or 6); otherwise ValueError."""
    if tree["merkle_root"].ndim != 1:
        raise ValueError("shard_point_proof takes one proof (no batch axis)")
    n, fri = mesh.size, tree["fri"]
    for what, size in (("FRI queries", fri["col_value"].shape[-2]),
                       ("main branches", tree["main"]["value"].shape[-2]),
                       ("lincomb branches",
                        tree["lincomb"]["value"].shape[-2])):
        if size % n:
            raise ValueError(
                f"mesh size {n} does not divide the {size} {what}; use a "
                f"mesh whose size divides the family's query and branch "
                f"counts")

    def cut(x, axis):
        s = x.shape[axis] // n
        at = [slice(None)] * x.ndim
        at[axis] = slice(mesh.rank * s, (mesh.rank + 1) * s)
        return _dense(x[tuple(at)], mesh.device)

    def whole(x):
        return _dense(x, mesh.device)

    out = {k: whole(tree[k]) for k in ("merkle_root", "l_merkle_root",
                                       "points")}
    out["fri"] = {k: (whole(v) if k == "root2"
                      else [cut(w, 0) for w in v] if k.endswith("_witness")
                      else cut(v, 1))                  # [L, q or 4q, ...]
                  for k, v in fri.items()}
    for g in ("main", "lincomb"):
        out[g] = {k: cut(v, 0) for k, v in tree[g].items()}
    return out


def verify_point_parallel(tree, mesh: Mesh | None = None,
                          cfg: StarkConfig | None = None, inp: int = 3) -> bool:
    """Verify ONE proof with its queries, branches and spot checks split
    over the mesh's ranks (latency, the dual of batch parallelism): each
    rank checks its share (protocol.verify's part) with the independent
    Merkle walk -- the shared walk compares state across branches, which
    would make every tree level a collective -- and the verdict is the AND
    over the ranks, the only collective."""
    mesh = mesh or make_mesh()
    share = shard_point_proof(tree, mesh)
    fn, _ = V.make_verifier(cfg or StarkConfig(), inp, shared_merkle=False,
                            device=mesh.device)
    return _all_and(mesh, fn(share, part=(mesh.rank, mesh.size)))


def verify_batch(proof_trees: list, cfg: StarkConfig | None = None,
                 inp: int = 3, device=None, mesh: Mesh | None = None
                 ) -> np.ndarray:
    """Stack host proof trees, copy them to the device, verify; returns the
    verdicts as a numpy bool array.  A batch holding a ragged tree takes the
    independent Merkle walk.  device=None means the card.

    With a mesh, every rank passes the same global list (a multiple of the
    mesh size), verifies its slice on the mesh's device and returns the
    global verdicts; a rank whose slice holds a ragged tree takes the
    independent walk, the others the shared one."""
    if mesh is None:
        dev = pdevice.resolve_device(device)
        batch = pdevice.stack_proofs(proof_trees)
        shared = all(pdevice.is_rectangular(t) for t in proof_trees)
        fn, _ = V.make_verifier(cfg or StarkConfig(), inp,
                                shared_merkle=shared, device=dev)
        return fn(pdevice.to_device(batch, dev)).cpu().numpy()
    local = shard_batch(pdevice.stack_proofs(proof_trees), mesh)
    lo, hi = part_bounds(len(proof_trees), mesh)
    shared = all(pdevice.is_rectangular(t) for t in proof_trees[lo:hi])
    fn = make_sharded_verifier(mesh, cfg, inp, shared_merkle=shared)
    return fn(local)[0].cpu().numpy()


class _Slot:
    """One buffer of the stream: the host batch (a BatchLayout or a packed
    words buffer, pinned on the card's path), its device copy, and the CUDA
    events that order the two against the verify that reads them."""

    def __init__(self):
        self.layout = None       # host parse: ingest.BatchLayout
        self.pack = None         # device parse: [chunk, words] int32
        self.statements = None   # run-time statements: ingest.StatementRows
        self.dev = None          # device buffers (same tree as the host's)
        self.copied = None       # event after the last H2D copy out of it
        self.used = None         # event after the last verify that read dev

    def wait_copied(self) -> None:
        """Host wait: the last copy out of this slot's host buffers has
        finished, so they may be refilled."""
        if self.copied is not None:
            self.copied.synchronize()

    def stage(self, host, n: int, dev: torch.device, copy_stream):
        """Rows [:n] of the host tree (or words) on `dev`.  On the card the
        copy is asynchronous, from pinned memory, on `copy_stream`; the
        current (compute) stream waits on its event."""
        if dev.type != "cuda":
            with span("stream.stage"):
                return pdevice.tree_map(lambda h: h[:n], host)
        compute = torch.cuda.current_stream(dev)
        shapes = pdevice.tree_map(lambda h: tuple(h.shape), host)
        with span("stream.stage") as sp, torch.cuda.stream(copy_stream):
            new = self.dev is None or pdevice.tree_map(
                lambda d: tuple(d.shape), self.dev) != shapes
            if new:
                # new buffers: the allocator may hand back memory that the
                # compute stream still reads, so wait for all of it first
                copy_stream.wait_stream(compute)
                self.dev = pdevice.tree_map(
                    lambda h: torch.empty(h.shape, dtype=h.dtype, device=dev),
                    host)
            elif self.used is not None:
                copy_stream.wait_event(self.used)
            pdevice.tree_map(lambda d, h: d[:n].copy_(h[:n], non_blocking=True),
                             self.dev, host)
            self.copied = torch.cuda.Event()
            self.copied.record(copy_stream)
            sp.set(new_buffers=new)
        compute.wait_event(self.copied)
        return pdevice.tree_map(lambda d: d[:n], self.dev)

    def release(self, dev: torch.device) -> None:
        """After the verify that reads this slot's device buffers has been
        launched: mark them used by the compute stream."""
        if dev.type != "cuda":
            return
        compute = torch.cuda.current_stream(dev)
        pdevice.tree_map(lambda d: d.record_stream(compute), self.dev)
        self.used = torch.cuda.Event()
        self.used.record(compute)


def verify_stream(proof_blobs, chunk: int | None = None,
                  cfg: StarkConfig | None = None, inp: int = 3,
                  manifest: dict | None = None, threads: int = 4,
                  device_parse: bool = False, device=None,
                  mesh: Mesh | None = None, statements=None,
                  constants=None):
    """Chunked verification of an arbitrarily large proof stream.

    proof_blobs: iterable of serialized proof byte strings.  Chunks of
    `chunk` blobs (default 64) are batch-ingested (proofio.ingest: native
    scan / fill on `threads` threads straight into reusable pinned batch
    buffers), copied to the device and verified; yields (global_index,
    verdict) pairs.  Malformed or family-mismatched proofs reject without
    aborting the stream.  A chunk whose batch holds a ragged proof takes the
    independent Merkle walk (proofio.device.is_rectangular).

    device_parse=True switches ingestion to device-side deserialization
    (proofio.static_layout): each blob is packed as one row of words, the
    chunk goes to the card as one array, and the proof tree is built there.
    Rerouted to the host parser: shape_ok=False rows, every blob SHORTER than
    the canonical length in every mode (zero padding could silently
    reconstruct a truncated proof whose missing tail bytes were zero), and
    any non-canonical length under strict mode (trailing bytes are invisible
    to the packed prefix) -- so verdicts are the host path's.  The reroute
    verifies only the rerouted rows.

    `manifest`, if given, is a dict recording completed chunk ids ->
    verdict lists; rerunning with the same manifest skips finished chunks.

    device=None means the card, and raises where there is none.

    With a mesh (default chunk 64 a rank, rounded up to a multiple of its
    size), every rank iterates the same blobs and prepares, copies and
    verifies its contiguous part of each chunk (part_bounds) on the mesh's
    device with the pipeline above; the parts' verdicts are gathered when
    the chunk is collected, one chunk behind, so every rank yields the same
    global (index, verdict) pairs.  The walk is chosen per rank: a rank
    whose part holds a ragged proof takes the independent walk while the
    others keep the shared one (the verdicts are the same either way).
    Every rank must pass the same manifest.

    With `statements` and `constants` the statement is given at run time,
    as the reference's library boundary takes it (src/lib.rs:99):
    `statements` runs in step with `proof_blobs`, one (input, claimed
    output) pair of ints a proof, `constants` are the stream's round
    constants (ints, cfg.num_constants of them), and `inp` is ignored.  The
    worker packs each chunk's statements as limbs beside its tree
    (ingest.StatementRows: each distinct statement converted once), the copy
    stream carries them, and the chunk runs through
    protocol.verify.make_general_verifier.  Not with device_parse or a mesh
    (ValueError).
    """
    runtime = statements is not None or constants is not None
    if runtime:
        if statements is None or constants is None:
            raise ValueError("run-time statements need both statements= "
                             "and constants=")
        if device_parse:
            raise ValueError("run-time statements take the host parse: "
                             "device_parse=True is not supported with "
                             "statements=")
        if mesh is not None:
            raise ValueError("run-time statements run on one device: mesh= "
                             "is not supported with statements=")
    dev = mesh.device if mesh is not None else pdevice.resolve_device(device)
    vcfg = cfg or StarkConfig()
    if mesh is None:
        chunk = chunk or 64
    else:
        chunk = chunk or 64 * mesh.size
        chunk = -(-chunk // mesh.size) * mesh.size
    rows = chunk if mesh is None else chunk // mesh.size   # a part at most
    on_card = dev.type == "cuda"
    copy_stream = torch.cuda.Stream(dev) if on_card else None
    slots = [_Slot(), _Slot()]       # double buffer, by chunk parity
    fb = _Slot()                     # the device-parse reroute's own
    lay = SL.canonical_layout(vcfg) if device_parse else None
    if runtime:
        constants = [int(c) % fp.MODULUS for c in constants]
        if len(constants) != vcfg.num_constants:
            raise ValueError(f"{len(constants)} round constants, the "
                             f"family takes {vcfg.num_constants}")
        consts = pdevice.to_tensor(fp.ints_to_limbs(constants), dev)
        limbs = {}                   # (inp, out) -> limbs, both slots'

    def host_tree(slot, blobs, pad_to=None):
        tree, ok, slot.layout = ingest.ingest_chunk(
            blobs, vcfg, slot.layout, threads=threads, pad_to=pad_to,
            pin=on_card)
        return tree, ok

    def verify_tree(slot, tree, n, sp=NO_SPAN, stmts=None):
        rect = pdevice.is_rectangular(pdevice.tree_map(lambda t: t[:n], tree))
        sp.set(walk="shared" if rect else "independent")
        if stmts is None:
            fn, _ = V.make_verifier(vcfg, inp, shared_merkle=rect, device=dev)
            verdicts = fn(slot.stage(tree, n, dev, copy_stream))
        else:
            fn, _ = V.make_general_verifier(vcfg, shared_merkle=rect,
                                            device=dev)
            d = slot.stage(dict(tree, statements=stmts), n, dev, copy_stream)
            st = d.pop("statements")
            verdicts = fn(d, st["inp"], consts, st["out"])
        slot.release(dev)
        return verdicts

    def host_verdicts(blobs):
        """Host parse + verify of the rerouted blobs of a device-parse
        chunk, synchronously: bool[len(blobs)]."""
        fb.wait_copied()
        tree, ok = host_tree(fb, blobs)
        if tree is None:
            return np.zeros(len(blobs), dtype=bool)
        return verify_tree(fb, tree, len(blobs)).cpu().numpy() & ok

    def prepare(cid, slot, blobs, stmts):
        """Worker thread: fill the slot's host buffers for a chunk."""
        if not blobs:                          # a rank's empty part
            return None
        with span("stream.prepare", chunk=cid, proofs=len(blobs)):
            with span("stream.wait_slot"):
                slot.wait_copied()
            if not device_parse:
                tree, ok = host_tree(slot, blobs, pad_to=rows)
                if not runtime or tree is None:
                    return tree, ok, None
                with span("stream.statements", proofs=len(blobs)) as sp:
                    if slot.statements is None:
                        slot.statements = ingest.StatementRows(rows, limbs,
                                                               pin=on_card)
                    sp.set(statements=slot.statements.fill(stmts))
                return tree, ok, slot.statements.tensors
            with span("stream.pack"):
                if slot.pack is None:
                    slot.pack = torch.zeros((rows, lay.words),
                                            dtype=torch.int32,
                                            pin_memory=on_card)
                return lay.pack(blobs, out=slot.pack)[1]

    def dispatch(c):
        """Main thread: copy and launch a prepared chunk.  Returns the
        pending descriptor, or the chunk's verdicts when nothing in it
        parsed."""
        cid, idxs, lo, blobs, slot, fut = c
        n = len(blobs)
        with span("stream.dispatch", chunk=cid, proofs=n) as sp:
            with span("stream.wait_prepared"):
                prepared = fut.result()
            if n == 0:
                return ("done", cid, idxs, lo, np.zeros(0, dtype=bool))
            if not device_parse:
                tree, ok, stmts = prepared
                if tree is None:                   # nothing parseable
                    return ("done", cid, idxs, lo, np.zeros(n, dtype=bool))
                return ("host", cid, idxs, lo, ok,
                        verify_tree(slot, tree, n, sp, stmts))
            sp.set(walk="shared")
            fn, _ = SL.make_blob_verifier(vcfg, inp, device=dev)
            verdicts, shape_ok = fn(slot.stage(slot.pack, n, dev,
                                               copy_stream))
            slot.release(dev)
            return ("dev", cid, idxs, lo, blobs, prepared, verdicts, shape_ok)

    def collect(p):
        """The chunk's verdicts: this rank's part (rerouted rows done),
        gathered over the mesh."""
        kind, cid, p_idxs, lo = p[:4]
        with span("stream.collect", chunk=cid, proofs=len(p_idxs)):
            if kind == "done":
                verdicts = p[4]
            elif kind == "host":
                ok, dv = p[4:]
                with span("stream.wait_verdicts"):
                    verdicts = dv.cpu().numpy() & ok      # waits on the device
            else:
                p_blobs, lens, dv, so = p[4:]
                with span("stream.wait_verdicts"):
                    verdicts = dv.cpu().numpy().copy()
                    shape_ok = so.cpu().numpy()
                # reroute to the host parser: shape-lane failures; SHORT
                # blobs in every mode; non-exact lengths under strict mode
                fallback = ~shape_ok | (lens < lay.nbytes)
                if vcfg.strict:
                    fallback |= lens != lay.nbytes
                rows = np.flatnonzero(fallback)
                if rows.size:
                    with span("stream.reroute", rerouted=int(rows.size)):
                        verdicts[rows] = host_verdicts(
                            [p_blobs[j] for j in rows])
            if mesh is not None:
                with span("stream.gather"):
                    verdicts, = _gather(mesh, [torch.from_numpy(verdicts)],
                                        lo, len(p_idxs))
                    verdicts = verdicts.cpu().numpy()
            if manifest is not None:
                manifest[cid] = [bool(v) for v in verdicts]
            return list(zip(p_idxs, (bool(v) for v in verdicts)))

    def chunks():
        buf, sts, idxs, cid = [], [], [], 0
        pairs = (zip(proof_blobs, statements, strict=True) if runtime
                 else ((b, None) for b in proof_blobs))
        for gi, (blob, st) in enumerate(pairs):
            buf.append(bytes(blob))
            sts.append(st)
            idxs.append(gi)
            if len(buf) == chunk:
                yield cid, idxs, buf, sts
                buf, sts, idxs, cid = [], [], [], cid + 1
        if buf:
            yield cid, idxs, buf, sts

    prep = None                      # chunk being prepared on the worker
    pending = None                   # chunk dispatched, verdicts not fetched

    def advance():
        """Dispatch the prepared chunk, then fetch the chunk before it."""
        nonlocal prep, pending
        p = dispatch(prep)
        prep = None
        out = collect(pending) if pending is not None else []
        if p[0] == "done":
            out += collect(p)
            pending = None
        else:
            pending = p
        return out

    with ThreadPoolExecutor(max_workers=1) as worker:
        for cid, idxs, blobs, sts in chunks():
            if manifest is not None and cid in manifest:
                yield from zip(idxs, manifest[cid])
                continue
            slot = slots[cid % 2]
            if prep is not None and prep[4] is slot:
                # same-parity prepared chunk (manifest skips break the
                # alternation): it must leave the slot before the refill
                yield from advance()
            lo, hi = (0, len(blobs)) if mesh is None else \
                part_bounds(len(blobs), mesh)
            fut = worker.submit(prepare, cid, slot, blobs[lo:hi], sts[lo:hi])
            if prep is not None:
                yield from advance()             # overlaps the worker
            prep = (cid, idxs, lo, blobs[lo:hi], slot, fut)
        if prep is not None:
            yield from advance()
        if pending is not None:
            yield from collect(pending)
