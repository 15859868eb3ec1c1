"""The port's multi-rank half of parallel/mesh.py on the CPU: gloo ranks
started by mesh.launch, one world of 2 ranks and one of 4 for the whole file
(each runs every case as a step of parallel/rank_checks.run_steps), held
against the one-process paths and the oracle on log_steps=9 blobs from
tests/prover.py; tolerance 0 (verdicts are booleans, compared exactly).

Cases: shard_batch / shard_batch_per_host slices; the sharded verifier on a
golden / tampered / ragged batch; the sharded blob verifier; verify_stream
(mesh=...) in both parse modes, with a ragged blob in one rank's part (that
rank alone takes the independent walk: a deliberate difference from the JAX
package, which picks one walk a chunk) and a last chunk smaller than the
world; verify_point_parallel on a golden proof and on proofs tampered in a
FRI column, a main branch, a lincomb branch and a spot-checked row; the
verifier's kernel calls with and without part; the refusals; a rank that
raises."""

import multiprocessing
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import oracle
import prover
import stark_verifier_tpu_torch as svt
from stark_verifier_tpu_torch.config import StarkConfig
from stark_verifier_tpu_torch.ops import (field_cuda, fri_cuda, merkle_cuda,
                                          spot_cuda)
from stark_verifier_tpu_torch.parallel import mesh as M
from stark_verifier_tpu_torch.parallel import rank_checks as R
from stark_verifier_tpu_torch.proofio import device, static_layout as SL
from stark_verifier_tpu_torch.proofio import wire
from stark_verifier_tpu_torch.protocol import verify as V

torch.set_num_threads(1)
CONSTS = [(i ** 7) ^ 42 for i in range(64)]
CFG = StarkConfig(log_steps=9)
CPU = torch.device("cpu")

# global batches (kind names); "ragged" sits in the last rank's slice
BATCH2 = ["golden", "flipped", "fri_column", "golden", "ragged", "golden"]
BATCH4 = ["golden", "flipped", "ragged", "golden"]
BLOBS = ["golden", "trailing", "truncated", "flipped", "golden", "empty"]
# streams in chunks of 4: 11 blobs at 2 ranks (a ragged blob only in rank
# 1's part of chunk 1), 7 at 4 ranks (rank 3's part of the last chunk is
# empty)
STREAM2 = ["golden", "flipped", "golden", "trailing",
           "golden", "truncated", "ragged", "golden",
           "empty", "golden", "main_branch"]
STREAM4 = ["golden", "ragged", "flipped", "golden",
           "truncated", "golden", "trailing"]
POINT = ["golden", "fri_column", "main_branch", "lincomb", "spot_row"]


def _flip_word(blob, word):
    b = bytearray(blob)
    b[4 * word + 1] ^= 1
    return bytes(b)


def _ragged(blob, depth=11):
    """The last (lincomb) branch with one witness fewer than its group."""
    at = len(blob) - 32 * depth - 4
    assert int.from_bytes(blob[at:at + 4], "little") == 32 * depth
    return (blob[:at] + (32 * (depth - 1)).to_bytes(4, "little")
            + blob[at + 4:-32])


@pytest.fixture(scope="module")
def kinds():
    pb = prover.prove_to_bytes(3, 512, CONSTS)[0]
    lay = SL.canonical_layout(CFG)
    col0 = lay.levels[0][2]

    def rec(g, i):
        return g["start"] + i * g["rec"]

    # tamper sites in different ranks' shares of the queries and branches:
    # query 30 of 40, main branch 150 (a witness word) and 70 (a value word
    # of spot check 35) of 160, lincomb branch 45 of 80
    return {
        "golden": pb, "flipped": _flip_word(pb, 27),
        "fri_column": _flip_word(pb, rec(col0, 30) + 1 + 3),
        "main_branch": _flip_word(pb, rec(lay.main, 150) + 1 + 48 + 1 + 19),
        "lincomb": _flip_word(pb, rec(lay.lincomb, 45) + 1 + 4),
        "spot_row": _flip_word(pb, rec(lay.main, 70) + 1 + 13),
        "ragged": _ragged(pb), "truncated": pb[:1000],
        "trailing": pb + b"trailing", "empty": b"",
    }


@pytest.fixture(scope="module")
def want(kinds):
    """{kind: the oracle's verdict}, which the port's one-process facade
    gives too."""
    out = oracle.mimc(3, 512, CONSTS)

    def verdict(blob):
        try:
            proof, _ = oracle.parse_proof(blob)
            return bool(oracle.verify_mimc_proof(3, 512, CONSTS, out, proof,
                                                 parity_guards=False))
        except (AssertionError, ValueError, IndexError):
            return False

    got = {k: verdict(b) for k, b in kinds.items()}
    assert got == {k: k in ("golden", "trailing") for k in kinds}
    assert got == {k: svt.verify_proof_bytes(b, log_steps=9, device="cpu")
                   for k, b in kinds.items()}
    return got


def _layout(mesh, cfg, kinds, names):
    """A rank step: what shard_batch and shard_batch_per_host hand this rank
    of the global batch `names`: its rows' merkle roots, its offset, and
    whether every leaf is on the mesh's device with canonical strides."""
    trees = {k: device.proof_tree(wire.parse_and_validate(kinds[k], cfg))
             for k in set(names)}
    glob = device.stack_proofs([trees[k] for k in names])
    lo, hi = M.part_bounds(len(names), mesh)
    per_host, offset = M.shard_batch_per_host(
        device.tree_map(lambda x: x[lo:hi], glob), mesh)
    out = {"offset": offset}
    for name, t in (("shard_batch", M.shard_batch(glob, mesh)),
                    ("per_host", per_host)):
        leaves = []
        device.tree_map(leaves.append, t)
        out[name] = {
            "roots": t["merkle_root"].numpy().view(np.uint32).tolist(),
            "canonical": all(x.device == mesh.device and x.stride()
                             == torch.empty(x.shape).stride()
                             for x in leaves)}
    return out


def _steps(kinds, batch, stream, point, blobs=None, layout=None):
    k = {"cfg": CFG, "kinds": kinds}
    steps = []
    if layout:
        steps.append((_layout, dict(k, names=layout)))
    steps += [(R.sharded_batch, dict(k, names=batch)),
              (R.sharded_batch, dict(k, names=batch, per_host=True))]
    if blobs:
        steps += [(R.blob_batch, dict(k, names=blobs)),
                  (R.blob_batch, dict(k, names=blobs, chunk=1))]
    steps += [(R.stream, dict(k, names=stream, chunk=4, device_parse=False)),
              (R.stream, dict(k, names=stream, chunk=4, device_parse=True)),
              (R.point, dict(k, names=point))]
    return steps


def _world(n, steps):
    """One world of n ranks running `steps`.  Its limit, 90 s, is over four
    times the 17.6 s the slower world took in a whole suite's run on six
    workers."""
    t0 = time.time()
    ranks = M.launch(n, R.run_steps, steps, devices="cpu", timeout_s=90)
    for r in ranks:
        assert t0 <= r["joined"] <= time.time()
    return [[r["steps"][i] for r in ranks] for i in range(len(steps))]


@pytest.fixture(scope="module")
def worlds(kinds):
    """{world size: future of {step name: every rank's record, in rank
    order}}.  Both worlds start at once, in the background, and the tests
    compute their one-process references while they run."""
    names = ["layout", "batch", "batch_per_host", "blob", "blob_chunk1",
             "stream_host", "stream_device", "point"]
    steps2 = _steps(kinds, BATCH2, STREAM2, POINT, blobs=BLOBS,
                    layout=["golden", "flipped", "fri_column", "golden"])
    steps4 = _steps(kinds, BATCH4, STREAM4, POINT)
    with ThreadPoolExecutor(max_workers=2) as pool:
        yield {2: pool.submit(lambda: dict(zip(names, _world(2, steps2)))),
               4: pool.submit(lambda: dict(zip(names[1:3] + names[5:],
                                               _world(4, steps4))))}


def _same_on_every_rank(records):
    results = [r["result"] for r in records]
    assert all(x == results[0] for x in results)
    return results[0]


def test_shard_batch_refuses_an_uneven_batch(kinds):
    tree = device.stack_proofs(
        [device.proof_tree(wire.parse_proof(kinds["golden"]))] * 3)
    with pytest.raises(ValueError, match="multiple"):
        M.shard_batch(tree, M.Mesh(2, 0, CPU, "gloo"))
    assert M.part_bounds(3, M.Mesh(2, 1, CPU)) == (2, 3)
    assert M.part_bounds(3, M.Mesh(4, 3, CPU)) == (3, 3)


def test_sharded_blob_verifier_refuses_a_ragged_chunking(kinds):
    fn, lay = M.make_sharded_blob_verifier(M.Mesh(1, 0, CPU), CFG, chunk=2)
    packed, _ = lay.pack([kinds["golden"]] * 3)
    with pytest.raises(ValueError, match="multiple of chunk"):
        fn(packed)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["stream_host", "stream_device"])
def test_stream_verdicts_equal_the_one_process_stream(kinds, worlds, want, n,
                                                      mode):
    names = STREAM2 if n == 2 else STREAM4
    single = dict(M.verify_stream([kinds[k] for k in names], chunk=4, cfg=CFG,
                                  device_parse=mode == "stream_device",
                                  device="cpu"))
    got = _same_on_every_rank(worlds[n].result()[mode])
    assert got == [single[i] for i in range(len(names))]
    assert got == [want[k] for k in names]


@pytest.mark.parametrize("n", [2, 4])
def test_point_parallel_equals_the_one_process_verdict(kinds, worlds, want,
                                                       n):
    fn, _ = V.make_verifier(CFG, device="cpu")
    single = [bool(fn(device.to_device(
        device.proof_tree(wire.parse_proof(kinds[k])), "cpu")))
        for k in POINT]
    got = _same_on_every_rank(worlds[n].result()["point"])
    assert got == single == [want[k] for k in POINT]
    assert got == [True, False, False, False, False]


def test_sharded_blob_verifier_equals_the_one_process_one(kinds, worlds):
    """Verdicts and shape lanes, gathered, equal the one-process blob
    verifier's on the same packed rows, with and without chunks."""
    fn, lay = SL.make_blob_verifier(CFG, device="cpu")
    packed, _ = lay.pack([kinds[k] for k in BLOBS])
    v, so = fn(packed)
    for step in ("blob", "blob_chunk1"):
        got = _same_on_every_rank(worlds[2].result()[step])
        assert got == {"verdict": v.tolist(), "shape_ok": so.tolist()}
    assert so.tolist() == [True, True, False, True, True, False]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("form", ["batch", "batch_per_host"])
def test_sharded_verdicts_equal_verify_batch_and_the_oracle(kinds, worlds,
                                                            want, n, form):
    names = BATCH2 if n == 2 else BATCH4
    trees = [device.proof_tree(wire.parse_proof(kinds[k])) for k in names]
    single = M.verify_batch(trees, CFG, device="cpu").tolist()
    got = _same_on_every_rank(worlds[n].result()[form])
    assert got["verdicts"] == single == [want[k] for k in names]
    assert got["all_ok"] is False


def test_shard_batch_slices_cover_the_batch_once(kinds, worlds):
    """Rank r gets rows [2r, 2r + 2) of the batch, as fresh tensors with
    canonical strides, by both sharding forms."""
    roots = [device.proof_tree(wire.parse_proof(kinds[k]))["merkle_root"]
             .tolist() for k in ["golden", "flipped", "fri_column", "golden"]]
    for rank, rec in enumerate(worlds[2].result()["layout"]):
        got = rec["result"]
        assert got["offset"] == 2 * rank
        for form in ("shard_batch", "per_host"):
            assert got[form]["canonical"]
            assert got[form]["roots"] == roots[2 * rank:2 * rank + 2]


KERNEL_WRAPPERS = [
    (merkle_cuda, "walk_leaf_levels_groups", "A"),
    (merkle_cuda, "walk_quads_groups", "B"),
    (fri_cuda, "fri_rows", "C"),
    (spot_cuda, "spot_checks", "D"),
    (field_cuda, "mul_mod", "E"),
    (merkle_cuda, "walk_branches_groups", "F"),
]


@pytest.fixture
def kernel_calls(monkeypatch):
    """Count the calls of every kernel's wrapper (on the card, one launch
    each)."""
    calls = {}
    for mod, name, letter in KERNEL_WRAPPERS:
        real = getattr(mod, name)

        def counted(*a, _real=real, _letter=letter, **kw):
            calls[_letter] = calls.get(_letter, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("path,want_calls", [
    ("shared", {"A": 2, "B": 2, "C": 1, "D": 1, "E": 2}),
    ("unshared", {"C": 1, "D": 1, "E": 2, "F": 2}),
    ("part", {"C": 1, "D": 1, "E": 2, "F": 2})])
def test_part_keeps_the_kernel_calls(kinds, kernel_calls, path, want_calls):
    """Without part the verifier calls each kernel's wrapper as before (the
    counts of the tree this change started from, for one call of the module
    on one proof of this family); with part the independent walk's kernels,
    as often, on the rank's share; every share of the golden proof
    accepts."""
    tree = device.proof_tree(wire.parse_proof(kinds["golden"]))
    fn, _ = V.make_verifier(CFG, shared_merkle=path == "shared",
                            device="cpu")
    if path == "part":
        for rank in range(4):
            kernel_calls.clear()
            share = M.shard_point_proof(tree, M.Mesh(4, rank, CPU))
            assert share["fri"]["col_value"].shape[-2] == 10
            assert bool(fn(share, part=(rank, 4)))
            assert kernel_calls == want_calls
    else:
        assert bool(fn(device.to_device(tree, "cpu")))
        assert kernel_calls == want_calls


def test_part_refusals(kinds):
    tree = device.proof_tree(wire.parse_proof(kinds["golden"]))
    share = M.shard_point_proof(tree, M.Mesh(2, 0, CPU))
    unshared, _ = V.make_verifier(CFG, shared_merkle=False, device="cpu")
    shared, _ = V.make_verifier(CFG, device="cpu")
    with pytest.raises(ValueError, match="independent walk"):
        shared(share, part=(0, 2))
    with pytest.raises(ValueError, match="share"):
        unshared(share, part=(0, 4))
    with pytest.raises(ValueError, match="share"):
        unshared(device.to_device(tree, "cpu"), part=(0, 2))
    with pytest.raises(ValueError, match="one proof"):
        M.shard_point_proof(device.stack_proofs([tree, tree]),
                            M.Mesh(2, 0, CPU))


@pytest.mark.parametrize("size", [3, 6])
def test_point_mesh_that_does_not_divide_the_queries_raises(kinds, size):
    tree = device.proof_tree(wire.parse_proof(kinds["golden"]))
    with pytest.raises(ValueError, match=f"mesh size {size} does not divide"):
        M.shard_point_proof(tree, M.Mesh(size, 0, CPU, "gloo"))


def test_make_mesh_without_a_group():
    assert M.make_mesh(device="cpu") == M.Mesh(1, 0, CPU)
    assert M.init_distributed(device="cpu") == M.Mesh(1, 0, CPU)
    with pytest.raises(RuntimeError, match="launch"):
        M.make_mesh(2, device="cpu")


def _fail_on_rank_1(mesh):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.barrier()


def test_launch_raises_when_a_rank_fails():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError,
                       match="rank 1 of 2 failed(.|\n)*on purpose"):
        M.launch(2, _fail_on_rank_1, devices="cpu", timeout_s=60)
    assert time.perf_counter() - t0 < 60


def _sleep(mesh, seconds):
    time.sleep(seconds)


def test_a_rank_that_never_returns_times_out():
    """Ranks still running at timeout_s: launch raises TimeoutError by that
    deadline (and the kill after it), not at the ranks' own pace, and no
    rank process outlives it."""
    before = set(multiprocessing.active_children())
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="did not finish within 5"):
        M.launch(2, _sleep, 600, devices="cpu", timeout_s=5)
    assert time.perf_counter() - t0 < 5 + 10
    assert not set(multiprocessing.active_children()) - before
