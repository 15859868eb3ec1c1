#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout:
    python3 chip_smoke.py [--profile]
(--profile adds a torch.profiler pass over one main-path call and one
unshared-path call: the device's busy share, and total and per-launch device
time of the kernels that take most of it.)

It needs a CUDA device, `nvcc`, and nothing else: no network, no JAX.  Phases
(any failure ends the run with a non-zero exit code; nothing falls back to
the CPU):

  1. device   -- the card's name and power limit;
  2. build    -- nvcc builds the kernels from stark_verifier_tpu_torch/csrc;
                 the instruction counts of the bounds are read from this
                 build's SASS (stark_verifier_tpu_torch/sass.py: cuobjdump
                 of the library and of csrc/probes/work.cu);
  3. kernels  -- each kernel against its plain PyTorch version on the card,
                 bit-exact, at the shapes its path gives it (the Merkle walks
                 A, B and F also with all groups of a call site in one
                 launch, as the path runs them; C on the proof's strided poly
                 rows, its ok bytes and evaluation words; D at power 3 and 2,
                 with its K table and with one of 65,536 rows; the multiply's edge
                 operands in C, D and E; the one-stage NTT kernel on a
                 middle stage of 2^20 points and on a cross stage as the
                 sharded NTT launches it; the several-stage NTT kernel
                 through ops/ntt.ntt at 2^6, 2^13, 2^16 and 2^20, forward
                 and inverse; the MiMC scan at 512 steps on 1,024 inputs,
                 powers 3 and 2, and on 1 input; the narrow hashes on a
                 chunk's chains, [512, 6] seeds x 9 links, and its k-hashes,
                 [512, 4, 9] words of 33 bytes), with the wrapper's
                 time (CUDA events around Python calls) and its device time
                 (calls replayed from a CUDA graph) beside the least time the
                 card could take; C's device time also at fewer proofs;
  4. golden   -- a full-size MiMC-STARK proof (2^13 steps) is generated with
                 the pure-Python prover and accepted by the pure-Python oracle;
  5. main path -- 1,024 proofs (12 of them tampered, one per protocol site) in
                 chunks of 512 through make_chunked_verifier on the card;
                 verdicts must be exactly right, equal the CPU path's on the
                 first 16, and the shared-path kernels must have been
                 launched (kernel A twice a chunk; the narrow hashes 8
                 times a chunk: its chains, its k-hashes, 3 + 3 dense tail
                 levels); the narrow hashes of one 512-proof verify,
                 recorded as it made them, against their plain version and
                 timed; then verify_proof_bytes on good / trailing /
                 truncated / flipped blobs (the good one launching the
                 narrow hashes 8 times);
  6. unshared path -- the same batch with shared_merkle=False: every branch
                 walks to the root on its own in the independent-walk kernel
                 (twice a chunk); verdicts equal the main path's.  Then a ragged batch (witness
                 arrays one zero level deeper than the depths, one proof with
                 a short depth) routed by is_rectangular, and
                 verify_proof_bytes on a ragged blob the oracle rejects;
  7. runtime statement -- make_general_verifier with input, round constants
                 and output as tensors (the call's K table from the
                 constants' iNTT and a forward NTT, one launch of the
                 several-stage kernel each; the iNTT held against its plain
                 version, the table against the statement's and its plain
                 version; kernel E takes the four boundary products);
                 verify_mimc on a list of blobs; a fresh power-2 proof
                 through SquareStatement;
 15. CUDA graphs (run after phase 7) -- a verifier module runs a shape
                 eagerly, captures it on its second call and replays it from
                 the third: the 1,024-proof batch of phase 5 through the
                 shared and the unshared module, the general verifier over
                 64 statements (each proof's input and claimed output its
                 own) and single verify_proof_bytes calls, replayed verdicts
                 equal to the eager ones; an eager and a capturing call
                 launch what a call of their walk launches, a replay
                 nothing from Python; two back-to-back replays of different
                 batches leave the first's verdicts as they were; two
                 threads replay one module at once, the golden batch on the
                 default stream and the tampered one on two streams of its
                 own in turns, each thread's verdicts exact; wall ms of each
                 case, eager against replay in turns (`graphs {...}` line).
                 Every launch count of the other phases is read against the
                 verify calls that ran eagerly or were captured
                 (protocol/verify.graph_counts);
 14. one constant a round (run after phase 7) -- 2^13 steps with 8,192
                 round constants: a fresh proof, the verifier's set-up, and
                 1,024 proofs (honest, a bit flipped at each protocol site)
                 through make_general_verifier and verify_mimc, verdicts the
                 oracle's, a moved output rejecting all; the call's K table
                 (4 launches of the several-stage NTT kernel) equal to the
                 statement's (`one constant a round {...}` line);
  8. strict   -- the golden proof accepts, a changed POINTS word rejects
                 under strict and accepts under parity, trailing bytes reject;
  9. bytes to verdicts -- 4,096 distinct blobs (seeded picks of 18 kinds:
                 golden, one bit flipped at each protocol site, truncated,
                 trailing bytes, the ragged blob, a log_steps=9 proof, empty;
                 each kind with the oracle's verdict) through
                 parallel.mesh.verify_stream in chunks of 512, with the host
                 parse (the native parser built by cc, pinned batches) and
                 with the device parse: verdicts exact in both, and each
                 chunk's launches those of the walk its tree selects (and of
                 its rerouted rows).  Then packing ms a proof and H2D GB/s
                 from pinned and pageable memory, and the CLI (`verify`
                 exits 0 / 1 / 2, `bench --batch 1024`) as subprocesses,
                 their JSON lines parsed;
 10. ranks    -- one process a rank (parallel/mesh.launch; each rank runs
                 steps of parallel/rank_checks and counts its own launches):
                 torch.cuda.device_count() ranks over NCCL verify the
                 1,024-proof batch of phase 5 with the sharded verifier; two
                 ranks on the one card over gloo run the sharded verifier,
                 the sharded blob verifier, the 4,096-blob stream of phase 9
                 in both parse modes and point parallelism on a golden and
                 three tampered proofs, each exact against the one-process
                 verdicts or the oracle's, each rank launching kernels A to
                 E on the shared paths and F, C, D and E on the point path;
                 then resident proofs/s at one rank and at two, one proof's
                 latency by point parallelism at one and two ranks beside
                 the one-process path's, the process group's start-up, and
                 `cli bench --devices <cards> --ref-single-chip`; in both
                 worlds the sharded NTT (parallel/ntt.py) at 2^16 and 2^20,
                 forward and inverse, each rank's slice and the gathered
                 result equal to the one-process ntt;
 11. times    -- proofs/s at batch 1,024 (shared, unshared, runtime
                 statement) and 8,192, single-proof latency;
 12. NTT, MiMC scan, debug (run after phase 10, before the times of phase
                 11) -- ops/ntt.ntt at 2^20
                 (2 launches of the several-stage kernel, no other), its
                 round trip and one point against a Horner evaluation on the
                 host, 2^13 against the oracle's FFT, a transform of one
                 stage-kernel launch a stage against the several-stage one
                 at 2^20, 2^16 and 2^13 (equal, then timed in turns); the
                 MiMC scan through
                 MimcStatement.compute_output (the known output of input 3),
                 16 inputs against the oracle at 8,192 steps with the
                 default 64 constants and with 8,192 (more than shared
                 memory holds: read from their rows), a wide constant among
                 the 8,192; ms and cycles a round for 1, 1,024, 16,384 and
                 131,072 inputs with each family, in turns, the SM clock
                 read during a scan; one STARK_DEBUG=1 pass of the first 16
                 proofs of phase 5, and a wide limb that raises;
 13. row forms and inversions (run after phase 5) -- the cross-check forms
                 of ops/quartic.py (eval4_inv_free, eval_interp4_nodes, its
                 split into interp4_nodes_pre + batch_inv +
                 interp4_nodes_finish, interp4 + eval_quartic) on kernel C's
                 phase-3 inputs at B = 512 (two special_x set on a node) and
                 on the 1,024-proof batch of phase 5 (204,800 row groups):
                 every form's words equal kernel C's evaluation words at
                 every row group, and the CPU's on the first 16 proofs;
                 inv_mod, batch_inv (axis -2 and 0) and pow_table on a
                 [1024, 16] input with the edge values, equal to the CPU's
                 and to host ints; each call counted: kernel E exactly once
                 a product, no other kernel; wall ms a form, kernel C's
                 device ms on the same rows (`row forms ...` line).

Each path is driven with every launch count set to 0 just before it and read
just after.  The last line printed is {"ok": true, "device": {...}}; the line
before it holds one JSON record per kernel.
"""

import collections
import json
import os
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False; this "
                     "script needs a CUDA device and does not run on the CPU\n")
    sys.exit(1)

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402

import oracle  # noqa: E402  (pure Python + hashlib)
import prover  # noqa: E402  (pure Python)
import stark_verifier_tpu_torch as sv  # noqa: E402
from stark_verifier_tpu_torch import _build, fp, native, sass  # noqa: E402
from stark_verifier_tpu_torch.config import StarkConfig, cached_tables  # noqa: E402
from stark_verifier_tpu_torch.models.mimc import MimcStatement  # noqa: E402
from stark_verifier_tpu_torch.models.square import SquareStatement  # noqa: E402
from stark_verifier_tpu_torch.ops import (  # noqa: E402
    blake2s, blake2s_cuda, field as F, field_cuda, fri_cuda,
    merkle as merkle_ops, merkle_cuda, mimc, ntt, prg, quartic, spot_cuda)
from stark_verifier_tpu_torch.parallel import mesh as M  # noqa: E402
from stark_verifier_tpu_torch.parallel import rank_checks as R  # noqa: E402
from stark_verifier_tpu_torch.proofio import (  # noqa: E402
    device as dev_io, ingest, static_layout as SL, wire)
from stark_verifier_tpu_torch.protocol import verify as V  # noqa: E402

DEV = torch.device("cuda")
P = fp.MODULUS
LOG_STEPS = 13         # the default statement family, at full width
CHUNK = 512            # proofs per chunk on the main path
BATCH = 1024
BIG_BATCH = 8192
RAGGED_BATCH = 16      # proofs of the padded batch of the unshared path
MUL_BIG = 1 << 20      # elements of the multiply's large comparison
NTT_LOGS = (20, 16, 13, 6)  # NTT sizes held against the plain version
NTT_STAGE = 10         # the middle stage of 2^20 timed alone
MIMC_STEPS = 8192      # the default family's trace: 8,191 rounds
MIMC_INPUTS = (1, 1024, 16384, 131072)  # inputs of the timed scans
MIMC_OUT_3 = int("95224774355499767951968048714566316597785297695903697235"
                 "130434363122555476056")   # its output for input 3

# Published peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of device
# memory bandwidth and 67 TFLOP/s of float32 outside the tensor cores.  The
# float32 figure is 128 lanes an SM at about 1.98 GHz, each counted as 2
# operations per fused multiply-add.  Two integer rates follow from it:
#   * the issue rate, 67e12 / 2 instructions a second: 4 schedulers an SM,
#     one warp instruction a clock each, so no kernel issues more, of any
#     kind;
#   * the ALU pipe's rate, 67e12 / 4: 16 lanes on each of the 4
#     sub-partitions.  LOP3, SHF, PRMT, SEL and ISETP run there and nowhere
#     else; an add may also run on the FMA pipe (IMAD, VIADD), so an add
#     counts against the issue rate only.
# An operations bound is the larger of (all instructions / issue rate) and
# (ALU-only instructions / ALU rate), so it holds whichever pipe the code
# sends its adds to.
MEM_BYTES_PER_S = 3.35e12
INSTR_PER_S = 67e12 / 2
ALU_PER_S = 67e12 / 4

# Where the instructions a unit of work needs, (all, ALU-only), are read
# from this build's SASS (stark_verifier_tpu_torch/sass.py):
#   a Blake2s compression of kernels A, B and F and of the narrow hashes:
#     the level loop of the kernel (the block loop, the link loop; part of
#     its mangled name here), its LOP3, PRMT and SHF (the xors, rotates and
#     feed-forward, ALU pipe only) and its adds; the row's loads, the
#     message selects and the loop's control are left out, so that a leaf's
#     compressions (and B's combine) count the same;
#   kernels C, D and E: the probes of csrc/probes/work.cu, the products,
#     reductions, adds and compares of a unit of the function, with no
#     loads, stores, moves or limb packing; C's special_x is canonicalized
#     once per (proof, level), as the function needs, though the kernel
#     redoes it in every thread.
SASS_COMPRESS = {"walk_leaf_levels": "stark_walk_groups_kernelILi0",
                 "walk_branches": "stark_walk_groups_kernelILi1",
                 "walk_quads": "stark_walk_groups_kernelILi2",
                 "hash_words": "stark_hash_kernelILb0E",
                 "hash_chain": "stark_hash_kernelILb1E"}
SASS_PROBES = ("probe_eval4_row", "probe_eval4_special_x", "probe_spot3",
               "probe_spot2", "probe_mul", "probe_butterfly", "probe_mimc3",
               "probe_mimc2")

# operands that the 256-bit multiply must carry right: 0, 1, p - 1, p,
# p + 1, 2^256 - 1, and limb patterns whose products carry through every
# column
EDGES = [0, 1, P - 1, P, P + 1, 2**256 - 1, 2**256 - 2**32, 2**224 - 1,
         int("FFFFFFFF00000000" * 4, 16), int("00000000FFFFFFFF" * 4, 16),
         2**255, (P - 1) // 2]

SITES = [
    ("merkle_root",), ("l_merkle_root",),
    ("fri", "root2"), ("fri", "col_value"), ("fri", "col_sibling"),
    ("fri", "poly_value"), ("fri", "col_witness", 0),
    ("fri", "poly_witness", 2),
    ("main", "value"), ("main", "witness"),
    ("lincomb", "value"), ("lincomb", "sibling"),
]


def log(msg):
    print(msg, flush=True)


def fail(msg):
    sys.stderr.write(f"chip_smoke: FAILED: {msg}\n")
    sys.exit(1)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps):
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=20, replays=5):
    """Milliseconds of device time per call of `fn`: `reps` calls are
    captured into one CUDA graph and replayed, so that no Python call lies
    between two launches.  Counts every device kernel the call issues (the
    hand-written one and whatever small PyTorch kernels its wrapper adds)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved, work):
    """(least ms, "bytes" or "operations", the three times) for the work
    [(units, (all, ALU-only) instructions a unit), ...] moving
    `bytes_moved` bytes."""
    parts = {"bytes_ms": bytes_moved / MEM_BYTES_PER_S * 1e3,
             "instr_ms": sum(u * o[0] for u, o in work) / INSTR_PER_S * 1e3,
             "alu_ms": sum(u * o[1] for u, o in work) / ALU_PER_S * 1e3}
    ms = max(parts.values())
    return ms, ("bytes" if ms == parts["bytes_ms"] else "operations"), parts


def max_abs_err(a, b):
    if a.shape != b.shape:
        fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def rand_words(gen, shape):
    """Random 32-bit words as int32 bit patterns, with all-ones and
    sign-bit-only words mixed in."""
    w = torch.randint(-2**31, 2**31, shape, generator=gen, device=DEV,
                      dtype=torch.int64).to(torch.int32)
    flat = w.view(-1)
    flat[0::7] = -1                  # 0xFFFFFFFF
    flat[3::11] = -2**31             # 0x80000000
    return w


def edge_limbs():
    return dev_io.to_tensor(fp.ints_to_limbs(EDGES), DEV)


def edge_words():
    """The edge values as the proof's 8 big-endian words."""
    return F.limbs_to_words_be(edge_limbs())


def rand_limbs(gen, shape):
    """Random raw 256-bit values as [..., 16] limbs; the first few are the
    edge values (EDGES) where there is room for all of them."""
    l = torch.randint(0, 1 << 16, shape + (16,), generator=gen, device=DEV,
                      dtype=torch.int64).to(torch.int32)
    flat = l.view(-1, 16)
    if flat.shape[0] >= len(EDGES):
        flat[:len(EDGES)] = edge_limbs()
    flat[len(EDGES)::13] = 0xFFFF    # all-ones values (>= p)
    return l


def start_indices(lead, depth, gen):
    idx = torch.randint(0, 1 << (depth + 1), lead, generator=gen, device=DEV,
                        dtype=torch.int64)
    ld4 = 1 << (depth - 1)
    return ((1 << (depth + 2)) + idx // ld4 + 4 * (idx % ld4)).to(torch.int32)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def measure(label, call, plain, got, want, moved, work, reps):
    """A kernel case: its results against the plain version's, the wrapper's
    and the device's time of `call`, the plain version's, and the bound for
    `work` (as bound() takes it) moving `moved` bytes."""
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    ms, dms = time_ms(call, reps), device_ms(call)
    plain_ms = time_ms(plain, 2)
    bms, by, parts = bound(moved, work)
    return {"shape": label, "max_abs_err": err, "ms": ms, "device_ms": dms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, **parts}


def walk_inputs(gen, b, n, vw, depth, levels):
    val, sib = rand_words(gen, (b, n, vw)), rand_words(gen, (b, n, vw))
    wit = rand_words(gen, (b, n, depth, 8))
    return (val, sib, wit, start_indices((b, n), depth, gen), levels)


def check_walk(gen, ops, b, specs, label, reps):
    """Kernel A on the groups of `specs` ((n, vw, depth, levels) each, b x n
    branches) in one launch, against the plain version group by group."""
    groups = [walk_inputs(gen, b, *sp) for sp in specs]
    got = merkle_cuda.walk_leaf_levels_groups(groups)
    torch.cuda.synchronize()
    want = [merkle_cuda.walk_leaf_levels_plain(*g) for g in groups]
    moved = compressions = 0
    for val, sib, _, ti, levels in groups:
        items = ti.numel()
        moved += nbytes(val, sib, ti) + items * 32 * (levels + 1)
        compressions += items * ((3 if val.shape[-1] == 24 else 1) + levels)

    return measure(label, lambda: merkle_cuda.walk_leaf_levels_groups(groups),
                   lambda: [merkle_cuda.walk_leaf_levels_plain(*g)
                            for g in groups],
                   got, want, moved,
                   [(compressions, ops["walk_leaf_levels"])], reps)


def quad_inputs(gen, b, q, depth, levels, bad=True):
    """One FRI poly group of the shared walk as kernel B takes it: b x 4q
    branches in sibling quads (b's sibling is b+1's value), 4-aligned start
    indices, every branch's first witness the other pair's digest -- except,
    with `bad`, branch 1's in every seventh quad, whose ok word must be 0."""
    val = rand_words(gen, (b, q, 4, 8))
    sib = val[:, :, [1, 0, 3, 2], :].contiguous()
    wit = rand_words(gen, (b, q, 4, depth, 8))
    pairs = blake2s.hash_leaf_pair(val[:, :, 0::2], sib[:, :, 0::2])
    wit[:, :, 0:2, 0] = pairs[:, :, None, 1]
    wit[:, :, 2:4, 0] = pairs[:, :, None, 0]
    if bad:
        wit[:, 3::7, 1, 0, 2] ^= 1
    y = torch.randint(0, 1 << (depth - 1), (b, q, 1), generator=gen,
                      device=DEV, dtype=torch.int64)
    ti = ((1 << (depth + 2)) + 4 * y
          + torch.arange(4, device=DEV)).to(torch.int32)
    return (val.reshape(b, 4 * q, 8), sib.reshape(b, 4 * q, 8),
            wit.reshape(b, 4 * q, depth, 8), ti.reshape(b, 4 * q), levels)


def check_quads(gen, ops, b, specs, label, reps):
    """Kernel B on the quad groups of `specs` ((q, depth, levels) each, b x q
    quads) in one launch, against the plain version group by group."""
    groups = [quad_inputs(gen, b, *sp) for sp in specs]
    got = merkle_cuda.walk_quads_groups(groups)
    torch.cuda.synchronize()
    want = [merkle_cuda.walk_quads_plain(*g) for g in groups]
    for _, ok in want:
        if bool(ok.all()) or not bool(ok.any()):
            fail("quad comparison inputs do not mix passing and failing "
                 "first witnesses as intended")
    # what a quad needs: its two leaves' rows, four first witnesses, its
    # levels' rows, its start index; out a digest and an ok word
    moved = compressions = 0
    for val, *_, levels in groups:
        quads = val.numel() // 32
        moved += quads * (4 * 32 + 4 * 32 + levels * 32 + 4 + 32 + 4)
        compressions += quads * (3 + levels)
    return measure(label, lambda: merkle_cuda.walk_quads_groups(groups),
                   lambda: [merkle_cuda.walk_quads_plain(*g) for g in groups],
                   [t for pair in got for t in pair],
                   [t for pair in want for t in pair], moved,
                   [(compressions, ops["walk_quads"])], reps)


def fri_inputs(gen, cfg, tables, g2_words, b):
    """Kernel C's operands at the path's shapes: b proofs' poly rows read in
    place from wider rows (a proof stride beyond them, as a slice of a
    batch may have), committed values, column indices over the 32-bit range
    (0 and the top on the last level), roots (the edge values among them)
    and the verifier's packed power table.  Random committed values fail:
    they are rewritten so that every third query holds, except a tampered
    word at queries 6 and 27, and at proof 1, level 2, query 3, whose rows
    are the constant 5 and whose committed value is 5 + p, right but not
    canonical; at proof 2, level 1, queries 3, 9, 12 and 15 the rows are
    constants the compare must carry right.  Returns (operands, the ok
    bytes those rewrites make)."""
    nl, q = cfg.fri_levels, cfg.fri_queries
    wide = rand_words(gen, (b, nl * 4 * q * 8 + 64))
    poly = wide[:, 64:].view(b, nl, 4 * q, 8)
    ne = len(EDGES)
    poly[0].reshape(-1, 8)[:ne] = edge_words()
    col = rand_words(gen, (b, nl, q, 8))
    ys = torch.randint(0, 2**32, (b, nl, q), generator=gen, device=DEV,
                       dtype=torch.int64)
    ys[0, -1, :2] = torch.tensor([0, 2**32 - 1], device=DEV)
    lroot, root2 = rand_words(gen, (b, 8)), rand_words(gen, (b, nl, 8))
    lroot[:ne] = edge_words()
    root2[:ne, 1] = edge_words()
    five = F.limbs_to_words_be(limbs_on_card([5, P + 5]))
    poly[1, 2, 0:4] = five[[0, 1, 0, 0]]
    poly[1, 2, 12:16] = five[1]
    # constant rows c at held queries: 4 c carries past 2^256 once folded
    # (the first two), or not
    consts = F.limbs_to_words_be(limbs_on_card(
        [2**255 - 1, 3 * 2**254 - 1, P - 1, 0]))
    for k, c in zip((3, 9, 12, 15), consts):
        poly[2, 1, 4 * k:4 * k + 4] = c
    ops = (poly, col, ys, lroot, root2, g2_words,
           np.asarray(tables.quartic_ginv), np.asarray(tables.inv4))
    _, lhs = fri_cuda.fri_rows_plain(*ops)
    col[:, :, 0::3] = lhs[:, :, 0::3]
    col[:, :, 6::21, 5] ^= 1
    col[1, 2, 3] = five[1]
    expect = torch.zeros((b, nl, q), dtype=torch.bool, device=DEV)
    expect[:, :, 0::3] = True
    expect[:, :, 6::21] = False
    expect[1, 2, 3] = False
    return ops, expect


def check_rows(gen, ops, cfg, tables, g2_words, b, reps):
    """Kernel C as the verifier calls it, its ok bytes and its evaluation
    words against the plain version's."""
    args, expect = fri_inputs(gen, cfg, tables, g2_words, b)
    got = fri_cuda.fri_rows(*args, lhs=True)
    torch.cuda.synchronize()
    want = fri_cuda.fri_rows_plain(*args)
    if not torch.equal(want[0], expect):
        fail("row-check comparison inputs do not mix accepted and rejected "
             "queries as intended")
    nl, q = cfg.fri_levels, cfg.fri_queries
    # what a row group needs: its four poly rows, its committed value, its
    # index, its ok byte; a (proof, level) its special_x; the table once
    moved = b * nl * q * (128 + 32 + 8 + 1) + b * nl * 32 + nbytes(g2_words)
    rec = measure(f"B={b} levels={nl} queries={q}",
                  lambda: fri_cuda.fri_rows(*args),
                  lambda: fri_cuda.fri_rows_plain(*args), got, want, moved,
                  [(b * nl * q, ops["probe_eval4_row"]),
                   (b * nl, ops["probe_eval4_special_x"])], reps)
    # fewer proofs: 422 fill the card once at 4 blocks of 160 an SM (about
    # 95 registers a thread), 424 start a second wave
    rec["device_ms_at_proofs"] = {
        n: device_ms(lambda: fri_cuda.fri_rows(
            *(t[:n] for t in args[:5]), *args[5:]))
        for n in (128, 256, 416, 424, b)}
    log(f"kernel fri_rows: device ms by proofs {rec['device_ms_at_proofs']}")
    return rec


def spot_inputs(gen, cfg, tabs, b, power):
    """Kernel D's operands at the path's shapes: the proof's main and
    lincomb value rows (raw words, 0xFFFFFFFF words mixed in), positions in
    the domain, raw k-hash words, canonical interpolant rows, the packed
    tables `tabs`.
    Random inputs fail every check: the committed values are rewritten so
    that the transition holds at every third position from 0, the lincomb
    from 1 and the boundary from 2."""
    n = cfg.spot_checks
    main = rand_words(gen, (b, 2 * n, 24))
    lin = rand_words(gen, (b, n, 8))
    kh = rand_words(gen, (b, 4, 8))
    pos = torch.randint(0, cfg.precision, (b, n), generator=gen, device=DEV,
                        dtype=torch.int64)
    ic1 = F.canon(rand_limbs(gen, (b,)))
    ic0 = F.canon(rand_limbs(gen, (b,))).flip(0).contiguous()
    # the right-hand sides, from the plain version's limbs and gathers
    # (input making stays off the multiply kernel)
    mul = field_cuda.mul_mod_plain
    mv = main.view(b, n, 2, 3, 8)
    # the multiply's edge operands: P and D of proof 0's first positions,
    # and its raw k's
    ew = edge_words()
    mv[0, :len(EDGES), 0, 0] = ew
    mv[0, :len(EDGES), 0, 1] = ew.flip(0)
    kh[0] = ew[[5, 3, 8, 9]]
    p, d, bb = (F.canon(F.words_be_to_limbs(mv[..., 0, j, :]))
                for j in range(3))
    mask = cfg.precision - 1
    x, xs, z, z2 = (F.words_le_to_limbs(t[i]) for t, i in (
        (tabs.g2, pos & mask), (tabs.g2, (pos << cfg.log_steps) & mask),
        (tabs.z, pos & mask), (tabs.z2, pos & mask)))
    k = F.words_le_to_limbs(tabs.k[pos & (tabs.k.shape[0] - 1)])
    ks = F.words_be_to_limbs(kh)[:, None]
    p_pow = [(mul(p, p), p)] if power == 3 else [(p, p)]
    rhs_t = F.limbs_to_words_be(F.mul_sum_mod(p_pow + [(z, d)], extra=[k]))
    rhs_l = F.limbs_to_words_be(F.mul_sum_mod(
        [(ks[..., 0, :], p), (ks[..., 1, :], mul(p, xs)),
         (ks[..., 2, :], bb), (ks[..., 3, :], mul(bb, xs))], extra=[d]))
    rhs_b = F.limbs_to_words_be(F.mul_sum_mod(
        [(bb, z2), (ic1[:, None], x)], extra=[ic0[:, None].expand(x.shape)]))
    mv[:, 0::3, 1, 0] = rhs_t[:, 0::3]
    lin[:, 1::3] = rhs_l[:, 1::3]
    mv[:, 2::3, 0, 0] = rhs_b[:, 2::3]           # (changes P: only bit 1 there)
    return (main, lin, pos, kh, ic1, ic0, tabs)


def check_spot(gen, ops, cfg, tabs, b, power, reps):
    args = spot_inputs(gen, cfg, tabs, b, power)
    got = spot_cuda.spot_checks(*args, power=power)
    torch.cuda.synchronize()
    want = spot_cuda.spot_checks_plain(*args, power=power)
    frac = want.to(torch.float32).mean(dim=(0, 1)).tolist()
    if not (want[:, 0::3, 0].all() and want[:, 1::3, 2].all()
            and want[:, 2::3, 1].all()) or want.all():
        fail("spot-check comparison inputs do not mix passing and failing "
             f"positions as intended (pass fractions {frac})")
    n = cfg.spot_checks
    # what a position needs: main row 2k (P, D, B) and P of row 2k+1, L, its
    # position, five table rows (x, x^steps, Z, Z2, K); per proof the k-hash
    # words and the two interpolant rows; out three bytes a position
    moved = b * n * (96 + 32 + 32 + 8 + 5 * 32 + 3) + b * (128 + 2 * 64)
    label = (f"B={b} positions={n} power={power} K table "
             f"{tabs.k.shape[0]} rows")
    rec = measure(label, lambda: spot_cuda.spot_checks(*args, power=power),
                  lambda: spot_cuda.spot_checks_plain(*args, power=power),
                  [got], [want], moved, [(b * n, ops[f"probe_spot{power}"])],
                  reps)
    rec["pass_fractions"] = frac
    return rec


def check_mul(gen, ops, shape_a, shape_b, reps, upper_half=False):
    """Kernel E at one pair of operand shapes (leading shapes, broadcast):
    raw operands, values >= p and the edge values on both sides.  With
    `upper_half`, `a` is the strided view the iNTT's butterfly multiplies:
    the upper half of every block of twice its second-to-last length."""
    a, b = rand_limbs(gen, shape_a), rand_limbs(gen, shape_b)
    if upper_half:
        half = shape_a[-1]
        blocks = torch.zeros(shape_a[:-1] + (2 * half, 16), dtype=torch.int32,
                             device=DEV)
        blocks[..., half:, :] = a
        a = blocks[..., half:, :]
    ne = len(EDGES)
    if shape_b:
        b = b.flip(0).contiguous()       # the edge values meet random ones
        if a.shape == b.shape and b.shape[0] >= ne * ne:
            # ... and every pair of edge values
            a[:ne * ne] = edge_limbs().repeat_interleave(ne, dim=0)
            b[:ne * ne] = edge_limbs().repeat(ne, 1)
        elif a.shape == b.shape and b.shape[0] >= ne:
            b[:ne] = a[:ne].flip(0)      # ... and each other
    got = field_cuda.mul_mod(a, b)
    torch.cuda.synchronize()
    want = field_cuda.mul_mod_plain(a, b)
    if not torch.equal(F.canon(got), got):
        fail("the multiply kernel returned a value that is not canonical")
    label = (f"{list(shape_a) + [16]} x {list(shape_b) + [16]}"
             + (f", a with strides {list(a.stride())}" if upper_half else ""))
    return measure(label, lambda: field_cuda.mul_mod(a, b),
                   lambda: field_cuda.mul_mod_plain(a, b), [got], [want],
                   nbytes(a, b, got), [(got.numel() // 16, ops["probe_mul"])],
                   reps)


def ntt_root(n):
    return pow(7, (P - 1) // n, P)


def ntt_function_bound(ops, n, inverse):
    """The least time of one n-point transform: its input read once, its
    output written once, the twiddle powers read once, and n/2 log2(n)
    butterflies (plus n products of the inverse's scaling)."""
    logn = n.bit_length() - 1
    work = [(n // 2 * logn, ops["probe_butterfly"])]
    if inverse:
        work.append((n, ops["probe_mul"]))
    return n * 64 * 2 + n // 2 * 32, work


def check_ntt_stage(gen, ops, logn, s):
    """One launch of the stage kernel, stage s of a 2^logn-point transform,
    as the stages between the first and the last run: the 8-word working
    layout in and out (raw values, the edge values among them), against
    the plain stage on the same values."""
    n = 1 << logn
    x = rand_limbs(gen, (n,))
    w = ntt_root(n)
    _, tw = ntt._card_tables(w, n, P, str(x.device))
    src = F.limbs_to_words_le(x).contiguous()
    dst = torch.empty_like(src)
    lib = _build.load()

    args = _build.NttStageArgs(
        src=src.data_ptr(), perm=None, tw=tw.data_ptr(), scale=None,
        dst=dst.data_ptr(), lead=1, n=n, src_n=n, half=1 << s,
        tw_rows=tw.shape[0], tw_stride=tw.shape[0] >> s, tw_off=0,
        src_limbs=0, dst_limbs=0)

    def call():
        ntt._launch(lib, ntt._stream(DEV), args)

    call()
    torch.cuda.synchronize()
    got = F.words_le_to_limbs(dst)
    stage_tw = torch.from_numpy(
        ntt._twiddle_stages(w, n, P)[s].astype(np.int32)).to(DEV)
    want = ntt.stage_plain(x, stage_tw)
    return measure(f"one stage (s={s}) of 2^{logn} points, 8-word layout",
                   call, lambda: ntt.stage_plain(x, stage_tw), [got], [want],
                   nbytes(src, dst) + (1 << s) * 32,
                   [(n // 2, ops["probe_butterfly"])], 10)


def check_cross_stage(gen, ops, logn):
    """One launch of the stage kernel as the sharded NTT runs a cross stage
    (ops/ntt.cross_stage): the last stage of a 2^logn-point transform, its
    pairs (a[j], b[j]) the two halves of the points, raw values, against the
    plain butterfly on the same operands (the twiddle rows gathered from the
    same table)."""
    n = 1 << logn
    half, s = n // 2, logn - 1
    a, b = rand_limbs(gen, (half,)), rand_limbs(gen, (half,))
    _, tw = ntt._card_tables(ntt_root(n), n, P, str(DEV))
    rows = torch.arange(half, device=DEV) * (tw.shape[0] >> s)
    w = F.words_le_to_limbs(tw[rows])

    def plain():
        t = field_cuda.mul_mod_plain(w, b)
        return torch.stack([F.add_mod(a, t), F.sub_mod(a, t)])

    def call():
        return ntt.cross_stage(a, b, tw, s, 0)

    got = call()
    torch.cuda.synchronize()
    return measure(f"a cross stage (s={s}) of 2^{logn} points, limbs in and "
                   "out", call, plain, [got], [plain()],
                   nbytes(a, b, got) + half * 32,
                   [(half, ops["probe_butterfly"])], 10)


def pass_bytes(n, inverse):
    """Bytes the passes of an n-point transform move: the first reads the
    caller's limbs (64 bytes a point) and the permutation, passes between
    read and write the 8-word buffer, the last writes limbs; each pass reads
    about one twiddle a point (a block C (2^k - 1)) and the inverse n^-1."""
    plan = ntt.passes(n.bit_length() - 1, n)
    moved = n * 4 + (32 if inverse else 0)
    for i in range(len(plan)):
        moved += n * (64 if i == 0 else 32) + n * (64 if i == len(plan) - 1
                                                   else 32) + n * 32
    return moved


def check_ntt(gen, ops, logn, inverse, reps):
    """ops/ntt.ntt on the card (one launch of the several-stage kernel a
    pass) against its plain version on the card, raw values with the edge
    values among them."""
    n = 1 << logn
    x = rand_limbs(gen, (n,))
    root = ntt_root(n)       # once: a 256-bit power on the host is ~0.2 ms
    got = ntt.ntt(x, root, inverse)
    torch.cuda.synchronize()
    want = ntt.ntt_plain(x, root, inverse)
    moved, work = ntt_function_bound(ops, n, inverse)
    case = measure(f"{'inverse' if inverse else 'forward'} transform, "
                   f"2^{logn} points", lambda: ntt.ntt(x, root, inverse),
                   lambda: ntt.ntt_plain(x, root, inverse), [got],
                   [want], moved, work, reps)
    case["passes"] = len(ntt.passes(logn, n))
    case["pass_bytes_bound_ms"] = pass_bytes(n, inverse) / MEM_BYTES_PER_S \
        * 1e3
    return case


def per_stage_ntt(x, root, inverse=False):
    """A transform as one launch of the stage kernel a stage (the structure
    of the port's first NTT, on this build's butterfly): the first gathering
    from the caller's limbs, the stages between in place on the 8-word
    buffer, the last writing limbs scaled by n^-1.  Kept here, off the
    port's path, as the yardstick of the several-stage kernel."""
    n = x.shape[-2]
    logn = n.bit_length() - 1
    perm, tw = ntt._card_tables(ntt._transform_root(root, inverse, P), n, P,
                                str(x.device))
    scale = ntt._scale_words(n, P, str(x.device)) if inverse else None
    out = torch.empty((1, n, 16), dtype=torch.int32, device=x.device)
    work = torch.empty((1, n, 8), dtype=torch.int32, device=x.device)
    args = _build.NttStageArgs(tw=tw.data_ptr(), lead=1, n=n,
                               tw_rows=tw.shape[0], tw_off=0)
    lib, stream = _build.load(), ntt._stream(x.device)
    for s in range(logn):
        first, last = s == 0, s == logn - 1
        args.src = (x if first else work).data_ptr()
        args.dst = (out if last else work).data_ptr()
        args.perm = perm.data_ptr() if first else None
        args.scale = scale.data_ptr() if last and inverse else None
        args.src_n = n
        args.half, args.tw_stride = 1 << s, tw.shape[0] >> s
        args.src_limbs, args.dst_limbs = int(first), int(last)
        ntt._launch(lib, stream, args)
    return out[0]


MIMC_CONSTS = [(i ** 7) ^ 42 for i in range(64)]


def check_mimc(gen, ops, n, steps, power=3, reps=3):
    """The MiMC scan kernel (ops/mimc.mimc) against its plain version on
    the card: raw inputs, the edge values among them, the default family's
    constants."""
    x = rand_limbs(gen, (n,))
    c = limbs_on_card(MIMC_CONSTS)
    got = mimc.mimc(x, steps, c, power)
    torch.cuda.synchronize()
    want = mimc.mimc_plain(x, steps, c, power)
    return measure(f"{n} inputs, {steps} steps, power {power}",
                   lambda: mimc.mimc(x, steps, c, power),
                   lambda: mimc.mimc_plain(x, steps, c, power), [got],
                   [want], nbytes(x, c, got),
                   [(n * (steps - 1), ops[f"probe_mimc{power}"])], reps)


def check_hash_words(ops, words, length, label, reps):
    """The narrow-hash kernel on the messages `words` [..., W] of `length`
    bytes against the plain version, word for word."""
    got = blake2s_cuda.hash_words(words, length)
    torch.cuda.synchronize()
    want = blake2s.hash_words_plain(words, length)
    n = got.numel() // 8
    return measure(label, lambda: blake2s_cuda.hash_words(words, length),
                   lambda: blake2s.hash_words_plain(words, length), [got],
                   [want], nbytes(words, got),
                   [(n * max(1, -(-length // 64)), ops["hash_words"])], reps)


def check_hash_chain(gen, ops, lead, links, reps):
    """The chain mode on random seeds [*lead, 8] against the plain chain
    (prg.chain_entries_plain), word for word."""
    seeds = rand_words(gen, lead + (8,))
    got = blake2s_cuda.chain_entries(seeds, links)
    torch.cuda.synchronize()
    want = prg.chain_entries_plain(seeds, links + 1)
    n = seeds.numel() // 8
    return measure(f"{list(lead) + [8]} seeds x {links} links",
                   lambda: blake2s_cuda.chain_entries(seeds, links),
                   lambda: prg.chain_entries_plain(seeds, links + 1), [got],
                   [want], nbytes(seeds, got),
                   [(n * links, ops["hash_chain"])], reps)


def check_hash_recorded(ops, fn, tree, kernels):
    """The narrow hashes of one verify call of CHUNK proofs, recorded as
    the call made them (the k-hash, the dense tail levels of both shared
    walks), each against the plain version and timed: cases of the
    hash_words record."""
    calls, real = [], blake2s_cuda.hash_words

    def recording(words, nbytes):
        calls.append((words.clone(), nbytes))
        return real(words, nbytes)

    blake2s_cuda.hash_words = recording
    eager_next(fn)
    try:
        fn(dev_io.tree_map(lambda x: x[:CHUNK], tree))
        torch.cuda.synchronize()
    finally:
        blake2s_cuda.hash_words = real
    rec, = (k for k in kernels if k["name"] == "hash_words")
    tails = 0
    for words, nb in calls:
        what = "k-hash" if nb == 33 else f"tail level {tails}"
        tails += nb != 33
        c = check_hash_words(ops, words, nb, f"recorded {what}: "
                             f"{list(words.shape)} words, {nb} bytes", 20)
        log(f"kernel hash_words [{c['shape']}]: max_abs_err "
            f"{c['max_abs_err']}, wrapper {c['ms']:.4f} ms, device "
            f"{c['device_ms']:.4f} ms, plain {c['plain_ms']:.2f} ms, bound "
            f"{c['bound_ms']:.5f} ms ({c['bound_by']}; ALU pipe "
            f"{c['alu_ms']:.5f})")
        if c["max_abs_err"]:
            fail(f"hash_words disagrees with its plain version on the "
                 f"recorded {what}")
        rec["cases"].append(c)
    return len(calls)


def branch_inputs(gen, b, n, vw, depth, max_depth=None, mixed=False):
    """One group of the unshared path: b x n branches of `depth` witness
    levels each (mixed: 1..max_depth by lane), witness arrays max_depth deep
    (one more than depth = a padded level, never hashed)."""
    max_depth = max_depth or depth
    val, sib = rand_words(gen, (b, n, vw)), rand_words(gen, (b, n, vw))
    wit = rand_words(gen, (b, n, max_depth, 8))
    if mixed:
        d64 = torch.randint(1, max_depth + 1, (b, n), generator=gen,
                            device=DEV, dtype=torch.int64)
    else:
        d64 = torch.full((b, n), depth, device=DEV, dtype=torch.int64)
    idx = torch.randint(0, 1 << 31, (b, n), generator=gen, device=DEV,
                        dtype=torch.int64) % (1 << (d64 + 1))
    ld4 = 1 << (d64 - 1)
    ti = ((1 << (d64 + 2)) + idx // ld4 + 4 * (idx % ld4)).to(torch.int32)
    return (val, sib, wit, ti, d64.to(torch.int32))


def check_branches(gen, ops, b, specs, label, reps, max_depth=None,
                   mixed=False):
    """Kernel F on the groups of `specs` ((n, vw, depth) each) in one
    launch, against the plain version group by group (and, at a uniform
    depth, against the static walk too)."""
    groups = [branch_inputs(gen, b, *sp, max_depth=max_depth, mixed=mixed)
              for sp in specs]
    got = merkle_cuda.walk_branches_groups(groups)
    torch.cuda.synchronize()
    want = [merkle_cuda.walk_branches_plain(*g) for g in groups]
    if not mixed and max_depth is None:
        # at a uniform depth the independent walk is the static one
        got, want = got + got, want + [
            merkle_cuda.walk_leaf_levels_plain(*g[:4], g[2].shape[-2])
            for g in groups]
    # what this run's depths need: the leaf's compressions and one a level
    moved = compressions = 0
    for val, sib, _, ti, d32 in groups:
        levels = int(d32.sum().item())
        moved += nbytes(val, sib, ti, d32) + ti.numel() * 32 + levels * 32
        compressions += ti.numel() * (3 if val.shape[-1] == 24 else 1) + levels

    rec = measure(label, lambda: merkle_cuda.walk_branches_groups(groups),
                  lambda: [merkle_cuda.walk_branches_plain(*g) for g in groups],
                  got, want, moved, [(compressions, ops["walk_branches"])],
                  reps)
    rec["compressions"] = compressions
    return rec


def check_value_classes(gen):
    """ops/merkle.verify_branches with a value size per branch on the card:
    each size class a group of one launch of kernel F (rows of 10 words, so
    the 32-byte class is a slice the kernel cannot read in place and the
    others take the word-by-word leaf hash), against the same call on the
    CPU."""
    b, n, max_depth, classes = 64, 96, 6, (32, 40, 12)
    val, sib = rand_words(gen, (b, n, 10)), rand_words(gen, (b, n, 10))
    wit = rand_words(gen, (b, n, max_depth, 8))
    depth = torch.randint(1, max_depth + 1, (b, n), generator=gen, device=DEV,
                          dtype=torch.int64).to(torch.int32)
    idx = torch.randint(0, 4, (b, n), generator=gen, device=DEV,
                        dtype=torch.int64).to(torch.int32)
    pick = torch.randint(0, 3, (b, n), generator=gen, device=DEV)
    vsizes = torch.tensor(classes, device=DEV, dtype=torch.int32)[pick]
    args = (idx, val, sib, wit, depth)
    before = merkle_cuda.launches["walk_branches"]
    # roots: each branch's own digest under its class, spoiled in one lane of 3
    roots = None
    for c in classes:
        ok_c, _ = merkle_ops.verify_branches(
            torch.zeros(8, dtype=torch.int32, device=DEV), *args,
            vsizes=torch.full_like(vsizes, c), vsize_classes=(c,))
        if bool(ok_c.any()):
            fail("a random branch verified against the zero root")
    ld4 = 1 << (depth.to(torch.int64) - 1)
    i64 = idx.to(torch.int64)
    ti = ((1 << (depth.to(torch.int64) + 2)) + i64 // ld4
          + 4 * (i64 % ld4)).to(torch.int32)
    for c in classes:
        h = merkle_cuda.walk_branches(val[..., :c // 4], sib[..., :c // 4],
                                      wit, ti, depth)
        sel = (vsizes == c)[..., None]
        roots = h if roots is None else torch.where(sel, h, roots)
    roots[:, 0::3, 0] ^= 1
    got, _ = merkle_ops.verify_branches(roots, *args, vsizes=vsizes,
                                        vsize_classes=classes)
    torch.cuda.synchronize()
    launched = merkle_cuda.launches["walk_branches"] - before
    want, _ = merkle_ops.verify_branches(
        roots.cpu(), *(t.cpu() for t in args), vsizes=vsizes.cpu(),
        vsize_classes=classes)
    expect = torch.ones((b, n), dtype=torch.bool)
    expect[:, 0::3] = False
    if not (torch.equal(got.cpu(), want) and torch.equal(want, expect)):
        fail("verify_branches with value classes: card and CPU verdicts "
             "differ, or are not the expected ones")
    if launched != 7:
        fail(f"verify_branches with value classes launched kernel F "
             f"{launched} times, expected 7 (3 + 3 + 1)")
    log(f"verify_branches with value sizes {classes} per branch: card "
        f"verdicts equal the CPU's and the expected ones; the classes in "
        f"one launch of kernel F")


def sass_phase():
    """The instructions a unit of each kernel's work needs, (all, ALU-only),
    read from this build's SASS (stark_verifier_tpu_torch/sass.py): the
    bounds of phase 3 take them from here and nowhere else, so a run that
    cannot read them fails."""
    try:
        rep = sass.report(str(_build.library_path()))
        work = sass.work()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"the bounds' instruction counts could not be read from the "
             f"SASS: {e} {getattr(e, 'stderr', '') or ''}")
    ops = {}
    for key, part in SASS_COMPRESS.items():
        names = [n for n in rep if part in n]
        one = rep[names[0]]["compression"] if len(names) == 1 else None
        if one is None:
            fail(f"sass: no compression found in the level loop of {part}")
        ops[key] = (one["alu"] + one["adds"], one["alu"])
        log(f"sass {key}: a compression {json.dumps(one)}; (all, ALU-only) "
            f"{ops[key]}")
    for name in rep:
        if any(k in name for k in ("fri_rows", "spot_kernel", "mul_mod",
                                   "ntt_stage", "ntt_block",
                                   "mimc_scan")):
            log(f"sass {name}: a thread's path {json.dumps(rep[name]['path'])}")
    for key in SASS_PROBES:
        if key not in work:
            fail(f"sass: probe {key} not found in csrc/probes/work.cu's SASS")
        ops[key] = (work[key]["arith"], work[key]["alu_only"])
        log(f"sass {key}: {json.dumps(work[key])}; (all, ALU-only) "
            f"{ops[key]}")
    return ops


def kernel_phase(cfg, tables, ops):
    gen = torch.Generator(device=DEV)
    gen.manual_seed(20240613)
    b = CHUNK
    dm = cfg.log_steps + 2               # witness depth of the main trees: 15
    # kernel A: the groups of the shared walk's two call sites, each site in
    # one launch (main + lincomb; the five FRI column groups), then each
    # group alone (one launch each).  The level count is the
    # one the shared walk gives a group (ops/merkle.py: depth minus the
    # dense tail, one level for the leaf).
    sp, q, nl = cfg.spot_checks, cfg.fri_queries, cfg.fri_levels
    a_main = [(2 * sp, 24, dm, dm - 3), (sp, 8, dm, dm - 3)]
    a_cols = [(q, 8, dm - 2 - 2 * l, dm - 5 - 2 * l) for l in range(nl)]
    a_cases = [check_walk(gen, ops, b, a_main, "main + lincomb, one launch",
                          20),
               check_walk(gen, ops, b, a_cols,
                          "5 FRI column groups, one launch", 20)]
    for spec in a_main + a_cols:
        n, vw, _, levels = spec
        a_cases.append(check_walk(gen, ops, b, [spec],
                                  f"B={b} n={n} vw={vw} levels={levels}", 20))
    # kernel B: the five FRI poly quad groups of the shared walk in one
    # launch (q quads of a tree of depth d walk d - 4 levels after their
    # combine), then each group alone
    b_quads = [(q, dm - 2 * l, dm - 2 * l - 4) for l in range(nl)]
    b_cases = [check_quads(gen, ops, b, b_quads,
                           "5 FRI poly quad groups, one launch", 20)]
    for spec in b_quads:
        b_cases.append(check_quads(
            gen, ops, b, [spec], f"B={b} quads={spec[0]} depth={spec[1]} "
            f"levels={spec[2]}", 20))
    # kernel C and D read the verifier's packed tables
    tabs = V._spot_tables(tables, cfg, DEV)
    c_case = check_rows(gen, ops, cfg, tables, tabs.g2, b, 20)
    # kernel D: power 3 on the static path first (the row's numbers), power
    # 2, and the K table of one constant a round (8,192 constants: 65,536
    # rows, the runtime-statement path's own table there)
    k_one = F.limbs_to_words_le(F.canon(rand_limbs(gen, (cfg.precision,))))
    d_cases = [check_spot(gen, ops, cfg, tabs, b, cfg.power, 20),
               check_spot(gen, ops, cfg, tabs, b, 2, 20),
               check_spot(gen, ops, cfg, tabs._replace(k=k_one), b,
                          cfg.power, 20)]
    # kernel E at the runtime-statement path's shapes (a boundary product of
    # one chunk and of the whole batch), at strided upper-half views of
    # butterfly blocks and a [64, 16] x [16] scaling (operand shapes of a
    # plain-torch NTT stage), and at a size whose bound reads real work
    nc = cfg.num_constants
    e_cases = [check_mul(gen, ops, (b,), (), 20),
               check_mul(gen, ops, (BATCH,), (), 20),
               check_mul(gen, ops, (), (BATCH,), 20),
               check_mul(gen, ops, (nc // 2,), (nc // 2,), 20)]
    for s in range(nc.bit_length() - 1):
        e_cases.append(check_mul(gen, ops, (nc >> (s + 1), 1 << s), (1 << s,),
                                 20, upper_half=True))
    e_cases += [check_mul(gen, ops, (nc,), (), 20),
                check_mul(gen, ops, (MUL_BIG,), (MUL_BIG,), 10)]
    # kernel F on the groups of the unshared path's two call sites, each in
    # one launch (main + lincomb; 5 column and 5 poly groups, the poly
    # groups 4 x queries independent branches there), then each group
    # alone, mixed depths and a padded level
    f_main = [(2 * sp, 24, dm), (sp, 8, dm)]
    f_fri = ([(q, 8, dm - 2 - 2 * l) for l in range(nl)]
             + [(4 * q, 8, dm - 2 * l) for l in range(nl)])
    f_cases = [check_branches(gen, ops, b, f_main,
                              "main + lincomb, one launch", 10),
               check_branches(gen, ops, b, f_fri,
                              "5 column + 5 poly groups, one launch", 10)]
    for n, vw, depth in f_main + f_fri:
        f_cases.append(check_branches(
            gen, ops, b, [(n, vw, depth)],
            f"B={b} n={n} vw={vw} depth={depth}", 10))
    f_cases.append(check_branches(
        gen, ops, b, [(2 * sp, 8, dm)], f"B={b} n={2 * sp} vw=8 depths "
        f"1..{dm} by lane", 10, mixed=True))
    f_cases.append(check_branches(
        gen, ops, b, [(2 * sp, 24, dm)], f"B={b} n={2 * sp} vw=24 depth={dm} "
        f"in {dm + 1} rows", 10, max_depth=dm + 1))
    check_value_classes(gen)
    # the one-stage NTT kernel: one middle stage of 2^20 points alone, and
    # a cross stage as the sharded NTT launches it
    stage_cases = [check_ntt_stage(gen, ops, 20, NTT_STAGE),
                   check_cross_stage(gen, ops, 20)]
    # the several-stage kernel: whole transforms through ops/ntt.ntt,
    # forward and inverse, 2^20 first (the row's numbers)
    block_cases = [check_ntt(gen, ops, logn, inverse, 20 if logn < 20 else 5)
                   for logn in NTT_LOGS for inverse in (False, True)]
    # the MiMC scan kernel: 512 steps on 1,024 inputs at both powers (the
    # plain version on the card takes some 250 launches a round) and on one
    # input
    mimc_cases = [check_mimc(gen, ops, 1024, 512, 3),
                  check_mimc(gen, ops, 1024, 512, 2),
                  check_mimc(gen, ops, 1, 512, 3)]
    # the narrow hashes at the main path's shapes: a chunk's chains (its
    # five FRI seeds and the lincomb root, one link fewer than the longer
    # index stream's entries) and its four k-hashes of 33 bytes; the dense
    # tails' inputs are recorded from a verify call in phase 5
    links = max(-(-q // 8), -(-sp // 8)) - 1
    chain_cases = [check_hash_chain(gen, ops, (b, nl + 1), links, 20)]
    kin = torch.cat([rand_words(gen, (b, 1, 8)).expand(b, 4, 8),
                     torch.arange(1, 5, dtype=torch.int32, device=DEV)
                     [None, :, None].expand(b, 4, 1)], dim=-1)
    hash_cases = [check_hash_words(ops, kin, 33,
                                   f"k-hashes {list(kin.shape)}, 33 bytes",
                                   20)]
    per_proof = sum(c["compressions"] for c in f_cases[:2]) // b
    log(f"unshared walk: {per_proof} compressions a proof over "
        f"{len(f_main + f_fri)} groups in two launches")

    def record(name, source, replaces, cases):
        main = cases[0]
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "launches_on": None,
               "max_abs_err": max(c["max_abs_err"] for c in cases),
               "ms": main["ms"], "device_ms": main["device_ms"],
               "plain_ms": main["plain_ms"],
               "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
               "library_ms": None, "match": all(c["max_abs_err"] == 0
                                                for c in cases),
               "cases": cases}
        return rec

    src = "stark_verifier_tpu_torch/csrc/"
    tpu = "stark_verifier_tpu/ops/"
    return [
        record("walk_leaf_levels", src + "merkle_walk.cu",
               tpu + "merkle_pallas.py:180", a_cases),
        record("walk_quads", src + "merkle_walk.cu",
               tpu + "merkle_pallas.py:198", b_cases),
        record("fri_rows", src + "fri_rows.cu",
               tpu + "fri_pallas.py:92", [c_case]),
        record("spot_checks", src + "spot_checks.cu",
               tpu + "spot_pallas.py:56", d_cases),
        record("mul_mod", src + "field_mul.cu",
               tpu + "field_pallas.py:206", e_cases),
        record("walk_branches", src + "merkle_walk.cu",
               tpu + "merkle_pallas.py:117", f_cases),
        # no pallas_call behind these three: the stage loop of the
        # XLA-compiled ntt and the lax.scan of the MiMC rounds
        record("ntt_stage", src + "ntt_stage.cu", tpu + "ntt.py:86",
               stage_cases),
        record("ntt_block", src + "ntt_block.cu", tpu + "ntt.py:86",
               block_cases),
        record("mimc_scan", src + "mimc_scan.cu", tpu + "mimc.py:41",
               mimc_cases),
        # nor behind these two: XLA compiled the JAX package's narrow
        # hashes and its chain loop
        record("hash_words", src + "blake2s_hash.cu", tpu + "blake2s.py:193",
               hash_cases),
        record("hash_chain", src + "blake2s_hash.cu", tpu + "prg.py:28",
               chain_cases),
    ]


# ---------------------------------------------------------------------------
# phases 4-6
# ---------------------------------------------------------------------------

def golden_proof(cfg):
    path = os.path.join(str(_build.BUILD_DIR), f"golden_proof_{cfg.log_steps}.bin")
    consts = [(i ** 7) ^ 42 for i in range(cfg.num_constants)]
    if os.path.exists(path):
        with open(path, "rb") as f:
            blob = f.read()
    else:
        blob, out = prover.prove_to_bytes(3, cfg.num_steps, consts)
        if out != oracle.mimc(3, cfg.num_steps, consts):
            fail("prover's MiMC output disagrees with the oracle's")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".tmp", "wb") as f:
            f.write(blob)
        os.replace(path + ".tmp", path)
    proof, consumed = oracle.parse_proof(blob)
    if consumed != len(blob):
        fail("oracle did not consume the whole golden proof")
    out = oracle.mimc(3, cfg.num_steps, consts)
    if not oracle.verify_mimc_proof(3, cfg.num_steps, consts, out, proof,
                                    parity_guards=cfg.log_steps == 13):
        fail("the oracle rejects the golden proof")
    return blob


def device_batch(tree_np, batch, tamper):
    """One proof -> a batch on the card, replicated there; with `tamper`,
    proofs 1..12 get one bit flipped at one protocol site each."""
    one = dev_io.to_device(tree_np, DEV)
    tree = dev_io.tree_map(
        lambda x: x.unsqueeze(0).expand((batch,) + x.shape).contiguous(), one)
    if tamper:
        for i, path in enumerate(SITES, start=1):
            node = tree
            for k in path[:-1]:
                node = node[k]
            flat = node[path[-1]][i].view(-1)
            flat[flat.numel() // 2] ^= 1
    return tree


def timed_calls(fn, tree, n):
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = fn(tree)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
        if not bool(v.all()):
            fail("a timed call rejected the golden proof")
    return out


def profile_call(label, call):
    """One call under torch.profiler: device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [(e.key, getattr(e, "device_time_total", 0.0) or 0.0, e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and "cuda" in str(e.device_type).lower()]
    total_us = sum(r[1] for r in rows)
    if total_us <= 0:
        log("profile: torch.profiler recorded no device time on this machine")
        return
    log(f"profile [{label}]: one call under the "
        f"profiler: wall {wall * 1e3:.1f} ms, device busy {total_us / 1e3:.1f} "
        f"ms ({100 * total_us / (wall * 1e6):.1f}% of wall), "
        f"{sum(r[2] for r in rows)} device kernels")
    ours = [r for r in rows if "stark_" in r[0]]
    log(f"  profile [{label}]: the port's own kernels: "
        f"{sum(r[1] for r in ours) / 1e3:.3f} ms in "
        f"{sum(r[2] for r in ours)} launches; PyTorch's: "
        f"{(total_us - sum(r[1] for r in ours)) / 1e3:.3f} ms in "
        f"{sum(r[2] for r in rows) - sum(r[2] for r in ours)} launches")
    for key, us, count in ours + sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"  profile [{label}]: {us / 1e3:9.3f} ms  {count:7d} x  "
            f"{us / 1e3 / count:8.4f} ms per launch  {key[:90]}")


def counted(call):
    """Run `call` with every kernel's launch count set to 0 just before and
    read just after: (result, counts)."""
    R.reset_counts()
    out = call()
    torch.cuda.synchronize()
    return out, R.launch_counts()


def eager_next(fn):
    """Forget the CUDA graphs of verifier module fn: its next call of each
    shape runs eagerly (a replay launches nothing from Python, and the
    wrappers a check records are not called)."""
    fn.graphs = V._CallGraphs()


def require_launches(path, counts, launched, idle=()):
    for name in launched:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the {path}")
    for name in idle:
        if counts[name] != 0:
            fail(f"kernel {name} was launched {counts[name]} times on the "
                 f"{path}, which must not reach it")


def expect_verdicts(what, got, want):
    got = got.cpu()
    if got.dtype != torch.bool or got.shape != want.shape:
        fail(f"{what}: verdicts {got.dtype} {tuple(got.shape)}")
    if not torch.equal(got, want):
        bad = (got != want).nonzero().flatten().tolist()
        fail(f"{what}: wrong verdicts at proofs {bad[:20]}")
    return got


def limbs_on_card(x):
    return dev_io.to_tensor(fp.ints_to_limbs(x) if isinstance(x, list)
                            else fp.int_to_limbs(x), DEV)


def oracle_verdict(blob, cfg, inp, consts, out, power=3):
    """The pure-Python oracle's verdict on a blob (an assert of the
    reference is a reject)."""
    try:
        proof, _ = oracle.parse_proof(blob)
        return bool(oracle.verify_mimc_proof(
            inp, cfg.num_steps, consts, out, proof,
            parity_guards=cfg.log_steps == 13, power=power))
    except (AssertionError, ValueError, IndexError):
        return False


def pad_one_level(tree_np):
    """A copy of a single-proof tree whose witness arrays all hold one more
    (zero) level than the depths say: ragged by is_rectangular, honest."""
    def pad(w):
        return np.concatenate([w, np.zeros_like(w[..., :1, :])], axis=-2)
    t = dev_io.tree_map(np.array, tree_np)
    t["main"]["witness"] = pad(t["main"]["witness"])
    t["lincomb"]["witness"] = pad(t["lincomb"]["witness"])
    for key in ("col_witness", "poly_witness"):
        t["fri"][key] = [pad(w) for w in t["fri"][key]]
    return t


def ragged_blob(blob):
    """The blob with the last witness of its last branch (the lincomb
    group's) cut off: that branch then carries one witness fewer than its
    neighbours."""
    depth = LOG_STEPS + 2
    at = len(blob) - 32 * depth - 4
    if int.from_bytes(blob[at:at + 4], "little") != 32 * depth:
        fail("ragged_blob: the last branch is not where the layout puts it")
    return (blob[:at] + (32 * (depth - 1)).to_bytes(4, "little")
            + blob[at + 4:-32])


def main_path(cfg, blob, tree_np, kernels, ops):
    """Phase 5.  Returns (verifier, batch on the card, exact verdicts)."""
    fn, _ = V.make_chunked_verifier(cfg, 3, chunk=CHUNK, device=DEV)
    tree = device_batch(tree_np, BATCH, tamper=True)
    verdicts, counts = counted(lambda: fn(tree))
    want = torch.ones(BATCH, dtype=torch.bool)
    want[1:1 + len(SITES)] = False
    verdicts = expect_verdicts("main path", verdicts, want)
    shared = ("walk_leaf_levels", "walk_quads", "fri_rows", "spot_checks")
    require_launches("main path", counts, shared, idle=("walk_branches",))
    if counts["walk_leaf_levels"] != 2 * (BATCH // CHUNK):
        fail(f"the main path launched kernel A {counts['walk_leaf_levels']} "
             f"times, expected 2 a chunk (main + lincomb; the column groups)")
    if counts["walk_quads"] != BATCH // CHUNK:
        fail(f"the main path launched kernel B {counts['walk_quads']} times, "
             f"expected 1 a chunk (the five FRI poly quad groups)")
    chunks = BATCH // CHUNK
    hashes = (counts["hash_chain"], counts["hash_words"])
    if hashes != (chunks, 7 * chunks):
        fail(f"the main path launched the chain and the narrow hashes "
             f"{hashes} times, expected {(chunks, 7 * chunks)}: a chunk's "
             f"chains, its k-hashes and the 3 + 3 tail levels")
    for k in kernels:
        if k["name"] in shared + ("hash_chain", "hash_words"):
            k["launches"], k["launches_on"] = counts[k["name"]], "main path"
    log(f"main path: batch {BATCH} in chunks of {CHUNK}: verdicts exact "
        f"(12 tampered reject, {BATCH - 12} accept); launches {counts}")
    recorded = check_hash_recorded(ops, fn, tree, kernels)
    log(f"hash_words: the {recorded} calls of one {CHUNK}-proof verify "
        f"(the k-hash and 3 + 3 tail levels) equal the plain version")

    cpu_fn, _ = V.make_verifier(cfg, 3, device="cpu")
    head = dev_io.tree_map(lambda x: x[:16].cpu(), tree)
    t0 = time.perf_counter()
    cpu_verdicts = cpu_fn(head)
    if not torch.equal(cpu_verdicts, verdicts[:16]):
        fail("CPU (plain versions) and card verdicts differ on the first 16")
    log(f"cpu cross-check: first 16 verdicts equal "
        f"({time.perf_counter() - t0:.1f} s)")

    flipped = bytearray(blob)
    flipped[110] ^= 1
    facade = {"blob": (blob, True), "trailing": (blob + b"trailing", True),
              "truncated": (blob[:1000], False),
              "flipped@110": (bytes(flipped), False)}
    for name, (data, expect) in facade.items():
        got, _ = counted(lambda: sv.verify_proof_bytes(
            data, log_steps=LOG_STEPS, device=DEV))
        if got is not expect:
            fail(f"verify_proof_bytes({name}) = {got}, expected {expect}")
        if name == "blob":
            log(f"verify_proof_bytes: one fixed-statement call launched the "
                f"narrow hashes {dict(blake2s_cuda.launches)}")
            if sum(blake2s_cuda.launches.values()) != 8:
                fail("one fixed-statement call must launch the narrow "
                     "hashes 8 times (1 chain, 1 k-hash, 3 + 3 tail levels)")
    log(f"verify_proof_bytes: {', '.join(facade)} as expected")
    return fn, tree, want


# ---------------------------------------------------------------------------
# phase 13 (run after phase 5): the FRI row cross-check forms of
# ops/quartic.py and the field's inversions on the card
# ---------------------------------------------------------------------------

INV_MOD_PRODUCTS = 270     # field.inv_mod: 255 squarings and 15 products
ROW_COLLISIONS = ((0, 1, 3, 1), (20, 0, 7, 0))   # (proof, level, query, node)


def batch_inv_products(n):
    """Products of field.batch_inv over n values: two doubling scans of
    ceil(log2 n) rounds, the inversion, two for the outputs."""
    return 2 * (n - 1).bit_length() + INV_MOD_PRODUCTS + 2


def row_form_products(q):
    """Kernel E launches of each form on [..., L, q] row groups, one a
    product: the forms' own, and batch_inv's over q totals (the nodes
    form) or 4q denominators (interp4) of a (proof, level)."""
    nodes = 15 + batch_inv_products(q)
    return {"eval4_inv_free": 9, "eval_interp4_nodes": nodes,
            "interp4_nodes_pre + batch_inv + finish": nodes,
            "interp4 + eval_quartic": 22 + batch_inv_products(4 * q)}


def weight_consts(tables, rows):
    """wconsts and winv [4, 16] on the card: w_i = prod_{j != i}(q_i - q_j)
    for the quartic roots q_i = G2^(i rows / 4), and their inverses, from
    host ints."""
    qr = [pow(tables.G2, i * rows // 4, P) for i in range(4)]
    wc = []
    for i in range(4):
        w = 1
        for j in range(4):
            if j != i:
                w = w * (qr[i] - qr[j]) % P
        wc.append(w)
    return limbs_on_card(wc), limbs_on_card([pow(w, P - 2, P) for w in wc])


def row_operands(poly_value, ys, l_root, root2, g2_words):
    """The forms' operands, gathered as fri_cuda.fri_rows_plain gathers
    kernel C's: e1 = y 4^l (32-bit wrap), node k at e1 + k rows / 4, x1^-3
    at -3 e1 and x1^3 at 3 e1, all mod rows; special_x the previous root and
    the rows the poly values, both raw.  Returns (nodes [..., L, q, 4, 16],
    x1cb, x1cb_inv [..., L, q, 16], ys [..., L, q, 4, 16], sx [..., L, 16])."""
    nl, q = ys.shape[-2:]
    rows = g2_words.shape[0]
    mask = rows - 1
    shift = 2 * torch.arange(nl, dtype=torch.int64, device=ys.device)
    e1 = ((ys & 0xFFFFFFFF) << shift[:, None]) & 0xFFFFFFFF
    g2 = F.words_le_to_limbs(g2_words)
    k = torch.arange(4, dtype=torch.int64, device=ys.device) * (rows // 4)
    nodes = g2[(e1[..., None] + k) & mask]
    x1cb, x1cb_inv = g2[(3 * e1) & mask], g2[(-3 * e1) & mask]
    prev = torch.cat([l_root[..., None, :], root2[..., :-1, :]], dim=-2)
    rows_l = F.words_be_to_limbs(
        poly_value.reshape(*poly_value.shape[:-2], q, 4, 8))
    return nodes, x1cb, x1cb_inv, rows_l, F.words_be_to_limbs(prev)


def row_forms(opnd, wc, winv):
    """{form: call} of the four cross-check formulations, each returning
    [..., L, q, 16] canonical limbs."""
    nodes, x1cb, x1cb_inv, ys, sx = opnd

    def split():
        pre = quartic.interp4_nodes_pre(nodes, x1cb, wc, ys, sx)
        return quartic.interp4_nodes_finish(pre, F.batch_inv(pre["total"]))

    return {
        "eval4_inv_free": lambda: quartic.eval4_inv_free(
            nodes, x1cb_inv, winv, ys, sx),
        "eval_interp4_nodes": lambda: quartic.eval_interp4_nodes(
            nodes, x1cb, wc, ys, sx),
        "interp4_nodes_pre + batch_inv + finish": split,
        "interp4 + eval_quartic": lambda: quartic.eval_quartic(
            quartic.interp4(nodes, ys), sx[..., None, :]),
    }


def counted_forms(what, forms, expected):
    """Each form with every launch count set to 0 just before and read just
    after: kernel E exactly `expected[form]` times (every product on the
    card, none on the CPU or on the plain multiply), no other kernel.
    Returns {form: result}."""
    out = {}
    for name, call in forms.items():
        got, counts = counted(call)
        if got.device.type != DEV.type:
            fail(f"{what}: {name} returned a tensor on {got.device}")
        others = {k: v for k, v in counts.items() if k != "mul_mod" and v}
        if counts["mul_mod"] != expected[name] or others:
            fail(f"{what}: {name} launched {counts}; expected mul_mod "
                 f"{expected[name]} times and nothing else")
        out[name] = got
    return out


def collide_rows(args, g2_words):
    """Set special_x of each ROW_COLLISIONS (proof, level) to the given
    node of the given query, whose rows become raw edge values; returns the
    node's canonical y at each."""
    poly, _, ys, lroot, root2 = args[:5]
    rows = g2_words.shape[0]
    want = []
    raw = [P, 2**256 - 1, P + 1, 2**256 - 2**32]
    for b, l, qi, k in ROW_COLLISIONS:
        e1 = (int(ys[b, l, qi]) << (2 * l)) & 0xFFFFFFFF
        node = F.words_le_to_limbs(g2_words[(e1 + k * rows // 4) & (rows - 1)])
        words = F.limbs_to_words_be(node)
        if l == 0:
            lroot[b] = words
        else:
            root2[b, l - 1] = words
        poly[b, l, 4 * qi:4 * qi + 4] = F.limbs_to_words_be(limbs_on_card(raw))
        want.append(raw[k] % P)
    return want


def check_forms_against_rows(what, forms_out, lhs_words):
    for name, got in forms_out.items():
        words = F.limbs_to_words_be(got)
        if not torch.equal(words, lhs_words):
            bad = (words != lhs_words).any(dim=-1).nonzero()[:5].tolist()
            fail(f"{what}: {name} differs from kernel C's evaluation words at "
                 f"(proof, level, query) {bad}")


def inversion_checks(gen):
    """inv_mod, batch_inv along -2 and along 0, and pow_table on a [1024,
    16] card input holding 0, 1, p - 1, p, p + 1 and 2^256 - 1: equal to
    their CPU results and to host ints, kernel E counted exactly."""
    x = rand_limbs(gen, (BATCH,))
    xc = F.canon(x)
    e = torch.randint(-2**31, 2**31, (BATCH,), generator=gen, device=DEV,
                      dtype=torch.int64).to(torch.int32)
    e[:4] = torch.tensor([0, 1, -1, -2**31], dtype=torch.int32)
    calls = {
        "inv_mod": (lambda t: F.inv_mod(t), x, INV_MOD_PRODUCTS),
        "batch_inv": (lambda t: F.batch_inv(t), xc,
                      batch_inv_products(BATCH)),
        "batch_inv axis 0": (lambda t: F.batch_inv(t, axis=0),
                             xc.view(32, -1, 16), batch_inv_products(32)),
        "pow_table": (lambda t: F.pow_table(t[:32], e.to(t.device), 32), x,
                      32),
    }
    times, ints = {}, {}
    for name, (fn, arg, n) in calls.items():
        got, counts = counted(lambda: fn(arg))
        others = {k: v for k, v in counts.items() if k != "mul_mod" and v}
        if counts["mul_mod"] != n or others:
            fail(f"{name} on the card launched {counts}; expected mul_mod {n} "
                 f"times and nothing else")
        if not torch.equal(got.cpu(), fn(arg.cpu())):
            fail(f"{name}: the card's result differs from the CPU's")
        times[name] = {"ms": time_ms(lambda: fn(arg), 3), "launches": n}
        ints[name] = [fp.limbs_to_int(r) for r in
                      got.reshape(-1, 16).cpu().numpy().astype(np.uint32)]
    xs = [fp.limbs_to_int(r) for r in x.cpu().numpy().astype(np.uint32)]
    if ints["inv_mod"] != [pow(v % P, P - 2, P) for v in xs]:
        fail("inv_mod on the card disagrees with host ints")
    pw = ints["pow_table"]
    for i in (0, 1, 2, 3, BATCH - 1):
        want = 1
        for bit in range(32):
            if (int(e[i]) & 0xFFFFFFFF) >> bit & 1:
                want = want * xs[bit] % P
        if pw[i] != want:
            fail(f"pow_table on the card disagrees with host ints at {i}")
    return times


def row_forms_phase(cfg, tables, tree):
    """Phase 13.  (a) kernel C's phase-3 inputs at B = 512 with two
    (proof, level)s whose special_x is a node; (b) the 1,024-proof batch of
    phase 5.  Every form's words equal kernel C's evaluation words at every
    row group (on the first 16 proofs of (b) also the forms on the CPU);
    kernel E carries every product and no other kernel runs.  Then the
    inversions on a [1024, 16] input."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(20261017)
    g2_words = V._packed(tables, "g2_words", DEV)
    wc, winv = weight_consts(tables, g2_words.shape[0])
    q = cfg.fri_queries
    expected = row_form_products(q)
    consts = (tables.quartic_ginv, tables.inv4)

    args, _ = fri_inputs(gen, cfg, tables, g2_words, CHUNK)
    ys_hit = collide_rows(args, g2_words)
    _, lhs = fri_cuda.fri_rows(*args, lhs=True)
    for (b, l, qi, _), y in zip(ROW_COLLISIONS, ys_hit):
        if lhs[b, l, qi].tolist() != F.limbs_to_words_be(
                limbs_on_card(y)).tolist():
            fail(f"kernel C at the node collision {(b, l, qi)} is not the "
                 f"node's canonical y")
    opnd = row_operands(args[0], args[2], args[3], args[4], g2_words)
    out = counted_forms(f"edge inputs B={CHUNK}", row_forms(opnd, wc, winv),
                        expected)
    check_forms_against_rows(f"edge inputs B={CHUNK}", out, lhs)
    log(f"row forms: edge inputs B={CHUNK}: all four forms equal kernel C's "
        f"words at {lhs.shape[0] * lhs.shape[1] * lhs.shape[2]:,} row groups, "
        f"node collisions {list(ROW_COLLISIONS)} give the node's y")

    fri = tree["fri"]
    moduli = V._table(tables, "level_moduli", DEV)[:, None]
    ys = prg.pseudorandom_indices(fri["root2"], q, moduli,
                                  cfg.extension_factor)
    kargs = (fri["poly_value"], fri["col_value"], ys, tree["l_merkle_root"],
             fri["root2"], g2_words) + consts
    ok, lhs = fri_cuda.fri_rows(*kargs, lhs=True)
    groups = ys.numel()
    opnd = row_operands(kargs[0], ys, kargs[3], kargs[4], g2_words)
    forms = row_forms(opnd, wc, winv)
    out = counted_forms(f"batch {BATCH}", forms, expected)
    check_forms_against_rows(f"batch {BATCH}", out, lhs)
    head = tuple(t[:16].cpu() for t in opnd)
    cpu_forms = row_forms(head, wc.cpu(), winv.cpu())
    for name, got in out.items():
        if not torch.equal(cpu_forms[name]().to(DEV), got[:16]):
            fail(f"batch {BATCH}: {name} on the CPU differs on the first 16")
    rec = {"groups": groups, "card": nvidia_smi_line(),
           "fri_rows_device_ms": device_ms(lambda: fri_cuda.fri_rows(*kargs)),
           "fri_rows_ok": int(ok.sum()), "forms": {}}
    for name, call in forms.items():
        rec["forms"][name] = {"ms": time_ms(call, 3),
                              "mul_mod_launches": expected[name]}
    log(f"row forms: batch {BATCH}: all four forms equal kernel C's words at "
        f"{groups:,} row groups and the CPU's on the first 16 proofs")
    rec["inversions"] = inversion_checks(gen)
    log("row forms " + json.dumps(rec))
    return rec


def unshared_path(cfg, blob, tree_np, tree, want, kernels, consts, out):
    """Phase 6.  Returns the unshared chunked verifier."""
    fn_u, _ = V.make_chunked_verifier(cfg, 3, chunk=CHUNK,
                                      shared_merkle=False, device=DEV)
    verdicts, counts = counted(lambda: fn_u(tree))
    expect_verdicts("unshared path", verdicts, want)
    require_launches("unshared path", counts,
                     ("walk_branches", "fri_rows", "spot_checks"),
                     idle=("walk_leaf_levels", "walk_quads"))
    if counts["walk_branches"] != 2 * (BATCH // CHUNK):
        fail(f"the unshared path launched kernel F {counts['walk_branches']} "
             f"times, expected 2 a chunk (the FRI groups; main + lincomb)")
    for k in kernels:
        if k["name"] == "walk_branches":
            k["launches"], k["launches_on"] = (counts["walk_branches"],
                                               "unshared path")
    log(f"unshared path: batch {BATCH} in chunks of {CHUNK}: verdicts exact "
        f"and equal to the shared path's; launches {counts}")

    # a padded batch: every proof honest, proof 5 with one depth one short
    padded = pad_one_level(tree_np)
    short = dev_io.tree_map(np.array, padded)
    short["main"]["depth"][3] -= 1
    trees = [padded] * RAGGED_BATCH
    trees[5] = short
    host_batch = dev_io.stack_proofs(trees)
    if dev_io.is_rectangular(host_batch) or not dev_io.is_rectangular(tree_np):
        fail("is_rectangular does not tell the padded batch from the proof")
    ragged = dev_io.to_device(host_batch, DEV)
    fn_r, _ = V.make_verifier(
        cfg, 3, shared_merkle=dev_io.is_rectangular(host_batch), device=DEV)
    want_r = torch.ones(RAGGED_BATCH, dtype=torch.bool)
    want_r[5] = False
    verdicts, counts = counted(lambda: fn_r(ragged))
    expect_verdicts("padded batch", verdicts, want_r)
    require_launches("padded batch", counts, ("walk_branches",),
                     idle=("walk_leaf_levels", "walk_quads"))
    # sent to the shared walk all the same, its depth guard rejects them all
    fn_s, _ = V.make_verifier(cfg, 3, device=DEV)
    expect_verdicts("padded batch on the shared walk", fn_s(ragged),
                    torch.zeros(RAGGED_BATCH, dtype=torch.bool))
    log(f"padded batch of {RAGGED_BATCH}: routed to the unshared walk by "
        "is_rectangular, the short-depth proof rejects and the others "
        "accept; on the shared walk every proof rejects")

    rb = ragged_blob(blob)
    rtree = dev_io.proof_tree(wire.parse_and_validate(rb, cfg))
    if dev_io.is_rectangular(rtree):
        fail("the ragged blob parsed as rectangular")
    expect = oracle_verdict(rb, cfg, 3, consts, out)
    got, counts = counted(lambda: sv.verify_proof_bytes(rb, log_steps=LOG_STEPS, device=DEV))
    if got is not expect or expect is not False:
        fail(f"verify_proof_bytes(ragged blob) = {got}, oracle {expect}")
    require_launches("ragged blob", counts, ("walk_branches",),
                     idle=("walk_leaf_levels", "walk_quads"))
    log("verify_proof_bytes: ragged blob rejects, as the oracle does")
    return fn_u


def replay_mul_launches(call, expected, kernels):
    """Every launch of kernel E that `call` makes, held word for word against
    the plain version on the very operands the path gave it (the iNTT's
    strided upper-half views with their twiddle tables, the boundary products
    of the whole batch).  Runs `call` once more with the wrapper recorded;
    these launches are not the ones counted for the path."""
    seen = []
    real = field_cuda.mul_mod

    def recording(a, b):
        out = real(a, b)
        seen.append((a, b, out))
        return out

    field_cuda.mul_mod = recording
    try:
        call()
        torch.cuda.synchronize()
    finally:
        field_cuda.mul_mod = real
    if len(seen) != expected:
        fail(f"the recorded call launched the multiply kernel {len(seen)} "
             f"times, the counted one {expected} times")
    shapes, worst = [], 0
    for a, b, out in seen:
        worst = max(worst, max_abs_err(out, field_cuda.mul_mod_plain(a, b)))
        shapes.append(f"{list(a.shape)}{'' if a.is_contiguous() else ' strided'}"
                      f" x {list(b.shape)}")
    log(f"runtime-statement path: its {len(seen)} multiply launches replayed "
        f"against the plain version: max_abs_err {worst}; operands "
        + "; ".join(shapes))
    for k in kernels:
        if k["name"] == "mul_mod":
            k["max_abs_err"] = max(k["max_abs_err"], worst)
    if worst != 0:
        fail("kernel mul_mod disagrees with its plain version on the "
             "runtime-statement path's own operands")


def runtime_statement_path(cfg, blob, tree, want, kernels, consts, out):
    """Phase 7.  Returns a call of the general verifier on a batch."""
    gfn, _ = V.make_general_verifier(cfg, device=DEV)
    inp_l, out_l = limbs_on_card(3), limbs_on_card(out)
    consts_l = limbs_on_card(consts)
    verdicts, counts = counted(lambda: gfn(tree, inp_l, consts_l, out_l))
    expect_verdicts("runtime-statement path", verdicts, want)
    require_launches("runtime-statement path", counts,
                     ("mul_mod", "walk_leaf_levels", "walk_quads",
                      "fri_rows", "spot_checks"))
    # the call's K table: the iNTT of the 64 constants and the forward NTT
    # of 512 points, one launch of the several-stage kernel each (not one of
    # the one-stage kernel a stage), their products the kernel's own;
    # kernel E keeps the four boundary products of a runtime input (iy1,
    # -iy1, iy0, -last iy0)
    if (counts["ntt_block"], counts["ntt_stage"], counts["mul_mod"]) != (
            2, 0, 4):
        fail(f"the runtime-statement path launched the several-stage NTT "
             f"kernel {counts['ntt_block']} times, the one-stage kernel "
             f"{counts['ntt_stage']} and kernel E {counts['mul_mod']}, "
             f"expected 2, 0 and 4")
    for k in kernels:
        if k["name"] == "mul_mod":
            k["launches"], k["launches_on"] = (counts["mul_mod"],
                                               "runtime-statement path")
    log(f"runtime-statement path: batch {BATCH}, input, constants and output "
        f"as tensors: verdicts equal the static path's; launches {counts}")
    eager_next(gfn)
    replay_mul_launches(lambda: gfn(tree, inp_l, consts_l, out_l),
                        counts["mul_mod"], kernels)
    root = cached_tables(cfg).minipoly_root
    err = max_abs_err(ntt.intt(consts_l, root),
                      ntt.ntt_plain(consts_l, root, inverse=True))
    for k in kernels:
        if k["name"] == "ntt_block":
            k["max_abs_err"] = max(k["max_abs_err"], err)
    if err:
        fail("the NTT kernel's iNTT of the path's constants disagrees with "
             "the plain version")
    log(f"runtime-statement path: the iNTT of its {cfg.num_constants} "
        f"constants against the plain version: max_abs_err {err}")
    gmod, _ = V._make_general_cached(cfg, True, str(DEV))
    k_call = V.runtime_k_words(consts_l, gmod)
    if not torch.equal(k_call, gmod.k_words):
        fail("the call's K table of the formula constants differs from the "
             "statement's")
    if not torch.equal(k_call.cpu(), V.runtime_k_words(consts_l.cpu(), gmod)):
        fail("the call's K table differs from its plain version")
    log(f"runtime-statement path: the call's K table ({gmod.k_period} rows) "
        f"equals the statement's and its plain version's")
    none = torch.zeros(BATCH, dtype=torch.bool)
    expect_verdicts("wrong output", gfn(tree, inp_l, consts_l,
                                        limbs_on_card((out + 1) % P)), none)
    changed = list(consts)
    changed[7] ^= 1
    expect_verdicts("changed constant",
                    gfn(tree, inp_l, limbs_on_card(changed), out_l), none)
    expect_verdicts("wrong input", gfn(tree, limbs_on_card(4), consts_l,
                                       out_l), none)
    log("runtime-statement path: a wrong output, a changed constant and a "
        "wrong input each reject every proof")

    flipped = bytearray(blob)
    flipped[110] ^= 1
    got = sv.verify_mimc(3, cfg.num_steps, consts, out,
                         [blob, bytes(flipped), blob[:500], blob], device=DEV)
    if got.tolist() != [True, False, False, True]:
        fail(f"verify_mimc(good, flipped, truncated, good) = {got.tolist()}")
    if sv.verify_mimc(3, cfg.num_steps, consts, out, blob, device=DEV) is not True:
        fail("verify_mimc on one blob did not accept")
    log("verify_mimc: good, flipped, truncated, good as expected")

    # the second statement family: x <- x^2 + k, a fresh full-width proof
    t0 = time.perf_counter()
    cfg2 = StarkConfig(log_steps=cfg.log_steps, power=2)
    blob2, out2 = prover.prove_to_bytes(5, cfg2.num_steps, consts, power=2)
    flipped2 = bytearray(blob2)
    flipped2[len(blob2) // 2] ^= 1
    if not oracle_verdict(blob2, cfg2, 5, consts, out2, power=2):
        fail("the oracle rejects the power-2 proof")
    fam = SquareStatement(cfg2)
    if fp.limbs_to_int(fam.compute_output(5, device=DEV).cpu().numpy()
                       .astype(np.uint32)) != out2:
        fail("SquareStatement.compute_output disagrees with the prover")
    sfn, _ = fam.make_verifier(inp=5, device=DEV)
    sgfn, _ = fam.make_general_verifier(device=DEV)
    trees = [dev_io.proof_tree(wire.parse_and_validate(b, cfg2))
             for b in (blob2, bytes(flipped2))]
    pair = dev_io.to_device(dev_io.stack_proofs(trees), DEV)
    want2 = torch.tensor([True, False])
    verdicts, counts = counted(lambda: sfn(pair))
    expect_verdicts("SquareStatement", verdicts, want2)
    require_launches("SquareStatement call", counts, ("spot_checks",))
    expect_verdicts("SquareStatement, runtime statement",
                    sgfn(pair, limbs_on_card(5), consts_l,
                         limbs_on_card(out2)), want2)
    # the cubic family must not accept a power-2 proof
    expect_verdicts("power-2 proof under the cubic verifier",
                    gfn(pair, limbs_on_card(5), consts_l, limbs_on_card(out2)),
                    torch.tensor([False, False]))
    log(f"SquareStatement: a fresh power-2 proof accepts, a flipped byte "
        f"rejects, the cubic verifier rejects both "
        f"({time.perf_counter() - t0:.1f} s)")
    return lambda t: gfn(t, inp_l, consts_l, out_l)


def graph_calls(what, fn, args, want, walk, nums, launches=None):
    """Three calls of verifier module fn on `args` from a forgotten graph
    cache: eager, capture, replay, each with the verdicts `want`, the first
    two launching `launches` (by default what a call of `walk` launches),
    the replay nothing from Python; then wall ms, eager against replay in
    turns (an untimed capture before each timed replay).  Leaves the
    shape captured."""
    launches = launches or WALK_LAUNCHES[walk]
    eager_next(fn)
    for how in ("eager", "capture", "replay"):
        before = V.graph_counts.copy()
        got, counts = counted(lambda: fn(*args))
        expect_verdicts(f"graphs: {what}, {how}", got, want)
        ran = V.graph_counts - before
        if ran != {(walk, how): 1}:
            fail(f"graphs: {what}: the {how} call ran as {dict(ran)}")
        counts = {k: counts[k] for k in launches}
        expect = launches if how != "replay" else dict.fromkeys(counts, 0)
        if counts != expect:
            fail(f"graphs: {what}: the {how} call launched {counts}, "
                 f"expected {expect}")
    turns = {"eager": [], "replay": []}
    for how in ("eager", "replay") * 4:
        if how == "eager":
            eager_next(fn)
        else:
            fn(*args)          # the capture: the eager turn saw the shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(*args)
        torch.cuda.synchronize()
        turns[how].append(1e3 * (time.perf_counter() - t0))
        expect_verdicts(f"graphs: {what}, timed", got, want)
    nums[what] = {k: statistics.median(v) for k, v in turns.items()}
    nums[what + "_ms"] = turns


def graphs_phase(cfg, blob, tree_np, tree, want, consts, out):
    """Phase 15: replayed verdicts against eager ones (see the module's
    docstring)."""
    nums = {"card": nvidia_smi_line()}
    torch.cuda.reset_peak_memory_stats()
    for shared in (True, False):
        fn, _ = V.make_verifier(cfg, 3, shared_merkle=shared, device=DEV)
        graph_calls(f"batch_{BATCH}_{'shared' if shared else 'unshared'}",
                    fn, (tree,), want, "shared" if shared else "unshared",
                    nums)

    # 64 statements, each proof with its own input and claimed output: only
    # the golden proof's statement (input 3) holds
    t0 = time.perf_counter()
    outs = [oracle.mimc(3 + s, cfg.num_steps, consts) for s in range(64)]
    nums["oracle_outputs_s"] = time.perf_counter() - t0
    gfn, _ = V.make_general_verifier(cfg, device=DEV)
    rows = [torch.arange(BATCH) % 64, (torch.arange(BATCH) + 1) % 64]
    stmt = [(limbs_on_card([3 + int(s) for s in r]),
             limbs_on_card([outs[int(s)] for s in r])) for r in rows]
    consts_l = limbs_on_card(consts)
    wants = [want & (r == 0) for r in rows]
    # kernel E: the four boundary products of a run-time input; the NTT
    # kernel: the call's K table
    graph_calls(f"general_{BATCH}_64_statements", gfn,
                (tree, stmt[0][0], consts_l, stmt[0][1]), wants[0], "shared",
                nums, dict(WALK_LAUNCHES["shared"], mul_mod=4, ntt_block=2))
    # two back-to-back replays of different batches: the first's verdicts,
    # returned before the second ran, stay as they were
    first = gfn(tree, stmt[0][0], consts_l, stmt[0][1])
    second = gfn(tree, stmt[1][0], consts_l, stmt[1][1])
    torch.cuda.synchronize()
    expect_verdicts("graphs: the second of two replays", second, wants[1])
    expect_verdicts("graphs: the first of two replays, after the second",
                    first, wants[0])
    fn, _ = V.make_verifier(cfg, 3, device=DEV)
    good = device_batch(tree_np, BATCH, tamper=False)
    first, second = fn(tree), fn(good)
    torch.cuda.synchronize()
    expect_verdicts("graphs: a replay of the tampered batch, after one of "
                    "the golden batch", first, want)
    expect_verdicts("graphs: the golden batch's replay", second,
                    torch.ones(BATCH, dtype=torch.bool))
    two_threads(fn, (good, tree), (torch.ones(BATCH, dtype=torch.bool), want))

    # single calls from bytes: the golden blob and a bit flipped at each
    # protocol site, in turns
    one_fn, _ = V.make_verifier(cfg, 3, device=DEV)
    eager_next(one_fn)
    kinds = {"golden": blob, **site_flips(cfg, blob)}
    hows, turns = [], {"eager": [], "replay": []}
    for k, data in list(kinds.items()) * 2:
        before = V.graph_counts.copy()
        got = sv.verify_proof_bytes(data, log_steps=LOG_STEPS, device=DEV)
        (walk, how), = ran = V.graph_counts - before
        if got is not (k == "golden") or ran[walk, how] != 1:
            fail(f"graphs: verify_proof_bytes({k}) = {got} ({dict(ran)})")
        hows.append(how)
    if hows[:2] != ["eager", "capture"] or set(hows[2:]) != {"replay"}:
        fail(f"graphs: single calls ran as {hows}")
    for how in ("eager", "replay") * 6:
        if how == "eager":
            eager_next(one_fn)
        elif not sv.verify_proof_bytes(blob, log_steps=LOG_STEPS,
                                       device=DEV):  # the capture
            fail("graphs: a capturing single call rejected the golden proof")
        t0 = time.perf_counter()
        if not sv.verify_proof_bytes(blob, log_steps=LOG_STEPS, device=DEV):
            fail("graphs: a timed single call rejected the golden proof")
        turns[how].append(1e3 * (time.perf_counter() - t0))
    nums["verify_proof_bytes"] = {k: statistics.median(v)
                                  for k, v in turns.items()}
    nums["verify_proof_bytes_ms"] = turns
    nums["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    nums["graph_counts"] = {f"{w}.{how}": n
                            for (w, how), n in V.graph_counts.items()}
    log("graphs " + json.dumps(nums))
    log(f"graphs: replayed verdicts equal the eager ones on the shared and "
        f"unshared batch of {BATCH}, the general verifier over 64 "
        f"statements and {len(hows)} single calls; a replay's earlier "
        f"verdicts survive the next replay; two threads replaying one "
        f"module at once each get their own verdicts")


def two_threads(fn, batches, wants, calls=20):
    """Two threads call verifier module fn (its shape already captured) at
    once, `calls` times each: thread 0 on batches[0] on the default stream,
    thread 1 on batches[1] on two streams of its own in turns.  Every call
    replays, and each returns its own batch's verdicts."""
    outs, errors = ([], []), []

    def caller(i):
        streams = ([torch.cuda.default_stream(DEV)] if i == 0 else
                   [torch.cuda.Stream(DEV), torch.cuda.Stream(DEV)])
        try:
            for c in range(calls):
                with torch.cuda.stream(streams[c % len(streams)]):
                    outs[i].append(fn(batches[i]))
        except Exception as e:          # noqa: BLE001 -- reported below
            errors.append(repr(e))

    before = V.graph_counts.copy()
    threads = [threading.Thread(target=caller, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    torch.cuda.synchronize()
    if errors or any(t.is_alive() for t in threads):
        fail(f"graphs: two threads on one module: {errors or 'hung'}")
    ran = V.graph_counts - before
    if ran != {("shared", "replay"): 2 * calls}:
        fail(f"graphs: two threads on one module ran as {dict(ran)}")
    for i, got in enumerate(outs):
        for c, verdicts in enumerate(got):
            expect_verdicts(f"graphs: thread {i}'s call {c}, two threads on "
                            f"one module", verdicts, wants[i])


def one_constant_a_round_phase():
    """Phase 14.  2^13 steps with 8,192 round constants (i^7) XOR 42, one a
    round: a fresh proof; the verifier built (the statement's tables, the
    host K table of 65,536 rows by NTT); 1,024 proofs, the honest one and a
    bit flipped at each protocol site in turn, through one call of
    make_general_verifier (4 launches of the several-stage NTT kernel: the
    2^13 iNTT and the 2^16 transform of the call's K table, equal to the
    statement's) and one of verify_mimc, every verdict the oracle's; a moved
    output rejects every proof.  Prints a `one constant a round {...}` line
    of seconds and milliseconds."""
    cfg = StarkConfig(log_steps=LOG_STEPS, num_constants=1 << LOG_STEPS)
    consts = [(i ** 7) ^ 42 for i in range(cfg.num_constants)]
    rec = {"constants": cfg.num_constants, "batch": BATCH}
    t0 = time.perf_counter()
    blob, out = prover.prove_to_bytes(3, cfg.num_steps, consts)
    rec["prove_s"] = time.perf_counter() - t0
    kinds = {"golden": blob, **site_flips(cfg, blob)}
    t0 = time.perf_counter()
    verdict = {k: oracle_verdict(b, cfg, 3, consts, out)
               for k, b in kinds.items()}
    rec["oracle_s"] = time.perf_counter() - t0
    if [k for k, v in verdict.items() if v] != ["golden"]:
        fail(f"one constant a round: the oracle's verdicts {verdict}")
    if oracle_verdict(blob, cfg, 3, consts, (out + 1) % P):
        fail("one constant a round: the oracle accepts a moved output")

    t0 = time.perf_counter()
    gfn, tables = V.make_general_verifier(cfg, device=DEV)
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0
    rec["k_rows"] = tables.k_period
    names = list(kinds)
    order = [i % len(names) for i in range(BATCH)]
    few = dev_io.to_device(dev_io.stack_proofs(
        [dev_io.proof_tree(wire.parse_and_validate(kinds[k], cfg))
         for k in names]), DEV)
    at = torch.tensor(order, device=DEV)
    batch = dev_io.tree_map(lambda x: x[at].contiguous(), few)
    want = torch.tensor([verdict[names[i]] for i in order])
    inp_l, out_l, consts_l = (limbs_on_card(3), limbs_on_card(out),
                              limbs_on_card(consts))
    t0 = time.perf_counter()
    got, counts = counted(lambda: gfn(batch, inp_l, consts_l, out_l))
    rec["first_call_ms"] = 1e3 * (time.perf_counter() - t0)
    expect_verdicts("one constant a round", got, want)
    if (counts["ntt_block"], counts["ntt_stage"]) != (4, 0):
        fail(f"one constant a round: NTT launches {counts}, expected 4 of "
             f"the several-stage kernel and none of the one-stage kernel")
    rec["ntt_block_launches"] = counts["ntt_block"]
    gmod, _ = V._make_general_cached(cfg, True, str(DEV))
    if not torch.equal(V.runtime_k_words(consts_l, gmod), gmod.k_words):
        fail("one constant a round: the call's K table differs from the "
             "statement's")
    calls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        expect_verdicts("one constant a round, timed",
                        gfn(batch, inp_l, consts_l, out_l), want)
        calls.append(1e3 * (time.perf_counter() - t0))
    rec["call_ms"] = calls
    rec["call_ms_median"] = statistics.median(calls)
    rec["k_table_device_ms"] = device_ms(
        lambda: V.runtime_k_words(consts_l, gmod))
    expect_verdicts("one constant a round, moved output",
                    gfn(batch, inp_l, consts_l, limbs_on_card((out + 1) % P)),
                    torch.zeros(BATCH, dtype=torch.bool))
    t0 = time.perf_counter()
    got = sv.verify_mimc(3, cfg.num_steps, consts, out,
                         [kinds[names[i]] for i in order], device=DEV)
    rec["verify_mimc_s"] = time.perf_counter() - t0
    if got.tolist() != want.tolist():
        fail("one constant a round: verify_mimc's verdicts differ from the "
             "oracle's")
    log("one constant a round " + json.dumps(rec))


def strict_phase(cfg, blob, tree_np):
    """Phase 8."""
    scfg = StarkConfig(log_steps=cfg.log_steps, strict=True)
    strict_fn, _ = V.make_verifier(scfg, 3, device=DEV)
    parity_fn, _ = V.make_verifier(cfg, 3, device=DEV)
    changed = dev_io.tree_map(np.array, tree_np)
    changed["points"][5, 0] ^= 1
    pair = dev_io.to_device(dev_io.stack_proofs([tree_np, changed]), DEV)
    expect_verdicts("strict", strict_fn(pair), torch.tensor([True, False]))
    expect_verdicts("parity", parity_fn(pair), torch.tensor([True, True]))
    for name, data, expect in (("blob", blob, True),
                               ("trailing", blob + b"trailing", False)):
        got = sv.verify_proof_bytes(data, log_steps=LOG_STEPS, strict=True,
                                    device=DEV)
        if got is not expect:
            fail(f"verify_proof_bytes({name}, strict) = {got}, "
                 f"expected {expect}")
    log("strict: the golden proof accepts; a changed POINTS word rejects "
        "under strict and accepts under parity; trailing bytes reject")


# ---------------------------------------------------------------------------
# phase 9: from proof bytes to verdicts
# ---------------------------------------------------------------------------

STREAM_BLOBS = 4096    # distinct blobs through verify_stream, chunks of CHUNK
# per verify call of a chunk, by the walk its tree selects (main path and
# unshared path above: A twice, B once, C once, D once, E twice a chunk)
WALK_LAUNCHES = {
    "shared": {"walk_leaf_levels": 2, "walk_quads": 1, "walk_branches": 0,
               "fri_rows": 1, "spot_checks": 1, "mul_mod": 2,
               "hash_words": 7, "hash_chain": 1},
    "unshared": {"walk_leaf_levels": 0, "walk_quads": 0, "walk_branches": 2,
                 "fri_rows": 1, "spot_checks": 1, "mul_mod": 2,
                 "hash_words": 1, "hash_chain": 1},
}


def moved_bytes(tree):
    """Bytes of every tensor of a tree."""
    total = [0]
    dev_io.tree_map(lambda h: total.__setitem__(0, total[0] + nbytes(h)), tree)
    return total[0]


def flip_bit(blob, word):
    b = bytearray(blob)
    b[4 * word + 1] ^= 1
    return bytes(b)


def site_flips(cfg, blob):
    """{"flip@<site>": blob with one bit flipped in a word in the middle of
    a record of that protocol site} for every site of SITES."""
    lay = SL.canonical_layout(cfg)
    _tag, root2, c0, p0 = lay.levels[0]
    p2 = lay.levels[2][3]

    def rec(g, i):
        return g["start"] + i * g["rec"]

    def wit(g, i):
        return rec(g, i) + 2 + 2 * g["vw"] + 8 * (g["d"] // 2) + 3

    sites = {
        "merkle_root": 3, "l_merkle_root": 11, "root2": root2 + 3,
        "col_value": rec(c0, 0) + 4, "col_sibling": rec(c0, 0) + 1 + 8 + 3,
        "poly_value": rec(p0, 5) + 4, "col_witness": wit(c0, 1),
        "poly_witness": wit(p2, 3), "main_value": rec(lay.main, 7) + 13,
        "main_witness": wit(lay.main, 7), "lincomb_value": rec(lay.lincomb, 4) + 4,
        "lincomb_sibling": rec(lay.lincomb, 4) + 1 + 8 + 3,
    }
    return {f"flip@{k}": flip_bit(blob, w) for k, w in sites.items()}


def stream_kinds(cfg, blob, consts, out):
    """The kinds of blob the stream mixes, each with the oracle's verdict
    and what the port's host parse makes of it: {name: (blob, verdict,
    parses, ragged, device-parse reroutes it)}."""
    lay = SL.canonical_layout(cfg)
    blobs = {"golden": blob}
    blobs.update(site_flips(cfg, blob))
    blobs["truncated"] = blob[:len(blob) // 3]
    blobs["trailing"] = blob + b"trailing bytes"
    blobs["ragged"] = ragged_blob(blob)
    blobs["log_steps_9"] = prover.prove_to_bytes(3, 512, consts)[0]
    blobs["empty"] = b""
    kinds = {}
    for name, b in blobs.items():
        try:
            t = dev_io.proof_tree(wire.parse_and_validate(b, cfg))
            parses, ragged = True, not dev_io.is_rectangular(t)
        except wire.WireFormatError:
            parses, ragged = False, False
        packed, lens = lay.pack([b])
        _, shape_ok = lay.parse(packed)
        reroute = (not bool(shape_ok[0])) or int(lens[0]) < lay.nbytes
        kinds[name] = (b, oracle_verdict(b, cfg, 3, consts, out), parses,
                       ragged, reroute)
    return kinds


def expected_chunk_launches(kinds, names, device_parse):
    """The launches each chunk of the stream must make: its own verify call
    by the walk its tree selects (host parse), or the blob verifier's shared
    call plus the host verify of its rerouted rows (device parse)."""
    def call(rows):
        ok = [k for k in rows if kinds[k][2]]
        if not ok:
            return {}
        return WALK_LAUNCHES["unshared" if any(kinds[k][3] for k in ok)
                             else "shared"]

    out = []
    for c in range(0, len(names), CHUNK):
        rows = names[c:c + CHUNK]
        if device_parse:
            dispatch = WALK_LAUNCHES["shared"]
            reroute = call([k for k in rows if kinds[k][4]])
        else:
            dispatch, reroute = call(rows), {}
        out.append((dispatch, reroute))
    return out


def add_counts(*parts):
    total = {}
    for p in parts:
        for k, v in p.items():
            total[k] = total.get(k, 0) + v
    return total


def run_stream(cfg, blobs, device_parse):
    """verify_stream over `blobs` with every launch count set to 0 just
    before: (verdicts, seconds, (counts, verify calls so far) read at the
    first verdict of each chunk, counts at the end, the verify calls)."""
    R.reset_counts()
    start = V.graph_counts.copy()
    verdicts, snaps = [], []
    t0 = time.perf_counter()
    for i, v in M.verify_stream(blobs, chunk=CHUNK, cfg=cfg,
                                device_parse=device_parse, device=DEV):
        if i != len(verdicts):
            fail(f"verify_stream yielded index {i} out of order")
        if i % CHUNK == 0:
            snaps.append((R.launch_counts(), V.graph_counts - start))
        verdicts.append(v)
    seconds = time.perf_counter() - t0
    return (verdicts, seconds, snaps, R.launch_counts(),
            V.graph_counts - start)


def walk_of(launches):
    return "unshared" if launches.get("walk_branches") else "shared"


def check_stream_launches(mode, kinds, names, device_parse, snaps, final,
                          calls):
    """The pipeline dispatches chunk j + 1 and then fetches chunk j (its
    reroute runs then) before chunk j's first verdict: so between the
    counts read there and the counts read before, the verify calls were
    chunk j + 1's dispatch and chunk j's reroute (and, before the first,
    chunk 0's dispatch), each on the walk its tree selects, and the
    launches grew by those of the calls that ran eagerly or were captured
    (a replay launches nothing from Python).  Returns the expected calls a
    chunk and how many of the calls replayed."""
    exp = expected_chunk_launches(kinds, names, device_parse)
    prev, at = {k: 0 for k in WALK_LAUNCHES["shared"]}, collections.Counter()
    for j, (snap, upto) in enumerate(snaps):
        parts = [exp[j][1]] + ([exp[j + 1][0]] if j + 1 < len(exp) else [])
        if j == 0:
            parts.append(exp[0][0])
        made, at = list((upto - at).elements()), upto
        if sorted(w for w, _ in made) != sorted(walk_of(p) for p in parts
                                                if p):
            fail(f"stream ({mode}): verify calls before chunk {j}'s "
                 f"verdicts {made}, expected the walks of {parts}")
        want = add_counts({k: 0 for k in prev}, *(
            WALK_LAUNCHES[w] for w, how in made if how != "replay"))
        got = {k: snap[k] - prev[k] for k in prev}
        if got != want:
            fail(f"stream ({mode}): launches before chunk {j}'s verdicts "
                 f"{got}, expected {want} (calls {made})")
        prev = snap
    if final != snaps[-1][0] or calls != snaps[-1][1]:
        fail(f"stream ({mode}): launches after the last chunk began")
    return exp, sum(n for (_, how), n in calls.items() if how == "replay")


def h2d_gbps(host, reps=5):
    """GB/s of one asynchronous copy of the host tree (pinned) to the card
    on a side stream, by CUDA events."""
    dev = dev_io.tree_map(lambda h: torch.empty(h.shape, dtype=h.dtype,
                                                device=DEV), host)
    moved = moved_bytes(host)
    stream = torch.cuda.Stream()
    rates = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record(stream)
            dev_io.tree_map(lambda d, h: d.copy_(h, non_blocking=True), dev,
                            host)
            end.record(stream)
        end.synchronize()
        rates.append(moved / (start.elapsed_time(end) * 1e-3) / 1e9)
    return statistics.median(rates), moved


def run_json(args, what, expect_rc=0, timeout=400):
    """Run `python -m <args>` from the checkout; return its last stdout line
    parsed as JSON (None when it prints none) after checking the exit."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    if res.returncode != expect_rc:
        fail(f"{what}: exit {res.returncode}, expected {expect_rc}\n"
             f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    lines = res.stdout.strip().splitlines()
    rec = None
    if lines and lines[-1].startswith("{"):
        rec = json.loads(lines[-1])
    log(f"{what}: exit {res.returncode} ({secs:.1f} s)"
        + (f" {json.dumps(rec)}" if rec else ""))
    return rec, res


def stream_phase(cfg, blob, tree_np, consts, out):
    """Phase 9: the stream of distinct blobs in both parse modes, the CLI
    as a user runs it, and the host's numbers no benchmark cell reads.
    Returns the stream's kinds and its names, for phase 10."""
    nums = {"card": nvidia_smi_line()}
    nums["parser_build_s"] = native.build_seconds()
    t0 = time.perf_counter()
    kinds = stream_kinds(cfg, blob, consts, out)
    log(f"stream kinds: {len(kinds)}, oracle verdicts "
        f"{ {k: v[1] for k, v in kinds.items()} } "
        f"({time.perf_counter() - t0:.1f} s)")

    # 4,096 distinct blobs: seeded picks, half golden; the ragged blob only
    # in chunks 2 and 5, so that the other chunks take the shared walk
    rng = random.Random(2026)
    plain = [k for k in kinds if k != "ragged"]
    weights = [len(plain) - 1 if k == "golden" else 1 for k in plain]
    names = rng.choices(plain, weights=weights, k=STREAM_BLOBS)
    for at in (2 * CHUNK + 17, 2 * CHUNK + 300, 5 * CHUNK + 99):
        names[at] = "ragged"
    blobs = [bytes(bytearray(kinds[k][0])) for k in names]
    want = [kinds[k][1] for k in names]
    results = {}
    for mode, dp in (("host parse", False), ("device parse", True)):
        verdicts, secs, snaps, final, calls = run_stream(cfg, blobs, dp)
        if verdicts != want:
            bad = [i for i, (g, w) in enumerate(zip(verdicts, want)) if g != w]
            fail(f"stream ({mode}): wrong verdicts at {bad[:20]} "
                 f"(kinds {[names[i] for i in bad[:5]]})")
        exp, replays = check_stream_launches(mode, kinds, names, dp, snaps,
                                             final, calls)
        walks = [("unshared" if e[0].get("walk_branches") else "shared")
                 if e[0] else "none" for e in exp]
        results[mode] = verdicts
        log(f"stream ({mode}): {STREAM_BLOBS} distinct blobs of "
            f"{len(kinds)} kinds in chunks of {CHUNK}: verdicts equal the "
            f"oracle's ({sum(want)} accept); chunks' walks {walks}, "
            f"reroutes {[bool(e[1]) for e in exp]}; launches {final}, "
            f"{replays} of {calls.total()} verify calls replayed; "
            f"{STREAM_BLOBS / secs:.1f} blobs/s")
        nums[f"mixed_stream_{'device' if dp else 'host'}_parse_blobs_per_s"] = \
            STREAM_BLOBS / secs
    if results["host parse"] != results["device parse"]:
        fail("the two parse modes disagree")
    del blobs

    # the host's share the benchmark does not read: packing, copies from
    # pinned memory
    gold = [bytes(bytearray(blob)) for _ in range(CHUNK)]
    _t, ok, lay = ingest.ingest_chunk(gold, cfg, None, pin=True)
    if not ok.all():
        fail("ingest rejected a copy of the golden proof")
    slay = SL.canonical_layout(cfg)
    pack = torch.zeros((CHUNK, slay.words), dtype=torch.int32,
                       pin_memory=True)
    ts = []
    for _ in range(4):
        t0 = time.perf_counter()
        slay.pack(gold, out=pack)
        ts.append(time.perf_counter() - t0)
    nums["pack_ms_per_proof"] = statistics.median(ts[1:]) * 1e3 / CHUNK
    gbps, moved = h2d_gbps(lay.tensors)
    nums["h2d_pinned_GBps_host_parse_chunk"] = gbps
    nums["h2d_bytes_host_parse_chunk"] = moved
    gbps, moved = h2d_gbps(pack)
    nums["h2d_pinned_GBps_device_parse_chunk"] = gbps
    nums["h2d_bytes_device_parse_chunk"] = moved
    pageable = dev_io.tree_map(lambda h: h.clone(), lay.tensors)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_io.tree_map(lambda h: h.to(DEV), pageable)
    torch.cuda.synchronize()
    nums["h2d_pageable_GBps_host_parse_chunk"] = (
        moved_bytes(lay.tensors) / (time.perf_counter() - t0) / 1e9)
    del pageable

    # the CLI, as a user runs it
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        files = {"golden": blob, "flipped": flip_bit(blob, 3),
                 "truncated": blob[:1000]}
        for name, data in files.items():
            with open(os.path.join(tmp, f"{name}.bin"), "wb") as f:
                f.write(data)
        path = {k: os.path.join(tmp, f"{k}.bin") for k in files}
        cli = "stark_verifier_tpu_torch.cli"
        for name, rc in (("golden", 0), ("flipped", 1), ("truncated", 2)):
            run_json([cli, "verify", path[name]], f"cli verify {name}", rc)
        rec, _ = run_json([cli, "bench", path["golden"], "--batch", "1024",
                           "--iters", "5"], "cli bench --batch 1024")
        nums["cli_bench_1024_proofs_per_s"] = rec["proofs_per_s"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for key, value in nums.items():
        log(f"bytes-to-verdicts {key}: {json.dumps(value)}")
    return kinds, names


# ---------------------------------------------------------------------------
# phase 10: one rank per process (parallel/mesh.launch, parallel/rank_checks)
# ---------------------------------------------------------------------------

SHARED_KERNELS = ("walk_leaf_levels", "walk_quads", "fri_rows", "spot_checks",
                  "mul_mod")                       # A, B, C, D, E
POINT_KERNELS = ("walk_branches", "fri_rows", "spot_checks", "mul_mod")
POINT_KINDS = ("golden", "flip@col_value", "flip@main_witness",
               "flip@main_value")    # a FRI column, a main branch, a row of a
#                                      spot check (its main value)
RANK_TIMEOUT_S = 600
# the sharded NTT in each world: (points, inverse)
NTT_SHARDED = [(1 << 16, False), (1 << 16, True), (1 << 20, False),
               (1 << 20, True)]


def run_world(what, n, steps, **kw):
    """launch(n, run_steps, steps): (each rank's step records, seconds from
    the launch until every rank had joined its process group)."""
    t0 = time.time()
    ranks = M.launch(n, R.run_steps, steps, timeout_s=RANK_TIMEOUT_S, **kw)
    startup = max(r["joined"] for r in ranks) - t0
    log(f"ranks [{what}]: {n} ranks joined {startup:.2f} s after the launch; "
        f"steps {[round(s['seconds'], 2) for s in ranks[0]['steps']]} s "
        f"on rank 0")
    return [r["steps"] for r in ranks], startup


def rank_results(what, ranks, i, want, kernels, idle=(), walk="shared"):
    """Step i of every rank: its result must equal `want`, and where a
    verify call of the step on `walk` ran eagerly or was captured, the rank
    must have launched each kernel of `kernels` and none of `idle`; where
    only calls on the other walk did, each kernel that walk launches; where
    every call replayed a graph, none of them (a replay launches nothing
    from Python)."""
    for rank, steps in enumerate(ranks):
        got = steps[i]["result"]
        if got != want:
            fail(f"ranks [{what}]: rank {rank} got {str(got)[:300]}, "
                 f"expected {str(want)[:300]}")
        calls = steps[i]["calls"]
        live = {w for w, how in calls if how != "replay"}
        if not calls:
            fail(f"ranks [{what}]: rank {rank} made no verify call")
        if walk in live:
            require_launches(f"{what} (rank {rank})", steps[i]["launches"],
                             kernels, idle)
        elif live:
            require_launches(f"{what} (rank {rank})", steps[i]["launches"],
                             {k for w in live
                              for k, n in WALK_LAUNCHES[w].items() if n})
        else:
            require_launches(f"{what} (rank {rank})", steps[i]["launches"],
                             (), tuple(kernels) + tuple(idle))
    log(f"ranks [{what}]: every rank exact; launches by rank "
        f"{[steps[i]['launches'] for steps in ranks]}; verify calls by "
        f"rank {[dict(steps[i]['calls']) for steps in ranks]}")


def sharded_ntt_results(what, ranks, i, nums, kernels):
    """Step i of every rank (rank_checks.sharded_ntt): each rank's slice and
    the gathered result equal the one-process ntt, and the rank launched
    the several-stage kernel (its local stages) and, in a world of several
    ranks, the one-stage kernel (the cross stages), whose launches on rank
    0 the kernel's record takes."""
    for rank, steps in enumerate(ranks):
        for rec in steps[i]["result"]:
            if not (rec["slice_equal"] and rec["gathered_equal"]):
                fail(f"ranks [{what}]: rank {rank}: the sharded NTT of "
                     f"{rec['n']} points (inverse {rec['inverse']}) differs "
                     f"from the one-process ntt")
        require_launches(f"{what} (rank {rank})", steps[i]["launches"],
                         ("ntt_block",) + (("ntt_stage",) if len(ranks) > 1
                                           else ()))
    if len(ranks) > 1:
        for k in kernels:
            if k["name"] == "ntt_stage":
                k["launches"] = ranks[0][i]["launches"]["ntt_stage"]
                k["launches_on"] = (f"parallel/ntt.make_sharded_ntt, {what}, "
                                    "rank 0, cross stages")
    secs = {f"{r['n']}{'_inverse' if r['inverse'] else ''}":
            [steps[i]["result"][j]["seconds"] for steps in ranks]
            for j, r in enumerate(ranks[0][i]["result"])}
    nums[f"sharded_ntt_seconds_{what}"] = secs
    log(f"ranks [{what}]: sharded NTT at 2^16 and 2^20, forward and "
        f"inverse: every rank's slice and the gathered result equal the "
        f"one-process ntt; seconds a call by rank {json.dumps(secs)}; "
        f"launches by rank {[steps[i]['launches'] for steps in ranks]}")


def rank_phase(cfg, blob, want, kinds, names, kernels):
    """Phase 10.  (a) device_count ranks over NCCL: the sharded verifier on
    the 1,024-proof batch of phase 5.  (b) two ranks on one card over gloo:
    the sharded verifier, the sharded blob verifier, the stream of phase 9
    in both parse modes and point parallelism, each exact, each rank's
    kernels launched; then (c) the numbers: resident proofs/s at one rank
    and at two, one proof's latency by point parallelism at one and two
    ranks beside the one-process path's, the process group's start-up, and
    `cli bench --devices`, all logged."""
    n_cards = torch.cuda.device_count()
    nums = {"card": nvidia_smi_line(), "cards": n_cards}
    sites = [(i, path) for i, path in enumerate(SITES, start=1)]
    batch = {"cfg": cfg, "kinds": {"golden": blob}, "names": ["golden"] * BATCH,
             "flips": sites, "shared": True}
    want_batch = {"verdicts": want.tolist(), "all_ok": False}

    ranks, nums["nccl_startup_s"] = run_world(
        f"nccl x {n_cards}", n_cards,
        [(R.sharded_batch, dict(batch, per_host=True)),
         (R.sharded_ntt, dict(cases=NTT_SHARDED))], devices="cuda")
    rank_results(f"nccl x {n_cards}: sharded verifier, batch {BATCH}", ranks,
                 0, want_batch, SHARED_KERNELS)
    sharded_ntt_results(f"nccl_x_{n_cards}", ranks, 1, nums, kernels)

    blobs = {k: v[0] for k, v in kinds.items()}
    oracle_verdicts = [kinds[k][1] for k in names]
    head = names[:BATCH]
    fn, lay = SL.make_blob_verifier(cfg, device=DEV)
    packed, _ = lay.pack([blobs[k] for k in head])
    v, so = fn(packed.to(DEV))
    want_blob = {"verdict": v.cpu().tolist(), "shape_ok": so.cpu().tolist()}
    k = {"cfg": cfg, "kinds": blobs}
    steps = [
        (R.sharded_batch, dict(batch)),
        (R.blob_batch, dict(k, names=head)),
        (R.stream, dict(k, names=names, chunk=CHUNK, device_parse=False)),
        (R.stream, dict(k, names=names, chunk=CHUNK, device_parse=True)),
        (R.point, dict(k, names=list(POINT_KINDS))),
        (R.time_resident, dict(k, kind="golden", batch=BATCH, turns=3)),
        (R.time_point, dict(k, kind="golden", reps=5)),
        (R.sharded_ntt, dict(cases=NTT_SHARDED)),
    ]
    ranks, nums["gloo_startup_s"] = run_world(
        "gloo x 2 on one card", 2, steps, devices="cuda", backend="gloo")
    rank_results(f"gloo x 2: sharded verifier, batch {BATCH}", ranks, 0,
                 want_batch, SHARED_KERNELS)
    rank_results(f"gloo x 2: sharded blob verifier, {BATCH} blobs", ranks, 1,
                 want_blob, SHARED_KERNELS)
    for i, mode in ((2, "host parse"), (3, "device parse")):
        rank_results(f"gloo x 2: stream ({mode}), {len(names)} blobs", ranks,
                     i, oracle_verdicts, SHARED_KERNELS)
    point_want = [kinds[k][1] for k in POINT_KINDS]
    if point_want != [True, False, False, False]:
        fail(f"the oracle's verdicts on the point kinds: {point_want}")
    rank_results("gloo x 2: point parallelism", ranks, 4, point_want,
                 POINT_KERNELS, idle=("walk_leaf_levels", "walk_quads"),
                 walk="unshared")
    sharded_ntt_results("gloo_x_2", ranks, 7, nums, kernels)

    # (c) the numbers, each rank's seconds between barriers
    res = [steps[5]["result"] for steps in ranks]
    alone = res[0]["alone"]
    every = [max(r["all"][t] for r in res) for t in range(len(res[0]["all"]))]
    nums["resident_1024_one_rank_s"] = alone
    nums["resident_1024_two_ranks_slowest_s"] = every
    nums["resident_1024_one_rank_proofs_per_s"] = BATCH / statistics.median(
        alone)
    nums["resident_1024_two_ranks_proofs_per_s"] = BATCH / statistics.median(
        every)
    lat = [steps[6]["result"] for steps in ranks]
    for key in ("single_process", "point_alone"):
        nums[f"latency_{key}_s"] = lat[0][key]
        nums[f"latency_{key}_samples_s"] = lat[0][key + "_s"]
    nums["latency_point_two_ranks_s"] = statistics.median(
        [max(r["point_all_s"][t] for r in lat)
         for t in range(len(lat[0]["point_all_s"]))])

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        path = os.path.join(tmp, "golden.bin")
        with open(path, "wb") as f:
            f.write(blob)
        ref = nums["resident_1024_one_rank_proofs_per_s"]
        _rec, res = run_json(
            ["stark_verifier_tpu_torch.cli", "bench", path, "--batch",
             str(BATCH), "--iters", "5", "--devices", str(n_cards),
             "--ref-single-chip", repr(ref)],
            f"cli bench --devices {n_cards} --ref-single-chip {ref:.1f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lines = [json.loads(x) for x in res.stdout.splitlines()
             if x.startswith("{")]
    if len(lines) != 2 or lines[0].get("n_devices") != n_cards:
        fail(f"cli bench --devices {n_cards}: printed {lines}")
    eff = lines[1].get("scaling_efficiency")
    if not isinstance(eff, (int, float)) or not 0 < eff < float("inf"):
        fail(f"cli bench --devices {n_cards}: scaling line {lines[1]}")
    nums["cli_bench_devices"] = lines
    for key, value in nums.items():
        log(f"ranks {key}: {json.dumps(value)}")


# ---------------------------------------------------------------------------
# phase 12: the standalone NTT, the MiMC scan and debug mode
# ---------------------------------------------------------------------------

def horner(vals, x):
    acc = 0
    for c in reversed(vals):
        acc = (acc * x + c) % P
    return acc


def per_stage_vs_passes(ops):
    """One stage-kernel launch a stage against ops/ntt.ntt (one launch a
    pass) at 2^20, 2^16 and 2^13, forward: equal, then device ms
    (a CUDA graph of the calls) and wrapper ms in turns (per stage, passes,
    passes, per stage), each beside the transform's bound."""
    out = {"card": nvidia_smi_line()}
    for logn in (20, 16, 13):
        n = 1 << logn
        gen = torch.Generator(device=DEV)
        gen.manual_seed(logn)
        x = rand_limbs(gen, (n,))
        root = ntt_root(n)
        if not torch.equal(per_stage_ntt(x, root), ntt.ntt(x, root)):
            fail(f"ntt at 2^{logn}: the per-stage transform and the "
                 f"several-stage one differ")
        reps = 20 if logn < 20 else 5
        calls = {"per_stage": lambda: per_stage_ntt(x, root),
                 "passes": lambda: ntt.ntt(x, root)}
        rec = {k: {"device_ms": [], "ms": []} for k in calls}
        for key in ("per_stage", "passes", "passes", "per_stage"):
            rec[key]["device_ms"].append(device_ms(calls[key], reps))
            rec[key]["ms"].append(time_ms(calls[key], reps))
        bms = bound(*ntt_function_bound(ops, n, False))[0]
        for key in calls:
            rec[key]["device_over_bound"] = min(rec[key]["device_ms"]) / bms
        rec["bound_ms"] = bms
        rec["launches"] = {"per_stage": logn,
                           "passes": len(ntt.passes(logn, n))}
        out[f"2^{logn}"] = rec
    log(f"ntt per stage vs passes (forward, in turns): {json.dumps(out)}")


def sm_clock_during(call):
    """The SM clock (MHz, nvidia-smi) read while `call`'s launches run."""
    call()
    got = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    torch.cuda.synchronize()
    return [float(v) for v in got.strip().splitlines()[0].split(",")]


def scan_times(families):
    """ms of a scan of MIMC_STEPS steps at MIMC_INPUTS inputs with each
    family of constants ({name: [k, 16] limbs on the card}: staged in
    shared memory, or read from their rows), in turns; cycles a round at
    the SM clock read during a long one-input scan."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(8192)
    many = rand_limbs(gen, (max(MIMC_INPUTS),))
    first = next(iter(families.values()))
    clock, clock_max = sm_clock_during(
        lambda: mimc.mimc(many[:1], 400 * MIMC_STEPS, first))
    out = {"card": nvidia_smi_line(), "sm_clock_mhz": clock,
           "sm_clock_max_mhz": clock_max, "steps": MIMC_STEPS}
    rounds = MIMC_STEPS - 1
    for n in MIMC_INPUTS:
        x = many[:n]
        calls = {key: (lambda c=c: mimc.mimc(x, MIMC_STEPS, c))
                 for key, c in families.items()}
        rec = {key: [] for key in calls}
        for key in list(calls) + list(reversed(calls)):
            rec[key].append(time_ms(calls[key], 3 if n > 16384 else 5))
        out[f"{n}_inputs"] = {
            key: {"ms": v, "cycles_a_round": min(v) * 1e-3 * clock * 1e6
                  / rounds} for key, v in rec.items()}
    log(f"mimc scan times: {json.dumps(out)}")


def ntt_mimc_debug_phase(cfg, tree, want, kernels, ops):
    """Phase 12.  The standalone NTT through ops/ntt.ntt (counted: two
    launches of the several-stage kernel at 2^20, no other), against the
    oracle's FFT at 2^13, a round trip and one output point against a Horner
    evaluation on the host at 2^20, one stage-kernel launch a stage against
    it (equal, timed in turns); the MiMC scan through the family's
    compute_output (counted), against the oracle on 16 inputs with 64 and
    with 8,192 constants and the known output of input 3, and its times; a
    STARK_DEBUG=1 pass of the first 16 proofs of phase 5, and a violation
    that raises."""
    n = 1 << 20
    rng = np.random.RandomState(20)
    host = rng.randint(0, 1 << 16, (n, 16)).astype(np.int32)
    host[:, -1] %= 0xFFFF                             # canonical values
    x = torch.from_numpy(host).to(DEV)
    y, counts = counted(lambda: ntt.ntt(x, ntt_root(n)))
    if (counts["ntt_block"], counts["ntt_stage"], counts["mul_mod"]) != (
            2, 0, 0):
        fail(f"ntt at 2^20 launched the several-stage kernel "
             f"{counts['ntt_block']} times, the one-stage kernel "
             f"{counts['ntt_stage']} and kernel E {counts['mul_mod']}, "
             f"expected 2, 0 and 0")
    for k in kernels:
        if k["name"] == "ntt_block":
            k["launches"], k["launches_on"] = (counts["ntt_block"],
                                               "ops/ntt.ntt, 2^20 points")
    back = ntt.intt(y, ntt_root(n))
    if not torch.equal(back, x):
        fail("intt(ntt(x)) at 2^20 is not x")
    vals = [fp.limbs_to_int(r) for r in host.astype(np.uint32)]
    at = 777777
    if fp.limbs_to_int(y[at].cpu().numpy().astype(np.uint32)) != horner(
            vals, pow(ntt_root(n), at, P)):
        fail(f"ntt at 2^20: point {at} differs from its Horner evaluation")
    m = 1 << 13
    small = [v % P for v in vals[:m]]
    got = ntt.ntt(limbs_on_card(small), ntt_root(m)).cpu().numpy()
    if [fp.limbs_to_int(r) for r in got.astype(np.uint32)] != \
            oracle.fft_fwd(small, ntt_root(m)):
        fail("ntt at 2^13 differs from the oracle's FFT")
    log(f"ntt: 2^20 forward in {counts['ntt_block']} launches of the "
        f"several-stage kernel (no other), the round trip exact, point {at} "
        f"equal to its Horner evaluation; 2^13 equal to the oracle's FFT")
    per_stage_vs_passes(ops)

    c = limbs_on_card([(i ** 7) ^ 42 for i in range(cfg.num_constants)])
    out, counts = counted(lambda: MimcStatement(cfg).compute_output(
        3, device=DEV))
    if counts["mimc_scan"] != 1:
        fail(f"compute_output launched the scan kernel {counts['mimc_scan']} "
             f"times, expected once")
    for k in kernels:
        if k["name"] == "mimc_scan":
            k["launches"], k["launches_on"] = (counts["mimc_scan"],
                                               "MimcStatement.compute_output")
    if fp.limbs_to_int(out.cpu().numpy().astype(np.uint32)) != MIMC_OUT_3:
        fail("compute_output(3) is not the known MiMC output of input 3")
    inputs = [3, 0, 1, P - 1, P, 2**256 - 1] + [7 ** k for k in range(10)]
    got = mimc.mimc(limbs_on_card(inputs), MIMC_STEPS, c).cpu().numpy()
    consts = [(i ** 7) ^ 42 for i in range(cfg.num_constants)]
    if [fp.limbs_to_int(r) for r in got.astype(np.uint32)] != [
            oracle.mimc(v, MIMC_STEPS, consts) for v in inputs]:
        fail("the MiMC scan at 8,192 steps differs from the oracle")
    # more constants than shared memory holds (7,168): read from their rows
    many = [(i ** 7) ^ 42 for i in range(MIMC_STEPS)]
    c_many = limbs_on_card(many)
    got = mimc.mimc(limbs_on_card(inputs), MIMC_STEPS, c_many).cpu().numpy()
    if [fp.limbs_to_int(r) for r in got.astype(np.uint32)] != [
            oracle.mimc(v, MIMC_STEPS, many) for v in inputs]:
        fail(f"the MiMC scan with {MIMC_STEPS} constants differs from the "
             f"oracle")
    wide = c_many.clone()
    wide[8000, 0] = 0x10000
    x3 = limbs_on_card([3])
    if fp.limbs_to_int(mimc.mimc(x3, 8001, wide).cpu().numpy().astype(
            np.uint32)[0]) != oracle.mimc(3, 8001, many) or not bool(
            (mimc.mimc(x3, 8002, wide) == -1).all()):
        fail("the MiMC scan with a wide constant 8,000 of 8,192: not exact "
             "before it is read, or not all ones after")
    log(f"mimc: compute_output(3) = the known output; 16 inputs equal the "
        f"oracle's at {MIMC_STEPS} steps with 64 and with {MIMC_STEPS} "
        f"constants; a wide constant read gives all ones")
    scan_times({"64_constants": c, f"{MIMC_STEPS}_constants": c_many})

    head = dev_io.tree_map(lambda t: t[:16], tree)
    before = os.environ.get("STARK_DEBUG")
    os.environ["STARK_DEBUG"] = "1"
    try:
        fn, _ = V.make_verifier(cfg, 3, device=DEV)
        t0 = time.perf_counter()
        expect_verdicts("STARK_DEBUG=1, the first 16 proofs", fn(head),
                        want[:16])
        secs = time.perf_counter() - t0
        bad = limbs_on_card(5)
        bad[3] = 0x2000F
        try:
            F.add_mod(limbs_on_card(5), bad)
            fail("STARK_DEBUG=1: a limb of 0x2000F did not raise")
        except ValueError as e:
            if "limb invariant" not in str(e):
                raise
    finally:
        if before is None:
            os.environ.pop("STARK_DEBUG", None)
        else:
            os.environ["STARK_DEBUG"] = before
    log(f"debug: STARK_DEBUG=1 verdicts of the first 16 proofs equal the "
        f"main path's ({secs:.2f} s a call); a wide limb raises")


def main():
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {smi}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    _build.load()
    log(f"build: {_build.build_seconds():.1f} s "
        f"({len(_build.sources())} sources, nvcc sm_90a)")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())
    ops = sass_phase()

    cfg = StarkConfig(log_steps=LOG_STEPS)
    consts = [(i ** 7) ^ 42 for i in range(cfg.num_constants)]
    t0 = time.perf_counter()
    tables = cached_tables(cfg)
    log(f"tables: {time.perf_counter() - t0:.1f} s (host)")

    kernels = kernel_phase(cfg, tables, ops)
    for k in kernels:
        for c in k["cases"]:
            log(f"kernel {k['name']} [{c['shape']}]: max_abs_err "
                f"{c['max_abs_err']}, wrapper {c['ms']:.4f} ms, device "
                f"{c['device_ms']:.4f} ms, plain "
                f"{c['plain_ms']:.2f} ms, bound {c['bound_ms']:.4f} ms "
                f"({c['bound_by']}; bytes {c['bytes_ms']:.4f}, all "
                f"instructions {c['instr_ms']:.4f}, ALU pipe "
                f"{c['alu_ms']:.4f})")
        if not k["match"]:
            fail(f"kernel {k['name']} disagrees with its plain version")

    t0 = time.perf_counter()
    blob = golden_proof(cfg)
    out = oracle.mimc(3, cfg.num_steps, consts)
    log(f"golden proof: {len(blob)} bytes, oracle accepts "
        f"({time.perf_counter() - t0:.1f} s)")
    tree_np = dev_io.proof_tree(wire.parse_and_validate(blob, cfg))

    fn, tree, want = main_path(cfg, blob, tree_np, kernels, ops)
    row_forms_phase(cfg, tables, tree)
    fn_u = unshared_path(cfg, blob, tree_np, tree, want, kernels, consts, out)
    general = runtime_statement_path(cfg, blob, tree, want, kernels, consts,
                                     out)
    graphs_phase(cfg, blob, tree_np, tree, want, consts, out)
    one_constant_a_round_phase()
    strict_phase(cfg, blob, tree_np)
    kinds, names = stream_phase(cfg, blob, tree_np, consts, out)
    rank_phase(cfg, blob, want, kinds, names, kernels)
    ntt_mimc_debug_phase(cfg, tree, want, kernels, ops)
    for k in kernels:
        if k["launches"] <= 0:
            fail(f"kernel {k['name']} was launched on none of the paths")
    del tree

    # ---- times -----------------------------------------------------------
    times = {"card": smi, "chunk": CHUNK}
    good = device_batch(tree_np, BATCH, tamper=False)
    # shared, unshared, unshared, shared: two versions within one call
    ts_s = timed_calls(fn, good, 3)
    ts_u = timed_calls(fn_u, good, 3)
    ts_u += timed_calls(fn_u, good, 2)
    ts_s += timed_calls(fn, good, 2)
    times["batch_1024_s_median"] = statistics.median(ts_s)
    times["batch_1024_proofs_per_s"] = BATCH / statistics.median(ts_s)
    times["unshared_batch_1024_s_median"] = statistics.median(ts_u)
    times["unshared_batch_1024_proofs_per_s"] = BATCH / statistics.median(ts_u)
    ts_g = timed_calls(general, good, 5)
    times["general_batch_1024_one_call_s_median"] = statistics.median(ts_g)
    if time.perf_counter() - t_start < 600:
        torch.cuda.reset_peak_memory_stats()
        big = device_batch(tree_np, BIG_BATCH, tamper=False)
        ts = timed_calls(fn, big, 3)
        times["batch_8192_s_median"] = statistics.median(ts)
        times["batch_8192_proofs_per_s"] = BIG_BATCH / statistics.median(ts)
        times["batch_8192_peak_device_bytes"] = torch.cuda.max_memory_allocated()
        del big
        torch.cuda.empty_cache()
    else:
        times["batch_8192_s_median"] = "not measured"
    one_fn, _ = V.make_verifier(cfg, 3, device=DEV)
    single = dev_io.to_device(tree_np, DEV)
    lat = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = one_fn(single)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        if not bool(ok):
            fail("single-proof call rejected the golden proof")
    times["single_proof_latency_s_median"] = statistics.median(lat[1:])
    times["total_seconds"] = time.perf_counter() - t_start
    log("times: " + json.dumps(times))
    if "--profile" in sys.argv:
        # last: the profiler slows every later launch of the process
        profile_call(f"main path, batch {BATCH}", lambda: fn(good))
        profile_call(f"unshared path, batch {BATCH}", lambda: fn_u(good))
        profile_call(f"runtime-statement path, batch {BATCH}",
                     lambda: general(good))

    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
