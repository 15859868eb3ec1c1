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
  2. build    -- nvcc builds the six kernels from stark_verifier_tpu_torch/csrc;
                 the instruction counts of the bounds are read from this
                 build's SASS (stark_verifier_tpu_torch/sass.py: cuobjdump
                 of the library and of csrc/probes/work.cu);
  3. kernels  -- each kernel against its plain PyTorch version on the card,
                 bit-exact, at the shapes its path gives it (the Merkle walks
                 A and F also with all groups of a call site in one launch,
                 as the path runs them), with the wrapper's time (CUDA events
                 around Python calls) and its device time (calls replayed
                 from a CUDA graph) beside the least time the card could
                 take;
  4. golden   -- a full-size MiMC-STARK proof (2^13 steps) is generated with
                 the pure-Python prover and accepted by the pure-Python oracle;
  5. main path -- 1,024 proofs (12 of them tampered, one per protocol site) in
                 chunks of 512 through make_chunked_verifier on the card;
                 verdicts must be exactly right, equal the CPU path's on the
                 first 16, and the shared-path kernels must have been
                 launched (kernel A twice a chunk); then verify_proof_bytes
                 on good / trailing / truncated / flipped blobs;
  6. unshared path -- the same batch with shared_merkle=False: every branch
                 walks to the root on its own in the independent-walk kernel
                 (twice a chunk); verdicts equal the main path's.  Then a ragged batch (witness
                 arrays one zero level deeper than the depths, one proof with
                 a short depth) routed by is_rectangular, and
                 verify_proof_bytes on a ragged blob the oracle rejects;
  7. runtime statement -- make_general_verifier with input, round constants
                 and output as tensors (the constants go through an iNTT whose
                 products are the multiply kernel); verify_mimc on a list of
                 blobs; a fresh power-2 proof through SquareStatement;
  8. strict   -- the golden proof accepts, a changed POINTS word rejects
                 under strict and accepts under parity, trailing bytes reject;
  9. times    -- proofs/s at batch 1,024 (shared, unshared, runtime
                 statement) and 8,192, single-proof latency.

Each path is driven with every launch count set to 0 just before it and read
just after.  The last line printed is {"ok": true, "device": {...}}; the line
before it holds one JSON record per kernel.
"""

import json
import os
import statistics
import subprocess
import sys
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
from stark_verifier_tpu_torch import _build, fp, sass  # noqa: E402
from stark_verifier_tpu_torch.config import StarkConfig, cached_tables  # noqa: E402
from stark_verifier_tpu_torch.models.square import SquareStatement  # noqa: E402
from stark_verifier_tpu_torch.ops import (  # noqa: E402
    field as F, field_cuda, fri_cuda, merkle as merkle_ops, merkle_cuda,
    spot_cuda)
from stark_verifier_tpu_torch.proofio import device as dev_io, wire  # noqa: E402
from stark_verifier_tpu_torch.protocol import verify as V  # noqa: E402

DEV = torch.device("cuda")
P = fp.MODULUS
LOG_STEPS = 13         # the default statement family, at full width
CHUNK = 512            # proofs per chunk on the main path
BATCH = 1024
BIG_BATCH = 8192
RAGGED_BATCH = 16      # proofs of the padded batch of the unshared path
MUL_BIG = 1 << 20      # elements of the multiply's large comparison
KERNEL_MODULES = (merkle_cuda, fri_cuda, spot_cuda, field_cuda)

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
#   a Blake2s compression of kernels A, B and F: the level loop of the
#     kernel (part of its mangled name here), its LOP3, PRMT and SHF (the
#     xors, rotates and feed-forward, ALU pipe only) and its adds; the row's
#     loads, the message selects and the loop's control are left out, so
#     that a leaf's compressions count the same;
#   kernels C, D and E: the probes of csrc/probes/work.cu, the products,
#     reductions, adds and compares of a unit of the function, with no
#     loads, stores, moves or limb packing; C's special_x is canonicalized
#     and squared once per (proof, level), as the function needs, though
#     the kernel redoes it in every thread.
SASS_COMPRESS = {"walk_leaf_levels": "stark_walk_groups_kernelILb0",
                 "walk_branches": "stark_walk_groups_kernelILb1",
                 "chain_levels": "stark_chain_kernel"}
SASS_PROBES = ("probe_eval4_row", "probe_eval4_special_x", "probe_spot3",
               "probe_spot2", "probe_mul")

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


def rand_limbs(gen, shape):
    """Random raw 256-bit values as [..., 16] limbs; the first few are the
    edge values 0, 1, p-1, p, p+1, 2^256-1."""
    l = torch.randint(0, 1 << 16, shape + (16,), generator=gen, device=DEV,
                      dtype=torch.int64).to(torch.int32)
    edge = fp.ints_to_limbs([0, 1, P - 1, P, P + 1, 2**256 - 1])
    flat = l.view(-1, 16)
    if flat.shape[0] >= 6:
        flat[:6] = torch.from_numpy(edge.astype(np.int32)).to(DEV)
    flat[6::13] = 0xFFFF             # all-ones values (>= p)
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


def check_chain(gen, ops, b, q, depth, levels, reps):
    # the main path's operand: levels 1..levels of one branch in four
    wit4 = rand_words(gen, (b, q, 4, depth, 8))
    view = wit4[:, :, 0, 1:1 + levels, :]
    h = rand_words(gen, (b, q, 8))
    ti = torch.randint(8, 1 << 20, (b, q), generator=gen, device=DEV,
                       dtype=torch.int64).to(torch.int32)
    got = merkle_cuda.chain_levels(h, view, ti, levels)
    torch.cuda.synchronize()
    want = merkle_cuda.chain_levels_plain(h, view, ti, levels)
    items = b * q
    return measure(f"B={b} n={q} levels={levels}",
                   lambda: merkle_cuda.chain_levels(h, view, ti, levels),
                   lambda: merkle_cuda.chain_levels_plain(h, view, ti, levels),
                   [got], [want], nbytes(h, ti, got) + items * levels * 32,
                   [(items * levels, ops["chain_levels"])], reps)


def check_rows(gen, ops, tables, cfg, b, reps):
    nl, q = cfg.fri_levels, cfg.fri_queries
    g2t = dev_io.to_tensor(tables.g2_powers, DEV)
    mask = cfg.precision - 1
    e1 = torch.randint(0, cfg.precision, (b, nl, q), generator=gen,
                       device=DEV, dtype=torch.int64)
    x1_inv = g2t[(-e1) & mask]
    x1sq_inv = g2t[(-2 * e1) & mask]
    ys = F.limbs_to_words_be(rand_limbs(gen, (b, nl, q, 4))).contiguous()
    ys.view(-1)[5::17] = -1                      # 0xFFFFFFFF words
    sx = rand_limbs(gen, (b, nl))                # raw, some >= p
    args = (x1_inv, x1sq_inv, ys, sx, tables.quartic_ginv, tables.inv4)
    got = fri_cuda.eval4_rows(*args)
    torch.cuda.synchronize()
    want = fri_cuda.eval4_rows_plain(*args)
    return measure(f"B={b} levels={nl} queries={q}",
                   lambda: fri_cuda.eval4_rows(*args),
                   lambda: fri_cuda.eval4_rows_plain(*args), [got], [want],
                   nbytes(x1_inv, x1sq_inv, ys, sx, got),
                   [(b * nl * q, ops["probe_eval4_row"]),
                    (b * nl, ops["probe_eval4_special_x"])], reps)


def check_spot(gen, ops, cfg, b, reps):
    n = cfg.spot_checks
    raw5 = rand_limbs(gen, (b, n, 5))
    tab5 = F.canon(rand_limbs(gen, (b, n, 5)))
    ks4 = rand_limbs(gen, (b, 1, 4))             # raw k's, some >= p
    ic1 = F.canon(rand_limbs(gen, (b, 1)))
    ic0 = F.canon(rand_limbs(gen, (b, 1))).flip(0).contiguous()
    # random inputs fail every check; make each family hold at some
    # positions (a canonical right-hand side is a valid raw encoding of
    # itself)
    p, d, bb = (F.canon(raw5[..., i, :]) for i in (0, 2, 3))
    x, xs, z, z2, k = (tab5[..., i, :] for i in range(5))
    mul = field_cuda.mul_mod_plain   # input making stays off the multiply kernel
    rhs_t = F.mul_sum_mod([(mul(p, p), p), (z, d)], extra=[k])
    raw5[:, 0::3, 1] = rhs_t[:, 0::3]
    rhs_l = F.mul_sum_mod(
        [(ks4[..., 0, :], p), (ks4[..., 1, :], mul(p, xs)),
         (ks4[..., 2, :], bb), (ks4[..., 3, :], mul(bb, xs))], extra=[d])
    raw5[:, 1::3, 4] = rhs_l[:, 1::3]
    rhs_b = F.mul_sum_mod([(bb, z2), (ic1, x)], extra=[ic0.expand(x.shape)])
    raw5[:, 2::3, 0] = rhs_b[:, 2::3]            # (changes P: only bit 1 there)
    args = (raw5, tab5, ks4, ic1, ic0)
    got = spot_cuda.spot_checks(*args, power=cfg.power)
    torch.cuda.synchronize()
    want = spot_cuda.spot_checks_plain(*args, power=cfg.power)
    frac = want.to(torch.float32).mean(dim=(0, 1)).tolist()
    if not (want[:, 0::3, 0].all() and want[:, 1::3, 2].all()
            and want[:, 2::3, 1].all()) or want.all():
        fail("spot-check comparison inputs do not mix passing and failing "
             f"positions as intended (pass fractions {frac})")
    rec = measure(f"B={b} positions={n}",
                  lambda: spot_cuda.spot_checks(*args, power=cfg.power),
                  lambda: spot_cuda.spot_checks_plain(*args, power=cfg.power),
                  [got], [want],
                  nbytes(raw5, tab5, ks4, ic1, ic0) + b * n * 4,
                  [(b * n, ops[f"probe_spot{cfg.power}"])], reps)
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
    if shape_b:
        b = b.flip(0).contiguous()       # the edge values meet random ones
        if b.shape[0] >= 6 and a.shape == b.shape:
            b[:6] = a[:6].flip(0)        # ... and each other
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
    b_cases = []
    for l in range(nl):
        d = dm - 2 * l                               # poly tree depth
        b_cases.append(check_chain(gen, ops, b, q, d, d - 4, 20))
    c_case = check_rows(gen, ops, tables, cfg, b, 20)
    d_case = check_spot(gen, ops, cfg, b, 20)
    # kernel E at the runtime-statement path's shapes (a boundary product of
    # one chunk and of the whole batch, every butterfly stage of the iNTT of
    # the 64 constants as ops/ntt.py slices it, its final scaling) and at a
    # size whose bound reads real work
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
        record("chain_levels", src + "merkle_walk.cu",
               tpu + "merkle_pallas.py:198", b_cases),
        record("eval4_rows", src + "fri_rows.cu",
               tpu + "fri_pallas.py:92", [c_case]),
        record("spot_checks", src + "spot_checks.cu",
               tpu + "spot_pallas.py:56", [d_case]),
        record("mul_mod", src + "field_mul.cu",
               tpu + "field_pallas.py:206", e_cases),
        record("walk_branches", src + "merkle_walk.cu",
               tpu + "merkle_pallas.py:117", f_cases),
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
    for mod in KERNEL_MODULES:
        for name in mod.launches:
            mod.launches[name] = 0
    out = call()
    torch.cuda.synchronize()
    counts = {}
    for mod in KERNEL_MODULES:
        counts.update(mod.launches)
    return out, counts


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


def main_path(cfg, blob, tree_np, kernels):
    """Phase 5.  Returns (verifier, batch on the card, exact verdicts)."""
    fn, _ = V.make_chunked_verifier(cfg, 3, chunk=CHUNK, device=DEV)
    tree = device_batch(tree_np, BATCH, tamper=True)
    verdicts, counts = counted(lambda: fn(tree))
    want = torch.ones(BATCH, dtype=torch.bool)
    want[1:1 + len(SITES)] = False
    verdicts = expect_verdicts("main path", verdicts, want)
    shared = ("walk_leaf_levels", "chain_levels", "eval4_rows", "spot_checks")
    require_launches("main path", counts, shared, idle=("walk_branches",))
    if counts["walk_leaf_levels"] != 2 * (BATCH // CHUNK):
        fail(f"the main path launched kernel A {counts['walk_leaf_levels']} "
             f"times, expected 2 a chunk (main + lincomb; the column groups)")
    for k in kernels:
        if k["name"] in shared:
            k["launches"], k["launches_on"] = counts[k["name"]], "main path"
    log(f"main path: batch {BATCH} in chunks of {CHUNK}: verdicts exact "
        f"(12 tampered reject, {BATCH - 12} accept); launches {counts}")

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
        got = sv.verify_proof_bytes(data, log_steps=LOG_STEPS, device=DEV)
        if got is not expect:
            fail(f"verify_proof_bytes({name}) = {got}, expected {expect}")
    log(f"verify_proof_bytes: {', '.join(facade)} as expected")
    return fn, tree, want


def unshared_path(cfg, blob, tree_np, tree, want, kernels, consts, out):
    """Phase 6.  Returns the unshared chunked verifier."""
    fn_u, _ = V.make_chunked_verifier(cfg, 3, chunk=CHUNK,
                                      shared_merkle=False, device=DEV)
    verdicts, counts = counted(lambda: fn_u(tree))
    expect_verdicts("unshared path", verdicts, want)
    require_launches("unshared path", counts,
                     ("walk_branches", "eval4_rows", "spot_checks"),
                     idle=("walk_leaf_levels", "chain_levels"))
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
                     idle=("walk_leaf_levels", "chain_levels"))
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
                     idle=("walk_leaf_levels", "chain_levels"))
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
                     ("mul_mod", "walk_leaf_levels", "chain_levels",
                      "eval4_rows", "spot_checks"))
    for k in kernels:
        if k["name"] == "mul_mod":
            k["launches"], k["launches_on"] = (counts["mul_mod"],
                                               "runtime-statement path")
    log(f"runtime-statement path: batch {BATCH}, input, constants and output "
        f"as tensors: verdicts equal the static path's; launches {counts}")
    replay_mul_launches(lambda: gfn(tree, inp_l, consts_l, out_l),
                        counts["mul_mod"], kernels)
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

    fn, tree, want = main_path(cfg, blob, tree_np, kernels)
    fn_u = unshared_path(cfg, blob, tree_np, tree, want, kernels, consts, out)
    general = runtime_statement_path(cfg, blob, tree, want, kernels, consts,
                                     out)
    strict_phase(cfg, blob, tree_np)
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
