#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout:
    python3 chip_smoke.py [--profile]
(--profile adds a torch.profiler pass over one main-path call: the device's
busy share, and total and per-launch device time of the kernels that take
most of it.)

It needs a CUDA device, `nvcc`, and nothing else: no network, no JAX.  Phases
(any failure ends the run with a non-zero exit code; nothing falls back to
the CPU):

  1. device   -- the card's name and power limit;
  2. build    -- nvcc builds the four kernels from stark_verifier_tpu_torch/csrc;
  3. kernels  -- each kernel against its plain PyTorch version on the card,
                 bit-exact, at the shapes the main path gives it, with the
                 wrapper's time (CUDA events around Python calls) and its
                 device time (calls replayed from a CUDA graph) beside the
                 least time the card could take;
  4. golden   -- a full-size MiMC-STARK proof (2^13 steps) is generated with
                 the pure-Python prover and accepted by the pure-Python oracle;
  5. main path -- 1,024 proofs (12 of them tampered, one per protocol site) in
                 chunks of 512 through make_chunked_verifier on the card;
                 verdicts must be exactly right, equal the CPU path's on the
                 first 16, and every kernel must have been launched;
                 then verify_proof_bytes on good / trailing / truncated /
                 flipped blobs;
  6. times    -- proofs/s at batch 1,024 and 8,192, single-proof latency.

The last line printed is {"ok": true, "device": {...}}; the line before it
holds one JSON record per kernel.
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
from stark_verifier_tpu_torch import _build, fp  # noqa: E402
from stark_verifier_tpu_torch.config import StarkConfig, cached_tables  # noqa: E402
from stark_verifier_tpu_torch.ops import (  # noqa: E402
    field as F, fri_cuda, merkle_cuda, spot_cuda)
from stark_verifier_tpu_torch.proofio import device as dev_io, wire  # noqa: E402
from stark_verifier_tpu_torch.protocol import verify as V  # noqa: E402

DEV = torch.device("cuda")
P = fp.MODULUS
CHUNK = 512            # proofs per chunk on the main path
BATCH = 1024
BIG_BATCH = 8192

# Published peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of device
# memory bandwidth and 67 TFLOP/s of float32 outside the tensor cores.  The
# sheet gives no int32 rate; an SM has 128 float32 lanes, each counted as 2
# operations per fused multiply-add, and 64 int32 lanes, so the int32 peak is
# 67e12 / 4 simple integer instructions per second.
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

# Integer instructions per unit of work (what the bound counts):
#   one Blake2s compression = 80 G functions of 12 instructions (a G is 14
#     two-input operations, but the card adds three inputs in one IADD3, so
#     a + b + x is one instruction);
#   one 256x256-bit product = 64 32x32->64 multiply-adds = 128 instructions;
#   one reduction of an accumulator mod p = 34 multiply-adds = 68 instructions;
#   one modular add / sub / canonicalization = 16 instructions.
OPS_COMPRESS = 80 * 12
OPS_MUL, OPS_REDUCE, OPS_ADD = 128, 68, 16
# kernel C: per row group the canonicalizations, the even/odd split and 7
# products; per (proof, level) one canonicalization and squaring of special_x
# (the kernel redoes that in every thread, which the bound does not count)
OPS_ROW = 7 * OPS_MUL + 6 * OPS_REDUCE + 14 * OPS_ADD
OPS_ROW_SX = OPS_MUL + OPS_REDUCE + OPS_ADD
OPS_SPOT = 11 * OPS_MUL + 6 * OPS_REDUCE + 5 * OPS_ADD       # kernel D

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


def bound(bytes_moved, ops):
    tb = bytes_moved / MEM_BYTES_PER_S * 1e3
    to = ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


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

def check_walk(gen, b, n, vw, depth, levels, reps):
    val, sib = rand_words(gen, (b, n, vw)), rand_words(gen, (b, n, vw))
    wit = rand_words(gen, (b, n, depth, 8))
    ti = start_indices((b, n), depth, gen)
    got = merkle_cuda.walk_leaf_levels(val, sib, wit, ti, levels)
    torch.cuda.synchronize()
    want = merkle_cuda.walk_leaf_levels_plain(val, sib, wit, ti, levels)
    err = max_abs_err(got, want)
    def call():
        return merkle_cuda.walk_leaf_levels(val, sib, wit, ti, levels)
    ms, dms = time_ms(call, reps), device_ms(call)
    plain_ms = time_ms(lambda: merkle_cuda.walk_leaf_levels_plain(
        val, sib, wit, ti, levels), 2)
    items = b * n
    moved = nbytes(val, sib, ti, got) + items * levels * 32
    ops = items * ((3 if vw == 24 else 1) + levels) * OPS_COMPRESS
    bms, by = bound(moved, ops)
    return {"shape": f"B={b} n={n} vw={vw} levels={levels}",
            "max_abs_err": err, "ms": ms, "device_ms": dms,
            "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by}


def check_chain(gen, b, q, depth, levels, reps):
    # the main path's operand: levels 1..levels of one branch in four
    wit4 = rand_words(gen, (b, q, 4, depth, 8))
    view = wit4[:, :, 0, 1:1 + levels, :]
    h = rand_words(gen, (b, q, 8))
    ti = torch.randint(8, 1 << 20, (b, q), generator=gen, device=DEV,
                       dtype=torch.int64).to(torch.int32)
    got = merkle_cuda.chain_levels(h, view, ti, levels)
    torch.cuda.synchronize()
    want = merkle_cuda.chain_levels_plain(h, view, ti, levels)
    err = max_abs_err(got, want)
    def call():
        return merkle_cuda.chain_levels(h, view, ti, levels)
    ms, dms = time_ms(call, reps), device_ms(call)
    plain_ms = time_ms(lambda: merkle_cuda.chain_levels_plain(
        h, view, ti, levels), 2)
    items = b * q
    moved = nbytes(h, ti, got) + items * levels * 32
    bms, by = bound(moved, items * levels * OPS_COMPRESS)
    return {"shape": f"B={b} n={q} levels={levels}", "max_abs_err": err,
            "ms": ms, "device_ms": dms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by}


def check_rows(gen, tables, cfg, b, reps):
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
    err = max_abs_err(got, want)
    def call():
        return fri_cuda.eval4_rows(*args)
    ms, dms = time_ms(call, reps), device_ms(call)
    plain_ms = time_ms(lambda: fri_cuda.eval4_rows_plain(*args), 2)
    items = b * nl * q
    moved = nbytes(x1_inv, x1sq_inv, ys, sx, got)
    bms, by = bound(moved, items * OPS_ROW + b * nl * OPS_ROW_SX)
    return {"shape": f"B={b} levels={nl} queries={q}", "max_abs_err": err,
            "ms": ms, "device_ms": dms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by}


def check_spot(gen, cfg, b, reps):
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
    rhs_t = F.mul_sum_mod([(F.sqr_mod(p), p), (z, d)], extra=[k])
    raw5[:, 0::3, 1] = rhs_t[:, 0::3]
    rhs_l = F.mul_sum_mod(
        [(ks4[..., 0, :], p), (ks4[..., 1, :], F.mul_mod(p, xs)),
         (ks4[..., 2, :], bb), (ks4[..., 3, :], F.mul_mod(bb, xs))], extra=[d])
    raw5[:, 1::3, 4] = rhs_l[:, 1::3]
    rhs_b = F.mul_sum_mod([(bb, z2), (ic1, x)], extra=[ic0.expand(x.shape)])
    raw5[:, 2::3, 0] = rhs_b[:, 2::3]            # (changes P: only bit 1 there)
    args = (raw5, tab5, ks4, ic1, ic0)
    got = spot_cuda.spot_checks(*args, power=cfg.power)
    torch.cuda.synchronize()
    want = spot_cuda.spot_checks_plain(*args, power=cfg.power)
    err = max_abs_err(got, want)
    frac = want.to(torch.float32).mean(dim=(0, 1)).tolist()
    if not (want[:, 0::3, 0].all() and want[:, 1::3, 2].all()
            and want[:, 2::3, 1].all()) or want.all():
        fail("spot-check comparison inputs do not mix passing and failing "
             f"positions as intended (pass fractions {frac})")
    def call():
        return spot_cuda.spot_checks(*args, power=cfg.power)
    ms, dms = time_ms(call, reps), device_ms(call)
    plain_ms = time_ms(lambda: spot_cuda.spot_checks_plain(
        *args, power=cfg.power), 2)
    items = b * n
    moved = nbytes(raw5, tab5, ks4, ic1, ic0) + items * 4
    bms, by = bound(moved, items * OPS_SPOT)
    return {"shape": f"B={b} positions={n}", "max_abs_err": err, "ms": ms,
            "device_ms": dms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by,
            "pass_fractions": frac}


def kernel_phase(cfg, tables):
    gen = torch.Generator(device=DEV)
    gen.manual_seed(20240613)
    b = CHUNK
    dm = cfg.log_steps + 2               # witness depth of the main trees: 15
    # the full-width level count the shared walk gives each group
    # (ops/merkle.py: depth minus the dense tail, one level for the leaf)
    a_cases = [check_walk(gen, b, 2 * cfg.spot_checks, 24, dm, dm - 3, 20),
               check_walk(gen, b, cfg.spot_checks, 8, dm, dm - 3, 20)]
    for l in range(cfg.fri_levels):
        d = dm - 2 - 2 * l                           # column tree depth
        a_cases.append(check_walk(gen, b, cfg.fri_queries, 8, d, d - 3, 20))
    b_cases = []
    for l in range(cfg.fri_levels):
        d = dm - 2 * l                               # poly tree depth
        b_cases.append(check_chain(gen, b, cfg.fri_queries, d, d - 4, 20))
    c_case = check_rows(gen, tables, cfg, b, 20)
    d_case = check_spot(gen, cfg, b, 20)

    def record(name, source, replaces, cases):
        main = cases[0]
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0,
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


def profile_main_path(fn, tree):
    """One main-path call under torch.profiler: device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn(tree)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(tree)
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
    log(f"profile: one call of batch {tree['merkle_root'].shape[0]} under the "
        f"profiler: wall {wall * 1e3:.1f} ms, device busy {total_us / 1e3:.1f} "
        f"ms ({100 * total_us / (wall * 1e6):.1f}% of wall), "
        f"{sum(r[2] for r in rows)} device kernels")
    ours = [r for r in rows if "stark_" in r[0]]
    log(f"  profile: the port's own kernels: "
        f"{sum(r[1] for r in ours) / 1e3:.3f} ms in "
        f"{sum(r[2] for r in ours)} launches; PyTorch's: "
        f"{(total_us - sum(r[1] for r in ours)) / 1e3:.3f} ms in "
        f"{sum(r[2] for r in rows) - sum(r[2] for r in ours)} launches")
    for key, us, count in ours + sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"  profile: {us / 1e3:9.3f} ms  {count:7d} x  "
            f"{us / 1e3 / count:8.4f} ms per launch  {key[:90]}")


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

    cfg = StarkConfig()
    t0 = time.perf_counter()
    tables = cached_tables(cfg)
    log(f"tables: {time.perf_counter() - t0:.1f} s (host)")

    kernels = kernel_phase(cfg, tables)
    for k in kernels:
        for c in k["cases"]:
            log(f"kernel {k['name']} [{c['shape']}]: max_abs_err "
                f"{c['max_abs_err']}, wrapper {c['ms']:.4f} ms, device "
                f"{c['device_ms']:.4f} ms, plain "
                f"{c['plain_ms']:.2f} ms, bound {c['bound_ms']:.4f} ms "
                f"({c['bound_by']})")
        if not k["match"]:
            fail(f"kernel {k['name']} disagrees with its plain version")

    t0 = time.perf_counter()
    blob = golden_proof(cfg)
    log(f"golden proof: {len(blob)} bytes, oracle accepts "
        f"({time.perf_counter() - t0:.1f} s)")
    tree_np = dev_io.proof_tree(wire.parse_and_validate(blob, cfg))

    # ---- main path: 1,024 proofs in chunks of 512 on the card ------------
    fn, _ = V.make_chunked_verifier(cfg, 3, chunk=CHUNK, device=DEV)
    tree = device_batch(tree_np, BATCH, tamper=True)
    for mod in (merkle_cuda, fri_cuda, spot_cuda):
        for name in mod.launches:
            mod.launches[name] = 0
    verdicts = fn(tree)
    torch.cuda.synchronize()
    counts = {**merkle_cuda.launches, **fri_cuda.launches,
              **spot_cuda.launches}
    verdicts = verdicts.cpu()
    want = torch.ones(BATCH, dtype=torch.bool)
    want[1:1 + len(SITES)] = False
    if verdicts.dtype != torch.bool or verdicts.shape != (BATCH,):
        fail(f"verdicts: {verdicts.dtype} {tuple(verdicts.shape)}")
    if not torch.equal(verdicts, want):
        bad = (verdicts != want).nonzero().flatten().tolist()
        fail(f"wrong verdicts at proofs {bad[:20]}")
    for k in kernels:
        k["launches"] = counts[k["name"]]
        if k["launches"] <= 0:
            fail(f"kernel {k['name']} was not launched on the main path")
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
        got = sv.verify_proof_bytes(data, device=DEV)
        if got is not expect:
            fail(f"verify_proof_bytes({name}) = {got}, expected {expect}")
    log(f"verify_proof_bytes: {', '.join(facade)} as expected")

    # ---- times -----------------------------------------------------------
    times = {"card": smi, "chunk": CHUNK}
    good = device_batch(tree_np, BATCH, tamper=False)
    ts = timed_calls(fn, good, 5)
    times["batch_1024_s_median"] = statistics.median(ts)
    times["batch_1024_proofs_per_s"] = BATCH / statistics.median(ts)
    del tree
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
        profile_main_path(fn, good)

    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
