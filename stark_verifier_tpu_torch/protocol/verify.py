"""The MiMC-STARK verifier: FRI + trace spot checks, batched.

Counterpart of the reference's verify_mimc_proof / verify_low_degree_proof
(src/main.rs:31-197) and of the JAX package's protocol/verify.py.  Where the
reference walks branches and positions one at a time with BigInt, this runs
every proof of a batch through the same fixed-shape tensor program:

  * Fiat-Shamir index PRGs: batched hash chains                (ops/prg.py)
  * all Merkle branch groups: shared-path walks, or with
    shared_merkle=False every branch on its own to the root (ops/merkle.py,
    the walks themselves in the kernels of ops/merkle_cuda.py)
  * FRI rows: one kernel over all levels and queries, from the proof's
    rows and roots to a verdict a query                   (ops/fri_cuda.py)
  * 80 constraint spot checks: one kernel                (ops/spot_cuda.py)
  * runtime round constants: the call's K table from an iNTT and a
    forward NTT, launches of the several-stage NTT kernel   (ops/ntt.py)

Every assert of the reference becomes a boolean lane; the proof verdict is
their AND, so a batch returns per-proof verdicts instead of panicking.
With part=(rank, world) the verifier checks one rank's share of a proof
(point parallelism, parallel/mesh.verify_point_parallel): its slice of the
FRI queries, Merkle branches and spot checks, whose AND over the ranks is
the verdict.
Bit-exactness quirks preserved: raw (unreduced) column values compared
against canonical evaluations, raw special_x / k1..k4 fed to products, stale
quartic roots, steps-1 MiMC.

On CUDA tensors the kernels run; on CPU tensors the same wrappers run
their plain PyTorch versions.  Ragged proofs (per-branch witness depths, or
witness arrays padded deeper than the depths) verify with
shared_merkle=False; routed to the shared walk they reject through its
uniform-depth guard, never misverify.

With STARK_DEBUG=1 (debug.py) the FRI column indices and the spot-check
positions are bounds-checked before kernels C and D take them, and the
verifiers the makers return synchronize the device after each call.

A verifier module replays its calls on the card from CUDA graphs, one for
each shape of its inputs (_CallGraphs): a call of a shape seen before
launches its ~1,800 glue kernels and the hand-written ones as one graph.
No op of a call reads the device back or copies from the host, so the
whole call captures; the module keeps the boundary interpolant's host
constants for that.  Several threads may call one module: a lock orders
the graphs' lookups, captures and replays, and a replay runs on the
graph's own stream, after the work the caller queued before it.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading

import numpy as np
import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from .. import debug, fp
from ..config import StarkConfig, StatementTables, cached_tables
from ..ops import blake2s, blake2s_cuda, field as F, fri_cuda, merkle
from ..ops import mimc as mimc_ops, ntt, prg, spot_cuda
from ..profiling import span
from ..proofio.device import resolve_device, to_tensor, tree_map


def _verify_groups(groups):
    """Each group's verdict [...] from the independent walk of its branches:
    groups are (root_words, indices, proof-tree group) triples, all walked
    in one launch of kernel F."""
    oks = merkle.verify_branches_groups([
        dict(root=root, indices=indices, value=g["value"],
             sibling=g["sibling"], witness=g["witness"], depth=g["depth"])
        for root, indices, g in groups])
    return [ok.all(dim=-1) for ok in oks]


def _as_shared_group(root_words, indices, group):
    return {"root": root_words, "indices": indices, "value": group["value"],
            "sibling": group["sibling"], "witness": group["witness"],
            "depth": group["depth"]}


def _table(tables, name: str, device) -> torch.Tensor:
    """A statement table as a tensor: the verifier module's registered
    buffer when `tables` is one, else a fresh copy of the host array."""
    t = getattr(tables, name)
    if isinstance(t, torch.Tensor):
        return t
    if name == "level_moduli":
        return torch.tensor(t, dtype=torch.int64, device=device)
    if name == "points_pts":
        return torch.from_numpy(t).to(device)
    return to_tensor(t, device)


# the statement tables kernels C and D gather from, packed to 8
# little-endian words a row: (buffer of a verifier module, StatementTables
# field)
_PACKED_TABLES = (("g2_words", "g2_powers"), ("z_words", "z_table"),
                  ("z2_words", "z2_table"), ("k_words", "k_table"))


def _packed(tables, name: str, device) -> torch.Tensor:
    """A packed table: the verifier module's buffer when `tables` is one,
    else packed afresh from the host limb array."""
    if isinstance(tables, nn.Module):
        return getattr(tables, name)
    src = dict(_PACKED_TABLES)[name]
    return to_tensor(fp.limbs_to_le_words(getattr(tables, src)), device)


def _spot_tables(tables, cfg: StarkConfig, device) -> spot_cuda.SpotTables:
    return spot_cuda.SpotTables(
        *(_packed(tables, name, device) for name, _ in _PACKED_TABLES),
        log_steps=cfg.log_steps)


def runtime_k_words(constants_limbs, tables) -> torch.Tensor:
    """The K table of run-time round constants [k, 16] limbs, packed [k_period,
    8] as kernel D reads it: row t is minipoly(k_root^t), the minipoly
    recovered by the constants' iNTT (main.rs:125), zero-padded to k_period
    points and transformed forward with root k_root = G2^skips2.  Two NTTs
    a call, whatever k: one launch each of the several-stage kernel up to
    2^10 points, two up to 2^20."""
    minipoly = ntt.intt(constants_limbs, tables.minipoly_root)    # [k, 16]
    padded = torch.cat([minipoly, minipoly.new_zeros(
        (tables.k_period - minipoly.shape[0], fp.NLIMBS))])
    return F.limbs_to_words_le(ntt.ntt(padded, tables.k_root))


def _fri_checks(l_root_words, fri, tables, cfg: StarkConfig,
                shared_merkle: bool = True, ys=None):
    """Complete FRI low-degree check, inversion-free.

    Returns (ok [...] bool over all levels, root2 [..., L, 8]).  ys may be
    the precomputed [..., L, q] column indices (verify_mimc_proof derives
    them from a FUSED Fiat-Shamir chain shared with the spot-check PRG);
    None computes them here (standalone FRI use).
    """
    q = cfg.fri_queries
    dev = l_root_words.device

    # Level-PARALLEL walk: nothing is sequential across FRI levels -- each
    # level's seed is its own root2 from the proof, and its poly tree's root
    # (and special_x) is the *previous* level's root, a shifted stack.
    root2 = fri["root2"]                                   # [..., L, 8]
    prev = torch.cat([l_root_words[..., None, :], root2[..., :-1, :]],
                     dim=-2)                               # [..., L, 8]

    mod_b = _table(tables, "level_moduli", dev)[:, None]   # [L, 1] = rou_deg/4
    if ys is None:
        ys = prg.pseudorandom_indices(root2, q, mod_b,
                                      cfg.extension_factor)  # [..., L, q]
    debug.check_bounds(ys, cfg.precision // 4 + 1, "fri column indices")

    # column branches verify against the proof's own embedded root2
    # (merkle_tree.rs:30-33 trust quirk); each level's walk covers EXACTLY
    # its witness depth (witnesses are per-level lists)
    i4 = torch.arange(4, dtype=torch.int64, device=dev)
    poly_pos = (ys[..., None] + mod_b[..., None] * i4).reshape(
        *ys.shape[:-1], ys.shape[-1] * 4)         # q, or a rank's share
    nlv = len(fri["col_witness"])
    groups = []
    for l in range(nlv):
        groups.append({
            "root": root2[..., l, :], "indices": ys[..., l, :],
            "value": fri["col_value"][..., l, :, :],
            "sibling": fri["col_sibling"][..., l, :, :],
            "witness": fri["col_witness"][l],
            "depth": fri["col_depth"][..., l, :]})
        groups.append({
            "root": prev[..., l, :], "indices": poly_pos[..., l, :],
            "value": fri["poly_value"][..., l, :, :],
            "sibling": fri["poly_sibling"][..., l, :, :],
            "witness": fri["poly_witness"][l],
            "depth": fri["poly_depth"][..., l, :],
            # the 4 row branches of a query are sibling quads (permuted
            # indices 4y+i); the shared walk takes their subtree once
            "quad": True})
    if shared_merkle:
        # shared-path walks: the converging upper-tree levels of all 2L
        # groups dedup to one compression per distinct node, stacked into one
        # Blake2s call per tree level (ops/merkle.py)
        oks = merkle.verify_groups_shared(groups)
    else:
        # every branch on its own to the root: the poly groups are 4q
        # independent branches here, not quads
        oks = _verify_groups([(g["root"], g["indices"], g) for g in groups])
    ok_merkle = torch.stack(
        [oks[2 * l] & oks[2 * l + 1] for l in range(nlv)], dim=-1)  # [..., L]

    # row x-coords are quartic_rou[j] * x1 with x1 = rou_level^y,
    # rou_level = G2^(4^l) (stale quartic roots, main.rs:73-80): x1 is a known
    # power of G2, so the even/odd-split row evaluation's only denominators
    # come from the master power table by gather.  The row kernel reads the
    # proof's poly rows, column values and roots (special_x = the previous
    # root, raw, main.rs:54) and the packed table itself, and compares its
    # canonical interpolated value with the RAW column value (main.rs:84-86):
    # a non-canonical committed value can never equal it, exactly like the
    # reference's unreduced BigInt equality.
    ok_val = fri_cuda.fri_rows(
        fri["poly_value"], fri["col_value"], ys, l_root_words, root2,
        _packed(tables, "g2_words", dev), tables.quartic_ginv,
        tables.inv4).all(dim=-1)                           # [..., L]
    ok = (ok_merkle & ok_val).all(dim=-1)
    return ok, root2


def points_root_binding(points_words, last_root):
    """Bind the parsed POINTS element to the final committed column root
    (half of the reference's open TODO at main.rs:94)."""
    return (merkle.merkle_root_permuted(points_words) == last_root).all(dim=-1)


def points_direct_check(points_words, tables, cfg: StarkConfig):
    """Direct low-degree test of the final FRI layer -- the other half of the
    reference's TODO (main.rs:94; POINTS parsed then discarded,
    deserializer.rs:47-59).

    Replicates upstream mimc_stark's verify_low_degree_proof tail check:
    interpolate the degree-(D-1) polynomial through the values at the first
    D = max_deg_plus_1 domain positions NOT divisible by extension_factor,
    then require every remaining such position to evaluate consistently.
    The interpolation nodes are host constants, so the whole check is one
    [held_out, D] evaluation-matrix product (see StatementTables).

    points_words: [..., final_domain, 8] word rows.  Returns [...] bool.
    """
    deg = cfg.fri_final_maxdeg_plus_1
    # deg is 8 or 16 for every power-of-two num_steps (folding by 4 stops at
    # <= 16), so all D products of an evaluation-matrix row sum through ONE
    # reduction (field.mul_sum_mod; D = 16 is exactly its bound).  StarkConfig
    # can never derive deg > 16, so this guards only hand-built config stubs.
    if deg > 16:
        raise ValueError(f"unconstructible config: final FRI degree {deg}")
    dev = points_words.device
    pts = _table(tables, "points_pts", dev)
    data = F.words_be_to_limbs(points_words)               # [..., nd, 16]
    used = data[..., pts[:deg], :]                         # [..., D, 16]
    held = data[..., pts[deg:], :]                         # [..., H, 16]
    m = _table(tables, "points_eval_matrix", dev)          # [H, D, 16]
    pred = F.mul_sum_mod(
        [(m[..., i, :], used[..., None, i, :]) for i in range(deg)])
    # canonical evaluation vs the RAW held-out value, like every other
    # committed-value comparison (a non-canonical byte encoding never equals
    # the canonical evaluation)
    return (pred == held).all(dim=-1).all(dim=-1)


def verify_low_degree_proof(l_root_words, fri, tables, cfg: StarkConfig,
                            points_words=None, shared_merkle: bool = True,
                            ys=None):
    """Standalone FRI low-degree check (reference: src/main.rs:31-97).

    fri: the stacked level arrays from proofio.device.proof_tree.  All levels
    verify in parallel (see _fri_checks).  Returns [...] bool.  The final
    direct check of the POINTS element is (faithfully) skipped in parity
    mode -- main.rs:94 TODO; strict mode closes the TODO completely: it binds
    POINTS to the last committed root AND runs the real low-degree test.
    """
    ok, root2 = _fri_checks(l_root_words, fri, tables, cfg, shared_merkle,
                            ys=ys)
    if cfg.strict and points_words is not None:
        ok = ok & points_root_binding(points_words, root2[..., -1, :])
        ok = ok & points_direct_check(points_words, tables, cfg)
    return ok


def _share(t, part):
    """The rank's contiguous share of the last axis of t (part = (rank,
    world)); None is all of it."""
    if part is None:
        return t
    rank, world = part
    n = t.shape[-1] // world
    return t[..., rank * n:(rank + 1) * n]


def _check_part(tree, cfg: StarkConfig, part) -> None:
    """The tree must hold exactly the share of `part` of the proof's
    queries, branches and spot checks (parallel/mesh.shard_point_proof)."""
    rank, world = part
    if not 0 <= rank < world:
        raise ValueError(f"part {part}: rank outside the world")
    fri, q, s = tree["fri"], cfg.fri_queries, cfg.spot_checks
    want = {"fri col_value": (fri["col_value"].shape[-2], q),
            "fri poly_value": (fri["poly_value"].shape[-2], 4 * q),
            "main value": (tree["main"]["value"].shape[-2], 2 * s),
            "lincomb value": (tree["lincomb"]["value"].shape[-2], s)}
    for what, (got, whole) in want.items():
        if whole % world or got != whole // world:
            raise ValueError(
                f"part {part}: {what} holds {got} rows, not a share "
                f"{whole} // {world} (cut the tree with "
                f"parallel.mesh.shard_point_proof)")


def verify_mimc_proof(tree, inp, output_limbs, tables, cfg: StarkConfig,
                      constants_limbs=None, shared_merkle: bool = True,
                      part=None):
    """Full proof check; mirrors verify_mimc_proof (main.rs:99-197).

    tree: proof tree of int32 word tensors ([..., ...] leading batch dims);
    output_limbs [..., 16] the claimed MiMC output.  inp: a host int (fast
    path: the boundary interpolant folds to host constants) or [..., 16]
    limbs on the tree's device.  constants_limbs: optional [k, 16] RUNTIME
    round constants (k = cfg.num_constants) -- when given, the call's own K
    table (runtime_k_words) takes the place of the statement's.  The
    modulus stays fixed (the limb reduction is specialized to p).  tables:
    StatementTables or a verifier module (whose buffers are used as they
    are).  Returns [...] bool verdicts.  With a verifier module as `tables`
    and its own input, the call goes through the module's CUDA graphs
    (_CallGraphs); the `verify` span says how it ran (`graph`: eager,
    capture or replay) and graph_counts counts it by walk.

    part=(rank, world): the tree holds only the rank's share of the FRI
    queries (and their rows), of the main and lincomb branches and of the
    spot checks; the Fiat-Shamir chains, the k-hashes and the boundary
    interpolant still run whole, and their indices are cut to the share
    before the walks, the row kernel and the spot kernel.  The verdict is
    the share's; the proof's is the AND over the ranks.  Independent walk
    only (shared_merkle=False): the shared walk dedups across branches.
    """
    if part is not None:
        if shared_merkle:
            raise ValueError("part needs the independent walk "
                             "(shared_merkle=False)")
        _check_part(tree, cfg, part)
    runtime = constants_limbs is not None
    with span("verify") as sp:
        if sp:
            sp.set(proofs=tree["merkle_root"][..., 0].numel(),
                   shared_merkle=shared_merkle, runtime=runtime)
            hashed = sum(blake2s_cuda.launches.values())
        call = functools.partial(_verify_mimc, tables=tables, cfg=cfg,
                                 shared_merkle=shared_merkle, part=part)
        args = (tree, inp, output_limbs, constants_limbs)
        if _module_boundary(tables, inp) is None:
            ok, how, graph = call(*args), "eager", None
        else:
            ok, how, graph = tables.graphs(call, args,
                                           (cfg, shared_merkle), part)
        with _counts_lock:
            graph_counts["shared" if shared_merkle else "unshared", how] += 1
        if sp:
            sp.set(graph=how, hash_launches=graph.hash_launches
                   if how == "replay"
                   else sum(blake2s_cuda.launches.values()) - hashed)
        return ok


def boundary_ints(last: int, inp, modulus: int) -> list:
    """The host constants of the boundary interpolant I(x) = i_c1 x + i_c0
    through (1, inp) and (last, output) (main.rs:183-187, utils.rs:246-274):
    [inv_e e0, p - 1], which scale the output, then for a host int inp its
    folded terms [-last iy0, iy0], for run-time limbs (inp None) the factors
    [inv_e e1, -last]."""
    m = modulus
    e0, e1 = (1 - last) % m, (last - 1) % m
    inv_e = pow(e0 * e1 % m, m - 2, m)
    if inp is None:
        tail = [inv_e * e1 % m, (-last) % m]
    else:
        iy0 = inp % m * inv_e % m * e1 % m
        tail = [(-last * iy0) % m, iy0]
    return [inv_e * e0 % m, m - 1] + tail


def _host_inp(inp):
    """The statement-static input, or None for run-time limbs."""
    return inp if isinstance(inp, int) else None


def _module_boundary(tables, inp):
    """The verifier module's boundary constants [4, 16] where `tables` is a
    module made for this input, else None."""
    if isinstance(tables, _FamilyVerifier) and \
            tables.boundary_inp == _host_inp(inp):
        return tables.boundary
    return None


def interpolant(inp, output_limbs, bnd):
    """(i_c0, i_c1) canonical limbs of the boundary interpolant from the
    claimed output, the input (host int or limbs) and boundary_ints as limbs
    [4, 16]; the device part only where the output (and a run-time input)
    enters."""
    iy1 = F.mul_mod(output_limbs, bnd[0])                  # [..., 16]
    neg_iy1 = F.mul_mod(bnd[1], iy1)
    if isinstance(inp, int):
        # statement-static input: iy0 and its -last*iy0 term fold to host
        return F.add_mod(bnd[2], neg_iy1), F.add_mod(bnd[3], iy1)
    # runtime input (the reference's library boundary, lib.rs:99): the same
    # algebra on the device
    iy0 = F.mul_mod(inp, bnd[2])                           # [..., 16]
    return F.add_mod(F.mul_mod(iy0, bnd[3]), neg_iy1), F.add_mod(iy0, iy1)


def _verify_mimc(tree, inp, output_limbs, constants_limbs, tables,
                 cfg: StarkConfig, shared_merkle: bool, part):
    """verify_mimc_proof's checks, a span for each phase."""
    m = cfg.modulus
    dev = tree["merkle_root"].device
    checks = []

    # FUSED Fiat-Shamir chains: the per-level FRI column PRGs (seeded by
    # root2, main.rs:56) and the spot-check PRG (seeded by l_merkle_root,
    # main.rs:149) are independent chains of narrow hashes; stacking them
    # steps them together -- max(nf, ns)-1 sequential links, bit-identical
    # per lane (the links never mix lanes)
    nf = -(-cfg.fri_queries // 8)
    ns = -(-cfg.spot_checks // 8)
    with span("verify.prg"):
        seeds = torch.cat(
            [tree["fri"]["root2"], tree["l_merkle_root"][..., None, :]],
            dim=-2)                                        # [..., L+1, 8]
        entries = prg.chain_entries(seeds, max(nf, ns))    # [..., L+1, n, 8]
        moduli = _table(tables, "level_moduli", dev)       # [L] = rou_deg/4
        ys = prg.indices_from_entries(
            entries[..., :-1, :nf, :], cfg.fri_queries, moduli[:, None],
            cfg.extension_factor)                          # [..., L, q]

    # FRI low-degree proof over the linear-combination tree (main.rs:127)
    with span("verify.fri"):
        checks.append(verify_low_degree_proof(
            tree["l_merkle_root"], tree["fri"], tables, cfg,
            tree.get("points"), shared_merkle, ys=_share(ys, part)))

    # k1..k4 = Blake2s(merkle_root || i), raw 256-bit BE ints
    # (main.rs:131-146) -- the four 33-byte hashes batch into ONE call; the
    # ninth message word holds the single byte i
    mroot = tree["merkle_root"]
    with span("verify.khash"):
        kbytes = torch.arange(1, 5, dtype=torch.int32, device=dev)  # [4]
        kin = torch.cat(
            [mroot[..., None, :].expand(mroot.shape[:-1] + (4, 8)),
             kbytes[:, None].expand(mroot.shape[:-1] + (4, 1))],
            dim=-1)                                        # [..., 4, 9]
        kh = blake2s.hash_words(kin, 33)                   # [..., 4, 8] raw

    # spot-check positions from l_merkle_root (main.rs:148-156)
    with span("verify.prg"):
        positions = prg.indices_from_entries(
            entries[..., -1, :ns, :], cfg.spot_checks, cfg.precision,
            cfg.extension_factor)                          # [..., 80] int64
        debug.check_bounds(positions, cfg.precision, "spot-check positions")
        aug = torch.stack(
            [positions, (positions + cfg.skips) % cfg.precision], dim=-1)
        augmented = aug.reshape(*aug.shape[:-2],
                                cfg.spot_checks * 2)       # interleaved
        # a rank's share: positions [k0, k1) are main branches [2 k0, 2 k1)
        positions, augmented = _share(positions, part), _share(augmented,
                                                               part)

    with span("verify.merkle"):
        if shared_merkle:
            checks.extend(merkle.verify_groups_shared([
                _as_shared_group(mroot, augmented, tree["main"]),
                _as_shared_group(tree["l_merkle_root"], positions,
                                 tree["lincomb"])]))
        else:
            checks.extend(_verify_groups([
                (mroot, augmented, tree["main"]),
                (tree["l_merkle_root"], positions, tree["lincomb"])]))

    # K(x) = minipoly(x^skips2) takes only k_period distinct values: the spot
    # kernel looks it up by pos mod period (main.rs:177-178) in a packed K
    # table, the statement's or, with runtime constants, this call's
    spot_tables = _spot_tables(tables, cfg, dev)
    if constants_limbs is not None:
        if constants_limbs.shape != (cfg.num_constants, fp.NLIMBS):
            raise ValueError(
                f"constants_limbs: shape {tuple(constants_limbs.shape)}, "
                f"family expects {(cfg.num_constants, fp.NLIMBS)}")
        with span("verify.kx", constants=cfg.num_constants,
                  k_rows=tables.k_period):
            spot_tables = spot_tables._replace(
                k=runtime_k_words(constants_limbs, tables))

    # boundary interpolant I(x) coefficients (main.rs:183-187): the
    # module's constants, or this call's from the host
    with span("verify.boundary"):
        bnd = _module_boundary(tables, inp)
        if bnd is None:
            bnd = to_tensor(fp.ints_to_limbs(boundary_ints(
                tables.last_step_position, _host_inp(inp), m)), dev)
        i_c0, i_c1 = interpolant(inp, output_limbs, bnd)

    # the three constraint families (main.rs:179-192) in one kernel, each
    # right-hand side one multi-term accumulation compared against the
    # canonicalized committed value (ops/spot_cuda.py).  The kernel reads the
    # trace values from the proof's own rows -- 96-byte main leaves P(x) ||
    # D(x) || B(x) and P(g1 x) in the next row, main.rs:163-174 -- and
    # gathers x = G2^pos, x^steps, Z(x) = (x^steps - 1) / (x - last) and
    # Z2(x) = (x - 1)(x - last) (main.rs:164-166, 175-176, 185) from
    # host-precomputed tables: no inversion and no square-and-multiply
    with span("verify.spot"):
        oks = spot_cuda.spot_checks(
            tree["main"]["value"], tree["lincomb"]["value"], positions, kh,
            i_c1, i_c0, spot_tables, power=cfg.power)                               # [..., 80, 3]
        checks.append(oks.flatten(-2).all(dim=-1))

        ok = checks[0]
        for c in checks[1:]:
            ok = ok & c
    return ok


# calls of verify_mimc_proof by (walk, how they ran): the walk "shared" or
# "unshared", how as the `verify` span's `graph` says it (eager, capture or
# replay)
graph_counts = collections.Counter()
_counts_lock = threading.Lock()

# input shapes a verifier module keeps a graph for, least recently used out
GRAPH_KEYS = 4


def _on_card(tree) -> bool:
    return tree["merkle_root"].is_cuda


class _Graph:
    """One verify call captured in a CUDA graph: the static copies of its
    tensor inputs that the graph reads, the verdicts it writes, and the
    stream it is captured and replayed on."""

    def __init__(self, fn, leaves: list, spec):
        self.inputs = [x.clone(memory_format=torch.contiguous_format)
                       for x in leaves if isinstance(x, torch.Tensor)]
        it = iter(self.inputs)
        args = tree_unflatten([next(it) if isinstance(x, torch.Tensor) else x
                               for x in leaves], spec)
        hashed = sum(blake2s_cuda.launches.values())
        self.out = self._capture(fn, args)
        # what a replay launches of the hash kernel, as graph nodes
        self.hash_launches = sum(blake2s_cuda.launches.values()) - hashed

    def _capture(self, fn, args):
        dev = self.inputs[0].device
        self.graph = torch.cuda.CUDAGraph()
        self.stream = torch.cuda.Stream(dev)
        # thread_local: the stream's worker thread may wait on an event or
        # pin host memory while this thread captures
        with torch.cuda.device(dev), torch.cuda.graph(
                self.graph, stream=self.stream,
                capture_error_mode="thread_local"):
            return fn(*args)

    def _replay(self) -> None:
        self.graph.replay()

    @contextlib.contextmanager
    def _on_stream(self):
        """Run the block on the graph's stream, after the work queued so
        far on the caller's stream and before the work queued there
        later."""
        with torch.cuda.device(self.stream.device):
            caller = torch.cuda.current_stream()
            self.stream.wait_stream(caller)
            with torch.cuda.stream(self.stream):
                yield
            caller.wait_stream(self.stream)

    def __call__(self, tensors: list) -> torch.Tensor:
        """The verdicts of the call on `tensors` (the inputs' tensors in
        order): a copy into the static inputs, the replay and a copy of the
        verdicts, which the next replay would overwrite, all on the graph's
        stream, so that the next replay waits for them whatever stream its
        caller is on."""
        out = torch.empty_like(self.out)
        with self._on_stream():
            torch._foreach_copy_(self.inputs, tensors)
            self._replay()
            out.copy_(self.out)
        return out


class _CallGraphs:
    """The CUDA graphs of a verifier module's calls, by the shapes and
    dtypes of their inputs.  A call runs eagerly off the card, with `part`,
    under STARK_DEBUG (its checks read the device) and the first time its
    shapes are seen; the second time it is captured, and from then on
    replayed, so a shape seen once never pays for a capture.  GRAPH_KEYS
    shapes are kept, least recently used out.  The graphs' static inputs
    and verdicts are shared by every caller of the module, so one lock
    orders the lookups, the captures and the replays of all threads."""

    def __init__(self):
        self._keys = collections.OrderedDict()   # key -> None, then _Graph
        self._lock = threading.Lock()

    def __call__(self, fn, args: tuple, static, part=None) -> tuple:
        """(fn(*args), how it ran, the graph or None); `static`: what else
        the call is specialized to (hashable)."""
        if part is not None or debug.enabled() or not _on_card(args[0]):
            return fn(*args), "eager", None
        leaves, spec = tree_flatten(args)
        key = (static, spec, tuple(
            (x.shape, x.dtype, x.device) if isinstance(x, torch.Tensor)
            else x for x in leaves))
        with self._lock:
            if key in self._keys:
                self._keys.move_to_end(key)
                graph, how = self._keys[key], "replay"
                if graph is None:
                    graph = self._keys[key] = _Graph(fn, leaves, spec)
                    how = "capture"
                return graph([x for x in leaves
                              if isinstance(x, torch.Tensor)]), how, graph
            self._keys[key] = None
            if len(self._keys) > GRAPH_KEYS:
                self._keys.popitem(last=False)
        return fn(*args), "eager", None


class _FamilyVerifier(nn.Module):
    """What the verifiers of one statement family share.

    The statement tables are registered buffers (g2_powers, z_table,
    z2_table, k_table, points_eval_matrix as int32 limb tensors; the copies
    of the first four packed to 8 words a row that kernels C and D read,
    g2_words, z_words, z2_words, k_words; level_moduli and points_pts as
    int64), so they are copied to the device once and move with .to(); the
    host constants (quartic_ginv, inv4, last_step_position, k_period,
    k_root, minipoly_root) are plain attributes.  So are the boundary
    interpolant's constants for the module's input (boundary_ints as limbs
    [4, 16], for `boundary_inp`: a host int, or None for run-time limbs),
    so that a call copies nothing from the host and can be captured in a
    CUDA graph (`graphs`).
    """

    def __init__(self, cfg: StarkConfig, tables: StatementTables,
                 shared_merkle: bool, inp: int | None = None):
        super().__init__()
        if not cfg.sanity_ok():
            raise ValueError("statement fails reference sanity checks")
        self.cfg = cfg
        self.shared_merkle = shared_merkle
        for name in ("g2_powers", "z_table", "z2_table", "k_table",
                     "points_eval_matrix"):
            self.register_buffer(name, to_tensor(getattr(tables, name), "cpu"),
                                 persistent=False)
        for name, src in _PACKED_TABLES:
            self.register_buffer(
                name, to_tensor(fp.limbs_to_le_words(getattr(tables, src)),
                                "cpu"), persistent=False)
        self.register_buffer(
            "level_moduli",
            torch.tensor(tables.level_moduli, dtype=torch.int64),
            persistent=False)
        self.register_buffer("points_pts", torch.from_numpy(tables.points_pts),
                             persistent=False)
        self.quartic_ginv = np.asarray(tables.quartic_ginv)
        self.inv4 = np.asarray(tables.inv4)
        self.last_step_position = tables.last_step_position
        self.k_period = tables.k_period
        self.k_root = tables.k_root
        self.minipoly_root = tables.minipoly_root
        self.boundary_inp = inp
        self.register_buffer(
            "boundary", to_tensor(fp.ints_to_limbs(boundary_ints(
                tables.last_step_position, inp, cfg.modulus)), "cpu"),
            persistent=False)
        self.graphs = _CallGraphs()

    def _check_device(self, tree) -> None:
        dev = self.g2_powers.device
        if tree["merkle_root"].device != dev:
            raise ValueError(
                f"proof tree on {tree['merkle_root'].device}, verifier on "
                f"{dev}: move the tree with proofio.device.to_device")


class MimcVerifier(_FamilyVerifier):
    """The end-to-end verifier of one statement family as a module, against
    the statement's precomputed MiMC output.

    forward(tree) -> bool[...] verdicts, for a single proof (no batch axis)
    or a stacked batch; with `chunk` set, the batch is processed in a Python
    loop of fixed-size chunks to bound the working set.
    """

    def __init__(self, cfg: StarkConfig, inp: int, tables: StatementTables,
                 shared_merkle: bool = True, chunk: int | None = None):
        super().__init__(cfg, tables, shared_merkle, inp)
        self.inp = inp
        self.chunk = chunk
        self.mimc_output = mimc_ops.mimc_host(
            inp, cfg.num_steps,
            constants=[(i ** 7) ^ 42 for i in range(cfg.num_constants)],
            power=cfg.power)
        self.register_buffer(
            "output_limbs", to_tensor(fp.int_to_limbs(self.mimc_output), "cpu"),
            persistent=False)

    def _verify(self, tree, part=None) -> torch.Tensor:
        lead = tree["merkle_root"].shape[:-1]
        output = self.output_limbs.expand(lead + (fp.NLIMBS,))
        return verify_mimc_proof(tree, self.inp, output, self, self.cfg,
                                 shared_merkle=self.shared_merkle, part=part)

    def forward(self, tree, part=None) -> torch.Tensor:
        """part=(rank, world): the tree is the rank's share of each proof
        (see verify_mimc_proof); not with `chunk`."""
        self._check_device(tree)
        if part is not None:
            if self.chunk is not None:
                raise ValueError("part is not for the chunked verifier")
            return self._verify(tree, part)
        if self.chunk is None:
            return self._verify(tree)
        batch = tree["merkle_root"].shape[0]
        if batch % self.chunk:
            raise ValueError(
                f"batch {batch} must be a multiple of chunk {self.chunk}")
        out = [self._verify(tree_map(lambda x: x[i:i + self.chunk], tree))
               for i in range(0, batch, self.chunk)]
        return torch.cat(out)


class GeneralMimcVerifier(_FamilyVerifier):
    """The verifier with every statement parameter except the modulus a
    RUNTIME value (the reference's library boundary, src/lib.rs:99).

    forward(tree, inp_limbs, constants_limbs, output_limbs) -> bool[...]:
    inp_limbs / output_limbs [..., 16] tensors on the verifier's device
    (broadcast over the proof batch if unbatched), constants_limbs [k, 16]
    the round constants (k must equal cfg.num_constants: it shapes the
    iNTT)."""

    def forward(self, tree, inp_limbs, constants_limbs,
                output_limbs) -> torch.Tensor:
        self._check_device(tree)
        lead = tree["merkle_root"].shape[:-1]
        inp_b = inp_limbs.expand(lead + (fp.NLIMBS,))
        out_b = output_limbs.expand(lead + (fp.NLIMBS,))
        return verify_mimc_proof(tree, inp_b, out_b, self, self.cfg,
                                 constants_limbs=constants_limbs,
                                 shared_merkle=self.shared_merkle)


def make_verifier(cfg: StarkConfig | None = None, inp: int = 3,
                  shared_merkle: bool = True, device=None):
    """Build the end-to-end verifier for a statement family.

    Returns (module, tables) where module(tree) -> bool[...] checks proofs
    against the statement's precomputed MiMC output (a statement-level
    constant, computed once on the host).  Works for single proofs (no batch
    axis) and stacked batches.  shared_merkle=False walks every Merkle branch
    on its own to the root (ragged proofs, and the independent cross-check of
    the shared-path dedup).  device=None means the card, and raises where
    there is none.  MEMOIZED on (cfg, inp, shared_merkle, device): the tables
    cost seconds of host time and are copied to the device once.
    """
    fn, tables = _make_verifier_cached(cfg or StarkConfig(), inp,
                                       shared_merkle,
                                       str(resolve_device(device)))
    return debug.checked(fn), tables


@functools.lru_cache(maxsize=16)
def _make_verifier_cached(cfg: StarkConfig, inp: int, shared_merkle: bool,
                          device: str):
    with _build_span(cfg, shared_merkle):
        tables = cached_tables(cfg)
        return MimcVerifier(cfg, inp, tables, shared_merkle).to(device), tables


def _build_span(cfg: StarkConfig, shared_merkle: bool):
    """The span of a verifier built on a cache miss, named by its family."""
    return span("verify.build", log_steps=cfg.log_steps,
                shared_merkle=shared_merkle)


def make_chunked_verifier(cfg: StarkConfig | None = None, inp: int = 3,
                          chunk: int = 1024, shared_merkle: bool = True,
                          device=None):
    """Batched verifier that processes the batch in fixed-size chunks (a
    Python loop over [batch/chunk] slices), which bounds the working set of
    the level-parallel FRI check for arbitrarily large batches.  Batch must
    be a multiple of `chunk` (pad with any proof and ignore the verdicts).
    Memoized like make_verifier."""
    fn, tables = _make_chunked_cached(cfg or StarkConfig(), inp, chunk,
                                      shared_merkle,
                                      str(resolve_device(device)))
    return debug.checked(fn), tables


@functools.lru_cache(maxsize=16)
def _make_chunked_cached(cfg: StarkConfig, inp: int, chunk: int,
                         shared_merkle: bool, device: str):
    with _build_span(cfg, shared_merkle):
        tables = cached_tables(cfg)
        return (MimcVerifier(cfg, inp, tables, shared_merkle,
                             chunk).to(device), tables)


def make_general_verifier(cfg: StarkConfig | None = None,
                          shared_merkle: bool = True, device=None):
    """The library-boundary entry point (reference: src/lib.rs:99): every
    statement parameter except the modulus is a RUNTIME value.

    Returns (module, tables) where
        module(tree, inp_limbs, constants_limbs, output_limbs) -> bool[...]
    (see GeneralMimcVerifier).  The modulus stays fixed: the limb arithmetic
    is specialized to p = 2^256 - 351*2^32 + 1.  Memoized like make_verifier.
    """
    fn, tables = _make_general_cached(cfg or StarkConfig(), shared_merkle,
                                      str(resolve_device(device)))
    return debug.checked(fn), tables


@functools.lru_cache(maxsize=16)
def _make_general_cached(cfg: StarkConfig, shared_merkle: bool, device: str):
    with _build_span(cfg, shared_merkle):
        tables = cached_tables(cfg)
        return (GeneralMimcVerifier(cfg, tables, shared_merkle).to(device),
                tables)
