"""The MiMC-STARK verifier: FRI + trace spot checks, batched.

Counterpart of the reference's verify_mimc_proof / verify_low_degree_proof
(src/main.rs:31-197) and of the JAX package's protocol/verify.py.  Where the
reference walks branches and positions one at a time with BigInt, this runs
every proof of a batch through the same fixed-shape tensor program:

  * Fiat-Shamir index PRGs: batched hash chains                (ops/prg.py)
  * all Merkle branch groups: shared-path walks, or with
    shared_merkle=False every branch on its own to the root (ops/merkle.py,
    the walks themselves in the kernels of ops/merkle_cuda.py)
  * FRI rows: one kernel over all levels and queries      (ops/fri_cuda.py)
  * 80 constraint spot checks: one kernel                (ops/spot_cuda.py)
  * runtime round constants: an iNTT whose products are the element-wise
    multiply kernel                          (ops/ntt.py, ops/field_cuda.py)

Every assert of the reference becomes a boolean lane; the proof verdict is
their AND, so a batch returns per-proof verdicts instead of panicking.
Bit-exactness quirks preserved: raw (unreduced) column values compared
against canonical evaluations, raw special_x / k1..k4 fed to products, stale
quartic roots, steps-1 MiMC.

On CUDA tensors the kernels run; on CPU tensors the same wrappers run
their plain PyTorch versions.  Ragged proofs (per-branch witness depths, or
witness arrays padded deeper than the depths) verify with
shared_merkle=False; routed to the shared walk they reject through its
uniform-depth guard, never misverify.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from .. import fp
from ..config import StarkConfig, StatementTables, cached_tables
from ..ops import blake2s, field as F, fri_cuda, merkle, mimc as mimc_ops
from ..ops import ntt, prg, spot_cuda
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
    # level's seed is its own root2 from the proof and its special_x is the
    # *previous* level's root, which is just a shifted stack.
    root2 = fri["root2"]                                   # [..., L, 8]
    prev = torch.cat([l_root_words[..., None, :], root2[..., :-1, :]],
                     dim=-2)                               # [..., L, 8]
    # special_x = raw previous-root bytes as (unreduced) field elements
    # (main.rs:54)
    special_x = F.words_be_to_limbs(prev)                  # [..., L, 16]

    mod_b = _table(tables, "level_moduli", dev)[:, None]   # [L, 1] = rou_deg/4
    if ys is None:
        ys = prg.pseudorandom_indices(root2, q, mod_b,
                                      cfg.extension_factor)  # [..., L, q]

    # column branches verify against the proof's own embedded root2
    # (merkle_tree.rs:30-33 trust quirk); each level's walk covers EXACTLY
    # its witness depth (witnesses are per-level lists)
    i4 = torch.arange(4, dtype=torch.int64, device=dev)
    poly_pos = (ys[..., None] + mod_b[..., None] * i4).reshape(
        *ys.shape[:-1], q * 4)
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
    # x1^-1 / x1^-2 come from the master power table by gather
    g2t = _table(tables, "g2_powers", dev)                 # [precision, 16]
    mask = cfg.precision - 1
    lvl_mult = torch.tensor([4 ** l for l in range(cfg.fri_levels)],
                            dtype=torch.int64, device=dev)[:, None]  # [L, 1]
    # int64 index arithmetic: masking with precision-1 (a power of two minus
    # one) gives what the reference's uint32 wrap-around gives
    e1 = (ys * lvl_mult) & mask                            # [..., L, q]
    x1_inv = g2t[(-e1) & mask]
    x1sq_inv = g2t[(-2 * e1) & mask]                       # [..., L, q, 16]

    # canonical interpolated value compared to the RAW column value
    # (main.rs:84-86): a non-canonical committed value can never equal a
    # canonical lhs, exactly like the reference's unreduced BigInt equality.
    # The row kernel speaks the wire's 8-word BE encoding on both ends, so
    # the equality runs directly on the proof's word arrays.
    rows_w = fri["poly_value"].reshape(
        *fri["poly_value"].shape[:-2], q, 4, 8)            # [..., L, q, 4, 8]
    lhs_w = fri_cuda.eval4_rows(x1_inv, x1sq_inv, rows_w, special_x,
                                tables.quartic_ginv, tables.inv4)
    ok_val = (lhs_w == fri["col_value"]).all(dim=-1).all(dim=-1)
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


def verify_mimc_proof(tree, inp, output_limbs, tables, cfg: StarkConfig,
                      constants_limbs=None, shared_merkle: bool = True):
    """Full proof check; mirrors verify_mimc_proof (main.rs:99-197).

    tree: proof tree of int32 word tensors ([..., ...] leading batch dims);
    output_limbs [..., 16] the claimed MiMC output.  inp: a host int (fast
    path: the boundary interpolant folds to host constants) or [..., 16]
    limbs on the tree's device.  constants_limbs: optional [k, 16] RUNTIME
    round constants (k = cfg.num_constants) -- when given, the constants
    mini-polynomial is recovered with an iNTT (main.rs:125) and K(x)
    evaluated by Horner, instead of the statement-static K table.  The
    modulus stays fixed (the limb reduction is specialized to p).  tables:
    StatementTables or a verifier module (whose buffers are used as they
    are).  Returns [...] bool verdicts.
    """
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
    seeds = torch.cat(
        [tree["fri"]["root2"], tree["l_merkle_root"][..., None, :]],
        dim=-2)                                            # [..., L+1, 8]
    entries = prg.chain_entries(seeds, max(nf, ns))        # [..., L+1, n, 8]
    moduli = _table(tables, "level_moduli", dev)           # [L] = rou_deg/4
    ys = prg.indices_from_entries(
        entries[..., :-1, :nf, :], cfg.fri_queries, moduli[:, None],
        cfg.extension_factor)                              # [..., L, q]

    # FRI low-degree proof over the linear-combination tree (main.rs:127)
    checks.append(verify_low_degree_proof(
        tree["l_merkle_root"], tree["fri"], tables, cfg, tree.get("points"),
        shared_merkle, ys=ys))

    # k1..k4 = Blake2s(merkle_root || i), raw 256-bit BE ints
    # (main.rs:131-146) -- the four 33-byte hashes batch into ONE call; the
    # ninth message word holds the single byte i
    mroot = tree["merkle_root"]
    kbytes = torch.arange(1, 5, dtype=torch.int32, device=dev)     # [4]
    kin = torch.cat(
        [mroot[..., None, :].expand(mroot.shape[:-1] + (4, 8)),
         kbytes[:, None].expand(mroot.shape[:-1] + (4, 1))],
        dim=-1)                                            # [..., 4, 9]
    kh = blake2s.hash_words(kin, 33)                       # [..., 4, 8]
    ks4 = F.words_be_to_limbs(kh)                          # [..., 4, 16] raw

    # spot-check positions from l_merkle_root (main.rs:148-156)
    positions = prg.indices_from_entries(
        entries[..., -1, :ns, :], cfg.spot_checks, cfg.precision,
        cfg.extension_factor)                              # [..., 80] int64
    aug = torch.stack(
        [positions, (positions + cfg.skips) % cfg.precision], dim=-1)
    augmented = aug.reshape(*aug.shape[:-2], cfg.spot_checks * 2)  # interleaved

    if shared_merkle:
        checks.extend(merkle.verify_groups_shared([
            _as_shared_group(mroot, augmented, tree["main"]),
            _as_shared_group(tree["l_merkle_root"], positions,
                             tree["lincomb"])]))
    else:
        checks.extend(_verify_groups([
            (mroot, augmented, tree["main"]),
            (tree["l_merkle_root"], positions, tree["lincomb"])]))

    # trace values: 96-byte leaves = P(x) || D(x) || B(x)  (main.rs:163-174)
    mv = tree["main"]["value"]                             # [..., 160, 24]
    mv = mv.reshape(*mv.shape[:-2], cfg.spot_checks, 2, 3, 8)
    p_raw = F.words_be_to_limbs(mv[..., 0, 0, :])          # [..., 80, 16]
    pg1_raw = F.words_be_to_limbs(mv[..., 1, 0, :])
    d_raw = F.words_be_to_limbs(mv[..., 0, 1, :])
    b_raw = F.words_be_to_limbs(mv[..., 0, 2, :])
    l_raw = F.words_be_to_limbs(tree["lincomb"]["value"])

    # x = G2^pos and x^steps = G2^(steps*pos mod precision): gathers from the
    # master power table replace square-and-multiply (main.rs:164-166)
    g2t = _table(tables, "g2_powers", dev)
    mask = cfg.precision - 1
    x = g2t[positions]                                     # [..., 80, 16]
    x_to_steps = g2t[(positions << cfg.log_steps) & mask]

    # Z(x) = (x^steps - 1) / (x - last_step_position)  (main.rs:175-176) and
    # Z2(x) = (x-1)(x-last) (main.rs:185) take one value per domain position:
    # host-precomputed table gathers -- no inversion anywhere
    z = _table(tables, "z_table", dev)[positions]
    z2_at_x = _table(tables, "z2_table", dev)[positions]
    # K(x) = minipoly(x^skips2) takes only k_period distinct values -- table
    # lookup by pos mod period (main.rs:177-178); with runtime constants the
    # minipoly comes from an iNTT instead
    if constants_limbs is None:
        k_of_x = _table(tables, "k_table", dev)[
            positions & (tables.k_period - 1)]
    else:
        if constants_limbs.shape != (cfg.num_constants, fp.NLIMBS):
            raise ValueError(
                f"constants_limbs: shape {tuple(constants_limbs.shape)}, "
                f"family expects {(cfg.num_constants, fp.NLIMBS)}")
        minipoly = ntt.intt(constants_limbs, tables.minipoly_root)  # [k, 16]
        x_sk2 = g2t[(positions * cfg.skips2) & mask]
        k_of_x = F.eval_poly(minipoly, x_sk2)

    # boundary interpolant I(x) coefficients (main.rs:183-187): I(x)
    # interpolates (1, inp), (last, output); host-constant scaffolding, device
    # part only where the output enters (utils.rs:246-274)
    last = tables.last_step_position
    e0 = (1 - last) % m
    e1 = (last - 1) % m
    inv_e = pow(e0 * e1 % m, m - 2, m)
    iy1 = F.mul_mod(output_limbs, F.const(inv_e * e0 % m, dev))    # [..., 16]
    neg_iy1 = F.mul_mod(F.const(m - 1, dev), iy1)
    if isinstance(inp, int):
        # statement-static input: iy0 and its -last*iy0 term fold to host
        iy0 = inp % m * inv_e % m * e1 % m                 # host scalar
        i_c0 = F.add_mod(F.const((-last * iy0) % m, dev), neg_iy1)
        i_c1 = F.add_mod(F.const(iy0, dev), iy1)
    else:
        # runtime input (the reference's library boundary, lib.rs:99): the
        # same algebra on the device
        iy0 = F.mul_mod(inp, F.const(inv_e * e1 % m, dev))  # [..., 16]
        i_c0 = F.add_mod(F.mul_mod(iy0, F.const((-last) % m, dev)), neg_iy1)
        i_c1 = F.add_mod(iy0, iy1)

    # the three constraint families (main.rs:179-192) in one kernel, each
    # right-hand side one multi-term accumulation compared against the
    # canonicalized committed value (ops/spot_cuda.py)
    raw5 = torch.stack([p_raw, pg1_raw, d_raw, b_raw, l_raw], dim=-2)
    tab5 = torch.stack([x, x_to_steps, z, z2_at_x, k_of_x], dim=-2)
    oks = spot_cuda.spot_checks(
        raw5, tab5, ks4[..., None, :, :], i_c1[..., None, :],
        i_c0[..., None, :], power=cfg.power)               # [..., 80, 3]
    checks.append(oks.all(dim=-1).all(dim=-1))

    ok = checks[0]
    for c in checks[1:]:
        ok = ok & c
    return ok


class _FamilyVerifier(nn.Module):
    """What the verifiers of one statement family share.

    The statement tables are registered buffers (g2_powers, z_table,
    z2_table, k_table, points_eval_matrix as int32 limb tensors;
    level_moduli and points_pts as int64), so they are copied to the device
    once and move with .to(); the host constants (quartic_ginv, inv4,
    last_step_position, k_period, minipoly_root) are plain attributes.
    """

    def __init__(self, cfg: StarkConfig, tables: StatementTables,
                 shared_merkle: bool):
        super().__init__()
        if not cfg.sanity_ok():
            raise ValueError("statement fails reference sanity checks")
        self.cfg = cfg
        self.shared_merkle = shared_merkle
        for name in ("g2_powers", "z_table", "z2_table", "k_table",
                     "points_eval_matrix"):
            self.register_buffer(name, to_tensor(getattr(tables, name), "cpu"),
                                 persistent=False)
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
        self.minipoly_root = tables.minipoly_root

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
        super().__init__(cfg, tables, shared_merkle)
        self.inp = inp
        self.chunk = chunk
        self.mimc_output = mimc_ops.mimc_host(
            inp, cfg.num_steps,
            constants=[(i ** 7) ^ 42 for i in range(cfg.num_constants)],
            power=cfg.power)
        self.register_buffer(
            "output_limbs", to_tensor(fp.int_to_limbs(self.mimc_output), "cpu"),
            persistent=False)

    def _verify(self, tree) -> torch.Tensor:
        lead = tree["merkle_root"].shape[:-1]
        output = self.output_limbs.expand(lead + (fp.NLIMBS,))
        return verify_mimc_proof(tree, self.inp, output, self, self.cfg,
                                 shared_merkle=self.shared_merkle)

    def forward(self, tree) -> torch.Tensor:
        self._check_device(tree)
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
    return _make_verifier_cached(cfg or StarkConfig(), inp, shared_merkle,
                                 str(resolve_device(device)))


@functools.lru_cache(maxsize=16)
def _make_verifier_cached(cfg: StarkConfig, inp: int, shared_merkle: bool,
                          device: str):
    tables = cached_tables(cfg)
    return MimcVerifier(cfg, inp, tables, shared_merkle).to(device), tables


def make_chunked_verifier(cfg: StarkConfig | None = None, inp: int = 3,
                          chunk: int = 1024, shared_merkle: bool = True,
                          device=None):
    """Batched verifier that processes the batch in fixed-size chunks (a
    Python loop over [batch/chunk] slices), which bounds the working set of
    the level-parallel FRI check for arbitrarily large batches.  Batch must
    be a multiple of `chunk` (pad with any proof and ignore the verdicts).
    Memoized like make_verifier."""
    return _make_chunked_cached(cfg or StarkConfig(), inp, chunk,
                                shared_merkle, str(resolve_device(device)))


@functools.lru_cache(maxsize=16)
def _make_chunked_cached(cfg: StarkConfig, inp: int, chunk: int,
                         shared_merkle: bool, device: str):
    tables = cached_tables(cfg)
    return (MimcVerifier(cfg, inp, tables, shared_merkle, chunk).to(device),
            tables)


def make_general_verifier(cfg: StarkConfig | None = None,
                          shared_merkle: bool = True, device=None):
    """The library-boundary entry point (reference: src/lib.rs:99): every
    statement parameter except the modulus is a RUNTIME value.

    Returns (module, tables) where
        module(tree, inp_limbs, constants_limbs, output_limbs) -> bool[...]
    (see GeneralMimcVerifier).  The modulus stays fixed: the limb arithmetic
    is specialized to p = 2^256 - 351*2^32 + 1.  Memoized like make_verifier.
    """
    return _make_general_cached(cfg or StarkConfig(), shared_merkle,
                                str(resolve_device(device)))


@functools.lru_cache(maxsize=16)
def _make_general_cached(cfg: StarkConfig, shared_merkle: bool, device: str):
    tables = cached_tables(cfg)
    return (GeneralMimcVerifier(cfg, tables, shared_merkle).to(device),
            tables)
