"""Pure-Python MiMC-STARK prover for synthetic test statements.

The benchmark's frozen copy of the repository's test prover: it makes the
honest proofs the benchmark's traffic is built from.  Changed from the
test copy: the package-relative import of the oracle and the source paths
in this docstring.

The reference repository contains NO prover -- proofs are generated externally
by a modified `mimc_stark` (reference README.md:7-9) and only `proof.bin` is
bundled.  That leaves every end-to-end test pinned to one statement family
(2^13 steps, the (i^7)^42 constants) and one golden byte string.  This module
is the *inverse function* of the verifier: it constructs, from first
principles, a proof that satisfies every check the verifier performs
(oracle.py, derived from the reference verifier's src/main.rs:31-197), serialized
to the exact wire format of the reference's src/deserializer.rs:16-144.

It is test infrastructure (pure Python ints + hashlib), sized for SMALL
statements (e.g. 2^9 steps -> ~1 s); it exists so tests can cover:
  * fresh proofs that are not proof.bin (different inp / steps / constants),
  * the general library API with non-default round constants,
  * strict mode against honestly-generated POINTS (real low-degree data),
  * tamper tests where the corruption site is chosen semantically.

Every construction step cites the verifier check it must satisfy.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import oracle
from .oracle import (
    MODULUS, EXTENSION_FACTOR, blake2s, get_pseudorandom_indices,
    permute_4_index, multi_inv, multi_interp_4, eval_quartic,
    lagrange_interp_2, mul_polys, eval_poly_at, fft_inv, fft_fwd,
    Branch,
)


# ---------------------------------------------------------------------------
# Merkle tree in the verifier's permute-4 layout
# ---------------------------------------------------------------------------

class MerkleTree:
    """Full binary tree over leaves given in QUERY-INDEX order.

    Leaf for query index x sits at tree position permute_4_index(x, L)
    (merkle_tree.rs:112-116); parents are Blake2s(left || right).  Branch
    extraction mirrors oracle.verify_branch exactly: the walk's parity
    source 2^(w+2) + i has the parity of i, which equals the heap-position
    parity at every level (SURVEY 2.2.1).
    """

    def __init__(self, leaves: list):
        L = len(leaves)
        assert L & (L - 1) == 0 and L >= 4
        perm = [b""] * L
        for x in range(L):
            perm[permute_4_index(x, L)] = leaves[x]
        levels = [perm]
        while len(levels[-1]) > 1:
            prev = levels[-1]
            levels.append([blake2s(prev[2 * i] + prev[2 * i + 1])
                           for i in range(len(prev) // 2)])
        self.levels = levels
        self.root = levels[-1][0]

    def branch(self, x: int) -> Branch:
        L = len(self.levels[0])
        i = permute_4_index(x, L)
        value = self.levels[0][i]
        sibling = self.levels[0][i ^ 1]
        wit = [self.levels[t][(i >> t) ^ 1]
               for t in range(1, len(self.levels) - 1)]
        return Branch(value, sibling, wit)


def _b32(x: int) -> bytes:
    return int(x).to_bytes(32, "big")


# ---------------------------------------------------------------------------
# FRI commitment (the prover side of verify_low_degree_proof, main.rs:31-97)
# ---------------------------------------------------------------------------

@dataclass
class FriLevel:
    root2: bytes
    column_branches: list      # [Branch] * queries
    poly_branches: list        # [Branch] * 4*queries (y-major)


def prove_low_degree(values: list, root_of_unity: int, maxdeg_plus_1: int,
                     m: int = MODULUS, exclude: int = EXTENSION_FACTOR,
                     queries: int = 40, tree: "MerkleTree | None" = None) -> tuple:
    """Returns (fri_levels, points) committing that `values` (evaluations over
    the domain generated by root_of_unity) lie on a polynomial of degree
    < maxdeg_plus_1.

    Per level (checked by main.rs:53-92): commit the quartic-fold column at
    special_x = the previous commitment root (raw bytes; the verifier uses it
    unreduced, SURVEY 2.2.5 -- same residue mod p), then open `queries`
    pseudorandom rows.  Terminates with the raw final-layer values (POINTS,
    <= 16 coefficients of remaining degree; parsed then discarded by the
    reference, deserializer.rs:47-59 -- strict mode re-checks them).
    """
    if maxdeg_plus_1 <= 16:
        return [], [_b32(v) for v in values]

    n = len(values)
    # callers that already committed `values` (mk_mimc_proof's ltree) pass
    # the tree in -- rebuilding it would double the dominant hashing cost
    mt = tree if tree is not None else MerkleTree([_b32(v) for v in values])
    # special_x = raw root bytes as a field element (main.rs:54); evaluation
    # below is mod m, so the unreduced verifier value gives the same residue
    special_x = int.from_bytes(mt.root, "big") % m

    quarter = n // 4
    xs = [1] * n
    for i in range(1, n):
        xs[i] = xs[i - 1] * root_of_unity % m
    # row interpolation: the row for column index y has x-coords
    # xs[y + quarter*j] = xs[y] * q_j with q_j the TOP-domain quartic roots --
    # identical at every level since rou_l^quarter_l = G2^(precision/4), which
    # is why the verifier's "stale" quartic roots pass (SURVEY 2.2.5)
    xsets = [xs[i + quarter * j] for i in range(quarter) for j in range(4)]
    ysets = [values[i + quarter * j] for i in range(quarter) for j in range(4)]
    polys = multi_interp_4(xsets, ysets, m)
    column = [eval_quartic(polys[4 * i: 4 * i + 4], special_x, m)
              for i in range(quarter)]

    m2 = MerkleTree([_b32(c) for c in column])
    ys = get_pseudorandom_indices(m2.root, queries, quarter, exclude)
    level = FriLevel(
        root2=m2.root,
        column_branches=[m2.branch(y) for y in ys],
        poly_branches=[mt.branch(y + quarter * j) for y in ys
                       for j in range(4)])

    sub_levels, points = prove_low_degree(
        column, pow(root_of_unity, 4, m), maxdeg_plus_1 // 4, m, exclude,
        queries)
    return [level] + sub_levels, points


# ---------------------------------------------------------------------------
# Top-level proof construction (the prover side of main.rs:99-197)
# ---------------------------------------------------------------------------

@dataclass
class Proof:
    merkle_root: bytes
    l_merkle_root: bytes
    fri_levels: list
    points: list
    main_branches: list        # [Branch] * 2*samples, interleaved [p, p+skips]
    lincomb_branches: list     # [Branch] * samples
    output: int                # claimed MiMC output (for the verifier call)


def mk_mimc_proof(inp: int, steps: int, round_constants: list,
                  m: int = MODULUS, samples: int = 80,
                  fri_queries: int = 40, power: int = 3) -> Proof:
    """Prove knowledge of the trace: steps-1 iterations of
    x <- x^power + k_{i mod nc} from `inp` (utils.rs:8-16; SURVEY 2.2.9).
    power 3 = the reference MiMC AIR; power 2 = models/square.py."""
    assert steps & (steps - 1) == 0
    nc = len(round_constants)
    assert nc & (nc - 1) == 0 and nc <= steps
    precision = steps * EXTENSION_FACTOR
    G2 = pow(7, (m - 1) // precision, m)          # main.rs:114
    skips = EXTENSION_FACTOR
    G1 = pow(G2, skips, m)

    xs = [1] * precision
    for i in range(1, precision):
        xs[i] = xs[i - 1] * G2 % m
    last = xs[(steps - 1) * skips]                # last_step_position

    # trace + claimed output (steps-1 iterations, SURVEY 2.2.9)
    trace = [inp % m]
    for i in range(steps - 1):
        trace.append((trace[-1] ** power + round_constants[i % nc]) % m)
    output = trace[-1]

    # P: interpolate the trace over the G1 domain, extend to the G2 domain
    p_poly = fft_inv(trace, G1, m)
    p_evals = fft_fwd(p_poly + [0] * (precision - steps), G2, m)

    # K(x): constants mini-polynomial (main.rs:123-125) extended over the
    # x^skips2 domain; k_ext[i mod period] == minipoly(x_i^skips2)
    skips2 = steps // nc
    minipoly = fft_inv(round_constants, pow(G2, skips * skips2, m), m)
    kdom = precision // skips2
    k_ext = fft_fwd(minipoly + [0] * (kdom - nc), pow(G2, skips2, m), m)

    # D = (P(g1 x) - P(x)^3 - K(x)) / Z,  Z = (x^steps - 1)/(x - last):
    # defined pointwise off the trace positions; spot-check positions exclude
    # multiples of the extension factor so the x^steps = 1 points never face
    # the transition check (main.rs:149,163-182)
    c_evals = [(p_evals[(i + skips) % precision] - pow(p_evals[i], power, m)
                - k_ext[i % kdom]) % m for i in range(precision)]
    z_num_inv = multi_inv([(xs[(i * steps) % precision] - 1) % m
                           for i in range(precision)], m)
    d_evals = [c_evals[i] * (xs[i] - last) % m * z_num_inv[i] % m
               for i in range(precision)]

    # B = (P - I) / Z2 with I through (1, inp), (last, output) (main.rs:183-187)
    interpolant = lagrange_interp_2([1, last], [inp % m, output], m)
    zeropoly2 = mul_polys([-1, 1], [-last, 1], m)
    z2_inv = multi_inv([eval_poly_at(zeropoly2, x, m) for x in xs], m)
    b_evals = [(p_evals[i] - eval_poly_at(interpolant, xs[i], m))
               * z2_inv[i] % m for i in range(precision)]

    # main commitment: 96-byte leaves P || D || B (main.rs:171-174)
    mtree = MerkleTree([_b32(p) + _b32(d) + _b32(b)
                        for p, d, b in zip(p_evals, d_evals, b_evals)])

    # linear combination with k1..k4 = Blake2s(root || i) raw 256-bit ints,
    # NOT reduced (main.rs:131-146; SURVEY 2.2.3) -- reduction inside the
    # evaluation is homomorphic, the verifier's algebra is mod p
    k1, k2, k3, k4 = (int.from_bytes(blake2s(mtree.root + bytes([i])), "big")
                      for i in (1, 2, 3, 4))
    g2s = pow(G2, steps, m)
    pw = 1
    l_evals = []
    for i in range(precision):
        l_evals.append((d_evals[i] + k1 * p_evals[i] + k2 * p_evals[i] * pw
                        + k3 * b_evals[i] + k4 * b_evals[i] * pw) % m)
        pw = pw * g2s % m
    ltree = MerkleTree([_b32(v) for v in l_evals])

    # spot-check openings (main.rs:148-159): positions from l_root over the
    # full domain, main branches interleaved [pos, pos+skips]
    positions = get_pseudorandom_indices(ltree.root, samples, precision,
                                         EXTENSION_FACTOR)
    main_branches = []
    for pos in positions:
        main_branches.append(mtree.branch(pos))
        main_branches.append(mtree.branch((pos + skips) % precision))
    lincomb_branches = [ltree.branch(pos) for pos in positions]

    fri_levels, points = prove_low_degree(l_evals, G2, steps * 2, m,
                                          EXTENSION_FACTOR, fri_queries,
                                          tree=ltree)
    return Proof(mtree.root, ltree.root, fri_levels, points,
                 main_branches, lincomb_branches, output)


# ---------------------------------------------------------------------------
# Wire serialization (inverse of src/deserializer.rs:16-144)
# ---------------------------------------------------------------------------

def _ser_multiproof(branches: list) -> bytes:
    out = [len(branches).to_bytes(4, "little")]
    for br in branches:
        out.append(len(br.value).to_bytes(4, "little"))
        out.append(br.value)
        out.append(br.sibling_value)
        out.append((32 * len(br.witnesses)).to_bytes(4, "little"))
        out.extend(br.witnesses)
    return b"".join(out)


def serialize_proof(p: Proof) -> bytes:
    out = [p.merkle_root, p.l_merkle_root]
    for lvl in p.fri_levels:
        out.append((1).to_bytes(4, "little"))            # tag MERKLE
        out.append(lvl.root2)
        out.append(_ser_multiproof(lvl.column_branches))
        out.append(_ser_multiproof(lvl.poly_branches))
    out.append((2).to_bytes(4, "little"))                # tag POINTS
    out.append((32 * len(p.points)).to_bytes(4, "little"))
    out.extend(p.points)
    out.append(_ser_multiproof(p.main_branches))
    out.append(_ser_multiproof(p.lincomb_branches))
    return b"".join(out)


def prove_to_bytes(inp: int, steps: int, round_constants: list,
                   m: int = MODULUS, power: int = 3) -> tuple:
    """Convenience: (wire bytes, claimed output)."""
    p = mk_mimc_proof(inp, steps, round_constants, m, power=power)
    return serialize_proof(p), p.output
