"""Pure-Python ground-truth oracle for the MiMC-STARK verifier.

The benchmark's frozen copy of the repository's test oracle: it decides
every verdict the benchmark compares, so later changes to the test copy do
not move the yardstick.  Left out of the copy: the helper that built test
tables with the JAX package (this copy imports nothing but the standard
library).

This is an independent re-implementation of the reference verifier's observable
semantics (jwasinger/stark-verifier: src/{main,utils,merkle_tree,fft,deserializer}.rs),
written directly from the protocol spec in SURVEY.md. It is THE source of golden
values for every kernel- and protocol-level test of the TPU framework: roots,
Fiat-Shamir indices, k-coefficients, per-level FRI column values, and the final
accept/reject verdict.

It uses only `int` + `hashlib.blake2s`, mathematical mod arithmetic throughout
(which reproduces the reference's negative_to_positive / Rust `%` behavior at
every call site -- see SURVEY.md section 2.2 for the case analysis).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

MODULUS = 2**256 - 351 * 2**32 + 1
EXTENSION_FACTOR = 8


def blake2s(data: bytes) -> bytes:
    return hashlib.blake2s(data).digest()


# ---------------------------------------------------------------------------
# Wire format (reference: src/deserializer.rs:16-144)
# ---------------------------------------------------------------------------

@dataclass
class Branch:
    value: bytes
    sibling_value: bytes
    witnesses: list[bytes]  # each 32 bytes


@dataclass
class MultiProof:
    branches: list[Branch]
    root: bytes = b"\x00" * 32  # embedded root (only set for FRI column trees)


@dataclass
class LDPMerkleProof:
    root2: bytes
    column_branches: MultiProof
    poly_branches: MultiProof


@dataclass
class StarkProof:
    merkle_root: bytes
    l_merkle_root: bytes
    fri_levels: list[LDPMerkleProof]
    points: list[bytes] = field(default_factory=list)  # parsed, ignored by verify
    merkle_branches: MultiProof = None
    linear_comb_branches: MultiProof = None


def _read_u32le(b: bytes, off: int) -> tuple[int, int]:
    return int.from_bytes(b[off:off + 4], "little"), off + 4


def parse_multiproof(b: bytes, off: int) -> tuple[MultiProof, int]:
    n, off = _read_u32le(b, off)
    branches = []
    for _ in range(n):
        vsize, off = _read_u32le(b, off)
        value = b[off:off + vsize]; off += vsize
        sibling = b[off:off + vsize]; off += vsize
        wsize, off = _read_u32le(b, off)
        assert wsize % 32 == 0, "witnesses should all be 32 bytes"
        witnesses = [b[off + 32 * i: off + 32 * (i + 1)] for i in range(wsize // 32)]
        off += wsize
        branches.append(Branch(value, sibling, witnesses))
    return MultiProof(branches), off


def parse_proof(b: bytes) -> tuple[StarkProof, int]:
    off = 0
    merkle_root = b[0:32]
    l_merkle_root = b[32:64]
    off = 64
    fri_levels: list[LDPMerkleProof] = []
    points: list[bytes] = []
    while True:
        tag, off = _read_u32le(b, off)
        if tag == 1:  # MERKLE
            root2 = b[off:off + 32]; off += 32
            col, off = parse_multiproof(b, off)
            col.root = root2
            poly, off = parse_multiproof(b, off)
            fri_levels.append(LDPMerkleProof(root2, col, poly))
        elif tag == 2:  # POINTS -- terminates FRI element loop
            psize, off = _read_u32le(b, off)
            assert psize > 0 and psize % 32 == 0
            points = [b[off + 32 * i: off + 32 * (i + 1)] for i in range(psize // 32)]
            off += psize
            break
        else:
            raise ValueError(f"invalid proof element type {tag}")
    merkle_branches, off = parse_multiproof(b, off)
    linear_comb_branches, off = parse_multiproof(b, off)
    return StarkProof(merkle_root, l_merkle_root, fri_levels, points,
                      merkle_branches, linear_comb_branches), off


# ---------------------------------------------------------------------------
# Fiat-Shamir index PRG (reference: src/utils.rs:53-94)
# ---------------------------------------------------------------------------

def get_pseudorandom_indices(seed: bytes, count: int, modulus: int,
                             exclude_multiples_of: int | None = None) -> list[int]:
    real_modulus = modulus
    if exclude_multiples_of is not None:
        real_modulus = modulus * (exclude_multiples_of - 1) // exclude_multiples_of
    hashes = bytearray(seed)  # seed is used raw, not hashed first
    while len(hashes) < 4 * count:
        hashes.extend(blake2s(bytes(hashes[-32:])))
    out = []
    for j in range(0, count * 4, 4):
        x = int.from_bytes(hashes[j:j + 4], "big") % real_modulus
        out.append(x)
    if exclude_multiples_of is not None:
        e = exclude_multiples_of
        out = [1 + x + (x // (e - 1)) for x in out]
    return out


# ---------------------------------------------------------------------------
# Merkle branch verification (reference: src/merkle_tree.rs:101-172)
# ---------------------------------------------------------------------------

def permute_4_index(x: int, L: int) -> int:
    ld4 = L // 4
    return (x // ld4) + 4 * (x % ld4)


def branch_root(index: int, br: Branch) -> bytes:
    """The root a branch walk terminates at (verify_branch without the
    assert) -- used by tests to construct valid synthetic branches."""
    w = len(br.witnesses)
    idx = permute_4_index(index, 2 ** (w + 1))
    tree_index = 2 ** (w + 2) + idx
    if tree_index % 2 != 0:
        res = blake2s(br.sibling_value + br.value)
    else:
        res = blake2s(br.value + br.sibling_value)
    tree_index //= 2
    for witness in br.witnesses:
        if tree_index % 2 != 0:
            res = blake2s(witness + res)
        else:
            res = blake2s(res + witness)
        tree_index //= 2
    return res


def verify_branch(root: bytes, index: int, br: Branch) -> bytes:
    w = len(br.witnesses)
    idx = permute_4_index(index, 2 ** (w + 1))
    tree_index = 2 ** (w + 2) + idx
    if tree_index % 2 != 0:
        res = blake2s(br.sibling_value + br.value)
    else:
        res = blake2s(br.value + br.sibling_value)
    tree_index //= 2
    for witness in br.witnesses:
        if tree_index % 2 != 0:
            res = blake2s(witness + res)
        else:
            res = blake2s(res + witness)
        tree_index //= 2
    if res != root:
        raise AssertionError("merkle branch does not match root")
    return br.value


def verify_multiproof(mp: MultiProof, indices: list[int],
                      root: bytes | None = None) -> list[bytes]:
    assert len(mp.branches) == len(indices), "branches len != indices len"
    r = root if root is not None else mp.root
    return [verify_branch(r, i, br) for br, i in zip(mp.branches, indices)]


# ---------------------------------------------------------------------------
# Field / polynomial helpers (reference: src/utils.rs, src/fft.rs)
# ---------------------------------------------------------------------------

def inv(x: int, m: int = MODULUS) -> int:
    x %= m
    if x == 0:
        return 0
    return pow(x, m - 2, m)


def multi_inv(values: list[int], m: int = MODULUS) -> list[int]:
    partials = [1]
    for v in values:
        partials.append(partials[-1] * (v if v != 0 else 1) % m)
    invp = inv(partials[-1], m)
    out = [0] * len(values)
    for i in range(len(values), 0, -1):
        if values[i - 1] == 0:
            out[i - 1] = 0
        else:
            out[i - 1] = partials[i - 1] * invp % m
            invp = invp * values[i - 1] % m
    return out


def eval_quartic(eq, x: int, m: int = MODULUS) -> int:
    xsq = x * x % m
    xcb = x * xsq
    return (eq[0] + eq[1] * x + eq[2] * xsq + eq[3] * xcb) % m


def multi_interp_4(xsets: list[int], ysets: list[int], m: int = MODULUS) -> list[int]:
    """Batched 4-point Lagrange interpolation (reference: src/utils.rs:196-244)."""
    assert len(xsets) == len(ysets)
    data = []
    inv_targets = []
    for i in range(0, len(xsets), 4):
        x0, x1, x2, x3 = xsets[i:i + 4]
        x01, x02, x03 = x0 * x1, x0 * x2, x0 * x3
        x12, x13, x23 = x1 * x2, x1 * x3, x2 * x3
        eq0 = [(-(x12 * x3)) % m, x12 + x13 + x23, -x1 - x2 - x3, 1]
        eq1 = [(-(x02 * x3)) % m, x02 + x03 + x23, -x0 - x2 - x3, 1]
        eq2 = [(-(x01 * x3)) % m, x01 + x03 + x13, -x0 - x1 - x3, 1]
        eq3 = [(-(x01 * x2)) % m, x01 + x02 + x12, -x0 - x1 - x2, 1]
        e0 = eval_quartic(eq0, x0, m)
        e1 = eval_quartic(eq1, x1, m)
        e2 = eval_quartic(eq2, x2, m)
        e3 = eval_quartic(eq3, x3, m)
        data.append((ysets[i:i + 4], [eq0, eq1, eq2, eq3]))
        inv_targets += [e0, e1, e2, e3]
    inv_vals = multi_inv(inv_targets, m)
    output = []
    for i, (ys, eqs) in enumerate(data):
        iy = [ys[j] * inv_vals[i * 4 + j] % m for j in range(4)]
        for j in range(4):
            output.append(sum(eqs[k][j] * iy[k] for k in range(4)) % m)
    return output


def eval_poly_at(poly: list[int], x: int, m: int = MODULUS) -> int:
    y, pw = 0, 1
    for c in poly:
        y += pw * c
        pw = pw * x % m
    return y % m


def mul_polys(p0: list[int], p1: list[int], m: int = MODULUS) -> list[int]:
    out = [0] * (len(p0) + len(p1) - 1)
    for i, a in enumerate(p0):
        for j, b in enumerate(p1):
            out[i + j] += a * b
    return [c % m for c in out]


def lagrange_interp_2(xs, ys, m: int = MODULUS):
    eq0 = [(-xs[1]) % m, 1]
    eq1 = [(-xs[0]) % m, 1]
    e0 = eval_poly_at(eq0, xs[0], m)
    e1 = eval_poly_at(eq1, xs[1], m)
    inv_val = inv(e0 * e1, m)
    iy0 = ys[0] * inv_val * e1
    iy1 = ys[1] * inv_val * e0
    return [(eq0[0] * iy0 + eq1[0] * iy1) % m, (eq0[1] * iy0 + eq1[1] * iy1) % m]


def simple_ft(vals, roots, m):
    n = len(roots)
    return [sum(vals[j] * roots[(i * j) % n] for j in range(n)) % m
            for i in range(n)]


def _fft(v, roots, m):
    if len(v) <= 4:
        return simple_ft(v, roots, m)
    left = _fft(v[::2], roots[::2], m)
    right = _fft(v[1::2], roots[::2], m)
    out = [0] * len(v)
    for i, (x, y) in enumerate(zip(left, right)):
        yr = y * roots[i]
        out[i] = (x + yr) % m
        out[i + len(left)] = (x - yr) % m
    return out


def fft_inv(v: list[int], root_of_unity: int, m: int = MODULUS) -> list[int]:
    """Inverse NTT (reference: src/fft.rs:64-86)."""
    roots = [1, root_of_unity % m]
    while roots[-1] != 1:
        roots.append(roots[-1] * root_of_unity % m)
    if len(roots) > len(v):
        roots += [0] * (len(roots) - len(v) - 1)
    roots.reverse()
    roots.pop()
    invlen = pow(len(v), m - 2, m)
    return [x * invlen % m for x in _fft(v, roots, m)]


def fft_fwd(v: list[int], root_of_unity: int, m: int = MODULUS) -> list[int]:
    """Forward NTT using the same recursion (for standalone-NTT parity tests)."""
    roots = [1, root_of_unity % m]
    while roots[-1] != 1:
        roots.append(roots[-1] * root_of_unity % m)
    roots.pop()
    return _fft(v, roots, m)


def mimc(inp: int, steps: int, round_constants: list[int], m: int = MODULUS,
         power: int = 3) -> int:
    """MiMC permutation; note the reference runs steps-1 iterations
    (utils.rs:11).  power 2 = the square family (models/square.py)."""
    out = inp
    n = len(round_constants)
    for i in range(steps - 1):
        out = (out ** power + round_constants[i % n]) % m
    return out


def mimc_round_constants() -> list[int]:
    # BigInt pow then bitwise XOR (reference: src/main.rs:209-212)
    return [(i ** 7) ^ 42 for i in range(64)]


# ---------------------------------------------------------------------------
# FRI low-degree proof (reference: src/main.rs:31-97)
# ---------------------------------------------------------------------------

def verify_low_degree_proof(merkle_root: bytes, root_of_unity: int, fri_levels,
                            max_deg_plus_1: int, m: int = MODULUS,
                            exclude: int | None = None,
                            trace: dict | None = None,
                            parity_guards: bool = True) -> bool:
    test_val = root_of_unity
    rou_deg = 1
    root = merkle_root
    while test_val != 1:
        rou_deg *= 2
        test_val = test_val * test_val % m

    quartic_rous = [1,
                    pow(root_of_unity, rou_deg // 4, m),
                    pow(root_of_unity, rou_deg // 2, m),
                    pow(root_of_unity, rou_deg * 3 // 4, m)]
    if parity_guards:
        # literal guard pinning the reference to the bundled proof's shape
        # (main.rs:50; SURVEY 2.2.7) -- relaxed for synthetic statement
        # families generated by tests/prover.py
        assert rou_deg == 65536, "invalid roudeg"

    if trace is not None:
        trace["fri_levels"] = []

    for lvl, mp in enumerate(fri_levels):
        special_x = int.from_bytes(root, "big")  # raw root bytes as field elt, unreduced
        ys = get_pseudorandom_indices(mp.root2, 40, rou_deg // 4, exclude)
        column_values = verify_multiproof(mp.column_branches, ys)  # embedded root
        poly_positions = [y + (rou_deg // 4) * i for y in ys for i in range(4)]
        poly_values = verify_multiproof(mp.poly_branches, poly_positions, root)

        xcoords, rows = [], []
        for i, y in enumerate(ys):
            x1 = pow(root_of_unity, y, m)
            for j in range(4):
                xcoords.append(quartic_rous[j] * x1 % m)
                rows.append(int.from_bytes(poly_values[i * 4 + j], "big"))

        polys = multi_interp_4(xcoords, rows, m)

        for g in range(40):
            c = int.from_bytes(column_values[g], "big")
            lhs = eval_quartic(polys[4 * g: 4 * g + 4], special_x, m)
            # NOTE: c compared UNREDUCED (reference main.rs:85); lhs is in [0, p).
            if lhs != c:
                raise AssertionError("low degree test failed")

        if trace is not None:
            trace["fri_levels"].append({
                "special_x": special_x,
                "ys": ys,
                "column_values": [int.from_bytes(c, "big") for c in column_values],
                "poly_positions": poly_positions,
                "rows": rows,
                "xcoords": xcoords,
                "polys": polys,
            })

        root_of_unity = pow(root_of_unity, 4, m)
        rou_deg //= 4
        root = mp.root2
    # NOTE: direct check of the final POINTS element is skipped by the reference
    # (main.rs:94 TODO); parity mode preserves this.
    return True


# ---------------------------------------------------------------------------
# Top-level verifier (reference: src/main.rs:99-197)
# ---------------------------------------------------------------------------

def verify_mimc_proof(inp: int, num_steps: int, round_constants: list[int],
                      output: int, proof: StarkProof, m: int = MODULUS,
                      trace: dict | None = None,
                      parity_guards: bool = True, power: int = 3) -> bool:
    if num_steps > 2**32 // EXTENSION_FACTOR:
        return False
    def is_pow2(n):
        return n != 0 and (n & (n - 1)) == 0
    if not is_pow2(num_steps) or not is_pow2(len(round_constants)):
        return False
    if len(round_constants) > num_steps:
        return False

    precision = num_steps * EXTENSION_FACTOR
    G2 = pow(7, (m - 1) // precision, m)
    skips = precision // num_steps
    skips2 = num_steps // len(round_constants)
    val = pow(G2, EXTENSION_FACTOR * skips2, m)
    if parity_guards:
        # literal guard (main.rs:120; SURVEY 2.2.7) -- relaxed for synthetic
        # statement families generated by tests/prover.py
        assert num_steps == 8192

    minipoly = fft_inv(round_constants, val, m)

    if not verify_low_degree_proof(proof.l_merkle_root, G2, proof.fri_levels,
                                   num_steps * 2, m, EXTENSION_FACTOR, trace,
                                   parity_guards=parity_guards):
        return False

    ks = [int.from_bytes(blake2s(proof.merkle_root + bytes([i])), "big")
          for i in (1, 2, 3, 4)]
    k1, k2, k3, k4 = ks

    positions = get_pseudorandom_indices(proof.l_merkle_root, 80, precision,
                                         EXTENSION_FACTOR)
    augmented = []
    for p_ in positions:
        augmented.append(p_)
        augmented.append((p_ + skips) % precision)

    values = verify_multiproof(proof.merkle_branches, augmented, proof.merkle_root)
    lin_values = verify_multiproof(proof.linear_comb_branches, positions,
                                   proof.l_merkle_root)

    last_step_position = pow(G2, (num_steps - 1) * skips, m)

    interpolant = lagrange_interp_2([1, last_step_position], [inp, output], m)
    zeropoly2 = mul_polys([-1, 1], [-last_step_position, 1], m)

    if trace is not None:
        trace.update({
            "G2": G2, "minipoly": minipoly, "k": ks, "positions": positions,
            "augmented": augmented, "last_step_position": last_step_position,
            "interpolant": interpolant, "zeropoly2": zeropoly2,
            "p_of_x": [], "d_of_x": [], "b_of_x": [], "l_of_x": [],
            "x": [], "z": [], "k_of_x": [],
        })

    for i, pos in enumerate(positions):
        x = pow(G2, pos, m)
        x_to_steps = pow(x, num_steps, m)
        p_of_x = int.from_bytes(values[2 * i][0:32], "big")
        p_of_g1x = int.from_bytes(values[2 * i + 1][0:32], "big")
        d_of_x = int.from_bytes(values[2 * i][32:64], "big")
        b_of_x = int.from_bytes(values[2 * i][64:96], "big")
        l_of_x = int.from_bytes(lin_values[i], "big")

        z = (x_to_steps - 1) * inv((x - last_step_position) % m, m) % m
        k_of_x = eval_poly_at(minipoly, pow(x, skips2, m), m)

        if (p_of_g1x - p_of_x**power - k_of_x - z * d_of_x) % m != 0:
            raise AssertionError("transition constraints check failed")
        if (p_of_x - b_of_x * eval_poly_at(zeropoly2, x, m)
                - eval_poly_at(interpolant, x, m)) % m != 0:
            raise AssertionError("boundary constraints check failed")
        if (l_of_x - d_of_x - k1 * p_of_x - k2 * p_of_x * x_to_steps
                - k3 * b_of_x - k4 * b_of_x * x_to_steps) % m != 0:
            raise AssertionError("invalid linear combination")

        if trace is not None:
            trace["p_of_x"].append(p_of_x)
            trace["d_of_x"].append(d_of_x)
            trace["b_of_x"].append(b_of_x)
            trace["l_of_x"].append(l_of_x)
            trace["x"].append(x)
            trace["z"].append(z)
            trace["k_of_x"].append(k_of_x)

    return True


def verify_proof_bytes(proof_bytes: bytes, inp: int = 3, log_steps: int = 13,
                       trace: dict | None = None) -> bool:
    """End-to-end: parse + recompute MiMC output + verify. Maps failures to False."""
    constants = mimc_round_constants()
    num_steps = 2 ** log_steps
    output = mimc(inp, num_steps, constants)
    try:
        proof, _ = parse_proof(proof_bytes)
        return verify_mimc_proof(inp, num_steps, constants, output, proof,
                                 MODULUS, trace)
    except (AssertionError, ValueError, IndexError):
        return False
