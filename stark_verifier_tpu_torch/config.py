"""Typed configuration for a STARK statement family.

The reference verifier hardcodes every parameter (src/main.rs:28-29,113-123,
205: modulus, extension factor 8, 2^13 steps, 64 round constants, 80 spot
checks, 40 FRI queries).  Here the same quantities live in one dataclass whose
defaults reproduce the reference exactly; derived tables (the G2 power table,
the Z / Z2 / K gather tables, the FRI level moduli) are precomputed host-side
once per statement family and reused across batches.

This is the port's own copy of the JAX package's config module (the two
packages share no code); tables_from_reference() carries tables that were
computed elsewhere across as plain numpy arrays.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np

from . import fp


@dataclass(frozen=True)
class StarkConfig:
    modulus: int = fp.MODULUS
    extension_factor: int = fp.EXTENSION_FACTOR
    log_steps: int = 13
    num_constants: int = 64
    spot_checks: int = 80          # reference: src/main.rs:148
    fri_queries: int = 40          # reference: src/main.rs:56
    strict: bool = False           # False = bit-exact parity with the
                                   # reference's soundness gaps; True also
                                   # binds and checks the POINTS element and
                                   # rejects trailing bytes
    power: int = 3                 # transition x <- x^power + k_i: 3 is the
                                   # reference's MiMC family (utils.rs:12)

    def __post_init__(self):
        # pinned until a test varies it: every table and index formula below
        # was only ever exercised at 8
        if self.extension_factor != 8:
            raise ValueError("only extension_factor == 8 is supported")

    @property
    def num_steps(self) -> int:
        return 1 << self.log_steps

    @property
    def precision(self) -> int:
        return self.num_steps * self.extension_factor

    @property
    def skips(self) -> int:
        return self.precision // self.num_steps

    @property
    def skips2(self) -> int:
        return self.num_steps // self.num_constants

    @property
    def fri_levels(self) -> int:
        # the prover folds by 4 until degree <= 16: log4(num_steps*2/16)
        n, lv = self.num_steps * 2, 0
        while n > 16:
            n //= 4
            lv += 1
        return lv

    @property
    def fri_final_maxdeg_plus_1(self) -> int:
        """max_deg_plus_1 after all FRI folds (the reference threads this but
        never checks it -- src/main.rs:31,89; the strict-mode direct check
        makes it load-bearing)."""
        return (self.num_steps * 2) >> (2 * self.fri_levels)

    @property
    def fri_final_domain(self) -> int:
        """Evaluation-domain size of the final (POINTS) layer."""
        return self.precision >> (2 * self.fri_levels)

    def sanity_ok(self, num_constants: int | None = None) -> bool:
        """The reference's input prechecks (src/main.rs:101-111) -- the only
        failures that return false rather than panic."""
        nc = self.num_constants if num_constants is None else num_constants

        def pow2(x):
            return x != 0 and (x & (x - 1)) == 0
        return (self.num_steps <= 2**32 // self.extension_factor
                and pow2(self.num_steps) and pow2(nc)
                and nc <= self.num_steps
                and self.power in (2, 3))


class StatementTables:
    """Host-precomputed constants for one statement family (shared by every
    proof in a batch; all pure functions of StarkConfig)."""

    def __init__(self, cfg: StarkConfig):
        self.cfg = cfg
        m = cfg.modulus
        self.G2 = pow(7, (m - 1) // cfg.precision, m)   # main.rs:114
        # PRG modulus rou_deg/4 per FRI level (main.rs:56,73-80,88); all
        # exponent arithmetic rides the master g2_powers gather table below
        self.level_moduli = []
        rd = cfg.precision
        for _ in range(cfg.fri_levels):
            self.level_moduli.append(rd // 4)
            rd //= 4
        self.level_moduli_np = np.array(self.level_moduli, dtype=np.uint32)
        # even/odd-split FRI row evaluation constants (ops/quartic.py): the
        # row nodes are x1 * q_i with quartic roots q_i computed ONCE from the
        # top-level domain and (faithfully to the reference) stale for later
        # levels (main.rs:43-48); g^{-1} = g^3 since g^4 = 1, plus 4^{-1}
        self.quartic_ginv = fp.int_to_limbs(
            pow(self.G2, cfg.precision * 3 // 4, m))
        self.inv4 = fp.int_to_limbs(pow(4, m - 2, m))
        self.last_step_position = pow(self.G2, (cfg.num_steps - 1) * cfg.skips, m)
        # constants mini-polynomial domain root: G2^(ext*skips2) (main.rs:124)
        self.minipoly_root = pow(self.G2, cfg.extension_factor * cfg.skips2, m)

        # master power table: G2 generates the whole evaluation domain, so
        # every exponentiation in the protocol is G2^(e mod precision) -- one
        # gather instead of a square-and-multiply chain
        g2_int = self._powers_int(self.G2, cfg.precision)
        self.g2_powers = fp.ints_to_limbs_fast(g2_int)
        # K(x) = minipoly(x^skips2): x^skips2 = G2^(skips2*pos mod precision)
        # has order precision/skips2, so K takes that many distinct values,
        # row t being minipoly(k_root^t): the k_period-point transform of the
        # zero-padded minipoly with root k_root = G2^skips2
        self.k_period = cfg.precision // math.gcd(cfg.precision, cfg.skips2)
        self.k_root = k_root(cfg)
        minipoly = self._intt_host(
            [(i ** 7) ^ 42 for i in range(cfg.num_constants)],
            self.minipoly_root)
        self.k_table = fp.ints_to_limbs_fast(_dft_host(
            minipoly + [0] * (self.k_period - len(minipoly)), self.k_root, m))

        # Z(x) = (x^steps - 1)/(x - last) and Z2(x) = (x-1)(x-last) take one
        # value per domain position x = G2^pos (main.rs:175-176,183-185):
        # precomputing them turns the spot-check divisions into gathers, so
        # the verifier runs no field inversion at all
        mask = cfg.precision - 1
        last = self.last_step_position
        denoms = [(x - last) % m for x in g2_int]
        inv_den = _batch_inv_host(denoms, m)
        self.z_table = fp.ints_to_limbs_fast(
            [(g2_int[(j << cfg.log_steps) & mask] - 1) * inv_den[j] % m
             for j in range(cfg.precision)])
        self.z2_table = fp.ints_to_limbs_fast(
            [(g2_int[j] - 1) * denoms[j] % m for j in range(cfg.precision)])

        # Strict-mode direct low-degree check of the final FRI (POINTS) layer
        # (the TODO the reference leaves open, src/main.rs:94): upstream
        # mimc_stark interpolates the first max_deg_plus_1 positions NOT
        # divisible by extension_factor and re-evaluates the remaining ones.
        # The interpolation nodes are powers of the final-domain root (host
        # constants), so the whole check collapses to one precomputed
        # evaluation matrix: data[pts[k+D]] ?= sum_i M[k, i] * data[pts[i]].
        nd = cfg.fri_final_domain
        deg = cfg.fri_final_maxdeg_plus_1
        rou_last = pow(self.G2, 4 ** cfg.fri_levels, m)
        self.points_pts = np.array(
            [x for x in range(nd) if x % cfg.extension_factor], dtype=np.int64)
        pts = self.points_pts
        if len(pts) <= deg:
            raise ValueError("no held-out positions for the direct check")
        powl = [pow(rou_last, int(x), m) for x in range(nd)]
        nodes = [powl[int(x)] for x in pts[:deg]]
        # Lagrange basis at each held-out target: numerator over all nodes
        # divided by (t - n_i) and by the denominator prod_{k != i}(n_i - n_k)
        dens = [1] * deg
        for i in range(deg):
            for k in range(deg):
                if k != i:
                    dens[i] = dens[i] * (nodes[i] - nodes[k]) % m
        targets = [powl[int(x)] for x in pts[deg:]]
        diffs = [(t - n) % m for t in targets for n in nodes]
        inv_all = _batch_inv_host([d % m for d in dens] + diffs, m)
        inv_dens, inv_diffs = inv_all[:deg], inv_all[deg:]
        mat = []
        for j, t in enumerate(targets):
            nfull = 1
            for n in nodes:
                nfull = nfull * (t - n) % m
            mat.append([nfull * inv_diffs[j * deg + i] % m * inv_dens[i] % m
                        for i in range(deg)])
        self.points_eval_matrix = np.stack(
            [fp.ints_to_limbs_fast(row) for row in mat])   # [nd-nd/8-deg, deg, 16]

    def _powers_int(self, base: int, n: int) -> list:
        m = self.cfg.modulus
        vals = [1] * n
        cur = 1
        for i in range(1, n):
            cur = cur * base % m
            vals[i] = cur
        return vals

    def _intt_host(self, vals: list, root: int) -> list:
        """Host inverse NTT matching the reference recursion (fft.rs:64-86)."""
        m = self.cfg.modulus
        inv_len = pow(len(vals), m - 2, m)
        return [x * inv_len % m
                for x in _dft_host(vals, pow(root, m - 2, m), m)]


def k_root(cfg: StarkConfig) -> int:
    """G2^skips2, the root of the K table's transform: K(x) at x = G2^pos
    is row pos mod k_period of the table."""
    m = cfg.modulus
    return pow(pow(7, (m - 1) // cfg.precision, m), cfg.skips2, m)


def _dft_host(vals: list, root: int, m: int) -> list:
    """out[i] = sum_j vals[j] root^(i j) mod m for i < len(vals), root of
    order len(vals) (a power of two): the reference's even/odd recursion
    (fft.rs:37-62) on host ints, O(n log n)."""

    def _fft(v, roots):
        if len(v) <= 4:
            n = len(roots)
            return [sum(v[j] * roots[(i * j) % n] for j in range(n)) % m
                    for i in range(n)]
        left = _fft(v[::2], roots[::2])
        right = _fft(v[1::2], roots[::2])
        out = [0] * len(v)
        for i, (a, b) in enumerate(zip(left, right)):
            br = b * roots[i]
            out[i] = (a + br) % m
            out[i + len(left)] = (a - br) % m
        return out

    roots = [1] * len(vals)
    for i in range(1, len(vals)):
        roots[i] = roots[i - 1] * root % m
    return _fft(vals, roots)


def _batch_inv_host(vals: list, m: int) -> list:
    """Montgomery-trick batch inversion over host ints; zeros map to 0
    (matching the reference's inv, src/utils.rs:139-167)."""
    n = len(vals)
    pre = [1] * (n + 1)
    for i, v in enumerate(vals):
        pre[i + 1] = pre[i] * (v if v else 1) % m
    inv_total = pow(pre[n], m - 2, m)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        v = vals[i]
        if v:
            out[i] = pre[i] * inv_total % m
            inv_total = inv_total * v % m
    return out


@functools.lru_cache(maxsize=8)
def cached_tables(cfg: StarkConfig) -> StatementTables:
    """Memoized table construction (the 2^16-entry batch inversion and power
    table of the default family cost seconds of host time)."""
    return StatementTables(cfg)


def default_tables() -> StatementTables:
    """The tables of the default statement family, StarkConfig()."""
    return cached_tables(StarkConfig())


# the array-valued and scalar fields tables_from_reference() expects
_TABLE_ARRAYS = ("g2_powers", "z_table", "z2_table", "k_table",
                 "quartic_ginv", "inv4", "level_moduli_np",
                 "points_eval_matrix", "points_pts")
_TABLE_SCALARS = ("last_step_position", "k_period", "minipoly_root")


def tables_from_reference(arrays: dict, cfg: StarkConfig) -> StatementTables:
    """Statement tables computed elsewhere -> a StatementTables for the port.

    arrays maps each name in _TABLE_ARRAYS to a numpy array (uint32 limbs or
    words; points_pts int64 positions) and each name in _TABLE_SCALARS to a
    plain int (the JAX package's StatementTables has
    fields of the same names and layouts).  Nothing is recomputed; shapes are
    checked against cfg."""
    t = object.__new__(StatementTables)
    t.cfg = cfg
    for name in _TABLE_ARRAYS:
        dtype = np.int64 if name == "points_pts" else np.uint32
        setattr(t, name, np.ascontiguousarray(arrays[name], dtype=dtype))
    for name in _TABLE_SCALARS:
        setattr(t, name, int(arrays[name]))
    deg = cfg.fri_final_maxdeg_plus_1
    npts = cfg.fri_final_domain - cfg.fri_final_domain // cfg.extension_factor
    want = {"g2_powers": (cfg.precision, fp.NLIMBS),
            "z_table": (cfg.precision, fp.NLIMBS),
            "z2_table": (cfg.precision, fp.NLIMBS),
            "k_table": (t.k_period, fp.NLIMBS),
            "quartic_ginv": (fp.NLIMBS,), "inv4": (fp.NLIMBS,),
            "level_moduli_np": (cfg.fri_levels,),
            "points_pts": (npts,),
            "points_eval_matrix": (npts - deg, deg, fp.NLIMBS)}
    for name, shape in want.items():
        if getattr(t, name).shape != shape:
            raise ValueError(
                f"{name}: shape {getattr(t, name).shape}, family expects {shape}")
    t.level_moduli = [int(v) for v in t.level_moduli_np]
    t.k_root = k_root(cfg)
    return t
