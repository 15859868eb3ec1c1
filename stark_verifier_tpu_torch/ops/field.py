"""256-bit prime-field arithmetic in plain integer torch.

A field element is a [..., 16] tensor of little-endian 16-bit limbs (see
fp.py), stored as int32 (values 0..0xFFFF) -- the JAX package's public layout.
All functions are shape-polymorphic over leading batch dims and run on
whatever device their tensors lie on.  Internally limbs widen to int64: a
limb product is < 2^32 and a 16-term column of them < 2^36, so every column
sum below is exact, and a *signed* sequential carry (arithmetic shift) also
resolves the negative columns of the C = 351*2^32 - 1 fold.

Values are *not* required to be canonical (< p) on input to multiplication:
any x < 2^256 is accepted and the result is canonical.  This matters for the
reference verifier's bit-exactness quirks (unreduced k1..k4 / special_x):
products of unreduced inputs are congruent to products of their residues, so
reducing early is safe wherever a value is only used inside mod-p algebra.
Raw (possibly >= p) values are compared bit-for-bit where the reference
compares unreduced integers.

This module is the arithmetic of the plain versions of the CUDA kernels
(ops/fri_cuda.py, ops/spot_cuda.py, ops/field_cuda.py) and of the small
per-proof glue of the verifier; the kernels carry their own 8 x 32-bit core
(csrc/field256.cuh).  mul_mod (with sqr_mod and mul_mod_lazy, which call it)
is the one function here with a kernel of its own: it dispatches to
ops/field_cuda.mul_mod, which launches the kernel for a CUDA tensor and runs
the plain version for a CPU tensor.  The plain versions of the other kernels
call field_cuda.mul_mod_plain directly, so that none of them is built on a
kernel.  mul_sum_mod has no kernel and is plain torch on either device.
The exponentiations and inversions (pow_const, pow2k, inv_mod, pow_table,
batch_inv) are plain torch whose products go through mul_mod.  ge,
cond_sub, mul_wide, reduce_wide and _sum_mod complete the JAX package's
surface (ops/quartic.py's cross-check forms sum with _sum_mod).  With
STARK_DEBUG=1 (debug.py) add_mod, sub_mod and mul_sum_mod check that their
operands' limbs are 16-bit values, and the reduction checks its output.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import debug, fp

NLIMBS = fp.NLIMBS
MASK = fp.LIMB_MASK

_C16 = [int(v) for v in fp.FOLD_C_LIMBS]                 # 3 limbs of C
_NOT_C16 = [MASK - (_C16[i] if i < 3 else 0) for i in range(NLIMBS)]


def const(x: int, device) -> torch.Tensor:
    """Embed a host int as a [16] limb tensor on `device`."""
    return torch.from_numpy(fp.int_to_limbs(x).astype(np.int32)).to(device)


# ---------------------------------------------------------------------------
# Word/byte views
# ---------------------------------------------------------------------------

def bswap32(w: torch.Tensor) -> torch.Tensor:
    """Byte-swap 32-bit words held as int32 bit patterns (LE word <-> BE
    4-byte read).  `>>` on int32 is arithmetic, so each right-shifted piece is
    masked down to the bytes it is meant to carry."""
    return (((w & 0xFF) << 24) | ((w & 0xFF00) << 8)
            | ((w >> 8) & 0xFF00) | ((w >> 24) & 0xFF))


def words_be_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """[..., 8] LE words of a 32-byte big-endian value -> [..., 16] limbs.

    Proof values are 32-byte big-endian ints (reference: src/main.rs:171-174);
    the hash view stores them as LE words.  bswap each word (making it the
    value of its 4-byte BE group), reverse group order, then split into
    16-bit limbs.
    """
    sw = bswap32(words).flip(-1)          # group 0 = least significant 32 bits
    lo = sw & MASK
    hi = (sw >> 16) & MASK
    return torch.stack([lo, hi], dim=-1).reshape(*words.shape[:-1], 16)


def limbs_to_words_be(limbs: torch.Tensor) -> torch.Tensor:
    """Inverse of words_be_to_limbs: [..., 16] limbs -> [..., 8] LE words of
    the 32-byte big-endian encoding."""
    pairs = limbs.reshape(*limbs.shape[:-1], 8, 2)
    sw = pairs[..., 0] | (pairs[..., 1] << 16)   # LE 32-bit groups
    return bswap32(sw.flip(-1))


def words_le_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """[..., 8] little-endian 32-bit limbs (the kernels' packed rows) ->
    [..., 16] 16-bit limbs."""
    lo = words & MASK
    hi = (words >> 16) & MASK
    return torch.stack([lo, hi], dim=-1).reshape(*words.shape[:-1], 16)


def limbs_to_words_le(limbs: torch.Tensor) -> torch.Tensor:
    """Inverse of words_le_to_limbs: [..., 16] limbs -> [..., 8] words."""
    return limbs[..., 0::2] | (limbs[..., 1::2] << 16)


# ---------------------------------------------------------------------------
# Carry normalization
# ---------------------------------------------------------------------------

def _cols(a: torch.Tensor) -> list:
    """[..., n] limbs -> list of n int64 column tensors."""
    return list(a.to(torch.int64).unbind(-1))


def _carry(cols: list, n_out: int) -> list:
    """Sequential carry over int64 columns (possibly negative or >= 2^16):
    returns n_out limbs in [0, 2^16); the carry past limb n_out-1 is dropped
    (callers size n_out so that it is zero)."""
    out = []
    c = None
    for i in range(n_out):
        v = cols[i] if i < len(cols) else None
        if c is not None:
            v = c if v is None else v + c
        if v is None:
            v = torch.zeros_like(cols[0])
        out.append(v & MASK)
        c = v >> 16                     # arithmetic shift = floor division
    return out


def _limbs(cols: list) -> torch.Tensor:
    return torch.stack(cols, dim=-1).to(torch.int32)


def _add_c(cols: list) -> list:
    """cols + C on the low three limbs (pre-carry)."""
    return [c + _C16[i] if i < 3 else c for i, c in enumerate(cols)]


def _select(cond: torch.Tensor, a: list, b: list) -> list:
    return [torch.where(cond, x, y) for x, y in zip(a, b)]


def canon(a: torch.Tensor) -> torch.Tensor:
    """Reduce a value < 2^256 into canonical [0, p).

    p = 2^256 - C:  a >= p  <=>  a + C >= 2^256, so one 17-limb add of C
    exposes the compare as its carry-out limb and the reduced value as its
    low limbs."""
    a64 = _cols(a)
    t = _carry(_add_c(a64), NLIMBS + 1)
    return _limbs(_select(t[NLIMBS] > 0, t[:NLIMBS], a64))


# ---------------------------------------------------------------------------
# Comparison / conditional subtract
# ---------------------------------------------------------------------------

def ge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b as integers; a, b [..., n] normalized limbs (any n).  Returns
    [...] bool: the most significant differing limb decides (limbs read as
    unsigned 32-bit words, as the JAX package's uint32 limbs compare)."""
    out = None
    for x, y in zip(_cols(a), _cols(b)):       # low limb first: the top wins
        x, y = x & 0xFFFFFFFF, y & 0xFFFFFFFF
        out = x >= y if out is None else torch.where(x == y, out, x > y)
    return out


def cond_sub(a: torch.Tensor, b: torch.Tensor,
             cond: torch.Tensor) -> torch.Tensor:
    """Where cond, a - b mod 2^(16n) (requires a >= b), else a; a, b
    [..., n] normalized limbs, cond [...] bool.  The difference is
    a + ~b + 1 with the carry past the top limb dropped."""
    cols = [x + (MASK - y) for x, y in zip(_cols(a), _cols(b))]
    cols[0] = cols[0] + 1
    d = _limbs(_carry(cols, len(cols)))
    return torch.where(cond[..., None], d, a)


# ---------------------------------------------------------------------------
# Add / sub mod p
# ---------------------------------------------------------------------------

def add_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p for canonical inputs: s = a + b and u = s + C; s >= p
    <=> u >= 2^256 <=> u's carry-out limb is set, in which case the answer is
    u's low limbs (s + C - 2^256 = s - p)."""
    debug.check_limbs(a, "add_mod lhs")
    debug.check_limbs(b, "add_mod rhs")
    a, b = torch.broadcast_tensors(a, b)
    raw = [x + y for x, y in zip(_cols(a), _cols(b))]
    s = _carry(raw, NLIMBS + 1)
    u = _carry(_add_c(raw), NLIMBS + 1)
    return _limbs(_select(u[NLIMBS] > 0, u[:NLIMBS], s[:NLIMBS]))


def sub_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for canonical inputs, via complement adds:
    r0 = a + ~b + 1 (= a - b + 2^256; carry-out limb set iff a >= b) and
    r1 = a + ~b + ~C + 2 (= a - b + p + 2^256; its low limbs are a - b + p,
    the a < b answer)."""
    debug.check_limbs(a, "sub_mod lhs")
    debug.check_limbs(b, "sub_mod rhs")
    a, b = torch.broadcast_tensors(a, b)
    base = [x + (MASK - y) for x, y in zip(_cols(a), _cols(b))]
    r0 = list(base)
    r0[0] = r0[0] + 1
    r1 = [x + _NOT_C16[i] for i, x in enumerate(base)]
    r1[0] = r1[0] + 2
    r0 = _carry(r0, NLIMBS + 1)
    r1 = _carry(r1, NLIMBS + 1)
    return _limbs(_select(r0[NLIMBS] > 0, r0[:NLIMBS], r1[:NLIMBS]))


# ---------------------------------------------------------------------------
# Multiplication
# ---------------------------------------------------------------------------

def _mul_acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns of [..., 16] x [..., 16] limbs as one
    [..., 31] int64 tensor (pre-carry, each < 2^36): anti-diagonal sums of the
    limb product matrix by the pad/flatten/re-stride trick (row i lands
    shifted right by i, then a plain axis sum)."""
    a, b = torch.broadcast_tensors(a, b)
    prod = a.to(torch.int64)[..., :, None] * b.to(torch.int64)[..., None, :]
    lead = prod.shape[:-2]
    x = torch.nn.functional.pad(prod, (0, NLIMBS))           # [..., 16, 32]
    x = x.reshape(lead + (NLIMBS * 2 * NLIMBS,))[..., :NLIMBS * (2 * NLIMBS - 1)]
    return x.reshape(lead + (NLIMBS, 2 * NLIMBS - 1)).sum(dim=-2)


def _fold_once(limbs: list) -> list:
    """limbs (n > 16 normalized limbs, value V) -> normalized limbs of
    lo + C*hi === V (mod p), where V = lo + 2^256 * hi and
    C*hi = 351 * (hi << 32) - hi (signed columns)."""
    lo, hi = limbs[:NLIMBS], limbs[NLIMBS:]
    n = max(NLIMBS, len(hi) + 2) + 1
    zero = torch.zeros_like(limbs[0])
    cols = []
    for i in range(n):
        v = lo[i] if i < NLIMBS else zero
        if 0 <= i - 2 < len(hi):
            v = v + 351 * hi[i - 2]
        if i < len(hi):
            v = v - hi[i]
        cols.append(v)
    return _carry(cols, n)


def _reduce_cols(cols: list) -> torch.Tensor:
    """Reduce int64 product/sum columns (any width, non-negative total
    < 2^544) to [..., 16] canonical limbs mod p."""
    limbs = _carry(cols, max(len(cols) + 3, NLIMBS + 1))
    while len(limbs) > NLIMBS + 1:
        limbs = _fold_once(limbs)
    # 17 limbs: V < 2^272.  One more fold brings it below 2^256 + 2^57; if
    # that leaves the top limb set, the low part is < 2^57, so the second
    # fold cannot carry out again and the value is < 2^256.
    for _ in range(2):
        limbs = _fold_once(limbs)
    v = limbs[:NLIMBS]
    u = _carry(_add_c(v), NLIMBS + 1)
    r = _limbs(_select(u[NLIMBS] > 0, u[:NLIMBS], v))
    debug.check_limbs(r, "_reduce_cols canonical output")
    return r


def mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full 512-bit product of two 256-bit values: [..., 16] x [..., 16] ->
    [..., 32] normalized limbs."""
    return _limbs(_carry(list(_mul_acc(a, b).unbind(-1)), 2 * NLIMBS))


def _acc_mul_c(acc: list, m: list) -> None:
    """acc[k .. k + len(m)] += C * m, in place in the list, for unnormalized
    int64 columns m, with the JAX package's split of the partial products:
    C's limb k times m's low 16 bits lands in two halves at columns k and
    k + 1, times m's high bits whole at column k + 1.  The split decides
    which column holds which part of the value, and the next fold cuts the
    columns at limb 16, so the lazy result of reduce_wide depends on it."""
    for k, c in enumerate(_C16):
        for j, x in enumerate(m):
            p = (x & MASK) * c
            acc[k + j] = acc[k + j] + (p & MASK)
            acc[k + j + 1] = acc[k + j + 1] + (p >> 16) + (x >> 16) * c


def reduce_wide(w: torch.Tensor, canonical: bool = True) -> torch.Tensor:
    """Reduce [..., 32] limbs (< 2^512, normalized or unnormalized, each
    < 2^21) to [..., 16] using 2^256 === C (mod p), C = 351*2^32 - 1.

    canonical=True returns the value in [0, p).  canonical=False returns a
    residue below 2^256, which may lie in [p, 2^256): it follows the JAX
    package's fold chain step for step (two folds on unnormalized columns,
    lo + C*hi and then its top four columns, one carry, a third fold of the
    carried top limb, and that fold's own 2^256 bit folded once more), so
    its bits are the JAX package's."""
    if canonical:
        return _reduce_cols(_cols(w))
    cols = _cols(w)
    zero = torch.zeros_like(cols[0])
    acc = cols[:NLIMBS] + [zero] * 4                       # fold 1: 20 columns
    _acc_mul_c(acc, cols[NLIMBS:])
    acc2 = acc[:NLIMBS] + [zero]                           # fold 2: 17 columns
    _acc_mul_c(acc2, acc[NLIMBS:])
    t = _carry(acc2, NLIMBS + 1)
    v = t[:NLIMBS] + [zero]                                # fold 3
    _acc_mul_c(v, t[NLIMBS:])
    vn = _carry(v, NLIMBS + 1)
    top = vn[NLIMBS]
    return _limbs(_carry(
        [x + top * _C16[i] if i < 3 else x for i, x in enumerate(vn[:NLIMBS])],
        NLIMBS))


def mul_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p, canonical; inputs may be any values < 2^256.  The
    element-wise multiply kernel for CUDA tensors, its plain version for CPU
    tensors (ops/field_cuda.py)."""
    from . import field_cuda          # field_cuda imports this module
    return field_cuda.mul_mod(a, b)


def sqr_mod(a: torch.Tensor) -> torch.Tensor:
    """a^2 mod p, canonical; input any value < 2^256."""
    return mul_mod(a, a)


def mul_mod_lazy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p.  Kept as a name for call-site intent (the JAX package
    once returned a cheaper non-canonical residue here); canonical."""
    return mul_mod(a, b)


def mul_sum_mod(pairs, extra=()) -> torch.Tensor:
    """sum_i a_i * b_i  +  sum_j extra_j   (mod p), with ONE reduction.

    pairs: iterable of (a, b) [..., 16] limb tensors (values < 2^256,
    broadcastable leads).  extra: iterable of [..., 16] plain addends.  The
    bound 1 <= n_pairs <= 16, n_extra <= 8 is the JAX package's exactness
    bound, kept so both sides accept the same calls; here the int64 columns
    (< 16 * 2^36 + 8 * 2^16) and the 544-bit reduction have room to spare.
    Canonical output."""
    pairs = list(pairs)
    extra = list(extra)
    n = len(pairs)
    if not (1 <= n <= 16 and len(extra) <= 8):
        raise ValueError(
            f"mul_sum_mod exactness bound: 1 <= n_pairs <= 16 (got {n}), "
            f"n_extra <= 8 (got {len(extra)})")
    for a, b in pairs:
        debug.check_limbs(a, "mul_sum_mod lhs")
        debug.check_limbs(b, "mul_sum_mod rhs")
    for t in extra:
        debug.check_limbs(t, "mul_sum_mod extra")
    acc = _mul_acc(*pairs[0])
    for a, b in pairs[1:]:
        acc = acc + _mul_acc(a, b)
    cols = list(acc.unbind(-1))
    for t in extra:
        t64 = _cols(t)
        cols = [c + t64[i] if i < NLIMBS else c for i, c in enumerate(cols)]
    return _reduce_cols(cols)


def neg_mod(a: torch.Tensor) -> torch.Tensor:
    """(-a) mod p for canonical input."""
    return sub_mod(torch.zeros_like(a), a)


# ---------------------------------------------------------------------------
# Exponentiation and inversion (products through mul_mod: on the card the
# element-wise multiply kernel, one launch a product)
# ---------------------------------------------------------------------------

def _one_like(shape, device) -> torch.Tensor:
    return const(1, device).expand(tuple(shape)).clone()


def pow_const(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e mod p for a host exponent (square-and-multiply from the top bit;
    e = 1 returns x as it is, e = 0 the limbs of 1)."""
    if e == 0:
        return _one_like(x.shape, x.device)
    r = x
    for bit in bin(e)[3:]:
        r = sqr_mod(r)
        if bit == "1":
            r = mul_mod(r, x)
    return r


def pow2k(x: torch.Tensor, k: int) -> torch.Tensor:
    """x^(2^k) mod p: k squarings (x itself for k = 0)."""
    for _ in range(k):
        x = sqr_mod(x)
    return x


def inv_mod(x: torch.Tensor) -> torch.Tensor:
    """x^(p-2) mod p (Fermat); maps 0 to 0, as the reference's inverse does
    at its call sites (src/utils.rs:139-167).

    The JAX package's addition chain for the sparse prime: p - 2 is, in
    binary, 215 ones, 010100000, 32 ones; the blocks x^(2^k - 1) of a
    doubling ladder cover the runs of ones, so the chain costs 255
    squarings and 15 products."""
    x = canon(x)

    def sm(r, k, t):
        return mul_mod(pow2k(r, k), t)     # r^(2^k) * t

    r1 = x
    r2 = sm(r1, 1, r1)                     # x^(2^2 - 1)
    r4 = sm(r2, 2, r2)
    r8 = sm(r4, 4, r4)
    r16 = sm(r8, 8, r8)
    r32 = sm(r16, 16, r16)
    r64 = sm(r32, 32, r32)
    r128 = sm(r64, 64, r64)
    u = sm(r128, 64, r64)                  # x^(2^192 - 1)
    u = sm(u, 16, r16)                     # 208 ones
    u = sm(u, 4, r4)                       # 212
    u = sm(u, 2, r2)                       # 214
    u = sm(u, 1, r1)                       # x^(2^215 - 1)
    # the tail block: 2^224 - 352 = (2^215 - 1) * 2^9 + 160, 160 = 0b010100000
    u = sqr_mod(u)
    u = mul_mod(sqr_mod(u), x)
    u = sqr_mod(u)
    u = mul_mod(sqr_mod(u), x)
    u = pow2k(u, 5)                        # x^(2^224 - 352)
    # the low word: (2^224 - 352) * 2^32 + (2^32 - 1) = p - 2
    return sm(u, 32, r32)


def pow_table(table: torch.Tensor, e: torch.Tensor, nbits: int) -> torch.Tensor:
    """base^e with table[i] = base^(2^i) (fp.pow2_table): table [nbits, 16],
    e [...] int32 exponents (uint32 bit patterns, < 2^nbits); [..., 16].
    One product a bit, kept where the bit is set."""
    r = _one_like(tuple(e.shape) + (NLIMBS,), e.device)
    for i in range(nbits):
        bit = ((e >> i) & 1).bool()[..., None]
        r = torch.where(bit, mul_mod(r, table[i]), r)
    return r


def _scan_products(v: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Inclusive product scan of [..., n, 16] along -2 (reverse: from the
    end), by doubling: log2(n) rounds of one product each.  Element 0 (n - 1
    when reversed) stays as it is, as in the JAX package's associative
    scan; every other is a canonical product, the same residue whatever the
    order."""
    if reverse:
        return _scan_products(v.flip(-2), False).flip(-2)
    n = v.shape[-2]
    d = 1
    while d < n:
        v = torch.cat([v[..., :d, :], mul_mod(v[..., d:, :], v[..., :-d, :])],
                      dim=-2)
        d *= 2
    return v


def batch_inv(v: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Invert many field elements with one Fermat inversion (Montgomery's
    trick; reference: src/utils.rs:169-194).

    v: [..., n, 16] canonical values along `axis` (default the second to
    last).  Zeros map to 0 (the reference's multi_inv).  Inclusive prefix
    and suffix product scans: inv_i = prefix_(i-1) * suffix_(i+1) *
    inv(total)."""
    if axis != -2:
        v = v.movedim(axis, -2)
    is_zero = (v == 0).all(dim=-1, keepdim=True)
    vv = torch.where(is_zero, _one_like(v.shape, v.device), v)
    pre = _scan_products(vv, reverse=False)
    suf = _scan_products(vv, reverse=True)
    itot = inv_mod(pre[..., -1, :])
    one = _one_like(v.shape[:-2] + (1, NLIMBS), v.device)
    pre_excl = torch.cat([one, pre[..., :-1, :]], dim=-2)
    suf_excl = torch.cat([suf[..., 1:, :], one], dim=-2)
    out = mul_mod(mul_mod_lazy(pre_excl, suf_excl), itot[..., None, :])
    out = torch.where(is_zero, torch.zeros_like(out), out)
    if axis != -2:
        out = out.movedim(-2, axis)
    return out


# ---------------------------------------------------------------------------
# Polynomial helpers
# ---------------------------------------------------------------------------

def eval_poly(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Evaluate sum_i coeffs[i] * x^i mod p (Horner over the coefficients).

    coeffs: [n, 16] (shared); x: [..., 16] canonical.  Same residue as the
    reference's power-accumulation loop (src/utils.rs:126-136 eval_poly_at);
    each step is acc * x + c through one reduction (mul_sum_mod).
    """
    rev = canon(coeffs.flip(0))
    acc = rev[0].expand(x.shape)
    for c in rev[1:]:
        acc = mul_sum_mod([(acc, x)], extra=[c.expand(x.shape)])
    return acc


def _sum_mod(terms: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Modular sum of canonical values along an axis: a tree of add_mod,
    halves added pairwise, an odd last element carried to the next round
    as it is (the JAX package's order, hence its bits on raw inputs)."""
    if axis != -2:
        terms = terms.movedim(axis, -2)
    while terms.shape[-2] > 1:
        k = terms.shape[-2]
        half = k // 2
        s = add_mod(terms[..., :half, :], terms[..., half:2 * half, :])
        if k % 2:
            s = torch.cat([s, terms[..., -1:, :]], dim=-2)
        terms = s
    return terms[..., 0, :]
