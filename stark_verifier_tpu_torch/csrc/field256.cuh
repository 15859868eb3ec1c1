// 256-bit prime-field core for the FRI row, spot-check and element-wise
// multiply kernels.
// p = 2^256 - C with C = 351 * 2^32 - 1, so 2^256 === C (mod p).
//
// Replaces the TPU package's in-kernel field core (ops/field_pallas.py:
// _mul_cols, _mul_cols_const, _acc_mul_c, _fold_canon, _carry_cols,
// _canon_cols, _add_canon, _sub_canon, _sum_rows) and its word<->limb row
// conversions (ops/fri_pallas.py: _words_to_limb_rows, _limb_rows_to_words).
// That core is shaped by a vector unit with 32-bit lanes and no carry flag:
// sixteen 16-bit limbs per value, limb-major [16, T] tiles, products split in
// halves, a Kogge-Stone carry, concatenate-built shifts, arithmetic selects.
// A CUDA thread has 32x32->64 multiplies and cheap sequential carries, so a
// value here is eight 32-bit limbs in registers, a product sum is one
// 18-limb accumulator, and a carry is a chain through 64-bit adds.  (The
// same product on the carry flag, PTX mad.lo.cc / madc.hi.cc in sppark's
// even / odd column scheme, compiles to more instructions on sm_90a and ran
// kernels C and D about 10 % slower: PERF.md, section 7.)
#pragma once
#include "common.cuh"

#define FE_C0 0xFFFFFFFFu  // C = FE_C1 * 2^32 + FE_C0
#define FE_C1 350u

struct fe {
  uint32_t v[8];  // little-endian 32-bit limbs, value < 2^256
};

// Sum-of-products accumulator: 18 limbs = 576 bits.  The widest use is four
// products of values < 2^256 plus one addend (< 2^515).
#define FE_ACC 18
struct fe_acc {
  uint32_t v[FE_ACC];
};

STARK_HD uint32_t fe_bswap(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(x, 0, 0x0123);
#else
  return (x >> 24) | ((x >> 8) & 0xFF00u) | ((x << 8) & 0xFF0000u) | (x << 24);
#endif
}

// 8 LE words of a 32-byte big-endian value (the proof's wire encoding).
STARK_HD fe fe_from_be_words(const uint32_t* w) {
  uint32_t t[8];
  stark_ld8(w, t);
  fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = fe_bswap(t[7 - k]);
  return r;
}

// 8 little-endian words (a packed table row).
STARK_HD fe fe_from_le_words(const uint32_t* w) {
  fe r;
  stark_ld8(w, r.v);
  return r;
}

STARK_HD void fe_to_be_words(const fe& a, uint32_t* w) {
  uint32_t t[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) t[7 - k] = fe_bswap(a.v[k]);
  stark_st8(w, t);
}

// 16 little-endian 16-bit limbs, one per 32-bit word (the public limb
// layout; 64 bytes, 16-byte aligned).
STARK_HD fe fe_from_limbs16(const uint32_t* l) {
  uint32_t t[16];
  stark_ld8(l, t);
  stark_ld8(l + 8, t + 8);
  fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    r.v[k] = (t[2 * k] & 0xFFFFu) | (t[2 * k + 1] << 16);
  return r;
}

STARK_HD bool fe_eq(const fe& a, const fe& b) {
  uint32_t d = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) d |= a.v[k] ^ b.v[k];
  return d == 0;
}

// r = a + C (low 256 bits); returns the carry out of bit 255.
STARK_HD uint32_t fe_add_c(const fe& a, fe& r) {
  uint64_t t = (uint64_t)a.v[0] + FE_C0;
  r.v[0] = (uint32_t)t;
  t = (uint64_t)a.v[1] + FE_C1 + (t >> 32);
  r.v[1] = (uint32_t)t;
#pragma unroll
  for (int k = 2; k < 8; ++k) {
    t = (uint64_t)a.v[k] + (t >> 32);
    r.v[k] = (uint32_t)t;
  }
  return (uint32_t)(t >> 32);
}

// Any value < 2^256 -> canonical [0, p):  a >= p  <=>  a + C >= 2^256, and
// then a - p is the low 256 bits of a + C.
STARK_HD fe fe_canon(const fe& a) {
  fe u;
  return fe_add_c(a, u) ? u : a;
}

// (a + b) mod p for canonical a, b.
STARK_HD fe fe_add(const fe& a, const fe& b) {
  fe s, u;
  uint64_t t = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    t = (uint64_t)a.v[k] + b.v[k] + (t >> 32);
    s.v[k] = (uint32_t)t;
  }
  uint32_t c = (uint32_t)(t >> 32);
  c |= fe_add_c(s, u);
  return c ? u : s;
}

// (a - b) mod p for canonical a, b:  on borrow add p, i.e. subtract C
// (mod 2^256).
STARK_HD fe fe_sub(const fe& a, const fe& b) {
  fe d, e;
  uint64_t t = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    t = (uint64_t)a.v[k] - b.v[k] - ((t >> 32) & 1u);
    d.v[k] = (uint32_t)t;
  }
  uint32_t borrow = (uint32_t)(t >> 32) & 1u;
  t = (uint64_t)d.v[0] - FE_C0;
  e.v[0] = (uint32_t)t;
  t = (uint64_t)d.v[1] - FE_C1 - ((t >> 32) & 1u);
  e.v[1] = (uint32_t)t;
#pragma unroll
  for (int k = 2; k < 8; ++k) {
    t = (uint64_t)d.v[k] - ((t >> 32) & 1u);
    e.v[k] = (uint32_t)t;
  }
  return borrow ? e : d;
}

STARK_HD void fe_acc_zero(fe_acc& acc) {
#pragma unroll
  for (int k = 0; k < FE_ACC; ++k) acc.v[k] = 0;
}

// acc += a * b (any a, b < 2^256): schoolbook rows of 32x32->64 products,
// each row's carry run to the top of the accumulator.
STARK_HD void fe_acc_mul(fe_acc& acc, const fe& a, const fe& b) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // (2^32-1)^2 + 2*(2^32-1) = 2^64 - 1: no overflow
      uint64_t t = (uint64_t)a.v[i] * b.v[j] + acc.v[i + j] + carry;
      acc.v[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
#pragma unroll
    for (int k = i + 8; k < FE_ACC; ++k) {
      uint64_t t = (uint64_t)acc.v[k] + carry;
      acc.v[k] = (uint32_t)t;
      carry = t >> 32;
    }
  }
}

// acc += a.
STARK_HD void fe_acc_add(fe_acc& acc, const fe& a) {
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < FE_ACC; ++k) {
    uint64_t t = (uint64_t)acc.v[k] + (k < 8 ? a.v[k] : 0u) + carry;
    acc.v[k] = (uint32_t)t;
    carry = t >> 32;
  }
}

// One fold: x (8 + NH limbs) = lo + 2^256 * hi  ->  r = lo + C * hi, in NR
// limbs (NR > NH + 2 and NR > 8, so nothing carries out).
template <int NH, int NR>
STARK_HD void fe_fold(const uint32_t* x, uint32_t* r) {
#pragma unroll
  for (int k = 0; k < NR; ++k) r[k] = k < 8 ? x[k] : 0u;
  const uint32_t c[2] = {FE_C0, FE_C1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      uint64_t t = (uint64_t)c[i] * x[8 + j] + r[i + j] + carry;
      r[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
#pragma unroll
    for (int k = i + NH; k < NR; ++k) {
      uint64_t t = (uint64_t)r[k] + carry;
      r[k] = (uint32_t)t;
      carry = t >> 32;
    }
  }
}

// Accumulator (< 2^576) -> canonical residue mod p.
//   fold 1: 18 limbs -> 13 (C * hi < 2^41 * 2^320)
//   fold 2: 13 limbs ->  9 (< 2^256 + 2^201)
//   folds 3, 4: 9 limbs -> 9; after fold 3 the value is < 2^256 + 2^73, so if
//   its top limb is still set the low part is tiny and fold 4 clears it.
STARK_HD fe fe_reduce(const fe_acc& acc) {
  uint32_t a[13], b[9], c[9], d[9];
  fe_fold<10, 13>(acc.v, a);
  fe_fold<5, 9>(a, b);
  fe_fold<1, 9>(b, c);
  fe_fold<1, 9>(c, d);
  fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = d[k];
  return fe_canon(r);
}

// (a * b) mod p, canonical, for any a, b < 2^256.
STARK_HD fe fe_mul(const fe& a, const fe& b) {
  fe_acc acc;
  fe_acc_zero(acc);
  fe_acc_mul(acc, a, b);
  return fe_reduce(acc);
}

// r[0..16) = a * b (any a, b < 2^256).
STARK_HD void fe_mul_wide(const fe& a, const fe& b, uint32_t* r) {
#pragma unroll
  for (int k = 0; k < 16; ++k) r[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint64_t t = (uint64_t)a.v[i] * b.v[j] + r[i + j] + carry;
      r[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    r[i + 8] = (uint32_t)carry;
  }
}

// (a * b) mod p, canonical, for any a, b < 2^256: fe_mul's result through
// a 16-limb product (each row's carry stops at its top limb, where fe_mul's
// accumulator carries it to limb 17) and three folds: < 2^298, < 2^256 +
// 2^83, then (if that carried) a low part < 2^83 plus C, below 2^256.
STARK_HD fe fe_mul_short(const fe& a, const fe& b) {
  uint32_t w[16], x[11], y[9], z[9];
  fe_mul_wide(a, b, w);
  fe_fold<8, 11>(w, x);
  fe_fold<2, 9>(x, y);
  fe_fold<1, 9>(y, z);
  fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = z[k];
  return fe_canon(r);
}
