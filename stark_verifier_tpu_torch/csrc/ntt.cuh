// The radix-2 NTT's butterfly and its two value layouts, shared by the
// one-stage kernel (ntt_stage.cu) and the several-stage kernel
// (ntt_block.cu).
//
// A side is either the public [.., 16] layout (16-bit limbs, one a 32-bit
// word, 64 bytes a value) or the working layout (eight little-endian 32-bit
// words, 32 bytes a value).
#pragma once
#include "field256.cuh"

STARK_HD fe stark_ntt_load(const uint32_t* base, long long row, int limbs) {
  return limbs ? fe_from_limbs16(base + row * 16)
               : fe_from_le_words(base + row * 8);
}

STARK_HD void stark_ntt_store(uint32_t* base, long long row, int limbs,
                              const fe& x) {
  if (limbs) {
    uint32_t r[16];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      r[2 * k] = x.v[k] & 0xFFFFu;
      r[2 * k + 1] = x.v[k] >> 16;
    }
    stark_st8(base + row * 16, r);
    stark_st8(base + row * 16 + 8, r + 8);
  } else {
    stark_st8(base + row * 8, x.v);
  }
}

// The butterfly: (a, b, w) -> (a + b w, a - b w) mod p (b w canonical, as
// the plain version's mul_mod gives it; a may be raw in the first stage).
STARK_HD void stark_butterfly(const fe& a, const fe& b, const fe& w, fe& lo,
                              fe& hi) {
  const fe t = fe_mul_short(b, w);
  lo = fe_add(a, t);
  hi = fe_sub(a, t);
}

STARK_HD int stark_log2(long long x) {
  int k = 0;
  while ((1LL << k) < x) ++k;
  return k;
}
