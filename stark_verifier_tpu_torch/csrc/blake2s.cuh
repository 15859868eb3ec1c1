// Blake2s-256 compression for the Merkle kernels (merkle_walk.cu).
//
// Replaces the TPU package's in-kernel Blake2s (ops/merkle_pallas.py: _g,
// _compress, _hash_words), which kept each state word as a [S, 128] vector
// tile and built rotates from two shifts and an or.  Here one thread owns one
// hash: the 16 state words and the 16 message words are scalars in registers,
// the ten rounds are unrolled with the message schedule as literals, and a
// rotate is one funnel shift (12, 7) or one byte permute (16, 8).
#pragma once
#include "common.cuh"

#define B2S_IV0 0x6A09E667u
#define B2S_IV1 0xBB67AE85u
#define B2S_IV2 0x3C6EF372u
#define B2S_IV3 0xA54FF53Au
#define B2S_IV4 0x510E527Fu
#define B2S_IV5 0x9B05688Cu
#define B2S_IV6 0x1F83D9ABu
#define B2S_IV7 0x5BE0CD19u
// parameter block word 0: digest_length=32, key=0, fanout=1, depth=1
#define B2S_PARAM0 0x01010020u

template <int R>
STARK_HD uint32_t b2s_rotr(uint32_t x) {
#if defined(__CUDA_ARCH__)
  if (R == 16) return __byte_perm(x, x, 0x1032);
  if (R == 8) return __byte_perm(x, x, 0x0321);
  return __funnelshift_r(x, x, R);
#else
  return (x >> R) | (x << (32 - R));
#endif
}

#define B2S_G(a, b, c, d, x, y) \
  do {                          \
    a = a + b + (x);            \
    d = b2s_rotr<16>(d ^ a);    \
    c = c + d;                  \
    b = b2s_rotr<12>(b ^ c);    \
    a = a + b + (y);            \
    d = b2s_rotr<8>(d ^ a);     \
    c = c + d;                  \
    b = b2s_rotr<7>(b ^ c);     \
  } while (0)

#define B2S_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, \
                  s14, s15)                                                    \
  do {                                                                         \
    B2S_G(v0, v4, v8, v12, m[s0], m[s1]);                                      \
    B2S_G(v1, v5, v9, v13, m[s2], m[s3]);                                      \
    B2S_G(v2, v6, v10, v14, m[s4], m[s5]);                                     \
    B2S_G(v3, v7, v11, v15, m[s6], m[s7]);                                     \
    B2S_G(v0, v5, v10, v15, m[s8], m[s9]);                                     \
    B2S_G(v1, v6, v11, v12, m[s10], m[s11]);                                   \
    B2S_G(v2, v7, v8, v13, m[s12], m[s13]);                                    \
    B2S_G(v3, v4, v9, v14, m[s14], m[s15]);                                    \
  } while (0)

// Set h to the initial chaining value of an unkeyed 32-byte-digest hash.
STARK_HD void b2s_init(uint32_t* h) {
  h[0] = B2S_IV0 ^ B2S_PARAM0;
  h[1] = B2S_IV1; h[2] = B2S_IV2; h[3] = B2S_IV3;
  h[4] = B2S_IV4; h[5] = B2S_IV5; h[6] = B2S_IV6; h[7] = B2S_IV7;
}

// One compression: h (8 words, updated in place), m (16 message words),
// t = byte counter after this block (all messages here are < 2^32 bytes),
// last = true on the final block.
STARK_HD void b2s_compress(uint32_t* h, const uint32_t* m, uint32_t t,
                           bool last) {
  uint32_t v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3];
  uint32_t v4 = h[4], v5 = h[5], v6 = h[6], v7 = h[7];
  uint32_t v8 = B2S_IV0, v9 = B2S_IV1, v10 = B2S_IV2, v11 = B2S_IV3;
  uint32_t v12 = B2S_IV4 ^ t, v13 = B2S_IV5;
  uint32_t v14 = last ? ~B2S_IV6 : B2S_IV6, v15 = B2S_IV7;
  B2S_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  B2S_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
  B2S_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
  B2S_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
  B2S_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
  B2S_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
  B2S_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
  B2S_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
  B2S_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
  B2S_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
  h[0] ^= v0 ^ v8;  h[1] ^= v1 ^ v9;  h[2] ^= v2 ^ v10; h[3] ^= v3 ^ v11;
  h[4] ^= v4 ^ v12; h[5] ^= v5 ^ v13; h[6] ^= v6 ^ v14; h[7] ^= v7 ^ v15;
}

// One Merkle level: h <- Blake2s(left || right) with (left, right) =
// (wit, h) when `odd` else (h, wit); 64-byte message, one compression.
STARK_HD void b2s_merkle_level(uint32_t* h, const uint32_t* wit, bool odd) {
  uint32_t m[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m[j] = odd ? wit[j] : h[j];
    m[8 + j] = odd ? h[j] : wit[j];
  }
  b2s_init(h);
  b2s_compress(h, m, 64u, true);
}
