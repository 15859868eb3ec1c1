// The MiMC trace scan: stark_mimc_scan.
//
// Replaces the TPU package's ops/mimc.py mimc (line 41: a lax.scan of the
// round x <- x^power + c_(i mod k) over the cycled round constants), which
// XLA compiles to a loop of element-wise operations over 16-bit limbs.  No
// pl.pallas_call stands behind it; the port gives it a kernel because the
// same loop in plain torch is hundreds of device launches a round, millions
// for one 8,192-step output.
//
// What bounds it on an H100: the chain.  Round i + 1 needs round i, so one
// input takes `rounds` times the latency of a round, and the card's issue
// rate bounds a launch only once tens of thousands of chains are in flight.
// One thread runs one input.  The kernel's first form took about 1.1 us a
// round (two canonical reductions, a general product for the square, the
// constant reloaded from 16-limb global rows each round).  The design
// shortens the round:
//
//   * constants out of the chain: a block checks the min(k, rounds)
//     constants a launch reads for wide limbs once (__syncthreads_or) and,
//     when they fit (STARK_MIMC_CONSTS_MAX, 224 KB), stages them into
//     shared memory in 8-word form; more constants are read from their
//     global rows (the same row for every thread, so from the cache).
//     Either way the loop reads the next constant a round ahead;
//   * one reduction a round: x^2 by a dedicated squaring (36 products, not
//     64), folded twice to below 2^257 and not to canonical form; x^2 x + c
//     (or x^2 + c) then takes the round's one reduction, three folds to
//     below 2^256.  x stays in that redundant form between rounds (every
//     product takes any operand below 2^256) and is made canonical once,
//     after the last round.
//
// Measured on an H100 80GB HBM3 at 700 W, SM clock 1,980 MHz (chip_smoke.py
// phase 12; the numbers in PERF.md), 8,192 steps at power 3: about 6.7 ms
// for 1 input (some 1,600 cycles a round; the first form 9.31 ms), the same
// within 1 % for 1,024 and 16,384 inputs, about 39 ms for 131,072 (the
// issue rate's bound is about 20 ms there).  A value spread over 2 or 4
// lanes of a warp (shuffle-broadcast products, ballot carries) was slower
// at every count measured (PERF.md): a warp issues one instruction for all
// its lanes, and the shuffles doubled a lane's instructions.
//
// Input: any value < 2^256 (the first product takes it raw); output
// canonical after the first round, the input itself at 0 rounds.  Limbs
// must be < 2^16: an input with a wider limb, or any constant a round reads
// with one, gives sixteen 0xFFFFFFFF words, as kernel E does.  Bit-identical
// with the first form and the plain version for every input (both reduce the
// same residue to canonical form).  The host build (g++) runs the same
// bodies a thread at a time, and chooses between the staged and the global
// constants by the same limit.
#include "field256.cuh"

#if !defined(__CUDACC__)
#include <vector>
#endif

#define STARK_MIMC_CONSTS_MAX 7168  // constants staged: 224 KB of shared

// r[0..16) = a^2: the 28 cross products once, doubled, plus the squares.
STARK_HD void fe_sqr_wide(const fe& a, uint32_t* r) {
#pragma unroll
  for (int k = 0; k < 16; ++k) r[k] = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = i + 1; j < 8; ++j) {
      const uint64_t t = (uint64_t)a.v[i] * a.v[j] + r[i + j] + carry;
      r[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    r[i + 8] = (uint32_t)carry;
  }
  r[15] = r[14] >> 31;
#pragma unroll
  for (int k = 14; k > 0; --k) r[k] = (r[k] << 1) | (r[k - 1] >> 31);
  r[0] <<= 1;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t sq = (uint64_t)a.v[i] * a.v[i];
    uint64_t t = (uint64_t)r[2 * i] + (uint32_t)sq + carry;
    r[2 * i] = (uint32_t)t;
    t = (uint64_t)r[2 * i + 1] + (sq >> 32) + (t >> 32);
    r[2 * i + 1] = (uint32_t)t;
    carry = t >> 32;
  }
}

// acc (18 limbs, < 2^514) -> a value < 2^256 congruent to it (not
// canonical): < 2^300 after the first fold, < 2^256 + 2^85 after the
// second; if that is >= 2^256 its low part is < 2^85 and the third fold
// (adding C) leaves it below 2^256.
STARK_HD fe stark_mimc_reduce(const uint32_t* acc) {
  uint32_t a[12], b[9], c[9];
  fe_fold<9, 12>(acc, a);
  fe_fold<2, 9>(a, b);
  fe_fold<1, 9>(b, c);
  fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = c[k];
  return r;
}

// One round on x < 2^256 (raw or redundant): a value < 2^256 congruent to
// x^POWER + c.
template <int POWER>
STARK_HD fe stark_mimc_round(const fe& x, const fe& c) {
  uint32_t acc[FE_ACC];
  acc[16] = acc[17] = 0;
  if constexpr (POWER == 3) {
    uint32_t s[16], a[11], t[9];
    fe_sqr_wide(x, s);
    fe_fold<8, 11>(s, a);  // < 2^298
    fe_fold<2, 9>(a, t);   // < 2^257: t[8] is 0 or 1
    fe lo;
#pragma unroll
    for (int k = 0; k < 8; ++k) lo.v[k] = t[k];
    fe_mul_wide(lo, x, acc);
    const uint32_t m = 0u - t[8];  // + t[8] x 2^256
    uint64_t carry = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint64_t u = (uint64_t)acc[8 + k] + (x.v[k] & m) + carry;
      acc[8 + k] = (uint32_t)u;
      carry = u >> 32;
    }
    acc[16] = (uint32_t)carry;
  } else {
    fe_sqr_wide(x, acc);
  }
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < 17; ++k) {
    const uint64_t u = (uint64_t)acc[k] + (k < 8 ? c.v[k] : 0u) + carry;
    acc[k] = (uint32_t)u;
    carry = u >> 32;
  }
  return stark_mimc_reduce(acc);
}

// 16 limbs -> a value; ORs what lies above 16 bits of any limb into wide.
STARK_HD fe stark_mimc_load(const uint32_t* l, uint32_t& wide) {
  uint32_t t[16];
  stark_ld8(l, t);
  stark_ld8(l + 8, t + 8);
  fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    wide |= (t[2 * k] | t[2 * k + 1]) >> 16;
    r.v[k] = (t[2 * k] & 0xFFFFu) | (t[2 * k + 1] << 16);
  }
  return r;
}

// Sixteen limbs of x, or sixteen 0xFFFFFFFF words when wide.
STARK_HD void stark_mimc_store(uint32_t* out, const fe& x, bool wide) {
  uint32_t o[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[2 * j] = wide ? 0xFFFFFFFFu : (x.v[j] & 0xFFFFu);
    o[2 * j + 1] = wide ? 0xFFFFFFFFu : (x.v[j] >> 16);
  }
  stark_st8(out, o);
  stark_st8(out + 8, o + 8);
}

// The constants a round reads: staged 8-word values (shared memory on the
// card), or the caller's 16-limb rows, unpacked where read (their wide
// limbs checked before the loop).
struct stark_mimc_staged {
  const fe* cs;
  STARK_HD fe at(long long i) const { return cs[i]; }
};
struct stark_mimc_rows {
  const uint32_t* consts;
  STARK_HD fe at(long long i) const {
    uint32_t wide = 0;
    return stark_mimc_load(consts + i * 16, wide);
  }
};

// Input i through `rounds` rounds with the kk constants of cs.
template <int POWER, class Consts>
STARK_HD void stark_mimc_one(const uint32_t* inp, Consts cs, long long kk,
                             long long rounds, bool cwide, uint32_t* out,
                             long long i) {
  uint32_t wide = 0;
  fe x = stark_mimc_load(inp + i * 16, wide);
  if (!wide && !cwide && rounds > 0) {
    long long ci = 0;
    fe next = cs.at(0);
    for (long long r = 0; r < rounds; ++r) {
      const fe c = next;
      if (++ci == kk) ci = 0;
      next = cs.at(ci);  // a round ahead of its use
      x = stark_mimc_round<POWER>(x, c);
    }
    x = fe_canon(x);
  }
  stark_mimc_store(out + i * 16, x, wide || cwide);
}

#if defined(__CUDACC__)
// The kk constants a launch reads: whether any is wide; staged into cs
// when STAGED.
template <int POWER, bool STAGED>
__global__ void __launch_bounds__(STARK_BLOCK)
stark_mimc_scan_kernel(const uint32_t* __restrict__ inp,
                       const uint32_t* __restrict__ consts, long long kk,
                       long long rounds, uint32_t* __restrict__ out,
                       long long n) {
  extern __shared__ fe stark_mimc_cs[];
  uint32_t wide = 0;
  for (long long r = threadIdx.x; r < kk; r += blockDim.x) {
    const fe c = stark_mimc_load(consts + r * 16, wide);
    if (STAGED) stark_mimc_cs[r] = c;
  }
  const bool cwide = __syncthreads_or(wide != 0) != 0;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (STAGED)
    stark_mimc_one<POWER>(inp, stark_mimc_staged{stark_mimc_cs}, kk, rounds,
                          cwide, out, i);
  else
    stark_mimc_one<POWER>(inp, stark_mimc_rows{consts}, kk, rounds, cwide,
                          out, i);
}

template <bool STAGED>
int stark_mimc_launch(const uint32_t* pi, const uint32_t* pc, long long kk,
                      long long rounds, int power, uint32_t* po, long long n,
                      cudaStream_t st) {
  const size_t smem = STAGED ? (size_t)kk * sizeof(fe) : 0;
  auto kernel = power == 3 ? stark_mimc_scan_kernel<3, STAGED>
                           : stark_mimc_scan_kernel<2, STAGED>;
  if (smem > 48 * 1024) {  // set for the current device at every launch
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((n + STARK_BLOCK - 1) / STARK_BLOCK);
  kernel<<<grid, STARK_BLOCK, smem, st>>>(pi, pc, kk, rounds, po, n);
  return (int)cudaGetLastError();
}
#else
template <bool STAGED>
int stark_mimc_launch(const uint32_t* pi, const uint32_t* pc, long long kk,
                      long long rounds, int power, uint32_t* po, long long n,
                      void*) {
  std::vector<fe> cs(STAGED ? (std::size_t)kk : 0);
  uint32_t wide = 0;
  for (long long r = 0; r < kk; ++r) {
    const fe c = stark_mimc_load(pc + r * 16, wide);
    if (STAGED) cs[(std::size_t)r] = c;
  }
  const bool cwide = wide != 0;
  for (long long i = 0; i < n; ++i) {
    if (STAGED && power == 3)
      stark_mimc_one<3>(pi, stark_mimc_staged{cs.data()}, kk, rounds, cwide,
                        po, i);
    else if (STAGED)
      stark_mimc_one<2>(pi, stark_mimc_staged{cs.data()}, kk, rounds, cwide,
                        po, i);
    else if (power == 3)
      stark_mimc_one<3>(pi, stark_mimc_rows{pc}, kk, rounds, cwide, po, i);
    else
      stark_mimc_one<2>(pi, stark_mimc_rows{pc}, kk, rounds, cwide, po, i);
  }
  return 0;
}
#endif

// inp [n, 16] and out [n, 16] limbs, consts [k, 16] limbs (16-byte
// aligned); out[i] = `rounds` rounds from inp[i].  Returns
// cudaGetLastError(), or 1 for a power other than 2 or 3, k < 1 or
// rounds < 0.
extern "C" int stark_mimc_scan(const void* inp, const void* consts,
                               long long k, long long rounds, int power,
                               void* out, long long n, void* stream) {
  const uint32_t* pi = static_cast<const uint32_t*>(inp);
  const uint32_t* pc = static_cast<const uint32_t*>(consts);
  uint32_t* po = static_cast<uint32_t*>(out);
  const long long kk = k < rounds ? k : rounds;  // the constants read
  if ((power != 2 && power != 3) || k < 1 || rounds < 0 || n < 0 ||
      !stark_aligned16(inp, 0) || !stark_aligned16(consts, 0) ||
      !stark_aligned16(out, 0))
    return 1;
  if (n == 0) return 0;
#if defined(__CUDACC__)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#else
  void* st = stream;
#endif
  if (kk <= STARK_MIMC_CONSTS_MAX)
    return stark_mimc_launch<true>(pi, pc, kk, rounds, power, po, n, st);
  return stark_mimc_launch<false>(pi, pc, kk, rounds, power, po, n, st);
}
