// The MiMC trace scan: stark_mimc_scan.
//
// Replaces the TPU package's ops/mimc.py mimc (a lax.scan of the round
// x <- x^power + c_(i mod k) over the cycled round constants), which XLA
// compiles to a loop of element-wise operations over 16-bit limbs.  No
// pl.pallas_call stands behind it; the port gives it a kernel because the
// same loop in plain torch is hundreds of device launches a round, millions
// for one 8,192-step output.
//
// One thread takes one input and runs `rounds` rounds in registers:
//   power 3: acc = (x * x mod p) * x + c;   power 2: acc = x * x + c;
//   x = acc mod p (one reduction a round, fe_reduce)
// as the plain version's mul_mod and mul_sum_mod do; the input may be any
// value < 2^256 (the first product takes it raw) and every round's result
// is canonical.  The constants [k, 16] are read from global memory each
// round (the same row for every thread of the launch, so it comes from the
// cache).  Limbs must be < 2^16: an input with a wider limb, or any
// constant with one, gives sixteen 0xFFFFFFFF words, as kernel E does.
//
// What bounds it on an H100: the chain.  Round i + 1 needs round i, so one
// input takes rounds x the latency of a round (about 790 instructions at
// power 3, probe_mimc3 of csrc/probes/work.cu in the SASS); the card's
// issue rate bounds it only once enough inputs are in flight to cover that
// latency (tens of thousands of threads).  On an H100 80GB HBM3 at 700 W a
// round takes about 1.1 us: 8,192 steps take 9.3 ms for one input and for
// 1,024 alike.
#include "field256.cuh"

template <int POWER>
STARK_HD fe stark_mimc_round(const fe& x, const fe& c) {
  fe_acc acc;
  fe_acc_zero(acc);
  if constexpr (POWER == 3) {
    fe_acc_mul(acc, fe_mul(x, x), x);
  } else {
    fe_acc_mul(acc, x, x);
  }
  fe_acc_add(acc, c);
  return fe_reduce(acc);
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

template <int POWER>
STARK_HD void stark_mimc_one(const uint32_t* inp, const uint32_t* consts,
                             long long k, long long rounds, uint32_t* out,
                             long long i) {
  uint32_t wide = 0;
  fe x = stark_mimc_load(inp + i * 16, wide);
  long long ci = 0;
  for (long long r = 0; r < rounds; ++r) {
    x = stark_mimc_round<POWER>(x, stark_mimc_load(consts + ci * 16, wide));
    if (++ci == k) ci = 0;
  }
  uint32_t o[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[2 * j] = wide ? 0xFFFFFFFFu : (x.v[j] & 0xFFFFu);
    o[2 * j + 1] = wide ? 0xFFFFFFFFu : (x.v[j] >> 16);
  }
  stark_st8(out + i * 16, o);
  stark_st8(out + i * 16 + 8, o + 8);
}

#if defined(__CUDACC__)
template <int POWER>
__global__ void __launch_bounds__(STARK_BLOCK)
stark_mimc_scan_kernel(const uint32_t* __restrict__ inp,
                       const uint32_t* __restrict__ consts, long long k,
                       long long rounds, uint32_t* __restrict__ out,
                       long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) stark_mimc_one<POWER>(inp, consts, k, rounds, out, i);
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
  if ((power != 2 && power != 3) || k < 1 || rounds < 0 || n < 0 ||
      !stark_aligned16(inp, 0) || !stark_aligned16(consts, 0) ||
      !stark_aligned16(out, 0))
    return 1;
  if (n == 0) return 0;
#if defined(__CUDACC__)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((n + STARK_BLOCK - 1) / STARK_BLOCK);
  if (power == 3)
    stark_mimc_scan_kernel<3><<<grid, STARK_BLOCK, 0, st>>>(pi, pc, k, rounds,
                                                            po, n);
  else
    stark_mimc_scan_kernel<2><<<grid, STARK_BLOCK, 0, st>>>(pi, pc, k, rounds,
                                                            po, n);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (long long i = 0; i < n; ++i) {
    if (power == 3)
      stark_mimc_one<3>(pi, pc, k, rounds, po, i);
    else
      stark_mimc_one<2>(pi, pc, k, rounds, po, i);
  }
  return 0;
#endif
}
