// Constraint spot checks: stark_spot_checks (kernel D).
//
// Replaces the TPU package's ops/spot_pallas.py kernel _make_spot_kernel
// (behind spot_checks).  Per spot position it canonicalizes the raw trace
// values P(x), P(g1 x), D(x), B(x), L(x) and checks the three constraint
// families, each right-hand side through ONE reduction of a sum of products:
//
//   transition  P(g1 x) == P^power + Z D + K         (power 3, or 2)
//   boundary    P(x)    == B Z2 + I1 x + I0
//   lincomb     L(x)    == k1 P + k2 P x^s + k3 B + k4 B x^s + D
//
// k1..k4 enter raw (any value < 2^256), as the reference multiplies them
// unreduced; the 18-limb accumulator holds the four such products plus D.
// Output: bit 0 / 1 / 2 of one word per position = transition / boundary /
// lincomb holds.
//
// One thread per position, all values in registers.  Bound on an H100: bytes.
// A position reads 640 bytes of its own (ten values as 16-bit limbs in 32-bit
// words, 64 bytes each) plus 384 shared per proof, and the function needs
// about 4,000 instructions of arithmetic for power 3 and 3,600 for power 2
// (probe_spot3 / probe_spot2 of csrc/probes/work.cu in the SASS): 6 per
// byte, under the card's 10 (33.5 T instructions a second over 3.35 TB/s).
// Each operand is read where it is first used, which keeps the thread near
// 110 registers.  Packing the operands to 8 words a value would halve the
// traffic; the layout is kept equal to the TPU package's public one for now
// so that the two compare array for array.
#include "field256.cuh"

// The arithmetic of one position.  v(j) is its operand j as a field
// element: 0..4 P(x), P(g1 x), D(x), B(x), L(x), raw; 5..9 x, x^steps, Z, Z2,
// K, canonical; 10..13 k1..k4, raw; 14, 15 I1, I0, canonical.  Returns the
// three bits.
template <int POWER, class Operands>
STARK_HD uint32_t stark_spot_core(const Operands& v) {
  fe p = fe_canon(v(0));
  fe pg1 = fe_canon(v(1));
  fe d = fe_canon(v(2));
  fe b = fe_canon(v(3));
  fe l = fe_canon(v(4));
  fe x = v(5), xs = v(6), z = v(7), z2 = v(8), kx = v(9);
  uint32_t ok = 0;
  fe_acc acc;

  // transition
  fe_acc_zero(acc);
  if (POWER == 3)
    fe_acc_mul(acc, fe_mul(p, p), p);
  else
    fe_acc_mul(acc, p, p);
  fe_acc_mul(acc, z, d);
  fe_acc_add(acc, kx);
  ok |= fe_eq(pg1, fe_reduce(acc)) ? 1u : 0u;

  // boundary
  fe_acc_zero(acc);
  fe_acc_mul(acc, b, z2);
  fe_acc_mul(acc, v(14), x);
  fe_acc_add(acc, v(15));
  ok |= fe_eq(p, fe_reduce(acc)) ? 2u : 0u;

  // lincomb (raw k's)
  fe p_xs = fe_mul(p, xs);
  fe b_xs = fe_mul(b, xs);
  fe_acc_zero(acc);
  fe_acc_mul(acc, v(10), p);
  fe_acc_mul(acc, v(11), p_xs);
  fe_acc_mul(acc, v(12), b);
  fe_acc_mul(acc, v(13), b_xs);
  fe_acc_add(acc, d);
  ok |= fe_eq(l, fe_reduce(acc)) ? 4u : 0u;
  return ok;
}

// A position's operands where they lie: its own rows of raw5 and tab5, its
// proof's rows of ks4, ic1 and ic0, as 16-bit limbs.
struct stark_spot_limbs {
  const uint32_t* raw;
  const uint32_t* tab;
  const uint32_t* ks;
  const uint32_t* ic1;
  const uint32_t* ic0;
  STARK_HD fe operator()(int j) const {
    return fe_from_limbs16(j < 5 ? raw + 16 * j
                           : j < 10 ? tab + 16 * (j - 5)
                           : j < 14 ? ks + 16 * (j - 10)
                           : j == 14 ? ic1 : ic0);
  }
};

template <int POWER>
STARK_HD void stark_spot_one(long long i, const uint32_t* raw5,
                             const uint32_t* tab5, const uint32_t* ks4,
                             const uint32_t* ic1, const uint32_t* ic0,
                             long long group, uint32_t* out) {
  long long q = i / group;  // the proof this position belongs to
  stark_spot_limbs v = {raw5 + i * 80, tab5 + i * 80, ks4 + q * 64,
                        ic1 + q * 16, ic0 + q * 16};
  out[i] = stark_spot_core<POWER>(v);
}

#if defined(__CUDACC__)
template <int POWER>
__global__ void __launch_bounds__(STARK_BLOCK)
stark_spot_kernel(const uint32_t* __restrict__ raw5,
                  const uint32_t* __restrict__ tab5,
                  const uint32_t* __restrict__ ks4,
                  const uint32_t* __restrict__ ic1,
                  const uint32_t* __restrict__ ic0, long long group,
                  uint32_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) stark_spot_one<POWER>(i, raw5, tab5, ks4, ic1, ic0, group, out);
}
#endif

// raw5 [n, 5, 16] raw limbs (P, Pg1, D, B, L); tab5 [n, 5, 16] canonical
// limbs (x, x^steps, Z, Z2, K); ks4 [n / group, 4, 16] raw; ic1, ic0
// [n / group, 16] canonical (one per `group` consecutive positions); out [n]
// words of 3 bits.  power must be 2 or 3.  Returns cudaGetLastError()
// (1 = cudaErrorInvalidValue for a bad argument).
extern "C" int stark_spot_checks(const void* raw5, const void* tab5,
                                 const void* ks4, const void* ic1,
                                 const void* ic0, long long group, int power,
                                 void* out, long long n, void* stream) {
  const uint32_t* r = static_cast<const uint32_t*>(raw5);
  const uint32_t* t = static_cast<const uint32_t*>(tab5);
  const uint32_t* k = static_cast<const uint32_t*>(ks4);
  const uint32_t* a = static_cast<const uint32_t*>(ic1);
  const uint32_t* b = static_cast<const uint32_t*>(ic0);
  uint32_t* o = static_cast<uint32_t*>(out);
  if ((power != 2 && power != 3) || group <= 0) return 1;
  if (n <= 0) return 0;
#if defined(__CUDACC__)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned grid = (unsigned)((n + STARK_BLOCK - 1) / STARK_BLOCK);
  if (power == 3)
    stark_spot_kernel<3><<<grid, STARK_BLOCK, 0, st>>>(r, t, k, a, b, group, o,
                                                       n);
  else
    stark_spot_kernel<2><<<grid, STARK_BLOCK, 0, st>>>(r, t, k, a, b, group, o,
                                                       n);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (long long i = 0; i < n; ++i) {
    if (power == 3)
      stark_spot_one<3>(i, r, t, k, a, b, group, o);
    else
      stark_spot_one<2>(i, r, t, k, a, b, group, o);
  }
  return 0;
#endif
}
