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
// words, 64 bytes each) plus 384 shared per proof, and does eleven 256-bit
// multiplies and six reductions, about 1,900 integer instructions: 3 per
// byte, under the card's ratio of 10 between the instructions it can issue
// and the bytes it can move.  Packing the operands to 8 words a value would
// halve the traffic; the layout is kept equal to the TPU package's public
// one for now so that the two compare array for array.
#include "field256.cuh"

template <int POWER>
STARK_HD void stark_spot_one(long long i, const uint32_t* raw5,
                             const uint32_t* tab5, const uint32_t* ks4,
                             const uint32_t* ic1, const uint32_t* ic0,
                             long long group, uint32_t* out) {
  const uint32_t* r = raw5 + i * 80;
  const uint32_t* t = tab5 + i * 80;
  fe p = fe_canon(fe_from_limbs16(r));
  fe pg1 = fe_canon(fe_from_limbs16(r + 16));
  fe d = fe_canon(fe_from_limbs16(r + 32));
  fe b = fe_canon(fe_from_limbs16(r + 48));
  fe l = fe_canon(fe_from_limbs16(r + 64));
  fe x = fe_from_limbs16(t);
  fe xs = fe_from_limbs16(t + 16);
  fe z = fe_from_limbs16(t + 32);
  fe z2 = fe_from_limbs16(t + 48);
  fe kx = fe_from_limbs16(t + 64);
  long long q = i / group;  // the proof this position belongs to
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
  fe_acc_mul(acc, fe_from_limbs16(ic1 + q * 16), x);
  fe_acc_add(acc, fe_from_limbs16(ic0 + q * 16));
  ok |= fe_eq(p, fe_reduce(acc)) ? 2u : 0u;

  // lincomb (raw k's)
  fe p_xs = fe_mul(p, xs);
  fe b_xs = fe_mul(b, xs);
  const uint32_t* k = ks4 + q * 64;
  fe_acc_zero(acc);
  fe_acc_mul(acc, fe_from_limbs16(k), p);
  fe_acc_mul(acc, fe_from_limbs16(k + 16), p_xs);
  fe_acc_mul(acc, fe_from_limbs16(k + 32), b);
  fe_acc_mul(acc, fe_from_limbs16(k + 48), b_xs);
  fe_acc_add(acc, d);
  ok |= fe_eq(l, fe_reduce(acc)) ? 4u : 0u;

  out[i] = ok;
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
