// Element-wise modular multiply: stark_mul_mod (kernel E).
//
// Replaces the TPU package's ops/field_pallas.py kernel _mul_mod_kernel
// (behind mul_mod; _mul_cols + _fold_canon).  That kernel works on limb-major
// [16, N] tiles of 16-bit limbs with split products and a Kogge-Stone carry,
// and its wrapper transposes both operands to get there.  Here one thread owns
// one element: it reads the 16 limbs of each operand as they lie in the public
// [.., 16] layout (64 bytes = four 128-bit loads), packs them to eight 32-bit
// limbs, multiplies and reduces with the core of field256.cuh, and writes the
// canonical result back as 16 limbs.
//
// An operand may repeat with a period (in elements): element i of the output
// reads operand element i % period.  That covers every broadcast whose
// smaller operand is a trailing block of the larger one -- a [16] constant
// (period 1), a [half, 16] twiddle table against [blocks, half, 16] butterfly
// inputs -- without a materialized copy.
//
// Limbs must be < 2^16.  An element with any larger limb on either side does
// not wrap silently: its result is sixteen 0xFFFFFFFF words, which is no
// valid element, equals none, and poisons every later product it enters.
//
// Bound on an H100: bytes.  An element moves 192 bytes (16-bit limbs one per
// 32-bit word) for one 256-bit product and one reduction, about 340
// instructions of arithmetic (probe_mul of csrc/probes/work.cu in the SASS):
// 1.8 per byte, under the card's 10 (33.5 T instructions a second over 3.35
// TB/s).  Packing the public layout to 8 words a value would cut the
// traffic in half; it is kept equal to the TPU package's so that the two
// compare array for array.
#include "field256.cuh"

STARK_HD void stark_mul_mod_one(long long i, const uint32_t* a,
                                long long a_period, const uint32_t* b,
                                long long b_period, uint32_t* out) {
  uint32_t ta[16], tb[16], r[16];
  const uint32_t* pa = a + (i % a_period) * 16;
  const uint32_t* pb = b + (i % b_period) * 16;
  stark_ld8(pa, ta);
  stark_ld8(pa + 8, ta + 8);
  stark_ld8(pb, tb);
  stark_ld8(pb + 8, tb + 8);
  uint32_t seen = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) seen |= ta[k] | tb[k];
  if (seen >> 16) {
#pragma unroll
    for (int k = 0; k < 16; ++k) r[k] = 0xFFFFFFFFu;
  } else {
    fe x, y;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      x.v[k] = ta[2 * k] | (ta[2 * k + 1] << 16);
      y.v[k] = tb[2 * k] | (tb[2 * k + 1] << 16);
    }
    fe p = fe_mul(x, y);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      r[2 * k] = p.v[k] & 0xFFFFu;
      r[2 * k + 1] = p.v[k] >> 16;
    }
  }
  stark_st8(out + i * 16, r);
  stark_st8(out + i * 16 + 8, r + 8);
}

#if defined(__CUDACC__)
__global__ void __launch_bounds__(STARK_BLOCK)
stark_mul_mod_kernel(const uint32_t* __restrict__ a, long long a_period,
                     const uint32_t* __restrict__ b, long long b_period,
                     uint32_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) stark_mul_mod_one(i, a, a_period, b, b_period, out);
}
#endif

// a [a_period, 16], b [b_period, 16] limbs (16-byte aligned); out [n, 16];
// output element i = a[i % a_period] * b[i % b_period] mod p, canonical.
// Returns cudaGetLastError() (1 = cudaErrorInvalidValue for a period < 1).
extern "C" int stark_mul_mod(const void* a, long long a_period, const void* b,
                             long long b_period, void* out, long long n,
                             void* stream) {
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (a_period < 1 || b_period < 1) return 1;
  if (n <= 0) return 0;
#if defined(__CUDACC__)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned grid = (unsigned)((n + STARK_BLOCK - 1) / STARK_BLOCK);
  stark_mul_mod_kernel<<<grid, STARK_BLOCK, 0, st>>>(pa, a_period, pb, b_period,
                                                     o, n);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (long long i = 0; i < n; ++i)
    stark_mul_mod_one(i, pa, a_period, pb, b_period, o);
  return 0;
#endif
}
