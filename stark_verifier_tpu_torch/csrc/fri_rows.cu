// FRI row check: stark_eval4_rows (kernel C).
//
// Replaces the TPU package's ops/fri_pallas.py kernel _make_row_kernel
// (behind eval4_rows).  Per FRI query it canonicalizes the four raw row
// values, evaluates the cubic through them at special_x by the even/odd
// split (see ops/quartic.py for the algebra) and writes the canonical result
// in the wire's 8-word big-endian encoding:
//
//   4 P(sx) = (y0+y1+y2+y3) + ((y0+y2)-(y1+y3)) v + (e + f v) u
//   e, f = (y0-y2) +- (y1-y3) g^-1,   u = sx / x1,   v = sx^2 / x1^2
//
// One thread per row group, everything in registers; g^-1 and 4^-1 arrive as
// kernel arguments (static per statement family).  x1^-1 and x1^-2 must be
// canonical (power-table gathers are).  special_x arrives RAW: each thread
// canonicalizes it and squares it itself.  The TPU package does that once
// per (proof, level) ahead of its kernel; here one more multiply per thread
// is cheaper than a separate pass of small launches.
//
// Bound on an H100: bytes, narrowly.  A row group moves about 290 bytes (128
// of rows, two 64-byte gathers, 32 out, a shared 64-byte operand) and does
// eight 256-bit multiplies with their reductions, about 1,700 integer
// instructions: 6 per byte, under the card's ratio of 10 between the
// instructions it can issue and the bytes it can move, so the 64-byte limb
// rows (16 bits of value per 32-bit word) cost more than the arithmetic.
#include "field256.cuh"

struct stark_row_consts {
  fe ginv;  // g^-1 = g^3, g the quartic root of unity
  fe inv4;  // 4^-1
};

STARK_HD void stark_eval4_one(long long i, const uint32_t* ys_words,
                              const uint32_t* sx, const uint32_t* x1i,
                              const uint32_t* x1sqi,
                              const stark_row_consts& k, long long group,
                              uint32_t* out) {
  fe y0 = fe_canon(fe_from_be_words(ys_words + i * 32));
  fe y1 = fe_canon(fe_from_be_words(ys_words + i * 32 + 8));
  fe y2 = fe_canon(fe_from_be_words(ys_words + i * 32 + 16));
  fe y3 = fe_canon(fe_from_be_words(ys_words + i * 32 + 24));
  long long p = i / group;  // the (proof, level) this row group belongs to
  fe sxc = fe_canon(fe_from_limbs16(sx + p * 16));
  fe sx2 = fe_mul(sxc, sxc);
  fe xi = fe_from_limbs16(x1i + i * 16);
  fe xsqi = fe_from_limbs16(x1sqi + i * 16);

  fe s02 = fe_add(y0, y2), s13 = fe_add(y1, y3);
  fe d02 = fe_sub(y0, y2);
  fe c1 = fe_mul(fe_sub(y1, y3), k.ginv);
  fe sa = fe_add(s02, s13), da = fe_sub(s02, s13);
  fe e = fe_add(d02, c1), f = fe_sub(d02, c1);
  fe v = fe_mul(sx2, xsqi);
  fe u = fe_mul(sxc, xi);
  fe efv = fe_add(e, fe_mul(f, v));
  // the two products and sa share one reduction
  fe_acc acc;
  fe_acc_zero(acc);
  fe_acc_mul(acc, da, v);
  fe_acc_mul(acc, efv, u);
  fe_acc_add(acc, sa);
  fe r = fe_mul(fe_reduce(acc), k.inv4);
  fe_to_be_words(r, out + i * 8);
}

#if defined(__CUDACC__)
__global__ void __launch_bounds__(STARK_BLOCK)
stark_eval4_kernel(const uint32_t* __restrict__ ys_words,
                   const uint32_t* __restrict__ sx,
                   const uint32_t* __restrict__ x1i,
                   const uint32_t* __restrict__ x1sqi, stark_row_consts k,
                   long long group, uint32_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) stark_eval4_one(i, ys_words, sx, x1i, x1sqi, k, group, out);
}
#endif

// ys_words [n, 4, 8] raw BE word rows; sx [n / group, 16] RAW 16-bit limbs
// (one per `group` consecutive rows); x1i, x1sqi [n, 16] canonical limbs; ginv8, inv4_8: HOST pointers to 8 little-endian 32-bit
// limbs each; out [n, 8] BE words.  Returns cudaGetLastError().
extern "C" int stark_eval4_rows(const void* ys_words, const void* sx,
                                const void* x1i, const void* x1sqi,
                                const uint32_t* ginv8,
                                const uint32_t* inv4_8, long long group,
                                void* out, long long n, void* stream) {
  stark_row_consts k;
  for (int j = 0; j < 8; ++j) {
    k.ginv.v[j] = ginv8[j];
    k.inv4.v[j] = inv4_8[j];
  }
  const uint32_t* y = static_cast<const uint32_t*>(ys_words);
  const uint32_t* a = static_cast<const uint32_t*>(sx);
  const uint32_t* c = static_cast<const uint32_t*>(x1i);
  const uint32_t* d = static_cast<const uint32_t*>(x1sqi);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (group <= 0) return 1;
  if (n <= 0) return 0;
#if defined(__CUDACC__)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned grid = (unsigned)((n + STARK_BLOCK - 1) / STARK_BLOCK);
  stark_eval4_kernel<<<grid, STARK_BLOCK, 0, st>>>(y, a, c, d, k, group, o, n);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (long long i = 0; i < n; ++i)
    stark_eval4_one(i, y, a, c, d, k, group, o);
  return 0;
#endif
}
