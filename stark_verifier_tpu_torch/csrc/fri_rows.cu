// FRI row check: stark_fri_rows (kernel C).
//
// Replaces the TPU package's ops/fri_pallas.py kernel _make_row_kernel
// (behind eval4_rows) together with the verifier glue around it
// (protocol/verify.py, _fri_checks): the limbs of special_x, the index
// arithmetic and the two power-table gathers before the kernel, the compare
// with the committed column value after it.  Per FRI row group (a proof, a
// level l, a query k) one thread
//
//   * reads the level's poly rows 4k .. 4k+3 where they lie in the proof
//     (8 big-endian words each, raw) and canonicalizes them;
//   * takes special_x, the previous level's root (l_merkle_root at level 0,
//     root2[l-1] after), as a raw 256-bit value (the reference's unreduced
//     special_x, main.rs:54) and canonicalizes it;
//   * forms e1 = y * 4^l = y << 2l in 32-bit wrap-around (y the query's
//     column index, as the reference's uint32 arithmetic) and gathers
//     x1^-1 = G2^(-e1) from the packed power table (8 little-endian words a
//     row, `rows` a power of two, indices masked by rows - 1);
//   * evaluates the cubic through the four rows at special_x by the even /
//     odd split (see ops/quartic.py for the algebra):
//
//       4 P(sx) = (y0+y1+y2+y3) + ((y0+y2)-(y1+y3)) v + (e + f v) u
//       e, f = (y0-y2) +- (y1-y3) g^-1,   u = sx / x1,   v = u^2
//
//     (v is sx^2 / x1^2, the square of u: G2 has order `rows`, so the
//     table row -2 e1 that the TPU kernel gathers for it is the square of
//     row -e1, and special_x needs no square of its own);
//   * holds P(sx) against the raw committed column value c, as the
//     reference's unreduced compare does (main.rs:84-86): c must be
//     canonical, and then 4 c = 4 P(sx) (mod p), 4 being invertible, so
//     that the product by 4^-1 is left out; writes one ok byte, and
//     P(sx)'s 8 big-endian words when the caller asks for them (the one
//     product more, then).
//
// What bounds it on an H100: the arithmetic.  A row group needs about
// 2,900 instructions of products, reductions, adds and compares
// (probe_eval4_row of csrc/probes/work.cu in the SASS: six 256-bit
// products, five reductions) against some 170 bytes: 17 instructions a
// byte, where the card issues 10 for each byte it moves.  The thread
// issues about 1.3 times that (loads, byte swaps, addresses) and runs at
// about half the issue rate, as kernel D does: on an H100 80GB HBM3 at
// 700 W, 512 proofs take 0.022 ms, 2.5x of the bound.  Forming v from a
// square of special_x and a second gather instead, per thread or once per
// (proof, level) in shared memory, took 1.2x as long; a cap of 80
// registers (5 blocks an SM, the launch in one wave) gained nothing.
#include "field256.cuh"

// 5 warps; at about 95 registers a thread, 4 blocks an SM
#define STARK_FRI_BLOCK 160

struct stark_row_consts {
  fe ginv;  // g^-1 = g^3, g the quartic root of unity
  fe inv4;  // 4^-1
};

// The operands of kernel C (the host's ctypes structure and the kernel's
// parameter share this layout).  Strides are in words between proofs; the
// rest of each operand is dense.
//   poly [proofs, levels, 4 q, 8]: the FRI poly value rows (big endian);
//   col [proofs, levels, q, 8]: the committed column values (big endian);
//   ys [proofs * levels * q] the column indices (int64, dense, < 2^32);
//   lroot [proofs, 8], root2 [proofs, levels, 8]: the roots (big endian);
//   g2 [rows, 8]: G2^i (little endian, canonical), rows a power of two and
//     the order of G2;
//   ok [proofs * levels * q] bytes; lhs [proofs * levels * q, 8] (big
//   endian) or null.
struct stark_fri_rows_args {
  const uint32_t* poly;
  const uint32_t* col;
  const long long* ys;
  const uint32_t* lroot;
  const uint32_t* root2;
  const uint32_t* g2;
  uint8_t* ok;
  uint32_t* lhs;
  long long poly_stride;
  long long col_stride;
  long long lroot_stride;
  long long root2_stride;
  long long rows;
  long long levels;
  long long q;
  long long n;
  stark_row_consts k;
};

// The arithmetic of one row group: raw y0..y3, u and v -> 4 P(special_x),
// canonical.
STARK_HD fe stark_eval4_core(const fe& y0r, const fe& y1r, const fe& y2r,
                             const fe& y3r, const fe& u, const fe& v,
                             const stark_row_consts& k) {
  fe y0 = fe_canon(y0r), y1 = fe_canon(y1r);
  fe y2 = fe_canon(y2r), y3 = fe_canon(y3r);
  fe s02 = fe_add(y0, y2), s13 = fe_add(y1, y3);
  fe d02 = fe_sub(y0, y2);
  fe c1 = fe_mul(fe_sub(y1, y3), k.ginv);
  fe sa = fe_add(s02, s13), da = fe_sub(s02, s13);
  fe e = fe_add(d02, c1), f = fe_sub(d02, c1);
  fe efv = fe_add(e, fe_mul(f, v));
  // the two products and sa share one reduction
  fe_acc acc;
  fe_acc_zero(acc);
  fe_acc_mul(acc, da, v);
  fe_acc_mul(acc, efv, u);
  fe_acc_add(acc, sa);
  return fe_reduce(acc);
}

// 4 a mod p, canonical, for a canonical a: 4 a = lo + 2^256 h with h < 4,
// and 2^256 = C (mod p).
STARK_HD fe fe_times4(const fe& a) {
  fe r, u;
  const uint32_t h = a.v[7] >> 30;
  uint64_t t = (uint64_t)(a.v[0] << 2) + (uint64_t)h * FE_C0;
  r.v[0] = (uint32_t)t;
  t = (uint64_t)((a.v[1] << 2) | (a.v[0] >> 30)) + (uint64_t)h * FE_C1 +
      (t >> 32);
  r.v[1] = (uint32_t)t;
#pragma unroll
  for (int j = 2; j < 8; ++j) {
    t = (uint64_t)((a.v[j] << 2) | (a.v[j - 1] >> 30)) + (t >> 32);
    r.v[j] = (uint32_t)t;
  }
  // a carry out of bit 255 leaves r below 2^43: 2^256 = C once more.
  // Limb by limb: a choice between two values put them on the stack.
  const bool carry = (uint32_t)(t >> 32) != 0;
  fe_add_c(r, u);
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = carry ? u.v[j] : r.v[j];
  return fe_canon(r);
}

// The raw committed value c equals P(special_x), given 4 P canonical: c is
// canonical (c + C does not reach 2^256) and 4 c = 4 P.
STARK_HD bool stark_fri_holds(const fe& c, const fe& p4) {
  fe u;
  return !fe_add_c(c, u) && fe_eq(fe_times4(c), p4);
}

// Row group i: its operands where they lie, the check, its ok byte (and
// its evaluation's words).
STARK_HD void stark_fri_row(const stark_fri_rows_args& g, long long i) {
  // n < 2^31 (checked by the entry point): 32-bit divisions
  const uint32_t pl = (uint32_t)i / (uint32_t)g.q;  // (proof, level)
  const uint32_t kq = (uint32_t)i - pl * (uint32_t)g.q;
  const uint32_t pr = pl / (uint32_t)g.levels;
  const uint32_t l = pl - pr * (uint32_t)g.levels;
  const long long at = (long long)l * g.q + kq;
  const uint32_t* rows = g.poly + pr * g.poly_stride + at * 32;
  const uint32_t* sx = l == 0 ? g.lroot + pr * g.lroot_stride
                              : g.root2 + pr * g.root2_stride + (l - 1) * 8;
  // levels <= 16 (checked by the entry point): the shift stays below 32
  const uint32_t e1 = (uint32_t)g.ys[i] << (2 * l);
  const unsigned long long mask = (unsigned long long)g.rows - 1;
  const fe x1_inv = fe_from_le_words(g.g2 + ((0u - e1) & mask) * 8);
  const fe u = fe_mul(fe_canon(fe_from_be_words(sx)), x1_inv);
  const fe p4 = stark_eval4_core(
      fe_from_be_words(rows), fe_from_be_words(rows + 8),
      fe_from_be_words(rows + 16), fe_from_be_words(rows + 24), u,
      fe_mul(u, u), g.k);
  g.ok[i] = stark_fri_holds(
      fe_from_be_words(g.col + pr * g.col_stride + at * 8), p4);
  if (g.lhs) fe_to_be_words(fe_mul(p4, g.k.inv4), g.lhs + i * 8);
}

#if defined(__CUDACC__)
__global__ void __launch_bounds__(STARK_FRI_BLOCK)
stark_fri_rows_kernel(const __grid_constant__ stark_fri_rows_args g) {
  const long long i = (long long)blockIdx.x * STARK_FRI_BLOCK + threadIdx.x;
  if (i < g.n) stark_fri_row(g, i);
}
#endif

// Kernel C over args->n row groups.  Returns 1 (cudaErrorInvalidValue)
// without writing anything for a bad argument, else cudaGetLastError().
extern "C" int stark_fri_rows(const void* args, void* stream) {
  const stark_fri_rows_args& g =
      *static_cast<const stark_fri_rows_args*>(args);
  if (g.q <= 0 || g.levels <= 0 || g.levels > 16 || g.n < 0 ||
      g.n > 0x7FFFFFFFLL || g.n % (g.q * g.levels) != 0 ||
      !stark_pow2(g.rows) || g.rows > (1LL << 32))
    return 1;
  if (g.n == 0) return 0;
  if (!stark_aligned16(g.poly, g.poly_stride) ||
      !stark_aligned16(g.col, g.col_stride) ||
      !stark_aligned16(g.lroot, g.lroot_stride) ||
      !stark_aligned16(g.root2, g.root2_stride) ||
      !stark_aligned16(g.g2, 0) || !stark_aligned16(g.lhs, 0) ||
      g.poly == nullptr || g.col == nullptr || g.lroot == nullptr ||
      g.root2 == nullptr || g.g2 == nullptr || g.ys == nullptr ||
      g.ok == nullptr)
    return 1;
#if defined(__CUDACC__)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid =
      (unsigned)((g.n + STARK_FRI_BLOCK - 1) / STARK_FRI_BLOCK);
  stark_fri_rows_kernel<<<grid, STARK_FRI_BLOCK, 0, st>>>(g);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (long long i = 0; i < g.n; ++i) stark_fri_row(g, i);
  return 0;
#endif
}
