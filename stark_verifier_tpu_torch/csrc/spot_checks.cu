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
// unreduced.  Output: three bytes a position, 1 where the transition /
// boundary / lincomb holds, else 0 (a bool tensor [..., 3] to the caller).
//
// The TPU kernel takes its operands as 16-bit limb tiles that plain JAX
// converts, gathers and stacks first.  This one reads them where they lie:
// the proof's own main and lincomb value rows (32-byte big-endian values,
// byte-swapped in registers), the raw k-hash words, the spot positions, and
// four statement tables of 8 little-endian words a row (the powers of G2,
// Z, Z2, K), from which it gathers x, x^steps, Z(x), Z2(x) and K(x) itself.
// On the runtime-statement path the K table is the call's own.
//
// What bounds it on an H100: the arithmetic, by issue.  A position needs
// about 3,900 instructions of products, reductions and compares at power 3
// (3,500 at power 2: probe_spot3 / probe_spot2 of csrc/probes/work.cu in
// the SASS) against some 330 bytes, 12 an instruction where the card moves
// 10.  FOUR lanes of a warp take a position, each one part of it through
// the same instruction stream, so no lane waits on another's branch:
//
//   lane 0  transition        P * P^(power-1) + Z * D + K
//   lane 1  boundary          B * Z2 + I1 * x + I0
//   lane 2  lincomb, half 1   k1 * P + k2 * (P x^s)
//   lane 3  lincomb, half 2   k3 * B + k4 * (B x^s) + D
//
// Every part is one reduced product (P^2, P x^s or B x^s; lane 1's is
// discarded), two products and an addend into an 18-limb accumulator.
// Lanes 2 and 3 add their accumulators by shuffle before the one reduction;
// lanes 0, 1 and 2 each write their verdict's byte.  The host build runs
// the four parts of a position in turn through the same functions: that is
// what the g++ tests hold against the plain version.  On an H100 80GB HBM3
// at 700 W, 512 proofs: 0.015 ms, 3.1x of its bound.  One thread a position
// on the same operands ran exactly as fast as four lanes, so four times the
// warps in flight did not move it; a lane issues 1,595 instructions (the
// SASS), 1.6x the bound's count a position, and runs at about half of the
// issue rate.
#include "field256.cuh"

// Where an operand slot of a part comes from, and how it is read.
#define STARK_SPOT_BE_RAW 0    // 8 big-endian words, as they are
#define STARK_SPOT_BE_CANON 1  // 8 big-endian words, canonicalized
#define STARK_SPOT_LE 2        // 8 little-endian words (a table row)
#define STARK_SPOT_LIMBS 3     // 16 little-endian 16-bit limbs
#define STARK_SPOT_ZERO 4      // 0

// The operands of kernel D (the host's ctypes structure and the kernel's
// parameter share this layout).  Strides are in words between proofs.
//   main [proofs, 2 group, 24]: row 2k holds P, D, B at position k, row
//     2k+1 P(g1 x) in its first 8 words (big endian);
//   lin [proofs, group, 8]: L(x) (big endian);
//   pos [proofs * group] positions (int64, dense);
//   kh [proofs, 4, 8]: k1..k4 (big endian, raw);
//   ic1, ic0 [proofs, 16]: I1, I0 as 16-bit limbs, canonical (stride 0:
//     one row for every proof);
//   g2, z, z2 [rows, 8] with rows a power of two; k [k_rows, 8] (a power of
//     two): canonical, little endian.  x = g2[pos], x^steps =
//     g2[pos << log_steps], Z(x) = z[pos], Z2(x) = z2[pos] (indices masked
//     by rows - 1), K(x) = k[pos & (k_rows - 1)];
//   out [proofs * group, 3] bytes.
struct stark_spot_args {
  const uint32_t* main;
  const uint32_t* lin;
  const long long* pos;
  const uint32_t* kh;
  const uint32_t* ic1;
  const uint32_t* ic0;
  const uint32_t* g2;
  const uint32_t* z;
  const uint32_t* z2;
  const uint32_t* k;
  uint8_t* out;
  long long main_stride;
  long long lin_stride;
  long long kh_stride;
  long long ic1_stride;
  long long ic0_stride;
  long long rows;
  long long k_rows;
  long long group;
  long long n;
  int log_steps;
  int power;
};

// c ? a : b limb by limb.  A conditional between two field elements in
// memory is a choice of address: with c known only at run time it puts both
// on the stack; selects keep them in registers.
STARK_HD fe fe_sel(bool c, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = c ? a.v[k] : b.v[k];
  return r;
}

// One operand slot read by its kind.
STARK_HD fe stark_spot_load(const uint32_t* p, int kind) {
  fe r;
  if (kind == STARK_SPOT_ZERO) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r.v[j] = 0;
    return r;
  }
  if (kind == STARK_SPOT_LIMBS) return fe_from_limbs16(p);
  uint32_t t[8];
  stark_ld8(p, t);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    r.v[j] = kind == STARK_SPOT_LE ? t[j] : fe_bswap(t[7 - j]);
  return fe_sel(kind == STARK_SPOT_BE_CANON, fe_canon(r), r);
}

// The field elements one part works on (see the table above):
//   pre = s * (role 0: s, else xs), the part's reduced product;
//   acc = a * s + c * d + e, with a = pre at role 0 and power 3 (s at role
//   0 and power 2), d = pre at roles 2 and 3;
//   lhs, the committed value its right-hand side must equal.
struct stark_spot_part_in {
  fe s, xs, a, c, d, e, lhs;
};

// A part's reduced product and accumulator.  With `role` known when it is
// compiled (the host loop, the probes) the product a part does not use is
// left out; on the card it is computed and dropped, so the four lanes run
// one instruction stream.
template <int POWER>
STARK_HD void stark_spot_part(int role, const stark_spot_part_in& in,
                              fe_acc& acc) {
  const fe pre = fe_mul(in.s, fe_sel(role == 0, in.s, in.xs));
  const fe a = fe_sel(role == 0, fe_sel(POWER == 3, pre, in.s), in.a);
  const fe d = fe_sel(role >= 2, pre, in.d);
  fe_acc_zero(acc);
  fe_acc_mul(acc, a, in.s);
  fe_acc_mul(acc, in.c, d);
  fe_acc_add(acc, in.e);
}

// Position i's operand slots for one part: pointers and kinds by role.
STARK_HD stark_spot_part_in stark_spot_operands(const stark_spot_args& g,
                                                long long i, int role) {
  // n < 2^31 (checked by the entry point): a 32-bit division
  const long long q = (long long)((uint32_t)i / (uint32_t)g.group);
  const long long kx = i - q * g.group;
  const uint32_t* row = g.main + q * g.main_stride + kx * 48;  // row 2k
  const uint32_t* p = row;
  const uint32_t* d = row + 8;
  const uint32_t* b = row + 16;
  const uint32_t* pg1 = row + 24;
  const uint32_t* l = g.lin + q * g.lin_stride + kx * 8;
  const uint32_t* ks = g.kh + q * g.kh_stride;
  // the positions' bits as unsigned: a table index is masked, never out of
  // range
  const unsigned long long pos = (unsigned long long)g.pos[i];
  const unsigned long long mask = (unsigned long long)g.rows - 1;
  const uint32_t* x = g.g2 + (pos & mask) * 8;
  const uint32_t* xs = g.g2 + ((pos << g.log_steps) & mask) * 8;
  const uint32_t* z = g.z + (pos & mask) * 8;
  const uint32_t* z2 = g.z2 + (pos & mask) * 8;
  const uint32_t* kv = g.k + (pos & ((unsigned long long)g.k_rows - 1)) * 8;
  const uint32_t* ic1 = g.ic1 + q * g.ic1_stride;
  const uint32_t* ic0 = g.ic0 + q * g.ic0_stride;
  // role:            0 transition  1 boundary  2 lincomb 1  3 lincomb 2
  const uint32_t* sp = role & 1 ? b : p;
  const uint32_t* ap = role == 3 ? ks + 16 : role == 2 ? ks : z2;
  const uint32_t* cp = role == 0 ? z : role == 1 ? ic1 : ks + 16 * role - 24;
  const uint32_t* dp = role == 0 ? d : x;
  const uint32_t* ep = role == 0 ? kv : role == 1 ? ic0 : d;
  const uint32_t* lp = role == 0 ? pg1 : role == 1 ? p : l;
  const int ck = role == 0 ? STARK_SPOT_LE
               : role == 1 ? STARK_SPOT_LIMBS : STARK_SPOT_BE_RAW;
  const int ek = role == 0 ? STARK_SPOT_LE
               : role == 1 ? STARK_SPOT_LIMBS
               : role == 2 ? STARK_SPOT_ZERO : STARK_SPOT_BE_CANON;
  stark_spot_part_in in;
  in.s = stark_spot_load(sp, STARK_SPOT_BE_CANON);
  in.xs = stark_spot_load(xs, STARK_SPOT_LE);
  in.a = stark_spot_load(ap, role == 1 ? STARK_SPOT_LE : STARK_SPOT_BE_RAW);
  in.c = stark_spot_load(cp, ck);
  in.d = stark_spot_load(dp, role == 0 ? STARK_SPOT_BE_CANON : STARK_SPOT_LE);
  in.e = stark_spot_load(ep, ek);
  in.lhs = stark_spot_load(lp, STARK_SPOT_BE_CANON);
  return in;
}

// acc += other (both below 2^575: no carry out).
STARK_HD void fe_acc_add_acc(fe_acc& acc, const fe_acc& other) {
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < FE_ACC; ++k) {
    uint64_t t = (uint64_t)acc.v[k] + other.v[k] + carry;
    acc.v[k] = (uint32_t)t;
    carry = t >> 32;
  }
}

// Position i in one thread (the host build): the four parts in turn, the
// lincomb halves added before their one reduction.
template <int POWER>
STARK_HD void stark_spot_position(const stark_spot_args& g, long long i) {
  fe_acc half;
#pragma unroll
  for (int role = 0; role < 4; ++role) {
    const stark_spot_part_in in = stark_spot_operands(g, i, role);
    fe_acc acc;
    stark_spot_part<POWER>(role, in, acc);
    if (role == 2) {
      half = acc;
      continue;
    }
    if (role == 3) fe_acc_add_acc(acc, half);
    g.out[3 * i + (role == 3 ? 2 : role)] = fe_eq(in.lhs, fe_reduce(acc));
  }
}

#if defined(__CUDACC__)
// Four lanes a position (lanes 4i .. 4i+3 of the grid), one part each.
// Lanes past the last position redo the last one (every lane of the warp
// takes part in the shuffle) and store nothing.
template <int POWER>
__global__ void __launch_bounds__(STARK_BLOCK)
stark_spot_kernel(const __grid_constant__ stark_spot_args g) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long i = t >> 2;
  const int role = (int)(t & 3);
  const long long at = i < g.n ? i : g.n - 1;
  const stark_spot_part_in in = stark_spot_operands(g, at, role);
  fe_acc acc, other;
  stark_spot_part<POWER>(role, in, acc);
#pragma unroll
  for (int k = 0; k < FE_ACC; ++k) {
    const uint32_t o = __shfl_xor_sync(0xFFFFFFFFu, acc.v[k], 1);
    other.v[k] = role >= 2 ? o : 0u;
  }
  fe_acc_add_acc(acc, other);
  const bool ok = fe_eq(in.lhs, fe_reduce(acc));
  if (role < 3 && i < g.n) g.out[3 * i + role] = ok;
}
#endif

// Kernel D over args->n positions, `group` a proof; power 2 or 3.  Returns
// 1 (cudaErrorInvalidValue) without writing anything for a bad argument,
// else cudaGetLastError().
extern "C" int stark_spot_checks(const void* args, void* stream) {
  const stark_spot_args& g = *static_cast<const stark_spot_args*>(args);
  if ((g.power != 2 && g.power != 3) || g.group <= 0 || g.n < 0 ||
      g.n > 0x7FFFFFFFLL || g.n % g.group != 0 || !stark_pow2(g.rows) ||
      !stark_pow2(g.k_rows) || g.log_steps < 0 || g.log_steps > 62)
    return 1;
  if (g.n == 0) return 0;
  if (!stark_aligned16(g.main, g.main_stride) ||
      !stark_aligned16(g.lin, g.lin_stride) ||
      !stark_aligned16(g.kh, g.kh_stride) ||
      !stark_aligned16(g.ic1, g.ic1_stride) ||
      !stark_aligned16(g.ic0, g.ic0_stride) ||
      !stark_aligned16(g.g2, 0) || !stark_aligned16(g.z, 0) ||
      !stark_aligned16(g.z2, 0) ||
      !stark_aligned16(g.k, 0) || g.pos == nullptr ||
      g.out == nullptr)
    return 1;
#if defined(__CUDACC__)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((4 * g.n + STARK_BLOCK - 1) / STARK_BLOCK);
  if (g.power == 3)
    stark_spot_kernel<3><<<grid, STARK_BLOCK, 0, st>>>(g);
  else
    stark_spot_kernel<2><<<grid, STARK_BLOCK, 0, st>>>(g);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (long long i = 0; i < g.n; ++i) {
    if (g.power == 3)
      stark_spot_position<3>(g, i);
    else
      stark_spot_position<2>(g, i);
  }
  return 0;
#endif
}
