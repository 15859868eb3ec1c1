// The arithmetic each field kernel's function needs, as ptxas emits it for
// sm_90a: stark_verifier_tpu_torch/sass.py builds this file on its own
// (nvcc -cubin; it is not part of the kernels' library), counts each probe's
// instructions and takes away probe_copy's.  A probe reads its operands as
// 8-word field elements and writes its result, so what is left is the
// products, reductions, adds and compares alone: none of the limb or byte
// packing, loads and stores of the kernels' layouts.  Never launched.
//
//   probe_eval4_row        kernel C, one row group, given special_x
//                          canonical: u = sx x1^-1, v = u^2, 4 P(sx) and
//                          the compare with the committed value;
//   probe_eval4_special_x  kernel C, one (proof, level): special_x's
//                          canonicalization, once;
//   probe_spot3 / 2        kernel D, one position (its four parts);
//   probe_mul              kernel E, one element;
//   probe_butterfly        the NTT stage, one pair: a product, an add and
//                          a subtract (the inverse's last stage adds two
//                          products, counted apart as probe_mul);
//   probe_mimc3 / 2        the MiMC scan, one round.
#include "../field_mul.cu"
#include "../fri_rows.cu"
#include "../mimc_scan.cu"
#include "../ntt_stage.cu"
#include "../spot_checks.cu"

#define PROBE_STRIDE 16  // field elements of input a thread

extern "C" __global__ void probe_copy(const fe* in, fe* out) {
  out[threadIdx.x] = in[threadIdx.x * PROBE_STRIDE];
}

extern "C" __global__ void probe_eval4_row(const fe* in, stark_row_consts k,
                                           uint32_t* out) {
  const fe* v = in + threadIdx.x * PROBE_STRIDE;
  const fe u = fe_mul(v[4], v[5]);
  out[threadIdx.x] = stark_fri_holds(
      v[6], stark_eval4_core(v[0], v[1], v[2], v[3], u, fe_mul(u, u), k));
}

extern "C" __global__ void probe_eval4_special_x(const fe* in, fe* out) {
  out[threadIdx.x] = fe_canon(in[threadIdx.x * PROBE_STRIDE]);
}

// Kernel D, one position as the sum of its four parts (csrc/spot_checks.cu),
// each part compiled for its own role so that the product it does not use
// is left out: what a position needs, whichever lanes run it.  Operands:
// 0..4 P(x), P(g1 x), D(x), B(x), L(x), raw; 5..9 x, x^steps, Z, Z2, K;
// 10..13 k1..k4, raw; 14, 15 I1, I0.
template <int POWER>
__device__ uint32_t probe_spot(const fe* v) {
  const fe p = fe_canon(v[0]), pg1 = fe_canon(v[1]), d = fe_canon(v[2]);
  const fe b = fe_canon(v[3]), l = fe_canon(v[4]);
  fe zero;
  for (int j = 0; j < 8; ++j) zero.v[j] = 0;
  const stark_spot_part_in t = {p, v[6], v[6], v[7], d, v[9], pg1};
  const stark_spot_part_in bd = {b, v[6], v[8], v[14], v[5], v[15], p};
  const stark_spot_part_in l1 = {p, v[6], v[10], v[11], v[5], zero, l};
  const stark_spot_part_in l2 = {b, v[6], v[12], v[13], v[5], d, l};
  fe_acc a0, a1, a2, a3;
  stark_spot_part<POWER>(0, t, a0);
  stark_spot_part<POWER>(1, bd, a1);
  stark_spot_part<POWER>(2, l1, a2);
  stark_spot_part<POWER>(3, l2, a3);
  fe_acc_add_acc(a2, a3);
  return (fe_eq(pg1, fe_reduce(a0)) ? 1u : 0u) |
         (fe_eq(p, fe_reduce(a1)) ? 2u : 0u) |
         (fe_eq(l, fe_reduce(a2)) ? 4u : 0u);
}

extern "C" __global__ void probe_spot3(const fe* in, uint32_t* out) {
  out[threadIdx.x] = probe_spot<3>(in + threadIdx.x * PROBE_STRIDE);
}

extern "C" __global__ void probe_spot2(const fe* in, uint32_t* out) {
  out[threadIdx.x] = probe_spot<2>(in + threadIdx.x * PROBE_STRIDE);
}

extern "C" __global__ void probe_mul(const fe* in, fe* out) {
  const fe* v = in + threadIdx.x * PROBE_STRIDE;
  out[threadIdx.x] = fe_mul(v[0], v[1]);
}

extern "C" __global__ void probe_butterfly(const fe* in, fe* out) {
  const fe* v = in + threadIdx.x * PROBE_STRIDE;
  fe lo, hi;
  stark_butterfly(v[0], v[1], v[2], lo, hi);
  out[2 * threadIdx.x] = lo;
  out[2 * threadIdx.x + 1] = hi;
}

extern "C" __global__ void probe_mimc3(const fe* in, fe* out) {
  const fe* v = in + threadIdx.x * PROBE_STRIDE;
  out[threadIdx.x] = stark_mimc_round<3>(v[0], v[1]);
}

extern "C" __global__ void probe_mimc2(const fe* in, fe* out) {
  const fe* v = in + threadIdx.x * PROBE_STRIDE;
  out[threadIdx.x] = stark_mimc_round<2>(v[0], v[1]);
}
