// The arithmetic each field kernel's function needs, as ptxas emits it for
// sm_90a: stark_verifier_tpu_torch/sass.py builds this file on its own
// (nvcc -cubin; it is not part of the kernels' library), counts each probe's
// instructions and takes away probe_copy's.  A probe reads its operands as
// 8-word field elements and writes its result, so what is left is the
// products, reductions, adds and compares alone: none of the limb or byte
// packing, loads and stores of the kernels' layouts.  Never launched.
//
//   probe_eval4_row        kernel C, one row group, given special_x canonical
//                          and squared;
//   probe_eval4_special_x  kernel C, one (proof, level): special_x's
//                          canonicalization and square, once;
//   probe_spot3 / 2        kernel D, one position;
//   probe_mul              kernel E, one element.
#include "../field_mul.cu"
#include "../fri_rows.cu"
#include "../spot_checks.cu"

#define PROBE_STRIDE 16  // field elements of input a thread

struct probe_operands {
  const fe* v;
  __device__ fe operator()(int j) const { return v[j]; }
};

extern "C" __global__ void probe_copy(const fe* in, fe* out) {
  out[threadIdx.x] = in[threadIdx.x * PROBE_STRIDE];
}

extern "C" __global__ void probe_eval4_row(const fe* in, stark_row_consts k,
                                           fe* out) {
  const fe* v = in + threadIdx.x * PROBE_STRIDE;
  out[threadIdx.x] =
      stark_eval4_core(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], k);
}

extern "C" __global__ void probe_eval4_special_x(const fe* in, fe* out) {
  fe sxc, sx2;
  stark_eval4_special_x(in[threadIdx.x * PROBE_STRIDE], sxc, sx2);
  out[2 * threadIdx.x] = sxc;
  out[2 * threadIdx.x + 1] = sx2;
}

extern "C" __global__ void probe_spot3(const fe* in, uint32_t* out) {
  probe_operands v = {in + threadIdx.x * PROBE_STRIDE};
  out[threadIdx.x] = stark_spot_core<3>(v);
}

extern "C" __global__ void probe_spot2(const fe* in, uint32_t* out) {
  probe_operands v = {in + threadIdx.x * PROBE_STRIDE};
  out[threadIdx.x] = stark_spot_core<2>(v);
}

extern "C" __global__ void probe_mul(const fe* in, fe* out) {
  const fe* v = in + threadIdx.x * PROBE_STRIDE;
  out[threadIdx.x] = fe_mul(v[0], v[1]);
}
