// One butterfly stage of the radix-2 NTT: stark_ntt_stage.
//
// Replaces the stage body of the TPU package's ops/ntt.py (ntt, the loop
// over stages: mul_mod of the upper halves by the stage's twiddles, add_mod
// and sub_mod, a concatenate), which XLA compiles to a graph of element-wise
// operations over 16-bit limbs.  No pl.pallas_call stands behind it; the
// port gives it a kernel because a stage in plain torch is hundreds of
// device launches over int64 limb columns, and a 2^20-point transform has
// twenty stages.
//
// One launch is one decimation-in-time stage over `lead` transforms of n
// points.  One thread takes one butterfly pair (i0, i1 = i0 + half) of a
// block of 2 half points:
//
//   t  = b * w mod p,   w = tw[(tw_off + j) * tw_stride],  j = i0 mod half
//   lo = add_mod(a, t)  -> i0        hi = sub_mod(a, t)  -> i1
//
// with the 256-bit core of field256.cuh (fe_mul, fe_add, fe_sub: the same
// formulas as the plain add_mod / sub_mod for every value < 2^256, so a raw
// a of stage 0 gives the plain version's words).  Two folds keep the
// transform's prologue and epilogue out of launches of their own, and are
// bit-exact:
//
//   * perm (stage 0): point i of a transform reads source point perm[i] of
//     its block of src_n source points (the bit-reverse gather; src_n = n,
//     or the whole transform's size for one shard of a sharded NTT);
//   * scale (the last stage): lo and hi are multiplied by it (the inverse's
//     n^-1), fe_mul taking any value < 2^256 to the canonical product, as
//     the plain version's final mul_mod does.
//
// Layouts: see ntt.cuh.  Limbs must be < 2^16.  The twiddle table is the
// powers of the transform's root, packed: stage s of an n-point transform
// reads w^(j n / 2^(s+1)) at stride n / 2^(s+1) in the table of n / 2
// powers.
//
// Where it runs: the stages whose partner points lie on another rank in the
// sharded NTT (ops/ntt.cross_stage, parallel/ntt.py).  A whole transform,
// or a rank's local stages, runs several stages a launch in shared memory
// (ntt_block.cu); the one-launch-a-stage transform is what chip_smoke.py
// times that kernel against.
//
// Bound on an H100: bytes.  A stage moves 64 bytes a point in the working
// layout (96 in the public one) and computes one product, one add and one
// subtract a pair: about 430 instructions (probe_butterfly of
// csrc/probes/work.cu in the SASS) for 128 bytes, 3.4 a byte, where the
// card issues 10 for each byte it moves.  On an H100 80GB HBM3 at 700 W a
// middle stage of 2^20 points takes 0.026 ms, 1.3x of its byte bound; the
// twenty stages of a 2^20-point transform, one a launch, took 0.47 ms.
#include "ntt.cuh"

// The operands of one stage (the host's ctypes structure and the kernel's
// parameter share this layout).
//   src [lead, src_n or n, 16 or 8]; perm [n] int32 (< src_n) or null;
//   tw [tw_rows, 8] words (canonical); scale [8] words or null;
//   dst [lead, n, 16 or 8] (may be src when there is no perm).
struct stark_ntt_stage_args {
  const uint32_t* src;
  const int32_t* perm;
  const uint32_t* tw;
  const uint32_t* scale;
  uint32_t* dst;
  long long lead;
  long long n;
  long long src_n;
  long long half;
  long long tw_rows;
  long long tw_stride;
  long long tw_off;
  int src_limbs;  // 1: src holds 16-bit limbs; 0: 8 words a value
  int dst_limbs;
};

// Pair p of the launch (p < lead * n / 2); lp = log2(n / 2), lh =
// log2(half), so that the divisions are shifts.
STARK_HD void stark_ntt_pair(const stark_ntt_stage_args& g, int lp, int lh,
                             long long p) {
  const long long t = p >> lp, q = p & ((g.n >> 1) - 1);
  const long long j = q & (g.half - 1);
  const long long i0 = ((q >> lh) << (lh + 1)) + j, i1 = i0 + g.half;
  long long s0 = t * g.n + i0, s1 = t * g.n + i1;
  if (g.perm != nullptr) {
    s0 = t * g.src_n + g.perm[i0];
    s1 = t * g.src_n + g.perm[i1];
  }
  const fe a = stark_ntt_load(g.src, s0, g.src_limbs);
  const fe b = stark_ntt_load(g.src, s1, g.src_limbs);
  const fe w = fe_from_le_words(g.tw + ((g.tw_off + j) * g.tw_stride) * 8);
  fe lo, hi;
  stark_butterfly(a, b, w, lo, hi);
  if (g.scale != nullptr) {
    const fe k = fe_from_le_words(g.scale);
    lo = fe_mul_short(lo, k);
    hi = fe_mul_short(hi, k);
  }
  stark_ntt_store(g.dst, t * g.n + i0, g.dst_limbs, lo);
  stark_ntt_store(g.dst, t * g.n + i1, g.dst_limbs, hi);
}

#if defined(__CUDACC__)
__global__ void __launch_bounds__(STARK_BLOCK)
stark_ntt_stage_kernel(const __grid_constant__ stark_ntt_stage_args g, int lp,
                       int lh, long long total) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < total) stark_ntt_pair(g, lp, lh, p);
}
#endif

// Returns cudaGetLastError(), or 1 (cudaErrorInvalidValue) for operands the
// kernel does not take: n or half not a power of two, half > n / 2, a
// twiddle index past the table, an operand not 16-byte aligned, a perm with
// src == dst.  (The perm's entries are the caller's to keep below src_n.)
extern "C" int stark_ntt_stage(const void* args, void* stream) {
  const stark_ntt_stage_args& g =
      *static_cast<const stark_ntt_stage_args*>(args);
  if (g.lead < 0 || g.n < 2 || !stark_pow2(g.n) || !stark_pow2(g.half) ||
      g.half > g.n / 2 || g.tw_stride < 0 || g.tw_off < 0 ||
      (g.tw_off + g.half - 1) * g.tw_stride >= g.tw_rows ||
      g.src == nullptr || g.dst == nullptr || g.tw == nullptr ||
      (g.perm != nullptr && (g.src_n < 1 || (const void*)g.src ==
                                                (const void*)g.dst)) ||
      (g.perm == nullptr && g.src_n != g.n))
    return 1;
  if (!stark_aligned16(g.src, 0) || !stark_aligned16(g.dst, 0) ||
      !stark_aligned16(g.tw, 0) || !stark_aligned16(g.scale, 0))
    return 1;
  const long long total = g.lead * (g.n / 2);
  if (total == 0) return 0;
  const int lp = stark_log2(g.n / 2), lh = stark_log2(g.half);
#if defined(__CUDACC__)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((total + STARK_BLOCK - 1) / STARK_BLOCK);
  stark_ntt_stage_kernel<<<grid, STARK_BLOCK, 0, st>>>(g, lp, lh, total);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (long long p = 0; p < total; ++p) stark_ntt_pair(g, lp, lh, p);
  return 0;
#endif
}
