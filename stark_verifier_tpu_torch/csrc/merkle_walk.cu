// Merkle branch walks: stark_walk_leaf_levels (kernel A),
// stark_chain_levels (kernel B) and stark_walk_branches (kernel F).
//
// Replace the TPU package's ops/merkle_pallas.py kernels
// _make_leaf_walk_kernel (behind walk_leaf_levels), _make_chain_kernel
// (behind chain_levels) and _make_walk_kernel (behind walk_branches).  Those
// tile branches word-major as [words, S, 128] and transpose the proof arrays
// to get there; here one thread walks one branch and reads its own value /
// sibling / witness rows straight from the proof tree's branch-major layout
// (32 bytes per level = two 128-bit loads), so nothing is transposed, padded
// or staged.
//
// Kernel F is the whole independent walk of one branch: the leaf pair-hash,
// then that thread's OWN number of witness levels.  The TPU kernel runs
// max_depth steps in every lane and masks those at or past the lane's depth
// with arithmetic selects; a thread simply loops `depth` times, clamped to
// the rows its branch has, so a depth above max_depth behaves as max_depth
// and no thread reads past its witness rows.
//
// Bound on an H100: integer operations.  A branch moves 32 bytes per level
// but spends one Blake2s compression (80 G functions of 12 instructions) on
// them, about 30 instructions per byte against the card's ratio of 10 between
// the instructions it can issue and the bytes it can move.  The design keeps
// the chaining value, the 16 state words and the message in registers for the
// whole walk and unrolls the rounds fully; the level loop stays rolled (its
// trip count is a launch argument).  Occupancy tuning and coalesced witness
// staging are left for later.
#include "blake2s.cuh"

// Leaf pair-hash of one branch: Blake2s(first || second) with
// (first, second) = (sibling, value) when the tree index is odd, else
// (value, sibling).  VW words per value: 8 (one 64-byte block) or 24 (192
// bytes = three blocks; counter 64 / 128 / 192, final flag on the third).
template <int VW>
STARK_HD void stark_leaf_hash(const uint32_t* val, const uint32_t* sib,
                              bool odd, uint32_t* h) {
  const uint32_t* first = odd ? sib : val;
  const uint32_t* second = odd ? val : sib;
  uint32_t m[16];
  b2s_init(h);
  if (VW == 8) {
    stark_ld8(first, m);
    stark_ld8(second, m + 8);
    b2s_compress(h, m, 64u, true);
  } else {
    stark_ld8(first, m);
    stark_ld8(first + 8, m + 8);
    b2s_compress(h, m, 64u, false);
    stark_ld8(first + 16, m);
    stark_ld8(second, m + 8);
    b2s_compress(h, m, 128u, false);
    stark_ld8(second + 8, m);
    stark_ld8(second + 16, m + 8);
    b2s_compress(h, m, 192u, true);
  }
}

// `levels` witness levels from digest h and CURRENT index ti; witness rows
// of this branch start at wit (8 words per level, consecutive).
STARK_HD void stark_chain(uint32_t* h, const uint32_t* wit, uint32_t ti,
                          int levels) {
  for (int k = 0; k < levels; ++k) {
    uint32_t w[8];
    stark_ld8(wit + 8 * (long long)k, w);
    b2s_merkle_level(h, w, (ti & 1u) != 0u);
    ti >>= 1;
  }
}

// The same leaf pair-hash for any width vw >= 1 (words per value), with the
// message gathered word by word: blocks of 16 words of first || second, zero
// padded, byte counter 8 * vw on the last.  For the widths the statement
// families do not use (ragged value sizes).
STARK_HD void stark_leaf_hash_any(const uint32_t* val, const uint32_t* sib,
                                  int vw, bool odd, uint32_t* h) {
  const uint32_t* first = odd ? sib : val;
  const uint32_t* second = odd ? val : sib;
  const int total = 2 * vw;
  const int nblocks = (total + 15) / 16;
  b2s_init(h);
  for (int blk = 0; blk < nblocks; ++blk) {
    uint32_t m[16];
    for (int j = 0; j < 16; ++j) {
      int k = blk * 16 + j;
      m[j] = k < vw ? first[k] : (k < total ? second[k - vw] : 0u);
    }
    bool last = blk == nblocks - 1;
    b2s_compress(h, m, last ? 4u * (uint32_t)total : 64u * (uint32_t)(blk + 1),
                 last);
  }
}

// Kernel F's body: branch i's leaf pair-hash and its own min(depth[i],
// max_depth) witness levels.  VW = 8 or 24 takes the vector-load leaf hash;
// VW = 0 takes the word-by-word one at the runtime width vw.  Value rows are
// vstride words apart (a column slice of wider rows is read in place).
template <int VW>
STARK_HD void stark_walk_branch_one(long long i, const uint32_t* value,
                                    const uint32_t* sibling, long long vstride,
                                    int vw, const uint32_t* witness,
                                    long long wit_stride, const uint32_t* tidx,
                                    const uint32_t* depth, int max_depth,
                                    uint32_t* out) {
  uint32_t h[8];
  uint32_t ti = tidx[i];
  uint32_t d = depth[i];
  if (d > (uint32_t)max_depth) d = (uint32_t)max_depth;
  const uint32_t* v = value + i * vstride;
  const uint32_t* s = sibling + i * vstride;
  if constexpr (VW == 0)
    stark_leaf_hash_any(v, s, vw, (ti & 1u) != 0u, h);
  else
    stark_leaf_hash<VW>(v, s, (ti & 1u) != 0u, h);
  stark_chain(h, witness + i * wit_stride, ti >> 1, (int)d);
  stark_st8(out + i * 8, h);
}

template <int VW>
STARK_HD void stark_walk_leaf_one(long long i, const uint32_t* value,
                                  const uint32_t* sibling,
                                  const uint32_t* witness,
                                  long long wit_stride, const uint32_t* tidx,
                                  uint32_t* out, int levels) {
  uint32_t h[8];
  uint32_t ti = tidx[i];
  stark_leaf_hash<VW>(value + i * VW, sibling + i * VW, (ti & 1u) != 0u, h);
  stark_chain(h, witness + i * wit_stride, ti >> 1, levels);
  stark_st8(out + i * 8, h);
}

STARK_HD void stark_chain_one(long long i, const uint32_t* h_in,
                              const uint32_t* witness, long long wit_stride,
                              const uint32_t* tidx, uint32_t* out,
                              int levels) {
  uint32_t h[8];
  stark_ld8(h_in + i * 8, h);
  stark_chain(h, witness + i * wit_stride, tidx[i], levels);
  stark_st8(out + i * 8, h);
}

#if defined(__CUDACC__)

template <int VW>
__global__ void __launch_bounds__(STARK_BLOCK)
stark_walk_leaf_kernel(const uint32_t* __restrict__ value,
                       const uint32_t* __restrict__ sibling,
                       const uint32_t* __restrict__ witness,
                       long long wit_stride,
                       const uint32_t* __restrict__ tidx,
                       uint32_t* __restrict__ out, int levels, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    stark_walk_leaf_one<VW>(i, value, sibling, witness, wit_stride, tidx, out,
                            levels);
}

__global__ void __launch_bounds__(STARK_BLOCK)
stark_chain_kernel(const uint32_t* __restrict__ h_in,
                   const uint32_t* __restrict__ witness, long long wit_stride,
                   const uint32_t* __restrict__ tidx,
                   uint32_t* __restrict__ out, int levels, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) stark_chain_one(i, h_in, witness, wit_stride, tidx, out, levels);
}

template <int VW>
__global__ void __launch_bounds__(STARK_BLOCK)
stark_walk_branches_kernel(const uint32_t* __restrict__ value,
                           const uint32_t* __restrict__ sibling,
                           long long vstride, int vw,
                           const uint32_t* __restrict__ witness,
                           long long wit_stride,
                           const uint32_t* __restrict__ tidx,
                           const uint32_t* __restrict__ depth, int max_depth,
                           uint32_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    stark_walk_branch_one<VW>(i, value, sibling, vstride, vw, witness,
                              wit_stride, tidx, depth, max_depth, out);
}

#endif  // __CUDACC__

// value/sibling [n, vw] words; witness: branch i's level k at
// witness + i * wit_stride + 8 * k (strides in words); tidx [n] start tree
// indices; out [n, 8].  vw must be 8 or 24.  Returns cudaGetLastError()
// (1 = cudaErrorInvalidValue for an unsupported vw).
extern "C" int stark_walk_leaf_levels(const void* value, const void* sibling,
                                      const void* witness,
                                      long long wit_stride, const void* tidx,
                                      void* out, int vw, int levels,
                                      long long n, void* stream) {
  const uint32_t* v = static_cast<const uint32_t*>(value);
  const uint32_t* s = static_cast<const uint32_t*>(sibling);
  const uint32_t* w = static_cast<const uint32_t*>(witness);
  const uint32_t* t = static_cast<const uint32_t*>(tidx);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (vw != 8 && vw != 24) return 1;
  if (n <= 0) return 0;
#if defined(__CUDACC__)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned grid = (unsigned)((n + STARK_BLOCK - 1) / STARK_BLOCK);
  if (vw == 8)
    stark_walk_leaf_kernel<8><<<grid, STARK_BLOCK, 0, st>>>(
        v, s, w, wit_stride, t, o, levels, n);
  else
    stark_walk_leaf_kernel<24><<<grid, STARK_BLOCK, 0, st>>>(
        v, s, w, wit_stride, t, o, levels, n);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (long long i = 0; i < n; ++i) {
    if (vw == 8)
      stark_walk_leaf_one<8>(i, v, s, w, wit_stride, t, o, levels);
    else
      stark_walk_leaf_one<24>(i, v, s, w, wit_stride, t, o, levels);
  }
  return 0;
#endif
}

// h_in [n, 8] running digests; witness as above; tidx [n] CURRENT (already
// halved) tree indices; out [n, 8].
extern "C" int stark_chain_levels(const void* h_in, const void* witness,
                                  long long wit_stride, const void* tidx,
                                  void* out, int levels, long long n,
                                  void* stream) {
  const uint32_t* h = static_cast<const uint32_t*>(h_in);
  const uint32_t* w = static_cast<const uint32_t*>(witness);
  const uint32_t* t = static_cast<const uint32_t*>(tidx);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (n <= 0) return 0;
#if defined(__CUDACC__)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned grid = (unsigned)((n + STARK_BLOCK - 1) / STARK_BLOCK);
  stark_chain_kernel<<<grid, STARK_BLOCK, 0, st>>>(h, w, wit_stride, t, o,
                                                   levels, n);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (long long i = 0; i < n; ++i)
    stark_chain_one(i, h, w, wit_stride, t, o, levels);
  return 0;
#endif
}

// value/sibling: branch i's vw words at value + i * vstride; witness as
// above, holding max_depth rows per branch; tidx [n] start tree indices;
// depth [n] witness levels per branch (uint32; above max_depth counts as
// max_depth); out [n, 8].  vw >= 1; rows must be 16-byte aligned when vw is 8
// or 24.  Returns cudaGetLastError() (1 = cudaErrorInvalidValue for a bad
// width, stride or depth bound).
extern "C" int stark_walk_branches(const void* value, const void* sibling,
                                   long long vstride, int vw,
                                   const void* witness, long long wit_stride,
                                   const void* tidx, const void* depth,
                                   int max_depth, void* out, long long n,
                                   void* stream) {
  const uint32_t* v = static_cast<const uint32_t*>(value);
  const uint32_t* s = static_cast<const uint32_t*>(sibling);
  const uint32_t* w = static_cast<const uint32_t*>(witness);
  const uint32_t* t = static_cast<const uint32_t*>(tidx);
  const uint32_t* d = static_cast<const uint32_t*>(depth);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (vw < 1 || vstride < vw || max_depth < 0) return 1;
  if (n <= 0) return 0;
#if defined(__CUDACC__)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned grid = (unsigned)((n + STARK_BLOCK - 1) / STARK_BLOCK);
  if (vw == 8)
    stark_walk_branches_kernel<8><<<grid, STARK_BLOCK, 0, st>>>(
        v, s, vstride, vw, w, wit_stride, t, d, max_depth, o, n);
  else if (vw == 24)
    stark_walk_branches_kernel<24><<<grid, STARK_BLOCK, 0, st>>>(
        v, s, vstride, vw, w, wit_stride, t, d, max_depth, o, n);
  else
    stark_walk_branches_kernel<0><<<grid, STARK_BLOCK, 0, st>>>(
        v, s, vstride, vw, w, wit_stride, t, d, max_depth, o, n);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (long long i = 0; i < n; ++i) {
    if (vw == 8)
      stark_walk_branch_one<8>(i, v, s, vstride, vw, w, wit_stride, t, d,
                               max_depth, o);
    else if (vw == 24)
      stark_walk_branch_one<24>(i, v, s, vstride, vw, w, wit_stride, t, d,
                                max_depth, o);
    else
      stark_walk_branch_one<0>(i, v, s, vstride, vw, w, wit_stride, t, d,
                               max_depth, o);
  }
  return 0;
#endif
}
