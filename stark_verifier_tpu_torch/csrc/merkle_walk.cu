// Merkle branch walks: stark_walk_leaf_levels_groups (kernel A),
// stark_walk_quads_groups (kernel B) and stark_walk_branches_groups
// (kernel F).
//
// Replace the TPU package's ops/merkle_pallas.py kernels
// _make_leaf_walk_kernel (behind walk_leaf_levels), _make_chain_kernel
// (behind chain_levels) and _make_walk_kernel (behind walk_branches).  Those
// tile branches word-major as [words, S, 128] and transpose the proof arrays
// to get there, one pallas_call per branch group; here one thread walks one
// branch (or one quad of branches) and reads its own value / sibling /
// witness rows straight from the proof tree's branch-major layout (32 bytes
// a level = two 128-bit loads), so nothing is transposed, padded or staged.
//
// All three take a table of branch groups and walk all of them in ONE
// launch: the verifier's call sites hand over 2, 5 or 10 groups at once
// (main and lincomb; the five FRI column groups or the five FRI poly quad
// groups; those ten groups on the unshared path).  The table is a kernel
// parameter (__grid_constant__, up to 32 groups of 96 bytes), so a launch
// needs no copy and no allocation and can be captured in a CUDA graph.
// Every block belongs to one group, so a warp never mixes widths or level
// counts, and the groups with the most work get the first blocks: the card
// runs them first and fills its tail with the light ones.  One group alone
// would leave most of the card idle: 40 quads of 512 proofs are 20,480
// threads, 160 blocks of 128 for 132 SMs.
//
// Kernel F is the whole independent walk of one branch: the leaf pair-hash,
// then that thread's OWN number of witness levels.  The TPU kernel runs
// max_depth steps in every lane and masks those at or past the lane's depth
// with arithmetic selects; a thread simply loops `depth` times, clamped to
// the rows its branch has, so a depth above max_depth behaves as max_depth
// and no thread reads past its witness rows.  Kernel A is the same walk with
// one level count for the whole group.
//
// Kernel B walks the FRI poly groups of the shared path, whose branches come
// in sibling quads: branch 4q+i holds leaf i of one level-2 subtree node.
// The TPU package hashes the quad's two leaf pairs and their combine in
// plain JAX and hands chain_levels the running digests; here one thread
// starts at the quad's leaves: H(v0 || s0) and H(v2 || s2), the check that
// each branch's level-0 witness is the other pair's digest, their combine,
// then the levels above from branch 0's witness.  The digests never leave
// registers, and the prologue's plain-tensor hashes (hundreds of small
// launches a group) are gone from the verifier.
//
// What bounds them on an H100: the integer ALU pipe.  A level moves 32 bytes
// and hashes them with one compression, whose xors and rotates only the ALU
// pipe runs (blake2s.cuh: 650 of them a compression in the SASS, 64 lanes an
// SM); the adds go to the FMA pipe.  At the verifier's shapes (512 proofs,
// the groups of a call site in one launch) A, B and F run at 1.1x to 1.8x
// of that bound on an H100 80GB HBM3 at 700 W; the launches of 200 threads
// a proof (A's five column groups, B's five quad groups: one partial wave)
// at the top of that range.  A thread loads a level's witness row as the
// level starts: loading it a level ahead in registers did not pay there
// (the grouped walks within 2 %, the chain of B's levels 20 % slower).
#include "blake2s.cuh"

#define STARK_WALK_MAX_GROUPS 32
// Threads a block of A, B and F.  At 64 registers a thread an SM holds 32 warps
// whatever the block; on an H100 the grouped walks ran within 1 % of each
// other at 32, 64 and 128 threads (256: up to 9 % slower on the five column
// groups), and 64 leaves the scheduler 16 blocks an SM to balance.
#define STARK_WALK_BLOCK 64

// The three walks of the grouped kernel.
#define STARK_WALK_A 0     // leaf + `levels` levels, one count a group
#define STARK_WALK_F 1     // leaf + each branch's own depth
#define STARK_WALK_QUAD 2  // sibling quads from their leaves (kernel B)

// One branch group of a grouped walk (the host's table and the kernel's
// parameter share this layout).  Branch i's vw value / sibling words start
// at value / sibling + i * vstride; its level k at witness + i * wit_stride
// + 8 * k (strides in words); tidx [branches] start tree indices; depth
// [n] witness levels per branch (kernel F; above `levels` counts as
// `levels`) or null; out [n, 8].  For A and F, n counts branches.  For B, n
// counts quads (branches 4q .. 4q+3), `levels` the witness levels walked
// after the quad's combine, and ok [n] gets 1 where the quad's level-0
// witnesses match its pair digests, else 0 (null for A and F).  first_block
// is set by the entry point.
struct stark_walk_group {
  const uint32_t* value;
  const uint32_t* sibling;
  const uint32_t* witness;
  const uint32_t* tidx;
  const uint32_t* depth;
  uint32_t* out;
  long long vstride;
  long long wit_stride;
  long long n;
  int vw;
  int levels;
  long long first_block;
  uint32_t* ok;
};

struct stark_walk_table {
  stark_walk_group g[STARK_WALK_MAX_GROUPS];
  int count;
};

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

// `levels` witness levels from digest h and CURRENT index ti; the branch's
// witness rows start at wit (8 words a level, consecutive).
STARK_HD void stark_chain(uint32_t* h, const uint32_t* wit, uint32_t ti,
                          int levels) {
  for (int k = 0; k < levels; ++k) {
    uint32_t w[8];
    stark_ld8(wit + 8 * (long long)k, w);
    b2s_merkle_level(h, w, (ti & 1u) != 0u);
    ti >>= 1;
  }
}

// Branch i of group g: its leaf pair-hash, then its levels -- g.levels
// (kernel A) or min(depth[i], g.levels) (kernel F) -- and the digest to out.
template <bool DEPTH>
STARK_HD void stark_walk_branch(const stark_walk_group& g, long long i) {
  uint32_t ti = g.tidx[i];
  int levels = g.levels;
  if (DEPTH && g.depth[i] < (uint32_t)levels) levels = (int)g.depth[i];
  const uint32_t* v = g.value + i * g.vstride;
  const uint32_t* s = g.sibling + i * g.vstride;
  const bool odd = (ti & 1u) != 0u;
  uint32_t h[8];
  if (g.vw == 8)
    stark_leaf_hash<8>(v, s, odd, h);
  else if (g.vw == 24 || !DEPTH)
    stark_leaf_hash<24>(v, s, odd, h);
  else
    stark_leaf_hash_any(v, s, g.vw, odd, h);
  stark_chain(h, g.witness + i * g.wit_stride, ti >> 1, levels);
  stark_st8(g.out + i * 8, h);
}

// Quad q of group g (kernel B), 32-byte leaves: branches b = 4q .. 4q+3
// are the four leaves of one level-2 node, so b and b+1 are sibling leaves
// (each one's sibling is the other's value: checked by the caller) and
// branch b's tree index is even (4-aligned: checked by the caller), as is
// b+2's.  Their independent walks hash n01 = H(v0 || s0) and n23 = H(v2 ||
// s2), meet each other's pair digest as their level-0 witness (checked
// here) and combine to H(n01 || n23); above that all four consume the same
// witnesses (checked by the caller), so branch b's rows serve the quad.
// Every row the prologue reads is loaded before the first hash, so that the
// loads' latency hides behind the hashing: on an H100 the five poly groups
// ran 1.24x faster so than with each row loaded where it is used.
STARK_HD void stark_walk_quad(const stark_walk_group& g, long long q) {
  const long long b = 4 * q;
  const uint32_t* v = g.value + b * g.vstride;
  const uint32_t* s = g.sibling + b * g.vstride;
  const uint32_t* wit = g.witness + b * g.wit_stride;
  uint32_t m01[16], m23[16], w[4][8];
  stark_ld8(v, m01);
  stark_ld8(s, m01 + 8);
  stark_ld8(v + 2 * g.vstride, m23);
  stark_ld8(s + 2 * g.vstride, m23 + 8);
#pragma unroll
  for (int k = 0; k < 4; ++k) stark_ld8(wit + k * g.wit_stride, w[k]);
  uint32_t n01[8], n23[8];
  b2s_init(n01);
  b2s_compress(n01, m01, 64u, true);
  b2s_init(n23);
  b2s_compress(n23, m23, 64u, true);
  uint32_t diff = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) diff |= w[k][j] ^ (k < 2 ? n23[j] : n01[j]);
  b2s_merkle_level(n01, n23, false);  // n01 <- H(n01 || n23)
  stark_chain(n01, wit + 8, g.tidx[b] >> 2, g.levels);
  stark_st8(g.out + q * 8, n01);
  g.ok[q] = diff == 0 ? 1u : 0u;
}

template <int MODE>
STARK_HD void stark_walk_one(const stark_walk_group& g, long long i) {
  if (MODE == STARK_WALK_QUAD)
    stark_walk_quad(g, i);
  else
    stark_walk_branch<MODE == STARK_WALK_F>(g, i);
}

#if defined(__CUDACC__)

template <int MODE>
__global__ void __launch_bounds__(STARK_WALK_BLOCK)
stark_walk_groups_kernel(const __grid_constant__ stark_walk_table t) {
  int gi = 0;
  while (gi + 1 < t.count && (long long)blockIdx.x >= t.g[gi + 1].first_block)
    ++gi;
  const stark_walk_group& g = t.g[gi];
  long long i = ((long long)blockIdx.x - g.first_block) * blockDim.x +
                threadIdx.x;
  if (i < g.n) stark_walk_one<MODE>(g, i);
}

#endif  // __CUDACC__

static bool stark_aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

// A group the kernel can walk: A takes widths 8 and 24, B width 8 and an ok
// array, F any width >= 1 and a depth array; strides at least a row;
// 16-byte loads (widths 8 and 24, every witness row, the digests) on
// 16-byte aligned rows.  B reads every quad's level-0 witness rows,
// whatever its levels.
static bool stark_walk_group_ok(const stark_walk_group& g, int mode) {
  const bool wide = g.vw == 8 || g.vw == 24;
  if (g.n < 0 || g.levels < 0 || g.vw < 1 || g.vstride < g.vw) return false;
  if (mode != STARK_WALK_F && !wide) return false;
  if (mode == STARK_WALK_QUAD && g.vw != 8) return false;
  if (g.n == 0) return true;
  if (mode == STARK_WALK_F && g.depth == nullptr) return false;
  if (mode == STARK_WALK_QUAD && g.ok == nullptr) return false;
  if (wide && (!stark_aligned16(g.value) || !stark_aligned16(g.sibling) ||
               g.vstride % 4 != 0))
    return false;
  if ((g.levels > 0 || mode == STARK_WALK_QUAD) &&
      (!stark_aligned16(g.witness) || g.wit_stride % 4 != 0))
    return false;
  return stark_aligned16(g.out);
}

// Compressions a thread of the group may need: the leaf's and one a level;
// a quad's two leaves, their combine and its levels.
static long long stark_walk_work(const stark_walk_group& g, int mode) {
  const long long leaf = (2LL * g.vw + 15) / 16;
  return g.n * (mode == STARK_WALK_QUAD ? 2 * leaf + 1 + g.levels
                                        : leaf + g.levels);
}

// The grouped walk of kernels A, B and F (mode): checks every descriptor
// first and returns 1 (cudaErrorInvalidValue) without writing anything if
// one is bad, or if count is out of range; else orders the groups by work,
// heaviest first, gives each its blocks and launches once.  Returns
// cudaGetLastError().
static int stark_walk_groups(const stark_walk_group* groups, int count,
                             int mode, void* stream) {
  if (count < 0 || count > STARK_WALK_MAX_GROUPS) return 1;
  for (int k = 0; k < count; ++k)
    if (!stark_walk_group_ok(groups[k], mode)) return 1;
  int order[STARK_WALK_MAX_GROUPS];
  for (int k = 0; k < count; ++k) {
    int j = k;
    for (; j > 0 && stark_walk_work(groups[order[j - 1]], mode) <
                        stark_walk_work(groups[k], mode);
         --j)
      order[j] = order[j - 1];
    order[j] = k;
  }
  stark_walk_table t;
  t.count = 0;
  long long blocks = 0;
  for (int k = 0; k < count; ++k) {
    const stark_walk_group& g = groups[order[k]];
    if (g.n == 0) continue;
    t.g[t.count] = g;
    t.g[t.count].first_block = blocks;
    blocks += (g.n + STARK_WALK_BLOCK - 1) / STARK_WALK_BLOCK;
    ++t.count;
  }
  if (t.count == 0) return 0;
  if (blocks > 0x7FFFFFFFLL) return 1;
#if defined(__CUDACC__)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)blocks;
  if (mode == STARK_WALK_A)
    stark_walk_groups_kernel<STARK_WALK_A><<<grid, STARK_WALK_BLOCK, 0, st>>>(t);
  else if (mode == STARK_WALK_F)
    stark_walk_groups_kernel<STARK_WALK_F><<<grid, STARK_WALK_BLOCK, 0, st>>>(t);
  else
    stark_walk_groups_kernel<STARK_WALK_QUAD><<<grid, STARK_WALK_BLOCK, 0,
                                                st>>>(t);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (int k = 0; k < t.count; ++k)
    for (long long i = 0; i < t.g[k].n; ++i) {
      if (mode == STARK_WALK_A)
        stark_walk_one<STARK_WALK_A>(t.g[k], i);
      else if (mode == STARK_WALK_F)
        stark_walk_one<STARK_WALK_F>(t.g[k], i);
      else
        stark_walk_one<STARK_WALK_QUAD>(t.g[k], i);
    }
  return 0;
#endif
}

// Kernel A: each group's leaf hash and its first `levels` witness levels,
// widths 8 or 24 (depth ignored).
extern "C" int stark_walk_leaf_levels_groups(const void* groups, int count,
                                             void* stream) {
  return stark_walk_groups(static_cast<const stark_walk_group*>(groups),
                           count, STARK_WALK_A, stream);
}

// Kernel F: each branch's leaf hash and its own min(depth[i], levels)
// witness levels, any width >= 1.
extern "C" int stark_walk_branches_groups(const void* groups, int count,
                                          void* stream) {
  return stark_walk_groups(static_cast<const stark_walk_group*>(groups),
                           count, STARK_WALK_F, stream);
}

// Kernel B: each group's sibling quads from their leaves (width 8), then
// `levels` witness levels of the quad's first branch; a digest and an ok
// word a quad.
extern "C" int stark_walk_quads_groups(const void* groups, int count,
                                       void* stream) {
  return stark_walk_groups(static_cast<const stark_walk_group*>(groups),
                           count, STARK_WALK_QUAD, stream);
}


