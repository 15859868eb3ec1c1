// Several butterfly stages of the radix-2 NTT in one launch: stark_ntt_block.
//
// Replaces the stage loop of the TPU package's ops/ntt.py (ntt, lines
// 86-95: mul_mod of the upper halves by the stage's twiddles, add_mod and
// sub_mod, a concatenate, once a stage), which XLA compiles to a graph of
// element-wise operations over 16-bit limbs.  No pl.pallas_call stands
// behind it.
//
// One launch is one pass: the k decimation-in-time stages s0 .. s0 + k - 1
// of `lead` transforms of n points.  Those stages split a transform into
// independent sub-transforms of 2^k points at stride 2^s0: point
//
//   i = hi 2^(s0+k) + m 2^s0 + lo      (m < 2^k, lo < 2^s0)
//
// belongs to sub-transform g = hi 2^s0 + lo, and stage s0 + t pairs the
// points whose m differ in bit t.  A block owns C sub-transforms with
// adjacent g (adjacent lo, so that a warp reads and writes runs of C
// points), holds their P = C 2^k points in shared memory, and runs one
// thread a pair (P / 2 threads):
//
//   load   each warp its own 2 W points of the tile (W = 32 threads) from
//          global memory (the first pass gathers through perm from the
//          caller's 16-limb rows);
//   warp   the first stages, while a butterfly block (C 2^(t+1) points)
//          fits in a warp's 2 W points (6 stages at C = 1): the warp's own
//          points only, __syncwarp between stages, each twiddle read from
//          the table (a few rows, cached);
//   block  the other stages: start copying the next stage's C 2^(t+1)
//          twiddles into the other of two shared buffers (cp.async: no
//          registers, no wait), every pair (stark_butterfly, as the
//          one-stage kernel computes it), wait for the copies,
//          __syncthreads;
//   store  each warp its points, multiplied by `scale` when given (the
//          inverse's n^-1 in the last pass), in the destination's layout.
//
// The wrapper (ops/ntt.py) runs a transform of log2 n stages as
// ceil(log2 n / 10) passes of at most 10 stages: 2^20 points as 10 + 10,
// 2^13 as 7 + 6, 64 points as one.  The first pass reads the caller's
// [.., 16] limbs (never written), passes between work in place on a buffer
// of 8 words a value (a block writes only the points it read), the last
// writes [.., 16] limbs.  Bit-exact with the one-stage kernel and the plain
// version: the same butterfly on the same operands in the same order.
//
// Shared memory: the tile as two planes of 16-byte halves (P x 32 bytes)
// and two stages' twiddles (P / 2 and P / 4 x 32 bytes), so that
// consecutive threads touch consecutive 16-byte slots: 56 KB for a tile
// of 1,024 points, the most a block takes (two blocks an SM).
//
// Bound on an H100: operations.  A pair costs about 400 instructions
// (probe_butterfly of csrc/probes/work.cu) and moves nothing to global
// memory between the passes' loads and stores; a 2^20-point transform in
// two passes moves about 0.27 GB (0.08 ms at 3.35 TB/s) against 0.12 ms of
// issue for its 2^19 x 20 pairs.  The one-stage kernel moved the data
// twenty times (3.49x of the transform's bound, PERF.md).  Measured on an
// H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md): see PERF.md section 6.
#include "ntt.cuh"

#if !defined(__CUDACC__)
#include <vector>
#endif

#define STARK_NTT_TILE_MAX 1024  // points a block at most (ops/ntt.py's plan)
#define STARK_NTT_SMEM(p) ((long long)(p) * 56)  // bytes of a tile of p

// The operands of one pass (the host's ctypes structure and the kernel's
// parameter share this layout).
//   src [lead, src_n or n, 16 or 8]; perm [n] int32 (< src_n) or null;
//   tw [tw_rows, 8] words (canonical), the root's powers: stage s reads
//   row j * (tw_rows >> s) for the pair offset j < 2^s;
//   scale [8] words or null; dst [lead, n, 16 or 8] (may be src when there
//   is no perm and both have one layout).
struct stark_ntt_block_args {
  const uint32_t* src;
  const int32_t* perm;
  const uint32_t* tw;
  const uint32_t* scale;
  uint32_t* dst;
  long long lead;
  long long n;
  long long src_n;
  long long tw_rows;
  int s0;  // the pass's first stage
  int k;   // its stages
  int lc;  // log2 of the sub-transforms a block (C)
  int src_limbs;  // 1: src holds 16-bit limbs; 0: 8 words a value
  int dst_limbs;
};

// A block's tile: transform t, first sub-transform g0, log2 P.
struct stark_ntt_tile {
  long long t;
  long long g0;
  int lp;
};

STARK_HD stark_ntt_tile stark_ntt_tile_of(const stark_ntt_block_args& g,
                                          long long b) {
  const int lp = g.lc + g.k;
  const long long per = g.n >> lp;  // tiles a transform
  stark_ntt_tile r;
  r.t = b / per;
  r.g0 = (b - r.t * per) << g.lc;
  r.lp = lp;
  return r;
}

// Index within its transform of tile point u = m C + c.
STARK_HD long long stark_ntt_point(const stark_ntt_block_args& g,
                                   const stark_ntt_tile& tl, long long u) {
  const long long sub = tl.g0 + (u & ((1LL << g.lc) - 1));
  const long long m = u >> g.lc;
  const long long lo = sub & ((1LL << g.s0) - 1), hi = sub >> g.s0;
  return (hi << (g.s0 + g.k)) + (m << g.s0) + lo;
}

STARK_HD fe stark_sm_ld(const stark_u32x4* plane, int size, int u) {
  const stark_u32x4 a = plane[u], b = plane[size + u];
  fe r;
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
  return r;
}

STARK_HD void stark_sm_st(stark_u32x4* plane, int size, int u,
                          const fe& x) {
  stark_u32x4 a, b;
  a.x = x.v[0]; a.y = x.v[1]; a.z = x.v[2]; a.w = x.v[3];
  b.x = x.v[4]; b.y = x.v[5]; b.z = x.v[6]; b.w = x.v[7];
  plane[u] = a;
  plane[size + u] = b;
}

// 16 bytes from global to shared memory: on the card an asynchronous copy
// (cp.async, completed by stark_cp_wait), on the host a plain one.
STARK_HD void stark_cp16(stark_u32x4* dst, const uint32_t* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
#else
  *dst = *reinterpret_cast<const stark_u32x4*>(src);
#endif
}

#if defined(__CUDACC__)
__device__ __forceinline__ void stark_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void stark_cp_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
#endif

// Stage t's twiddle buffer: the last stage's (C 2^(k-1) entries) and
// every stage of its parity at 2P, the others at 3P (in 16-byte slots).
STARK_HD stark_u32x4* stark_ntt_twbuf(stark_u32x4* sm, int p, int k, int t) {
  return sm + ((t & 1) == ((k - 1) & 1) ? 2 * p : 3 * p);
}

// One pair a thread: P / 2 threads, in warps of W = min(32, P / 2).  Warp
// w loads, and in the warp's stages runs and stores, the tile points
// [2 W w, 2 W w + 2 W): its lane's two, u0 and u0 + W.
STARK_HD int stark_ntt_block_threads(long long p) { return (int)(p / 2); }

STARK_HD int stark_ntt_warp_u0(int tid, int nt) {
  const int w = nt < 32 ? nt : 32;
  return 2 * (tid - tid % w) + tid % w;
}

// The warp's stages: those whose pairs stay inside a warp's points, while
// a butterfly block (2^(t+1) points of C sub-transforms) fits in 2 W.
STARK_HD int stark_ntt_warp_stages(const stark_ntt_block_args& g, int nt) {
  const int w = nt < 32 ? nt : 32;
  int t = 0;
  while (t < g.k && (2 << (t + g.lc)) <= 2 * w) ++t;
  return t;
}

// Thread `tid` of `nt`: its two points of the tile from global memory.
STARK_HD void stark_ntt_tile_load(const stark_ntt_block_args& g,
                                  const stark_ntt_tile& tl, stark_u32x4* sm,
                                  int tid, int nt) {
  const int p = 1 << tl.lp, u0 = stark_ntt_warp_u0(tid, nt);
  for (int u = u0; u <= u0 + (nt < 32 ? nt : 32); u += nt < 32 ? nt : 32) {
    const long long i = stark_ntt_point(g, tl, u);
    const long long row = g.perm != nullptr ? tl.t * g.src_n + g.perm[i]
                                            : tl.t * g.n + i;
    stark_sm_st(sm, p, u, stark_ntt_load(g.src, row, g.src_limbs));
  }
}

// Stage s0 + t's twiddle of pair offset jm of sub-transform c: row
// (jm 2^s0 + lo_c) (tw_rows >> (s0 + t)) of the power table.
STARK_HD const uint32_t* stark_ntt_twiddle_row(const stark_ntt_block_args& g,
                                               const stark_ntt_tile& tl,
                                               int t, int jm, int c) {
  const long long lo = (tl.g0 + c) & ((1LL << g.s0) - 1);
  return g.tw + ((((long long)jm << g.s0) + lo) * (g.tw_rows >> (g.s0 + t))) *
                    8;
}

// Stage s0 + t's twiddles into shared memory, two planes of C 2^t: entry
// v = jm C + c.
STARK_HD void stark_ntt_tile_twiddles(const stark_ntt_block_args& g,
                                      const stark_ntt_tile& tl,
                                      stark_u32x4* tw_sm, int t, int tid,
                                      int nt) {
  const int count = 1 << (g.lc + t);
  for (int v = tid; v < count; v += nt) {
    const uint32_t* row =
        stark_ntt_twiddle_row(g, tl, t, v >> g.lc, v & ((1 << g.lc) - 1));
    stark_cp16(tw_sm + v, row);
    stark_cp16(tw_sm + count + v, row + 4);
  }
}

// Stage s0 + t on the tile: thread tid's pair q = qm C + c joins points m0
// and m0 + 2^t of sub-transform c.  Its twiddle comes from shared memory
// (tw_sm) or, in the warp's stages, straight from the table (few rows,
// cached).  Tile indices in 32 bits: 64-bit index arithmetic costs more
// ALU instructions than a pair's additions.
STARK_HD void stark_ntt_tile_stage(const stark_ntt_block_args& g,
                                   const stark_ntt_tile& tl, stark_u32x4* sm,
                                   const stark_u32x4* tw_sm, int t,
                                   int tid) {
  const int p = 1 << tl.lp;
  const int c = tid & ((1 << g.lc) - 1), qm = tid >> g.lc;
  const int jm = qm & ((1 << t) - 1);
  const int m0 = ((qm >> t) << (t + 1)) + jm;
  const int u0 = (m0 << g.lc) + c, u1 = u0 + (1 << (t + g.lc));
  const fe w = tw_sm != nullptr
                   ? stark_sm_ld(tw_sm, 1 << (g.lc + t), (jm << g.lc) + c)
                   : fe_from_le_words(stark_ntt_twiddle_row(g, tl, t, jm, c));
  fe lo, hi;
  stark_butterfly(stark_sm_ld(sm, p, u0), stark_sm_ld(sm, p, u1), w, lo, hi);
  stark_sm_st(sm, p, u0, lo);
  stark_sm_st(sm, p, u1, hi);
}

STARK_HD void stark_ntt_tile_store(const stark_ntt_block_args& g,
                                   const stark_ntt_tile& tl,
                                   const stark_u32x4* sm, int tid, int nt) {
  const int p = 1 << tl.lp, u0 = stark_ntt_warp_u0(tid, nt);
  fe k;
  if (g.scale != nullptr) k = fe_from_le_words(g.scale);
  for (int u = u0; u <= u0 + (nt < 32 ? nt : 32); u += nt < 32 ? nt : 32) {
    fe x = stark_sm_ld(sm, p, u);
    if (g.scale != nullptr) x = fe_mul_short(x, k);
    stark_ntt_store(g.dst, tl.t * g.n + stark_ntt_point(g, tl, u),
                    g.dst_limbs, x);
  }
}

#if defined(__CUDACC__)
__global__ void __launch_bounds__(1024)
stark_ntt_block_kernel(const __grid_constant__ stark_ntt_block_args g) {
  extern __shared__ stark_u32x4 stark_ntt_sm[];
  const stark_ntt_tile tl = stark_ntt_tile_of(g, blockIdx.x);
  const int p = 1 << tl.lp;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int wl = stark_ntt_warp_stages(g, nt);
  if (wl < g.k) {  // the first block-wide stage's twiddles, in flight early
    stark_ntt_tile_twiddles(g, tl, stark_ntt_twbuf(stark_ntt_sm, p, g.k, wl),
                            wl, tid, nt);
    stark_cp_commit();
  }
  stark_ntt_tile_load(g, tl, stark_ntt_sm, tid, nt);
  __syncwarp();
  for (int t = 0; t < wl; ++t) {
    stark_ntt_tile_stage(g, tl, stark_ntt_sm, nullptr, t, tid);
    __syncwarp();
  }
  if (wl < g.k) {
    stark_cp_wait();
    __syncthreads();
    for (int t = wl; t < g.k; ++t) {
      if (t + 1 < g.k) {  // into the buffer stage t - 1 read
        stark_ntt_tile_twiddles(
            g, tl, stark_ntt_twbuf(stark_ntt_sm, p, g.k, t + 1), t + 1, tid,
            nt);
        stark_cp_commit();
      }
      stark_ntt_tile_stage(g, tl, stark_ntt_sm,
                           stark_ntt_twbuf(stark_ntt_sm, p, g.k, t), t, tid);
      stark_cp_wait();
      __syncthreads();
    }
  }
  stark_ntt_tile_store(g, tl, stark_ntt_sm, tid, nt);
}
#endif

// Returns cudaGetLastError(), or 1 (cudaErrorInvalidValue) for operands the
// kernel does not take: n not a power of two, a pass past log2 n stages, a
// tile over STARK_NTT_TILE_MAX points (more shared memory than a block
// has) or over the transform, a twiddle table shorter than the pass's last
// stage needs, an operand not 16-byte aligned, a perm with src == dst, src
// == dst in two layouts.  (The perm's entries are the caller's to keep
// below src_n.)
extern "C" int stark_ntt_block(const void* args, void* stream) {
  const stark_ntt_block_args& g =
      *static_cast<const stark_ntt_block_args*>(args);
  if (g.lead < 0 || g.n < 2 || !stark_pow2(g.n) || g.s0 < 0 || g.k < 1 ||
      g.lc < 0 || g.s0 + g.k > stark_log2(g.n) || g.lc + g.k > 30)
    return 1;
  const long long p = 1LL << (g.lc + g.k);
  if (p > STARK_NTT_TILE_MAX || p > g.n || !stark_pow2(g.tw_rows) ||
      (g.tw_rows >> (g.s0 + g.k - 1)) < 1 || g.src == nullptr ||
      g.dst == nullptr || g.tw == nullptr ||
      (g.perm != nullptr && (g.src_n < 1 || (const void*)g.src ==
                                                (const void*)g.dst)) ||
      (g.perm == nullptr && g.src_n != g.n) ||
      ((const void*)g.src == (const void*)g.dst &&
       g.src_limbs != g.dst_limbs))
    return 1;
  if (!stark_aligned16(g.src, 0) || !stark_aligned16(g.dst, 0) ||
      !stark_aligned16(g.tw, 0) || !stark_aligned16(g.scale, 0))
    return 1;
  const long long blocks = g.lead * (g.n / p);
  if (blocks == 0) return 0;
  const int nt = stark_ntt_block_threads(p);
#if defined(__CUDACC__)
  // above 48 KB only after this opt-in, which holds for the current device
  // alone: so it is set at every launch
  const cudaError_t e = cudaFuncSetAttribute(
      stark_ntt_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)STARK_NTT_SMEM(STARK_NTT_TILE_MAX));
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  stark_ntt_block_kernel<<<(unsigned)blocks, nt, (size_t)STARK_NTT_SMEM(p),
                           st>>>(g);
  return (int)cudaGetLastError();
#else
  (void)stream;
  std::vector<stark_u32x4> sm((std::size_t)(STARK_NTT_SMEM(p) / 16));
  const int wl = stark_ntt_warp_stages(g, nt);
  for (long long b = 0; b < blocks; ++b) {
    const stark_ntt_tile tl = stark_ntt_tile_of(g, b);
    for (int tid = 0; tid < nt; ++tid)
      stark_ntt_tile_load(g, tl, sm.data(), tid, nt);
    for (int t = 0; t < g.k; ++t) {
      stark_u32x4* tw = nullptr;
      if (t >= wl) {
        tw = stark_ntt_twbuf(sm.data(), (int)p, g.k, t);
        for (int tid = 0; tid < nt; ++tid)
          stark_ntt_tile_twiddles(g, tl, tw, t, tid, nt);
      }
      for (int tid = 0; tid < nt; ++tid)
        stark_ntt_tile_stage(g, tl, sm.data(), tw, t, tid);
    }
    for (int tid = 0; tid < nt; ++tid)
      stark_ntt_tile_store(g, tl, sm.data(), tid, nt);
  }
  return 0;
#endif
}
