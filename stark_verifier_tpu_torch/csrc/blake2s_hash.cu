// Narrow Blake2s hashes, one launch for all the messages of a call:
// stark_hash_words.
//
// Replaces no pallas_call.  The JAX package left these hashes to XLA: the
// Fiat-Shamir chain links (ops/prg.chain_entries), the k-hashes, the dense
// tail levels of the shared Merkle walk and strict mode's POINTS root, all
// through ops/blake2s.hash_words.  The port ran them as plain torch, some
// 590 small kernels a compression, launched one after another by the host.
// Here one thread owns one message: it reads the message's W words (zeros
// past W, nothing masked by nbytes: exactly the words the plain version
// reads, so the two agree bit for bit on any input, bad padding included),
// compresses ceil(nbytes / 64) blocks (at least one) with the register
// compression of blake2s.cuh, and writes the 8-word digest.  In chain mode a
// thread owns one 32-byte entry and hashes it `links` times in registers,
// writing every entry, the raw seed first, as ops/prg.chain_entries returns
// them: a call's chains in one launch instead of one launch a link.
//
// What bounds it on an H100: the launch.  A verify call hashes a few
// thousand messages of one to three blocks (its chains: 512 proofs x 6
// seeds x 9 links), microseconds of device work, and each launch costs the
// host about as much.  By instruction count the bound is the integer ALU
// pipe, 668 ALU-only instructions a compression (blake2s.cuh); a thread's
// dependent rounds set its latency.  So the design is the fewest launches:
// one for every message of a call, whatever its width, length or leading
// shape, and one for every chain of a call.
#include "blake2s.cuh"

// The operands of one launch (_build.HashArgs: the same fields in the same
// order).
struct stark_hash_args {
  const void* src;  // [n, words] int32 words, any alignment
  void* dst;        // [n, 8] digests, or [n, links + 1, 8] in chain mode;
                    // 16-byte aligned
  long long n;      // messages (chain mode: seeds)
  int words;        // W, the words a message (chain mode: 8)
  int nbytes;       // the message's length in bytes, at most 4 W (chain: 32)
  int chain;        // 0: one digest a message; 1: each seed's chain
  int links;        // chain mode: the links after the seed, at least 0
};

// Message i of `src`: blocks of 16 words read from its W, zeros past W.
STARK_HD void stark_hash_one(long long i, const uint32_t* src, uint32_t* dst,
                             int words, int nbytes) {
  const uint32_t* msg = src + i * words;
  int nblocks = nbytes > 64 ? (nbytes + 63) / 64 : 1;
  uint32_t h[8], m[16];
  b2s_init(h);
#pragma unroll 1
  for (int blk = 0; blk < nblocks; ++blk) {
    int lo = blk * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) m[j] = lo + j < words ? msg[lo + j] : 0u;
    bool last = blk == nblocks - 1;
    b2s_compress(h, m, last ? (uint32_t)nbytes : (uint32_t)(4 * lo + 64),
                 last);
  }
  stark_st8(dst + i * 8, h);
}

// Seed i of `src` and its `links` chain links: entry k + 1 = Blake2s of the
// 32 bytes of entry k.
STARK_HD void stark_chain_one(long long i, const uint32_t* src, uint32_t* dst,
                              int links) {
  uint32_t h[8], m[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    h[j] = src[i * 8 + j];
    m[8 + j] = 0u;
  }
  uint32_t* row = dst + i * (long long)(links + 1) * 8;
  stark_st8(row, h);
#pragma unroll 1
  for (int k = 1; k <= links; ++k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = h[j];
    b2s_init(h);
    b2s_compress(h, m, 32u, true);
    stark_st8(row + k * 8, h);
  }
}

#if defined(__CUDACC__)
template <bool CHAIN>
__global__ void __launch_bounds__(STARK_BLOCK)
stark_hash_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                  long long n, int words, int nbytes, int links) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (CHAIN)
    stark_chain_one(i, src, dst, links);
  else
    stark_hash_one(i, src, dst, words, nbytes);
}
#endif

// One launch over a->n messages (or seeds).  Returns cudaGetLastError(), or
// 1 (cudaErrorInvalidValue) for operands the kernel does not take: no
// words, a length outside [0, 4 W], a chain over other than 32-byte entries
// or with negative links, an unaligned dst.
extern "C" int stark_hash_words(const stark_hash_args* a, void* stream) {
  const uint32_t* src = static_cast<const uint32_t*>(a->src);
  uint32_t* dst = static_cast<uint32_t*>(a->dst);
  if (a->words < 1 || a->nbytes < 0 || a->nbytes > 4LL * a->words) return 1;
  if (a->chain != 0 && a->chain != 1) return 1;
  if (a->chain && (a->words != 8 || a->nbytes != 32 || a->links < 0)) return 1;
  if (!stark_aligned16(dst, 0)) return 1;
  if (a->n <= 0) return 0;
#if defined(__CUDACC__)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned grid = (unsigned)((a->n + STARK_BLOCK - 1) / STARK_BLOCK);
  if (a->chain)
    stark_hash_kernel<true><<<grid, STARK_BLOCK, 0, st>>>(
        src, dst, a->n, a->words, a->nbytes, a->links);
  else
    stark_hash_kernel<false><<<grid, STARK_BLOCK, 0, st>>>(
        src, dst, a->n, a->words, a->nbytes, a->links);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (long long i = 0; i < a->n; ++i) {
    if (a->chain)
      stark_chain_one(i, src, dst, a->links);
    else
      stark_hash_one(i, src, dst, a->words, a->nbytes);
  }
  return 0;
#endif
}
