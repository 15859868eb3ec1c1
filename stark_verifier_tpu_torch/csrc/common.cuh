// Shared definitions for the verifier's CUDA kernels.
//
// Every kernel is one thread per work item, and the per-item body is a
// __host__ __device__ function: nvcc builds it for sm_90a, and a plain C++
// compiler builds the same body behind the same C entry points as a loop over
// the items (no CUDA headers needed), which is how the arithmetic is tested
// where there is no card.
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define STARK_HD __host__ __device__ __forceinline__
#else
#define STARK_HD inline
#endif

#define STARK_BLOCK 128

// 16-byte vector for aligned 128-bit loads and stores of word rows.
struct alignas(16) stark_u32x4 {
  uint32_t x, y, z, w;
};

// Load / store 8 consecutive words (32 bytes, 16-byte aligned) as two
// 128-bit accesses.
STARK_HD void stark_ld8(const uint32_t* p, uint32_t* o) {
  const stark_u32x4* q = reinterpret_cast<const stark_u32x4*>(p);
  stark_u32x4 a = q[0], b = q[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

STARK_HD void stark_st8(uint32_t* p, const uint32_t* v) {
  stark_u32x4* q = reinterpret_cast<stark_u32x4*>(p);
  stark_u32x4 a, b;
  a.x = v[0]; a.y = v[1]; a.z = v[2]; a.w = v[3];
  b.x = v[4]; b.y = v[5]; b.z = v[6]; b.w = v[7];
  q[0] = a;
  q[1] = b;
}

// A row pointer the kernels read with 128-bit loads: 16-byte aligned, and
// a stride (in words) that keeps every row so.
inline bool stark_aligned16(const void* p, long long stride) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0 &&
         stride % 4 == 0;
}

inline bool stark_pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }
