// One-thread device field layer of the Montgomery product kernel
// (csrc/mont_mul.cu): 753-bit Montgomery arithmetic over 24 x 32-bit words
// (R = 2^768, the file format's radix), one element per thread.  Values
// are canonical (< p) on entry and exit, so the kernel and its plain
// version agree word for word.  The group and scan kernels use the lane
// layer of field_coop.cuh instead.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#include "g16_constants.cuh"  // G16_P, G16_NINV, G16_ONE, G16_B3 (generated)

#define NW 24

struct Fp {
  uint32_t v[NW];
};

// -- prime field --------------------------------------------------------------

// CIOS Montgomery product a*b/R mod p with 64-bit accumulators; canonical
// output by one conditional subtract ((ab + mp)/R < 2p for a, b < p).
template <int P>
__device__ __forceinline__ void fp_mul_inl(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t ai = a.v[i];
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)ai * b.v[j] + t[j] + c;
      t[j] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
    uint64_t s = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * G16_NINV[P];
    s = (uint64_t)m * G16_P[P][0] + t[0];
    c = (uint32_t)(s >> 32);
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)m * G16_P[P][j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
    s = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  uint32_t d[NW];
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)t[j] - G16_P[P][j] - br;
    d[j] = (uint32_t)s;
    br = (uint32_t)(s >> 32) & 1u;
  }
  const bool ge = (t[NW] != 0) || (br == 0);
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = ge ? d[j] : t[j];
}
