// Batched Montgomery product a*b/R mod p, one thread per element.
//
// Replaces the TPU kernel of gpu_groth16_prover_3x_tpu/ops/pallas_kernels.py
// (`_build`, the pl.pallas_call at :121, body `_kernel_body`): a fully
// unrolled CIOS over 48 x 16-bit limbs with lazy carries and a final
// Kogge-Stone resolve, vectorized across 1024 lanes.  Here each thread
// keeps one element's 24-word CIOS accumulator in registers and uses the
// card's 32 x 32 -> 64 bit multiply-add, so no carry folds are needed.
//
// Bound on the H100: 32-bit integer multiply-adds.  An element needs
// 2 * 24^2 = 1152 word products, each a low and a high multiply-add
// (about 144 us per 2^20 elements at 16.75e12/s), against 3 * 96 B of
// traffic (about 90 us per 2^20 at 3.35 TB/s).  The two bounds are close,
// so the design keeps the whole accumulator in registers (no local
// memory) and the loads coalesced (limb-major (24, n) layout: lane b
// reads word j at j*n + b).
//
// Also defines g16_error_string for the Python wrappers.
#include "field.cuh"

template <int P>
__global__ void k_mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* out,
                           long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp x, y, r;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    x.v[j] = a[j * n + i];
    y.v[j] = b[j * n + i];
  }
  fp_mul_inl<P>(r, x, y);
#pragma unroll
  for (int j = 0; j < NW; ++j) out[j * n + i] = r.v[j];
}

// prime: 0 = P_A (MNT4753 Fr = MNT6753 Fq), 1 = P_B (MNT4753 Fq = MNT6753 Fr).
extern "C" int g16_mont_mul(int prime, const void* a, const void* b, void* out,
                            long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (prime == 0)
    k_mont_mul<0><<<blocks, threads, 0, st>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  else if (prime == 1)
    k_mont_mul<1><<<blocks, threads, 0, st>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* g16_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
