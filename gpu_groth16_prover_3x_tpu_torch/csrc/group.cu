// Whole elliptic-curve group operations, one thread per point.
//
// Replaces the TPU kernels of gpu_groth16_prover_3x_tpu/ops/pallas_group.py
// (`_build`, the pl.pallas_call at :267; entries maybe_add / maybe_dbl /
// maybe_mixed_add), which trace ops/ec.py's RCB15 formulas into one kernel
// so every intermediate stays on chip.  Here each thread runs one complete
// formula (add: 14, dbl: 13, mixed add: 13 field products over Fq, Fq2 or
// Fq3) with its intermediates in registers and local memory; device
// memory sees only the input and output coordinates.
//
// Bound on the H100: 32-bit integer multiply-adds.  One Fq product is a
// 24-word CIOS, 2 * 24^2 = 1152 word products of two multiply-adds each,
// so a G1 add (14 products, about 32k multiply-adds, 1.9 ns at 16.75e12/s)
// against 864 B moved (0.26 ns at 3.35 TB/s) is bound by operations,
// about 7x over the bytes; Fq2 and Fq3 points raise both alike.  The
// design keeps the field product, and for Fq2 / Fq3 every tower operation,
// out of line
// (csrc/field.cuh): one body per field compiles in seconds, while fully
// inlined deg-3 formulas took minutes of nvcc; the cost is call overhead
// and register spills to local memory, which ptxas reports
// (ops/build.py ptxas_report) and PERF.md records.
#include "field.cuh"

template <int CFG>
__global__ void k_ec_add(const uint32_t* P, const uint32_t* Q, uint32_t* out,
                         long long n) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= n) return;
  Pt<CFG> a, c, r;
  pt_load(a, P, n, b);
  pt_load(c, Q, n, b);
  ec_add(r, a, c);
  pt_store(r, out, n, b);
}

template <int CFG>
__global__ void k_ec_dbl(const uint32_t* P, uint32_t* out, long long n) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= n) return;
  Pt<CFG> a, r;
  pt_load(a, P, n, b);
  ec_dbl(r, a);
  pt_store(r, out, n, b);
}

// Q holds the affine operand as (2*D, 24, n): x coefficients, then y.
// inf[b] != 0 marks an infinite affine operand: the result is P.
template <int CFG>
__global__ void k_ec_mixed_add(const uint32_t* P, const uint32_t* Q,
                               const uint8_t* inf, uint32_t* out,
                               long long n) {
  constexpr int D = Cfg<CFG>::D;
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= n) return;
  Pt<CFG> a, r;
  typename Cfg<CFG>::El x, y;
  pt_load(a, P, n, b);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      x.c[i].v[j] = Q[(i * NW + j) * n + b];
      y.c[i].v[j] = Q[((D + i) * NW + j) * n + b];
    }
  if (inf[b]) {
    r = a;
  } else {
    ec_mixed_add(r, a, x, y);
  }
  pt_store(r, out, n, b);
}

#ifndef G16_CFG
#error "compile once per group configuration: -DG16_CFG=0..3 (ops/build.py)"
#endif
#define G16_NAME2(a, b) a##b
#define G16_NAME(a, b) G16_NAME2(a, b)

// One entry point per group configuration G16_CFG (0 MNT4753 G1, 1 MNT4753
// G2, 2 MNT6753 G1, 3 MNT6753 G2), each from its own nvcc process so the
// four build in parallel.
// op: 0 add(P, Q), 1 dbl(P), 2 mixed_add(P, Q affine, inf).
extern "C" int G16_NAME(g16_ec_op_, G16_CFG)(int op, const void* P,
                                             const void* Q, const void* inf,
                                             void* out, long long n,
                                             void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* p = (const uint32_t*)P;
  const uint32_t* q = (const uint32_t*)Q;
  uint32_t* o = (uint32_t*)out;
  if (op == 0)
    k_ec_add<G16_CFG><<<blocks, threads, 0, st>>>(p, q, o, n);
  else if (op == 1)
    k_ec_dbl<G16_CFG><<<blocks, threads, 0, st>>>(p, o, n);
  else if (op == 2)
    k_ec_mixed_add<G16_CFG><<<blocks, threads, 0, st>>>(
        p, q, (const uint8_t*)inf, o, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
