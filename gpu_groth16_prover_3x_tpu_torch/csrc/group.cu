// Whole elliptic-curve group operations, one group of T lanes per point.
//
// Replaces the TPU kernels of gpu_groth16_prover_3x_tpu/ops/pallas_group.py
// (`_build`, the pl.pallas_call at :267; entries maybe_add / maybe_dbl /
// maybe_mixed_add), which trace ops/ec.py's RCB15 formulas into one kernel
// so every intermediate stays on chip.  Here T neighbouring lanes of a
// warp run one complete formula together (add: 14, dbl: 13, mixed add: 13
// field products over Fq, Fq2 or Fq3), each lane holding 24 / T words of
// every field element (csrc/field_coop.cuh); device memory sees only the
// input and output coordinates.
//
// Bound on the H100: 32-bit integer multiply-adds.  One Fq product is a
// 24-word CIOS, 2 * 24^2 = 1152 word products of two multiply-adds each,
// so a G1 add (14 products, about 32k multiply-adds, 1.9 ns at 16.75e12/s)
// against 864 B moved (0.26 ns at 3.35 TB/s) is bound by operations,
// about 7x over the bytes; Fq2 and Fq3 points raise both alike.  What
// kept one thread per point away from that bound was its state: 72 to 216
// words a point plus the formula's temporaries, in local memory, with 8
// warps on an SM.  Spread over T lanes (4 for G1, 8 for the towers) the
// state is registers only, with no stack frame for G1 and Fq2, and 12 to
// 16 warps are resident; the price is three shuffles per CIOS step
// (field_coop.cuh).
//
// Memory access: the (3*deg, 24, n) operands are limb-major with the
// point index fastest, and a lane reads and writes its own words of each
// coefficient directly.  A warp covers 32 / T neighbouring points of T
// rows per access: whole 32-byte sectors for T = 4, half sectors for
// T = 8, whose other half the neighbouring warp takes.  Staging the
// tiles through shared memory was measured and is no faster (the
// G16_STAGE variant below, tune_lanes.py, PERF.md): the kernels are bound
// by operations several times over their bytes.
#ifndef G16_CFG
#error "compile once per group configuration: -DG16_CFG=0..3 (ops/build.py)"
#endif
#include "field_coop.cuh"

// Blocks of G16_THREADS that must fit an SM (the register cap): 16 warps
// for the towers on 8 lanes, 12 for G1 on 4 lanes, which holds twice the
// words a lane and measured faster than 8 lanes at 16 warps.
#ifndef G16_MINB
#if G16_T == 4
#define G16_MINB 3
#else
#define G16_MINB 4
#endif
#endif
#define G16_THREADS 128

// internal linkage: every configuration's unit defines these names
namespace {

using O = lanes::Ops<G16_CFG, G16_T>;

// The point this thread's group works on.  Every shuffle names the whole
// warp, so no group leaves early: past the end a group computes on the
// last point again and `live` keeps it from storing.
__device__ __forceinline__ long long group_index(long long n, bool& live) {
  const long long g =
      (blockIdx.x * (long long)G16_THREADS + threadIdx.x) / G16_T;
  live = g < n;
  return live ? g : n - 1;
}

#ifndef G16_STAGE
__global__ void __launch_bounds__(G16_THREADS, G16_MINB)
k_ec_add(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
         uint32_t* __restrict__ out, long long n) {
  bool live;
  const long long b = group_index(n, live);
  O::Ln L;
  O::init(L);
  O::Pt a, c, r;
  O::pt_load(L, a, P, n, b);
  O::pt_load(L, c, Q, n, b);
  O::ec_add(L, r, a, c);
  if (live) O::pt_store(L, r, out, n, b);
}
#else
// Measurement variant (tune_lanes.py, -DG16_STAGE): the same add with its
// operands and result staged through shared-memory tiles, so that device
// memory sees whole sectors per warp whatever T is.  The row stride of a
// tile (points per block + 4) keeps the 8 lanes of a group on 8 banks.
__global__ void __launch_bounds__(G16_THREADS, G16_MINB)
k_ec_add(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
         uint32_t* __restrict__ out, long long n) {
  static_assert(G16_T == 8, "the tile stride is chosen for 8 lanes");
  constexpr int PB = G16_THREADS / G16_T, STR = PB + 4,
                ROWS = 3 * O::D * NW;
  __shared__ uint32_t sp[ROWS * STR], sq[ROWS * STR];
  const long long b0 = blockIdx.x * (long long)PB;
  for (int i = threadIdx.x; i < ROWS * PB; i += G16_THREADS) {
    const int row = i / PB, col = i % PB;
    if (b0 + col < n) {
      sp[row * STR + col] = P[(long long)row * n + b0 + col];
      sq[row * STR + col] = Q[(long long)row * n + b0 + col];
    }
  }
  __syncthreads();
  const int pt = threadIdx.x / G16_T;
  const bool live = b0 + pt < n;
  O::Ln L;
  O::init(L);
  O::Pt a, c, r;
  O::pt_load(L, a, sp, STR, pt);        // past the end: unused tile words
  O::pt_load(L, c, sq, STR, pt);
  O::ec_add(L, r, a, c);
  __syncthreads();
  if (live) O::pt_store(L, r, sp, STR, pt);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * PB; i += G16_THREADS) {
    const int row = i / PB, col = i % PB;
    if (b0 + col < n) out[(long long)row * n + b0 + col] = sp[row * STR + col];
  }
}
#endif

__global__ void __launch_bounds__(G16_THREADS, G16_MINB)
k_ec_dbl(const uint32_t* __restrict__ P, uint32_t* __restrict__ out,
         long long n) {
  bool live;
  const long long b = group_index(n, live);
  O::Ln L;
  O::init(L);
  O::Pt a, r;
  O::pt_load(L, a, P, n, b);
  O::ec_dbl(L, r, a);
  if (live) O::pt_store(L, r, out, n, b);
}

// Q holds the affine operand as (2*D, 24, n): x coefficients, then y.
// inf[b] != 0 marks an infinite affine operand: the result is P (a select:
// the groups of a warp stay in step).
__global__ void __launch_bounds__(G16_THREADS, G16_MINB)
k_ec_mixed_add(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
               const uint8_t* __restrict__ inf, uint32_t* __restrict__ out,
               long long n) {
  bool live;
  const long long b = group_index(n, live);
  O::Ln L;
  O::init(L);
  O::Pt a, r;
  O::El x, y;
  O::pt_load(L, a, P, n, b);
  O::el_load(L, x, Q, 0, n, b);
  O::el_load(L, y, Q, O::D, n, b);
  O::ec_mixed_add(L, r, a, x, y);
  O::select(r, inf[b] != 0, a, r);
  if (live) O::pt_store(L, r, out, n, b);
}

}  // namespace

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
  const int threads = G16_THREADS;
  const long long per_block = threads / G16_T;     // points per block
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* p = (const uint32_t*)P;
  const uint32_t* q = (const uint32_t*)Q;
  uint32_t* o = (uint32_t*)out;
  if (op == 0)
    k_ec_add<<<blocks, threads, 0, st>>>(p, q, o, n);
  else if (op == 1)
    k_ec_dbl<<<blocks, threads, 0, st>>>(p, o, n);
  else if (op == 2)
    k_ec_mixed_add<<<blocks, threads, 0, st>>>(
        p, q, (const uint8_t*)inf, o, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
