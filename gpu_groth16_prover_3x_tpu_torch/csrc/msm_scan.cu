// Pippenger bucket scan: all S steps of a chunk in one thread.
//
// Replaces the TPU kernel of gpu_groth16_prover_3x_tpu/ops/pallas_group.py
// `_fuse_build` (the pl.pallas_call at :490), whose only caller runs ONE
// scan step (ops/msm.py step_core, :413-441) per launch under a lax.scan
// of S - 1 launches (msm.py:466).  Here one launch covers a window block:
// thread b owns chunk b (S consecutive points of one window's digit-sorted
// order) and loops over its S steps with the run accumulator kept in the
// thread.  Per step it lifts the next sorted affine point (y -> p - y for
// a negative digit, the infinity mask y == 0 taken first), adds it to the
// accumulator when the key repeats or restarts the run when it changes,
// and writes the same emissions, first partial, tail and has-changed flag
// that the stitch and scatter stages consume.
//
// Bound on the H100: 32-bit integer multiply-adds.  A G1 mixed add is 13
// Fq products (about 30k multiply-adds, 1.8 ns at 16.75e12/s) per step
// against 192 B of point row read and 288 B of emission written (0.14 ns
// at 3.35 TB/s): operations bound it, about 12x over the bytes.  The point
// rows are read through the sorted index straight from the (n, 2*D*24)
// file-layout rows (no gathered copy), and a run restart skips the mixed
// add.  The accumulator spills to local memory
// (ptxas report); occupancy comes from many windows per launch.
#include "field.cuh"

// rows: (nrows, 2*D*24) affine rows; idx, keys: (S, B) int32; signs: (S, B)
// uint8 or null.  Outputs: em (3D, 24, S-1, B) run totals emitted before
// step s (the accumulator entering step s), em_valid (S-1, B), tail and
// first (3D, 24, B), haschg (B).
template <int CFG>
__global__ void k_msm_scan(const uint32_t* rows, const int32_t* idx,
                           const int32_t* keys, const uint8_t* signs, int S,
                           long long B, uint32_t* em, uint8_t* em_valid,
                           uint32_t* tail, uint32_t* first, uint8_t* haschg) {
  using C = Cfg<CFG>;
  using El = typename C::El;
  constexpr int D = C::D, P = C::P, F = 2 * D * NW;
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;

  Pt<CFG> acc, fst, lifted;
  El x, y, zero;
#pragma unroll
  for (int i = 0; i < D; ++i) fp_zero(zero.c[i]);
  pt_identity(fst);

  // lift step s's point; returns its infinity flag
  auto load = [&](int s) -> bool {
    const uint32_t* row = rows + (long long)idx[s * B + b] * F;
    bool inf = true;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        x.c[i].v[j] = row[i * NW + j];
        y.c[i].v[j] = row[(D + i) * NW + j];
      }
#pragma unroll
    for (int i = 0; i < D; ++i) inf = inf && fp_is_zero(y.c[i]);
    if (signs != nullptr && signs[s * B + b]) e_sub(y, zero, y);
    if (inf) {
      pt_identity(lifted);
    } else {
      lifted.X = x;
      lifted.Y = y;
      lifted.Z = zero;
      fp_one<P>(lifted.Z.c[0]);
    }
    return inf;
  };

  load(0);
  acc = lifted;
  int prevk = keys[b];
  bool chg = false;
  const long long es = (long long)(S - 1) * B;
  for (int s = 1; s < S; ++s) {
    const int k = keys[s * B + b];
    const bool same = (k == prevk);
    pt_store(acc, em + (long long)(s - 1) * B, es, b);
    em_valid[(s - 1) * B + b] = (!same && chg) ? 1 : 0;
    if (!same && !chg) fst = acc;
    const bool inf = load(s);
    if (!same) {
      acc = lifted;
    } else if (!inf) {
      ec_mixed_add(acc, acc, x, y);
    }
    chg = chg || !same;
    prevk = k;
  }
  pt_store(acc, tail, B, b);
  pt_store(fst, first, B, b);
  haschg[b] = chg ? 1 : 0;
}

#ifndef G16_CFG
#error "compile once per group configuration: -DG16_CFG=0..3 (ops/build.py)"
#endif
#define G16_NAME2(a, b) a##b
#define G16_NAME(a, b) G16_NAME2(a, b)

// One entry point per group configuration G16_CFG (csrc/group.cu).
extern "C" int G16_NAME(g16_msm_scan_, G16_CFG)(
    const void* rows, const void* idx, const void* keys, const void* signs,
    int S, long long B, void* em, void* em_valid, void* tail, void* first,
    void* haschg, void* stream) {
  if (B <= 0) return 0;
  if (S < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  k_msm_scan<G16_CFG><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (const int32_t*)idx, (const int32_t*)keys,
      (const uint8_t*)signs, S, B, (uint32_t*)em, (uint8_t*)em_valid,
      (uint32_t*)tail, (uint32_t*)first, (uint8_t*)haschg);
  return (int)cudaGetLastError();
}
