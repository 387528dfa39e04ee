// The NTT butterfly's add/sub: (a + b) mod p and (a - b) mod p of
// canonical 24-word elements, both halves in one launch, one thread per
// element.
//
// Replaces no TPU kernel.  The JAX package forms E + t and E - t of each
// NTT level with plain limb arithmetic under jit (gpu_groth16_prover_3x_tpu/
// ops/ntt.py `_ntt`, F.add / F.sub), which XLA fuses into one pass over
// the level.  PyTorch runs eagerly and fuses nothing: the port's plain
// version (ops/limbs.py add / sub on 32 int64 limbs) is about 160
// elementwise launches a level and 2.6 KB of temporaries a lane.  This
// kernel is that one pass.
//
// Bound on the H100: bytes.  A butterfly reads E and t and writes E + t
// and E - t, 4 x 96 B; its arithmetic is two 24-word carry chains and a
// conditional correction each, about 200 integer instructions, far under
// the card's rate for 384 B.  A level at 2^20 (2^19 butterflies) moves
// 201 MB: 0.06 ms at 3.35 TB/s.  So the design moves each byte once:
// the 24 words of a, b and the results stay in registers, the loads and
// stores are coalesced in the limb-major layout (lane i reads word j at
// j * word_stride + offset(i), neighbouring lanes neighbouring words),
// and each operand is read where it lies through its strides, so the
// strided even half E of a level needs no copy and the two results land
// straight in the level's output.
//
// Geometry.  Every operand is a (24, n1, n2, n3) view with unit stride
// along n3; the wrapper (ops/ntt.py add_sub) passes the sizes and, per
// operand, the word stride and the strides of n1 and n2.  A stride of 0
// broadcasts.  Outputs may be the inputs themselves: a thread reads all
// of its words before it writes any.
#include "field.cuh"

// a, b, sum, diff
#define G16_OPS 4

struct AddSubGeom {
  unsigned lanes, n2, n3;
  long long w[G16_OPS], s1[G16_OPS], s2[G16_OPS];
};

// MODE: 0 both, 1 the sum only, 2 the difference only.
template <int P, int MODE>
__global__ void k_ntt_addsub(const uint32_t* a, const uint32_t* b,
                             uint32_t* sum, uint32_t* diff, AddSubGeom g) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.lanes) return;
  const unsigned k = i % g.n3, r = i / g.n3;
  const long long m = r % g.n2, q = r / g.n2;
  long long off[G16_OPS];
#pragma unroll
  for (int o = 0; o < G16_OPS; ++o) off[o] = q * g.s1[o] + m * g.s2[o] + k;
  uint32_t x[NW], y[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    x[j] = a[j * g.w[0] + off[0]];
    y[j] = b[j * g.w[1] + off[1]];
  }
  if (MODE != 2) {
    // x + y < 2p < 2^768: one carry chain, then x + y - p where that
    // does not borrow
    uint32_t s[NW], d[NW], c = 0, br = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t t = (uint64_t)x[j] + y[j] + c;
      s[j] = (uint32_t)t;
      c = (uint32_t)(t >> 32);
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t t = (uint64_t)s[j] - G16_P[P][j] - br;
      d[j] = (uint32_t)t;
      br = (uint32_t)(t >> 32) & 1u;
    }
    const bool ge = (c != 0) || (br == 0);
#pragma unroll
    for (int j = 0; j < NW; ++j) sum[j * g.w[2] + off[2]] = ge ? d[j] : s[j];
  }
  if (MODE != 1) {
    // x - y, plus p where it borrowed (mod 2^768)
    uint32_t d[NW], br = 0, c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t t = (uint64_t)x[j] - y[j] - br;
      d[j] = (uint32_t)t;
      br = (uint32_t)(t >> 32) & 1u;
    }
    const uint32_t mask = 0u - br;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t t = (uint64_t)d[j] + (G16_P[P][j] & mask) + c;
      diff[j * g.w[3] + off[3]] = (uint32_t)t;
      c = (uint32_t)(t >> 32);
    }
  }
}

template <int P>
static void launch(int mode, unsigned blocks, unsigned threads,
                   cudaStream_t st, const uint32_t* a, const uint32_t* b,
                   uint32_t* sum, uint32_t* diff, const AddSubGeom& g) {
  if (mode == 0)
    k_ntt_addsub<P, 0><<<blocks, threads, 0, st>>>(a, b, sum, diff, g);
  else if (mode == 1)
    k_ntt_addsub<P, 1><<<blocks, threads, 0, st>>>(a, b, sum, diff, g);
  else
    k_ntt_addsub<P, 2><<<blocks, threads, 0, st>>>(a, b, sum, diff, g);
}

// prime: 0 = P_A, 1 = P_B (as g16_mont_mul).  mode: 0 writes sum and
// diff, 1 sum only, 2 diff only (the unused pointer may be null).
// geom: n1, n2, n3, then for a, b, sum, diff in turn the word stride and
// the strides of n1 and n2 (15 values, in elements).
extern "C" int g16_ntt_addsub(int prime, int mode, const void* a,
                              const void* b, void* sum, void* diff,
                              const long long* geom, void* stream) {
  if (prime < 0 || prime > 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const long long n1 = geom[0], n2 = geom[1], n3 = geom[2];
  if (n1 <= 0 || n2 <= 0 || n3 <= 0) return 0;
  const long long lanes = n1 * n2 * n3;
  if (lanes >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  AddSubGeom g;
  g.lanes = (unsigned)lanes;
  g.n2 = (unsigned)n2;
  g.n3 = (unsigned)n3;
  for (int o = 0; o < G16_OPS; ++o) {
    g.w[o] = geom[3 + 3 * o];
    g.s1[o] = geom[4 + 3 * o];
    g.s2[o] = geom[5 + 3 * o];
  }
  const unsigned threads = 256;
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t *pa = (const uint32_t*)a, *pb = (const uint32_t*)b;
  uint32_t *ps = (uint32_t*)sum, *pd = (uint32_t*)diff;
  if (prime == 0)
    launch<0>(mode, blocks, threads, st, pa, pb, ps, pd, g);
  else
    launch<1>(mode, blocks, threads, st, pa, pb, ps, pd, g);
  return (int)cudaGetLastError();
}
