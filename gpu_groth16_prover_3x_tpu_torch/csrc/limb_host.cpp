// Host-side native kernels: 12x64-limb Montgomery arithmetic + batch
// affine normalization primitives for the Groth16 prover's host side.
//
// This is the framework's native runtime counterpart of the reference's
// host C++ stack: the Montgomery multiply mirrors libff's mpn-based
// Fp_model::mul for n=12 (depends/libff/libff/algebra/fields/fp.tcc:26-185)
// and the batch-inversion prefix/suffix walk mirrors
// batch_to_special_all_non_zeros (mnt4753_g1.cpp:485-503).  It is used by
// the Python layer (gpu_groth16_prover_3x_tpu_torch/utils/native.py, via
// ctypes): the exact Pippenger MSM, fixed-base exponentiation and FFT of
// the host oracle, and the Horner recombination of the device MSM's
// window sums.  A copy of the JAX package's csrc/limb_host.cpp.
//
// Build: g++ -O3 -shared -fPIC -o libgroth16host.so limb_host.cpp
// (no external dependencies; unsigned __int128 for the 64x64->128 mul).
// utils/native.py builds it at first use into the package's _build/.

#include <cstdint>
#include <cstring>

namespace {

constexpr int NL = 12;  // 12 x 64-bit limbs = 768 bits

using u64 = std::uint64_t;
using u128 = unsigned __int128;

// out = a + b, returns carry
inline u64 add_n(u64 *out, const u64 *a, const u64 *b) {
    u128 c = 0;
    for (int i = 0; i < NL; ++i) {
        c += (u128)a[i] + b[i];
        out[i] = (u64)c;
        c >>= 64;
    }
    return (u64)c;
}

// out = a - b, returns borrow
inline u64 sub_n(u64 *out, const u64 *a, const u64 *b) {
    u128 br = 0;
    for (int i = 0; i < NL; ++i) {
        u128 d = (u128)a[i] - b[i] - br;
        out[i] = (u64)d;
        br = (d >> 64) & 1;  // two's complement borrow
    }
    return (u64)br;
}

inline bool geq(const u64 *a, const u64 *b) {
    for (int i = NL - 1; i >= 0; --i) {
        if (a[i] != b[i]) return a[i] > b[i];
    }
    return true;
}

// CIOS Montgomery multiply: out = a * b * 2^-768 mod p  (inputs < p)
inline void mont_mul_one(u64 *out, const u64 *a, const u64 *b,
                         const u64 *p, u64 inv) {
    u64 t[NL + 2] = {0};
    for (int i = 0; i < NL; ++i) {
        // t += a[i] * b
        u128 c = 0;
        for (int j = 0; j < NL; ++j) {
            c += (u128)t[j] + (u128)a[i] * b[j];
            t[j] = (u64)c;
            c >>= 64;
        }
        c += t[NL];
        t[NL] = (u64)c;
        t[NL + 1] += (u64)(c >> 64);
        // m = t[0] * inv mod 2^64; t += m * p; t >>= 64
        u64 m = t[0] * inv;
        c = (u128)t[0] + (u128)m * p[0];
        c >>= 64;
        for (int j = 1; j < NL; ++j) {
            c += (u128)t[j] + (u128)m * p[j];
            t[j - 1] = (u64)c;
            c >>= 64;
        }
        c += t[NL];
        t[NL - 1] = (u64)c;
        t[NL] = t[NL + 1] + (u64)(c >> 64);
        t[NL + 1] = 0;
    }
    if (t[NL] || geq(t, p)) sub_n(t, t, p);
    std::memcpy(out, t, NL * sizeof(u64));
}

}  // namespace

extern "C" {

// Elementwise Montgomery products: out[i] = a[i] * b[i * b_stride] / R.
// b_stride 0 broadcasts a single right operand (encode/decode).
void g16_mont_mul_batch(u64 *out, const u64 *a, const u64 *b,
                        long long n, long long b_stride,
                        const u64 *p, u64 inv) {
    for (long long i = 0; i < n; ++i) {
        mont_mul_one(out + i * NL, a + i * NL, b + i * b_stride * NL,
                     p, inv);
    }
}

// Batch affine normalization, phase 1: prefix products of the z
// coordinates (zeros pass through as ones), all in the Montgomery domain.
// prefix has n+1 entries; prefix[0] must be preloaded with R mod p (the
// Montgomery one).  Returns nothing; caller inverts prefix[n] (one
// modular inverse, host bigint) and calls phase 2.
void g16_batch_inv_prefix(u64 *prefix, const u64 *zs, long long n,
                          const u64 *p, u64 inv) {
    u64 zero[NL] = {0};
    for (long long i = 0; i < n; ++i) {
        const u64 *z = zs + i * NL;
        bool is_zero = std::memcmp(z, zero, sizeof zero) == 0;
        if (is_zero) {
            std::memcpy(prefix + (i + 1) * NL, prefix + i * NL,
                        NL * sizeof(u64));
        } else {
            mont_mul_one(prefix + (i + 1) * NL, prefix + i * NL, z, p, inv);
        }
    }
}

// Phase 2: walk backwards turning the inverted total into per-element
// inverses: zinv[i] = prefix[i] * total_inv; total_inv *= z[i].
// total_inv holds the Montgomery-domain inverse of prefix[n] on entry.
void g16_batch_inv_suffix(u64 *zinvs, u64 *total_inv, const u64 *prefix,
                          const u64 *zs, long long n,
                          const u64 *p, u64 inv) {
    u64 zero[NL] = {0};
    for (long long i = n - 1; i >= 0; --i) {
        const u64 *z = zs + i * NL;
        if (std::memcmp(z, zero, sizeof zero) == 0) {
            std::memset(zinvs + i * NL, 0, NL * sizeof(u64));
        } else {
            mont_mul_one(zinvs + i * NL, prefix + i * NL, total_inv, p, inv);
            mont_mul_one(total_inv, total_inv, z, p, inv);
        }
    }
}

// Affine projection: for homogeneous projective (X:Y:Z) Montgomery rows,
// out_x = X * zinv / R ... (stays in the Montgomery domain):
//   out[i] = in[i] * zinvs[i] / R
void g16_mul_pairwise(u64 *out, const u64 *a, const u64 *zinvs,
                      long long n, const u64 *p, u64 inv) {
    for (long long i = 0; i < n; ++i) {
        mont_mul_one(out + i * NL, a + i * NL, zinvs + i * NL, p, inv);
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Generic tower-field + elliptic-curve kernels for the host oracle.
//
// These make the CPU oracle usable at reference scale (2^16..2^20
// constraints): the reference's oracle is the OpenMP BDLO12 Pippenger
// prover (libsnark/main.cpp:172-233 with
// depends/libff/libff/algebra/scalar_multiplication/multiexp.tcc:165-283);
// ours is the same bucket algorithm in portable C++ over the shared
// 12x64-limb Montgomery layout.  Field elements of Fp^deg (deg 1/2/3,
// non-residue alpha) are deg consecutive 12-limb blocks; points are
// Jacobian (X,Y,Z) = 3*deg blocks, zero iff Z == 0 (the convention of
// host/ec.py and multiexp/curves.cu:7-103).
// ---------------------------------------------------------------------------

namespace {

constexpr int MAXDEG = 3;

struct Fctx {
    const u64 *p;      // 12-limb prime
    u64 inv;           // -p^-1 mod 2^64
    int deg;           // extension degree 1, 2, 3
    const u64 *alpha;  // non-residue, Montgomery domain, 12 limbs (deg>1)
};

inline void cp(u64 *out, const u64 *a, int nblk) {
    std::memcpy(out, a, nblk * NL * sizeof(u64));
}

inline bool blk_is_zero(const u64 *a, int nblk) {
    for (int i = 0; i < nblk * NL; ++i)
        if (a[i]) return false;
    return true;
}

// base-field (one 12-limb block) ops; inputs reduced < p
inline void bf_add(const Fctx &f, u64 *out, const u64 *a, const u64 *b) {
    add_n(out, a, b);            // p is 753-bit: no carry out of 768
    if (geq(out, f.p)) sub_n(out, out, f.p);
}

inline void bf_sub(const Fctx &f, u64 *out, const u64 *a, const u64 *b) {
    if (sub_n(out, a, b)) add_n(out, out, f.p);
}

inline void bf_mul(const Fctx &f, u64 *out, const u64 *a, const u64 *b) {
    mont_mul_one(out, a, b, f.p, f.inv);
}

// extension element ops (deg blocks); schoolbook with alpha fold-in,
// the same maths as host/field.py e_mul / the device towers
// (multiexp/arith.cu:370-619).
inline void fe_add(const Fctx &f, u64 *out, const u64 *a, const u64 *b) {
    for (int i = 0; i < f.deg; ++i)
        bf_add(f, out + i * NL, a + i * NL, b + i * NL);
}

inline void fe_sub(const Fctx &f, u64 *out, const u64 *a, const u64 *b) {
    for (int i = 0; i < f.deg; ++i)
        bf_sub(f, out + i * NL, a + i * NL, b + i * NL);
}

inline void fe_mul(const Fctx &f, u64 *out, const u64 *a, const u64 *b) {
    u64 acc[MAXDEG * NL], t[NL];
    for (int i = 0; i < f.deg * NL; ++i) acc[i] = 0;
    for (int i = 0; i < f.deg; ++i) {
        for (int j = 0; j < f.deg; ++j) {
            bf_mul(f, t, a + i * NL, b + j * NL);
            int k = i + j;
            if (k >= f.deg) {  // wrap with alpha: x^deg = alpha
                k -= f.deg;
                bf_mul(f, t, t, f.alpha);
            }
            bf_add(f, acc + k * NL, acc + k * NL, t);
        }
    }
    cp(out, acc, f.deg);
}

inline void fe_dbl(const Fctx &f, u64 *out, const u64 *a) {
    fe_add(f, out, a, a);
}

// Jacobian point = 3*deg blocks (X, Y, Z).  Formulas mirror host/ec.py
// (dbl-2007-bl / add-2007-bl with complete case dispatch).
struct Ectx {
    Fctx f;
    const u64 *a_coef;    // curve a, Montgomery, deg blocks
    const u64 *mont_one;  // R mod p, 12 limbs (for the Z2==1 fast path)
};

// Z == Montgomery one in every component (c0 == R mod p, rest zero)?
inline bool fe_is_one(const Ectx &e, const u64 *z) {
    if (std::memcmp(z, e.mont_one, NL * sizeof(u64))) return false;
    for (int i = NL; i < e.f.deg * NL; ++i)
        if (z[i]) return false;
    return true;
}

inline bool pt_is_zero(const Ectx &e, const u64 *pt) {
    return blk_is_zero(pt + 2 * e.f.deg * NL, e.f.deg);
}

inline void pt_set_zero(const Ectx &e, u64 *pt) {
    std::memset(pt, 0, 3 * e.f.deg * NL * sizeof(u64));
}

void ec_dbl(const Ectx &e, u64 *out, const u64 *pt) {
    const Fctx &f = e.f;
    const int D = f.deg * NL;
    if (pt_is_zero(e, pt)) { cp(out, pt, 3 * f.deg); return; }
    const u64 *x = pt, *y = pt + D, *z = pt + 2 * D;
    u64 xx[MAXDEG * NL], yy[MAXDEG * NL], yyyy[MAXDEG * NL], zz[MAXDEG * NL];
    u64 s[MAXDEG * NL], m[MAXDEG * NL], t[MAXDEG * NL], u[MAXDEG * NL];
    fe_mul(f, xx, x, x);
    fe_mul(f, yy, y, y);
    fe_mul(f, yyyy, yy, yy);
    fe_mul(f, zz, z, z);
    // S = 2((X+YY)^2 - XX - YYYY)
    fe_add(f, s, x, yy);
    fe_mul(f, s, s, s);
    fe_sub(f, s, s, xx);
    fe_sub(f, s, s, yyyy);
    fe_dbl(f, s, s);
    // M = 3 XX + a ZZ^2
    fe_mul(f, m, zz, zz);
    fe_mul(f, m, m, e.a_coef);
    fe_add(f, t, xx, xx);
    fe_add(f, t, t, xx);
    fe_add(f, m, m, t);
    // T = M^2 - 2S
    fe_mul(f, t, m, m);
    fe_sub(f, t, t, s);
    fe_sub(f, t, t, s);
    // Y3 = M(S - T) - 8 YYYY ; Z3 = (Y+Z)^2 - YY - ZZ  (compute Z3 first:
    // out may alias pt)
    u64 z3[MAXDEG * NL];
    fe_add(f, z3, y, z);
    fe_mul(f, z3, z3, z3);
    fe_sub(f, z3, z3, yy);
    fe_sub(f, z3, z3, zz);
    fe_sub(f, u, s, t);
    fe_mul(f, u, m, u);
    fe_dbl(f, yyyy, yyyy);
    fe_dbl(f, yyyy, yyyy);
    fe_dbl(f, yyyy, yyyy);
    fe_sub(f, u, u, yyyy);
    cp(out, t, f.deg);
    cp(out + D, u, f.deg);
    cp(out + 2 * D, z3, f.deg);
}

void ec_add(const Ectx &e, u64 *out, const u64 *p1, const u64 *p2) {
    const Fctx &f = e.f;
    const int D = f.deg * NL;
    if (pt_is_zero(e, p1)) { cp(out, p2, 3 * f.deg); return; }
    if (pt_is_zero(e, p2)) { cp(out, p1, 3 * f.deg); return; }
    const u64 *x1 = p1, *y1 = p1 + D, *z1 = p1 + 2 * D;
    const u64 *x2 = p2, *y2 = p2 + D, *z2 = p2 + 2 * D;
    u64 z1z1[MAXDEG * NL], z2z2[MAXDEG * NL];
    u64 u1[MAXDEG * NL], u2[MAXDEG * NL], s1[MAXDEG * NL], s2[MAXDEG * NL];
    u64 t[MAXDEG * NL];
    // mixed-add fast path (Z2 == 1): u1 = x1, s1 = y1, no z2 powers --
    // saves 5 of the 12 general-case field muls (madd-2007-bl, the same
    // move as the reference's mixed_add, multiexp/curves.cu:148-197)
    const bool z2_one = fe_is_one(e, z2);
    fe_mul(f, z1z1, z1, z1);
    if (z2_one) {
        cp(u1, x1, f.deg);
        cp(s1, y1, f.deg);
    } else {
        fe_mul(f, z2z2, z2, z2);
        fe_mul(f, u1, x1, z2z2);
        fe_mul(f, t, z2, z2z2);
        fe_mul(f, s1, y1, t);
    }
    fe_mul(f, u2, x2, z1z1);
    fe_mul(f, t, z1, z1z1);
    fe_mul(f, s2, y2, t);
    if (std::memcmp(u1, u2, D * sizeof(u64)) == 0) {
        if (std::memcmp(s1, s2, D * sizeof(u64)) == 0) {
            ec_dbl(e, out, p1);
        } else {
            pt_set_zero(e, out);
        }
        return;
    }
    u64 h[MAXDEG * NL], i[MAXDEG * NL], j[MAXDEG * NL], r[MAXDEG * NL];
    u64 v[MAXDEG * NL], x3[MAXDEG * NL], y3[MAXDEG * NL], z3[MAXDEG * NL];
    fe_sub(f, h, u2, u1);
    fe_dbl(f, i, h);
    fe_mul(f, i, i, i);
    fe_mul(f, j, h, i);
    fe_sub(f, r, s2, s1);
    fe_dbl(f, r, r);
    fe_mul(f, v, u1, i);
    // X3 = r^2 - J - 2V
    fe_mul(f, x3, r, r);
    fe_sub(f, x3, x3, j);
    fe_sub(f, x3, x3, v);
    fe_sub(f, x3, x3, v);
    // Y3 = r(V - X3) - 2 S1 J
    fe_sub(f, y3, v, x3);
    fe_mul(f, y3, r, y3);
    fe_mul(f, t, s1, j);
    fe_dbl(f, t, t);
    fe_sub(f, y3, y3, t);
    // Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) * H  (= 2 Z1 H when Z2 == 1)
    if (z2_one) {
        fe_mul(f, z3, z1, h);
        fe_dbl(f, z3, z3);
    } else {
        fe_add(f, z3, z1, z2);
        fe_mul(f, z3, z3, z3);
        fe_sub(f, z3, z3, z1z1);
        fe_sub(f, z3, z3, z2z2);
        fe_mul(f, z3, z3, h);
    }
    cp(out, x3, f.deg);
    cp(out + D, y3, f.deg);
    cp(out + 2 * D, z3, f.deg);
}

// R mod p (the Montgomery one) by 768 modular doublings of 1
inline void compute_mont_one(const u64 *p, u64 *out) {
    std::memset(out, 0, NL * sizeof(u64));
    out[0] = 1;
    for (int i = 0; i < 768; ++i) {
        u64 carry = add_n(out, out, out);
        if (carry || geq(out, p)) sub_n(out, out, p);
    }
}

// c-bit window digit of a 12x64 little-endian scalar at bit offset `pos`
inline unsigned digit_at(const u64 *s, int pos, int c) {
    int word = pos >> 6, off = pos & 63;
    u64 lo = s[word] >> off;
    if (off + c > 64 && word + 1 < NL) lo |= s[word + 1] << (64 - off);
    return (unsigned)(lo & ((1ull << c) - 1));
}

}  // namespace

extern "C" {

// Pippenger bucket MSM (the BDLO12 method of multiexp.tcc:165-283):
// out (3*deg*12, Jacobian Montgomery) = sum_i scalars[i] * pts[i].
// pts: n * 3*deg*12 Jacobian Montgomery rows; scalars: n * 12 standard
// little-endian (< 2^753); c: window bits (1..20).
void g16_msm(u64 *out, const u64 *pts, const u64 *scalars, long long n,
             int c, int deg, const u64 *p, u64 inv, const u64 *alpha,
             const u64 *a_coef) {
    u64 mont_one[NL];
    compute_mont_one(p, mont_one);
    Ectx e{{p, inv, deg, alpha}, a_coef, mont_one};
    const int PSZ = 3 * deg * NL;
    const int nwin = (753 + c - 1) / c;
    const long long nbuck = (1ll << c) - 1;
    u64 *buckets = new u64[nbuck * PSZ];
    u64 *wsums = new u64[(long long)nwin * PSZ];
    u64 running[3 * MAXDEG * NL], wsum[3 * MAXDEG * NL];
    for (int w = 0; w < nwin; ++w) {
        std::memset(buckets, 0, nbuck * PSZ * sizeof(u64));
        for (long long i = 0; i < n; ++i) {
            unsigned d = digit_at(scalars + i * NL, w * c, c);
            if (d) {
                u64 *b = buckets + (long long)(d - 1) * PSZ;
                ec_add(e, b, b, pts + i * PSZ);
            }
        }
        // suffix-sum accumulation: sum_b (b+1) * bucket_b
        std::memset(running, 0, PSZ * sizeof(u64));
        std::memset(wsum, 0, PSZ * sizeof(u64));
        for (long long b = nbuck - 1; b >= 0; --b) {
            ec_add(e, running, running, buckets + b * PSZ);
            ec_add(e, wsum, wsum, running);
        }
        cp(wsums + (long long)w * PSZ, wsum, 3 * deg);
    }
    // Horner over windows: res = ((top * 2^c + ...) * 2^c + w0)
    u64 res[3 * MAXDEG * NL];
    cp(res, wsums + (long long)(nwin - 1) * PSZ, 3 * deg);
    for (int w = nwin - 2; w >= 0; --w) {
        for (int k = 0; k < c; ++k) ec_dbl(e, res, res);
        ec_add(e, res, res, wsums + (long long)w * PSZ);
    }
    cp(out, res, 3 * deg);
    delete[] wsums;
    delete[] buckets;
}

// Window-sum Horner epilogue for the device prover: wsums holds nwin
// HOMOGENEOUS-projective (X:Y:Z) Montgomery rows (the device MSM's
// per-window sums, zero encoded as Z == 0); computes
//   res = sum_w 2^(cbits*w) * W_w
// by top-down Horner (cbits doublings + one add per window — the same
// recombination the reference performs on the CPU after reading back
// per-stream results, cuda_prover_piecewise.cu:188-200) and writes a
// JACOBIAN Montgomery point.  Projective -> Jacobian via
// (X, Y, Z) -> (X*Z, Y*Z^2, Z): x/z^2 = X/Z and y/z^3 = Y/Z.
void g16_horner_proj(u64 *out, const u64 *wsums, int nwin, int cbits,
                     int deg, const u64 *p, u64 inv, const u64 *alpha,
                     const u64 *a_coef) {
    u64 mont_one[NL];
    compute_mont_one(p, mont_one);
    Ectx e{{p, inv, deg, alpha}, a_coef, mont_one};
    const int D = deg * NL, PSZ = 3 * D;
    u64 *jac = new u64[(long long)nwin * PSZ];
    u64 zz[MAXDEG * NL];
    for (int w = 0; w < nwin; ++w) {
        const u64 *X = wsums + (long long)w * PSZ;
        const u64 *Y = X + D, *Z = Y + D;
        u64 *o = jac + (long long)w * PSZ;
        if (blk_is_zero(Z, deg)) {
            std::memset(o, 0, PSZ * sizeof(u64));
        } else {
            fe_mul(e.f, o, X, Z);
            fe_mul(e.f, zz, Z, Z);
            fe_mul(e.f, o + D, Y, zz);
            cp(o + 2 * D, Z, deg);
        }
    }
    u64 res[3 * MAXDEG * NL];
    cp(res, jac + (long long)(nwin - 1) * PSZ, 3 * deg);
    for (int w = nwin - 2; w >= 0; --w) {
        for (int k = 0; k < cbits; ++k) ec_dbl(e, res, res);
        ec_add(e, res, res, jac + (long long)w * PSZ);
    }
    cp(out, res, 3 * deg);
    delete[] jac;
}

// Fixed-base windowed batch exponentiation (multiexp.tcc:547-680, the
// trusted-setup path): out[i] = scalars[i] * base, n Jacobian results.
void g16_fixed_base_batch(u64 *out, const u64 *base, const u64 *scalars,
                          long long n, int window, int deg, const u64 *p,
                          u64 inv, const u64 *alpha, const u64 *a_coef) {
    u64 mont_one[NL];
    compute_mont_one(p, mont_one);
    Ectx e{{p, inv, deg, alpha}, a_coef, mont_one};
    const int PSZ = 3 * deg * NL;
    const int outerc = (753 + window - 1) / window;
    const long long in_window = 1ll << window;
    u64 *table = new u64[(long long)outerc * in_window * PSZ];
    u64 g_outer[3 * MAXDEG * NL], g_inner[3 * MAXDEG * NL];
    cp(g_outer, base, 3 * deg);
    for (int w = 0; w < outerc; ++w) {
        u64 *row = table + (long long)w * in_window * PSZ;
        std::memset(g_inner, 0, PSZ * sizeof(u64));
        for (long long j = 0; j < in_window; ++j) {
            cp(row + j * PSZ, g_inner, 3 * deg);
            ec_add(e, g_inner, g_inner, g_outer);
        }
        for (int k = 0; k < window; ++k) ec_dbl(e, g_outer, g_outer);
    }
    u64 res[3 * MAXDEG * NL];
    for (long long i = 0; i < n; ++i) {
        const u64 *s = scalars + i * NL;
        std::memset(res, 0, PSZ * sizeof(u64));
        for (int w = 0; w < outerc; ++w) {
            unsigned d = digit_at(s, w * window, window);
            ec_add(e, res, res,
                   table + ((long long)w * in_window + d) * PSZ);
        }
        cp(out + i * PSZ, res, 3 * deg);
    }
    delete[] table;
}

// In-place radix-2 DIT NTT over the scalar field, Montgomery domain
// (the butterfly of basic_radix2_domain_aux.tcc:167-203).  a: n x 12
// Montgomery rows, n a power of two; omega/one in Montgomery form.
void g16_fft(u64 *a, long long n, const u64 *omega, const u64 *one,
             const u64 *p, u64 inv) {
    Fctx f{p, inv, 1, nullptr};
    int logn = 0;
    while ((1ll << logn) < n) ++logn;
    u64 tmp[NL];
    for (long long k = 0; k < n; ++k) {
        long long rk = 0;
        for (int b = 0; b < logn; ++b) rk |= ((k >> b) & 1) << (logn - 1 - b);
        if (k < rk) {
            cp(tmp, a + k * NL, 1);
            cp(a + k * NL, a + rk * NL, 1);
            cp(a + rk * NL, tmp, 1);
        }
    }
    u64 w_m[NL], w[NL], t[NL];
    for (long long m = 1; m < n; m <<= 1) {
        // w_m = omega^(n / 2m)
        cp(w_m, omega, 1);
        for (long long e2 = n / (2 * m); e2 > 1; e2 >>= 1)
            bf_mul(f, w_m, w_m, w_m);
        for (long long k = 0; k < n; k += 2 * m) {
            cp(w, one, 1);
            for (long long j = 0; j < m; ++j) {
                bf_mul(f, t, w, a + (k + j + m) * NL);
                bf_sub(f, a + (k + j + m) * NL, a + (k + j) * NL, t);
                bf_add(f, a + (k + j) * NL, a + (k + j) * NL, t);
                bf_mul(f, w, w, w_m);
            }
        }
    }
}

// Pointwise modular ops on (n, 12) rows (domain-agnostic add/sub).
void g16_vec_sub(u64 *out, const u64 *a, const u64 *b, long long n,
                 const u64 *p) {
    Fctx f{p, 0, 1, nullptr};
    for (long long i = 0; i < n; ++i)
        bf_sub(f, out + i * NL, a + i * NL, b + i * NL);
}

// Geometric scaling: a[i] *= g^i (Montgomery domain), the coset
// multiply of basic_radix2_domain.tcc:84-96.
void g16_coset_scale(u64 *a, long long n, const u64 *g, const u64 *p,
                     u64 inv) {
    Fctx f{p, inv, 1, nullptr};
    u64 u[NL];
    cp(u, g, 1);
    for (long long i = 1; i < n; ++i) {
        bf_mul(f, a + i * NL, a + i * NL, u);
        bf_mul(f, u, u, g);
    }
}

}  // extern "C"
