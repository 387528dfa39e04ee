"""Host-side exact evaluation domains (the oracle NTT).

Replaces the reference's vendored libfqfft evaluation-domain family
(depends/libfqfft/libfqfft/evaluation_domain/): basic_radix2_domain.tcc
(incl. the mixed 2^a*q^b sizes of fields with a small subgroup),
extended_radix2_domain.tcc, step_radix2_domain.tcc, and the
get_evaluation_domain.tcc:58-135 selection cascade.  The reference FFT is
mathematically the plain DFT in natural order:

    FFT(a)[i]  = sum_j a[j] * omega^(i*j)          (aux.tcc:168-202)
    iFFT(a)    = FFT with omega^-1, scaled by 1/n  (basic_radix2_domain.tcc:71-82)
    cosetFFT   = scale a[j] by g^j, then FFT       (:84-89)
    icosetFFT  = iFFT, then scale by g^-j          (:91-96)

Since field arithmetic is exact, any algorithm computing the same function
is bit-identical; this module is the spec the device NTT (ops/ntt.py) is
tested against.  (The Groth16 pipeline itself always sizes d+1 = 2^k,
generate_parameters.cpp:35-36 — the non-basic domains exist for full
evaluation-domain parity.)

The domain root comes from libff::get_root_of_unity including the
small-subgroup derivation for MNT6753 Fr (field_utils.tcc:40-89), see
curves/constants.get_root_of_unity.
"""

from typing import List

from ..curves.constants import FieldParams, get_root_of_unity
from ..utils import native


def _ceil_log2(n: int) -> int:
    """libff::log2 (rounds up): smallest k with 2^k >= n."""
    return (n - 1).bit_length() if n > 1 else 0


def _dft_any(a: List[int], omega: int, p: int) -> List[int]:
    """Exact DFT for any composite length by recursive Cooley-Tukey.

    Used for the 2^a*q^b mixed-radix sizes of small-subgroup fields
    (aux.tcc _basic_serial_mixed_radix_FFT:44-132 computes the same
    function; exact arithmetic makes any algorithm bit-identical).
    """
    n = len(a)
    if n == 1:
        return list(a)
    q = next((f for f in (2, 3, 5, 7, 11, 13) if n % f == 0), n)
    if q == n:  # prime length: naive O(n^2)
        return [sum(a[j] * pow(omega, i * j % n, p) for j in range(n)) % p
                for i in range(n)]
    m = n // q
    omq = pow(omega, q, p)
    subs = [_dft_any(a[i::q], omq, p) for i in range(q)]
    wq = [pow(omega, m * i % n, p) for i in range(q)]  # q-th roots of unity
    out = [0] * n
    wk = 1                                             # omega^k0
    for k0 in range(m):
        wi = [1] * q                                   # omega^(i*k0)
        for i in range(1, q):
            wi[i] = wi[i - 1] * wk % p
        terms = [wi[i] * subs[i][k0] % p for i in range(q)]
        for t in range(q):
            s = 0
            for i in range(q):
                s += wq[i * t % q] * terms[i]
            out[k0 + t * m] = s % p
        wk = wk * omega % p
    return out


class Radix2Domain:
    """Domain of size m = 2^k — or 2^a * q^b for small-subgroup fields
    (basic_radix2_domain equivalent, basic_radix2_domain.tcc:26-60)."""

    def __init__(self, fp: FieldParams, m: int):
        if m < 2:
            raise ValueError("domain size must be >= 2")
        if m & (m - 1) and fp.small_subgroup_base is None:
            raise ValueError("domain size must be a power of two >= 2")
        self.fp = fp
        self.p = fp.p
        self.m = m
        # raises ValueError unless m = 2^a (* q^b when defined), a <= s
        self.omega = get_root_of_unity(fp, m)
        self.g = fp.multiplicative_generator

    # -- core FFT -------------------------------------------------------------

    def _fft(self, a: List[int], omega: int) -> List[int]:
        """In-place iterative radix-2 DIT (same maths as aux.tcc:168-202)."""
        p = self.p
        n = len(a)
        if n & (n - 1):
            return _dft_any([x % p for x in a], omega, p)
        if n >= 64:
            # native butterfly loops (csrc/limb_host.cpp g16_fft) for
            # reference-scale (2^16+) oracle runs
            res = native.fft_ints(a, omega, p)
            if res is not None:
                return res
        logn = n.bit_length() - 1
        # bit-reverse permutation
        for k in range(n):
            rk = int(bin(k)[2:].zfill(logn)[::-1], 2)
            if k < rk:
                a[k], a[rk] = a[rk], a[k]
        m = 1
        for _ in range(logn):
            w_m = pow(omega, n // (2 * m), p)
            for k in range(0, n, 2 * m):
                w = 1
                for j in range(m):
                    t = w * a[k + j + m] % p
                    a[k + j + m] = (a[k + j] - t) % p
                    a[k + j] = (a[k + j] + t) % p
                    w = w * w_m % p
            m *= 2
        return a

    def fft(self, a: List[int]) -> List[int]:
        assert len(a) == self.m
        return self._fft([x % self.p for x in a], self.omega)

    def ifft(self, a: List[int]) -> List[int]:
        assert len(a) == self.m
        p = self.p
        out = self._fft([x % p for x in a], pow(self.omega, -1, p))
        n_inv = pow(self.m, -1, p)
        return [x * n_inv % p for x in out]

    # -- coset ops (basic_radix2_domain.tcc:84-134) ----------------------------

    def _multiply_by_coset(self, a: List[int], g: int) -> List[int]:
        p = self.p
        u = g
        out = list(a)
        for i in range(1, len(out)):
            out[i] = out[i] * u % p
            u = u * g % p
        return out

    def coset_fft(self, a: List[int]) -> List[int]:
        return self.fft(self._multiply_by_coset(a, self.g))

    def icoset_fft(self, a: List[int]) -> List[int]:
        return self._multiply_by_coset(self.ifft(a), pow(self.g, -1, self.p))

    def compute_vanishing_polynomial(self, t: int) -> int:
        return (pow(t, self.m, self.p) - 1) % self.p

    def divide_by_z_on_coset(self, a: List[int]) -> List[int]:
        zinv = pow(self.compute_vanishing_polynomial(self.g), -1, self.p)
        return [x * zinv % self.p for x in a]

    def evaluate_all_lagrange_polynomials(self, t: int) -> List[int]:
        """_basic_radix2_evaluate_all_lagrange_polynomials (aux.tcc:333-388)."""
        p, m = self.p, self.m
        t = t % p
        u = [0] * m
        if pow(t, m, p) == 1:
            omega_i = 1
            for i in range(m):
                if omega_i == t:
                    u[i] = 1
                    return u
                omega_i = omega_i * self.omega % p
        z = (pow(t, m, p) - 1) % p
        l = z * pow(m, -1, p) % p
        r = 1
        for i in range(m):
            u[i] = l * pow((t - r) % p, -1, p) % p
            l = l * self.omega % p
            r = r * self.omega % p
        return u

    def get_domain_element(self, idx: int) -> int:
        return pow(self.omega, idx, self.p)

    def add_poly_Z(self, coeff: int, H: List[int]) -> None:
        """H += coeff * Z(x) with Z = x^m - 1 (basic_radix2_domain.tcc)."""
        assert len(H) == self.m + 1
        H[self.m] = (H[self.m] + coeff) % self.p
        H[0] = (H[0] - coeff) % self.p


class ExtendedRadix2Domain:
    """Domain of size m = 2^(s+1): the 2^s roots of unity union the coset
    shifted by g^2 (extended_radix2_domain.tcc; shift from libff
    coset_shift(), field_utils.tcc)."""

    def __init__(self, fp: FieldParams, m: int):
        if m <= 1 or _ceil_log2(m) != fp.s + 1:
            raise ValueError("extended_radix2: need log2(m) == s + 1")
        self.fp = fp
        self.p = fp.p
        self.m = m
        self.small_m = m // 2
        self.omega = get_root_of_unity(fp, self.small_m)  # raises if bad m
        self.shift = (fp.multiplicative_generator ** 2) % fp.p
        self.g = fp.multiplicative_generator
        self._basic = Radix2Domain(fp, self.small_m)

    def fft(self, a: List[int]) -> List[int]:
        assert len(a) == self.m
        p, sm = self.p, self.small_m
        shift_sm = pow(self.shift, sm, p)
        a0, a1 = [0] * sm, [0] * sm
        shift_i = 1
        for i in range(sm):
            a0[i] = (a[i] + a[sm + i]) % p
            a1[i] = shift_i * (a[i] + shift_sm * a[sm + i]) % p
            shift_i = shift_i * self.shift % p
        a0 = self._basic._fft(a0, self.omega)
        a1 = self._basic._fft(a1, self.omega)
        return a0 + a1

    def ifft(self, a: List[int]) -> List[int]:
        assert len(a) == self.m
        p, sm = self.p, self.small_m
        om_inv = pow(self.omega, -1, p)
        a0 = self._basic._fft([x % p for x in a[:sm]], om_inv)
        a1 = self._basic._fft([x % p for x in a[sm:]], om_inv)
        shift_sm = pow(self.shift, sm, p)
        sconst = pow(sm * (1 - shift_sm) % p, -1, p)
        shift_inv = pow(self.shift, -1, p)
        shift_inv_i = 1
        out = [0] * self.m
        for i in range(sm):
            out[i] = sconst * (-shift_sm * a0[i] + shift_inv_i * a1[i]) % p
            out[i + sm] = sconst * (a0[i] - shift_inv_i * a1[i]) % p
            shift_inv_i = shift_inv_i * shift_inv % p
        return out

    def _multiply_by_coset(self, a: List[int], g: int) -> List[int]:
        p = self.p
        u = g
        out = list(a)
        for i in range(1, len(out)):
            out[i] = out[i] * u % p
            u = u * g % p
        return out

    def coset_fft(self, a: List[int]) -> List[int]:
        return self.fft(self._multiply_by_coset(a, self.g))

    def icoset_fft(self, a: List[int]) -> List[int]:
        return self._multiply_by_coset(self.ifft(a), pow(self.g, -1, self.p))

    def get_domain_element(self, idx: int) -> int:
        p, sm = self.p, self.small_m
        if idx < sm:
            return pow(self.omega, idx, p)
        return self.shift * pow(self.omega, idx - sm, p) % p

    def compute_vanishing_polynomial(self, t: int) -> int:
        p, sm = self.p, self.small_m
        tsm = pow(t, sm, p)
        return (tsm - 1) * (tsm - pow(self.shift, sm, p)) % p

    def add_poly_Z(self, coeff: int, H: List[int]) -> None:
        assert len(H) == self.m + 1
        p, sm = self.p, self.small_m
        shift_sm = pow(self.shift, sm, p)
        H[self.m] = (H[self.m] + coeff) % p
        H[sm] = (H[sm] - coeff * (shift_sm + 1)) % p
        H[0] = (H[0] + coeff * shift_sm) % p

    def divide_by_z_on_coset(self, a: List[int]) -> List[int]:
        p, sm = self.p, self.small_m
        coset_sm = pow(self.g, sm, p)
        shift_sm = pow(self.shift, sm, p)
        z0i = pow((coset_sm - 1) * (coset_sm - shift_sm) % p, -1, p)
        z1i = pow((coset_sm * shift_sm - 1)
                  * (coset_sm * shift_sm - shift_sm) % p, -1, p)
        return ([x * z0i % p for x in a[:sm]]
                + [x * z1i % p for x in a[sm:]])

    def evaluate_all_lagrange_polynomials(self, t: int) -> List[int]:
        p, sm = self.p, self.small_m
        t = t % p
        T0 = self._basic.evaluate_all_lagrange_polynomials(t)
        T1 = self._basic.evaluate_all_lagrange_polynomials(
            t * pow(self.shift, -1, p) % p)
        t_sm = pow(t, sm, p)
        shift_sm = pow(self.shift, sm, p)
        one_over_denom = pow((shift_sm - 1) % p, -1, p)
        c0 = (t_sm - shift_sm) * (-one_over_denom) % p
        c1 = (t_sm - 1) * one_over_denom % p
        return ([x * c0 % p for x in T0] + [x * c1 % p for x in T1])


class StepRadix2Domain:
    """Domain of size m = 2^k + 2^r: the 2^k-th roots of unity union a
    coset of the 2^r-th roots (step_radix2_domain.tcc)."""

    def __init__(self, fp: FieldParams, m: int):
        if m <= 1:
            raise ValueError("step_radix2: need m > 1")
        self.fp = fp
        self.p = fp.p
        self.m = m
        self.big_m = 1 << (_ceil_log2(m) - 1)
        self.small_m = m - self.big_m
        if self.small_m & (self.small_m - 1):
            raise ValueError("step_radix2: m - 2^(log2(m)-1) must be a "
                             "power of two")
        self.omega = get_root_of_unity(fp, 1 << _ceil_log2(m))
        self.big_omega = self.omega * self.omega % fp.p
        self.small_omega = get_root_of_unity(fp, self.small_m) \
            if self.small_m > 1 else 1
        self.g = fp.multiplicative_generator
        self._big = Radix2Domain(fp, self.big_m)
        self._small = (Radix2Domain(fp, self.small_m)
                       if self.small_m > 1 else None)

    def _small_fft(self, a: List[int], inverse: bool) -> List[int]:
        if self._small is None:
            return list(a)
        om = self.small_omega if not inverse else pow(
            self.small_omega, -1, self.p)
        return self._small._fft([x % self.p for x in a], om)

    def fft(self, a: List[int]) -> List[int]:
        assert len(a) == self.m
        p, bm, sm = self.p, self.big_m, self.small_m
        c = [0] * bm
        d = [0] * bm
        omega_i = 1
        for i in range(bm):
            c[i] = (a[i] + a[i + bm]) % p if i < sm else a[i] % p
            d[i] = omega_i * ((a[i] - a[i + bm]) % p if i < sm
                              else a[i]) % p
            omega_i = omega_i * self.omega % p
        e = [0] * sm
        compr = bm // sm
        for i in range(sm):
            for j in range(compr):
                e[i] = (e[i] + d[i + j * sm]) % p
        c = self._big._fft(c, self.big_omega)
        e = self._small_fft(e, inverse=False)
        return c + e

    def ifft(self, a: List[int]) -> List[int]:
        assert len(a) == self.m
        p, bm, sm = self.p, self.big_m, self.small_m
        U0 = self._big._fft([x % p for x in a[:bm]],
                            pow(self.big_omega, -1, p))
        U1 = self._small_fft(a[bm:], inverse=True)
        u0i = pow(bm, -1, p)
        U0 = [x * u0i % p for x in U0]
        u1i = pow(sm, -1, p)
        U1 = [x * u1i % p for x in U1]
        tmp = list(U0)
        omega_i = 1
        for i in range(bm):
            tmp[i] = tmp[i] * omega_i % p
            omega_i = omega_i * self.omega % p
        out = [0] * self.m
        for i in range(sm, bm):
            out[i] = U0[i]
        compr = bm // sm
        for i in range(sm):
            for j in range(1, compr):
                U1[i] = (U1[i] - tmp[i + j * sm]) % p
        om_inv = pow(self.omega, -1, p)
        om_inv_i = 1
        for i in range(sm):
            U1[i] = U1[i] * om_inv_i % p
            om_inv_i = om_inv_i * om_inv % p
        over_two = pow(2, -1, p)
        for i in range(sm):
            out[i] = (U0[i] + U1[i]) * over_two % p
            out[bm + i] = (U0[i] - U1[i]) * over_two % p
        return out

    def _multiply_by_coset(self, a: List[int], g: int) -> List[int]:
        p = self.p
        u = g
        out = list(a)
        for i in range(1, len(out)):
            out[i] = out[i] * u % p
            u = u * g % p
        return out

    def coset_fft(self, a: List[int]) -> List[int]:
        return self.fft(self._multiply_by_coset(a, self.g))

    def icoset_fft(self, a: List[int]) -> List[int]:
        return self._multiply_by_coset(self.ifft(a), pow(self.g, -1, self.p))

    def get_domain_element(self, idx: int) -> int:
        p = self.p
        if idx < self.big_m:
            return pow(self.big_omega, idx, p)
        return self.omega * pow(self.small_omega, idx - self.big_m, p) % p

    def compute_vanishing_polynomial(self, t: int) -> int:
        p = self.p
        return (pow(t, self.big_m, p) - 1) \
            * (pow(t, self.small_m, p)
               - pow(self.omega, self.small_m, p)) % p

    def add_poly_Z(self, coeff: int, H: List[int]) -> None:
        assert len(H) == self.m + 1
        p = self.p
        om_sm = pow(self.omega, self.small_m, p)
        H[self.m] = (H[self.m] + coeff) % p
        H[self.big_m] = (H[self.big_m] - coeff * om_sm) % p
        H[self.small_m] = (H[self.small_m] - coeff) % p
        H[0] = (H[0] + coeff * om_sm) % p

    def divide_by_z_on_coset(self, a: List[int]) -> List[int]:
        p, bm, sm = self.p, self.big_m, self.small_m
        coset = self.g
        Z0 = (pow(coset, bm, p) - 1) % p
        c_sm_Z0 = pow(coset, sm, p) * Z0 % p
        o_sm_Z0 = pow(self.omega, sm, p) * Z0 % p
        om_2sm = pow(self.omega, 2 * sm, p)
        out = list(a)
        elt = 1
        for i in range(bm):
            out[i] = out[i] * pow((c_sm_Z0 * elt - o_sm_Z0) % p, -1, p) % p
            elt = elt * om_2sm % p
        cw = coset * self.omega % p
        Z1 = (pow(cw, bm, p) - 1) \
            * ((pow(cw, sm, p) - pow(self.omega, sm, p)) % p) % p
        z1i = pow(Z1, -1, p)
        for i in range(sm):
            out[bm + i] = out[bm + i] * z1i % p
        return out

    def evaluate_all_lagrange_polynomials(self, t: int) -> List[int]:
        p, bm, sm = self.p, self.big_m, self.small_m
        t = t % p
        inner_big = self._big.evaluate_all_lagrange_polynomials(t)
        if self._small is not None:
            inner_small = self._small.evaluate_all_lagrange_polynomials(
                t * pow(self.omega, -1, p) % p)
        else:
            inner_small = [1]
        out = [0] * self.m
        L0 = (pow(t, sm, p) - pow(self.omega, sm, p)) % p
        om_sm = pow(self.omega, sm, p)
        bo_sm = pow(self.big_omega, sm, p)
        elt = 1
        for i in range(bm):
            out[i] = inner_big[i] * L0 \
                * pow((elt - om_sm) % p, -1, p) % p
            elt = elt * bo_sm % p
        L1 = (pow(t, bm, p) - 1) \
            * pow((pow(self.omega, bm, p) - 1) % p, -1, p) % p
        for i in range(sm):
            out[bm + i] = L1 * inner_small[i] % p
        return out


class _SequenceDomain:
    """Shared evaluation/interpolation core for the non-root-of-unity
    domains (geometric_sequence_domain.tcc, arithmetic_sequence_domain.tcc).

    The reference computes these with Newton-basis transforms + subproduct
    trees; with exact field arithmetic the FFT is *defined* as evaluation
    of the coefficient vector at the domain points (the reference's own
    gtest checks its FFT against naive Lagrange evaluation), so direct
    O(m^2) evaluation/interpolation computes the identical function.
    These domains are unreachable from the Groth16 pipeline (d+1 is
    always 2^k) and exist for full evaluation-domain parity; they are
    used at test sizes only.
    """

    def __init__(self, fp: FieldParams, m: int, points: List[int]):
        self.fp = fp
        self.p = fp.p
        self.m = m
        self.points = points
        self.g = fp.multiplicative_generator

    def fft(self, a: List[int]) -> List[int]:
        """Evaluate the polynomial with coefficients a at every point."""
        assert len(a) == self.m
        p = self.p
        out = []
        for x in self.points:
            acc = 0
            for c in reversed(a):
                acc = (acc * x + c) % p
            out.append(acc)
        return out

    def ifft(self, a: List[int]) -> List[int]:
        """Interpolate values a at the points -> coefficients (exact
        Lagrange; O(m^2))."""
        assert len(a) == self.m
        p, m = self.p, self.m
        # full product N(x) = prod (x - x_i), coefficient form
        N = [1]
        for x in self.points:
            N = [(lo - x * hi) % p
                 for lo, hi in zip([0] + N, N + [0])]
        out = [0] * m
        for i, xi in enumerate(self.points):
            # q = N / (x - xi) by synthetic division (degree m-1)
            q = [0] * m
            acc = 0
            for k in range(m, 0, -1):
                acc = (N[k] + acc * xi) % p
                q[k - 1] = acc
            denom = 1
            for j, xj in enumerate(self.points):
                if j != i:
                    denom = denom * (xi - xj) % p
            scale = a[i] % p * pow(denom, -1, p) % p
            for k in range(m):
                out[k] = (out[k] + scale * q[k]) % p
        return out

    def _multiply_by_coset(self, a: List[int], g: int) -> List[int]:
        p = self.p
        u = g
        out = [x % p for x in a]
        for i in range(1, len(out)):
            out[i] = out[i] * u % p
            u = u * g % p
        return out

    def coset_fft(self, a: List[int]) -> List[int]:
        return self.fft(self._multiply_by_coset(a, self.g))

    def icoset_fft(self, a: List[int]) -> List[int]:
        return self._multiply_by_coset(self.ifft(a), pow(self.g, -1, self.p))

    def compute_vanishing_polynomial(self, t: int) -> int:
        p = self.p
        z = 1
        for x in self.points:
            z = z * ((t - x) % p) % p
        return z

    def evaluate_all_lagrange_polynomials(self, t: int) -> List[int]:
        p, m = self.p, self.m
        t = t % p
        for i, x in enumerate(self.points):
            if x == t:
                out = [0] * m
                out[i] = 1
                return out
        out = []
        for i, xi in enumerate(self.points):
            num, den = 1, 1
            for j, xj in enumerate(self.points):
                if j != i:
                    num = num * ((t - xj) % p) % p
                    den = den * ((xi - xj) % p) % p
            out.append(num * pow(den, -1, p) % p)
        return out

    def get_domain_element(self, idx: int) -> int:
        return self.points[idx]

    def add_poly_Z(self, coeff: int, H: List[int]) -> None:
        """H += coeff * Z(x), Z = prod (x - x_i) (degree m).  (The
        reference's loop for these domains indexes sequence[m] past its
        own precomputed table — never exercised; this is the in-bounds
        degree-m product consistent with the radix-2 domains.)"""
        assert len(H) == self.m + 1
        p = self.p
        N = [1]
        for x in self.points:
            N = [(lo - x * hi) % p for lo, hi in zip([0] + N, N + [0])]
        for k in range(self.m + 1):
            H[k] = (H[k] + coeff * N[k]) % p


class GeometricSequenceDomain(_SequenceDomain):
    """Points x_i = r^i with r = geometric_generator = 2
    (geometric_sequence_domain.tcc:260-275; fp.tcc:292-298)."""

    GENERATOR = 2

    def __init__(self, fp: FieldParams, m: int):
        if m <= 1:
            raise ValueError("geometric domain needs m > 1")
        pts, x = [], 1
        for _ in range(m):
            pts.append(x)
            x = x * self.GENERATOR % fp.p
        super().__init__(fp, m, pts)

    def divide_by_z_on_coset(self, a: List[int]) -> List[int]:
        # mirrors the reference: one global scale by Z(multiplicative
        # generator)^-1 (geometric_sequence_domain.tcc:249-257)
        zinv = pow(self.compute_vanishing_polynomial(self.g), -1, self.p)
        return [x * zinv % self.p for x in a]


class ArithmeticSequenceDomain(_SequenceDomain):
    """Points x_i = i * arithmetic_generator with generator = 1
    (arithmetic_sequence_domain.tcc:238-252; fp.tcc:301-307)."""

    GENERATOR = 1

    def __init__(self, fp: FieldParams, m: int):
        if m <= 1:
            raise ValueError("arithmetic domain needs m > 1")
        super().__init__(fp, m,
                         [i * self.GENERATOR % fp.p for i in range(m)])

    def divide_by_z_on_coset(self, a: List[int]) -> List[int]:
        # mirrors the reference (arithmetic_sequence_domain.tcc:228-236):
        # coset = arithmetic_generator, where Z vanishes (x_1 == 1), so
        # this raises just as the reference's .inverse() would abort
        zinv = pow(self.compute_vanishing_polynomial(self.GENERATOR),
                   -1, self.p)
        return [x * zinv % self.p for x in a]


def best_mixed_domain_size(fp: FieldParams, min_size: int) -> int:
    """min { n = 2^a * q^b >= min_size, b <= power, a <= s }
    (get_evaluation_domain.tcc:34-57)."""
    best = None
    for b in range(fp.small_subgroup_power + 1):
        r = fp.small_subgroup_base ** b
        two_adicity = 0
        while r < min_size:
            r *= 2
            two_adicity += 1
        if two_adicity <= fp.s and (best is None or r < best):
            best = r
    if best is None:
        raise ValueError("no mixed domain size fits")
    return best


def get_evaluation_domain(fp: FieldParams, min_size: int):
    """Domain selection cascade (get_evaluation_domain.tcc:58-135):
    basic -> extended -> step at min_size, then at big + rounded_small,
    then the best mixed 2^a*q^b basic domain for small-subgroup fields,
    then the geometric / arithmetic sequence fallbacks.  (For the MNT
    fields the radix-2 family covers every size the pipeline produces;
    the sequence domains are reachable only for min_size > 2^s.)
    """
    big = 1 << (_ceil_log2(min_size) - 1)
    small = min_size - big
    rounded_small = (1 << _ceil_log2(small)) if small > 0 else 0
    for cls, size in ((Radix2Domain, min_size),
                      (ExtendedRadix2Domain, min_size),
                      (StepRadix2Domain, min_size),
                      (Radix2Domain, big + rounded_small),
                      (ExtendedRadix2Domain, big + rounded_small),
                      (StepRadix2Domain, big + rounded_small)):
        try:
            return cls(fp, size)
        except ValueError:
            continue
    if fp.small_subgroup_base is not None:
        try:
            return Radix2Domain(fp, best_mixed_domain_size(fp, min_size))
        except ValueError:
            pass
    for cls in (GeometricSequenceDomain, ArithmeticSequenceDomain):
        try:
            return cls(fp, min_size)
        except ValueError:
            continue
    raise ValueError(
        f"get_evaluation_domain: no matching domain for size {min_size}")
