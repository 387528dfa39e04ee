"""Host-side Groth16: trusted setup, oracle prover, verification.

The three roles mirror the reference:
  - `setup`     ~ r1cs_gg_ppzksnark_generator (r1cs_gg_ppzksnark.tcc:206-379)
                  restricted to what the challenge pipeline consumes
                  (A/B1/B2/L/H queries; vk kept as trapdoor scalars)
  - `compute_h` ~ the iFFT/cosetFFT witness-map pipeline that both provers
                  inline (libsnark/main.cpp:89-148,
                  cuda_prover_piecewise.cu:14-49; semantics from
                  r1cs_to_qap_witness_map with d1=d2=d3=0)
  - `prove`     ~ the challenge CPU prover (libsnark/main.cpp:172-233):
                  5 MSMs and C = Ht + Lt + r*Bt1 (NO s-randomness,
                  main.cpp:219)
  - `verify_with_trapdoor` replaces the pairing check with the equivalent
    exponent-space equation, using the setup trapdoor (t, alpha, beta,
    delta, generator dlogs) kept from setup.  Bit-exactness of the pipeline
    is separately enforced by sha256 golden-file tests.
"""

import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..curves.constants import CurveParams
from . import ec
from .fft import Radix2Domain, get_evaluation_domain
from .msm import fixed_base_msm, get_exp_window_size, msm
from .r1cs import R1CS, evaluate_lc, generate_r1cs_example_with_field_input


@dataclass
class Trapdoor:
    """Setup toxic waste, retained for verification in tests."""
    t: int
    alpha: int
    beta: int
    delta: int
    g1_dlog: int   # g1 generator = g1_dlog * G1::one  (generator is random,
                   # r1cs_gg_ppzksnark.tcc:290)
    at: List[int]  # QAP evaluations A_i(t), post AB-swap
    bt: List[int]
    ct: List[int]
    zt: int
    gamma: int = 0  # 0 = setup predates the vk path; derive_keys draws it in


@dataclass
class VerifyingKey:
    """Public verification key (r1cs_gg_ppzksnark.tcc:346-377 analog).

    alpha_g1/beta_g2 are kept as group elements (the pairing
    e(alpha_g1, beta_g2) is computed at verify time rather than cached
    as a GT value, since no reference file format carries GT).
    """
    alpha_g1: tuple        # affine G1
    beta_g2: tuple         # affine G2
    gamma_g2: tuple        # affine G2
    delta_g2: tuple        # affine G2
    gamma_abc_g1: list     # affine G1, len num_inputs + 1


@dataclass
class ProvingKeyExtras:
    """The alpha/beta/delta group elements the FULL prover adds on top of
    the challenge query tables (r1cs_gg_ppzksnark.tcc:381-496)."""
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    delta_g1: tuple
    delta_g2: tuple


@dataclass
class SetupResult:
    d: int
    m: int
    A: list        # affine G1, len m+1
    B1: list       # affine G1, len m+1
    B2: list       # affine G2, len m+1
    L: list        # affine G1, len m-1
    H: list        # affine G1, len d
    w: List[int]   # m+1 scalars incl. leading 1
    ca: List[int]  # d+1
    cb: List[int]
    cc: List[int]
    r: int
    trapdoor: Trapdoor


def qap_instance_evaluation(cs: R1CS, domain: Radix2Domain, t: int
                            ) -> Tuple[List[int], List[int], List[int], int]:
    """r1cs_to_qap_instance_map_with_evaluation (r1cs_to_qap.tcc:104-174).

    Returns (At, Bt, Ct, Zt); Ht is implicitly [t^i].
    """
    p = cs.p
    nvar = cs.num_variables
    at = [0] * (nvar + 1)
    bt = [0] * (nvar + 1)
    ct = [0] * (nvar + 1)
    u = domain.evaluate_all_lagrange_polynomials(t)
    # input-consistency rows: At[i] = u[num_constraints + i]
    for i in range(cs.num_inputs + 1):
        at[i] = u[cs.num_constraints + i]
    for i, cons in enumerate(cs.constraints):
        for idx, coeff in cons.a:
            at[idx] = (at[idx] + u[i] * coeff) % p
        for idx, coeff in cons.b:
            bt[idx] = (bt[idx] + u[i] * coeff) % p
        for idx, coeff in cons.c:
            ct[idx] = (ct[idx] + u[i] * coeff) % p
    zt = domain.compute_vanishing_polynomial(t)
    return at, bt, ct, zt


def setup(curve: CurveParams, log2_d: int,
          rng: Optional[random.Random] = None) -> SetupResult:
    """generate_paramaters<ppT> (libsnark/generate_parameters.cpp:23-123).

    Builds the synthetic R1CS, runs the Groth16 generator, and assembles
    exactly the data the params/input files carry.
    """
    rng = rng or random.Random()
    r_mod = curve.fr.p
    d_plus_1 = 1 << log2_d
    d = d_plus_1 - 1

    cs, primary, auxiliary = generate_r1cs_example_with_field_input(
        r_mod, d - 1, 1, rng)
    full_assignment = primary + auxiliary
    m = cs.num_variables
    assert m == d + 1

    # ---- generator (r1cs_gg_ppzksnark.tcc:206-379) ----
    cs.swap_ab_if_beneficial()  # :213
    t = rng.randrange(1, r_mod)
    alpha = rng.randrange(1, r_mod)
    beta = rng.randrange(1, r_mod)
    delta = rng.randrange(1, r_mod)
    delta_inv = pow(delta, -1, r_mod)

    # the selection cascade (get_evaluation_domain.tcc) resolves to the
    # basic radix-2 domain for every size this pipeline produces (d+1 is
    # always 2^k, generate_parameters.cpp:35-36)
    domain = get_evaluation_domain(
        curve.fr, cs.num_constraints + cs.num_inputs + 1)
    assert domain.m == d_plus_1
    at, bt, ct, zt = qap_instance_evaluation(cs, domain, t)

    # L query scalars: ((beta*At + alpha*Bt + Ct) * delta^-1) for aux vars
    lt = [
        (beta * at[i] + alpha * bt[i] + ct[i]) * delta_inv % r_mod
        for i in range(cs.num_inputs + 1, m + 1)
    ]
    # H query scalars: t^i * Zt * delta^-1, i = 0..d-1 (Ht resized by 2,
    # r1cs_gg_ppzksnark.tcc:281; qap degree = d+1 so len = d)
    zt_dinv = zt * delta_inv % r_mod
    ht = []
    ti = 1
    for _ in range(d):
        ht.append(ti * zt_dinv % r_mod)
        ti = ti * t % r_mod

    # fixed-base exponentiations (the reference uses a random g1 generator,
    # G2::one for the g-side of B; :290,300)
    g1 = ec.g1_group(curve)
    g2 = ec.g2_group(curve)
    g1_dlog = rng.randrange(1, r_mod)
    g1_gen = g1.mul(g1_dlog, ec.g1_generator(curve))
    g2_gen = ec.g2_generator(curve)

    w1 = get_exp_window_size(3 * (m + 1))
    w2 = get_exp_window_size(m + 1)
    # one table build serves all four G1 query vectors
    g1_scalars = at + bt + lt + ht
    g1_pts = fixed_base_msm(g1, g1_gen, g1_scalars, w1)
    na, nb = len(at), len(bt)
    nl = len(lt)
    A_q = g1_pts[:na]
    B1_q = g1_pts[na:na + nb]
    L_q = g1_pts[na + nb:na + nb + nl]
    H_q = g1_pts[na + nb + nl:]
    B2_q = fixed_base_msm(g2, g2_gen, bt, w2)

    A_aff = g1.batch_to_affine(A_q)
    B1_aff = g1.batch_to_affine(B1_q)
    B2_aff = [g2.to_affine(pt) for pt in B2_q]
    L_aff = g1.batch_to_affine(L_q)
    H_aff = g1.batch_to_affine(H_q)

    # ---- input-side data (generate_parameters.cpp:41-57, 88-107) ----
    w = [1] + [x % r_mod for x in full_assignment]
    ca = [0] * d_plus_1
    cb = [0] * d_plus_1
    cc = [0] * d_plus_1
    for i in range(cs.num_inputs + 1):
        ca[i + cs.num_constraints] = (
            1 if i == 0 else full_assignment[i - 1] % r_mod)
    for i, cons in enumerate(cs.constraints):
        ca[i] = (ca[i] + evaluate_lc(cons.a, full_assignment, r_mod)) % r_mod
        cb[i] = (cb[i] + evaluate_lc(cons.b, full_assignment, r_mod)) % r_mod
        cc[i] = (cc[i] + evaluate_lc(cons.c, full_assignment, r_mod)) % r_mod
    r = rng.randrange(r_mod)
    # drawn LAST so the params/input byte streams match pre-vk setups
    gamma = rng.randrange(1, r_mod)

    return SetupResult(
        d=d, m=m, A=A_aff, B1=B1_aff, B2=B2_aff, L=L_aff, H=H_aff,
        w=w, ca=ca, cb=cb, cc=cc, r=r,
        trapdoor=Trapdoor(t, alpha, beta, delta, g1_dlog, at, bt, ct, zt,
                          gamma),
    )


def compute_h(curve: CurveParams, d: int, ca: List[int], cb: List[int],
              cc: List[int]) -> List[int]:
    """The H-polynomial pipeline (libsnark/main.cpp:89-148).

    iFFT(ca), iFFT(cb) -> cosetFFT both -> pointwise mul -> iFFT/cosetFFT(cc)
    -> subtract -> divide by Z on coset -> icosetFFT.  Returns d+2
    coefficients (domain->m + 1) of which the prover uses the first d.
    """
    dom = get_evaluation_domain(curve.fr, d + 1)
    a = dom.coset_fft(dom.ifft(list(ca)))
    b = dom.coset_fft(dom.ifft(list(cb)))
    p = curve.fr.p
    h = [x * y % p for x, y in zip(a, b)]
    c = dom.coset_fft(dom.ifft(list(cc)))
    h = [(x - y) % p for x, y in zip(h, c)]
    h = dom.divide_by_z_on_coset(h)
    h = dom.icoset_fft(h)
    return h + [0]  # coefficients_for_H has m+1 entries (main.cpp:136-143)


def prove(curve: CurveParams, params, inputs, mask_bits: int = None):
    """The challenge prover (libsnark/main.cpp:172-233).

    `params` / `inputs` follow utils.serialization.Groth16Params/Input
    (affine points / standard-domain scalars).  Returns affine
    (A, B2, C).

    `mask_bits` masks every MSM scalar to its low bits before the
    multiexps (h is still computed from the full pipeline first).  The
    masked proof equals a partial-low-window device proof exactly (MSMs
    are linear in scalar bits), which is how the multichip dryrun
    value-checks a W-window run without paying for all 96.
    """
    g1 = ec.g1_group(curve)
    g2 = ec.g2_group(curve)
    primary_input_size = 1

    h_coeffs = compute_h(curve, params.d, inputs.ca, inputs.cb, inputs.cc)
    if mask_bits is not None:
        mask = (1 << mask_bits) - 1
        h_coeffs = [x & mask for x in h_coeffs]
        inputs = type(inputs)(
            w=[x & mask for x in inputs.w], ca=inputs.ca, cb=inputs.cb,
            cc=inputs.cc, r=inputs.r)

    A_pts = [g1.from_affine(xy) if xy[1] else g1.zero for xy in params.A]
    B1_pts = [g1.from_affine(xy) if xy[1] else g1.zero for xy in params.B1]
    B2_pts = [
        g2.from_affine(xy) if not g2.fis_zero(xy[1]) else g2.zero
        for xy in params.B2
    ]
    L_pts = [g1.from_affine(xy) if xy[1] else g1.zero for xy in params.L]
    H_pts = [g1.from_affine(xy) if xy[1] else g1.zero for xy in params.H]

    evaluation_At = msm(g1, inputs.w, A_pts)                       # m+1
    evaluation_Bt1 = msm(g1, inputs.w, B1_pts)                     # m+1
    evaluation_Bt2 = msm(g2, inputs.w, B2_pts)                     # m+1
    evaluation_Ht = msm(g1, h_coeffs[:params.d], H_pts)            # d
    evaluation_Lt = msm(
        g1, inputs.w[primary_input_size + 1:], L_pts)              # m-1

    # C = Ht + Lt + r*Bt1 (main.cpp:219 -- no s-terms)
    C = g1.add(g1.add(evaluation_Ht, evaluation_Lt),
               g1.mul(inputs.r, evaluation_Bt1))

    return (g1.to_affine(evaluation_At),
            g2.to_affine(evaluation_Bt2),
            g1.to_affine(C))


def derive_keys(curve: CurveParams, result: "SetupResult",
                num_inputs: int = 1
                ) -> Tuple[VerifyingKey, ProvingKeyExtras]:
    """Derive the full-Groth16 key material from a challenge setup.

    The challenge pipeline's files carry no vk
    (generate_parameters.cpp:60-108 writes only the query tables), so
    the vk is reconstructed from the retained trapdoor exactly as the
    generator would have built it (r1cs_gg_ppzksnark.tcc:289-377):
    gamma_abc_i = (beta*At_i + alpha*Bt_i + Ct_i) / gamma for the
    primary indices, and plain generator multiples for the rest.
    """
    r_mod = curve.fr.p
    td = result.trapdoor
    if not td.gamma:
        raise ValueError("setup predates gamma; re-run setup")
    g1 = ec.g1_group(curve)
    g2 = ec.g2_group(curve)
    g1_gen = g1.mul(td.g1_dlog, ec.g1_generator(curve))
    g2_gen = ec.g2_generator(curve)

    gamma_inv = pow(td.gamma, -1, r_mod)
    abc = [
        (td.beta * td.at[i] + td.alpha * td.bt[i] + td.ct[i])
        * gamma_inv % r_mod
        for i in range(num_inputs + 1)
    ]
    vk = VerifyingKey(
        alpha_g1=g1.to_affine(g1.mul(td.alpha, g1_gen)),
        beta_g2=g2.to_affine(g2.mul(td.beta, g2_gen)),
        gamma_g2=g2.to_affine(g2.mul(td.gamma, g2_gen)),
        delta_g2=g2.to_affine(g2.mul(td.delta, g2_gen)),
        gamma_abc_g1=[g1.to_affine(g1.mul(k, g1_gen)) for k in abc],
    )
    pk = ProvingKeyExtras(
        alpha_g1=vk.alpha_g1,
        beta_g1=g1.to_affine(g1.mul(td.beta, g1_gen)),
        beta_g2=vk.beta_g2,
        delta_g1=g1.to_affine(g1.mul(td.delta, g1_gen)),
        delta_g2=vk.delta_g2,
    )
    return vk, pk


def full_prove(curve: CurveParams, result: "SetupResult",
               pk: ProvingKeyExtras, r: int = None, s: int = None,
               rng: Optional[random.Random] = None):
    """The LIBRARY-level Groth16 prover with alpha/beta offsets and
    (r, s) zero-knowledge terms (r1cs_gg_ppzksnark.tcc:381-496) — the
    variant the challenge prover deliberately strips (main.cpp:219).

    Returns affine (g1_A, g2_B, g1_C), publicly verifiable by
    `verify()` with only the vk.
    """
    r_mod = curve.fr.p
    rng = rng or random.Random()
    if r is None:
        r = rng.randrange(r_mod)
    if s is None:
        s = rng.randrange(r_mod)
    g1 = ec.g1_group(curve)
    g2 = ec.g2_group(curve)
    num_inputs = 1

    h = compute_h(curve, result.d, result.ca, result.cb, result.cc)
    w = result.w

    A_pts = [g1.from_affine(xy) if xy[1] else g1.zero for xy in result.A]
    B1_pts = [g1.from_affine(xy) if xy[1] else g1.zero for xy in result.B1]
    B2_pts = [
        g2.from_affine(xy) if not g2.fis_zero(xy[1]) else g2.zero
        for xy in result.B2
    ]
    L_pts = [g1.from_affine(xy) if xy[1] else g1.zero for xy in result.L]
    H_pts = [g1.from_affine(xy) if xy[1] else g1.zero for xy in result.H]

    alpha_g1 = g1.from_affine(pk.alpha_g1)
    beta_g1 = g1.from_affine(pk.beta_g1)
    beta_g2 = g2.from_affine(pk.beta_g2)
    delta_g1 = g1.from_affine(pk.delta_g1)
    delta_g2 = g2.from_affine(pk.delta_g2)

    # g1_A = alpha + sum w_i A_i + r delta       (tcc:428-441)
    g_A = g1.add(g1.add(alpha_g1, msm(g1, w, A_pts)),
                 g1.mul(r, delta_g1))
    # g2_B = beta + sum w_i B_i + s delta; g1_B mirror
    g_B2 = g2.add(g2.add(beta_g2, msm(g2, w, B2_pts)),
                  g2.mul(s, delta_g2))
    g_B1 = g1.add(g1.add(beta_g1, msm(g1, w, B1_pts)),
                  g1.mul(s, delta_g1))
    # g1_C = sum_aux w L + sum h H + s A + r B1 - rs delta  (tcc:462-477)
    g_C = g1.add(
        g1.add(msm(g1, w[num_inputs + 1:], L_pts),
               msm(g1, h[:result.d], H_pts)),
        g1.add(g1.add(g1.mul(s, g_A), g1.mul(r, g_B1)),
               g1.neg(g1.mul(r * s % r_mod, delta_g1))),
    )
    return (g1.to_affine(g_A), g2.to_affine(g_B2), g1.to_affine(g_C))


def verify(curve: CurveParams, vk: VerifyingKey, primary_input: List[int],
           proof) -> bool:
    """Pairing-based Groth16 verification, vk only — no trapdoor.

    e(A, B) == e(alpha, beta) * e(acc, gamma) * e(C, delta) with
    acc = gamma_abc_0 + sum_i primary_i * gamma_abc_{i+1}
    (r1cs_gg_ppzksnark.tcc:498-610).
    """
    from . import pairing as pr
    p = curve.fq.p
    alpha = curve.non_residue
    g1 = ec.g1_group(curve)
    g2 = ec.g2_group(curve)
    if len(primary_input) + 1 != len(vk.gamma_abc_g1):
        return False
    proof_a, proof_b, proof_c = proof

    acc = g1.from_affine(vk.gamma_abc_g1[0]) \
        if vk.gamma_abc_g1[0][1] else g1.zero
    for x, xy in zip(primary_input, vk.gamma_abc_g1[1:]):
        pt = g1.from_affine(xy) if xy[1] else g1.zero
        acc = g1.add(acc, g1.mul(int(x) % curve.fr.p, pt))

    def load1(xy):
        return g1.from_affine(xy) if xy[1] else g1.zero

    def load2(xy):
        return g2.from_affine(xy) if not g2.fis_zero(xy[1]) else g2.zero

    a_pt, b_pt, c_pt = load1(proof_a), load2(proof_b), load1(proof_c)
    for pt, grp in ((a_pt, g1), (b_pt, g2), (c_pt, g1)):
        if not grp.is_on_curve(pt):
            return False
    # e(A,B) * e(-alpha,beta) * e(-acc,gamma) * e(-C,delta) == 1
    return pr.pairing_product_is_one(curve, [
        (a_pt, b_pt),
        (g1.neg(g1.from_affine(vk.alpha_g1)), load2(vk.beta_g2)),
        (g1.neg(acc), load2(vk.gamma_g2)),
        (g1.neg(c_pt), load2(vk.delta_g2)),
    ])


def verify_with_trapdoor(curve: CurveParams, result: "SetupResult",
                         proof_a, proof_b, proof_c) -> bool:
    """Exponent-space Groth16 check using the setup trapdoor.

    Expected values (challenge-simplified prover, no s-randomness):
        A = (sum_i w_i At_i) * g1_gen
        B = (sum_i w_i Bt_i) * G2::one
        C = (H(t) Zt + sum_aux w_i (beta At_i + alpha Bt_i + Ct_i)
             + r sum_i w_i Bt_i) * delta^-1 ... expanded exactly as the
        prover's MSMs assemble it.
    Also checks the QAP divisibility A(t)B(t) - C(t) == H(t) Zt.
    """
    r_mod = curve.fr.p
    td = result.trapdoor
    w = result.w
    m = result.m

    a_s = sum(wi * ai for wi, ai in zip(w, td.at)) % r_mod
    b_s = sum(wi * bi for wi, bi in zip(w, td.bt)) % r_mod
    c_qap = sum(wi * ci for wi, ci in zip(w, td.ct)) % r_mod

    h = compute_h(curve, result.d, result.ca, result.cb, result.cc)
    h_at_t = 0
    ti = 1
    for coeff in h[:result.d]:
        h_at_t = (h_at_t + coeff * ti) % r_mod
        ti = ti * td.t % r_mod
    # QAP: A(t)*B(t) - C(t) must equal H(t)*Z(t).  The prover only uses
    # h[0:d] but the degree-d coefficient of H is 0 for honest witnesses
    # (r1cs_gg_ppzksnark.tcc:395-399), so this is exact.
    if (a_s * b_s - c_qap - h_at_t * td.zt) % r_mod:
        return False

    delta_inv = pow(td.delta, -1, r_mod)
    l_s = sum(
        wi * ((td.beta * ai + td.alpha * bi + ci) % r_mod)
        for wi, ai, bi, ci in zip(w[2:], td.at[2:], td.bt[2:], td.ct[2:])
    ) % r_mod
    c_s = ((h_at_t * td.zt + l_s) * delta_inv + result.r * b_s) % r_mod

    g1 = ec.g1_group(curve)
    g2 = ec.g2_group(curve)
    g1_one = ec.g1_generator(curve)
    g2_one = ec.g2_generator(curve)

    exp_a = g1.to_affine(g1.mul(a_s * td.g1_dlog % r_mod, g1_one))
    exp_b = g2.to_affine(g2.mul(b_s, g2_one))
    exp_c = g1.to_affine(g1.mul(c_s * td.g1_dlog % r_mod, g1_one))
    return (exp_a, exp_b, exp_c) == (proof_a, proof_b, proof_c)
