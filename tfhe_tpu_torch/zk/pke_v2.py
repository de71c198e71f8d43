"""Proof of knowledge for compact-public-key LWE encryption, version 2.

Re-implements the algebra of the reference ``tfhe-zk-pok/src/proofs/pke_v2``
(the shorter-proof scheme of the TFHE ZK paper: instead of bit-decomposing
every noise coordinate as in pke v1, the prover shows the *euclidean norm*
bound ||(e1,e2)||^2 <= B^2 via a Lagrange four-square witness v with
B^2 - ||e||^2 = v1^2+..+v4^2, plus 128 random +/-1 projections (the matrix
R) whose bit decompositions certify the aggregated bound B_bound
(pke_v2/mod.rs:839-1615 prove_impl, :1768 verify_impl, :2085
pairing_check_two_steps; four_squares.rs; compute_crs_params
pke_v2/mod.rs:638).

Structure preserved from the reference:
- CRS: g_list[j] = alpha^j G for j=1..2n with the j=n+1 slot zeroed,
  g_hat_list[i] = alpha^i G_hat (GroupElements, proofs/mod.rs:81).
- witness layout w = (e1 | e2 | v | r1 | r2), binary vector
  w_bin = (rev(r != 0) | m bits | bits of w_R), w_R = R.w.
- challenge chain gamma -> R -> phi -> xi -> y -> t -> theta -> omega ->
  delta[7] -> z -> chi with each hash binding all prior commitments.
  Every challenge is derived through zk/transcript.py, a byte-for-byte
  mirror of the Rust sha3 framing (pke_v2/hashes.rs typestate chain,
  config V0_8_0 Compact; arkworks Montgomery-limb point/scalar byte
  encodings) — given equal domain-separator/sid/commitment bytes the
  scalars equal the reference's. The separators themselves are drawn
  from the reference CRS's rng there, so equal-VALUE interop requires
  importing a reference CRS's separators (transcript.separators_from_
  crs_ds covers self-generated CRS deterministically).
- ComputeLoad::Proof layout (C_hat_h3 / C_hat_w carried in the proof) and
  the TwoSteps verification equations (50)/(51).

Host-side pure Python (proofs guard data ingress; not GPU work). Tests run
reduced dimensions; the code path is dimension-generic.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from .curve import (G1, G2, R as ZP, fixed_base_powers, group_sum,
                    msm as curve_msm, pairing_product_is_one)
from .four_squares import four_squares
from .pke import (
    _compute_r1,
    _compute_r2,
    _hash_to_scalars,
    _ilog2,
    _msm_g1,
    _poly_mul_mod,
)

_GHL_FACTOR_X10000 = 950625  # 9.75^2 * 10^4 (pke_v2/mod.rs:655)


def _ceil_ilog2(v: int) -> int:
    assert v > 0
    return (v - 1).bit_length() if v > 1 else 0


def compute_crs_params_v2(d: int, k: int, b_squared: int, t: int,
                          pad_bits: int, bound_type: str = "GHL"):
    """(n, D, B_bound_squared, m_bound) — pke_v2/mod.rs:638-694."""
    assert k <= d
    base = b_squared + ((d + 2) ** 2 * (d + k)) // 4
    if bound_type == "GHL":
        bbs = (_GHL_FACTOR_X10000 * base + 9999) // 10000
    else:  # Cauchy-Schwarz
        bbs = (2 * (d + k) + 4) * base
    m_bound = 1 + (_ceil_ilog2(bbs) + 1) // 2
    assert m_bound <= 64
    t_eff = t >> pad_bits
    D = d + k * _ilog2(t_eff)
    n = D + 128 * m_bound
    return n, D, bbs, m_bound


def _inf_to_euclidean_squared(b_inf: int, dim: int) -> int:
    return b_inf * b_inf * dim


@dataclass
class PkeV2Crs:
    """pke_v2 CRS: same punctured powers-of-alpha lists as v1 but sized by
    the norm-proof formula (n = D + 128*m)."""

    d: int
    k: int
    b_inf: int
    q: int  # 0 encodes 2^64
    t: int
    pad_bits: int
    bound_type: str = "GHL"
    n: int = 0
    big_d: int = 0
    b_bound_squared: int = 0
    m_bound: int = 0
    g_list: List[G1] = field(default_factory=list)       # 1-based, 2n+1
    g_hat_list: List[G2] = field(default_factory=list)   # 1-based, n+1
    sid: int = 0
    ds: bytes = b""

    @property
    def decoded_q(self) -> int:
        return (1 << 64) if self.q == 0 else self.q

    @property
    def delta(self) -> int:
        return self.decoded_q // self.t

    @property
    def t_eff(self) -> int:
        return self.t >> self.pad_bits

    def params_for(self, k: int):
        """Per-statement (D, m) for k <= self.k messages."""
        bsq = _inf_to_euclidean_squared(self.b_inf, self.d + k)
        _, D, _, m = compute_crs_params_v2(
            self.d, k, bsq, self.t, self.pad_bits, self.bound_type)
        return D, m, bsq

    @classmethod
    def generate(cls, d: int, k: int, b_inf: int, q: int, t: int,
                 pad_bits: int, seed: int = 0,
                 bound_type: str = "GHL") -> "PkeV2Crs":
        bsq = _inf_to_euclidean_squared(b_inf, d + k)
        n, D, bbs, m = compute_crs_params_v2(d, k, bsq, t, pad_bits,
                                             bound_type)
        root = hashlib.shake_256(
            b"tfhe-tpu-crs-v2" + seed.to_bytes(8, "little"))
        alpha = int.from_bytes(root.digest(80)[:64], "little") % ZP
        crs = cls(d=d, k=k, b_inf=b_inf, q=q, t=t, pad_bits=pad_bits,
                  bound_type=bound_type, n=n, big_d=D,
                  b_bound_squared=bbs, m_bound=m)
        # windowed fixed-base tables; the j = n+1 slot is the punctured
        # KZG hole (GroupElements::new)
        crs.g_list = [G1.zero()] + fixed_base_powers(
            G1, alpha, 2 * n, skip=frozenset((n + 1,)))
        crs.g_hat_list = [G2.zero()] + fixed_base_powers(G2, alpha, n)
        crs.sid = int.from_bytes(root.digest(96)[80:88], "little")
        crs.ds = root.digest(128)[96:]
        return crs

    def tag(self, name: bytes) -> bytes:
        return b"pkev2/" + self.ds + name


@dataclass
class PkeV2Proof:
    C_hat_e: G2
    C_e: G1
    C_r_tilde: G1
    C_R: G1
    C_hat_bin: G2
    C_y: G1
    C_h1: G1
    C_h2: G1
    C_hat_t: G2
    pi: G1
    pi_kzg: G1
    C_hat_h3: G2
    C_hat_w: G2

    def to_bytes(self) -> bytes:
        parts = [p.to_bytes() for p in (
            self.C_hat_e, self.C_e, self.C_r_tilde, self.C_R,
            self.C_hat_bin, self.C_y, self.C_h1, self.C_h2, self.C_hat_t,
            self.pi, self.pi_kzg, self.C_hat_h3, self.C_hat_w)]
        return b"".join(parts)


def _msm_g2(points: Sequence[G2], scalars: Sequence[int]) -> G2:
    """Pippenger bucket MSM (curve.msm); was a per-term double-and-add."""
    points = list(points)
    if not points:
        return G2.zero()
    return curve_msm((s, p) for p, s in zip(points, scalars))


def _poly_mul_zp(a: List[int], b: List[int]) -> List[int]:
    """Product over Zp (Kronecker substitution; see pke._poly_mul_mod)."""
    return _poly_mul_mod(a, b, ZP)


def _phi_r_cols(Rm: List[int], phi: List[int], cols: int) -> List[int]:
    """All columns of phi.T R at once: out[j] = sum_i phi_i R[i, j].

    One pass over the column-major R matrix (entries in {-1, 0, 1});
    replaces the per-column 128-iteration closure that prove/verify used
    to re-run for every j (~n calls x 128 = ~700k interpreted loops)."""
    out = [0] * cols
    for i in range(128):
        ph = phi[i]
        row = Rm[i::128]
        for j, v in enumerate(row):
            if v:
                if v == 1:
                    out[j] += ph
                else:
                    out[j] -= ph
    return [x % ZP for x in out]


def _compute_a_theta_v2(crs: PkeV2Crs, theta: List[int], a, b_poly,
                        k: int, D: int) -> List[int]:
    """a_theta = A~.T theta, length D (pke_v2/mod.rs:1617-1717).

    The two d-dimensional blocks are (nega)cyclic correlations, computed
    as single Kronecker products instead of the O(d^2) double loop:

    - rot(a).T theta1:  dot_i = sum_{j>=i} a_{j-i} th_j - sum_{j<i}
      a_{d+j-i} th_j.  With P = rev(a) * theta1 (linear product,
      rev(a)_i = a_{d-1-i}):  dot_i = P_{d-1+i} - P_{i-1}.
    - phi(bar b) theta2:  dot_i = sum_{i+j<d} b_{d-1-i-j} th2_j
      - sum_{i+j>=d} b_{2d-1-i-j} th2_j.  With Q = b * theta2:
      dot_i = Q_{d-1-i} - Q_{2d-1-i}.
    """
    d, t_eff = crs.d, crs.t_eff
    delta = crs.delta % ZP
    theta1, theta2 = theta[:d], theta[d:d + k]
    az = [x % ZP for x in a]
    bz = [x % ZP for x in b_poly]
    P_ = _poly_mul_mod(az[::-1], theta1, ZP)
    Q_ = _poly_mul_mod(bz, theta2, ZP) if k else []
    lq = len(Q_)
    out = []
    for i in range(d):
        dot = P_[d - 1 + i] - (P_[i - 1] if i else 0)
        qi = d - 1 - i
        if 0 <= qi < lq:
            dot += Q_[qi]
        qi = 2 * d - 1 - i
        if qi < lq:
            dot -= Q_[qi]
        out.append(dot % ZP)
    step = _ilog2(t_eff)
    for i in range(k):  # delta * g[log t].T theta2_i (ascending powers)
        cur = delta * theta2[i] % ZP
        for j in range(step):
            out.append(cur)
            cur = cur * 2 % ZP
    assert len(out) == D
    return out


def _make_transcript(crs: PkeV2Crs, metadata: bytes, a, b_poly, c1, c2,
                     k: int, D: int, mb: int):
    """The reference-framed Fiat-Shamir transcript (hashes.rs chain,
    config V0_8_0 Compact — see zk/transcript.py) bound to this CRS and
    statement. Both prove() and verify() derive every challenge through
    this object, so the framing IS the reference's byte layout."""
    from . import transcript as tr

    ds = tr.separators_from_crs_ds(crs.ds)
    xb = tr.statement_bytes(crs.q, crs.d, k, crs.b_inf, crs.t,
                            crs.pad_bits, a, b_poly, c1, c2)
    return tr.PkeV2Transcript(
        ds, crs.sid.to_bytes(16, "little"), metadata, xb,
        D=D, m=mb, n=crs.n, k=k, d=crs.d)


def prove(crs: PkeV2Crs, public, private, metadata: bytes = b"",
          seed: bytes = b"\x00" * 32) -> PkeV2Proof:
    """public = (a, b, c1, c2); private = (r, e1, m, e2).

    Mirrors prove_impl (pke_v2/mod.rs:839) with ComputeLoad::Proof.
    """
    a, b_poly, c1, c2 = public
    r, e1, m, e2 = private
    d = crs.d
    k = len(c2)
    # soundness-critical input validation: real exceptions, not asserts
    # (asserts are stripped under python -O, which would let an unsound
    # proof be emitted past the CRS bound)
    if not (k <= crs.k and len(a) == d and len(c1) == d):
        raise ValueError(
            f"statement shape mismatch: k={k} (max {crs.k}), "
            f"len(a)={len(a)}, len(c1)={len(c1)}, d={d}")
    n = crs.n
    q = crs.decoded_q
    delta = crs.delta
    t_eff = crs.t_eff
    D, mb, b_squared = crs.params_for(k)
    L = D + 128 * mb

    e_sqr_norm = sum(x * x for x in e1) + sum(x * x for x in e2)
    if b_squared < e_sqr_norm:
        raise ValueError("noise exceeds the CRS bound: "
                         f"||e||^2 = {e_sqr_norm} > B^2 = {b_squared}")

    g = G1.generator()
    g_hat = G2.generator()
    gl = crs.g_list      # 1-based alpha^j
    gh = crs.g_hat_list  # 1-based alpha^i

    gammas = _hash_to_scalars(crs.tag(b"gamma"), [seed, metadata], 6)
    gamma_e, gamma_hat_e, gamma_r, gamma_R, gamma_bin, gamma_y = gammas

    r1 = _compute_r1(e1, c1, a, r, d, q)
    r2 = _compute_r2(e2, c2, m, b_poly, r, d, delta, q)

    # binary part of the witness: reversed r bits then message bits
    w_tilde: List[bool] = [bool(x) for x in reversed(r)]
    for mi in m:
        for j in range(_ilog2(t_eff)):
            w_tilde.append(bool((mi >> j) & 1))
    assert len(w_tilde) == D

    v = four_squares(b_squared - e_sqr_norm)

    w_full = list(e1) + list(e2) + list(v) + list(r1) + list(r2)

    # commitments round 1
    ev = [x % ZP for x in w_full[: d + k + 4]]  # e1|e2|v as Zp
    C_hat_e = gamma_hat_e * g_hat + _msm_g2(gh[1: d + k + 5], ev)
    C_e = gamma_e * g + _msm_g1(
        [gl[n - j] for j in range(d + k + 4)], ev)
    r12 = [x % ZP for x in (list(r1) + list(r2))]
    C_r_tilde = gamma_r * g + _msm_g1(gl[1: d + k + 1], r12)

    from .transcript import g1_bytes, g2_bytes

    tr = _make_transcript(crs, metadata, a, b_poly, c1, c2, k, D, mb)
    Rm = tr.gen_R(g2_bytes(C_hat_e), g1_bytes(C_e), g1_bytes(C_r_tilde))

    w_R = []
    for i in range(128):
        acc = 0
        for x, rij in zip(w_full, Rm[i::128]):
            if rij == 1:
                acc += x
            elif rij == -1:
                acc -= x
        assert acc * acc <= crs.b_bound_squared
        w_R.append(acc)

    C_R = gamma_R * g + _msm_g1(gl[1:129], [x % ZP for x in w_R])

    phi = tr.gen_phi(g1_bytes(C_R))

    # bit decomposition of w_R (two's complement over mb bits)
    w_R_bin: List[bool] = []
    for x in w_R:
        ux = x & ((1 << mb) - 1) if x >= 0 else ((x + (1 << mb))
                                                 & ((1 << mb) - 1))
        for j in range(mb):
            w_R_bin.append(bool((ux >> j) & 1))
    w_bin = w_tilde + w_R_bin
    assert len(w_bin) == L

    C_hat_bin = group_sum(
        [gamma_bin * g_hat]
        + [gh[j + 1] for j, wb in enumerate(w_bin) if wb])

    xi = tr.gen_xi(g2_bytes(C_hat_bin))
    y = tr.gen_y()

    C_y = gamma_y * g + _msm_g1(
        [gl[n - j] for j in range(L)],
        [y[j] if w_bin[j] else 0 for j in range(L)])

    t = tr.gen_t(g1_bytes(C_y))
    theta = tr.gen_theta()

    a_theta = _compute_a_theta_v2(crs, theta, a, b_poly, k, D)
    t_theta = sum(th * (c % ZP) for th, c in
                  zip(theta, list(c1) + list(c2))) % ZP

    omega = tr.gen_omega()
    deltas = tr.gen_delta()
    delta_r, delta_dec, delta_eq, delta_y, delta_theta, delta_e, delta_l = \
        deltas
    delta_theta_q = delta_theta * (q % ZP) % ZP

    ez = [x % ZP for x in e1] + [x % ZP for x in e2] + [x % ZP for x in v]

    # -- the aggregated polynomial P_pi: sum of 6 structured products
    # (pke_v2/mod.rs:1104-1340). poly coefficient index = power of alpha.
    def xi_dec_coeff(j):
        """delta_dec * xi[j/m] * 2^(j%m), negated on the top (sign) bit."""
        blk, pos = divmod(j, mb)
        r_ = delta_dec * xi[blk] % ZP * pow(2, pos, ZP) % ZP
        return (-r_) % ZP if pos == mb - 1 else r_

    poly_0_lhs = [0] * (1 + n)
    poly_0_lhs[0] = delta_y * gammas[5] % ZP  # gamma_y
    for j in range(L):
        p = 0
        if not w_bin[j]:
            p -= delta_y * y[j]
        if j < D:
            p += delta_theta * a_theta[j]
        p += delta_eq * t[j] % ZP * y[j]
        if j >= D:
            p += xi_dec_coeff(j - D)
        poly_0_lhs[n - j] = (poly_0_lhs[n - j] + p) % ZP
    poly_0_rhs = [0] * (1 + L)
    poly_0_rhs[0] = gamma_bin % ZP
    for j in range(L):
        if w_bin[j]:
            poly_0_rhs[j + 1] = 1

    phi_R_col = _phi_r_cols(Rm, phi, 2 * (d + k) + 4).__getitem__

    poly_1_lhs = [0] * (1 + n)
    poly_1_lhs[0] = delta_l * gamma_e % ZP
    for j in range(d + k + 4):
        poly_1_lhs[n - j] = delta_l * ez[j] % ZP
    for j in range(n):
        acc = delta_e * omega[j] % ZP
        if j < d + k:
            acc += delta_theta * theta[j]
        if j < d + k + 4:
            acc += delta_r * phi_R_col(j)
        poly_1_lhs[n - j] = (poly_1_lhs[n - j] + acc) % ZP
    poly_1_rhs = [0] * (1 + d + k + 4)
    poly_1_rhs[0] = gamma_hat_e % ZP
    for j in range(d + k + 4):
        poly_1_rhs[1 + j] = ez[j]

    poly_2_lhs = [0] * (1 + d + k)
    poly_2_lhs[0] = gamma_r % ZP
    for j in range(d + k):
        poly_2_lhs[1 + j] = r12[j]
    poly_2_rhs = [0] * (1 + n)
    for j in range(d + k):
        poly_2_rhs[n - j] = (delta_r * phi_R_col(d + k + 4 + j)
                             - delta_theta_q * theta[j]) % ZP

    poly_3_lhs = [0] * (1 + 128)
    poly_3_lhs[0] = gamma_R % ZP
    for j in range(128):
        poly_3_lhs[1 + j] = w_R[j] % ZP
    poly_3_rhs = [0] * (1 + n)
    for j in range(128):
        poly_3_rhs[n - j] = (delta_r * phi[j] + delta_dec * xi[j]) % ZP

    poly_4_lhs = [0] * (1 + n)
    poly_4_lhs[0] = delta_e * gamma_e % ZP
    for j in range(d + k + 4):
        poly_4_lhs[n - j] = delta_e * ez[j] % ZP
    poly_4_rhs = [0] * (1 + d + k + 4)
    for j in range(d + k + 4):
        poly_4_rhs[1 + j] = omega[j]

    poly_5_lhs = [0] * (1 + n)
    poly_5_lhs[0] = delta_eq * gamma_y % ZP
    for j in range(L):
        if w_bin[j]:
            poly_5_lhs[n - j] = delta_eq * y[j] % ZP
    poly_5_rhs = [0] * (1 + n)
    for j in range(n):
        poly_5_rhs[1 + j] = t[j]

    prods = [
        _poly_mul_zp(poly_0_lhs, poly_0_rhs),
        _poly_mul_zp(poly_1_lhs, poly_1_rhs),
        _poly_mul_zp(poly_2_lhs, poly_2_rhs),
        _poly_mul_zp(poly_3_lhs, poly_3_rhs),
        _poly_mul_zp(poly_4_lhs, poly_4_rhs),
        _poly_mul_zp(poly_5_lhs, poly_5_rhs),
    ]
    length = max(len(p) for p in prods)
    P_pi = [0] * length
    for idx, pr in enumerate(prods):
        sgn = 1 if idx < 3 else -1
        for j, c in enumerate(pr):
            P_pi[j] = (P_pi[j] + sgn * c) % ZP
    if length > n + 1:
        P_pi[n + 1] = (P_pi[n + 1]
                       - (delta_theta * t_theta
                          + delta_l * (b_squared % ZP))) % ZP
    # commit P_pi on (g, alpha^1.. ) — the alpha^(n+1) slot is the CRS hole,
    # so a nonzero coefficient there would be silently dropped; the identity
    # guarantees it is exactly the subtracted constant
    pi = P_pi[0] * g + _msm_g1(gl[1:length], P_pi[1:])

    # h1/h2 helper commitments
    h1_scalars = [0] * L
    for j in range(L):
        acc = 0
        if j < D:
            acc += delta_theta * a_theta[j]
        acc -= delta_y * y[j]
        acc += delta_eq * t[j] % ZP * y[j]
        if j >= D:
            acc += xi_dec_coeff(j - D)
        h1_scalars[j] = acc % ZP
    C_h1 = _msm_g1([gl[n - j] for j in range(L)], h1_scalars)

    h2_scalars = [0] * n
    for j in range(n):
        acc = delta_e * omega[j] % ZP
        if j < d + k:
            acc += delta_theta * theta[j]
        if j < d + k + 4:
            acc += delta_r * phi_R_col(j)
        h2_scalars[j] = acc % ZP
    C_h2 = _msm_g1([gl[n - j] for j in range(n)], h2_scalars)

    h3_scalars = [(delta_r * phi_R_col(d + k + 4 + j)
                   - delta_theta_q * theta[j]) % ZP for j in range(d + k)]
    C_hat_h3 = _msm_g2([gh[n - j] for j in range(d + k)], h3_scalars)
    C_hat_w = _msm_g2(gh[1: d + k + 5], omega[: d + k + 4])

    C_hat_t = _msm_g2(gh[1: n + 1], t)

    z = tr.gen_z(g1_bytes(C_h1), g1_bytes(C_h2), g2_bytes(C_hat_t),
                 g2_bytes(C_hat_h3), g2_bytes(C_hat_w))

    # the five opened polynomials and their evaluations at z
    P_h1 = [0] * (1 + n)
    for j in range(L):
        P_h1[n - j] = h1_scalars[j]
    P_h2 = [0] * (1 + n)
    for j in range(n):
        P_h2[n - j] = h2_scalars[j]
    P_t = [0] + list(t)
    P_h3 = [0] * (1 + n)
    for j in range(d + k):
        P_h3[n - j] = h3_scalars[j]
    P_omega = [0] + list(omega[: d + k + 4])

    def eval_at(poly, x):
        acc = 0
        for c in reversed(poly):
            acc = (acc * x + c) % ZP
        return acc

    p_h1, p_h2, p_t = (eval_at(P_h1, z), eval_at(P_h2, z), eval_at(P_t, z))
    p_h3, p_omega = eval_at(P_h3, z), eval_at(P_omega, z)

    chi = tr.gen_chi(p_h1, p_h2, p_t, p_h3, p_omega)
    chi2 = chi * chi % ZP
    chi3 = chi2 * chi % ZP
    chi4 = chi3 * chi % ZP

    Q = [0] * (1 + n)
    for j in range(1 + n):
        Q[j] = (P_h1[j] + chi * P_h2[j] + chi2 * P_t[j]
                + chi3 * P_h3[j]
                + chi4 * (P_omega[j] if j < len(P_omega) else 0)) % ZP
    Q[0] = (Q[0] - (p_h1 + chi * p_h2 + chi2 * p_t + chi3 * p_h3
                    + chi4 * p_omega)) % ZP
    # synthetic division by (X - z): Q must vanish at z
    qq = [0] * n
    acc = 0
    for j in range(n, 0, -1):
        acc = (Q[j] + z * acc) % ZP if j == n else (Q[j] + z * acc) % ZP
        qq[j - 1] = acc
    assert (Q[0] + z * qq[0]) % ZP == 0, "KZG opening: nonzero remainder"
    pi_kzg = qq[0] * g + _msm_g1(gl[1:n], qq[1:n])

    return PkeV2Proof(
        C_hat_e=C_hat_e, C_e=C_e, C_r_tilde=C_r_tilde, C_R=C_R,
        C_hat_bin=C_hat_bin, C_y=C_y, C_h1=C_h1, C_h2=C_h2,
        C_hat_t=C_hat_t, pi=pi, pi_kzg=pi_kzg,
        C_hat_h3=C_hat_h3, C_hat_w=C_hat_w,
    )


def verify(proof: PkeV2Proof, crs: PkeV2Crs, public,
           metadata: bytes = b"") -> bool:
    """pairing_check_two_steps (pke_v2/mod.rs:2085): equations (50)+(51)."""
    a, b_poly, c1, c2 = public
    d = crs.d
    k = len(c2)
    if k > crs.k or len(a) != d or len(b_poly) != d or len(c1) != d:
        return False
    n = crs.n
    q = crs.decoded_q
    D, mb, b_squared = crs.params_for(k)
    L = D + 128 * mb
    gl, gh = crs.g_list, crs.g_hat_list
    g, g_hat = G1.generator(), G2.generator()

    from .transcript import g1_bytes, g2_bytes

    tr = _make_transcript(crs, metadata, a, b_poly, c1, c2, k, D, mb)
    Rm = tr.gen_R(g2_bytes(proof.C_hat_e), g1_bytes(proof.C_e),
                  g1_bytes(proof.C_r_tilde))
    phi = tr.gen_phi(g1_bytes(proof.C_R))
    xi = tr.gen_xi(g2_bytes(proof.C_hat_bin))
    y = tr.gen_y()
    t = tr.gen_t(g1_bytes(proof.C_y))
    theta = tr.gen_theta()
    a_theta = _compute_a_theta_v2(crs, theta, a, b_poly, k, D)
    t_theta = sum(th * (c % ZP) for th, c in
                  zip(theta, list(c1) + list(c2))) % ZP
    omega = tr.gen_omega()
    deltas = tr.gen_delta()
    delta_r, delta_dec, delta_eq, delta_y, delta_theta, delta_e, delta_l = \
        deltas
    delta_theta_q = delta_theta * (q % ZP) % ZP

    phi_R_col = _phi_r_cols(Rm, phi, 2 * (d + k) + 4).__getitem__

    def xi_dec_coeff(j):
        blk, pos = divmod(j, mb)
        r_ = delta_dec * xi[blk] % ZP * pow(2, pos, ZP) % ZP
        return (-r_) % ZP if pos == mb - 1 else r_

    z = tr.gen_z(g1_bytes(proof.C_h1), g1_bytes(proof.C_h2),
                 g2_bytes(proof.C_hat_t), g2_bytes(proof.C_hat_h3),
                 g2_bytes(proof.C_hat_w))

    # recompute the opened evaluations at z
    P_h1 = [0] * (1 + n)
    for j in range(L):
        acc = 0
        if j < D:
            acc += delta_theta * a_theta[j]
        acc -= delta_y * y[j]
        acc += delta_eq * t[j] % ZP * y[j]
        if j >= D:
            acc += xi_dec_coeff(j - D)
        P_h1[n - j] = acc % ZP
    P_h2 = [0] * (1 + n)
    for j in range(n):
        acc = delta_e * omega[j] % ZP
        if j < d + k:
            acc += delta_theta * theta[j]
        if j < d + k + 4:
            acc += delta_r * phi_R_col(j)
        P_h2[n - j] = acc % ZP
    P_t = [0] + list(t)
    P_h3 = [0] * (1 + n)
    for j in range(d + k):
        P_h3[n - j] = (delta_r * phi_R_col(d + k + 4 + j)
                       - delta_theta_q * theta[j]) % ZP
    P_omega = [0] + list(omega[: d + k + 4])

    def eval_at(poly, x):
        acc = 0
        for c in reversed(poly):
            acc = (acc * x + c) % ZP
        return acc

    p_h1, p_h2, p_t = (eval_at(P_h1, z), eval_at(P_h2, z), eval_at(P_t, z))
    p_h3, p_omega = eval_at(P_h3, z), eval_at(P_omega, z)

    chi = tr.gen_chi(p_h1, p_h2, p_t, p_h3, p_omega)
    chi2 = chi * chi % ZP
    chi3 = chi2 * chi % ZP
    chi4 = chi3 * chi % ZP

    # equation (50): e(pi, g_hat) ==
    #   e(dy*Cy + Ch1, Cbin) + e(dl*Ce + Ch2, Ce_hat) + e(Cr~, Ch3_hat)
    #   - e(CR, S_hat) - e(de*Ce, Cw_hat) - e(deq*Cy, Ct_hat)
    #   - e(g a, g_hat a^n)*(dth*t_theta + dl*B^2)
    S_hat = _msm_g2([gh[n - j] for j in range(128)],
                    [(delta_r * phi[j] + delta_dec * xi[j]) % ZP
                     for j in range(128)])
    const = (delta_theta * t_theta + delta_l * (b_squared % ZP)) % ZP
    if not pairing_product_is_one([
        (delta_y * proof.C_y + proof.C_h1, proof.C_hat_bin),
        (delta_l * proof.C_e + proof.C_h2, proof.C_hat_e),
        (proof.C_r_tilde, proof.C_hat_h3),
        (-(proof.C_R), S_hat),
        (-(delta_e * proof.C_e), proof.C_hat_w),
        (-(delta_eq * proof.C_y), proof.C_hat_t),
        (-(const * gl[1]), gh[n]),
        (-(proof.pi), g_hat),
    ]):
        return False

    # equation (51): the batched KZG opening at z
    c_hat = chi2 * proof.C_hat_t + chi3 * proof.C_hat_h3 \
        + chi4 * proof.C_hat_w
    c_hat = c_hat - ((p_t * chi2 + p_h3 * chi3 + p_omega * chi4) % ZP) * g_hat
    return pairing_product_is_one([
        (proof.C_h1 + chi * proof.C_h2 - ((p_h1 + chi * p_h2) % ZP) * g,
         g_hat),
        (g, c_hat),
        (-(proof.pi_kzg), gh[1] + (-(z % ZP)) * g_hat),
    ])
