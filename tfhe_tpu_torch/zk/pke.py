"""Proof of knowledge for compact-public-key LWE encryption (pke v1).

Re-implements the algebra of the reference ``tfhe-zk-pok/src/proofs/pke.rs``
(scheme of Libert's "vector commitments"-style PKE proof): the prover shows
knowledge of (r, e1, m, e2) with

    c1 = rot(a) . bar(r) + e1          (mod q)
    c2_i = <phi_{d-1-i}(b), bar(r)> + delta m_i + e2_i   (mod q)

with r binary and e1/e2/m range-bounded, by bit-committing the witness
vector w (r reversed, m digits, e1, e2, r1, r2 two's-complement digits)
under a structured (powers-of-alpha with a gap) BLS12-446 CRS and proving
one aggregated polynomial identity with three pairings.

Matches the reference layout: CRS ``GroupElements::new`` (g_list[j] =
alpha^j G, j=1..2n, with the n+1 slot zeroed; g_hat_list[i] = alpha^i
G_hat, i=1..n), witness bit order and two's-complement digit signs of
``compute_a_theta`` (pke.rs:935-1050), r1/r2 exact-division residuals
(proofs/mod.rs:196-270), and the ComputeLoad::Verify pairing equation
(pke.rs:1311-1352). Fiat-Shamir uses SHAKE-256 over the same transcript
fields (byte-for-byte transcript compat with the Rust sha3 construction is
not a goal; the binding structure is).

Host-side pure Python: proofs guard data ingress, they are not GPU work.
Dimensions are free parameters; tests run reduced sizes (the reference's
d=1024/k=320 takes minutes in pure Python but is the same code path).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from .curve import (G1, G2, R, fixed_base_powers, msm as curve_msm,
                    pairing_product_is_one)

_MASK64 = (1 << 64) - 1


def _i64(x: int) -> int:
    """Wrap to signed 64-bit."""
    x &= _MASK64
    return x - (1 << 64) if x >= (1 << 63) else x


def _u64(x: int) -> int:
    return x & _MASK64


def _zp(x: int) -> int:
    """Zp::from_i64 — signed into the scalar field."""
    return x % R


def _ilog2(x: int) -> int:
    return x.bit_length() - 1


def _bits(x: int, nbits: int):
    """LSB-first bits of the u64 two's-complement representation."""
    x = _u64(x)
    return [(x >> i) & 1 for i in range(nbits)]


# ---------------------------------------------------------------------------
# Fiat-Shamir (SHAKE-256)
# ---------------------------------------------------------------------------

def _hash_to_scalars(tag: bytes, chunks: Sequence[bytes], count: int) -> List[int]:
    h = hashlib.shake_256()
    h.update(tag)
    for c in chunks:
        h.update(len(c).to_bytes(8, "little"))
        h.update(c)
    raw = h.digest(count * 64)
    return [
        int.from_bytes(raw[i * 64 : (i + 1) * 64], "little") % R
        for i in range(count)
    ]


def _hash_to_128bit(tag: bytes, chunks: Sequence[bytes], count: int) -> List[int]:
    h = hashlib.shake_256()
    h.update(tag)
    for c in chunks:
        h.update(len(c).to_bytes(8, "little"))
        h.update(c)
    raw = h.digest(count * 16)
    return [
        int.from_bytes(raw[i * 16 : (i + 1) * 16], "little") for i in range(count)
    ]


def _ints_bytes(vals: Sequence[int]) -> bytes:
    return b"".join(_u64(v).to_bytes(8, "little") for v in vals)


def _scalars_bytes(vals: Sequence[int]) -> bytes:
    return b"".join((v % R).to_bytes(40, "little") for v in vals)


# ---------------------------------------------------------------------------
# CRS
# ---------------------------------------------------------------------------

def compute_crs_params(d: int, k: int, b: int, t: int, pad_bits: int):
    """pke.rs:472-492."""
    b_r = d // 2 + 1
    t_eff = t >> pad_bits
    big_d = d + k * _ilog2(t_eff) + (d + k) * (2 + _ilog2(b) + _ilog2(b_r))
    n = big_d + 1
    return n, big_d, b_r


@dataclass
class PkeCrs:
    """Public parameters: the structured group-element lists plus the
    LWE statement shape. ``g_list[j] = alpha^j G`` (1-based, j = n+1
    zeroed), ``g_hat_list[i] = alpha^i G_hat``."""

    d: int
    k: int
    b: int
    q: int  # 0 encodes 2^64
    t: int
    pad_bits: int
    n: int = 0
    big_d: int = 0
    b_r: int = 0
    g_list: List[G1] = field(default_factory=list)
    g_hat_list: List[G2] = field(default_factory=list)
    sid: int = 0
    ds: bytes = b""  # domain-separator root

    @property
    def decoded_q(self) -> int:
        return (1 << 64) if self.q == 0 else self.q

    @property
    def delta(self) -> int:
        return self.decoded_q // self.t

    @property
    def t_eff(self) -> int:
        return self.t >> self.pad_bits

    def big_d_for(self, k: int) -> int:
        """Effective witness size for a statement with k <= self.k messages
        (the reference recomputes this per proof, pke.rs:602-607)."""
        return (self.d + k * _ilog2(self.t_eff)
                + (self.d + k) * (2 + _ilog2(self.b) + _ilog2(self.b_r)))

    @classmethod
    def generate(cls, d: int, k: int, b: int, q: int, t: int,
                 pad_bits: int, seed: int = 0) -> "PkeCrs":
        n, big_d, b_r = compute_crs_params(d, k, b, t, pad_bits)
        root = hashlib.shake_256(b"tfhe-tpu-crs" + seed.to_bytes(8, "little"))
        alpha = int.from_bytes(root.digest(80)[:64], "little") % R
        crs = cls(d=d, k=k, b=b, q=q, t=t, pad_bits=pad_bits,
                  n=n, big_d=big_d, b_r=b_r)
        # 1-based; the n+1 "gap" slot holds the identity (pke.rs:91);
        # windowed fixed-base tables (curve.fixed_base_powers) — the naive
        # per-power double-and-add took minutes at production dimensions
        crs.g_list = [G1.zero()] + fixed_base_powers(
            G1, alpha, 2 * n, skip=frozenset((n + 1,)))
        crs.g_hat_list = [G2.zero()] + fixed_base_powers(G2, alpha, n)
        crs.sid = int.from_bytes(root.digest(96)[80:88], "little")
        crs.ds = root.digest(128)[96:]
        return crs

    def tag(self, name: bytes) -> bytes:
        return self.ds + name


# ---------------------------------------------------------------------------
# residuals r1/r2 (proofs/mod.rs:196-270) — exact division by q
# ---------------------------------------------------------------------------

def _compute_r1(e1, c1, a, r, d, q):
    r1 = [e1[i] - c1[i] for i in range(d)]
    for i in range(d):
        for j in range(d):
            prod = a[i] * r[d - j - 1]
            if i + j < d:
                r1[i + j] += prod
            else:
                r1[i + j - d] -= prod
    assert all(v % q == 0 for v in r1), "statement does not hold"
    return [v // q for v in r1]


def _compute_r2(e2, c2, m, b, r, d, delta, q):
    out = []
    for i in range(len(c2)):
        v = delta * m[i] + e2[i] - c2[i]
        for j in range(d):
            bj = b[d - j - i - 1] if i + j < d else -b[2 * d - j - i - 1]
            v += r[d - j - 1] * bj
        assert v % q == 0, "statement does not hold"
        out.append(v // q)
    return out


# ---------------------------------------------------------------------------
# a_theta = A~.T theta  (pke.rs:935-1050, incl. two's-complement signs)
# ---------------------------------------------------------------------------

def _compute_a_theta(crs: PkeCrs, theta0, a, b_poly, k):
    d, t_eff, delta = crs.d, crs.t_eff, crs.delta
    qz = _zp(crs.decoded_q)
    theta1, theta2 = theta0[:d], theta0[d:]
    az = [_zp(x) for x in a]
    bz = [_zp(x) for x in b_poly]
    out = []
    for i in range(d):  # rot(a).T theta1 + shifted-b theta2 block
        dot = 0
        for j in range(d):
            if i <= j:
                dot += az[j - i] * theta1[j]
            else:
                dot -= az[d + j - i] * theta1[j]
        for j in range(k):
            if i + j < d:
                dot += bz[d - i - j - 1] * theta2[j]
            else:
                dot -= bz[2 * d - i - j - 1] * theta2[j]
        out.append(dot % R)
    step = _ilog2(t_eff)
    for i in range(k):  # delta * g[log t].T theta2_i
        for j in range(step):
            out.append((delta * (1 << j)) % R * theta2[i] % R)
    step = 1 + _ilog2(crs.b)
    for theta, cnt in ((theta1, d), (theta2, k)):  # e1 then e2 digits
        for i in range(cnt):
            for j in range(step):
                v = (1 << j) * theta[i] % R
                out.append((-v) % R if j == step - 1 else v)
    step = 1 + _ilog2(crs.b_r)
    for theta, cnt in ((theta1, d), (theta2, k)):  # r1 then r2 digits, x -q
        for i in range(cnt):
            for j in range(step):
                v = (-qz) * (1 << j) % R * theta[i] % R
                out.append((-v) % R if j == step - 1 else v)
    assert len(out) == crs.big_d_for(k)
    return out


# ---------------------------------------------------------------------------
# proof object + prove/verify
# ---------------------------------------------------------------------------

@dataclass
class PkeProof:
    c_hat: G2
    c_y: G1
    pi: G1

    def to_bytes(self) -> bytes:
        return self.c_hat.to_bytes() + self.c_y.to_bytes() + self.pi.to_bytes()


def _msm_g1(points: Sequence[G1], scalars: Sequence[int]) -> G1:
    """Pippenger bucket MSM (curve.msm); was a per-term double-and-add."""
    points = list(points)
    if not points:
        return G1.zero()
    return curve_msm((s, p) for p, s in zip(points, scalars))


def _poly_mul_mod(a: Sequence[int], b: Sequence[int], m: int = R):
    """Polynomial product over Z_m via Kronecker substitution: coefficients
    are packed into one big integer at a spacing wide enough that no column
    sum can carry, multiplied with Python's native (subquadratic) bigint
    multiply, and unpacked. Exact for any coefficients; the O(n^2) Python
    schoolbook loop this replaces dominated prove/verify at production
    dimensions (n ~ 5000 -> ~27M interpreted iterations per product)."""
    la, lb = len(a), len(b)
    if not la or not lb:
        return []
    if min(la, lb) <= 24:
        out = [0] * (la + lb - 1)
        for i, ai in enumerate(a):
            if ai:
                for j, bj in enumerate(b):
                    if bj:
                        out[i + j] += ai * bj
        return [x % m for x in out]
    need = 2 * m.bit_length() + min(la, lb).bit_length()
    S = (need + 7) // 8
    A = int.from_bytes(
        b"".join((x % m).to_bytes(S, "little") for x in a), "little")
    B = int.from_bytes(
        b"".join((x % m).to_bytes(S, "little") for x in b), "little")
    raw = (A * B).to_bytes(S * (la + lb), "little")
    return [int.from_bytes(raw[i * S:(i + 1) * S], "little") % m
            for i in range(la + lb - 1)]


def _witness_bits(crs: PkeCrs, r, m, e1, e2, r1, r2):
    w = []
    for v in reversed(r):
        w += _bits(v, 1)
    for v in m:
        w += _bits(v, _ilog2(crs.t_eff))
    for v in e1:
        w += _bits(v, 1 + _ilog2(crs.b))
    for v in e2:
        w += _bits(v, 1 + _ilog2(crs.b))
    for v in r1:
        w += _bits(v, 1 + _ilog2(crs.b_r))
    for v in r2:
        w += _bits(v, 1 + _ilog2(crs.b_r))
    assert len(w) == crs.big_d_for(len(e2))
    return w


def _x_bytes(crs: PkeCrs, a, b_poly, c1, c2) -> bytes:
    return b"".join([
        _ints_bytes([crs.q, crs.d, crs.b, crs.t, crs.pad_bits]),
        _ints_bytes(a), _ints_bytes(b_poly), _ints_bytes(c1), _ints_bytes(c2),
    ])


def _transcript(crs: PkeCrs, metadata: bytes, xb: bytes, *extra: bytes):
    return [crs.sid.to_bytes(8, "little"), metadata, xb, *extra]


def _challenges(crs: PkeCrs, public, proof_head, metadata: bytes):
    """All Fiat-Shamir values shared by prover and verifier: y, theta,
    a_theta, t, (delta_eq, delta_y), t_theta."""
    a, b_poly, c1, c2 = public
    c_hat, c_y = proof_head
    k = len(c2)
    n = crs.n
    xb = _x_bytes(crs, a, b_poly, c1, c2)
    y = [0] + _hash_to_scalars(
        crs.tag(b"hash"), _transcript(crs, metadata, xb, c_hat.to_bytes()), n
    )
    theta = _hash_to_scalars(
        crs.tag(b"lmap"),
        _transcript(crs, metadata, xb, c_hat.to_bytes(), c_y.to_bytes()),
        crs.d + k + 1,
    )
    theta0, delta_theta = theta[: crs.d + k], theta[crs.d + k]
    a_theta = _compute_a_theta(crs, theta0, a, b_poly, k)
    t_vec = [0] + _hash_to_128bit(
        crs.tag(b"hash_t"),
        _transcript(crs, metadata, _scalars_bytes(y[1:]), xb,
                    c_hat.to_bytes(), c_y.to_bytes()),
        n,
    )
    delta_eq, delta_y = _hash_to_scalars(
        crs.tag(b"agg"),
        _transcript(crs, metadata, xb, c_hat.to_bytes(), c_y.to_bytes()),
        2,
    )
    t_theta = 0
    for i in range(crs.d):
        t_theta += theta0[i] * _zp(c1[i])
    for i in range(k):
        t_theta += theta0[crs.d + i] * _zp(c2[i])
    return y, a_theta, delta_theta, t_vec, delta_eq, delta_y, t_theta % R


def prove(crs: PkeCrs, public, private, metadata: bytes = b"",
          seed: bytes = b"") -> PkeProof:
    """public = (a, b_poly, c1, c2) as i64 lists; private = (r, e1, m, e2).

    Mirrors pke.rs:552-934 with ComputeLoad::Verify (three-element proof).
    """
    a, b_poly, c1, c2 = public
    r, e1, m, e2 = private
    d, k, n = crs.d, len(c2), crs.n
    big_d = crs.big_d_for(k)  # actual witness size for this bin's k
    q = crs.decoded_q

    gamma, gamma_y = _hash_to_scalars(crs.tag(b"gamma"), [seed], 2)
    r1 = _compute_r1(e1, c1, a, r, d, q)
    r2 = _compute_r2(e2, c2, m, b_poly, r, d, crs.delta, q)
    w = _witness_bits(crs, r, m, e1, e2, r1, r2)

    c_hat = gamma * G2.generator()
    for j in range(1, big_d + 1):
        if w[j - 1]:
            c_hat = c_hat + crs.g_hat_list[j]

    xb = _x_bytes(crs, a, b_poly, c1, c2)
    y = [0] + _hash_to_scalars(
        crs.tag(b"hash"), _transcript(crs, metadata, xb, c_hat.to_bytes()), n
    )
    c_y = gamma_y * G1.generator() + _msm_g1(
        [crs.g_list[n + 1 - i] for i in range(1, big_d + 1)],
        [y[i] * w[i - 1] for i in range(1, big_d + 1)],
    )

    (y, a_theta, delta_theta, t_vec, delta_eq, delta_y, t_theta) = _challenges(
        crs, public, (c_hat, c_y), metadata
    )

    # poly = poly_0 * poly_1 - poly_2 * poly_3   (pke.rs:757-800)
    poly_0 = [0] * (n + 1)
    poly_1 = [0] * (big_d + 1)
    poly_2 = [0] * (n + 1)
    poly_3 = [0] * (n + 1)
    poly_0[0] = delta_y * gamma_y % R
    for i in range(1, n + 1):
        v = (delta_y * (y[i] * (w[i - 1] if i <= big_d else 0))
             + (delta_eq * t_vec[i] - delta_y) * y[i])
        if i <= big_d:
            v += delta_theta * a_theta[i - 1]
        poly_0[n + 1 - i] = v % R
    poly_1[0] = gamma
    for i in range(1, big_d + 1):
        poly_1[i] = w[i - 1]
    poly_2[0] = gamma_y
    for i in range(1, big_d + 1):
        poly_2[n + 1 - i] = y[i] * w[i - 1] % R
    for i in range(1, n + 1):
        poly_3[i] = delta_eq * t_vec[i] % R

    # poly_0*poly_1 has degree n+big_d; poly_2*poly_3 reaches 2n
    prod = [0] * (2 * n + 1)
    for i, c in enumerate(_poly_mul_mod(poly_0, poly_1)):
        prod[i] = c
    for i, c in enumerate(_poly_mul_mod(poly_2, poly_3)):
        prod[i] = (prod[i] - c) % R
    if len(prod) > n + 1:
        prod[n + 1] = (prod[n + 1] - t_theta * delta_theta) % R

    pi = prod[0] * G1.generator() + _msm_g1(
        [crs.g_list[j] for j in range(1, len(prod))], prod[1:]
    )
    return PkeProof(c_hat=c_hat, c_y=c_y, pi=pi)


def verify(proof: PkeProof, crs: PkeCrs, public, metadata: bytes = b"") -> bool:
    """ComputeLoad::Verify equation (pke.rs:1311-1352):

    e(pi, g_hat) == e(delta_y c_y + sum_i factor_i g_{n+1-i}, c_hat)
                    / e(c_y, sum_i delta_eq t_i g_hat_i)
                    / e(g_1, g_hat_n)^{t_theta delta_theta}
    """
    a, b_poly, c1, c2 = public
    k, n = len(c2), crs.n
    big_d = crs.big_d_for(k)
    if k > crs.k or big_d > crs.big_d or len(a) != crs.d or len(b_poly) != crs.d:
        return False
    (y, a_theta, delta_theta, t_vec, delta_eq, delta_y, t_theta) = _challenges(
        crs, public, (proof.c_hat, proof.c_y), metadata
    )

    factors = []
    for i in range(1, n + 1):
        f = (delta_eq * t_vec[i] - delta_y) * y[i]
        if i <= big_d:
            f += delta_theta * a_theta[i - 1]
        factors.append(f % R)
    p0 = delta_y * proof.c_y + _msm_g1(
        [crs.g_list[n + 1 - i] for i in range(1, n + 1)], factors
    )
    q1 = curve_msm((delta_eq * t_vec[i], crs.g_hat_list[i])
                   for i in range(1, n + 1))

    # lhs == rhs rewritten as a multi-pairing product check (one shared
    # final exponentiation): e(pi, ghat) * e(-p0, c_hat) * e(c_y, q1)
    # * e((t_theta*delta_theta) g_1, ghat_n) == 1
    return pairing_product_is_one([
        (proof.pi, G2.generator()),
        (-p0, proof.c_hat),
        (proof.c_y, q1),
        ((t_theta * delta_theta % R) * crs.g_list[1], crs.g_hat_list[n]),
    ])
