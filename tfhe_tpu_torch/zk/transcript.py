"""pke_v2 Fiat-Shamir transcript with the reference's sha3 framing.

Byte-for-byte mirror of ``tfhe-zk-pok/src/proofs/pke_v2/hashes.rs`` (the
RHash -> PhiHash -> XiHash -> YHash -> THash -> ThetaHash -> OmegaHash ->
DeltaHash -> ZHash -> chi typestate chain) and of the byte encodings the
Rust side hashes (``curve_api/bls12_446.rs``):

- field elements are hashed as their MONTGOMERY limb bytes: a scalar x
  enters the transcript as (x * 2^320 mod r) in 40 LE bytes
  (``Zp::to_le_bytes``, arkworks ``Fp.0.0`` limbs); an Fq coordinate as
  (x * 2^448 mod p) in 56 LE bytes;
- a G1 point as mont(x) || mont(y) || infinity_u8 = 113 bytes, a G2 point
  as mont(x.c0) || mont(x.c1) || mont(y.c0) || mont(y.c1) || infinity_u8
  = 225 bytes (``G1::to_le_bytes``/``G2::to_le_bytes``);
- scalars are derived from shake256 as 56-byte reads with the top limb
  masked to 42 bits, then multiplied by 2^-128 mod r (``Zp::hash`` /
  ``from_raw_u64x7``'s REDC over 2 limbs); 128-bit scalars read 16 bytes
  (``Zp::hash_128bit``);
- the R matrix is a shake256 XOF stream mapped two bits at a time to
  {0,1 -> 0; 2 -> +1; 3 -> -1} (hashes.rs:432-459), encoded for hashing
  in base-3 groups of five (``encode_R``, Compact mode);
- the statement bytes (x_bytes) are q || d || [k] || bound || t ||
  proven-zero-bits || a || b || c1 || c2, all LE u64 (RHash::new);
- hash config V0_8_0 (the reference default): Compact mode (only the
  first scalar is hashed; the vector is its power sequence), AnyBitAnySlot
  zero-bit encoding, InfinityNorm bound, hash_k=true.

The domain separators are 8-byte strings drawn from the CRS RNG in the
reference (``ShortPKEv2DomainSeparators``, HASH_DS_LEN_BYTES=8); their
VALUES are CRS-specific there, so this module takes them as input and
``separators_from_crs_ds`` derives a deterministic set from our CRS's
serialized ``ds`` field. Given equal separator/sid/commitment bytes, the
scalars produced here equal the reference's.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Sequence

from .curve import P as _FQ_P
from .curve import R as _ZP

_R_MONT = 1 << 320          # arkworks Montgomery R for the 5-limb scalar field
_Q_MONT = 1 << 448          # ... for the 7-limb base field
_INV_2_128 = pow(1 << 128, -1, _ZP)
_MASK_426 = (1 << 426) - 1  # 7 limbs with the top limb masked to 42 bits

DS_NAMES = ("hash", "hash_R", "hash_t", "hash_w", "hash_agg", "hash_lmap",
            "hash_phi", "hash_xi", "hash_z", "hash_chi", "hash_gamma")


@dataclass(frozen=True)
class DomainSeparators:
    """The 11 8-byte separators of ShortPKEv2DomainSeparators."""

    hash: bytes
    hash_R: bytes
    hash_t: bytes
    hash_w: bytes
    hash_agg: bytes
    hash_lmap: bytes
    hash_phi: bytes
    hash_xi: bytes
    hash_z: bytes
    hash_chi: bytes
    hash_gamma: bytes


def separators_from_crs_ds(ds: bytes) -> DomainSeparators:
    """Deterministic separator set from our CRS's stored ``ds`` bytes (the
    reference draws them from its CRS rng; equal-value interop therefore
    requires importing the reference CRS's separators — this derivation
    covers self-generated CRS)."""
    h = hashlib.shake_256(b"pkev2-ds" + ds).digest(8 * len(DS_NAMES))
    return DomainSeparators(**{
        name: h[i * 8:(i + 1) * 8] for i, name in enumerate(DS_NAMES)})


# ---------------------------------------------------------------------------
# byte encodings (curve_api/bls12_446.rs)
# ---------------------------------------------------------------------------

def zp_bytes(x: int) -> bytes:
    """Zp::to_le_bytes — Montgomery limbs, 40 LE bytes."""
    return (x % _ZP * _R_MONT % _ZP).to_bytes(40, "little")


def _fq_mont_bytes(x: int) -> bytes:
    return (x % _FQ_P * _Q_MONT % _FQ_P).to_bytes(56, "little")


def g1_bytes(p) -> bytes:
    """G1::to_le_bytes: mont(x) || mont(y) || infinity (113 bytes).
    The arkworks affine zero is (0, 1, infinity=true)."""
    if p.pt is None:
        return _fq_mont_bytes(0) + _fq_mont_bytes(1) + b"\x01"
    x, y = p.pt
    return _fq_mont_bytes(x) + _fq_mont_bytes(y) + b"\x00"


def g2_bytes(p) -> bytes:
    """G2::to_le_bytes (225 bytes)."""
    if p.pt is None:
        return (_fq_mont_bytes(0) + _fq_mont_bytes(0)
                + _fq_mont_bytes(1) + _fq_mont_bytes(0) + b"\x01")
    (x0, x1), (y0, y1) = p.pt
    return (_fq_mont_bytes(x0) + _fq_mont_bytes(x1)
            + _fq_mont_bytes(y0) + _fq_mont_bytes(y1) + b"\x00")


# ---------------------------------------------------------------------------
# scalar derivation (Zp::hash / Zp::hash_128bit)
# ---------------------------------------------------------------------------

def _shake(inputs: Sequence[bytes]) -> "hashlib._Hash":
    h = hashlib.shake_256()
    for part in inputs:
        h.update(part)
    return h


def zp_hash(inputs: Sequence[bytes], count: int) -> List[int]:
    """count scalars: 56-byte XOF reads, top limb masked to 42 bits,
    times 2^-128 mod r (from_raw_u64x7's 2-limb REDC)."""
    stream = _shake(inputs).digest(56 * count)
    out = []
    for i in range(count):
        u = int.from_bytes(stream[i * 56:(i + 1) * 56], "little") & _MASK_426
        out.append(u * _INV_2_128 % _ZP)
    return out


def zp_hash_128(inputs: Sequence[bytes], count: int) -> List[int]:
    """count 128-bit scalars (16-byte reads, no reduction needed)."""
    stream = _shake(inputs).digest(16 * count)
    return [int.from_bytes(stream[i * 16:(i + 1) * 16], "little")
            for i in range(count)]


def gen_scalars_compact(inputs: Sequence[bytes], count: int):
    """PkeV2HashMode::Compact gen_scalars: derive scalar1 only, expand to
    [1, s, s^2, ...]; the byte representation re-hashed downstream is
    scalar1's Montgomery bytes."""
    (s1,) = zp_hash(inputs, 1)
    out = [1] * count
    cur = s1
    for j in range(1, count):
        out[j] = cur
        cur = cur * s1 % _ZP
    return out, zp_bytes(s1)


def gen_scalars_classical(inputs: Sequence[bytes], count: int):
    vals = zp_hash(inputs, count)
    return vals, b"".join(zp_bytes(v) for v in vals)


# ---------------------------------------------------------------------------
# statement bytes + zero-bit / R encodings (hashes.rs)
# ---------------------------------------------------------------------------

def encode_proven_zero_bits_anybit_anyslot(msb_zero_padding_bit_count: int,
                                           t: int, k: int) -> bytes:
    """hashes.rs:170-225 — the base value (t_log2 - pad zero-able bits of
    ones) repeated k times, bit-packed lsb-to-msb. Cross-checked against
    the reference's own unit test vectors."""
    t_log2 = t.bit_length() - 1
    assert msb_zero_padding_bit_count <= t_log2
    eff = t_log2 - msb_zero_padding_bit_count
    encoded_base = (1 << 64) - 1 if eff == 64 else (1 << eff) - 1
    packed = bytearray()
    bit_buffer = 0
    bits_in_buffer = 0
    for _ in range(k):
        bit_buffer |= encoded_base << bits_in_buffer
        bits_in_buffer += t_log2
        while bits_in_buffer >= 8:
            packed.append(bit_buffer & 0xFF)
            bit_buffer >>= 8
            bits_in_buffer -= 8
    if bits_in_buffer:
        packed.append(bit_buffer & 0xFF)
    return bytes(packed)


def statement_bytes(q: int, d: int, k: int, b_inf: int, t: int,
                    msbs_zero_padding_bit_count: int,
                    a, b, c1, c2) -> bytes:
    """RHash::new x_bytes for config V0_8_0 (hash_k=true, InfinityNorm
    bound, AnyBitAnySlot zero bits); all integers LE u64."""
    zero_bits = encode_proven_zero_bits_anybit_anyslot(
        msbs_zero_padding_bit_count, t, k)

    def u64s(vals):
        return b"".join((int(v) & ((1 << 64) - 1)).to_bytes(8, "little")
                        for v in vals)

    return (
        (q & ((1 << 64) - 1)).to_bytes(8, "little")
        + d.to_bytes(8, "little")
        + k.to_bytes(8, "little")
        + (b_inf & ((1 << 64) - 1)).to_bytes(8, "little")
        + t.to_bytes(8, "little")
        + zero_bits
        + u64s(a) + u64s(b) + u64s(c1) + u64s(c2)
    )


def gen_R(inputs: Sequence[bytes], rows: int, cols: int) -> List[int]:
    """The ternary R matrix from a shake256 XOF: one byte per entry, two
    bits mapped {0,1 -> 0; 2 -> 1; 3 -> -1} (hashes.rs:432-459).
    Layout R[i + j*128] — returned flat in that indexing."""
    stream = _shake(inputs).digest(rows * cols)
    out = []
    for byte in stream:
        b2 = byte & 0b11
        out.append(0 if b2 < 2 else (1 if b2 == 2 else -1))
    return out


def encode_R_compact(R: Sequence[int]) -> bytes:
    """Compact/Classical encode_R: ternary values packed five per byte in
    base 3 (value+1 digits, little-endian powers)."""
    packed = bytearray()
    for i in range(0, len(R), 5):
        chunk = R[i:i + 5]
        val = 0
        p3 = 1
        for v in chunk:
            val += (v + 1) * p3
            p3 *= 3
        packed.append(val)
    return bytes(packed)


# ---------------------------------------------------------------------------
# the chained transcript (Compact mode, config V0_8_0)
# ---------------------------------------------------------------------------

class PkeV2Transcript:
    """Stateful mirror of the hashes.rs typestate chain for Compact mode.

    Construct with the domain separators, sid bytes, metadata and x_bytes,
    then call the gen_* methods in the proof order, passing each new
    commitment's bytes; each call returns the scalars and updates the
    hashed state exactly as the corresponding Rust impl does."""

    def __init__(self, ds: DomainSeparators, sid_bytes: bytes,
                 metadata: bytes, x_bytes: bytes, D: int, m: int, n: int,
                 k: int, d: int):
        self.ds = ds
        self.sid = sid_bytes
        self.metadata = metadata
        self.x = x_bytes
        self.D, self.m, self.n, self.k, self.d = D, m, n, k, d
        self.Chat_e = self.C_e = self.C_r_tilde = b""
        self.R_bytes = b""
        self.phi_b = self.xi_b = self.y_b = self.t_b = b""
        self.theta_b = self.omega_b = self.delta_b = self.z_b = b""
        self.C_R = self.C_hat_bin = self.C_y = b""

    # -- R ---------------------------------------------------------------
    def gen_R(self, C_hat_e: bytes, C_e: bytes, C_r_tilde: bytes):
        self.Chat_e, self.C_e, self.C_r_tilde = C_hat_e, C_e, C_r_tilde
        R = gen_R([self.ds.hash_R, self.sid, self.metadata, self.x,
                   C_hat_e, C_e, C_r_tilde],
                  128, 2 * (self.d + self.k) + 4)
        self.R_bytes = encode_R_compact(R)
        return R

    # -- phi -------------------------------------------------------------
    def gen_phi(self, C_R: bytes):
        self.C_R = C_R
        phi, self.phi_b = gen_scalars_compact(
            [self.ds.hash_phi, self.sid, self.metadata, self.x,
             self.R_bytes, self.Chat_e, self.C_e, C_R, self.C_r_tilde],
            128)
        return phi

    # -- xi (R replaced by b"" in Compact) -------------------------------
    def gen_xi(self, C_hat_bin: bytes):
        self.C_hat_bin = C_hat_bin
        xi, self.xi_b = gen_scalars_compact(
            [self.ds.hash_xi, self.sid, self.metadata, self.x,
             self.Chat_e, self.C_e, b"", self.phi_b, self.C_R,
             C_hat_bin, self.C_r_tilde],
            128)
        return xi

    # -- y ---------------------------------------------------------------
    def gen_y(self):
        y, self.y_b = gen_scalars_compact(
            [self.ds.hash, self.sid, self.metadata, self.x, b"",
             self.phi_b, self.xi_b, self.Chat_e, self.C_e, self.C_R,
             self.C_hat_bin, self.C_r_tilde],
            self.D + 128 * self.m)
        return y

    # -- t ---------------------------------------------------------------
    def gen_t(self, C_y: bytes):
        self.C_y = C_y
        t, self.t_b = gen_scalars_compact(
            [self.ds.hash_t, self.sid, self.metadata, self.x, self.y_b,
             self.phi_b, self.xi_b, self.Chat_e, self.C_e, b"",
             self.C_R, self.C_hat_bin, self.C_r_tilde, C_y],
            self.n)
        return t

    # -- theta (lmap) ----------------------------------------------------
    def gen_theta(self):
        theta, self.theta_b = gen_scalars_compact(
            [self.ds.hash_lmap, self.sid, self.metadata, self.x, self.y_b,
             self.t_b, self.phi_b, self.xi_b, self.Chat_e, self.C_e,
             b"", self.C_R, self.C_hat_bin, self.C_r_tilde, self.C_y],
            self.d + self.k)
        return theta

    # -- omega (w) -------------------------------------------------------
    def gen_omega(self):
        omega, self.omega_b = gen_scalars_compact(
            [self.ds.hash_w, self.sid, self.metadata, self.x, self.y_b,
             self.t_b, self.phi_b, self.xi_b, self.theta_b, self.Chat_e,
             self.C_e, b"", self.C_R, self.C_hat_bin, self.C_r_tilde,
             self.C_y],
            self.n)
        return omega

    # -- delta (agg; never compact) --------------------------------------
    def gen_delta(self):
        delta = zp_hash(
            [self.ds.hash_agg, self.sid, self.metadata, self.x, self.y_b,
             self.t_b, self.phi_b, self.xi_b, self.theta_b, self.omega_b,
             self.Chat_e, self.C_e, b"", self.C_R, self.C_hat_bin,
             self.C_r_tilde, self.C_y],
            7)
        self.delta_b = b"".join(zp_bytes(v) for v in delta)
        return delta

    # -- z ---------------------------------------------------------------
    def gen_z(self, C_h1: bytes, C_h2: bytes, C_hat_t: bytes,
              C_hat_h3: bytes, C_hat_omega: bytes):
        self._z_comms = (C_h1, C_h2, C_hat_t, C_hat_h3, C_hat_omega)
        (z,) = zp_hash(
            [self.ds.hash_z, self.sid, self.metadata, self.x, self.y_b,
             self.t_b, self.phi_b, self.xi_b, self.theta_b, self.omega_b,
             self.delta_b, self.Chat_e, self.C_e, b"", self.C_R,
             self.C_hat_bin, self.C_r_tilde, self.C_y,
             C_h1, C_h2, C_hat_t, C_hat_h3, C_hat_omega],
            1)
        self.z_b = zp_bytes(z)
        return z

    # -- chi -------------------------------------------------------------
    def gen_chi(self, p_h1: int, p_h2: int, p_t: int,
                p_h3=None, p_omega=None) -> int:
        C_h1, C_h2, C_hat_t, C_hat_h3, C_hat_omega = self._z_comms
        (chi,) = zp_hash(
            [self.ds.hash_chi, self.sid, self.metadata, self.x, self.y_b,
             self.t_b, self.phi_b, self.xi_b, self.theta_b, self.omega_b,
             self.delta_b, self.Chat_e, self.C_e, b"", self.C_R,
             self.C_hat_bin, self.C_r_tilde, self.C_y,
             C_h1, C_h2, C_hat_t, C_hat_h3, C_hat_omega, self.z_b,
             zp_bytes(p_h1), zp_bytes(p_h2), zp_bytes(p_t),
             b"" if p_h3 is None else zp_bytes(p_h3),
             b"" if p_omega is None else zp_bytes(p_omega)],
            1)
        return chi
