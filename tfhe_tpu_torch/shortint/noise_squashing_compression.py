"""Compression of noise-squashed (u128) ciphertexts into packed GLWE lists.

Torch counterpart of ``tfhe_tpu/shortint/noise_squashing_compression.py``
(reference ``shortint/list_compression/noise_squashing_compression.rs``:
``compress_noise_squashed_ciphertexts_into_list``, and the key types of
``list_compression/{private_key,server_keys}.rs``). Unlike the u64 list
compression, a packed ciphertext is extracted WITHOUT a PBS (a plain
sample extraction), because the squashed torus has enough noise headroom;
the storage modulus stays the full native u128.

The packing keyswitch is an exact CRT-NTT convolution on the key's
device: digit polynomials (one nonzero coefficient per packed LWE) are
forward-transformed once and MAC'd against the packing key's u128
residues, a prime at a time, and the 128-bit result is reconstructed by
the Garner path of the u128 PBS (``core/squash.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from .._torus import from_u64
from ..core import squash as sq
from ..ops import ntt as ntt_mod
from ..utils.params import NoiseSquashingCompressionParameters
from .client_key import ClientKey
from .noise_squashing import NoiseSquashingPrivateKey, SquashedNoiseCiphertext


@dataclass
class NoiseSquashingCompressionPrivateKey:
    """GLWE secret key of the packed domain (private_key.rs:308)."""

    glwe_sk: sq.GlweSecretKey128
    params: NoiseSquashingCompressionParameters

    @classmethod
    def generate(cls, client_key: ClientKey,
                 params: NoiseSquashingCompressionParameters
                 ) -> "NoiseSquashingCompressionPrivateKey":
        """From the client key's keygen stream, on its device."""
        k = params.packing_ks_glwe_dimension
        N = params.packing_ks_polynomial_size
        bits = client_key._keygen_gen.mask.uniform_binary(k * N)
        return cls(glwe_sk=sq.GlweSecretKey128(
            bits=from_u64(bits.reshape(k, N), client_key.device)),
            params=params)

    def private_key_view(self) -> NoiseSquashingPrivateKey:
        """Decryption view (reference private_key.rs:100 From impl)."""
        return NoiseSquashingPrivateKey(glwe_sk=self.glwe_sk, params=None)

    def decrypt(self, ct: SquashedNoiseCiphertext) -> list:
        return self.private_key_view().decrypt(ct)


@dataclass
class NoiseSquashingCompressionKey:
    """u128 packing keyswitch key in NTT residue form (server_keys.rs:271):
    ``pksk_hat`` int32 (u32) [P, n_in, l, R_c, N_c], the residues of
    GLWE_enc128(s_j * 2^(128 - b*level)) under the compression GLWE key,
    on the client key's device."""

    pksk_hat: torch.Tensor
    params: NoiseSquashingCompressionParameters
    num_primes: int
    in_dim: int

    @classmethod
    def generate(cls, client_key: ClientKey,
                 squash_private_key: NoiseSquashingPrivateKey,
                 comp_private_key: NoiseSquashingCompressionPrivateKey
                 ) -> "NoiseSquashingCompressionKey":
        cp = comp_private_key.params
        N_c = cp.packing_ks_polynomial_size
        R_c = cp.packing_ks_glwe_dimension + 1
        l, b = cp.packing_ks_level, cp.packing_ks_base_log
        in_bits = squash_private_key.glwe_sk.as_lwe_bits()
        n_in = in_bits.shape[0]
        dev = comp_private_key.glwe_sk.bits.device
        # plaintexts s_j * 2^(128 - b*level) as (hi, lo) pairs, message in
        # coefficient 0 (lwe_packing_keyswitch_key_generation.rs)
        pts_hi = torch.zeros((n_in, l, N_c), dtype=torch.int64, device=dev)
        pts_lo = torch.zeros_like(pts_hi)
        for lev_idx in range(l):
            shift = 128 - b * (l - lev_idx)
            if shift >= 64:
                pts_hi[:, lev_idx, 0] = in_bits.to(dev) << (shift - 64)
            else:
                pts_lo[:, lev_idx, 0] = in_bits.to(dev) << shift
        hi, lo = sq.glwe_encrypt128(
            comp_private_key.glwe_sk, pts_hi.reshape(-1, N_c),
            pts_lo.reshape(-1, N_c), cp.packing_ks_key_noise_distribution,
            client_key._keygen_gen)
        # exactness budget: signed digits (< 2^(b-1)) x u128 coefficients,
        # n_in*l accumulated negacyclic products
        bound = ntt_mod.polymul_bound_bits(b, N_c, num_sums=n_in * l,
                                           torus_bits=128)
        npr = ntt_mod.min_primes_for_bound(float(bound))
        pksk_hat = sq.key_residues128(hi.reshape(n_in, l, R_c, N_c),
                                      lo.reshape(n_in, l, R_c, N_c),
                                      ntt_mod.get_plan(N_c, npr))
        return cls(pksk_hat=pksk_hat, params=cp, num_primes=npr, in_dim=n_in)


@dataclass
class CompressedSquashedNoiseCiphertextList:
    """Packed GLWE list at full u128 precision (ciphertext/squashed_noise.rs
    CompressedSquashedNoiseCiphertextList): (hi, lo) int64 (u64)
    [n_glwe, R_c, N_c]."""

    glwe_hi: torch.Tensor
    glwe_lo: torch.Tensor
    count: int
    message_modulus: int
    carry_modulus: int
    params: NoiseSquashingCompressionParameters
    degrees: Optional[List[int]] = None

    def __len__(self) -> int:
        return self.count

    def unpack(self, index: int) -> SquashedNoiseCiphertext:
        """Extract one squashed LWE, no PBS needed (the reference's
        SquashedNoiseCiphertextList::unpack path), with the exact 128-bit
        extraction (``core/squash.py::sample_extract128``)."""
        if not 0 <= index < self.count:
            raise IndexError(f"index {index} out of a list of {self.count}")
        per = min(self.params.lwe_per_glwe,
                  self.params.packing_ks_polynomial_size)
        gidx, nth = divmod(index, per)
        hi, lo = sq.sample_extract128(self.glwe_hi[gidx], self.glwe_lo[gidx],
                                      nth)
        degree = (self.degrees[index] if self.degrees is not None
                  else self.message_modulus * self.carry_modulus - 1)
        return SquashedNoiseCiphertext(
            hi=hi, lo=lo, degree=degree,
            message_modulus=self.message_modulus,
            carry_modulus=self.carry_modulus)


def _packing_mac(key: NoiseSquashingCompressionKey, chi: torch.Tensor,
                 clo: torch.Tensor, plan: ntt_mod.NegacyclicNtt):
    """The packing keyswitch's MAC for one GLWE of B <= N_c LWEs (hi, lo)
    [B, n_in+1]: sum_j D_j(X) * KSK_j with D_j holding LWE b's digit of
    mask coefficient j at X^b, as (hi, lo) [R_c, N_c]. Each prime's
    products are built and summed on their own."""
    cp = key.params
    N_c, l = cp.packing_ks_polynomial_size, cp.packing_ks_level
    n_in, B = key.in_dim, chi.shape[0]
    digits = sq.decompose128(chi[:, :n_in], clo[:, :n_in],
                             cp.packing_ks_base_log, l)  # [B, n_in, l]
    polys = torch.zeros((n_in, l, N_c), dtype=torch.int64, device=chi.device)
    polys[:, :, :B] = digits.permute(1, 2, 0)
    # base-2^61 digits exceed the primes by ~2^30: a full remainder first
    dhat = plan.fwd_signed(polys)  # [P, n_in, l, N_c]
    acc = torch.stack([
        ((dhat[i][..., None, :] * key.pksk_hat[i].to(torch.int64)) % p)
        .sum(dim=(0, 1)) % p
        for i, p in enumerate(plan.primes)])  # [P, R_c, N_c]
    return sq._reconstruct128(plan, plan.inv(acc))


def compress_noise_squashed_ciphertexts_into_list(
        key: NoiseSquashingCompressionKey,
        ciphertexts: List[SquashedNoiseCiphertext]
) -> CompressedSquashedNoiseCiphertextList:
    """Pack squashed LWEs into GLWEs with the u128 packing keyswitch
    (noise_squashing_compression.rs:23-120), on the key's device; a
    batched ciphertext contributes each of its rows."""
    cp = key.params
    N_c = cp.packing_ks_polynomial_size
    R_c = cp.packing_ks_glwe_dimension + 1
    per = min(cp.lwe_per_glwe, N_c)
    dev = key.pksk_hat.device
    plan = ntt_mod.get_plan(N_c, key.num_primes)
    n_in = key.in_dim
    his, los, degrees = [], [], []
    for ct in ciphertexts:
        if ct.hi.shape[-1] != n_in + 1:
            raise ValueError("ciphertext lwe size does not match the packing "
                             "keyswitch key")
        if (ct.message_modulus, ct.carry_modulus) != (cp.message_modulus,
                                                      cp.carry_modulus):
            raise ValueError("ciphertext moduli differ from the compression "
                             "parameters'")
        hi2 = ct.hi.reshape(-1, n_in + 1).to(dev)
        his.append(hi2)
        los.append(ct.lo.reshape(-1, n_in + 1).to(dev))
        degrees.extend([ct.degree] * hi2.shape[0])
    count = len(degrees)
    n_glwe = -(-count // per)
    out_hi = torch.zeros((n_glwe, R_c, N_c), dtype=torch.int64, device=dev)
    out_lo = torch.zeros_like(out_hi)
    if count:
        hi_all, lo_all = torch.cat(his), torch.cat(los)
    for gidx in range(n_glwe):
        chi = hi_all[gidx * per:(gidx + 1) * per]
        clo = lo_all[gidx * per:(gidx + 1) * per]
        B = chi.shape[0]
        mac_hi, mac_lo = _packing_mac(key, chi, clo, plan)
        body_hi = torch.zeros((R_c, N_c), dtype=torch.int64, device=dev)
        body_lo = torch.zeros_like(body_hi)
        body_hi[R_c - 1, :B] = chi[:, n_in]
        body_lo[R_c - 1, :B] = clo[:, n_in]
        out_hi[gidx], out_lo[gidx] = sq.sub128(body_hi, body_lo, mac_hi,
                                               mac_lo)
    return CompressedSquashedNoiseCiphertextList(
        glwe_hi=out_hi, glwe_lo=out_lo, count=count,
        message_modulus=cp.message_modulus, carry_modulus=cp.carry_modulus,
        params=cp, degrees=degrees if count else None)
