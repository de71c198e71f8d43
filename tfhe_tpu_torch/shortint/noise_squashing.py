"""Shortint noise squashing: re-encrypt a ciphertext with a 128-bit PBS so
the result carries enough noise headroom for threshold decryption.

Torch counterpart of ``tfhe_tpu/shortint/noise_squashing.py`` (reference
``tfhe/src/shortint/noise_squashing/``: private_key.rs, server_key.rs,
atomic_pattern/standard.rs:63-150, and the PBS-128 plumbing in
``shortint/server_key/mod.rs:1561-1610``). Flow for KS -> PBS keys:

    ct (u64, big key) --KS--> small key --MS--> blind rotation over the
    u128 torus with the squashing BSK and an identity LUT at Delta_128 -->
    sample extract --> SquashedNoiseCiphertext (u128 LWE, degree kept)

The keyswitch is the server key's own (``ServerKey.ks_only``); the
rotation is torch ops on the key's device (``core/squash.py``), as
``tfhe_tpu`` runs it in XLA with no Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._torus import M32, from_u64, srl
from ..core import squash as sq
from ..ops import ntt as ntt_mod
from ..ops import server as server_ops
from ..utils.params import ModulusSwitchType, NoiseSquashingParameters
from .ciphertext import ShortintCiphertext
from .client_key import ClientKey

_MASK128 = (1 << 128) - 1


@dataclass
class SquashedNoiseCiphertext:
    """u128 LWE ciphertext as a (hi, lo) pair of int64 (u64) tensors
    [..., kN+1], plus shortint metadata (reference
    ``shortint/ciphertext/squashed_noise.rs``)."""

    hi: torch.Tensor
    lo: torch.Tensor
    degree: int
    message_modulus: int
    carry_modulus: int


def _limb_sums(limb: torch.Tensor, bits: torch.Tensor) -> list:
    """Per row, the sums of the selected u64 limbs' low and high 32-bit
    halves as python ints (exact: each < n * 2^32)."""
    lo = ((limb & M32) * bits).sum(dim=-1)
    hi = (srl(limb, 32) * bits).sum(dim=-1)
    return list(zip(hi.tolist(), lo.tolist()))


@dataclass
class NoiseSquashingPrivateKey:
    """The u128 GLWE secret key (private_key.rs), drawn from the client
    key's keygen stream so squashing keysets are reproducible."""

    glwe_sk: sq.GlweSecretKey128
    params: NoiseSquashingParameters

    @classmethod
    def generate(cls, client_key: ClientKey,
                 params: NoiseSquashingParameters
                 ) -> "NoiseSquashingPrivateKey":
        """On the client key's device."""
        k, N = params.glwe_dimension, params.polynomial_size
        bits = client_key._keygen_gen.mask.uniform_binary(k * N)
        return cls(glwe_sk=sq.GlweSecretKey128(
            bits=from_u64(bits.reshape(k, N), client_key.device)),
            params=params)

    def decrypt_raw(self, ct: SquashedNoiseCiphertext) -> list:
        """Raw u128 plaintexts b - <a, s> mod 2^128, python ints (exact),
        one per ciphertext."""
        bits = self.glwe_sk.as_lwe_bits()
        n = bits.shape[0]
        hi = ct.hi.to(bits.device).reshape(-1, n + 1)
        lo = ct.lo.to(bits.device).reshape(-1, n + 1)
        out = []
        for (hh, hl), (lh, ll), bh, bl in zip(
                _limb_sums(hi[:, :n], bits), _limb_sums(lo[:, :n], bits),
                hi[:, n].tolist(), lo[:, n].tolist()):
            dot = (hh << 96) + (hl << 64) + (lh << 32) + ll
            out.append(((bh << 64) + (bl & ((1 << 64) - 1)) - dot)
                       & _MASK128)
        return out

    def decrypt(self, ct: SquashedNoiseCiphertext) -> list:
        """Decode message-and-carry from the u128 encoding (padding bit)."""
        mod_sup = ct.message_modulus * ct.carry_modulus
        delta = (1 << 127) // mod_sup
        return [(raw + delta // 2) // delta % (2 * mod_sup) % mod_sup
                for raw in self.decrypt_raw(ct)]


@dataclass
class NoiseSquashingKey:
    """Server-side squashing key: the u128 bootstrap key in NTT form,
    int32 (u32) residues [P, n_small, l, R, R, N] on the client key's
    device (server_key.rs; the keyswitch key is borrowed from the compute
    server key at squash time, as in atomic_pattern/standard.rs:80-104)."""

    bsk_res: torch.Tensor
    base_log: int
    levels: int
    num_primes: int
    params: NoiseSquashingParameters

    @classmethod
    def generate(cls, client_key: ClientKey,
                 private_key: NoiseSquashingPrivateKey) -> "NoiseSquashingKey":
        p = private_key.params
        if p.grouping_factor:
            raise ValueError("multi-bit squashing BSK not yet wired (as in "
                             "tfhe_tpu)")
        bsk = sq.gen_bootstrap_key128(
            client_key.lwe_sk, private_key.glwe_sk, p.decomp_base_log,
            p.decomp_level_count, p.glwe_noise_distribution,
            client_key._keygen_gen)
        num_primes = sq.num_primes_for_squash(p)
        return cls(bsk_res=sq.bootstrap_key128_to_ntt(bsk, num_primes)
                   .residues, base_log=p.decomp_base_log,
                   levels=p.decomp_level_count, num_primes=num_primes,
                   params=p)

    def identity_lut(self) -> tuple:
        """The identity LUT at Delta_128 over the output cleartext space:
        (hi, lo) int64[R, N] on the key's device."""
        p = self.params
        mod_sup = p.message_modulus * p.carry_modulus
        N, R = p.polynomial_size, p.glwe_size
        box = N // mod_sup
        delta_hi = np.uint64((1 << 63) // mod_sup)  # Delta_128 >> 64
        body = np.repeat(np.arange(mod_sup, dtype=np.uint64) * delta_hi, box)
        half = box // 2
        with np.errstate(over="ignore"):
            body[:half] = np.uint64(0) - body[:half]
        lut_hi = np.zeros((R, N), dtype=np.uint64)
        lut_hi[-1] = np.roll(body, -half)
        dev = self.bsk_res.device
        return from_u64(lut_hi, dev), torch.zeros((R, N), dtype=torch.int64,
                                                  device=dev)

    def squash_ciphertext_noise(self, server_key,
                                ct: ShortintCiphertext
                                ) -> SquashedNoiseCiphertext:
        """KS -> 128-bit PBS with the identity LUT
        (atomic_pattern/standard.rs:63-150), on the key's device."""
        p = self.params
        dev = self.bsk_res.device
        small = ct.ct.to(dev)
        if ct.under_key == "big":  # keyswitch to the small key
            small = server_key.ks_only(small)
        log_modulus = p.polynomial_size.bit_length()  # switch to 2N
        switch = (server_ops.lwe_centered_binary_modulus_switch
                  if p.modulus_switch_type
                  == ModulusSwitchType.CENTERED_MEAN_NOISE_REDUCTION
                  else server_ops.lwe_standard_modulus_switch)
        ms_mask, ms_body = switch(small, log_modulus)
        batch = small.shape[:-1]
        lut_hi, lut_lo = self.identity_lut()
        shape = batch + tuple(lut_hi.shape)
        rot_hi, rot_lo = sq.blind_rotate128(
            lut_hi.expand(shape), lut_lo.expand(shape), ms_mask, ms_body,
            self.bsk_res, self.base_log, self.levels,
            ntt_mod.get_plan(p.polynomial_size, self.num_primes))
        out_hi, out_lo = sq.sample_extract128(rot_hi, rot_lo)
        return SquashedNoiseCiphertext(
            hi=out_hi, lo=out_lo, degree=ct.degree,
            message_modulus=p.message_modulus, carry_modulus=p.carry_modulus)
