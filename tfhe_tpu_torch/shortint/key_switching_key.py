"""Keyset-to-keyset key switching (parameter casting) and ciphertext
re-randomization.

Torch counterpart of ``tfhe_tpu/shortint/key_switching_key.py`` (reference
``shortint/key_switching_key/mod.rs:134,539,696``: an optional pre-shift
LUT, the keyswitch, a refresh PBS on the destination key;
``shortint/ciphertext/re_randomization.rs:283-374``: add keyswitched
compact-PK encryptions of zero derived from a seed).

The keyswitch is ``ops/server.py::keyswitch_mxu``, int8 GEMMs a digit limb
(the re-randomization key's 1 x 24 digits reach 2^23);
the refresh runs the destination key's ``apply_lookup_table`` or
``pbs_only`` (K2 acc32 -> K1 under v6b).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core import algorithms as algo
from ..ops import server as server_ops
from ..utils.csprng import EncryptionRandomGenerator
from ..utils.params import EncryptionKeyChoice, ShortintKeySwitchingParameters
from .ciphertext import NOMINAL_NOISE, ShortintCiphertext
from .client_key import ClientKey
from .compact_public_key import CompactPrivateKey, CompactPublicKey
from .server_key import ServerKey


def ksk_limbs(ksk: torch.Tensor) -> torch.Tensor:
    """A KSK int64[n_in, l, n_out+1] in the limb form of
    ``server.keyswitch_mxu``, on its device: int8[n_in*l, (n_out+1)*8]."""
    n_in, l, o = ksk.shape
    return server_ops.u64_to_i8_limbs(ksk).reshape(n_in * l, o * 8)


@dataclass
class KeySwitchingKey:
    """Casts ciphertexts from a source keyset (a compute keyset or a
    compact-PK keyset) into a destination keyset."""

    ksk: torch.Tensor  # int64[n_src, l, n_dst+1]
    ksk_i8: torch.Tensor  # int8[n_src*l, (n_dst+1)*8]
    params: ShortintKeySwitchingParameters
    dest_server_key: ServerKey
    src_server_key: Optional[ServerKey]
    cast_rshift: int
    dest_under: str  # 'big' | 'small'

    @classmethod
    def generate(cls, src, dst_client: ClientKey, dst_server: ServerKey,
                 params: ShortintKeySwitchingParameters,
                 src_server: Optional[ServerKey] = None
                 ) -> "KeySwitchingKey":
        """``src``: a ClientKey (compute keyset) or a CompactPrivateKey;
        the key is drawn from the destination client key's keygen stream,
        on its device."""
        if isinstance(src, CompactPrivateKey):
            in_sk = src.lwe_sk
        else:
            in_sk, _, _ = src.encryption_key_and_noise
        sp, dp = src.params, dst_client.params
        src_bits = (sp.message_modulus * sp.carry_modulus).bit_length() - 1
        dst_bits = (dp.message_modulus * dp.carry_modulus).bit_length() - 1
        if params.destination_key == EncryptionKeyChoice.BIG:
            out_sk, noise, dest_under = (dst_client.big_lwe_sk,
                                         dp.glwe_noise_distribution, "big")
        else:
            out_sk, noise, dest_under = (dst_client.lwe_sk,
                                         dp.lwe_noise_distribution, "small")
        ksk = algo.gen_keyswitch_key(
            in_sk, out_sk, params.ks_base_log, params.ks_level, noise,
            dst_client._keygen_gen).data
        return cls(ksk=ksk, ksk_i8=ksk_limbs(ksk), params=params,
                   dest_server_key=dst_server, src_server_key=src_server,
                   cast_rshift=dst_bits - src_bits, dest_under=dest_under)

    def keyswitch(self, ct: torch.Tensor) -> torch.Tensor:
        return server_ops.keyswitch_mxu(ct.to(self.ksk.device), self.ksk_i8,
                                        self.params.ks_base_log,
                                        self.params.ks_level)

    def cast(self, ct: ShortintCiphertext) -> ShortintCiphertext:
        """Pre-shift (when casting to fewer message bits), keyswitch, then
        a refresh PBS under the destination key (key_switching_key/mod.rs:
        696-800; a cast always refreshes)."""
        dsk = self.dest_server_key
        dp = dsk.params
        mod_sup_dst = dp.message_modulus * dp.carry_modulus
        pre = ct
        if self.cast_rshift < 0:
            assert self.src_server_key is not None, (
                "casting to a smaller message modulus needs the source "
                "server key for the pre-shift LUT")
            src_sk = self.src_server_key
            mod_sup_src = (src_sk.params.message_modulus
                           * src_sk.params.carry_modulus)
            lut = src_sk.generate_lookup_table(
                lambda x: (x << -self.cast_rshift) % mod_sup_src)
            pre = src_sk.apply_lookup_table(ct, lut)
        mid = ShortintCiphertext(
            ct=self.keyswitch(pre.ct), degree=pre.degree,
            noise_level=NOMINAL_NOISE, message_modulus=dp.message_modulus,
            carry_modulus=dp.carry_modulus, under_key=self.dest_under)
        if self.cast_rshift > 0:
            f = lambda x: (x >> self.cast_rshift) % mod_sup_dst  # noqa: E731
        else:
            f = lambda x: x % mod_sup_dst  # noqa: E731
        lut = dsk.generate_lookup_table(f)
        if self.dest_under == "big" and dsk.order == "ks_pbs":
            return dsk.apply_lookup_table(mid, lut)
        # the destination is the small key: the ciphertext already sits
        # under the PBS input key
        return ShortintCiphertext(
            ct=dsk.pbs_only(mid.ct, lut.acc), degree=lut.degree,
            noise_level=NOMINAL_NOISE, message_modulus=dp.message_modulus,
            carry_modulus=dp.carry_modulus, under_key="big")


def re_randomize_ciphertexts(cts: list, cpk: CompactPublicKey,
                             ksk: KeySwitchingKey, seed: int) -> list:
    """Add keyswitched compact-PK encryptions of zero, derived from
    ``seed`` (ciphertext/re_randomization.rs:283-374). Inputs must be at
    nominal noise; outputs stay at nominal."""
    assert ksk.dest_under == "big", "re-randomization requires KS->PBS order"
    assert ksk.cast_rshift == 0, "re-randomization requires matching moduli"
    for ct in cts:
        assert ct.noise_level <= NOMINAL_NOISE, (
            "tried to re-randomize a ciphertext with non-nominal noise")
    count = sum(int(np.prod(ct.ct.shape[:-1])) or 1 for ct in cts)
    rng = EncryptionRandomGenerator(seed, seed ^ 0x5EED)
    zeros = cpk.encrypt(np.zeros(count, dtype=np.uint64), rng=rng)
    ksed = ksk.keyswitch(zeros.expand())
    out, idx = [], 0
    for ct in cts:
        m = int(np.prod(ct.ct.shape[:-1])) or 1
        z = ksed[idx:idx + m].reshape(ct.ct.shape)
        idx += m
        out.append(ct.with_ct(ct.ct + z.to(ct.ct.device)))
    return out
