"""Shortint client key: secret keys + encrypt/decrypt.

Reference: ``tfhe/src/shortint/client_key/mod.rs``. Same derivation as
``tfhe_tpu.shortint.client_key``: a root AES stream yields the secret,
keygen and encryption sub-seeds; the GLWE key then the small LWE key are
drawn from the secret stream. The same seed gives byte-equal keys and
ciphertexts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from .._torus import to_u64
from ..core import algorithms as algo
from ..core.entities import GlweSecretKey, LweSecretKey
from ..utils.csprng import (AesCtrGenerator, EncryptionRandomGenerator,
                            SecretRandomGenerator)
from ..utils.encoding import ShortintEncoding
from ..utils.params import ClassicPBSParameters, EncryptionKeyChoice
from .ciphertext import NOMINAL_NOISE, ShortintCiphertext


def derive_seeds(seed: int) -> tuple:
    """(secret, keygen mask, keygen noise, encrypt mask, encrypt noise)
    sub-seeds drawn from the root seed's AES stream."""
    return tuple(int(x) for x in AesCtrGenerator(seed).uniform_u64(5))


@dataclass
class ClientKey:
    params: ClassicPBSParameters
    glwe_sk: GlweSecretKey
    lwe_sk: LweSecretKey  # the small key
    device: torch.device
    # two independent generators: one consumed by server-key generation,
    # one by encryptions (None for a key carried in without its seed)
    _enc_gen: EncryptionRandomGenerator = None
    _keygen_gen: EncryptionRandomGenerator = None
    seed: int = 0

    @classmethod
    def generate(cls, params: ClassicPBSParameters, seed: int = 0,
                 device=None) -> "ClientKey":
        """Deterministic keygen from a root seed, on ``device`` (the GPU
        when unset)."""
        dev = resolve_device(device)
        s_seed, ekg_seed, nkg_seed, e_seed, n_seed = derive_seeds(seed)
        sec = SecretRandomGenerator(s_seed)
        glwe_sk = algo.gen_glwe_secret_key(
            params.glwe_dimension, params.polynomial_size, sec, dev)
        lwe_sk = algo.gen_lwe_secret_key(params.lwe_dimension, sec, dev)
        return cls(params=params, glwe_sk=glwe_sk, lwe_sk=lwe_sk, device=dev,
                   _enc_gen=EncryptionRandomGenerator(e_seed, n_seed),
                   _keygen_gen=EncryptionRandomGenerator(ekg_seed, nkg_seed),
                   seed=seed)

    # -- key views ----------------------------------------------------------
    @property
    def big_lwe_sk(self) -> LweSecretKey:
        return self.glwe_sk.as_lwe_secret_key()

    @property
    def encryption_key_and_noise(self):
        """(secret key, noise distribution, key name) of fresh encryptions."""
        if self.params.encryption_key_choice == EncryptionKeyChoice.BIG:
            return self.big_lwe_sk, self.params.glwe_noise_distribution, "big"
        return self.lwe_sk, self.params.lwe_noise_distribution, "small"

    @property
    def encoding(self) -> ShortintEncoding:
        return ShortintEncoding(
            ciphertext_modulus=self.params.ciphertext_modulus,
            message_modulus=self.params.message_modulus,
            carry_modulus=self.params.carry_modulus,
            padding_bit=True,
        )

    # -- encrypt / decrypt ----------------------------------------------------
    def encrypt(self, values) -> ShortintCiphertext:
        """Encrypt message(s): a scalar or array-like -> batched ciphertext."""
        if self._enc_gen is None:
            raise ValueError("this client key carries no encryption seed")
        vals = np.atleast_1d(np.asarray(values, dtype=np.uint64))
        enc = self.encoding
        pts = np.array([enc.encode(int(v)) for v in vals.reshape(-1)],
                       dtype=np.uint64)
        sk, noise, under = self.encryption_key_and_noise
        cts = algo.lwe_encrypt(sk, pts, noise, self._enc_gen)
        cts = cts.reshape(vals.shape + (sk.dim + 1,))
        if np.ndim(values) == 0:
            cts = cts[0]
        return ShortintCiphertext(
            ct=cts,
            degree=self.params.message_modulus - 1,
            noise_level=NOMINAL_NOISE,
            message_modulus=self.params.message_modulus,
            carry_modulus=self.params.carry_modulus,
            under_key=under,
        )

    def decrypt_raw(self, ct: ShortintCiphertext) -> np.ndarray:
        sk = self.big_lwe_sk if ct.under_key == "big" else self.lwe_sk
        raw = algo.lwe_decrypt(sk, ct.ct.to(sk.bits.device))
        return to_u64(raw).reshape(ct.batch_shape)

    def decrypt_message_and_carry(self, ct: ShortintCiphertext) -> np.ndarray:
        raw = np.atleast_1d(self.decrypt_raw(ct))
        enc = self.encoding
        out = np.array([enc.decode(int(p)) for p in raw.reshape(-1)],
                       dtype=np.uint64)
        return out.reshape(raw.shape)

    def decrypt(self, ct: ShortintCiphertext) -> np.ndarray:
        """Message only (mod message_modulus)."""
        return (self.decrypt_message_and_carry(ct)
                % np.uint64(ct.message_modulus))
