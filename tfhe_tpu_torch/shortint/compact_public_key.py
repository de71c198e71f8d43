"""Compact public key encryption and compact ciphertext lists.

Torch counterpart of ``tfhe_tpu/shortint/compact_public_key.py``
(reference ``shortint/public_key/compact.rs``,
``core_crypto/algorithms/lwe_compact_public_key_generation.rs``: pk = (a,
b = a (*) rev(s) + e), one semi-reverse negacyclic convolution;
``lwe_encryption.rs:2279-2410``: per bin of n messages one shared mask
convolution and n bodies; ``lwe_compact_ciphertext_list_expansion.rs``:
the mask of ciphertext i is a * X^i).

The random draws are ``tfhe_tpu``'s, in its order, on the host; the
convolutions run on the keys' device through the port's exact CRT
product, and the expansion is one batched gather with a sign mask.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from .._torus import from_u64, to_u64, u64_const
from ..core import algorithms as algo
from ..core.entities import LweSecretKey
from ..utils.csprng import EncryptionRandomGenerator, SecretRandomGenerator
from ..utils.encoding import ShortintEncoding
from ..utils.params import CompactPublicKeyEncryptionParameters
from .ciphertext import NOMINAL_NOISE, ShortintCiphertext


def _srnc(lhs: torch.Tensor, rhs_binary: torch.Tensor) -> torch.Tensor:
    """slice_semi_reverse_negacyclic_convolution: lhs (*) reverse(rhs) in
    Z_{2^64}[X]/(X^n + 1) (slice_algorithms.rs:626), for one binary
    ``rhs`` [n] and one or more ``lhs`` [..., n]."""
    return algo._binary_polymul_batch(rhs_binary.flip(-1)[None],
                                      lhs[..., None, :])


def _encoding(p) -> ShortintEncoding:
    return ShortintEncoding(ciphertext_modulus=p.ciphertext_modulus,
                            message_modulus=p.message_modulus,
                            carry_modulus=p.carry_modulus, padding_bit=True)


@dataclass
class CompactPrivateKey:
    """Dedicated secret key of compact-PK encryption (shortint
    CompactPrivateKey)."""

    lwe_sk: LweSecretKey
    params: CompactPublicKeyEncryptionParameters
    _gen: EncryptionRandomGenerator = None

    @classmethod
    def generate(cls, params: CompactPublicKeyEncryptionParameters,
                 seed: int = 0, device=None) -> "CompactPrivateKey":
        """The key bits and the public key's generator from ``seed``, as
        ``tfhe_tpu`` derives them, on ``device`` (the GPU when unset)."""
        dev = resolve_device(device)
        sec = SecretRandomGenerator(seed ^ 0xC0FFEE)
        sk = algo.gen_lwe_secret_key(params.encryption_lwe_dimension, sec,
                                     dev)
        gen = EncryptionRandomGenerator(seed ^ 0xFACADE, seed ^ 0xDEC0DE)
        return cls(lwe_sk=sk, params=params, _gen=gen)

    @property
    def encoding(self) -> ShortintEncoding:
        return _encoding(self.params)

    def decrypt_expanded(self, cts: torch.Tensor) -> np.ndarray:
        """Messages of expanded ciphertexts int64[m, n+1]."""
        raws = to_u64(algo.lwe_decrypt(self.lwe_sk,
                                       cts.to(self.lwe_sk.bits.device)))
        enc = self.encoding
        return np.array([enc.decode(int(r)) for r in raws], dtype=np.uint64)


@dataclass
class CompactPublicKey:
    """(a, b = a (*) rev(s) + e): 2n u64 values."""

    mask: torch.Tensor  # int64[n]
    body: torch.Tensor  # int64[n]
    params: CompactPublicKeyEncryptionParameters

    @classmethod
    def generate(cls, private_key: CompactPrivateKey) -> "CompactPublicKey":
        p = private_key.params
        n = p.encryption_lwe_dimension
        gen = private_key._gen
        dev = private_key.lwe_sk.bits.device
        mask = from_u64(gen.mask.uniform_u64(n), dev)
        body = _srnc(mask, private_key.lwe_sk.bits) + from_u64(
            gen.sample_noise(p.encryption_noise_distribution, n), dev)
        return cls(mask=mask, body=body, params=p)

    @property
    def device(self) -> torch.device:
        return self.mask.device

    def encrypt(self, values, rng: EncryptionRandomGenerator = None
                ) -> "CompactCiphertextList":
        """A clear list -> a compact list (lwe_encryption.rs:2279): per bin
        of n values, mask_out = a (*) rev(r) + e1 and body_j =
        rev(b (*) rev(r))_j + Delta m_j + e2_j. The bins' draws (r, e1, e2
        from the noise stream) come in ``tfhe_tpu``'s order; each bin's
        two convolutions are one batched product."""
        p = self.params
        n = p.encryption_lwe_dimension
        if rng is None:
            rng = EncryptionRandomGenerator(secrets.randbits(128),
                                            secrets.randbits(128))
        enc = _encoding(p)
        vals = np.atleast_1d(np.asarray(values, dtype=np.uint64)).reshape(-1)
        k = vals.shape[0]
        n_bins = -(-k // n)
        dist = p.encryption_noise_distribution
        dev = self.device
        pk_polys = torch.stack([self.mask, self.body])
        masks, bodies = [], []
        for b in range(n_bins):
            chunk = vals[b * n:(b + 1) * n]
            m = chunk.shape[0]
            r = from_u64(rng.noise.uniform_binary(n), dev)
            e1 = from_u64(rng.sample_noise(dist, n), dev)
            e2 = from_u64(rng.sample_noise(dist, m), dev)
            conv = _srnc(pk_polys, r)
            masks.append(conv[0] + e1)
            pts = torch.tensor([u64_const(enc.encode(int(v))) for v in chunk],
                               dtype=torch.int64, device=dev)
            bodies.append(conv[1].flip(-1)[:m] + e2 + pts)
        return CompactCiphertextList(
            masks=torch.stack(masks), bodies=torch.cat(bodies), count=k,
            params=p, degree=p.message_modulus - 1)


@dataclass
class CompactCiphertextList:
    """Shared-mask compact LWE list: n + k u64 values instead of
    k * (n + 1)."""

    masks: torch.Tensor  # int64[n_bins, n]
    bodies: torch.Tensor  # int64[count]
    count: int
    params: Any
    degree: int

    def expand(self) -> torch.Tensor:
        """-> int64[count, n+1]: ciphertext i's mask is its bin's mask
        times X^(i mod n) (lwe_compact_ciphertext_list_expansion.rs), one
        gather: coefficient t is mask[t - j] for t >= j and -mask[n + t - j]
        below."""
        n = self.params.encryption_lwe_dimension
        dev = self.masks.device
        i = torch.arange(self.count, device=dev)
        b, j = i // n, i % n
        src = torch.arange(n, device=dev)[None] - j[:, None]
        neg = src < 0
        rot = self.masks[b[:, None], torch.where(neg, src + n, src)]
        rot = torch.where(neg, -rot, rot)
        return torch.cat([rot, self.bodies[:, None]], dim=1)

    def expand_to_shortint(self) -> ShortintCiphertext:
        """The expanded ciphertexts as one batched shortint ciphertext under
        the compact key (cast with a KeySwitchingKey before computing)."""
        p = self.params
        return ShortintCiphertext(
            ct=self.expand(), degree=self.degree, noise_level=NOMINAL_NOISE,
            message_modulus=p.message_modulus, carry_modulus=p.carry_modulus,
            under_key="pke")
