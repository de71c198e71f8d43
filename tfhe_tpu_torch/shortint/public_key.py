"""LWE public keys: encrypt without the secret key.

Torch counterpart of ``tfhe_tpu/shortint/public_key.py`` (reference
``tfhe/src/shortint/public_key/standard.rs`` and
``core_crypto/algorithms/lwe_public_key_generation.rs``): the public key is
a list of encryptions of zero, kept on the device; public encryption is a
random binary subset sum plus the plaintext (Regev public-key encryption).

The subset sum of v values over Z zeros is one product sel[v, Z] x
zeros[Z, n+1] mod 2^64, computed as an int8 GEMM of the 0/1 selection
against the zeros' eight signed limbs (|row sum| <= Z * 128 < 2^31 at
2_2's Z = 131,264), never as a values x key temporary.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from .._torus import u64_const
from ..core import algorithms as algo
from ..ops import server as server_ops
from ..utils.csprng import AesCtrGenerator
from ..utils.encoding import ShortintEncoding
from .ciphertext import NOMINAL_NOISE, ShortintCiphertext
from .client_key import ClientKey


def _zero_count(n: int) -> int:
    """Reference zero_encryption_count (shortint/engine/public_side.rs:
    15-22): (n + 1) * log2(q) + 128 encryptions of zero, the
    leftover-hash-lemma margin of subset-sum public encryption."""
    return (n + 1) * 64 + 128


@dataclass
class PublicKey:
    zeros: torch.Tensor  # int64[count, n+1], encryptions of 0
    params: Any
    #: the zeros in signed base-256 limbs, int8[count, (n+1)*8], built at
    #: the first encryption
    zeros_i8: Optional[torch.Tensor] = None

    @classmethod
    def generate(cls, client_key: ClientKey) -> "PublicKey":
        """The zeros, drawn from the client key's encryption stream, on the
        client key's device."""
        sk, noise, _ = client_key.encryption_key_and_noise
        count = _zero_count(sk.dim)
        zeros = algo.lwe_encrypt(sk, np.zeros(count, dtype=np.uint64), noise,
                                 client_key._enc_gen)
        return cls(zeros=zeros, params=client_key.params)

    def encrypt(self, values, rng=None) -> ShortintCiphertext:
        """Random-subset-sum public encryption (standard.rs encrypt). The
        selection bits come from the AES-CTR CSPRNG (seeded from OS entropy
        when ``rng`` is None), or from a ``np.random.Generator`` (the
        test-only deterministic source, drawn as ``tfhe_tpu`` draws it)."""
        p = self.params
        if rng is None:
            rng = AesCtrGenerator(seed=secrets.randbits(128))
        vals = np.atleast_1d(np.asarray(values, dtype=np.uint64))
        count, dim = self.zeros.shape
        if isinstance(rng, np.random.Generator):
            sel = rng.integers(0, 2, size=(vals.size, count), dtype=np.uint64)
        else:
            sel = rng.uniform_binary(vals.size * count).reshape(vals.size,
                                                                count)
        if self.zeros_i8 is None:
            self.zeros_i8 = server_ops.u64_to_i8_limbs(self.zeros).reshape(
                count, dim * 8)
        dev = self.zeros.device
        sel = torch.from_numpy(sel.astype(np.int64)).to(dev)
        cts = server_ops.limb_matmul(sel, self.zeros_i8, 1)
        enc = ShortintEncoding(ciphertext_modulus=p.ciphertext_modulus,
                               message_modulus=p.message_modulus,
                               carry_modulus=p.carry_modulus,
                               padding_bit=True)
        pts = [u64_const(enc.encode(int(v))) for v in vals.reshape(-1)]
        cts[:, -1] += torch.tensor(pts, dtype=torch.int64, device=dev)
        cts = cts.reshape(vals.shape + (dim,))
        if np.ndim(values) == 0:
            cts = cts[0]
        under = "big" if dim - 1 == p.big_lwe_dimension else "small"
        return ShortintCiphertext(
            ct=cts,
            degree=p.message_modulus - 1,
            noise_level=NOMINAL_NOISE,
            message_modulus=p.message_modulus,
            carry_modulus=p.carry_modulus,
            under_key=under,
        )

