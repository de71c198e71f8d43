"""Shortint ciphertext: a (possibly batched) LWE tensor plus host-side
degree/noise bookkeeping.

Reference: ``tfhe/src/shortint/ciphertext/standard.rs:20`` and
``ciphertext/common.rs:68,151``. A batched ciphertext carries one
(degree, noise_level) pair for the whole batch.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

NOMINAL_NOISE = 1


@dataclass
class ShortintCiphertext:
    ct: torch.Tensor  # int64[..., dim+1]
    degree: int  # max attainable encoded value
    noise_level: int  # multiples of nominal fresh noise
    message_modulus: int
    carry_modulus: int
    under_key: str = "big"  # 'big' (GLWE-derived key) or 'small'

    @property
    def batch_shape(self):
        return tuple(self.ct.shape[:-1])

    def with_ct(self, ct, degree=None, noise_level=None) -> "ShortintCiphertext":
        return replace(
            self,
            ct=ct,
            degree=self.degree if degree is None else degree,
            noise_level=self.noise_level if noise_level is None else noise_level,
        )


@dataclass
class LookupTable:
    """A trivial GLWE accumulator + the degree of the function's output."""

    acc: torch.Tensor  # int64[k+1, N]
    degree: int
