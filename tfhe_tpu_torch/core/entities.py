"""Core-crypto entities of the main path: tensors plus metadata.

Torch counterpart of the subset of ``tfhe_tpu/core/entities.py`` that the
shortint KS -> PBS path needs. Shapes (q = 2^64, int64 torus values):

- LWE secret key:     int64[n] in {0, 1}
- GLWE secret key:    int64[k, N] in {0, 1}
- LWE keyswitch key:  int64[n_in, l_ks, n_out+1]
- LWE bootstrap key:  int64[n, l_pbs, k+1, k+1, N] (standard domain; the
                      server keys keep only its transform)
- NTT bootstrap key:  int32 (u32) [2, P, n, l_pbs, k+1, k+1, N], residues
                      and Shoup duals over the first P PRIMES32
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class LweSecretKey:
    bits: torch.Tensor  # int64[n], values in {0, 1}

    @property
    def dim(self) -> int:
        return self.bits.shape[0]


@dataclass
class GlweSecretKey:
    bits: torch.Tensor  # int64[k, N]

    @property
    def glwe_dim(self) -> int:
        return self.bits.shape[0]

    @property
    def poly_size(self) -> int:
        return self.bits.shape[1]

    def as_lwe_secret_key(self) -> LweSecretKey:
        """The equivalent big LWE key (``GlweSecretKey::into_lwe_secret_key``)."""
        return LweSecretKey(self.bits.reshape(-1).clone())


@dataclass
class LweKeyswitchKey:
    data: torch.Tensor  # int64[n_in, l, n_out+1]
    base_log: int
    levels: int


@dataclass
class LweBootstrapKey:
    data: torch.Tensor  # int64[n, l, k+1, k+1, N]
    base_log: int
    levels: int


@dataclass
class NttLweBootstrapKey:
    """Transform-domain BSK of the exact CRT path: per-prime NTT residues
    and their Shoup duals floor(res * 2^32 / p), u32 values in int32
    storage (the duals exceed 2^31: read them masked)."""

    residues: torch.Tensor  # int32[2, P, n, l, k+1, k+1, N]
    base_log: int
    levels: int
    num_primes: int
