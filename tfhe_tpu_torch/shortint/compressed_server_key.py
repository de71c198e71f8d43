"""Compressed (seeded) server keys: only the ciphertext BODIES and the
mask-stream coordinates are stored; the masks are drawn again on
decompression.

Torch counterpart of ``tfhe_tpu/shortint/compressed_server_key.py``
(reference: the seeded entities ``core_crypto/entities/
seeded_lwe_bootstrap_key.rs``, ``seeded_lwe_keyswitch_key.rs`` and
``CompressedServerKey``, ``shortint/server_key/compressed.rs``). The
recorded coordinates are the keygen mask stream's (key, byte offset) at
the start of each key's draws, so :meth:`CompressedServerKey.decompress`
builds a server key byte-equal to ``ServerKey.generate`` of the same client
key for the variant in use (v6b: the BNF2 key, the standard-domain BSK, the
KSK and its int8 limbs; a multi-bit set: its key of subset-product GGSWs in
K5's layout).

KS64 keys only, as in ``tfhe_tpu``, classic or multi-bit; :meth:`serialize`
writes ``tfhe_tpu``'s ``CompressedServerKey`` envelope
(``utils/serialization.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .._torus import from_u64
from ..core import algorithms as algo
from ..utils import serialization as ser
from ..utils.csprng import AesCtrGenerator
from .client_key import ClientKey
from .server_key import (ServerKey, check_supported, drift_params,
                         grouping_of, is_ks32, resolve_variant)


def _check_classic(p) -> None:
    check_supported(p)
    if is_ks32(p) or drift_params(p) is not None:
        raise ValueError(f"{p.name}: the compressed server key carries the "
                         "classic KS64 key (or a multi-bit one) only, as "
                         "tfhe_tpu's does")


@dataclass
class CompressedServerKey:
    params: Any
    #: int64[n, l, k+1, N] (multi-bit: [n/g, 2^g-1, l, k+1, N]): each GGSW
    #: row's body
    bsk_bodies: torch.Tensor
    ksk_bodies: torch.Tensor  # int64[n_big, l_ks]: each KSK LWE's body
    mask_seed: int  # the keygen mask stream's AES key
    bsk_mask_start: int  # stream byte offset of the first BSK mask draw
    ksk_mask_start: int
    max_degree: int = 0

    @classmethod
    def generate(cls, client_key: ClientKey) -> "CompressedServerKey":
        """The draws of :meth:`ServerKey.generate` (the BSK, or a
        multi-bit set's GGSWs of subset products, with glwe noise, then the
        KSK with lwe noise), recording where each key's masks start and
        keeping only the bodies."""
        p = client_key.params
        _check_classic(p)
        gen = client_key._keygen_gen
        mask_seed = int.from_bytes(gen.mask._key16, "little")
        bsk_mask_start = gen.mask.table_index
        g = grouping_of(p)
        if g:
            bsk = algo.gen_multi_bit_bootstrap_key(
                client_key.lwe_sk, client_key.glwe_sk, p.pbs_base_log,
                p.pbs_level, g, p.glwe_noise_distribution, gen)
        else:
            bsk = algo.gen_bootstrap_key(
                client_key.lwe_sk, client_key.glwe_sk, p.pbs_base_log,
                p.pbs_level, p.glwe_noise_distribution, gen)
        ksk_mask_start = gen.mask.table_index
        ksk = algo.gen_keyswitch_key(
            client_key.big_lwe_sk, client_key.lwe_sk, p.ks_base_log,
            p.ks_level, p.lwe_noise_distribution, gen)
        return cls(params=p,
                   bsk_bodies=bsk.data[..., p.glwe_dimension, :].clone(),
                   ksk_bodies=ksk.data[..., -1].clone(),
                   mask_seed=mask_seed, bsk_mask_start=bsk_mask_start,
                   ksk_mask_start=ksk_mask_start,
                   max_degree=p.message_modulus * p.carry_modulus - 1)

    @property
    def device(self) -> torch.device:
        return self.bsk_bodies.device

    def decompress(self) -> ServerKey:
        """Draw the masks again from the recorded stream coordinates and
        prepare the full server key on the bodies' device."""
        p = self.params
        k, N = p.glwe_dimension, p.polynomial_size
        n_big, n_small = k * N, p.lwe_dimension
        dev = self.device
        rows = tuple(self.bsk_bodies.shape[:-1])  # (n, l, k+1) or multi-bit
        stream = AesCtrGenerator(self.mask_seed,
                                 table_index=self.bsk_mask_start)
        masks = stream.uniform_u64(int(np.prod(rows)) * k * N)
        bsk = torch.cat([from_u64(masks.reshape(rows + (k, N)), dev),
                         self.bsk_bodies[..., None, :]], dim=-2)
        stream = AesCtrGenerator(self.mask_seed,
                                 table_index=self.ksk_mask_start)
        masks = stream.uniform_u64(n_big * p.ks_level * n_small)
        ksk = torch.cat([from_u64(masks.reshape(n_big, p.ks_level, n_small),
                                  dev), self.ksk_bodies[..., None]], dim=-1)
        variant = resolve_variant(N, p.pbs_base_log, p.pbs_level, params=p)
        sk = ServerKey.from_standard_keys(p, ksk, bsk, variant)
        sk.max_degree = self.max_degree
        return sk

    def serialized_size_bytes(self) -> int:
        """Bytes of the bodies plus the seeds."""
        return (self.bsk_bodies.numel() + self.ksk_bodies.numel()) * 8 + 64

    def serialize(self) -> bytes:
        """``tfhe_tpu``'s envelope of this key, byte for byte; read it back
        with ``utils.serialization.deserialize``."""
        return ser.serialize_compressed_server_key(self)
