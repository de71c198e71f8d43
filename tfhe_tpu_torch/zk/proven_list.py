"""ZK-proven compact ciphertext lists.

Mirrors the reference ``ProvenCompactCiphertextList``
(``tfhe/src/high_level_api/compact_list.rs:489-690``,
``shortint/ciphertext/zk.rs``): compact-public-key encryption where each
shared-mask bin carries a pke proof of well-formedness; the server
verifies before expanding, so malformed ciphertexts (wrong noise, wrong
encoding, not an encryption at all) are rejected at ingress.

Statement per bin (matching ``CompactPublicKey.encrypt``):
    c1 = rot(a) . bar(r) + e1            a = pk.mask
    c2_j = <phi(b), bar(r)> + delta m_j + e2_j     b = pk.body
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .._torus import from_u64, u64_const
from ..shortint.compact_public_key import (
    CompactCiphertextList,
    CompactPublicKey,
    _srnc,
)
from ..utils.csprng import EncryptionRandomGenerator
from ..utils.encoding import ShortintEncoding
from .pke import PkeCrs, PkeProof, prove, verify
from .pke_v2 import PkeV2Crs
from . import pke_v2 as _pke_v2


def _scheme(crs):
    """Dispatch on the CRS type: PkeCrs -> v1 (pke.rs), PkeV2Crs -> v2
    (pke_v2/, shorter norm-bound proofs)."""
    if isinstance(crs, PkeV2Crs):
        return _pke_v2.prove, _pke_v2.verify
    return prove, verify

_U64 = np.uint64


def _to_i64_list(arr) -> List[int]:
    """u64 values (an int64 tensor or numpy) as signed Python ints."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().to("cpu", torch.int64).reshape(-1).tolist()
    return [int(v) for v in np.asarray(arr, dtype=_U64).view(np.int64)]


def noise_bound_pow2(dist) -> int:
    """Power-of-two bound B with noise in [-B, B): t-uniform(b) values lie
    in [-2^b, 2^b] so B = 2^(b+1); gaussian uses a 6-sigma bound."""
    if dist.kind == "t_uniform":
        return 1 << (dist.bound_log2 + 1)
    import math

    return 1 << (math.ceil(math.log2(6.0 * dist.std_dev * 2.0 ** 64)) + 1)


def crs_for_params(params, max_bin_messages: int, seed: int = 0) -> PkeCrs:
    """CRS sized for a CompactPublicKeyEncryptionParameters set: d = the
    encryption LWE dimension, t includes the padding bit, B from the
    encryption noise bound (compact_list.rs CRS::from_config)."""
    t = 2 * params.message_modulus * params.carry_modulus
    return PkeCrs.generate(
        d=params.encryption_lwe_dimension,
        k=max_bin_messages,
        b=noise_bound_pow2(params.encryption_noise_distribution),
        q=0,
        t=t,
        pad_bits=1,
        seed=seed,
    )


def crs_for_params_v2(params, max_bin_messages: int,
                      seed: int = 0) -> PkeV2Crs:
    """pke_v2 CRS for a CompactPublicKeyEncryptionParameters set
    (zk scheme V2, the reference default since v0.11)."""
    t = 2 * params.message_modulus * params.carry_modulus
    return PkeV2Crs.generate(
        d=params.encryption_lwe_dimension,
        k=max_bin_messages,
        b_inf=noise_bound_pow2(params.encryption_noise_distribution),
        q=0,
        t=t,
        pad_bits=1,
        seed=seed,
    )


def bin_seed(seed: bytes, b: int) -> bytes:
    """The prove seed of bin ``b`` under a fixed list seed."""
    return hashlib.sha256(seed + b.to_bytes(8, "little")).digest()


@dataclass
class ProvenCompactCiphertextList:
    ct_list: CompactCiphertextList
    proofs: List[PkeProof]
    metadata: bytes = b""

    @classmethod
    def encrypt_and_prove(
        cls,
        pk: CompactPublicKey,
        values,
        crs: PkeCrs,
        metadata: bytes = b"",
        rng: EncryptionRandomGenerator = None,
        seed: bytes = None,
    ) -> "ProvenCompactCiphertextList":
        """CompactPublicKey.encrypt with witness capture: one proof per
        shared-mask bin (k = bin size <= crs.k). The ciphertexts are made on
        the key's device, the proofs on the host. ``rng`` (the encryption
        generator) and the prove seeds default to fresh ``secrets`` draws, a
        seed a bin, as ``tfhe_tpu``'s. A fixed ``seed`` is for tests only: bin
        b is proven with ``bin_seed(seed, b)``, so no two bins share their
        blinding."""
        p = pk.params
        n = p.encryption_lwe_dimension
        assert n == crs.d, "CRS dimension mismatch"
        if rng is None:
            rng = EncryptionRandomGenerator(
                secrets.randbits(128), secrets.randbits(128)
            )
        enc = ShortintEncoding(
            ciphertext_modulus=p.ciphertext_modulus,
            message_modulus=p.message_modulus,
            carry_modulus=p.carry_modulus,
            padding_bit=True,
        )
        vals = np.atleast_1d(np.asarray(values, dtype=_U64)).reshape(-1)
        k = vals.shape[0]
        n_bins = -(-k // n)
        dev = pk.device
        masks, bodies = [], []
        dist = p.encryption_noise_distribution
        a_i64 = _to_i64_list(pk.mask)
        b_i64 = _to_i64_list(pk.body)
        pk_polys = torch.stack([pk.mask, pk.body])
        proofs = []
        prove_fn, _ = _scheme(crs)
        for b in range(n_bins):
            chunk = vals[b * n : (b + 1) * n]
            m = chunk.shape[0]
            assert m <= crs.k, "bin larger than CRS k"
            r = rng.noise.uniform_binary(n).astype(_U64)
            e1 = rng.sample_noise(dist, n)
            e2 = rng.sample_noise(dist, m)
            conv = _srnc(pk_polys, from_u64(r, dev))
            mask = conv[0] + from_u64(e1, dev)
            pts = torch.tensor([u64_const(enc.encode(int(v))) for v in chunk],
                               dtype=torch.int64, device=dev)
            body = conv[1].flip(-1)[:m] + from_u64(e2, dev) + pts
            masks.append(mask)
            bodies.append(body)
            public = (a_i64, b_i64, _to_i64_list(mask), _to_i64_list(body))
            private = (
                [int(x) for x in r],
                _to_i64_list(e1),
                [int(x) for x in chunk],
                _to_i64_list(e2),
            )
            proofs.append(
                prove_fn(crs, public, private, metadata=metadata,
                         seed=secrets.token_bytes(32) if seed is None
                         else bin_seed(seed, b))
            )
        ct_list = CompactCiphertextList(
            masks=torch.stack(masks), bodies=torch.cat(bodies), count=k,
            params=p, degree=p.message_modulus - 1,
        )
        return cls(ct_list=ct_list, proofs=proofs, metadata=metadata)

    # ------------------------------------------------------------------
    def verify(self, crs: PkeCrs, pk: CompactPublicKey,
               metadata: bytes = b"") -> bool:
        n = pk.params.encryption_lwe_dimension
        a_i64 = _to_i64_list(pk.mask)
        b_i64 = _to_i64_list(pk.body)
        cl = self.ct_list
        for b, proof in enumerate(self.proofs):
            lo = b * n
            hi = min(lo + n, cl.count)
            public = (
                a_i64,
                b_i64,
                _to_i64_list(cl.masks[b]),
                _to_i64_list(cl.bodies[lo:hi]),
            )
            _, verify_fn = _scheme(crs)
            if not verify_fn(proof, crs, public, metadata=metadata):
                return False
        return True

    def verify_and_expand(self, crs: PkeCrs, pk: CompactPublicKey,
                          metadata: bytes = b""):
        """Reference verify-then-expand flow; raises on a bad proof."""
        if not self.verify(crs, pk, metadata):
            raise ValueError("invalid ZK proof for compact ciphertext list")
        return self.ct_list.expand_to_shortint()
