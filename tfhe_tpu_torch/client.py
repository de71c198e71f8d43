"""Thin-client surface: keygen / encrypt / decrypt / serialize without the
server stack.

Torch counterpart of ``tfhe_tpu/client.py`` (the reference's browser client
API ``tfhe/src/js_on_wasm_api/``: client-side keygen, encryption,
serialization and compact lists, so that a device without a GPU produces
ciphertexts for a remote server). Every function here runs with nothing of
the server stack imported: no ``ops/`` module, no kernel build (checked by
``tests/test_torch_client.py`` in a subprocess with ``tfhe_tpu_torch.ops``
masked). Keys live on the device the caller names (``device="cpu"`` for a
client without a GPU); ciphertexts come back as numpy arrays, as
``tfhe_tpu``'s do, unless the caller names a device for them.

Interop contract: ciphertexts made here are bit-identical to the full
stack's (``integer.ClientKey.encrypt_radix``) from the same seed, on any
device, and the envelopes are the regular ``RadixCiphertext`` /
``ShortintClientKey`` / ``CompactCiphertextList`` envelopes of
:mod:`tfhe_tpu_torch.utils.serialization`, byte-equal to ``tfhe_tpu``'s,
so the client, the port's server and ``tfhe_tpu`` read each other's.
The ZK half (``build_proven_compact_list``, ``client_crs``,
``serialize_proof``) proves on the host (``zk/``): its proofs and the
``PkeV2Crs`` / ``PkeV2Proof`` envelopes equal ``tfhe_tpu``'s from the same
seeds, and each package verifies the other's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .shortint.ciphertext import NOMINAL_NOISE, ShortintCiphertext
from .shortint.client_key import ClientKey as ShortintClientKey
from .shortint.compact_public_key import CompactPrivateKey, CompactPublicKey
from .utils import serialization as ser
from .utils.hostarray import asarray

__all__ = [
    "ClientKey",
    "ClientRadixCiphertext",
    "CompactPublicKey",
    "CompactPrivateKey",
    "encrypt_radix",
    "encrypt_signed_radix",
    "decrypt_radix",
    "decrypt_signed_radix",
    "serialize_radix",
    "serialize_client_key",
    "generate_compact_keys",
    "build_compact_list",
    "build_proven_compact_list",
    "client_crs",
    "serialize_compact_list",
    "serialize_proof",
]

ClientKey = ShortintClientKey


@dataclass
class ClientRadixCiphertext:
    """Client-side radix ciphertext, attribute-compatible with the
    serialization envelope of the server's ``RadixCiphertext``: numpy u64
    blocks (or an int64 tensor on a device the caller named)."""

    ct: object  # u64[..., num_blocks, dim+1]
    degrees: np.ndarray
    noise_levels: np.ndarray
    message_modulus: int
    carry_modulus: int

    @property
    def num_blocks(self) -> int:
        return self.ct.shape[-2]


def _radix_digits(values, num_blocks: int, message_modulus: int
                  ) -> np.ndarray:
    """The base-``message_modulus`` digits u64[..., num_blocks] of clear
    unsigned values, least significant first."""
    vals = np.atleast_1d(np.asarray(values, dtype=np.uint64))
    digits = np.zeros(vals.shape + (num_blocks,), dtype=np.uint64)
    v = vals.copy()
    for b in range(num_blocks):
        digits[..., b] = v % np.uint64(message_modulus)
        v //= np.uint64(message_modulus)
    return digits


def encrypt_radix(ck: ShortintClientKey, values, num_blocks: int,
                  device=None) -> ClientRadixCiphertext:
    """Clear integer(s) -> radix ciphertext with the same block
    decomposition and CSPRNG draw order as ``integer.ClientKey.
    encrypt_radix`` (reference integer/client_key/mod.rs), built without
    the server-side radix module; the blocks as numpy u64, or on
    ``device``."""
    mm = ck.params.message_modulus
    digits = _radix_digits(values, num_blocks, mm)
    ct = ck.encrypt(digits.reshape(-1))
    arr = ct.ct.reshape(digits.shape + (ct.ct.shape[-1],))
    if np.ndim(values) == 0:
        arr = arr[0]
    return ClientRadixCiphertext(
        ct=asarray(arr, device),
        degrees=np.full(num_blocks, mm - 1, dtype=np.int64),
        noise_levels=np.full(num_blocks, NOMINAL_NOISE, dtype=np.int64),
        message_modulus=mm,
        carry_modulus=ck.params.carry_modulus,
    )


def encrypt_signed_radix(ck: ShortintClientKey, values, num_blocks: int,
                         device=None) -> ClientRadixCiphertext:
    """Two's-complement encode then radix-encrypt (signed integers)."""
    bits = int(math.log2(ck.params.message_modulus)) * num_blocks
    vals = np.asarray(values, dtype=np.int64)
    enc = np.asarray(np.mod(vals.astype(object), 1 << bits), dtype=np.uint64)
    return encrypt_radix(ck, enc if vals.ndim else np.uint64(enc),
                         num_blocks, device)


def _as_shortint(ck: ShortintClientKey, payload) -> ShortintCiphertext:
    ct = payload.ct
    if not isinstance(ct, torch.Tensor):
        ct = asarray(ct, ck.device)
    return ShortintCiphertext(
        ct=ct, degree=payload.message_modulus - 1, noise_level=NOMINAL_NOISE,
        message_modulus=payload.message_modulus,
        carry_modulus=payload.carry_modulus,
        under_key=ck.encryption_key_and_noise[2])


def decrypt_radix(ck: ShortintClientKey, payload) -> np.ndarray:
    """Radix ciphertext (of the client or the server) -> clear unsigned
    values u64[...]."""
    digits = np.atleast_2d(ck.decrypt(_as_shortint(ck, payload)))
    mm = int(payload.message_modulus)
    scale = mm ** np.arange(digits.shape[-1], dtype=object)
    vals = (digits.astype(object) * scale).sum(axis=-1)
    return np.array([int(v) for v in np.atleast_1d(vals)], dtype=np.uint64)


def decrypt_signed_radix(ck: ShortintClientKey, payload) -> np.ndarray:
    mm = int(payload.message_modulus)
    bits = int(math.log2(mm)) * payload.ct.shape[-2]
    u = decrypt_radix(ck, payload)
    return np.where(
        u >= np.uint64(1 << (bits - 1)),
        u.astype(np.int64) - np.int64(1 << bits),
        u.astype(np.int64),
    )


def serialize_radix(payload) -> bytes:
    """Client radix ciphertext -> the standard ``RadixCiphertext``
    envelope (readable by the server's ``safe_deserialize``)."""
    return ser.serialize_radix(payload)


def serialize_client_key(ck: ShortintClientKey) -> bytes:
    return ser.serialize_shortint_client_key(ck)


# ---------------------------------------------------------------------------
# compact lists (js_on_wasm_api parity: the reference browser client builds
# CompactCiphertextLists, js_high_level_api/integers.rs)
# ---------------------------------------------------------------------------

def generate_compact_keys(cpk_params, seed: int = 0, device=None):
    """(CompactPrivateKey, CompactPublicKey) for a
    CompactPublicKeyEncryptionParameters set on ``device`` (the GPU when
    unset), the analog of ``TfheCompactPublicKey::new`` in the wasm
    client."""
    sk = CompactPrivateKey.generate(cpk_params, seed=seed, device=device)
    return sk, CompactPublicKey.generate(sk)


def build_compact_list(pk: CompactPublicKey, values, num_blocks: int):
    """Radix-decompose clear integers and pack them into ONE
    CompactCiphertextList under the compact public key (the
    CompactCiphertextListBuilder::push/build flow of
    js_high_level_api/integers.rs, without the server stack)."""
    mm = pk.params.message_modulus
    return pk.encrypt(_radix_digits(values, num_blocks, mm).reshape(-1))


def build_proven_compact_list(pk, values, num_blocks: int, crs,
                              metadata: bytes = b""):
    """build_compact_list + a ZK proof of encryption correctness per
    shared-mask bin (ProvenCompactCiphertextList::builder ...
    build_with_proof_packed in the wasm client). Proving runs on the host
    (the BLS12-446 library of ``csrc/bls446.c`` when cc built it, else the
    pure-Python curve)."""
    from .zk.proven_list import ProvenCompactCiphertextList

    mm = pk.params.message_modulus
    return ProvenCompactCiphertextList.encrypt_and_prove(
        pk, _radix_digits(values, num_blocks, mm).reshape(-1), crs,
        metadata=metadata)


def client_crs(cpk_params, max_bin_messages: int, seed: int = 0,
               scheme: str = "v2"):
    """CRS sized for the parameter set (CompactPkeCrs::from_config).
    ``scheme``: 'v2' (the reference default since v0.11) or 'v1'."""
    from .zk import proven_list as pl

    fn = pl.crs_for_params_v2 if scheme == "v2" else pl.crs_for_params
    return fn(cpk_params, max_bin_messages, seed=seed)


def serialize_compact_list(cl) -> bytes:
    return ser.serialize_compact_list(cl)


def serialize_proof(proof) -> bytes:
    return ser.serialize_zk_proof(proof)
