"""Oblivious PRF: encrypted uniform randomness from a public seed.

Torch counterpart of ``tfhe_tpu/shortint/oprf.py`` (reference
``tfhe/src/shortint/oprf.rs``): a SHAKE256 XOF expands the seed into a
pseudorandom LWE mask (body 0) whose phase -<a, s> is uniform and unknown
to everyone; one blind rotation with a staircase accumulator shapes it into
an encryption of a uniform value in [0, 2^random_bits_count).

LUT recipe (oprf.rs:185-255): acc[x] = (2*(x // poly_delta) + 1) * delta / 2
with poly_delta = 2N / 2^bits (no box encoding), then a final plaintext add
of degree * delta / 2. The PBS switches with the standard rounding and runs
on the exact CRT key (K2 u64 -> K3, or K2 acc32 -> K3-acc32 under
``TFHE_V4_ACC=32``) under v6/v6b/crt, on the Goldilocks key (K2 u64 ->
K4) under v5, and on a multi-bit key's (K2 u64 -> K5) whatever the
variant (``tfhe_tpu``'s ``oprf.py:69-74``).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .._torus import from_u64, u64_const
from ..ops import server as server_ops
from .ciphertext import NOMINAL_NOISE, ShortintCiphertext


def sha3_hash_u64(seed: int, count: int) -> np.ndarray:
    """SHAKE256(seed_le_8bytes) -> ``count`` little-endian u64
    (oprf.rs:98)."""
    reader = hashlib.shake_256(int(seed).to_bytes(8, "little", signed=False))
    return np.frombuffer(reader.digest(count * 8), dtype="<u8").copy()


def create_random_from_seed(seed: int, lwe_dimension: int) -> np.ndarray:
    """The seeded LWE: XOF mask, zero body (oprf.rs
    create_random_from_seed); u64[lwe_dimension + 1]."""
    ct = np.zeros(lwe_dimension + 1, dtype=np.uint64)
    ct[:lwe_dimension] = sha3_hash_u64(seed, lwe_dimension)
    return ct


def _full_bits(p) -> int:
    """Message + carry + the padding bit."""
    return int(np.log2(p.message_modulus * p.carry_modulus)) + 1


def staircase_accumulator(p, random_bits_count: int) -> np.ndarray:
    """The OPRF's accumulator u64[k+1, N]: a staircase body, no box
    encoding."""
    if (1 << random_bits_count) > p.message_modulus * p.carry_modulus:
        raise ValueError(f"{random_bits_count} random bits do not fit "
                         f"message and carry")
    N = p.polynomial_size
    delta = np.uint64(1 << (64 - _full_bits(p)))
    poly_delta = np.uint64(2 * N // (1 << random_bits_count))
    j = np.arange(N, dtype=np.uint64)
    acc = np.zeros((p.glwe_size, N), dtype=np.uint64)
    acc[-1] = (2 * (j // poly_delta) + 1) * delta // np.uint64(2)
    return acc


def oblivious_pseudo_random_batch(server_key, seeds, random_bits_counts
                                  ) -> torch.Tensor:
    """The OPRF of several seeds in ONE batched PBS: int64[m, k*N + 1]
    under the big key, row i the encryption of a uniform value in
    [0, 2^random_bits_counts[i]). Each row equals the single-seed OPRF of
    its seed: every PBS of the batch is independent."""
    sk = server_key
    p = sk.params
    dev = sk.device
    bits = [int(b) for b in random_bits_counts]
    cts = from_u64(np.stack([create_random_from_seed(int(s), p.lwe_dimension)
                             for s in seeds]), dev)
    accs = {b: staircase_accumulator(p, b) for b in bits}
    if len(accs) == 1:
        lut = from_u64(accs[bits[0]], dev)
    else:
        lut = from_u64(np.stack([accs[b] for b in bits]), dev)
    _, rotated = sk._rotate(cts, lut, False, 64)
    out = server_ops.sample_extract(rotated, 0)
    delta = 1 << (64 - _full_bits(p))
    plain = torch.tensor([u64_const(((1 << b) - 1) * delta // 2)
                          for b in bits], dtype=torch.int64, device=dev)
    out[:, -1] += plain
    return out


def generate_oblivious_pseudo_random(server_key, seed: int,
                                     random_bits_count: int
                                     ) -> ShortintCiphertext:
    """Encrypted uniform value in [0, 2^random_bits_count)
    (generate_oblivious_pseudo_random_message_and_carry)."""
    p = server_key.params
    out = oblivious_pseudo_random_batch(server_key, [seed],
                                        [random_bits_count])[0]
    return ShortintCiphertext(
        ct=out, degree=(1 << random_bits_count) - 1,
        noise_level=NOMINAL_NOISE, message_modulus=p.message_modulus,
        carry_modulus=p.carry_modulus, under_key="big")
