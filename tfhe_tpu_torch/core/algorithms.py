"""Core-crypto algorithms of the main path: secret keys, LWE/GLWE
encryption, keyswitch and bootstrap key generation, and the bootstrap key's
exact CRT transform.

Torch counterpart of the subset of ``tfhe_tpu/core/algorithms.py`` the
shortint KS -> PBS path and the boolean layer need. Random draws come from the host CSPRNG
(``utils/csprng.py``) in the JAX package's documented order, so the same
seed gives byte-equal keys and ciphertexts; the arithmetic (dot products,
the negacyclic key products through the port's NTT) runs on the device of
the secret key.

Randomness consumption order:
  per LWE ct:   n mask u64s, then 1 noise sample
  per GLWE ct:  k*N mask u64s, then N noise samples (batched per call)
  per KSK row:  one LWE encryption of the row's l plaintexts
  per GGSW:     rows in storage order (level-major), one GLWE draw for all
"""

from __future__ import annotations

import numpy as np
import torch

from .._torus import from_u64, i64_to_u32
from ..ops import ntt as ntt_mod
from ..utils.csprng import EncryptionRandomGenerator, SecretRandomGenerator
from ..utils.params import DynamicDistribution
from .entities import (GlweSecretKey, LweBootstrapKey, LweKeyswitchKey,
                       LweSecretKey, NttLweBootstrapKey)


# ---------------------------------------------------------------------------
# secret keys
# ---------------------------------------------------------------------------

def gen_lwe_secret_key(dim: int, gen: SecretRandomGenerator,
                       device) -> LweSecretKey:
    return LweSecretKey(from_u64(gen.uniform_binary(dim), device))


def gen_glwe_secret_key(glwe_dim: int, poly_size: int,
                        gen: SecretRandomGenerator, device) -> GlweSecretKey:
    bits = gen.uniform_binary(glwe_dim * poly_size).reshape(glwe_dim,
                                                            poly_size)
    return GlweSecretKey(from_u64(bits, device))


# ---------------------------------------------------------------------------
# LWE encrypt / decrypt
# ---------------------------------------------------------------------------

def lwe_encrypt(sk: LweSecretKey, plaintexts, noise: DynamicDistribution,
                gen: EncryptionRandomGenerator) -> torch.Tensor:
    """Encrypt plaintexts (u64 array-like) -> int64[m, n+1]: masks then
    noise drawn per call, body = <a, s> + pt + e (lwe_encryption.rs)."""
    pts = np.atleast_1d(np.asarray(plaintexts, dtype=np.uint64))
    m = pts.shape[0]
    n = sk.dim
    dev = sk.bits.device
    masks = from_u64(gen.mask.uniform_u64(m * n).reshape(m, n), dev)
    es = from_u64(gen.sample_noise(noise, m), dev)
    body = (masks * sk.bits).sum(dim=1) + from_u64(pts, dev) + es
    return torch.cat([masks, body[:, None]], dim=1)


def lwe_decrypt(sk: LweSecretKey, cts: torch.Tensor) -> torch.Tensor:
    """Raw plaintexts (noise included): b - <a, s> (lwe_encryption.rs:519)."""
    cts = cts.reshape(-1, sk.dim + 1)
    return cts[:, sk.dim] - (cts[:, : sk.dim] * sk.bits).sum(dim=1)


# ---------------------------------------------------------------------------
# negacyclic product of the binary key with uniform masks
# ---------------------------------------------------------------------------

def _binary_polymul_batch(s_bits: torch.Tensor,
                          masks: torch.Tensor) -> torch.Tensor:
    """sum_i s_i(X) * a_i(X) mod (X^N + 1, 2^64) for a batch, exact.

    ``s_bits``: int64[k, N] binary; ``masks``: int64[..., k, N] ->
    int64[..., N]. The CRT-NTT plan has enough primes for the
    1 + 64 + log2(N) + log2(k) bit bound, so the result is the exact
    product mod 2^64 (the same primes as the JAX package)."""
    k, n = s_bits.shape
    num_primes = ntt_mod.min_primes_for_bound(
        ntt_mod.polymul_bound_bits(1, n, num_sums=k))
    plan = ntt_mod.get_plan(n, num_primes)
    P = plan.num_primes
    batch = masks.shape[:-2]
    p = plan.tables(masks.device)["p"].reshape(P, 1, 1, 1)
    s_hat = plan.fwd_digits(s_bits)  # [P, k, N]
    a_hat = plan.fwd(masks.reshape(-1, k, n))  # [P, M, k, N]
    prod = torch.remainder(a_hat * s_hat[:, None], p)
    acc = torch.remainder(prod.sum(dim=2), p[..., 0])  # [P, M, N]
    return plan.reconstruct_u64(plan.inv(acc)).reshape(batch + (n,))


# ---------------------------------------------------------------------------
# GLWE encrypt
# ---------------------------------------------------------------------------

def glwe_encrypt(sk: GlweSecretKey, plaintext_polys: torch.Tensor,
                 noise: DynamicDistribution,
                 gen: EncryptionRandomGenerator) -> torch.Tensor:
    """Encrypt plaintext polynomials int64[m, N] -> int64[m, k+1, N]."""
    pts = plaintext_polys
    if pts.ndim == 1:
        pts = pts[None]
    m, N = pts.shape
    k = sk.glwe_dim
    assert N == sk.poly_size
    dev = sk.bits.device
    masks = from_u64(gen.mask.uniform_u64(m * k * N).reshape(m, k, N), dev)
    noises = from_u64(gen.sample_noise(noise, m * N).reshape(m, N), dev)
    body = _binary_polymul_batch(sk.bits, masks) + pts + noises
    return torch.cat([masks, body[:, None, :]], dim=1)


# ---------------------------------------------------------------------------
# keyswitch key
# ---------------------------------------------------------------------------

def gen_keyswitch_key(in_sk: LweSecretKey, out_sk: LweSecretKey,
                      base_log: int, levels: int,
                      noise: DynamicDistribution,
                      gen: EncryptionRandomGenerator) -> LweKeyswitchKey:
    """KSK[i, j] = Enc_out(s_in_i * q / B^(levels - j)): block 0 holds the
    level-``levels`` summand, aligned with the decomposition order
    (lwe_keyswitch_key_generation.rs:175-190). Each row is one LWE
    encryption of its ``levels`` plaintexts (masks, then noise), drawn row
    by row; the arithmetic runs once for the whole key."""
    n_in, n_out = in_sk.dim, out_sk.dim
    masks = np.empty((n_in, levels, n_out), dtype=np.uint64)
    es = np.empty((n_in, levels), dtype=np.uint64)
    for i in range(n_in):
        masks[i] = gen.mask.uniform_u64(levels * n_out).reshape(levels, n_out)
        es[i] = gen.sample_noise(noise, levels)
    dev = out_sk.bits.device
    masks_t = from_u64(masks, dev)
    shifts = torch.tensor([64 - base_log * (levels - j) for j in range(levels)],
                          dtype=torch.int64, device=dev)
    pts = in_sk.bits.to(dev)[:, None] << shifts  # recomposition summands
    body = (masks_t * out_sk.bits).sum(dim=-1) + pts + from_u64(es, dev)
    data = torch.cat([masks_t, body[..., None]], dim=-1)
    return LweKeyswitchKey(data, base_log, levels)


# ---------------------------------------------------------------------------
# GGSW + bootstrap key
# ---------------------------------------------------------------------------

def _ggsw_messages(sk: GlweSecretKey, cleartexts: torch.Tensor,
                   base_log: int, levels: int) -> torch.Tensor:
    """Message polynomials of GGSW rows for a vector of cleartexts:
    int64[m, l, k+1, N]; level-matrix index j holds factor
    -m * q/B^(levels-j); row r message = factor * s_r, last row = -factor
    in the constant coefficient (ggsw_encryption.rs:20-44)."""
    k, N = sk.bits.shape
    m = cleartexts.shape[0]
    msgs = torch.zeros((m, levels, k + 1, N), dtype=torch.int64,
                       device=sk.bits.device)
    for j in range(levels):
        factor = (-cleartexts) << (64 - base_log * (levels - j))  # [m]
        for r in range(k):
            msgs[:, j, r] = sk.bits[r][None, :] * factor[:, None]
        msgs[:, j, k, 0] = -factor
    return msgs


def gen_bootstrap_key(in_sk: LweSecretKey, glwe_sk: GlweSecretKey,
                      base_log: int, levels: int,
                      noise: DynamicDistribution,
                      gen: EncryptionRandomGenerator) -> LweBootstrapKey:
    """One GGSW of each small-key bit under the GLWE key, all rows in one
    batched draw and one batched key product (row-major over (key bit,
    level, row) for both streams)."""
    n = in_sk.dim
    k, N = glwe_sk.bits.shape
    msgs = _ggsw_messages(glwe_sk, in_sk.bits.to(glwe_sk.bits.device),
                          base_log, levels)
    rows = glwe_encrypt(glwe_sk, msgs.reshape(-1, N), noise, gen)
    return LweBootstrapKey(rows.reshape(n, levels, k + 1, k + 1, N),
                           base_log, levels)


def bootstrap_key_to_ntt(bsk: LweBootstrapKey,
                         num_primes: int) -> NttLweBootstrapKey:
    """Forward-transform every BSK polynomial over the first ``num_primes``
    PRIMES32 (the analog of ``fill_with_forward_fourier``,
    fft64/crypto/bootstrap.rs:199), on the key's device, with the Shoup dual
    floor(res * 2^32 / p) of every residue: one int64 division per entry,
    at keygen only (res < 2^30, so res << 32 stays below 2^62)."""
    N = bsk.data.shape[-1]
    plan = ntt_mod.get_plan(N, num_primes)
    res = plan.fwd(bsk.data)  # [P, n, l, k+1, k+1, N]
    p = plan.tables(res.device)["p"].reshape(
        (num_primes,) + (1,) * (res.ndim - 1))
    shoup = torch.div(res << 32, p, rounding_mode="floor")
    return NttLweBootstrapKey(
        residues=i64_to_u32(torch.stack([res, shoup])).contiguous(),
        base_log=bsk.base_log, levels=bsk.levels, num_primes=num_primes)
