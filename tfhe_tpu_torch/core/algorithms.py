"""Core-crypto algorithms: secret keys, LWE encryption (over the u64 and
the u32 torus), trivial LWEs, GLWE and GGSW encryption, GLWE decryption,
keyswitch (u64 and KS32) and bootstrap key generation, and the bootstrap
key's exact CRT transform.

Torch counterpart of ``tfhe_tpu/core/algorithms.py``, the multi-bit
bootstrap key included. Random draws come from the host CSPRNG
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

from .._torus import from_u64
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


_MASK32 = 0xFFFFFFFF


def lwe_encrypt32(sk: LweSecretKey, plaintexts, noise: DynamicDistribution,
                  gen: EncryptionRandomGenerator) -> torch.Tensor:
    """LWE encryption over the u32 torus (the KS32 pattern's post-keyswitch
    modulus): masks then noise drawn as :func:`lwe_encrypt` draws them,
    each reduced to 32 bits. Returns int64[m, n+1] holding u32 values."""
    pts = np.atleast_1d(np.asarray(plaintexts, dtype=np.uint64))
    m, n = pts.shape[0], sk.dim
    dev = sk.bits.device
    masks = from_u64(gen.mask.uniform_u64(m * n).reshape(m, n)
                     & np.uint64(_MASK32), dev)
    es = from_u64(gen.sample_noise32(noise, m), dev)
    body = ((masks * sk.bits).sum(dim=1) + from_u64(pts, dev) + es) & _MASK32
    return torch.cat([masks, body[:, None]], dim=1)


def lwe_trivial(n: int, plaintexts, device) -> torch.Tensor:
    """Trivial (noiseless, maskless) LWEs of ``plaintexts``: int64[m, n+1]
    (reference ``lwe_encryption.rs`` trivial encrypt)."""
    pts = from_u64(np.atleast_1d(np.asarray(plaintexts, dtype=np.uint64)),
                   device)
    out = torch.zeros((pts.shape[0], n + 1), dtype=torch.int64, device=device)
    out[:, n] = pts
    return out


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
    product mod 2^64 (the same primes as the JAX package). The masks go
    through in slices of at most ``NTT_KEY_CHUNK_ENTRIES`` entries: a
    bootstrap key's are many GB at N = 32768, and each transform's
    temporaries P times that."""
    # ops/ is imported at use: the thin client (client.py) encrypts with
    # this module where the server stack is absent
    from ..ops import ntt as ntt_mod

    k, n = s_bits.shape
    num_primes = ntt_mod.min_primes_for_bound(
        ntt_mod.polymul_bound_bits(1, n, num_sums=k))
    plan = ntt_mod.get_plan(n, num_primes)
    P = plan.num_primes
    batch = masks.shape[:-2]
    p = plan.tables(masks.device)["p"].reshape(P, 1, 1, 1)
    s_hat = plan.fwd_digits(s_bits)  # [P, k, N]
    flat = masks.reshape(-1, k, n)
    out = torch.empty(flat.shape[0], n, dtype=torch.int64,
                      device=masks.device)
    step = max(1, NTT_KEY_CHUNK_ENTRIES // (k * n))
    for i in range(0, flat.shape[0], step):
        a_hat = plan.fwd(flat[i:i + step])  # [P, M, k, N]
        prod = torch.remainder(a_hat * s_hat[:, None], p)
        acc = torch.remainder(prod.sum(dim=2), p[..., 0])  # [P, M, N]
        out[i:i + step] = plan.reconstruct_u64(plan.inv(acc))
    return out.reshape(batch + (n,))


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


def glwe_decrypt(sk: GlweSecretKey, cts: torch.Tensor) -> torch.Tensor:
    """Raw plaintext polynomials (noise included): int64[m, k+1, N] (or
    [k+1, N]) -> int64[m, N]."""
    if cts.ndim == 2:
        cts = cts[None]
    k = sk.glwe_dim
    return cts[:, k] - _binary_polymul_batch(sk.bits, cts[:, :k])


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


def gen_keyswitch_key32(in_sk: LweSecretKey, out_sk: LweSecretKey,
                        base_log: int, levels: int,
                        noise: DynamicDistribution,
                        gen: EncryptionRandomGenerator) -> LweKeyswitchKey:
    """The KS32 keyswitch key: row i encrypts the big key's bit i over the
    u32 torus, summands bit << (32 - base_log * level)
    (``shortint/atomic_pattern/ks32.rs`` keygen). Rows are drawn as
    :func:`lwe_encrypt32` draws them, one row at a time; the arithmetic
    runs once for the whole key."""
    n_in, n_out = in_sk.dim, out_sk.dim
    masks = np.empty((n_in, levels, n_out), dtype=np.uint64)
    es = np.empty((n_in, levels), dtype=np.uint64)
    for i in range(n_in):
        masks[i] = gen.mask.uniform_u64(levels * n_out).reshape(levels, n_out)
        es[i] = gen.sample_noise32(noise, levels)
    dev = out_sk.bits.device
    masks_t = from_u64(masks & np.uint64(_MASK32), dev)
    shifts = torch.tensor([32 - base_log * (levels - j) for j in range(levels)],
                          dtype=torch.int64, device=dev)
    pts = (in_sk.bits.to(dev)[:, None] << shifts) & _MASK32
    body = ((masks_t * out_sk.bits).sum(dim=-1) + pts
            + from_u64(es, dev)) & _MASK32
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


def ggsw_encrypt(sk: GlweSecretKey, cleartext: int, base_log: int,
                 levels: int, noise: DynamicDistribution,
                 gen: EncryptionRandomGenerator) -> torch.Tensor:
    """GGSW encryption of a small cleartext: int64[l, k+1, k+1, N], its
    rows drawn in storage order (ggsw_encryption.rs:20-175)."""
    k, N = sk.bits.shape
    clear = torch.tensor([int(cleartext)], dtype=torch.int64,
                         device=sk.bits.device)
    msgs = _ggsw_messages(sk, clear, base_log, levels)
    rows = glwe_encrypt(sk, msgs.reshape(-1, N), noise, gen)
    return rows.reshape(levels, k + 1, k + 1, N)


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


def gen_multi_bit_bootstrap_key(in_sk: LweSecretKey, glwe_sk: GlweSecretKey,
                                base_log: int, levels: int, grouping: int,
                                noise: DynamicDistribution,
                                gen: EncryptionRandomGenerator
                                ) -> LweBootstrapKey:
    """Multi-bit BSK (``lwe_multi_bit_programmable_bootstrapping`` keygen):
    for each group of ``grouping`` small-key bits, GGSW encryptions of
    every nonempty subset product prod_{j in v} s_j, subset index v = 1 ..
    2^g - 1 a bitmask over the group; all rows in one batched draw, as
    ``tfhe_tpu`` draws them. Returns data int64[n/g, 2^g-1, l, k+1, k+1,
    N]."""
    n = in_sk.dim
    if n % grouping:
        raise ValueError(f"lwe_dimension {n} is not divisible by the "
                         f"grouping {grouping}")
    ngroups, nsub = n // grouping, (1 << grouping) - 1
    k, N = glwe_sk.bits.shape
    bits = in_sk.bits.to(glwe_sk.bits.device).reshape(ngroups, grouping)
    subsets = torch.tensor(
        [[(v >> j) & 1 for j in range(grouping)] for v in range(1, nsub + 1)],
        dtype=torch.bool, device=bits.device)  # [2^g-1, g]
    # prod over the subset's bits: 1 where every chosen bit is 1
    clear = torch.where(subsets[None], bits[:, None, :],
                        torch.ones_like(bits[:, None, :])).prod(dim=-1)
    msgs = _ggsw_messages(glwe_sk, clear.reshape(-1), base_log, levels)
    rows = glwe_encrypt(glwe_sk, msgs.reshape(-1, N), noise, gen)
    return LweBootstrapKey(
        rows.reshape(ngroups, nsub, levels, k + 1, k + 1, N), base_log,
        levels)


#: standard-domain entries :func:`bootstrap_key_to_ntt` (and the key
#: product of :func:`_binary_polymul_batch`) transforms at once: its int64
#: temporaries are a few times P such slices, not P keys (a multi-bit 3_3
#: key's 7.9 GB would need more than an 80 GB card at once)
NTT_KEY_CHUNK_ENTRIES = 1 << 24


def bootstrap_key_to_ntt(bsk: LweBootstrapKey,
                         num_primes: int) -> NttLweBootstrapKey:
    """Forward-transform every BSK polynomial over the first ``num_primes``
    PRIMES32 (the analog of ``fill_with_forward_fourier``,
    fft64/crypto/bootstrap.rs:199), on the key's device, with the Shoup dual
    floor(res * 2^32 / p) of every residue: one int64 division per entry,
    at keygen only (res < 2^30, so res << 32 stays below 2^62). Slices of
    the first axis of at most ``NTT_KEY_CHUNK_ENTRIES`` entries at a time,
    into one int32 [2, P, ...] result."""
    from ..ops import ntt as ntt_mod

    data = bsk.data
    plan = ntt_mod.get_plan(data.shape[-1], num_primes)
    out = torch.empty((2, num_primes) + tuple(data.shape), dtype=torch.int32,
                      device=data.device)
    step = max(1, NTT_KEY_CHUNK_ENTRIES // max(1, data[0].numel()))
    for i in range(0, data.shape[0], step):
        out[:, :, i:i + step] = ntt_mod.with_shoup_duals(
            plan.fwd(data[i:i + step]), plan)
    return NttLweBootstrapKey(residues=out, base_log=bsk.base_log,
                              levels=bsk.levels, num_primes=num_primes)
