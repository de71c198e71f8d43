"""Reference-exact CSPRNG fork budgets and sequential sampling (the port's
copy of ``tfhe_tpu/utils/fork_budgets.py``).

The reference makes parallel keygen/encryption bit-identical to serial by
statically pre-assigning each child generator a byte budget
(``commons/generators/encryption/mod.rs:26-66``,
``noise_random_generator.rs:28-62``,
``tfhe-csprng/src/generators/aes_ctr/parallel.rs``). This module reproduces
that arithmetic exactly:

- per-sample byte counts per distribution (uniform: scalar width; gaussian
  pair: 16 bytes x ceil(-128 / log2(1 - pi/4)) = 58 attempts = 928 bytes,
  from PER_SAMPLE_TARGET_FAILURE_PROBABILITY_LOG2 = -128; t-uniform:
  ceil((bound_log2 + 2) / 8), rejection-free);
- per-entity mask/noise element counts (LWE, GLWE, GGSW, BSK, KSK);
- a strictly sequential Marsaglia-polar torus-gaussian sampler consuming
  the stream exactly like ``math/random/gaussian.rs:42-70`` (16 bytes per
  attempt, pairwise, Rust round-half-away-from-zero);
- fork helpers so parallel == serial byte-for-byte.

The default keygen (``core/algorithms.py``) uses a simpler batched draw
order; this module is the opt-in reference-compatible mode
(``ServerKey.generate(reference_forks=True)``). The draws are host numpy;
the key's arithmetic runs on the secret key's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .._torus import from_u64
from ..core import algorithms as algo
from ..core.entities import LweBootstrapKey
from .csprng import AesCtrGenerator, EncryptionRandomGenerator
from .params import DynamicDistribution

PER_SAMPLE_TARGET_FAILURE_PROBABILITY_LOG2 = -128.0

_U64 = np.uint64


# ---------------------------------------------------------------------------
# per-sample byte counts (math/random/{gaussian,t_uniform,uniform}.rs)
# ---------------------------------------------------------------------------

def uniform_sample_bytes(scalar_bytes: int = 8) -> int:
    return scalar_bytes


def gaussian_pair_attempt_bytes(scalar_bytes: int = 8) -> int:
    """One Marsaglia-polar attempt draws two raw integers."""
    return 2 * scalar_bytes


def gaussian_min_attempts() -> int:
    """ceil(-128 / log2(1 - pi/4)) — the margin factor making a
    budget-exhaustion failure rarer than 2^-128."""
    p_fail = 1.0 - math.pi / 4.0
    return math.ceil(
        PER_SAMPLE_TARGET_FAILURE_PROBABILITY_LOG2 / math.log2(p_fail)
    )


def t_uniform_sample_bytes(bound_log2: int) -> int:
    return (bound_log2 + 2 + 7) // 8


def noise_bytes_per_element(dist: DynamicDistribution, scalar_bytes: int = 8) -> int:
    """noise_random_generator.rs:33-56."""
    if dist.kind == "gaussian":
        return gaussian_pair_attempt_bytes(scalar_bytes) * gaussian_min_attempts()
    return t_uniform_sample_bytes(dist.bound_log2)


# ---------------------------------------------------------------------------
# per-entity element counts (the fork configs built at the call sites)
# ---------------------------------------------------------------------------

def lwe_mask_elements(n: int) -> int:
    return n


def lwe_noise_elements() -> int:
    return 1


def glwe_mask_elements(k: int, N: int) -> int:
    return k * N


def glwe_noise_elements(N: int) -> int:
    return N


def ggsw_mask_elements(k: int, N: int, levels: int) -> int:
    # l*(k+1) GLWE rows, each with k mask polynomials
    return levels * (k + 1) * k * N


def ggsw_noise_elements(k: int, N: int, levels: int) -> int:
    return levels * (k + 1) * N


@dataclass(frozen=True)
class ForkConfig:
    """children_count x (mask_bytes, noise_bytes) per child
    (EncryptionRandomGeneratorForkConfig)."""

    children_count: int
    mask_bytes_per_child: int
    noise_bytes_per_child: int


def bsk_fork_config(
    n: int, k: int, N: int, levels: int, noise_dist: DynamicDistribution
) -> ForkConfig:
    """BSK keygen forks one child per input key bit (one GGSW each),
    lwe_bootstrap_key encryption_fork_config."""
    return ForkConfig(
        children_count=n,
        mask_bytes_per_child=ggsw_mask_elements(k, N, levels) * 8,
        noise_bytes_per_child=ggsw_noise_elements(k, N, levels)
        * noise_bytes_per_element(noise_dist),
    )


def ggsw_fork_config(
    k: int, N: int, levels: int, noise_dist: DynamicDistribution
) -> ForkConfig:
    """A GGSW forks into l*(k+1) GLWE-row children."""
    return ForkConfig(
        children_count=levels * (k + 1),
        mask_bytes_per_child=glwe_mask_elements(k, N) * 8,
        noise_bytes_per_child=glwe_noise_elements(N)
        * noise_bytes_per_element(noise_dist),
    )


def ksk_fork_config(
    n_in: int, n_out: int, levels: int, noise_dist: DynamicDistribution
) -> ForkConfig:
    """KSK keygen forks one child per input key bit (l LWEs each)."""
    return ForkConfig(
        children_count=n_in,
        mask_bytes_per_child=levels * lwe_mask_elements(n_out) * 8,
        noise_bytes_per_child=levels * lwe_noise_elements()
        * noise_bytes_per_element(noise_dist),
    )


def lwe_list_fork_config(
    count: int, n: int, noise_dist: DynamicDistribution
) -> ForkConfig:
    """Encrypting a list of LWEs forks one child per ciphertext."""
    return ForkConfig(
        children_count=count,
        mask_bytes_per_child=lwe_mask_elements(n) * 8,
        noise_bytes_per_child=lwe_noise_elements()
        * noise_bytes_per_element(noise_dist),
    )


def fork(gen: EncryptionRandomGenerator, config: ForkConfig):
    """Split both streams per the config; parent jumps past all children
    (AesCtrGenerator::par_try_fork semantics)."""
    return gen.fork(
        config.children_count,
        config.mask_bytes_per_child,
        config.noise_bytes_per_child,
    )


# ---------------------------------------------------------------------------
# sequential reference-order sampling (gaussian.rs:42-70 exactly)
# ---------------------------------------------------------------------------

def _rust_round(x: float) -> int:
    """f64::round — half away from zero (numpy rounds half to even)."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def _from_torus(x: float) -> np.uint64:
    """FromTorus<f64>: torus-fractional part scaled to 2^64, wrapping."""
    frac = x - _rust_round(x)
    return _U64(_rust_round(frac * (2.0 ** 64)) % (1 << 64))


def gaussian_pair_reference(gen: AesCtrGenerator, std: float, mean: float = 0.0):
    """One Marsaglia-polar pair with the reference's exact stream
    consumption: 8 bytes u then 8 bytes v per attempt, i64 scaled by
    2^-63, retry until 0 < s < 1."""
    while True:
        u_bytes = gen.next_bytes(8)
        v_bytes = gen.next_bytes(8)
        u = float(int.from_bytes(bytes(u_bytes.tolist()), "little", signed=True))
        v = float(int.from_bytes(bytes(v_bytes.tolist()), "little", signed=True))
        u *= 2.0 ** -63
        v *= 2.0 ** -63
        s = u * u + v * v
        if 0.0 < s < 1.0:
            cst = std * math.sqrt(-2.0 * math.log(s) / s)
            return u * cst + mean, v * cst + mean


def gaussian_torus_u64_reference(
    gen: AesCtrGenerator, count: int, std: float, mean: float = 0.0
) -> np.ndarray:
    """``count`` torus samples consumed exactly like the reference slice
    fill: pairwise, with a final pair-draw-discard-one for odd counts."""
    out = np.zeros(count, dtype=_U64)
    i = 0
    while i + 1 < count:
        a, b = gaussian_pair_reference(gen, std, mean)
        out[i] = _from_torus(a)
        out[i + 1] = _from_torus(b)
        i += 2
    if i < count:
        a, _ = gaussian_pair_reference(gen, std, mean)
        out[i] = _from_torus(a)
    return out


def sample_noise_reference(
    gen: AesCtrGenerator, dist: DynamicDistribution, count: int
) -> np.ndarray:
    if dist.kind == "gaussian":
        return gaussian_torus_u64_reference(gen, count, dist.std_dev)
    # t-uniform is rejection-free; the batched sampler already consumes
    # ceil((b+2)/8) bytes per sample little-endian, matching t_uniform.rs
    return gen.t_uniform_torus_u64(count, dist.bound_log2)


# ---------------------------------------------------------------------------
# reference-forked BSK keygen (parallel == serial bit-for-bit)
# ---------------------------------------------------------------------------

def gen_bootstrap_key_reference_forks(
    in_sk,
    glwe_sk,
    base_log: int,
    levels: int,
    noise_dist: DynamicDistribution,
    gen: EncryptionRandomGenerator,
):
    """BSK with the reference's hierarchical fork layout: one child per key
    bit, then one grandchild per GGSW row; each row draws mask then noise
    from its own bounded stream. Returns LweBootstrapKey (int64 on the GLWE
    key's device); any subset of the children may be generated on any
    worker and the bytes are identical. The rows' key products run once,
    batched, after the draws."""
    n = in_sk.dim
    k, N = glwe_sk.bits.shape
    R = k + 1
    cfg = bsk_fork_config(n, k, N, levels, noise_dist)
    children = fork(gen, cfg)
    row_cfg = ggsw_fork_config(k, N, levels, noise_dist)
    masks = np.zeros((n, levels * R, k, N), dtype=_U64)
    noises = np.zeros((n, levels * R, N), dtype=_U64)
    for i, child in enumerate(children):
        for r_idx, row_gen in enumerate(fork(child, row_cfg)):
            masks[i, r_idx] = row_gen.mask.uniform_u64(k * N).reshape(k, N)
            noises[i, r_idx] = sample_noise_reference(row_gen.noise,
                                                      noise_dist, N)
    dev = glwe_sk.bits.device
    msgs = algo._ggsw_messages(glwe_sk, in_sk.bits.to(dev), base_log, levels)
    masks_t = from_u64(masks.reshape(-1, k, N), dev)
    body = (algo._binary_polymul_batch(glwe_sk.bits, masks_t)
            + msgs.reshape(-1, N) + from_u64(noises.reshape(-1, N), dev))
    rows = torch.cat([masks_t, body[:, None]], dim=1)
    return LweBootstrapKey(rows.reshape(n, levels, R, R, N), base_log, levels)
