"""Closed-form noise-variance formulas + an analytic noise-simulation engine
(the port's copy of ``tfhe_tpu/core/noise_formulas.py``).

Reference: ``tfhe/src/core_crypto/commons/noise_formulas/`` — per-op additive
variance formulas (lwe_keyswitch.rs, lwe_programmable_bootstrap.rs,
modulus_switch.rs) and the ``noise_simulation`` engine (mod.rs:8-88) whose
simulated ciphertexts propagate variance instead of data.

Two families here:

- *fitted* formulas reproducing the reference's published
  132-bit-security models (only valid for keys at secure noise levels);
- *first-principles* formulas valid for arbitrary key noise (the
  transform-variant gate of ``shortint.server_key`` reads two of them).

All variances are torus-relative (modulus-normalized), like the reference's
``Variance`` type.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

from ..utils.params import ModulusSwitchType

LOG2_E = math.log2(math.e)


# ---------------------------------------------------------------------------
# fitted 132-bit-security formulas (reference autogenerated models)
# ---------------------------------------------------------------------------

def keyswitch_additive_variance_gaussian(
    input_lwe_dimension: int,
    output_lwe_dimension: int,
    decomposition_base_log: int,
    decomposition_level_count: int,
    input_modulus: float = 2.0 ** 64,
    output_modulus: float = 2.0 ** 64,
) -> float:
    """Reference keyswitch_additive_variance_132_bits_security_gaussian
    (noise_formulas/lwe_keyswitch.rs:35-53)."""
    n_in = float(input_lwe_dimension)
    n_out = float(output_lwe_dimension)
    b = 2.0 ** decomposition_base_log
    l = float(decomposition_level_count)
    return (
        l * n_in
        * (2.0 ** (4.0 - 2.88539008177793 * math.log(output_modulus))
           + 2.0 ** (5.31469187675068 - 0.0497829131652661 * n_out))
        * (b ** 2 / 12.0 + 1.0 / 6.0)
        + n_in * (0.0208333333333333 * input_modulus ** -2.0
                  + 0.0416666666666667 * b ** (-2.0 * l))
        - input_modulus ** -2.0 / 12.0
        + output_modulus ** -2.0 / 12.0
    )


def pbs_additive_variance_gaussian(
    input_lwe_dimension: int,
    output_glwe_dimension: int,
    output_polynomial_size: int,
    decomposition_base_log: int,
    decomposition_level_count: int,
    modulus: float = 2.0 ** 64,
) -> float:
    """Reference pbs_variance_132_bits_security_gaussian_fft_mul
    (noise_formulas/lwe_programmable_bootstrap.rs:13-102). The fft-precision
    term models the reference's f64 FFT; the exact-NTT path has zero
    transform error, so this is an upper bound for us."""
    n = float(input_lwe_dimension)
    k = float(output_glwe_dimension)
    N = float(output_polynomial_size)
    b = 2.0 ** decomposition_base_log
    l = float(decomposition_level_count)
    lnq = math.log(modulus)
    fft_exp = max(0.0, LOG2_E * lnq - 53.0)
    return n * (
        0.00705
        * 2.0 ** (2.0 * fft_exp + 2.88539008177793 * math.log(b)
                  - 2.88539008177793 * lnq)
        * l ** 1.01827 * k ** 1.22003 * N ** 2.22003 * (k + 1.0) ** 1.01827
        + l * N
        * (2.0 ** (4.0 - 2.88539008177793 * lnq)
           + 2.0 ** (-0.0497829131652661 * k * N + 5.31469187675068))
        * (b ** 2 / 12.0 + 1.0 / 6.0) * (k + 1.0)
        - modulus ** -2.0 / 24.0
        + 0.5 * k * N * (0.0208333333333333 * modulus ** -2.0
                         + 0.0416666666666667 * b ** (-2.0 * l))
        + b ** (-2.0 * l) / 24.0
    )


# ---------------------------------------------------------------------------
# first-principles formulas (arbitrary key noise; binary secrets)
# ---------------------------------------------------------------------------

def keyswitch_additive_variance_exact(
    input_lwe_dimension: int,
    decomposition_base_log: int,
    decomposition_level_count: int,
    ksk_noise_variance: float,
) -> float:
    """KS error = sum_j trunc_j * s_j + sum_{j,lev} digit * e_ksk.

    - truncation: per element uniform in +-B^-l/2 (torus), Var = B^-2l/12,
      against binary s (E[s^2] = 1/2);
    - MAC noise: n*l MACs with E[digit^2] = B^2/12 + 1/6 (balanced digits).
    """
    n = float(input_lwe_dimension)
    b = 2.0 ** decomposition_base_log
    l = float(decomposition_level_count)
    e_d2 = b ** 2 / 12.0 + 1.0 / 6.0
    return n * l * e_d2 * ksk_noise_variance + n * 0.5 * b ** (-2.0 * l) / 12.0


def modulus_switch_additive_variance(
    lwe_dimension: int, log_modulus: int, centered_mean: bool = False
) -> float:
    """Rounding to the 2N grid: per-element error uniform +-2^-(log+1),
    body + n binary-weighted mask terms (modulus_switch.rs). The
    centered-mean noise reduction subtracts half of each rounding error from
    the body, halving the mask contribution (algorithms/modulus_switch
    .rs:35-104) — this is what carries the 2_2 parameters from ~2^-75 to
    their advertised ~2^-128 pfail."""
    n = float(lwe_dimension)
    step_var = (2.0 ** -log_modulus) ** 2 / 12.0
    mask_factor = 0.25 if centered_mean else 0.5
    return step_var * (1.0 + n * mask_factor)


def external_product_additive_variance_exact(
    glwe_dimension: int,
    polynomial_size: int,
    decomposition_base_log: int,
    decomposition_level_count: int,
    ggsw_noise_variance: float,
) -> float:
    """One external product: (k+1)*l*N MACs of digit x GGSW-noise plus the
    decomposition truncation on (k+1) polynomials."""
    k = float(glwe_dimension)
    N = float(polynomial_size)
    b = 2.0 ** decomposition_base_log
    l = float(decomposition_level_count)
    e_d2 = b ** 2 / 12.0 + 1.0 / 6.0
    mac = (k + 1.0) * l * N * e_d2 * ggsw_noise_variance
    trunc = (1.0 + k * N * 0.5) * b ** (-2.0 * l) / 12.0
    return mac + trunc


def blind_rotate_additive_variance_exact(
    input_lwe_dimension: int,
    glwe_dimension: int,
    polynomial_size: int,
    decomposition_base_log: int,
    decomposition_level_count: int,
    bsk_noise_variance: float,
) -> float:
    """n sequential external products (exact NTT: no transform error)."""
    return input_lwe_dimension * external_product_additive_variance_exact(
        glwe_dimension, polynomial_size, decomposition_base_log,
        decomposition_level_count, bsk_noise_variance,
    )


def bnf_blind_rotate_extra_variance(
    input_lwe_dimension: int,
    glwe_dimension: int,
    polynomial_size: int,
    decomposition_base_log: int,
    decomposition_level_count: int,
    transform_modulus: float,
    acc32: bool = True,
    acc32_err_span: float = 2.0 * 4.0,
    acc64_err_span: float = 18.0,
) -> float:
    """Extra additive variance of a BNF-domain blind rotation (v5/v6
    kernels) on top of :func:`blind_rotate_additive_variance_exact` —
    torus-relative, n-step total.  Empirically validated (ratio asserted)
    in ``tfhe_tpu``'s tests/test_noise.py.

    Three approximation sources (ops/bnf2.py arithmetic model; the same
    formula covers v5 with ``transform_modulus`` = the Goldilocks prime):

    - *BSK rescale*: each key coefficient is rounded ONCE into Z_q'
      (``torus_to_qp``), error uniform +-0.5 q'-units = +-1/(2 q') torus.
      Per step it enters (k+1)*l*N MACs against balanced digits
      (E[d^2] = B^2/12 + 1/6), like a GGSW noise of variance 1/(12 q'^2).
    - *switch-back truncation*: acc32 mode produces the increment directly
      as a hi-plane value (``qp_to_torus32``) with |error| <= ~4 units of
      2^-32 after centering (span 8); acc64's ``qp_to_torus`` undershoot
      spans ~18 units of 2^-64.
    - *acc32 increment rounding* is subsumed by the span above (the
      one-time initial-accumulator rounding, variance 2^-64/12, is
      negligible and omitted).

    Both sources hit EVERY GLWE component of the step output, including
    the k mask polynomials; at the phase level a mask error rides a
    convolution with the binary GLWE secret (N/2 expected taps), so the
    per-unit variance is amplified by (1 + k*N/2).
    """
    n = float(input_lwe_dimension)
    k = float(glwe_dimension)
    N = float(polynomial_size)
    b = 2.0 ** decomposition_base_log
    l = float(decomposition_level_count)
    e_d2 = b ** 2 / 12.0 + 1.0 / 6.0
    mask_amp = 1.0 + k * N / 2.0
    rescale = (k + 1.0) * l * N * e_d2 / (12.0 * transform_modulus ** 2)
    if acc32:
        switch = (acc32_err_span * 2.0 ** -32) ** 2 / 12.0
    else:
        switch = (acc64_err_span * 2.0 ** -64) ** 2 / 12.0
    return n * mask_amp * (rescale + switch)


# ---------------------------------------------------------------------------
# noise simulation engine (noise_formulas/noise_simulation/mod.rs:8-88)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NoiseSimulationLwe:
    """A 'ciphertext' that carries only its dimension + noise variance."""

    lwe_dimension: int
    variance: float
    modulus: float = 2.0 ** 64


class NoiseSimulationEngine:
    """Propagates variance through the atomic pattern analytically — the
    tool for pfail budgeting without running any crypto."""

    def __init__(self, params):
        self.p = params

    def encrypt(self) -> NoiseSimulationLwe:
        p = self.p
        sigma = p.glwe_noise_distribution.std_dev
        return NoiseSimulationLwe(p.big_lwe_dimension, sigma * sigma)

    def add(self, a: NoiseSimulationLwe, b: NoiseSimulationLwe) -> NoiseSimulationLwe:
        assert a.lwe_dimension == b.lwe_dimension
        return replace(a, variance=a.variance + b.variance)

    def scalar_mul(self, a: NoiseSimulationLwe, scalar: int) -> NoiseSimulationLwe:
        return replace(a, variance=a.variance * scalar * scalar)

    def keyswitch(self, a: NoiseSimulationLwe) -> NoiseSimulationLwe:
        p = self.p
        sig = p.lwe_noise_distribution.std_dev
        add = keyswitch_additive_variance_exact(
            a.lwe_dimension, p.ks_base_log, p.ks_level, sig * sig
        )
        return NoiseSimulationLwe(p.lwe_dimension, a.variance + add)

    def pbs(self, a: NoiseSimulationLwe) -> NoiseSimulationLwe:
        """PBS RESETS the noise: output variance is the blind-rotation
        accumulation only (input noise only affects pfail)."""
        p = self.p
        sig = p.glwe_noise_distribution.std_dev
        var = blind_rotate_additive_variance_exact(
            p.lwe_dimension, p.glwe_dimension, p.polynomial_size,
            p.pbs_base_log, p.pbs_level, sig * sig,
        )
        return NoiseSimulationLwe(p.big_lwe_dimension, var)

    def atomic_pattern(self, a: NoiseSimulationLwe) -> NoiseSimulationLwe:
        return self.pbs(self.keyswitch(a))

    def pfail_per_pbs(self, a: NoiseSimulationLwe) -> float:
        """P[|pre-rotation error| > box/2] under a gaussian model: the error
        entering the rotation is input + KS + mod-switch."""
        p = self.p
        after_ks = self.keyswitch(a)
        log2n = int(math.log2(2 * p.polynomial_size))
        centered = (
            getattr(p, "modulus_switch_type", None)
            == ModulusSwitchType.CENTERED_MEAN_NOISE_REDUCTION
        )
        total = after_ks.variance + modulus_switch_additive_variance(
            p.lwe_dimension, log2n, centered_mean=centered
        )
        box_half = 1.0 / (4.0 * p.message_modulus * p.carry_modulus)
        z = box_half / math.sqrt(total)
        return math.erfc(z / math.sqrt(2.0))
