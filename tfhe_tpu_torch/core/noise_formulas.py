"""Closed-form noise variances the transform-variant gate reads.

The two first-principles formulas of ``tfhe_tpu/core/noise_formulas.py``
that ``shortint.server_key.variant_noise_margin_ok`` compares: the exact
blind rotation's own variance and the extra variance of a BNF-domain
rotation. Variances are torus-relative (reference ``Variance``).
"""

from __future__ import annotations


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
    """Extra additive variance of a BNF-domain blind rotation on top of
    :func:`blind_rotate_additive_variance_exact` (n-step total).

    - BSK rescale: each key coefficient is rounded once into Z_q', error
      uniform +-1/(2 q') torus, entering (k+1)*l*N MACs per step against
      balanced digits like a GGSW noise of variance 1/(12 q'^2);
    - switch-back truncation: acc32's ``qp_to_torus32`` error spans ~8
      units of 2^-32, acc64's ``qp_to_torus`` ~18 units of 2^-64.

    Both hit every GLWE component; a mask error rides a convolution with
    the binary GLWE secret, amplifying it by (1 + k*N/2)."""
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
