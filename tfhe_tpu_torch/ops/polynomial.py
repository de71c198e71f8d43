"""Negacyclic monomial products on the torus (mod X^N + 1, coeffs mod 2^64).

Torch counterpart of ``tfhe_tpu/ops/polynomial.py``; vectorized over
leading batch dims, with a per-row degree (the blind-rotation case).
Reference: ``core_crypto/algorithms/polynomial_algorithms.rs``
(``polynomial_wrapping_monic_monomial_{mul,div}``).
"""

from __future__ import annotations

import torch


def monomial_mul(poly: torch.Tensor, degree) -> torch.Tensor:
    """``poly * X^degree (mod X^N + 1)`` with wrapping coefficients.

    ``poly``: int64[..., N] torus values; ``degree``: integer tensor
    broadcastable to ``poly.shape[:-1]`` with values in [0, 2N).

    out[t] = poly[(t - d) mod N] * (-1)^{floor(((t - d) mod 2N) / N)}
    """
    n = poly.shape[-1]
    degree = torch.as_tensor(degree, dtype=torch.int64, device=poly.device)
    t = torch.arange(n, dtype=torch.int64, device=poly.device)
    src = torch.remainder(t - degree[..., None], 2 * n)
    neg = src >= n
    src = torch.where(neg, src - n, src)
    bshape = torch.broadcast_shapes(degree.shape, poly.shape[:-1])
    src = src.expand(bshape + (n,))
    neg = neg.expand(bshape + (n,))
    gathered = torch.gather(poly.expand(bshape + (n,)), -1, src)
    return torch.where(neg, -gathered, gathered)


def monomial_div(poly: torch.Tensor, degree) -> torch.Tensor:
    """``poly * X^{-degree} (mod X^N + 1)`` (reference
    ``monic_monomial_div``)."""
    n = poly.shape[-1]
    degree = torch.as_tensor(degree, dtype=torch.int64, device=poly.device)
    return monomial_mul(poly, torch.remainder(2 * n - degree, 2 * n))


def monomial_mul_and_subtract(poly: torch.Tensor, degree) -> torch.Tensor:
    """``poly * X^degree - poly``, the first step of a CMUX (reference
    ``polynomial_wrapping_monic_monomial_mul_and_subtract``)."""
    return monomial_mul(poly, degree) - poly
