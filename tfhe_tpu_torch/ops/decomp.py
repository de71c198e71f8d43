"""Signed (balanced) gadget decomposition — torch, bit-exact with
``tfhe_tpu/ops/decomp.py``.

Decomposes torus values into ``level_count`` balanced base-2^base_log
digits, MSB-rounded, level ``level_count`` first (the GGSW level-matrix and
KSK block order). Reference: ``commons/math/decomposition/decomposer.rs``
(``init_decomposer_state``) and ``iter.rs`` (``decompose_one_level``).
The state is the signed int64 view: the reference shifts arithmetically on
the two's-complement pattern.
"""

from __future__ import annotations

import numpy as np
import torch

from .._torus import srl


def closest_representable(x: torch.Tensor, base_log: int,
                          level_count: int) -> torch.Tensor:
    """Round ``x`` to the closest value representable on the
    ``level_count * base_log`` most significant bits (decomposer.rs
    ``native_closest_representable``)."""
    non_rep = 64 - level_count * base_log
    if non_rep == 0:
        return x
    shift = non_rep - 1
    res = srl(x, shift) + 1
    res = res & ~1
    return res << shift


def init_decomposer_state(x: torch.Tensor, base_log: int,
                          level_count: int) -> torch.Tensor:
    """Rounded, balanced initial state (int64 holding the signed value)."""
    rep = level_count * base_log
    non_rep = 64 - rep
    if non_rep == 0:
        raise ValueError("base_log * level_count must be < 64")
    res = srl(x, non_rep - 1)
    rounding_bit = res & 1
    res = srl(res + 1, 1)
    res = res & ((1 << rep) - 1)
    shifted_random = rounding_bit << (rep - 1)
    need_balance = (((res - 1) | shifted_random) & res) >> (rep - 1)
    return res - (need_balance << rep)


def decompose(x: torch.Tensor, base_log: int, level_count: int) -> torch.Tensor:
    """int64[...] torus values -> int64[..., level_count] signed digits;
    index 0 is the ``level_count`` term (smallest recomposition factor)."""
    state = init_decomposer_state(x, base_log, level_count)
    mod_b_mask = (1 << base_log) - 1
    digits = []
    for _ in range(level_count):
        res = state & mod_b_mask
        state = state >> base_log  # arithmetic shift
        carry = (((res - 1) | state) & res) >> (base_log - 1)
        state = state + carry
        digits.append(res - (carry << base_log))
    return torch.stack(digits, dim=-1)


def recompose(digits: torch.Tensor, base_log: int,
              level_count: int) -> torch.Tensor:
    """Sum of digit_i * q / B^level mod 2^64, the inverse of
    :func:`decompose` up to :func:`closest_representable` rounding; the
    digit axis is last, level ``level_count`` first."""
    acc = torch.zeros(digits.shape[:-1], dtype=torch.int64,
                      device=digits.device)
    for idx in range(level_count):
        acc = acc + (digits[..., idx] << (64 - base_log * (level_count - idx)))
    return acc


def recomposition_summand(value_signed: np.ndarray, level: int,
                          base_log: int) -> np.ndarray:
    """DecompositionTerm::to_recomposition_summand — value << (64 -
    b*level), wrapping (numpy u64; key generation plaintexts)."""
    shift = np.uint64(64 - base_log * level)
    return (np.asarray(value_signed).astype(np.int64).astype(np.uint64)) << shift
