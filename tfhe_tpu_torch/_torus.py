"""The torus carrier: u64 values held in ``torch.int64`` with wrap-around.

PyTorch's unsigned 64-bit type supports too few operations on the CPU
(multiplication and ``&``, but no ``+``, ``>>`` or comparisons), so every
torus value rides in int64. Addition, subtraction, multiplication and left
shifts wrap mod 2^64 exactly as u64 arithmetic does; the three operations
that differ get helpers here:

- right shifts of a torus value are logical: :func:`srl` masks the bits the
  arithmetic shift copies from the sign;
- unsigned compares flip the sign bit first (:func:`ult`);
- remainders of a full 64-bit value by a small modulus split the value into
  32-bit halves first (:func:`urem`).

Values known to be < 2^63 (residues, values mod q' < 2^61, digits) use the
plain signed operators.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = (1 << 32) - 1
_SIGN = -(1 << 63)


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64-held u64 values by ``k`` in [0, 64)."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b for int64-held u64 values."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def urem(x: torch.Tensor, p: int) -> torch.Tensor:
    """x mod p for int64-held u64 ``x`` and 0 < p < 2^31."""
    hi = srl(x, 32) % p
    return (hi * ((1 << 32) % p) + (x & M32)) % p


def u64_const(v: int) -> int:
    """A python u64 constant as the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def from_u64(arr, device) -> torch.Tensor:
    """numpy u64 (or anything np.asarray accepts) -> int64 tensor."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy u64 with the same bits."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint64)


def from_u32(arr, device) -> torch.Tensor:
    """numpy u32 -> int32 tensor with the same bits (kernel storage)."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy u32 with the same bits."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32)


def u32_to_i64(t: torch.Tensor) -> torch.Tensor:
    """int32-stored u32 values -> their int64 value in [0, 2^32)."""
    return t.to(torch.int64) & M32


def i64_to_u32(t: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of int64 values -> int32 storage (same bits)."""
    lo = t & M32
    return torch.where(lo >= (1 << 31), lo - (1 << 32), lo).to(torch.int32)
