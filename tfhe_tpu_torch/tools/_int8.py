"""The plain PyTorch arithmetic of the int8 tensor-core probes: u32 values
held in int64 with wrap-around, int8 limbs as int64 values, and exact int8
products. Each function is a formula-for-formula copy of its JAX
counterpart in ``tfhe_tpu/ops/pbs_kernel.py`` (named beside it), as the
CUDA device functions of ``csrc/mma_int8.cuh`` are.

Products: an int64 ``torch.matmul`` on the CPU; on a GPU, where int64
matmul is not implemented, a float64 one, exact because every sum of int8
products here is below 2^24 in magnitude (at most 512 * 128 * 128).
"""

from __future__ import annotations

import torch

from .._torus import M32, srl

#: the pair fold's +2^31
BIAS31 = 1 << 31


def wrap(v: torch.Tensor) -> torch.Tensor:
    """u32 wrap-around of int64 values."""
    return v & M32


def i8(x: torch.Tensor) -> torch.Tensor:
    """The low byte of u32 values as int8 (two's complement), as JAX's
    ``astype(jnp.int8)`` of a uint32 gives it."""
    return ((x & 0xFF) ^ 0x80) - 0x80


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of int8 values held in int64, exact (see the module)."""
    if a.device.type == "cpu":
        return torch.matmul(a, b)
    prod = torch.matmul(a.double(), b.double())
    if prod.abs().max().item() >= 1 << 24:
        raise ValueError("int8 product past 2^24: float64 would not be exact")
    return prod.long()


def table(w, device) -> torch.Tensor:
    """A numpy int8 table as int64 on ``device``."""
    return torch.from_numpy(w.astype("int64")).to(device)


def condsub(x: torch.Tensor, c) -> torch.Tensor:
    """``_condsub``: x - c where x >= c."""
    return torch.where(x >= c, x - c, x)


def mul_hi(a: torch.Tensor, b) -> torch.Tensor:
    """``_mul_hi``: the high word of the u32 product (the int64 product
    wraps mod 2^64, the shift is logical)."""
    return srl(a * b, 32)


def mul_hi_approx(a: torch.Tensor, b) -> torch.Tensor:
    """``_mul_hi_approx``: the 16-bit limb product without the low half's
    carries (at most 2 below ``mul_hi``)."""
    ah, al = a >> 16, a & 0xFFFF
    bh, bl = b >> 16, b & 0xFFFF
    return wrap(ah * bh + ((al * bh) >> 16) + ((ah * bl) >> 16))


def condsub_wide(x: torch.Tensor, c) -> torch.Tensor:
    """``_condsub_wide``: m = x - c, m + (m >> 31) c, in u32."""
    m = wrap(x - c)
    return wrap(m + (m >> 31) * c)


def shoup(a: torch.Tensor, w, wsh, p: int) -> torch.Tensor:
    """``_shoup`` in its default approx mode: (a w) mod p, < 2p."""
    q = mul_hi_approx(a, wsh)
    return condsub_wide(wrap(a * w - q * p), 2 * p)


def split4_balanced(x: torch.Tensor) -> list:
    """``_split4_i8``: balanced base-256 limbs of x as int32 (limbs 0-2 in
    [-128, 127], limb 3 the rest, cast to int8)."""
    v = ((x + BIAS31) & M32) - BIAS31  # as int32
    limbs = []
    for _ in range(3):
        d = v & 0xFF
        d = torch.where(d > 127, d - 256, d)
        limbs.append(d)
        v = (v - d) >> 8
    return limbs + [i8(v)]


def offset_limbs(u: torch.Tensor, n: int) -> list:
    """``_split4_i8_offset`` / ``_split_digits_i8``: limb j =
    ((u >> 8j) & 255) - 128 of int32 values u (here >= 0)."""
    return [((u >> (8 * j)) & 0xFF) - 128 for j in range(n)]


def pair_fold(U: torch.Tensor) -> tuple:
    """``_pair_fold_u``: [..., 512] int32 values -> (V0u, V1u), V =
    U_lo + (U_hi << 8) in int32, + 2^31 as u32."""
    v0 = wrap(U[..., :128] + (U[..., 128:256] << 8) + BIAS31)
    v1 = wrap(U[..., 256:384] + (U[..., 384:512] << 8) + BIAS31)
    return v0, v1
