"""Two-prime BNF transform domain ("v6"/"v6b") — the spec of the port's
blind-rotation kernel, in torch.

Torch counterpart of ``tfhe_tpu/ops/bnf2.py``. External products are
computed mod q' = p0 * p1 (a prime pair whose product is ~2^60 or ~2^57)
with the bootstrap key rounded ONCE into Z_q' at key-prep time, the
generalization of the reference's NTT64 "bridge to NTT-friendly" path
(``ntt64_bnf_pbs.rs:174-260``) to a 2-prime CRT of ~30-bit primes:

- ciphertexts and the accumulator stay mod 2^64;
- key coefficients are rescaled once: b' = round(b * q' / 2^64) in [0, q');
- gadget digits are exact small signed integers embedded mod each prime;
- the NTT mod p_i computes the integer convolution digits (*) b' mod p_i,
  and the 2-term CRT merge gives it mod q';
- the switch back to the torus is a fixed-point multiply whose dropped
  terms ARE the spec (``qp_to_torus``, ``qp_to_torus32``), reproduced bit
  for bit by the CUDA kernel.

The scalar maps below, ``bootstrap_key_to_bnf2`` and ``blind_rotate_bnf2``
are bit-exact with ``tfhe_tpu.ops.bnf2`` (tests/test_torch_bnf2.py).
"""

from __future__ import annotations

import torch

from .._torus import M32, i64_to_u32, srl, ult
from . import ntt as ntt_mod
from .decomp import decompose
from .polynomial import monomial_div, monomial_mul


class Bnf2Flavor:
    """A (p0, p1) prime pair plus every derived switch-back constant.

    The torus switch t = round(x * 2^64 / q') is computed as
    (x << S1) + cross-terms >> S2 with S1 = 64 - SHIFT, S2 = SHIFT - 32,
    SHIFT = ceil(log2 q'), F = floor(2^(64+SHIFT)/q') = 2^64 + G; the pair
    must satisfy F - 2^64 in (0, 2^60). (The TPU kernel's lazy reductions
    for 8*max(p) < 2^32 are not carried over: the port's kernel reduces
    exactly, which gives the same canonical residues.)"""

    def __init__(self, p0: int, p1: int, t32_bias: int):
        assert p0 < 2 * p1, "crt merge needs r0 < 2*p1"
        self.p0, self.p1 = p0, p1
        self.qp = p0 * p1
        self.shift = (self.qp - 1).bit_length()
        assert (1 << (self.shift - 1)) < self.qp <= (1 << self.shift)
        self.s1 = 64 - self.shift
        self.s2 = self.shift - 32
        self.inv01 = pow(p0, p1 - 2, p1)
        self.inv01_sh = (self.inv01 << 32) // p1
        self.g_const = (1 << (64 + self.shift)) // self.qp - (1 << 64)
        assert 0 < self.g_const < (1 << 60), hex(self.g_const)
        self.g1 = self.g_const >> 32
        self.g0 = self.g_const & M32
        self.c1t = (1 << 60) // p1
        assert self.c1t < (1 << 32) and p1 * self.c1t < (1 << 60)
        self.t32_bias = t32_bias
        self.primes = (p0, p1)

    def plan(self, n: int) -> ntt_mod.NegacyclicNtt:
        return ntt_mod.get_plan(n, 2, primes=self.primes)


#: the ~30-bit pair: the first two PRIMES32 (the "v6" variant)
DEFAULT = Bnf2Flavor(ntt_mod.PRIMES32[0], ntt_mod.PRIMES32[1], t32_bias=4)
assert DEFAULT.s1 == 4 and DEFAULT.s2 == 28

#: the sub-2^29 pair (q' ~ 2^56.9998) of the shipped "v6b" variant
FAST28 = Bnf2Flavor(0x163B0001, 0x17080001, t32_bias=1)
assert FAST28.s1 == 7 and FAST28.s2 == 25


def eligible(n: int, base_log: int, levels: int) -> bool:
    """The shape envelope of the v6 kernels: N a power of two in
    [256, 32768], N % 128 == 0, and digits that fit the hi-limb u32
    decomposer (base_log * levels <= 31)."""
    return (256 <= n <= 32768 and n % 128 == 0 and (n & (n - 1)) == 0
            and base_log * levels <= 31)


# ---------------------------------------------------------------------------
# scalar maps (int64-held u64, vectorized) — the spec
# ---------------------------------------------------------------------------

def torus_to_qp(b: torch.Tensor, flavor: Bnf2Flavor = None) -> torch.Tensor:
    """round(b * q' / 2^64) for torus values b mod 2^64; output in [0, q')
    (a round that reaches exactly q' folds back to 0)."""
    fl = flavor or DEFAULT
    q = fl.qp
    qh = q >> 32
    ql = q & M32
    bh = srl(b, 32)
    bl = b & M32
    ll = bl * ql
    lh = bl * qh
    hl = bh * ql
    hh = bh * qh
    mid = lh + hl  # < 2^63 + 2^60 as u64: the int64 bits wrap exactly
    lo = ll + (mid << 32)
    hi = hh + srl(mid, 32) + ult(lo, ll).to(torch.int64)
    out = hi + srl(lo, 63)  # + rounding bit; < 2^61, signed compare is safe
    return torch.where(out >= q, out - q, out)


def crt2_merge(r0: torch.Tensor, r1: torch.Tensor,
               flavor: Bnf2Flavor = None) -> torch.Tensor:
    """Canonical residues (r0 mod p0, r1 mod p1) -> x in [0, q')."""
    fl = flavor or DEFAULT
    d = torch.remainder(r1 + fl.p1 - r0, fl.p1)
    v1 = torch.remainder(d * fl.inv01, fl.p1)  # < 2^60: exact
    return r0 + fl.p0 * v1


def qp_to_torus32(r0: torch.Tensor, r1: torch.Tensor,
                  flavor: Bnf2Flavor = None) -> torch.Tensor:
    """acc32 switch-back fused with the CRT merge: canonical residues ->
    hi-plane torus value in [0, 2^32)

        v1 = (r1 + 2*P1 - r0) * INV01  mod P1
        t32 = ((v1 * C1T) >> 28) + (r0 >> S2) + T32_BIAS   (mod 2^32)
    """
    fl = flavor or DEFAULT
    d = torch.remainder(r1 + 2 * fl.p1 - r0, fl.p1)
    v1 = torch.remainder(d * fl.inv01, fl.p1)
    t = ((v1 * fl.c1t) >> 28) + (r0 >> fl.s2) + fl.t32_bias
    return t & M32


def qp_to_torus(x: torch.Tensor, flavor: Bnf2Flavor = None) -> torch.Tensor:
    """Switch x in [0, q') back to the 2^64 torus:
        t = (x << S1) + ((x0*G1 + x1*G0) >> S2) + ((x1*G1) << S1) mod 2^64
    with x = x1*2^32 + x0 (the x0*G0 term is dropped)."""
    fl = flavor or DEFAULT
    x0 = x & M32
    x1 = x >> 32
    s = x0 * fl.g1 + x1 * fl.g0  # < 2^61: exact
    d = x1 * fl.g1  # < 2^55: exact
    return (x << fl.s1) + (s >> fl.s2) + (d << fl.s1)


def r32(x: torch.Tensor) -> torch.Tensor:
    """Round torus values to the nearest multiple of 2^32 (the acc32
    accumulator's rounding)."""
    return srl(x + (1 << 31), 32) << 32


# ---------------------------------------------------------------------------
# BSK preparation
# ---------------------------------------------------------------------------

def bootstrap_key_to_bnf2(bsk: torch.Tensor,
                          flavor: Bnf2Flavor = None) -> torch.Tensor:
    """Standard-domain BSK int64[n, l, R, R, N] (torus) -> BNF2 key in scan
    layout, u32 values in int32 storage [n, 2(residue/shoup), 2(P), l*R, R,
    N], the layout the blind-rotation kernel reads.

    Each coefficient is rescaled into Z_q' (``torus_to_qp``) then
    forward-transformed mod each prime (natural order in, DIF order out);
    the second plane holds the Shoup duals floor(res * 2^32 / p)."""
    nlwe, l, R, R2, N = bsk.shape
    fl = flavor or DEFAULT
    plan = fl.plan(N)
    res = plan.fwd(torus_to_qp(bsk, fl))  # [2, n, l, R, R, N]
    p = plan.tables(bsk.device)["p"].reshape(2, 1, 1, 1, 1, 1)
    shoup = torch.div(res << 32, p, rounding_mode="floor")
    out = torch.stack([res, shoup]).movedim(2, 0)  # [n, 2, 2, l, R, R, N]
    return i64_to_u32(out.reshape(nlwe, 2, 2, l * R, R2, N)).contiguous()


# ---------------------------------------------------------------------------
# plain blind rotation (bit-exact twin of the CUDA kernel)
# ---------------------------------------------------------------------------

def cmux_steps(acc: torch.Tensor, msed_mask: torch.Tensor,
               bsk_scan2: torch.Tensor, base_log: int, levels: int,
               acc_round32: bool, flavor: Bnf2Flavor = None) -> torch.Tensor:
    """The n CMUX steps of the blind rotation on an int64[B, R, N]
    accumulator (body rotation already applied). ``acc_round32``: every
    increment is produced as a hi-plane value by ``qp_to_torus32``.
    ``bsk_scan2``: int32[n, 2, 2, l*R, R, N] (residues are < 2^30, so the
    int32 storage reads back as the value)."""
    B, R, N = acc.shape
    fl = flavor or DEFAULT
    plan = fl.plan(N)
    p = plan.tables(acc.device)["p"].reshape(2, 1, 1, 1, 1)
    mask = msed_mask.to(torch.int64)
    for i in range(bsk_scan2.shape[0]):
        ct1 = monomial_mul(acc, mask[:, i, None]) - acc
        digits = decompose(ct1, base_log, levels).movedim(-1, -3)  # [B,l,R,N]
        dhat = plan.fwd_digits(digits.reshape(B, levels * R, N))  # [2,B,lR,N]
        g = bsk_scan2[i, 0].to(torch.int64)  # [2, lR, R(c), N]
        prod = torch.remainder(dhat[:, :, :, None, :] * g[:, None], p)
        acc_hat = torch.remainder(prod.sum(dim=2), p[:, :, 0])  # [2,B,R,N]
        r = plan.inv(acc_hat)
        if acc_round32:
            inc = qp_to_torus32(r[0], r[1], fl) << 32
        else:
            inc = qp_to_torus(crt2_merge(r[0], r[1], fl), fl)
        acc = acc + inc
    return acc


def blind_rotate_bnf2(
    lut: torch.Tensor,
    msed_mask: torch.Tensor,
    msed_body: torch.Tensor,
    bsk_scan2: torch.Tensor,
    base_log: int,
    levels: int,
    acc_round32: bool = False,
    flavor: Bnf2Flavor = None,
) -> torch.Tensor:
    """Blind rotation with external products mod q' and the accumulator
    mod 2^64 (spec of ``tfhe_tpu.ops.bnf2.blind_rotate_bnf2``).

    ``lut``: int64[B, R, N] (or [R, N], shared); ``msed_mask``: [B, n] in
    [0, 2N); ``msed_body``: [B]; ``bsk_scan2``: int32[n, 2, 2, l*R, R, N].
    ``acc_round32``: the accumulator starts rounded to a multiple of 2^32
    and every increment is a hi-plane value (the shipped acc32 mode).
    Returns int64[B, R, N]."""
    acc = monomial_div(lut, msed_body.to(torch.int64)[:, None])
    if acc_round32:
        acc = r32(acc)
    return cmux_steps(acc, msed_mask, bsk_scan2, base_log, levels,
                      acc_round32, flavor)
