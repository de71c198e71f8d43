"""Goldilocks-prime (p = 2^64 - 2^32 + 1) arithmetic and negacyclic NTT:
the transform domain of the "v5" PBS, in torch.

Torch counterpart of ``tfhe_tpu/ops/goldilocks.py`` (reference: the NTT64
arithmetic of ``core_crypto/commons/math/ntt/ntt64.rs:166-260`` and the BNF
PBS of ``algorithms/lwe_programmable_bootstrapping/ntt64_bnf_pbs.rs:174-260``).
Ciphertexts and the accumulator stay mod 2^64; the bootstrap key is rounded
once into Z_p and every external product is computed exactly mod p, then
switched back to the torus with ``x + (x >> 32)``.

Values ride in the port's int64 torus carrier (``_torus.py``): u64 bits in
int64 storage, with wrap-around ``+``, ``-``, ``*``, masked right shifts
(``srl``) and sign-flipped unsigned compares (``ult``). Every helper takes
and returns canonical representatives (< p) unless noted, so the plain
blind rotation below is bit-identical to ``tfhe_tpu``'s jnp oracle and its
Pallas kernel, and to the CUDA kernel K4 (``csrc/blind_rotate_goldilocks.cu``).
The TPU kernel's shift-stage tables (``stage_shifts``) are a TPU layout
device and are not carried over.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._torus import M32, i64_to_u32, srl, u32_to_i64, u64_const, ult
from .decomp import decompose
from .polynomial import monomial_div, monomial_mul

P = (1 << 64) - (1 << 32) + 1
EPS = (1 << 32) - 1  # 2^64 mod P;  2^96 = -1 mod P
GEN = 7  # generator of the multiplicative group
ORDER2 = 192  # multiplicative order of 2 mod P

_P64 = u64_const(P)  # P's bits as an int64


def eligible(n: int, base_log: int, levels: int) -> bool:
    """The v5 kernel's envelope (``tfhe_tpu/ops/pbs_kernel_g.py::
    eligible``): N a power of two in [256, 8192] (the plan needs
    G = N/128 | 64) and digits that fit the hi-word decomposer."""
    return (256 <= n <= 8192 and n % 128 == 0 and (n & (n - 1)) == 0
            and base_log * levels <= 31)


# ---------------------------------------------------------------------------
# field arithmetic on int64-held u64 values
# ---------------------------------------------------------------------------

def gcanon(x: torch.Tensor) -> torch.Tensor:
    """Any u64 representative -> canonical value mod P (2p > 2^64, so one
    conditional subtract suffices)."""
    return torch.where(ult(x, _P64), x, x - _P64)


def gadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod P for canonical a, b; canonical output."""
    s = a + b
    s = torch.where(ult(s, a), s + EPS, s)  # a u64 wrap: +2^64 = +EPS
    return gcanon(s)


def gsub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod P for canonical a, b; canonical output."""
    d = a - b
    return torch.where(ult(a, b), d - EPS, d)  # -2^64 = -EPS


def _reduce128(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi * 2^64 + lo) mod P, canonical: lo - hi_hi + EPS * hi_lo with
    2^64 = EPS and 2^96 = -1."""
    hi_hi = srl(hi, 32)
    hi_lo = hi & M32
    t0 = lo - hi_hi
    t0 = torch.where(ult(lo, hi_hi), t0 - EPS, t0)
    t1 = hi_lo * EPS  # < 2^64: exact as u64
    t2 = t0 + t1
    t2 = torch.where(ult(t2, t1), t2 + EPS, t2)
    return gcanon(t2)


def gmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod P for canonical a, b: the 128-bit product from 32-bit
    limbs (each limb product wraps as u64), then :func:`_reduce128`."""
    ah, al = srl(a, 32), a & M32
    bh, bl = srl(b, 32), b & M32
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    mid = lh + hl
    mid_carry = ult(mid, lh).to(torch.int64)  # weight 2^96
    lo = ll + (mid << 32)
    lo_carry = ult(lo, ll).to(torch.int64)
    hi = hh + srl(mid, 32) + (mid_carry << 32) + lo_carry
    return _reduce128(hi, lo)


def torus_to_field(b: torch.Tensor) -> torch.Tensor:
    """round(b * P / 2^64) for torus values b, canonical (the one-time key
    embedding, ``ntt64.rs:166``): b - r with r = floor((b * EPS + 2^63 - 1)
    / 2^64); the half-up tie goes to the SMALLER r."""
    t = (b & M32) << 32  # low 64 bits of b * 2^32
    s = t + ((1 << 63) - 1)
    c1 = ult(s, t).to(torch.int64)
    c2 = ult(s, b).to(torch.int64)
    r = srl(b, 32) + c1 - c2
    return gcanon(b - r)


def field_to_torus(x: torch.Tensor) -> torch.Tensor:
    """Canonical Z_p value -> 2^64 torus: exactly ``x + (x >> 32)``."""
    return x + srl(x, 32)


def signed_to_field(d: torch.Tensor) -> torch.Tensor:
    """Small signed integers (decomposition digits) -> Z_p: d < 0 ? P + d
    : d."""
    return torch.where(d < 0, d + _P64, d)


def gpow(a: int, e: int) -> int:
    return pow(int(a), int(e), P)


# ---------------------------------------------------------------------------
# plan: negacyclic NTT over Z_p with the v5 (group, lane) frequency order
# ---------------------------------------------------------------------------

def _bitrev(x: int, bits: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


class GoldilocksPlan:
    """Per-N tables (numpy u64 on the host; :meth:`tables` gives device
    copies). ``psi`` is the primitive 2N-th root chosen so that the
    group-DFT base psi^(2N/G) is the power of two 2^(192/G), G = N/128, as
    the JAX package chooses it: the key's transform domain depends on it."""

    def __init__(self, n: int):
        assert n >= 256 and n % 128 == 0 and n & (n - 1) == 0, n
        self.n = n
        self.log_n = n.bit_length() - 1
        G = n // 128
        assert G <= 64, "the v5 plan needs N <= 8192"
        self.G = G
        self.log_g = G.bit_length() - 1
        assert (P - 1) % (2 * n) == 0

        psi0 = gpow(GEN, (P - 1) // (2 * n))
        omega_g_target = gpow(2, ORDER2 // G) if G > 1 else 1
        zeta = gpow(psi0, 2 * n // G)  # a primitive G-th root
        t_sol = next((t for t in range(1, 2 * G + 1, 2)
                      if gpow(zeta, t) == omega_g_target), None)
        assert t_sol is not None, "no odd dlog for the shift-stage root"
        self.psi = gpow(psi0, t_sol)
        self.omega = gpow(self.psi, 2)
        assert gpow(self.psi, n) == P - 1

        self.twist = np.array([gpow(self.psi, j) for j in range(n)],
                              dtype=np.uint64)  # psi^j
        inv_psi = gpow(self.psi, 2 * n - 1)
        inv_n = gpow(n, P - 2)
        self.untwist = np.array([inv_n * gpow(inv_psi, j) % P
                                 for j in range(n)],
                                dtype=np.uint64)  # psi^-j / N

        # DIF stage s: sub-size m = n >> s, twiddles omega_m^j, j < m/2
        self.tw_fwd, self.tw_inv = [], []
        for s in range(self.log_n):
            m = n >> s
            wm = gpow(self.omega, n // m)
            wmi = gpow(wm, P - 2)
            self.tw_fwd.append(np.array([gpow(wm, j) for j in range(m // 2)],
                                        dtype=np.uint64))
            self.tw_inv.append(np.array([gpow(wmi, j) for j in range(m // 2)],
                                        dtype=np.uint64))

        # DIF output position q holds frequency bitrev_logN(q); v5 point
        # (g, l) holds frequency l + 128 * bitrev_G(g)
        br = np.array([_bitrev(q, self.log_n) for q in range(n)])
        pos_of_freq = np.argsort(br)
        brg = np.array([_bitrev(g, self.log_g) for g in range(G)])
        freq_v5 = (np.arange(128)[None, :] + 128 * brg[:, None]).reshape(-1)
        self.perm_to_kernel = pos_of_freq[freq_v5]  # [N]: DIF pos per (g, l)
        self.perm_from_kernel = np.argsort(self.perm_to_kernel)
        self._dev: dict = {}

    def tables(self, device) -> dict:
        """twist, untwist, the stage twiddles and both permutations as
        int64 tensors on ``device`` (cached)."""
        key = str(torch.device(device))
        if key not in self._dev:
            t = lambda a: torch.from_numpy(
                np.asarray(a, dtype=np.uint64).view(np.int64)).to(device)
            self._dev[key] = {
                "twist": t(self.twist), "untwist": t(self.untwist),
                "fwd": [t(x) for x in self.tw_fwd],
                "inv": [t(x) for x in self.tw_inv],
                "to_kernel": torch.from_numpy(self.perm_to_kernel).to(device),
                "from_kernel": torch.from_numpy(
                    self.perm_from_kernel).to(device),
            }
        return self._dev[key]


@functools.lru_cache(maxsize=None)
def get_plan_g(n: int) -> GoldilocksPlan:
    return GoldilocksPlan(n)


# ---------------------------------------------------------------------------
# NTT (classic DIF mod P) and the kernel-order views
# ---------------------------------------------------------------------------

def fwd_ntt(x: torch.Tensor, plan: GoldilocksPlan) -> torch.Tensor:
    """Negacyclic forward NTT mod P of canonical int64[..., N]; output in
    classic DIF (bit-reversed) order."""
    n = plan.n
    tb = plan.tables(x.device)
    x = gmul(x, tb["twist"])
    for s in range(plan.log_n):
        m = n >> s
        xr = x.reshape(x.shape[:-1] + (n // m, m))
        a, b = xr[..., : m // 2], xr[..., m // 2:]
        x = torch.cat([gadd(a, b), gmul(gsub(a, b), tb["fwd"][s])],
                      dim=-1).reshape(x.shape)
    return x


def inv_ntt(x: torch.Tensor, plan: GoldilocksPlan) -> torch.Tensor:
    """Inverse of :func:`fwd_ntt` (input in DIF order), canonical output."""
    n = plan.n
    tb = plan.tables(x.device)
    for s in reversed(range(plan.log_n)):
        m = n >> s
        xr = x.reshape(x.shape[:-1] + (n // m, m))
        u, v = xr[..., : m // 2], xr[..., m // 2:]
        bw = gmul(v, tb["inv"][s])
        x = torch.cat([gadd(u, bw), gsub(u, bw)], dim=-1).reshape(x.shape)
    return gmul(x, tb["untwist"])


def fwd_ntt_kernel_order(x: torch.Tensor,
                         plan: GoldilocksPlan) -> torch.Tensor:
    """int64[..., N] -> canonical int64[..., G, 128] in the v5 kernel's
    (group, lane) frequency order."""
    y = fwd_ntt(x, plan)[..., plan.tables(x.device)["to_kernel"]]
    return y.reshape(y.shape[:-1] + (plan.G, 128))


def inv_ntt_kernel_order(y: torch.Tensor,
                         plan: GoldilocksPlan) -> torch.Tensor:
    y = y.reshape(y.shape[:-2] + (plan.n,))
    return inv_ntt(y[..., plan.tables(y.device)["from_kernel"]], plan)


# ---------------------------------------------------------------------------
# key preparation and the plain blind rotation
# ---------------------------------------------------------------------------

def bootstrap_key_to_goldilocks(bsk: torch.Tensor) -> torch.Tensor:
    """Standard-domain BSK int64[n, l, R, R, N] -> kernel-order NTT-domain
    key, u32 in int32 storage [n, 2 (hi, lo), l*R, R, G, 128]: each
    coefficient rounded into Z_p (:func:`torus_to_field`), then
    forward-transformed (``ntt64_bnf_pbs.rs:174``)."""
    nlwe, l, R, R2, N = bsk.shape
    plan = get_plan_g(N)
    hat = fwd_ntt_kernel_order(torus_to_field(bsk), plan)
    hat = hat.reshape(nlwe, l * R, R2, plan.G, 128)
    return i64_to_u32(torch.stack([srl(hat, 32), hat], dim=1)).contiguous()


def bsk_g_merge(bsk_g: torch.Tensor) -> torch.Tensor:
    """int32-stored [n, 2, lR, R, G, 128] (hi, lo) -> canonical int64
    values [n, lR, R, G, 128]."""
    return (u32_to_i64(bsk_g[:, 0]) << 32) | u32_to_i64(bsk_g[:, 1])


def cmux_steps(acc: torch.Tensor, msed_mask: torch.Tensor,
               bsk_g: torch.Tensor, base_log: int,
               levels: int) -> torch.Tensor:
    """The n CMUX steps of the v5 blind rotation on an int64[B, R, N]
    accumulator whose body rotation is applied
    (``goldilocks.py::blind_rotate_goldilocks``'s loop): per step,
    ``rot - acc`` decomposed, digits lifted into Z_p and transformed, the
    MAC against the key mod P, the inverse transform (canonical), and
    ``acc += x + (x >> 32)``. ``bsk_g``: int32[n, 2, l*R, R, G, 128]."""
    B, R, N = acc.shape
    plan = get_plan_g(N)
    mask = msed_mask.to(torch.int64)
    for i in range(bsk_g.shape[0]):
        ct1 = monomial_mul(acc, mask[:, i, None]) - acc
        digits = decompose(ct1, base_log, levels).movedim(-1, -3)  # [B,l,R,N]
        dhat = fwd_ntt_kernel_order(signed_to_field(digits), plan)
        dhat = dhat.reshape(B, levels * R, plan.G, 128)
        g = bsk_g_merge(bsk_g[i: i + 1])[0]  # [lR, R(c), G, 128]
        out = gmul(dhat[:, 0, None], g[None, 0])
        for j in range(1, levels * R):
            out = gadd(out, gmul(dhat[:, j, None], g[None, j]))
        acc = acc + field_to_torus(inv_ntt_kernel_order(out, plan))
    return acc


def blind_rotate_goldilocks(lut: torch.Tensor, msed_mask: torch.Tensor,
                            msed_body: torch.Tensor, bsk_g: torch.Tensor,
                            base_log: int, levels: int) -> torch.Tensor:
    """The v5 blind rotation (spec of ``tfhe_tpu``'s jnp oracle
    ``goldilocks.blind_rotate_goldilocks``): the body rotation, then
    :func:`cmux_steps`. ``lut``: int64[B, R, N] (or [R, N], shared);
    ``msed_mask``: [B, n] in [0, 2N); ``msed_body``: [B]. Returns
    int64[B, R, N]."""
    acc = monomial_div(lut, msed_body.to(torch.int64)[:, None])
    return cmux_steps(acc, msed_mask, bsk_g, base_log, levels)
