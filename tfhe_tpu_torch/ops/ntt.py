"""Exact negacyclic NTT mod ~30-bit primes, with CRT back to 2^64 — torch.

Torch counterpart of ``tfhe_tpu/ops/ntt.py``: the same primes, the same
tables (numpy, built once per (N, primes)), the same transform structure:

- forward = Gentleman–Sande (DIF) stages on natural-order input, no
  bit-reversal, so the pointwise domain is the DIF output order; the BNF
  bootstrap key is stored in that order and the CUDA blind-rotation kernel
  reproduces it stage for stage;
- inverse = the exact stage-by-stage unwind (CT butterflies with inverse
  twiddles in reverse stage order), then the untwist by psi^{-j} N^{-1};
- negacyclic wrap by psi-twisting with a primitive 2N-th root of unity.

Every multiply against a known constant is a Shoup multiply
(``q = (a * w_shoup) >> 32; r = a*w - q*p``), valid for a < 2^32. Values
are int64 tensors: residues stay < 2^31, and the one product that can pass
2^63 (``a * w_shoup``) is shifted logically.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._torus import M32, i64_to_u32, srl, u64_const, urem

# tfhe-ntt native64::Plan32 primes (tfhe-ntt/src/lib.rs:457-461), extended
# with six more c*2^16 + 1 primes, in the same order as tfhe_tpu.
PRIMES32: tuple[int, ...] = (
    0x3F5A0001,
    0x3F5D0001,
    0x3F760001,
    0x3F820001,
    0x3FAC0001,
    0x3FFC0001,
    0x3FED0001,
    0x3FDE0001,
    0x3FD20001,
    0x3FBB0001,
    0x3FB10001,
)


def _find_generator(p: int) -> int:
    """Smallest generator of (Z/p)^* (p prime)."""
    factors = []
    m = p - 1
    d = 2
    while d * d <= m:
        if m % d == 0:
            factors.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        factors.append(m)
    for g in range(2, p):
        if all(pow(g, (p - 1) // f, p) != 1 for f in factors):
            return g
    raise ValueError("no generator found")


@functools.lru_cache(maxsize=None)
def _psi_root(p: int, order: int) -> int:
    """A primitive ``order``-th root of unity mod p."""
    assert (p - 1) % order == 0, (p, order)
    psi = pow(_find_generator(p), (p - 1) // order, p)
    assert pow(psi, order, p) == 1 and pow(psi, order // 2, p) != 1
    return psi


def min_primes_for_bound(bound_bits: float) -> int:
    """Smallest number of leading PRIMES32 whose product exceeds
    2^(bound_bits + 1) (factor 2 for the sign of the centered result)."""
    prod_bits = 0.0
    for i, p in enumerate(PRIMES32):
        prod_bits += np.log2(float(p))
        if prod_bits > bound_bits + 1:
            return i + 1
    raise ValueError(f"bound 2^{bound_bits} too large for available primes")


def polymul_bound_bits(operand_bits: int, n: int, num_sums: int = 1,
                       torus_bits: int = 64) -> float:
    """log2 bound on |coefficient| of a sum of ``num_sums`` negacyclic
    products of (signed, < 2^operand_bits) x (unsigned, < 2^torus_bits)."""
    return operand_bits + torus_bits + np.log2(n) + np.log2(max(num_sums, 1))


def _shoup_np(w: np.ndarray, p: int) -> np.ndarray:
    """floor(w * 2^32 / p) for a table of constants (exact, python ints)."""
    flat = [int(x) for x in np.asarray(w, dtype=np.uint64).reshape(-1)]
    out = np.array([(x << 32) // p for x in flat], dtype=np.uint64)
    return out.reshape(np.asarray(w).shape)


def shoup_mul(a: torch.Tensor, w, w_shoup, p) -> torch.Tensor:
    """(a * w) mod p with Shoup's trick; a < 2^32, w < p; result in [0, p)."""
    q = srl(a * w_shoup, 32)
    r = a * w - q * p
    return torch.where(r >= p, r - p, r)


class NegacyclicNtt:
    """Per-(N, primes) transform plan: numpy tables, torch transforms.
    Tensors are ``[P, ..., N]`` int64 residues."""

    def __init__(self, n: int, num_primes: int, primes: tuple = None):
        assert n & (n - 1) == 0, "N must be a power of two"
        self.n = n
        if primes is None:
            assert 2 <= num_primes <= len(PRIMES32)
            primes = PRIMES32[:num_primes]
        else:
            assert len(primes) == num_primes
            for p in primes:
                assert (p - 1) % (2 * n) == 0, (p, n)
        self.num_primes = num_primes
        self.primes = tuple(primes)
        self.log_n = n.bit_length() - 1
        P = num_primes

        psi = [_psi_root(p, 2 * n) for p in self.primes]
        omega = [(ps * ps) % p for ps, p in zip(psi, self.primes)]

        self.twist = np.stack([
            np.array([pow(ps, j, p) for j in range(n)], dtype=np.uint64)
            for ps, p in zip(psi, self.primes)])  # [P, N] psi^j
        self.untwist = np.stack([
            np.array([(pow(ps, 2 * n - j, p) * pow(n, p - 2, p)) % p
                      for j in range(n)], dtype=np.uint64)
            for ps, p in zip(psi, self.primes)])  # [P, N] psi^{-j} N^{-1}

        # Stage twiddles: stage s has blocks of length m = N >> s, half
        # h = m/2, twiddle w_m^j for j in [0, h) with w_m = omega^(N/m).
        self.tw_fwd: list[np.ndarray] = []
        self.tw_inv: list[np.ndarray] = []
        for s in range(self.log_n):
            m = n >> s
            h = m >> 1
            fwd = np.zeros((P, h), dtype=np.uint64)
            inv = np.zeros((P, h), dtype=np.uint64)
            for pi, p in enumerate(self.primes):
                wm = pow(omega[pi], n // m, p)
                wm_inv = pow(wm, p - 2, p)
                wj = 1
                wj_inv = 1
                for j in range(h):
                    fwd[pi, j] = wj
                    inv[pi, j] = wj_inv
                    wj = (wj * wm) % p
                    wj_inv = (wj_inv * wm_inv) % p
            self.tw_fwd.append(fwd)
            self.tw_inv.append(inv)

        def shoup_table(tbl: np.ndarray) -> np.ndarray:
            return np.stack(
                [_shoup_np(tbl[pi], p) for pi, p in enumerate(self.primes)])

        self.twist_shoup = shoup_table(self.twist)
        self.untwist_shoup = shoup_table(self.untwist)
        self.tw_fwd_shoup = [shoup_table(t) for t in self.tw_fwd]
        self.tw_inv_shoup = [shoup_table(t) for t in self.tw_inv]
        self.p_arr = np.array(self.primes, dtype=np.uint64)

        # Garner / CRT reconstruction constants (tfhe-ntt native64.rs
        # reconstruct_32bit_01234 semantics)
        ps = [int(p) for p in self.primes]
        self.garner_inv = []  # inverse of (p0*...*p_{i-1}) mod p_i
        for i in range(1, P):
            prod = 1
            for j in range(i):
                prod = (prod * ps[j]) % ps[i]
            self.garner_inv.append(pow(prod, ps[i] - 2, ps[i]))
        self.garner_inv_shoup = [
            (inv << 32) // ps[i + 1] for i, inv in enumerate(self.garner_inv)]
        self.pj_shoup = [
            [(ps[j] << 32) // ps[i] for j in range(i)] for i in range(P)]
        mask64 = (1 << 64) - 1
        self.prefix_mod64 = []  # [1, p0, p0p1, ...] wrapping
        acc = 1
        for i in range(P):
            self.prefix_mod64.append(acc & mask64)
            acc = (acc * ps[i]) & mask64
        self.full_prod_mod64 = acc & mask64
        self._dev_tables: dict = {}

    # -- device tables --------------------------------------------------------
    def tables(self, device) -> dict:
        """The constant tables as int64 tensors on ``device`` (cached)."""
        key = str(torch.device(device))
        if key not in self._dev_tables:
            t = lambda a: torch.from_numpy(
                np.asarray(a, dtype=np.uint64).view(np.int64)).to(device)
            self._dev_tables[key] = {
                "p": t(self.p_arr),
                "twist": t(self.twist), "twist_sh": t(self.twist_shoup),
                "untwist": t(self.untwist),
                "untwist_sh": t(self.untwist_shoup),
                "fwd": [t(x) for x in self.tw_fwd],
                "fwd_sh": [t(x) for x in self.tw_fwd_shoup],
                "inv": [t(x) for x in self.tw_inv],
                "inv_sh": [t(x) for x in self.tw_inv_shoup],
            }
        return self._dev_tables[key]

    def _p(self, tb, ndim: int) -> torch.Tensor:
        return tb["p"].reshape((self.num_primes,) + (1,) * ndim)

    def p_like(self, ndim: int, device) -> torch.Tensor:
        """The primes as int64 [P, 1, ..., 1] (``ndim`` ones) on ``device``:
        the broadcast of a per-prime reduction over residues [P, ...]."""
        return self._p(self.tables(device), ndim)

    # -- forward ------------------------------------------------------------
    def fwd_digits(self, x: torch.Tensor) -> torch.Tensor:
        """Forward transform of small signed integers (|x| < 2p, e.g.
        gadget digits): int64[..., N] -> residues int64[P, ..., N]."""
        assert x.shape[-1] == self.n
        tb = self.tables(x.device)
        xs = x.reshape(1, -1, self.n)
        p = self._p(tb, 2)
        r = torch.where(xs < 0, xs + p, xs)
        r = torch.where(r < 0, r + p, r)
        return self._twisted_fwd(r, tb, x.shape[:-1])

    def fwd(self, x: torch.Tensor) -> torch.Tensor:
        """Forward transform of int64-held u64 torus values (cold path:
        key transforms, key-algebra products): -> int64[P, ..., N]."""
        assert x.shape[-1] == self.n
        tb = self.tables(x.device)
        xs = x.reshape(-1, self.n)
        r = torch.stack([urem(xs, p) for p in self.primes])
        return self._twisted_fwd(r, tb, x.shape[:-1])

    def fwd_signed(self, x: torch.Tensor) -> torch.Tensor:
        """Forward transform of signed int64 values of any size (digits of
        a base beyond the primes, e.g. the squashed-list packing
        keyswitch's base 2^61): each reduced with a full remainder first.
        -> int64[P, ..., N]."""
        assert x.shape[-1] == self.n
        tb = self.tables(x.device)
        r = torch.remainder(x.reshape(1, -1, self.n), self._p(tb, 2))
        return self._twisted_fwd(r, tb, x.shape[:-1])

    def fwd_u128(self, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
        """Forward transform of u128 values held as (hi, lo) int64 limb
        pairs: each reduced as (hi mod p)(2^64 mod p) + lo mod p, both limbs
        read as full u64. -> int64[P, ..., N]."""
        assert hi.shape == lo.shape and hi.shape[-1] == self.n
        tb = self.tables(hi.device)
        hs, ls = hi.reshape(-1, self.n), lo.reshape(-1, self.n)
        r = torch.stack([(urem(hs, p) * ((1 << 64) % p) + urem(ls, p)) % p
                         for p in self.primes])
        return self._twisted_fwd(r, tb, hi.shape[:-1])

    def _twisted_fwd(self, r: torch.Tensor, tb, lead) -> torch.Tensor:
        """The psi twist and the DIF stages on canonical residues r [P, M,
        N], shaped back to [P, *lead, N]."""
        p = self._p(tb, 2)
        r = shoup_mul(r, tb["twist"][:, None], tb["twist_sh"][:, None], p)
        return self._fwd_stages(r, tb).reshape((self.num_primes,)
                                               + tuple(lead) + (self.n,))

    def _fwd_stages(self, r: torch.Tensor, tb) -> torch.Tensor:
        """DIF stages on r [P, M, N]."""
        n = self.n
        P, M = r.shape[0], r.shape[1]
        p = self._p(tb, 3)
        for s in range(self.log_n):
            m = n >> s
            h = m >> 1
            rr = r.reshape(P, M, n // m, 2, h)
            a = rr[..., 0, :]
            b = rr[..., 1, :]
            w = tb["fwd"][s][:, None, None]
            ws = tb["fwd_sh"][s][:, None, None]
            u = a + b
            u = torch.where(u >= p, u - p, u)
            v = shoup_mul(a - b + p, w, ws, p)
            r = torch.stack([u, v], dim=-2).reshape(P, M, n)
        return r

    # -- inverse ------------------------------------------------------------
    def inv(self, xhat: torch.Tensor) -> torch.Tensor:
        """Inverse transform: residues [P, ..., N] of the integer result
        coefficients (canonical, < p)."""
        n = self.n
        tb = self.tables(xhat.device)
        shape = xhat.shape
        P = self.num_primes
        r = xhat.reshape(P, -1, n)
        M = r.shape[1]
        p = self._p(tb, 3)
        for s in reversed(range(self.log_n)):
            m = n >> s
            h = m >> 1
            rr = r.reshape(P, M, n // m, 2, h)
            u = rr[..., 0, :]
            v = rr[..., 1, :]
            w = tb["inv"][s][:, None, None]
            ws = tb["inv_sh"][s][:, None, None]
            bw = shoup_mul(v, w, ws, p)
            a = u + bw
            a = torch.where(a >= p, a - p, a)
            b = u - bw + p
            b = torch.where(b >= p, b - p, b)
            r = torch.stack([a, b], dim=-2).reshape(P, M, n)
        p2 = self._p(tb, 2)
        out = shoup_mul(r, tb["untwist"][:, None], tb["untwist_sh"][:, None],
                        p2)
        return out.reshape(shape)

    # -- CRT reconstruction ---------------------------------------------------
    def reconstruct_u64(self, residues: torch.Tensor) -> torch.Tensor:
        """Garner mixed-radix CRT with sign correction: residues [P, ...] of
        a centered integer x (|x| < prod(primes)/2) -> x mod 2^64 (int64)."""
        P = self.num_primes
        ps = self.primes
        m = [residues[i] for i in range(P)]
        v = [m[0]]
        for i in range(1, P):
            pi = ps[i]
            acc = v[i - 1]
            for j in range(i - 2, -1, -1):
                acc = v[j] + shoup_mul(acc, ps[j], self.pj_shoup[i][j], pi)
            diff = 2 * pi + m[i] - acc  # < 3*p_i < 2^32
            v.append(shoup_mul(diff, self.garner_inv[i - 1],
                               self.garner_inv_shoup[i - 1], pi))
        pos = torch.zeros_like(v[0])
        for i in range(P):
            pos = pos + v[i] * u64_const(self.prefix_mod64[i])
        neg = pos - u64_const(self.full_prod_mod64)
        sign = v[P - 1] > ps[P - 1] // 2
        return torch.where(sign, neg, pos)


@functools.lru_cache(maxsize=None)
def get_plan(n: int, num_primes: int, primes: tuple = None) -> NegacyclicNtt:
    return NegacyclicNtt(n, num_primes, primes=primes)


def with_shoup_duals(res: torch.Tensor, plan: NegacyclicNtt) -> torch.Tensor:
    """Residues u32 [P, ...] over ``plan``'s primes (any integer dtype) ->
    int32 (u32) [2, P, ...]: the residues and their Shoup duals
    floor(res * 2^32 / p), one int64 division an entry (res < 2^30, so
    res << 32 stays below 2^62)."""
    res = res.to(torch.int64) & M32
    p = plan.tables(res.device)["p"].reshape(
        (plan.num_primes,) + (1,) * (res.ndim - 1))
    shoup = torch.div(res << 32, p, rounding_mode="floor")
    return i64_to_u32(torch.stack([res, shoup])).contiguous()
