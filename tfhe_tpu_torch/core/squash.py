"""u128-torus core crypto for noise squashing (the 128-bit PBS) — torch.

Torch counterpart of ``tfhe_tpu/core/squash.py``. The reference implements
noise squashing with a dedicated f128 FFT (``tfhe-fft/src/fft128``,
``core_crypto/fft_impl/fft128``) and u128 torus entities. Here the u128
torus is a (hi, lo) pair of int64 tensors holding u64 limbs (``_torus``'s
carrier: wrap-around arithmetic, logical right shifts by ``srl``, unsigned
compares by ``ult``), and the polynomial products run over the port's
CRT-NTT (``ops/ntt.py``), widened to a 6-prime budget (|coeff| of the
external-product integer result < 2^166 < prod(6 primes)/2).

Flow (shortint/noise_squashing/atomic_pattern/standard.rs:63-150,
server_key/mod.rs:1561-1610): keyswitch (caller) -> modulus switch ->
blind rotation over the u128 torus with a u128-GGSW bootstrap key ->
sample extract. Decomposition follows decomposer.rs bit for bit, widened
to 128 bits. Random draws come from the host CSPRNG in ``tfhe_tpu``'s
calls and order, so equal seeds give bit-equal keys; the arithmetic runs
on the device of the secret key.

One difference from ``tfhe_tpu``: :func:`sample_extract128` negates the
wrapped mask coefficients as 128-bit pairs (hi' = -hi - (lo != 0)), as
tfhe-rs does, where ``tfhe_tpu`` negates each limb on its own and so adds
2^64 to every negated coefficient whose lo limb is not 0 (ROADMAP standing
note 14).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._torus import M32, from_u64, srl, u64_const, ult
from ..ops import ntt as ntt_mod
from ..utils.csprng import EncryptionRandomGenerator
from ..utils.params import DynamicDistribution, NoiseSquashingParameters
from .algorithms import _binary_polymul_batch
from .entities import LweSecretKey

_MASK64 = (1 << 64) - 1
_MASK128 = (1 << 128) - 1
#: rows of N coefficients forward-transformed at once into a key's
#: residues (bounds the int64 temporaries of the largest keys)
KEY_FWD_ROWS = 4096


# ---------------------------------------------------------------------------
# (hi, lo) u64-pair helpers on int64 tensors
# ---------------------------------------------------------------------------

def add128(ahi, alo, bhi, blo):
    lo = alo + blo
    return ahi + bhi + ult(lo, alo).to(torch.int64), lo


def sub128(ahi, alo, bhi, blo):
    return ahi - bhi - ult(alo, blo).to(torch.int64), alo - blo


def neg128(hi, lo):
    """The 128-bit two's-complement negation of the pair."""
    return -hi - (lo != 0).to(torch.int64), -lo


def _halves(b):
    """(high, low) 32-bit halves of u64 values: tensors or a python int."""
    if isinstance(b, int):
        b &= _MASK64
        return b >> 32, b & M32
    return srl(b, 32), b & M32


def mul_u64_wide(a, b):
    """Full 128-bit product of u64 values -> (hi, lo); ``b`` may be a
    python int."""
    ah, al = _halves(a)
    bh, bl = _halves(b)
    t0 = al * bl
    t1 = al * bh
    t2 = ah * bl
    t3 = ah * bh
    mid = srl(t0, 32) + (t1 & M32) + (t2 & M32)
    lo = (t0 & M32) | (mid << 32)
    hi = t3 + srl(t1, 32) + srl(t2, 32) + srl(mid, 32)
    return hi, lo


# ---------------------------------------------------------------------------
# 128-bit signed gadget decomposition (decomposer.rs widened to 128 bits)
# ---------------------------------------------------------------------------

def decompose128(hi: torch.Tensor, lo: torch.Tensor, base_log: int,
                 level_count: int) -> torch.Tensor:
    """Balanced signed digits of u128 (hi, lo) values: int64[...,
    level_count], the level ``level_count`` digit first (the order of
    ``ops.decomp.decompose``). Two regimes: rep = base_log * level_count
    <= 63 (the squashed-list packing keyswitch, 61 x 1) and 64 < rep <=
    126 (the squash PBS, 24 x 3)."""
    rep = base_log * level_count
    assert 0 < rep <= 126, rep
    non_rep = 128 - rep
    if rep <= 63:
        # the rounded state fits one u64 limb: the u64 decomposer on
        # x >> 64 with a 128-bit shift origin
        res = srl(hi, non_rep - 1 - 64)  # x >> (non_rep - 1)
        rounding = res & 1
        res = srl(res + 1, 1) & ((1 << rep) - 1)
        need_balance = (((res - 1) | (rounding << (rep - 1))) & res) \
            >> (rep - 1)
        state = res - (need_balance << rep)
        digits = []
        mod_b = (1 << base_log) - 1
        for _ in range(level_count):
            r = state & mod_b
            state = state >> base_log
            carry = (((r - 1) | state) & r) >> (base_log - 1)
            state = state + carry
            digits.append(r - (carry << base_log))
        return torch.stack(digits, dim=-1)
    s = non_rep - 1  # in [1, 63]
    # res = x >> (non_rep - 1): a (rep+1)-bit value on the pair
    res_lo = srl(lo, s) | (hi << (64 - s))
    res_hi = srl(hi, s)
    rounding = res_lo & 1
    # res = (res + 1) >> 1
    res_lo2 = res_lo + 1
    res_hi2 = res_hi + (res_lo2 == 0).to(torch.int64)
    res_lo = srl(res_lo2, 1) | (res_hi2 << 63)
    res_hi = srl(res_hi2, 1) & ((1 << (rep - 64)) - 1)  # mod 2^rep
    # the need_balance bit trick at bit rep-1 (in the hi limb)
    top = rep - 1 - 64
    m1_hi = res_hi - (res_lo == 0).to(torch.int64)
    need_balance = (((m1_hi | (rounding << top)) & res_hi) >> top) & 1
    # state = res - (need_balance << rep), two's complement on the pair
    st_hi = res_hi - (need_balance << (rep - 64))
    st_lo = res_lo
    digits = []
    mod_b = (1 << base_log) - 1
    for _ in range(level_count):
        res = st_lo & mod_b  # the digit candidate (unsigned low bits)
        # state >>= base_log, an arithmetic shift of the signed pair
        st_lo = srl(st_lo, base_log) | (st_hi << (64 - base_log))
        st_hi = st_hi >> base_log
        carry = srl(((res - 1) | st_lo) & res, base_log - 1) & 1
        st_lo2 = st_lo + carry
        st_hi = st_hi + ult(st_lo2, st_lo).to(torch.int64)
        st_lo = st_lo2
        digits.append(res - (carry << base_log))
    return torch.stack(digits, dim=-1)


# ---------------------------------------------------------------------------
# entities
# ---------------------------------------------------------------------------

@dataclass
class GlweSecretKey128:
    """Binary GLWE secret key used over the u128 torus (bits are bits; only
    the torus width differs): int64[k, N] in {0, 1}."""

    bits: torch.Tensor

    @property
    def glwe_dim(self) -> int:
        return self.bits.shape[0]

    @property
    def poly_size(self) -> int:
        return self.bits.shape[1]

    def as_lwe_bits(self) -> torch.Tensor:
        return self.bits.reshape(-1)


@dataclass
class LweBootstrapKey128:
    hi: torch.Tensor  # int64 (u64) [n, l, R, R, N]
    lo: torch.Tensor
    base_log: int
    levels: int


@dataclass
class NttLweBootstrapKey128:
    residues: torch.Tensor  # int32 (u32, all < 2^30) [P, n, l, R, R, N]
    base_log: int
    levels: int
    num_primes: int


# ---------------------------------------------------------------------------
# keygen / encrypt / decrypt over the u128 torus
# ---------------------------------------------------------------------------

def num_primes_for_squash(params: NoiseSquashingParameters) -> int:
    bound = ntt_mod.polymul_bound_bits(
        params.decomp_base_log, params.polynomial_size,
        num_sums=params.decomp_level_count * params.glwe_size,
        torus_bits=128)
    return ntt_mod.min_primes_for_bound(bound)


def _crt_polymul_int(s_bits: torch.Tensor, polys: torch.Tensor,
                     n_primes: int = 4):
    """Exact negacyclic s (binary, int64[N]) x polys (u64, int64[m, N]) as
    a 128-bit result (hi, lo). Negacyclic wrap terms subtract, so the true
    coefficients are signed with |coeff| < N * 2^64 << prod(primes)/2:
    reconstructed with the sign correction, reduced mod 2^128."""
    n = polys.shape[-1]
    plan = ntt_mod.get_plan(n, n_primes)
    s_hat = plan.fwd_digits(s_bits)[:, None]  # [P, 1, N]
    m_hat = plan.fwd(polys)  # [P, m, N]
    prod = (s_hat * m_hat) % plan.p_like(2, polys.device)
    return _reconstruct128(plan, plan.inv(prod))


def _binary_dot128(sk_bits: torch.Tensor, mask_hi: torch.Tensor,
                   mask_lo: torch.Tensor):
    """<s, mask> over Z_{2^128}[X]/(X^N+1): sum_k s_k (*) mask_k.
    ``sk_bits``: int64[k, N]; masks int64[m, k, N] -> (hi, lo) [m, N]."""
    m, k, n = mask_lo.shape
    hi_t = torch.zeros((m, n), dtype=torch.int64, device=mask_lo.device)
    lo_t = torch.zeros_like(hi_t)
    for r in range(k):
        dhi, dlo = _crt_polymul_int(sk_bits[r], mask_lo[:, r])
        # + 2^64 * (s (*) mask_hi mod 2^64)
        hi_part = _binary_polymul_batch(sk_bits[r:r + 1],
                                        mask_hi[:, r:r + 1])
        hi_t, lo_t = add128(hi_t, lo_t, dhi + hi_part, dlo)
    return hi_t, lo_t


def sample_noise128(gen: EncryptionRandomGenerator, dist: DynamicDistribution,
                    n: int):
    """Noise on the u128 torus as numpy u64 (hi, lo). T-uniform bounds are
    < 2^62, so the value fits one u64 draw, sign-extended into the hi
    limb."""
    if dist.kind == "t_uniform":
        v = gen.noise.t_uniform_torus_u64(n, dist.bound_log2)
        hi = np.where(v.astype(np.int64) < 0, np.uint64(_MASK64),
                      np.uint64(0)).astype(np.uint64)
        return hi, v.astype(np.uint64)
    # gaussian: the f64 samples carry <= 53 bits of precision (the
    # reference's f64-pair sampling has the same limit); scaled to 2^128
    # and split into limbs
    f = gen.noise.gaussian_pairs_f64((n + 1) // 2, dist.std_dev)[:n]
    scaled = np.ldexp(f, 128)
    hi_f = np.floor(np.ldexp(f, 64))
    lo_f = scaled - np.ldexp(hi_f, 64)  # in [0, 2^64)
    with np.errstate(over="ignore", invalid="ignore"):
        hi = hi_f.astype(np.int64).astype(np.uint64)
        lo = np.minimum(lo_f, np.nextafter(2.0 ** 64, 0)).astype(np.uint64)
    return hi, lo


def glwe_encrypt128(sk: GlweSecretKey128, pts_hi: torch.Tensor,
                    pts_lo: torch.Tensor, noise: DynamicDistribution,
                    gen: EncryptionRandomGenerator):
    """Plaintext polynomials (hi, lo) int64[m, N] on the key's device ->
    (hi, lo) int64[m, k+1, N]. The mask is one draw of 16 bytes a
    coefficient, lo limb first (the LE u128 convention), then the
    noise."""
    m, n = pts_lo.shape
    k = sk.glwe_dim
    dev = sk.bits.device
    raw = gen.mask.uniform_u64(2 * m * k * n).reshape(m, k, n, 2)
    mask_lo = from_u64(raw[..., 0], dev)
    mask_hi = from_u64(raw[..., 1], dev)
    del raw
    nhi, nlo = sample_noise128(gen, noise, m * n)
    dhi, dlo = _binary_dot128(sk.bits, mask_hi, mask_lo)
    bhi, blo = add128(dhi, dlo, pts_hi, pts_lo)
    bhi, blo = add128(bhi, blo, from_u64(nhi, dev).reshape(m, n),
                      from_u64(nlo, dev).reshape(m, n))
    return (torch.cat([mask_hi, bhi[:, None]], dim=1),
            torch.cat([mask_lo, blo[:, None]], dim=1))


def glwe_decrypt128(sk: GlweSecretKey128, ct_hi: torch.Tensor,
                    ct_lo: torch.Tensor):
    """(hi, lo) int64[m, k+1, N] -> raw plaintexts (hi, lo) [m, N]."""
    k = sk.glwe_dim
    dhi, dlo = _binary_dot128(sk.bits, ct_hi[:, :k], ct_lo[:, :k])
    return sub128(ct_hi[:, k], ct_lo[:, k], dhi, dlo)


def gen_bootstrap_key128(in_sk: LweSecretKey, glwe_sk: GlweSecretKey128,
                         base_log: int, levels: int,
                         noise: DynamicDistribution,
                         gen: EncryptionRandomGenerator
                         ) -> LweBootstrapKey128:
    """GGSW(bit) of each input key element over the u128 torus
    (lwe_bootstrap_key_generation.rs widened; factor q/B^level with
    q = 2^128), all rows in one batched draw, on the GLWE key's device."""
    n = in_sk.dim
    k, N = glwe_sk.bits.shape
    R = k + 1
    dev = glwe_sk.bits.device
    msgs_hi = torch.zeros((n, levels, R, N), dtype=torch.int64, device=dev)
    msgs_lo = torch.zeros_like(msgs_hi)
    nb = -in_sk.bits.to(dev)  # -bit: all ones in both limbs for a 1
    for j in range(levels):
        shift = 128 - base_log * (levels - j)  # >= 56 for squash params
        # factor = (-bit) << shift mod 2^128
        if shift >= 64:
            fh, fl = nb << (shift - 64), torch.zeros_like(nb)
        else:
            fh, fl = (nb << shift) | srl(nb, 64 - shift), nb << shift
        for r in range(k):  # bits are 0/1, so the limb-wise product is exact
            msgs_hi[:, j, r] = glwe_sk.bits[r][None, :] * fh[:, None]
            msgs_lo[:, j, r] = glwe_sk.bits[r][None, :] * fl[:, None]
        msgs_hi[:, j, k, 0], msgs_lo[:, j, k, 0] = neg128(fh, fl)
    rows_hi, rows_lo = glwe_encrypt128(glwe_sk, msgs_hi.reshape(-1, N),
                                       msgs_lo.reshape(-1, N), noise, gen)
    return LweBootstrapKey128(hi=rows_hi.reshape(n, levels, R, R, N),
                              lo=rows_lo.reshape(n, levels, R, R, N),
                              base_log=base_log, levels=levels)


def key_residues128(hi: torch.Tensor, lo: torch.Tensor,
                    plan: ntt_mod.NegacyclicNtt) -> torch.Tensor:
    """Forward transforms of u128 key polynomials (hi, lo) int64[..., N]
    as int32 residues [P, ..., N], KEY_FWD_ROWS polynomials at a time."""
    n = hi.shape[-1]
    h, l_ = hi.reshape(-1, n), lo.reshape(-1, n)
    out = torch.empty((plan.num_primes, h.shape[0], n), dtype=torch.int32,
                      device=hi.device)
    for a in range(0, h.shape[0], KEY_FWD_ROWS):
        b = a + KEY_FWD_ROWS
        out[:, a:b] = plan.fwd_u128(h[a:b], l_[a:b]).to(torch.int32)
    return out.reshape((plan.num_primes,) + hi.shape)


def bootstrap_key128_to_ntt(bsk: LweBootstrapKey128,
                            num_primes: int) -> NttLweBootstrapKey128:
    plan = ntt_mod.get_plan(bsk.hi.shape[-1], num_primes)
    return NttLweBootstrapKey128(
        residues=key_residues128(bsk.hi, bsk.lo, plan),
        base_log=bsk.base_log, levels=bsk.levels, num_primes=num_primes)


# ---------------------------------------------------------------------------
# the 128-bit PBS (torch ops on the device)
# ---------------------------------------------------------------------------

def _monomial_mul128(hi, lo, degrees):
    """(hi, lo)[..., N] * X^degrees (negacyclic); ``degrees`` broadcasts
    against the leading dims. The wrap negation is the pair's 128-bit
    negation."""
    n = hi.shape[-1]
    degree = torch.as_tensor(degrees, dtype=torch.int64, device=hi.device)
    t = torch.arange(n, dtype=torch.int64, device=hi.device)
    src = (t - degree[..., None]) % (2 * n)
    neg = src >= n
    src = torch.where(neg, src - n, src)
    shape = torch.broadcast_shapes(degree.shape, hi.shape[:-1]) + (n,)
    src, neg = src.expand(shape), neg.expand(shape)
    ghi = torch.gather(hi.expand(shape), -1, src)
    glo = torch.gather(lo.expand(shape), -1, src)
    nhi, nlo = neg128(ghi, glo)
    return torch.where(neg, nhi, ghi), torch.where(neg, nlo, glo)


def _monomial_div128(hi, lo, degrees):
    n = hi.shape[-1]
    d = torch.as_tensor(degrees, dtype=torch.int64, device=hi.device)
    return _monomial_mul128(hi, lo, (2 * n - d) % (2 * n))


def _reconstruct128(plan: ntt_mod.NegacyclicNtt, residues: torch.Tensor):
    """Garner CRT -> the centered integer mod 2^128 as (hi, lo): residues
    [P, ...] (canonical) -> int64 pairs [...]."""
    P = plan.num_primes
    ps = plan.primes
    m = [residues[i] for i in range(P)]
    v = [m[0]]
    for i in range(1, P):
        pi = ps[i]
        acc = v[i - 1]
        for j in range(i - 2, -1, -1):
            acc = v[j] + ntt_mod.shoup_mul(acc, ps[j], plan.pj_shoup[i][j],
                                           pi)
            # keep the partial < 2 p_i for the next Shoup round
            acc = torch.where(acc >= 2 * pi, acc - 2 * pi, acc)
        # acc < 2 p_i, so diff stays in (0, 4 p_i) and 4 p < 2^32
        diff = 3 * pi + m[i] - acc
        v.append(ntt_mod.shoup_mul(diff, plan.garner_inv[i - 1],
                                   plan.garner_inv_shoup[i - 1], pi))
    hi = torch.zeros_like(v[0])
    lo = torch.zeros_like(v[0])
    pre = 1
    for i in range(P):
        pw = pre & _MASK128
        thi, tlo = mul_u64_wide(v[i], pw & _MASK64)
        thi = thi + v[i] * u64_const(pw >> 64)
        hi, lo = add128(hi, lo, thi, tlo)
        pre *= ps[i]
    full = pre & _MASK128
    nhi, nlo = sub128(hi, lo, u64_const(full >> 64), u64_const(full))
    sign = v[P - 1] > ps[P - 1] // 2
    return torch.where(sign, nhi, hi), torch.where(sign, nlo, lo)


def external_product128(ggsw_res: torch.Tensor, acc_hi: torch.Tensor,
                        acc_lo: torch.Tensor, base_log: int, levels: int,
                        plan: ntt_mod.NegacyclicNtt):
    """GGSW (NTT residues [P, l, R, R, N], any integer dtype) x GLWE128
    (hi, lo) [..., R, N] -> the product (hi, lo) [..., R, N]. Each product
    is reduced mod p before the sum: nine raw products below 2^60 would
    overflow int64."""
    R, N = acc_hi.shape[-2:]
    nb = acc_hi.ndim - 2
    digits = decompose128(acc_hi, acc_lo, base_log, levels)  # [.., R, N, l]
    dhat = plan.fwd_digits(torch.movedim(digits, -1, -3))  # [P, .., l, R, N]
    g = ggsw_res.to(torch.int64).reshape(
        (plan.num_primes,) + (1,) * nb + (levels, R, R, N))
    dev = acc_hi.device
    prod = (dhat[..., None, :] * g) % plan.p_like(nb + 4, dev)
    acc_hat = prod.sum(dim=(-4, -3)) % plan.p_like(nb + 2, dev)
    return _reconstruct128(plan, plan.inv(acc_hat))


def blind_rotate128(lut_hi, lut_lo, msed_mask, msed_body, bsk_res,
                    base_log: int, levels: int,
                    plan: ntt_mod.NegacyclicNtt):
    """u128 blind rotation: LUT (hi, lo) [..., R, N], switched mask
    [..., n] and body [...]; ``bsk_res`` int32 [P, n, l, R, R, N]. A loop
    over the n steps on the key's device, each upcasting its own slice of
    the key."""
    acc_hi, acc_lo = _monomial_div128(lut_hi, lut_lo, msed_body[..., None])
    for i in range(bsk_res.shape[1]):
        rhi, rlo = _monomial_mul128(acc_hi, acc_lo, msed_mask[..., i, None])
        d_hi, d_lo = sub128(rhi, rlo, acc_hi, acc_lo)
        ehi, elo = external_product128(bsk_res[:, i], d_hi, d_lo, base_log,
                                       levels, plan)
        acc_hi, acc_lo = add128(acc_hi, acc_lo, ehi, elo)
    return acc_hi, acc_lo


def sample_extract128(glwe_hi: torch.Tensor, glwe_lo: torch.Tensor,
                      nth: int = 0):
    """GLWE128 (hi, lo) [..., k+1, N] -> LWE128 of its nth coefficient
    (hi, lo) [..., k*N + 1] (glwe_sample_extraction.rs:89): mask
    coefficient i is a[nth - i] for i <= nth and -a[N + nth - i] above,
    each negation the pair's 128-bit one (tfhe-rs' u128 arithmetic;
    ``tfhe_tpu`` negates the limbs apart, ROADMAP standing note 14)."""
    k = glwe_hi.shape[-2] - 1
    N = glwe_hi.shape[-1]
    lead = glwe_hi.shape[:-2]
    src = nth - torch.arange(N, device=glwe_hi.device)
    neg = src < 0
    src = torch.where(neg, src + N, src)
    mhi, mlo = glwe_hi[..., :k, :][..., src], glwe_lo[..., :k, :][..., src]
    nhi, nlo = neg128(mhi, mlo)
    mhi = torch.where(neg, nhi, mhi).reshape(lead + (k * N,))
    mlo = torch.where(neg, nlo, mlo).reshape(lead + (k * N,))
    return (torch.cat([mhi, glwe_hi[..., k, nth, None]], dim=-1),
            torch.cat([mlo, glwe_lo[..., k, nth, None]], dim=-1))
