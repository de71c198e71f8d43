"""Server-side operations of the atomic patterns, in torch.

Torch counterpart of ``tfhe_tpu/ops/server.py``:

- keyswitch: ``core_crypto/algorithms/lwe_keyswitch.rs:137-230``, computed
  as ONE int8 GEMM of the gadget digits against the KSK in signed base-256
  limbs (``torch._int_mm``; the JAX package leaves the same product to
  XLA's ``jnp.dot``), for base logs above 7 (the casting keys', up to 2^23
  a digit) one GEMM a digit limb (:func:`limb_matmul`), and the KS32
  keyswitch onto the u32 torus (``lwe_keyswitch.rs:331``, 4 limbs);
- modulus switch to 2N from the u64 or the u32 torus, standard or with the
  centered-binary body correction (``algorithms/modulus_switch.rs:35-104``),
  and the drift technique's choice of an encryption of zero
  (``modulus_switch_noise_reduction.rs``);
- sample extraction (``algorithms/glwe_sample_extraction.rs:89``), also at
  one coefficient per GLWE of a batch;
- the exact CRT spec: external product, cmux, the cmux steps, blind rotation
  (exact, or in acc32 mode) and the portable PBS over P NTT primes with
  Garner reconstruction;
- the blind rotations and programmable bootstraps that run the kernels
  (``ops/pbs_kernel.py``): the exact CRT PBS (K2 u64, K3; under
  ``TFHE_V4_ACC=32`` K2 acc32, K3-acc32), the v6/v6b BNF PBS (K2, K1 in
  acc32 mode; K2 u64, K3-bnf2 in two-plane mode) and the v5 Goldilocks PBS
  (K2 u64, K4);
- the multi-bit PBS (``lwe_multi_bit_programmable_bootstrapping.rs``): the
  torch spec of ``tfhe_tpu``'s ``multi_bit_blind_rotate`` (n/g external
  products against GGSWs combined in the transform domain, split into the
  key bundles and the accumulate), and the path that runs its kernels (K2
  u64, then K5a and K5b a chunk of steps).

Tensors are int64 torus values (see ``_torus.py``), batched over leading
dims; u32 torus values (KS32) ride in int64, reduced to 32 bits after every
wrap.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .._torus import M32, srl, u32_to_i64
from . import bnf2 as bnf2_mod
from . import ntt as ntt_mod
from . import pbs_kernel as pk
from .decomp import decompose
from .polynomial import monomial_div, monomial_mul

# ---------------------------------------------------------------------------
# keyswitch: exact products mod 2^64 through int8 GEMMs
# ---------------------------------------------------------------------------

_LIMB_WEIGHTS = tuple(1 << (8 * k) for k in range(8))


def u64_to_i8_limbs(x: torch.Tensor) -> torch.Tensor:
    """int64-held u64 values in signed base-256 limb form on their device,
    int64[...] -> int8[..., 8]: x = sum(limb_k * 256^k) mod 2^64 with
    limb_k in [-128, 127] (the 9th carry limb contributes 2^64 == 0 and is
    dropped; the arithmetic shift changes only bits that limb would
    hold)."""
    limbs = []
    for _ in range(8):
        r = ((x + 128) & 0xFF) - 128
        limbs.append(r.to(torch.int8))
        x = (x - r) >> 8
    return torch.stack(limbs, dim=-1)


def ksk_limbs(ksk: torch.Tensor, base_log: int,
              u32: bool = False) -> torch.Tensor:
    """The KSK in the limb form of :func:`u64_to_i8_limbs` on its device:
    int64-held u64 [n_in, l, n_out+1] -> int8[n_in * l, (n_out+1) * 8]
    (``tfhe_tpu``'s contract, which keeps the compute keys' base_log <= 7);
    ``u32``: a KS32 key's u32 entries, in their low 4 limbs (the carry out
    of them is 0 mod 2^32), int8[n_in * l, (n_out+1) * 4]."""
    assert base_log <= 7, "balanced digits must fit int8 for the keyswitch"
    n_in, l, o = ksk.shape
    if u32:
        return u64_to_i8_limbs(ksk & _MASK32)[..., :4].reshape(n_in * l,
                                                               o * 4)
    return u64_to_i8_limbs(ksk).reshape(n_in * l, o * 8)


def ksk_to_i8_limbs(ksk: np.ndarray, base_log: int) -> np.ndarray:
    """:func:`ksk_limbs` of a numpy u64 KSK, on the host."""
    x = torch.from_numpy(np.asarray(ksk, dtype=np.uint64).view(np.int64))
    return ksk_limbs(x, base_log).numpy()


def _int_mm(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, O] -> int32 [M, O] through ``torch._int_mm``,
    zero-padded to its CUDA shape rules (M > 16 and a multiple of 8, K and
    O multiples of 8)."""
    M, K = a8.shape
    O = b8.shape[1]
    pad_m, pad_k, pad_o = max(24, -(-M // 8) * 8) - M, -K % 8, -O % 8
    if pad_m or pad_k:
        a8 = torch.cat([a8, a8.new_zeros((M, pad_k))], dim=1)
        a8 = torch.cat([a8, a8.new_zeros((pad_m, K + pad_k))])
    if pad_k or pad_o:
        b8 = torch.cat([b8, b8.new_zeros((K, pad_o))], dim=1)
        b8 = torch.cat([b8, b8.new_zeros((pad_k, O + pad_o))])
    return torch._int_mm(a8, b8)[:M, :O]


def limb_matmul(d: torch.Tensor, w_i8: torch.Tensor,
                digit_bits: int) -> torch.Tensor:
    """sum_k d[m, k] * W[k, o] mod 2^64, exact, for signed ``d`` with
    |d| <= 2^(digit_bits - 1) (gadget digits, or 0/1 selections with
    ``digit_bits`` = 1) and u64 ``W`` given by its limbs ``w_i8``
    [K, O*8] (:func:`u64_to_i8_limbs`): one int8 GEMM a digit limb
    (digit_bits // 8 + 1 signed base-256 limbs; one GEMM up to 7 bits),
    the 8 limb sums recombined as sum_k s_k * 2^(8k). A GEMM's row sum
    stays below K * 128 * min(2^(digit_bits-1), 128) < 2^31. Returns
    int64[M, O]."""
    M, K = d.shape
    O = w_i8.shape[1] // 8
    assert K * 128 * min(1 << (digit_bits - 1), 128) < 1 << 31, \
        "an int8 GEMM row sum would overflow int32"
    w = torch.tensor(_LIMB_WEIGHTS, dtype=torch.int64, device=d.device)
    n_limbs = digit_bits // 8 + 1
    total = 0
    for a in range(n_limbs):
        r = d
        if a < n_limbs - 1:
            r = ((d + 128) & 0xFF) - 128
            d = (d - r) >> 8
        sums = _int_mm(r.to(torch.int8), w_i8).reshape(M, O, 8)
        total = total + ((sums.to(torch.int64) * w).sum(dim=-1) << (8 * a))
    return total


def keyswitch_mxu(ct: torch.Tensor, ksk_i8: torch.Tensor, base_log: int,
                  levels: int) -> torch.Tensor:
    """LWE keyswitch (``lwe_keyswitch.rs:137-230``) as int8 GEMMs:
    out = [0 | b] - sum_{i,l} digit_{i,l} * KSK[i, l] mod 2^64, the digits
    ``[B, n_in*l]`` against the KSK's limbs ``[n_in*l, (n_out+1)*8]`` by
    :func:`limb_matmul`: ONE GEMM for base_log <= 7 (``tfhe_tpu``'s
    ``keyswitch_mxu``), one a digit limb above (its generic ``keyswitch``:
    the casting keys' digits reach 2^23).

    ``ct``: int64[..., n_in+1]; ``ksk_i8``: int8[n_in*l, (n_out+1)*8]."""
    K, O8 = ksk_i8.shape
    n_in, n_out = K // levels, O8 // 8 - 1
    batch = ct.shape[:-1]
    d = decompose(ct[..., :n_in], base_log, levels).reshape(-1, K)
    out = -limb_matmul(d, ksk_i8, base_log).reshape(batch + (n_out + 1,))
    out[..., n_out] += ct[..., n_in]
    return out


# ---------------------------------------------------------------------------
# keyswitch with scalar change (u64 -> u32): the KS32 atomic pattern
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def ksk32_to_i8_limbs(ksk32: np.ndarray, base_log: int) -> np.ndarray:
    """:func:`ksk_limbs` of a numpy KS32 KSK (u64 values < 2^32), on the
    host: int8[n_in*l, (n_out+1)*4]."""
    x = torch.from_numpy(np.asarray(ksk32, dtype=np.uint64).view(np.int64))
    return ksk_limbs(x, base_log, u32=True).numpy()


def keyswitch_mxu32(ct: torch.Tensor, ksk_i8: torch.Tensor, base_log: int,
                    levels: int) -> torch.Tensor:
    """u64 -> u32 LWE keyswitch as one int8 GEMM
    (``lwe_keyswitch.rs:331`` keyswitch_lwe_ciphertext_with_scalar_change):
    the mask decomposes with the u64 decomposer, the MAC runs against the
    4 u32 limbs, the body rounds to the closest multiple of 2^32 (ties up)
    and shifts down, and the output wraps mod 2^32.

    ``ct``: int64[..., n_in+1]; ``ksk_i8``: int8[n_in*l, (n_out+1)*4].
    Returns int64[..., n_out+1] holding u32 values."""
    K, O4 = ksk_i8.shape
    n_in, n_out = K // levels, O4 // 4 - 1
    batch = ct.shape[:-1]
    d8 = decompose(ct[..., :n_in], base_log, levels).to(torch.int8)
    sums = _int_mm(d8.reshape(-1, K), ksk_i8)
    sums = sums.reshape(batch + (n_out + 1, 4)).to(torch.int64)
    w = torch.tensor(_LIMB_WEIGHTS[:4], dtype=torch.int64, device=ct.device)
    out = -(sums * w).sum(dim=-1)
    out[..., n_out] += srl(ct[..., n_in] + (1 << 31), 32)
    return out & _MASK32


# ---------------------------------------------------------------------------
# modulus switch
# ---------------------------------------------------------------------------

def modulus_switch(x: torch.Tensor, log_modulus: int,
                   torus_bits: int = 64) -> torch.Tensor:
    """Round to the nearest multiple of 2^torus_bits / 2^log_modulus; the
    switched value in [0, 2^log_modulus) (fft_impl/common.rs:10).
    ``torus_bits`` = 32 reads the low 32 bits: the KS32 pattern's
    post-keyswitch modulus (``atomic_pattern/ks32.rs``)."""
    if torus_bits < 64:
        half = 1 << (torus_bits - log_modulus - 1)
        out = ((x & ((1 << torus_bits) - 1)) + half) >> (torus_bits
                                                          - log_modulus)
        return out & ((1 << log_modulus) - 1)
    half = 1 << (64 - log_modulus - 1)
    return srl(x + half, 64 - log_modulus)


def _trunc_div2(x: torch.Tensor) -> torch.Tensor:
    """Rust-style truncated (toward zero) division by two."""
    return torch.div(x, 2, rounding_mode="trunc")


def _ms_round_error(x: torch.Tensor, log_modulus: int,
                    torus_bits: int) -> torch.Tensor:
    """The signed rounding error rounded(x) - x of the modulus switch, as
    int64 (a torus_bits-wide wrapping difference, sign-extended)."""
    rounded = (modulus_switch(x, log_modulus, torus_bits)
               << (torus_bits - log_modulus))
    if torus_bits < 64:
        err = rounded - (x & ((1 << torus_bits) - 1))
        tb = 1 << (torus_bits - 1)
        return ((err + tb) & ((1 << torus_bits) - 1)) - tb
    return rounded - x


def centered_binary_ms_body_correction(mask: torch.Tensor, log_modulus: int,
                                       torus_bits: int = 64) -> torch.Tensor:
    """Correction added to the body before a centered-binary modulus switch
    (CenteredMeanNoiseReduction, algorithms/modulus_switch.rs:57).
    ``mask``: int64[..., n] -> int64[...]."""
    err = _ms_round_error(mask, log_modulus, torus_bits)
    half_err = _trunc_div2(err)
    halving_err_doubled = 2 * half_err - err  # in {-1, 0, 1}
    sum_half = half_err.sum(dim=-1)
    sum_halving = halving_err_doubled.sum(dim=-1)
    sum_half = sum_half - _trunc_div2(sum_halving)
    return sum_half - (1 << (torus_bits - log_modulus - 1))


def lwe_centered_binary_modulus_switch(ct: torch.Tensor, log_modulus: int,
                                       torus_bits: int = 64):
    """(switched_mask, switched_body) in [0, 2^log_modulus), with the
    centered-binary body correction applied before the switch."""
    n = ct.shape[-1] - 1
    mask = ct[..., :n]
    corr = centered_binary_ms_body_correction(mask, log_modulus, torus_bits)
    return (modulus_switch(mask, log_modulus, torus_bits),
            modulus_switch(ct[..., n] + corr, log_modulus, torus_bits))


def lwe_standard_modulus_switch(ct: torch.Tensor, log_modulus: int,
                                torus_bits: int = 64):
    n = ct.shape[-1] - 1
    return (modulus_switch(ct[..., :n], log_modulus, torus_bits),
            modulus_switch(ct[..., n], log_modulus, torus_bits))


# ---------------------------------------------------------------------------
# drift-technique modulus-switch noise reduction
# ---------------------------------------------------------------------------

def _ms_round_error_f64(x: torch.Tensor, log_modulus: int,
                        torus_bits: int = 64) -> torch.Tensor:
    """The switch's signed rounding error rounded(x) - x as f64
    (modulus_switch_noise_reduction.rs:14-36 round_error_float); |err| <=
    2^(torus_bits - log_modulus - 1) < 2^53, so the f64 value is exact."""
    return _ms_round_error(x, log_modulus, torus_bits).to(torch.float64)


def choose_drift_candidate(ct: torch.Tensor, zeros: torch.Tensor,
                           r_sigma_factor: float, bound: float,
                           input_variance: float, log_modulus: int,
                           torus_bits: int = 64,
                           chunk: int = 64) -> torch.Tensor:
    """Drift-technique candidate selection (eprint 2024/1718; reference
    ``modulus_switch_noise_reduction.rs:99``): for each LWE, the candidates
    {no addition} and {ct + zeros[z]} are measured by
    ``|expectancy| + sqrt(variance + modular_input_variance) * r_sigma``
    with expectancy = body_err - sum(mask_err)/2 and variance =
    sum(mask_err^2)/4 over the switch's rounding errors. Returns the
    candidate index of each LWE (0 = no addition, z+1 = zeros[z]): the
    first candidate whose measure is <= ``bound``, else the first minimum.

    ``ct``: int64[..., n+1]; ``zeros``: int64[Z, n+1]. The modular
    variance is input_variance * 2^(2*torus_bits). Candidates are measured
    ``chunk`` at a time on the ciphertexts' device, to bound the transient
    memory (all of them at once would not fit at production zero counts).
    At torus_bits = 32 every summand is an integer below 2^53 and the sums
    are exact in any order; at 64 bits a sum may round, so a near-tie can
    fall to another candidate than ``tfhe_tpu``'s."""
    n = ct.shape[-1] - 1
    zeros_ext = torch.cat([zeros.new_zeros((1, n + 1)), zeros.to(ct.device)])
    mod_var = float(input_variance) * float(2.0 ** (2 * torus_bits))
    r_sigma = float(r_sigma_factor)
    measures = []
    for z0 in range(0, zeros_ext.shape[0], chunk):
        zk = zeros_ext[z0:z0 + chunk]
        cand = ct[None] + zk.reshape((zk.shape[0],) + (1,) * (ct.ndim - 1)
                                     + (n + 1,))
        err = _ms_round_error_f64(cand, log_modulus, torus_bits)
        mask_err = err[..., :n]
        expectancy = err[..., n] - mask_err.sum(dim=-1) / 2.0
        variance = (mask_err * mask_err).sum(dim=-1) / 4.0
        measures.append(expectancy.abs()
                        + torch.sqrt(variance + mod_var) * r_sigma)
    measures = torch.cat(measures)  # [Z+1, ...]
    sat = measures <= float(bound)
    first_sat = torch.argmax(sat.to(torch.int8), dim=0)  # first True
    best = torch.argmin(measures, dim=0)  # first occurrence of the min
    return torch.where(sat.any(dim=0), first_sat, best)


def improve_drift_ms(ct: torch.Tensor, zeros: torch.Tensor,
                     r_sigma_factor: float, bound: float,
                     input_variance: float, log_modulus: int,
                     torus_bits: int = 64) -> torch.Tensor:
    """Add the chosen encryption of zero to each LWE (identity when the
    no-addition candidate wins). The modulus switch that follows must be
    the standard rounding switch (reference
    improve_noise_and_modulus_switch -> lwe_ciphertext_modulus_switch)."""
    idx = choose_drift_candidate(ct, zeros, r_sigma_factor, bound,
                                 input_variance, log_modulus, torus_bits)
    n = ct.shape[-1] - 1
    zeros_ext = torch.cat([zeros.new_zeros((1, n + 1)), zeros.to(ct.device)])
    return ct + zeros_ext[idx]


# ---------------------------------------------------------------------------
# sample extraction
# ---------------------------------------------------------------------------

def sample_extract(glwe: torch.Tensor, nth: int = 0) -> torch.Tensor:
    """GLWE -> LWE of the nth coefficient (glwe_sample_extraction.rs:89).
    ``glwe``: int64[..., k+1, N] -> int64[..., k*N + 1]."""
    k = glwe.shape[-2] - 1
    N = glwe.shape[-1]
    body = glwe[..., k, nth]
    rev = glwe[..., :k, :].flip(-1)
    opp = N - nth - 1
    idx = torch.arange(N, device=glwe.device)
    neg = torch.where(idx < opp, -rev, rev)
    out_mask = torch.roll(neg, -opp, dims=-1).reshape(glwe.shape[:-2]
                                                      + (k * N,))
    return torch.cat([out_mask, body[..., None]], dim=-1)


def sample_extract_at(glwe: torch.Tensor, nth: torch.Tensor) -> torch.Tensor:
    """:func:`sample_extract` of each GLWE of a batch at its own
    coefficient: ``glwe`` int64[M, k+1, N], ``nth`` int[M] in [0, N) ->
    int64[M, k*N + 1]. Mask coefficient i is a[nth - i] for i <= nth and
    -a[N + nth - i] above."""
    M, R, N = glwe.shape
    nth = nth.to(torch.int64).to(glwe.device)
    src = nth[:, None] - torch.arange(N, device=glwe.device)[None]
    neg = src < 0
    src = torch.where(neg, src + N, src)
    mask = torch.gather(glwe[:, :R - 1], 2,
                        src[:, None].expand(M, R - 1, N))
    mask = torch.where(neg[:, None], -mask, mask).reshape(M, (R - 1) * N)
    body = glwe[torch.arange(M, device=glwe.device), R - 1, nth]
    return torch.cat([mask, body[:, None]], dim=-1)


# ---------------------------------------------------------------------------
# external product / cmux / blind rotation: the exact CRT spec
# ---------------------------------------------------------------------------

def external_product_ntt(ggsw_hat: torch.Tensor, glwe: torch.Tensor,
                         base_log: int, levels: int,
                         plan: ntt_mod.NegacyclicNtt) -> torch.Tensor:
    """GGSW (transform domain) x GLWE -> GLWE, exact mod 2^64.

    ``ggsw_hat``: int32 (u32) [2, P, l, R, R, N], the NTT residues and
    their Shoup duals; ``glwe``: int64[..., R, N]. Returns the external
    product int64[..., R, N] (the caller adds it to the accumulator). Every
    MAC term is a Shoup multiply against the key's duals, reduced before the
    sum (eight products of 30-bit residues would overflow int64)."""
    P = plan.num_primes
    batch = glwe.shape[:-2]
    digits = decompose(glwe, base_log, levels).movedim(-1, -3)  # [.., l, R, N]
    dhat = plan.fwd_digits(digits)  # [P, ..., l, R, N]
    kshape = (P,) + (1,) * len(batch) + tuple(ggsw_hat.shape[2:])
    g = u32_to_i64(ggsw_hat[0]).reshape(kshape)  # [P, 1.., l, R, C, N]
    gs = u32_to_i64(ggsw_hat[1]).reshape(kshape)
    p = plan.tables(glwe.device)["p"].reshape((P,) + (1,) * (len(kshape) - 1))
    prod = ntt_mod.shoup_mul(dhat[..., None, :], g, gs, p)
    acc_hat = torch.remainder(prod.sum(dim=(-4, -3)), p[..., 0, 0])
    return plan.reconstruct_u64(plan.inv(acc_hat))


def cmux_ntt(ggsw_hat: torch.Tensor, ct0: torch.Tensor, ct1: torch.Tensor,
             base_log: int, levels: int,
             plan: ntt_mod.NegacyclicNtt) -> torch.Tensor:
    """ct0 + GGSW x (ct1 - ct0): ct1 when the GGSW encrypts 1, ct0 when it
    encrypts 0 (``fft_impl/fft64/crypto/ggsw.rs:510`` cmux; ``tfhe_tpu``'s
    ``server.cmux_ntt``). ``ggsw_hat``: int32 (u32) [2, P, l, R, R, N] as
    :func:`external_product_ntt` takes it."""
    return ct0 + external_product_ntt(ggsw_hat, ct1 - ct0, base_log, levels,
                                      plan)


def round32(x: torch.Tensor) -> torch.Tensor:
    """Torus values rounded to the nearest multiple of 2^32 (ties up), mod
    2^64: the acc32 rounding of ``tfhe_tpu``'s ``blind_rotate`` (``r32``)."""
    return srl(x + (1 << 31), 32) << 32


def cmux_steps_crt(acc: torch.Tensor, msed_mask: torch.Tensor,
                   bsk_hat: torch.Tensor, base_log: int, levels: int,
                   plan: ntt_mod.NegacyclicNtt,
                   acc_round32: bool = False) -> torch.Tensor:
    """The n CMUX steps of :func:`blind_rotate` on an accumulator whose body
    rotation is applied: acc <- acc + GGSW_i x (acc * X^{a_i} - acc), the
    cmux of ``fft_impl/fft64/crypto/ggsw.rs:510``; with ``acc_round32``
    each increment is rounded by :func:`round32`.
    ``acc``: int64[..., R, N]; ``msed_mask``: [..., n];
    ``bsk_hat``: int32[2, P, n, l, R, R, N]."""
    mask = msed_mask.to(torch.int64)
    for i in range(bsk_hat.shape[2]):
        rotated = monomial_mul(acc, mask[..., i, None])
        inc = external_product_ntt(bsk_hat[:, :, i], rotated - acc, base_log,
                                   levels, plan)
        acc = acc + (round32(inc) if acc_round32 else inc)
    return acc


def blind_rotate(lut: torch.Tensor, msed_mask: torch.Tensor,
                 msed_body: torch.Tensor, bsk_hat: torch.Tensor,
                 base_log: int, levels: int, plan: ntt_mod.NegacyclicNtt,
                 acc_round32: bool = False) -> torch.Tensor:
    """Blind rotation of ``lut`` by the mod-switched LWE, exact mod 2^64
    (the two-plane accumulator of the JAX package's Pallas kernel); with
    ``acc_round32`` the body-rotated accumulator and every CMUX increment
    are rounded to multiples of 2^32 (the acc32 mode, ``tfhe_tpu``'s
    ``server.py:492-505``).

    ``lut``: int64[..., R, N]; ``msed_mask``: [..., n] in [0, 2N);
    ``msed_body``: [...]; ``bsk_hat``: int32[2, P, n, l, R, R, N]."""
    acc = monomial_div(lut, msed_body.to(torch.int64)[..., None])
    if acc_round32:
        acc = round32(acc)
    return cmux_steps_crt(acc, msed_mask, bsk_hat, base_log, levels, plan,
                          acc_round32)


# ---------------------------------------------------------------------------
# programmable bootstrap
# ---------------------------------------------------------------------------

def acc_mode(default: str = "32") -> str:
    """The accumulator mode of the v4/v6 kernels (``TFHE_V4_ACC``). The JAX
    package defaults it to 32 on the BNF path and to 64 (two planes) on the
    exact CRT path; any value other than 32 is the two-plane mode."""
    return os.environ.get("TFHE_V4_ACC", default)


def crt_acc32_requested(poly_size: int, base_log: int, levels: int) -> bool:
    """Whether ``tfhe_tpu``'s ``blind_rotate_pallas`` would run the exact
    CRT path in acc32 mode here: the v4 kernel (``TFHE_NTT_VARIANT`` unset
    or v4, a v4 shape) with ``TFHE_V4_ACC=32``."""
    return (os.environ.get("TFHE_NTT_VARIANT", "v4") == "v4"
            and acc_mode(default="64") == "32"
            and poly_size >= 256 and poly_size % 128 == 0
            and base_log * levels <= 31)


def _switch_and_flatten(ct_in: torch.Tensor, lut: torch.Tensor, N: int,
                        centered_ms: bool, torus_bits: int = 64):
    """Modulus switch to 2N from the ``torus_bits`` torus, flattened to one
    batch dim: (batch shape, mask [B, n], body [B], lut [R, N] shared or
    [B, R, N])."""
    log_modulus = N.bit_length()
    if centered_ms:
        ms_mask, ms_body = lwe_centered_binary_modulus_switch(
            ct_in, log_modulus, torus_bits)
    else:
        ms_mask, ms_body = lwe_standard_modulus_switch(ct_in, log_modulus,
                                                       torus_bits)
    batch = ct_in.shape[:-1]
    n_small = ct_in.shape[-1] - 1
    if lut.ndim > 2:
        lut = lut.expand(batch + lut.shape[-2:]).reshape(
            (-1,) + lut.shape[-2:]).contiguous()
    return batch, ms_mask.reshape(-1, n_small), ms_body.reshape(-1), lut


def programmable_bootstrap(ct_in: torch.Tensor, lut: torch.Tensor,
                           bsk_hat: torch.Tensor, base_log: int, levels: int,
                           plan: ntt_mod.NegacyclicNtt,
                           centered_ms: bool = True,
                           extract_nth: int = 0) -> torch.Tensor:
    """Classic PBS on the exact CRT spec (torch ops only): modulus switch
    -> :func:`blind_rotate` -> sample extraction. ``lut``: int64[..., R, N]
    or [R, N]; ``bsk_hat``: int32[2, P, n, l, R, R, N]. Returns
    int64[..., k*N + 1] (shortint/server_key/mod.rs:1440-1560)."""
    batch, ms_mask, ms_body, lut = _switch_and_flatten(ct_in, lut, plan.n,
                                                       centered_ms)
    rotated = blind_rotate(lut, ms_mask, ms_body, bsk_hat, base_log, levels,
                           plan)
    out = sample_extract(rotated, extract_nth)
    return out.reshape(batch + (out.shape[-1],))


def crt_rotation(lut: torch.Tensor, ms_mask: torch.Tensor,
                 ms_body: torch.Tensor, bsk_scan: torch.Tensor,
                 base_log: int, levels: int) -> torch.Tensor:
    """Blind rotation on the exact CRT key, the rotated GLWE int64[B, R, N]:
    K2 body rotation (u64) -> K3 (P-prime Garner tail, two-plane
    accumulator); when :func:`crt_acc32_requested` (``TFHE_V4_ACC=32``)
    the accumulator is the u32 hi plane as on the TPU: K2 acc32 ->
    K3-acc32, every increment rounded to a multiple of 2^32 (``tfhe_tpu``'s
    ``pbs_kernel.blind_rotate_pallas``).

    ``lut``: int64[R, N] (shared) or [B, R, N]; ``ms_mask``: [B, n] and
    ``ms_body``: [B] in [0, 2N); ``bsk_scan``: int32[n, 2, P, l*R, R, N].
    CUDA tensors run the kernels, CPU tensors their plain versions."""
    if crt_acc32_requested(bsk_scan.shape[-1], base_log, levels):
        hi = pk.body_rotate_acc32(lut, ms_body)
        hi = pk.blind_rotate_crt_acc32(hi, ms_mask, bsk_scan, base_log,
                                       levels)
        return hi.to(torch.int64) << 32
    acc = pk.body_rotate_u64(lut, ms_body)
    return pk.blind_rotate_crt(acc, ms_mask, bsk_scan, base_log, levels)


def goldilocks_rotation(lut: torch.Tensor, ms_mask: torch.Tensor,
                        ms_body: torch.Tensor, bsk_g: torch.Tensor,
                        base_log: int, levels: int,
                        bsk_k: torch.Tensor) -> torch.Tensor:
    """Blind rotation on the v5 Goldilocks key, the rotated GLWE
    int64[B, R, N]: K2 body rotation (u64, the ``monomial_div`` of
    ``pbs_kernel_g.py:726``) -> K4. ``bsk_g``: int32 (u32)
    [n, 2, l*R, R, G, 128]; ``bsk_k``: the same key in K4's order
    (``pbs_kernel.goldilocks_kernel_key``)."""
    acc = pk.body_rotate_u64(lut, ms_body)
    return pk.blind_rotate_goldilocks(acc, ms_mask, bsk_g, base_log, levels,
                                      bsk_k)


def programmable_bootstrap_crt(
    ct_in: torch.Tensor,
    lut: torch.Tensor,
    bsk_scan: torch.Tensor,
    base_log: int,
    levels: int,
    centered_ms: bool = True,
    extract_nth: int = 0,
    input_torus_bits: int = 64,
) -> torch.Tensor:
    """Classic PBS on the exact CRT path, the counterpart of ``tfhe_tpu``'s
    ``programmable_bootstrap_pallas`` (``ops/server.py:540``): modulus
    switch -> :func:`crt_rotation` -> sample extraction.

    ``bsk_scan``: int32[n, 2, P, l*R, R, N] (``pbs_kernel.
    bsk_to_scan_layout`` of the NTT key). CUDA tensors run the kernels, CPU
    tensors their plain versions. Returns int64[..., k*N + 1]."""
    batch, ms_mask, ms_body, lut = _switch_and_flatten(
        ct_in, lut, bsk_scan.shape[-1], centered_ms, input_torus_bits)
    acc = crt_rotation(lut, ms_mask, ms_body, bsk_scan, base_log, levels)
    out = sample_extract(acc, extract_nth)
    return out.reshape(batch + (out.shape[-1],))


def programmable_bootstrap_bnf2(
    ct_in: torch.Tensor,
    lut: torch.Tensor,
    bsk_scan2: torch.Tensor,
    base_log: int,
    levels: int,
    centered_ms: bool = True,
    extract_nth: int = 0,
    flavor=None,
    input_torus_bits: int = 64,
) -> torch.Tensor:
    """Classic PBS on the 2-prime BNF path: modulus switch -> body rotation
    -> blind rotation -> sample extraction. Under ``TFHE_V4_ACC=32`` (the
    default) the kernels are K2 acc32 and K1; otherwise the accumulator is
    the exact u64 of two planes: K2 u64 and K3 with the ``bnf2_c`` tail.
    ``TFHE_V6_STACKED=1`` selects ``tfhe_tpu``'s sublane-stacked step
    (``one_step_stacked``), a TPU layout of the same function, so the port
    runs K1 under it as well.

    ``ct_in``: int64[..., n+1] under the small key (u32 values with
    ``input_torus_bits`` = 32, the KS32 pattern); ``lut``: int64[R, N]
    (shared) or [..., R, N]; ``bsk_scan2``: int32[n, 2, 2, l*R, R, N] from
    ``bnf2.bootstrap_key_to_bnf2``. CUDA tensors run the kernels, CPU
    tensors their plain versions. Returns int64[..., k*N + 1]."""
    fl = flavor or bnf2_mod.DEFAULT
    batch, ms_mask, ms_body, lut = _switch_and_flatten(
        ct_in, lut, bsk_scan2.shape[5], centered_ms, input_torus_bits)
    if acc_mode() == "32":
        hi = pk.body_rotate_acc32(lut, ms_body)
        hi = pk.blind_rotate_bnf2_acc32(hi, ms_mask, bsk_scan2, base_log,
                                        levels, fl)
        rotated = hi.to(torch.int64) << 32
    else:
        acc = pk.body_rotate_u64(lut, ms_body)
        rotated = pk.blind_rotate_bnf2_u64(acc, ms_mask, bsk_scan2, base_log,
                                           levels, fl)
    out = sample_extract(rotated, extract_nth)
    return out.reshape(batch + (out.shape[-1],))


def programmable_bootstrap_goldilocks(
    ct_in: torch.Tensor,
    lut: torch.Tensor,
    bsk_g: torch.Tensor,
    base_log: int,
    levels: int,
    centered_ms: bool = True,
    extract_nth: int = 0,
    *,
    bsk_k: torch.Tensor,
    input_torus_bits: int = 64,
) -> torch.Tensor:
    """Classic PBS on the single-prime Goldilocks (BNF) path, the v5
    variant: the counterpart of ``tfhe_tpu``'s
    ``ops/server.py::programmable_bootstrap_goldilocks`` (``:596-653``,
    without its TPU batch padding): modulus switch ->
    :func:`goldilocks_rotation` -> sample extraction.

    ``bsk_g``: int32 (u32) [n, 2, l*R, R, G, 128] from
    ``goldilocks.bootstrap_key_to_goldilocks``; ``bsk_k``: the same key in
    K4's order, prepared once. CUDA tensors run the kernels, CPU tensors
    their plain versions. Returns int64[..., k*N + 1]."""
    batch, ms_mask, ms_body, lut = _switch_and_flatten(
        ct_in, lut, bsk_g.shape[4] * 128, centered_ms, input_torus_bits)
    acc = goldilocks_rotation(lut, ms_mask, ms_body, bsk_g, base_log, levels,
                              bsk_k)
    out = sample_extract(acc, extract_nth)
    return out.reshape(batch + (out.shape[-1],))


# ---------------------------------------------------------------------------
# multi-bit PBS -- reference lwe_multi_bit_programmable_bootstrapping.rs
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _trivial_ggsw_one_hat(n: int, num_primes: int, base_log: int,
                          levels: int, R: int) -> np.ndarray:
    """Transform-domain trivial GGSW of the cleartext 1: the diagonal
    gadget entries q/B^(levels-j) in coefficient 0 (GGSW = m*G with no
    encryption), twisted and forward-transformed with object ints, as
    ``tfhe_tpu``'s ``_trivial_ggsw_one_hat``. numpy u64[P, l, R, R, N]."""
    plan = ntt_mod.get_plan(n, num_primes)
    data = np.zeros((levels, R, R, n), dtype=np.uint64)
    for j in range(levels):
        shift = 64 - base_log * (levels - j)
        for r in range(R):
            data[j, r, r, 0] = np.uint64(1) << np.uint64(shift)
    out = np.zeros((plan.num_primes,) + data.shape, dtype=np.uint64)
    for pi, p in enumerate(plan.primes):
        r = (data % np.uint64(p)).astype(object)
        r = (r * plan.twist[pi].astype(object)) % p  # twist
        x = r.astype(np.uint64)
        nloc = n
        for s in range(plan.log_n):
            m = nloc >> s
            h = m >> 1
            xr = x.reshape(data.shape[:-1] + (nloc // m, 2, h))
            a = xr[..., 0, :].astype(object)
            b = xr[..., 1, :].astype(object)
            u = (a + b) % p
            v = ((a - b) * plan.tw_fwd[s][pi].astype(object)) % p
            x = np.stack([u, v], axis=-2).reshape(data.shape).astype(
                np.uint64)
        out[pi] = x
    return out


def multi_bit_keybundle_plain(msed_mask: torch.Tensor,
                              mbk_hat: torch.Tensor, t0: int, count: int,
                              base_log: int, levels: int, grouping: int,
                              plan: ntt_mod.NegacyclicNtt) -> torch.Tensor:
    """The key bundles of group steps t0 .. t0+count-1 (the spec of K5a):
    for each ciphertext, step t's combined GGSW

        G1 + sum_{v=1}^{2^g-1} prod_{j in v} NTT(X^{a_{tg+j}} - 1)
             (.) GGSW_{t,v}  (mod each prime)

    (G1 the trivial GGSW of 1, :func:`_trivial_ggsw_one_hat`), which
    depends on the key and the step's g mask values, not on the
    accumulator. ``msed_mask``: [B, n] in [0, 2N) (n/g groups of g);
    ``mbk_hat``: residues [P, n/g, 2^g-1, l, R, R, N] in any integer dtype
    (u32 values, no Shoup duals). Returns int64 [B, count, P, l*R, R, N],
    the layout K5a writes and K5b reads."""
    B = msed_mask.shape[0]
    R, N = mbk_hat.shape[-2:]
    P = plan.num_primes
    dev = msed_mask.device
    mask = msed_mask.to(torch.int64)
    triv = torch.from_numpy(_trivial_ggsw_one_hat(
        N, P, base_log, levels, R).view(np.int64)).to(dev)[:, None]
    p = plan.tables(dev)["p"]
    p_full = p.reshape(P, 1, 1, 1, 1, 1)  # [P, B, l, R, C, N]
    p_b = p.reshape(P, 1, 1)  # [P, B, N]
    delta = torch.zeros((B, N), dtype=torch.int64, device=dev)
    delta[:, 0] = 1
    out = []
    for t in range(t0, t0 + count):
        nh = [plan.fwd_digits(monomial_mul(delta, mask[:, t * grouping + j])
                              - delta)
              for j in range(grouping)]  # [P, B, N] each
        combined = triv.expand(P, B, levels, R, R, N)
        for v in range(1, 1 << grouping):
            coef = None
            for j in range(grouping):
                if (v >> j) & 1:
                    coef = nh[j] if coef is None else (coef * nh[j]) % p_b
            gv = (mbk_hat[:, t, v - 1].to(torch.int64) & M32).reshape(
                P, 1, levels, R, R, N)
            combined = combined + (coef[..., None, None, None, :] * gv) \
                % p_full
        combined = combined % p_full
        out.append(combined.movedim(0, 1).reshape(B, P, levels * R, R, N))
    return torch.stack(out, dim=1)


def multi_bit_accumulate_plain(acc: torch.Tensor, bundles: torch.Tensor,
                               base_log: int, levels: int,
                               plan: ntt_mod.NegacyclicNtt) -> torch.Tensor:
    """The dependent external products of a chunk of group steps (the spec
    of K5b): per step, the new accumulator replaces the old one,
    Garner(INTT(sum_r NTT(decompose(acc))_r (.) bundle_r)). ``acc``:
    int64[B, R, N]; ``bundles``: [B, count, P, l*R, R, N] (u32 residues in
    any integer dtype, :func:`multi_bit_keybundle_plain`'s layout)."""
    B, count, P = bundles.shape[:3]
    R, N = acc.shape[-2:]
    p = plan.tables(acc.device)["p"]
    p_full = p.reshape(P, 1, 1, 1, 1, 1)  # [P, B, l, R, C, N]
    for tt in range(count):
        combined = (bundles[:, tt].to(torch.int64) & M32).reshape(
            B, P, levels, R, R, N).movedim(1, 0)
        digits = decompose(acc, base_log, levels).movedim(-1, -3)
        dhat = plan.fwd_digits(digits)  # [P, B, l, R, N]
        prod = (dhat[..., None, :] * combined) % p_full
        acc_hat = prod.sum(dim=(-4, -3)) % p_full[..., 0, 0]
        acc = plan.reconstruct_u64(plan.inv(acc_hat))
    return acc


def multi_bit_group_steps(acc: torch.Tensor, msed_mask: torch.Tensor,
                          mbk_hat: torch.Tensor, base_log: int, levels: int,
                          grouping: int,
                          plan: ntt_mod.NegacyclicNtt) -> torch.Tensor:
    """The n/g group steps of :func:`multi_bit_blind_rotate` on an
    accumulator whose body rotation is applied (the spec of the K5 pair and
    of the single-kernel reference r14): chunks of
    ``pbs_kernel.multi_bit_chunk`` steps, as the kernels run, each the key
    bundles of :func:`multi_bit_keybundle_plain` then the external
    products of :func:`multi_bit_accumulate_plain`. Every value between
    the decomposition and the Garner tail is exact mod each prime, so the
    chunking does not change the result.

    ``acc``: int64[..., R, N]; ``msed_mask``: [..., n] in [0, 2N) (n/g
    groups of g); ``mbk_hat``: residues [P, n/g, 2^g-1, l, R, R, N] in any
    integer dtype (u32 values, no Shoup duals)."""
    ngroups = mbk_hat.shape[1]
    R, N = acc.shape[-2:]
    batch = acc.shape[:-2]
    acc = acc.reshape(-1, R, N)
    mask = msed_mask.reshape(-1, msed_mask.shape[-1])
    chunk = pk.multi_bit_chunk(acc.shape[0], ngroups, plan.num_primes,
                               levels * R, R, N)
    for t0 in range(0, ngroups, chunk):
        count = min(chunk, ngroups - t0)
        bundles = multi_bit_keybundle_plain(mask, mbk_hat, t0, count,
                                            base_log, levels, grouping, plan)
        acc = multi_bit_accumulate_plain(acc, bundles, base_log, levels, plan)
    return acc.reshape(batch + (R, N))


def _multi_bit_kernel_key(mbk_hat: torch.Tensor, grouping: int,
                          plan: ntt_mod.NegacyclicNtt) -> torch.Tensor:
    """``tfhe_tpu``'s multi-bit key argument, residues [P, n/g, 2^g-1, l,
    R, R, N] without duals, as K5 reads it (duals added, its layout)."""
    if mbk_hat.shape[2] != (1 << grouping) - 1:
        raise ValueError(f"mbk_hat {tuple(mbk_hat.shape)} does not hold the "
                         f"2^{grouping} - 1 subsets of grouping {grouping}")
    return pk.multi_bit_key_layout(ntt_mod.with_shoup_duals(mbk_hat, plan))


def multi_bit_blind_rotate(lut: torch.Tensor, msed_mask: torch.Tensor,
                           msed_body: torch.Tensor, mbk_hat: torch.Tensor,
                           base_log: int, levels: int, grouping: int,
                           plan: ntt_mod.NegacyclicNtt) -> torch.Tensor:
    """Multi-bit blind rotation with ``tfhe_tpu``'s signature
    (``multi_bit_blind_rotate``, ``std_prepare_multi_bit_ggsw``): the
    accumulator starts as ``monomial_div(lut, body)``, then the group
    steps of :func:`multi_bit_group_steps`; run as
    :func:`multi_bit_rotation` on the key laid out for K5. ``lut``:
    int64[..., R, N]; ``msed_mask``: [..., n]; ``msed_body``: [...];
    ``mbk_hat``: residues [P, n/g, 2^g-1, l, R, R, N]."""
    batch = msed_body.shape
    R, N = lut.shape[-2:]
    lut = lut.expand(batch + (R, N)).reshape(-1, R, N)
    out = multi_bit_rotation(
        lut, msed_mask.reshape(-1, msed_mask.shape[-1]),
        msed_body.reshape(-1), _multi_bit_kernel_key(mbk_hat, grouping, plan),
        base_log, levels)
    return out.reshape(batch + (R, N))


def multi_bit_programmable_bootstrap(ct_in: torch.Tensor, lut: torch.Tensor,
                                     mbk_hat: torch.Tensor, base_log: int,
                                     levels: int, grouping: int,
                                     plan: ntt_mod.NegacyclicNtt,
                                     extract_nth: int = 0) -> torch.Tensor:
    """Multi-bit PBS with ``tfhe_tpu``'s signature
    (``multi_bit_programmable_bootstrap``): the standard modulus switch
    (never the centered one), the rotation, sample extraction; run as
    :func:`programmable_bootstrap_multi_bit` on the key laid out for K5."""
    return programmable_bootstrap_multi_bit(
        ct_in, lut, _multi_bit_kernel_key(mbk_hat, grouping, plan), base_log,
        levels, extract_nth)


def multi_bit_rotation(lut: torch.Tensor, ms_mask: torch.Tensor,
                       ms_body: torch.Tensor, mbk: torch.Tensor,
                       base_log: int, levels: int) -> torch.Tensor:
    """Multi-bit blind rotation on its kernels, the rotated GLWE
    int64[B, R, N]: K2 body rotation (u64) -> the K5 pair
    (``pbs_kernel.blind_rotate_multi_bit``: K5a and K5b a chunk of steps).
    ``mbk``: the key in K5's layout int32 [n/g, 2, P, 2^g-1, l*R, R, N]
    (``pbs_kernel.multi_bit_key_layout``). CUDA tensors run the kernels,
    CPU tensors their plain versions."""
    acc = pk.body_rotate_u64(lut, ms_body)
    return pk.blind_rotate_multi_bit(acc, ms_mask, mbk, base_log, levels)


def programmable_bootstrap_multi_bit(
    ct_in: torch.Tensor,
    lut: torch.Tensor,
    mbk: torch.Tensor,
    base_log: int,
    levels: int,
    extract_nth: int = 0,
    input_torus_bits: int = 64,
) -> torch.Tensor:
    """Multi-bit PBS on the kernels: the standard modulus switch ->
    :func:`multi_bit_rotation` -> sample extraction. Returns
    int64[..., k*N + 1]."""
    batch, ms_mask, ms_body, lut = _switch_and_flatten(
        ct_in, lut, mbk.shape[-1], False, input_torus_bits)
    acc = multi_bit_rotation(lut, ms_mask, ms_body, mbk, base_log, levels)
    out = sample_extract(acc, extract_nth)
    return out.reshape(batch + (out.shape[-1],))
