"""Server-side operations of the KS -> PBS paths, in torch.

Torch counterpart of the main-path subset of ``tfhe_tpu/ops/server.py``:

- keyswitch: ``core_crypto/algorithms/lwe_keyswitch.rs:137-230``, computed
  as ONE int8 GEMM of the gadget digits against the KSK in signed base-256
  limbs (``torch._int_mm``; the JAX package leaves the same product to
  XLA's ``jnp.dot``);
- modulus switch to 2N with the centered-binary body correction
  (``algorithms/modulus_switch.rs:35-104``);
- sample extraction (``algorithms/glwe_sample_extraction.rs:89``);
- the exact CRT spec: external product, cmux, blind rotation and the
  portable PBS over P NTT primes with Garner reconstruction;
- the programmable bootstraps that run the kernels (``ops/pbs_kernel.py``):
  the exact CRT PBS (K2 u64, K3), the v6/v6b BNF PBS (K2, K1 in acc32
  mode; K2 u64, K3-bnf2 in two-plane mode) and the v5 Goldilocks PBS (K2
  u64, K4).

Tensors are int64 torus values (see ``_torus.py``), batched over leading
dims.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .._torus import srl, u32_to_i64
from . import bnf2 as bnf2_mod
from . import ntt as ntt_mod
from . import pbs_kernel as pk
from .decomp import decompose
from .polynomial import monomial_div, monomial_mul

# ---------------------------------------------------------------------------
# keyswitch (int8 GEMM)
# ---------------------------------------------------------------------------


def ksk_to_i8_limbs(ksk: np.ndarray, base_log: int) -> np.ndarray:
    """The KSK in signed base-256 limb form: every u64 entry rewritten as
    sum(limb_k * 256^k) mod 2^64 with limb_k in [-128, 127] (the 9th carry
    limb contributes 2^64 == 0 and is dropped).
    u64[n_in, l, n_out+1] -> int8[n_in * l, (n_out+1) * 8] (numpy, host)."""
    # base_log == 8 would admit a +128 balanced digit, which wraps in int8
    assert base_log <= 7, "balanced digits must fit int8 for the keyswitch"
    v = np.asarray(ksk, dtype=np.uint64).copy()
    limbs = np.empty(v.shape + (8,), dtype=np.int8)
    for k in range(8):
        r = (v & np.uint64(0xFF)).astype(np.int64)
        r = np.where(r > 127, r - 256, r)
        limbs[..., k] = r.astype(np.int8)
        v = (v - r.astype(np.uint64)) >> np.uint64(8)
    n_in, l, o = ksk.shape
    return limbs.reshape(n_in * l, o * 8)


def keyswitch_mxu(ct: torch.Tensor, ksk_i8: torch.Tensor, base_log: int,
                  levels: int) -> torch.Tensor:
    """LWE keyswitch as one int8 x int8 -> int32 GEMM.

    out = [0 | b] - sum_{i,l} digit_{i,l} * KSK[i, l], with the digits
    ``[B, n_in*l]`` multiplied against the limbs ``[n_in*l, (n_out+1)*8]``
    and the 8 limb sums recombined as sum_k s_k * 2^(8k) mod 2^64. Exact:
    |digit| <= 2^(base_log-1) <= 64 and |limb| <= 128, so a row sum stays
    below K * 2^13 < 2^31 for K up to 2^18.

    ``ct``: int64[..., n_in+1]; ``ksk_i8``: int8[n_in*l, (n_out+1)*8]."""
    K, O8 = ksk_i8.shape
    n_in = K // levels
    n_out = O8 // 8 - 1
    a = ct[..., :n_in]
    b = ct[..., n_in]
    batch = ct.shape[:-1]
    d8 = decompose(a, base_log, levels).to(torch.int8).reshape(-1, K)
    B = d8.shape[0]
    # torch._int_mm on CUDA wants m > 16 and m % 8 == 0
    pad = max(24, -(-B // 8) * 8) - B
    if pad:
        d8 = torch.cat([d8, d8.new_zeros((pad, K))])
    sums = torch._int_mm(d8, ksk_i8)[:B]
    sums = sums.reshape(batch + (n_out + 1, 8)).to(torch.int64)
    w = torch.tensor([1 << (8 * k) for k in range(8)], dtype=torch.int64,
                     device=ct.device)
    total = (sums * w).sum(dim=-1)
    out = -total
    out[..., n_out] += b
    return out


# ---------------------------------------------------------------------------
# modulus switch
# ---------------------------------------------------------------------------

def modulus_switch(x: torch.Tensor, log_modulus: int) -> torch.Tensor:
    """Round to the nearest multiple of 2^64 / 2^log_modulus; the switched
    value in [0, 2^log_modulus) (fft_impl/common.rs:10)."""
    half = 1 << (64 - log_modulus - 1)
    return srl(x + half, 64 - log_modulus)


def _trunc_div2(x: torch.Tensor) -> torch.Tensor:
    """Rust-style truncated (toward zero) division by two."""
    return torch.div(x, 2, rounding_mode="trunc")


def centered_binary_ms_body_correction(mask: torch.Tensor,
                                       log_modulus: int) -> torch.Tensor:
    """Correction added to the body before a centered-binary modulus switch
    (CenteredMeanNoiseReduction, algorithms/modulus_switch.rs:57).
    ``mask``: int64[..., n] -> int64[...]."""
    rounded = modulus_switch(mask, log_modulus) << (64 - log_modulus)
    err = rounded - mask  # signed rounding error (wrapping difference)
    half_err = _trunc_div2(err)
    halving_err_doubled = 2 * half_err - err  # in {-1, 0, 1}
    sum_half = half_err.sum(dim=-1)
    sum_halving = halving_err_doubled.sum(dim=-1)
    sum_half = sum_half - _trunc_div2(sum_halving)
    return sum_half - (1 << (64 - log_modulus - 1))


def lwe_centered_binary_modulus_switch(ct: torch.Tensor, log_modulus: int):
    """(switched_mask, switched_body) in [0, 2^log_modulus), with the
    centered-binary body correction applied before the switch."""
    n = ct.shape[-1] - 1
    mask = ct[..., :n]
    corr = centered_binary_ms_body_correction(mask, log_modulus)
    return (modulus_switch(mask, log_modulus),
            modulus_switch(ct[..., n] + corr, log_modulus))


def lwe_standard_modulus_switch(ct: torch.Tensor, log_modulus: int):
    n = ct.shape[-1] - 1
    return (modulus_switch(ct[..., :n], log_modulus),
            modulus_switch(ct[..., n], log_modulus))


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
    """ct0 + GGSW x (ct1 - ct0): selects ct1 when the GGSW encrypts 1
    (fft_impl/fft64/crypto/ggsw.rs:510 cmux)."""
    return ct0 + external_product_ntt(ggsw_hat, ct1 - ct0, base_log, levels,
                                      plan)


def cmux_steps_crt(acc: torch.Tensor, msed_mask: torch.Tensor,
                   bsk_hat: torch.Tensor, base_log: int, levels: int,
                   plan: ntt_mod.NegacyclicNtt) -> torch.Tensor:
    """The n CMUX steps of :func:`blind_rotate` on an accumulator whose body
    rotation is applied: acc <- cmux(bsk_i, acc, acc * X^{a_i}).
    ``acc``: int64[..., R, N]; ``msed_mask``: [..., n];
    ``bsk_hat``: int32[2, P, n, l, R, R, N]."""
    mask = msed_mask.to(torch.int64)
    for i in range(bsk_hat.shape[2]):
        rotated = monomial_mul(acc, mask[..., i, None])
        acc = cmux_ntt(bsk_hat[:, :, i], acc, rotated, base_log, levels, plan)
    return acc


def blind_rotate(lut: torch.Tensor, msed_mask: torch.Tensor,
                 msed_body: torch.Tensor, bsk_hat: torch.Tensor,
                 base_log: int, levels: int, plan: ntt_mod.NegacyclicNtt,
                 acc_round32: bool = False) -> torch.Tensor:
    """Blind rotation of ``lut`` by the mod-switched LWE, exact mod 2^64
    (the two-plane accumulator of the JAX package's Pallas kernel).

    ``lut``: int64[..., R, N]; ``msed_mask``: [..., n] in [0, 2N);
    ``msed_body``: [...]; ``bsk_hat``: int32[2, P, n, l, R, R, N]."""
    if acc_round32:
        raise NotImplementedError(
            "the exact CRT path's acc32 mode is not ported yet (ROADMAP "
            "Queue B, B3-acc32)")
    acc = monomial_div(lut, msed_body.to(torch.int64)[..., None])
    return cmux_steps_crt(acc, msed_mask, bsk_hat, base_log, levels, plan)


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
                        centered_ms: bool):
    """Modulus switch to 2N, flattened to one batch dim: (batch shape,
    mask [B, n], body [B], lut [R, N] shared or [B, R, N])."""
    log_modulus = N.bit_length()
    if centered_ms:
        ms_mask, ms_body = lwe_centered_binary_modulus_switch(ct_in,
                                                              log_modulus)
    else:
        ms_mask, ms_body = lwe_standard_modulus_switch(ct_in, log_modulus)
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


def programmable_bootstrap_crt(
    ct_in: torch.Tensor,
    lut: torch.Tensor,
    bsk_scan: torch.Tensor,
    base_log: int,
    levels: int,
    centered_ms: bool = True,
    extract_nth: int = 0,
) -> torch.Tensor:
    """Classic PBS on the exact CRT path, the counterpart of ``tfhe_tpu``'s
    ``programmable_bootstrap_pallas`` (``ops/server.py:540``): modulus
    switch -> K2 body rotation (u64) -> K3 blind rotation (P-prime Garner
    tail, two-plane accumulator) -> sample extraction.

    ``bsk_scan``: int32[n, 2, P, l*R, R, N] (``pbs_kernel.
    bsk_to_scan_layout`` of the NTT key). CUDA tensors run the kernels, CPU
    tensors their plain versions. Returns int64[..., k*N + 1]."""
    N = bsk_scan.shape[-1]
    if crt_acc32_requested(N, base_log, levels):
        raise NotImplementedError(
            "TFHE_V4_ACC=32 on the exact CRT path (increments rounded to "
            "2^32) is not ported yet: ROADMAP Queue B, B3-acc32")
    batch, ms_mask, ms_body, lut = _switch_and_flatten(ct_in, lut, N,
                                                       centered_ms)
    acc = pk.body_rotate_u64(lut, ms_body)
    acc = pk.blind_rotate_crt(acc, ms_mask, bsk_scan, base_log, levels)
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
) -> torch.Tensor:
    """Classic PBS on the 2-prime BNF path: modulus switch -> body rotation
    -> blind rotation -> sample extraction. Under ``TFHE_V4_ACC=32`` (the
    default) the kernels are K2 acc32 and K1; otherwise the accumulator is
    the exact u64 of two planes: K2 u64 and K3 with the ``bnf2_c`` tail.

    ``ct_in``: int64[..., n+1] under the small key; ``lut``: int64[R, N]
    (shared) or [..., R, N]; ``bsk_scan2``: int32[n, 2, 2, l*R, R, N] from
    ``bnf2.bootstrap_key_to_bnf2``. CUDA tensors run the kernels, CPU
    tensors their plain versions. Returns int64[..., k*N + 1]."""
    fl = flavor or bnf2_mod.DEFAULT
    batch, ms_mask, ms_body, lut = _switch_and_flatten(
        ct_in, lut, bsk_scan2.shape[5], centered_ms)
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
) -> torch.Tensor:
    """Classic PBS on the single-prime Goldilocks (BNF) path, the v5
    variant: the counterpart of ``tfhe_tpu``'s
    ``ops/server.py::programmable_bootstrap_goldilocks`` (``:596-653``,
    without its TPU batch padding): modulus switch -> K2 body rotation
    (u64, the ``monomial_div`` of ``pbs_kernel_g.py:726``) -> K4 blind
    rotation -> sample extraction.

    ``bsk_g``: int32 (u32) [n, 2, l*R, R, G, 128] from
    ``goldilocks.bootstrap_key_to_goldilocks``; ``bsk_k``: the same key in
    K4's order (``pbs_kernel.goldilocks_kernel_key``), prepared once. CUDA
    tensors run the kernels, CPU tensors their plain versions. Returns
    int64[..., k*N + 1]."""
    batch, ms_mask, ms_body, lut = _switch_and_flatten(
        ct_in, lut, bsk_g.shape[4] * 128, centered_ms)
    acc = pk.body_rotate_u64(lut, ms_body)
    acc = pk.blind_rotate_goldilocks(acc, ms_mask, bsk_g, base_log, levels,
                                     bsk_k)
    out = sample_extract(acc, extract_nth)
    return out.reshape(batch + (out.shape[-1],))
