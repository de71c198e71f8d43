"""NTT64 prime-modulus PBS: the ciphertext modulus IS the NTT prime, in torch.

Torch counterpart of ``tfhe_tpu/ops/ntt64_pbs.py`` (reference:
``core_crypto/algorithms/lwe_programmable_bootstrapping/ntt64_pbs.rs``):
every ciphertext lives mod q = 2^64 - 2^32 + 1 (the Goldilocks prime), so
the external products of the blind rotation are exact negacyclic
convolutions mod (X^N + 1, q), and everything around them is non-native
arithmetic:

- the gadget decomposition is ``SignedDecomposerNonNative``
  (``decomposer.rs:310-548``): a sign split around ceil(q/2), a rounded
  shift of the absolute value, balanced digits, the sign applied last;
- the recomposition scale of level i is 2^(64 - b*i) as an integer mod q;
- the PBS modulus switch divides by q: round(v * 2N / q)
  (``ntt64_pbs.rs:540``), computed exactly here on the tensor's device
  from the 128-bit product in int64 pieces;
- monomial products and the sample extraction negate mod q (q - v, and
  0 stays 0).

Values ride in the int64 carrier of ``_torus.py`` (u64 bits; ``ult`` for
unsigned compares, ``srl`` for logical shifts) and every helper keeps them
canonical (< q). The field arithmetic and the transform are the port's
``ops/goldilocks.py`` (classic DIF order: the key's transform domain is the
one the hand-written kernel K6, ``csrc/blind_rotate_ntt64.cu``, reads with
no permutation). The n CMUX steps run through
``pbs_kernel.blind_rotate_ntt64``: K6 on a CUDA tensor, :func:`cmux_steps_q`
(the plain version) on a CPU tensor.

Key generation draws from the caller's ``np.random.Generator`` in
``tfhe_tpu``'s order, with its shapes and dtypes (first the mask, then the
noise), so a key made from one seed equals ``tfhe_tpu``'s bit for bit; the
mask convolution runs through the Goldilocks transform on the key's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .._torus import M32, from_u64, srl, u64_const, ult
from . import goldilocks as gl

#: the ciphertext modulus == the NTT prime (Goldilocks)
Q: int = gl.P
#: ceil(log2(q)): q is 64 bits, so the "containing" scale is 2^64
Q_BITS: int = 64
#: ceil(q / 2): the positive/negative split point of the signed view
Q_HALF_CEIL: int = (Q + 1) // 2

_Q64 = u64_const(Q)


def _u64_tensor(x, device=None) -> torch.Tensor:
    """An int64 tensor (u64 bits) from a tensor or anything numpy reads as
    u64, on ``device`` (a tensor's own device when None)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) if device is None else x.to(device,
                                                              torch.int64)
    return from_u64(np.asarray(x, dtype=np.uint64),
                    "cpu" if device is None else device)


def gneg(a: torch.Tensor) -> torch.Tensor:
    """-a mod q for canonical a: q - a, and 0 stays 0."""
    return torch.where(a == 0, a, _Q64 - a)


# ---------------------------------------------------------------------------
# SignedDecomposerNonNative (vectorized)
# ---------------------------------------------------------------------------

def init_state_nonnative(v, base_log: int, levels: int, q: int = Q):
    """(state, sign) of the non-native decomposer for canonical ``v`` < q
    (``decomposer.rs:520`` ``init_decomposer_state``): the sign split
    around ceil(q/2), then one rounded shift of the absolute value at bit
    ceil_log2(q) - b*l. Returns (int64 state < 2^(b*l), bool negative)."""
    assert q & (q - 1) != 0, "use the native decomposer for 2^k moduli"
    q_bits = q.bit_length()  # == ceil_ilog2(q) for non-power-of-two q
    non_rep = q_bits - base_log * levels
    assert non_rep > 0, "b*l must be < ceil_ilog2(q)"
    v = _u64_tensor(v)
    q64 = u64_const(q)
    neg = ~ult(v, u64_const((q + 1) // 2))
    abs_v = torch.where(neg, q64 - v, v)  # < 2^63: signed shifts are exact
    res = abs_v >> (non_rep - 1)
    return (res + 1) >> 1, neg


def closest_representable_nonnative(v, base_log: int, levels: int,
                                    q: int = Q) -> torch.Tensor:
    """``decomposer.rs`` ``closest_representable``: the rounded absolute
    value re-scaled and sign-reapplied mod q (canonical, int64 carrier)."""
    state, neg = init_state_nonnative(v, base_log, levels, q)
    abs_closest = state << (q.bit_length() - base_log * levels)
    return torch.where(neg & (abs_closest != 0), u64_const(q) - abs_closest,
                       abs_closest)


def decompose_nonnative(v, base_log: int, levels: int,
                        q: int = Q) -> torch.Tensor:
    """Balanced signed digits of ``v`` (canonical mod q), int64, shaped
    ``v.shape + (levels,)`` with index 0 the smallest scale 2^(64-b*l)
    (the iterator's first yield, the GGSW level order), the sign applied
    last (``iter.rs:299-435``)."""
    state, neg = init_state_nonnative(v, base_log, levels, q)
    mask = (1 << base_log) - 1
    digits = []
    for _ in range(levels):
        res = state & mask
        state = state >> base_log  # arithmetic shift
        carry = (((res - 1) | state) & res) >> (base_log - 1)
        state = state + carry
        digits.append(res - (carry << base_log))
    d = torch.stack(digits, dim=-1)
    return torch.where(neg[..., None], -d, d)


def recomposition_summand_q(value_signed: np.ndarray, level: int,
                            base_log: int) -> np.ndarray:
    """``term.rs`` ``to_approximate_recomposition_summand`` mod q: the
    signed term times 2^(64 - b*level), canonical in [0, q) (host, u64)."""
    v = np.asarray(value_signed, dtype=object)
    shift = Q_BITS - base_log * level
    out = (v * (1 << shift)) % Q
    return np.array(out.tolist(), dtype=np.uint64)


def modulus_switch_nonnative(v, poly_size: int) -> torch.Tensor:
    """round(v * 2N / q) for canonical ``v`` (``ntt64_pbs.rs:540``, the
    u128 ``divide_round``: (v * 2N + (q - 1) / 2) // q), exact on the
    tensor's device. With 2N = 2^s, x = v * 2^s + (q - 1) / 2 = hi * 2^64 +
    lo, and 2^64 = q + 2^32 - 1, so x = hi * q + r with r = lo + hi *
    (2^32 - 1) < 2q: the quotient is hi, plus one when r >= q. Values in
    [0, 2N]; q - 1 maps to 2N, which every monomial product treats as 0.
    """
    s = (2 * poly_size).bit_length() - 1
    assert 1 << s == 2 * poly_size, "N must be a power of two"
    v = _u64_tensor(v)
    hi = srl(v, 64 - s)
    lo = v << s
    lo2 = lo + (Q >> 1)
    hi = hi + ult(lo2, lo).to(torch.int64)
    r = lo2 + hi * M32
    wrapped = ult(r, lo2)  # r >= 2^64 > q
    return hi + (wrapped | ~ult(r, _Q64)).to(torch.int64)


# ---------------------------------------------------------------------------
# mod-q LWE / GLWE primitives
# ---------------------------------------------------------------------------

def _rounded_gaussian_q(std_abs: float, shape,
                        rng: np.random.Generator) -> np.ndarray:
    """Gaussian noise of absolute std (in q units), canonical mod q (u64):
    ``tfhe_tpu``'s draw, its Python-int reduction done in int64."""
    e = np.rint(rng.normal(0.0, std_abs, size=shape)).astype(np.int64)
    return np.where(e < 0, e + np.int64(_Q64), e).view(np.uint64)


def _bits_tensor(bits, device) -> torch.Tensor:
    """A binary secret key (numpy or tensor) as int64 on ``device``."""
    if not isinstance(bits, torch.Tensor):
        bits = torch.from_numpy(np.asarray(bits, dtype=np.int64))
    return bits.to(device, torch.int64)


def _mod_q_dot_binary(a: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """sum_j a[..., j] * bits[j] mod q for canonical ``a`` and a binary
    ``bits``: the 32-bit halves summed apart (< 2^63 for fewer than 2^31
    terms), then one 128-bit reduction."""
    sel = bits.to(torch.int64)
    lo_sum = ((a & M32) * sel).sum(-1)
    hi_sum = (srl(a, 32) * sel).sum(-1)
    lo = lo_sum + (hi_sum << 32)
    hi = srl(hi_sum, 32) + ult(lo, lo_sum).to(torch.int64)
    return gl._reduce128(hi, lo)


def _polymul_binary_q(s_bits, masks: torch.Tensor) -> torch.Tensor:
    """a_j (*) s_j negacyclic mod (X^N + 1, q), summed over j, through the
    Goldilocks transform on the masks' device. ``s_bits``: [k, N] binary;
    ``masks``: int64[m, k, N] canonical. Returns int64[m, N]."""
    plan = gl.get_plan_g(masks.shape[-1])
    s = _bits_tensor(s_bits, masks.device)
    s_hat = gl.fwd_ntt(s, plan)  # [k, N]
    a_hat = gl.fwd_ntt(masks, plan)  # [m, k, N]
    prod = gl.gmul(a_hat, s_hat[None])
    acc = prod[:, 0]
    for j in range(1, prod.shape[1]):
        acc = gl.gadd(acc, prod[:, j])
    return gl.inv_ntt(acc, plan)


def glwe_encrypt_q(sk_bits, msgs, noise_std_abs: float,
                   rng: np.random.Generator, device=None) -> torch.Tensor:
    """GLWE encryption mod q: mask uniform in [0, q), body = sum a_j*s_j +
    m + e (all mod q). ``msgs``: u64[m, N] canonical (numpy or int64
    tensor). -> int64[m, k+1, N] on ``device`` (the GPU when None)."""
    dev = resolve_device(device)
    k, N = np.shape(sk_bits)
    m = msgs.shape[0]
    mask_np = rng.integers(0, Q, size=(m, k, N), dtype=np.uint64)
    mask = from_u64(mask_np, dev)
    del mask_np
    body = _polymul_binary_q(sk_bits, mask)
    e = from_u64(_rounded_gaussian_q(noise_std_abs, (m, N), rng), dev)
    body = gl.gadd(gl.gadd(body, _u64_tensor(msgs, dev)), e)
    return torch.cat([mask, body[:, None, :]], dim=1)


def glwe_decrypt_q(sk_bits, cts: torch.Tensor) -> torch.Tensor:
    """body - sum a_j*s_j mod q. ``cts``: int64[m, k+1, N] -> int64[m, N]."""
    k = np.shape(sk_bits)[0]
    acc = _polymul_binary_q(sk_bits, cts[:, :k])
    return gl.gsub(cts[:, k], acc)


def lwe_encrypt_q(sk_bits, pts, noise_std_abs: float,
                  rng: np.random.Generator, device=None) -> torch.Tensor:
    """LWE encryption mod q. ``pts``: u64[m] canonical -> int64[m, n+1] on
    ``device`` (the GPU when None)."""
    dev = resolve_device(device)
    bits = _bits_tensor(sk_bits, dev)
    m = np.shape(pts)[0]
    a = from_u64(rng.integers(0, Q, size=(m, bits.shape[0]),
                              dtype=np.uint64), dev)
    e = from_u64(_rounded_gaussian_q(noise_std_abs, (m,), rng), dev)
    body = gl.gadd(gl.gadd(_mod_q_dot_binary(a, bits), _u64_tensor(pts, dev)),
                   e)
    return torch.cat([a, body[:, None]], dim=1)


def lwe_decrypt_q(sk_bits, cts: torch.Tensor) -> torch.Tensor:
    """phase = body - <a, s> mod q. ``cts``: int64[m, n+1] -> int64[m]."""
    bits = _bits_tensor(sk_bits, cts.device)
    return gl.gsub(cts[:, -1], _mod_q_dot_binary(cts[:, :-1], bits))


def decode_q(phase: torch.Tensor, delta: int) -> torch.Tensor:
    """Signed rounding decode mod q (``decomposer.rs:decode_plaintext``):
    round(|p| / delta) with the sign of p's centered view, mod q."""
    neg = ult(u64_const(Q >> 1), phase)
    p = torch.where(neg, _Q64 - phase, phase)  # < 2^63
    d = p // delta + ((p % delta) >= delta - delta // 2).to(torch.int64)
    return torch.where(neg & (d != 0), _Q64 - d, d)


# ---------------------------------------------------------------------------
# GGSW + bootstrap key (mod q)
# ---------------------------------------------------------------------------

def gen_bootstrap_key_ntt64(lwe_bits, glwe_bits, base_log: int, levels: int,
                            noise_std_abs: float, rng: np.random.Generator,
                            device=None) -> torch.Tensor:
    """Standard-domain BSK mod q: int64[n, l, k+1, k+1, N] on ``device``
    (the GPU when None; there it is refused, before any draw, outside K6's
    envelope, ``pbs_kernel.ntt64_refusal``).

    GGSW row (j, r) encrypts factor*s_r (the last row -factor) with factor
    = -bit * 2^(64 - b*(levels-j)) mod q (``ggsw_encryption.rs:20-175``
    with the non-native recomposition scale)."""
    from . import pbs_kernel as pk

    dev = resolve_device(device)
    lwe_bits = np.asarray(lwe_bits)
    glwe_bits = np.asarray(glwe_bits)
    n = lwe_bits.shape[0]
    k, N = glwe_bits.shape
    if dev.type == "cuda":
        why = pk.ntt64_refusal(k + 1, levels, base_log, N)
        if why:
            raise ValueError(why)
    msgs = np.zeros((n, levels, k + 1, N), dtype=np.uint64)
    for j in range(levels):
        factor = recomposition_summand_q(
            -lwe_bits.astype(np.int64), levels - j, base_log)  # [n]
        for r in range(k):
            msgs[:, j, r] = np.where(glwe_bits[r][None, :].astype(bool),
                                     factor[:, None], np.uint64(0))
        msgs[:, j, k, 0] = np.where(factor == 0, factor,
                                    np.uint64(Q) - factor)
    rows = glwe_encrypt_q(glwe_bits, msgs.reshape(-1, N), noise_std_abs, rng,
                          dev)
    return rows.reshape(n, levels, k + 1, k + 1, N)


def bootstrap_key_to_ntt64(bsk_q: torch.Tensor) -> torch.Tensor:
    """Forward-transform every BSK polynomial, classic DIF order (the
    ``convert_standard_lwe_bootstrap_key_to_ntt64`` analog; N^-1 stays in
    the inverse transform's untwist). K6 reads the result as it is."""
    plan = gl.get_plan_g(bsk_q.shape[-1])
    return gl.fwd_ntt(bsk_q, plan).contiguous()


# ---------------------------------------------------------------------------
# rotation + PBS
# ---------------------------------------------------------------------------

def monomial_mul_q(poly: torch.Tensor, degree) -> torch.Tensor:
    """poly * X^degree mod (X^N + 1, q), degree in [0, 2N] (a tensor
    broadcastable to ``poly.shape[:-1]``; 2N acts as 0). Negation mod q."""
    n = poly.shape[-1]
    d = torch.remainder(torch.as_tensor(degree, dtype=torch.int64,
                                        device=poly.device), 2 * n)
    t = torch.arange(n, dtype=torch.int64, device=poly.device)
    src = torch.remainder(t - d[..., None], 2 * n)
    wrapped = src >= n
    src = torch.where(wrapped, src - n, src)
    bshape = torch.broadcast_shapes(d.shape, poly.shape[:-1])
    src = src.expand(bshape + (n,))
    wrapped = wrapped.expand(bshape + (n,))
    gathered = torch.gather(poly.expand(bshape + (n,)), -1, src)
    return torch.where(wrapped, gneg(gathered), gathered)


def monomial_div_q(poly: torch.Tensor, degree) -> torch.Tensor:
    """poly * X^-degree mod (X^N + 1, q)."""
    n = poly.shape[-1]
    d = torch.as_tensor(degree, dtype=torch.int64, device=poly.device)
    return monomial_mul_q(poly, torch.remainder(2 * n - d, 2 * n))


def cmux_steps_q(acc: torch.Tensor, mask_sw: torch.Tensor,
                 bsk_hat: torch.Tensor, base_log: int,
                 levels: int) -> torch.Tensor:
    """The n CMUX steps of the mod-q blind rotation on an int64[B, R, N]
    canonical accumulator whose body rotation is applied (the loop of
    ``tfhe_tpu``'s ``blind_rotate_ntt64``; K6's plain version): per step,
    rot - acc mod q, the non-native digits lifted into Z_q and transformed,
    the MAC against the step's key, the inverse transform, acc += mod q.
    ``mask_sw``: [B, n] in [0, 2N]; ``bsk_hat``: int64[n, l, R, R, N]."""
    B, R, N = acc.shape
    plan = gl.get_plan_g(N)
    mask = mask_sw.to(device=acc.device, dtype=torch.int64)
    for i in range(bsk_hat.shape[0]):
        ct1 = gl.gsub(monomial_mul_q(acc, mask[:, i, None]), acc)
        digits = decompose_nonnative(ct1, base_log, levels).movedim(-1, -3)
        dhat = gl.fwd_ntt(gl.signed_to_field(digits), plan).reshape(
            B, levels * R, N)
        g = bsk_hat[i].reshape(levels * R, R, N)
        out = gl.gmul(dhat[:, 0, None], g[None, 0])
        for j in range(1, levels * R):
            out = gl.gadd(out, gl.gmul(dhat[:, j, None], g[None, j]))
        acc = gl.gadd(acc, gl.inv_ntt(out, plan))
    return acc


def blind_rotate_ntt64(lut: torch.Tensor, mask_sw: torch.Tensor,
                       body_sw: torch.Tensor, bsk_hat: torch.Tensor,
                       base_log: int, levels: int) -> torch.Tensor:
    """Blind rotation mod q (``ntt64_pbs.rs:178-285``, batched): ``lut``
    int64[B, R, N] canonical; ``mask_sw`` / ``body_sw``: switched degrees
    in [0, 2N] ([B, n] / [B]); ``bsk_hat``: the transformed key
    int64[n, l, R, R, N]. The body rotation, then the n steps on K6 (a
    CUDA tensor) or :func:`cmux_steps_q` (a CPU tensor). -> int64[B, R,
    N]."""
    from . import pbs_kernel as pk

    body = torch.as_tensor(body_sw, dtype=torch.int64, device=lut.device)
    acc = monomial_div_q(lut, body[:, None]).contiguous()
    return pk.blind_rotate_ntt64(acc, mask_sw, bsk_hat, base_log, levels)


def sample_extract_q(glwe: torch.Tensor, nth: int = 0) -> torch.Tensor:
    """GLWE -> LWE of the nth coefficient, negations mod q
    (``glwe_sample_extraction.rs`` with a custom modulus)."""
    k = glwe.shape[-2] - 1
    N = glwe.shape[-1]
    body = glwe[..., k, nth]
    rev = glwe[..., :k, :].flip(-1)
    opp = N - nth - 1
    idx = torch.arange(N, device=glwe.device)
    neg = torch.where(idx < opp, gneg(rev), rev)
    rotated = torch.roll(neg, -opp, dims=-1)
    out_mask = rotated.reshape(glwe.shape[:-2] + (k * N,))
    return torch.cat([out_mask, body[..., None]], dim=-1)


def generate_lut_q(poly_size: int, glwe_size: int, message_modulus: int,
                   delta: int, f) -> np.ndarray:
    """Trivial GLWE LUT mod q (``generate_programmable_bootstrap_glwe_lut``),
    u64[glwe_size, N] on the host."""
    N = poly_size
    box = N // message_modulus
    body = np.zeros(N, dtype=np.uint64)
    for i in range(message_modulus):
        body[i * box:(i + 1) * box] = (f(i) * delta) % Q
    half = box // 2  # negacyclic half-box pre-rotation (mod q negation)
    rot = np.concatenate([body[half:], body[:half]])
    tail = rot[N - half:]
    rot[N - half:] = np.where(tail == 0, tail, np.uint64(Q) - tail)
    out = np.zeros((glwe_size, N), dtype=np.uint64)
    out[-1] = rot
    return out


def pbs_ntt64(lwe_cts: torch.Tensor, lut_glwe, bsk_hat: torch.Tensor,
              base_log: int, levels: int) -> torch.Tensor:
    """The whole PBS mod q on the ciphertexts' device: the modulus switch,
    the blind rotation (K6 on a CUDA device, one launch), the sample
    extraction. ``lwe_cts``: int64[B, n+1]; ``lut_glwe``: u64[k+1, N]
    (numpy or int64 tensor). -> int64[B, k*N + 1]."""
    dev = lwe_cts.device
    lut = _u64_tensor(lut_glwe, dev)
    N = lut.shape[-1]
    B = lwe_cts.shape[0]
    mask_sw = modulus_switch_nonnative(lwe_cts[:, :-1], N)
    body_sw = modulus_switch_nonnative(lwe_cts[:, -1], N)
    acc = blind_rotate_ntt64(lut[None].expand((B,) + lut.shape), mask_sw,
                             body_sw, bsk_hat, base_log, levels)
    return sample_extract_q(acc)
