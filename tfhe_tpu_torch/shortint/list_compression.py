"""List compression: many LWEs packed into GLWEs, stored modulus-switched.

Torch counterpart of ``tfhe_tpu/shortint/list_compression.py`` (reference
``tfhe/src/shortint/list_compression/`` (compression.rs:17-164,
server_keys.rs:27-100) and ``core_crypto/algorithms/
lwe_packing_keyswitch.rs``):

- compress: the packing keyswitch of up to ``lwe_per_glwe`` big-key LWEs
  into one GLWE under a dedicated compression key (an NTT-domain MAC over
  N_c with P primes, exact, as torch ops on the device), then only the top
  ``storage_log_modulus`` bits of every coefficient are kept;
- decompress: re-expand, extract coefficient i, then one blind rotation
  with an identity LUT under the decompression key back to the big key
  (``decompress_and_apply_lookup_table``): ``tfhe_tpu``'s TPU path,
  ``programmable_bootstrap_pallas`` with the standard modulus switch, which
  in the port is ``programmable_bootstrap_crt`` on the exact CRT key (K2 u64
  -> K3, or K2 acc32 -> K3-acc32 under ``TFHE_V4_ACC=32``) whatever the
  server key's variant.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._torus import i64_to_u32, srl, u32_to_i64
from ..core import algorithms as algo
from ..core.entities import GlweSecretKey
from ..ops import ntt as ntt_mod
from ..ops import pbs_kernel as pk
from ..ops import server as server_ops
from ..ops.decomp import decompose
from ..utils.csprng import SecretRandomGenerator
from ..utils.params import CompressionParameters, DynamicDistribution
from .ciphertext import NOMINAL_NOISE, ShortintCiphertext
from .client_key import ClientKey
from .server_key import ServerKey, num_primes_for

_G = DynamicDistribution.gaussian_from_std_dev

# v1_4/list_compression/p_fail_2_minus_128/mod.rs (gaussian)
COMP_PARAM_MESSAGE_2_CARRY_2_KS_PBS = CompressionParameters(
    br_level=1,
    br_base_log=23,
    packing_ks_level=2,
    packing_ks_base_log=6,
    packing_ks_polynomial_size=256,
    packing_ks_glwe_dimension=4,
    lwe_per_glwe=256,
    storage_log_modulus=12,
    packing_ks_key_noise_distribution=_G(1.339775301998614e-07),
    name="COMP_PARAM_MESSAGE_2_CARRY_2_KS_PBS",
)

COMP_PARAM_TEST_TOY = CompressionParameters(
    br_level=1,
    br_base_log=23,
    packing_ks_level=2,
    packing_ks_base_log=6,
    packing_ks_polynomial_size=128,
    packing_ks_glwe_dimension=2,
    lwe_per_glwe=128,
    storage_log_modulus=16,
    packing_ks_key_noise_distribution=_G(2.0 ** -40),
    name="COMP_PARAM_TEST_TOY",
)

#: GLWEs a packing-keyswitch pass works on, and input LWE coefficients a
#: MAC chunk sums (they bound the product tensor: P x tile x chunk x l x
#: R_c x N_c int64, 335 MB at 2_2)
TILE = 8
MAC_CHUNK = 512


@dataclass
class CompressionPrivateKeys:
    """The client's compression GLWE secret key
    (list_compression/private_key.rs)."""

    comp_glwe_sk: GlweSecretKey
    params: CompressionParameters


@dataclass
class CompressionKey:
    """Packing keyswitch key, NTT domain: int64[P, n_big, l, R_c, N_c]
    residues over the first P PRIMES32."""

    pksk_hat: torch.Tensor
    params: CompressionParameters
    num_primes: int


@dataclass
class DecompressionKey:
    """Blind-rotation key from the compression key back to the main GLWE
    key: the exact CRT key in scan layout, int32 (u32) [k_c*N_c, 2, P,
    l*R, R, N]."""

    bsk_scan: torch.Tensor
    br_base_log: int
    br_level: int
    num_primes: int


def new_compression_private_key(client_key: ClientKey,
                                params: CompressionParameters
                                ) -> CompressionPrivateKeys:
    """The compression GLWE key, drawn from the client seed's own secret
    stream, on the client key's device."""
    sec = SecretRandomGenerator((client_key.seed << 8) ^ 0xC0)
    sk = algo.gen_glwe_secret_key(params.packing_ks_glwe_dimension,
                                  params.packing_ks_polynomial_size, sec,
                                  client_key.device)
    return CompressionPrivateKeys(comp_glwe_sk=sk, params=params)


def new_compression_decompression_keys(client_key: ClientKey,
                                       private: CompressionPrivateKeys):
    """(CompressionKey, DecompressionKey), server_keys.rs:27-100, both from
    the client key's keygen stream (the packing key, then the
    decompression key)."""
    cp = private.params
    N_c, R_c = cp.packing_ks_polynomial_size, cp.packing_ks_glwe_dimension + 1
    gen = client_key._keygen_gen
    # packing key: for each big-key bit, levels of GLWE(s_j * q / B^level)
    bits = client_key.big_lwe_sk.bits
    n_big, l, b = bits.shape[0], cp.packing_ks_level, cp.packing_ks_base_log
    msgs = torch.zeros((n_big, l, N_c), dtype=torch.int64, device=bits.device)
    for lev_idx in range(l):
        msgs[:, lev_idx, 0] = bits << (64 - b * (l - lev_idx))
    rows = algo.glwe_encrypt(private.comp_glwe_sk, msgs.reshape(-1, N_c),
                             cp.packing_ks_key_noise_distribution, gen)
    # the MAC's bound: digit (b - 1) + 64 + log2(N_c) + log2(n_big * l)
    bound = (b - 1) + 64 + np.log2(N_c) + np.log2(n_big * l)
    npr = ntt_mod.min_primes_for_bound(float(bound))
    pksk_hat = ntt_mod.get_plan(N_c, npr).fwd(rows.reshape(n_big, l, R_c,
                                                           N_c))
    comp_key = CompressionKey(pksk_hat=pksk_hat, params=cp, num_primes=npr)
    # decompression key: a GGSW of each compression-key bit under the main
    # GLWE key, on the exact CRT key of the main parameters' prime count
    p = client_key.params
    bsk = algo.gen_bootstrap_key(
        private.comp_glwe_sk.as_lwe_secret_key(), client_key.glwe_sk,
        cp.br_base_log, cp.br_level, p.glwe_noise_distribution, gen)
    npr_m = num_primes_for(p)
    dec_key = DecompressionKey(
        bsk_scan=pk.bsk_to_scan_layout(
            algo.bootstrap_key_to_ntt(bsk, npr_m).residues),
        br_base_log=cp.br_base_log, br_level=cp.br_level, num_primes=npr_m)
    return comp_key, dec_key


@dataclass
class CompressedCiphertextList:
    """Packed GLWEs keeping only the top ``storage_log_modulus`` bits
    (CompressedModulusSwitchedGlweCiphertext): u32 in int32 storage
    [n_glwe, R_c, N_c]."""

    storage: torch.Tensor
    count: int
    message_modulus: int
    carry_modulus: int
    params: CompressionParameters


def pack(a: torch.Tensor, bvals: torch.Tensor, comp_key: CompressionKey
         ) -> torch.Tensor:
    """The packing keyswitch of g groups of LWEs (masks ``a`` int64[g, per,
    n_big], bodies ``bvals`` [g, per]) -> g GLWEs int64[g, R_c, N_c]: body
    polynomial sum_i b_i X^i minus sum_{j, lev} P_{j,lev} * K[j, lev],
    P_{j,lev}(X) = sum_i digit_{i,j,lev} X^i, an NTT-domain MAC summed
    exactly (< n_big * l * p) before one reduction, then one inverse
    transform and the Garner reconstruction (``tfhe_tpu``'s
    ``_get_pack_fn``)."""
    cp = comp_key.params
    g, per, n_big = a.shape
    l, N_c = cp.packing_ks_level, cp.packing_ks_polynomial_size
    R_c = cp.packing_ks_glwe_dimension + 1
    plan = ntt_mod.get_plan(N_c, comp_key.num_primes)
    P = plan.num_primes
    digits = decompose(a, cp.packing_ks_base_log, l)  # [g, per, n_big, l]
    polys = torch.zeros((g, n_big, l, N_c), dtype=torch.int64,
                        device=a.device)
    polys[..., :per] = digits.permute(0, 2, 3, 1)
    dhat = plan.fwd_digits(polys)  # [P, g, n_big, l, N_c]
    p = plan.tables(a.device)["p"]
    p6 = p.reshape(P, 1, 1, 1, 1, 1)
    acc = torch.zeros((P, g, R_c, N_c), dtype=torch.int64, device=a.device)
    for c0 in range(0, n_big, MAC_CHUNK):
        prod = torch.remainder(
            dhat[:, :, c0:c0 + MAC_CHUNK, :, None, :]
            * comp_key.pksk_hat[:, None, c0:c0 + MAC_CHUNK], p6)
        acc += prod.sum(dim=(2, 3))
    acc = torch.remainder(acc, p.reshape(P, 1, 1, 1))
    mac = plan.reconstruct_u64(plan.inv(acc))  # [g, R_c, N_c]
    body = torch.zeros((g, R_c, N_c), dtype=torch.int64, device=a.device)
    body[:, R_c - 1, :per] = bvals
    return body - mac


def compress(comp_key: CompressionKey, cts: ShortintCiphertext
             ) -> CompressedCiphertextList:
    """Pack a batched shortint ciphertext (leading batch dims = the list
    order) on the compression key's device, TILE GLWEs a pass."""
    cp = comp_key.params
    N_c = cp.packing_ks_polynomial_size
    dev = comp_key.pksk_hat.device
    arr = cts.ct.reshape(-1, cts.ct.shape[-1]).to(dev)
    count, n_big = arr.shape[0], arr.shape[1] - 1
    assert count <= cp.lwe_per_glwe * N_c
    per = min(cp.lwe_per_glwe, N_c)
    n_glwe = -(-count // per)
    padded = torch.zeros((n_glwe * per, n_big + 1), dtype=torch.int64,
                         device=dev)
    padded[:count] = arr
    a_all = padded[:, :n_big].reshape(n_glwe, per, n_big)
    b_all = padded[:, n_big].reshape(n_glwe, per)
    stored = torch.cat([pack(a_all[i:i + TILE], b_all[i:i + TILE], comp_key)
                        for i in range(0, n_glwe, TILE)])
    slm = cp.storage_log_modulus
    top = srl(stored + (1 << (64 - slm - 1)), 64 - slm)
    return CompressedCiphertextList(
        storage=i64_to_u32(top), count=count,
        message_modulus=cts.message_modulus,
        carry_modulus=cts.carry_modulus, params=cp)


def decompress(lst: CompressedCiphertextList, dec_key: DecompressionKey,
               server_key: ServerKey, indices=None) -> ShortintCiphertext:
    """Expand, extract, and one identity-LUT blind rotation of all the
    ``indices`` (every item when None) at once
    (decompress_and_apply_lookup_table)."""
    cp = lst.params
    per = min(cp.lwe_per_glwe, cp.packing_ks_polynomial_size)
    slm = cp.storage_log_modulus
    if indices is None:
        indices = range(lst.count)
    dev = dec_key.bsk_scan.device
    idx = torch.as_tensor(list(indices), dtype=torch.int64, device=dev)
    glwes = u32_to_i64(lst.storage.to(dev)) << (64 - slm)
    small = server_ops.sample_extract_at(glwes[idx // per], idx % per)
    mm, cm = lst.message_modulus, lst.carry_modulus
    lut = server_key.generate_lookup_table(lambda x: x % (mm * cm))
    out = server_ops.programmable_bootstrap_crt(
        small, lut.acc.to(dev), dec_key.bsk_scan, dec_key.br_base_log,
        dec_key.br_level, centered_ms=False)
    return ShortintCiphertext(
        ct=out, degree=mm * cm - 1, noise_level=NOMINAL_NOISE,
        message_modulus=mm, carry_modulus=cm, under_key="big")
