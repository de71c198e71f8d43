"""Carry keys made by tfhe_tpu into the port.

Every function takes plain numpy arrays (what ``np.asarray`` of a
``tfhe_tpu`` key gives), so the port and the JAX package can compute on
identical keys without the port importing either JAX or ``tfhe_tpu``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import boolean
from ._device import resolve_device
from ._torus import from_u32, from_u64
from .core.entities import GlweSecretKey, LweSecretKey
from .ops import ntt as ntt_mod
from .shortint.client_key import ClientKey
from .shortint.server_key import ServerKey, check_supported, resolve_variant
from .utils.params import BOOLEAN_PARAMS_BY_NAME, PARAMS_BY_NAME


def client_key_from_arrays(params_name: str, glwe_sk_bits, lwe_sk_bits,
                           device=None) -> ClientKey:
    """A port ClientKey from secret-key bits u64[k, N] and u64[n]. It
    decrypts; it carries no random streams, so it does not encrypt."""
    dev = resolve_device(device)
    return ClientKey(params=PARAMS_BY_NAME[params_name],
                     glwe_sk=GlweSecretKey(from_u64(glwe_sk_bits, dev)),
                     lwe_sk=LweSecretKey(from_u64(lwe_sk_bits, dev)),
                     device=dev)


def server_key_from_arrays(params_name: str, ksk_u64,
                           bsk_scan_residues_u32, num_primes: int,
                           device=None) -> ServerKey:
    """A port ServerKey from ``tfhe_tpu``'s stored key arrays: the KSK
    u64[n_big, l_ks, n_small+1] and the CRT-domain bootstrap key in scan
    layout u32[n, 2(residue/shoup), P, l*R, R, N] over the first
    ``num_primes`` PRIMES32. The standard-domain BSK is rebuilt exactly with
    the port's inverse NTT + Garner reconstruction (as
    ``tfhe_tpu.shortint.server_key`` does before deriving its BNF2 key),
    then prepared for the resolved variant (under v5, ``bsk_g`` equals
    ``tfhe_tpu``'s ``ServerKey.bsk_scan_g``)."""
    p = PARAMS_BY_NAME[params_name]
    check_supported(p)
    dev = resolve_device(device)
    variant = resolve_variant(p.polynomial_size, p.pbs_base_log, p.pbs_level,
                              params=p)
    scan = np.asarray(bsk_scan_residues_u32, dtype=np.uint32)
    nlwe, two, P, lR, R, N = scan.shape
    if P != num_primes or two != 2:
        raise ValueError(f"scan layout {scan.shape} does not hold {num_primes} "
                         "primes of residues + Shoup duals")
    levels = lR // R
    res = from_u32(scan[:, 0], dev).to(torch.int64) & 0xFFFFFFFF
    res = res.movedim(1, 0)  # [P, n, l*R, R, N]
    plan = ntt_mod.get_plan(N, num_primes)
    std = plan.reconstruct_u64(plan.inv(res)).reshape(nlwe, levels, R, R, N)
    return ServerKey.from_standard_keys(p, from_u64(ksk_u64, dev), std,
                                        variant)


def boolean_client_key_from_arrays(params_name: str, glwe_sk_bits,
                                   lwe_sk_bits,
                                   device=None) -> boolean.ClientKey:
    """A port boolean ClientKey from secret-key bits u64[k, N] and u64[n].
    It decrypts; it carries no random streams, so it does not encrypt."""
    dev = resolve_device(device)
    return boolean.ClientKey(
        params=BOOLEAN_PARAMS_BY_NAME[params_name],
        glwe_sk=GlweSecretKey(from_u64(glwe_sk_bits, dev)),
        lwe_sk=LweSecretKey(from_u64(lwe_sk_bits, dev)), device=dev)


def boolean_server_key_from_arrays(params_name: str, ksk_u64,
                                   bsk_scan_u32,
                                   device=None) -> boolean.ServerKey:
    """A port boolean ServerKey from ``tfhe_tpu``'s stored key arrays: the
    KSK u64[k*N, l_ks, n+1] and the CRT key in scan layout
    u32[n, 2, P, l*R, R, N], taken as stored (the port's NTT plan gives the
    same residue order)."""
    dev = resolve_device(device)
    return boolean.ServerKey.from_keys(
        BOOLEAN_PARAMS_BY_NAME[params_name], from_u64(ksk_u64, dev),
        from_u32(bsk_scan_u32, dev))
