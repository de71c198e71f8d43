"""Disk-backed key cache: avoids minutes of keygen per test or run.

Torch counterpart of ``tfhe_tpu/keycache.py`` (reference
``tfhe/src/keycache/mod.rs``, ``shortint/keycache.rs``), with its layout:
a directory ``{params name}_s{seed}_{fingerprint}`` under
``$TFHE_TPU_KEYCACHE`` (default: ``.keycache/`` at the root of the
checkout) holding ``ksk.npy``, ``ksk_i8.npy`` and ``bsk_scan.npy``, the
server key's stored form (``utils.serialization.server_key_arrays``); the
keys are also kept in memory per process. Port keygen from a seed equals
``tfhe_tpu``'s byte for byte, so a cache written by either package serves
the other.

The client key's keygen and encryption streams come from independent
sub-seeds (:class:`tfhe_tpu_torch.shortint.client_key.ClientKey`), so a
cache hit is bit-identical to a fresh generation: the key material and
every later encryption.
"""

from __future__ import annotations

import hashlib
import os
import threading
from pathlib import Path

import numpy as np

from ._device import resolve_device

_mem: dict = {}
_lock = threading.Lock()


def cache_root() -> Path:
    """``$TFHE_TPU_KEYCACHE``, read at each call, else ``.keycache/``."""
    return Path(os.environ.get(
        "TFHE_TPU_KEYCACHE",
        os.path.join(os.path.dirname(__file__), "..", ".keycache")))


def _fingerprint(params) -> str:
    """Short stable hash of the fields that shape key material (two
    different parameter sets may share a name; ``tfhe_tpu``'s fields, in
    its order, so both packages name a cache directory alike)."""
    fields = []
    for f in ("lwe_dimension", "glwe_dimension", "polynomial_size",
              "ks_base_log", "ks_level", "pbs_base_log", "pbs_level",
              "grouping_factor", "message_modulus", "carry_modulus",
              "encryption_key_choice", "modulus_switch_type"):
        fields.append(str(getattr(params, f, None)))
    for f in ("lwe_noise_distribution", "glwe_noise_distribution"):
        d = getattr(params, f, None)
        fields.append(f"{getattr(d, 'kind', None)}:{getattr(d, 'std_dev', None)}:"
                      f"{getattr(d, 'bound_log2', None)}")
    return hashlib.sha256("|".join(fields).encode()).hexdigest()[:12]


def _cache_dir(param_name: str, seed: int, fp: str) -> Path:
    return cache_root() / f"{param_name}_s{seed}_{fp}"


def get_shortint_keys(params, seed: int = 0, device=None):
    """(ClientKey, ServerKey) for a shortint parameter set on ``device``
    (the GPU when unset), from memory, from disk, or generated and
    written."""
    from .shortint.client_key import ClientKey
    from .shortint.server_key import ServerKey, num_primes_for
    from .utils.serialization import server_key_arrays

    dev = resolve_device(device)
    fp = _fingerprint(params)
    key = ("shortint", params.name, seed, fp, str(dev))
    with _lock:
        if key in _mem:
            return _mem[key]

    d = _cache_dir(params.name, seed, fp)
    ck = ClientKey.generate(params, seed, device=dev)  # secret keys only
    if (d / "bsk_scan.npy").exists():
        sk = ServerKey.from_stored(params, np.load(d / "ksk.npy"),
                                  np.load(d / "bsk_scan.npy"),
                                  num_primes_for(params), dev)
    else:
        sk = ServerKey.generate(ck)
        d.mkdir(parents=True, exist_ok=True)
        arrays = server_key_arrays(sk)
        for name in ("ksk", "ksk_i8", "bsk_scan"):  # bsk_scan.npy last
            np.save(d / f"{name}.npy", arrays[name])
    with _lock:
        _mem[key] = (ck, sk)
    return ck, sk


def clear_memory_cache() -> None:
    with _lock:
        _mem.clear()
