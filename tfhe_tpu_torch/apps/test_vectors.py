"""Golden test vectors: every intermediate of a KS -> PBS atomic pattern from
a fixed seed, held to the SHA-256 sums of ``apps/test_vectors_data/``.

Torch counterpart of ``apps/test_vectors.py`` (reference
``apps/test-vectors``, main.rs: RAND_SEED 0x74666865, toy geometry n = 10,
k = 1, N = 256, noise 0, and ``scripts/test_vectors.sh``'s checksum
gate). The keyswitch, the standard modulus switch and the exact blind
rotation run on the port's path: ``ops/server.py::keyswitch_mxu``, then
K2 u64 -> K3 (``pbs_kernel.body_rotate_u64``, ``blind_rotate_crt``) on the
CRT key, the kernels on a GPU and their plain versions on the CPU. Each
array is hashed in ``tfhe_tpu``'s dtype (u64) and shape, so the port
reproduces the sums that ``tfhe_tpu`` wrote.

Usage:  python -m tfhe_tpu_torch.apps.test_vectors generate outdir [device]
        python -m tfhe_tpu_torch.apps.test_vectors check   [outdir] [device]

(``device``: the GPU when left out; ``cpu`` runs the plain versions.
``generate`` never writes into ``apps/test_vectors_data/``: that directory
holds the golden data the port is checked against.)
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import tempfile

import numpy as np

RAND_SEED = 0x74666865

TOY = dict(lwe_dimension=10, glwe_dimension=1, polynomial_size=256,
           pbs_base_log=23, pbs_level=1, ks_base_log=3, ks_level=5)

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "apps", "test_vectors_data")

A, B = 3, 2  # the two encrypted messages


def luts(mod_sup: int) -> tuple:
    """(tag, function) of the two blind rotations: identity and 2x."""
    return (("id", lambda x: x), ("spec", lambda x: (2 * x) % mod_sup))


def keys(device=None):
    """(ClientKey, ServerKey) of the vectors: PARAM_TEST_TOY cut to the
    reference's toy geometry with noise 0, from RAND_SEED, on ``device``
    (the GPU when unset)."""
    from ..shortint.client_key import ClientKey
    from ..shortint.server_key import ServerKey
    from ..utils.params import PARAM_TEST_TOY, DynamicDistribution

    zero = DynamicDistribution.gaussian_from_std_dev(0.0)
    p = dataclasses.replace(
        PARAM_TEST_TOY, lwe_dimension=TOY["lwe_dimension"],
        polynomial_size=TOY["polynomial_size"],
        lwe_noise_distribution=zero, glwe_noise_distribution=zero,
        name="TEST_VECTORS_TOY")
    ck = ClientKey.generate(p, seed=RAND_SEED, device=device)
    return ck, ServerKey.generate(ck)


def vectors(ck, sk) -> dict:
    """Every intermediate, as u64 numpy arrays in ``tfhe_tpu``'s shapes."""
    from .._torus import to_u64, u64_const
    from ..ops import pbs_kernel as pk
    from ..ops import server as so

    p = ck.params
    vecs = {
        "large_lwe_secret_key": to_u64(ck.big_lwe_sk.bits),
        "small_lwe_secret_key": to_u64(ck.lwe_sk.bits),
        "ksk": to_u64(sk.ksk),
    }
    lwe_a = ck.encrypt(np.uint64(A)).ct
    lwe_b = ck.encrypt(np.uint64(B)).ct
    vecs["lwe_a"] = to_u64(lwe_a)
    vecs["lwe_b"] = to_u64(lwe_b)
    vecs["lwe_sum"] = to_u64(lwe_a + lwe_b)
    vecs["lwe_prod"] = to_u64(lwe_a * u64_const(B))

    ks = so.keyswitch_mxu(lwe_a[None], sk.ksk_i8, p.ks_base_log, p.ks_level)
    vecs["lwe_ks"] = to_u64(ks[0])
    N = p.polynomial_size
    msm, msb = so.lwe_standard_modulus_switch(ks, N.bit_length())
    vecs["lwe_ms"] = np.concatenate([to_u64(msm[0]), to_u64(msb)])
    for tag, f in luts(p.message_modulus * p.carry_modulus):
        lut = sk.generate_lookup_table(f).acc
        acc = pk.body_rotate_u64(lut, msb)
        rotated = pk.blind_rotate_crt(acc, msm, sk.crt_key(), p.pbs_base_log,
                                      p.pbs_level)[0]
        vecs[f"glwe_after_{tag}_br"] = to_u64(rotated)
        vecs[f"lwe_after_{tag}_pbs"] = to_u64(so.sample_extract(rotated, 0))
    return vecs


def generate(outdir: str, device=None) -> dict:
    """Write every vector as ``<name>.npy`` and their sums as
    ``checksums.json`` into ``outdir``; return the sums. Refuses the golden
    directory ``DATA_DIR``."""
    if os.path.realpath(outdir) == os.path.realpath(DATA_DIR):
        raise ValueError(f"{DATA_DIR} holds the golden vectors the port is "
                         "checked against: generate into another directory")
    ck, sk = keys(device)
    os.makedirs(outdir, exist_ok=True)
    sums = {}
    for name, arr in vectors(ck, sk).items():
        arr = np.ascontiguousarray(arr)
        np.save(os.path.join(outdir, f"{name}.npy"), arr)
        sums[name] = hashlib.sha256(arr.tobytes()).hexdigest()
    with open(os.path.join(outdir, "checksums.json"), "w") as f:
        json.dump(sums, f, indent=1, sort_keys=True)
    return sums


def check(outdir: str = DATA_DIR, device=None) -> bool:
    """Regenerate the vectors on ``device`` and compare every sum with
    ``outdir/checksums.json``."""
    with open(os.path.join(outdir, "checksums.json")) as f:
        want = json.load(f)
    with tempfile.TemporaryDirectory() as td:
        got = generate(td, device)
    ok = True
    for k in sorted(want):
        if want[k] != got.get(k):
            print(f"MISMATCH {k}: {want[k][:16]} != {got.get(k, 'missing')[:16]}")
            ok = False
    print("OK: all vectors reproduce" if ok else "FAIL")
    return ok


if __name__ == "__main__":
    cmd = sys.argv[1] if len(sys.argv) > 1 else "check"
    device = sys.argv[3] if len(sys.argv) > 3 else None
    if cmd == "generate":
        if len(sys.argv) < 3:
            sys.exit("usage: python -m tfhe_tpu_torch.apps.test_vectors "
                     "generate outdir [device]")
        print(json.dumps(generate(sys.argv[2], device), indent=1,
                         sort_keys=True))
    else:
        outdir = sys.argv[2] if len(sys.argv) > 2 else DATA_DIR
        sys.exit(0 if check(outdir, device) else 1)
