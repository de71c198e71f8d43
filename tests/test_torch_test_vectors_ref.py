"""The port's reference-vector twin (``tfhe_tpu_torch.apps.
test_vectors_ref``) against ``apps/test_vectors_ref.py``, on the CPU:

- the toy set byte-equal to tfhe_tpu's: every artifact, every ``_internal``
  array, and the digests ``TOY_SHA256``;
- a set with gaussian noise, k = 2 and two PBS levels byte-equal too (the
  bulk noise slices and the limb products of the BSK's rows);
- the bulk sampler's pieces against the scalar ones they replace;
- ``decrypt_contract`` through the plain K2 u64 -> K3 (id LUT -> 4, spec
  LUT -> 8), and ``main``;
- the oid check of ``tests/test_ref_vectors.py``, which skips, as that one
  does, where the reference checkout is absent.

Tolerance: exact (bytes)."""

import hashlib
import os

import numpy as np
import pytest

from test_ref_vectors import REF_DIR, tvr as jtvr  # apps/test_vectors_ref

from tfhe_tpu_torch.apps import test_vectors_ref as tvr
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.utils.csprng import AesCtrGenerator

#: gaussian noise (valid_params_128's), k = 2, two PBS levels, toy sizes
NOISY = dict(n=12, k=2, N=256, lwe_std=tvr.VALID["lwe_std"],
             glwe_std=tvr.VALID["glwe_std"], pbs_blog=15, pbs_l=2,
             ks_blog=3, ks_l=5)


@pytest.fixture(scope="module")
def toy_files():
    return tvr.generate(tvr.TOY)


def _byte_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        if name == "_internal":
            continue
        assert got[name] == want[name], name
    internal = want["_internal"]
    assert set(got["_internal"]) == set(internal) | {"params"}
    for name, arr in internal.items():
        assert got["_internal"][name].dtype == arr.dtype, name
        np.testing.assert_array_equal(got["_internal"][name], arr,
                                      err_msg=name)


def test_toy_set_byte_equal(toy_files):
    assert tvr.TOY == jtvr.TOY and tvr.VALID == jtvr.VALID
    _byte_equal(toy_files, jtvr.generate(jtvr.TOY))
    assert tvr.digests(toy_files) == tvr.TOY_SHA256
    assert len(tvr.TOY_SHA256) == 10


def test_noisy_set_byte_equal():
    _byte_equal(tvr.generate(NOISY), jtvr.generate(NOISY))


def test_bulk_sampler_matches_scalar():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(0, 1e-3, 1000), rng.normal(0, 10, 100),
                        [0.0, -0.0, 0.5, -0.5, 1.5, -2.5, 2.0 ** -65,
                         0.5 - 2.0 ** -54, -(0.5 - 2.0 ** -54)]])
    np.testing.assert_array_equal(
        tvr._from_torus_array(x),
        np.array([tvr._from_torus(float(v)) for v in x], dtype=np.uint64))
    for std in (0.0, tvr.VALID["lwe_std"], 0.25):
        bulk = tvr._gaussian_slice(AesCtrGenerator(11, table_index=1), 300,
                                   std)
        gen = AesCtrGenerator(11, table_index=1)
        scalar = [tvr._gaussian_one(gen, std) for _ in range(300)]
        np.testing.assert_array_equal(bulk, np.array(scalar, np.uint64))
    masks = rng.integers(0, 1 << 64, size=(3, 64), dtype=np.uint64)
    bits = rng.integers(0, 2, size=64).astype(np.uint64)
    want = np.stack([jtvr._negacyclic_binary_polymul(m, bits) for m in masks])
    np.testing.assert_array_equal(tvr._negacyclic_binary_polymul(masks, bits),
                                  want)


def test_decrypt_contract_on_the_cpu(toy_files):
    pk.reset_launches()
    assert tvr.decrypt_contract(toy_files, device="cpu") == {"id": 4,
                                                             "spec": 8}
    assert all(f.launches == 0 for f in pk.KERNELS)  # plain versions
    inputs = tvr.pbs_inputs(toy_files, device="cpu")
    assert inputs["key"].shape[2] == tvr.CONTRACT_PRIMES == 4


def test_main_without_a_reference(capsys):
    assert tvr.main(["toy", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "{'id': 4, 'spec': 8}" in out
    assert "10 byte-exact matches, 0 mismatches" in out
    assert len(tvr.VALID_SHA256) == 10


@pytest.mark.skipif(not os.path.isdir(REF_DIR), reason="reference absent")
def test_toy_params_byte_exact(toy_files):
    checkout = os.path.dirname(os.path.dirname(os.path.dirname(REF_DIR)))
    oids = tvr.reference_oids("toy_params", checkout)
    reproducible = [k for k in toy_files if not k.startswith("_")]
    assert len(reproducible) == 10
    for name in reproducible:
        got = hashlib.sha256(toy_files[name]).hexdigest()
        want, want_size = oids[name]
        assert got == want, (name, got, want)
        assert len(toy_files[name]) == want_size, name
