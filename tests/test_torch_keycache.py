"""The port's key cache (``tfhe_tpu_torch.keycache``) against
``tfhe_tpu.keycache`` at PARAM_TEST_TOY on the CPU, every cache under
``tmp_path`` (never the checkout's ``.keycache/``): the fingerprints and
directory names are equal; a directory written by either package holds the
same file bytes and serves the other (equal keys, equal PBS output); a hit
equals the miss that wrote it; ``$TFHE_TPU_KEYCACHE`` is read at each call;
``high_level_api.generate_keys(use_keycache=True, device="cpu")`` works.
Tolerance: exact."""

import dataclasses

import numpy as np
import pytest
import torch

from tfhe_tpu import keycache as jkc
from tfhe_tpu.utils import params as jparams

from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch import keycache
from tfhe_tpu_torch._torus import to_u32, to_u64
from tfhe_tpu_torch.high_level_api import api
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.server_key import ServerKey
from tfhe_tpu_torch.utils import params as pm

SEED = 5
FILES = ("ksk.npy", "ksk_i8.npy", "bsk_scan.npy")
MSGS = np.array([0, 3, 9, 15], dtype=np.uint64)


@pytest.fixture(autouse=True)
def caches(tmp_path, monkeypatch):
    """Both packages' caches under tmp_path, their memory caches empty."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(jkc, "_DEFAULT_DIR", str(jdir))
    monkeypatch.setenv("TFHE_TPU_KEYCACHE", str(pdir))
    jkc.clear_memory_cache()
    keycache.clear_memory_cache()
    yield jdir, pdir
    jkc.clear_memory_cache()
    keycache.clear_memory_cache()


@pytest.mark.parametrize("name", [
    "PARAM_TEST_TOY", "PARAM_MESSAGE_2_CARRY_2_KS_PBS",
    "PARAM_TEST_TOY_MULTI_BIT",
    "V1_5_PARAM_MESSAGE_2_CARRY_2_KS32_PBS_TUNIFORM_2M128"])
def test_fingerprints_equal(name):
    p, jp = pm.PARAMS_BY_NAME[name], jparams.PARAMS_BY_NAME[name]
    assert keycache._fingerprint(p) == jkc._fingerprint(jp)
    other = dataclasses.replace(p, ks_level=p.ks_level + 1)
    assert keycache._fingerprint(other) != keycache._fingerprint(p)


def _lut_out(sk, ct):
    out = sk.apply_lookup_table(ct, sk.generate_lookup_table(
        lambda x: (3 * x) % 16))
    return to_u64(out.ct)


def test_directories_byte_equal_and_cross_served(caches):
    """Each package's miss writes the same directory, file for file; each
    reads the other's: the port's hit equals a fresh port key, tfhe_tpu's
    hit equals a fresh tfhe_tpu key."""
    jdir, pdir = caches
    jck, jsk = jkc.get_shortint_keys(jparams.PARAM_TEST_TOY, SEED)
    ck, sk = keycache.get_shortint_keys(pm.PARAM_TEST_TOY, SEED, "cpu")
    (jsub,), (psub,) = list(jdir.iterdir()), list(pdir.iterdir())
    assert jsub.name == psub.name
    assert jsub.name.startswith(f"PARAM_TEST_TOY_s{SEED}_")
    for f in FILES:
        assert (jsub / f).read_bytes() == (psub / f).read_bytes(), f
    ct = ck.encrypt(MSGS)
    np.testing.assert_array_equal(_lut_out(sk, ct), np.asarray(
        jsk.apply_lookup_table(jck.encrypt(MSGS), jsk.generate_lookup_table(
            lambda x: (3 * x) % 16)).ct))

    # swap the directories: each package now hits the other's files
    jkc.clear_memory_cache()
    keycache.clear_memory_cache()
    jkc._DEFAULT_DIR = str(pdir)
    _, jsk2 = jkc.get_shortint_keys(jparams.PARAM_TEST_TOY, SEED)
    np.testing.assert_array_equal(np.asarray(jsk2.bsk_scan),
                                  np.asarray(jsk.bsk_scan))
    np.testing.assert_array_equal(np.asarray(jsk2.ksk_i8),
                                  np.asarray(jsk.ksk_i8))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TFHE_TPU_KEYCACHE", str(jdir))
        ck2, sk2 = keycache.get_shortint_keys(pm.PARAM_TEST_TOY, SEED, "cpu")
    fresh = ServerKey.generate(ClientKey.generate(pm.PARAM_TEST_TOY, SEED,
                                                  device="cpu"))
    for f in ("ksk", "ksk_i8", "bsk_b"):
        assert torch.equal(getattr(sk2, f), getattr(fresh, f)), f
    np.testing.assert_array_equal(to_u32(sk2.crt_key()),
                                  np.asarray(jsk.bsk_scan))
    np.testing.assert_array_equal(_lut_out(sk2, ct), _lut_out(sk, ct))
    np.testing.assert_array_equal(ck2.decrypt(sk2.apply_lookup_table(
        ct, sk2.generate_lookup_table(lambda x: x))), MSGS % 4)


def test_hit_equals_miss(caches):
    _, pdir = caches
    ck, sk = keycache.get_shortint_keys(pm.PARAM_TEST_TOY, SEED, "cpu")
    assert keycache.get_shortint_keys(pm.PARAM_TEST_TOY, SEED,
                                      "cpu")[1] is sk  # memory
    keycache.clear_memory_cache()
    ck2, sk2 = keycache.get_shortint_keys(pm.PARAM_TEST_TOY, SEED, "cpu")
    assert sk2 is not sk and sk2.bsk_scan is not None  # from disk
    for f in ("ksk", "ksk_i8", "bsk_b"):
        assert torch.equal(getattr(sk2, f), getattr(sk, f)), f
    # the miss wrote its CRT key from a temporary and keeps bsk_std
    assert sk.bsk_scan is None and sk.bsk_std is not None
    assert torch.equal(sk2.stored_bsk(), sk.stored_bsk())
    assert torch.equal(ck2.glwe_sk.bits, ck.glwe_sk.bits)
    # encryptions of the hit's client key equal a fresh key's
    fresh = ClientKey.generate(pm.PARAM_TEST_TOY, SEED, device="cpu")
    assert torch.equal(ck2.encrypt(MSGS).ct, fresh.encrypt(MSGS).ct)
    (sub,) = list(pdir.iterdir())
    assert sorted(p.name for p in sub.iterdir()) == sorted(FILES)


def test_multi_bit_key_cached(caches):
    ck, sk = keycache.get_shortint_keys(pm.PARAM_TEST_TOY_MULTI_BIT, SEED,
                                        "cpu")
    keycache.clear_memory_cache()
    _, sk2 = keycache.get_shortint_keys(pm.PARAM_TEST_TOY_MULTI_BIT, SEED,
                                        "cpu")
    assert torch.equal(sk2.bsk_mb, sk.bsk_mb)
    ct = ck.encrypt(MSGS)
    np.testing.assert_array_equal(_lut_out(sk2, ct), _lut_out(sk, ct))


def test_cache_root_read_at_each_call(tmp_path, monkeypatch):
    monkeypatch.setenv("TFHE_TPU_KEYCACHE", str(tmp_path / "elsewhere"))
    assert keycache.cache_root() == tmp_path / "elsewhere"
    monkeypatch.delenv("TFHE_TPU_KEYCACHE")
    assert keycache.cache_root().name == ".keycache"


def test_generate_keys_use_keycache(caches):
    _, pdir = caches
    config = api.ConfigBuilder().use_custom_parameters(
        pm.PARAM_TEST_TOY).with_seed(SEED).build()
    ck, sk = api.generate_keys(config, use_keycache=True, device="cpu")
    assert len(list(pdir.iterdir())) == 1
    keycache.clear_memory_cache()
    ck2, sk2 = api.generate_keys(config, use_keycache=True, device="cpu")
    assert torch.equal(sk2.inner.key.bsk_b, sk.inner.key.bsk_b)
    api.set_server_key(sk2)
    try:
        a, b = api.FheUint8.encrypt(200, ck2), api.FheUint8.encrypt(99, ck2)
        assert (a + b).decrypt(ck) == (200 + 99) % 256
    finally:
        api.unset_server_key()
