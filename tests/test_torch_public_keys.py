"""The port's public keys and keyset casting against tfhe_tpu at
PARAM_TEST_TOY on the CPU: ``shortint.public_key`` (the subset-sum public
key), ``shortint.compact_public_key`` (compact lists and their expansion),
``shortint.key_switching_key`` (casting, re-randomization) and the
keyswitch of any base log under them (``ops/server.py::keyswitch_mxu``).

The toy compact-PK and casting sets are ``tests/test_cpk_ksk.py``'s
(``TOY_PKE``, ``TOY_KS``), built from each package's own classes. Same
seeds => byte-equal keys; the encryption randomness comes from equal
seeded generators. Tolerance: exact (integer arithmetic). Every output
also decrypts to its clear value.
"""

import numpy as np
import pytest
import torch

from tfhe_tpu.ops import server as jserver
from tfhe_tpu.shortint import compact_public_key as jcpk
from tfhe_tpu.shortint import key_switching_key as jksk
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.public_key import PublicKey as JPublicKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils import csprng as jcsprng
from tfhe_tpu.utils import params as jparams

from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import from_u64, to_u64
from tfhe_tpu_torch.ops import server as server_ops
from tfhe_tpu_torch.shortint import compact_public_key as cpk
from tfhe_tpu_torch.shortint import key_switching_key as kskm
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.public_key import PublicKey
from tfhe_tpu_torch.shortint.server_key import ServerKey
from tfhe_tpu_torch.utils import csprng
from tfhe_tpu_torch.utils import params as pm


def toy_sets(m, destination="BIG"):
    """``tests/test_cpk_ksk.py``'s TOY_PKE and TOY_KS from the params
    module ``m`` (the port's or tfhe_tpu's); ``destination`` SMALL casts
    onto the small key."""
    pke = m.CompactPublicKeyEncryptionParameters(
        encryption_lwe_dimension=64,
        encryption_noise_distribution=m.DynamicDistribution.t_uniform(3),
        message_modulus=4, carry_modulus=4, name="TOY_PKE")
    ks = m.ShortintKeySwitchingParameters(
        ks_base_log=3, ks_level=5,
        destination_key=getattr(m.EncryptionKeyChoice, destination),
        name="TOY_KS")
    return pke, ks


@pytest.fixture(scope="module")
def keys():
    """Compute keys at seed 7, compact keys at seed 8, the casting key onto
    the big key (tests/test_cpk_ksk.py's seeds)."""
    jck = JClientKey.generate(jparams.PARAM_TEST_TOY, seed=7)
    jsk = JServerKey.generate(jck)
    ck = ClientKey.generate(pm.PARAM_TEST_TOY, seed=7, device="cpu")
    sk = ServerKey.generate(ck)
    (jpke, jks), (pke, ks) = toy_sets(jparams), toy_sets(pm)
    jpriv = jcpk.CompactPrivateKey.generate(jpke, seed=8)
    priv = cpk.CompactPrivateKey.generate(pke, seed=8, device="cpu")
    jpk, pk = jcpk.CompactPublicKey.generate(jpriv), \
        cpk.CompactPublicKey.generate(priv)
    jk = jksk.KeySwitchingKey.generate(jpriv, jck, jsk, jks)
    k = kskm.KeySwitchingKey.generate(priv, ck, sk, ks)
    return dict(jck=jck, jsk=jsk, ck=ck, sk=sk, jpriv=jpriv, priv=priv,
                jpk=jpk, pk=pk, jk=jk, k=k, pke=pke, ks=ks)


def eq(t, j):
    np.testing.assert_array_equal(to_u64(t), np.asarray(j))


# -- the public key -------------------------------------------------------------

def test_public_key_byte_equal_and_encrypts(keys):
    jpub, pub = JPublicKey.generate(keys["jck"]), PublicKey.generate(
        keys["ck"])
    assert tuple(pub.zeros.shape) == ((256 + 1) * 64 + 128, 257)
    eq(pub.zeros, jpub.zeros)
    msgs = np.array([0, 1, 2, 3], dtype=np.uint64)
    jct = jpub.encrypt(msgs, rng=np.random.default_rng(5))
    ct = pub.encrypt(msgs, rng=np.random.default_rng(5))
    eq(ct.ct, jct.ct)
    assert (ct.under_key, ct.degree) == (jct.under_key, jct.degree)
    np.testing.assert_array_equal(keys["ck"].decrypt(ct), msgs)
    # the AES-CTR selection stream
    jct = jpub.encrypt(3, rng=jcsprng.AesCtrGenerator(seed=9))
    ct = pub.encrypt(3, rng=csprng.AesCtrGenerator(seed=9))
    eq(ct.ct, jct.ct)
    assert keys["ck"].decrypt(ct) == 3
    carried = convert.public_key_from_arrays(pm.PARAM_TEST_TOY.name,
                                             np.asarray(jpub.zeros), "cpu")
    eq(carried.encrypt([1, 2], rng=np.random.default_rng(6)).ct,
       jpub.encrypt([1, 2], rng=np.random.default_rng(6)).ct)


# -- compact public key and lists --------------------------------------------------

def test_compact_keys_byte_equal(keys):
    eq(keys["priv"].lwe_sk.bits, keys["jpriv"].lwe_sk.bits)
    eq(keys["pk"].mask, keys["jpk"].mask)
    eq(keys["pk"].body, keys["jpk"].body)
    eq(keys["k"].ksk, keys["jk"].ksk)
    assert (keys["k"].cast_rshift, keys["k"].dest_under) == (
        keys["jk"].cast_rshift, keys["jk"].dest_under)


@pytest.mark.parametrize("count", [10, 130])
def test_compact_list_encrypt_expand(keys, count):
    """One bin of 64, and three (the last part-filled)."""
    msgs = np.arange(count, dtype=np.uint64) % 4
    jl = keys["jpk"].encrypt(msgs, rng=jcsprng.EncryptionRandomGenerator(1, 2))
    lst = keys["pk"].encrypt(msgs, rng=csprng.EncryptionRandomGenerator(1, 2))
    assert tuple(lst.masks.shape) == (-(-count // 64), 64)
    eq(lst.masks, jl.masks)
    eq(lst.bodies, jl.bodies)
    expanded = lst.expand()
    eq(expanded, jl.expand())
    np.testing.assert_array_equal(keys["priv"].decrypt_expanded(expanded),
                                  msgs)
    sct = lst.expand_to_shortint()
    assert (sct.under_key, sct.degree) == ("pke", 3)


def test_cast_pke_to_compute(keys):
    """Expand, keyswitch onto the big key, refresh by apply_lookup_table;
    then a LUT on the cast ciphertexts."""
    msgs = np.array([0, 1, 2, 3], dtype=np.uint64)
    jl = keys["jpk"].encrypt(msgs, rng=jcsprng.EncryptionRandomGenerator(3, 4))
    lst = keys["pk"].encrypt(msgs, rng=csprng.EncryptionRandomGenerator(3, 4))
    jout = keys["jk"].cast(jl.expand_to_shortint())
    out = keys["k"].cast(lst.expand_to_shortint())
    eq(out.ct, jout.ct)
    assert out.under_key == "big"
    np.testing.assert_array_equal(keys["ck"].decrypt(out), msgs)
    lut = keys["sk"].generate_lookup_table(lambda x: (x + 1) % 4)
    np.testing.assert_array_equal(
        keys["ck"].decrypt(keys["sk"].apply_lookup_table(out, lut)),
        (msgs + 1) % 4)
    carried = convert.key_switching_key_from_arrays(
        keys["ks"], np.asarray(keys["jk"].ksk), keys["sk"], "big", 0)
    eq(carried.cast(lst.expand_to_shortint()).ct, jout.ct)


def test_cast_pke_to_small_key(keys):
    """A casting key onto the small key: the refresh is pbs_only."""
    (jpke, jks), (pke, ks) = toy_sets(jparams, "SMALL"), toy_sets(pm, "SMALL")
    jk = jksk.KeySwitchingKey.generate(keys["jpriv"], keys["jck"],
                                       keys["jsk"], jks)
    k = kskm.KeySwitchingKey.generate(keys["priv"], keys["ck"], keys["sk"],
                                      ks)
    eq(k.ksk, jk.ksk)
    msgs = np.array([3, 2, 1], dtype=np.uint64)
    jl = keys["jpk"].encrypt(msgs, rng=jcsprng.EncryptionRandomGenerator(5, 6))
    lst = keys["pk"].encrypt(msgs, rng=csprng.EncryptionRandomGenerator(5, 6))
    jout, out = jk.cast(jl.expand_to_shortint()), k.cast(
        lst.expand_to_shortint())
    eq(out.ct, jout.ct)
    np.testing.assert_array_equal(keys["ck"].decrypt(out), msgs)


def test_cast_compute_to_compute(keys):
    """From the seed-7 keyset to a seed-99 one (the source server key
    rides along for a pre-shift that this cast does not need)."""
    _, jks = toy_sets(jparams)
    _, ks = toy_sets(pm)
    jck2 = JClientKey.generate(jparams.PARAM_TEST_TOY, seed=99)
    ck2 = ClientKey.generate(pm.PARAM_TEST_TOY, seed=99, device="cpu")
    jsk2, sk2 = JServerKey.generate(jck2), ServerKey.generate(ck2)
    jk = jksk.KeySwitchingKey.generate(keys["jck"], jck2, jsk2, jks,
                                       src_server=keys["jsk"])
    k = kskm.KeySwitchingKey.generate(keys["ck"], ck2, sk2, ks,
                                      src_server=keys["sk"])
    eq(k.ksk, jk.ksk)
    msgs = np.array([3, 1], dtype=np.uint64)
    jout = jk.cast(keys["jck"].encrypt(msgs))
    out = k.cast(keys["ck"].encrypt(msgs))
    eq(out.ct, jout.ct)
    np.testing.assert_array_equal(ck2.decrypt(out), msgs)


def test_re_randomization(keys):
    msgs = np.array([2, 3], dtype=np.uint64)
    jct = keys["jsk"].message_extract(keys["jck"].encrypt(msgs))
    ct = keys["sk"].message_extract(keys["ck"].encrypt(msgs))
    eq(ct.ct, jct.ct)
    (jrr,) = jksk.re_randomize_ciphertexts([jct], cpk=keys["jpk"],
                                           ksk=keys["jk"], seed=1234)
    (rr,) = kskm.re_randomize_ciphertexts([ct], cpk=keys["pk"],
                                          ksk=keys["k"], seed=1234)
    eq(rr.ct, jrr.ct)
    np.testing.assert_array_equal(keys["ck"].decrypt(rr), msgs)
    assert not torch.equal(rr.ct, ct.ct)
    (rr2,) = kskm.re_randomize_ciphertexts([ct], cpk=keys["pk"],
                                           ksk=keys["k"], seed=1234)
    assert torch.equal(rr.ct, rr2.ct)
    carried = convert.compact_public_key_from_arrays(
        keys["pke"], keys["jpk"].mask, keys["jpk"].body, "cpu")
    (rr3,) = kskm.re_randomize_ciphertexts([ct], cpk=carried, ksk=keys["k"],
                                           seed=1234)
    assert torch.equal(rr.ct, rr3.ct)
    priv = convert.compact_private_key_from_arrays(
        keys["pke"], np.asarray(keys["jpriv"].lwe_sk.bits), "cpu")
    lst = keys["pk"].encrypt([1, 2])
    np.testing.assert_array_equal(priv.decrypt_expanded(lst.expand()), [1, 2])


# -- the keyswitch of any base log ------------------------------------------------

@pytest.mark.parametrize("base_log,levels", [(3, 5), (7, 2), (8, 2), (12, 2),
                                             (24, 1)])
def test_keyswitch_any_base_log(base_log, levels):
    """ops/server.py::keyswitch_mxu (one int8 GEMM a digit limb, one in
    all up to base log 7) against tfhe_tpu's generic keyswitch on random
    u64 inputs and a random u64 key, and against tfhe_tpu's keyswitch_mxu
    with its limbs where that one applies (base_log <= 7). (24, 1) is the
    V1_5 PKE -> big re-randomization key's shape."""
    rng = np.random.default_rng(base_log)
    n_in, n_out, B = 64, 40, 5
    ct = rng.integers(0, 1 << 64, size=(B, n_in + 1), dtype=np.uint64)
    ksk = rng.integers(0, 1 << 64, size=(n_in, levels, n_out + 1),
                       dtype=np.uint64)
    want = np.asarray(jserver.keyswitch(ct, ksk, base_log, levels))
    limbs = kskm.ksk_limbs(from_u64(ksk, "cpu"))
    eq(server_ops.keyswitch_mxu(from_u64(ct, "cpu"), limbs, base_log,
                                levels), want)
    if base_log <= 7:
        jlimbs = np.asarray(jserver.ksk_to_i8_limbs(ksk, base_log))
        np.testing.assert_array_equal(limbs.numpy(), jlimbs)
        np.testing.assert_array_equal(
            server_ops.ksk_to_i8_limbs(ksk, base_log), jlimbs)
        eq(server_ops.keyswitch_mxu(from_u64(ct, "cpu"), limbs, base_log,
                                    levels),
           jserver.keyswitch_mxu(ct, jlimbs, base_log, levels))


def test_shortint_exports_match_jax():
    """``tfhe_tpu_torch.shortint`` exports ``tfhe_tpu.shortint``'s names,
    the noise-squashing ones as the port's classes and function of the
    squashing modules; ``gen_keys`` gives ClientKey.generate's key."""
    import tfhe_tpu.shortint as jshortint

    import tfhe_tpu_torch.shortint as shortint
    from tfhe_tpu_torch.shortint import noise_squashing as ns
    from tfhe_tpu_torch.shortint import noise_squashing_compression as nsc

    assert set(shortint.__all__) == set(jshortint.__all__)
    assert all(hasattr(shortint, n) for n in shortint.__all__)
    for mod, names in ((ns, ("NoiseSquashingKey", "NoiseSquashingPrivateKey",
                             "SquashedNoiseCiphertext")),
                       (nsc, ("CompressedSquashedNoiseCiphertextList",
                              "NoiseSquashingCompressionKey",
                              "NoiseSquashingCompressionPrivateKey",
                              "compress_noise_squashed_ciphertexts_into_"
                              "list"))):
        for n in names:
            assert getattr(shortint, n) is getattr(mod, n), n
            assert getattr(jshortint, n).__name__ == n
    ck, sk = shortint.gen_keys(pm.PARAM_TEST_TOY, seed=3, device="cpu")
    assert torch.equal(ck.lwe_sk.bits, ClientKey.generate(
        pm.PARAM_TEST_TOY, seed=3, device="cpu").lwe_sk.bits)
    assert sk.params is pm.PARAM_TEST_TOY
