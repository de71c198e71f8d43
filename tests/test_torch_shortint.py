"""The port's shortint main path against tfhe_tpu at PARAM_TEST_TOY, on the
CPU (the kernels' plain versions): same seed => byte-equal keys and
ciphertexts, key conversion, variant resolution, and apply_lookup_table
bit-equal to tfhe_tpu on all 16 message+carry inputs. Tolerance: exact
(integer arithmetic throughout)."""

import numpy as np
import pytest

from tfhe_tpu.ops import bnf2 as jb2
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils.params import PARAM_TEST_TOY as JP

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import from_u64, to_u32, to_u64
from tfhe_tpu_torch.shortint.ciphertext import ShortintCiphertext
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.server_key import ServerKey
from tfhe_tpu_torch.utils.params import PARAM_TEST_TOY as P

SEED = 20261016


@pytest.fixture(scope="module")
def keys():
    jck = JClientKey.generate(JP, seed=SEED)
    jsk = JServerKey.generate(jck)
    ck = ClientKey.generate(P, seed=SEED, device="cpu")
    sk = ServerKey.generate(ck)
    return jck, jsk, ck, sk


def test_same_seed_keys_byte_equal(keys):
    jck, jsk, ck, sk = keys
    np.testing.assert_array_equal(to_u64(ck.glwe_sk.bits),
                                  np.asarray(jck.glwe_sk.bits))
    np.testing.assert_array_equal(to_u64(ck.lwe_sk.bits),
                                  np.asarray(jck.lwe_sk.bits))
    np.testing.assert_array_equal(to_u64(sk.ksk), np.asarray(jsk.ksk))
    np.testing.assert_array_equal(sk.ksk_i8.numpy(), np.asarray(jsk.ksk_i8))
    np.testing.assert_array_equal(to_u32(sk.bsk_b),
                                  np.asarray(jsk._bsk_b(jb2.FAST28)))


def test_ntt_variant_equal(keys):
    _, jsk, _, sk = keys
    assert sk.ntt_variant == jsk.ntt_variant == "v6b"


def test_same_seed_encryption_byte_equal():
    jck = JClientKey.generate(JP, seed=7)
    ck = ClientKey.generate(P, seed=7, device="cpu")
    vals = np.arange(16, dtype=np.uint64)
    np.testing.assert_array_equal(to_u64(ck.encrypt(vals).ct),
                                  np.asarray(jck.encrypt(vals).ct))
    np.testing.assert_array_equal(to_u64(ck.encrypt(5).ct),
                                  np.asarray(jck.encrypt(5).ct))


def test_convert_round_trip(keys):
    jck, jsk, ck, sk = keys
    ck2 = convert.client_key_from_arrays(
        P.name, np.asarray(jck.glwe_sk.bits), np.asarray(jck.lwe_sk.bits),
        device="cpu")
    sk2 = convert.server_key_from_arrays(
        P.name, np.asarray(jsk.ksk), np.asarray(jsk.bsk_scan),
        jsk.num_primes, device="cpu")
    assert sk2.variant == sk.variant
    np.testing.assert_array_equal(to_u64(sk2.ksk), to_u64(sk.ksk))
    np.testing.assert_array_equal(sk2.ksk_i8.numpy(), sk.ksk_i8.numpy())
    np.testing.assert_array_equal(to_u32(sk2.bsk_b), to_u32(sk.bsk_b))
    np.testing.assert_array_equal(to_u64(ck2.glwe_sk.bits),
                                  to_u64(ck.glwe_sk.bits))
    np.testing.assert_array_equal(to_u64(ck2.lwe_sk.bits),
                                  to_u64(ck.lwe_sk.bits))
    vals = np.arange(16, dtype=np.uint64)
    np.testing.assert_array_equal(
        ck2.decrypt_message_and_carry(ck.encrypt(vals)), vals)
    with pytest.raises(ValueError, match="seed"):
        ck2.encrypt(vals)


def test_apply_lookup_table_bit_equal(keys):
    jck, jsk, ck, sk = keys
    mod = JP.message_modulus * JP.carry_modulus
    f = lambda x: (3 * x + 1) % mod
    vals = np.arange(mod, dtype=np.uint64)
    jct = jck.encrypt(vals)
    jout = jsk.apply_lookup_table(jct, jsk.generate_lookup_table(f))
    lut = sk.generate_lookup_table(f)
    np.testing.assert_array_equal(to_u64(lut.acc),
                                  np.asarray(jsk.generate_lookup_table(f).acc))
    ct = ShortintCiphertext(ct=from_u64(np.asarray(jct.ct), "cpu"),
                            degree=jct.degree, noise_level=jct.noise_level,
                            message_modulus=jct.message_modulus,
                            carry_modulus=jct.carry_modulus)
    out = sk.apply_lookup_table(ct, lut)
    np.testing.assert_array_equal(to_u64(out.ct), np.asarray(jout.ct))
    want = np.array([f(int(v)) for v in vals], dtype=np.uint64)
    np.testing.assert_array_equal(ck.decrypt_message_and_carry(out), want)
    np.testing.assert_array_equal(ck.decrypt(out), want % P.message_modulus)
    assert out.degree == jout.degree


def test_keyswitch_and_message_extract(keys):
    jck, jsk, ck, sk = keys
    vals = np.arange(16, dtype=np.uint64)
    jct = jck.encrypt(vals)
    ct = ShortintCiphertext(ct=from_u64(np.asarray(jct.ct), "cpu"),
                            degree=15, noise_level=1, message_modulus=4,
                            carry_modulus=4)
    np.testing.assert_array_equal(to_u64(sk.keyswitch(ct).ct),
                                  np.asarray(jsk.keyswitch(jct).ct))
    out = sk.message_extract(ct)
    np.testing.assert_array_equal(to_u64(out.ct),
                                  np.asarray(jsk.message_extract(jct).ct))
    np.testing.assert_array_equal(ck.decrypt_message_and_carry(out), vals % 4)
