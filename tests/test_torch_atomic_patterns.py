"""The port's other atomic patterns against tfhe_tpu at the toy sets, on the
CPU (the kernels' plain versions; v6b: plain K2 acc32 -> plain K1):

- KS32 (``PARAM_TEST_TOY_KS32``): the u32-torus keyswitch key and its 4
  int8 limbs, ``keyswitch_mxu32`` (the body rounded to 2^32, the output
  wrapping mod 2^32), the PBS switching from 32 bits;
- PBS -> KS (``PARAM_TEST_TOY_PBS_KS``): small-key ciphertexts, the PBS
  first, then the keyswitch back to the small key;
- ``reference_forks`` keygen (the reference's fork layout and sequential
  gaussian sampler).

Same seed => byte-equal keys and ciphertexts; every LUT round trip, and a
second PBS chained on its output, bit-equal to tfhe_tpu. Keys carried in
and out with ``convert`` equal both. Tolerance: exact. The drift technique
is ``test_torch_drift_ms.py``."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfhe_tpu.ops import server as jserver
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils import params as jparams

from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import from_u64, to_u32, to_u64
from tfhe_tpu_torch.ops import server
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.server_key import ServerKey, is_ks32
from tfhe_tpu_torch.utils import params

M32 = (1 << 32) - 1
NAMES = ("PARAM_TEST_TOY_KS32", "PARAM_TEST_TOY_PBS_KS")


def _keys(name, seed, reference_forks=False):
    jck = JClientKey.generate(getattr(jparams, name), seed=seed)
    ck = ClientKey.generate(getattr(params, name), seed=seed, device="cpu")
    return (jck, JServerKey.generate(jck, reference_forks=reference_forks),
            ck, ServerKey.generate(ck, reference_forks=reference_forks))


@pytest.fixture(scope="module")
def keys():
    return {name: _keys(name, seed) for name, seed in zip(NAMES, (19, 17))}


@pytest.mark.parametrize("name", NAMES)
def test_keys_byte_equal(keys, name):
    jck, jsk, ck, sk = keys[name]
    np.testing.assert_array_equal(to_u64(sk.ksk), np.asarray(jsk.ksk))
    np.testing.assert_array_equal(sk.ksk_i8.numpy(), np.asarray(jsk.ksk_i8))
    assert sk.variant == jsk.ntt_variant == "v6b"
    assert sk.order == jsk._ap_order
    assert is_ks32(sk.params) == JServerKey._is_ks32(jsk.params)
    if name == "PARAM_TEST_TOY_KS32":
        assert to_u64(sk.ksk).max() <= M32 and sk.ksk_i8.shape[1] == 17 * 4


@pytest.mark.parametrize("name", NAMES)
def test_round_trip_and_chain_bit_equal(keys, name):
    jck, jsk, ck, sk = keys[name]
    msgs = np.array([0, 1, 2, 3, 3, 2], dtype=np.uint64)
    jct, ct = jck.encrypt(msgs), ck.encrypt(msgs)
    np.testing.assert_array_equal(to_u64(ct.ct), np.asarray(jct.ct))
    under = "small" if name == "PARAM_TEST_TOY_PBS_KS" else "big"
    assert ct.under_key == jct.under_key == under
    f = lambda x: (3 * x + 1) % 4
    jout = jsk.apply_lookup_table(jct, jsk.generate_lookup_table(f))
    lut = sk.generate_lookup_table(f)
    out = sk.apply_lookup_table(ct, lut)
    np.testing.assert_array_equal(to_u64(out.ct), np.asarray(jout.ct))
    assert out.under_key == jout.under_key == under
    got = ck.decrypt(out)
    np.testing.assert_array_equal(got, [f(int(m)) for m in msgs])
    # a second PBS chained on the output: a valid ciphertext of its key
    jout2 = jsk.apply_lookup_table(jout, jsk.generate_lookup_table(f))
    out2 = sk.apply_lookup_table(out, lut)
    np.testing.assert_array_equal(to_u64(out2.ct), np.asarray(jout2.ct))
    np.testing.assert_array_equal(ck.decrypt(out2),
                                  [f(int(g)) for g in got])
    other = "big" if under == "small" else "small"
    with pytest.raises(ValueError, match=f"expects {under}-key input"):
        sk.apply_lookup_table(replace(out, under_key=other), lut)


def test_pbs_ks_leveled_then_lut(keys):
    jck, jsk, ck, sk = keys["PARAM_TEST_TOY_PBS_KS"]
    a, b = np.array([1, 2], np.uint64), np.array([2, 1], np.uint64)
    js = jsk.unchecked_add(jck.encrypt(a), jck.encrypt(b))
    s = sk.unchecked_add(ck.encrypt(a), ck.encrypt(b))
    jm, m = jsk.message_extract(js), sk.message_extract(s)
    np.testing.assert_array_equal(to_u64(m.ct), np.asarray(jm.ct))
    assert list(ck.decrypt(m)) == [3, 3]


def test_ks32_keyswitch_mod_2_32(keys):
    """keyswitch_mxu32 equals tfhe_tpu's ks_only, and the u32 ciphertext
    decrypts under the small key at modulus 2^32."""
    jck, jsk, ck, sk = keys["PARAM_TEST_TOY_KS32"]
    msgs = np.array([1, 3, 0, 2], dtype=np.uint64)
    jct, ct = jck.encrypt(msgs), ck.encrypt(msgs)
    small = to_u64(sk.keyswitch(ct).ct)
    np.testing.assert_array_equal(small, np.asarray(jsk._fns[2](jct.ct,
                                                                jsk.ksk_i8)))
    np.testing.assert_array_equal(to_u64(sk.ks_only(ct.ct)), small)
    assert small.max() <= M32
    bits = to_u64(ck.lwe_sk.bits).astype(object)
    n = bits.shape[0]
    delta32 = (1 << 32) // 32
    for r, m in enumerate(msgs):
        raw = (int(small[r, n]) - int((small[r, :n].astype(object)
                                       * bits).sum())) % (1 << 32)
        assert ((raw + delta32 // 2) // delta32) % 32 % 16 == int(m)


def test_keyswitch_mxu32_random_inputs():
    """keyswitch_mxu32 and ksk32_to_i8_limbs on random u64 inputs and a
    random u32 key, against tfhe_tpu's (every limb and the body rounding
    at ties)."""
    rng = np.random.default_rng(32)
    n_in, levels, n_out, base_log = 24, 4, 9, 4
    ksk = rng.integers(0, 1 << 32, size=(n_in, levels, n_out + 1),
                       dtype=np.uint64)
    ct = rng.integers(0, 1 << 64, size=(5, n_in + 1), dtype=np.uint64)
    ct[0, -1] = np.uint64((7 << 32) + (1 << 31))  # a tie rounds up
    limbs = server.ksk32_to_i8_limbs(ksk, base_log)
    jlimbs = np.asarray(jserver.ksk32_to_i8_limbs(ksk, base_log))
    np.testing.assert_array_equal(limbs, jlimbs)
    got = server.keyswitch_mxu32(from_u64(ct, "cpu"), torch.from_numpy(limbs),
                                 base_log, levels)
    want = np.asarray(jserver.keyswitch_mxu32(
        jnp.asarray(ct), jnp.asarray(jlimbs), base_log, levels))
    np.testing.assert_array_equal(to_u64(got), want)


@pytest.mark.parametrize("torus_bits", [32, 64])
def test_modulus_switches_from_each_torus(torus_bits):
    rng = np.random.default_rng(torus_bits)
    ct = rng.integers(0, 1 << 64, size=(6, 17), dtype=np.uint64)
    if torus_bits == 32:
        ct &= np.uint64(M32)
    for jfn, fn in ((jserver.lwe_centered_binary_modulus_switch,
                     server.lwe_centered_binary_modulus_switch),
                    (jserver.lwe_standard_modulus_switch,
                     server.lwe_standard_modulus_switch)):
        want = jfn(jnp.asarray(ct), 9, torus_bits)
        got = fn(from_u64(ct, "cpu"), 9, torus_bits)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(to_u64(g), np.asarray(w))


@pytest.mark.parametrize("name", NAMES)
def test_keys_carried_both_ways(keys, name):
    """tfhe_tpu's arrays into the port (the KS32 key as its 4 limbs) give
    the port's own key, and the port's key back out gives tfhe_tpu's
    arrays; the carried key's round trip equals tfhe_tpu's."""
    jck, jsk, ck, sk = keys[name]
    carried = convert.server_key_from_arrays(
        name, np.asarray(jsk.ksk), np.asarray(jsk.bsk_scan), jsk.num_primes,
        device="cpu")
    np.testing.assert_array_equal(carried.ksk_i8.numpy(),
                                  sk.ksk_i8.numpy())
    np.testing.assert_array_equal(to_u32(carried.bsk_b), to_u32(sk.bsk_b))
    out_name, ksk, scan, nprimes, zeros = convert.server_key_to_arrays(sk)
    assert (out_name, nprimes, zeros) == (name, jsk.num_primes, None)
    np.testing.assert_array_equal(ksk, np.asarray(jsk.ksk))
    np.testing.assert_array_equal(scan, np.asarray(jsk.bsk_scan))
    cname, glwe_bits, lwe_bits = convert.client_key_to_arrays(ck)
    cck = convert.client_key_from_arrays(cname, glwe_bits, lwe_bits,
                                         device="cpu")
    np.testing.assert_array_equal(glwe_bits, np.asarray(jck.glwe_sk.bits))
    np.testing.assert_array_equal(lwe_bits, np.asarray(jck.lwe_sk.bits))
    msgs = np.array([2, 1], dtype=np.uint64)
    jct = jck.encrypt(msgs)
    jout = jsk.apply_lookup_table(jct, jsk.generate_lookup_table(
        lambda x: x ^ 1))
    ct = ck.encrypt(msgs)  # the same stream position as jct
    np.testing.assert_array_equal(to_u64(ct.ct), np.asarray(jct.ct))
    out = carried.apply_lookup_table(ct, carried.generate_lookup_table(
        lambda x: x ^ 1))
    np.testing.assert_array_equal(to_u64(out.ct), np.asarray(jout.ct))
    assert list(cck.decrypt(out)) == [3, 0]


def test_reference_forks_keygen_byte_equal():
    """ServerKey.generate(reference_forks=True): the BSK drawn with the
    reference's fork layout equals tfhe_tpu's (its BNF2 and CRT forms),
    and a LUT round trip on it is bit-equal."""
    from tfhe_tpu.ops import bnf2 as jb2

    jck, jsk, ck, sk = _keys("PARAM_TEST_TOY", 23, reference_forks=True)
    np.testing.assert_array_equal(to_u32(sk.bsk_b),
                                  np.asarray(jsk._bsk_b(jb2.FAST28)))
    np.testing.assert_array_equal(to_u32(sk.crt_key()),
                                  np.asarray(jsk.bsk_scan))
    np.testing.assert_array_equal(to_u64(sk.ksk), np.asarray(jsk.ksk))
    plain = ServerKey.generate(ClientKey.generate(params.PARAM_TEST_TOY,
                                                  seed=23, device="cpu"))
    assert not np.array_equal(to_u32(plain.bsk_b), to_u32(sk.bsk_b))
    msgs = np.arange(4, dtype=np.uint64)
    f = lambda x: (x + 3) % 16
    jout = jsk.apply_lookup_table(jck.encrypt(msgs),
                                  jsk.generate_lookup_table(f))
    out = sk.apply_lookup_table(ck.encrypt(msgs), sk.generate_lookup_table(f))
    np.testing.assert_array_equal(to_u64(out.ct), np.asarray(jout.ct))
