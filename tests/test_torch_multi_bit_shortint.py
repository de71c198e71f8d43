"""The port's shortint layer on a multi-bit key against ``tfhe_tpu`` on the
CPU (the kernels' plain versions: K2 u64 -> K5), exactly: server keys from
one client-key seed, ``apply_lookup_table`` over the whole cleartext space
at g = 2, 3, 4 under ``TFHE_NTT_VARIANT`` = v6b and crt and under
``TFHE_V4_ACC=32`` (a multi-bit key ignores all three, in both packages;
the JAX key gets a fresh jit cache per setting, ROADMAP standing note 1),
the shortint OPRF, a compressed multi-bit key decompressed, a JAX key
carried across by ``convert``, and many-LUT on a multi-bit key, which
decrypts right while ``tfhe_tpu`` raises there (ROADMAP standing note 11).
Tolerance: exact."""

import numpy as np
import pytest

from tfhe_tpu.shortint import oprf as joprf
from tfhe_tpu.shortint import server_key as jserver_key
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.compressed_server_key import \
    CompressedServerKey as JCompressedServerKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils import params as jparams

from test_torch_multi_bit import SEED, TOY_N, toy_set
from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import from_u64, to_u32, to_u64
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.shortint import oprf
from tfhe_tpu_torch.shortint.ciphertext import ShortintCiphertext
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.compressed_server_key import CompressedServerKey
from tfhe_tpu_torch.shortint.server_key import ServerKey
from tfhe_tpu_torch.utils import params as pm

MOD = 16  # message x carry modulus of the toy sets
ENVS = {"v6b": {"TFHE_NTT_VARIANT": "v6b"},
        "crt": {"TFHE_NTT_VARIANT": "crt"},
        "acc32": {"TFHE_V4_ACC": "32"}}


@pytest.fixture(scope="module")
def keys():
    """g -> (JAX client key, JAX server key, port client key, port server
    key), from one seed."""
    out = {}
    for g in (2, 3, 4):
        jck = JClientKey.generate(toy_set(jparams, g), seed=SEED)
        ck = ClientKey.generate(toy_set(pm, g), seed=SEED, device="cpu")
        out[g] = (jck, JServerKey.generate(jck), ck, ServerKey.generate(ck))
    return out


def carry_in(jct) -> ShortintCiphertext:
    return ShortintCiphertext(
        ct=from_u64(np.asarray(jct.ct), "cpu"), degree=jct.degree,
        noise_level=jct.noise_level, message_modulus=jct.message_modulus,
        carry_modulus=jct.carry_modulus, under_key=jct.under_key)


def test_server_key_equal(keys):
    """The port's multi-bit key is ``tfhe_tpu``'s residues laid out for K5;
    the KSK is byte-equal; P = 4 (the bound grows by g log2 3 bits)."""
    for g, (jck, jsk, ck, sk) in keys.items():
        assert sk.bsk_mb.shape[3] == (1 << g) - 1
        assert sk.num_primes == jsk.num_primes == 4
        assert sk.variant == jsk.ntt_variant == "crt"
        name, ksk, res, P, zeros = convert.server_key_to_arrays(sk)
        np.testing.assert_array_equal(res, np.asarray(jsk.bsk_scan))
        np.testing.assert_array_equal(ksk, np.asarray(jsk.ksk))
        assert zeros is None and P == 4


@pytest.mark.parametrize("env", list(ENVS))
@pytest.mark.parametrize("g", [2, 3, 4])
def test_apply_lookup_table_equal(keys, g, env, monkeypatch):
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jserver_key, "_jitted_ks_pbs_cache", {})
    jck, jsk, ck, sk = keys[g]
    f = lambda x: (5 * x + 3) % MOD
    jct = jck.encrypt(np.arange(MOD, dtype=np.uint64))
    want = jsk.apply_lookup_table(jct, jsk.generate_lookup_table(f))
    pk.reset_launches()
    got = sk.apply_lookup_table(carry_in(jct),
                                sk.generate_lookup_table(f))
    np.testing.assert_array_equal(to_u64(got.ct), np.asarray(want.ct))
    np.testing.assert_array_equal(ck.decrypt_message_and_carry(got),
                                  [f(x) for x in range(MOD)])
    assert got.degree == want.degree
    assert not any(fn.launches for fn in pk.KERNELS)


def test_chained_lookups_equal(keys):
    """Three LUT rounds on the group-4 key, the second through ``ks_pbs``
    and the others through ``apply_lookup_table``."""
    jck, jsk, ck, sk = keys[4]
    jct = jck.encrypt(np.arange(4, dtype=np.uint64))
    jcur, cur = jct, carry_in(jct)
    for _ in range(3):
        jlut = jsk.generate_msg_lookup_table(lambda x: 3 * x + 1)
        lut = sk.generate_msg_lookup_table(lambda x: 3 * x + 1)
        jcur = jsk.apply_lookup_table(jcur, jlut)
        cur = sk.apply_lookup_table(cur, lut)
        np.testing.assert_array_equal(to_u64(cur.ct), np.asarray(jcur.ct))
    np.testing.assert_array_equal(ck.decrypt(cur), [1, 0, 3, 2])


@pytest.mark.parametrize("bits", [1, 4])
def test_oprf_equal(keys, bits):
    """The shortint OPRF's staircase PBS on the multi-bit key."""
    jck, jsk, ck, sk = keys[2]
    want = joprf.generate_oblivious_pseudo_random(jsk, seed=7,
                                                  random_bits_count=bits)
    got = oprf.generate_oblivious_pseudo_random(sk, seed=7,
                                                random_bits_count=bits)
    np.testing.assert_array_equal(to_u64(got.ct), np.asarray(want.ct))
    assert got.degree == want.degree
    assert 0 <= int(ck.decrypt_message_and_carry(got).item()) < (1 << bits)


@pytest.mark.parametrize("g", [2, 4])
def test_compressed_key_decompresses_equal(g):
    """A compressed multi-bit server key (bodies and stream offsets)
    decompresses to the key ``ServerKey.generate`` makes from a fresh client
    key of the same seed, and to ``tfhe_tpu``'s decompressed key."""
    p, jp = toy_set(pm, g), toy_set(jparams, g)
    csk = CompressedServerKey.generate(
        ClientKey.generate(p, seed=SEED, device="cpu"))
    assert tuple(csk.bsk_bodies.shape) == (TOY_N[g] // g, (1 << g) - 1, 1,
                                           2, 256)
    sk = csk.decompress()
    fresh = ServerKey.generate(ClientKey.generate(p, seed=SEED, device="cpu"))
    assert (sk.bsk_mb == fresh.bsk_mb).all() and (sk.ksk == fresh.ksk).all()
    jsk = JCompressedServerKey.generate(
        JClientKey.generate(jp, seed=SEED)).decompress()
    np.testing.assert_array_equal(to_u32(pk.multi_bit_legacy_layout(
        sk.bsk_mb, 1).contiguous()), np.asarray(jsk.bsk_scan))
    np.testing.assert_array_equal(to_u64(csk.bsk_bodies),
                                  np.asarray(JCompressedServerKey.generate(
                                      JClientKey.generate(jp, seed=SEED))
                                      .bsk_bodies))


def test_key_carried_by_convert_computes_equal(keys):
    """A ``tfhe_tpu`` multi-bit server key carried across as numpy arrays
    computes the JAX outputs."""
    jck, jsk, ck, _ = keys[2]
    sk = convert.server_key_from_arrays(
        "PARAM_TEST_TOY_MULTI_BIT", np.asarray(jsk.ksk),
        np.asarray(jsk.bsk_scan), jsk.num_primes, device="cpu")
    assert sk.bsk_mb is not None and sk.num_primes == 4
    jct = jck.encrypt(np.arange(MOD, dtype=np.uint64))
    f = lambda x: (x * x) % MOD
    want = jsk.apply_lookup_table(jct, jsk.generate_lookup_table(f))
    got = sk.apply_lookup_table(carry_in(jct), sk.generate_lookup_table(f))
    np.testing.assert_array_equal(to_u64(got.ct), np.asarray(want.ct))
    back = convert.server_key_to_arrays(sk)
    np.testing.assert_array_equal(back[2], np.asarray(jsk.bsk_scan))
    with pytest.raises(ValueError, match="residues"):
        convert.server_key_from_arrays(
            "PARAM_TEST_TOY_MULTI_BIT", np.asarray(jsk.ksk),
            np.asarray(jsk.bsk_scan)[:, :3], 4, device="cpu")


@pytest.mark.parametrize("k", [2, 4])
def test_many_lut_on_a_multi_bit_key(keys, k):
    """ONE keyswitch and multi-bit rotation (plain K2 u64 -> K5), then k
    extractions, as tfhe-rs runs it: every output decrypts right.
    ``tfhe_tpu`` raises there (its many-LUT hands the multi-bit key to the
    classic rotation), so the outputs are held by decryption."""
    jck, jsk, ck, sk = keys[2]
    fns = [lambda x, i=i: (x + i) % MOD for i in range(k)]
    many = sk.generate_many_lookup_table(fns)
    vals = np.arange(many.max_input_degree + 1, dtype=np.uint64)
    jct = jck.encrypt(vals)
    ct = carry_in(jct)
    ct.degree = many.max_input_degree
    outs = sk.apply_many_lookup_table(ct, many)
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(ck.decrypt_message_and_carry(out),
                                      [(int(v) + i) % MOD for v in vals])
    jct.degree = many.max_input_degree
    with pytest.raises(ValueError, match="too many values to unpack"):
        jsk.apply_many_lookup_table(jct, jsk.generate_many_lookup_table(fns))
