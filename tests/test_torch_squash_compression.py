"""The port's compression of noise-squashed ciphertexts
(``tfhe_tpu_torch.shortint.noise_squashing_compression``) and the HLAPI
squashing entries against tfhe_tpu at PARAM_TEST_TOY with
PARAM_TEST_TOY_SQUASH and ``tests/test_squash_compression.py``'s
TOY_SQUASH_COMP, on the CPU. Same seed => bit-equal keys. Tolerance:
exact (integer arithmetic).

- the compression private key and the packing key's NTT residues (7
  primes at base 2^61 and n_in = 256) bit-equal;
- the packed GLWEs bit-equal on the same squashed inputs (one batched
  ciphertext, or several), ``unpack`` equal to a Python-int exact
  extraction, every unpacked value decrypting to its input; the empty
  list;
- the HLAPI flow of ``tests/test_squash_compression.py``: keys from
  ``generate_keys`` under a squash config equal to tfhe_tpu's (the draw
  order: the squashing private key before the server key), ``squash_noise``,
  the list builder, ``get(i).decrypt_with_compression_key``.
"""

import numpy as np
import pytest
import torch

from tfhe_tpu.high_level_api import api as japi
from tfhe_tpu.shortint import noise_squashing as jns
from tfhe_tpu.shortint import noise_squashing_compression as jnsc
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.utils import params as jpm

from test_squash_compression import TOY_SQUASH_COMP as JCOMP
from test_torch_noise_squashing import exact_extract, u128
from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import to_u32, to_u64
from tfhe_tpu_torch.high_level_api import api
from tfhe_tpu_torch.shortint import noise_squashing as ns
from tfhe_tpu_torch.shortint import noise_squashing_compression as nsc
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.server_key import ServerKey
from tfhe_tpu_torch.utils import params as pm

SEED = 123  # tests/test_squash_compression.py's key seed
MSGS = np.array([0, 1, 2, 3, 3, 1], dtype=np.uint64)
COMP = pm.NoiseSquashingCompressionParameters(
    packing_ks_level=1, packing_ks_base_log=61, packing_ks_polynomial_size=256,
    packing_ks_glwe_dimension=1, lwe_per_glwe=4,
    packing_ks_key_noise_distribution=pm.DynamicDistribution.t_uniform(3),
    message_modulus=4, carry_modulus=4)


@pytest.fixture(scope="module")
def keys():
    """The client key, the squashing private key, then the compression keys,
    drawn in this order in both packages; the port's server and squashing
    keys after them."""
    jck = JClientKey.generate(jpm.PARAM_TEST_TOY, seed=SEED)
    jpriv = jns.NoiseSquashingPrivateKey.generate(
        jck, jpm.PARAM_TEST_TOY_SQUASH)
    jcpriv = jnsc.NoiseSquashingCompressionPrivateKey.generate(jck, JCOMP)
    jckey = jnsc.NoiseSquashingCompressionKey.generate(jck, jpriv, jcpriv)
    ck = ClientKey.generate(pm.PARAM_TEST_TOY, seed=SEED, device="cpu")
    priv = ns.NoiseSquashingPrivateKey.generate(ck, pm.PARAM_TEST_TOY_SQUASH)
    cpriv = nsc.NoiseSquashingCompressionPrivateKey.generate(ck, COMP)
    ckey = nsc.NoiseSquashingCompressionKey.generate(ck, priv, cpriv)
    sk = ServerKey.generate(ck)
    nsk = ns.NoiseSquashingKey.generate(ck, priv)
    return dict(jck=jck, jpriv=jpriv, jcpriv=jcpriv, jckey=jckey, ck=ck,
                priv=priv, cpriv=cpriv, ckey=ckey, sk=sk, nsk=nsk)


def to_jax(ct: ns.SquashedNoiseCiphertext) -> jns.SquashedNoiseCiphertext:
    return jns.SquashedNoiseCiphertext(
        hi=to_u64(ct.hi), lo=to_u64(ct.lo), degree=ct.degree,
        message_modulus=ct.message_modulus, carry_modulus=ct.carry_modulus)


@pytest.fixture(scope="module")
def packed(keys):
    """MSGS squashed by the port, then packed in both packages (the same
    squashed inputs): 6 LWEs at 4 a GLWE, 2 GLWEs."""
    squashed = keys["nsk"].squash_ciphertext_noise(
        keys["sk"], keys["ck"].encrypt(MSGS))
    jlist = jnsc.compress_noise_squashed_ciphertexts_into_list(
        keys["jckey"], [to_jax(squashed)])
    plist = nsc.compress_noise_squashed_ciphertexts_into_list(keys["ckey"],
                                                              [squashed])
    return squashed, jlist, plist


def test_compression_keys_bit_equal(keys):
    np.testing.assert_array_equal(to_u64(keys["cpriv"].glwe_sk.bits),
                                  np.asarray(keys["jcpriv"].glwe_sk.bits))
    ckey, jckey = keys["ckey"], keys["jckey"]
    assert (ckey.num_primes, ckey.in_dim) == (jckey.num_primes,
                                              jckey.in_dim) == (7, 256)
    assert ckey.pksk_hat.dtype == torch.int32
    np.testing.assert_array_equal(to_u32(ckey.pksk_hat),
                                  np.asarray(jckey.pksk_hat))


def test_packed_glwes_bit_equal(packed):
    squashed, jlist, plist = packed
    assert len(plist) == len(jlist) == len(MSGS)
    assert plist.glwe_hi.shape == (2, 2, 256)
    np.testing.assert_array_equal(to_u64(plist.glwe_hi), jlist.glwe_hi)
    np.testing.assert_array_equal(to_u64(plist.glwe_lo), jlist.glwe_lo)
    assert plist.degrees == jlist.degrees == [squashed.degree] * len(MSGS)


@pytest.mark.parametrize("index", range(len(MSGS)))
def test_unpack_decrypts(keys, packed, index):
    """Each entry is the exact extraction of its GLWE's coefficient (GLWE
    index // 4, coefficient index % 4) and decrypts to its value under the
    compression private key; tfhe_tpu's limb-wise extraction of the same
    list differs only in the hi limbs (ROADMAP standing note 14)."""
    _, jlist, plist = packed
    ct = plist.unpack(index)
    g, nth = divmod(index, 4)
    want = exact_extract(to_u64(plist.glwe_hi[g])[None],
                         to_u64(plist.glwe_lo[g])[None], nth)[0]
    assert (u128(to_u64(ct.hi), to_u64(ct.lo)) == want).all()
    assert keys["cpriv"].decrypt(ct) == [int(MSGS[index])]
    jct = jlist.unpack(index)
    np.testing.assert_array_equal(to_u64(ct.lo), np.asarray(jct.lo))
    assert ct.hi[-1] == int(np.asarray(jct.hi)[-1].astype(np.int64))


def test_several_inputs(keys):
    """A batched and a single squashed ciphertext into one list: the rows
    in order, each with its own degree, bit-equal to tfhe_tpu's."""
    ck, sk, nsk = keys["ck"], keys["sk"], keys["nsk"]
    a = nsk.squash_ciphertext_noise(sk, ck.encrypt([3, 2, 1]))
    b = nsk.squash_ciphertext_noise(
        sk, sk.unchecked_add(ck.encrypt([2]), ck.encrypt([3])))
    plist = nsc.compress_noise_squashed_ciphertexts_into_list(keys["ckey"],
                                                              [a, b])
    jlist = jnsc.compress_noise_squashed_ciphertexts_into_list(
        keys["jckey"], [to_jax(a), to_jax(b)])
    np.testing.assert_array_equal(to_u64(plist.glwe_hi), jlist.glwe_hi)
    np.testing.assert_array_equal(to_u64(plist.glwe_lo), jlist.glwe_lo)
    assert plist.degrees == jlist.degrees == [3, 3, 3, 6]
    assert [keys["cpriv"].decrypt(plist.unpack(i))[0] for i in range(4)] \
        == [3, 2, 1, 5]


def test_empty_list(keys):
    plist = nsc.compress_noise_squashed_ciphertexts_into_list(keys["ckey"],
                                                              [])
    jlist = jnsc.compress_noise_squashed_ciphertexts_into_list(keys["jckey"],
                                                               [])
    assert len(plist) == len(jlist) == 0
    assert plist.glwe_hi.shape == jlist.glwe_hi.shape == (0, 2, 256)
    with pytest.raises(IndexError):
        plist.unpack(0)


def test_convert_list_and_keys(keys, packed):
    """tfhe_tpu's packing key and list carried in by ``convert``: the same
    list, the same packing."""
    _, jlist, plist = packed
    jckey, jcpriv = keys["jckey"], keys["jcpriv"]
    cpriv, ckey = convert.squash_compression_keys_from_arrays(
        COMP, np.asarray(jcpriv.glwe_sk.bits), np.asarray(jckey.pksk_hat),
        jckey.in_dim, device="cpu")
    lst = convert.compressed_squashed_list_from_arrays(
        COMP, jlist.glwe_hi, jlist.glwe_lo, jlist.count,
        jlist.message_modulus, jlist.carry_modulus, jlist.degrees,
        device="cpu")
    assert torch.equal(lst.glwe_hi, plist.glwe_hi)
    assert [cpriv.decrypt(lst.unpack(i))[0] for i in range(len(MSGS))] \
        == list(MSGS)
    again = nsc.compress_noise_squashed_ciphertexts_into_list(
        ckey, [packed[0]])
    assert torch.equal(again.glwe_lo, plist.glwe_lo)


# -- the HLAPI --------------------------------------------------------------------

def _config(mod, params, squash, comp):
    return mod.Config(params, seed=11, noise_squashing_parameters=squash,
                      noise_squashing_compression_parameters=comp)


@pytest.fixture(scope="module")
def hl_keys():
    jck, jsk = japi.generate_keys(_config(
        japi, jpm.PARAM_TEST_TOY, jpm.PARAM_TEST_TOY_SQUASH, JCOMP))
    ck, sk = api.generate_keys(_config(
        api, pm.PARAM_TEST_TOY, pm.PARAM_TEST_TOY_SQUASH, COMP), device="cpu")
    return jck, jsk, ck, sk


def test_hlapi_keys_equal_under_a_squash_config(hl_keys):
    """Every key of ``generate_keys`` equals tfhe_tpu's: the squashing
    private key drawn in ``ClientKey.generate``, then the compute keys,
    the squashing key, the compression keys."""
    jck, jsk, ck, sk = hl_keys
    pairs = [
        (ck.inner.key.lwe_sk.bits, jck.inner.key.lwe_sk.bits),
        (ck.noise_squashing_private_key.glwe_sk.bits,
         jck.noise_squashing_private_key.glwe_sk.bits),
        (ck.noise_squashing_compression_private_key.glwe_sk.bits,
         jck.noise_squashing_compression_private_key.glwe_sk.bits),
        (sk.inner.key.ksk, jsk.inner.key.ksk)]
    for got, want in pairs:
        np.testing.assert_array_equal(to_u64(got), np.asarray(want))
    np.testing.assert_array_equal(to_u32(sk.inner.key.stored_bsk()),
                                  np.asarray(jsk.inner.key.bsk_scan))
    np.testing.assert_array_equal(to_u32(sk.noise_squashing_key.bsk_res),
                                  np.asarray(jsk.noise_squashing_key.bsk_res))
    np.testing.assert_array_equal(
        to_u32(sk.noise_squashing_compression_key.pksk_hat),
        np.asarray(jsk.noise_squashing_compression_key.pksk_hat))
    # without a squash config the compute keys are drawn first: other keys
    plain_ck = api.ClientKey.generate(api.Config(pm.PARAM_TEST_TOY, seed=11),
                                      device="cpu")
    assert plain_ck.noise_squashing_private_key is None


def test_hlapi_compressed_squashed_list(hl_keys):
    """tests/test_squash_compression.py's flow: squash -> pack into a
    compressed list -> unpack (no PBS) -> decrypt; the squashed values also
    decrypt under the squashing private key."""
    _, _, ck, sk = hl_keys
    api.set_server_key(sk)
    try:
        a = api.FheUint8.encrypt(200, ck)
        b = api.FheUint8.encrypt(55, ck)
        sa, sb = a.squash_noise(), b.squash_noise()
        assert isinstance(sa, api.SquashedNoiseFheUint)
        assert sa.squashed.hi.shape == (4, 257)
        assert (sa.decrypt(ck), sb.decrypt(ck)) == (200, 55)
        packed = (api.CompressedSquashedNoiseCiphertextList.builder()
                  .push(sa).push(sb).build())
        assert len(packed) == 2 and len(packed.inner) == 8
        assert packed.get(0).decrypt_with_compression_key(ck) == 200
        assert packed.get(1).decrypt_with_compression_key(ck) == 55
        with pytest.raises(IndexError):
            packed.get(2)
    finally:
        api.unset_server_key()


def test_hlapi_without_squash_keys(hl_keys):
    """A server key without a squashing key refuses ``squash_noise``; a
    client key without the private keys refuses to decrypt."""
    _, _, ck, sk = hl_keys
    plain = api.ServerKey(sk.inner)
    api.set_server_key(plain)
    try:
        x = api.FheUint8.encrypt(7, ck)
        with pytest.raises(RuntimeError, match="noise squashing key"):
            x.squash_noise()
        with pytest.raises(RuntimeError, match="compression key"):
            api.CompressedSquashedNoiseCiphertextList.builder().build()
        api.set_server_key(sk)
        s = x.squash_noise()
    finally:
        api.unset_server_key()
    bare = api.ClientKey(ck.inner)
    with pytest.raises(ValueError, match="noise_squashing_parameters"):
        s.decrypt(bare)
    with pytest.raises(ValueError, match="compression_parameters"):
        s.decrypt_with_compression_key(bare)
