"""The port's list compression (``tfhe_tpu_torch.shortint.list_compression``)
against tfhe_tpu at PARAM_TEST_TOY with COMP_PARAM_TEST_TOY, on the CPU
(the kernels' plain versions). Same seed => byte-equal keys; the same
encryptions in both packages. Tolerance: exact (integer arithmetic).

- the compression private key, the packing key's NTT residues and the
  decompression key (exact CRT key, scan layout) byte-equal;
- ``compress``: the stored top bits byte-equal (the packing keyswitch's
  NTT-domain MAC, then the rounding to ``storage_log_modulus`` bits);
- ``decompress``: equal to ``programmable_bootstrap_pallas`` in interpret
  mode on the JAX decompression key and the JAX list's extractions (the
  TPU path of ``tfhe_tpu``'s decompress; on the CPU the JAX decompress
  takes the exact path, ROADMAP standing note 2): with ``TFHE_V4_ACC``
  unset (plain K2 u64 -> plain K3 P = 4, which the exact path equals too)
  and under ``TFHE_V4_ACC=32`` (plain K2 acc32 -> plain K3-acc32); every
  output decrypts to its input;
- JAX keys and a JAX list carried in by ``convert`` give the same bits.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tfhe_tpu.ops import ntt as jntt
from tfhe_tpu.ops import server as jserver
from tfhe_tpu.shortint import list_compression as jlc
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils.params import PARAM_TEST_TOY as JP

from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import to_u32, to_u64
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.shortint import list_compression as lc
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.server_key import ServerKey
from tfhe_tpu_torch.utils.params import PARAM_TEST_TOY as P

SEED = 31  # tests/test_compression.py's key seed
MSGS = np.arange(16, dtype=np.uint64)


@pytest.fixture(scope="module")
def keys():
    jck = JClientKey.generate(JP, seed=SEED)
    jsk = JServerKey.generate(jck)
    jpriv = jlc.new_compression_private_key(jck, jlc.COMP_PARAM_TEST_TOY)
    jcomp, jdec = jlc.new_compression_decompression_keys(jck, jpriv)
    ck = ClientKey.generate(P, seed=SEED, device="cpu")
    sk = ServerKey.generate(ck)
    priv = lc.new_compression_private_key(ck, lc.COMP_PARAM_TEST_TOY)
    comp, dec = lc.new_compression_decompression_keys(ck, priv)
    return dict(jck=jck, jsk=jsk, jpriv=jpriv, jcomp=jcomp, jdec=jdec,
                ck=ck, sk=sk, priv=priv, comp=comp, dec=dec)


@pytest.fixture(scope="module")
def lists(keys):
    """The 16 values compressed in both packages from the same
    encryptions."""
    jct, ct = keys["jck"].encrypt(MSGS), keys["ck"].encrypt(MSGS)
    np.testing.assert_array_equal(to_u64(ct.ct), np.asarray(jct.ct))
    return (jlc.compress(keys["jcomp"], jct), lc.compress(keys["comp"], ct))


def _pallas_decompress(keys, jlst, indices):
    """tfhe_tpu's decompress on a TPU: the stored GLWEs expanded, one
    extraction an index, ``programmable_bootstrap_pallas`` with the
    standard switch (interpret mode here), traced anew for the
    environment of the call."""
    cp, jdec = jlst.params, keys["jdec"]
    per = min(cp.lwe_per_glwe, cp.packing_ks_polynomial_size)
    glwes = jnp.asarray(jlst.storage.astype(np.uint64)
                        << np.uint64(64 - cp.storage_log_modulus))
    small = jnp.stack([jserver.sample_extract(glwes[i // per], nth=i % per)
                       for i in indices])
    lut = keys["jsk"].generate_lookup_table(lambda x: x % 16)
    plan = jntt.get_plan(JP.polynomial_size, jdec.num_primes)
    fn = jax.jit(lambda s, acc, key: jserver.programmable_bootstrap_pallas(
        s, acc, key, jdec.br_base_log, jdec.br_level, plan,
        centered_ms=False, batch_tile=len(indices)))
    return np.asarray(fn(small, lut.acc, jdec.bsk_scan))


def test_parameter_constants_match_jax():
    for name in ("COMP_PARAM_MESSAGE_2_CARRY_2_KS_PBS", "COMP_PARAM_TEST_TOY"):
        j, p = getattr(jlc, name), getattr(lc, name)
        for f in ("br_level", "br_base_log", "packing_ks_level",
                  "packing_ks_base_log", "packing_ks_polynomial_size",
                  "packing_ks_glwe_dimension", "lwe_per_glwe",
                  "storage_log_modulus", "decompression_grouping_factor",
                  "name"):
            assert getattr(p, f) == getattr(j, f), (name, f)
        assert (p.packing_ks_key_noise_distribution.std_dev
                == j.packing_ks_key_noise_distribution.std_dev)


def test_keys_byte_equal(keys):
    np.testing.assert_array_equal(to_u64(keys["priv"].comp_glwe_sk.bits),
                                  np.asarray(keys["jpriv"].comp_glwe_sk.bits))
    assert keys["comp"].num_primes == keys["jcomp"].num_primes == 3
    np.testing.assert_array_equal(to_u64(keys["comp"].pksk_hat),
                                  np.asarray(keys["jcomp"].pksk_hat))
    dec, jdec = keys["dec"], keys["jdec"]
    assert (dec.br_base_log, dec.br_level, dec.num_primes) == (
        jdec.br_base_log, jdec.br_level, jdec.num_primes)
    np.testing.assert_array_equal(to_u32(dec.bsk_scan),
                                  np.asarray(jdec.bsk_scan))


def test_compress_storage_byte_equal(lists):
    jlst, lst = lists
    assert lst.count == jlst.count == 16
    assert (lst.message_modulus, lst.carry_modulus) == (4, 4)
    assert tuple(lst.storage.shape) == jlst.storage.shape
    np.testing.assert_array_equal(to_u32(lst.storage), jlst.storage)
    assert to_u32(lst.storage).max() < 1 << lc.COMP_PARAM_TEST_TOY \
        .storage_log_modulus


def test_compress_several_glwes(keys):
    """300 ciphertexts: three GLWEs of 128, the last one part-filled."""
    vals = np.arange(300, dtype=np.uint64) % 16
    jlst = jlc.compress(keys["jcomp"], keys["jck"].encrypt(vals))
    lst = lc.compress(keys["comp"], keys["ck"].encrypt(vals))
    assert lst.storage.shape[0] == 3
    np.testing.assert_array_equal(to_u32(lst.storage), jlst.storage)


@pytest.mark.parametrize("acc", ["u64", "acc32"])
def test_decompress_matches_pallas_interpret(keys, lists, acc, monkeypatch):
    monkeypatch.delenv("TFHE_NTT_VARIANT", raising=False)
    if acc == "acc32":
        monkeypatch.setenv("TFHE_V4_ACC", "32")
    else:
        monkeypatch.delenv("TFHE_V4_ACC", raising=False)
    jlst, lst = lists
    idx = list(range(16))
    want = _pallas_decompress(keys, jlst, idx)
    pk.reset_launches()
    out = lc.decompress(lst, keys["dec"], keys["sk"])
    assert not any(fn.launches for fn in pk.KERNELS)
    got = to_u64(out.ct)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(keys["ck"].decrypt_message_and_carry(out),
                                  MSGS)
    assert (out.degree, out.noise_level, out.under_key) == (15, 1, "big")
    if acc == "u64":  # the exact path of tfhe_tpu's CPU decompress
        jout = jlc.decompress(jlst, keys["jdec"], keys["jsk"])
        np.testing.assert_array_equal(got, np.asarray(jout.ct))
    else:  # every increment rounded: nothing below 2^32 in the body
        assert (got[:, -1] & np.uint64(0xFFFFFFFF)).max() == 0


def test_decompress_subset(keys, lists):
    jlst, lst = lists
    jout = jlc.decompress(jlst, keys["jdec"], keys["jsk"], indices=[2, 0])
    out = lc.decompress(lst, keys["dec"], keys["sk"], indices=[2, 0])
    np.testing.assert_array_equal(to_u64(out.ct), np.asarray(jout.ct))
    np.testing.assert_array_equal(keys["ck"].decrypt_message_and_carry(out),
                                  [2, 0])


def test_carried_keys_and_list(keys, lists):
    """The JAX keys and the JAX list carried in give the port's bits."""
    jlst, lst = lists
    priv, comp, dec = convert.compression_keys_from_arrays(
        lc.COMP_PARAM_TEST_TOY, np.asarray(keys["jpriv"].comp_glwe_sk.bits),
        np.asarray(keys["jcomp"].pksk_hat), keys["jcomp"].num_primes,
        np.asarray(keys["jdec"].bsk_scan), keys["jdec"].num_primes,
        device="cpu")
    np.testing.assert_array_equal(to_u64(comp.pksk_hat),
                                  to_u64(keys["comp"].pksk_hat))
    again = lc.compress(comp, keys["ck"].encrypt(MSGS[:4]))
    np.testing.assert_array_equal(
        to_u32(again.storage),
        jlc.compress(keys["jcomp"], keys["jck"].encrypt(MSGS[:4])).storage)
    carried = convert.compressed_list_from_arrays(
        lc.COMP_PARAM_TEST_TOY, jlst.storage, jlst.count, 4, 4, device="cpu")
    a = lc.decompress(carried, dec, keys["sk"], indices=[5, 9])
    b = lc.decompress(lst, keys["dec"], keys["sk"], indices=[5, 9])
    np.testing.assert_array_equal(to_u64(a.ct), to_u64(b.ct))
