"""The port's many-LUT PBS (``ServerKey.generate_many_lookup_table`` /
``apply_many_lookup_table``) against tfhe_tpu at PARAM_TEST_TOY, on the CPU
(the kernels' plain versions): one keyswitch and one blind rotation on the
exact CRT key, then one sample extraction a function.

- with ``TFHE_V4_ACC`` unset (plain K2 u64 -> plain K3 P = 4): the JAX
  ``ServerKey`` on the CPU, whose exact path gives K3's bits;
- under ``TFHE_V4_ACC=32`` (plain K2 acc32 -> plain K3-acc32): the TPU
  path of ``tfhe_tpu``'s ``apply_many_lookup_table``, ``blind_rotate_pallas``
  in interpret mode (the JAX key never rounds on the CPU);
- under ``TFHE_NTT_VARIANT=v5`` (plain K2 u64 -> plain K4): the JAX
  ``ServerKey``, whose CPU path is the Goldilocks oracle.

Tolerance: exact (integer arithmetic). Also: the degree guard, the CRT key
built at first use and equal to tfhe_tpu's ``bsk_scan`` (and carried in by
``convert``), and many-LUT under KS32, which switches from the u32 torus."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tfhe_tpu.ops import ntt as jntt
from tfhe_tpu.ops import pbs_kernel as jpk
from tfhe_tpu.ops import server as jserver
from tfhe_tpu.shortint import server_key as jserver_key
from tfhe_tpu.shortint.ciphertext import ShortintCiphertext as JCiphertext
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils.params import PARAM_TEST_TOY as JP

from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import to_u32, to_u64
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.shortint.ciphertext import ShortintCiphertext
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.server_key import ServerKey
from tfhe_tpu_torch.utils.params import PARAM_TEST_TOY as P
from tfhe_tpu_torch.utils.params import PARAM_TEST_TOY_KS32

SEED = 55  # tests/test_many_lut.py's key seed
#: (functions, inputs): k = 2 over every degree <= 7, k = 4 over <= 3
FUNCS = {
    2: ([lambda x: x % 4, lambda x: (x * 2) % 16], np.arange(8)),
    4: ([lambda x: x, lambda x: x + 1, lambda x: (3 * x) % 4,
         lambda x: 15 - x], np.arange(4)),
}


@functools.lru_cache(maxsize=None)
def _pallas_rotation():
    """``blind_rotate_pallas`` under jax.jit, so that the cases of one
    shape share one interpret-mode compile (read the environment before
    the first call)."""
    return jax.jit(jpk.blind_rotate_pallas, static_argnames=(
        "base_log", "levels", "plan", "batch_tile"))


def _keys():
    jck = JClientKey.generate(JP, seed=SEED)
    jsk = JServerKey.generate(jck)
    ck = ClientKey.generate(P, seed=SEED, device="cpu")
    return jck, jsk, ck, ServerKey.generate(ck)


@pytest.fixture(scope="module")
def keys():
    return _keys()


def _inputs(jck, ck, msgs):
    """The same message encryptions in both packages, at degree
    max(msgs)."""
    jct, ct = jck.encrypt(msgs), ck.encrypt(msgs)
    deg = int(msgs.max())
    return (JCiphertext(ct=jct.ct, degree=deg, noise_level=1,
                        message_modulus=4, carry_modulus=4),
            ShortintCiphertext(ct=ct.ct, degree=deg, noise_level=1,
                               message_modulus=4, carry_modulus=4))


def _check(jouts, outs, fns, msgs, ck):
    assert len(outs) == len(jouts) == len(fns)
    for jo, o, f in zip(jouts, outs, fns):
        np.testing.assert_array_equal(to_u64(o.ct), np.asarray(jo.ct))
        assert o.degree == jo.degree
        np.testing.assert_array_equal(ck.decrypt_message_and_carry(o),
                                      [f(int(m)) for m in msgs])


@pytest.mark.parametrize("k", [2, 4])
def test_many_lut_bit_equal(keys, k):
    jck, jsk, ck, sk = keys
    fns, msgs = FUNCS[k]
    jct, ct = _inputs(jck, ck, msgs)
    many = sk.generate_many_lookup_table(fns)
    jmany = jsk.generate_many_lookup_table(fns)
    np.testing.assert_array_equal(to_u64(many.acc), np.asarray(jmany.acc))
    assert (many.degrees, many.stride, many.count, many.max_input_degree) \
        == (jmany.degrees, jmany.stride, jmany.count, jmany.max_input_degree)
    pk.reset_launches()
    _check(jsk.apply_many_lookup_table(jct, jmany),
           sk.apply_many_lookup_table(ct, many), fns, msgs, ck)
    assert not any(fn.launches for fn in pk.KERNELS)


def test_degree_guard(keys):
    jck, jsk, ck, sk = keys
    jct, ct = _inputs(jck, ck, np.arange(16))
    fns = [lambda x: x, lambda x: x + 1]
    with pytest.raises(AssertionError, match="many-LUT limit"):
        jsk.apply_many_lookup_table(jct, jsk.generate_many_lookup_table(fns))
    with pytest.raises(ValueError, match="many-LUT limit"):
        sk.apply_many_lookup_table(ct, sk.generate_many_lookup_table(fns))


def test_crt_key_built_at_first_use_and_carried(keys):
    """Under v6b the CRT key is built at the first many-LUT call from the
    standard-domain BSK (which it replaces), equals tfhe_tpu's bsk_scan,
    and a key carried in with that bsk_scan gives the same many-LUT
    bits."""
    _, jsk, _, _ = keys
    ck = ClientKey.generate(P, seed=SEED, device="cpu")
    sk = ServerKey.generate(ck)  # the fixture's key, drawn anew
    assert sk.variant == "v6b" and sk.bsk_scan is None
    assert sk.bsk_std is not None
    fns, msgs = FUNCS[2]
    ct = ck.encrypt(msgs)
    ct = ShortintCiphertext(ct=ct.ct, degree=7, noise_level=1,
                            message_modulus=4, carry_modulus=4)
    many = sk.generate_many_lookup_table(fns)
    outs = sk.apply_many_lookup_table(ct, many)
    assert sk.bsk_std is None
    np.testing.assert_array_equal(to_u32(sk.bsk_scan),
                                  np.asarray(jsk.bsk_scan))
    carried = convert.server_key_from_arrays(
        P.name, np.asarray(jsk.ksk), np.asarray(jsk.bsk_scan),
        jsk.num_primes, device="cpu")
    assert carried.bsk_std is None
    np.testing.assert_array_equal(to_u32(carried.bsk_b), to_u32(sk.bsk_b))
    for a, b in zip(carried.apply_many_lookup_table(ct, many), outs):
        np.testing.assert_array_equal(to_u64(a.ct), to_u64(b.ct))
    name, ksk, scan, nprimes, zeros = convert.server_key_to_arrays(sk)
    assert (name, nprimes, zeros) == (P.name, jsk.num_primes, None)
    np.testing.assert_array_equal(ksk, np.asarray(jsk.ksk))
    np.testing.assert_array_equal(scan, np.asarray(jsk.bsk_scan))


@pytest.mark.parametrize("k", [2, 4])
def test_many_lut_acc32_matches_pallas_interpret(keys, k, monkeypatch):
    """TFHE_V4_ACC=32: the port's plain K2 acc32 -> plain K3-acc32 against
    the TPU branch of tfhe_tpu's apply_many_lookup_table (keyswitch,
    centered switch, blind_rotate_pallas in interpret mode on bsk_scan,
    the extractions); both k share one interpret-mode compile."""
    monkeypatch.setenv("TFHE_V4_ACC", "32")
    monkeypatch.delenv("TFHE_NTT_VARIANT", raising=False)
    monkeypatch.setattr(jserver_key, "_jitted_ks_pbs_cache", {})
    jck, jsk, ck, sk = keys
    fns = FUNCS[k][0]
    msgs = np.arange(8) % (16 // k)
    jct, ct = _inputs(jck, ck, msgs)
    jmany = jsk.generate_many_lookup_table(fns)
    p = JP
    N = p.polynomial_size
    small = jsk._fns[2](jct.ct, jsk.ksk_i8)
    msm, msb = jserver.lwe_centered_binary_modulus_switch(small,
                                                          N.bit_length())
    lut = jnp.broadcast_to(jmany.acc, (len(msgs),) + jmany.acc.shape)
    rotated = _pallas_rotation()(
        lut, msm, msb, jsk.bsk_scan, base_log=p.pbs_base_log,
        levels=p.pbs_level, plan=jntt.get_plan(N, jsk.num_primes),
        batch_tile=len(msgs))
    want = [jserver.sample_extract(rotated, nth=i * jmany.stride)
            for i in range(k)]
    outs = sk.apply_many_lookup_table(ct, sk.generate_many_lookup_table(fns))
    for w, o, f in zip(want, outs, fns):
        got = to_u64(o.ct)
        np.testing.assert_array_equal(got, np.asarray(w))
        np.testing.assert_array_equal(ck.decrypt_message_and_carry(o),
                                      [f(int(m)) for m in msgs])
    # the rounding is in effect: the body of every output is a multiple of
    # 2^32 plus nothing from a lower plane
    assert (got[:, -1] & np.uint64(0xFFFFFFFF)).max() == 0


@pytest.fixture(scope="module")
def v5_keys():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TFHE_NTT_VARIANT", "v5")
        return _keys()


@pytest.mark.parametrize("k", [2, 4])
def test_many_lut_v5_bit_equal(v5_keys, k, monkeypatch):
    """TFHE_NTT_VARIANT=v5: plain K2 u64 -> plain K4 on the Goldilocks key,
    against tfhe_tpu's v5 branch (its Goldilocks oracle on the CPU)."""
    monkeypatch.setenv("TFHE_NTT_VARIANT", "v5")
    jck, jsk, ck, sk = v5_keys
    assert sk.variant == jsk.ntt_variant == "v5"
    fns, msgs = FUNCS[k]
    jct, ct = _inputs(jck, ck, msgs)
    _check(jsk.apply_many_lookup_table(jct, jsk.generate_many_lookup_table(fns)),
           sk.apply_many_lookup_table(ct, sk.generate_many_lookup_table(fns)),
           fns, msgs, ck)
    assert sk.bsk_scan is None  # v5 never builds the CRT key


def test_many_lut_ks32_switches_from_32_bits():
    """Under KS32 the keyswitch lands on the u32 torus and many-LUT's
    switch reads 32 bits, as the KS32 PBS does; every output decrypts to
    its function. (tfhe_tpu's apply_many_lookup_table switches the u32
    values as 64-bit ones, ``server_key.py:600-606``: not compared.)"""
    ck = ClientKey.generate(PARAM_TEST_TOY_KS32, seed=SEED, device="cpu")
    sk = ServerKey.generate(ck)
    fns, msgs = FUNCS[2]
    ct = ck.encrypt(msgs)
    ct = ShortintCiphertext(ct=ct.ct, degree=7, noise_level=1,
                            message_modulus=4, carry_modulus=4)
    outs = sk.apply_many_lookup_table(ct, sk.generate_many_lookup_table(fns))
    for o, f in zip(outs, fns):
        np.testing.assert_array_equal(ck.decrypt_message_and_carry(o),
                                      [f(int(m)) for m in msgs])
