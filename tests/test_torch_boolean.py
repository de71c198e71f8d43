"""The port's boolean layer against tfhe_tpu.boolean at BOOLEAN_TEST_TOY, on
the CPU (the kernels' plain versions): the parameter sets, same seed =>
byte-equal keys (bsk_scan, ksk) and ciphertexts, every gate bit-equal, the
truth tables, and key conversion. Tolerance: exact (integer arithmetic)."""

import dataclasses

import numpy as np
import pytest

from tfhe_tpu.boolean.keys import ClientKey as JClientKey
from tfhe_tpu.boolean.keys import ServerKey as JServerKey
from tfhe_tpu.utils import params as jparams

from tfhe_tpu_torch import boolean, convert
from tfhe_tpu_torch._torus import from_u64, to_u32, to_u64
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.utils import params

SEED = 3
P = params.BOOLEAN_TEST_TOY
CASES = [(False, False), (False, True), (True, False), (True, True)]
GATES = {"and_": lambda a, b: a and b, "or_": lambda a, b: a or b,
         "nand": lambda a, b: not (a and b), "nor": lambda a, b: not (a or b),
         "xor": lambda a, b: a ^ b, "xnor": lambda a, b: not (a ^ b)}


@pytest.fixture(scope="module")
def keys():
    jck = JClientKey.generate(jparams.BOOLEAN_TEST_TOY, seed=SEED)
    jsk = JServerKey.generate(jck)
    ck = boolean.ClientKey.generate(P, seed=SEED, device="cpu")
    sk = boolean.ServerKey.generate(ck)
    return jck, jsk, ck, sk


@pytest.fixture(scope="module")
def operands(keys):
    """The four input pairs, encrypted by both packages (same bits)."""
    jck, _, ck, _ = keys
    a = np.array([x for x, _ in CASES])
    b = np.array([y for _, y in CASES])
    jl, jr = jck.encrypt(a), jck.encrypt(b)
    l, r = ck.encrypt(a), ck.encrypt(b)
    return jl, jr, l, r


def _wrap(ct):
    return boolean.BooleanCiphertext(ct=from_u64(np.asarray(ct.ct), "cpu"))


@pytest.mark.parametrize("name", ["BOOLEAN_DEFAULT_PARAMETERS",
                                  "BOOLEAN_DEFAULT_PARAMETERS_KS_PBS",
                                  "BOOLEAN_TFHE_LIB_PARAMETERS",
                                  "BOOLEAN_TEST_TOY"])
def test_parameter_sets_match_jax(name):
    got = params.BOOLEAN_PARAMS_BY_NAME[name]
    want = getattr(jparams, name)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(w):
            assert dataclasses.asdict(g) == dataclasses.asdict(w), f.name
        elif hasattr(w, "value"):  # enums of the two packages
            assert g.value == w.value, f.name
        else:
            assert g == w, f.name


def test_same_seed_keys_byte_equal(keys):
    jck, jsk, ck, sk = keys
    np.testing.assert_array_equal(to_u64(ck.lwe_sk.bits),
                                  np.asarray(jck.lwe_sk.bits))
    np.testing.assert_array_equal(to_u64(ck.glwe_sk.bits),
                                  np.asarray(jck.glwe_sk.bits))
    np.testing.assert_array_equal(to_u64(sk.ksk), np.asarray(jsk.ksk))
    np.testing.assert_array_equal(sk.ksk_i8.numpy(), np.asarray(jsk.ksk_i8))
    assert sk.num_primes == jsk.num_primes == 3
    np.testing.assert_array_equal(to_u32(sk.bsk_scan),
                                  np.asarray(jsk.bsk_scan))
    np.testing.assert_array_equal(to_u32(sk.bsk_hat), np.asarray(jsk.bsk_hat))


def test_same_seed_encryption_byte_equal(keys, operands):
    jl, jr, l, r = operands
    np.testing.assert_array_equal(to_u64(l.ct), np.asarray(jl.ct))
    np.testing.assert_array_equal(to_u64(r.ct), np.asarray(jr.ct))


@pytest.mark.parametrize("gate", sorted(GATES))
def test_binary_gate_bit_equal(keys, operands, gate):
    jck, jsk, ck, sk = keys
    jl, jr, l, r = operands
    pk.reset_launches()
    got = getattr(sk, gate)(l, r)
    want = getattr(jsk, gate)(jl, jr)
    np.testing.assert_array_equal(to_u64(got.ct), np.asarray(want.ct))
    assert list(ck.decrypt(got)) == [GATES[gate](a, b) for a, b in CASES]
    assert list(ck.decrypt(got)) == list(jck.decrypt(want))
    # CPU tensors take the plain versions
    assert pk.body_rotate_u64.launches == pk.blind_rotate_crt.launches == 0


def test_not_and_mux_bit_equal(keys, operands):
    jck, jsk, ck, sk = keys
    jl, jr, l, r = operands
    np.testing.assert_array_equal(to_u64(sk.not_(l).ct),
                                  np.asarray(jsk.not_(jl).ct))
    assert list(ck.decrypt(sk.not_(l))) == [not a for a, _ in CASES]
    cond = [True, False, True, False]
    jc = jck.encrypt(np.array(cond))
    c = ck.encrypt(np.array(cond))
    got = sk.mux(c, l, r)
    np.testing.assert_array_equal(to_u64(got.ct),
                                  np.asarray(jsk.mux(jc, jl, jr).ct))
    assert list(ck.decrypt(got)) == [
        a if cc else b for cc, (a, b) in zip(cond, CASES)]


def test_mux_one_batch_equals_two_bootstraps(keys, operands):
    """mux bootstraps both branches in one batch: the same bits as two
    separate bootstraps."""
    _, _, ck, sk = keys
    _, _, l, r = operands
    c = ck.encrypt(np.array([True, True, False, False]))
    in1 = c.ct + l.ct
    in1[..., -1] += boolean.PLAINTEXT_FALSE
    in2 = -c.ct + r.ct
    in2[..., -1] += boolean.PLAINTEXT_FALSE
    s = sk._bootstrap(in1) + sk._bootstrap(in2)
    s[..., -1] += boolean.PLAINTEXT_TRUE
    np.testing.assert_array_equal(to_u64(sk._keyswitch(s)),
                                  to_u64(sk.mux(c, l, r).ct))


def test_gates_on_jax_ciphertexts_and_batch_shapes(keys):
    """Gates take ciphertexts made by tfhe_tpu and keep a 2-d batch shape."""
    jck, jsk, ck, sk = keys
    a = np.array([[True, False, True], [False, False, True]])
    b = np.array([[True, True, False], [False, True, True]])
    jl, jr = jck.encrypt(a), jck.encrypt(b)
    got = sk.or_(_wrap(jl), _wrap(jr))
    assert tuple(got.ct.shape) == (2, 3, P.lwe_dimension + 1)
    np.testing.assert_array_equal(to_u64(got.ct),
                                  np.asarray(jsk.or_(jl, jr).ct))
    np.testing.assert_array_equal(ck.decrypt(got), a | b)


def test_convert_round_trip(keys, operands):
    jck, jsk, ck, sk = keys
    jl, jr, _, _ = operands
    ck2 = convert.boolean_client_key_from_arrays(
        P.name, np.asarray(jck.glwe_sk.bits), np.asarray(jck.lwe_sk.bits),
        device="cpu")
    sk2 = convert.boolean_server_key_from_arrays(
        P.name, np.asarray(jsk.ksk), np.asarray(jsk.bsk_scan), device="cpu")
    np.testing.assert_array_equal(to_u64(ck2.lwe_sk.bits),
                                  to_u64(ck.lwe_sk.bits))
    np.testing.assert_array_equal(to_u64(ck2.glwe_sk.bits),
                                  to_u64(ck.glwe_sk.bits))
    np.testing.assert_array_equal(to_u32(sk2.bsk_scan), to_u32(sk.bsk_scan))
    np.testing.assert_array_equal(sk2.ksk_i8.numpy(), sk.ksk_i8.numpy())
    got = sk2.nand(_wrap(jl), _wrap(jr))
    np.testing.assert_array_equal(to_u64(got.ct),
                                  np.asarray(jsk.nand(jl, jr).ct))
    assert list(ck2.decrypt(got)) == [not (a and b) for a, b in CASES]
    with pytest.raises(ValueError, match="seed"):
        ck2.encrypt([True])
    with pytest.raises(ValueError, match="shape"):
        convert.boolean_server_key_from_arrays(
            P.name, np.asarray(jsk.ksk), np.asarray(jsk.bsk_scan)[:, :, :2],
            device="cpu")
