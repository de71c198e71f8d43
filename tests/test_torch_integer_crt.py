"""The port's CRT integers (``tfhe_tpu_torch.integer.crt``) and static big
ints (``tfhe_tpu_torch.integer.bigint``) against ``tfhe_tpu.integer``'s.

CRT at PARAM_TEST_TOY over the bases (3, 4), on the CPU: same-seed
``encrypt_crt`` is byte-equal, and every ``CrtServerKey`` op on the same
inputs (JAX encryptions carried into the port) gives the JAX output bit for
bit (tolerance 0), with equal degrees and noise levels, decrypts to the
clear oracle mod 12 and leaves its inputs unchanged. Big ints: the cases of
``tests/test_bigint.py``, each computed with the port's and the JAX
package's classes, must agree."""

import numpy as np
import pytest
import torch

from tfhe_tpu.integer import bigint as jbigint
from tfhe_tpu.integer import crt as jcrt
from test_torch_integer_ops import (  # noqa: F401  (one_torch_thread: autouse)
    integer_keys, one_torch_thread, public_names)

from tfhe_tpu_torch._torus import from_u64, to_u64
from tfhe_tpu_torch.integer import bigint, crt

SEED = 71  # tests/test_crt.py's key seed
MODULI = (3, 4)
M = 12
A = np.array([5, 11, 3], dtype=np.uint64)
B = np.array([9, 4, 10], dtype=np.uint64)


def _carry_in(j):
    return crt.CrtCiphertext(
        ct=from_u64(np.asarray(j.ct), "cpu"), moduli=tuple(j.moduli),
        degrees=np.array(j.degrees), noise_levels=np.array(j.noise_levels),
        message_modulus=j.message_modulus, carry_modulus=j.carry_modulus)


def _assert_same(j, p):
    np.testing.assert_array_equal(to_u64(p.ct), np.asarray(j.ct))
    np.testing.assert_array_equal(p.degrees, j.degrees)
    np.testing.assert_array_equal(p.noise_levels, j.noise_levels)
    assert p.moduli == j.moduli


@pytest.fixture(scope="module")
def ctx():
    jck, jsk, ck, sk = integer_keys(SEED)
    first = (jcrt.encrypt_crt(jck, A, MODULI), crt.encrypt_crt(ck, A, MODULI))
    jb = jcrt.encrypt_crt(jck, B, MODULI)
    jcsk = jcrt.CrtServerKey(jsk)
    ja = first[0]
    # 2(a + b) unreduced: degrees (8, 12) and noise 4 leave no room for
    # another operand, so the ops below reduce it first
    jx = {"a": ja, "b": jb, "s": jcrt.CrtCiphertext(
        ct=(ja.ct + jb.ct) * 2, moduli=MODULI,
        degrees=(ja.degrees + jb.degrees) * 2,
        noise_levels=(ja.noise_levels + jb.noise_levels) * 2,
        message_modulus=4, carry_modulus=4)}
    return {"jck": jck, "ck": ck, "jcsk": jcsk, "csk": crt.CrtServerKey(sk),
            "jx": jx, "px": {k: _carry_in(v) for k, v in jx.items()},
            "first": first}


def test_encrypt_decrypt_byte_equal(ctx):
    j, p = ctx["first"]
    _assert_same(j, p)
    assert p.value_modulus == M
    np.testing.assert_array_equal(crt.decrypt_crt(ctx["ck"], p), A)
    np.testing.assert_array_equal(crt.decrypt_crt(ctx["ck"], ctx["px"]["s"]),
                                  2 * (A + B) % M)


def test_public_names_match_jax():
    assert public_names(crt.CrtServerKey) == public_names(jcrt.CrtServerKey)
    assert public_names(crt.CrtCiphertext) == public_names(jcrt.CrtCiphertext)


CASES = {
    "add": (lambda k, x: k.add(x["a"], x["b"]), lambda a, b, s: a + b),
    "add[reduce]": (lambda k, x: k.add(x["s"], x["b"]),
                    lambda a, b, s: s + b),
    "sub": (lambda k, x: k.sub(x["a"], x["b"]), lambda a, b, s: a - b),
    "neg": (lambda k, x: k.neg(x["a"]), lambda a, b, s: -a),
    "mul": (lambda k, x: k.mul(x["a"], x["b"]), lambda a, b, s: a * b),
    "mul[reduce]": (lambda k, x: k.mul(x["s"], x["b"]),
                    lambda a, b, s: s * b),
    "scalar_add": (lambda k, x: k.scalar_add(x["a"], 7),
                   lambda a, b, s: a + 7),
    "scalar_mul": (lambda k, x: k.scalar_mul(x["a"], 5),
                   lambda a, b, s: a * 5),
}


@pytest.mark.parametrize("name", list(CASES))
def test_crt_op_bit_equal(ctx, name):
    fn, want = CASES[name]
    px = ctx["px"]
    snaps = {k: v.ct.clone() for k, v in px.items()}
    out = fn(ctx["csk"], px)
    _assert_same(fn(ctx["jcsk"], ctx["jx"]), out)
    a, b = A.astype(np.int64), B.astype(np.int64)
    np.testing.assert_array_equal(crt.decrypt_crt(ctx["ck"], out),
                                  want(a, b, 2 * (a + b)) % M)
    for k, v in px.items():
        assert torch.equal(v.ct, snaps[k]), "an op wrote into its input"


def test_crt_bases_checked(ctx):
    with pytest.raises(ValueError, match="coprime"):
        crt.encrypt_crt(ctx["ck"], A, (2, 4))
    with pytest.raises(ValueError, match="fit"):
        crt.encrypt_crt(ctx["ck"], A, (17, 3))


# the cases of tests/test_bigint.py, each run on one module's classes;
# the port's results must equal the JAX package's
BIGINT_CASES = {
    "wrapping_arithmetic": lambda m: [
        int(m.U256.max_value() + 1), int(m.U256(0) - 1),
        int(m.U256(1 << 255) * 2), int(m.U128((1 << 128) - 1) + 1)],
    "words_and_bytes_roundtrip": lambda m: [
        m.U256(0x0123456789ABCDEF_FEDCBA9876543210_DEADBEEFCAFEBABE_0011223344556677)
        .to_words(),
        m.U256.from_words([1, 2, 3, 4]).value,
        m.U256.from_le_bytes(m.U256(-5).to_le_bytes()).value,
        m.U256(0x0123456789ABCDEF).to_le_bytes()],
    "signed_semantics": lambda m: [
        int(m.I256(-1)), m.I256(-1).to_unsigned_int(),
        int(m.I256.min_value() - 1), int(m.I256.max_value()),
        int(m.I256(-8) >> 1), m.I256(-5) < m.I256(3), int(m.I512(-3) * 7)],
    "shift_mod_bits": lambda m: [
        int(m.U256(1) << 256), int(m.U256(1) << 257), int(m.U512(1) << 513),
        int(m.U1024(3) >> 1025), int(m.U2048(1) << 2047)],
    "mixed_int_ops": lambda m: [
        int(m.U256(10) + 5), m.U256(10) == 10, (3 * m.U256(7)).value,
        int(20 - m.U128(3)), int(m.U128(100) // 7), int(m.U128(100) % 7),
        repr(m.U256(9)), hash(m.U256(9)) == hash(m.U256(9))],
}


@pytest.mark.parametrize("name", list(BIGINT_CASES))
def test_bigint_matches_jax(name):
    case = BIGINT_CASES[name]
    assert case(bigint) == case(jbigint)
