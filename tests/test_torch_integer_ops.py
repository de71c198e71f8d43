"""The port's integer radix layer (``tfhe_tpu_torch.integer.radix``) against
``tfhe_tpu.integer.radix`` at PARAM_TEST_TOY, 4 blocks (8-bit values), on
the CPU (the kernels' plain versions).

Same seed => byte-equal integer keys and encryptions. Every public op of
the JAX ``ServerKey`` runs on the same inputs (JAX encryptions carried in
through ``convert.radix_ciphertext_from_arrays``) in both packages: the
output ciphertext must equal the JAX one bit for bit (tolerance 0: integer
arithmetic throughout), with equal degrees and noise levels, decrypt to the
clear oracle, and leave every input (a second reference to it) unchanged.
The inputs include a carry-dirty ciphertext (degrees 6 > 3), which makes
the ops that clean their operands run ``full_propagate`` first.

The helpers here are shared with ``test_torch_integer_extra.py`` and
``test_torch_integer_crt.py``.
"""

import numpy as np
import pytest
import torch

from tfhe_tpu.integer.radix import BooleanBlock as JBooleanBlock
from tfhe_tpu.integer.radix import ClientKey as JClientKey
from tfhe_tpu.integer.radix import ServerKey as JServerKey
from tfhe_tpu.utils.params import PARAM_TEST_TOY as JP

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import from_u64, to_u64
from tfhe_tpu_torch.integer import gen_keys, radix
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.shortint.ciphertext import ShortintCiphertext
from tfhe_tpu_torch.utils.params import PARAM_TEST_TOY as P

SEED = 99  # tests/test_integer_ops.py's key seed
NB = 4
BITS = 8
MOD = 1 << BITS


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a module's port ops on one torch thread, then restore the count:
    the plain kernels' small int64 ops run several times slower on 8
    threads than on one, more so beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def integer_keys(seed):
    """(JAX client key, JAX server key, port client key, port server key)
    from one seed; the port's on the CPU."""
    jck = JClientKey.generate(JP, seed=seed)
    jsk = JServerKey.generate(jck)
    ck = radix.ClientKey.generate(P, seed=seed, device="cpu")
    sk = radix.ServerKey.generate(ck)
    return jck, jsk, ck, sk


def carry_in(x):
    """A JAX radix ciphertext, boolean block, or list of them, carried into
    the port on the CPU."""
    if isinstance(x, list):
        return [carry_in(v) for v in x]
    if isinstance(x, JBooleanBlock):
        return radix.BooleanBlock(ct=from_u64(np.asarray(x.ct), "cpu"))
    return convert.radix_ciphertext_from_arrays(
        np.asarray(x.ct), x.degrees, x.noise_levels, x.message_modulus,
        x.carry_modulus, device="cpu")


def snapshot(x):
    if isinstance(x, list):
        return [snapshot(v) for v in x]
    if isinstance(x, radix.BooleanBlock):
        return (x.ct.clone(),)
    return (x.ct.clone(), x.degrees.copy(), x.noise_levels.copy())


def assert_unchanged(x, snap):
    if isinstance(x, list):
        for v, s in zip(x, snap):
            assert_unchanged(v, s)
        return
    assert torch.equal(x.ct, snap[0]), "an op wrote into its input"
    if len(snap) > 1:
        np.testing.assert_array_equal(x.degrees, snap[1])
        np.testing.assert_array_equal(x.noise_levels, snap[2])


def decode(ck, sk, out, kind):
    """Clear value(s) of a port output: 'u' unsigned radix, 's' signed
    radix, 'r' radix with carries in its blocks (summed with them), 'b'
    boolean block."""
    if kind == "b":
        return sk.decrypt_bool(ck, out).astype(np.uint64)
    if kind == "u":
        return ck.decrypt_radix(out)
    if kind == "s":
        return ck.decrypt_signed_radix(out)
    mm, nb = out.message_modulus, out.num_blocks
    s = ShortintCiphertext(ct=out.ct, degree=int(out.degrees.max()),
                           noise_level=1, message_modulus=mm,
                           carry_modulus=out.carry_modulus)
    blocks = np.atleast_1d(ck.key.decrypt_message_and_carry(s)).astype(object)
    blocks = blocks.reshape(out.batch_shape + (nb,))
    vals = sum(blocks[..., b] * mm ** b for b in range(nb))
    return (vals % mm ** nb).astype(np.uint64)


def assert_same(jout, out, kind, want, ck, sk):
    """The port's output equals the JAX one bit for bit (and in degrees and
    noise levels), and decrypts to ``want``."""
    if isinstance(kind, tuple):
        assert isinstance(out, tuple) and len(out) == len(kind)
        for j, o, k, w in zip(jout, out, kind, want):
            assert_same(j, o, k, w, ck, sk)
        return
    np.testing.assert_array_equal(to_u64(out.ct), np.asarray(jout.ct))
    if kind == "b":
        assert isinstance(out, radix.BooleanBlock)
    else:
        assert isinstance(out, radix.RadixCiphertext)
        np.testing.assert_array_equal(out.degrees, np.asarray(jout.degrees))
        np.testing.assert_array_equal(out.noise_levels,
                                      np.asarray(jout.noise_levels))
        assert (out.message_modulus, out.carry_modulus) == (
            jout.message_modulus, jout.carry_modulus)
    got = decode(ck, sk, out, kind)
    np.testing.assert_array_equal(
        got, np.asarray(want).astype(got.dtype).reshape(got.shape))


def run_case(ctx, fn, want, kind):
    """``fn(server_key, inputs)`` in both packages, compared."""
    snaps = {k: snapshot(v) for k, v in ctx["px"].items()}
    jout = fn(ctx["jsk"], ctx["jx"])
    out = fn(ctx["sk"], ctx["px"])
    assert_same(jout, out, kind, want(ctx["clear"]), ctx["ck"], ctx["sk"])
    for k, v in ctx["px"].items():
        assert_unchanged(v, snaps[k])


def public_names(cls):
    return {n for n in dir(cls) if not n.startswith("_")}


# ---------------------------------------------------------------------------
# this file's keys and inputs
# ---------------------------------------------------------------------------

A = np.array([200, 77], dtype=np.uint64)
B = np.array([45, 77], dtype=np.uint64)  # lane 1: a == b
AMT = np.array([3, 6], dtype=np.uint64)
S = np.array([-100, 57], dtype=np.int64)
T = np.array([3, -57], dtype=np.int64)
A2 = np.array([13, 7], dtype=np.uint64)  # 2 blocks: 4-bit values
B2 = np.array([3, 2], dtype=np.uint64)
S2 = np.array([-7, 6], dtype=np.int64)
T2 = np.array([2, -4], dtype=np.int64)
C = np.array([1, 0], dtype=np.uint64)
C2 = np.array([1, 1], dtype=np.uint64)


@pytest.fixture(scope="module")
def ctx():
    jck, jsk, ck, sk = integer_keys(SEED)
    # the first encryptions of both keys, compared by test_keys_and_encryptions
    ja, a = jck.encrypt_radix(A, NB), ck.encrypt_radix(A, NB)
    js, s = jck.encrypt_signed_radix(S, NB), ck.encrypt_signed_radix(S, NB)
    j5, p5 = jck.encrypt_radix(5, NB), ck.encrypt_radix(5, NB)
    jx = {"a": ja, "s": js, "b": jck.encrypt_radix(B, NB),
          "amt": jck.encrypt_radix(AMT, NB),
          "t": jck.encrypt_signed_radix(T, NB),
          "a2": jck.encrypt_radix(A2, 2), "b2": jck.encrypt_radix(B2, 2),
          "s2": jck.encrypt_signed_radix(S2, 2),
          "t2": jck.encrypt_signed_radix(T2, 2),
          "c": JBooleanBlock(ct=jck.key.encrypt(C).ct),
          "c2": JBooleanBlock(ct=jck.key.encrypt(C2).ct)}
    jx["d"] = jsk.unchecked_add(jx["a"], jx["b"])  # carry-dirty, degrees 6
    clear = {"a": A, "b": B, "amt": AMT, "s": S, "t": T, "a2": A2, "b2": B2,
             "s2": S2, "t2": T2, "c": C, "c2": C2, "d": (A + B) % MOD}
    return {"jck": jck, "jsk": jsk, "ck": ck, "sk": sk, "jx": jx,
            "px": {k: carry_in(v) for k, v in jx.items()}, "clear": clear,
            "first": (ja, a, js, s, j5, p5)}


def _u(v):
    return np.asarray(v, dtype=object)


def _rot_r(v, s, bits=BITS):
    v = _u(v)
    return ((v >> s) | (v << (bits - s))) % (1 << bits)


def _signed(v, bits):
    v = np.asarray(v, dtype=np.int64) % (1 << bits)
    return np.where(v >= 1 << (bits - 1), v - (1 << bits), v)


def _trunc_div(a, b):
    q = np.abs(a) // np.abs(b)
    return np.where((a < 0) != (b < 0), -q, q)


def _ilog2(v):
    return [int(x).bit_length() - 1 for x in v]


# name -> (fn(server key, inputs), oracle(clear inputs), output kind);
# "name[variant]" runs the op ``name`` on other arguments
CASES = {
    "full_propagate": (lambda k, x: k.full_propagate(x["d"]),
                       lambda c: c["d"], "u"),
    "unchecked_add": (lambda k, x: k.unchecked_add(x["a"], x["b"]),
                      lambda c: (c["a"] + c["b"]) % MOD, "r"),
    "add": (lambda k, x: k.add(x["d"], x["b"]),
            lambda c: (c["d"] + c["b"]) % MOD, "u"),
    "add_parallelized": (
        lambda k, x: k.add_parallelized(x["a"], x["b"], compute_overflow=True),
        lambda c: ((c["a"] + c["b"]) % MOD, _u(c["a"]) + _u(c["b"]) >= MOD),
        ("u", "b")),
    "unchecked_neg": (lambda k, x: k.unchecked_neg(x["a"]),
                      lambda c: (MOD - c["a"]) % MOD, "r"),
    "neg": (lambda k, x: k.neg(x["a"]), lambda c: (MOD - c["a"]) % MOD, "u"),
    "sub": (lambda k, x: k.sub(x["a"], x["b"]),
            lambda c: (c["a"] - c["b"]) % MOD, "u"),
    "sub_parallelized": (
        lambda k, x: k.sub_parallelized(x["a"], x["b"], compute_overflow=True),
        lambda c: ((c["a"] - c["b"]) % MOD, c["a"] < c["b"]), ("u", "b")),
    "scalar_add": (lambda k, x: k.scalar_add(x["a"], 57),
                   lambda c: (c["a"] + 57) % MOD, "u"),
    "scalar_sub": (lambda k, x: k.scalar_sub(x["a"], 57),
                   lambda c: (c["a"] - 57) % MOD, "u"),
    "scalar_mul": (lambda k, x: k.scalar_mul(x["a"], 11),
                   lambda c: (c["a"] * 11) % MOD, "u"),
    "scalar_mul[0]": (lambda k, x: k.scalar_mul(x["a"], 0),
                      lambda c: c["a"] * 0, "u"),
    "bitand": (lambda k, x: k.bitand(x["d"], x["b"]),
               lambda c: c["d"] & c["b"], "u"),
    "bitor": (lambda k, x: k.bitor(x["a"], x["b"]),
              lambda c: c["a"] | c["b"], "u"),
    "bitxor": (lambda k, x: k.bitxor(x["a"], x["b"]),
               lambda c: c["a"] ^ c["b"], "u"),
    "bitnot": (lambda k, x: k.bitnot(x["a"]),
               lambda c: ~c["a"] % MOD, "u"),
    "mul": (lambda k, x: k.mul(x["a"], x["b"]),
            lambda c: (c["a"] * c["b"]) % MOD, "u"),
    "mul_sequential": (lambda k, x: k.mul_sequential(x["a2"], x["b2"]),
                       lambda c: (c["a2"] * c["b2"]) % 16, "u"),
    "eq": (lambda k, x: k.eq(x["a"], x["b"]),
           lambda c: c["a"] == c["b"], "b"),
    "ne": (lambda k, x: k.ne(x["a"], x["b"]),
           lambda c: c["a"] != c["b"], "b"),
    "lt": (lambda k, x: k.lt(x["a"], x["b"]), lambda c: c["a"] < c["b"], "b"),
    "le": (lambda k, x: k.le(x["a"], x["b"]), lambda c: c["a"] <= c["b"], "b"),
    "gt": (lambda k, x: k.gt(x["d"], x["b"]), lambda c: c["d"] > c["b"], "b"),
    "ge": (lambda k, x: k.ge(x["a"], x["b"]), lambda c: c["a"] >= c["b"], "b"),
    "min": (lambda k, x: k.min(x["a"], x["b"]),
            lambda c: np.minimum(c["a"], c["b"]), "u"),
    "max": (lambda k, x: k.max(x["d"], x["b"]),
            lambda c: np.maximum(c["d"], c["b"]), "u"),
    "if_then_else": (lambda k, x: k.if_then_else(x["c"], x["a"], x["b"]),
                     lambda c: np.where(c["c"] == 1, c["a"], c["b"]), "u"),
    "cmux": (lambda k, x: k.cmux(x["c"], x["d"], x["b"]),
             lambda c: np.where(c["c"] == 1, c["d"], c["b"]), "u"),
    "boolean_bitand": (lambda k, x: k.boolean_bitand(x["c"], x["c2"]),
                       lambda c: c["c"] & c["c2"], "b"),
    "boolean_bitor": (lambda k, x: k.boolean_bitor(x["c"], x["c2"]),
                      lambda c: c["c"] | c["c2"], "b"),
    "boolean_bitnot": (lambda k, x: k.boolean_bitnot(x["c"]),
                       lambda c: 1 - c["c"], "b"),
    "all_eq_slices": (lambda k, x: k.all_eq_slices([x["a"], x["b"]],
                                                   [x["b"], x["b"]]),
                      lambda c: c["a"] == c["b"], "b"),
    "all_eq_slices[length]": (lambda k, x: k.all_eq_slices([x["a"], x["b"]],
                                                           [x["a"]]),
                              lambda c: c["a"] * 0, "b"),
    "contains_sub_slice": (
        lambda k, x: k.contains_sub_slice([x["a"], x["b"], x["b"]],
                                          [x["b"], x["a"]]),
        lambda c: c["a"] == c["b"], "b"),
    "scalar_right_shift": (lambda k, x: k.scalar_right_shift(x["a"], 3),
                           lambda c: c["a"] >> np.uint64(3), "u"),
    "scalar_right_shift[block]": (lambda k, x: k.scalar_right_shift(x["a"], 2),
                                  lambda c: c["a"] >> np.uint64(2), "u"),
    "scalar_left_shift": (lambda k, x: k.scalar_left_shift(x["a"], 5),
                          lambda c: (c["a"] << np.uint64(5)) % MOD, "u"),
    "scalar_left_shift[block]": (lambda k, x: k.scalar_left_shift(x["a"], 4),
                                 lambda c: (c["a"] << np.uint64(4)) % MOD, "u"),
    "scalar_rotate_right": (lambda k, x: k.scalar_rotate_right(x["a"], 3),
                            lambda c: _rot_r(c["a"], 3), "u"),
    "scalar_rotate_left": (lambda k, x: k.scalar_rotate_left(x["a"], 2),
                           lambda c: _rot_r(c["a"], BITS - 2), "u"),
    "right_shift": (lambda k, x: k.right_shift(x["a"], x["amt"]),
                    lambda c: c["a"] >> c["amt"], "u"),
    "left_shift": (lambda k, x: k.left_shift(x["a"], x["amt"]),
                   lambda c: (c["a"] << c["amt"]) % MOD, "u"),
    "scalar_eq": (lambda k, x: k.scalar_eq(x["a"], 77),
                  lambda c: c["a"] == 77, "b"),
    "scalar_ne": (lambda k, x: k.scalar_ne(x["a"], 77),
                  lambda c: c["a"] != 77, "b"),
    "scalar_lt": (lambda k, x: k.scalar_lt(x["a"], 100),
                  lambda c: c["a"] < 100, "b"),
    "scalar_le": (lambda k, x: k.scalar_le(x["a"], 77),
                  lambda c: c["a"] <= 77, "b"),
    "scalar_gt": (lambda k, x: k.scalar_gt(x["a"], 77),
                  lambda c: c["a"] > 77, "b"),
    "scalar_ge": (lambda k, x: k.scalar_ge(x["a"], 100),
                  lambda c: c["a"] >= 100, "b"),
    "scalar_lt[wide]": (lambda k, x: k.scalar_lt(x["a"], 300),
                        lambda c: c["a"] < 300, "b"),
    "scalar_bitand": (lambda k, x: k.scalar_bitand(x["a"], 0x5A),
                      lambda c: c["a"] & 0x5A, "u"),
    "scalar_bitor": (lambda k, x: k.scalar_bitor(x["a"], 0x33),
                     lambda c: c["a"] | 0x33, "u"),
    "scalar_bitxor": (lambda k, x: k.scalar_bitxor(x["a"], 0xA5),
                      lambda c: c["a"] ^ 0xA5, "u"),
    "sum_ciphertexts": (lambda k, x: k.sum_ciphertexts([x["a"], x["b"], x["d"]]),
                        lambda c: (c["a"] + c["b"] + c["d"]) % MOD, "u"),
    "div_rem": (lambda k, x: k.div_rem(x["a2"], x["b2"]),
                lambda c: (c["a2"] // c["b2"], c["a2"] % c["b2"]), ("u", "u")),
    "div": (lambda k, x: k.div(x["a2"], x["b2"]),
            lambda c: c["a2"] // c["b2"], "u"),
    "rem": (lambda k, x: k.rem(x["a2"], x["b2"]),
            lambda c: c["a2"] % c["b2"], "u"),
    "count_ones": (lambda k, x: k.count_ones(x["a"]),
                   lambda c: [bin(int(v)).count("1") for v in c["a"]], "u"),
    "count_zeros": (lambda k, x: k.count_zeros(x["a"]),
                    lambda c: [BITS - bin(int(v)).count("1") for v in c["a"]],
                    "u"),
    "is_even": (lambda k, x: k.is_even(x["a"]),
                lambda c: c["a"] % 2 == 0, "b"),
    "is_odd": (lambda k, x: k.is_odd(x["a"]),
               lambda c: c["a"] % 2 == 1, "b"),
    "ilog2": (lambda k, x: k.ilog2(x["a2"]), lambda c: _ilog2(c["a2"]), "u"),
    "signed_lt": (lambda k, x: k.signed_lt(x["s"], x["t"]),
                  lambda c: c["s"] < c["t"], "b"),
    "signed_le": (lambda k, x: k.signed_le(x["s"], x["t"]),
                  lambda c: c["s"] <= c["t"], "b"),
    "signed_gt": (lambda k, x: k.signed_gt(x["s"], x["t"]),
                  lambda c: c["s"] > c["t"], "b"),
    "signed_ge": (lambda k, x: k.signed_ge(x["s"], x["t"]),
                  lambda c: c["s"] >= c["t"], "b"),
    "signed_min": (lambda k, x: k.signed_min(x["s"], x["t"]),
                   lambda c: np.minimum(c["s"], c["t"]), "s"),
    "signed_max": (lambda k, x: k.signed_max(x["s"], x["t"]),
                   lambda c: np.maximum(c["s"], c["t"]), "s"),
    "sign_bit": (lambda k, x: k.sign_bit(x["s"]), lambda c: c["s"] < 0, "b"),
    "abs": (lambda k, x: k.abs(x["s"]), lambda c: np.abs(c["s"]), "s"),
    "signed_scalar_compare": (
        lambda k, x: k.signed_scalar_compare(x["s"], -3, lambda s: s == 1),
        lambda c: c["s"] < -3, "b"),
    "signed_scalar_lt": (lambda k, x: k.signed_scalar_lt(x["s"], 57),
                         lambda c: c["s"] < 57, "b"),
    "signed_scalar_le": (lambda k, x: k.signed_scalar_le(x["s"], 57),
                         lambda c: c["s"] <= 57, "b"),
    "signed_scalar_gt": (lambda k, x: k.signed_scalar_gt(x["s"], -100),
                         lambda c: c["s"] > -100, "b"),
    "signed_scalar_ge": (lambda k, x: k.signed_scalar_ge(x["s"], 0),
                         lambda c: c["s"] >= 0, "b"),
    "arithmetic_right_shift": (lambda k, x: k.arithmetic_right_shift(x["s"], 3),
                               lambda c: c["s"] >> 3, "s"),
    "arithmetic_right_shift_encrypted": (
        lambda k, x: k.arithmetic_right_shift_encrypted(x["s"], x["amt"]),
        lambda c: c["s"] >> c["amt"].astype(np.int64), "s"),
    "signed_div_rem": (
        lambda k, x: k.signed_div_rem(x["s2"], x["t2"]),
        lambda c: (_signed(_trunc_div(c["s2"], c["t2"]), 4),
                   _signed(c["s2"] - _trunc_div(c["s2"], c["t2"]) * c["t2"], 4)),
        ("s", "s")),
    "cast_to_num_blocks": (lambda k, x: k.cast_to_num_blocks(x["d"], 6),
                           lambda c: c["d"], "u"),
    "cast_to_num_blocks[trim]": (lambda k, x: k.cast_to_num_blocks(x["a"], 2),
                                 lambda c: c["a"] % 16, "u"),
    "signed_cast_to_num_blocks": (
        lambda k, x: k.signed_cast_to_num_blocks(x["s"], 6),
        lambda c: c["s"], "s"),
}

#: the JAX ServerKey's public names that are no op on ciphertexts
#: (``decrypt_bool`` decodes every boolean output above)
NOT_OPS = {"generate", "params", "decrypt_bool"}


def test_keys_and_encryptions_byte_equal(ctx):
    jsk, sk = ctx["jsk"], ctx["sk"]
    jck, ck = ctx["jck"], ctx["ck"]
    np.testing.assert_array_equal(to_u64(ck.key.glwe_sk.bits),
                                  np.asarray(jck.key.glwe_sk.bits))
    np.testing.assert_array_equal(to_u64(ck.key.lwe_sk.bits),
                                  np.asarray(jck.key.lwe_sk.bits))
    np.testing.assert_array_equal(to_u64(sk.key.ksk), np.asarray(jsk.key.ksk))
    assert sk.params.name == jsk.params.name
    ja, a, js, s, j5, p5 = ctx["first"]
    for j, p in ((ja, a), (js, s), (j5, p5)):
        np.testing.assert_array_equal(to_u64(p.ct), np.asarray(j.ct))
        np.testing.assert_array_equal(p.degrees, j.degrees)
        np.testing.assert_array_equal(p.noise_levels, j.noise_levels)
    np.testing.assert_array_equal(ck.decrypt_radix(a), A)
    np.testing.assert_array_equal(ck.decrypt_signed_radix(s), S)
    # a scalar encrypts to one unbatched radix ciphertext
    assert tuple(p5.ct.shape) == (NB, P.polynomial_size + 1)
    assert ck.decrypt_radix(p5) == 5


def test_public_ops_match_jax():
    """The port's ServerKey has exactly the JAX one's public names, and
    each op of radix.py (the ones of ops_extra.py are
    test_torch_integer_extra.py's) has a bit-equality case here."""
    assert public_names(radix.ServerKey) == public_names(JServerKey)
    assert public_names(radix.ClientKey) == public_names(JClientKey)
    own = {n for n in vars(JServerKey) if not n.startswith("_")}
    cased = {n.split("[")[0] for n in CASES}
    assert own - NOT_OPS == cased


@pytest.mark.parametrize("name", list(CASES))
def test_op_bit_equal(ctx, name):
    run_case(ctx, *CASES[name])


def test_convert_round_trip(ctx):
    jck, jsk, ck = ctx["jck"], ctx["jsk"], ctx["ck"]
    ja = ctx["jx"]["d"]
    arrays = convert.radix_ciphertext_to_arrays(carry_in(ja))
    np.testing.assert_array_equal(arrays[0], np.asarray(ja.ct))
    np.testing.assert_array_equal(arrays[1], ja.degrees)
    np.testing.assert_array_equal(arrays[2], ja.noise_levels)
    assert arrays[3:] == (ja.message_modulus, ja.carry_modulus)
    again = convert.radix_ciphertext_from_arrays(*arrays, device="cpu")
    np.testing.assert_array_equal(to_u64(again.ct), arrays[0])
    with pytest.raises(ValueError, match="degrees"):
        convert.radix_ciphertext_from_arrays(arrays[0], arrays[1][:2],
                                             arrays[2], 4, 4, device="cpu")
    cck, csk = convert.integer_keys_from_arrays(
        P.name, np.asarray(jck.key.glwe_sk.bits),
        np.asarray(jck.key.lwe_sk.bits), np.asarray(jsk.key.ksk),
        np.asarray(jsk.key.bsk_scan), jsk.key.num_primes, device="cpu")
    assert isinstance(cck, radix.ClientKey)
    assert isinstance(csk, radix.ServerKey)
    np.testing.assert_array_equal(cck.decrypt_radix(carry_in(ctx["jx"]["a"])), A)
    a = carry_in(ctx["jx"]["a"])
    np.testing.assert_array_equal(to_u64(csk.is_odd(a).ct),
                                  np.asarray(jsk.is_odd(ctx["jx"]["a"]).ct))
    np.testing.assert_array_equal(to_u64(csk.is_odd(a).ct),
                                  to_u64(ctx["sk"].is_odd(a).ct))


def test_cpu_ops_launch_no_kernel(ctx):
    pk.reset_launches()
    out = ctx["sk"].add(ctx["px"]["a"], ctx["px"]["b"])
    assert out.ct.device.type == "cpu"
    np.testing.assert_array_equal(ctx["ck"].decrypt_radix(out), (A + B) % MOD)
    for fn in pk.KERNELS:
        assert fn.launches == 0, fn.__name__


def test_entry_points_without_device_need_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        radix.ClientKey.generate(P, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        gen_keys(P, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.radix_ciphertext_from_arrays(
            np.zeros((NB, P.polynomial_size + 1), np.uint64),
            np.zeros(NB), np.zeros(NB), 4, 4)
