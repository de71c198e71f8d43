"""The port's integer op tail (``tfhe_tpu_torch.integer.ops_extra``) against
``tfhe_tpu.integer.ops_extra`` at PARAM_TEST_TOY, 4 blocks (8-bit values),
on the CPU: every public op of ``RadixExtraOps`` on the same inputs (JAX
encryptions carried into the port) gives the JAX output bit for bit
(tolerance 0), with equal degrees and noise levels, decrypts to the clear
oracle and leaves its inputs unchanged; the OPRF's one batched PBS equals
the JAX per-block loop. The ``scalar_div_rem`` cases, the deepest, run
from ``test_torch_integer_div.py`` (``DIV_CASES``), so that they do not
share a worker with this file's."""

import numpy as np
import pytest

from tfhe_tpu_torch._torus import to_u64

from tfhe_tpu.integer.ops_extra import RadixExtraOps as JRadixExtraOps
from test_torch_integer_ops import (  # noqa: F401  (one_torch_thread: autouse)
    carry_in, integer_keys, one_torch_thread, public_names, run_case)
from tfhe_tpu_torch.integer.ops_extra import RadixExtraOps

SEED = 21  # tests/test_integer_extra.py's key seed
NB = 4
BITS = 8
MOD = 1 << BITS

A = np.array([77, 200], dtype=np.uint64)
B = np.array([77, 13], dtype=np.uint64)  # lane 0: a == b
AMT = np.array([3, 1], dtype=np.uint64)
A2 = np.array([5, 0], dtype=np.uint64)  # 2 blocks: 4-bit values
B2 = np.array([7, 13], dtype=np.uint64)


@pytest.fixture(scope="module")
def ctx():
    jck, jsk, ck, sk = integer_keys(SEED)
    jx = {"a": jck.encrypt_radix(A, NB), "b": jck.encrypt_radix(B, NB),
          "amt": jck.encrypt_radix(AMT, NB),
          "a2": jck.encrypt_radix(A2, 2), "b2": jck.encrypt_radix(B2, 2)}
    jx["d"] = jsk.unchecked_add(jx["a"], jx["b"])  # carry-dirty, degrees 6
    clear = {"a": A, "b": B, "amt": AMT, "a2": A2, "b2": B2,
             "d": (A + B) % MOD}
    return {"jck": jck, "jsk": jsk, "ck": ck, "sk": sk, "jx": jx,
            "px": {k: carry_in(v) for k, v in jx.items()}, "clear": clear}


def _lz(v, bits):
    return [bits - int(x).bit_length() for x in v]


def _tz(v, bits):
    return [bits if int(x) == 0 else (int(x) & -int(x)).bit_length() - 1
            for x in v]


def _rot(v, s, left):
    v, s = np.asarray(v, dtype=object), np.asarray(s, dtype=object)
    if left:
        s = (BITS - s) % BITS
    return ((v >> s) | (v << (BITS - s))) % MOD


def _first_index(v, clears):
    return [clears.index(int(x)) if int(x) in clears else 0 for x in v]


CLEARS = [1, 77, 200, 77]
MATCHES = [(77, 3), (200, 15), (100, 1)]

# name -> (fn(server key, inputs), oracle(clear inputs), output kind)
CASES = {
    "sum_ciphertexts_parallelized": (
        lambda k, x: k.sum_ciphertexts_parallelized(
            [x["a"], x["b"], x["d"], x["b"]]),
        lambda c: (c["a"] + 2 * c["b"] + c["d"]) % MOD, "u"),
    "mul_parallelized": (lambda k, x: k.mul_parallelized(x["d"], x["b"]),
                         lambda c: (c["d"] * c["b"]) % MOD, "u"),
    "overflowing_add": (
        lambda k, x: k.overflowing_add(x["a"], x["b"]),
        lambda c: ((c["a"] + c["b"]) % MOD,
                   c["a"].astype(int) + c["b"].astype(int) >= MOD), ("u", "b")),
    "overflowing_sub": (lambda k, x: k.overflowing_sub(x["a"], x["b"]),
                        lambda c: ((c["a"] - c["b"]) % MOD, c["a"] < c["b"]),
                        ("u", "b")),
    "overflowing_mul": (lambda k, x: k.overflowing_mul(x["a2"], x["b2"]),
                        lambda c: ((c["a2"] * c["b2"]) % 16,
                                   c["a2"] * c["b2"] >= 16), ("u", "b")),
    "match_value": (
        lambda k, x: k.match_value(x["b"], MATCHES),
        lambda c: ([dict(MATCHES).get(int(v), 0) for v in c["b"]],
                   [int(v) in dict(MATCHES) for v in c["b"]]), ("u", "b")),
    "match_value_or": (
        lambda k, x: k.match_value_or(x["b"], [(13, 2)], default=9),
        lambda c: ([2 if v == 13 else 9 for v in c["b"]], c["b"] == 13),
        ("u", "b")),
    "is_in_clears": (lambda k, x: k.is_in_clears(x["b"], CLEARS),
                     lambda c: [int(v) in CLEARS for v in c["b"]], "b"),
    "contains": (lambda k, x: k.contains([x["d"], x["b"]], x["a"]),
                 lambda c: (c["d"] == c["a"]) | (c["b"] == c["a"]), "b"),
    "contains_clear": (lambda k, x: k.contains_clear([x["a"], x["b"]], 13),
                       lambda c: (c["a"] == 13) | (c["b"] == 13), "b"),
    "index_in_clears": (
        lambda k, x: k.index_in_clears(x["a"], CLEARS),
        lambda c: (_first_index(c["a"], CLEARS),
                   [int(v) in CLEARS for v in c["a"]]), ("u", "b")),
    "first_index_in_clears": (
        lambda k, x: k.first_index_in_clears(x["b"], CLEARS),
        lambda c: (_first_index(c["b"], CLEARS),
                   [int(v) in CLEARS for v in c["b"]]), ("u", "b")),
    "index_of": (
        lambda k, x: k.index_of([x["b"], x["a"], x["a"]], x["a"]),
        lambda c: (np.where(c["b"] == c["a"], 0, 1), [True, True]),
        ("u", "b")),
    "scalar_div": (lambda k, x: k.scalar_div(x["a"], 1),
                   lambda c: c["a"], "u"),
    "scalar_rem": (lambda k, x: k.scalar_rem(x["d"], 16),
                   lambda c: c["d"] % 16, "u"),
    "reverse_bits": (
        lambda k, x: k.reverse_bits(x["a"]),
        lambda c: [int(f"{int(v):08b}"[::-1], 2) for v in c["a"]], "u"),
    "scalar_bitslice": (lambda k, x: k.scalar_bitslice(x["a"], 2, 6),
                        lambda c: (c["a"] >> np.uint64(2)) & 0xF, "u"),
    "leading_zeros": (lambda k, x: k.leading_zeros(x["a2"]),
                      lambda c: _lz(c["a2"], 4), "u"),
    "trailing_zeros": (lambda k, x: k.trailing_zeros(x["a2"]),
                       lambda c: _tz(c["a2"], 4), "u"),
    "leading_ones": (lambda k, x: k.leading_ones(x["b2"]),
                     lambda c: _lz(c["b2"] ^ 0xF, 4), "u"),
    "trailing_ones": (lambda k, x: k.trailing_ones(x["b2"]),
                      lambda c: _tz(c["b2"] ^ 0xF, 4), "u"),
    "rotate_right": (lambda k, x: k.rotate_right(x["a"], x["amt"]),
                     lambda c: _rot(c["a"], c["amt"], left=False), "u"),
    "rotate_left": (lambda k, x: k.rotate_left(x["a"], x["amt"]),
                    lambda c: _rot(c["a"], c["amt"], left=True), "u"),
    "scalar_dot_product": (
        lambda k, x: k.scalar_dot_product([x["a"], x["b"], x["d"]], [2, 0, 3]),
        lambda c: (2 * c["a"] + 3 * c["d"]) % MOD, "u"),
}

# run by test_torch_integer_div.py
DIV_CASES = {
    "scalar_div_rem": (lambda k, x: k.scalar_div_rem(x["a"], 3),
                       lambda c: (c["a"] // 3, c["a"] % 3), ("u", "u")),
    "scalar_div_rem[pow2]": (lambda k, x: k.scalar_div_rem(x["a"], 8),
                             lambda c: (c["a"] // 8, c["a"] % 8), ("u", "u")),
    "scalar_div_rem[wide]": (lambda k, x: k.scalar_div_rem(x["a"], 300),
                             lambda c: (c["a"] * 0, c["a"]), ("u", "u")),
}


def test_public_ops_match_jax():
    """The port's RadixExtraOps has exactly the JAX one's public names, and
    each op has a bit-equality case here or in test_torch_integer_div.py
    (the OPRF: the test below)."""
    assert public_names(RadixExtraOps) == public_names(JRadixExtraOps)
    cased = {n.split("[")[0] for n in list(CASES) + list(DIV_CASES)}
    assert public_names(JRadixExtraOps) - {
        "generate_oblivious_pseudo_random"} == cased


@pytest.mark.parametrize("name", list(CASES))
def test_op_bit_equal(ctx, name):
    run_case(ctx, *CASES[name])


def test_oblivious_pseudo_random_one_batched_pbs(ctx, monkeypatch):
    """The integer OPRF runs its blocks' seeded LWEs through ONE batched
    PBS (one plain K2 u64 -> K3 call on the exact CRT key); the blocks,
    degrees and noise levels equal tfhe_tpu's per-block loop bit for bit,
    for a bound inside a block (5 bits: 2 + 2 + 1, then a trivial zero
    block) and for every bit, and the value decrypts below its bound."""
    from tfhe_tpu_torch.ops import pbs_kernel as pk

    calls = []
    real = pk.blind_rotate_crt_plain
    monkeypatch.setattr(pk, "blind_rotate_crt_plain",
                        lambda *a: calls.append(a) or real(*a))
    for bits in (5, None):
        calls.clear()
        want = ctx["jsk"].generate_oblivious_pseudo_random(
            seed=7, num_blocks=NB, random_bits_count=bits)
        got = ctx["sk"].generate_oblivious_pseudo_random(
            seed=7, num_blocks=NB, random_bits_count=bits)
        np.testing.assert_array_equal(to_u64(got.ct), np.asarray(want.ct))
        np.testing.assert_array_equal(got.degrees, want.degrees)
        np.testing.assert_array_equal(got.noise_levels, want.noise_levels)
        assert len(calls) == 1
        value = int(ctx["ck"].decrypt_radix(got))
        assert 0 <= value < (1 << (bits or BITS))
    assert got.degrees.tolist() == [3, 3, 3, 3]
