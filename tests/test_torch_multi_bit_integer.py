"""The port's integer layer and HLAPI on a multi-bit key against
``tfhe_tpu`` on the CPU (the kernels' plain versions: K2 u64 -> K5),
exactly: 4-block radix add, mul and eq on JAX encryptions carried in, the
integer (FheUint) OPRF, and an HLAPI ``FheUint8`` chain under
``ConfigBuilder().use_custom_parameters(PARAM_TEST_TOY_MULTI_BIT)``. The
radix ops need nothing of their own for multi-bit: every PBS is the
shortint ``apply_lookup_table``, which takes the multi-bit path. Outputs
equal tfhe_tpu's bit for bit (blocks, degrees, noise levels) and decrypt to
the clear result; tolerance: exact."""

import numpy as np
import pytest

from tfhe_tpu.high_level_api import api as japi
from tfhe_tpu.integer.radix import ClientKey as JClientKey
from tfhe_tpu.integer.radix import ServerKey as JServerKey
from tfhe_tpu.utils.params import PARAM_TEST_TOY_MULTI_BIT as JP

from test_torch_hlapi import assert_same, carry_in as carry_in_hl
from test_torch_integer_ops import assert_unchanged, carry_in, snapshot
from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch._torus import to_u64
from tfhe_tpu_torch.high_level_api import api
from tfhe_tpu_torch.integer import radix
from tfhe_tpu_torch.utils.params import PARAM_TEST_TOY_MULTI_BIT as P

SEED = 99  # tests/test_integer_ops.py's key seed
NB = 4  # blocks: 8-bit values at 2 message bits a block
A, B = np.array([200, 37], dtype=np.uint64), np.array([57, 37],
                                                      dtype=np.uint64)


@pytest.fixture(scope="module")
def ctx():
    jck = JClientKey.generate(JP, seed=SEED)
    ck = radix.ClientKey.generate(P, seed=SEED, device="cpu")
    return {"jck": jck, "jsk": JServerKey.generate(jck), "ck": ck,
            "sk": radix.ServerKey.generate(ck)}


CLEAR = {"add": lambda a, b: (a + b) % 256,
         "mul": lambda a, b: (a * b) % 256,
         "eq": lambda a, b: (a == b).astype(np.uint64)}


@pytest.mark.parametrize("op", list(CLEAR))
def test_radix_op_equal(ctx, op):
    clear = CLEAR[op]
    ja, jb = (ctx["jck"].encrypt_radix(v, NB) for v in (A, B))
    a, b = carry_in(ja), carry_in(jb)
    snaps = [snapshot(a), snapshot(b)]
    want = getattr(ctx["jsk"], op)(ja, jb)
    got = getattr(ctx["sk"], op)(a, b)
    np.testing.assert_array_equal(to_u64(got.ct), np.asarray(want.ct))
    if op == "eq":
        value = ctx["sk"].decrypt_bool(ctx["ck"], got).astype(np.uint64)
    else:
        np.testing.assert_array_equal(got.degrees, want.degrees)
        np.testing.assert_array_equal(got.noise_levels, want.noise_levels)
        value = ctx["ck"].decrypt_radix(got)
    np.testing.assert_array_equal(value, clear(A, B))
    for x, s in zip((a, b), snaps):
        assert_unchanged(x, s)


@pytest.mark.parametrize("bits", [5, None])
def test_integer_oprf_equal(ctx, bits):
    """The FheUint OPRF: every block's seeded LWE through one batched
    multi-bit PBS, equal to tfhe_tpu's per-block loop."""
    want = ctx["jsk"].generate_oblivious_pseudo_random(
        seed=7, num_blocks=NB, random_bits_count=bits)
    got = ctx["sk"].generate_oblivious_pseudo_random(
        seed=7, num_blocks=NB, random_bits_count=bits)
    np.testing.assert_array_equal(to_u64(got.ct), np.asarray(want.ct))
    np.testing.assert_array_equal(got.degrees, want.degrees)
    assert 0 <= int(ctx["ck"].decrypt_radix(got)) < (1 << (bits or 8))


def test_hlapi_fheuint8_chain():
    """``generate_keys`` on a multi-bit config, then ((a + b) * 3 min c)
    ^ 0x5A and its eq with c, and a cast of a, step by step in both
    packages."""
    def config(m):
        return m.ConfigBuilder().use_custom_parameters(
            JP if m is japi else P).with_seed(SEED).build()

    jck, jsk = japi.generate_keys(config(japi))
    ck, sk = api.generate_keys(config(api), device="cpu")
    assert sk.inner.key.bsk_mb is not None
    old = japi._SERVER_KEY
    japi.set_server_key(jsk)
    api.set_server_key(sk)
    try:
        ja = japi.FheUint8.encrypt(200, jck)
        jb = japi.FheUint8.encrypt(57, jck)
        jc = japi.FheUint8.encrypt(100, jck)
        args = {japi: (ja, jb, jc),
                api: tuple(carry_in_hl(x) for x in (ja, jb, jc))}
        steps = [lambda m, x: x + args[m][1], lambda m, x: x * 3,
                 lambda m, x: x.min(args[m][2]), lambda m, x: x ^ 0x5A,
                 lambda m, x: x.eq(args[m][2]),
                 lambda m, x: x.cast_into(m.FheUint16)]
        want = [1, 3, 3, 0x59, False, 200]
        jx, x = ja, args[api][0]
        for step, clear in zip(steps, want):
            jx, x = step(japi, jx), step(api, x)
            assert_same(jx, x)
            assert x.decrypt(ck) == clear
            if isinstance(x, api.FheBool):
                jx, x = ja, args[api][0]
    finally:
        japi.set_server_key(old)
        api.unset_server_key()
