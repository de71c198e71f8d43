"""The port's typed high-level API (``tfhe_tpu_torch.high_level_api``)
against ``tfhe_tpu.high_level_api`` at PARAM_TEST_TOY on the CPU: the tests
of ``tests/test_hlapi.py``, the reference README chain, ``test_tag_propagation``
and ``test_fhe_array_elementwise`` of ``tests/test_hlapi_extra.py`` and
``test_kv_store`` of ``tests/test_pk_kv.py``.

Same seed => byte-equal keys. Every input is a JAX encryption carried into
the port type of the same name; each operator, cast, comparison, array op
and ``KVStore`` op runs in both packages (each with its own global server
key) and the port's output must equal the JAX one bit for bit (tolerance
0: blocks, degrees, noise levels, type), decrypt to the clear result, and
leave every input unchanged. Every entry the port does not carry yet
raises ``NotImplementedError`` naming its ROADMAP item by number and title.
"""

import numpy as np
import pytest
import torch

from tfhe_tpu import high_level_api as jhl
from tfhe_tpu.high_level_api import api as japi
from tfhe_tpu.high_level_api import kv_store as jkv
from tfhe_tpu.utils.params import PARAM_TEST_TOY as JP
from test_torch_integer_ops import assert_unchanged, snapshot
from test_torch_integer_ops import carry_in as carry_in_integer
from test_torch_strings import one_torch_thread  # noqa: F401  (autouse)

from tfhe_tpu_torch import high_level_api as hl
from tfhe_tpu_torch._torus import to_u64
from tfhe_tpu_torch.high_level_api import api
from tfhe_tpu_torch.high_level_api import kv_store
from tfhe_tpu_torch.utils.params import PARAM_TEST_TOY as P

SEED = 7  # tests/test_hlapi.py's key seed


def config(m, params, seed=SEED):
    return m.ConfigBuilder().use_custom_parameters(params).with_seed(seed).build()


@pytest.fixture(scope="module")
def keys():
    jck, jsk = japi.generate_keys(config(japi, JP))
    ck, sk = api.generate_keys(config(api, P), device="cpu")
    return {"jck": jck, "jsk": jsk, "ck": ck, "sk": sk}


@pytest.fixture(autouse=True)
def server_keys(keys):
    """Both packages' global server keys for one test, then the JAX one the
    test found (other JAX test files set their own)."""
    old = japi._SERVER_KEY
    japi.set_server_key(keys["jsk"])
    api.set_server_key(keys["sk"])
    yield
    japi.set_server_key(old)
    api.unset_server_key()


def carry_in(x):
    """A JAX HLAPI value carried into the port type of the same name."""
    if isinstance(x, japi.FheBool):
        return api.FheBool(carry_in_integer(x.block))
    if isinstance(x, (japi._FheIntegerBase, japi._FheArrayBase)):
        return getattr(api, type(x).__name__)(carry_in_integer(x.ct))
    return x


def _inner(x):
    return x.block if isinstance(x, api.FheBool) else x.ct


def assert_same(jout, out):
    """Port output (an HLAPI value, or a tuple of them) == the JAX one:
    same type name, same blocks, degrees and noise levels."""
    if isinstance(jout, tuple):
        assert isinstance(out, tuple) and len(out) == len(jout)
        for j, o in zip(jout, out):
            assert_same(j, o)
        return
    assert type(out).__name__ == type(jout).__name__
    assert type(out).__module__.startswith("tfhe_tpu_torch.")
    j, o = (jout.block, out.block) if isinstance(jout, japi.FheBool) else (
        jout.ct, out.ct)
    np.testing.assert_array_equal(to_u64(o.ct), np.asarray(j.ct))
    if not isinstance(jout, japi.FheBool):
        np.testing.assert_array_equal(o.degrees, j.degrees)
        np.testing.assert_array_equal(o.noise_levels, j.noise_levels)


def clear(keys, out):
    if isinstance(out, tuple):
        return tuple(clear(keys, o) for o in out)
    got = out.decrypt(keys["ck"])
    return [int(v) for v in got] if isinstance(out, api._FheArrayBase) else got


def run(keys, fn, *args):
    """``fn(api_module, *args)`` in both packages on the same inputs (JAX
    encryptions carried into the port): outputs bit-equal, inputs
    unchanged. Returns the port output's clear value."""
    pargs = [carry_in(a) for a in args]
    snaps = [snapshot(_inner(a)) for a in pargs]
    jout = fn(japi, *args)
    out = fn(api, *pargs)
    assert_same(jout, out)
    for a, s in zip(pargs, snaps):
        assert_unchanged(_inner(a), s)
    return clear(keys, out)


def enc(keys, ty, value):
    return getattr(japi, ty).encrypt(value, keys["jck"])


# -- tests/test_hlapi.py -------------------------------------------------------

def test_readme_example(keys):
    a, b = enc(keys, "FheUint32", 1344), enc(keys, "FheUint32", 5)
    c = enc(keys, "FheUint8", 7)
    assert run(keys, lambda m, b: b << 1, b) == 5 << 1
    assert run(keys, lambda m, a, b: a * b, a, b) == 1344 * 5
    assert run(keys, lambda m, a: a.cast_into(m.FheUint8), a) == 1344 % 256
    assert run(keys, lambda m, a, c: a.cast_into(m.FheUint8).min(c), a,
               c) == min(1344 % 256, 7)


def test_readme_chain(keys):
    """The reference README's own chain: (a * b) >> b, cast to FheUint8,
    min with c, & 1 (1344, 5, 7 -> 6720, 210, 210, 7, 1)."""
    a, b = enc(keys, "FheUint32", 1344), enc(keys, "FheUint32", 5)
    c = enc(keys, "FheUint8", 7)
    steps = [lambda m, x: x * b_[m], lambda m, x: x >> b_[m],
             lambda m, x: x.cast_into(m.FheUint8), lambda m, x: x.min(c_[m]),
             lambda m, x: x & 1]
    b_, c_ = {japi: b, api: carry_in(b)}, {japi: c, api: carry_in(c)}
    x, got = a, []
    for step in steps:
        got.append(run(keys, step, x))
        x = step(japi, x)
    assert got == [6720, 210, 210, 7, 1]


def test_operators(keys):
    a, b = enc(keys, "FheUint8", 200), enc(keys, "FheUint8", 57)
    assert run(keys, lambda m, a, b: (a + b, a - b), a, b) == (
        (200 + 57) % 256, (200 - 57) % 256)
    assert run(keys, lambda m, a: (a + 100, a * 3, a & 0x0F, ~a, a >> 2,
                                   a.rotate_left(3)), a) == (
        (200 + 100) % 256, (200 * 3) % 256, 200 & 0x0F, (~200) % 256,
        200 >> 2, ((200 << 3) | (200 >> 5)) % 256)
    assert run(keys, lambda m, a, b: (a // b, a % b), a, b) == (
        200 // 57, 200 % 57)


def test_comparisons_and_select(keys):
    a, b = enc(keys, "FheUint8", 13), enc(keys, "FheUint8", 200)
    assert run(keys, lambda m, a, b: (a.lt(b), a.ge(b), a.lt(100)), a, b) == (
        True, False, True)
    assert run(keys, lambda m, a, b: a.lt(b).select(a, b), a, b) == 13
    assert run(keys, lambda m, b: b.overflowing_add(b), b) == (400 % 256, True)


def test_fhebool_algebra(keys):
    t, f = enc(keys, "FheBool", True), enc(keys, "FheBool", False)
    assert run(keys, lambda m, t, f: (t & f, t | f, t ^ t, ~f), t, f) == (
        False, True, False, True)


def _wrap_i8(v: int) -> int:
    return (v + 128) % 256 - 128


def test_signed(keys):
    a, b = enc(keys, "FheInt8", -57), enc(keys, "FheInt8", 13)
    assert run(keys, lambda m, a, b: (a + b, a - b, a * b), a, b) == (
        -44, -70, _wrap_i8(-57 * 13))
    assert run(keys, lambda m, a, b: (a.lt(b), a.gt(b), a.lt(-100)), a, b) == (
        True, False, False)
    assert run(keys, lambda m, a, b: (a.abs(), a >> 2, a.min(b)), a, b) == (
        57, -57 >> 2, -57)
    assert run(keys, lambda m, a, b: a.div_rem(b), a, b) == (
        int(-57 / 13), -57 - int(-57 / 13) * 13)  # trunc toward zero
    assert run(keys, lambda m, a: a.cast_into(m.FheInt16), a) == -57


def test_trivial_encrypt(keys):
    out = run(keys, lambda m: m.FheUint8.encrypt_trivial(42))
    assert out == 42
    t = api.FheUint8.encrypt_trivial(42)
    assert t.ct.ct.device == keys["sk"].inner.key.device


# -- tests/test_hlapi_extra.py, tests/test_pk_kv.py ----------------------------

def test_tag_propagation(keys):
    ck = keys["ck"]
    old = ck.tag
    ck.tag = api.Tag(b"tenant-42")
    try:
        assert ck.tag == api.Tag(b"tenant-42")
        assert ck.tag != api.Tag(b"tenant-43")
        assert api.ServerKey(keys["sk"].inner, tag=ck.tag).tag == ck.tag
        # the compressed server key that carries the tag in the JAX test
        with pytest.raises(NotImplementedError,
                           match="item 6: shortint side modules"):
            api.CompressedServerKey.generate(ck)
    finally:
        ck.tag = old


def test_fhe_array_elementwise(keys):
    a = getattr(japi, "FheUint8Array").encrypt([10, 200, 31], keys["jck"])
    b = getattr(japi, "FheUint8Array").encrypt([5, 100, 1], keys["jck"])
    assert run(keys, lambda m, a, b: (a + b, a & b), a, b) == (
        [15, 44, 32], [10 & 5, 200 & 100, 31 & 1])
    assert run(keys, lambda m, a: (a[1], a[0:2]), a) == (200, [10, 200])
    assert run(keys, lambda m, a: a.sum(), a) == (10 + 200 + 31) % 256
    assert list(run(keys, lambda m, a, b: a.eq(b), a, a)) == [True] * 3
    assert len(carry_in(a)) == 3


def test_kv_store(keys):
    k10, k20 = enc(keys, "FheUint8", 10), enc(keys, "FheUint8", 20)
    v111, v222 = enc(keys, "FheUint8", 111), enc(keys, "FheUint8", 222)
    pairs = [(k10, v111), (k20, v222)]
    stores = {japi: jkv.KVStore(), api: kv_store.KVStore()}
    for k, v in pairs:
        stores[japi].insert(k, v)
        stores[api].insert(carry_in(k), carry_in(v))
    assert len(stores[api]) == 2
    assert run(keys, lambda m, q: stores[m].get(q), k20) == 222
    assert run(keys, lambda m, q: stores[m].get(q),
               enc(keys, "FheUint8", 99)) == 0
    assert run(keys, lambda m, q: stores[m].contains(q), k10) is True
    assert run(keys, lambda m, q: stores[m].contains(q),
               enc(keys, "FheUint8", 9)) is False
    q, v = enc(keys, "FheUint8", 10), enc(keys, "FheUint8", 42)
    assert run(keys, lambda m, q, v: stores[m].update(q, v) or stores[m].get(q),
               q, v) == 42
    assert run(keys, lambda m, q: stores[m].get(q), k10) == 42
    assert run(keys, lambda m, q: stores[m].get(q), k20) == 222
    assert kv_store.KVStore().get(carry_in(k10)) is None


# -- keys, devices, coverage, what raises ---------------------------------------

def test_keys_and_encryptions_byte_equal():
    jck, _ = japi.generate_keys(config(japi, JP, seed=11))
    ck, sk = hl.generate_keys(config(hl, P, seed=11), device="cpu")
    np.testing.assert_array_equal(to_u64(ck.inner.key.lwe_sk.bits),
                                  np.asarray(jck.inner.key.lwe_sk.bits))
    assert sk.inner.key.device == torch.device("cpu")
    j, p = japi.FheUint16.encrypt(4321, jck), hl.FheUint16.encrypt(4321, ck)
    assert_same(j, p)
    assert p.decrypt(ck) == 4321
    assert_same(japi.FheBool.encrypt(True, jck), hl.FheBool.encrypt(True, ck))
    assert api.Config().parameters.name == "PARAM_MESSAGE_2_CARRY_2_KS_PBS"


def test_entry_points_need_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.generate_keys(config(api, P))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.ClientKey.generate(config(api, P))


UNPORTED = {
    "keycache": (lambda: api.generate_keys(config(api, P), use_keycache=True,
                                           device="cpu"), (9,)),
    "compression_config": (lambda: api.generate_keys(
        api.ConfigBuilder().use_custom_parameters(P)
        .enable_compression(object()).build(), device="cpu"), (6,)),
    "noise_squashing_config": (lambda: api.ClientKey.generate(
        api.ConfigBuilder().use_custom_parameters(P)
        .enable_noise_squashing(object()).build(), device="cpu"), (7,)),
    "squash_noise": (lambda: api.FheUint8.encrypt_trivial(3).squash_noise(),
                     (7,)),
    "SquashedNoiseFheUint": (lambda: api.SquashedNoiseFheUint(None, 8, 4),
                             (7,)),
    "CompressedSquashedNoiseCiphertextList": (
        lambda: api.CompressedSquashedNoiseCiphertextList.builder(), (7,)),
    "CompressedServerKey": (lambda: api.CompressedServerKey(None), (6,)),
    "CompressedXofKeySet": (
        lambda: api.CompressedXofKeySet.generate(api.Config(), seed=1), (6,)),
    "CompactPublicKey": (lambda: api.CompactPublicKey.new(None, None, None,
                                                          None), (6, 9)),
    "HlCompactCiphertextList": (lambda: api.HlCompactCiphertextList(None),
                                (6, 9)),
    "CompactCiphertextListBuilder": (
        lambda: api.CompactCiphertextListBuilder(None), (6, 9)),
    "HlCompressedCiphertextList": (
        lambda: api.HlCompressedCiphertextList(None, []), (6,)),
    "CompressedCiphertextListBuilder": (
        lambda: api.CompressedCiphertextListBuilder(), (6,)),
    "safe_serialize": (lambda: api.safe_serialize(None), (9,)),
    "safe_deserialize": (lambda: api.safe_deserialize(b""), (9,)),
}

TITLES = {6: "shortint side modules", 7: "u128 noise squashing",
          9: "platform layers"}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_entries_raise(name):
    """Each entry whose module the port does not carry yet raises, naming
    every ROADMAP item it waits on by number and title."""
    fn, items = UNPORTED[name]
    with pytest.raises(NotImplementedError) as err:
        fn()
    msg = str(err.value)
    assert "ROADMAP Queue A" in msg
    for i in items:
        assert f"item {i}: {TITLES[i]}" in msg, msg


def _public(cls):
    return {n for n in dir(cls) if not n.startswith("_")}


def test_public_names_match_jax():
    """Every public method of the JAX FheBool, integer base, array base and
    KVStore, every name of the JAX ``high_level_api.__all__``, and every
    public class or function of the JAX api module has a counterpart."""
    for j, p in ((japi.FheBool, api.FheBool),
                 (japi._FheIntegerBase, api._FheIntegerBase),
                 (japi._FheArrayBase, api._FheArrayBase),
                 (jkv.KVStore, kv_store.KVStore),
                 (japi.ConfigBuilder, api.ConfigBuilder),
                 (japi.Config, api.Config), (japi.Tag, api.Tag)):
        assert _public(j) == _public(p), j.__name__
    assert set(jhl.__all__) == set(hl.__all__)
    assert all(hasattr(hl, n) for n in hl.__all__)
    jnames = {n for n, v in vars(japi).items()
              if not n.startswith("_") and callable(v)
              and getattr(v, "__module__", "") == japi.__name__}
    assert jnames <= set(vars(api)), sorted(jnames - set(vars(api)))
    assert api.fhe_uint(32) is hl.FheUint32 and api.fhe_int(8) is hl.FheInt8
    assert api.fhe_uint_array(8) is api.FheUint8Array
    assert api.FheUint8Array.SCALAR_TYPE is api.FheUint8
