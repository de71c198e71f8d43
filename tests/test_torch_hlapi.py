"""The port's typed high-level API (``tfhe_tpu_torch.high_level_api``)
against ``tfhe_tpu.high_level_api`` at PARAM_TEST_TOY on the CPU: the tests
of ``tests/test_hlapi.py``, the reference README chain, the tests of
``tests/test_hlapi_extra.py`` but noise squashing
(``test_tag_propagation``, ``test_fhe_array_elementwise``, the compressed
server key, the compact public key, the compressed and the compact list,
the XOF key set) and ``test_kv_store`` of ``tests/test_pk_kv.py``.

Same seed => byte-equal keys. Every input is a JAX encryption carried into
the port type of the same name; each operator, cast, comparison, array op
and ``KVStore`` op runs in both packages (each with its own global server
key) and the port's output must equal the JAX one bit for bit (tolerance
0: blocks, degrees, noise levels, type), decrypt to the clear result, and
leave every input unchanged. The entries of the shortint side modules
(ROADMAP Queue A item 6) give tfhe_tpu's keys and outputs bit for bit; the
encryption randomness of a compact list (``secrets.randbits``, read by both
packages) is pinned for that. ``safe_serialize`` writes tfhe_tpu's bytes,
``safe_deserialize`` reads them (size limit, conformance), and
``generate_keys(use_keycache=True)`` gives the seed's keys from a cache
under ``tmp_path``. The ZK half of the compact lists (``build_with_proof``,
``verify_and_expand``) gives tfhe_tpu's lists, proofs and values
(``secrets.token_bytes`` pinned too).
"""

import dataclasses
import secrets

import numpy as np
import pytest
import torch

from tfhe_tpu import high_level_api as jhl
from tfhe_tpu.high_level_api import api as japi
from tfhe_tpu.high_level_api import kv_store as jkv
from tfhe_tpu.shortint import list_compression as jlc
from tfhe_tpu.utils import params as jparams
from tfhe_tpu.utils.params import PARAM_TEST_TOY as JP
from test_torch_integer_ops import assert_unchanged, snapshot
from test_torch_integer_ops import carry_in as carry_in_integer
from test_torch_strings import one_torch_thread  # noqa: F401  (autouse)

from tfhe_tpu_torch import high_level_api as hl
from tfhe_tpu_torch._torus import to_u32, to_u64
from tfhe_tpu_torch.high_level_api import api
from tfhe_tpu_torch.high_level_api import kv_store
from tfhe_tpu_torch.shortint import list_compression as lc
from tfhe_tpu_torch.utils import params as pm
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
        # drawn from both packages' keygen streams, which stay in step
        csk = api.CompressedServerKey.generate(ck)
        jcsk = japi.CompressedServerKey.generate(keys["jck"])
        np.testing.assert_array_equal(to_u64(csk.inner.ksk_bodies),
                                      jcsk.inner.ksk_bodies)
        assert csk.tag == ck.tag
        assert csk.decompress().tag == ck.tag
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


@pytest.fixture(scope="module")
def zk_lists(keys):
    """A typed proven compact list (FheUint4 11, FheBool True, FheUint8 200)
    in both packages: the toy compact set of dimension 16 onto the big key
    (seed 41), the v2 CRS for bins of 16 (seed 2), ``secrets`` pinned."""
    import tfhe_tpu.zk.proven_list as jpl

    import tfhe_tpu_torch.zk.proven_list as ppl

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(secrets, "randbits", lambda k: (1 << k) // 5)
        mp.setattr(secrets, "token_bytes", lambda k: b"\x0b" * k)
        jcpk, cpk = _cpks(keys, 16, "ZK", 41)
        jcrs = jpl.crs_for_params_v2(jcpk.pk.params, 16, seed=2)
        crs = ppl.crs_for_params_v2(cpk.pk.params, 16, seed=2)
        _use_keys(keys)
        jl = japi.CompactCiphertextListBuilder(jcpk).push(
            11, japi.FheUint4).push(True, japi.FheBool).push(
            200, japi.FheUint8).build_with_proof(jcrs, metadata=b"hl")
        lst = api.CompactCiphertextListBuilder(cpk).push(
            11, api.FheUint4).push(True, api.FheBool).push(
            200, api.FheUint8).build_with_proof(crs, metadata=b"hl")
    return jl, lst, jcrs, crs


def _zk_build_with_proof(keys, zk):
    jl, lst, _, _ = zk
    np.testing.assert_array_equal(to_u64(lst.clist.masks), jl.clist.masks)
    np.testing.assert_array_equal(to_u64(lst.clist.bodies), jl.clist.bodies)
    assert [p.to_bytes() for p in lst.proofs] == \
        [p.to_bytes() for p in jl.proofs]
    assert lst.metadata == b"hl" and len(lst) == 3


def _zk_verify_and_expand(keys, zk):
    jl, lst, jcrs, crs = zk
    _use_keys(keys)
    jvals = jl.verify_and_expand(jcrs, metadata=b"hl")
    vals = lst.verify_and_expand(crs, metadata=b"hl")
    for jv, v in zip(jvals, vals):
        assert_same(jv, v)
    assert [clear(keys, v) for v in vals] == [11, True, 200]
    with pytest.raises(ValueError, match="invalid ZK proof"):
        lst.verify_and_expand(crs, metadata=b"other")
    bad = dataclasses.replace(lst.clist, bodies=lst.clist.bodies.clone())
    bad.bodies[2] += 1 << 60
    with pytest.raises(ValueError, match="invalid ZK proof"):
        api.HlCompactCiphertextList(bad, lst.entries, lst.pk, lst.proofs,
                                    lst.metadata).verify_and_expand(
            crs, metadata=b"hl")


ZK_ENTRIES = {"verify_and_expand": _zk_verify_and_expand,
              "build_with_proof": _zk_build_with_proof}


@pytest.mark.parametrize("name", list(ZK_ENTRIES))
def test_zk_entries_equal_tfhe_tpu(keys, zk_lists, name):
    """``build_with_proof`` gives tfhe_tpu's list and proofs bit for bit;
    ``verify_and_expand`` verifies, then expands and casts to tfhe_tpu's
    values, and refuses other metadata and a tampered body."""
    ZK_ENTRIES[name](keys, zk_lists)


def _keycache_round_trip(keys, tmp_path, monkeypatch):
    """``generate_keys(use_keycache=True)``: a miss writes the cache, a hit
    reads it; both give the seed's keys, and an add runs on the hit's."""
    from tfhe_tpu_torch import keycache

    monkeypatch.setenv("TFHE_TPU_KEYCACHE", str(tmp_path))
    keycache.clear_memory_cache()
    try:
        miss = api.generate_keys(config(api, P), use_keycache=True,
                                 device="cpu")
        keycache.clear_memory_cache()
        ck, sk = api.generate_keys(config(api, P), use_keycache=True,
                                   device="cpu")
    finally:
        keycache.clear_memory_cache()
    for key in (miss[1], sk):
        assert torch.equal(key.inner.key.bsk_b, keys["sk"].inner.key.bsk_b)
    assert torch.equal(ck.inner.key.lwe_sk.bits,
                       keys["ck"].inner.key.lwe_sk.bits)
    api.set_server_key(sk)
    a, b = api.FheUint8.encrypt(250, ck), api.FheUint8.encrypt(9, ck)
    assert (a + b).decrypt(keys["ck"]) == 3


def _safe_serialize_round_trip(keys, tmp_path, monkeypatch):
    """tfhe_tpu's bytes for an integer, the client key and the server key;
    the size limit holds at write time."""
    x = japi.FheUint16.encrypt(4321, keys["jck"])
    assert api.safe_serialize(carry_in(x)) == japi.safe_serialize(x)
    assert api.safe_serialize(keys["ck"]) == japi.safe_serialize(keys["jck"])
    assert api.safe_serialize(keys["sk"]) == japi.safe_serialize(keys["jsk"])
    with pytest.raises(ValueError, match="exceeds limit"):
        api.safe_serialize(keys["sk"], serialized_size_limit=1000)
    with pytest.raises(TypeError, match="unsupported type"):
        api.safe_serialize(object())


def _safe_deserialize_round_trip(keys, tmp_path, monkeypatch):
    """tfhe_tpu's envelopes load onto the CPU: an integer as its FheUint
    type (it decrypts and computes), the keys as shortint keys; the size
    limit and the conformance predicate hold."""
    x = japi.FheUint16.encrypt(4321, keys["jck"])
    back = api.safe_deserialize(japi.safe_serialize(x), device="cpu")
    assert type(back) is api.FheUint16 and back.decrypt(keys["ck"]) == 4321
    assert_same(x + x, back + back)
    ck = api.safe_deserialize(japi.safe_serialize(keys["jck"]), device="cpu")
    assert torch.equal(ck.lwe_sk.bits, keys["ck"].inner.key.lwe_sk.bits)
    from tfhe_tpu_torch.utils import serialization as ser

    blob = japi.safe_serialize(keys["jsk"])
    sk = api.safe_deserialize(blob, conformance=ser.conformance_params(
        P.name), device="cpu")
    assert torch.equal(sk.bsk_b, keys["sk"].inner.key.bsk_b)
    with pytest.raises(ser.SerializationError, match="conformance"):
        api.safe_deserialize(blob, conformance=ser.conformance_params(
            "PARAM_MESSAGE_2_CARRY_2_KS_PBS"), device="cpu")
    with pytest.raises(ValueError, match="exceeds limit"):
        api.safe_deserialize(blob, serialized_size_limit=len(blob) - 1)


ROUND_TRIPS = {"keycache": _keycache_round_trip,
               "safe_serialize": _safe_serialize_round_trip,
               "safe_deserialize": _safe_deserialize_round_trip}


@pytest.mark.parametrize("name", list(ROUND_TRIPS))
def test_retired_raises_round_trip(keys, name, tmp_path, monkeypatch):
    """The entries that raised until ROADMAP Queue A item 9's first slice
    (the keycache, safe serialization) run, against tfhe_tpu's bytes."""
    ROUND_TRIPS[name](keys, tmp_path, monkeypatch)


# -- the shortint side modules' entries (ROADMAP Queue A item 6) ---------------

def pke_sets(m, n, name):
    """tests/test_hlapi_extra.py's toy compact-PK set of dimension ``n``
    and its casting set onto the big key, from the params module ``m``."""
    return (m.CompactPublicKeyEncryptionParameters(
                encryption_lwe_dimension=n,
                encryption_noise_distribution=m.DynamicDistribution
                .t_uniform(3),
                message_modulus=4, carry_modulus=4, name=f"TOY_PKE_{name}"),
            m.ShortintKeySwitchingParameters(
                ks_base_log=3, ks_level=5,
                destination_key=m.EncryptionKeyChoice.BIG,
                name=f"TOY_KS_{name}"))


@pytest.fixture(scope="module")
def comp_keys():
    """tests/test_hlapi_extra.py's compression config (seed 8) in both
    packages."""
    jck, jsk = japi.generate_keys(
        japi.ConfigBuilder().use_custom_parameters(JP).with_seed(8)
        .enable_compression(jlc.COMP_PARAM_TEST_TOY).build())
    ck, sk = api.generate_keys(
        api.ConfigBuilder().use_custom_parameters(P).with_seed(8)
        .enable_compression(lc.COMP_PARAM_TEST_TOY).build(), device="cpu")
    return {"jck": jck, "jsk": jsk, "ck": ck, "sk": sk}


@pytest.fixture
def pinned_randbits(monkeypatch):
    """The OS entropy of compact-list encryption, pinned for both
    packages."""
    monkeypatch.setattr(secrets, "randbits", lambda k: (1 << k) // 3)


def _use_keys(k):
    japi.set_server_key(k["jsk"])
    api.set_server_key(k["sk"])


def _cpks(keys, n, name, seed):
    (jpke, jks), (pke, ks) = pke_sets(jparams, n, name), pke_sets(pm, n,
                                                                  name)
    return (japi.CompactPublicKey.new(keys["jck"], keys["jsk"], jpke, jks,
                                      seed=seed),
            api.CompactPublicKey.new(keys["ck"], keys["sk"], pke, ks,
                                     seed=seed))


def _compressed_items(k):
    """FheUint8(173), FheUint4(9), FheBool(True): JAX encryptions under the
    compression keyset and their port copies."""
    j = [japi.FheUint8.encrypt(173, k["jck"]),
         japi.FheUint4.encrypt(9, k["jck"]), japi.FheBool.encrypt(True,
                                                                  k["jck"])]
    return j, [carry_in(x) for x in j]


def _entry_compression_config(keys, comp_keys):
    jck, jsk, ck, sk = (comp_keys[n] for n in ("jck", "jsk", "ck", "sk"))
    np.testing.assert_array_equal(
        to_u64(ck.compression_private_key.comp_glwe_sk.bits),
        np.asarray(jck.compression_private_key.comp_glwe_sk.bits))
    np.testing.assert_array_equal(to_u64(sk.compression_key.pksk_hat),
                                  np.asarray(jsk.compression_key.pksk_hat))
    np.testing.assert_array_equal(to_u32(sk.decompression_key.bsk_scan),
                                  np.asarray(jsk.decompression_key.bsk_scan))
    np.testing.assert_array_equal(to_u64(sk.inner.key.ksk),
                                  np.asarray(jsk.inner.key.ksk))


def _entry_compressed_server_key(keys, comp_keys):
    cfg = (api.Config(P, seed=77), japi.Config(JP, seed=77))
    csk = api.CompressedServerKey.generate(api.ClientKey.generate(
        cfg[0], device="cpu"))
    jcsk = japi.CompressedServerKey.generate(japi.ClientKey.generate(cfg[1]))
    np.testing.assert_array_equal(to_u64(csk.inner.bsk_bodies),
                                  jcsk.inner.bsk_bodies)
    np.testing.assert_array_equal(to_u64(csk.inner.ksk_bodies),
                                  jcsk.inner.ksk_bodies)
    sk, jsk = csk.decompress(), jcsk.decompress()
    assert isinstance(sk, api.ServerKey)
    np.testing.assert_array_equal(to_u32(sk.inner.key.crt_key()),
                                  np.asarray(jsk.inner.key.bsk_scan))


def _entry_xof_key_set(keys, comp_keys):
    cfg = api.ConfigBuilder().use_custom_parameters(P).build()
    jcfg = japi.ConfigBuilder().use_custom_parameters(JP).build()
    ks = api.CompressedXofKeySet.generate(cfg, seed=5, device="cpu")
    jks = japi.CompressedXofKeySet.generate(jcfg, seed=5)
    assert ks.seed == jks.seed == 5 and ks.config.seed == 5
    np.testing.assert_array_equal(
        to_u64(ks.compressed_server_key.inner.bsk_bodies),
        jks.compressed_server_key.inner.bsk_bodies)


def _entry_compact_public_key(keys, comp_keys):
    jcpk, cpk = _cpks(keys, 64, "HL", 21)
    np.testing.assert_array_equal(to_u64(cpk.pk.mask), jcpk.pk.mask)
    np.testing.assert_array_equal(to_u64(cpk.pk.body), jcpk.pk.body)
    np.testing.assert_array_equal(to_u64(cpk.ksk.ksk), np.asarray(jcpk.ksk.ksk))
    assert cpk.tag == keys["ck"].tag


def _entry_compact_list(keys, comp_keys):
    jcpk, cpk = _cpks(keys, 16, "CL", 31)
    jl = japi.CompactCiphertextListBuilder(jcpk).push(6, japi.FheUint4) \
        .push(False, japi.FheBool).build()
    lst = api.CompactCiphertextListBuilder(cpk).push(6, api.FheUint4) \
        .push(False, api.FheBool).build()
    assert len(lst) == len(jl) == 2
    assert [(t.__name__, nb, off) for t, nb, off in lst.entries] == [
        (t.__name__, nb, off) for t, nb, off in jl.entries]
    np.testing.assert_array_equal(to_u64(lst.clist.masks), jl.clist.masks)
    np.testing.assert_array_equal(to_u64(lst.clist.bodies), jl.clist.bodies)


def _entry_compact_list_builder(keys, comp_keys):
    jcpk, cpk = _cpks(keys, 16, "CL", 31)
    jb = japi.CompactCiphertextListBuilder(jcpk).push(200, japi.FheUint8)
    b = api.CompactCiphertextListBuilder(cpk).push(200, api.FheUint8)
    assert b._digits == jb._digits == [0, 2, 0, 3]
    (jv,), (v,) = jb.build().expand(), b.build().expand()
    assert_same(jv, v)


def _entry_compressed_list(keys, comp_keys):
    _use_keys(comp_keys)
    j, p = _compressed_items(comp_keys)
    jl = japi.CompressedCiphertextListBuilder().push(j[0]).push(j[2]).build()
    lst = api.CompressedCiphertextListBuilder().push(p[0]).push(p[2]).build()
    assert len(lst) == 2
    assert_same(jl.get(1), lst.get(1))


def _entry_compressed_list_builder(keys, comp_keys):
    _use_keys(comp_keys)
    j, p = _compressed_items(comp_keys)
    jl = japi.CompressedCiphertextListBuilder().push(j[1]).build()
    lst = api.CompressedCiphertextListBuilder().push(p[1]).build()
    np.testing.assert_array_equal(to_u32(lst.packed.storage),
                                  jl.packed.storage)
    assert lst.entries[0][1:] == jl.entries[0][1:] == (2, 0)


SIDE_ENTRIES = {
    "compression_config": _entry_compression_config,
    "CompressedServerKey": _entry_compressed_server_key,
    "CompressedXofKeySet": _entry_xof_key_set,
    "CompactPublicKey": _entry_compact_public_key,
    "HlCompactCiphertextList": _entry_compact_list,
    "CompactCiphertextListBuilder": _entry_compact_list_builder,
    "HlCompressedCiphertextList": _entry_compressed_list,
    "CompressedCiphertextListBuilder": _entry_compressed_list_builder,
}


@pytest.mark.parametrize("name", list(SIDE_ENTRIES))
def test_side_module_entries_run(keys, comp_keys, pinned_randbits, name):
    """Each entry that raised until the shortint side modules were ported
    (ROADMAP Queue A item 6) now runs and gives tfhe_tpu's keys, lists and
    values bit for bit."""
    SIDE_ENTRIES[name](keys, comp_keys)


# -- tests/test_hlapi_extra.py: the side modules' HLAPI tests ------------------

def test_compressed_server_key_hlapi(keys):
    """A key set of seed 77 from its compressed server key: x + x on the
    decompressed key, bit-equal to tfhe_tpu, decrypts to 18."""
    jsk = japi.CompressedServerKey.generate(
        japi.ClientKey.generate(japi.Config(JP, seed=77))).decompress()
    ck2 = api.ClientKey.generate(api.Config(P, seed=77), device="cpu")
    sk = api.CompressedServerKey.generate(ck2).decompress()
    jck2 = japi.ClientKey.generate(japi.Config(JP, seed=77))
    _use_keys({"jsk": jsk, "sk": sk})
    x = japi.FheUint8.encrypt(9, jck2)
    y = carry_in(x) + carry_in(x)
    assert_same(x + x, y)
    assert y.decrypt(ck2) == 18


def test_compact_public_key_hlapi(keys, pinned_randbits):
    jcpk, cpk = _cpks(keys, 64, "HL", 21)
    jx, x = jcpk.encrypt_radix(201, japi.FheUint8), cpk.encrypt_radix(
        201, api.FheUint8)
    assert_same(jx, x)
    assert x.decrypt(keys["ck"]) == 201
    assert run(keys, lambda m, a: a + a, jx) == (201 * 2) % 256


def test_compressed_ciphertext_list_hlapi(comp_keys):
    """push/build/get over mixed types (compressed_ciphertext_list.rs)."""
    _use_keys(comp_keys)
    j, p = _compressed_items(comp_keys)
    jl = japi.CompressedCiphertextListBuilder().push(j[0]).push(j[1]) \
        .push(j[2]).build()
    lst = api.CompressedCiphertextListBuilder().push(p[0]).push(p[1]) \
        .push(p[2]).build()
    np.testing.assert_array_equal(to_u32(lst.packed.storage),
                                  jl.packed.storage)
    assert len(lst) == 3
    got = [lst.get(i) for i in range(3)]
    for i, g in enumerate(got):
        assert_same(jl.get(i), g)
    ck = comp_keys["ck"]
    assert [got[0].decrypt(ck), got[1].decrypt(ck), got[2].decrypt(ck)] == [
        173, 9, True]
    assert type(got[1]).__name__ == "FheUint4"


def test_compact_list_builder_hlapi(keys, pinned_randbits):
    """Typed compact list: push/build/expand (compact_list.rs)."""
    jcpk, cpk = _cpks(keys, 16, "CL", 31)
    jvals = japi.CompactCiphertextListBuilder(jcpk).push(11, japi.FheUint4) \
        .push(True, japi.FheBool).push(2, japi.FheUint2).build().expand()
    vals = api.CompactCiphertextListBuilder(cpk).push(11, api.FheUint4) \
        .push(True, api.FheBool).push(2, api.FheUint2).build().expand()
    for jv, v in zip(jvals, vals):
        assert_same(jv, v)
    assert [clear(keys, v) for v in vals] == [11, True, 2]


def test_xof_keyset_deterministic():
    """Equal seeds give byte-equal key sets, equal to tfhe_tpu's, and keys
    derived on either side decrypt each other's results
    (xof_key_set.rs)."""
    cfg = api.ConfigBuilder().use_custom_parameters(P).build()
    ck1, sk1 = api.CompressedXofKeySet.generate(cfg, seed=99,
                                                device="cpu").decompress()
    ck2, sk2 = api.CompressedXofKeySet.generate(cfg, seed=99,
                                                device="cpu").decompress()
    jck, _ = japi.CompressedXofKeySet.generate(
        japi.ConfigBuilder().use_custom_parameters(JP).build(),
        seed=99).decompress()
    assert torch.equal(ck1.inner.key.lwe_sk.bits, ck2.inner.key.lwe_sk.bits)
    np.testing.assert_array_equal(to_u64(ck1.inner.key.lwe_sk.bits),
                                  np.asarray(jck.inner.key.lwe_sk.bits))
    assert torch.equal(sk1.inner.key.bsk_b, sk2.inner.key.bsk_b)
    api.set_server_key(sk1)
    x = api.FheUint8.encrypt(42, ck1)
    assert int((x + x).decrypt(ck2)) == 84


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
