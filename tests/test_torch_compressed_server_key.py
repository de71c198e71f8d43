"""The port's compressed server key
(``tfhe_tpu_torch.shortint.compressed_server_key``) against tfhe_tpu at
PARAM_TEST_TOY on the CPU: the same client seed gives byte-equal bodies and
mask-stream coordinates, and ``decompress`` gives a server key byte-equal
to the port's ``ServerKey.generate`` of a fresh client key of that seed,
for each transform variant (v6b: the BNF2 key, the standard-domain BSK;
crt: the exact CRT key; v5: the Goldilocks key; all: the KSK and its int8
limbs). Under v6b and crt the exact CRT key also equals tfhe_tpu's
decompressed ``bsk_scan``. A multi-bit set decompresses to K5's key;
``serialize`` writes tfhe_tpu's ``CompressedServerKey`` envelope, which
either package reads back. Tolerance: exact.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.compressed_server_key import \
    CompressedServerKey as JCompressed
from tfhe_tpu.utils import serialization as jser
from tfhe_tpu.utils.params import PARAM_TEST_TOY as JP

from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import to_u32, to_u64
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.compressed_server_key import CompressedServerKey
from tfhe_tpu_torch.shortint.server_key import ServerKey
from tfhe_tpu_torch.utils import params as pm
from tfhe_tpu_torch.utils import serialization as ser
from tfhe_tpu_torch.utils.params import PARAM_TEST_TOY as P

SEED = 11  # tests/test_compressed_server_key.py's seed
KEY_FIELDS = ("ksk", "ksk_i8", "bsk_b", "bsk_std", "bsk_scan", "bsk_g",
              "bsk_g_k", "ms_zeros")


def _fresh(seed=SEED):
    return ClientKey.generate(P, seed=seed, device="cpu")


@pytest.fixture(scope="module")
def jax_key():
    jcsk = JCompressed.generate(JClientKey.generate(JP, seed=SEED))
    return jcsk, jcsk.decompress()


def assert_same_key(a: ServerKey, b: ServerKey):
    assert (a.variant, a.max_degree, a.params.name) == (
        b.variant, b.max_degree, b.params.name)
    for f in KEY_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), f


@pytest.mark.parametrize("variant", ["v6b", "crt", "v5"])
def test_decompress_byte_equal_to_generate(jax_key, variant, monkeypatch):
    if variant == "v6b":
        monkeypatch.delenv("TFHE_NTT_VARIANT", raising=False)
    else:
        monkeypatch.setenv("TFHE_NTT_VARIANT", variant)
    jcsk, jsk = jax_key
    csk = CompressedServerKey.generate(_fresh())
    np.testing.assert_array_equal(to_u64(csk.bsk_bodies), jcsk.bsk_bodies)
    np.testing.assert_array_equal(to_u64(csk.ksk_bodies), jcsk.ksk_bodies)
    assert (csk.mask_seed, csk.bsk_mask_start, csk.ksk_mask_start,
            csk.max_degree) == (jcsk.mask_seed, jcsk.bsk_mask_start,
                                jcsk.ksk_mask_start, jcsk.max_degree)
    sk = csk.decompress()
    assert sk.variant == variant
    assert_same_key(sk, ServerKey.generate(_fresh()))
    if variant != "v5":
        np.testing.assert_array_equal(to_u32(sk.crt_key()),
                                      np.asarray(jsk.bsk_scan))
    np.testing.assert_array_equal(to_u64(sk.ksk), np.asarray(jsk.ksk))


def test_carried_key_decompresses_and_runs(jax_key):
    """tfhe_tpu's compressed key carried in decompresses to the port's key
    of the same seed and evaluates a LUT; its bodies are under a quarter of
    the full key's bytes."""
    jcsk, _ = jax_key
    csk = convert.compressed_server_key_from_arrays(
        P.name, jcsk.bsk_bodies, jcsk.ksk_bodies, jcsk.mask_seed,
        jcsk.bsk_mask_start, jcsk.ksk_mask_start, jcsk.max_degree, "cpu")
    sk = csk.decompress()
    assert_same_key(sk, ServerKey.generate(_fresh()))
    ck = _fresh()
    out = sk.apply_lookup_table(ck.encrypt([0, 1, 2, 3]),
                                sk.generate_lookup_table(lambda x: (x + 1)
                                                         % 4))
    np.testing.assert_array_equal(ck.decrypt(out), [1, 2, 3, 0])
    full = sum(t.numel() * t.element_size()
               for t in (sk.bsk_b, sk.ksk, sk.ksk_i8))
    assert csk.serialized_size_bytes() < full / 4


def test_production_size():
    """At 2_2 the bodies are ~28.5 MB (n l (k+1) N + k N l_ks u64)."""
    p = pm.PARAM_MESSAGE_2_CARRY_2_KS_PBS
    n, l, k, N = p.lwe_dimension, p.pbs_level, p.glwe_dimension, \
        p.polynomial_size
    assert (n * l * (k + 1) * N + k * N * p.ks_level) * 8 < 30 * 1024 * 1024


def _multi_bit_client_key():
    """A client key of PARAM_TEST_TOY with a grouping factor of 2
    (duck-typed: the set's fields as class attributes)."""
    fields = {f.name: getattr(P, f.name) for f in dataclasses.fields(P)}
    ck = _fresh()
    ck.params = type("MultiBit", (), dict(fields, grouping_factor=2,
                                          glwe_size=P.glwe_size))()
    return ck


def test_multi_bit_decompresses_equal():
    """A multi-bit set's compressed key (the GGSWs of subset products,
    drawn as ``ServerKey.generate`` draws them) decompresses to the server
    key of a fresh client key of the same seed: K5's key and the KSK."""
    csk = CompressedServerKey.generate(_multi_bit_client_key())
    assert tuple(csk.bsk_bodies.shape) == (8, 3, 1, 2, 256)
    sk = csk.decompress()
    want = ServerKey.generate(_multi_bit_client_key())
    assert torch.equal(sk.bsk_mb, want.bsk_mb)
    assert torch.equal(sk.ksk, want.ksk) and torch.equal(sk.ksk_i8,
                                                         want.ksk_i8)
    assert sk.bsk_b is None and sk.bsk_scan is None


def test_serialize_classic_and_multi_bit(jax_key):
    """``serialize`` writes tfhe_tpu's envelope byte for byte, classic and
    multi-bit alike (the duck-typed multi-bit set has no registered name,
    so only the classic one is read back); the load decompresses to the
    same key (a multi-bit set compresses:
    ``test_multi_bit_decompresses_equal``)."""
    jcsk, _ = jax_key
    csk = CompressedServerKey.generate(_fresh())
    blob = csk.serialize()
    assert blob == jser.serialize_compressed_server_key(jcsk)
    back = ser.deserialize(blob, expected_type="CompressedServerKey",
                           device="cpu")
    assert back.serialize() == blob
    assert_same_key(back.decompress(), csk.decompress())
    jback = jser.deserialize(blob, expected_type="CompressedServerKey")
    np.testing.assert_array_equal(jback.bsk_bodies, jcsk.bsk_bodies)
    mb = CompressedServerKey.generate(_multi_bit_client_key())
    as_numpy = types.SimpleNamespace(**dict(
        vars(mb), bsk_bodies=to_u64(mb.bsk_bodies),
        ksk_bodies=to_u64(mb.ksk_bodies)))
    assert mb.serialize() == jser.serialize_compressed_server_key(as_numpy)


def test_ks32_set_refused():
    """tfhe_tpu's compressed key carries the classic KS64 key only; a KS32
    set is refused rather than compressed wrong."""
    ck = ClientKey.generate(pm.PARAM_TEST_TOY_KS32, seed=SEED, device="cpu")
    with pytest.raises(ValueError, match="classic KS64"):
        CompressedServerKey.generate(ck)
