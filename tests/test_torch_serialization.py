"""The port's safe serialization (``tfhe_tpu_torch.utils.serialization``)
and CBOR layouts (``utils/cbor.py``) against tfhe_tpu at PARAM_TEST_TOY on
the CPU. Same seeds => byte-equal objects, so for every type tfhe_tpu
serializes the port's envelope equals tfhe_tpu's byte for byte, and each
package reads what the other wrote: the shortint client
key, the server key (v6b, crt, v5, multi-bit, KS32, and a drift key, whose
encryptions of zero neither package stores), the shortint ciphertext, the
radix ciphertext, the compressed and the compact list, the compressed
server key (the squashed ciphertext's envelope: the frozen corpus here,
``tests/test_torch_noise_squashing.py`` both ways). Also: the size limit,
the magic, the expected type, conformance, the upgrade chains (the compact
list's v1), untrusted array specs, the ZK types (their envelopes from
the frozen corpus; fresh ones in ``tests/test_torch_zk.py``),
the frozen corpus ``tests/data/compat_*_v1.bin``, and a client key carried
in without its seed. Tolerance: exact (bytes)."""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from tfhe_tpu.integer import radix as jradix
from tfhe_tpu.shortint import compact_public_key as jcpk
from tfhe_tpu.shortint import list_compression as jlc
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.compressed_server_key import \
    CompressedServerKey as JCompressed
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils import cbor as jcbor
from tfhe_tpu.utils import csprng as jcsprng
from tfhe_tpu.utils import params as jparams
from tfhe_tpu.utils import serialization as jser

from test_torch_public_keys import toy_sets
from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import from_u64, to_u32, to_u64
from tfhe_tpu_torch.integer import radix
from tfhe_tpu_torch.shortint import compact_public_key as cpk
from tfhe_tpu_torch.shortint import list_compression as lc
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.compressed_server_key import CompressedServerKey
from tfhe_tpu_torch.shortint.server_key import ServerKey
from tfhe_tpu_torch.utils import cbor
from tfhe_tpu_torch.utils import csprng
from tfhe_tpu_torch.utils import params as pm
from tfhe_tpu_torch.utils import serialization as ser

SEED = 11  # tests/test_serialization.py's seed
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MSGS = np.array([0, 1, 2, 3, 7], dtype=np.uint64)


def _drift(m):
    """PARAM_TEST_TOY under the drift technique, from params module ``m``
    (tests/test_torch_isolation.py's toy drift set)."""
    return dataclasses.replace(
        m.PARAM_TEST_TOY,
        modulus_switch_type=m.ModulusSwitchType.DRIFT_TECHNIQUE_NOISE_REDUCTION,
        modulus_switch_noise_reduction_params=m
        .ModulusSwitchNoiseReductionParams(16, 2.0 ** 57, 3.0, 2.0 ** -80))


KEY_SETS = {  # case -> (params name, TFHE_NTT_VARIANT or None)
    "v6b": ("PARAM_TEST_TOY", None),
    "crt": ("PARAM_TEST_TOY", "crt"),
    "v5": ("PARAM_TEST_TOY", "v5"),
    "multi_bit": ("PARAM_TEST_TOY_MULTI_BIT", None),
    "ks32": ("PARAM_TEST_TOY_KS32", None),
    "drift": ("drift", None),
}


def _params(m, name):
    if name == "drift":
        return _drift(m)
    return getattr(m, name)


@pytest.fixture(scope="module")
def toy():
    jck = JClientKey.generate(jparams.PARAM_TEST_TOY, seed=SEED)
    ck = ClientKey.generate(pm.PARAM_TEST_TOY, seed=SEED, device="cpu")
    return dict(jck=jck, jsk=JServerKey.generate(jck), ck=ck,
                sk=ServerKey.generate(ck))


def fresh():
    """Client keys of SEED whose encryption streams are unused, so both
    packages draw the same encryptions."""
    return (JClientKey.generate(jparams.PARAM_TEST_TOY, seed=SEED),
            ClientKey.generate(pm.PARAM_TEST_TOY, seed=SEED, device="cpu"))


def both_ways(jbytes, pbytes, expected_type, jread=True):
    """The two envelopes are equal, and each package's load of the other's
    writes the same bytes again; the port's load is returned."""
    assert pbytes == jbytes
    back = ser.deserialize(jbytes, expected_type=expected_type, device="cpu")
    if jread:
        jback = jser.deserialize(pbytes, expected_type=expected_type)
        assert _jwrite(expected_type, jback) == pbytes
    return back


def _jwrite(tname, obj):
    return {"ShortintClientKey": jser.serialize_shortint_client_key,
            "ShortintServerKey": jser.serialize_shortint_server_key,
            "ShortintCiphertext": jser.serialize_shortint_ciphertext,
            "RadixCiphertext": jser.serialize_radix,
            "CompressedCiphertextList": jser.serialize_compressed_list,
            "CompactCiphertextList": jser.serialize_compact_list,
            "CompressedServerKey": jser.serialize_compressed_server_key,
            }[tname](obj)


# -- the envelopes, byte for byte ----------------------------------------------

def test_client_key(toy):
    back = both_ways(jser.serialize_shortint_client_key(toy["jck"]),
                     ser.serialize_shortint_client_key(toy["ck"]),
                     "ShortintClientKey")
    assert torch.equal(back.lwe_sk.bits, toy["ck"].lwe_sk.bits)
    assert ser.serialize_shortint_client_key(back) == \
        ser.serialize_shortint_client_key(toy["ck"])
    np.testing.assert_array_equal(back.decrypt(toy["ck"].encrypt(MSGS)),
                                  MSGS % 4)


def test_client_key_without_seed_refused(toy):
    """A key carried in from its bits has no seed to regenerate from:
    writing it would store seed 0, so it raises."""
    carried = convert.client_key_from_arrays(
        "PARAM_TEST_TOY", *convert.client_key_to_arrays(toy["ck"])[1:],
        device="cpu")
    with pytest.raises(ser.SerializationError, match="carries no seed"):
        ser.serialize_shortint_client_key(carried)


def test_tampered_client_key_refused(toy):
    data = bytearray(ser.serialize_shortint_client_key(toy["ck"]))
    data[-1] ^= 1  # the last LWE key bit
    with pytest.raises(ser.SerializationError, match="does not match"):
        ser.deserialize(bytes(data), device="cpu")


@pytest.mark.parametrize("case", list(KEY_SETS))
def test_server_key(case, monkeypatch):
    name, variant = KEY_SETS[case]
    if variant:
        monkeypatch.setenv("TFHE_NTT_VARIANT", variant)
    else:
        monkeypatch.delenv("TFHE_NTT_VARIANT", raising=False)
    jck = JClientKey.generate(_params(jparams, name), seed=SEED)
    ck = ClientKey.generate(_params(pm, name), seed=SEED, device="cpu")
    jsk, sk = JServerKey.generate(jck), ServerKey.generate(ck)
    if case == "drift":
        assert sk.ms_zeros is not None and jsk.ms_zeros is not None
    pbytes = ser.serialize_shortint_server_key(sk)
    # KS32's and the drift set's names are not in tfhe_tpu's registry
    # (ROADMAP standing note 8): tfhe_tpu writes them but cannot load them
    back = both_ways(jser.serialize_shortint_server_key(jsk), pbytes,
                     "ShortintServerKey", jread=case in ("v6b", "crt", "v5",
                                                         "multi_bit"))
    assert back.variant == sk.variant and back.max_degree == sk.max_degree
    assert ser.serialize_shortint_server_key(back) == pbytes
    lut = sk.generate_lookup_table(lambda x: (x + 1) % 16)
    ct = ck.encrypt(MSGS)
    want = sk.apply_lookup_table(ct, lut)
    got = back.apply_lookup_table(ct, back.generate_lookup_table(
        lambda x: (x + 1) % 16))
    if case == "drift":  # neither package stores the encryptions of zero
        assert back.ms_zeros is None
        np.testing.assert_array_equal(ck.decrypt(got), (MSGS + 1) % 4)
    else:
        assert torch.equal(got.ct, want.ct)


def test_v5_key_stores_the_crt_form(monkeypatch):
    """A v5 key keeps its standard-domain BSK, from which its stored form
    (its serialization, ``convert.server_key_to_arrays``) builds the CRT
    key into a temporary equal to tfhe_tpu's stored ``bsk_scan``; the key
    is left as it was."""
    monkeypatch.setenv("TFHE_NTT_VARIANT", "v5")
    jck = JClientKey.generate(jparams.PARAM_TEST_TOY, seed=SEED)
    ck = ClientKey.generate(pm.PARAM_TEST_TOY, seed=SEED, device="cpu")
    sk = ServerKey.generate(ck)
    assert sk.bsk_scan is None and sk.bsk_std is not None
    arrays = convert.server_key_to_arrays(sk)
    np.testing.assert_array_equal(arrays[2], np.asarray(
        JServerKey.generate(jck).bsk_scan))
    assert sk.bsk_scan is None and sk.bsk_std is not None
    assert sk.variant == "v5"


@pytest.mark.parametrize("variant", ["v6b", "v5"])
def test_saving_leaves_the_key_as_it_was(variant, monkeypatch):
    """Serializing a generated key builds its CRT form into a temporary:
    the live key keeps its fields (no CRT key stays resident)."""
    monkeypatch.setenv("TFHE_NTT_VARIANT", variant)
    sk = ServerKey.generate(ClientKey.generate(pm.PARAM_TEST_TOY, seed=SEED,
                                               device="cpu"))
    before = {f: getattr(sk, f) for f in ("bsk_scan", "bsk_std", "bsk_b",
                                          "bsk_g")}
    blob = ser.serialize_shortint_server_key(sk)
    assert all(getattr(sk, f) is v for f, v in before.items())
    assert sk.bsk_scan is None
    back = ser.deserialize(blob, expected_type="ShortintServerKey",
                           device="cpu")
    assert torch.equal(back.crt_key(), sk.crt_key())


def test_envelope_prime_count_is_the_stored_keys():
    """A key carried in with another prime count than the set's default
    writes that count into the header, and its envelope loads back."""
    from tfhe_tpu_torch.core import algorithms as algo
    from tfhe_tpu_torch.core.entities import LweBootstrapKey
    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.shortint.server_key import num_primes_for

    p = pm.PARAM_TEST_TOY
    sk = ServerKey.generate(ClientKey.generate(p, seed=SEED, device="cpu"))
    P = num_primes_for(p) + 1
    scan = pk.bsk_to_scan_layout(algo.bootstrap_key_to_ntt(
        LweBootstrapKey(sk.bsk_std, p.pbs_base_log, p.pbs_level),
        P).residues)
    name, ksk, bsk, n, _ = convert.server_key_to_arrays(
        ServerKey.from_stored(p, to_u64(sk.ksk), to_u32(scan), P, "cpu"))
    assert n == P and bsk.shape[2] == P
    carried = ServerKey.from_stored(p, ksk, bsk, P, "cpu")
    blob = ser.serialize_shortint_server_key(carried)
    hlen = int.from_bytes(blob[8:12], "little")
    assert json.loads(blob[12:12 + hlen])["meta"]["num_primes"] == P
    back = ser.deserialize(blob, expected_type="ShortintServerKey",
                           device="cpu")
    assert back.crt_key().shape[2] == P
    assert torch.equal(back.crt_key(), carried.crt_key())


def test_shortint_ciphertext():
    jck, ck = fresh()
    back = both_ways(jser.serialize_shortint_ciphertext(jck.encrypt(MSGS)),
                     ser.serialize_shortint_ciphertext(ck.encrypt(MSGS)),
                     "ShortintCiphertext")
    assert back.under_key == "big"
    np.testing.assert_array_equal(ck.decrypt(back), MSGS % 4)


def test_radix():
    jck, ck = fresh()
    jick, ick = jradix.ClientKey(jck), radix.ClientKey(ck)
    vals = np.array([173, 9], dtype=np.uint64)
    back = both_ways(jser.serialize_radix(jick.encrypt_radix(vals, 4)),
                     ser.serialize_radix(ick.encrypt_radix(vals, 4)),
                     "RadixCiphertext")
    np.testing.assert_array_equal(ick.decrypt_radix(back), vals)
    assert back.degrees.dtype == np.int64


def test_compressed_list(toy):
    jck, ck = fresh()
    jpriv = jlc.new_compression_private_key(jck, jlc.COMP_PARAM_TEST_TOY)
    jcomp, _ = jlc.new_compression_decompression_keys(jck, jpriv)
    priv = lc.new_compression_private_key(ck, lc.COMP_PARAM_TEST_TOY)
    comp, dec = lc.new_compression_decompression_keys(ck, priv)
    jl = jlc.compress(jcomp, jck.encrypt(MSGS))
    lst = lc.compress(comp, ck.encrypt(MSGS))
    back = both_ways(jser.serialize_compressed_list(jl),
                     ser.serialize_compressed_list(lst),
                     "CompressedCiphertextList")
    assert back.params == lst.params and back.count == 5
    out = lc.decompress(back, dec, toy["sk"], [0, 4])
    np.testing.assert_array_equal(ck.decrypt(out), [0, 3])


def test_compact_list():
    (jpke, _), (pke, _) = toy_sets(jparams), toy_sets(pm)
    jpk = jcpk.CompactPublicKey.generate(
        jcpk.CompactPrivateKey.generate(jpke, seed=8))
    priv = cpk.CompactPrivateKey.generate(pke, seed=8, device="cpu")
    k = cpk.CompactPublicKey.generate(priv)
    jl = jpk.encrypt(MSGS % 4, rng=jcsprng.EncryptionRandomGenerator(3, 4))
    lst = k.encrypt(MSGS % 4, rng=csprng.EncryptionRandomGenerator(3, 4))
    back = both_ways(jser.serialize_compact_list(jl),
                     ser.serialize_compact_list(lst), "CompactCiphertextList")
    assert back.params == pke
    np.testing.assert_array_equal(priv.decrypt_expanded(back.expand()),
                                  MSGS % 4)


def test_compact_list_v1_upgrade():
    """v1 stored only the parameter set's name: it is resolved through the
    registry, and an unregistered name raises SerializationError."""
    name = "PARAM_PKE_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128"
    masks, bodies = np.arange(16, dtype=np.uint64)[None], np.arange(
        3, dtype=np.uint64)
    for mod in (jser, ser):
        v1 = mod.serialize("CompactCiphertextList",
                           {"count": 3, "degree": 3, "params": name},
                           {"masks": masks, "bodies": bodies}, version=1)
        lst = ser.deserialize(v1, device="cpu")
        assert lst.params == pm.PARAMS_BY_NAME[name] and lst.count == 3
        np.testing.assert_array_equal(to_u64(lst.bodies), bodies)
        bad = mod.serialize("CompactCiphertextList",
                            {"count": 3, "degree": 3, "params": "NOPE"},
                            {"masks": masks, "bodies": bodies}, version=1)
        with pytest.raises(ser.SerializationError, match="unregistered"):
            ser.deserialize(bad, device="cpu")


@pytest.mark.parametrize("multi_bit", [False, True])
def test_compressed_server_key(multi_bit):
    name = "PARAM_TEST_TOY_MULTI_BIT" if multi_bit else "PARAM_TEST_TOY"
    jc = JCompressed.generate(JClientKey.generate(getattr(jparams, name),
                                                  seed=SEED))
    c = CompressedServerKey.generate(ClientKey.generate(getattr(pm, name),
                                                        seed=SEED,
                                                        device="cpu"))
    back = both_ways(jser.serialize_compressed_server_key(jc), c.serialize(),
                     "CompressedServerKey")
    assert (back.mask_seed, back.bsk_mask_start, back.ksk_mask_start,
            back.max_degree) == (c.mask_seed, c.bsk_mask_start,
                                 c.ksk_mask_start, c.max_degree)
    assert back.serialize() == c.serialize()
    sk, want = back.decompress(), c.decompress()
    assert torch.equal(sk.ksk, want.ksk)
    if multi_bit:
        assert torch.equal(sk.bsk_mb, want.bsk_mb)
    else:
        assert torch.equal(sk.bsk_b, want.bsk_b)


# -- the envelope's checks -------------------------------------------------------

def test_size_limit_magic_and_type(toy):
    blob = ser.serialize_shortint_ciphertext(toy["ck"].encrypt(MSGS))
    with pytest.raises(ser.SerializationError, match="size limit"):
        ser.deserialize(blob, size_limit=100, device="cpu")
    with pytest.raises(ser.SerializationError, match="magic"):
        ser.deserialize(b"garbage" + blob, device="cpu")
    with pytest.raises(ser.SerializationError, match="expected type"):
        ser.deserialize(blob, expected_type="ShortintServerKey",
                        device="cpu")


def test_conformance(toy):
    blob = ser.serialize_shortint_client_key(toy["ck"])
    ok = ser.deserialize(blob, conformance=ser.conformance_params(
        "PARAM_TEST_TOY"), device="cpu")
    assert ok.params.name == "PARAM_TEST_TOY"
    with pytest.raises(ser.SerializationError, match="conformance"):
        ser.deserialize(blob, conformance=ser.conformance_params("OTHER"),
                        device="cpu")


def test_upgrade_chain_and_versions():
    ser.register_type(
        "_TestThing", 2, lambda p, device: ("v2", p["meta"]["x"]),
        upgrades={1: lambda p: {"meta": {"x": p["meta"]["old_x"] + 1},
                                "arrays": p["arrays"]}})
    try:
        assert ser.deserialize(ser.serialize("_TestThing", {"old_x": 41}, {},
                                             version=1)) == ("v2", 42)
        with pytest.raises(ser.SerializationError, match="newer"):
            ser.deserialize(ser.serialize("_TestThing", {"x": 1}, {},
                                          version=3))
        with pytest.raises(ser.SerializationError, match="no upgrade path"):
            ser.deserialize(ser.serialize("_TestThing", {"x": 1}, {},
                                          version=0))
        with pytest.raises(ser.SerializationError, match="not registered"):
            ser.serialize("_Unknown", {}, {})
    finally:
        del ser._REGISTRY["_TestThing"]


def _with_spec(blob: bytes, **spec) -> bytes:
    """``blob`` with its first array's spec fields replaced."""
    hlen = int.from_bytes(blob[8:12], "little")
    header = json.loads(blob[12:12 + hlen])
    first = next(iter(header["arrays"]))
    header["arrays"][first].update(spec)
    hj = json.dumps(header).encode()
    return blob[:8] + len(hj).to_bytes(4, "little") + hj + blob[12 + hlen:]


@pytest.mark.parametrize("spec,match", [
    ({"shape": [-1, 6]}, "negative dimension"),
    ({"offset": -8}, "bad spec"),
    ({"nbytes": -1}, "bad spec"),
    ({"offset": 1 << 20}, "bad spec"),
    ({"nbytes": 8}, "bad spec"),
])
def test_untrusted_array_specs(toy, spec, match):
    """Negative or out-of-range specs raise before any slicing, in the port
    as in tfhe_tpu."""
    blob = _with_spec(ser.serialize_shortint_ciphertext(
        toy["ck"].encrypt(MSGS)), **spec)
    for mod, kw in ((ser, {"device": "cpu"}), (jser, {})):
        with pytest.raises(mod.SerializationError, match=match):
            mod.deserialize(blob, **kw)


# -- the frozen corpus -------------------------------------------------------------

PORTED = {"shortint_ck": "ShortintClientKey",
          "shortint_sk": "ShortintServerKey",
          "shortint_ct": "ShortintCiphertext",
          "radix_ct": "RadixCiphertext",
          "compressed_list": "CompressedCiphertextList",
          "compact_list": "CompactCiphertextList",
          "compressed_server_key": "CompressedServerKey",
          "squashed_ct": "SquashedNoiseCiphertext"}
ZK_TYPES = {"zk_crs": ("PkeV2Crs", ser.serialize_zk_crs),
            "zk_proof": ("PkeV2Proof", ser.serialize_zk_proof)}


@pytest.fixture(scope="module")
def corpus():
    manifest = json.load(open(os.path.join(DATA, "compat_manifest_v2.json")))
    assert set(manifest["artifacts"]) == set(PORTED) | set(ZK_TYPES)
    blobs = {}
    for name, info in manifest["artifacts"].items():
        blob = open(os.path.join(DATA, info["file"]), "rb").read()
        assert hashlib.sha256(blob).hexdigest() == info["sha256"], name
        assert len(blob) == info["nbytes"], name
        blobs[name] = blob
    return manifest, blobs


@pytest.mark.parametrize("name", list(PORTED))
def test_corpus_artifact_loads(corpus, name):
    """Each frozen artifact the port holds loads and writes back the same
    bytes (the frozen types are current: no upgrade ran)."""
    manifest, blobs = corpus
    obj = ser.deserialize(blobs[name], expected_type=PORTED[name],
                          device="cpu")
    write = {"ShortintClientKey": ser.serialize_shortint_client_key,
             "ShortintServerKey": ser.serialize_shortint_server_key,
             "ShortintCiphertext": ser.serialize_shortint_ciphertext,
             "RadixCiphertext": ser.serialize_radix,
             "CompressedCiphertextList": ser.serialize_compressed_list,
             "CompactCiphertextList": ser.serialize_compact_list,
             "CompressedServerKey": ser.serialize_compressed_server_key,
             "SquashedNoiseCiphertext": ser.serialize_squashed_ciphertext,
             }[PORTED[name]]
    assert write(obj) == blobs[name]


def test_corpus_semantics(corpus):
    manifest, blobs = corpus
    want = ClientKey.generate(pm.PARAM_TEST_TOY, seed=manifest["seed"],
                              device="cpu")
    ck = ser.deserialize(blobs["shortint_ck"], device="cpu")
    assert torch.equal(ck.lwe_sk.bits, want.lwe_sk.bits)
    ct = ser.deserialize(blobs["shortint_ct"], device="cpu")
    assert int(want.decrypt(ct)[0]) == 3
    sk = ser.deserialize(blobs["shortint_sk"], device="cpu")
    out = sk.apply_lookup_table(ct, sk.generate_lookup_table(
        lambda x: (x + 1) % 4))
    assert int(want.decrypt(out)[0]) == 0
    cl = ser.deserialize(blobs["compact_list"], device="cpu")
    assert cl.params.name == "TOY_PKE_ZK" and cl.count == 4


@pytest.mark.parametrize("name", list(ZK_TYPES))
def test_corpus_zk_types_round_trip(corpus, name):
    """The frozen ZK artifacts load in the port, every point checked
    (canonical, on the curve, in the subgroup), and write back the same
    bytes; the proof's tfhe_tpu object writes the same bytes as the port's
    (tfhe_tpu's own corpus test loads its CRS: ~40 s of pure-Python
    subgroup checks)."""
    tname, write = ZK_TYPES[name]
    blob = corpus[1][name]
    obj = ser.deserialize(blob, expected_type=tname, device="cpu")
    assert write(obj) == blob
    if name == "zk_crs":
        assert len(obj.g_list) == 2 * obj.n + 1
        assert len(obj.g_hat_list) == obj.n + 1
    else:
        jobj = jser.deserialize(blob, expected_type=tname)
        assert jser.serialize_zk_proof(jobj) == blob
        assert obj.to_bytes() == jobj.to_bytes()


# -- CBOR ------------------------------------------------------------------------------

@pytest.mark.parametrize("as_tensor", [False, True])
def test_cbor_layouts_equal_tfhe_tpu(as_tensor):
    """Every layout of the reference's entities, on values of every CBOR
    argument size (< 24, u8, u16, u32, u64), from numpy or a torus
    tensor."""
    rng = np.random.default_rng(3)
    vals = np.concatenate([
        np.array([0, 23, 24, 255, 256, 65535, 65536, (1 << 32) - 1, 1 << 32,
                  (1 << 64) - 1], dtype=np.uint64),
        rng.integers(0, (1 << 64) - 1, 54, dtype=np.uint64, endpoint=True)])
    arg = from_u64(vals, "cpu") if as_tensor else vals
    bits = (vals & np.uint64(1)).astype(np.uint64)
    barg = from_u64(bits, "cpu") if as_tensor else bits
    assert cbor.lwe_secret_key_bytes(barg) == jcbor.lwe_secret_key_bytes(bits)
    assert cbor.lwe_ciphertext_bytes(arg) == jcbor.lwe_ciphertext_bytes(vals)
    assert cbor.lwe_ciphertext_bytes(arg, modulus=1 << 40) == \
        jcbor.lwe_ciphertext_bytes(vals, modulus=1 << 40)
    assert cbor.glwe_ciphertext_bytes(arg, 32) == \
        jcbor.glwe_ciphertext_bytes(vals, 32)
    assert cbor.lwe_keyswitch_key_bytes(arg, 3, 5, 11) == \
        jcbor.lwe_keyswitch_key_bytes(vals, 3, 5, 11)
    assert cbor.lwe_bootstrap_key_bytes(arg, 2, 16, 23, 1) == \
        jcbor.lwe_bootstrap_key_bytes(vals, 2, 16, 23, 1)
    assert cbor.lwe_ciphertext_bytes(arg[:0]) == \
        jcbor.lwe_ciphertext_bytes(vals[:0])
    assert to_u64(from_u64(vals, "cpu")).tobytes() == vals.tobytes()
