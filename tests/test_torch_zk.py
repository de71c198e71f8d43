"""The port's ZK-proven compact lists (``tfhe_tpu_torch/zk``, its curve's
native library ``csrc/bls446.c``) against ``tfhe_tpu.zk`` on the CPU:
point bytes and pairings equal, the native MSM, fixed-base powers and
pairing equal to the pure-Python curve; pke v1 and v2 proofs from one seed
byte-equal, each package verifying the other's; tampered proofs and
statements rejected; a proven list from converted compact keys with a fixed
encryption generator and prove seed bit-equal to ``tfhe_tpu``'s and
accepted by its verifier; the transcript framing; the production-dimension
v2 run once (as ``tests/test_zk.py::test_zk_v2_production_dimensions``).
Tolerance: exact (bytes)."""

import random

import numpy as np
import pytest
import torch

from tfhe_tpu.shortint import compact_public_key as jcpk
from tfhe_tpu.utils import csprng as jcsprng
from tfhe_tpu.utils import params as jparams
from tfhe_tpu.utils import serialization as jser
from tfhe_tpu.zk import curve as jcv
from tfhe_tpu.zk import pke as jpke
from tfhe_tpu.zk import pke_v2 as jpke2
from tfhe_tpu.zk import proven_list as jpl
from tfhe_tpu.zk import transcript as jtr
from tfhe_tpu.zk.four_squares import four_squares as jfour

from test_torch_strings import one_torch_thread  # noqa: F401
from test_zk import _gen_testcase, _i64

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import to_u64
from tfhe_tpu_torch.shortint import compact_public_key as cpk
from tfhe_tpu_torch.utils import csprng
from tfhe_tpu_torch.utils import params as pm
from tfhe_tpu_torch.utils import serialization as ser
from tfhe_tpu_torch.zk import curve as cv
from tfhe_tpu_torch.zk import pke, pke_v2
from tfhe_tpu_torch.zk import proven_list as pl
from tfhe_tpu_torch.zk import transcript as tr
from tfhe_tpu_torch.zk.four_squares import four_squares

PROVE_SEED = b"\x5e" * 32


def to_jax_proof(proof):
    """A port proof as tfhe_tpu's, point by point through its bytes."""
    cls = jpke2.PkeV2Proof if hasattr(proof, "C_hat_e") else jpke.PkeProof
    return cls(**{f: getattr(jcv, type(p).__name__).from_bytes(p.to_bytes())
                  for f, p in vars(proof).items()})


def _pke_set(m, n=16, name="TOY_PKE_ZK"):
    """tests/test_zk.py's toy compact-PK set from the params module ``m``."""
    return m.CompactPublicKeyEncryptionParameters(
        encryption_lwe_dimension=n,
        encryption_noise_distribution=m.DynamicDistribution.t_uniform(3),
        message_modulus=4, carry_modulus=4, name=name)


# -- the curve -----------------------------------------------------------------

def test_native_library_builds():
    """cc builds ``csrc/bls446.c`` here, so the port's curve takes its
    native path (``chip_smoke.py`` phase 22 asserts the same on the GPU
    machine)."""
    assert cv._native_lib() is not None


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_point_bytes_equal_tfhe_tpu(group):
    """Multiples of the generator: the same bytes in both packages, read
    back by both."""
    cls, jcls = getattr(cv, group), getattr(jcv, group)
    for k in (1, 2, 12345, cv.R - 1):
        p, jp = cls.generator() * k, jcls.generator() * k
        assert p.to_bytes() == jp.to_bytes()
        assert cls.from_bytes(jp.to_bytes()).to_bytes() == jp.to_bytes()
        assert jcls.from_bytes(p.to_bytes()).to_bytes() == p.to_bytes()
    assert cls.zero().to_bytes() == jcls.zero().to_bytes()


def test_pairing_equals_tfhe_tpu():
    """e(aG1, bG2) in the pure-Python curves of both packages, and the
    port's native pairing, are the same Fq12 value; bilinearity holds."""
    a, b = 123457, 987653
    p, q = cv.G1.generator() * a, cv.G2.generator() * b
    e = cv.pairing(p, q)
    assert e == jcv.pairing(jcv.G1.generator() * a, jcv.G2.generator() * b)
    assert cv._native_pairing_eval(p, q) == e
    g = cv.pairing(cv.G1.generator(), cv.G2.generator())
    assert e == cv.f12_pow(g, a * b % cv.R)


def test_native_msm_and_powers_equal_python():
    """The native fixed-base powers and Pippenger MSM over both groups
    against the pure-Python curve (the spec) and tfhe_tpu's results."""
    rnd = random.Random(11)
    alpha = rnd.randrange(cv.R)
    scalars = [pow(alpha, j, cv.R) for j in range(1, 40)] + [0]  # >= 32: native MSM
    before = dict(cv.NATIVE_CALLS)
    for cls, jcls, ops in ((cv.G1, jcv.G1, cv.FQ_OPS),
                           (cv.G2, jcv.G2, cv.FQ2_OPS)):
        nat = cv._native_fixed_powers(cls, scalars, 8)
        tbl = cv._FixedBaseTable(cls.GEN, ops, bits=cv.R.bit_length())
        assert [p.pt for p in nat] == tbl.mul_many(scalars)
        pts = [p.pt for p in nat]
        ks = [rnd.randrange(cv.R) for _ in pts]
        ks[3] = 0
        got = cv.msm((k, cls(p) if p else cls.zero())
                     for k, p in zip(ks, pts))
        j = cv._msm_pippenger(pts, ks, ops, bits=cv.R.bit_length())
        (aff,) = cv._jac_to_affine_batch([j], ops)
        assert got.pt == aff
        want = jcv.msm((k, jcls(p) if p else jcls.zero())
                       for k, p in zip(ks, pts))
        assert got.to_bytes() == want.to_bytes()
    assert cv.NATIVE_CALLS["fixed_powers"] == before["fixed_powers"] + 2
    assert cv.NATIVE_CALLS["msm"] == before["msm"] + 2


def test_native_pairing_product_matches_python():
    P1, Q1 = cv.G1(cv.G1.GEN), cv.G2(cv.G2.GEN)
    a, b = 987654321, 123456789
    good = [(P1 * a, Q1 * b), (P1 * (-(a * b) % cv.R), Q1)]
    bad = [(P1 * a, Q1 * b), (P1, Q1)]
    assert cv._native_pairing_product(good) is True
    assert cv._native_pairing_product(bad) is False
    assert cv._native_pairing_product(
        [(cv.G1.zero(), Q1), (P1, cv.G2.zero())]) is True


def _off_subgroup_g1():
    """An on-curve G1 point outside the prime-order subgroup: (2, y) with
    y^2 = 2^3 + 1 (P = 3 mod 4, so y = v^((P+1)/4))."""
    y = pow(9, (cv.P + 1) // 4, cv.P)
    return cv.G1((2, y))


def test_subgroup_checks_native_and_python_agree():
    """The native subgroup check (the native MSM of one point by r) agrees
    with the Python one on points in and out of the subgroup; the CRS
    loader's batch check and ``from_bytes`` reject the outsider, as
    tfhe_tpu's loader does."""
    bad = _off_subgroup_g1()
    assert bad.on_curve() and cv._pt_mul(bad.pt, cv.R, cv.FQ_OPS) is not None
    before = cv.NATIVE_CALLS["subgroup"]
    assert cv._native_in_subgroup(cv.G1, bad.pt) is False
    good = [cv.G1.generator() * 5, cv.G2.generator() * 7]
    assert [cv._native_in_subgroup(type(p), p.pt) for p in good] == [True,
                                                                   True]
    assert cv.NATIVE_CALLS["subgroup"] == before + 3
    with pytest.raises(cv.InvalidPointError, match="subgroup"):
        cv.check_subgroup_many(good + [bad])
    cv.check_subgroup_many(good + [cv.G1.zero()])
    for mod in (cv, jcv):
        with pytest.raises(mod.InvalidPointError, match="subgroup"):
            mod.G1.from_bytes(bad.to_bytes())


def test_four_squares_equal_tfhe_tpu():
    for v in [0, 1, 2, 3, 6, 7, 15, 28, 240, (1 << 97) + 12345]:
        s = four_squares(v)
        assert sum(x * x for x in s) == v
        assert list(s) == list(jfour(v))


# -- pke v1 and v2 -------------------------------------------------------------

SCHEMES = {
    "v1": (dict(d=8, k=1, b=256, q=0, t=32, pad_bits=1, seed=7),
           (8, 1, 256, 32, 1), pke.PkeCrs, pke, jpke.PkeCrs, jpke),
    "v2": (dict(d=4, k=1, b_inf=2, q=0, t=8, pad_bits=1, seed=11),
           (4, 1, 2, 8, 1), pke_v2.PkeV2Crs, pke_v2, jpke2.PkeV2Crs, jpke2),
}


@pytest.fixture(scope="module")
def schemes():
    """Each scheme's CRS from one seed in both packages."""
    return {name: (crs_cls.generate(**kw), jcrs_cls.generate(**kw))
            for name, (kw, _, crs_cls, _, jcrs_cls, _) in SCHEMES.items()}


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_proofs_equal_and_cross_verify(schemes, scheme):
    """One CRS seed, one statement, one prove seed: the CRS and the proof
    byte-equal; the port verifies tfhe_tpu's proof and tfhe_tpu the
    port's."""
    _, case, _, mod, _, jmod = SCHEMES[scheme]
    crs, jcrs = schemes[scheme]
    assert [p.to_bytes() for p in crs.g_list] == \
        [p.to_bytes() for p in jcrs.g_list]
    assert [p.to_bytes() for p in crs.g_hat_list] == \
        [p.to_bytes() for p in jcrs.g_hat_list]
    public, private, _ = _gen_testcase(np.random.default_rng(3), *case)
    proof = mod.prove(crs, public, private, metadata=b"meta", seed=b"s")
    jproof = jmod.prove(jcrs, public, private, metadata=b"meta", seed=b"s")
    assert proof.to_bytes() == jproof.to_bytes()
    assert mod.verify(convert.zk_proof_from_fields(jproof),
                      convert.zk_crs_from_fields(jcrs), public,
                      metadata=b"meta")
    assert jmod.verify(to_jax_proof(proof), jcrs, public, metadata=b"meta")


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_tampered_proofs_rejected(schemes, scheme):
    """Wrong metadata, a tampered statement and a proof of another
    statement fail the port's verifier."""
    _, case, _, mod, _, _ = SCHEMES[scheme]
    crs, _ = schemes[scheme]
    public, private, _ = _gen_testcase(np.random.default_rng(4), *case)
    proof = mod.prove(crs, public, private, metadata=b"", seed=b"s")
    assert mod.verify(proof, crs, public, metadata=b"")
    assert not mod.verify(proof, crs, public, metadata=b"x")
    a, b, c1, c2 = public
    assert not mod.verify(proof, crs, (a, b, c1, [_i64(c2[0] + (1 << 59))]),
                          metadata=b"")
    other, _, _ = _gen_testcase(np.random.default_rng(9), *case)
    assert not mod.verify(proof, crs, other, metadata=b"")


def test_crs_and_proof_envelopes_equal_tfhe_tpu(schemes):
    """``PkeV2Crs`` and ``PkeV2Proof`` envelopes: byte-equal, and each
    package reads the other's (convert carries both ways)."""
    crs, jcrs = schemes["v2"]
    blob = ser.serialize_zk_crs(crs)
    assert blob == jser.serialize_zk_crs(jcrs)
    back = convert.zk_from_envelope(jser.serialize_zk_crs(jcrs))
    assert ser.serialize_zk_crs(back) == blob
    public, private, _ = _gen_testcase(np.random.default_rng(5),
                                       *SCHEMES["v2"][1])
    proof = pke_v2.prove(crs, public, private, metadata=b"m", seed=b"p")
    pblob = ser.serialize_zk_proof(proof)
    assert pblob == jser.serialize_zk_proof(
        jpke2.prove(jcrs, public, private, metadata=b"m", seed=b"p"))
    loaded = ser.deserialize(pblob, expected_type="PkeV2Proof", device="cpu")
    assert loaded.to_bytes() == proof.to_bytes()
    assert pke_v2.verify(loaded, back, public, metadata=b"m")
    assert jpke2.verify(jser.deserialize(pblob), jcrs, public, metadata=b"m")


# -- proven compact lists ------------------------------------------------------

def _generators(seed):
    return (csprng.EncryptionRandomGenerator(seed, seed + 1),
            jcsprng.EncryptionRandomGenerator(seed, seed + 1))


@pytest.mark.parametrize("scheme", ["v1", "v2"])
def test_proven_list_equals_tfhe_tpu(scheme, monkeypatch):
    """Compact keys carried from tfhe_tpu, one encryption generator and one
    list seed: the list and every proof bit-equal to tfhe_tpu's proven
    with each bin's ``bin_seed`` (bins of 16 messages: 20 values make two,
    and their seeds differ), tfhe_tpu's verifier accepts the port's list,
    the port's ``verify_and_expand`` decrypts it; a tampered body is
    rejected by both."""
    import secrets

    bin_seeds = [pl.bin_seed(PROVE_SEED, b) for b in range(2)]
    assert bin_seeds[0] != bin_seeds[1]
    drawn = iter(bin_seeds)
    monkeypatch.setattr(secrets, "token_bytes", lambda k: next(drawn))
    jp, p = _pke_set(jparams), _pke_set(pm)
    jpriv = jcpk.CompactPrivateKey.generate(jp, seed=5)
    jpk = jcpk.CompactPublicKey.generate(jpriv)
    priv = convert.compact_private_key_from_arrays(
        p, np.asarray(jpriv.lwe_sk.bits, dtype=np.uint64), device="cpu")
    pk = convert.compact_public_key_from_arrays(p, jpk.mask, jpk.body,
                                                device="cpu")
    crs_fn = pl.crs_for_params_v2 if scheme == "v2" else pl.crs_for_params
    jcrs_fn = (jpl.crs_for_params_v2 if scheme == "v2"
               else jpl.crs_for_params)
    crs, jcrs = crs_fn(p, 16, seed=2), jcrs_fn(jp, 16, seed=2)
    vals = [(3 * i + 1) % 16 for i in range(20)]
    rng, jrng = _generators(77)
    lst = pl.ProvenCompactCiphertextList.encrypt_and_prove(
        pk, vals, crs, metadata=b"md", rng=rng, seed=PROVE_SEED)
    jlst = jpl.ProvenCompactCiphertextList.encrypt_and_prove(
        jpk, vals, jcrs, metadata=b"md", rng=jrng)
    np.testing.assert_array_equal(to_u64(lst.ct_list.masks),
                                  jlst.ct_list.masks)
    np.testing.assert_array_equal(to_u64(lst.ct_list.bodies),
                                  jlst.ct_list.bodies)
    assert [x.to_bytes() for x in lst.proofs] == \
        [x.to_bytes() for x in jlst.proofs]
    assert next(drawn, None) is None
    carried = jpl.ProvenCompactCiphertextList(
        ct_list=jcpk.CompactCiphertextList(
            masks=to_u64(lst.ct_list.masks), bodies=to_u64(lst.ct_list.bodies),
            count=lst.ct_list.count, params=jp, degree=lst.ct_list.degree),
        proofs=[to_jax_proof(x) for x in lst.proofs], metadata=b"md")
    assert carried.verify(jcrs, jpk, metadata=b"md")
    ct = lst.verify_and_expand(crs, pk, metadata=b"md")
    assert list(priv.decrypt_expanded(ct.ct)) == [v % 16 for v in vals]
    lst.ct_list.bodies[1] += 1 << 60
    carried.ct_list.bodies[1] += np.uint64(1 << 60)
    assert not lst.verify(crs, pk, metadata=b"md")
    assert not carried.verify(jcrs, jpk, metadata=b"md")
    with pytest.raises(ValueError, match="invalid ZK proof"):
        lst.verify_and_expand(crs, pk, metadata=b"md")


def test_default_randomness_is_fresh():
    """Without ``rng`` and ``seed`` the list draws from ``secrets``: two
    lists of the same values differ, and both verify."""
    p = _pke_set(pm)
    priv = cpk.CompactPrivateKey.generate(p, seed=5, device="cpu")
    pk = cpk.CompactPublicKey.generate(priv)
    crs = pl.crs_for_params_v2(p, 4, seed=3)
    a = pl.ProvenCompactCiphertextList.encrypt_and_prove(pk, [1, 2], crs)
    b = pl.ProvenCompactCiphertextList.encrypt_and_prove(pk, [1, 2], crs)
    assert not torch.equal(a.ct_list.bodies, b.ct_list.bodies)
    assert a.proofs[0].to_bytes() != b.proofs[0].to_bytes()
    assert a.verify(crs, pk) and b.verify(crs, pk)


# -- the transcript ------------------------------------------------------------

def test_transcript_framing_equals_tfhe_tpu():
    """The reference's own zero-bits vectors (hashes.rs:1390-1409), and
    every framing function of the port equal to tfhe_tpu's on the same
    inputs, through a whole challenge chain."""
    assert tr.encode_proven_zero_bits_anybit_anyslot(1, 1 << 5, 6) == bytes(
        [0b11101111, 0b10111101, 0b11110111, 0b11110])
    assert tr.encode_proven_zero_bits_anybit_anyslot(2, 1 << 9, 3) == bytes(
        [0b1111111, 0b11111110, 0b11111100, 0b1])
    assert tr.zp_hash([b"abc"], 3) == jtr.zp_hash([b"abc"], 3)
    assert tr.zp_hash_128([b"abc"], 2) == jtr.zp_hash_128([b"abc"], 2)
    assert tr.zp_bytes(12345) == jtr.zp_bytes(12345)
    g = cv.G1.generator() * 7
    assert tr.g1_bytes(g) == jtr.g1_bytes(jcv.G1.generator() * 7)
    assert tr.g1_bytes(cv.G1.zero())[-1] == 1
    assert tr.gen_R([b"seed"], 128, 4) == jtr.gen_R([b"seed"], 128, 4)
    assert tr.encode_R_compact([1, -1, 0, 0, 0, 1]) == \
        jtr.encode_R_compact([1, -1, 0, 0, 0, 1])
    assert tr.gen_scalars_compact([b"x"], 5) == \
        jtr.gen_scalars_compact([b"x"], 5)

    def chain(mod, meta):
        t = mod.PkeV2Transcript(mod.separators_from_crs_ds(b"test-ds"),
                                b"\x00" * 16, meta, b"xbytes", D=10, m=3,
                                n=394, k=1, d=8)
        t.gen_R(b"A", b"B", b"C")
        return t.gen_phi(b"D"), t.gen_xi(b"E")

    assert chain(tr, b"m1") == chain(jtr, b"m1")
    assert chain(tr, b"m1") != chain(tr, b"m2")


# -- the production dimensions -------------------------------------------------

def test_zk_v2_production_dimensions():
    """pke v2 at ``PARAM_PKE_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128`` (d =
    2048, t-uniform 17), as tests/test_zk.py runs it: prove, verify and
    expand 6 values, decrypted; a tampered body rejected. The native curve
    carries the MSMs and the pairing checks."""
    from tfhe_tpu_torch.utils.params_registry import get as params_by_name

    P = params_by_name("PARAM_PKE_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128")
    before = dict(cv.NATIVE_CALLS)
    crs = pl.crs_for_params_v2(P, max_bin_messages=8, seed=1)
    assert crs.d == 2048
    priv = cpk.CompactPrivateKey.generate(P, seed=7, device="cpu")
    pk = cpk.CompactPublicKey.generate(priv)
    msgs = [3, 0, 2, 1, 1, 2]
    lst = pl.ProvenCompactCiphertextList.encrypt_and_prove(
        pk, msgs, crs, metadata=b"prod")
    ct = lst.verify_and_expand(crs, pk, metadata=b"prod")
    assert list(priv.decrypt_expanded(ct.ct)) == msgs
    lst.ct_list.bodies[0] += 1 << 59
    assert not lst.verify(crs, pk, metadata=b"prod")
    assert all(cv.NATIVE_CALLS[k] > before[k] for k in
               ("fixed_powers", "msm", "pairing_product"))
