"""The port's noise squashing (``tfhe_tpu_torch.core.squash``,
``tfhe_tpu_torch.shortint.noise_squashing``) against tfhe_tpu at
PARAM_TEST_TOY with PARAM_TEST_TOY_SQUASH on the CPU. Same seed =>
bit-equal keys; the same inputs in both packages. Tolerance: exact
(integer arithmetic, and Python-int oracles for the 128-bit values).

- the pair helpers and ``mul_u64_wide`` on random and edge limbs;
- ``decompose128`` in both regimes against tfhe_tpu's and the Python-int
  oracle of ``tests/test_noise_squashing.py``;
- ``_monomial_mul128`` / ``_monomial_div128``, ``_reconstruct128`` at 6
  and 8 primes, ``external_product128``, ``blind_rotate128`` over all steps
  on tfhe_tpu's own switched inputs;
- ``glwe_encrypt128`` / ``glwe_decrypt128``, the standard-domain BSK and
  the squashing key's NTT residues, bit-equal from equal seeds;
- the squashed body bit-equal to tfhe_tpu's; the mask equal to a
  Python-int exact extraction of tfhe_tpu's own rotated GLWE, and apart
  from tfhe_tpu's by 2^64 exactly where tfhe_tpu's limb-wise extraction
  negates a coefficient whose lo limb is not 0 (ROADMAP standing note 14),
  with its phase errors;
- ``decrypt`` equal, the squashed envelope byte-equal both ways, CPU
  tensors staying on the CPU, the multi-bit refusal.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tfhe_tpu.core import squash as jsq
from tfhe_tpu.ops import ntt as jntt
from tfhe_tpu.shortint import noise_squashing as jns
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils import csprng as jcsprng
from tfhe_tpu.utils import serialization as jser
from tfhe_tpu.utils import params as jpm

from test_noise_squashing import _oracle_decompose128
from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import from_u64, to_u32, to_u64
from tfhe_tpu_torch.core import squash as sq
from tfhe_tpu_torch.core.entities import LweSecretKey
from tfhe_tpu_torch.ops import ntt
from tfhe_tpu_torch.shortint import noise_squashing as ns
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.server_key import ServerKey
from tfhe_tpu_torch.utils import csprng
from tfhe_tpu_torch.utils import params as pm
from tfhe_tpu_torch.utils import serialization as ser

SEED = 99  # tests/test_noise_squashing.py's key seed
MSGS = np.array([0, 2, 5, 7, 8, 10, 13, 15], dtype=np.uint64)  # msg+carry
M64 = (1 << 64) - 1
M128 = (1 << 128) - 1
EDGE_HI = [0, M64, 1 << 63, (1 << 63) - 1]
EDGE_LO = [0, M64, 0, M64]


def cpu(a):
    return from_u64(a, "cpu")


def u128(hi, lo) -> np.ndarray:
    """Python ints hi * 2^64 + lo of u64 arrays (an object array)."""
    h = np.asarray(hi, dtype=np.uint64).astype(object)
    return (h << 64) | np.asarray(lo, dtype=np.uint64).astype(object)


def limbs(rng, n):
    hi = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    lo = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    hi[:4], lo[:4] = EDGE_HI, EDGE_LO
    return hi, lo


def centered(x: int) -> int:
    x &= M128
    return x - (1 << 128) if x >> 127 else x


@pytest.fixture(scope="module")
def keys():
    jck = JClientKey.generate(jpm.PARAM_TEST_TOY, seed=SEED)
    jsk = JServerKey.generate(jck)
    jpriv = jns.NoiseSquashingPrivateKey.generate(
        jck, jpm.PARAM_TEST_TOY_SQUASH)
    jnsk = jns.NoiseSquashingKey.generate(jck, jpriv)
    ck = ClientKey.generate(pm.PARAM_TEST_TOY, seed=SEED, device="cpu")
    sk = ServerKey.generate(ck)
    priv = ns.NoiseSquashingPrivateKey.generate(ck, pm.PARAM_TEST_TOY_SQUASH)
    nsk = ns.NoiseSquashingKey.generate(ck, priv)
    return dict(jck=jck, jsk=jsk, jpriv=jpriv, jnsk=jnsk, ck=ck, sk=sk,
                priv=priv, nsk=nsk)


@pytest.fixture(scope="module")
def squashed(keys):
    """MSGS squashed in both packages from the same encryptions; tfhe_tpu's
    rotation inputs and rotated GLWE recorded around its own call."""
    jct, ct = keys["jck"].encrypt(MSGS), keys["ck"].encrypt(MSGS)
    np.testing.assert_array_equal(to_u64(ct.ct), np.asarray(jct.ct))
    seen = {}
    rotate, extract = jsq.blind_rotate128, jsq.sample_extract128

    def rotate_spy(*args):
        seen["rotate_args"] = args
        return rotate(*args)

    def extract_spy(hi, lo, nth=0):
        seen["rotated"] = (np.asarray(hi), np.asarray(lo))
        return extract(hi, lo, nth)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsq, "blind_rotate128", rotate_spy)
        mp.setattr(jsq, "sample_extract128", extract_spy)
        js = keys["jnsk"].squash_ciphertext_noise(keys["jsk"], jct)
    ps = keys["nsk"].squash_ciphertext_noise(keys["sk"], ct)
    return dict(js=js, ps=ps, ct=ct, **seen)


# -- the pair helpers ------------------------------------------------------------

def test_mul_u64_wide():
    rng = np.random.default_rng(0)
    a, b = limbs(rng, 200)
    hi, lo = sq.mul_u64_wide(cpu(a), cpu(b))
    jhi, jlo = jsq.mul_u64_wide(a, b)
    np.testing.assert_array_equal(to_u64(hi), jhi)
    np.testing.assert_array_equal(to_u64(lo), jlo)
    assert list(u128(to_u64(hi), to_u64(lo))) == [
        int(x) * int(y) for x, y in zip(a, b)]
    # a python-int factor, as the Garner weights are given
    c = (1 << 64) - 12345
    hi, lo = sq.mul_u64_wide(cpu(a), c)
    assert list(u128(to_u64(hi), to_u64(lo))) == [int(x) * c for x in a]


def test_add_sub_neg128():
    rng = np.random.default_rng(1)
    ah, al = limbs(rng, 100)
    bh, bl = limbs(rng, 100)
    bh, bl = bh[::-1].copy(), bl[::-1].copy()
    a, b = u128(ah, al), u128(bh, bl)
    with np.errstate(over="ignore"):
        jadd, jsub = jsq.add128(ah, al, bh, bl), jsq.sub128(ah, al, bh, bl)
        jneg = jsq.neg128(bh, bl)
    for fn, jout, want in (
            (sq.add128, jadd, (a + b) & M128),
            (sq.sub128, jsub, (a - b) & M128)):
        hi, lo = fn(cpu(ah), cpu(al), cpu(bh), cpu(bl))
        np.testing.assert_array_equal(to_u64(hi), jout[0])
        np.testing.assert_array_equal(to_u64(lo), jout[1])
        assert list(u128(to_u64(hi), to_u64(lo))) == list(want)
    hi, lo = sq.neg128(cpu(bh), cpu(bl))
    np.testing.assert_array_equal(to_u64(hi), np.asarray(jneg[0]))
    assert list(u128(to_u64(hi), to_u64(lo))) == list((-b) & M128)


@pytest.mark.parametrize("bl,l", [(24, 3), (23, 3), (13, 6), (61, 1),
                                  (20, 3), (12, 5)])
def test_decompose128(bl, l):
    """Both regimes (rep <= 63, 64 < rep <= 126) against tfhe_tpu's and the
    Python-int oracle."""
    rng = np.random.default_rng(2)
    hi, lo = limbs(rng, 256)
    got = sq.decompose128(cpu(hi), cpu(lo), bl, l)
    assert got.dtype == torch.int64 and got.shape == (256, l)
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jsq.decompose128(jnp.asarray(hi), jnp.asarray(lo), bl, l)))
    for i, x in enumerate(u128(hi, lo)):
        assert got[i].tolist() == _oracle_decompose128(int(x), bl, l), hex(x)


N_MONO = 64


@pytest.mark.parametrize("d", [0, 1, N_MONO - 1, N_MONO, 2 * N_MONO - 1],
                         ids=["0", "1", "N-1", "N", "2N-1"])
def test_monomial_mul128(d):
    N = N_MONO
    rng = np.random.default_rng(3)
    hi, lo = limbs(rng, 3 * 2 * N)
    hi, lo = hi.reshape(3, 2, N), lo.reshape(3, 2, N)
    degs = np.array([[d], [(d + 7) % (2 * N)], [d]])
    for port, jax_fn in ((sq._monomial_mul128, jsq._monomial_mul128),
                         (sq._monomial_div128, jsq._monomial_div128)):
        ph, pl = port(cpu(hi), cpu(lo), torch.as_tensor(degs))
        jh, jl = jax_fn(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(degs))
        np.testing.assert_array_equal(to_u64(ph), np.asarray(jh))
        np.testing.assert_array_equal(to_u64(pl), np.asarray(jl))
    # against the definition: X^d * a, a negation the pair's
    ph, pl = sq._monomial_mul128(cpu(hi[0, 0]), cpu(lo[0, 0]), d)
    a = u128(hi[0, 0], lo[0, 0])
    want = [0] * N
    for i in range(N):
        j, s = (i + d) % (2 * N), 1
        if j >= N:
            j, s = j - N, -1
        want[j] = (s * int(a[i])) & M128
    assert list(u128(to_u64(ph), to_u64(pl))) == want


@pytest.mark.parametrize("num_primes", [6, 8])
def test_reconstruct128(num_primes):
    """The Garner path to 128 bits, with the sign correction, against
    tfhe_tpu's and the centered CRT value."""
    plan, jplan = ntt.get_plan(256, num_primes), jntt.get_plan(256,
                                                                num_primes)
    rng = np.random.default_rng(4)
    res = np.stack([rng.integers(0, p, 512, dtype=np.uint64)
                    for p in plan.primes])
    res[:, 0] = 0
    res[:, 1] = [p - 1 for p in plan.primes]
    hi, lo = sq._reconstruct128(plan, cpu(res))
    jhi, jlo = jsq._reconstruct128(jplan, jnp.asarray(res))
    np.testing.assert_array_equal(to_u64(hi), np.asarray(jhi))
    np.testing.assert_array_equal(to_u64(lo), np.asarray(jlo))
    prod = math.prod(plan.primes)
    for i in (0, 1, 2, 511):
        x = 0
        for r, p in zip(res[:, i], plan.primes):
            q = prod // p
            x += int(r) * q * pow(q, -1, p)
        x %= prod
        x = x - prod if x > prod // 2 else x
        assert int(u128(to_u64(hi[i:i + 1]), to_u64(lo[i:i + 1]))[0]) \
            == x & M128


def test_external_product128(keys):
    """One external product of the squashing key's first GGSW with a random
    GLWE128 batch."""
    nsk, jnsk = keys["nsk"], keys["jnsk"]
    p = nsk.params
    R, N = p.glwe_size, p.polynomial_size
    rng = np.random.default_rng(5)
    hi, lo = limbs(rng, 3 * R * N)
    hi, lo = hi.reshape(3, R, N), lo.reshape(3, R, N)
    plan = ntt.get_plan(N, nsk.num_primes)
    ph, pl = sq.external_product128(nsk.bsk_res[:, 0], cpu(hi), cpu(lo),
                                    nsk.base_log, nsk.levels, plan)
    jh, jl = jax.jit(jsq.external_product128, static_argnums=(3, 4, 5))(
        jnsk.bsk_res[:, 0], jnp.asarray(hi), jnp.asarray(lo), jnsk.base_log,
        jnsk.levels, jntt.get_plan(N, jnsk.num_primes))
    np.testing.assert_array_equal(to_u64(ph), np.asarray(jh))
    np.testing.assert_array_equal(to_u64(pl), np.asarray(jl))


def test_glwe128_and_bootstrap_key_bit_equal():
    """glwe_encrypt128 / glwe_decrypt128 and gen_bootstrap_key128 from equal
    generators, bit for bit, on a 6-bit input key."""
    def gens():
        return (csprng.EncryptionRandomGenerator(123, 456),
                jcsprng.EncryptionRandomGenerator(123, 456))

    gen, jgen = gens()
    k, N = 1, 256
    bits = gen.mask.uniform_binary(k * N).reshape(k, N)
    jgen.mask.uniform_binary(k * N)
    sk = sq.GlweSecretKey128(cpu(bits))
    jsk = jsq.GlweSecretKey128(bits=bits.astype(np.uint64))
    rng = np.random.default_rng(6)
    pts_hi = rng.integers(0, 1 << 64, (2, N), dtype=np.uint64) & np.uint64(
        0xFFFFFF0000000000)
    pts_lo = rng.integers(0, 1 << 64, (2, N), dtype=np.uint64)
    for noise in (jpm.DynamicDistribution.t_uniform(3),
                  jpm.DynamicDistribution.gaussian_from_std_dev(2.0 ** -100)):
        pnoise = pm.DynamicDistribution(noise.kind, noise.std_dev,
                                        noise.bound_log2)
        ch, cl = sq.glwe_encrypt128(sk, cpu(pts_hi), cpu(pts_lo), pnoise, gen)
        jh, jl = jsq.glwe_encrypt128(jsk, pts_hi, pts_lo, noise, jgen)
        np.testing.assert_array_equal(to_u64(ch), jh)
        np.testing.assert_array_equal(to_u64(cl), jl)
        dh, dl = sq.glwe_decrypt128(sk, ch, cl)
        jdh, jdl = jsq.glwe_decrypt128(jsk, jh, jl)
        np.testing.assert_array_equal(to_u64(dh), jdh)
        np.testing.assert_array_equal(to_u64(dl), jdl)
    in_bits = np.array([1, 0, 1, 1, 0, 1], dtype=np.uint64)
    noise = jpm.DynamicDistribution.t_uniform(3)
    pnoise = pm.DynamicDistribution.t_uniform(3)
    bsk = sq.gen_bootstrap_key128(LweSecretKey(cpu(in_bits)), sk, 24, 3,
                                  pnoise, gen)
    jbsk = jsq.gen_bootstrap_key128(
        jpm_lwe_key(in_bits), jsk, 24, 3, noise, jgen)
    np.testing.assert_array_equal(to_u64(bsk.hi), jbsk.hi)
    np.testing.assert_array_equal(to_u64(bsk.lo), jbsk.lo)
    res = sq.bootstrap_key128_to_ntt(bsk, 6).residues
    np.testing.assert_array_equal(
        to_u32(res), np.asarray(jsq.bootstrap_key128_to_ntt(jbsk, 6)
                                .residues))


def jpm_lwe_key(bits):
    from tfhe_tpu.core.entities import LweSecretKey as JLweSecretKey

    return JLweSecretKey(bits=bits)


# -- the keys and the squash ------------------------------------------------------

def test_keys_bit_equal(keys):
    """The squashing private key and the BSK's NTT residues (6 primes at
    base 2^24, 3 levels) bit for bit."""
    np.testing.assert_array_equal(to_u64(keys["priv"].glwe_sk.bits),
                                  np.asarray(keys["jpriv"].glwe_sk.bits))
    nsk, jnsk = keys["nsk"], keys["jnsk"]
    assert (nsk.num_primes, nsk.base_log, nsk.levels) == (
        jnsk.num_primes, jnsk.base_log, jnsk.levels) == (6, 24, 3)
    assert nsk.bsk_res.dtype == torch.int32
    np.testing.assert_array_equal(to_u32(nsk.bsk_res),
                                  np.asarray(jnsk.bsk_res))
    # the compute keys drawn before them are the same too
    np.testing.assert_array_equal(to_u64(keys["sk"].ksk),
                                  np.asarray(keys["jsk"].ksk))


def test_blind_rotate128_all_steps(keys, squashed):
    """tfhe_tpu's rotation inputs (identity LUT, switched mask and body)
    through every step of the port's ``blind_rotate128``."""
    lut_hi, lut_lo, mask, body, bsk, bl, lv, jplan = squashed["rotate_args"]
    nsk = keys["nsk"]
    assert np.asarray(bsk).shape[1] == pm.PARAM_TEST_TOY.lwe_dimension
    hi, lo = sq.blind_rotate128(
        cpu(np.asarray(lut_hi)), cpu(np.asarray(lut_lo)),
        torch.from_numpy(np.asarray(mask).astype(np.int64)),
        torch.from_numpy(np.asarray(body).astype(np.int64)), nsk.bsk_res,
        bl, lv, ntt.get_plan(jplan.n, jplan.num_primes))
    jh, jl = squashed["rotated"]
    np.testing.assert_array_equal(to_u64(hi), jh)
    np.testing.assert_array_equal(to_u64(lo), jl)
    # and the port's own LUT is tfhe_tpu's
    ph, pl = nsk.identity_lut()
    np.testing.assert_array_equal(to_u64(ph), np.asarray(lut_hi)[0])
    np.testing.assert_array_equal(to_u64(pl), np.asarray(lut_lo)[0])


def exact_extract(hi, lo, nth=0) -> np.ndarray:
    """Python-int sample extraction of GLWE128s (hi, lo) u64[B, k+1, N]."""
    g = u128(hi, lo)
    B, R, N = g.shape
    out = np.empty((B, (R - 1) * N + 1), dtype=object)
    for b in range(B):
        for r in range(R - 1):
            for i in range(N):
                v = g[b, r, nth - i] if i <= nth else -g[b, r, N + nth - i]
                out[b, r * N + i] = v & M128
        out[b, -1] = g[b, R - 1, nth]
    return out


def test_squashed_body_bit_equal_mask_exact(squashed):
    js, ps = squashed["js"], squashed["ps"]
    jh, jl = np.asarray(js.hi), np.asarray(js.lo)
    ph, pl = to_u64(ps.hi), to_u64(ps.lo)
    assert ph.shape == jh.shape == (len(MSGS), 257)
    np.testing.assert_array_equal(ph[:, -1], jh[:, -1])
    np.testing.assert_array_equal(pl[:, -1], jl[:, -1])
    assert (u128(ph, pl) == exact_extract(*squashed["rotated"])).all()
    assert ps.degree == js.degree == squashed["ct"].degree
    assert (ps.message_modulus, ps.carry_modulus) == (4, 4)


def test_decrypt_equal(keys, squashed):
    priv, jpriv = keys["priv"], keys["jpriv"]
    assert priv.decrypt(squashed["ps"]) == jpriv.decrypt(squashed["js"]) \
        == list(MSGS)
    js = squashed["js"]
    carried = convert.squashed_ciphertext_from_arrays(
        np.asarray(js.hi), np.asarray(js.lo), js.degree, 4, 4, device="cpu")
    assert priv.decrypt_raw(carried) == jpriv.decrypt_raw(js)
    one = ns.SquashedNoiseCiphertext(carried.hi[3], carried.lo[3], 3, 4, 4)
    assert priv.decrypt_raw(one) == jpriv.decrypt_raw(js)[3:4]


def test_reference_extraction_offsets(squashed):
    """Standing note 14: tfhe_tpu's squashed mask exceeds the port's by
    exactly 2^64 at every negated position (1..N-1 of each mask polynomial,
    nth = 0) whose lo limb is not 0, and nowhere else; the lo limbs and
    the body are equal."""
    js, ps = squashed["js"], squashed["ps"]
    jh, jl = np.asarray(js.hi), np.asarray(js.lo)
    ph, pl = to_u64(ps.hi), to_u64(ps.lo)
    np.testing.assert_array_equal(jl, pl)
    diff = (u128(jh, jl) - u128(ph, pl)) & M128
    N = pm.PARAM_TEST_TOY_SQUASH.polynomial_size
    negated = np.zeros(jh.shape, dtype=bool)
    negated[:, 1:N] = True
    want = np.where(negated & (pl != 0), 1, 0).astype(object) << 64
    assert (diff == want).all()
    assert (want != 0).sum() == len(MSGS) * (N - 1)  # no lo limb is 0 here


def test_reference_extraction_phase_errors(keys, squashed):
    """Standing note 14 at toy (seed 99): tfhe_tpu's phase errors are
    2^71.0 on every message (the key's ones among the negated positions x
    2^64), the port's below 2^62."""
    delta = (1 << 127) // 16

    def log2_errors(priv, ct):
        return [math.log2(abs(centered(r - int(m) * delta)) or 1)
                for r, m in zip(priv.decrypt_raw(ct), MSGS)]

    jerr = log2_errors(keys["jpriv"], squashed["js"])
    perr = log2_errors(keys["priv"], squashed["ps"])
    assert all(70.9 < e < 71.1 for e in jerr), jerr
    assert max(perr) < 62, perr


def test_squash_preserves_carry(keys):
    """tests/test_noise_squashing.py's carry case: message+carry 6 and 5."""
    ck, sk = keys["ck"], keys["sk"]
    s = sk.unchecked_add(ck.encrypt([3, 2]), ck.encrypt([3, 3]))
    out = keys["nsk"].squash_ciphertext_noise(sk, s)
    assert out.degree == s.degree
    assert keys["priv"].decrypt(out) == [6, 5]


@pytest.mark.parametrize("nth", [0, 5, 255])
def test_sample_extract128_exact(nth):
    rng = np.random.default_rng(7 + nth)
    hi, lo = limbs(rng, 2 * 3 * 256)
    hi, lo = hi.reshape(2, 3, 256), lo.reshape(2, 3, 256)
    ph, pl = sq.sample_extract128(cpu(hi), cpu(lo), nth)
    assert (u128(to_u64(ph), to_u64(pl)) == exact_extract(hi, lo, nth)).all()


def test_squashed_envelope_byte_equal(squashed):
    """``serialize_squashed_ciphertext`` equals tfhe_tpu's bytes for the
    same ciphertext, and each package loads what the other wrote."""
    js = squashed["js"]
    ct = convert.squashed_ciphertext_from_arrays(
        np.asarray(js.hi), np.asarray(js.lo), js.degree, js.message_modulus,
        js.carry_modulus, device="cpu")
    blob, jblob = ser.serialize_squashed_ciphertext(ct), \
        jser.serialize_squashed_ciphertext(js)
    assert blob == jblob
    back = ser.deserialize(jblob, expected_type="SquashedNoiseCiphertext",
                           device="cpu")
    assert isinstance(back, ns.SquashedNoiseCiphertext)
    assert torch.equal(back.hi, ct.hi) and torch.equal(back.lo, ct.lo)
    assert (back.degree, back.message_modulus, back.carry_modulus) == (
        js.degree, 4, 4)
    jback = jser.deserialize(blob)
    np.testing.assert_array_equal(np.asarray(jback.hi), np.asarray(js.hi))
    ps = squashed["ps"]
    pback = ser.deserialize(ser.serialize_squashed_ciphertext(ps),
                            device="cpu")
    assert torch.equal(pback.hi, ps.hi) and torch.equal(pback.lo, ps.lo)


def test_cpu_tensors_stay_on_cpu(keys, squashed):
    cpu_dev = torch.device("cpu")
    assert keys["priv"].glwe_sk.bits.device == cpu_dev
    assert keys["nsk"].bsk_res.device == cpu_dev
    ps = squashed["ps"]
    assert ps.hi.device == ps.lo.device == cpu_dev
    assert ps.hi.dtype == ps.lo.dtype == torch.int64


def test_convert_keys_squash_alike(keys, squashed):
    """tfhe_tpu's squashing keys carried in by ``convert`` squash the same
    encryptions to the same bits as the port's own keys."""
    jnsk, jpriv = keys["jnsk"], keys["jpriv"]
    p = pm.PARAM_TEST_TOY_SQUASH
    nsk = convert.noise_squashing_key_from_arrays(
        p, np.asarray(jnsk.bsk_res), device="cpu")
    priv = convert.noise_squashing_private_key_from_arrays(
        p, np.asarray(jpriv.glwe_sk.bits), device="cpu")
    ct = squashed["ct"]
    one = type(ct)(ct=ct.ct[:2], degree=ct.degree, noise_level=1,
                   message_modulus=4, carry_modulus=4)
    out = nsk.squash_ciphertext_noise(keys["sk"], one)
    assert torch.equal(out.hi, squashed["ps"].hi[:2])
    assert torch.equal(out.lo, squashed["ps"].lo[:2])
    assert priv.decrypt(out) == list(MSGS[:2])


def test_multi_bit_squash_set_refused(keys):
    """Both packages refuse a multi-bit squashing set before any draw."""
    name = "NOISE_SQUASHING_PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_2_CARRY_2_" \
           "KS_PBS_TUNIFORM_2M128"
    p = pm.PARAMS_BY_NAME[name]
    assert p.grouping_factor == 4
    priv = ns.NoiseSquashingPrivateKey(keys["priv"].glwe_sk, p)
    with pytest.raises(ValueError, match="multi-bit"):
        ns.NoiseSquashingKey.generate(keys["ck"], priv)
    from tfhe_tpu.utils.params_registry import UNIVERSE

    jpriv = jns.NoiseSquashingPrivateKey(keys["jpriv"].glwe_sk,
                                         UNIVERSE[name])
    with pytest.raises(AssertionError, match="multi-bit"):
        jns.NoiseSquashingKey.generate(keys["jck"], jpriv)
