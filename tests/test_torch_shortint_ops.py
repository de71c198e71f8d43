"""The rest of the port's shortint layer against tfhe_tpu at PARAM_TEST_TOY,
on the CPU (v6b: plain K2 acc32 -> plain K1):

- every leveled and bivariate op of ``ServerKey`` (``unchecked_add``,
  ``unchecked_scalar_add``, ``unchecked_scalar_mul``, ``unchecked_neg``,
  ``unchecked_sub``, ``carry_extract``, ``message_extract``,
  ``generate_msg_lookup_table``, ``unchecked_apply_lookup_table_bivariate``,
  ``add``, ``smart_add``, ``mul``, ``keyswitch``, the ``ks_only`` /
  ``pbs_only`` entry points): output bits, degree, noise level and key
  equal, the clear function back, the inputs untouched; the noise check;
- the core algorithms ``lwe_trivial``, ``glwe_decrypt``, ``ggsw_encrypt``,
  ``lwe_encrypt32``, ``gen_keyswitch_key32``, ``decomp.recompose`` and
  ``polynomial.monomial_mul_and_subtract``;
- ``core/noise_formulas.py`` (every formula and the simulation engine) and
  ``utils/fork_budgets.py`` (the budgets, the sequential sampler, forks).

Tolerance: exact, floats included (the same formulas on the same inputs)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfhe_tpu.core import algorithms as jalgo
from tfhe_tpu.core import noise_formulas as jnf
from tfhe_tpu.ops import decomp as jdecomp
from tfhe_tpu.ops import polynomial as jpoly
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils import csprng as jcsprng
from tfhe_tpu.utils import fork_budgets as jfb
from tfhe_tpu.utils import params as jparams

from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch._torus import from_u64, to_u64
from tfhe_tpu_torch.core import algorithms as algo
from tfhe_tpu_torch.core import noise_formulas as nf
from tfhe_tpu_torch.core.entities import GlweSecretKey, LweSecretKey
from tfhe_tpu_torch.ops import decomp, polynomial
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.server_key import ServerKey
from tfhe_tpu_torch.utils import csprng, fork_budgets
from tfhe_tpu_torch.utils import params

SEED = 31


@pytest.fixture(scope="module")
def keys():
    jck = JClientKey.generate(jparams.PARAM_TEST_TOY, seed=SEED)
    ck = ClientKey.generate(params.PARAM_TEST_TOY, seed=SEED, device="cpu")
    return jck, JServerKey.generate(jck), ck, ServerKey.generate(ck)


@pytest.fixture(scope="module")
def cts(keys):
    """Encryptions of both packages (same stream), dirty ones included:
    a (messages), b (messages), d = a + b (carries set)."""
    jck, jsk, ck, sk = keys
    a, b = np.array([3, 1, 2, 0], np.uint64), np.array([2, 3, 1, 0],
                                                      np.uint64)
    ja, jb = jck.encrypt(a), jck.encrypt(b)
    pa, pb = ck.encrypt(a), ck.encrypt(b)
    return ({"a": ja, "b": jb, "d": jsk.unchecked_add(ja, jb)},
            {"a": pa, "b": pb, "d": sk.unchecked_add(pa, pb)},
            {"a": a, "b": b, "d": a + b})


MM = 4
#: name -> (fn(key, x), clear oracle of the message and carry)
OPS = {
    "unchecked_add": (lambda k, x: k.unchecked_add(x["a"], x["b"]),
                      lambda c: c["a"] + c["b"]),
    "unchecked_scalar_add": (lambda k, x: k.unchecked_scalar_add(x["a"], 5),
                             lambda c: c["a"] + 5),
    "unchecked_scalar_mul": (lambda k, x: k.unchecked_scalar_mul(x["b"], 3),
                             lambda c: c["b"] * 3),
    "unchecked_neg": (lambda k, x: k.unchecked_neg(x["d"]),
                      lambda c: (8 - c["d"]) % 16),
    "unchecked_sub": (lambda k, x: k.unchecked_sub(x["a"], x["b"]),
                      lambda c: (c["a"] + 4 - c["b"]) % 16),
    "carry_extract": (lambda k, x: k.carry_extract(x["d"]),
                      lambda c: c["d"] // MM),
    "message_extract": (lambda k, x: k.message_extract(x["d"]),
                        lambda c: c["d"] % MM),
    "msg_lookup_table": (lambda k, x: k.apply_lookup_table(
        x["d"], k.generate_msg_lookup_table(lambda v: 3 * v + 1)),
        lambda c: (3 * (c["d"] % MM) + 1) % MM),
    "bivariate": (lambda k, x: k.unchecked_apply_lookup_table_bivariate(
        x["a"], x["b"], lambda u, v: (u + 2 * v) % MM),
        lambda c: (c["a"] + 2 * c["b"]) % MM),
    "add": (lambda k, x: k.add(x["d"], x["b"]),
            lambda c: (c["d"] + c["b"]) % MM),
    "smart_add": (lambda k, x: k.smart_add(k.unchecked_scalar_mul(x["d"], 2),
                                           x["d"]),
                  lambda c: (2 * c["d"]) % MM + c["d"]),
    "smart_add[fits]": (lambda k, x: k.smart_add(x["a"], x["b"]),
                        lambda c: c["a"] + c["b"]),
    "mul": (lambda k, x: k.mul(x["a"], x["b"]),
            lambda c: (c["a"] * c["b"]) % MM),
}


@pytest.mark.parametrize("name", list(OPS))
def test_op_bit_equal(keys, cts, name):
    jck, jsk, ck, sk = keys
    jx, px, clear = cts
    fn, oracle = OPS[name]
    snaps = {k: v.ct.clone() for k, v in px.items()}
    jout, out = fn(jsk, jx), fn(sk, px)
    np.testing.assert_array_equal(to_u64(out.ct), np.asarray(jout.ct))
    assert (out.degree, out.noise_level, out.under_key) == (
        jout.degree, jout.noise_level, jout.under_key)
    np.testing.assert_array_equal(ck.decrypt_message_and_carry(out),
                                  oracle(clear))
    for k, v in px.items():
        assert torch.equal(v.ct, snaps[k]), f"{name} wrote into {k}"


def test_noise_check_raises(keys, cts):
    _, jsk, _, sk = keys
    jx, px, _ = cts
    with pytest.raises(AssertionError, match="noise level"):
        jsk.unchecked_apply_lookup_table_bivariate(
            jsk.unchecked_scalar_mul(jx["a"], 3), jx["b"], lambda u, v: u)
    with pytest.raises(ValueError, match="noise level 13 exceeds max 5"):
        sk.unchecked_apply_lookup_table_bivariate(
            sk.unchecked_scalar_mul(px["a"], 3), px["b"], lambda u, v: u)


def test_ks_only_and_pbs_only_equal(keys, cts):
    jck, jsk, ck, sk = keys
    jx, px, clear = cts
    jks_pbs, jpbs, jks = jsk._fns
    small = sk.ks_only(px["a"].ct)
    np.testing.assert_array_equal(to_u64(small),
                                  np.asarray(jks(jx["a"].ct, jsk.ksk_i8)))
    np.testing.assert_array_equal(to_u64(sk.keyswitch(px["a"]).ct),
                                  to_u64(small))
    lut = sk.generate_lookup_table(lambda v: v ^ 3)
    want = jpbs(jks(jx["a"].ct, jsk.ksk_i8), jnp.asarray(to_u64(lut.acc)),
                jsk.pbs_bsk)
    np.testing.assert_array_equal(to_u64(sk.pbs_only(small, lut.acc)),
                                  np.asarray(want))
    np.testing.assert_array_equal(to_u64(sk.ks_pbs(px["a"].ct, lut.acc)),
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# core algorithms
# ---------------------------------------------------------------------------

def _secret_keys(k, N, n, seed):
    jsec = jcsprng.SecretRandomGenerator(seed)
    sec = csprng.SecretRandomGenerator(seed)
    jg = jalgo.gen_glwe_secret_key(k, N, jsec)
    g = algo.gen_glwe_secret_key(k, N, sec, "cpu")
    jl = jalgo.gen_lwe_secret_key(n, jsec)
    return jg, g, jl, algo.gen_lwe_secret_key(n, sec, "cpu")


def test_core_algorithms_equal():
    jg, g, jl, l = _secret_keys(2, 64, 12, 3)
    noise = params.PARAM_TEST_TOY.glwe_noise_distribution
    jnoise = jparams.PARAM_TEST_TOY.glwe_noise_distribution
    jgen = jcsprng.EncryptionRandomGenerator(4, 5)
    gen = csprng.EncryptionRandomGenerator(4, 5)
    pts = np.array([1 << 62, 3 << 61, 5], dtype=np.uint64)
    np.testing.assert_array_equal(to_u64(algo.lwe_trivial(12, pts, "cpu")),
                                  jalgo.lwe_trivial(12, pts))
    jggsw = jalgo.ggsw_encrypt(jg, 1, 10, 2, jnoise, jgen)
    ggsw = algo.ggsw_encrypt(g, 1, 10, 2, noise, gen)
    np.testing.assert_array_equal(to_u64(ggsw), np.asarray(jggsw))
    assert tuple(ggsw.shape) == (2, 3, 3, 64)
    glwe = ggsw.reshape(-1, 3, 64)
    np.testing.assert_array_equal(to_u64(algo.glwe_decrypt(g, glwe)),
                                  jalgo.glwe_decrypt(jg, np.asarray(jggsw)
                                                     .reshape(-1, 3, 64)))
    np.testing.assert_array_equal(to_u64(algo.glwe_decrypt(g, glwe[0])),
                                  jalgo.glwe_decrypt(jg, to_u64(glwe[0])))
    # the u32 torus: encryptions and the KS32 keyswitch key
    t3 = params.DynamicDistribution.t_uniform(3)
    jt3 = jparams.DynamicDistribution.t_uniform(3)
    g3 = params.DynamicDistribution.gaussian_from_std_dev(2.0 ** -20)
    jg3 = jparams.DynamicDistribution.gaussian_from_std_dev(2.0 ** -20)
    for dist, jdist in ((t3, jt3), (g3, jg3)):
        np.testing.assert_array_equal(
            to_u64(algo.lwe_encrypt32(l, pts, dist, gen)),
            jalgo.lwe_encrypt32(jl, pts, jdist, jgen))
        big = LweSecretKey(g.bits.reshape(-1))
        jbig = jg.as_lwe_secret_key()
        np.testing.assert_array_equal(
            to_u64(algo.gen_keyswitch_key32(big, l, 4, 4, dist, gen).data),
            jalgo.gen_keyswitch_key32(jbig, jl, 4, 4, jdist, jgen).data)


def test_recompose_and_monomial_mul_and_subtract():
    rng = np.random.default_rng(9)
    x = rng.integers(0, 1 << 64, size=(3, 40), dtype=np.uint64)
    for base_log, levels in ((23, 1), (4, 4), (10, 2)):
        digits = decomp.decompose(from_u64(x, "cpu"), base_log, levels)
        want = np.asarray(jdecomp.recompose(
            jdecomp.decompose(jnp.asarray(x), base_log, levels), base_log,
            levels))
        got = decomp.recompose(digits, base_log, levels)
        np.testing.assert_array_equal(to_u64(got), want)
        np.testing.assert_array_equal(
            want, jdecomp.np_closest_representable(x, base_log, levels))
    deg = rng.integers(0, 80, size=(3,), dtype=np.uint64)
    np.testing.assert_array_equal(
        to_u64(polynomial.monomial_mul_and_subtract(
            from_u64(x, "cpu"), torch.from_numpy(deg.astype(np.int64))[:, None])),
        np.asarray(jpoly.monomial_mul_and_subtract(jnp.asarray(x),
                                                   jnp.asarray(deg)[:, None])))


# ---------------------------------------------------------------------------
# noise formulas and fork budgets
# ---------------------------------------------------------------------------

def test_noise_formulas_equal():
    args = {
        "keyswitch_additive_variance_gaussian": (866, 742, 3, 5),
        "pbs_additive_variance_gaussian": (866, 1, 2048, 23, 1),
        "keyswitch_additive_variance_exact": (2048, 3, 5, 1e-12),
        "modulus_switch_additive_variance": (866, 12, True),
        "external_product_additive_variance_exact": (1, 2048, 23, 1, 1e-29),
        "blind_rotate_additive_variance_exact": (866, 1, 2048, 23, 1, 1e-29),
        "bnf_blind_rotate_extra_variance": (866, 1, 2048, 23, 1, 2.0 ** 57),
    }
    for name, a in args.items():
        assert getattr(nf, name)(*a) == getattr(jnf, name)(*a), name
    assert nf.modulus_switch_additive_variance(16, 9) == \
        jnf.modulus_switch_additive_variance(16, 9)
    for pname in ("PARAM_MESSAGE_2_CARRY_2_KS_PBS", "PARAM_TEST_TOY"):
        eng = nf.NoiseSimulationEngine(getattr(params, pname))
        jeng = jnf.NoiseSimulationEngine(getattr(jparams, pname))
        x, jx = eng.encrypt(), jeng.encrypt()
        assert dataclasses.astuple(x) == dataclasses.astuple(jx)
        s = eng.scalar_mul(eng.add(x, x), 3)
        js = jeng.scalar_mul(jeng.add(jx, jx), 3)
        assert dataclasses.astuple(s) == dataclasses.astuple(js)
        for step in ("keyswitch", "pbs", "atomic_pattern"):
            assert dataclasses.astuple(getattr(eng, step)(s)) == \
                dataclasses.astuple(getattr(jeng, step)(js)), step
        assert eng.pfail_per_pbs(s) == jeng.pfail_per_pbs(js)


def test_fork_budgets_equal():
    calls = {"uniform_sample_bytes": (), "gaussian_pair_attempt_bytes": (),
             "gaussian_min_attempts": (), "t_uniform_sample_bytes": (17,),
             "lwe_mask_elements": (16,), "lwe_noise_elements": (),
             "glwe_mask_elements": (2, 256), "glwe_noise_elements": (256,),
             "ggsw_mask_elements": (2, 256, 3),
             "ggsw_noise_elements": (2, 256, 3)}
    for name, a in calls.items():
        assert getattr(fork_budgets, name)(*a) == getattr(jfb, name)(*a), name
    for d, jd in ((params.DynamicDistribution.t_uniform(17),
                   jparams.DynamicDistribution.t_uniform(17)),
                  (params.PARAM_TEST_TOY.glwe_noise_distribution,
                   jparams.PARAM_TEST_TOY.glwe_noise_distribution)):
        assert fork_budgets.noise_bytes_per_element(d) == \
            jfb.noise_bytes_per_element(jd)
        for cfg in ("bsk_fork_config", "ggsw_fork_config"):
            a = (16, 1, 256, 1, d) if cfg == "bsk_fork_config" else \
                (1, 256, 1, d)
            ja = a[:-1] + (jd,)
            assert dataclasses.astuple(getattr(fork_budgets, cfg)(*a)) == \
                dataclasses.astuple(getattr(jfb, cfg)(*ja))
        assert dataclasses.astuple(fork_budgets.ksk_fork_config(
            512, 16, 5, d)) == dataclasses.astuple(jfb.ksk_fork_config(
                512, 16, 5, jd))
        assert dataclasses.astuple(fork_budgets.lwe_list_fork_config(
            7, 16, d)) == dataclasses.astuple(jfb.lwe_list_fork_config(
                7, 16, jd))
    # the sequential sampler and the forks consume the stream alike
    gen, jgen = csprng.AesCtrGenerator(8), jcsprng.AesCtrGenerator(8)
    np.testing.assert_array_equal(
        fork_budgets.gaussian_torus_u64_reference(gen, 7, 2.0 ** -30),
        jfb.gaussian_torus_u64_reference(jgen, 7, 2.0 ** -30))
    egen = csprng.EncryptionRandomGenerator(1, 2)
    jegen = jcsprng.EncryptionRandomGenerator(1, 2)
    kids = fork_budgets.fork(egen, fork_budgets.ForkConfig(3, 64, 32))
    jkids = jfb.fork(jegen, jfb.ForkConfig(3, 64, 32))
    for c, jc in zip(kids, jkids):
        np.testing.assert_array_equal(c.mask.uniform_u64(8),
                                      jc.mask.uniform_u64(8))
        np.testing.assert_array_equal(c.noise.uniform_u64(4),
                                      jc.noise.uniform_u64(4))
    np.testing.assert_array_equal(egen.mask.uniform_u64(2),
                                  jegen.mask.uniform_u64(2))
