"""The port's foundations against tfhe_tpu on the same numpy inputs: the
negacyclic NTT (forward, digit forward, inverse, CRT reconstruction),
gadget decomposition, monomial products, and the CSPRNG's bytes and
samples. Tolerance: exact (integer arithmetic, same seed => same bits)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tfhe_tpu.ops import bnf2 as jb2
from tfhe_tpu.ops import decomp as jdecomp
from tfhe_tpu.ops import ntt as jntt
from tfhe_tpu.ops import polynomial as jpoly
from tfhe_tpu.utils import csprng as jcsprng

from tfhe_tpu_torch._torus import from_u64, to_u64
from tfhe_tpu_torch.ops import bnf2 as b2
from tfhe_tpu_torch.ops import decomp
from tfhe_tpu_torch.ops import ntt
from tfhe_tpu_torch.ops import polynomial as poly
from tfhe_tpu_torch.utils import csprng


def _u64(rng, shape):
    return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)


@pytest.mark.parametrize("n,num_primes", [(256, 2), (256, 4), (2048, 2),
                                          (2048, 4)])
def test_ntt_matches_jax(n, num_primes):
    rng = np.random.default_rng(n + num_primes)
    jplan = jntt.get_plan(n, num_primes)
    plan = ntt.get_plan(n, num_primes)
    x = _u64(rng, (3, n))
    got = plan.fwd(from_u64(x, "cpu"))
    # the JAX reference runs jitted (its eager dispatch is ~10x slower)
    want = np.asarray(jax.jit(jplan.fwd)(jnp.asarray(x)))
    np.testing.assert_array_equal(to_u64(got), want)

    d = rng.integers(-(1 << 29), 1 << 29, size=(2, 5, n), dtype=np.int64)
    got_d = plan.fwd_digits(from_u64(d.view(np.uint64), "cpu"))
    want_d = np.asarray(jax.jit(jplan.fwd_digits)(jnp.asarray(d)))
    np.testing.assert_array_equal(to_u64(got_d), want_d)

    res = np.stack([rng.integers(0, p, size=(3, n), dtype=np.uint64)
                    for p in plan.primes])
    got_i = plan.inv(from_u64(res, "cpu"))
    want_i = np.asarray(jax.jit(jplan.inv)(jnp.asarray(res)))
    np.testing.assert_array_equal(to_u64(got_i), want_i)

    got_r = plan.reconstruct_u64(got_i)
    want_r = np.asarray(jax.jit(jplan.reconstruct_u64)(jnp.asarray(want_i)))
    np.testing.assert_array_equal(to_u64(got_r), want_r)
    # the 4-prime transform is an exact invertible map on u64 polynomials
    if num_primes == 4:
        back = plan.reconstruct_u64(plan.inv(got))
        np.testing.assert_array_equal(to_u64(back), x)


def test_ntt_custom_prime_pair_matches_jax():
    rng = np.random.default_rng(28)
    x = _u64(rng, (2, 256))
    got = b2.FAST28.plan(256).fwd(from_u64(x, "cpu"))
    want = np.asarray(jax.jit(jb2.FAST28.plan(256).fwd)(jnp.asarray(x)))
    np.testing.assert_array_equal(to_u64(got), want)


@pytest.mark.parametrize("base_log,levels", [(23, 1), (3, 5), (5, 3),
                                             (10, 2), (7, 4)])
def test_decompose_matches_jax(base_log, levels):
    rng = np.random.default_rng(base_log * 10 + levels)
    x = np.concatenate([_u64(rng, 4000), np.array(
        [0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1, 1 << 41],
        dtype=np.uint64)])
    got = decomp.decompose(from_u64(x, "cpu"), base_log, levels)
    want = np.asarray(jdecomp.decompose(jnp.asarray(x), base_log, levels))
    np.testing.assert_array_equal(got.numpy(), want)
    got_c = decomp.closest_representable(from_u64(x, "cpu"), base_log, levels)
    want_c = np.asarray(jdecomp.closest_representable(jnp.asarray(x),
                                                      base_log, levels))
    np.testing.assert_array_equal(to_u64(got_c), want_c)


def test_recomposition_summand_matches_jax():
    v = np.array([0, 1, -1, 3, -64], dtype=np.int64)
    for level in (1, 3, 5):
        np.testing.assert_array_equal(
            decomp.recomposition_summand(v, level, 3),
            jdecomp.recomposition_summand(v, level, 3))


@pytest.mark.parametrize("n", [256, 2048])
def test_monomial_mul_div_match_jax(n):
    rng = np.random.default_rng(n)
    p = _u64(rng, (6, 2, n))
    deg = rng.integers(0, 2 * n, size=(6, 1), dtype=np.uint64)
    deg[0, 0], deg[1, 0], deg[2, 0] = 0, n, 2 * n - 1
    for port_fn, jax_fn in ((poly.monomial_mul, jpoly.monomial_mul),
                            (poly.monomial_div, jpoly.monomial_div)):
        got = port_fn(from_u64(p, "cpu"), from_u64(deg, "cpu"))
        want = np.asarray(jax_fn(jnp.asarray(p), jnp.asarray(deg)))
        np.testing.assert_array_equal(to_u64(got), want)
    # one shared polynomial, one degree per batch row
    got = poly.monomial_div(from_u64(p[0], "cpu"), from_u64(deg, "cpu"))
    want = np.asarray(jpoly.monomial_div(jnp.asarray(p[0]),
                                         jnp.asarray(deg)))
    np.testing.assert_array_equal(to_u64(got), want)


@pytest.mark.parametrize("native", [True, False])
def test_aes_ctr_bytes_match_jax(native):
    seed = 0x0123456789ABCDEF_FEDCBA9876543210
    g = csprng.AesCtrGenerator(seed)
    jg = jcsprng.AesCtrGenerator(seed)
    if not native:  # the numpy AES path of both packages
        g._key16 = None
        jg._key16 = None
    for n in (1, 15, 16, 17, 1000, 4096 + 3):
        np.testing.assert_array_equal(g.next_bytes(n), jg.next_bytes(n))
    kids = g.try_fork(3, 40)
    jkids = jg.try_fork(3, 40)
    for k, jk in zip(kids, jkids):
        np.testing.assert_array_equal(k.next_bytes(40), jk.next_bytes(40))
    np.testing.assert_array_equal(g.next_bytes(33), jg.next_bytes(33))


def test_samplers_match_jax():
    g = csprng.EncryptionRandomGenerator(11, 12)
    jg = jcsprng.EncryptionRandomGenerator(11, 12)
    np.testing.assert_array_equal(g.mask.uniform_u64(777),
                                  jg.mask.uniform_u64(777))
    np.testing.assert_array_equal(g.mask.uniform_binary(300),
                                  jg.mask.uniform_binary(300))
    np.testing.assert_array_equal(g.noise.gaussian_torus_u64(1001, 2.0 ** -25),
                                  jg.noise.gaussian_torus_u64(1001, 2.0 ** -25))
    np.testing.assert_array_equal(g.noise.t_uniform_torus_u64(500, 17),
                                  jg.noise.t_uniform_torus_u64(500, 17))
    from tfhe_tpu.utils.params import PARAM_TEST_TOY as JP

    from tfhe_tpu_torch.utils.params import PARAM_TEST_TOY as P

    np.testing.assert_array_equal(
        g.sample_noise(P.glwe_noise_distribution, 64),
        jg.sample_noise(JP.glwe_noise_distribution, 64))
