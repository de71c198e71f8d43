"""The port's multi-bit PBS core against ``tfhe_tpu`` on the CPU, exactly:
the multi-bit bootstrap key's bytes (``gen_multi_bit_bootstrap_key``) and
its transform, the trivial GGSW of 1, ``multi_bit_blind_rotate`` on seeded
LUTs, masks and bodies, and K5's plain version (the wrapper on CPU
tensors) on the same inputs, at ``PARAM_TEST_TOY_MULTI_BIT`` (g = 2) and at
g = 3 (n = 18) and g = 4 (n = 16) built with ``dataclasses.replace``. Also
the host side of K5: its key layout, the transform's points it evaluates
the coefficients at, and G1's constants. Tolerance: exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfhe_tpu.core import algorithms as jalgo
from tfhe_tpu.ops import ntt as jntt
from tfhe_tpu.ops import server as jserver
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.utils import params as jparams

from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch._torus import from_u64, i64_to_u32, to_u64
from tfhe_tpu_torch.core import algorithms as algo
from tfhe_tpu_torch.ops import ntt as ntt_mod
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.ops import server
from tfhe_tpu_torch.ops.polynomial import monomial_mul
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.utils import params as pm

SEED = 21  # tests/test_multibit.py's key seed
#: grouping -> the LWE dimension of its toy set (divisible by g)
TOY_N = {2: 16, 3: 18, 4: 16}


def toy_set(pmod, g):
    """``PARAM_TEST_TOY_MULTI_BIT`` of a params module (the port's or
    tfhe_tpu's) at grouping g."""
    base = pmod.PARAM_TEST_TOY_MULTI_BIT
    if g == 2:
        return base
    return dataclasses.replace(base, grouping_factor=g, lwe_dimension=TOY_N[g],
                               name=f"PARAM_TEST_TOY_MULTI_BIT_G{g}")


def multi_bit_keys(g):
    """The multi-bit bootstrap key of both packages from one client-key
    seed: (JAX LweBootstrapKey, port LweBootstrapKey)."""
    jp, p = toy_set(jparams, g), toy_set(pm, g)
    jck = JClientKey.generate(jp, seed=SEED)
    ck = ClientKey.generate(p, seed=SEED, device="cpu")
    jb = jalgo.gen_multi_bit_bootstrap_key(
        jck.lwe_sk, jck.glwe_sk, jp.pbs_base_log, jp.pbs_level, g,
        jp.glwe_noise_distribution, jck._keygen_gen)
    b = algo.gen_multi_bit_bootstrap_key(
        ck.lwe_sk, ck.glwe_sk, p.pbs_base_log, p.pbs_level, g,
        p.glwe_noise_distribution, ck._keygen_gen)
    return jb, b


@pytest.fixture(scope="module")
def keys():
    return {g: multi_bit_keys(g) for g in (2, 3, 4)}


@pytest.mark.parametrize("g", [2, 3, 4])
def test_multi_bit_key_bytes_equal(keys, g):
    """The GGSWs of every nonempty subset product, drawn from the same
    stream: byte-equal, [n/g, 2^g-1, l, k+1, k+1, N]; their 4-prime
    transform (residues and Shoup duals) equal too."""
    jb, b = keys[g]
    n = TOY_N[g]
    assert tuple(b.data.shape) == (n // g, (1 << g) - 1, 1, 2, 2, 256)
    np.testing.assert_array_equal(to_u64(b.data), np.asarray(jb.data))
    jh = jalgo.bootstrap_key_to_ntt(jb, 4)
    h = algo.bootstrap_key_to_ntt(b, 4)
    np.testing.assert_array_equal(h.residues.numpy().view(np.uint32),
                                  np.asarray(jh.residues))


def test_multi_bit_key_refuses_a_partial_group():
    ck = ClientKey.generate(pm.PARAM_TEST_TOY, seed=SEED, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        algo.gen_multi_bit_bootstrap_key(
            ck.lwe_sk, ck.glwe_sk, 23, 1, 3, pm.PARAM_TEST_TOY
            .glwe_noise_distribution, ck._keygen_gen)


@pytest.mark.parametrize("shape", [(256, 4, 23, 1, 2), (512, 3, 17, 1, 4),
                                   (256, 4, 14, 2, 2)])
def test_trivial_ggsw_one_hat_equal(shape):
    np.testing.assert_array_equal(server._trivial_ggsw_one_hat(*shape),
                                  jserver._trivial_ggsw_one_hat(*shape))


def rotation_inputs(g, B=3):
    rng = np.random.default_rng(SEED + g)
    n, N = TOY_N[g], 256
    lut = rng.integers(0, 1 << 64, size=(B, 2, N), dtype=np.uint64)
    mask = rng.integers(0, 2 * N, size=(B, n))
    body = rng.integers(0, 2 * N, size=(B,))
    return lut, mask, body


@pytest.mark.parametrize("g", [2, 3, 4])
def test_multi_bit_blind_rotate_equal(keys, g):
    """``multi_bit_blind_rotate`` on seeded LUTs, masks and bodies, and K5's
    plain version after the plain K2 u64 body rotation on the same inputs,
    equal to the JAX function."""
    jb, b = keys[g]
    jh = jalgo.bootstrap_key_to_ntt(jb, 4)
    h = algo.bootstrap_key_to_ntt(b, 4)
    lut, mask, body = rotation_inputs(g)
    want = np.asarray(jserver.multi_bit_blind_rotate(
        jnp.asarray(lut), jnp.asarray(mask), jnp.asarray(body),
        jh.residues[0], 23, 1, g, jntt.get_plan(256, 4)))
    got = server.multi_bit_blind_rotate(
        from_u64(lut, "cpu"), torch.from_numpy(mask), torch.from_numpy(body),
        h.residues[0], 23, 1, g, ntt_mod.get_plan(256, 4))
    np.testing.assert_array_equal(to_u64(got), want)
    pk.reset_launches()
    acc = pk.body_rotate_u64(from_u64(lut, "cpu"), torch.from_numpy(body))
    k5 = pk.blind_rotate_multi_bit(acc, torch.from_numpy(mask),
                                   pk.multi_bit_key_layout(h.residues), 23, 1)
    np.testing.assert_array_equal(to_u64(k5), want)
    assert not any(fn.launches for fn in pk.KERNELS)


def test_multi_bit_programmable_bootstrap_equal(keys):
    """The torch spec's whole PBS (standard switch, rotation, extraction)
    and the kernels' path on CPU tensors equal the JAX PBS."""
    jb, b = keys[2]
    jh = jalgo.bootstrap_key_to_ntt(jb, 4)
    h = algo.bootstrap_key_to_ntt(b, 4)
    rng = np.random.default_rng(SEED)
    ct = rng.integers(0, 1 << 64, size=(4, 17), dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, size=(2, 256), dtype=np.uint64)
    want = np.asarray(jserver.multi_bit_programmable_bootstrap(
        jnp.asarray(ct), jnp.asarray(lut), jh.residues[0], 23, 1, 2,
        jntt.get_plan(256, 4), extract_nth=3))
    got = server.multi_bit_programmable_bootstrap(
        from_u64(ct, "cpu"), from_u64(lut, "cpu"), h.residues[0], 23, 1, 2,
        ntt_mod.get_plan(256, 4), extract_nth=3)
    np.testing.assert_array_equal(to_u64(got), want)
    path = server.programmable_bootstrap_multi_bit(
        from_u64(ct, "cpu"), from_u64(lut, "cpu"),
        pk.multi_bit_key_layout(h.residues), 23, 1, extract_nth=3)
    np.testing.assert_array_equal(to_u64(path), want)


def test_key_layout_round_trip():
    rng = np.random.default_rng(3)
    res = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31,
                                        size=(2, 4, 5, 7, 2, 2, 2, 32),
                                        dtype=np.int32))
    mbk = pk.multi_bit_key_layout(res)
    assert tuple(mbk.shape) == (5, 2, 4, 7, 4, 2, 32) and mbk.is_contiguous()
    assert pk.multi_bit_grouping(mbk) == 3
    assert torch.equal(pk.multi_bit_legacy_layout(mbk, 2), res)


@pytest.mark.parametrize("N", [64, 2048])
def test_closed_form_coefficients(N):
    """K5 evaluates NTT(X^a - 1) at point t as psi^(e_t a) - 1 from the
    twist table (psi^(k+N) = -psi^k): equal to the plan's transform of the
    monomial for every prime and a spread of a in [0, 2N)."""
    plan = ntt_mod.get_plan(N, 4)
    e = pk.multi_bit_exponents(plan).astype(np.int64)
    delta = torch.zeros(N, dtype=torch.int64)
    delta[0] = 1
    for a in (0, 1, 3, N - 1, N, N + 5, 2 * N - 1):
        want = plan.fwd_digits(monomial_mul(delta, torch.tensor(a))
                               - delta).numpy()
        k = (e * a) % (2 * N)
        for pi, p in enumerate(plan.primes):
            tw = plan.twist[pi].astype(np.int64)
            z = np.where(k >= N, p - tw[k % N], tw[k % N])
            np.testing.assert_array_equal(z - 1, want[pi])


def test_g1_constants():
    """G1's transform is diagonal and one constant a level: K5 reads it as
    (2^(64 - base_log (l - lev)) mod p) and its dual; the Barrett constants
    are floor(2^64 / p)."""
    plan = ntt_mod.get_plan(256, 4)
    g1, g1_sh, mu = pk.multi_bit_constants(plan, 14, 2, 2)
    for pi, p in enumerate(plan.primes):
        for lev in range(2):
            want = (1 << (64 - 14 * (2 - lev))) % p
            assert int(g1[pi, lev]) == want
            assert int(g1_sh[pi, lev]) == (want << 32) // p
        assert int(mu[pi]) == (1 << 64) // p
    assert not g1[4:].any() and not g1[:, 2:].any()
    with pytest.raises(ValueError, match="levels"):
        pk.multi_bit_constants(plan, 3, 9, 2)


def test_wrapper_refuses_other_devices():
    """Given no CPU tensor the wrapper launches K5 or raises; here, with no
    card, an unsupported device raises before any launch."""
    acc = torch.zeros((1, 2, 64), dtype=torch.int64, device="meta")
    mask = torch.zeros((1, 4), dtype=torch.int64)
    mbk = i64_to_u32(torch.zeros((2, 2, 4, 3, 2, 2, 64), dtype=torch.int64))
    with pytest.raises(ValueError, match="unsupported device"):
        pk.blind_rotate_multi_bit(acc, mask, mbk, 23, 1)
