"""The port's server-side operations against tfhe_tpu.ops.server on the
same numpy inputs: KSK limb form, the int8-GEMM keyswitch, the centered and
standard modulus switches, sample extraction and the v6/v6b PBS on CPU
tensors (the kernels' plain versions). Tolerance: exact."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tfhe_tpu.ops import bnf2 as jb2
from tfhe_tpu.ops import server as jserver

from tfhe_tpu_torch._torus import from_u32, from_u64, to_u64
from tfhe_tpu_torch.ops import bnf2 as b2
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.ops import server

N_IN, LEVELS, BASE_LOG, N_OUT = 64, 5, 3, 16


@pytest.fixture(scope="module")
def ksk():
    rng = np.random.default_rng(99)
    return rng.integers(0, 1 << 64, size=(N_IN, LEVELS, N_OUT + 1),
                        dtype=np.uint64)


def test_ksk_to_i8_limbs_matches_jax(ksk):
    got = server.ksk_to_i8_limbs(ksk, BASE_LOG)
    np.testing.assert_array_equal(got, jserver.ksk_to_i8_limbs(ksk, BASE_LOG))
    assert got.shape == (N_IN * LEVELS, (N_OUT + 1) * 8)


@pytest.mark.parametrize("batch", [(1,), (5,), (17,), ()])
def test_keyswitch_matches_jax(ksk, batch):
    rng = np.random.default_rng(len(batch) and batch[0])
    ct = rng.integers(0, 1 << 64, size=batch + (N_IN + 1,), dtype=np.uint64)
    limbs = server.ksk_to_i8_limbs(ksk, BASE_LOG)
    got = server.keyswitch_mxu(from_u64(ct, "cpu"),
                               torch.from_numpy(limbs),
                               BASE_LOG, LEVELS)
    want = np.asarray(jserver.keyswitch_mxu(
        jnp.asarray(ct), jnp.asarray(limbs), BASE_LOG, LEVELS))
    np.testing.assert_array_equal(to_u64(got), want)
    # and the decompose-MAC definition (lwe_keyswitch.rs) it replaces
    np.testing.assert_array_equal(want, np.asarray(jserver.keyswitch(
        jnp.asarray(ct), jnp.asarray(ksk), BASE_LOG, LEVELS)))


@pytest.mark.parametrize("log_modulus", [9, 12])
def test_modulus_switches_match_jax(log_modulus):
    rng = np.random.default_rng(log_modulus)
    ct = rng.integers(0, 1 << 64, size=(7, 33), dtype=np.uint64)
    ct[0, :4] = [0, (1 << 64) - 1, 1 << 63, (1 << 63) - 1]
    t = from_u64(ct, "cpu")
    for port_fn, jax_fn in (
            (server.lwe_centered_binary_modulus_switch,
             jserver.lwe_centered_binary_modulus_switch),
            (server.lwe_standard_modulus_switch,
             jserver.lwe_standard_modulus_switch)):
        gm, gb = port_fn(t, log_modulus)
        wm, wb = jax_fn(jnp.asarray(ct), log_modulus)
        np.testing.assert_array_equal(to_u64(gm), np.asarray(wm))
        np.testing.assert_array_equal(to_u64(gb), np.asarray(wb))
    np.testing.assert_array_equal(
        to_u64(server.centered_binary_ms_body_correction(t, log_modulus)),
        np.asarray(jserver.centered_binary_ms_body_correction(
            jnp.asarray(ct), log_modulus)))


@pytest.mark.parametrize("k,n", [(1, 256), (4, 512)])
def test_sample_extract_matches_jax(k, n):
    rng = np.random.default_rng(k)
    glwe = rng.integers(0, 1 << 64, size=(3, k + 1, n), dtype=np.uint64)
    for nth in (0, 1, 100, n - 1):
        got = server.sample_extract(from_u64(glwe, "cpu"), nth)
        want = np.asarray(jserver.sample_extract(jnp.asarray(glwe), nth))
        np.testing.assert_array_equal(to_u64(got), want)


@pytest.mark.parametrize("flavor", ["DEFAULT", "FAST28"])
@pytest.mark.parametrize("centered", [True, False])
def test_programmable_bootstrap_bnf2_matches_jax(flavor, centered,
                                                 monkeypatch):
    monkeypatch.delenv("TFHE_V4_ACC", raising=False)
    fl, jfl = {"DEFAULT": (b2.DEFAULT, jb2.DEFAULT),
               "FAST28": (b2.FAST28, jb2.FAST28)}[flavor]
    rng = np.random.default_rng(3 + centered)
    n_small, R, N = 8, 2, 256
    ct = rng.integers(0, 1 << 64, size=(5, n_small + 1), dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, size=(R, N), dtype=np.uint64)
    std = rng.integers(0, 1 << 64, size=(n_small, 1, R, R, N),
                       dtype=np.uint64)
    bsk2 = np.asarray(jb2.bootstrap_key_to_bnf2(std, flavor=jfl))
    jfn = jax.jit(functools.partial(
        jserver.programmable_bootstrap_bnf2, base_log=23, levels=1,
        centered_ms=centered, use_pallas=False, flavor=jfl))
    want = np.asarray(jfn(jnp.asarray(ct), jnp.asarray(lut),
                          jnp.asarray(bsk2)))
    pk.reset_launches()
    got = server.programmable_bootstrap_bnf2(
        from_u64(ct, "cpu"), from_u64(lut, "cpu"), from_u32(bsk2, "cpu"),
        23, 1, centered_ms=centered, flavor=fl)
    np.testing.assert_array_equal(to_u64(got), want)
    assert pk.body_rotate_acc32.launches == 0
    assert pk.blind_rotate_bnf2_acc32.launches == 0


def test_two_plane_accumulator_is_not_substituted(monkeypatch):
    """TFHE_V4_ACC=64 runs the two-plane accumulator (K2 u64, K3 with the
    BNF2 tail), not the acc32 kernels: bit-equal to the JAX package's
    two-plane oracle (the shipped FAST28 pair), and different from the
    acc32 result."""
    monkeypatch.setenv("TFHE_V4_ACC", "64")
    fl, jfl = b2.FAST28, jb2.FAST28
    rng = np.random.default_rng(8)
    n_small, R, N = 8, 2, 256
    ct = rng.integers(0, 1 << 64, size=(5, n_small + 1), dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, size=(R, N), dtype=np.uint64)
    std = rng.integers(0, 1 << 64, size=(n_small, 1, R, R, N),
                       dtype=np.uint64)
    bsk2 = np.asarray(jb2.bootstrap_key_to_bnf2(std, flavor=jfl))
    jfn = jax.jit(functools.partial(
        jserver.programmable_bootstrap_bnf2, base_log=23, levels=1,
        use_pallas=False, flavor=jfl))
    want = np.asarray(jfn(jnp.asarray(ct), jnp.asarray(lut),
                          jnp.asarray(bsk2)))
    args = (from_u64(ct, "cpu"), from_u64(lut, "cpu"), from_u32(bsk2, "cpu"),
            23, 1)
    got = server.programmable_bootstrap_bnf2(*args, flavor=fl)
    np.testing.assert_array_equal(to_u64(got), want)
    monkeypatch.setenv("TFHE_V4_ACC", "32")
    acc32 = server.programmable_bootstrap_bnf2(*args, flavor=fl)
    assert not np.array_equal(to_u64(acc32), want)
