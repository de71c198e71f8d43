"""The port's exact CRT path in acc32 mode (TFHE_V4_ACC=32) and the stacked
v6 step (TFHE_V6_STACKED=1) against tfhe_tpu, on the same numpy inputs:

- the plain K2 (acc32) -> plain K3-acc32 pipeline against
  ``blind_rotate_pallas`` in interpret mode under TFHE_NTT_VARIANT=v4 and
  TFHE_V4_ACC=32 (the rounding Garner tail, P = 3 at the BOOLEAN_TEST_TOY
  geometry and P = 4 at 23 x 1), and against the acc_round32 oracle
  ``server.blind_rotate`` of both packages;
- ``programmable_bootstrap_crt`` under acc32 against
  ``programmable_bootstrap_pallas`` on the same toy boolean keys;
- every boolean gate at BOOLEAN_TEST_TOY under acc32 against its truth
  table;
- the stacked step: ``blind_rotate_pallas(bnf2=True)`` under
  TFHE_V6_STACKED=1 against the plain K2 acc32 -> plain K1, both flavors.

On the CPU the JAX package's boolean ServerKey never takes the rounded path
(``use_pallas_default()`` is False there), so the gates are held against
the Pallas kernel, which is what they run on a TPU. Tolerance: exact
(integer arithmetic)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tfhe_tpu.boolean.keys import ClientKey as JClientKey
from tfhe_tpu.boolean.keys import ServerKey as JServerKey
from tfhe_tpu.core import algorithms as jalgo
from tfhe_tpu.core.entities import LweBootstrapKey as JLweBootstrapKey
from tfhe_tpu.ops import bnf2 as jb2
from tfhe_tpu.ops import ntt as jntt
from tfhe_tpu.ops import pbs_kernel as jpk
from tfhe_tpu.ops import server as jserver
from tfhe_tpu.utils import params as jparams

from tfhe_tpu_torch import boolean
from tfhe_tpu_torch._torus import from_u32, from_u64, to_u64
from tfhe_tpu_torch.ops import bnf2 as b2
from tfhe_tpu_torch.ops import ntt
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.ops import server
from tfhe_tpu_torch.utils import params

N = 256
SEED = 5
LO32 = np.uint64(0xFFFFFFFF)


#: what blind_rotate_pallas reads from the environment when it is traced
_PALLAS_ENV = ("TFHE_NTT_VARIANT", "TFHE_V4_ACC", "TFHE_V6_STACKED",
               "TFHE_UNROLL", "TFHE_BATCH_TILE")
_PALLAS_STATIC = ("base_log", "levels", "plan", "batch_tile", "unroll",
                  "bnf2", "bnf2_flavor")
_JITTED = {}


@pytest.fixture
def acc32(monkeypatch):
    """TFHE_NTT_VARIANT=v4, TFHE_V4_ACC=32, and ``blind_rotate_pallas``
    under jax.jit: one jitted function per setting of the environment, kept
    for the module, so the cases of one geometry (the P = 3 rotation and
    both PBS cases) share one interpret-mode compile, which takes about
    13 s on a CPU, instead of one each."""
    monkeypatch.setenv("TFHE_NTT_VARIANT", "v4")
    monkeypatch.setenv("TFHE_V4_ACC", "32")
    raw = jpk.blind_rotate_pallas

    def jitted(*args, **kwargs):
        env = tuple(os.environ.get(k) for k in _PALLAS_ENV)
        if env not in _JITTED:
            _JITTED[env] = jax.jit(raw, static_argnames=_PALLAS_STATIC)
        return _JITTED[env](*args, **kwargs)

    monkeypatch.setattr(jpk, "blind_rotate_pallas", jitted)


def _plain_acc32(lut, mask, body, scan, base_log, levels):
    """plain K2 acc32 -> plain K3-acc32, back to u64 torus values."""
    hi = pk.body_rotate_acc32(from_u64(lut, "cpu"), from_u64(body, "cpu"))
    hi = pk.blind_rotate_crt_acc32(hi, from_u64(mask, "cpu"),
                                   from_u32(scan, "cpu"), base_log, levels)
    return to_u64(hi.to(torch.int64) << 32)


# (P, R, base_log, levels): the BOOLEAN_TEST_TOY geometry; 2_2's 23 x 1
@pytest.mark.parametrize("P,R,BL,L", [(3, 3, 10, 2), (4, 2, 23, 1)])
def test_plain_k3_acc32_matches_pallas_interpret(acc32, P, R, BL, L):
    rng = np.random.default_rng(P)
    # B = batch_tile = 4 and the default unroll; at P = 3 the toy's
    # lwe_dimension too: the shapes of the PBS test below, whose compile
    # this one makes
    B = 4
    n_steps = params.BOOLEAN_TEST_TOY.lwe_dimension if P == 3 else 2
    std = rng.integers(0, 1 << 64, size=(n_steps, L, R, R, N),
                       dtype=np.uint64)
    hat = np.asarray(jalgo.bootstrap_key_to_ntt(
        JLweBootstrapKey(std, BL, L), P).residues)
    scan = np.asarray(jpk.bsk_to_scan_layout(jnp.asarray(hat)))
    lut = rng.integers(0, 1 << 64, size=(B, R, N), dtype=np.uint64)
    mask = rng.integers(0, 2 * N, size=(B, n_steps), dtype=np.uint64)
    body = rng.integers(0, 2 * N, size=(B,), dtype=np.uint64)
    jplan = jntt.get_plan(N, P)
    want = np.asarray(jpk.blind_rotate_pallas(
        jnp.asarray(lut), jnp.asarray(mask), jnp.asarray(body),
        jnp.asarray(scan), BL, L, jplan, batch_tile=B))
    pk.reset_launches()
    got = _plain_acc32(lut, mask, body, scan, BL, L)
    np.testing.assert_array_equal(got, want)
    assert (got & LO32).max() == 0  # multiples of 2^32
    assert pk.blind_rotate_crt_acc32.launches == 0
    # the acc_round32 oracle of both packages
    oracle = np.asarray(jserver.blind_rotate(
        jnp.asarray(lut), jnp.asarray(mask), jnp.asarray(body),
        jnp.asarray(hat), BL, L, jplan, acc_round32=True))
    np.testing.assert_array_equal(got, oracle)
    spec = server.blind_rotate(from_u64(lut, "cpu"), from_u64(mask, "cpu"),
                               from_u64(body, "cpu"), from_u32(hat, "cpu"),
                               BL, L, ntt.get_plan(N, P), acc_round32=True)
    np.testing.assert_array_equal(to_u64(spec), oracle)


@pytest.fixture(scope="module")
def toy_keys():
    jck = JClientKey.generate(jparams.BOOLEAN_TEST_TOY, seed=SEED)
    jsk = JServerKey.generate(jck)
    ck = boolean.ClientKey.generate(params.BOOLEAN_TEST_TOY, seed=SEED,
                                    device="cpu")
    return jck, jsk, ck, boolean.ServerKey.generate(ck)


@pytest.mark.parametrize("centered_ms", [False, True])
def test_pbs_crt_acc32_matches_pallas_pbs(acc32, toy_keys, centered_ms):
    """programmable_bootstrap_crt (K2 acc32 -> K3-acc32, plain) ==
    programmable_bootstrap_pallas in interpret mode, on the toy boolean
    keys and ciphertexts of both packages."""
    jck, jsk, _, sk = toy_keys
    p = params.BOOLEAN_TEST_TOY
    ct = np.asarray(jck.encrypt(np.array([True, False, True, True])).ct)
    lut = sk._true_lut()
    want = np.asarray(jserver.programmable_bootstrap_pallas(
        jnp.asarray(ct), jnp.asarray(to_u64(lut)), jsk.bsk_scan,
        p.pbs_base_log, p.pbs_level, jntt.get_plan(N, sk.num_primes),
        centered_ms=centered_ms, batch_tile=4))
    pk.reset_launches()
    got = server.programmable_bootstrap_crt(
        from_u64(ct, "cpu"), lut, sk.bsk_scan, p.pbs_base_log, p.pbs_level,
        centered_ms=centered_ms)
    np.testing.assert_array_equal(to_u64(got), want)
    assert not any(fn.launches for fn in pk.KERNELS)
    # not the exact path's result: the rounding is in effect
    assert (to_u64(got) & LO32).max() == 0


GATES = {"and_": lambda a, b: a & b, "or_": lambda a, b: a | b,
         "nand": lambda a, b: ~(a & b), "nor": lambda a, b: ~(a | b),
         "xor": lambda a, b: a ^ b, "xnor": lambda a, b: ~(a ^ b)}


def test_boolean_gates_acc32_truth_tables(acc32, toy_keys):
    _, _, ck, sk = toy_keys
    a = np.array([False, False, True, True])
    b = np.array([False, True, False, True])
    c = np.array([True, False, False, True])
    l, r, cond = ck.encrypt(a), ck.encrypt(b), ck.encrypt(c)
    for name, f in GATES.items():
        out = getattr(sk, name)(l, r)
        np.testing.assert_array_equal(ck.decrypt(out), f(a, b), err_msg=name)
    np.testing.assert_array_equal(ck.decrypt(sk.not_(l)), ~a)
    np.testing.assert_array_equal(ck.decrypt(sk.mux(cond, l, r)),
                                  np.where(c, a, b))


def _stacked_case(flavor, jflavor, monkeypatch):
    """(JAX blind_rotate_pallas(bnf2=True) under TFHE_V6_STACKED=1, plain K2
    acc32 -> plain K1) on the _toy_inputs pattern of tests/test_bnf2.py."""
    monkeypatch.setenv("TFHE_V6_STACKED", "1")
    monkeypatch.delenv("TFHE_V4_ACC", raising=False)
    levels, R, blog, B, n_small = 1, 2, 23, 4, 3
    rng = np.random.default_rng(3)
    lut = rng.integers(0, 1 << 64, size=(B, R, N), dtype=np.uint64)
    mask = rng.integers(0, 2 * N, size=(B, n_small), dtype=np.uint64)
    body = rng.integers(0, 2 * N, size=(B,), dtype=np.uint64)
    std = rng.integers(0, 1 << 64, size=(n_small, levels, R, R, N),
                       dtype=np.uint64)
    bsk2 = np.asarray(jb2.bootstrap_key_to_bnf2(std, flavor=jflavor))
    run_jax = lambda fl: np.asarray(jpk.blind_rotate_pallas(
        jnp.asarray(lut), jnp.asarray(mask), jnp.asarray(body),
        jnp.asarray(bsk2), blog, levels, jflavor.plan(N), batch_tile=2,
        unroll=1, bnf2=True, bnf2_flavor=fl))
    hi = pk.body_rotate_acc32(from_u64(lut, "cpu"), from_u64(body, "cpu"))
    hi = pk.blind_rotate_bnf2_acc32(hi, from_u64(mask, "cpu"),
                                    from_u32(bsk2, "cpu"), blog, levels,
                                    flavor)
    return run_jax, to_u64(hi.to(torch.int64) << 32)


def test_stacked_step_equals_plain_k1(monkeypatch):
    """TFHE_V6_STACKED=1 selects the sublane-stacked TPU step, written for
    the DEFAULT pair (``bnf2_flavor=None``); it computes K1's function:
    blind_rotate_pallas(bnf2=True) == plain K2 acc32 -> plain K1, bit for
    bit."""
    run_jax, got = _stacked_case(b2.DEFAULT, jb2.DEFAULT, monkeypatch)
    np.testing.assert_array_equal(got, run_jax(None))


def test_stacked_step_fast28_runs_k1(monkeypatch):
    """With the FAST28 pair the JAX package has no stacked step (it asserts,
    ``pbs_kernel.py:1801``); the port runs K1 under TFHE_V6_STACKED=1, equal
    to the unstacked Pallas kernel of that pair."""
    run_jax, got = _stacked_case(b2.FAST28, jb2.FAST28, monkeypatch)
    with pytest.raises(AssertionError):
        run_jax(jb2.FAST28)
    monkeypatch.delenv("TFHE_V6_STACKED")
    np.testing.assert_array_equal(got, run_jax(jb2.FAST28))
