"""The port's v5 Goldilocks path against tfhe_tpu, on the same numpy inputs:

- the field ops against Python ints (values >= p and >= 2^63 included);
- ``torus_to_field`` (ties included) and ``field_to_torus``, the plan's psi,
  tables and permutations, and ``bootstrap_key_to_goldilocks`` against
  ``tfhe_tpu.ops.goldilocks``;
- the plain K2 (u64) -> plain K4 pipeline against the jnp oracle
  ``blind_rotate_goldilocks`` and against ``blind_rotate_goldilocks_pallas``
  in interpret mode (``batch_tile=2``, as tests/test_pbs_kernel_g.py runs
  it); K4's key order against the DIF transform;
- ``programmable_bootstrap_goldilocks`` for both modulus switches;
- the shortint v5 variant at PARAM_TEST_TOY: ``resolve_variant`` against the
  JAX one, ``apply_lookup_table`` bit-equal to tfhe_tpu's, and
  ``convert.server_key_from_arrays``' key byte-equal to ``bsk_scan_g``.

Tolerance: exact (integer arithmetic). Toy sizes: N = 256, n <= 16."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfhe_tpu.ops import goldilocks as jgl
from tfhe_tpu.ops import pbs_kernel_g as jkg
from tfhe_tpu.ops import server as jserver
from tfhe_tpu.shortint import server_key as jsk_mod
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils import params as jparams

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import from_u32, from_u64, to_u32, to_u64
from tfhe_tpu_torch.ops import goldilocks as gl
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.ops import server
from tfhe_tpu_torch.shortint import server_key as sk_mod
from tfhe_tpu_torch.shortint.ciphertext import ShortintCiphertext
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.server_key import ServerKey
from tfhe_tpu_torch.utils import params as pm

P = gl.P
EDGE = [0, 1, 2, P - 1, P, P + 1, (1 << 64) - 1, (1 << 64) - 2,
        (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63, (1 << 63) + 1,
        (1 << 64) - (1 << 32)]
N, R, BL, L = 256, 2, 23, 1


def _cpu64(a):
    return from_u64(a, "cpu")


def _values(rng, k=600):
    return np.concatenate([rng.integers(0, 1 << 64, size=k, dtype=np.uint64),
                           np.array(EDGE, dtype=np.uint64)])


def test_field_ops_match_python_ints():
    rng = np.random.default_rng(1)
    raw_a, raw_b = _values(rng), _values(rng)[::-1].copy()
    a, b = raw_a % np.uint64(P), raw_b % np.uint64(P)
    got = {name: to_u64(fn(_cpu64(a), _cpu64(b))) for name, fn in
           (("mul", gl.gmul), ("add", gl.gadd), ("sub", gl.gsub))}
    canon = to_u64(gl.gcanon(_cpu64(raw_a)))
    for i in range(len(a)):
        x, y = int(a[i]), int(b[i])
        assert int(got["mul"][i]) == x * y % P, (x, y)
        assert int(got["add"][i]) == (x + y) % P, (x, y)
        assert int(got["sub"][i]) == (x - y) % P, (x, y)
        assert int(canon[i]) == int(raw_a[i]) % P
    digits = np.arange(-(1 << 22), (1 << 22) + 1, 4099, dtype=np.int64)
    np.testing.assert_array_equal(
        to_u64(gl.signed_to_field(_cpu64(digits.view(np.uint64)))),
        np.asarray(jgl.signed_to_field(jnp.asarray(digits))))


def test_torus_field_maps_match_jax():
    rng = np.random.default_rng(2)
    # b * EPS == 2^63 (mod 2^64): b * P / 2^64 lies exactly half-way
    tie = (1 << 63) * pow(gl.EPS, -1, 1 << 64) % (1 << 64)
    b = np.concatenate([_values(rng), np.array(
        [tie - 1, tie, tie + 1], dtype=np.uint64)])
    np.testing.assert_array_equal(
        to_u64(gl.torus_to_field(_cpu64(b))),
        np.asarray(jgl.torus_to_field(jnp.asarray(b))))
    x = b % np.uint64(P)
    np.testing.assert_array_equal(
        to_u64(gl.field_to_torus(_cpu64(x))),
        np.asarray(jgl.field_to_torus(jnp.asarray(x))))
    # the tie rounds half up (the smaller r of b - r)
    got = gl.torus_to_field(_cpu64(np.array([tie], np.uint64)))
    assert int(to_u64(got)[0]) == (tie * P + (1 << 63)) >> 64


@pytest.mark.parametrize("n", [256, 512, 2048])
def test_plan_matches_jax(n):
    plan, jplan = gl.get_plan_g(n), jgl.get_plan_g(n)
    assert (plan.psi, plan.omega, plan.G) == (jplan.psi, jplan.omega, jplan.G)
    for name in ("twist", "untwist", "perm_to_kernel", "perm_from_kernel"):
        np.testing.assert_array_equal(getattr(plan, name),
                                      getattr(jplan, name))
    for ours, theirs in ((plan.tw_fwd, jplan.tw_fwd),
                         (plan.tw_inv, jplan.tw_inv)):
        assert len(ours) == len(theirs) == plan.log_n
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    t = pk.goldilocks_tables(plan)  # K4's layout of the same tables
    assert t.shape == (4, n)
    np.testing.assert_array_equal(t[1], plan.untwist)
    np.testing.assert_array_equal(t[2, n // 2: n // 2 + n // 4], plan.tw_fwd[1])
    np.testing.assert_array_equal(t[3, n - 2: n - 1], plan.tw_inv[-1])


def _key(rng, n_steps, levels=L, R_=R, n=N):
    std = rng.integers(0, 1 << 64, size=(n_steps, levels, R_, R_, n),
                       dtype=np.uint64)
    return std, np.asarray(jgl.bootstrap_key_to_goldilocks(std))


def test_bootstrap_key_to_goldilocks_byte_equal():
    rng = np.random.default_rng(3)
    std, want = _key(rng, 3, levels=2)
    got = gl.bootstrap_key_to_goldilocks(_cpu64(std))
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(to_u32(got), want)
    # K4's key: the same values in the DIF order of fwd_ntt
    plan = gl.get_plan_g(N)
    dif = gl.fwd_ntt(gl.torus_to_field(_cpu64(std)), plan)
    np.testing.assert_array_equal(
        to_u64(pk.goldilocks_kernel_key(got)),
        to_u64(dif.reshape(3, 2 * R, R, N)))


def _rotation_inputs(rng, B, n_steps, R_=R, n=N):
    lut = rng.integers(0, 1 << 64, size=(B, R_, n), dtype=np.uint64)
    mask = rng.integers(0, 2 * n, size=(B, n_steps), dtype=np.uint64)
    body = rng.integers(0, 2 * n, size=(B,), dtype=np.uint64)
    return lut, mask, body


def test_plain_k4_matches_oracle_and_pallas_interpret():
    """plain K2 (u64) then plain K4 == the jnp oracle == the v5 Pallas
    kernel in interpret mode, bit for bit, on random data."""
    rng = np.random.default_rng(4)
    B, n_steps = 4, 4
    _, bsk_g = _key(rng, n_steps)
    lut, mask, body = _rotation_inputs(rng, B, n_steps)
    args = (jnp.asarray(lut), jnp.asarray(mask), jnp.asarray(body),
            jnp.asarray(bsk_g), BL, L)
    oracle = np.asarray(jgl.blind_rotate_goldilocks(*args))
    pallas = np.asarray(jkg.blind_rotate_goldilocks_pallas(
        *args, batch_tile=2, unroll=1))
    np.testing.assert_array_equal(pallas, oracle)
    pk.reset_launches()
    acc = pk.body_rotate_u64(_cpu64(lut), _cpu64(body))
    g = from_u32(bsk_g, "cpu")
    got = pk.blind_rotate_goldilocks(acc, _cpu64(mask), g, BL, L,
                                     pk.goldilocks_kernel_key(g))
    np.testing.assert_array_equal(to_u64(got), oracle)
    np.testing.assert_array_equal(
        to_u64(gl.blind_rotate_goldilocks(_cpu64(lut), _cpu64(mask),
                                          _cpu64(body),
                                          from_u32(bsk_g, "cpu"), BL, L)),
        oracle)
    assert pk.blind_rotate_goldilocks.launches == 0
    assert pk.body_rotate_u64.launches == 0


@pytest.mark.parametrize("centered", [True, False])
def test_programmable_bootstrap_goldilocks_matches_jax(centered):
    rng = np.random.default_rng(5 + centered)
    B, n_steps, levels = 3, 5, 2
    _, bsk_g = _key(rng, n_steps, levels=levels)
    ct = rng.integers(0, 1 << 64, size=(B, n_steps + 1), dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, size=(R, N), dtype=np.uint64)
    want = np.asarray(jserver.programmable_bootstrap_goldilocks(
        jnp.asarray(ct), jnp.asarray(lut), jnp.asarray(bsk_g), 10, levels,
        centered_ms=centered, use_pallas=False))
    g = from_u32(bsk_g, "cpu")
    got = server.programmable_bootstrap_goldilocks(
        _cpu64(ct), _cpu64(lut), g, 10, levels, centered_ms=centered,
        bsk_k=pk.goldilocks_kernel_key(g))
    assert tuple(got.shape) == (B, N + 1)
    np.testing.assert_array_equal(to_u64(got), want)


# ---------------------------------------------------------------------------
# the shortint v5 variant
# ---------------------------------------------------------------------------

_SETS = ("PARAM_MESSAGE_2_CARRY_2_KS_PBS", "PARAM_MESSAGE_1_CARRY_1_KS_PBS",
         "PARAM_TEST_TOY")


@pytest.mark.parametrize("case", [(256, 23, 1), (2048, 23, 1), (512, 10, 2),
                                  (128, 23, 1), (2048, 16, 2), *_SETS])
def test_resolve_variant_matches_jax(case, monkeypatch):
    """Under TFHE_NTT_VARIANT=v5 both packages answer alike, with and
    without a parameter set: v5 only for a shape in the kernel envelope
    whose noise gate passes, crt otherwise."""
    monkeypatch.setenv("TFHE_NTT_VARIANT", "v5")
    name = case if isinstance(case, str) else "PARAM_TEST_TOY"
    p, jp = pm.PARAMS_BY_NAME[name], getattr(jparams, name)
    shape = ((p.polynomial_size, p.pbs_base_log, p.pbs_level)
             if isinstance(case, str) else case)
    for ours, theirs in ((None, None), (p, jp)):
        want = jsk_mod.resolve_variant(*shape, params=theirs)
        assert sk_mod.resolve_variant(*shape, params=ours) == want
    if isinstance(case, str):
        assert want == "v5"  # the three sets take v5 when asked
    elif not jkg.eligible(*case):
        assert want == "crt"


SEED = 515151


def test_shortint_v5_bit_equal(monkeypatch):
    monkeypatch.setenv("TFHE_NTT_VARIANT", "v5")
    p, jp = pm.PARAM_TEST_TOY, jparams.PARAM_TEST_TOY
    jck = JClientKey.generate(jp, seed=SEED)
    jsk = JServerKey.generate(jck)
    ck = ClientKey.generate(p, seed=SEED, device="cpu")
    sk = ServerKey.generate(ck)
    assert sk.ntt_variant == jsk.ntt_variant == "v5"
    assert sk.bsk_b is None and sk.bsk_scan is None and sk.num_primes == 1
    np.testing.assert_array_equal(to_u32(sk.bsk_g), np.asarray(jsk.bsk_scan_g))
    mm = p.message_modulus
    f = lambda x: (x * x + 1) % mm
    vals = np.arange(p.message_modulus * p.carry_modulus, dtype=np.uint64)
    jct = jck.encrypt(vals)
    jout = jsk.apply_lookup_table(jct, jsk.generate_lookup_table(f))
    ct = ShortintCiphertext(ct=from_u64(np.asarray(jct.ct), "cpu"),
                            degree=jct.degree, noise_level=jct.noise_level,
                            message_modulus=jct.message_modulus,
                            carry_modulus=jct.carry_modulus)
    pk.reset_launches()
    out = sk.apply_lookup_table(ct, sk.generate_lookup_table(f))
    np.testing.assert_array_equal(to_u64(out.ct), np.asarray(jout.ct))
    np.testing.assert_array_equal(
        ck.decrypt_message_and_carry(out),
        np.array([f(int(v)) for v in vals], dtype=np.uint64))
    assert pk.blind_rotate_goldilocks.launches == 0


def test_convert_server_key_v5_matches_bsk_scan_g(monkeypatch):
    """A key carried over from tfhe_tpu's stored CRT arrays derives the
    same v5 key as tfhe_tpu's ``bsk_scan_g``, byte for byte."""
    monkeypatch.setenv("TFHE_NTT_VARIANT", "v5")
    jp = jparams.PARAM_TEST_TOY
    jck = JClientKey.generate(jp, seed=SEED + 1)
    jsk = JServerKey.generate(jck)
    sk = convert.server_key_from_arrays(
        jp.name, np.asarray(jsk.ksk), np.asarray(jsk.bsk_scan),
        jsk.num_primes, device="cpu")
    assert sk.variant == "v5"
    np.testing.assert_array_equal(to_u32(sk.bsk_g), np.asarray(jsk.bsk_scan_g))
    np.testing.assert_array_equal(
        to_u64(sk.bsk_g_k), to_u64(pk.goldilocks_kernel_key(sk.bsk_g)))
