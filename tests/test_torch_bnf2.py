"""The port's BNF2 spec and the plain versions of its two kernels against
tfhe_tpu, on the same numpy inputs:

- the scalar maps and bootstrap_key_to_bnf2, DEFAULT and FAST28 flavors;
- blind_rotate_bnf2 in both accumulator modes against the JAX oracle;
- the plain K2 -> K1 pipeline against ``blind_rotate_pallas(bnf2=True)``
  and the plain K2 against ``_build_body_rot_fn_v4(acc32=True)``, both run
  in Pallas interpret mode as tests/test_bnf2.py runs them.

Tolerance: exact (integer arithmetic)."""

import numpy as np
import pytest

import jax.numpy as jnp

from tfhe_tpu.ops import bnf2 as jb2
from tfhe_tpu.ops import pbs_kernel as jpk

from tfhe_tpu_torch._torus import from_u32, from_u64, to_u32, to_u64
from tfhe_tpu_torch.ops import bnf2 as b2
from tfhe_tpu_torch.ops import pbs_kernel as pk

FLAVORS = {"DEFAULT": (b2.DEFAULT, jb2.DEFAULT),
           "FAST28": (b2.FAST28, jb2.FAST28)}


def test_flavor_constants_match_jax():
    for fl, jfl in FLAVORS.values():
        for attr in ("p0", "p1", "qp", "s1", "s2", "inv01", "inv01_sh",
                     "g_const", "g1", "g0", "c1t", "t32_bias"):
            assert getattr(fl, attr) == getattr(jfl, attr), attr


@pytest.mark.parametrize("name", sorted(FLAVORS))
def test_scalar_maps_match_jax(name):
    fl, jfl = FLAVORS[name]
    rng = np.random.default_rng(7)
    b = np.concatenate([
        rng.integers(0, 1 << 64, 3000, dtype=np.uint64),
        np.array([0, 1, (1 << 32) - 1, 1 << 32, 1 << 63, (1 << 64) - 1,
                  fl.qp - 1, fl.qp, fl.qp + 1], dtype=np.uint64)])
    np.testing.assert_array_equal(
        to_u64(b2.torus_to_qp(from_u64(b, "cpu"), fl)),
        np.asarray(jb2.torus_to_qp(jnp.asarray(b), jfl)))
    x = np.concatenate([rng.integers(0, fl.qp, 3000, dtype=np.uint64),
                        np.array([0, 1, fl.qp - 1], dtype=np.uint64)])
    r0, r1 = x % np.uint64(fl.p0), x % np.uint64(fl.p1)
    np.testing.assert_array_equal(
        to_u64(b2.crt2_merge(from_u64(r0, "cpu"), from_u64(r1, "cpu"), fl)),
        np.asarray(jb2.crt2_merge(jnp.asarray(r0), jnp.asarray(r1), jfl)))
    np.testing.assert_array_equal(
        to_u64(b2.qp_to_torus32(from_u64(r0, "cpu"), from_u64(r1, "cpu"),
                                fl)),
        np.asarray(jb2.qp_to_torus32(jnp.asarray(r0), jnp.asarray(r1), jfl)))
    np.testing.assert_array_equal(
        to_u64(b2.qp_to_torus(from_u64(x, "cpu"), fl)),
        np.asarray(jb2.qp_to_torus(jnp.asarray(x), jfl)))


@pytest.mark.parametrize("name", sorted(FLAVORS))
def test_bootstrap_key_to_bnf2_matches_jax(name):
    fl, jfl = FLAVORS[name]
    rng = np.random.default_rng(5)
    std = rng.integers(0, 1 << 64, size=(3, 1, 2, 2, 256), dtype=np.uint64)
    got = b2.bootstrap_key_to_bnf2(from_u64(std, "cpu"), fl)
    assert got.dtype.is_floating_point is False and got.is_contiguous()
    np.testing.assert_array_equal(
        to_u32(got), np.asarray(jb2.bootstrap_key_to_bnf2(std, flavor=jfl)))


def _toy_inputs(flavor, batch=4, n_small=8, seed=3, p_n=256, R=2):
    """The shapes of tests/test_bnf2.py::_toy_inputs."""
    levels, blog = 1, 23
    r = np.random.default_rng(seed)
    lut = r.integers(0, 1 << 64, size=(batch, R, p_n), dtype=np.uint64)
    mask = r.integers(0, 2 * p_n, size=(batch, n_small), dtype=np.uint64)
    body = r.integers(0, 2 * p_n, size=(batch,), dtype=np.uint64)
    std = r.integers(0, 1 << 64, size=(n_small, levels, R, R, p_n),
                     dtype=np.uint64)
    bsk2 = np.asarray(jb2.bootstrap_key_to_bnf2(std, flavor=flavor))
    return lut, mask, body, bsk2, blog, levels


@pytest.mark.parametrize("name", sorted(FLAVORS))
@pytest.mark.parametrize("acc32", [False, True])
def test_blind_rotate_bnf2_matches_jax_oracle(name, acc32):
    fl, jfl = FLAVORS[name]
    lut, mask, body, bsk2, blog, levels = _toy_inputs(jfl, seed=11)
    want = np.asarray(jb2.blind_rotate_bnf2(
        jnp.asarray(lut), jnp.asarray(mask), jnp.asarray(body),
        jnp.asarray(bsk2), blog, levels, acc_round32=acc32, flavor=jfl))
    got = b2.blind_rotate_bnf2(
        from_u64(lut, "cpu"), from_u64(mask, "cpu"), from_u64(body, "cpu"),
        from_u32(bsk2, "cpu"), blog, levels, acc_round32=acc32, flavor=fl)
    np.testing.assert_array_equal(to_u64(got), want)


@pytest.mark.parametrize("name", sorted(FLAVORS))
def test_plain_kernels_match_pallas_interpret(name, monkeypatch):
    """plain K2 then plain K1 == the v6 Pallas kernels (body-rotation
    prologue + fused steps, acc32) in interpret mode, bit for bit."""
    monkeypatch.delenv("TFHE_V4_ACC", raising=False)
    fl, jfl = FLAVORS[name]
    lut, mask, body, bsk2, blog, levels = _toy_inputs(jfl, seed=21)
    want = np.asarray(jpk.blind_rotate_pallas(
        jnp.asarray(lut), jnp.asarray(mask), jnp.asarray(body),
        jnp.asarray(bsk2), blog, levels, jfl.plan(256), batch_tile=2,
        unroll=2, bnf2=True, bnf2_flavor=jfl))
    pk.reset_launches()
    hi = pk.body_rotate_acc32(from_u64(lut, "cpu"), from_u64(body, "cpu"))
    hi = pk.blind_rotate_bnf2_acc32(hi, from_u64(mask, "cpu"),
                                    from_u32(bsk2, "cpu"), blog, levels, fl)
    got = to_u32(hi).astype(np.uint64) << np.uint64(32)
    np.testing.assert_array_equal(got, want)
    # CPU tensors take the plain versions: no kernel launched
    assert pk.body_rotate_acc32.launches == 0
    assert pk.blind_rotate_bnf2_acc32.launches == 0


@pytest.mark.parametrize("R", [2, 5])
def test_plain_body_rotation_matches_pallas_interpret(R):
    """plain K2 == _build_body_rot_fn_v4(acc32=True) in interpret mode, on
    the transposed [R, G, B, 128] layout of the Pallas kernel."""
    n, B = 256, 4
    G = n // 128
    r = np.random.default_rng(R)
    lut = r.integers(0, 1 << 64, size=(B, R, n), dtype=np.uint64)
    body = r.integers(0, 2 * n, size=(B,), dtype=np.uint64)
    body[:2] = [0, n]
    acc = jpk.to_transposed_layout(jnp.moveaxis(jnp.asarray(lut), 1, 0), G)
    hi, lo = jpk.split_u64(jnp.moveaxis(acc, 2, 1))  # [R, G, B, 128]
    a_rot = ((2 * n - jnp.asarray(body)) % (2 * n)).astype(jnp.uint32)
    fn = jpk._build_body_rot_fn_v4(n, R, 2, acc32=True)
    out = fn(a_rot[None, :, None], hi, lo)
    want = np.asarray(jnp.moveaxis(
        jpk.from_transposed_layout(jnp.moveaxis(out, 1, 2)), 0, 1))
    got = pk.body_rotate_acc32(from_u64(lut, "cpu"), from_u64(body, "cpu"))
    np.testing.assert_array_equal(to_u32(got), want)
    shared = pk.body_rotate_acc32(from_u64(lut[0], "cpu"),
                                  from_u64(body, "cpu"))
    np.testing.assert_array_equal(
        to_u32(shared), to_u32(pk.body_rotate_acc32_plain(
            from_u64(np.broadcast_to(lut[0], lut.shape), "cpu"),
            from_u64(body, "cpu"))))


def test_kernel_tables_layout():
    """K1's constant table holds the plan's tables at the offsets the CUDA
    source reads (stage s twiddles at N - (N >> s))."""
    n = 256
    plan = b2.FAST28.plan(n)
    t = pk.plan_tables(plan)
    assert t.shape == (2, 8, n) and t.dtype == np.uint32
    for pi in range(2):
        np.testing.assert_array_equal(t[pi, 0], plan.twist[pi])
        np.testing.assert_array_equal(t[pi, 3], plan.untwist_shoup[pi])
        for s in range(plan.log_n):
            off, h = n - (n >> s), n >> (s + 1)
            np.testing.assert_array_equal(t[pi, 4, off:off + h],
                                          plan.tw_fwd[s][pi])
            np.testing.assert_array_equal(t[pi, 7, off:off + h],
                                          plan.tw_inv_shoup[s][pi])
