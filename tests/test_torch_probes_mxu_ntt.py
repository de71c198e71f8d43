"""The tensor-core transform cases of the port (``tfhe_tpu_torch/tools/
ntt_mxu.py``: the MXU cases of ``ntt_variants`` and ``v4_probe``, and
``ntt_v3c_experiments``) and its int8 tables (``ops/mxu_tables.py``)
against ``tfhe_tpu``.

The JAX probes run every case when they are imported, and several of their
MXU cases are stale (ROADMAP.md Queue C), so each body is rebuilt here from
the function the JAX package computes today, called as
``tools/v4_probe.py:159-178`` calls ``_fwd_ntt_v3`` / ``_inv_ntt_v3b``, and
``_fwd_ntt_v4`` / ``_inv_ntt_v4`` on the [G, Bt, 128] layout the step
kernel gives them, then run through ``pallas_call(..., interpret=True)`` on
the same numpy rows (8 polynomials, 3 trips) and held exactly. N = 256 but
one case and the tables also at N = 2048. Also: ``_inv_ntt_v3`` and
``_inv_ntt_v3b`` give one output, the Shoup mode in force is the default
approx one, CPU tensors take the plain versions (launch counts stay 0),
the entry point needs a GPU, and the verdict's arithmetic."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from tfhe_tpu.ops import kernel_bench as jkb
from tfhe_tpu.ops import pbs_kernel as jpk

from tfhe_tpu_torch._torus import from_u32, to_u32
from tfhe_tpu_torch.ops import mxu_tables
from tfhe_tpu_torch.tools import ntt_mxu as nm
from tfhe_tpu_torch.tools import ntt_v3c_experiments as v3c
from tfhe_tpu_torch.tools import ntt_variants as nv
from tfhe_tpu_torch.tools import v4_probe as vp

U32, I32 = jnp.uint32, jnp.int32
LOOPS, BT = 3, 8
P0 = np.uint32(nm.PRIME)
P20 = np.uint32(nm.P2)
V3_NAMES = ("fwd_w8", "inv_w8", "fwd_w8m", "inv_w8m", "fwd_bias_row",
            "inv_bias_row", "c32", "c32_sh", "one_sh", "recomb_bias", "c16",
            "c16_sh")
V4_NAMES = ("fwd_w8", "inv_w8", "inv_bias", "tw", "tw_inv", "gw_fwd",
            "gw_inv", "c16", "c16_sh", "one_sh", "nl_in", "in_offset")


@pytest.mark.parametrize("n", [256, 2048])
def test_tables_equal_jax(n):
    a, b = mxu_tables.v3_tables(n, 4), jpk._get_tables(n, 4)
    for k in V3_NAMES:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
    assert a.first_small_stage == b.first_small_stage
    a, b = mxu_tables.v4_tables(n, 4, 23), jpk._get_tables_v4(n, 4, 23)
    for k in V4_NAMES:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
    assert (a.G, a.log_g) == (b.G, b.log_g)


def _dot(a, b):
    return lax.dot_general(a, b, (((1,), (0,)), ((), ())),
                           preferred_element_type=I32)


@functools.lru_cache(maxsize=None)
def _consts(n):
    """The tables the bodies read, as the kernel's refs: v3 (with the
    merged and the unmerged limb matrices) and v4, prime 0's constants."""
    t3, t4 = jpk._get_tables(n, 4), jpk._get_tables_v4(n, 4, 23)
    arrays = {k: getattr(t3, k) for k in (
        "tw_fwd", "tw_fwd_sh", "tw_inv", "tw_inv_sh", "twist", "twist_sh",
        "untwist", "untwist_sh", "fwd_w8", "fwd_w8m", "inv_w8m",
        "fwd_bias_row", "inv_bias_row")}
    arrays.update({f"v4_{k}": getattr(t4, k) for k in (
        "fwd_w8", "inv_w8", "tw", "tw_inv", "gw_fwd", "gw_inv", "inv_bias")})
    return arrays, t3, t4


def _tc(refs, n):
    """The bodies' table dict: tools/v4_probe.py's v3 ``tc`` and ``T4C``."""
    arrays, t3, t4 = _consts(n)
    tc = {k: r[:] for k, r in zip(arrays, refs)}
    tc["first_small"] = t3.first_small_stage
    tc["mxu_consts"] = tuple((int(t3.c16[i]), int(t3.c16_sh[i]),
                              int(t3.one_sh[i])) for i in range(4))
    tc["fwd_bias"], tc["inv_bias"] = tc["fwd_bias_row"], tc["inv_bias_row"]
    t4c = {k[3:]: v for k, v in tc.items() if k.startswith("v4_")}
    t4c["log_g"] = t4.log_g
    t4c["mxu_consts"] = tuple((int(t4.c16[i]), int(t4.c16_sh[i]),
                               int(t4.one_sh[i])) for i in range(4))
    return tc, t4c, t3, t4


def _limbs4(y, G):
    """v4_probe.py:229-231: the 4-limb offset split of [G, BT, 128]."""
    return jnp.concatenate([
        ((((y.reshape(G * BT, 128)).astype(I32) >> I32(8 * j)) & I32(255))
         - I32(128)).astype(jnp.int8) for j in range(4)], axis=-1)


def _mm(x, tc, n, kind):
    """ntt_v3c_experiments.py:252-302: mm4_only, mm1_only, mm1_rows*."""
    G = n // 128
    c = jpk._condsub(x.reshape(BT * G, 128), P0)
    if kind == "mm4":
        L, acc = jpk._split4_i8(c), None
        for j in range(4):
            u = _dot(L, tc["fwd_w8"][0, j])
            acc = u if acc is None else acc + u
        return acc.astype(U32).reshape(BT, n) + x
    r = {"mm1": 1, "mm1_2": 2, "mm1_4": 4}[kind]
    U = _dot(jnp.concatenate([jpk._split4_i8_offset(c)] * r, axis=0),
             tc["fwd_w8m"][0])
    R = BT * G
    if r == 1:
        acc = U[:, :128] + U[:, 128:256] + U[:, 256:384] + U[:, 384:512]
    elif r == 2:
        acc = U[:R, :128] + U[R:, :128] + U[:R, 128:256] + U[R:, 384:512]
    else:
        acc = (U[:R, :128] + U[R:2 * R, :128] + U[2 * R:3 * R, 128:256]
               + U[3 * R:, 384:512])
    return acc.astype(U32).reshape(BT, n) + x


def _v4_inv_mmr(x, t4c, G):
    """v4_probe.py:235-251 (the exact _mul_hi for q0)."""
    U = _dot(_limbs4(jpk._condsub(x, P0), G), t4c["inv_w8"][0])
    V0u, V1u = jpk._pair_fold_u(U)
    c16, c16_sh, one_sh = t4c["mxu_consts"][0]
    r0 = V0u - jpk._mul_hi(V0u, U32(one_sh)) * P0
    r1 = jpk._shoup(V1u, U32(c16), U32(c16_sh), P0)
    s = jpk._condsub(r0 + r1, P20)
    s = jpk._condsub(s + t4c["inv_bias"][0][None, :], P20)
    return jpk._condsub(s, P0).reshape(G, BT, 128)


def _body(name, n):
    """The JAX body of case ``name`` on [BT, n] (v3, mm) or [G, BT, 128]
    (v4) u32, given the refs."""
    G, log_n = n // 128, n.bit_length() - 1
    i8x3 = lambda x: jnp.concatenate(
        [x.reshape(G * BT, 128).astype(jnp.int8)] * 3, axis=-1)

    def body(x, refs):
        tc, t4c, t3, t4 = _tc(refs, n)
        if name == "v3_fwd_mxu":  # v4_probe.py:159-167
            return jpk._fwd_ntt_v3(x, 0, tc, P0, P20, log_n,
                                   tc["fwd_w8m"]).reshape(BT, n)
        if name == "v3_inv_mxu":  # v4_probe.py:169-178
            return jpk._inv_ntt_v3b(x.reshape(BT * G, 128), 0, tc, P0, P20,
                                    log_n, tc["inv_w8m"], BT, n)
        if name == "split4_only":  # ntt_variants.py:185-188
            L = jpk._split4_i8(x.reshape(BT * G, 128))
            return (L[:, :128].astype(I32).astype(U32)
                    + L[:, 128:256].astype(I32).astype(U32)).reshape(BT, n) + x
        if name.startswith("mm"):
            kind = {"mm4_only": "mm4", "mm1_only": "mm1",
                    "mm1_rows256": "mm1_2", "mm1_rows512": "mm1_4"}[name]
            return _mm(x, tc, n, kind)
        if name == "v4_matmul_fold":  # v4_probe.py:325-332 (g_matmul_fold)
            V0u, V1u = jpk._pair_fold_u(_dot(i8x3(x), t4c["fwd_w8"][0]))
            return (V0u ^ V1u).reshape(G, BT, 128)
        if name == "v4_split4":  # v4_probe.py:227-232
            return x + _limbs4(jpk._condsub(x, P0), G)[:, :128].astype(
                I32).astype(U32).reshape(G, BT, 128)
        if name == "v4_inv_matmul_recombine":
            return _v4_inv_mmr(x, t4c, G)
        if name == "v4_fwd_mxu":  # v4_probe.py:114-118
            d = (x & U32(0x3FFFFF)).astype(I32) - I32(1 << 21)
            L = jpk._split_digits_i8(d, t4.nl_in, t4.in_offset)
            return jpk._fwd_ntt_v4(L, 0, t4c, P0, P20, BT, G)
        if name == "v4_fwd_mxu_nosplit":  # v4_probe.py:121-125
            return jpk._fwd_ntt_v4(i8x3(x), 0, t4c, P0, P20, BT, G)
        assert name == "v4_inv_mxu"  # v4_probe.py:128-130
        return jpk._inv_ntt_v4(x, 0, t4c, P0, P20, BT, G)
    return body


def _looped(name, x, n):
    arrays = [jnp.asarray(a) for a in _consts(n)[0].values()]
    body = _body(name, n)

    def kernel(n_ref, x_ref, *refs):
        refs[-1][:] = lax.fori_loop(
            0, n_ref[0], lambda i, v: body(v, refs[:-1]), x_ref[:])

    call = jkb._looped_pallas(kernel, (x.shape, jnp.uint32), 1 + len(arrays),
                              interpret=True)
    return np.asarray(call(jnp.full((1,), LOOPS, jnp.int32), jnp.asarray(x),
                           *arrays))


CASES = {c.name: c for c in (nv.MXU_CASES + vp.MXU_CASES + v3c.CASES)}


def _check(name, n):
    assert jpk._SHOUP_MODE == "approx"
    x = np.random.default_rng(5).integers(0, int(P0), (BT, n), np.uint32)
    got = to_u32(CASES[name](from_u32(x, "cpu"), LOOPS))
    G = n // 128
    if name.startswith("v4"):  # [G, BT, 128]: group g of polynomial b
        want = _looped(name, x.reshape(BT, G, 128).transpose(1, 0, 2), n)
        want = want.transpose(1, 0, 2).reshape(BT, n)
    else:
        want = _looped(name, x, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_equals_jax_body(name):
    _check(name, 256)


def test_plain_equals_jax_body_at_2048():
    _check("v4_inv_mxu", 2048)


def test_inv_v3_and_v3b_agree():
    """``_inv_ntt_v3`` (flat big stages) and ``_inv_ntt_v3b`` (3-D block
    stages) give one output, so ``v3_inv_mxu`` stands for both."""
    n = 256
    x = jnp.asarray(np.random.default_rng(6).integers(
        0, int(P20), (BT * n // 128, 128), np.uint32))
    arrays = [jnp.asarray(a) for a in _consts(n)[0].values()]
    tc = _tc(arrays, n)[0]
    a = jpk._inv_ntt_v3(x, 0, tc, P0, P20, 8, tc["inv_w8m"], BT, n)
    b = jpk._inv_ntt_v3b(x, 0, tc, P0, P20, 8, tc["inv_w8m"], BT, n)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cpu_tensors_take_plain_versions():
    for mod, cases in ((nv, nv.MXU_CASES), (vp, vp.MXU_CASES),
                       (v3c, v3c.CASES)):
        mod.reset_launches()
        for c in cases:
            (x,) = c.inputs("cpu")
            out = c(x, 1)
            assert out.shape == x.shape and c.launches == 0, c.name
        assert {c.kernel for c in cases} <= set(mod.SASS_LOOP_TOTALS)
    rows = v3c.run_all(device="cpu")
    assert [r["metric"] for r in rows] == [c.name for c in v3c.CASES] + [
        m for m, _, _ in v3c.V3_ROWS]


def test_units_and_macs():
    """mm1_rows256/512 count 2 and 4 transforms a polynomial, and issue
    their MACs (the wgmma kernel in 4-wgmma m64n256k32 bodies); the
    mma.sync references read their table once a polynomial-trip, the
    wgmma kernel once a launch: at most 1/8 of that."""
    (x,) = nm.residues("cpu")
    by = CASES
    assert by["mm1_rows512"].units((x,)) == 4 * x.shape[0]
    assert by["mm1_rows512"].macs((x,)) == 4 * by["mm1_only"].macs((x,))
    assert by["v3_fwd_mxu"].macs((x,)) == x.shape[0] * 16 * 512 * 512
    assert by["v4_fwd_mxu"].macs((x,)) == x.shape[0] * 16 * 384 * 512
    assert by["v4_fwd_mxu"].reference.l2_bytes((x,)) == \
        x.shape[0] * 384 * 512
    assert by["split4_only"].macs((x,)) == 0
    polys = 4 * x.shape[0]  # the kernel takes a multiple of its 4
    y = x.repeat(4, 1)
    for c in by.values():
        if c.reference is None:
            continue
        assert c.mma_trips((y,)) * 4 * 64 * 256 * 32 == c.macs((y,))
        assert c.reference.macs((y,)) == c.macs((y,))
        assert c.l2_bytes((y,)) * 8 <= c.reference.l2_bytes((y,))
        assert c.l2_bytes((y,)) == polys * (
            nm.K[c.kernel.split("_")[0] if c.kernel.startswith("mm")
                 else c.kernel] * 128 + 2 * 2048 * 4) / 256


def test_entry_point_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        v3c.run_all(quick=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        v3c.main([])


def test_verdict():
    """ns a polynomial from the butterfly rows (11,264 butterflies) and the
    MXU rows, and which side wins."""
    rows = {m: {"ps_per_unit": ps, "card": "c"} for m, ps in (
        ("fwd_r2", 2.0), ("fwd_r4", 1.5), ("inv_r2", 2.5), ("inv_r4", 1.6),
        ("v3_fwd_mxu", 20000.0), ("v4_fwd_mxu", 15000.0),
        ("v4_fwd_mxu_nosplit", 14000.0), ("v3_inv_mxu", 30000.0),
        ("v4_inv_mxu", 19000.0))}
    for m in ("v3_fwd_mxu", "v4_fwd_mxu", "v3_inv_mxu", "v4_inv_mxu"):
        rows[m]["l2_bytes_per_s"] = 1e12
    rows["int8_matmul_128x512x128"] = {"int8_tensor_fraction": 0.5}
    rows["int8_gemm_library"] = {"int8_tensor_fraction": 0.6}
    v = nm.verdict(rows)
    assert v["ns_per_polynomial"]["fwd_r4"] == pytest.approx(1.5 * 11264e-3)
    assert v["ns_per_polynomial"]["v4_fwd_mxu"] == pytest.approx(15.0)
    assert v["speedup_over_r4"]["v4_fwd_mxu"] == pytest.approx(16.896 / 15)
    assert v["tensor_dft_wins"] == {"fwd": True, "inv": False}
