"""The step probes of the port (``tfhe_tpu_torch/tools/v4_probe.py``)
against ``tools/v4_probe.py``'s case bodies and the JAX specs of the step.

The JAX probe runs every case when it is imported, so each body is rebuilt
here from ``tfhe_tpu.ops.pbs_kernel``'s functions and run through
``pallas_call(..., interpret=True)`` on the same numpy inputs. ``g_rot``
and ``g_decomp`` are held exactly, in the [G, Bt, 128] layout of
``run_case_g``, where x[g, b, l] is coefficient l * G + g of ciphertext b;
the transforms (``_fwd_stage_sliced``/``_rolled``, lazy < 2p) and the MAC
mod p; ``_inv_ntt`` (canonical) exactly. ``g_garner`` is fed canonical
residues (x < 2^29, so that x ^ i lies below every prime and the probe's
mask keeps it), one trip, and held exactly, as are the BNF2 tails against
``tfhe_tpu.ops.bnf2``. N = 256 but ``g_rot`` also at N = 2048, as the
probe writes it. Also: both layouts share one plain version, CPU tensors
take the plain versions (launch counts stay 0), the entry point needs a
GPU, and the split of a step into the pieces adds up."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from tfhe_tpu.ops import bnf2 as jbnf2
from tfhe_tpu.ops import kernel_bench as jkb
from tfhe_tpu.ops import pbs_kernel as jpk

from tfhe_tpu_torch._torus import from_u32, to_u32
from tfhe_tpu_torch.ops import kernel_bench as kb
from tfhe_tpu_torch.tools import v4_probe as vp

U32, I32 = jnp.uint32, jnp.int32
LOOPS = 3
BT = 8
CASES = {c.name: c for c in vp.CASES}


def _looped(body, x, *consts, loops=LOOPS):
    def kernel(n_ref, x_ref, *refs):
        c = [r[:] for r in refs[:-1]]
        refs[-1][:] = lax.fori_loop(0, n_ref[0], lambda i, v: body(v, *c),
                                    x_ref[:])

    call = jkb._looped_pallas(kernel, (x.shape, jnp.uint32), 1 + len(consts),
                              interpret=True)
    return np.asarray(call(jnp.full((1,), loops, jnp.int32), jnp.asarray(x),
                           *map(jnp.asarray, consts)))


def _u32(shape, high, seed):
    return np.random.default_rng(seed).integers(0, high, shape, np.uint32)


def _run(piece, x, loops=LOOPS, *ops):
    """Every layout's case of ``piece`` on CPU tensors: one plain result."""
    outs = [to_u32(CASES[f"{piece}_{lay}"](from_u32(x, "cpu"), *ops, loops))
            for lay in vp.layouts_of(piece)]
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0], o)
    return outs[0]


def _g_rot(G, log_2n):
    """tools/v4_probe.py::g_rot (:335-372) for G groups of 128 lanes."""
    def body(x):
        lane_idx = lax.broadcasted_iota(U32, (1, 1, 128), 2)
        a = (x[:1, :, :1] & U32(2 * 128 * G - 1))
        hi, lo = x, x ^ U32(1)
        for t in range(log_2n):
            s = 1 << t
            bit = (a >> U32(t)) & U32(1)
            if s >= 128 * G:
                rhi, rlo = jpk._neg64(hi, lo)
            elif s >= G:
                sl = s // G
                rhi = jpk._roll(hi, sl, 2)
                rlo = jpk._roll(lo, sl, 2)
                nhi, nlo = jpk._neg64(rhi, rlo)
                wrap = lane_idx < U32(sl)
                rhi = jnp.where(wrap, nhi, rhi)
                rlo = jnp.where(wrap, nlo, rlo)
            else:
                rthi = jpk._roll(hi[G - s:], 1, 2)
                rtlo = jpk._roll(lo[G - s:], 1, 2)
                nhi, nlo = jpk._neg64(rthi, rtlo)
                wrap = lane_idx < U32(1)
                rthi = jnp.where(wrap, nhi, rthi)
                rtlo = jnp.where(wrap, nlo, rtlo)
                rhi = jnp.concatenate([rthi, hi[:G - s]], axis=0)
                rlo = jnp.concatenate([rtlo, lo[:G - s]], axis=0)
            take = bit != U32(0)
            hi = jnp.where(take, rhi, hi)
            lo = jnp.where(take, rlo, lo)
        return hi ^ lo
    return body


def _rows_of_g(x):
    """[G, Bt, 128] -> [Bt, N] rows, coefficient l * G + g."""
    G = x.shape[0]
    return np.ascontiguousarray(x.transpose(1, 2, 0)).reshape(x.shape[1],
                                                               128 * G)


@pytest.mark.parametrize("n", [256, 2048])
def test_rot_equals_g_rot(n):
    """The port's rotation is g_rot's u64 negacyclic rotation, in K1's
    coefficient order. (v4_rot runs the same code on a [Bt, G, 128] tile
    whose axis 0 holds Bt = 8 rows where the code expects G groups, so
    g_rot is the body this function is held to.)"""
    G = n // 128
    x = _u32((G, BT, 128), vp.PRIME0, seed=n)
    want = _looped(_g_rot(G, (2 * n).bit_length() - 1), x)
    np.testing.assert_array_equal(_run("rot", _rows_of_g(x)), _rows_of_g(want))


def test_decomp_equals_g_decomp():
    x = _u32((2, BT, 128), 1 << 32, seed=1)
    want = _looped(lambda v: jpk._decompose_u32(v, v ^ U32(1), vp.BASE_LOG,
                                                1)[0].astype(U32), x)
    np.testing.assert_array_equal(_run("decomp", _rows_of_g(x)),
                                  _rows_of_g(want))


def _tables(n, P=4):
    return jpk._get_tables(n, P)


def test_lift_twist_mod_p():
    """v4_fwd_with_split's digit (:116) lifted into Z_p and twisted by
    prime 0's psi^t (pk._shoup), mod p."""
    tabs = _tables(256)
    p = np.uint32(tabs.plan.primes[0])

    def body(v, tw, tw_sh):
        d = (v & U32(0x3FFFFF)).astype(I32) - I32(1 << 21)
        m = jnp.where(d < 0, d + I32(int(p)), d).astype(U32)
        return jpk._condsub(jpk._shoup(m, tw[None], tw_sh[None], p), p)

    x = _u32((BT, 256), 1 << 32, seed=2)
    want = _looped(body, x, tabs.twist[0], tabs.twist_sh[0])
    np.testing.assert_array_equal(_run("lift_twist", x) % p, want % p)


def _stages(pi, s0, s1, n):
    tabs = _tables(n)
    p = np.uint32(tabs.plan.primes[pi])
    p2 = np.uint32(2 * int(p))

    def body(v, tw, tw_sh, upper):
        for s in range(s0, s1):
            h = (n >> s) >> 1
            if h >= 128:
                v = jpk._fwd_stage_sliced(v, h, tw[pi, s][None],
                                          tw_sh[pi, s][None], p, p2)
            else:
                v = jpk._fwd_stage_rolled(v, h, tw[pi, s][None],
                                          tw_sh[pi, s][None], upper[s][None],
                                          p, p2)
        return jpk._condsub(v, p)
    return body, (tabs.tw_fwd, tabs.tw_fwd_sh, tabs.upper), p


@pytest.mark.parametrize("piece,stages", [("fwd", (0, 8)),
                                          ("fwd_first4", (0, 4))])
def test_forward_pieces_per_prime(piece, stages):
    """Polynomial k of a ciphertext's 8 is transformed mod prime k % 4
    (forward_stages<4>), stage for stage as pk._fwd_ntt's stages, mod p;
    one trip."""
    x = _u32((2, 8, 256), vp.PRIME0, seed=3)
    got = _run(piece, x, 1)
    for pi in range(4):
        body, tabs, p = _stages(pi, *stages, 256)
        rows = np.ascontiguousarray(x[:, pi::4]).reshape(-1, 256)
        want = _looped(body, rows, *tabs, loops=1)
        np.testing.assert_array_equal(
            got[:, pi::4].reshape(-1, 256) % p, want)


def test_inv_untwist_per_prime():
    x = _u32((2, 8, 256), vp.PRIME0, seed=4)
    got = _run("inv_untwist", x, 1)
    tabs = _tables(256)
    names = jkb._TAB_NAMES
    for pi in range(4):
        p = np.uint32(tabs.plan.primes[pi])

        def body(v, *arrays, pi=pi, p=p):
            tc = dict(zip(names, arrays))
            return jpk._inv_ntt(v, pi, tc, p, np.uint32(2 * int(p)), 8)

        rows = np.ascontiguousarray(x[:, pi::4]).reshape(-1, 256)
        want = _looped(body, rows, *(getattr(tabs, nm) for nm in names),
                       loops=1)
        np.testing.assert_array_equal(got[:, pi::4].reshape(-1, 256), want)


def test_mac2_mod_p():
    """v4_mac2 with two distinct GGSW rows and true Shoup duals."""
    p = np.uint32(vp.PRIME0)
    rng = np.random.default_rng(5)
    g = rng.integers(0, int(p), size=(2, 256))
    g2 = kb.mac_operands(torch.from_numpy(g))
    gs = to_u32(g2[1])

    def body(v, g_, gs_):
        acc = jpk._shoup(v, g_[0][None], gs_[0][None], p)
        return jpk._condsub(acc + jpk._shoup(v, g_[1][None], gs_[1][None], p),
                            np.uint32(2) * p)

    x = _u32((BT, 256), int(p), seed=6)
    want = _looped(body, x, g.astype(np.uint32), gs)
    np.testing.assert_array_equal(_run("mac2", x, LOOPS, g2) % p, want % p)


def _g_garner(P):
    """tools/v4_probe.py::g_garner (:402-435) at P primes, returning the
    centered value's (hi, lo)."""
    plan = _tables(256, P).plan
    primes = plan.primes
    inv_sh = [int(v) for v in plan.garner_inv_shoup]

    def value(x):
        m = [x ^ U32(i) for i in range(P)]
        v = [m[0]]
        for i in range(1, P):
            pi_p = U32(primes[i])
            acc_g = v[i - 1]
            for j in range(i - 2, -1, -1):
                acc_g = v[j] + jpk._shoup(acc_g, U32(primes[j]),
                                          U32(plan.pj_shoup[i][j]), pi_p)
            diff = U32(3 * primes[i]) + m[i] - acc_g
            vi = jpk._shoup(diff, U32(plan.garner_inv[i - 1]),
                            U32(inv_sh[i - 1]), pi_p)
            v.append(jpk._condsub(vi, pi_p))
        pos_hi = jnp.zeros_like(v[0])
        pos_lo = jnp.zeros_like(v[0])
        for i in range(P):
            pre = plan.prefix_mod64[i]
            thi, tlo = jpk._mul_hi_lo(v[i], U32(pre & 0xFFFFFFFF))
            thi = thi + v[i] * U32((pre >> 32) & 0xFFFFFFFF)
            pos_hi, pos_lo = jpk._add64(pos_hi, pos_lo, thi, tlo)
        fp = plan.full_prod_mod64
        neg_hi, neg_lo = jpk._sub64(pos_hi, pos_lo, U32(fp >> 32),
                                    U32(fp & 0xFFFFFFFF))
        sign = v[P - 1] > U32(primes[P - 1] // 2)
        return jnp.where(sign, neg_hi, pos_hi), jnp.where(sign, neg_lo,
                                                          pos_lo)
    return value


@pytest.mark.parametrize("kind", ["garner3", "garner4", "garner32_3",
                                  "garner32_4"])
def test_garner_tails_equal_g_garner(kind):
    """One trip on canonical residues: garner* folds the value as g_garner
    does (hi ^ lo); garner32_* rounds it to its hi word as the acc32 step
    does (hi + (lo >> 31), pbs_kernel.py:1635-1640)."""
    value = _g_garner(int(kind[-1]))
    if kind.startswith("garner32"):
        body = lambda v: (lambda hl: hl[0] + (hl[1] >> U32(31)))(value(v))
    else:
        body = lambda v: (lambda hl: hl[0] ^ hl[1])(value(v))
    x = _u32((BT, 256), 1 << 29, seed=7)
    np.testing.assert_array_equal(_run(kind, x, 1), _looped(body, x, loops=1))


def test_bnf2_tails_equal_jax_spec():
    """bnf2_c and bnf2_c32 against tfhe_tpu.ops.bnf2's crt2_merge +
    qp_to_torus and qp_to_torus32, one trip on canonical residues."""
    x = _u32((BT, 256), 1 << 29, seed=8)
    r0, r1 = x.astype(np.uint64), (x ^ np.uint32(1)).astype(np.uint64)
    t = np.asarray(jbnf2.qp_to_torus(jbnf2.crt2_merge(r0, r1)))
    np.testing.assert_array_equal(_run("bnf2_c", x, 1),
                                  ((t >> np.uint64(32)) ^ t)
                                  & np.uint64(0xFFFFFFFF))
    np.testing.assert_array_equal(_run("bnf2_c32", x, 1),
                                  np.asarray(jbnf2.qp_to_torus32(r0, r1)))
    assert jbnf2.DEFAULT.primes == vp.FLAVOR.primes


def test_cpu_tensors_take_plain_versions():
    vp.reset_launches()
    for c in vp.CASES:
        args = c.inputs("cpu")
        out = c(*args, 1)
        assert out.shape == args[0].shape and out.dtype == torch.int32
        assert c.launches == 0, c.name
    assert {c.kernel for c in vp.CASES} <= set(vp.SASS_LOOP_TOTALS)


def test_transform_layouts_share_one_loop():
    """fwd and inv_untwist run ct on the step kernels' own loop, il1 and
    il on the probes' C-strided loop at C = 1 and C = 2: il1 against il is
    the layout alone."""
    for piece in vp.BRK_PIECES:
        parts = {lay: vp.SASS_LOOP_TOTALS[f"{piece}_{lay}"][1][-1]
                 for lay in vp.layouts_of(piece)}
        assert parts == {"ct": "ILi1ELb1E", "il1": "ILi1ELb0E",
                         "il": "ILi2ELb0E"}
    assert vp.SASS_LOOP_TOTALS["fwd_first4_ct"][1][-1] == "ILi1ELb0E"


def test_entry_point_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        vp.run_all(quick=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        vp.main([])


def test_step_split_adds_up():
    """The pieces of a ciphertext-step at 2_2: K1 runs 2 primes, K3 4; the
    split is units times seconds per unit, and the remainder what the
    measured step leaves."""
    assert vp.step_units(2, "bnf2_c32") == {
        "rot": 4096, "decomp": 4096, "lift_twist": 8192, "fwd": 4 * 11264,
        "mac2": 8192, "inv_untwist": 4 * 11264, "bnf2_c32": 4096}
    rows = [{"metric": f"{k}_ct", "ps_per_unit": 1.0, "card": "c"}
            for k in ("rot", "decomp", "lift_twist", "fwd", "mac2",
                      "inv_untwist", "bnf2_c32", "garner4")]
    k1, k3 = vp.step_split(rows, {"K1": 1e-7, "K3_P4": 1e-6})
    assert k1["sum_us"] == pytest.approx(sum(vp.step_units(2, "bnf2_c32")
                                             .values()) * 1e-6)
    assert k1["remainder_us"] == pytest.approx(0.1 - k1["sum_us"])
    assert k3["pieces_us"]["garner4"] == pytest.approx(4096e-6)
    assert set(k1["stand_ins"]) == {"rot", "fwd", "inv_untwist"}
    assert k3["stand_ins"] == {}
