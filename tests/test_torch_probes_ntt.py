"""The NTT-variant probes of the port (``tfhe_tpu_torch/tools/
ntt_variants.py``) against ``tools/ntt_variants.py``'s case bodies.

The JAX probe runs every case when it is imported, so each body is rebuilt
here from ``tfhe_tpu.ops.pbs_kernel``'s transforms and stages and run
through ``pallas_call(..., interpret=True)`` on the same numpy rows (prime
0 of ``_get_tables(n, 4)``; 3 trips, one for the bodies slowest in
interpret mode). The JAX transforms are lazy (< 2p), the port's exact:
they are held as residues mod p, the inverse (canonical on both sides)
and the transpose exactly. Rows are of N = 256 but one case at N = 2048. Also: the variants share one plain transform, the stage ranges
compose to it, CPU tensors take the plain versions (launch counts stay 0)
and the entry point needs a GPU."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from tfhe_tpu.ops import kernel_bench as jkb
from tfhe_tpu.ops import pbs_kernel as jpk

from tfhe_tpu_torch._torus import from_u32, to_u32
from tfhe_tpu_torch.ops import kernel_bench as kb
from tfhe_tpu_torch.ops import ntt as ntt_mod
from tfhe_tpu_torch.tools import ntt_variants as nv

LOOPS = 3
BT = 8
P = np.uint32(nv.PRIME)
P2 = np.uint32(2 * nv.PRIME)
# tools/ntt_variants.py:33-35 without the MXU tables
TABS = ("tw_fwd", "tw_fwd_sh", "tw_inv", "tw_inv_sh", "twist", "twist_sh",
        "untwist", "untwist_sh", "upper", "tw_fwd_col", "tw_fwd_col_sh",
        "tw_inv_col", "tw_inv_col_sh")


def _rows(n, seed=0, high=None):
    return np.random.default_rng(seed).integers(0, high or int(P), (BT, n),
                                                np.uint32)


def _looped(body, x, loops=LOOPS):
    """tools/ntt_variants.py::run_case's kernel, interpret mode."""
    n = x.shape[-1]
    tabs = jpk._get_tables(n, 4)
    arrays = [jnp.asarray(getattr(tabs, nm)) for nm in TABS]

    def kernel(n_ref, x_ref, *refs):
        tc = {nm: r[:] for nm, r in zip(TABS, refs[:-1])}
        tc["first_small"] = tabs.first_small_stage
        refs[-1][:] = lax.fori_loop(0, n_ref[0], lambda i, v: body(v, tc, n),
                                    x_ref[:])

    call = jkb._looped_pallas(kernel, (x.shape, jnp.uint32), 1 + len(arrays),
                              interpret=True)
    return np.asarray(call(jnp.full((1,), loops, jnp.int32), jnp.asarray(x),
                           *arrays))


def _log(n):
    return n.bit_length() - 1


# the JAX bodies, tools/ntt_variants.py:94-222
JAX = {
    "fwd_v1": lambda x, tc, n: jpk._fwd_ntt(x, 0, tc, P, P2, _log(n)),
    "fwd_v2": lambda x, tc, n: jpk._fwd_ntt_v2(x, 0, tc, P, P2, _log(n)),
    "inv_v1": lambda x, tc, n: jpk._inv_ntt(x, 0, tc, P, P2, _log(n)),
    "inv_v2": lambda x, tc, n: jpk._inv_ntt_v2(x, 0, tc, P, P2, _log(n)),
}


def _sliced4(x, tc, n):
    for s in range(4):
        h = (n >> s) >> 1
        x = jpk._fwd_stage_sliced(x, h, tc["tw_fwd"][0, s][None],
                                  tc["tw_fwd_sh"][0, s][None], P, P2)
    return x


def _rolled7(x, tc, n):
    for s in range(_log(n) - 7, _log(n)):
        h = (n >> s) >> 1
        x = jpk._fwd_stage_rolled(x, h, tc["tw_fwd"][0, s][None],
                                  tc["tw_fwd_sh"][0, s][None],
                                  tc["upper"][s][None], P, P2)
    return x


def _subl7(x, tc, n):
    y = x.reshape(BT * (n // 128), 128).T
    for k in range(7):
        h = 128 >> (k + 1)
        y = jpk._fwd_stage_subl(y, h, tc["tw_fwd_col"][0, k][:, None],
                                tc["tw_fwd_col_sh"][0, k][:, None], P, P2)
    return y.T.reshape(BT, n)


def _relayout(x, tc, n):
    y = x.reshape(BT * (n // 128), 128).T
    return (y + jnp.uint32(1)).T.reshape(BT, n)


JAX.update({"sliced4": _sliced4, "rolled7": _rolled7,
            "subl7_with_relayout": _subl7, "relayout_only": _relayout})

for _v, _fwd in (("v2", jpk._fwd_ntt_v2), ("v1", jpk._fwd_ntt)):
    # fwd4_primes_v1/_v2 with each prime's lazy output made canonical
    # before the XOR (the port's transforms are exact)
    def _fwd4(x, tc, n, fwd=_fwd):
        tabs = jpk._get_tables(n, 4)
        o = None
        for pi in range(4):
            p = np.uint32(tabs.plan.primes[pi])
            y = jpk._condsub(fwd(x, pi, tc, p, np.uint32(2 * int(p)),
                                 _log(n)), p)
            o = y if o is None else o ^ y
        return o

    JAX[f"fwd4_primes_{_v}"] = _fwd4


#: the bodies slowest in interpret mode (sublane transposes) run one trip
TRIPS = {"fwd_v2": 1, "inv_v2": 1, "subl7_with_relayout": 1}


@functools.lru_cache(maxsize=None)
def _jax(name, n):
    return _looped(JAX[name], _rows(n), TRIPS.get(name, LOOPS))


CASES = {c.name: c for c in nv.CASES}


def _plain(name, n, body):
    return to_u32(CASES[name](from_u32(_rows(n), "cpu"),
                              TRIPS.get(body, LOOPS)))


@pytest.mark.parametrize("case", ["fwd_r2", "fwd_r4", "fwd_reg"])
@pytest.mark.parametrize("body", ["fwd_v1", "fwd_v2"])
def test_forward_variants_equal_jax_mod_p(case, body):
    np.testing.assert_array_equal(_plain(case, 256, body),
                                  _jax(body, 256) % P)


@pytest.mark.parametrize("case", ["inv_r2", "inv_r4", "inv_reg"])
@pytest.mark.parametrize("body", ["inv_v1", "inv_v2"])
def test_inverse_variants_equal_jax(case, body):
    np.testing.assert_array_equal(_plain(case, 256, body),
                                  _jax(body, 256))


@pytest.mark.parametrize("n", [256, 2048])
def test_first4_equals_sliced4_mod_p(n):
    np.testing.assert_array_equal(_plain("first4", n, "sliced4"),
                                  _jax("sliced4", n) % P)


@pytest.mark.parametrize("case", ["last7_r2", "last7_reg"])
@pytest.mark.parametrize("body", ["rolled7", "subl7_with_relayout"])
def test_last7_equals_jax_mod_p(case, body):
    np.testing.assert_array_equal(_plain(case, 256, body),
                                  _jax(body, 256) % P)


@pytest.mark.parametrize("case", ["transpose_128", "transpose_128_pad"])
def test_transpose_equals_relayout_only(case):
    """One trip is transpose + 1 on each 128 x 128 tile (8 rows of 2048);
    relayout_only's loop is two transposes and + 1, so 2k trips equal k
    loops of it plus k."""
    x = _rows(2048, seed=1, high=1 << 32)
    one = to_u32(CASES[case](from_u32(x, "cpu"), 1))
    np.testing.assert_array_equal(
        one, (x.reshape(1, 128, 128).transpose(0, 2, 1) + np.uint32(1))
        .reshape(BT, 2048))
    two = to_u32(CASES[case](from_u32(x, "cpu"), 2 * LOOPS))
    np.testing.assert_array_equal(two - np.uint32(LOOPS),
                                  _looped(_relayout, x, LOOPS))


def test_transpose_library_is_one_trip():
    """``library_ms``'s call computes one trip (transpose + 1 of every
    tile) into a contiguous buffer: a transpose in memory."""
    (x,) = nv.tiles("cpu")
    case = {c.name: c for c in nv.CASES}["transpose_128"]
    got = case.library(x)
    assert got.is_contiguous() and torch.equal(got, case(x, 1))


def test_fwd4_primes_equals_jax():
    """fwd4_primes_v1's body; _v2 differs only in the transform's TPU
    layout (fwd_v2, held above), and four of its transforms take ten
    seconds in interpret mode."""
    np.testing.assert_array_equal(_plain("fwd4_primes", 256, "fwd4_primes_v1"),
                                  _jax("fwd4_primes_v1", 256))


def test_stage_ranges_compose_to_the_transform():
    """first4 then the last seven stages is the transform without its
    twist (the plan's own stages), so each variant can take the place of
    forward_stages."""
    x = torch.from_numpy(_rows(2048, seed=2).astype(np.int64))
    plan = kb._plan1(2048)
    whole = plan._fwd_stages(x[None], plan.tables("cpu"))[0]
    y = nv.stages_plain(nv.stages_plain(from_u32(x.numpy().astype(np.uint32),
                                                 "cpu"), 1, 0, 4), 1, 4, 11)
    np.testing.assert_array_equal(to_u32(y), whole.numpy().astype(np.uint32))
    r4 = nv.fwd_stage_range(ntt_mod.get_plan(2048, 4), x.expand(4, BT, 2048),
                            0, 11)
    assert torch.equal(r4[0], whole)


def test_cpu_tensors_take_plain_versions():
    nv.reset_launches()
    for c in nv.CASES:
        (x,) = c.inputs("cpu")
        out = c(x, 1)
        assert out.shape == x.shape and out.dtype == torch.int32
        assert c.launches == 0, c.name
    assert {c.kernel for c in nv.CASES} <= set(nv.SASS_LOOP_TOTALS)


def test_entry_point_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        nv.run_all(quick=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        nv.main([])
