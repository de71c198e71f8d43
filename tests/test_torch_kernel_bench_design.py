"""The kernel bench's micro-kernels as redesigned (``csrc/kernel_bench.cu``):
the CPU mirror of each kernel's index formulas (``ops/kernel_bench.py``:
the transform's pass plan, item origins and swizzled row, the elementwise
kernels' thread-to-element map and 16-byte words, the rotation's words a
thread, source indices and double buffer) against the plain version and
against tfhe_tpu's ``_looped_pallas`` body in interpret mode, at N = 256
and 2048 and 1, 3 and 16 trips, on the same numpy inputs; and the bound's
yardstick, ``micro_pipe_instructions``, pinned to the radix-2 loop's
units."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from tfhe_tpu.ops import kernel_bench as jkb
from tfhe_tpu.ops import pbs_kernel as jpk

from tfhe_tpu_torch._torus import from_u32, from_u64, to_u32, to_u64
from tfhe_tpu_torch.ops import kernel_bench as kb
from tfhe_tpu_torch.ops import ntt as ntt_mod

P = np.uint32(kb.PRIME)
ROWS = 4
TRIPS = (1, 3, 16)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pallas(kernel, shape, n_vmem):
    call = jkb._looped_pallas(kernel, (shape, jnp.uint32), n_vmem,
                              interpret=True)
    return jax.jit(lambda loops, *ops: call(jnp.full((1,), loops, jnp.int32),
                                            *ops))


@functools.lru_cache(maxsize=None)
def _jax_ntt(direction: str, n: int):
    """JAX bench_ntt's body at prime PRIMES32[0] (lazy, < 2p)."""
    tabs = jpk._get_tables(n, 4)
    tab_arrays = [jnp.asarray(getattr(tabs, nm)) for nm in jkb._TAB_NAMES]
    log_n = n.bit_length() - 1
    step = {"fwd": jpk._fwd_ntt, "inv": jpk._inv_ntt}[direction]

    def kernel(n_ref, x_ref, *refs):
        tabs_c = {nm: r[:] for nm, r in zip(jkb._TAB_NAMES, refs[:-1])}
        refs[-1][:] = lax.fori_loop(
            0, n_ref[0],
            lambda i, x: step(x, 0, tabs_c, P, np.uint32(2 * int(P)), log_n),
            x_ref[:])

    fn = _pallas(kernel, (ROWS, n), 1 + len(tab_arrays))
    return lambda loops, x: np.asarray(fn(loops, x, *tab_arrays)) % P


@functools.lru_cache(maxsize=None)
def _jax_mac(n: int):
    def kernel(n_ref, x_ref, g_ref, gs_ref, o_ref):
        def step(i, x):
            acc = None
            for j in range(kb.MAC_TERMS):
                term = jpk._shoup(x, g_ref[j][None], gs_ref[j][None], P)
                acc = term if acc is None else jpk._condsub(
                    acc + term, np.uint32(2 * int(P)))
            return acc

        o_ref[:] = lax.fori_loop(0, n_ref[0], step, x_ref[:])

    fn = _pallas(kernel, (ROWS, n), 3)
    return lambda loops, *ops: np.asarray(fn(loops, *ops)) % P


@functools.lru_cache(maxsize=None)
def _jax_rotate(n: int):
    log_2n = n.bit_length()

    def kernel(n_ref, x_ref, a_ref, o_ref):
        lane_idx = lax.broadcasted_iota(jnp.uint32, (1, n), 1)
        hi, lo = lax.fori_loop(
            0, n_ref[0],
            lambda i, hl: jpk._negacyclic_rot(hl[0], hl[1], a_ref[:],
                                              lane_idx, log_2n),
            (x_ref[0], x_ref[1]))
        o_ref[0] = hi
        o_ref[1] = lo

    return _pallas(kernel, (2, ROWS, n), 2)


@functools.lru_cache(maxsize=None)
def _jax_decompose(n: int):
    bl, lv = kb.DECOMP_BASE_LOG, kb.DECOMP_LEVELS

    def kernel(n_ref, x_ref, o_ref):
        def step(i, hl):
            hi, lo = hl
            digs = jpk._decompose_u32(hi, lo, bl, lv)
            d = digs[0]
            for dd in digs[1:]:
                d = d + dd
            return hi + d.astype(jnp.uint32), lo

        hi, lo = lax.fori_loop(0, n_ref[0], step, (x_ref[0], x_ref[1]))
        o_ref[0] = hi
        o_ref[1] = lo

    return _pallas(kernel, (2, ROWS, n), 1)


def _u64(hl):
    return (np.asarray(hl[0]).astype(np.uint64) << np.uint64(32)) | hl[1]


def _split(x):
    return np.stack([(x >> np.uint64(32)).astype(np.uint32),
                     (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)])


@pytest.mark.parametrize("trips", TRIPS)
@pytest.mark.parametrize("n", [256, 2048])
@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_ntt_mirror(direction, n, trips):
    x = np.random.default_rng(n + trips).integers(0, int(P), size=(ROWS, n),
                                                  dtype=np.uint32)
    xt = from_u32(x, "cpu")
    got = kb.kb_ntt_mirror(xt, trips, direction == "inv")
    plain = getattr(kb, f"kb_ntt_{direction}_plain")(xt, trips)
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(
        to_u32(got), _jax_ntt(direction, n)(trips, jnp.asarray(x)))


@pytest.mark.parametrize("trips", TRIPS)
@pytest.mark.parametrize("n", [256, 2048])
def test_mac_mirror(n, trips):
    """True Shoup duals on both sides (the JAX bench draws random ones)."""
    rng = np.random.default_rng(n + trips)
    g = rng.integers(0, int(P), size=(kb.MAC_TERMS, n))
    g2 = kb.mac_operands(torch.from_numpy(g))
    x = rng.integers(0, int(P), size=(ROWS, n), dtype=np.uint32)
    xt = from_u32(x, "cpu")
    got = kb.kb_mac_mirror(xt, g2, trips)
    assert torch.equal(got, kb.kb_mac_plain(xt, g2, trips))
    want = _jax_mac(n)(trips, jnp.asarray(x), jnp.asarray(g.astype(np.uint32)),
                       jnp.asarray(to_u32(g2[1])))
    np.testing.assert_array_equal(to_u32(got), want)


@pytest.mark.parametrize("trips", TRIPS)
@pytest.mark.parametrize("n", [256, 2048])
def test_rotate_mirror(n, trips):
    """Every kind of a_row: 0, odd, N (pure negation) and 2N - 1."""
    rng = np.random.default_rng(n + trips)
    x = rng.integers(0, 1 << 64, size=(ROWS, n), dtype=np.uint64)
    a = np.array([0, 2 * int(rng.integers(0, n)) + 1, n, 2 * n - 1])
    xt, at = from_u64(x, "cpu"), torch.from_numpy(a)
    got = kb.kb_rotate_mirror(xt, at, trips)
    assert torch.equal(got, kb.kb_rotate_plain(xt, at, trips))
    want = _jax_rotate(n)(trips, jnp.asarray(_split(x)),
                          jnp.asarray(a.astype(np.uint32)[:, None]))
    np.testing.assert_array_equal(to_u64(got), _u64(np.asarray(want)))


@pytest.mark.parametrize("trips", TRIPS)
@pytest.mark.parametrize("n", [256, 2048])
def test_decompose_mirror(n, trips):
    x = np.random.default_rng(n + trips).integers(0, 1 << 64, size=(ROWS, n),
                                                  dtype=np.uint64)
    xt = from_u64(x, "cpu")
    bl, lv = kb.DECOMP_BASE_LOG, kb.DECOMP_LEVELS
    got = kb.kb_decompose_mirror(xt, bl, lv, trips)
    assert torch.equal(got, kb.kb_decompose_plain(xt, bl, lv, trips))
    want = _jax_decompose(n)(trips, jnp.asarray(_split(x)))
    np.testing.assert_array_equal(to_u64(got), _u64(np.asarray(want)))


@pytest.mark.parametrize("log_n", range(1, 13))
def test_ntt_pass_plan_is_the_step_plan(log_n):
    """kb_ntt's passes split the stages as the step does
    (brk::split_stages): every stage once, at most 3 a pass, larger passes
    first, the forward ones up from stage 0 and the inverse ones down from
    log_n - 1, the twist on the first forward pass and the untwist on the
    last inverse pass; the mirror's transforms at small N and odd row
    counts match the plain versions."""
    fwd, inv = kb.ntt_pass_plan(log_n, False), kb.ntt_pass_plan(log_n, True)
    for plan in (fwd, inv):
        stages = sorted(s for s0, k, _ in plan for s in range(s0, s0 + k))
        assert stages == list(range(log_n))
        sizes = [k for _, k, _ in plan]
        assert max(sizes) <= 3 and sizes == sorted(sizes, reverse=True)
        assert sum(t for *_, t in plan) == 1
    assert [s0 for s0, *_ in fwd] == sorted(s0 for s0, *_ in fwd)
    assert [s0 for s0, *_ in inv] == sorted((s0 for s0, *_ in inv),
                                            reverse=True)
    assert fwd[0][2] and inv[-1][2]
    if log_n <= 4:
        x = kb.micro_inputs("cpu", rows=3, N=1 << log_n, seed=log_n)
        for name, inverse in (("kb_ntt_fwd", False), ("kb_ntt_inv", True)):
            assert torch.equal(kb.kb_ntt_mirror(x[name][0], 3, inverse),
                               getattr(kb, f"{name}_plain")(x[name][0], 3))


def test_elementwise_maps_cover_every_element_once():
    """kb_mac's and kb_decompose's threads own every element once, in 16-byte
    words of one row where N >= 8; below that (and for a short last thread)
    the mirror's scalar path matches the plain version."""
    for rows, n in ((3, 2), (5, 4), (1, 8), (3, 256)):
        e, valid, _ = kb._thread_elements(rows * n, n)
        assert sorted(e[valid].tolist()) == list(range(rows * n))
        x = kb.micro_inputs("cpu", rows=rows, N=n, seed=n)
        assert torch.equal(kb.kb_mac_mirror(*x["kb_mac"], 3),
                           kb.kb_mac_plain(*x["kb_mac"], 3))
        assert torch.equal(kb.kb_decompose_mirror(*x["kb_decompose"], 3),
                           kb.kb_decompose_plain(*x["kb_decompose"], 3))


def test_micro_pipe_instructions_are_the_radix2_units():
    """The yardstick of the redesign is the first design's work floor: the
    SASS_OPS rows of the micro-kernels and micro_pipe_instructions over
    them, unchanged, while SASS_LOOP_TOTALS pins the new loops."""
    assert kb.SASS_OPS["kb_ntt_fwd"] == {"twist": (2, 4.5, 0),
                                         "fwd_butterfly": (5, 6.5, 0)}
    assert kb.SASS_OPS["kb_ntt_inv"] == {"inv_butterfly": (7, 7.5, 0),
                                         "twist": (2, 4.5, 0)}
    assert kb.SASS_OPS["kb_mac"] == {"mac": (5, 4.5, 0)}
    assert kb.SASS_OPS["kb_rotate"] == {"element": (7, 5, 0)}
    assert kb.SASS_OPS["kb_decompose"] == {"element": (18, 3, 3)}
    bf = 1024 * 11  # butterflies of a transform at N = 2048
    want = {"kb_ntt_fwd": max(2 * 2048 + 5 * bf, 4.5 * 2048 + 6.5 * bf),
            "kb_ntt_inv": max(2 * 2048 + 7 * bf, 4.5 * 2048 + 7.5 * bf),
            "kb_mac": 5 * 2048 * kb.MAC_TERMS, "kb_rotate": 7 * 2048,
            "kb_decompose": 15 * 2048}
    for name, per_row_trip in want.items():
        assert kb.micro_pipe_instructions(name, 528, 2048, 16) == \
            528 * 16 * per_row_trip
    assert (kb.N_BENCH, kb.PRIME, kb.MAC_TERMS, kb.DECOMP_BASE_LOG,
            kb.DECOMP_LEVELS, kb.LOOPS, kb.KB_CHECK_LOOPS) == (
        2048, ntt_mod.PRIMES32[0], 2, 23, 1, (256, 4096), 16)
    assert {k: v[1] for k, v in kb.SASS_LOOP_TOTALS.items()
            if k in want} == {
        "kb_ntt_fwd": "kb_ntt_kernelILb0ELi11E",
        "kb_ntt_inv": "kb_ntt_kernelILb1ELi11E",
        "kb_mac": "kb_mac_kernelILi2E", "kb_rotate": "kb_rotate_kernelILi11E",
        "kb_decompose": "kb_decompose_kernel"}
