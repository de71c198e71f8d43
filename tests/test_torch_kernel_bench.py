"""The port's micro-benchmarks (``tfhe_tpu_torch/ops/kernel_bench.py``)
against tfhe_tpu's (``tfhe_tpu/ops/kernel_bench.py``), on the same numpy
inputs: each micro-kernel's plain version against the JAX body run through
``_looped_pallas`` in interpret mode for 3 loops at N = 256 and N = 2048 --
the transforms and the Shoup MAC (fed the same true duals) as residues mod
p, the rotation and the decomposition exactly; the timing harness's
physicality gate; the entry point's refusal to run without a GPU; the SASS
loop counter on a hand-written listing."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from tfhe_tpu.ops import kernel_bench as jkb
from tfhe_tpu.ops import pbs_kernel as jpk

from tfhe_tpu_torch import sass_loops
from tfhe_tpu_torch._torus import from_u32, from_u64, to_u32, to_u64
from tfhe_tpu_torch.ops import kernel_bench as kb

LOOPS = 3
P = np.uint32(kb.PRIME)
BT = 8


def _looped(kernel, shape, n_vmem, *operands):
    call = jkb._looped_pallas(kernel, (shape, jnp.uint32), n_vmem,
                              interpret=True)
    return np.asarray(call(jnp.full((1,), LOOPS, jnp.int32), *operands))


@pytest.mark.parametrize("n", [256, 2048])
@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_ntt_plain_matches_looped_pallas(direction, n):
    """JAX bench_ntt's body (prime PRIMES32[0], lazy < 2p) == the plain
    kb_ntt_* mod p."""
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

    x = np.random.default_rng(n).integers(0, int(P), size=(BT, n),
                                          dtype=np.uint32)
    want = _looped(kernel, (BT, n), 1 + len(tab_arrays), jnp.asarray(x),
                   *tab_arrays) % P
    fn = {"fwd": kb.kb_ntt_fwd, "inv": kb.kb_ntt_inv}[direction]
    np.testing.assert_array_equal(to_u32(fn(from_u32(x, "cpu"), LOOPS)),
                                  want)


@pytest.mark.parametrize("n", [256, 2048])
def test_mac_plain_matches_looped_pallas(n):
    """JAX bench_pointwise_mac's body with TRUE Shoup duals (the JAX bench
    draws them at random, so its output is no product mod p) == the plain
    kb_mac mod p."""
    rng = np.random.default_rng(1)
    g = rng.integers(0, int(P), size=(kb.MAC_TERMS, n))
    g2 = kb.mac_operands(torch.from_numpy(g))
    gs = to_u32(g2[1])
    np.testing.assert_array_equal(gs, (g.astype(object) << 32) // int(P))

    def kernel(n_ref, x_ref, g_ref, gs_ref, o_ref):
        def step(i, x):
            acc = None
            for j in range(kb.MAC_TERMS):
                term = jpk._shoup(x, g_ref[j][None], gs_ref[j][None], P)
                acc = term if acc is None else jpk._condsub(
                    acc + term, np.uint32(2 * int(P)))
            return acc

        o_ref[:] = lax.fori_loop(0, n_ref[0], step, x_ref[:])

    x = rng.integers(0, int(P), size=(BT, n), dtype=np.uint32)
    want = _looped(kernel, (BT, n), 3, jnp.asarray(x),
                   jnp.asarray(g.astype(np.uint32)), jnp.asarray(gs)) % P
    got = kb.kb_mac(from_u32(x, "cpu"), g2, LOOPS)
    np.testing.assert_array_equal(to_u32(got), want)


def _u64(hl):
    return (hl[0].astype(np.uint64) << np.uint64(32)) | hl[1]


@pytest.mark.parametrize("n", [256, 2048])
def test_rotate_plain_matches_looped_pallas(n):
    rng = np.random.default_rng(2)
    x = rng.integers(0, 1 << 32, size=(2, BT, n), dtype=np.uint32)
    a = rng.integers(0, 2 * n, size=(BT, 1), dtype=np.uint32)
    a[:2, 0] = [0, n]
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

    want = _u64(_looped(kernel, (2, BT, n), 2, jnp.asarray(x),
                        jnp.asarray(a)))
    got = kb.kb_rotate(from_u64(_u64(x), "cpu"),
                       torch.from_numpy(a[:, 0].astype(np.int64)), LOOPS)
    np.testing.assert_array_equal(to_u64(got), want)


@pytest.mark.parametrize("n", [256, 2048])
def test_decompose_plain_matches_looped_pallas(n):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 32, size=(2, BT, n), dtype=np.uint32)
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

    want = _u64(_looped(kernel, (2, BT, n), 1, jnp.asarray(x)))
    got = kb.kb_decompose(from_u64(_u64(x), "cpu"), bl, lv, LOOPS)
    np.testing.assert_array_equal(to_u64(got), want)


def test_cpu_tensors_take_plain_versions_and_inputs_are_seeded():
    kb.reset_launches()
    a, b = kb.micro_inputs("cpu", rows=3, N=256), kb.micro_inputs(
        "cpu", rows=3, N=256)
    for fn in kb.MICRO_KERNELS:
        args = a[fn.__name__]
        assert all(torch.equal(u, v) for u, v in zip(args, b[fn.__name__])
                   if isinstance(u, torch.Tensor))
        out = fn(*args, 2)
        assert out.shape == args[0].shape and out.dtype == args[0].dtype
        assert fn.launches == 0, fn.__name__
    assert kb.bench_rows("cpu") == 2


def test_checked_per_unit_refuses_nonphysical_deltas():
    assert kb._checked_per_unit(1.0, 3.0, 1e6, "ok", 1e-9, 1e-3) == 2e-6
    for t_lo, t_hi in ((1.0, 0.9), (1.0, 1.0), (0.0, 1e4)):
        with pytest.raises(RuntimeError, match="nonphysical"):
            kb._checked_per_unit(t_lo, t_hi, 1e6, "bad", 1e-9, 1e-3)


def test_entry_point_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        kb.run_all(quick=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        kb.main([])


def test_bounds_cover_every_kernel():
    """Every step-kernel entry (K4 too) and micro-kernel has its SASS
    counts; the busier pipe is the larger count, or half the total."""
    for entry, primes in (("blind_rotate_bnf2_acc32", 2),
                          ("blind_rotate_crt", 3), ("blind_rotate_crt", 4),
                          ("blind_rotate_crt_acc32", 3),
                          ("blind_rotate_crt_acc32", 4),
                          ("blind_rotate_bnf2_u64", 2),
                          ("blind_rotate_goldilocks", 1)):
        one = kb.step_pipe_instructions(entry, 1, 1, 2, 1, 2048, primes)
        assert one > 0
        assert kb.step_pipe_instructions(entry, 3, 5, 2, 1, 2048,
                                         primes) == 15 * one
    for fn in kb.MICRO_KERNELS:
        assert kb.micro_pipe_instructions(fn.__name__, 2, 256, 3) > 0
    assert kb.busier_pipe(10, 4) == 10 and kb.busier_pipe(4, 10) == 10


SASS = """
        Function : _Z6kernelPj
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDC R5, c[0x0][0x220] ;
        /*0020*/                   LDS R2, [R0] ;
        /*0030*/                   IADD3 R6, R0, 0x4, RZ ;
        /*0040*/                   IMAD.HI.U32 R3, R2, R5, RZ ;
        /*0050*/                   ISETP.GE.U32.AND P0, PT, R3, R5, PT ;
        /*0060*/                   SEL R4, R5, RZ, P0 ;
        /*0070*/                   IMAD.IADD R3, R3, 0x1, -R4 ;
        /*0080*/                   STS [R6], R3 ;
        /*0090*/                   ISETP.GE.AND P1, PT, R6, R5, PT ;
        /*00a0*/              @!P1 BRA 0x20 ;
        /*00b0*/                   EXIT ;
"""


def test_sass_loops_counts_data_instructions_by_pipe():
    funcs = sass_loops.parse(SASS)
    (loop,) = sass_loops.loops(funcs["_Z6kernelPj"])
    assert loop["loop"] == "0x20-0xa0" and loop["nested"] == 0
    # IMAD.HI, IMAD.IADD on the FMA pipe; ISETP, SEL on the ALU pipe; the
    # index add and the loop compare are not data
    assert (loop["alu"], loop["fma"], loop["lds"], loop["sts"]) == (2, 2, 1, 1)


def test_sass_drift_finds_a_changed_loop(monkeypatch):
    """sass_drift recounts each bounded kernel's loops in a build's SASS and
    reports the kernels whose (ALU, FMA) totals moved."""
    monkeypatch.setattr(kb, "SASS_LOOP_TOTALS", {
        "k": ("lib", "kernelPj", (2, 2))})
    assert kb.sass_drift(lambda lib: SASS) == []
    changed = SASS.replace("SEL R4, R5, RZ, P0", "SEL R4, R5, RZ, P0 ;\n"
                           "        /*0065*/   LOP3.LUT R4, R4, R3, RZ, "
                           "0xc0, !PT")
    assert kb.sass_drift(lambda lib: changed) == [("k", (2, 2), (3, 2))]
    with pytest.raises(ValueError, match="0 functions"):
        kb.sass_drift(lambda lib: SASS.replace("kernelPj", "otherPj"))
