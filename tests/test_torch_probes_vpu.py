"""The VPU-primitive probes of the port (``tfhe_tpu_torch/tools/
vpu_primitives.py``) against ``tools/vpu_primitives.py``'s case bodies.

The JAX probe runs every case when it is imported, so each body is rebuilt
here, formula for formula, from ``tfhe_tpu.ops.pbs_kernel``'s functions and
the probe's own helpers, and run through ``pallas_call(..., interpret=True)``
on the same numpy tile at each case's check trips and values (3 trips
below P0, the JAX tile, but where that tile cannot tell a wrong kernel);
each plain version must equal it exactly, and the check must be able to
fail. ``pk._shoup`` runs in its exact mode (the formula the CUDA cases
mirror with ``__umulhi``); its default approximate mode is held mod p.
Tiles are [8, 256], but the ``run_case3d`` layout, whose [16, 16, 128] tile
is rows of N = 2048. Also: CPU tensors take the plain versions (launch
counts stay 0), the entry point needs a GPU, and the IMAD.WIDE verdict and
the opcode check read the rows and a hand-written SASS listing."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from tfhe_tpu.ops import kernel_bench as jkb
from tfhe_tpu.ops import pbs_kernel as jpk

from tfhe_tpu_torch import sass_loops
from tfhe_tpu_torch._torus import from_u32, to_u32
from tfhe_tpu_torch.tools import _harness as h
from tfhe_tpu_torch.tools import vpu_primitives as vpu

U32 = jnp.uint32
LOOPS = 3
P0, W = np.uint32(vpu.P0), np.uint32(vpu.W)
WSH = np.uint32(vpu.WSH)
P16, W16, W16SH = np.uint32(vpu.P16), np.uint32(vpu.W16), np.uint32(vpu.W16SH)
MASK16 = np.uint32(0xFFFF)


def _looped(body, x, loops=LOOPS):
    def kernel(n_ref, x_ref, o_ref):
        o_ref[:] = lax.fori_loop(0, n_ref[0], lambda i, v: body(v), x_ref[:])

    call = jkb._looped_pallas(kernel, (x.shape, jnp.uint32), 1, interpret=True)
    return np.asarray(call(jnp.full((1,), loops, jnp.int32), jnp.asarray(x)))


# the JAX probe's own helpers, as tools/vpu_primitives.py:107-151 write them
def _shoup16(a, w, wsh, p):
    q = (a * wsh) >> np.uint32(16)
    return a * w - q * p


def _mulhi_4mullo(a, wsh_hi, wsh_lo):
    a1 = a >> np.uint32(16)
    a0 = a & np.uint32(0xFFFF)
    m = a1 * wsh_lo + a0 * wsh_hi + ((a0 * wsh_lo) >> np.uint32(16))
    return a1 * wsh_hi + (m >> np.uint32(16))


def _mul_hi_approx(a, b):
    ah = a >> np.uint32(16)
    al = a & np.uint32(0xFFFF)
    bh = b >> np.uint32(16)
    bl = b & np.uint32(0xFFFF)
    return ah * bh + ((al * bh) >> np.uint32(16)) + ((ah * bl) >> np.uint32(16))


def _shoup_approx(a, w, wsh, p):
    q = _mul_hi_approx(a, wsh)
    r = a * w - q * p
    return jpk._condsub(r, np.uint32(2) * p)


# tools/vpu_primitives.py:79-157, by case name
JAX_BODIES = {
    "add": lambda x: x + x,
    "mul_u32": lambda x: x * x,
    "mul_u32_const": lambda x: x * W,
    "shift": lambda x: x >> U32(16),
    "and": lambda x: x & U32(0xFFFF),
    "where_ge": lambda x: jnp.where(x >= P0, x - P0, x),
    "mul_hi": lambda x: jpk._mul_hi(x, x | U32(1)),
    "shoup": lambda x: jpk._shoup(x, W, WSH, P0),
    "shoup_condsub": lambda x: jpk._condsub(jpk._shoup(x, W, WSH, P0), P0),
    "butterfly_mix": lambda x: jpk._condsub(x + x, np.uint32(2) * P0)
    ^ jpk._shoup(x, W, WSH, P0),
    "to_f32_roundtrip": lambda x: (x.astype(jnp.int32).astype(jnp.float32)
                                   + 1.0).astype(jnp.int32).astype(jnp.uint32),
    "mullo16_vals": lambda x: (x & MASK16) * W16,
    "shoup16": lambda x: _shoup16(x & MASK16, W16, W16SH, P16),
    "shoup16_condsub": lambda x: jpk._condsub(
        _shoup16(x & MASK16, W16, W16SH, P16), np.uint32(2) * P16),
    "mul_f32": lambda x: ((x & MASK16).astype(jnp.float32)
                          * 1.5).astype(jnp.uint32),
    "mulhi_4mullo": lambda x: _mulhi_4mullo(
        x, np.uint32(W >> np.uint32(16)), np.uint32(W & np.uint32(0xFFFF))),
    "mulhi_approx": lambda x: _mul_hi_approx(x, x | U32(1)),
    "shoup_approx_2p": lambda x: _shoup_approx(x, W, WSH, P0),
    "shoup_approx_canon": lambda x: jpk._condsub(
        _shoup_approx(x, W, WSH, P0), P0),
}


def _tile(n=256, seed=0, high=P0):
    return np.random.default_rng(seed).integers(0, high, (8, n), np.uint32)


def _plain(name, x, loops=LOOPS):
    return to_u32(vpu.op_plain(name, from_u32(x, "cpu"), loops))


@pytest.mark.parametrize("name", list(JAX_BODIES))
def test_op_plain_equals_jax_case(name, monkeypatch):
    """At the case's check values and trips (those of the kernel's check
    on the card)."""
    monkeypatch.setattr(jpk, "_SHOUP_MODE", "exact")
    high, loops = vpu.check_spec(name)
    x = _tile(high=high)
    np.testing.assert_array_equal(_plain(name, x, loops),
                                  _looped(JAX_BODIES[name], x, loops))


def _wrong_kernels(name, x):
    """Outputs of kernels that are wrong for case ``name`` but easy to
    write by mistake: a copy, zeros, and (shift) the wrong shift count."""
    out = {"copy": x, "zeros": np.zeros_like(x)}
    if name == "shift":
        out.update({f"shift by {k}": x >> np.uint32(k)
                    for k in range(32) if k != 16})
    return out


@pytest.mark.parametrize("name", list(vpu.OPS))
def test_op_check_can_fail(name):
    """The check on the card compares at ``check_spec``: there, the plain
    version differs from a copy, from zeros and, for shift, from every
    other shift count, so no such kernel can pass it. (On the JAX tile at 3
    trips shift is all zeros and where_ge the identity.)"""
    high, loops = vpu.check_spec(name)
    case = {c.name: c for c in vpu.OP_CASES}[name]
    (x,) = case.check_inputs("cpu")
    x = to_u32(x)
    assert case.check == loops and int(x.max()) < high
    want = _plain(name, x, loops)
    for wrong, got in _wrong_kernels(name, x).items():
        assert not np.array_equal(want, got), (name, wrong)


def test_jax_tile_cannot_check_shift_and_where_ge():
    """Why those two cases have check values of their own."""
    x = _tile(2048)
    assert not _plain("shift", x).any()
    np.testing.assert_array_equal(_plain("where_ge", x), x)


def test_shoup_equals_default_approx_mode_mod_p():
    """pk._shoup's default (approximate) mode lands elsewhere in [0, 2p):
    the same residues mod p."""
    assert jpk._SHOUP_MODE == "approx"
    x = _tile(seed=1)
    want = _looped(JAX_BODIES["shoup"], x) % P0
    np.testing.assert_array_equal(_plain("shoup", x) % P0, want)


def test_to_f32_roundtrip_saturates_as_xla():
    """Near 2^31 the f32 value rounds to 2^31, which no int32 holds: XLA
    gives 0x7FFFFFFF (as CUDA's F2I does), torch's CPU cast 0x80000000;
    the plain version follows XLA."""
    x = _tile(seed=2)
    x[0, :6] = [0x7FFFFFFF, 0x7FFFFFC0, 0x7FFFFF80, 0x80000000, 0xFFFFFFFF,
                0x7F000000]
    got = _plain("to_f32_roundtrip", x)
    np.testing.assert_array_equal(got, _looped(JAX_BODIES["to_f32_roundtrip"],
                                               x))
    assert got[0, 0] == 0x7FFFFFFF


def test_hopper_rows():
    """mul_wide is hi ^ lo of the 64-bit product; shoup_ntt_common the
    canonical Shoup product (shoup_condsub); add_mod x + W mod P0."""
    x = _tile(seed=3)
    y = x.astype(np.uint64)
    for _ in range(LOOPS):
        t = y * np.uint64(W)
        y = (t >> np.uint64(32)) ^ (t & np.uint64(0xFFFFFFFF))
    np.testing.assert_array_equal(_plain("mul_wide", x), y)
    np.testing.assert_array_equal(_plain("shoup_ntt_common", x),
                                  _plain("shoup_condsub", x))
    z = x.astype(np.uint64)
    for _ in range(LOOPS):
        z = (z + np.uint64(W)) % np.uint64(P0)
    np.testing.assert_array_equal(_plain("add_mod", x), z)


# run_case3d (tools/vpu_primitives.py:161-216) on its [16, 16, 128] tile
def _stage_like(x):
    G = x.shape[0]
    h_ = G // 2
    u, v = x[:h_], x[h_:]
    return jnp.concatenate([u + v, u - v], axis=0)


def _four_stages(x):
    for st in range(4):
        m = x.shape[0] >> st
        pieces = []
        for b in range(x.shape[0] // m):
            u = x[b * m: b * m + m // 2]
            v = x[b * m + m // 2: (b + 1) * m]
            pieces.append(u + v)
            pieces.append(u - v)
        x = jnp.concatenate(pieces, axis=0)
    return x


@pytest.mark.parametrize("name,body", [
    ("addsub_only", lambda x: (x + x) - (x >> U32(1))),
    ("one_stage_concat", _stage_like),
    ("four_stages_concat", _four_stages)])
def test_case3d_layout(name, body):
    """JAX's x[g, b, l] is coefficient g * 128 + l of row b: the group
    stages are butterfly stages of rows of 2048 at strides N/2 .. N/16."""
    x = np.random.default_rng(4).integers(0, P0, (16, 16, 128), np.uint32)
    want = _looped(body, x)
    rows = lambda a: np.ascontiguousarray(a.transpose(1, 0, 2)).reshape(16,
                                                                         2048)
    case = {c.name: c for c in vpu.STAGE_CASES}[name]
    got = case(from_u32(rows(x), "cpu"), LOOPS)
    np.testing.assert_array_equal(to_u32(got), rows(want))


@pytest.mark.parametrize("log_h", vpu.SWEEP_LOG_H)
def test_stride_sweep_plain(log_h):
    """Each sweep row's plain version is one (u + v, u - v) stage at
    stride 2^log_h per trip; the barrier and __syncwarp rows share it."""
    x = _tile(2048, seed=5)
    hh = 1 << log_h
    y = x.astype(np.uint64)
    for _ in range(LOOPS):
        v = y.reshape(8, -1, 2, hh)
        y = np.stack([v[:, :, 0] + v[:, :, 1],
                      v[:, :, 0] - v[:, :, 1] + np.uint64(1 << 32)],
                     axis=2).reshape(8, 2048) & np.uint64(0xFFFFFFFF)
    by = {c.name: c for c in vpu.STAGE_CASES}
    got = to_u32(by[f"stage_h{hh}_barrier"](from_u32(x, "cpu"), LOOPS))
    np.testing.assert_array_equal(got, y)
    if log_h in vpu.WARP_LOG_H:
        np.testing.assert_array_equal(
            to_u32(by[f"stage_h{hh}_syncwarp"](from_u32(x, "cpu"), LOOPS)),
            got)


def test_cpu_tensors_take_plain_versions():
    vpu.reset_launches()
    for c in vpu.CASES:
        (x,) = c.inputs("cpu")
        assert x.shape == (2, 2048) and torch.equal(x, c.inputs("cpu")[0])
        out = c(x, 1)
        assert out.shape == x.shape and out.dtype == torch.int32
        assert c.launches == 0, c.name
    assert len(vpu.OP_CASES) == 22 and {c.kernel for c in vpu.CASES} <= set(
        vpu.SASS_LOOP_TOTALS)


def test_entry_point_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        vpu.run_all(quick=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        vpu.main([])


def test_imad_wide_verdict():
    rows = [{"metric": "mul_u32", "fma_per_sm_clock": 60.0,
             "fma_per_sm_cycle": 64.0, "card": "c"},
            {"metric": "mul_wide", "fma_per_sm_clock": 30.0,
             "fma_per_sm_cycle": 16.0, "card": "c"}]
    v = vpu.imad_wide_verdict(rows)
    assert (v["ratio"], v["ratio_in_kernel"]) == (0.5, 0.25)


class _ClockedCase:
    """Stands in for a case on the card: blocks 0 and 1 on SM 3, block 1
    starting 20 cycles after block 0; the SM takes 100 + 50 cycles a
    trip for the two."""
    trips = (10, 30)

    def __call__(self, x, loops, clk):
        clk[:, 0] = torch.tensor([1000, 1020])
        clk[:, 1] = 1000 + 100 + 50 * loops
        clk[:, 2] = 3


def test_in_kernel_rates():
    """Instructions per SM cycle from each SM's span of loop cycles: per
    trip 50 cycles for its two blocks of 2048 elements, 1.5 FMA and 0.5
    ALU instructions each."""
    (x,) = vpu.tile("cpu")
    row = {"units_per_loop": x.numel(), "alu_per_unit": 0.5,
           "fma_per_unit": 1.5, "fma_slots_per_unit": 2.0,
           "flex_per_unit": 0.0, "ns_per_loop": 25.0}
    r = vpu.in_kernel_rates(_ClockedCase(), (x,), row)
    assert r == {"sm_cycles_per_trip": 50.0, "blocks_per_sm": 2.0,
                 "sm_mhz": 2000.0, "alu_per_sm_cycle": 0.5 * 2048 * 2 / 50,
                 "fma_per_sm_cycle": 1.5 * 2048 * 2 / 50,
                 "int32_fraction_in_kernel": 2.0 * 2048 * 2 / 50 / 64}


def test_sm_spans():
    """Each SM's span runs from its first block's start to its last
    block's end."""
    clk = torch.tensor([[5, 50, 0], [10, 70, 1], [0, 40, 0], [12, 30, 1]])
    ids, n, spans = vpu.sm_spans(clk)
    assert ids.tolist() == [0, 1] and n.tolist() == [2, 2]
    assert spans.tolist() == [50, 60]


SASS = """
        Function : _ZN12_GLOBAL__N_18vpu_loopINS_9OpMulWideEEEvPKjPjiNS_6ConstsE
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDG.E R2, [R4.64] ;
        /*0020*/                   IMAD.WIDE.U32 R6, R2, c[0x0][0x218], RZ ;
        /*0030*/                   LOP3.LUT R2, R7, R6, RZ, 0x3c, !PT ;
        /*0040*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0050*/                   ISETP.GE.AND P0, PT, R0, c[0x0][0x210], PT ;
        /*0060*/              @!P0 BRA 0x20 ;
        /*0070*/                   STG.E [R4.64], R2 ;
        /*0080*/                   EXIT ;
"""


def test_missing_ops_reads_the_loop_body():
    """A case passes when its kernel's loop holds a data instruction of
    the op it names, and is reported when the body lost it."""
    funcs = {"vpu_primitives": sass_loops.parse(SASS)}
    table = {"mul_wide": ("vpu_primitives", ("9OpMulWideE",), None)}
    case = {c.name: c for c in vpu.OP_CASES}["mul_wide"]
    assert h.missing_ops([case], table, funcs.__getitem__) == []
    folded = {"vpu_primitives": sass_loops.parse(
        SASS.replace("IMAD.WIDE.U32 R6, R2", "MOV R6, R2"))}
    assert h.missing_ops([case], table, folded.__getitem__) == [
        ("mul_wide", ("IMAD.WIDE",))]


WEIGHTED = """
        Function : _Z6kernelPj
        /*0000*/                   LDS R2, [R0] ;
        /*0010*/                   IMAD.HI.U32 R3, R2, R5, RZ ;
        /*0020*/                   IMAD.WIDE.U32 R6, R2, R5, RZ ;
        /*0030*/                   IMAD R4, R3, R5, RZ ;
        /*0040*/                   LOP3.LUT R2, R7, R4, RZ, 0x3c, !PT ;
        /*0048*/                   VIADD R2, R2, 0x1 ;
        /*0050*/                   ISETP.GE.AND P1, PT, R0, R5, PT ;
        /*0060*/              @!P1 BRA 0x0 ;
"""


def test_imad_hi_and_wide_take_more_fma_slots():
    """The IMAD.WIDE verdict (an H100 issues a stream of IMAD.HI or
    IMAD.WIDE at 0.43-0.47 of IMAD's rate, a Shoup multiply's IMAD.HI
    beside two IMADs at no more than 1.93 slots) as sass_loops weighs
    them: three FMA-pipe instructions, four issue slots. VIADD stays an ALU
    instruction that may issue on either pipe (``flex``), as add_mod's row
    showed."""
    (loop,) = sass_loops.loops(sass_loops.parse(WEIGHTED)["_Z6kernelPj"])
    assert (loop["alu"], loop["fma"], loop["fma_slots"], loop["flex"]) == (
        2, 3, 4, 1)
    assert sass_loops.FMA_DOUBLE == ("IMAD.HI", "IMAD.WIDE")
    assert sass_loops.DOUBLE_SLOTS == 1.5
    from tfhe_tpu_torch.ops import kernel_bench as kb

    assert kb.busier_pipe(2, 4, 1) == 4 and kb.busier_pipe(9, 1, 4) == 5


def test_one_rule_bounds_every_kernel(monkeypatch):
    """Every ``SASS_OPS`` row gives (ALU, FMA slots, flex), and the step
    kernels' bound takes the flex instructions off the ALU pipe as the
    probes' does: K1 is ALU-bound, so its VIADDs lower its bound."""
    from tfhe_tpu_torch.ops import kernel_bench as kb

    for kernel, ops in kb.SASS_OPS.items():
        for unit, c in ops.items():
            assert len(c) == 3 and 0 <= c[2] <= c[0], (kernel, unit)
    args = ("blind_rotate_bnf2_acc32", 1, 1, 2, 1, 2048, 2)
    with_flex = kb.step_pipe_instructions(*args)
    monkeypatch.setitem(kb.SASS_OPS, "blind_rotate_bnf2_acc32", {
        u: c[:2] + (0,)
        for u, c in kb.SASS_OPS["blind_rotate_bnf2_acc32"].items()})
    assert with_flex < kb.step_pipe_instructions(*args)
