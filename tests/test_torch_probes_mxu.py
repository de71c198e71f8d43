"""The int8 tensor-core probes of the port (``tfhe_tpu_torch/tools/
mxu_probe.py``, ``kernel_experiments.py``) against the case bodies of
``tools/mxu_probe.py`` and ``tools/kernel_experiments.py``.

The JAX probes run every case when they are imported, so each body is
rebuilt here from ``tfhe_tpu.ops.pbs_kernel`` and run through
``pallas_call(..., interpret=True)`` on the same numpy tile (3 trips),
where int8 ``dot_general`` into int32 is exact, and held exactly. E2 also
past its accumulator's wrap (700 trips of a tile whose products align).
Also: the u32 -> int8 conversion, the tensor column of ``sass_loops`` and
the IMMA checks on a hand-written listing, the E rows' mapping onto
``ntt_variants``, CPU tensors taking the plain versions (launch counts stay
0), and the entry points needing a GPU."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from tfhe_tpu.ops import kernel_bench as jkb
from tfhe_tpu.ops import pbs_kernel as jpk

from tfhe_tpu_torch import sass_loops
from tfhe_tpu_torch._torus import to_u32
from tfhe_tpu_torch.tools import _harness as h
from tfhe_tpu_torch.tools import _int8 as q
from tfhe_tpu_torch.tools import kernel_experiments as ke
from tfhe_tpu_torch.tools import mxu_probe as mp
from tfhe_tpu_torch.tools import ntt_variants as nv

U32, I32 = jnp.uint32, jnp.int32
LOOPS = 3
P0, W, WSH = np.uint32(mp.P0), np.uint32(mp.W), np.uint32(mp.WSH)
CASES = {c.name: c for c in mp.CASES}


def _dot(a, b):
    return lax.dot_general(a, b, (((1,), (0,)), ((), ())),
                           preferred_element_type=I32)


# tools/mxu_probe.py:78-143
def _mm(x, w, copies, rows=1):
    L = x.reshape(128, 128).astype(jnp.int8)
    A = jnp.concatenate([L] * copies, axis=-1)
    return _dot(jnp.concatenate([A] * rows, axis=0), w)


def _fold(x, U):
    V = (U[:, :128] + (U[:, 128:256] << I32(8))).astype(U32)
    return x ^ V.reshape(1, -1)[:, :2048] * U32(3)


def _chain(x, k):
    for _ in range(k):
        x = jpk._shoup(x, W, WSH, P0)
    return x


JAX = {
    "matmul_512x512": lambda x, w5, w3: _fold(x, _mm(x, w5, 4)),
    "matmul_384x512": lambda x, w5, w3: _fold(x, _mm(x, w3, 3)),
    "matmul_256r_384x512": lambda x, w5, w3: _fold(x, _mm(x, w3, 3, 2)[:128]),
    "shoup_x8": lambda x, w5, w3: _chain(x, 8),
    "shoup_x16": lambda x, w5, w3: _chain(x, 16),
    "mix_matmul512_shoupx8":
        lambda x, w5, w3: _fold(_chain(x, 8), _mm(x, w5, 4)),
    "mix_2matmul_shoupx16": lambda x, w5, w3: _fold(
        _fold(_chain(x, 16), _mm(x, w5, 4)), _mm(x, w3, 3)),
}


def _looped(body, x, *consts, loops=LOOPS, out=None):
    """run_case's kernel (tools/mxu_probe.py:53-66), interpret mode."""
    def kernel(n_ref, x_ref, *refs):
        c = [r[:] for r in refs[:-1]]
        refs[-1][:] = lax.fori_loop(0, n_ref[0], lambda i, v: body(v, *c),
                                    x_ref[:] if out is None
                                    else jnp.zeros(*out))

    shape = (x.shape, jnp.uint32) if out is None else out
    call = jkb._looped_pallas(kernel, shape, 1 + len(consts), interpret=True)
    return np.asarray(call(jnp.full((1,), loops, jnp.int32), jnp.asarray(x),
                           *map(jnp.asarray, consts)))


@functools.lru_cache(maxsize=None)
def _tile():
    (x,) = mp.tiles("cpu")
    return x[:1]


@pytest.mark.parametrize("name", list(JAX))
def test_probe_plain_equals_jax_case(name):
    assert jpk._SHOUP_MODE == "approx"
    x = _tile()
    want = _looped(JAX[name], to_u32(x[0]), *mp.weights())
    np.testing.assert_array_equal(to_u32(CASES[name](x, LOOPS))[0], want)


@pytest.mark.parametrize("name", ["matmul_512x512", "matmul_384x512",
                                  "matmul_256r_384x512"])
def test_library_is_one_trips_product(name):
    """``library_ms``' call, ``torch._int_mm``, computes one trip's int8
    product of every tile (E2's: L @ W)."""
    (x,) = mp.tiles("cpu")
    w512, w384 = mp.weights()
    k, rows = mp._PRODUCTS[name][0]
    U = mp._product(mp.h.u32(x), w512 if k == 512 else w384, k // 128, rows)
    got = CASES[name].library(x).reshape(U.shape)
    assert torch.equal(got.long(), U)
    L, W_ = ke.e2_inputs("cpu")
    assert torch.equal(ke.E2.library(L, W_).reshape(-1, 128, 128).long(),
                       L.long() @ W_.long())


def test_u32_to_int8_is_the_low_byte():
    """JAX's astype(jnp.int8) of a uint32 keeps the low byte, two's
    complement; ``_int8.i8`` does the same, as the kernel's (int8_t) cast."""
    v = np.array([0, 1, 127, 128, 255, 256, 0x17F, 0x80000080, 0xFFFFFFFF,
                  0x3F5A0000], np.uint32)
    want = np.asarray(jnp.asarray(v).astype(jnp.int8)).astype(np.int64)
    got = q.i8(torch.from_numpy(v.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, v.astype(np.uint8).view(np.int8))


def _e2(l, w, loops):
    """tools/kernel_experiments.py::k_matmul (:96-107): acc from 0."""
    return _looped(lambda acc, l_, w_: acc + _dot(l_, w_), l, l, w,
                   loops=loops, out=((128, 128), jnp.int32))


@pytest.mark.parametrize("loops", [1, LOOPS])
def test_e2_plain_equals_jax_case(loops):
    L, W_ = ke.e2_inputs("cpu")
    got = ke.E2(L, W_, loops).numpy()
    want = np.stack([_e2(L[i].numpy(), W_.numpy(), loops)
                     for i in range(L.shape[0])])
    np.testing.assert_array_equal(got, want)


def test_e2_check_wraps_the_accumulator():
    """The aligned tile adds over 5.1e6 a trip, so ``more_checks``' 700
    trips wrap the int32 accumulator (a saturating kernel would fail), and
    the plain version wraps as the JAX case does."""
    L, W_ = ke.e2_aligned_inputs("cpu")
    (inputs, trips), = ke.E2.more_checks
    assert inputs is ke.e2_aligned_inputs and trips == ke.CHECK_TRIPS
    one = ke.E2(L, W_, 1).numpy().astype(np.int64)
    assert np.abs(one).min() * trips > 2 ** 31
    want = _e2(L[0].numpy(), W_.numpy(), trips)
    np.testing.assert_array_equal(ke.E2(L, W_, trips).numpy()[0], want)
    assert (one[0] * trips != want).any()  # it did wrap


def test_e_rows_run_ntt_variants_cases():
    """E1, E1b, E3, E4, E5 are ntt_variants' kernels under the JAX
    names."""
    names = {c.name for c in nv.CASES}
    assert [m for m, _, _ in ke.E_ROWS] == [
        "transpose_128x128_u32", "relayout_roundtrip_8x2048",
        "sublane_7stages_128x128", "rolled_7stages_8x2048",
        "sliced_4stages_8x2048"]
    assert {n for _, n, _ in ke.E_ROWS} <= names
    rows = ke.run_all(device="cpu")
    assert [r["metric"] for r in rows] == ["int8_matmul_128x512x128"] + [
        m for m, _, _ in ke.E_ROWS]
    assert all(r["timing"] == "not measured" for r in rows)


def test_macs_and_mma_trips():
    """Every MAC the JAX case counts: on the wgmma kernel, 128 m64n128k32 a
    tile-trip for matmul_512x512 (128 * 512 * 512 / (64 * 128 * 32)), in
    4-wgmma bodies; on its mma.sync reference 8192 mma in 8-mma bodies.
    The tables are read once a launch, not once a pass: at most 1/8 of the
    reference's L2 bytes a tile-trip."""
    args = mp.tiles("cpu")
    c = CASES["matmul_512x512"]
    assert c.macs(args) == 2 * 128 * 512 * 512  # two tiles on the CPU
    assert c.mma_trips(args) * 4 == 2 * 128
    assert c.mma_trips(args) * 4 * 64 * 128 * 32 == c.macs(args)
    ref = c.reference
    assert ref.macs(args) == c.macs(args)
    assert ref.mma_trips(args) * 4 * mp.MT == 2 * 8192
    assert ref.mma_trips(args) * 4 * mp.MT * h.MACS_PER_MMA == c.macs(args)
    mix2 = CASES["mix_2matmul_shoupx16"]
    assert mix2.macs(args) == 2 * 128 * (512 + 384) * 512
    assert mix2.reference.l2_bytes(args) == 2 * 4 * (512 + 384) * 512
    for case in mp.SYNC_CASES:
        new = CASES[case.name[:-len("_sync")]]
        assert new.reference is case
        assert new.l2_bytes(args) * 8 <= case.l2_bytes(args)
    assert CASES["shoup_x8"].macs(args) == 0
    L, W_ = ke.e2_inputs("cpu")
    assert ke.E2.macs((L, W_)) == 2 * 128 * 512 * 128
    assert ke.E2.mma_trips((L, W_)) * 16 * h.MACS_PER_MMA == ke.E2.macs(
        (L, W_))


SASS = """
        Function : _ZN12_GLOBAL__N_116mxu_probe_kernelILi0EEEvNS_9ProbeArgsE
        /*0000*/                   MOV R0, RZ ;
        /*0010*/                   LDG.E R4, desc[UR4][R8.64] ;
        /*0020*/                   LDS R2, [R0] ;
        /*0030*/                   IMMA.16832.S8.S8 R12, R2.ROW, R4.COL, R12 ;
        /*0040*/                   IMMA.16832.S8.S8 R16, R2.ROW, R5.COL, R16 ;
        /*0050*/                   IADD3 R0, R0, 0x20, RZ ;
        /*0060*/                   ISETP.GE.AND P0, PT, R0, R7, PT ;
        /*0070*/              @!P0 BRA 0x10 ;
        /*0080*/                   LOP3.LUT R20, R12, R16, RZ, 0x3c, !PT ;
        /*0090*/                   EXIT ;
"""


def test_sass_loops_counts_imma_under_tensor():
    """IMMA is counted in the loop's ``tensor`` column, not on the ALU
    pipe; sass_drift compares (ALU, FMA, tensor) totals."""
    (name, ins), = sass_loops.parse(SASS).items()
    (loop,) = sass_loops.loops(ins)
    assert (loop["alu"], loop["fma"], loop["tensor"]) == (0, 0, 2)
    from tfhe_tpu_torch.ops import kernel_bench as kb

    table = {"mm": ("mxu_probe", ("16mxu_probe_kernelILi0E",), (0, 0, 2))}
    assert kb.sass_drift(lambda lib: SASS, table) == []
    lost = SASS.replace("IMMA.16832.S8.S8 R16, R2.ROW, R5.COL, R16", "NOP")
    assert kb.sass_drift(lambda lib: lost, table) == [
        ("mm", (0, 0, 2), (0, 0, 1))]


def test_missing_ops_and_mma_drift_find_a_lost_imma():
    case = CASES["matmul_512x512"].reference  # the mma.sync kernel
    table = {case.kernel: ("mxu_probe", ("16mxu_probe_kernelILi0E",), None)}
    funcs = {"mxu_probe": sass_loops.parse(SASS)}
    assert h.missing_ops([case], table, funcs.__getitem__) == []
    gone = {"mxu_probe": sass_loops.parse(
        SASS.replace("IMMA.16832.S8.S8", "MOV"))}
    assert h.missing_ops([case], table, gone.__getitem__) == [
        ("matmul_512x512_sync", ("IMMA",))]
    # the listing's body holds 2 mma, the kernel's 8: a quarter issued
    args = mp.tiles("cpu")
    assert h.mma_drift([case], table, "cpu", funcs.__getitem__) == [
        ("matmul_512x512_sync", case.macs(args) // 4, case.macs(args))]
    eight = SASS.replace(
        "        /*0050*/", "".join(
            f"        /*004{i}*/                   IMMA.16832.S8.S8 R{20 + i},"
            f" R2.ROW, R4.COL, R{20 + i} ;\n" for i in range(1, 7))
        + "        /*0050*/")
    full = {"mxu_probe": sass_loops.parse(eight)}
    assert h.mma_drift([case], table, "cpu", full.__getitem__) == []


def test_cpu_tensors_take_plain_versions():
    for mod in (mp, ke):
        mod.reset_launches()
        for c in mod.CASES:
            args = c.inputs("cpu")
            out = c(*args, 1)
            assert out.dtype == torch.int32 and c.launches == 0, c.name
        assert {c.kernel for c in mod.CASES} <= set(mod.SASS_LOOP_TOTALS)


@pytest.mark.parametrize("mod", [mp, ke])
def test_entry_point_needs_a_gpu(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.run_all(quick=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])


WG_SASS = """
        Function : _ZN12_GLOBAL__N_116mxu_probe_kernelILi0EEEvNS_9ProbeArgsE
        /*0000*/                   MOV R0, RZ ;
        /*0010*/                   LDS R2, [R0] ;
        /*0020*/                   WARPGROUP.ARRIVE ;
        /*0030*/                   IGMMA.64x128x32.S8.S8 R24, gdesc[UR4], R24, gsb0 ;
        /*0040*/                   IGMMA.64x128x32.S8.S8 R24, gdesc[UR8], R24, gsb0 ;
        /*0050*/                   IGMMA.64x128x32.S8.S8 R24, gdesc[UR12], R24, gsb0 ;
        /*0060*/                   IGMMA.64x128x32.S8.S8 R24, gdesc[UR16], R24, gsb0 ;
        /*0070*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0080*/                   ISETP.GE.AND P0, PT, R0, R7, PT ;
        /*0090*/              @!P0 BRA 0x20 ;
        /*00a0*/                   HGMMA.64x8x16.F16 RZ, gdesc[URZ], RZ, !UPT, gsb0 ;
        /*00b0*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
        /*00c0*/                   LOP3.LUT R20, R24, R25, RZ, 0x3c, !PT ;
        /*00d0*/                   IADD3 R1, R1, 0x1, RZ ;
        /*00e0*/                   ISETP.GE.AND P1, PT, R1, R6, PT ;
        /*00f0*/              @!P1 BRA 0x10 ;
        /*0100*/                   EXIT ;
"""


def test_sass_loops_counts_igmma_under_tensor():
    """A wgmma (IGMMA, its shape in the opcode) is counted in the loop's
    ``tensor`` column, not on the ALU pipe, with the MACs of its shape;
    an mma.sync keeps 16 * 8 * 32; the commit's HGMMA into RZ counts no
    MAC."""
    (name, ins), = sass_loops.parse(WG_SASS).items()
    inner, outer = sorted(sass_loops.loops(ins), key=lambda r: r["nested"])
    assert (inner["alu"], inner["fma"], inner["tensor"]) == (0, 0, 4)
    assert inner["tensor_ops"] == ["IGMMA.64x128x32.S8.S8"] * 4
    # the commit (an HGMMA into RZ) is a tensor instruction of no product
    assert outer["tensor"] == 1 and outer["tensor_ops"] == []
    assert h.macs_of("IGMMA.64x128x32.S8.S8") == 64 * 128 * 32
    assert h.macs_of("IGMMA.64x256x32.S8.S8") == 64 * 256 * 32
    assert h.macs_of("IMMA.16832.S8.S8") == h.MACS_PER_MMA == 16 * 8 * 32


def test_missing_ops_and_mma_drift_find_a_lost_igmma():
    """The wgmma case names IGMMA; a listing whose loop lost it is found
    by ``missing_ops``, and one whose body issues 3 of its 4 wgmma by
    ``mma_drift`` (two tiles on the CPU: 64 bodies a trip)."""
    case = CASES["matmul_512x512"]
    assert case.required == ("IGMMA",)
    table = {case.kernel: ("mxu_probe", ("16mxu_probe_kernelILi0E",), None)}
    funcs = {"mxu_probe": sass_loops.parse(WG_SASS)}
    args = mp.tiles("cpu")
    assert h.missing_ops([case], table, funcs.__getitem__) == []
    assert h.mma_drift([case], table, "cpu", funcs.__getitem__) == []
    gone = {"mxu_probe": sass_loops.parse(WG_SASS.replace("IGMMA", "MOV"))}
    assert h.missing_ops([case], table, gone.__getitem__) == [
        ("matmul_512x512", ("IGMMA",))]
    three = {"mxu_probe": sass_loops.parse(WG_SASS.replace(
        "IGMMA.64x128x32.S8.S8 R24, gdesc[UR16], R24, gsb0", "NOP"))}
    assert h.mma_drift([case], table, "cpu", three.__getitem__) == [
        ("matmul_512x512", case.macs(args) * 3 // 4, case.macs(args))]
    # an IMMA listing does not stand for the wgmma case
    imma = {"mxu_probe": sass_loops.parse(SASS)}
    assert h.missing_ops([case], table, imma.__getitem__) == [
        ("matmul_512x512", ("IGMMA",))]
