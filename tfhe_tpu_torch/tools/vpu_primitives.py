"""The VPU-primitive probes on an NVIDIA GPU: the cost of one 32-bit
operation, and of one shared-memory butterfly stage, per element.

Counterpart of ``tools/vpu_primitives.py``::

    python -m tfhe_tpu_torch.tools.vpu_primitives [out.jsonl]

prints one JSON row per case (and appends it to ``out.jsonl``). It runs on
the GPU and raises without one. Nothing is caught: a case that fails fails
the run.

- ``OP_CASES`` (``run_case``, pallas_call at ``tools/vpu_primitives.py:54``):
  the 19 JAX cases by name and formula, on u32 elements held in registers
  (``csrc/vpu_primitives.cu::vpu_loop``), and three Hopper rows:
  ``mul_wide`` (the 32 x 32 -> 64-bit product, IMAD.WIDE.U32, folded as
  hi ^ lo), ``shoup_ntt_common`` and ``add_mod`` (the step kernels' own
  ``brk::shoup_mul`` and ``brk::add_mod``). ``imad_wide_verdict`` divides
  ``mul_wide``'s FMA-pipe issue rate by ``mul_u32``'s (one IMAD).
- ``STAGE_CASES`` (``run_case3d``, pallas_call at ``:170``): the group stages of
  ``:193-216`` as butterfly stages of rows of N = 2048 in shared memory
  (JAX's x[g, b, l] is coefficient g * 128 + l of row b), and a stride
  sweep h = 1 .. 1024 with a block barrier after each stage, and with
  ``__syncwarp`` alone where a warp owns both halves of its pairs (h <= 32).

The tile is the JAX one widened to the card: ``kernel_bench.bench_rows``
rows of 2048 (4 per SM), 8 independent elements per thread. Timing is the
JAX probes' and B6's: two trip counts, their difference over the trips
(``kernel_bench._time_delta``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .._device import resolve_device
from .._torus import M32, from_u32
from ..ops import kernel_bench as kb
from ..ops import pbs_kernel as pk
from . import _harness as h

N = 2048
P0 = 0x3F5A0001
W = 12345677
WSH = (W << 32) // P0
P16, W16 = 40961, 12345
W16SH = (W16 << 16) // P16
MASK16, SH16 = 0xFFFF, 16
ELEMS = 8  # independent elements per thread (csrc kElems)
VPU_THREADS = 256  # threads per block of vpu_loop (csrc kVpuThreads)
SRC = "tools/vpu_primitives.py"
#: the u32 constants of the kernel's Consts, in order
CONSTS = (W, WSH, P0, 2 * P0, MASK16, SH16, 1, W16, W16SH, P16, 2 * P16,
          W >> 16, W & 0xFFFF)


# ---------------------------------------------------------------------------
# the plain versions: u32 arithmetic in int64, wrapped to 32 bits
# ---------------------------------------------------------------------------

def _condsub(x, c):
    return torch.where(x >= c, x - c, x)


def _shoup_lazy(x):
    return (x * W - h.umulhi(x, WSH) * P0) & M32


def _shoup16(x):
    a = x & MASK16
    return (a * W16 - (((a * W16SH) & M32) >> SH16) * P16) & M32


def _mulhi_approx(a, b):
    ah, al, bh, bl = a >> 16, a & MASK16, b >> 16, b & MASK16
    return (ah * bh + (((al * bh) & M32) >> 16)
            + (((ah * bl) & M32) >> 16)) & M32


def _shoup_approx(x):
    return _condsub((x * W - _mulhi_approx(x, WSH) * P0) & M32, 2 * P0)


def _to_f32_roundtrip(x):
    """u32 -> i32 -> f32, + 1.0 (f32), f32 -> i32 -> u32. XLA's f32 -> s32
    convert saturates (2^31 and above give 0x7FFFFFFF; seen in interpret
    mode on the CPU, the reference), CUDA's F2I does too, and torch's CPU
    cast does not (it gives 0x80000000): so clamp in f64 first."""
    i = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.float32) + 1.0
    return i.to(torch.float64).clamp(-(1 << 31), (1 << 31) - 1).to(
        torch.int64) & M32


def _mulhi_4mullo(x):
    a1, a0 = x >> 16, x & MASK16
    wh, wl = W >> 16, W & 0xFFFF
    m = (a1 * wl + a0 * wh + (((a0 * wl) & M32) >> 16)) & M32
    return (a1 * wh + (m >> 16)) & M32


#: name -> (plain function of int64 u32 values, JAX line, required opcodes)
OPS = {
    "add": (lambda x: (x + x) & M32, 79,
            ("IADD3", "LEA", "SHF.L", "IMAD.SHL", "IMAD.IADD")),
    "mul_u32": (lambda x: (x * x) & M32, 80, ("IMAD",)),
    "mul_u32_const": (lambda x: (x * W) & M32, 81, ("IMAD",)),
    "shift": (lambda x: x >> SH16, 82, ("SHF",)),
    "and": (lambda x: x & MASK16, 83, ("LOP3",)),
    "where_ge": (lambda x: _condsub(x, P0), 84,
                 ("ISETP", "SEL", "VIMNMX", "IMNMX")),
    "mul_hi": (lambda x: h.umulhi(x, x | 1), 85, ("IMAD.HI",)),
    "shoup": (_shoup_lazy, 86, ("IMAD.HI",)),
    "shoup_condsub": (lambda x: _condsub(_shoup_lazy(x), P0), 87,
                      ("IMAD.HI",)),
    "butterfly_mix": (lambda x: _condsub((x + x) & M32, 2 * P0)
                      ^ _shoup_lazy(x), 89, ("IMAD.HI",)),
    "to_f32_roundtrip": (_to_f32_roundtrip, 93, ("F2I", "I2F")),
    "mullo16_vals": (lambda x: ((x & MASK16) * W16) & M32, 112, ("IMAD",)),
    "shoup16": (_shoup16, 113, ("IMAD",)),
    "shoup16_condsub": (lambda x: _condsub(_shoup16(x), 2 * P16), 114,
                        ("IMAD",)),
    "mul_f32": (lambda x: ((x & MASK16).to(torch.float32) * 1.5).to(
        torch.int64), 118, ("FMUL", "I2F", "F2I")),
    "mulhi_4mullo": (_mulhi_4mullo, 132, ("IMAD",)),
    "mulhi_approx": (lambda x: _mulhi_approx(x, x | 1), 154, ("IMAD",)),
    "shoup_approx_2p": (_shoup_approx, 155, ("IMAD",)),
    "shoup_approx_canon": (lambda x: _condsub(_shoup_approx(x), P0), 156,
                           ("IMAD",)),
    # Hopper rows (no JAX case): replaces points at the cases they extend
    "mul_wide": (lambda x: (h.umulhi(x, W) ^ (x * W)) & M32, 80,
                 ("IMAD.WIDE",)),
    "shoup_ntt_common": (lambda x: _condsub(_shoup_lazy(x), P0), 86,
                         ("IMAD.HI",)),
    "add_mod": (lambda x: _condsub(x + W, P0), 79, ("IADD3", "VIADD")),
}
#: the Hopper rows, and the JAX case each extends
HOPPER_ROWS = {"mul_wide": "mul_u32", "shoup_ntt_common": "shoup_condsub",
               "add_mod": "add"}

#: the CUDA kernel of each case: csrc Op struct names, in the entry's order
_OP_STRUCTS = ("OpAdd", "OpMulU32", "OpMulU32Const", "OpShift", "OpAnd",
               "OpWhereGe", "OpMulHi", "OpShoup", "OpShoupCondsub",
               "OpButterflyMix", "OpToF32Roundtrip", "OpMullo16Vals",
               "OpShoup16", "OpShoup16Condsub", "OpMulF32", "OpMulhi4Mullo",
               "OpMulhiApprox", "OpShoupApprox2p", "OpShoupApproxCanon",
               "OpMulWide", "OpShoupNttCommon", "OpAddMod")
assert len(_OP_STRUCTS) == len(OPS)


def op_plain(name: str, x: torch.Tensor, loops: int) -> torch.Tensor:
    """``loops`` trips of case ``name`` on u32 values (int32 storage)."""
    f = OPS[name][0]
    y = h.u32(x)
    for _ in range(loops):
        y = f(y)
    return h.to_storage(y)


def stages_plain(x: torch.Tensor, loops: int, log_h0: int,
                 n_stages: int) -> torch.Tensor:
    """``loops`` trips of ``n_stages`` butterfly stages (u + v, u - v) at
    strides 2^log_h0, 2^(log_h0 - 1), ... on rows of u32 (int32 [rows,
    N])."""
    rows, n = x.shape
    y = h.u32(x)
    for _ in range(loops):
        for s in range(n_stages):
            hh = 1 << (log_h0 - s)
            v = y.reshape(rows, n // (2 * hh), 2, hh)
            y = torch.stack([v[:, :, 0] + v[:, :, 1],
                             v[:, :, 0] - v[:, :, 1]], dim=2).reshape(
                                 rows, n) & M32
    return h.to_storage(y)


def addsub_plain(x: torch.Tensor, loops: int) -> torch.Tensor:
    """``loops`` trips of x <- (x + x) - (x >> 1) (addsub_only)."""
    y = h.u32(x)
    for _ in range(loops):
        y = ((y + y) - (y >> 1)) & M32
    return h.to_storage(y)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from .._build import cuda_lib

    lib = cuda_lib("vpu_primitives")
    i, v, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    lib.vpu_case.argtypes = [i, v, v, ll, i, v, ctypes.c_float,
                             ctypes.c_float, v, v]
    lib.vpu_smem_stages.argtypes = [v, v, i, i, i, i, i, i, v]
    lib.vpu_regs_addsub.argtypes = [v, v, ll, i, i, v]
    for e in (lib.vpu_case, lib.vpu_smem_stages, lib.vpu_regs_addsub):
        e.restype = ctypes.c_int
    if lib.vpu_num_cases() != len(_OP_STRUCTS):
        raise RuntimeError("libvpu_primitives: case table mismatch")
    return lib


_CONSTS = (ctypes.c_uint * len(CONSTS))(*CONSTS)


def _launch_op(which: int, name: str):
    def launch(x, loops, clk=None):
        """``clk``: None, or int64 [blocks, 3] for each block's loop start
        and end clock and SM id."""
        h.cuda_operand(name, x, 2)
        out = torch.empty_like(x)
        rc = _lib().vpu_case(which, pk._ptr(x), pk._ptr(out), x.numel(),
                             loops, _CONSTS, 1.0, 1.5,
                             None if clk is None else pk._ptr(clk),
                             pk._stream(x.device))
        pk._raise_on(rc, name)
        return out
    return launch


def _launch_stages(name, log_h0, n_stages, warp_only):
    def launch(x, loops):
        h.cuda_operand(name, x, 2)
        out = torch.empty_like(x)
        rc = _lib().vpu_smem_stages(
            pk._ptr(x), pk._ptr(out), x.shape[0], x.shape[1].bit_length() - 1,
            log_h0, n_stages, int(warp_only), loops, pk._stream(x.device))
        pk._raise_on(rc, name)
        return out
    return launch


def _launch_addsub(x, loops):
    h.cuda_operand("addsub_only", x, 2)
    out = torch.empty_like(x)
    rc = _lib().vpu_regs_addsub(pk._ptr(x), pk._ptr(out), x.numel(), 1, loops,
                                pk._stream(x.device))
    pk._raise_on(rc, "addsub_only")
    return out


def tile(device, rows: int = None, seed: int = 0, high: int = P0):
    """The seeded tile: ``rows`` (default ``kernel_bench.bench_rows``) rows
    of 2048 u32 below ``high`` (P0, as the JAX probe draws them)."""
    dev = torch.device(device)
    rows = rows or kb.bench_rows(dev)
    x = np.random.default_rng(seed).integers(0, high, (rows, N), np.uint32)
    return (from_u32(x, dev),)


#: (values below, trips) of the comparison with the plain version where the
#: JAX tile (below P0, 3 trips) cannot tell a wrong kernel: ``shift`` is 0
#: after two trips, ``where_ge`` the identity below P0
CHECK = {"shift": (1 << 32, 1), "where_ge": (2 * P0, 3)}


def check_spec(name: str) -> tuple:
    return CHECK.get(name, (P0, 3))


def _elements(args):
    return args[0].numel()


def _butterflies(n_stages):
    return lambda args: args[0].numel() // 2 * n_stages


# the one PyTorch call that computes a trip on the timed tile (values < P0
# < 2^31, so int32 storage shifts and compares as u32 would). where_ge's
# stand-in, x mod P0, is another function: it agrees on x < 2 P0 only.
_LIBRARY = {
    "add": lambda x: torch.add(x, x),
    "mul_u32": lambda x: torch.mul(x, x),
    "shift": lambda x: torch.bitwise_right_shift(x, SH16),
    "and": lambda x: torch.bitwise_and(x, MASK16),
    "where_ge": lambda x: torch.remainder(x, P0),
}


def sm_spans(clk: torch.Tensor) -> tuple:
    """Per SM that ran a block: (its blocks, the SM cycles from the first
    block's loop start to the last one's end), from ``clk`` [blocks, 3]
    (start, end, SM id; clock64 counts each SM's own cycles)."""
    sm = clk[:, 2]
    ids = torch.unique(sm)
    spans = torch.stack([clk[sm == i, 1].max() - clk[sm == i, 0].min()
                         for i in ids])
    counts = torch.stack([(sm == i).sum() for i in ids])
    return ids, counts, spans


def in_kernel_rates(case, args, row) -> dict:
    """The pipes' instructions per SM and cycle read inside the kernel, on
    each SM's own clock: per SM, the cycles from its first block's loop
    start to its last one's end (clock64) at the case's two trip counts,
    their difference per trip, over the instructions of its blocks; the
    median over SMs. Neither the max-clock assumption nor the event timing
    enters. ``sm_mhz``: those cycles per trip over the event-timed ns;
    ``int32_fraction_in_kernel``: the busier pipe's bound (in issue slots,
    flex as :func:`kernel_bench.busier_pipe` takes it) over those
    cycles."""
    (x,) = args
    lo, hi = case.trips
    blocks = x.numel() // (VPU_THREADS * ELEMS)
    clk = {k: torch.zeros(blocks, 3, dtype=torch.int64, device=x.device)
           for k in (lo, hi)}
    for k in (lo, hi):
        case(x, k, clk=clk[k])
    (ids_lo, _, span_lo), (ids, n, span_hi) = (sm_spans(clk[lo].cpu()),
                                              sm_spans(clk[hi].cpu()))
    if not torch.equal(ids_lo, ids):
        raise RuntimeError(f"{case.name}: the two runs used other SMs")
    cyc = (span_hi - span_lo).double() / (hi - lo)
    units = row["units_per_loop"] / blocks * n  # per SM and trip
    busier = kb.busier_pipe(row["alu_per_unit"], row["fma_slots_per_unit"],
                            row["flex_per_unit"])
    med = lambda t: t.median().item()
    return {"sm_cycles_per_trip": med(cyc),
            "blocks_per_sm": med(n.double()),
            "sm_mhz": med(cyc) / row["ns_per_loop"] * 1e3,
            "alu_per_sm_cycle": med(row["alu_per_unit"] * units / cyc),
            "fma_per_sm_cycle": med(row["fma_per_unit"] * units / cyc),
            "int32_fraction_in_kernel": med(
                busier * units / cyc / kb.INT32_LANES_PER_SM)}


def _op_case(which: int, name: str) -> h.Case:
    plain, line, required = OPS[name]
    hopper = HOPPER_ROWS.get(name)
    return h.Case(
        name, replaces=f"{SRC}:{line}", mirrors=[hopper or name],
        kernel=name, launch=_launch_op(which, name),
        plain=functools.partial(op_plain, name), inputs=tile,
        units=_elements, unit="element", required=required,
        trips=(1024, 16384), check=check_spec(name)[1],
        check_inputs=(functools.partial(tile, high=check_spec(name)[0])
                      if name in CHECK else None),
        divisor=ELEMS, library=_LIBRARY.get(name), extra=in_kernel_rates,
        note=f"Hopper row beside {hopper}" if hopper else "")


#: one case per JAX op case and Hopper row
OP_CASES = tuple(_op_case(i, n) for i, n in enumerate(OPS))

#: the strides of the sweep (log2) and those that also run with __syncwarp
SWEEP_LOG_H = tuple(range(11))
WARP_LOG_H = tuple(range(6))


def _stage_case(name, log_h0, n_stages, warp_only, mirrors, line):
    return h.Case(
        name, replaces=f"{SRC}:{line}", mirrors=mirrors,
        kernel="stages_warp" if warp_only else "stages_barrier",
        launch=_launch_stages(name, log_h0, n_stages, warp_only),
        plain=functools.partial(stages_plain, log_h0=log_h0,
                                n_stages=n_stages),
        inputs=tile, units=_butterflies(n_stages), unit="butterfly",
        required=("IADD3", "VIADD", "IMAD.IADD"), trips=(256, 4096))


STAGE_CASES = (
    h.Case("addsub_only", replaces=f"{SRC}:214", mirrors=["addsub_only"],
           kernel="addsub", launch=_launch_addsub,
           plain=addsub_plain, inputs=tile,
           units=_elements, unit="element",
           required=("IADD3", "LEA", "IMAD", "SHF"), trips=(1024, 16384),
           divisor=ELEMS),
    _stage_case("one_stage_concat", 10, 1, False, ["one_stage_concat"], 215),
    _stage_case("four_stages_concat", 10, 4, False, ["four_stages_concat"],
                216),
    *(_stage_case(f"stage_h{1 << j}_barrier", j, 1, False,
                  ["one_stage_concat"], 215) for j in SWEEP_LOG_H),
    *(_stage_case(f"stage_h{1 << j}_syncwarp", j, 1, True,
                  ["one_stage_concat"], 215) for j in WARP_LOG_H),
)

CASES = OP_CASES + STAGE_CASES

#: per kernel: its library, the parts of its mangled name, and the (ALU,
#: FMA) data instructions summed over its loops as ``sass_loops`` counted
#: them in the SASS of :data:`kernel_bench.SASS_TOOLKIT` (``sass_drift``
#: holds a build to them)
_TOTALS = {
    "add": (3, 5), "mul_u32": (0, 8), "mul_u32_const": (0, 8),
    "shift": (8, 0), "and": (8, 0), "where_ge": (16, 8), "mul_hi": (8, 8),
    "shoup": (0, 24), "shoup_condsub": (20, 28), "butterfly_mix": (30, 34),
    "to_f32_roundtrip": (24, 0), "mullo16_vals": (8, 8),
    "shoup16": (16, 24), "shoup16_condsub": (32, 32), "mul_f32": (32, 0),
    "mulhi_4mullo": (35, 37), "mulhi_approx": (56, 32),
    "shoup_approx_2p": (51, 53), "shoup_approx_canon": (64, 64),
    "mul_wide": (8, 8), "shoup_ntt_common": (20, 28), "add_mod": (24, 8),
    "stages_barrier": (0, 2), "stages_warp": (0, 2), "addsub": (8, 8)}
SASS_LOOP_TOTALS = {
    **{name: ("vpu_primitives", ("8vpu_loop", f"{len(s)}{s}E"),
              _TOTALS[name]) for name, s in zip(OPS, _OP_STRUCTS)},
    "stages_barrier": ("vpu_primitives", ("11smem_stagesILb0E",),
                       _TOTALS["stages_barrier"]),
    "stages_warp": ("vpu_primitives", ("11smem_stagesILb1E",),
                    _TOTALS["stages_warp"]),
    "addsub": ("vpu_primitives", ("11regs_addsub",), _TOTALS["addsub"]),
}


def reset_launches():
    h.reset(CASES)


def imad_wide_verdict(rows) -> dict:
    """``mul_wide``'s FMA-pipe instructions per SM and clock over
    ``mul_u32``'s: 1.0 when IMAD.WIDE issues at IMAD's rate; by the event
    timing at the max clock, and per SM cycle read in the kernel."""
    by = {r["metric"]: r for r in rows}
    wide, imad = by["mul_wide"], by["mul_u32"]
    return {"metric": "imad_wide_verdict",
            "mul_wide_fma_per_sm_clock": wide["fma_per_sm_clock"],
            "mul_u32_fma_per_sm_clock": imad["fma_per_sm_clock"],
            "ratio": wide["fma_per_sm_clock"] / imad["fma_per_sm_clock"],
            "ratio_in_kernel": wide["fma_per_sm_cycle"]
            / imad["fma_per_sm_cycle"],
            "card": wide["card"]}


def iter_rows(quick: bool = False, device=None):
    """Every case's row (held against its plain version first on the GPU),
    then the IMAD.WIDE verdict. ``quick``: 3 timed runs a point instead of
    5. On the CPU the plain versions run and nothing is timed."""
    dev = resolve_device(device)
    rows = []
    for r in h.iter_rows(CASES, SASS_LOOP_TOTALS, dev, 3 if quick else 5):
        rows.append(r)
        yield r
    if dev.type == "cuda":
        yield imad_wide_verdict(rows)


def run_all(quick: bool = False, device=None) -> list:
    return list(iter_rows(quick, device))


def main(argv=None) -> int:
    return h.main(iter_rows, argv)


if __name__ == "__main__":
    import sys

    sys.exit(main())
