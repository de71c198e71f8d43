"""The harness the probe modules share: a probe case (a looped CUDA kernel
behind a wrapper that counts its launches, its plain PyTorch version, its
seeded inputs and its units of work), its check against the plain version,
its two-point timing into a JSON row, and the reading of its loop bodies
from the SASS the build leaves beside each library.

A case is called as ``case(*args, loops)``. Given CPU tensors it runs its
plain version; given CUDA tensors it launches its kernel or raises, and
adds one to ``case.launches``.
"""

from __future__ import annotations

import functools
import json
import sys

import torch

from .._device import resolve_device
from .._torus import M32, i64_to_u32, u32_to_i64
from ..ops import kernel_bench as kb
from ..ops import pbs_kernel as pk


class Case:
    """One probe case.

    ``name``: the row's metric; ``replaces``: ``tools/<file>.py:<line>`` of
    the JAX case it mirrors, ``mirrors``: the JAX case names; ``kernel``:
    its key in the module's SASS table (library, parts of the mangled name,
    loop totals); ``launch(*args, loops)``: the CUDA launch on checked CUDA
    tensors; ``plain(*args, loops)``; ``inputs(device)``: the seeded
    arguments before the trip count; ``units(args)``: units of work (named
    ``unit``) per trip over all of them; ``pipes(loops_of_kernel, args)``:
    (ALU, FMA, flex) data instructions per trip, by default the kernel's
    innermost loops with data instructions, each run once per unit, over
    ``divisor`` units per pass (a rule of ``kernel_bench.SASS_OPS`` gives
    the FMA column in issue slots); ``required``: opcode prefixes of which
    the kernel's loops must hold one (the op the case names);
    ``library(*args)``: one PyTorch
    call that computes one trip's function on the same tile, or None;
    ``trips``: the low and high trip counts of the timing, ``check``: the
    trips of the comparison with the plain version, on
    ``check_inputs(device)`` (default: the timed inputs), chosen so that
    the comparison can fail: a body that is the identity or zero on the
    timed tile (where_ge, shift) is checked on values where it is not;
    ``extra(case, args, row)``: more keys of the row, measured after the
    timing (keyword arguments of the launch reach ``launch``);
    ``macs(args)``: the int8 multiply-adds per trip over all inputs (None:
    an INT32 case), ``mma_trips(args)``: the runs per trip of the loop
    bodies that hold the kernel's ``mma`` instructions, over all blocks and
    warps (``mma.sync``) or warpgroups (``wgmma``; every such body holds
    as many), ``l2_bytes(args)``: the bytes a
    trip reads through L2 (a table streamed by every block);
    ``more_checks``: more (inputs(device), trips) comparisons, on values the
    first cannot fail on (an accumulator that must wrap); ``mma``: the
    tensor-core instruction the row names; ``reference``: the case of the
    same function on an earlier kernel (a ``_sync`` reference), checked
    before the row and timed with it in turns (ref, case, case, ref)."""

    def __init__(self, name, *, replaces, mirrors, kernel, launch, plain,
                 inputs, units, unit, required, trips, check=3,
                 check_inputs=None, divisor=1, pipes=None, library=None,
                 extra=None, note="", macs=None, mma_trips=None,
                 l2_bytes=None, more_checks=(),
                 mma="mma.sync.m16n8k32.s8", reference=None):
        self.name, self.replaces, self.mirrors = name, replaces, mirrors
        self.kernel, self._launch, self.plain = kernel, launch, plain
        self.inputs, self.units, self.unit = inputs, units, unit
        self.required, self.trips, self.check = required, trips, check
        self._check_inputs = check_inputs
        self.divisor, self._pipes, self.library = divisor, pipes, library
        self.extra, self.note = extra, note
        self.macs = macs or (lambda args: 0)
        self.mma_trips, self.l2_bytes = mma_trips, l2_bytes
        self.more_checks = more_checks
        self.mma, self.reference = mma, reference
        self.launches = 0

    def __call__(self, *args, **kw):
        if args[0].device.type == "cpu":
            return self.plain(*args)
        out = self._launch(*args, **kw)
        self.launches += 1
        return out

    def check_inputs(self, device):
        """The arguments of the comparison with the plain version."""
        return (self._check_inputs or self.inputs)(device)

    def pipes(self, loops: list, args, key: str = "fma_slots") -> tuple:
        """(ALU, FMA, flex) data instructions per trip over ``args``: the
        FMA count in issue slots (``key="fma"``: in instructions), flex
        the ALU instructions that may issue on either pipe."""
        if self._pipes is not None:
            return self._pipes(loops, args)
        inner = [r for r in loops if r["nested"] == 0 and (r["alu"] + r["fma"])]
        n = self.units(args) / self.divisor
        return tuple(n * sum(r[k] for r in inner)
                     for k in ("alu", key, "flex"))


def glue_pipes(elements):
    """A ``Case.pipes`` of an int8 case: (ALU, FMA, flex) of the innermost
    loops that hold no mma, each body run once per element
    (``elements(args)`` a trip): the elementwise glue, a lower bound of the
    INT32 work (an epilogue inside a product's loop is not counted)."""
    def pipes(loops, args):
        inner = [r for r in loops if r["nested"] == 0 and not r["tensor"]
                 and (r["alu"] + r["fma"])]
        return tuple(elements(args) * sum(r[k] for r in inner)
                     for k in ("alu", "fma_slots", "flex"))
    return pipes


def thread_pipes(threads):
    """A ``Case.pipes`` of a kernel whose trip runs the body of each of its
    loops once in every thread (``threads(args)`` a trip; the loops that
    hold its products run per warpgroup and carry no INT32 data
    instructions): (ALU, FMA, flex) summed over its loops, times the
    threads."""
    def pipes(loops, args):
        return tuple(threads(args) * sum(r[k] for r in loops)
                     for k in ("alu", "fma_slots", "flex"))
    return pipes


def reset(cases):
    for c in cases:
        c.launches = 0


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

def u32(x: torch.Tensor) -> torch.Tensor:
    """int32-stored u32 values -> int64 in [0, 2^32)."""
    return u32_to_i64(x)


def to_storage(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> their low 32 bits in int32 storage."""
    return i64_to_u32(x)


def umulhi(a: torch.Tensor, b) -> torch.Tensor:
    """High word of the 64-bit product of u32 values held in int64."""
    return ((a * b) >> 32) & M32


def cuda_operand(name: str, x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Check a kernel operand: int32 (u32 storage), ``ndim`` dims,
    contiguous, on a CUDA device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    pk._check(x, name, torch.int32, ndim, x.device)
    return x


# ---------------------------------------------------------------------------
# SASS
# ---------------------------------------------------------------------------

def read_sass(lib: str) -> str:
    from .. import _build

    with open(_build.sass_path(lib)) as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def _funcs(lib: str) -> dict:
    from .. import sass_loops

    return sass_loops.parse(read_sass(lib))


def kernel_function(table: dict, kernel: str, funcs_of=_funcs) -> list:
    """The SASS of ``kernel`` of ``table`` ({kernel: (library, part,
    totals)}): its instructions; raises unless exactly one function of its
    library matches."""
    lib, part, _ = table[kernel]
    found = [ins for name, ins in funcs_of(lib).items()
             if kb.name_matches(name, part)]
    if len(found) != 1:
        raise ValueError(f"{kernel}: {len(found)} functions of lib{lib} "
                         f"match {part!r}")
    return found[0]


def kernel_loops(table: dict, kernel: str, funcs_of=_funcs) -> list:
    from .. import sass_loops

    return sass_loops.loops(kernel_function(table, kernel, funcs_of))


def missing_ops(cases, table: dict, funcs_of=_funcs) -> list:
    """The cases whose kernel's loops hold none of the opcodes the case
    names (a loop body folded away, or compiled to something else):
    [(case, required prefixes)]."""
    from .. import sass_loops

    out = []
    for c in cases:
        ins = kernel_function(table, c.kernel, funcs_of)
        data = sass_loops.data_instructions(ins)
        spans = [tuple(int(a, 16) for a in r["loop"].split("-"))
                 for r in sass_loops.loops(ins)]
        ops = {op for addr, _, op, _ in ins
               if (data[addr] or op.startswith(sass_loops.TENSOR))
               and any(lo <= addr <= hi for lo, hi in spans)}
        if not any(o.startswith(req) for o in ops for req in c.required):
            out.append((c.name, c.required))
    return out


#: int8 multiply-adds of one ``mma.sync.m16n8k32`` (one IMMA.16832)
MACS_PER_MMA = 16 * 8 * 32


def macs_of(opcode: str) -> int:
    """The multiply-adds of one tensor-core instruction, from the shape in
    its SASS opcode: ``IGMMA.64x128x32...`` (wgmma: M x N x K), or
    ``IMMA.16832...`` / ``HMMA.1688...`` (mma.sync: m16, n8, then K)."""
    import re

    m = re.search(r"\.(\d+)x(\d+)x(\d+)", opcode)
    if m:
        return int(m.group(1)) * int(m.group(2)) * int(m.group(3))
    m = re.search(r"\.16(8)(\d+)", opcode)
    if m:
        return 16 * 8 * int(m.group(2))
    raise ValueError(f"no shape in tensor-core opcode {opcode!r}")


def mma_drift(cases, table: dict, device="cpu", funcs_of=_funcs) -> list:
    """The int8 cases whose SASS does not issue every MAC the case counts:
    the MACs of the tensor-core instructions of each loop body that holds
    them (each instruction's from its shape, :func:`macs_of`), times
    ``mma_trips``, against ``macs`` (a body the compiler cut short, or
    bodies of unequal MACs): [(case, MACs the SASS issues a trip or None,
    MACs counted)]."""
    from .. import sass_loops

    out = []
    for c in cases:
        if c.mma_trips is None:
            continue
        args = c.inputs(device)
        loops = sass_loops.loops(kernel_function(table, c.kernel, funcs_of))
        per_body = {sum(macs_of(op) for op in r["tensor_ops"])
                    for r in loops if r["tensor_ops"]}
        issued = (per_body.pop() * c.mma_trips(args)
                  if len(per_body) == 1 else None)
        if issued != c.macs(args):
            out.append((c.name, issued, c.macs(args)))
    return out


# ---------------------------------------------------------------------------
# check, time, row
# ---------------------------------------------------------------------------

def check(case, args) -> tuple:
    """The kernel against its plain version on ``args`` (its check inputs)
    at ``case.check`` trips, exactly, after ``case.more_checks``:
    (max_abs_err, plain ms between CUDA events). Raises on any
    difference."""
    for inputs, trips in case.more_checks:
        more = inputs(args[0].device)
        _compare(case, case(*more, trips), case.plain(*more, trips))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    got = case(*args, case.check)
    start.record()
    want = case.plain(*args, case.check)
    end.record()
    end.synchronize()
    return _compare(case, got, want), start.elapsed_time(end)


def _compare(case, got, want) -> float:
    err = (u32(got) - u32(want)).abs().max().item()
    if tuple(got.shape) != tuple(want.shape) or err != 0:
        raise AssertionError(f"{case.name}: kernel != plain version "
                             f"(max_abs_diff {err})")
    return float(err)


def row(case, args, table: dict, iters: int = 3) -> dict:
    """Time ``case`` by the two-point method on ``args`` (CUDA tensors)
    and give its JSON row: ns per trip over all the inputs, ps per unit,
    the loop bodies' data instructions per unit on each INT32 pipe (from
    the build's SASS; the FMA pipe's also in issue slots), the
    instructions per SM and clock each pipe issued, and the busier pipe's
    bound (in issue slots) over the time (``int32_fraction``)."""
    lo, hi = case.trips
    units = case.units(args)

    def per_unit(c):
        return kb._time_delta(lambda k: c(*args, k), lo, hi, units, c.name,
                              1e-16, 1e-6, iters)

    ref = case.reference
    if ref is None:
        per = per_unit(case)
    else:  # in turns: ref, case, case, ref
        turns = [per_unit(c) for c in (ref, case, case, ref)]
        per = (turns[1] + turns[2]) / 2
    rates = kb.card_rates(args[0].device.index or 0)
    loops = kernel_loops(table, case.kernel)
    alu, slots, flex = case.pipes(loops, args)
    fma = case.pipes(loops, args, "fma")[1]
    clocks = per * units * rates["max_sm_mhz"] * 1e6 * rates["sms"]
    out = {"metric": case.name, "mirrors": case.mirrors,
           "replaces": case.replaces, "unit": case.unit,
           "units_per_loop": units, "ns_per_loop": per * units * 1e9,
           "ps_per_unit": per * 1e12, "alu_per_unit": alu / units,
           "fma_per_unit": fma / units, "fma_slots_per_unit": slots / units,
           "flex_per_unit": flex / units,
           "alu_per_sm_clock": alu / clocks, "fma_per_sm_clock": fma / clocks,
           "int32_fraction": kb.busier_pipe(alu, slots, flex) / units / per
           / rates["int32"], "card": rates["card"]}
    macs = case.macs(args)
    if macs:
        out.update(int8_macs_per_loop=macs, int8_mac_per_s=macs / units / per,
                   int8_tensor_fraction=macs / units / per / rates["int8_mac"],
                   mma=case.mma)
    if ref is not None:
        out.update(ps_per_unit_turns=[turns[1] * 1e12, turns[2] * 1e12],
                   sync_ps_per_unit=(turns[0] + turns[3]) / 2 * 1e12,
                   sync_ps_per_unit_turns=[turns[0] * 1e12, turns[3] * 1e12],
                   sync_mma=ref.mma,
                   speedup_over_sync=(turns[0] + turns[3]) / 2 / per)
    if case.l2_bytes is not None:
        out["l2_bytes_per_loop"] = case.l2_bytes(args)
        out["l2_bytes_per_s"] = case.l2_bytes(args) / units / per
    if case.note:
        out["note"] = case.note
    if case.extra is not None:
        out.update(case.extra(case, args, out))
    return out


def cpu_row(case, args) -> dict:
    """A row of a CPU run: the plain version ran 2 trips, nothing was
    timed."""
    case(*args, 2)
    return {"metric": case.name, "mirrors": case.mirrors,
            "replaces": case.replaces, "value": None, "device": "cpu",
            "timing": "not measured"}


def iter_rows(cases, table: dict, device=None, iters: int = 3):
    """Every case's row on its seeded inputs; on the GPU each case (and its
    reference) is held against its plain version on its check inputs
    first. Nothing is caught."""
    dev = resolve_device(device)
    for c in cases:
        args = c.inputs(dev)
        if dev.type == "cpu":
            yield cpu_row(c, args)
            continue
        check(c, c.check_inputs(dev))
        if c.reference is not None:
            check(c.reference, c.check_inputs(dev))
        yield row(c, args, table, iters)


def main(iter_all, argv=None) -> int:
    """Print every row of ``iter_all()`` as a JSON line, and append it to
    ``argv[0]`` when given."""
    argv = sys.argv[1:] if argv is None else argv
    sink = open(argv[0], "a") if argv else None
    try:
        for r in iter_all():
            line = json.dumps(r)
            print(line, flush=True)
            if sink:
                print(line, file=sink, flush=True)
    finally:
        if sink:
            sink.close()
    return 0
