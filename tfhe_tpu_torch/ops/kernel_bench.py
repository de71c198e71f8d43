"""Per-kernel micro-benchmarks of the blind-rotation step on an NVIDIA GPU.

Counterpart of ``tfhe_tpu/ops/kernel_bench.py`` and of its entry point
``bench.py --kernels``::

    python -m tfhe_tpu_torch.ops.kernel_bench [out.jsonl]

prints one JSON row per micro-benchmark (and appends it to ``out.jsonl``
when given). Nothing is caught: a row that fails fails the run.

Five looped micro-kernels (``csrc/kernel_bench.cu``) replace the bodies of
``_looped_pallas`` (``tfhe_tpu/ops/kernel_bench.py:91``), each the card's
ceiling for one primitive of the step, over a run-time trip count: only
``kb_ntt_fwd`` / ``kb_ntt_inv`` (one-prime negacyclic transform) run the
step's own pieces, the passes of K1 and K3 (``csrc/ntt_common.cuh``'s
``split_stages`` plan, ``item_origin``, the swizzled row, and the stages
``fwd_regs_with`` / ``inv_regs_with`` that the step's ``fwd_regs`` /
``inv_regs`` call: up to 3 stages a pass in registers, the twist fused into
the first forward pass, the untwist into the last inverse one), on one row
a block resident in shared memory beside the direction's twiddles, staged
there once a block as (value, dual) pairs where the step reads them with
``__ldg``. ``kb_mac`` (Shoup MAC against two rows of a GGSW row, true
duals, summed as the step's fused pass sums), ``kb_decompose`` (balanced
digits of the hi word, ``HiDecomposer``) and ``kb_rotate`` (negacyclic
rotation of u64 rows) run their primitive alone, where the step fuses it
into a pass: the first two elementwise in registers for all trips, the
rotation through a double-buffered row in shared memory. The bound of each
is the INT32 pipes at the radix-2 loop's work floor (:data:`SASS_OPS`).
Each has a plain PyTorch version, ``*_plain``, and a CPU mirror of its
kernel's index formulas, ``*_mirror``; a wrapper given CPU tensors runs
the plain version, given CUDA tensors it launches the kernel or raises,
and counts its launches in ``launches``.

The step rows time the step kernels themselves: ``bench_step`` K3 (the
exact 4-prime CRT step at 2_2, the counterpart of the legacy step of
``bench_step``), ``bench_step_v6`` K1 (the v6 BNF2 step), each per
ciphertext-step by two step counts, in turns with the same function on
the radix-2 step loop (``fused_step_r2``, ``fused_step_v6_r2``: the
reference kernels ``kb_step_crt_r2`` and ``kb_step_bnf2_acc32_r2`` of
``csrc/kernel_bench.cu``, which no entry point runs; their plain versions
are K3's and K1's); ``bench_keyswitch`` the keyswitch GEMM
(``torch._int_mm``, outside any kernel of the port, as the JAX package
leaves it to XLA); ``bench_ntt_plan`` the port's ``NegacyclicNtt`` at
N = 16384.

Timing: CUDA events around each run, the median or the minimum of a few
runs, and per-unit times by the two-point trip-count method (the time at a
high count minus the time at a low one, over the difference), which
cancels launch and prologue time; a per-unit time outside a physical range
raises. Rates are against the card's own peaks (:func:`card_rates`).
"""

from __future__ import annotations

import ctypes
import functools
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from .._device import resolve_device
from .._torus import M32, from_u32, from_u64, i64_to_u32, srl, u32_to_i64
from . import bnf2 as bnf2_mod
from . import ntt as ntt_mod
from . import pbs_kernel as pk
from ..utils.params import PARAM_MESSAGE_2_CARRY_2_KS_PBS
from .decomp import decompose
from .polynomial import monomial_mul

INT32_LANES_PER_SM = 64  # Hopper SM: 64 lanes on each INT32 pipe
#: dense int8 tensor-core MACs per SM and clock: the H100 SXM data sheet's
#: 1,979 dense INT8 TOPS at 1,830 MHz over 132 SMs (1979e12 / 2 / 132 /
#: 1.83e9 = 4,096)
INT8_MACS_PER_SM_CLOCK = 4096
ROWS_PER_SM = 4  # micro-kernel rows a SM
N_BENCH = 2048
PRIME = ntt_mod.PRIMES32[0]
MAC_TERMS = 2
MAC_MAX_TERMS = 4  # the rows g kb_mac's kernel takes
DECOMP_BASE_LOG, DECOMP_LEVELS = 23, 1
LOOPS = (256, 4096)  # low and high trip counts of the two-point method
KB_CHECK_LOOPS = 16  # passes of a micro-kernel's exactness check

#: data instructions per unit of work as sm_90a runs them, (ALU pipe, FMA
#: pipe, flex), per kernel (a step kernel's Garner tail at P primes as
#: "<entry>/<P>"): the instructions of each loop body that read the loaded
#: data or a value computed from it (index arithmetic, loads, stores,
#: branches and barriers left out), as ``python -m
#: tfhe_tpu_torch.sass_loops`` counts them in the SASS the build leaves
#: beside each library (``_build/lib<name>.sass``; -O3, sm_90a, the
#: toolkit :data:`SASS_TOOLKIT`).
#: An unrolled body is divided by its copies; a step kernel's element loop
#: holds the remainder copies of the level loop (K1, K3: one; K4: three;
#: kb_decompose's first design: three of the digit loop, one of which
#: runs), which are taken out. IMAD in all its forms runs on the FMA pipe;
#: IADD3, ISETP, SEL, LOP3, SHF, LEA, VIADD and the rest on the ALU pipe.
#: The FMA column counts issue slots (``fma_slots``): IMAD.HI and IMAD.WIDE
#: count 1.5 (``sass_loops.DOUBLE_SLOTS``, a floor chosen to fit the
#: ``tools.vpu_primitives`` rows on an H100, not a measured slot cost).
#: ``flex``: the VIADDs among the ALU column, which may issue on either
#: pipe (:func:`busier_pipe`); one rule bounds the step kernels, the
#: micro-kernels and the probes. Units, per step and ciphertext of a step
#: kernel: element (rotate, rot - acc, digit state) per R*N; level (the
#: next digit, its lift into each Z_p and the twist) per l*R*N; forward
#: and inverse butterflies; mac (one Shoup product and its add_mod) per
#: P*R*l*R*N; untwist_tail (the P untwists, the tail, acc +=) per R*N.
#: The step kernels' units are a work floor, read from the radix-2 loop,
#: which ran each unit in a loop of its own: one add_mod and one Shoup
#: product a butterfly or MAC term, and the rotation, digit, lift, twist,
#: untwist and tail each unit needs, as ``csrc/ntt_variants.cu`` bounds its
#: transform variants. K1 and K3 now run several stages a pass with
#: the lift, the MAC and the tail fused into the passes beside them
#: (``ntt_common.cuh``'s StepPasses; the lift recomputes a coefficient's
#: digit once per prime), so their loops no longer split into these units:
#: the bound counts the same work whatever implements it, and only
#: :data:`SASS_LOOP_TOTALS` follows the new loops. The kernel bench's
#: reference loops (``kb_step_*_r2``) are bounded by their step kernel's
#: row (:data:`BOUND_ENTRY`). Recount, and update
#: :data:`SASS_LOOP_TOTALS`, when :func:`sass_drift` finds a change.
SASS_OPS = {
    "blind_rotate_bnf2_acc32": {  # K1, bnf2_c32
        "element": (14.5, 4.5, 2), "level": (15.5, 11.5, 1),
        "fwd_butterfly": (5, 6.5, 0), "mac": (5, 4.5, 0),
        "inv_butterfly": (8, 6.5, 0), "untwist_tail": (12, 16, 1)},
    "blind_rotate_crt/3": {  # K3, garner_c
        "element": (21, 3, 2), "level": (17, 18.5, 1),
        "fwd_butterfly": (5, 6.5, 0), "mac": (5, 4.5, 0),
        "inv_butterfly": (7, 7.5, 0), "untwist_tail": (21, 31, 1)},
    "blind_rotate_crt/4": {
        "element": (20, 5, 2), "level": (20, 23, 1),
        "fwd_butterfly": (5, 6.5, 0), "mac": (5, 4.5, 0),
        "inv_butterfly": (7, 7.5, 0), "untwist_tail": (32, 50.5, 1)},
    "blind_rotate_crt_acc32/3": {  # K3-acc32, garner_c rounded
        "element": (15.5, 4.5, 2), "level": (18.5, 17, 1),
        "fwd_butterfly": (6, 5.5, 0), "mac": (5, 4.5, 0),
        "inv_butterfly": (7, 7.5, 0), "untwist_tail": (22, 31, 1)},
    "blind_rotate_crt_acc32/4": {
        "element": (16, 5, 2), "level": (19, 24, 0),
        "fwd_butterfly": (6, 5.5, 0), "mac": (5, 4.5, 0),
        "inv_butterfly": (8, 6.5, 0), "untwist_tail": (33, 50.5, 1)},
    "blind_rotate_bnf2_u64": {  # K3-bnf2, bnf2_c
        "element": (20, 3, 2.5), "level": (14, 13, 0.5),
        "fwd_butterfly": (5, 6.5, 0), "mac": (5.25, 4.25, 0),
        "inv_butterfly": (8, 6.5, 0), "untwist_tail": (16, 24.5, 0)},
    # K4 (P = 1, u64 Goldilocks arithmetic: a 64 x 64 -> 128-bit product is
    # 7-11 instructions, IMAD.WIDE.U32 fusing a 32 x 32 product with a
    # 64-bit add; the reduction mod p and the canonical select take ~22
    # more, mostly 64-bit compares and selects on the ALU pipe);
    # untwist_tail is the untwist with x + (x >> 32) and acc +=
    "blind_rotate_goldilocks": {
        "element": (14, 3, 2), "level": (34, 12, 1),
        "fwd_butterfly": (39, 14, 0), "mac": (32, 17.5, 0),
        "inv_butterfly": (39, 18.5, 0), "untwist_tail": (23, 14.5, 0)},
    # K6 (the NTT64 PBS over the same field, P = 1): K4's transforms and
    # MAC loops, identical in the SASS; the level loop (4 copies) holds the
    # non-native decomposer's 64-bit digit, its sign and the lift before
    # the twist; the element loop (its 3 remainder copies of the level
    # loop taken out) the rotation with the mod-q negation, g_sub and the
    # sign split with the rounded shift; untwist_tail the untwist and
    # g_add. flex: sass_loops counts no VIADD in these loops
    "blind_rotate_ntt64": {
        "element": (28, 4, 0), "level": (45, 13, 0),
        "fwd_butterfly": (39, 14, 0), "mac": (32, 17.5, 0),
        "inv_butterfly": (39, 18.5, 0), "untwist_tail": (32, 17.5, 0)},
    # K5 (the multi-bit group step at P = 4): K3 P=4's row for the work it
    # shares (the digit state and lift, the transforms, the Shoup MAC term,
    # the untwist and Garner tail; K5's lift has no rotation, so "element"
    # is a floor from above by a few instructions), and r14's own Barrett
    # product with its add_mod, read from its MAC pass loop (per product:
    # 4 IMAD.WIDE.U32, IMAD, IMAD.X, IMAD.IADD, IMAD.MOV; 2 IADD3, 2 SEL,
    # 2 ISETP, a VIADD): "combine" per coef_v x row sum (P*R*N*(2^g-1) a
    # step), "coef" per product building the 2^g-1 coefficients
    # (P*N*(2^g-1-g)). The function's bound (the pair's and r14's rows)
    # counts these units; K5a's and K5b's rows count their own parts of
    # them (K5a the Shoup terms and coefficient products of the bundle,
    # K5b K3's units and one "combine" a MAC term against the bundle)
    "blind_rotate_multi_bit/4": {
        "element": (20, 5, 2), "level": (20, 23, 1),
        "fwd_butterfly": (5, 6.5, 0), "mac": (5, 4.5, 0),
        "inv_butterfly": (7, 7.5, 0), "untwist_tail": (32, 50.5, 1),
        "combine": (7, 10, 1), "coef": (7, 10, 1)},
    # the micro-kernels, per unit of their first design's loops (the
    # radix-2 transform stage by stage, each primitive in shared memory
    # with a barrier a trip): the work floor that bounds their redesign
    "kb_ntt_fwd": {"twist": (2, 4.5, 0), "fwd_butterfly": (5, 6.5, 0)},
    "kb_ntt_inv": {"inv_butterfly": (7, 7.5, 0), "twist": (2, 4.5, 0)},
    "kb_mac": {"mac": (5, 4.5, 0)},  # per element and term
    "kb_rotate": {"element": (7, 5, 0)},
    "kb_decompose": {"element": (18, 3, 3)},  # state, one digit, the add
}

#: the toolkit whose SASS :data:`SASS_OPS` was read from
SASS_TOOLKIT = "Build cuda_12.9.r12.9/compiler.36037853_0"

#: per :data:`SASS_OPS` kernel (and K7's cluster kernel, bounded by K3
#: P=4's row): its library, a part of its mangled name, and
#: (ALU, FMA) data instructions summed over every loop of that kernel, as
#: ``sass_loops.loops`` counted them in the SASS that :data:`SASS_OPS` was
#: read from (the step kernels' rows: in the build of their pass loops,
#: every pass variant of each instantiation; their SASS_OPS units are the
#: work floor above). :func:`sass_drift` recounts them in a fresh build: a
#: change there means the table is stale.
SASS_LOOP_TOTALS = {
    "blind_rotate_bnf2_acc32": ("blind_rotate_bnf2", "Bnf2Tail32E",
                                (2392, 2370)),
    "blind_rotate_crt/3": ("blind_rotate_crt", "10GarnerTailILi3E",
                           (2932, 2848)),
    "blind_rotate_crt/4": ("blind_rotate_crt", "10GarnerTailILi4E",
                           (3437, 3533)),
    "blind_rotate_crt_acc32/3": ("blind_rotate_crt", "12GarnerTail32ILi3E",
                                 (2868, 2889)),
    "blind_rotate_crt_acc32/4": ("blind_rotate_crt", "12GarnerTail32ILi4E",
                                 (3375, 3569)),
    "blind_rotate_bnf2_u64": ("blind_rotate_crt", "8Bnf2TailE", (2606, 2522)),
    # the bench's reference loops (the radix-2 step loop, bounded by their
    # step kernel's SASS_OPS row, BOUND_ENTRY)
    "kb_step_bnf2_acc32_r2": ("kernel_bench", "Bnf2Tail32ELb1E", (119, 92)),
    "kb_step_crt_r2": ("kernel_bench", "10GarnerTailILi4EEELb1E", (119, 110)),
    "blind_rotate_goldilocks": ("blind_rotate_goldilocks",
                                "blind_rotate_goldilocks_kernel", (582, 221)),
    "blind_rotate_ntt64": ("blind_rotate_ntt64", "blind_rotate_ntt64_kernel",
                           (677, 230)),
    # K5 at P = 4: the single-kernel reference r14 at each grouping, K5a at
    # each grouping, K5b (its SASS_OPS row is shared)
    "blind_rotate_multi_bit/4/g2": ("blind_rotate_multi_bit",
                                    "multi_bit_kernelILi4ELi2E", (3178, 3375)),
    "blind_rotate_multi_bit/4/g3": ("blind_rotate_multi_bit",
                                    "multi_bit_kernelILi4ELi3E", (3450, 3649)),
    "blind_rotate_multi_bit/4/g4": ("blind_rotate_multi_bit",
                                    "multi_bit_kernelILi4ELi4E", (3940, 4172)),
    "multi_bit_keybundle/4/g2": ("blind_rotate_multi_bit",
                                 "keybundle_kernelILi4ELi2E", (30, 34)),
    "multi_bit_keybundle/4/g3": ("blind_rotate_multi_bit",
                                 "keybundle_kernelILi4ELi3E", (51, 71)),
    "multi_bit_keybundle/4/g4": ("blind_rotate_multi_bit",
                                 "keybundle_kernelILi4ELi4E", (91, 128)),
    "multi_bit_accumulate/4": ("blind_rotate_multi_bit",
                               "accumulate_kernelILi4E", (3353, 3599)),
    # K7's cluster kernel, classic u64 at P = 4 (the 3_3 step; its bound
    # stays the function's: K3 P=4's SASS_OPS row, chip_smoke.step_bound)
    "blind_rotate_wide_cluster/4": ("blind_rotate_wide",
                                    ("wide_cluster_kernel",
                                     "10GarnerTailILi4EEELb0ELi1E"),
                                    (1062, 1162)),
    # the same kernel at split 2 (the 4_4 step: N = 32768, N = 16384 at
    # l = 3), classic u64 at P = 4
    "blind_rotate_wide_split/4": ("blind_rotate_wide",
                                  ("wide_cluster_kernel",
                                   "10GarnerTailILi4EEELb0ELi2E"),
                                  (1255, 1340)),
    # the micro-kernels as redesigned (their SASS_OPS units stay the
    # radix-2 loop's work floor): the transform and the rotation at N =
    # 2048, kb_mac at 2 rows
    "kb_ntt_fwd": ("kernel_bench", "kb_ntt_kernelILb0ELi11E", (216, 272)),
    "kb_ntt_inv": ("kernel_bench", "kb_ntt_kernelILb1ELi11E", (288, 296)),
    "kb_mac": ("kernel_bench", "kb_mac_kernelILi2E", (72, 72)),
    "kb_rotate": ("kernel_bench", "kb_rotate_kernelILi11E", (35, 9)),
    "kb_decompose": ("kernel_bench", "kb_decompose_kernel", (344, 48)),
}


def name_matches(name: str, part) -> bool:
    """Whether a mangled kernel name holds ``part`` (a string, or a tuple
    of strings that must all occur)."""
    parts = (part,) if isinstance(part, str) else part
    return all(p in name for p in parts)


def sass_drift(read_sass, totals: dict = None) -> list:
    """The kernels whose loops in the SASS of a build differ from
    ``totals`` (default :data:`SASS_LOOP_TOTALS`; {kernel: (library, part
    of its mangled name, (ALU, FMA) or (ALU, FMA, tensor))}): [(kernel,
    recorded totals, counted)], empty when the counts the bounds were read
    from still hold.
    ``read_sass(library)`` gives the SASS text of ``lib<library>.so``. A
    kernel found in no function, or in more than one, raises."""
    from .. import sass_loops

    funcs, out = {}, []
    for kernel, (lib, part, want) in (SASS_LOOP_TOTALS if totals is None
                                     else totals).items():
        if lib not in funcs:
            funcs[lib] = sass_loops.parse(read_sass(lib))
        found = [ins for name, ins in funcs[lib].items()
                 if name_matches(name, part)]
        if len(found) != 1:
            raise ValueError(f"{kernel}: {len(found)} functions of lib{lib} "
                             f"match {part!r}")
        loops = sass_loops.loops(found[0])
        got = tuple(sum(r[k] for r in loops)
                    for k in ("alu", "fma", "tensor")[:len(want)])
        if got != want:
            out.append((kernel, want, got))
    return out


def busier_pipe(alu: float, fma: float, flex: float = 0) -> float:
    """Instructions on one 64-lane pipe: the ALU and FMA pipes run side
    by side, at most 128 instructions per SM and clock in all, so the time
    is the busier pipe's, or half the total when that is more. ``flex`` of
    the ALU instructions may issue on either pipe."""
    return max(alu - flex, fma, (alu + fma) / 2)


#: the SASS_OPS row that bounds each reference step loop of the bench
BOUND_ENTRY = {"kb_step_bnf2_acc32_r2": "blind_rotate_bnf2_acc32",
               "kb_step_crt_r2": "blind_rotate_crt"}


def _pipes(kernel: str, units: dict) -> float:
    ops = SASS_OPS[kernel]
    return busier_pipe(*(sum(u * ops[k][i] for k, u in units.items())
                         for i in range(3)))


def step_pipe_instructions(kernel: str, B: int, n: int, R: int,
                           levels: int, N: int, P: int) -> float:
    """Busier-pipe instructions of ``B`` ciphertexts times ``n`` steps of a
    blind-rotation kernel (``kernel``: its entry, K1, K3, K3-acc32,
    K3-bnf2, or K4 or K6 at P = 1), at :data:`SASS_OPS`: per step and
    ciphertext R*N elements, l*R*N levels, P*l*R forward and P*R inverse
    transforms of N/2*log2(N) butterflies, P*R*l*R*N MAC products and R*N
    untwists with the tail."""
    kernel = BOUND_ENTRY.get(kernel, kernel)
    key = kernel if kernel in SASS_OPS else f"{kernel}/{P}"
    lR, half_log = levels * R, (N // 2) * (N.bit_length() - 1)
    return float(B) * n * _pipes(key, {
        "element": R * N, "level": lR * N,
        "fwd_butterfly": P * lR * half_log, "mac": P * R * lR * N,
        "inv_butterfly": P * R * half_log, "untwist_tail": R * N})


def multi_bit_pipe_instructions(B: int, n_groups: int, grouping: int,
                                R: int, levels: int, N: int,
                                P: int) -> float:
    """Busier-pipe instructions of ``B`` ciphertexts times ``n_groups``
    group steps of K5 (``blind_rotate_multi_bit``) at :data:`SASS_OPS`:
    per step and ciphertext R*N elements, l*R*N levels, P*l*R forward and
    P*R inverse transforms, P*(2^g-1)*R*l*R*N Shoup MAC terms,
    P*(2^g-1)*R*N products by the coefficients and P*(2^g-1-g)*N products
    building them, R*N untwists with the tail."""
    nsub = (1 << grouping) - 1
    lR, half_log = levels * R, (N // 2) * (N.bit_length() - 1)
    return float(B) * n_groups * _pipes(f"blind_rotate_multi_bit/{P}", {
        "element": R * N, "level": lR * N,
        "fwd_butterfly": P * lR * half_log, "inv_butterfly": P * R * half_log,
        "mac": P * nsub * R * lR * N, "combine": P * nsub * R * N,
        "coef": P * (nsub - grouping) * N, "untwist_tail": R * N})


def multi_bit_keybundle_pipe_instructions(B: int, n_groups: int,
                                          grouping: int, R: int,
                                          levels: int, N: int,
                                          P: int) -> float:
    """Busier-pipe instructions of K5a (``multi_bit_keybundle``) building
    the bundles of ``B`` ciphertexts times ``n_groups`` steps, at K5's
    :data:`SASS_OPS` row: per ciphertext-step P*(2^g-1)*l*R*R*N Shoup terms
    of the bundle and P*(2^g-1-g)*N products building the coefficients."""
    nsub = (1 << grouping) - 1
    return float(B) * n_groups * _pipes(f"blind_rotate_multi_bit/{P}", {
        "mac": P * nsub * R * levels * R * N,
        "coef": P * (nsub - grouping) * N})


def multi_bit_accumulate_pipe_instructions(B: int, n_groups: int, R: int,
                                           levels: int, N: int,
                                           P: int) -> float:
    """Busier-pipe instructions of K5b (``multi_bit_accumulate``) over
    ``B`` ciphertexts times ``n_groups`` steps, at K5's :data:`SASS_OPS`
    row: per ciphertext-step K3's units (R*N elements, l*R*N levels,
    P*l*R forward and P*R inverse transforms, R*N untwists with the tail)
    and P*R*l*R*N MAC terms against the bundle, each a Barrett product
    with its add_mod (the row's "combine")."""
    lR, half_log = levels * R, (N // 2) * (N.bit_length() - 1)
    return float(B) * n_groups * _pipes(f"blind_rotate_multi_bit/{P}", {
        "element": R * N, "level": lR * N,
        "fwd_butterfly": P * lR * half_log, "inv_butterfly": P * R * half_log,
        "combine": P * R * lR * N, "untwist_tail": R * N})


def micro_pipe_instructions(name: str, rows: int, N: int,
                            loops: int) -> float:
    """Busier-pipe instructions of ``loops`` passes of micro-kernel
    ``name`` over ``rows`` rows of N."""
    half_log = (N // 2) * (N.bit_length() - 1)
    per_row = {
        "kb_ntt_fwd": {"twist": N, "fwd_butterfly": half_log},
        "kb_ntt_inv": {"twist": N, "inv_butterfly": half_log},
        "kb_mac": {"mac": N * MAC_TERMS},
        "kb_rotate": {"element": N},
        "kb_decompose": {"element": N},
    }[name]
    return _pipes(name, {k: v * rows * loops for k, v in per_row.items()})


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0].strip()


@functools.lru_cache(maxsize=None)
def card_rates(device_index: int = 0) -> dict:
    """The card's name, SM count, max SM clock and peak rates: ``int32``,
    instructions per second of one 64-lane INT32 pipe on every SM at the
    max SM clock; ``int8_mac``, dense int8 tensor-core MACs per second
    (:data:`INT8_MACS_PER_SM_CLOCK`)."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    mhz = float(_nvidia_smi("clocks.max.sm").split()[0])
    return {"card": torch.cuda.get_device_name(device_index), "sms": sms,
            "max_sm_mhz": mhz,
            "int32": sms * INT32_LANES_PER_SM * mhz * 1e6,
            "int8_mac": sms * INT8_MACS_PER_SM_CLOCK * mhz * 1e6}


def bench_rows(device) -> int:
    """Rows of a micro-kernel run: :data:`ROWS_PER_SM` per SM on a GPU (the
    JAX tiles of 8 or 64 rows fill one TPU core, but would fill 8 of the
    H100's 132 SMs), 2 on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 2
    return ROWS_PER_SM * torch.cuda.get_device_properties(
        dev).multi_processor_count


# ---------------------------------------------------------------------------
# the micro-kernels: plain versions and wrappers
# ---------------------------------------------------------------------------

def _plan1(N: int) -> ntt_mod.NegacyclicNtt:
    """The one-prime plan of the micro-benchmarks (PRIMES32[0])."""
    return ntt_mod.get_plan(N, 1, (PRIME,))


def kb_ntt_fwd_plain(x: torch.Tensor, loops: int) -> torch.Tensor:
    """``loops`` forward negacyclic transforms mod PRIMES32[0] of each row:
    the twist, then the DIF stages (``NegacyclicNtt.fwd_digits``).
    ``x``: int32 [rows, N] residues < p. Returns int32 [rows, N]."""
    plan, y = _plan1(x.shape[-1]), x.to(torch.int64)
    for _ in range(loops):
        y = plan.fwd_digits(y)[0]
    return y.to(torch.int32)


def kb_ntt_inv_plain(x: torch.Tensor, loops: int) -> torch.Tensor:
    """``loops`` inverse transforms (``NegacyclicNtt.inv``, the untwist
    included) of each row; as :func:`kb_ntt_fwd_plain`."""
    plan, y = _plan1(x.shape[-1]), x.to(torch.int64)
    for _ in range(loops):
        y = plan.inv(y[None])[0]
    return y.to(torch.int32)


def mac_operands(g: torch.Tensor, p: int = PRIME) -> torch.Tensor:
    """MAC rows g (int64 [terms, N], residues < p) with their true Shoup
    duals floor(g * 2^32 / p), as the key stores them: int32 (u32)
    [2, terms, N]."""
    return i64_to_u32(torch.stack([g, (g << 32) // p]))


def kb_mac_plain(x: torch.Tensor, g2: torch.Tensor, loops: int) -> torch.Tensor:
    """``loops`` times x <- sum_j x * g_j mod p over the rows of g (the
    residues of :func:`mac_operands`' ``g2``). ``x``: int32 [rows, N]."""
    g = u32_to_i64(g2[0])
    y = x.to(torch.int64)
    for _ in range(loops):
        y = ((y[:, None, :] * g) % PRIME).sum(dim=1) % PRIME
    return y.to(torch.int32)


def kb_rotate_plain(x: torch.Tensor, a: torch.Tensor,
                    loops: int) -> torch.Tensor:
    """``loops`` times x <- x * X^{a_row} (mod X^N + 1) on u64 rows
    (``monomial_mul``). ``x``: int64 [rows, N]; ``a``: [rows] in [0, 2N)."""
    deg = a.to(torch.int64)
    for _ in range(loops):
        x = monomial_mul(x, deg)
    return x


def kb_decompose_plain(x: torch.Tensor, base_log: int, levels: int,
                       loops: int) -> torch.Tensor:
    """``loops`` times hi <- hi + the sum of the balanced digits of the u64
    value (hi, lo) mod 2^32, lo kept (``decompose``; base_log * levels <=
    31, so only hi matters). ``x``: int64 [rows, N]."""
    lo = x & M32
    for _ in range(loops):
        hi = srl(x, 32) + decompose(x, base_log, levels).sum(dim=-1)
        x = ((hi & M32) << 32) | lo
    return x


# ---------------------------------------------------------------------------
# the CPU mirror of the micro-kernels (csrc/kernel_bench.cu)
# ---------------------------------------------------------------------------
#
# Each kernel's index formulas, run on the CPU: the transform's pass plan,
# its items by lane and round, their positions, the swizzled row and the
# runs read as 16-byte words; the elementwise kernels' thread-to-element
# map and 16-byte words; the rotation's words a thread, its source indices
# and negations, and the double buffer. The arithmetic is the plain
# versions' (step_passes' registers), so a wrong index shows against them
# on the CPU.

NTT_THREADS = 256  # kb_ntt's threads, a row a block
EW = 8  # kb_mac's and kb_decompose's elements a thread
ROT_THREADS = 512  # kb_rotate's threads, a row a block


def ntt_pass_plan(log_n: int, inverse: bool) -> tuple:
    """kb_ntt's passes of one transform at N = 2^log_n, in the order they
    run: (first stage, stages, fused twist) each; stages [0, log_n) split as
    the step splits them (``brk::split_stages``, ``step_passes._split``),
    the first forward pass twisting, the last inverse pass untwisting."""
    from . import step_passes as sp

    plan = sp._split(0, log_n, inverse)
    twisting = len(plan) - 1 if inverse else 0
    return tuple((s0, k, i == twisting) for i, (s0, k) in enumerate(plan))


def _lane_rounds(items: int, threads: int):
    """The items of a pass in the order lanes take them: item r * threads +
    lane of round r, the last round cut at ``items``."""
    g = (torch.arange(-(-items // threads))[:, None] * threads
         + torch.arange(threads)).reshape(-1)
    return g[g < items]


def kb_ntt_mirror(x: torch.Tensor, loops: int, inverse: bool) -> torch.Tensor:
    """kb_ntt's index formulas on the CPU: the direction's stage twiddles
    and twist staged as (value, dual) pairs from the flat [8, N] table as
    the kernel stages them (``tw2``, ``tt2``), each row copied in 16-byte
    chunks into its swizzled image, then per trip every pass of
    :func:`ntt_pass_plan`, its items by lane and round at positions i0 + m
    hl (``item_origin``), read as 16-byte chunks where hl = 1, the twist
    from ``tt2`` before the first forward pass's stages, the untwist after
    the last inverse pass's, the stages those of ``fwd_regs_with`` /
    ``inv_regs_with`` on twiddle pairs ``tw2[jj]``. ``x``: int32 [rows, N];
    the result as :func:`kb_ntt_fwd_plain` (or ``_inv``) gives it."""
    from . import step_passes as sp

    N = x.shape[-1]
    log_n = N.bit_length() - 1
    tables = u32_to_i64(torch.from_numpy(pk.plan_tables(_plan1(N)).view(
        "int32")))[0].reshape(-1)
    every = torch.arange(N)
    st, tt = (sp.T_INV, sp.T_UTW) if inverse else (sp.T_FWD, sp.T_TW)
    tw2 = torch.stack([tables[st * N + every], tables[(st + 1) * N + every]],
                      dim=-1)
    tt2 = torch.stack([tables[tt * N + every], tables[(tt + 1) * N + every]],
                      dim=-1)

    def staged(jj):
        return tw2[jj, 0], tw2[jj, 1]

    regs = sp.inv_regs_with if inverse else sp.fwd_regs_with
    img = torch.zeros(x.shape, dtype=torch.int64)
    img[:, sp.swz(every)] = u32_to_i64(x)
    for _ in range(loops):
        for s0, k, twist in ntt_pass_plan(log_n, inverse):
            log_hl = log_n - s0 - k
            g = _lane_rounds(N >> k, NTT_THREADS)
            j = g & ((1 << log_hl) - 1)
            pos = ((((g >> log_hl) << (log_hl + k)) + j)[:, None]
                   + (torch.arange(1 << k) << log_hl))
            phys = sp.swz(pos)
            if not torch.equal(phys.reshape(-1).sort().values, every):
                raise AssertionError(f"pass ({s0}, {k}) misses positions")
            q = min(4, 1 << k)  # words a vector access of lds_run reads
            run = phys.reshape(-1, q)
            if log_hl == 0 and not (
                    torch.equal(run, run[:, :1] + torch.arange(q))
                    and bool((run[:, 0] % q == 0).all())):
                raise AssertionError("a vector access of a run is not whole")
            v = img[:, phys]
            if twist and not inverse:
                v = ntt_mod.shoup_mul(v, tt2[pos, 0], tt2[pos, 1], PRIME)
            v = regs(v, staged, N, s0, k, j, log_hl, PRIME)
            if twist and inverse:
                v = ntt_mod.shoup_mul(v, tt2[pos, 0], tt2[pos, 1], PRIME)
            img[:, phys] = v
    return i64_to_u32(img[:, sp.swz(every)])


def _thread_elements(total: int, N: int):
    """The elementwise kernels' map: thread i owns elements 8i .. 8i + 7
    ([threads, 8], with a mask of those < total); where N >= 8 they are 8
    consecutive positions of one row from a multiple of 8 (the 16-byte
    words)."""
    e = torch.arange(-(-total // EW))[:, None] * EW + torch.arange(EW)
    t = e & (N - 1)
    if N >= EW and not (torch.equal(t, t[:, :1] + torch.arange(EW))
                        and bool((t[:, 0] % EW == 0).all())):
        raise AssertionError("a thread's 8 elements are not one run")
    return e, e < total, t


def kb_mac_mirror(x: torch.Tensor, g2: torch.Tensor,
                  loops: int) -> torch.Tensor:
    """kb_mac's thread-to-element map on the CPU: each thread's 8 elements
    and their positions' rows of g and duals, held over all trips, each trip
    a sum from 0 of the Shoup products with add_mod. As
    :func:`kb_mac_plain`."""
    from . import step_passes as sp

    rows, N = x.shape
    total = rows * N
    e, valid, t = _thread_elements(total, N)
    flat = u32_to_i64(x).reshape(-1)
    v = torch.where(valid, flat[e.clamp(max=total - 1)], 0)
    g = u32_to_i64(g2)
    w, ws = g[0][:, t], g[1][:, t]
    for _ in range(loops):
        acc = torch.zeros_like(v)
        for j in range(g.shape[1]):
            acc = sp._add_mod(acc, ntt_mod.shoup_mul(v, w[j], ws[j], PRIME),
                              PRIME)
        v = acc
    out = flat.clone()
    out[e[valid]] = v[valid]
    return i64_to_u32(out.reshape(rows, N))


def kb_decompose_mirror(x: torch.Tensor, base_log: int, levels: int,
                        loops: int) -> torch.Tensor:
    """kb_decompose's map on the CPU: thread i's four 16-byte words, the u32
    words 16i .. 16i + 15 of the rows (lo, hi, lo, hi, ...), the hi words
    held over all trips, each trip the digits of all 8 states a level at a
    time. As :func:`kb_decompose_plain`."""
    from . import step_passes as sp

    rows, N = x.shape
    total = rows * N
    e, valid, _ = _thread_elements(total, N)
    words = torch.stack([x & M32, srl(x, 32)], dim=-1).reshape(-1)
    w = 2 * e[..., None] + torch.arange(2)  # the thread's (lo, hi) words
    lo = words[w[..., 0].clamp(max=2 * total - 2)]
    hi = words[w[..., 1].clamp(max=2 * total - 1)]
    for _ in range(loops):
        hi = (hi + sum(sp.hi_digits(hi, base_log, levels))) & M32
    out = x.reshape(-1).clone()
    out[e[valid]] = (hi[valid] << 32) | lo[valid]
    return out.reshape(rows, N)


def kb_rotate_mirror(x: torch.Tensor, a: torch.Tensor,
                     loops: int) -> torch.Tensor:
    """kb_rotate's formulas on the CPU: each row copied in as 16-byte pairs
    into one of two buffers, then per trip thread i's words t = i + j *
    ROT_THREADS, each from source t - a_row, + 2N when negative, less N and
    negated when >= N; the result in the buffer the trip count's parity
    leaves it. As :func:`kb_rotate_plain`."""
    rows, N = x.shape
    t = _lane_rounds(N, ROT_THREADS)
    if not torch.equal(t.sort().values, torch.arange(N)):
        raise AssertionError("the threads miss words of the row")
    buf = [x.clone(), torch.zeros_like(x)]
    cur = 0
    for _ in range(loops):
        s = t[None, :] - a.to(torch.int64)[:, None]
        s = s + torch.where(s < 0, 2 * N, 0)
        neg = s >= N
        s = s - torch.where(neg, N, 0)
        v = torch.gather(buf[cur], 1, s)
        buf[cur ^ 1][:, t] = torch.where(neg, -v, v)
        cur ^= 1
    return buf[cur]


@functools.lru_cache(maxsize=None)
def _kb_lib():
    from .._build import cuda_lib

    lib = cuda_lib("kernel_bench")
    i, v = ctypes.c_int, ctypes.c_void_p
    lib.kb_ntt.argtypes = [v, v, v, i, i, ctypes.c_uint, i, i, v]
    lib.kb_mac.argtypes = [v, v, v, i, i, i, ctypes.c_uint, i, v]
    lib.kb_rotate.argtypes = [v, v, v, i, i, i, v]
    lib.kb_decompose.argtypes = [v, v, i, i, i, i, i, v]
    u = ctypes.c_uint
    lib.kb_step_bnf2_acc32_r2.argtypes = [
        v, v, v, v, v, i, i, i, i, i, i, u, u, u, u, u, i, u, v]
    lib.kb_step_crt_r2.argtypes = [v, v, v, v, v, i, i, i, i, i, i, i, v,
                                   ctypes.c_ulonglong, v]
    p = ctypes.POINTER(i)
    lib.kb_occupancy.argtypes = [i, i, p, p, p]
    for entry in (lib.kb_ntt, lib.kb_mac, lib.kb_rotate, lib.kb_decompose,
                  lib.kb_step_bnf2_acc32_r2, lib.kb_step_crt_r2,
                  lib.kb_occupancy):
        entry.restype = ctypes.c_int
    return lib


def _rows_of(name: str, x: torch.Tensor, dtype, loops: int):
    """Check a micro-kernel's rows and trip count; returns (rows, log2 N)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    pk._check(x, "x", dtype, 2, x.device)
    rows, N = x.shape
    if N & (N - 1) or not 2 <= N <= 4096:
        raise ValueError(f"{name}: N={N} is not a power of two in 2..4096")
    if not 0 < rows <= 65535 or loops < 0:
        raise ValueError(f"{name}: rows={rows}, loops={loops}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x is not 16-byte aligned")
    return rows, N.bit_length() - 1


def _ntt(name: str, inverse: int, x: torch.Tensor, loops: int):
    rows, log_n = _rows_of(name, x, torch.int32, loops)
    tables = pk._plan_tables_dev(_plan1(x.shape[1]), str(x.device))
    out = torch.empty_like(x)
    rc = _kb_lib().kb_ntt(pk._ptr(x), pk._ptr(out), pk._ptr(tables), rows,
                          log_n, PRIME, loops, inverse, pk._stream(x.device))
    pk._raise_on(rc, name)
    return out


def kb_ntt_fwd(x: torch.Tensor, loops: int) -> torch.Tensor:
    """Micro-kernel wrapper: see :func:`kb_ntt_fwd_plain`."""
    if x.device.type == "cpu":
        return kb_ntt_fwd_plain(x, loops)
    out = _ntt("kb_ntt_fwd", 0, x, loops)
    kb_ntt_fwd.launches += 1
    return out


def kb_ntt_inv(x: torch.Tensor, loops: int) -> torch.Tensor:
    """Micro-kernel wrapper: see :func:`kb_ntt_inv_plain`."""
    if x.device.type == "cpu":
        return kb_ntt_inv_plain(x, loops)
    out = _ntt("kb_ntt_inv", 1, x, loops)
    kb_ntt_inv.launches += 1
    return out


def kb_mac(x: torch.Tensor, g2: torch.Tensor, loops: int) -> torch.Tensor:
    """Micro-kernel wrapper: see :func:`kb_mac_plain`."""
    if x.device.type == "cpu":
        return kb_mac_plain(x, g2, loops)
    rows, log_n = _rows_of("kb_mac", x, torch.int32, loops)
    pk._check(g2, "g2", torch.int32, 3, x.device)
    if g2.shape[0] != 2 or g2.shape[2] != x.shape[1]:
        raise ValueError(f"g2 shape {tuple(g2.shape)} != [2, terms, "
                         f"{x.shape[1]}]")
    if not 1 <= g2.shape[1] <= MAC_MAX_TERMS or g2.data_ptr() % 16:
        raise ValueError(f"kb_mac: {g2.shape[1]} rows g (the kernel takes "
                         f"1..{MAC_MAX_TERMS}, 16-byte aligned)")
    out = torch.empty_like(x)
    rc = _kb_lib().kb_mac(pk._ptr(x), pk._ptr(out), pk._ptr(g2), rows,
                          g2.shape[1], log_n, PRIME, loops,
                          pk._stream(x.device))
    pk._raise_on(rc, "kb_mac")
    kb_mac.launches += 1
    return out


def kb_rotate(x: torch.Tensor, a: torch.Tensor, loops: int) -> torch.Tensor:
    """Micro-kernel wrapper: see :func:`kb_rotate_plain`."""
    if x.device.type == "cpu":
        return kb_rotate_plain(x, a, loops)
    rows, log_n = _rows_of("kb_rotate", x, torch.int64, loops)
    if tuple(a.shape) != (rows,):
        raise ValueError(f"a shape {tuple(a.shape)} != ({rows},)")
    a32 = a.to(device=x.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(x)
    rc = _kb_lib().kb_rotate(pk._ptr(x), pk._ptr(out), pk._ptr(a32), rows,
                             log_n, loops, pk._stream(x.device))
    pk._raise_on(rc, "kb_rotate")
    kb_rotate.launches += 1
    return out


def kb_decompose(x: torch.Tensor, base_log: int, levels: int,
                 loops: int) -> torch.Tensor:
    """Micro-kernel wrapper: see :func:`kb_decompose_plain`."""
    if x.device.type == "cpu":
        return kb_decompose_plain(x, base_log, levels, loops)
    rows, log_n = _rows_of("kb_decompose", x, torch.int64, loops)
    if not (base_log >= 1 and levels >= 1 and base_log * levels <= 31):
        raise ValueError(f"base_log={base_log}, levels={levels}: the kernel "
                         "decomposes the hi word (base_log*levels <= 31)")
    out = torch.empty_like(x)
    rc = _kb_lib().kb_decompose(pk._ptr(x), pk._ptr(out), rows, base_log,
                                levels, log_n, loops, pk._stream(x.device))
    pk._raise_on(rc, "kb_decompose")
    kb_decompose.launches += 1
    return out


#: ``kb_occupancy``'s index of each micro-kernel
_OCCUPANCY_INDEX = {"kb_ntt_fwd": 0, "kb_ntt_inv": 1, "kb_mac": 2,
                    "kb_rotate": 3, "kb_decompose": 4}


def micro_occupancy(name: str, N: int = N_BENCH) -> dict:
    """Threads a block, resident blocks per SM, registers and local (spill)
    bytes a thread of micro-kernel ``name`` at N (kb_mac at 2 terms).
    Needs the built library and a GPU."""
    t, regs, local = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    blocks = _kb_lib().kb_occupancy(_OCCUPANCY_INDEX[name],
                                    N.bit_length() - 1, ctypes.byref(t),
                                    ctypes.byref(regs), ctypes.byref(local))
    if blocks <= 0:
        raise RuntimeError(f"kb_occupancy {name}: {blocks} at N={N}")
    return {"threads": t.value, "blocks_per_sm": blocks,
            "registers": regs.value, "local_bytes": local.value}


def kb_step_bnf2_acc32_r2(acc_hi: torch.Tensor, msed_mask: torch.Tensor,
                          bsk_scan2: torch.Tensor, base_log: int,
                          levels: int, flavor=None) -> torch.Tensor:
    """The reference step loop of K1's function (the radix-2 loop, the
    bench's ``fused_step_v6_r2``); plain version
    ``pbs_kernel.blind_rotate_bnf2_acc32_plain``."""
    fl = flavor or bnf2_mod.DEFAULT
    if acc_hi.device.type == "cpu":
        return pk.blind_rotate_bnf2_acc32_plain(acc_hi, msed_mask, bsk_scan2,
                                                base_log, levels, fl)
    out = pk.launch_bnf2_acc32(_kb_lib(), "kb_step_bnf2_acc32_r2", acc_hi,
                               msed_mask, bsk_scan2, base_log, levels, fl)
    kb_step_bnf2_acc32_r2.launches += 1
    return out


def kb_step_crt_r2(acc: torch.Tensor, msed_mask: torch.Tensor,
                   bsk_scan: torch.Tensor, base_log: int,
                   levels: int) -> torch.Tensor:
    """The reference step loop of K3's function at P = 4 (the radix-2
    loop, the bench's ``fused_step_r2``); plain version
    ``pbs_kernel.blind_rotate_crt_plain``."""
    if acc.device.type == "cpu":
        return pk.blind_rotate_crt_plain(acc, msed_mask, bsk_scan, base_log,
                                         levels)
    out = pk.launch_crt("kb_step_crt_r2", acc, msed_mask, bsk_scan, base_log,
                        levels, lib=_kb_lib())
    kb_step_crt_r2.launches += 1
    return out


#: the micro-kernel wrappers, each with its ``launches`` count
MICRO_KERNELS = (kb_ntt_fwd, kb_ntt_inv, kb_mac, kb_rotate, kb_decompose)
#: the reference step loops, each with its ``launches`` count
STEP_REFERENCES = (kb_step_bnf2_acc32_r2, kb_step_crt_r2)
for _fn in MICRO_KERNELS + STEP_REFERENCES:
    _fn.launches = 0


def reset_launches():
    """Zero the launch counts of the micro-kernel wrappers and of the
    reference step loops."""
    for fn in MICRO_KERNELS + STEP_REFERENCES:
        fn.launches = 0


def micro_inputs(device, rows: int = None, N: int = N_BENCH,
                 seed: int = 0) -> dict:
    """Seeded inputs of each micro-kernel, by name: the arguments before
    the trip count, for both the wrapper and its plain version."""
    dev = torch.device(device)
    rows = rows or bench_rows(dev)
    rng = np.random.default_rng(seed)
    res = lambda *s: from_u32(rng.integers(0, PRIME, size=s, dtype=np.uint32),
                              dev)
    u64 = lambda *s: from_u64(rng.integers(0, 1 << 64, size=s,
                                           dtype=np.uint64), dev)
    g = torch.from_numpy(rng.integers(0, PRIME, size=(MAC_TERMS, N)))
    a = torch.from_numpy(rng.integers(0, 2 * N, size=rows)).to(dev)
    return {"kb_ntt_fwd": (res(rows, N),), "kb_ntt_inv": (res(rows, N),),
            "kb_mac": (res(rows, N), mac_operands(g).to(dev)),
            "kb_rotate": (u64(rows, N), a),
            "kb_decompose": (u64(rows, N), DECOMP_BASE_LOG, DECOMP_LEVELS)}


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _time_fn(fn, iters: int = 5, reduce: str = "median") -> float:
    """Device seconds of ``fn()`` between CUDA events, after one warm-up
    run: the median of ``iters`` runs, or the minimum (``reduce="min"``,
    for the two-point deltas: the noise of a run is additive and positive,
    so the minimum is the estimator that cannot push t_hi - t_lo below
    0)."""
    fn()
    ts = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) * 1e-3)
    return float(min(ts) if reduce == "min" else statistics.median(ts))


def _checked_per_unit(t_lo: float, t_hi: float, units: float, metric: str,
                      lo_bound: float, hi_bound: float) -> float:
    """(t_hi - t_lo) / units with a physicality gate: a per-unit time
    outside [lo_bound, hi_bound] raises instead of shipping a row."""
    per = (t_hi - t_lo) / units
    if not lo_bound <= per <= hi_bound:
        raise RuntimeError(
            f"{metric}: nonphysical per-unit time {per:.3e} s (t_lo="
            f"{t_lo:.6f} s, t_hi={t_hi:.6f} s, expected [{lo_bound:.1e}, "
            f"{hi_bound:.1e}]): widen the trip counts or re-run")
    return per


def _time_delta(fn, lo: int, hi: int, units_per_loop: float, metric: str,
                lo_bound: float, hi_bound: float, iters: int = 5) -> float:
    """Seconds per unit of ``fn(k)`` (k: the trip count) by the two-point
    method: min-of-``iters`` times at ``lo`` and ``hi``, their difference
    over (hi - lo) * ``units_per_loop``, through :func:`_checked_per_unit`."""
    t_lo = _time_fn(lambda: fn(lo), iters, reduce="min")
    t_hi = _time_fn(lambda: fn(hi), iters, reduce="min")
    return _checked_per_unit(t_lo, t_hi, (hi - lo) * units_per_loop, metric,
                             lo_bound, hi_bound)


def _cpu_row(metric: str, unit: str, batch: int) -> dict:
    """A row of a CPU run: the plain computation ran, nothing was timed."""
    return {"metric": metric, "value": None, "unit": unit, "batch": batch,
            "device": "cpu", "timing": "not measured"}


# ---------------------------------------------------------------------------
# the rows
# ---------------------------------------------------------------------------

def _micro_row(name: str, metric: str, unit: str, units_per_loop: float,
               bounds, device, iters: int) -> dict:
    """Time micro-kernel ``name`` by the two-point method on its seeded
    inputs; on the CPU run its plain version over 2 loops instead."""
    fn = {k.__name__: k for k in MICRO_KERNELS}[name]
    dev = resolve_device(device)
    args = micro_inputs(dev)[name]
    rows = args[0].shape[0]
    if dev.type == "cpu":
        fn(*args, 2)
        return _cpu_row(metric, unit, rows)
    per = _time_delta(lambda k: fn(*args, k), *LOOPS,
                      units_per_loop * rows, metric, *bounds, iters=iters)
    rates = card_rates(dev.index or 0)
    loop_instr = micro_pipe_instructions(name, rows, N_BENCH, 1)
    return {"metric": metric, "value": 1.0 / per, "unit": unit,
            "seconds_per_loop": per * units_per_loop * rows,
            "int32_fraction": loop_instr / (per * units_per_loop * rows)
            / rates["int32"],
            "batch": rows, "card": rates["card"]}


def bench_ntt(direction: str = "fwd", device=None, iters: int = 5) -> dict:
    """One-prime negacyclic transform throughput, N = 2048 (JAX
    ``bench_ntt``): butterflies/s over all rows."""
    half_log = (N_BENCH // 2) * (N_BENCH.bit_length() - 1)
    return _micro_row(f"kb_ntt_{direction}", f"ntt_{direction}_N{N_BENCH}",
                      "butterflies/s", half_log, (1e-15, 1e-7), device, iters)


def bench_pointwise_mac(device=None, iters: int = 5) -> dict:
    """Shoup MAC: x <- sum of x * g_j over 2 rows, one prime (JAX
    ``bench_pointwise_mac``): MAC/s."""
    return _micro_row("kb_mac", "pointwise_shoup_mac", "MAC/s",
                      N_BENCH * MAC_TERMS, (1e-15, 1e-7), device, iters)


def bench_rotate(device=None, iters: int = 5) -> dict:
    """Negacyclic rotation of u64 rows (JAX ``bench_rotate``):
    u64-poly-rotations/s."""
    return _micro_row("kb_rotate", "negacyclic_rotate",
                      "u64-poly-rotations/s", 1, (1e-12, 1e-3), device,
                      iters)


def bench_decompose(device=None, iters: int = 5) -> dict:
    """Balanced decomposition, base_log 23, 1 level (JAX
    ``bench_decompose``): coeff-decomp/s."""
    return _micro_row("kb_decompose", "decompose", "coeff-decomp/s", N_BENCH,
                      (1e-15, 1e-7), device, iters)


def _repeat_steps(key: torch.Tensor, n_steps: int) -> torch.Tensor:
    reps = -(-n_steps // key.shape[0])
    return key.repeat((reps,) + (1,) * (key.ndim - 1))[:n_steps].contiguous()


def _step_rows(metric: str, kernel, reference, key, acc, mask, p,
               lo_steps: int, hi_steps: int, P: int, iters: int,
               extra: dict) -> tuple:
    """Time a step kernel and its reference loop per ciphertext-step by two
    step counts (``key`` and ``mask`` have ``hi_steps`` steps; their first
    ``lo_steps`` make the low point), in turns on the same inputs:
    reference, kernel, kernel, reference. Returns the kernel's row
    (``metric``) and the reference's (``metric``_r2), each at the mean of
    its two timings."""
    B, R, N = acc.shape
    runs = {k: (mask[:, :k].contiguous(), key[:k].contiguous())
            for k in (lo_steps, hi_steps)}

    def fn(kern):
        return lambda k: kern(acc, *runs[k], p.pbs_base_log, p.pbs_level,
                              **extra)

    if acc.device.type == "cpu":
        fn(kernel)(lo_steps)
        fn(reference)(lo_steps)
        return (_cpu_row(metric, "ct-steps/s", B),
                _cpu_row(f"{metric}_r2", "ct-steps/s", B))
    times = {kernel: [], reference: []}
    for kern in (reference, kernel, kernel, reference):
        times[kern].append(_time_delta(fn(kern), lo_steps, hi_steps, B,
                                       metric, 1e-9, 1e-4, iters))
    rates = card_rates(acc.device.index or 0)
    rows = []
    for kern, name in ((kernel, metric), (reference, f"{metric}_r2")):
        per = statistics.mean(times[kern])
        instr = step_pipe_instructions(kern.__name__, 1, 1, R, p.pbs_level,
                                       N, P)
        rows.append({
            "metric": name, "value": 1.0 / per, "unit": "ct-steps/s",
            "seconds_per_ct_step": per,
            "seconds_per_ct_step_runs": times[kern],
            "implied_blind_rotate_pbs_per_s": 1.0 / (per * p.lwe_dimension),
            "int32_fraction": instr / per / rates["int32"],
            "kernel": kern.__name__, "batch": B, "card": rates["card"]})
    return tuple(rows)


def bench_step(params=None, batch: int = 256, lo_steps: int = 16,
               hi_steps: int = 600, device=None, iters: int = 5) -> tuple:
    """K3, the exact 4-prime CRT step (the function of the JAX package's
    legacy ``_build_step_fn``, JAX ``bench_step``), at the 2_2 shape, in
    turns with its reference loop ``kb_step_crt_r2``: the rows
    ``fused_step`` and ``fused_step_r2``, per ciphertext-step seconds by two
    step counts. The key is a valid CRT key (canonical residues per prime,
    true Shoup duals: the transform of a random standard key over 2 steps,
    repeated along the step axis)."""
    from ..core import algorithms as algo
    from ..core.entities import LweBootstrapKey

    p = params or PARAM_MESSAGE_2_CARRY_2_KS_PBS
    dev = resolve_device(device)
    R, N, l = p.glwe_size, p.polynomial_size, p.pbs_level
    if dev.type == "cpu":
        batch, lo_steps, hi_steps = 2, 1, 2
    rng = np.random.default_rng(4)
    std = from_u64(rng.integers(0, 1 << 64, size=(2, l, R, R, N),
                                dtype=np.uint64), dev)
    scan = pk.bsk_to_scan_layout(algo.bootstrap_key_to_ntt(
        LweBootstrapKey(std, p.pbs_base_log, l), 4).residues)
    acc = from_u64(rng.integers(0, 1 << 64, size=(batch, R, N),
                                dtype=np.uint64), dev)
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(batch, hi_steps)))
    return _step_rows("fused_step", pk.blind_rotate_crt, kb_step_crt_r2,
                      _repeat_steps(scan, hi_steps), acc, mask.to(dev), p,
                      lo_steps, hi_steps, 4, iters, {})


def bench_step_v6(params=None, batch: int = 1024, lo_steps: int = 32,
                  hi_steps: int = 1484, device=None, iters: int = 5) -> tuple:
    """K1, the v6 BNF2 step in acc32 mode (JAX ``bench_step_v6``), at the
    2_2 shape on a DEFAULT-flavor key from a random standard key (true
    Shoup duals), over 2 steps repeated, in turns with its reference loop
    ``kb_step_bnf2_acc32_r2``: the rows ``fused_step_v6`` and
    ``fused_step_v6_r2``, per ciphertext-step seconds by two step
    counts."""
    p = params or PARAM_MESSAGE_2_CARRY_2_KS_PBS
    dev = resolve_device(device)
    R, N, l = p.glwe_size, p.polynomial_size, p.pbs_level
    if dev.type == "cpu":
        batch, lo_steps, hi_steps = 2, 1, 2
    rng = np.random.default_rng(7)
    std = from_u64(rng.integers(0, 1 << 64, size=(2, l, R, R, N),
                                dtype=np.uint64), dev)
    bsk2 = bnf2_mod.bootstrap_key_to_bnf2(std, bnf2_mod.DEFAULT)
    hi = from_u32(rng.integers(0, 1 << 32, size=(batch, R, N),
                               dtype=np.uint32), dev)
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(batch, hi_steps)))
    return _step_rows("fused_step_v6", pk.blind_rotate_bnf2_acc32,
                      kb_step_bnf2_acc32_r2, _repeat_steps(bsk2, hi_steps),
                      hi, mask.to(dev), p, lo_steps, hi_steps, 2, iters,
                      {"flavor": bnf2_mod.DEFAULT})


def bench_keyswitch(params=None, batch: int = 4096, lo: int = 2,
                    hi: int = 66, device=None, iters: int = 5) -> dict:
    """The keyswitch as one int8 GEMM (``server.keyswitch_mxu``, JAX
    ``bench_keyswitch``) at batch 4096: int8 MAC/s against the card's
    tensor-core int8 rate; above 1.0 raises. Each loop folds its result
    into every input coordinate, so no two loops see the same input."""
    from .server import keyswitch_mxu, ksk_to_i8_limbs

    p = params or PARAM_MESSAGE_2_CARRY_2_KS_PBS
    dev = resolve_device(device)
    n_in, n_out = p.glwe_dimension * p.polynomial_size, p.lwe_dimension
    if dev.type == "cpu":
        batch, lo, hi = 2, 1, 1
    rng = np.random.default_rng(5)
    ksk = rng.integers(0, 1 << 64, size=(n_in, p.ks_level, n_out + 1),
                       dtype=np.uint64)
    ksk_i8 = torch.from_numpy(ksk_to_i8_limbs(ksk, p.ks_base_log)).to(dev)
    ct = from_u64(rng.integers(0, 1 << 64, size=(batch, n_in + 1),
                               dtype=np.uint64), dev)

    def many(k):
        out = ct
        for _ in range(k):
            ks = keyswitch_mxu(out, ksk_i8, p.ks_base_log, p.ks_level)
            out = out * 6364136223846793005 + 1
            out[..., : n_out + 1] += ks
        return out.sum()

    if dev.type == "cpu":
        many(lo)
        return _cpu_row("keyswitch_mxu", "int8-MAC/s", batch)
    t = _time_delta(many, lo, hi, 1, "keyswitch_mxu", 1e-5, 10.0, iters)
    macs = batch * (n_in * p.ks_level) * ((n_out + 1) * 8)
    rates = card_rates(dev.index or 0)
    row = {"metric": "keyswitch_mxu", "value": macs / t, "unit": "int8-MAC/s",
           "int8_tensor_fraction": macs / t / rates["int8_mac"],
           "ks_per_s": batch / t, "batch": batch, "card": rates["card"]}
    if row["int8_tensor_fraction"] > 1.0:
        raise RuntimeError(f"keyswitch_mxu above the int8 peak: {row}")
    return row


def bench_ntt_plan(n: int = 16384, num_primes: int = 5, batch: int = 8,
                   lo: int = 1, hi: int = 9, device=None,
                   iters: int = 5) -> dict:
    """The port's ``NegacyclicNtt`` (PyTorch ops, no kernel of its own) on
    the GPU at N = 16384 over 5 primes: a forward transform of 22-bit
    digits and the inverse, per loop; the counterpart of JAX
    ``bench_ntt_jnp``, which times the XLA plan path."""
    plan = ntt_mod.get_plan(n, num_primes)
    dev = resolve_device(device)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(0, 1 << 63, size=(batch, n))).to(dev)

    def many(k):
        out = x
        for _ in range(k):
            h = plan.fwd_digits(out & ((1 << 22) - 1))
            out = out + plan.inv(h)[0]
        return out

    butterflies = 2 * num_primes * batch * (n // 2) * (n.bit_length() - 1)
    if dev.type == "cpu":
        many(lo)
        return _cpu_row(f"ntt_plan_roundtrip_N{n}", "butterflies/s", batch)
    t = _time_delta(many, lo, hi, butterflies, f"ntt_plan_roundtrip_N{n}",
                    1e-15, 1e-6, iters)
    return {"metric": f"ntt_plan_roundtrip_N{n}", "value": 1.0 / t,
            "unit": "butterflies/s", "batch": batch,
            "card": card_rates(dev.index or 0)["card"]}


def iter_rows(quick: bool = False, device=None):
    """Every row, one at a time, in the JAX ``run_all`` order (``quick``:
    without the N = 16384 plan row, and 3 timed runs a point instead of 5).
    No row is caught: a failure fails the run. On the CPU
    (``device="cpu"``) only the plain computations run, at small sizes, and
    nothing is timed."""
    dev = resolve_device(device)
    it = 3 if quick else 5
    yield bench_ntt("fwd", dev, it)
    yield bench_ntt("inv", dev, it)
    yield bench_pointwise_mac(dev, it)
    yield bench_rotate(dev, it)
    yield bench_decompose(dev, it)
    yield from bench_step(device=dev, iters=it)
    yield from bench_step_v6(device=dev, iters=it)
    yield bench_keyswitch(device=dev, iters=it)
    if not quick:
        yield bench_ntt_plan(device=dev, iters=it)


def run_all(quick: bool = False, device=None) -> list:
    """The rows of :func:`iter_rows`, as a list."""
    return list(iter_rows(quick, device))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sink = open(argv[0], "a") if argv else None
    try:
        for row in iter_rows():
            line = json.dumps(row)
            print(line, flush=True)
            if sink:
                print(line, file=sink, flush=True)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
