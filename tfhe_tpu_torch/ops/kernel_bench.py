"""Per-kernel micro-benchmarks of the blind-rotation step on an NVIDIA GPU.

Counterpart of ``tfhe_tpu/ops/kernel_bench.py`` and of its entry point
``bench.py --kernels``::

    python -m tfhe_tpu_torch.ops.kernel_bench [out.jsonl]

prints one JSON row per micro-benchmark (and appends it to ``out.jsonl``
when given). Nothing is caught: a row that fails fails the run.

Five looped micro-kernels (``csrc/kernel_bench.cu``) replace the bodies of
``_looped_pallas`` (``tfhe_tpu/ops/kernel_bench.py:91``): ``kb_ntt_fwd`` /
``kb_ntt_inv`` (one-prime negacyclic transform), ``kb_mac`` (Shoup MAC
against two rows of a GGSW row, true duals), ``kb_rotate`` (negacyclic
rotation of u64 rows) and ``kb_decompose`` (balanced digits of the hi
word). Each runs a run-time trip count of its primitive on rows resident in
shared memory, one block per row, built from the device functions that K1
and K3 run (``csrc/ntt_common.cuh``). Each has a plain PyTorch version,
``*_plain``; a wrapper given CPU tensors runs it, given CUDA tensors it
launches the kernel or raises, and counts its launches in ``launches``.

The step rows time the step kernels themselves: ``bench_step`` K3 (the
exact 4-prime CRT step at 2_2, the counterpart of the legacy step of
``bench_step``), ``bench_step_v6`` K1 (the v6 BNF2 step), each per
ciphertext-step by two step counts; ``bench_keyswitch`` the keyswitch GEMM
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
ROWS_PER_SM = 4  # micro-kernel rows: 4 blocks of 512 threads fill an SM
N_BENCH = 2048
PRIME = ntt_mod.PRIMES32[0]
MAC_TERMS = 2
DECOMP_BASE_LOG, DECOMP_LEVELS = 23, 1
LOOPS = (256, 4096)  # low and high trip counts of the two-point method

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
#: kb_decompose: three of the digit loop, one of which runs), which are
#: taken out. IMAD in all its forms runs on the FMA pipe; IADD3, ISETP,
#: SEL, LOP3, SHF, LEA, VIADD and the rest on the ALU pipe. The FMA column
#: counts issue slots (``fma_slots``): IMAD.HI and IMAD.WIDE count 1.5
#: (``sass_loops.DOUBLE_SLOTS``, a floor chosen to fit the
#: ``tools.vpu_primitives`` rows on an H100, not a measured slot cost).
#: ``flex``: the VIADDs among the ALU column, which may issue on either
#: pipe (:func:`busier_pipe`); one rule bounds the step kernels, the
#: micro-kernels and the probes. Units, per step and ciphertext of a step
#: kernel: element (rotate, rot - acc, digit state) per R*N; level (the
#: next digit, its lift into each Z_p and the twist) per l*R*N; forward
#: and inverse butterflies; mac (one Shoup product and its add_mod) per
#: P*R*l*R*N; untwist_tail (the P untwists, the tail, acc +=) per R*N.
#: Recount, and update :data:`SASS_LOOP_TOTALS`, when :func:`sass_drift`
#: finds a change.
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
    # the micro-kernels, per unit of their loop
    "kb_ntt_fwd": {"twist": (2, 4.5, 0), "fwd_butterfly": (5, 6.5, 0)},
    "kb_ntt_inv": {"inv_butterfly": (7, 7.5, 0), "twist": (2, 4.5, 0)},
    "kb_mac": {"mac": (5, 4.5, 0)},  # per element and term
    "kb_rotate": {"element": (7, 5, 0)},
    "kb_decompose": {"element": (18, 3, 3)},  # state, one digit, the add
}

#: the toolkit whose SASS :data:`SASS_OPS` was read from
SASS_TOOLKIT = "Build cuda_12.9.r12.9/compiler.36037853_0"

#: per :data:`SASS_OPS` kernel: its library, a part of its mangled name, and
#: (ALU, FMA) data instructions summed over every loop of that kernel, as
#: ``sass_loops.loops`` counted them in the SASS that :data:`SASS_OPS` was
#: read from. :func:`sass_drift` recounts them in a fresh build: a change
#: there means the table is stale.
SASS_LOOP_TOTALS = {
    "blind_rotate_bnf2_acc32": ("blind_rotate_bnf2", "Bnf2Tail32E", (121, 90)),
    "blind_rotate_crt/3": ("blind_rotate_crt", "10GarnerTailILi3E",
                           (140, 122)),
    "blind_rotate_crt/4": ("blind_rotate_crt", "10GarnerTailILi4E",
                           (123, 111)),
    "blind_rotate_crt_acc32/3": ("blind_rotate_crt", "12GarnerTail32ILi3E",
                                 (141, 118)),
    "blind_rotate_crt_acc32/4": ("blind_rotate_crt", "12GarnerTail32ILi4E",
                                 (120, 109)),
    "blind_rotate_bnf2_u64": ("blind_rotate_crt", "8Bnf2TailE", (127, 99)),
    "blind_rotate_goldilocks": ("blind_rotate_goldilocks",
                                "blind_rotate_goldilocks_kernel", (582, 221)),
    "kb_ntt_fwd": ("kernel_bench", "kb_ntt_kernelILb0E", (7, 10)),
    "kb_ntt_inv": ("kernel_bench", "kb_ntt_kernelILb1E", (9, 11)),
    "kb_mac": ("kernel_bench", "kb_mac_kernel", (35, 28)),
    "kb_rotate": ("kernel_bench", "kb_rotate_kernel", (7, 5)),
    "kb_decompose": ("kernel_bench", "kb_decompose_kernel", (66, 8)),
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


def _pipes(kernel: str, units: dict) -> float:
    ops = SASS_OPS[kernel]
    return busier_pipe(*(sum(u * ops[k][i] for k, u in units.items())
                         for i in range(3)))


def step_pipe_instructions(kernel: str, B: int, n: int, R: int,
                           levels: int, N: int, P: int) -> float:
    """Busier-pipe instructions of ``B`` ciphertexts times ``n`` steps of a
    blind-rotation kernel (``kernel``: its entry, K1, K3, K3-acc32,
    K3-bnf2 or K4 at P = 1), at :data:`SASS_OPS`: per step and
    ciphertext R*N elements, l*R*N levels, P*l*R forward and P*R inverse
    transforms of N/2*log2(N) butterflies, P*R*l*R*N MAC products and R*N
    untwists with the tail."""
    key = kernel if kernel in SASS_OPS else f"{kernel}/{P}"
    lR, half_log = levels * R, (N // 2) * (N.bit_length() - 1)
    return float(B) * n * _pipes(key, {
        "element": R * N, "level": lR * N,
        "fwd_butterfly": P * lR * half_log, "mac": P * R * lR * N,
        "inv_butterfly": P * R * half_log, "untwist_tail": R * N})


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


@functools.lru_cache(maxsize=None)
def _kb_lib():
    from .._build import cuda_lib

    lib = cuda_lib("kernel_bench")
    i, v = ctypes.c_int, ctypes.c_void_p
    lib.kb_ntt.argtypes = [v, v, v, i, i, ctypes.c_uint, i, i, v]
    lib.kb_mac.argtypes = [v, v, v, i, i, i, ctypes.c_uint, i, v]
    lib.kb_rotate.argtypes = [v, v, v, i, i, i, v]
    lib.kb_decompose.argtypes = [v, v, i, i, i, i, i, v]
    for entry in (lib.kb_ntt, lib.kb_mac, lib.kb_rotate, lib.kb_decompose):
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


#: the micro-kernel wrappers, each with its ``launches`` count
MICRO_KERNELS = (kb_ntt_fwd, kb_ntt_inv, kb_mac, kb_rotate, kb_decompose)
for _fn in MICRO_KERNELS:
    _fn.launches = 0


def reset_launches():
    """Zero the launch counts of the micro-kernel wrappers."""
    for fn in MICRO_KERNELS:
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


def _step_row(metric: str, kernel, key, acc, mask, p, lo_steps: int,
              hi_steps: int, P: int, iters: int, extra: dict):
    """Time a step kernel per ciphertext-step by two step counts (``key``
    and ``mask`` have ``hi_steps`` steps; their first ``lo_steps`` make the
    low point)."""
    B, R, N = acc.shape
    runs = {k: (mask[:, :k].contiguous(), key[:k].contiguous())
            for k in (lo_steps, hi_steps)}
    fn = lambda k: kernel(acc, *runs[k], p.pbs_base_log, p.pbs_level,
                          **extra)
    if acc.device.type == "cpu":
        fn(lo_steps)
        return _cpu_row(metric, "ct-steps/s", B)
    per = _time_delta(fn, lo_steps, hi_steps, B, metric, 1e-9, 1e-4, iters)
    rates = card_rates(acc.device.index or 0)
    instr = step_pipe_instructions(kernel.__name__, 1, 1, R, p.pbs_level, N,
                                   P)
    return {"metric": metric, "value": 1.0 / per, "unit": "ct-steps/s",
            "seconds_per_ct_step": per,
            "implied_blind_rotate_pbs_per_s": 1.0 / (per * p.lwe_dimension),
            "int32_fraction": instr / per / rates["int32"],
            "batch": B, "card": rates["card"]}


def bench_step(params=None, batch: int = 256, lo_steps: int = 16,
               hi_steps: int = 600, device=None, iters: int = 5) -> dict:
    """K3, the exact 4-prime CRT step (the function of the JAX package's
    legacy ``_build_step_fn``, JAX ``bench_step``), at the 2_2 shape: per
    ciphertext-step seconds by two step counts. The key is a valid CRT key
    (canonical residues per prime, true Shoup duals: the transform of a
    random standard key over 2 steps, repeated along the step axis)."""
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
    return _step_row("fused_step", pk.blind_rotate_crt,
                     _repeat_steps(scan, hi_steps), acc, mask.to(dev), p,
                     lo_steps, hi_steps, 4, iters, {})


def bench_step_v6(params=None, batch: int = 1024, lo_steps: int = 32,
                  hi_steps: int = 1484, device=None, iters: int = 5) -> dict:
    """K1, the v6 BNF2 step in acc32 mode (JAX ``bench_step_v6``), at the
    2_2 shape on a DEFAULT-flavor key from a random standard key (true
    Shoup duals), over 2 steps repeated: per ciphertext-step seconds by two
    step counts."""
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
    return _step_row("fused_step_v6", pk.blind_rotate_bnf2_acc32,
                     _repeat_steps(bsk2, hi_steps), hi, mask.to(dev), p,
                     lo_steps, hi_steps, 2, iters,
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
    yield bench_step(device=dev, iters=it)
    yield bench_step_v6(device=dev, iters=it)
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
