#!/usr/bin/env python3
"""Drive tfhe_tpu_torch's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. build every CUDA kernel from ``tfhe_tpu_torch/csrc`` (one nvcc per
   source, all at once), print the build time and ptxas' register, spill
   and shared-memory report, hold the loops of the build's SASS to the
   counts the bounds were read from (``kernel_bench.sass_drift``, the
   probes' tables too), require each probe's loops to hold the op its
   case names (``IGMMA`` for the wgmma cases) and issue every MAC it
   counts, and print each wgmma kernel's registers, spills, shared
   memory, cluster size and blocks per SM (a spill fails);
2. shortint ``PARAM_MESSAGE_2_CARRY_2_KS_PBS`` (v6b, acc32): seeded keygen,
   a batch of 2048 covering all 16 message+carry values; K2 acc32 and K1
   against their plain versions (exact) on the path's own inputs (the
   whole batch, all 866 steps) and at three 32-step cases;
   ``ServerKey.apply_lookup_table`` with the launch counts zeroed just
   before and read just after; timings;
3. boolean gates at ``BOOLEAN_DEFAULT_PARAMETERS`` (exact CRT, P = 3):
   seeded keygen, 4096 random pairs, every gate (``not_`` and ``mux``
   included) against its truth table; K2 u64 and K3 against their plain
   versions at the path's shapes (K3's on 64 ciphertexts, all 805 steps);
   launch counts around one gate call; gates/s for ``and_`` and ``mux``;
4. FHE Trivium at ``BOOLEAN_DEFAULT_PARAMETERS``: encrypted key, the full
   1152-round FHE warm-up, 256 keystream bits against the clear cipher, 64
   bits transciphered; warm-up seconds and keystream bits/s;
5. shortint ``TFHE_NTT_VARIANT=crt`` at 2_2 (K2 u64, K3 with P = 4) and
6. shortint ``TFHE_V4_ACC=64`` at 2_2 (v6b, two-plane: K2 u64, K3-bnf2):
   each a batch of 512 through ``apply_lookup_table`` with the launch
   counts around it, decrypting to 3x mod 16, PBS/s; K2 u64 and the K3
   entry against their plain versions on that batch's own keyswitched
   inputs (K3's on its first 64 ciphertexts, all 866 steps), and K3 on
   random u64 accumulators over 32 steps; K3 timed at B = 512;
7. shortint ``TFHE_NTT_VARIANT=v5`` at 2_2 (K2 u64, K4 over the Goldilocks
   prime): a batch of 2048 through ``apply_lookup_table`` with the launch
   counts around it (K2 u64 and K4 once each, K1 and K3 never), decrypting
   to 3x mod 16; K2 u64 and K4 against their plain versions on that
   batch's own keyswitched inputs (K4's on its first 64 ciphertexts, all
   866 steps, the whole key), K4 on random u64 accumulators over 32 steps
   and at 1_1 geometry (R = 5, N = 512); KS -> PBS and K4 timed at
   B = 2048;
8. boolean gates under ``TFHE_V4_ACC=32`` with phase 3's keys (K2 acc32,
   K3-acc32: the exact CRT step on the u32 hi plane, every increment
   rounded to 2^32): every gate on the 4096 pairs against its truth table,
   the launch counts around one ``and_`` (K2 acc32 and K3-acc32 once, K2
   u64 and K3 never), K2 acc32 against its plain version on the whole
   batch and K3-acc32 on the gate's first 64 inputs over all 805 steps;
   ``and_`` gates/s and K3-acc32 at B = 4096 beside the exact ``and_``;
9. 2_2 under ``TFHE_NTT_VARIANT=v4 TFHE_V4_ACC=32`` with phase 5's 4-prime
   key: a batch of 512 through ``apply_lookup_table`` (K2 acc32,
   K3-acc32) with the launch counts around it; K2 acc32 and K3-acc32
   against their plain versions on that batch's own inputs (K3-acc32's on
   its first 64 ciphertexts, all 866 steps, the whole key) and K3-acc32 on
   random accumulators over 32 steps;
10. ``TFHE_V6_STACKED=1`` (a TPU layout of K1's function, read by nothing
    in the port; its parity with K1 is a CPU test): phase 2's batch takes
    the same kernels with it set and gives phase 2's ciphertext bit for
    bit;
11. the kernel bench: each micro-kernel of ``csrc/kernel_bench.cu`` held
    exactly against its plain version and timed at a small trip count,
    then ``kernel_bench.run_all(quick=True)`` with the launch counts
    around it, one JSON row per micro-benchmark;
12. the TPU design probes (``tfhe_tpu_torch/tools``: ``vpu_primitives``,
    ``ntt_variants``, ``v4_probe``, and on the int8 tensor cores
    ``mxu_probe``, ``kernel_experiments``, ``ntt_v3c_experiments`` and the
    MXU cases of the second and third): each case's kernel, and each
    ``_sync`` reference of a wgmma case (the first, mma.sync kernel), held
    exactly against its plain version at its check trip count and timed
    there (a wgmma case and its reference in turns: ref, new, new, ref),
    then each probe's ``run_all(quick=True)`` with the launch counts
    around it, one JSON row per case (the wgmma rows with their
    reference's time from the same turns), the IMAD.WIDE verdict, the
    split of K1's and K3's time per ciphertext-step (against phase 11's
    rows), ``mix_overlap`` (do the tensor cores run beside the INT32
    pipes?) and the tensor-core verdict (``mxu_verdict``: the int8
    small-DFT transforms, wgmma and mma.sync, against the INT32 radix-2
    and radix-4 ones);
13. the card's name and power limit, a ``{"kernels": [...]}`` line, and
    last the ``{"ok": true, "device": {...}}`` line.

Times are CUDA events: a kernel's ``ms`` is the median of a few runs (K2:
the mean of 200 back-to-back launches between one pair of events); a plain
version's ``plain_ms`` is its comparison run. Bounds: ``bound_ms`` is the
larger of the bytes the kernel must move over the card's HBM rate (3.35
TB/s, H100 SXM data sheet) and its instructions over the rate of one
64-lane-per-SM integer pipe (64 lanes x SMs x max SM clock), counted per
pipe from the SASS of the build (K1, K3, K3-acc32, K3-bnf2, K4 and the
micro-kernels, ``kernel_bench.SASS_OPS``; each probe's own loops, or the
radix-2 code's counts for the transform variants); a probe's bound is the
largest of that, its int8 MACs at the dense tensor-core peak, and its
bytes, and ``bound_term`` names which. ``library_ms`` is the
time of one PyTorch call computing a probe trip's function on the same
tile, where there is one, else null.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0x5EED
BATCH = 2048  # shortint 2_2 main path
BOOL_BATCH = 4096  # boolean gates
SIDE_BATCH = 512  # shortint crt and two-plane phases
PLAIN_BATCH = 64  # plain-version comparisons of the long step kernels
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
K2_LAUNCHES = 200  # back-to-back launches per K2 timing
KB_CHECK_LOOPS = 16  # micro-kernel passes of the exactness check
TRIVIUM_KEY = [(i * 7 + 3) % 2 for i in range(80)]
TRIVIUM_IV = [(i * 5 + 1) % 2 for i in range(80)]
DEVICE = "cuda"


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs (CUDA events),
    after one warm-up run unless the caller has just run ``fn``."""
    import torch

    if warmup:
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_loop(fn, launches: int) -> float:
    """Mean device time of ``fn`` in ms over ``launches`` back-to-back runs
    between one pair of CUDA events (for kernels of tens of µs)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def max_abs_err(a, b) -> float:
    """Largest |a - b| of two integer tensors: u32 values in int32 storage,
    or u64 torus values in int64 storage (the wrapped, centered distance)."""
    import torch

    if a.dtype == torch.int32:
        m = (1 << 32) - 1
        return float(((a.long() & m) - (b.long() & m)).abs().max().item())
    return float((a - b).double().abs().max().item())


def step_bytes(B: int, n: int, R: int, levels: int, N: int, P: int,
               acc_bytes: int) -> float:
    """Bytes a blind-rotation kernel must move: the key once, the
    accumulator in and out, the mask, the constant tables."""
    key = n * 2 * P * levels * R * R * N * 4
    return key + 2 * B * R * N * acc_bytes + B * n * 4 + P * 8 * N * 4


def k2_bytes(B: int, R: int, N: int, shared_lut: bool, out_bytes: int):
    lut = R * N * 8 * (1 if shared_lut else B)
    return lut + B * 4 + B * R * N * out_bytes


def bound(ops: float, nbytes: float, rate: float):
    ops_ms = ops / rate * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def probe_bound(int32_ops: float, macs: float, nbytes: float, rates: dict):
    """A probe's bound, the largest of three times: its busier INT32 pipe's
    instructions at ``rates["int32"]``, its int8 MACs at the dense
    tensor-core peak ``rates["int8_mac"]``, its bytes at the HBM rate:
    (ms, "operations" or "bytes", the binding term)."""
    terms = {"int32_pipe": int32_ops / rates["int32"] * 1e3,
             "int8_tensor": macs / rates["int8_mac"] * 1e3,
             "hbm_bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], ("bytes" if term == "hbm_bytes" else "operations"), \
        term


def step_bound(entry: str, B: int, n: int, R: int, levels: int, N: int,
               P: int, acc_bytes: int, rate: float):
    """A step kernel's bound on the SASS per-pipe rule: (ms, "bytes" or
    "operations"), ``kernel_bench.step_pipe_instructions``."""
    from tfhe_tpu_torch.ops import kernel_bench as kb

    return bound(kb.step_pipe_instructions(entry, B, n, R, levels, N, P),
                 step_bytes(B, n, R, levels, N, P, acc_bytes), rate)


def check_equal(name, kernel, plain, args):
    """Kernel vs plain version on the same inputs, exact; returns the
    max_abs_err (0) and the plain version's time (ms): its comparison run,
    between CUDA events."""
    import torch

    got = kernel(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(*args)
    end.record()
    end.synchronize()
    err = max_abs_err(got, want)
    if tuple(got.shape) != tuple(want.shape) or err != 0:
        raise AssertionError(f"{name}: kernel != plain version "
                             f"(max_abs_diff {err})")
    return err, start.elapsed_time(end)


@contextlib.contextmanager
def env(**values):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def random_k1_case(rng, B, n, R, levels, N, flavor):
    import torch

    from tfhe_tpu_torch._torus import from_u32, from_u64
    from tfhe_tpu_torch.ops import bnf2 as b2

    std = rng.integers(0, 1 << 64, size=(n, levels, R, R, N), dtype=np.uint64)
    bsk = b2.bootstrap_key_to_bnf2(from_u64(std, DEVICE), flavor)
    acc = from_u32(rng.integers(0, 1 << 32, size=(B, R, N), dtype=np.uint32),
                   DEVICE)
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(B, n))).to(DEVICE)
    return acc, mask, bsk


def switched(sk, ct):
    """The keyswitched, modulus-switched (mask [B, n], body [B]) that
    ``sk.apply_lookup_table(ct, ...)`` hands its step kernels."""
    from tfhe_tpu_torch.ops import server as server_ops
    from tfhe_tpu_torch.utils.params import ModulusSwitchType

    p = sk.params
    small = server_ops.keyswitch_mxu(ct.ct, sk.ksk_i8, p.ks_base_log,
                                     p.ks_level)
    if p.modulus_switch_type == ModulusSwitchType.CENTERED_MEAN_NOISE_REDUCTION:
        switch = server_ops.lwe_centered_binary_modulus_switch
    else:
        switch = server_ops.lwe_standard_modulus_switch
    return switch(small, p.polynomial_size.bit_length())


def launches_of(*names) -> dict:
    from tfhe_tpu_torch.ops import pbs_kernel as pk

    return {n: getattr(pk, n).launches for n in names}


def require_launched(label: str, counts: dict):
    print(f"{label} launches: {counts}")
    if min(counts.values()) < 1:
        raise AssertionError(f"{label}: a kernel of the path did not launch: "
                             f"{counts}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def _read_sass(lib: str) -> str:
    from tfhe_tpu_torch import _build

    with open(_build.sass_path(lib)) as f:
        return f.read()


def phase_build():
    from tfhe_tpu_torch import _build
    from tfhe_tpu_torch.ops import kernel_bench as kb
    from tfhe_tpu_torch.ops import pbs_kernel as pk

    secs = _build.build_cuda()
    print(f"build: {secs:.1f} s for {list(_build.CUDA_SOURCES)}, "
          f"{_build.nvcc_version()}")
    for name in _build.CUDA_SOURCES:
        with open(_build.ptxas_report_path(name)) as f:
            for line in f:
                if ("entry function" in line or "registers" in line
                        or "spill" in line):
                    print(f"  ptxas {name}: {line.strip()}")
    # every bound rests on kernel_bench.SASS_OPS: hold its source, the
    # loops of this build, to the counts it was read from
    drift = kb.sass_drift(_read_sass)
    if drift:
        raise AssertionError(
            f"SASS loops differ from kernel_bench.SASS_LOOP_TOTALS (read "
            f"from {kb.SASS_TOOLKIT}) as (kernel, (ALU, FMA) then, now): "
            f"{drift}; recount kernel_bench.SASS_OPS")
    print(f"SASS loops of all {len(kb.SASS_LOOP_TOTALS)} bounded kernels == "
          f"kernel_bench.SASS_LOOP_TOTALS (read from {kb.SASS_TOOLKIT})")
    # the probes: their loop counts, and the op each case names in them
    from tfhe_tpu_torch.tools import _harness as h

    for mod in probe_modules().values():
        cases = mod.CASES + getattr(mod, "SYNC_CASES", ())
        drift = kb.sass_drift(_read_sass, mod.SASS_LOOP_TOTALS)
        missing = h.missing_ops(cases, mod.SASS_LOOP_TOTALS)
        unissued = h.mma_drift(cases, mod.SASS_LOOP_TOTALS, DEVICE)
        if drift or missing or unissued:
            raise AssertionError(
                f"{mod.__name__}: SASS loops differ from SASS_LOOP_TOTALS as "
                f"(kernel, then, now): {drift}; loops without the op their "
                f"case names: {missing}; int8 cases whose SASS does not "
                f"issue the MACs they count (case, issued, counted): "
                f"{unissued}")
        print(f"SASS loops of {len(mod.SASS_LOOP_TOTALS)} kernels of "
              f"{mod.__name__} == its SASS_LOOP_TOTALS; every case's loop "
              "holds its op; every int8 case's mma loops issue its MACs")
    step_kernel_report()
    wgmma_kernel_report()
    return secs


#: the step kernels' shapes on the paths: (label, entry, P, R, levels, N,
#: accumulator bytes)
STEP_SHAPES = (
    ("K1 2_2", "blind_rotate_bnf2_acc32", 2, 2, 1, 2048, 4),
    ("K3 boolean default (P=3)", "blind_rotate_crt", 3, 4, 2, 512, 8),
    ("K3 2_2 crt (P=4)", "blind_rotate_crt", 4, 2, 1, 2048, 8),
    ("K3-acc32 boolean default (P=3)", "blind_rotate_crt_acc32", 3, 4, 2,
     512, 4),
    ("K3-acc32 2_2 (P=4)", "blind_rotate_crt_acc32", 4, 2, 1, 2048, 4),
    ("K3-bnf2 2_2 two-plane", "blind_rotate_bnf2_u64", 2, 2, 1, 2048, 8))


def _ptxas_spills(lib: str) -> dict:
    """{mangled entry: spill store + load bytes} from ptxas' report of
    lib<lib>.so."""
    import re

    from tfhe_tpu_torch import _build

    out, entry = {}, None
    with open(_build.ptxas_report_path(lib)) as f:
        for line in f:
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and entry is not None:
                out[entry] = int(m.group(1)) + int(m.group(2))
    return out


def step_kernel_report():
    """Per step kernel at each path's shape: its dynamic shared memory (the
    <entry>_smem export, held to ops/step_passes.step_smem_bytes: acc and
    digits, no MAC buffer), registers, spill bytes and resident blocks per
    SM; fails on a spill in any instantiation of K1's or K3's step kernel,
    or on an export that differs from the formula."""
    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.ops import step_passes as sp

    spills = {lib: _ptxas_spills(lib)
              for lib in ("blind_rotate_bnf2", "blind_rotate_crt")}
    spilled = {name: b for lib in spills.values() for name, b in lib.items()
               if "blind_rotate_kernel" in name and b}
    for label, entry, P, R, levels, N, acc_bytes in STEP_SHAPES:
        smem = pk.step_smem_bytes(entry, P, R, levels, N)
        want = sp.step_smem_bytes(P, R, levels, N, acc_bytes)
        occ = pk.step_occupancy(entry, P, R, levels, N)
        print(f"  {label}: {smem / 1024:.0f} KiB dynamic shared memory a "
              f"block, {occ['registers']} registers, {occ['local_bytes']} "
              f"local bytes a thread, {occ['blocks_per_sm']} blocks per SM")
        if smem != want:
            raise AssertionError(f"{entry}_smem {smem} != the formula's "
                                 f"{want} (acc + digits) at {label}")
        if occ["local_bytes"]:
            spilled[f"{entry} at {label}"] = occ["local_bytes"]
    for entry, P, radix2_of in (("kb_step_bnf2_acc32_r2", 2, 4),
                                ("kb_step_crt_r2", 4, 8)):
        smem = pk.step_smem_bytes(entry, P, 2, 1, 2048)
        if smem != sp.step_smem_bytes(P, 2, 1, 2048, radix2_of, radix2=True):
            raise AssertionError(f"{entry}_smem {smem} != the radix-2 "
                                 "loop's layout")
        print(f"  {entry} (the radix-2 loop, the bench's reference) 2_2: "
              f"{smem / 1024:.0f} KiB")
    for label, args in (("K4 2_2 v5", ("blind_rotate_goldilocks", 1, 2, 1,
                                       2048)),
                        ("K4 1_1 v5", ("blind_rotate_goldilocks", 1, 5, 1,
                                       512))):
        print(f"  {label}: {pk.step_smem_bytes(*args) / 1024:.0f} KiB "
              "dynamic shared memory a block")
    if spilled:
        raise AssertionError(f"K1/K3 step kernels spill: {spilled}")
    print("K1 and K3: no spills; shared memory == acc + digits")


#: the wgmma kernels' instantiations: (library, op, copies)
WGMMA_KERNELS = tuple(
    [("mxu_probe", op, 1) for op in (
        "matmul_512x512", "matmul_384x512", "matmul_256r_384x512",
        "mix_matmul512_shoupx8", "mix_2matmul_shoupx16")]
    + [("ntt_mxu", op, c) for op, c in (
        ("v3_fwd", 1), ("v3_inv", 1), ("mm4", 1), ("mm1", 1), ("mm1", 2),
        ("mm1", 4), ("v4_fold", 1), ("v4_inv_mmr", 1), ("v4_fwd", 1),
        ("v4_fwd_nosplit", 1), ("v4_inv", 1))])


def wgmma_kernel_report():
    """Per wgmma kernel (mxu_probe_kernel, ntt_mxu_kernel): registers,
    ptxas' spill bytes, local bytes a thread, dynamic shared memory,
    cluster size, resident blocks per SM and clusters on the card; fails
    on a spill."""
    from tfhe_tpu_torch.tools import mxu_probe, ntt_mxu

    spills = {lib: _ptxas_spills(lib) for lib in ("mxu_probe", "ntt_mxu")}
    spilled = {name: b for lib, part in (("mxu_probe", "16mxu_probe_kernelI"),
                                         ("ntt_mxu", "14ntt_mxu_kernelI"))
               for name, b in spills[lib].items() if part in name and b}
    for lib, op, copies in WGMMA_KERNELS:
        occ = (mxu_probe.occupancy(op) if lib == "mxu_probe"
               else ntt_mxu.occupancy(op, copies))
        print(f"  wgmma {lib} {op}{f' x{copies}' if copies > 1 else ''}: "
              f"{occ['registers']} registers, {occ['local_bytes']} local "
              f"bytes a thread, {occ['smem_bytes'] / 1024:.1f} KiB dynamic "
              f"shared memory, cluster of {occ['cluster']}, "
              f"{occ['blocks_per_sm']} block(s) per SM, {occ['clusters']} "
              "clusters on the card")
        if occ["local_bytes"]:
            spilled[f"{lib} {op} x{copies}"] = occ["local_bytes"]
    if spilled:
        raise AssertionError(f"wgmma kernels spill: {spilled}")
    print(f"wgmma kernels: no spills ({len(WGMMA_KERNELS)} instantiations)")


def in_turns(new, ref, reps: int = 2) -> tuple:
    """CUDA-event ms of ``new()`` and ``ref()`` timed ref, new, new, ref
    (each turn the median of ``reps`` runs, a function warmed up before its
    first turn only): (new ms, ref ms), each the mean of its two turns."""
    r1, n1 = cuda_ms(ref, reps), cuda_ms(new, reps)
    n2, r2 = cuda_ms(new, reps, False), cuda_ms(ref, reps, False)
    return (n1 + n2) / 2, (r1 + r2) / 2


def phase_shortint_v6b(card, rate, rows):
    import torch

    from tfhe_tpu_torch._torus import from_u64
    from tfhe_tpu_torch.ops import bnf2 as b2
    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.ops import server as server_ops
    from tfhe_tpu_torch.shortint.client_key import ClientKey
    from tfhe_tpu_torch.shortint.server_key import ServerKey
    from tfhe_tpu_torch.utils.params import (PARAM_MESSAGE_1_CARRY_1_KS_PBS,
                                             PARAM_MESSAGE_2_CARRY_2_KS_PBS)

    p = PARAM_MESSAGE_2_CARRY_2_KS_PBS
    t0 = time.perf_counter()
    ck = ClientKey.generate(p, seed=SEED)
    sk = ServerKey.generate(ck)
    torch.cuda.synchronize()
    print(f"keygen 2_2: {time.perf_counter() - t0:.1f} s, variant "
          f"{sk.variant}, bsk_b {tuple(sk.bsk_b.shape)}, "
          f"ksk_i8 {tuple(sk.ksk_i8.shape)}")
    mod = p.message_modulus * p.carry_modulus
    f = lambda x: (3 * x) % mod
    vals = np.arange(BATCH, dtype=np.uint64) % mod
    ct = ck.encrypt(vals)
    lut = sk.generate_lookup_table(f)
    want_clear = np.array([f(int(v)) for v in vals], dtype=np.uint64)
    fl = sk.flavor
    R, N, n = p.glwe_size, p.polynomial_size, p.lwe_dimension

    # kernels vs plain versions at the main path's shapes
    ms_mask, ms_body = switched(sk, ct)
    # the script's first plain run pays the one-time start-up of torch's
    # CUDA ops (4.7 s against about 1 ms after it, on an H100): keep that
    # out of the timed comparison runs
    pk.body_rotate_acc32_plain(lut.acc, ms_body)
    k2_err, k2_plain = check_equal("body_rotate_acc32", pk.body_rotate_acc32,
                                   pk.body_rotate_acc32_plain,
                                   (lut.acc, ms_body))
    acc_hi = pk.body_rotate_acc32(lut.acc, ms_body)
    k1_err, k1_plain = check_equal(
        "blind_rotate_bnf2_acc32", pk.blind_rotate_bnf2_acc32,
        pk.blind_rotate_bnf2_acc32_plain,
        (acc_hi, ms_mask, sk.bsk_b, p.pbs_base_log, p.pbs_level, fl))
    print(f"K2 acc32 and K1 == plain at B={BATCH}, n={n}")
    rng = np.random.default_rng(SEED)
    p11 = PARAM_MESSAGE_1_CARRY_1_KS_PBS
    for label, B, steps, R_, levels, N_, flavor in (
            ("2_2 geometry, DEFAULT flavor", 64, 32, 2, 1, 2048, b2.DEFAULT),
            ("2_2 geometry, FAST28 flavor", 64, 32, 2, 1, 2048, b2.FAST28),
            ("1_1 geometry, FAST28 flavor", 64, 32, p11.glwe_size,
             p11.pbs_level, p11.polynomial_size, b2.FAST28)):
        acc, mask, bsk = random_k1_case(rng, B, steps, R_, levels, N_, flavor)
        check_equal("blind_rotate_bnf2_acc32", pk.blind_rotate_bnf2_acc32,
                    pk.blind_rotate_bnf2_acc32_plain,
                    (acc, mask, bsk, 23, levels, flavor))
        lut_r = from_u64(rng.integers(0, 1 << 64, size=(B, R_, N_),
                                      dtype=np.uint64), DEVICE)
        body = torch.from_numpy(rng.integers(0, 2 * N_, size=B)).to(DEVICE)
        check_equal("body_rotate_acc32", pk.body_rotate_acc32,
                    pk.body_rotate_acc32_plain, (lut_r, body))
        print(f"K1, K2 acc32 == plain: {label}, B={B}, {steps} steps")

    # the main path through the entry point
    pk.reset_launches()
    out = sk.apply_lookup_table(ct, lut)
    torch.cuda.synchronize()
    launches = launches_of("body_rotate_acc32", "blind_rotate_bnf2_acc32")
    require_launched("2_2 v6b main path", launches)
    if tuple(out.ct.shape) != (BATCH, p.big_lwe_dimension + 1):
        raise AssertionError(f"output shape {tuple(out.ct.shape)}")
    got_clear = ck.decrypt_message_and_carry(out)
    if not np.array_equal(got_clear, want_clear):
        bad = int((got_clear != want_clear).sum())
        raise AssertionError(f"{bad} of {BATCH} PBS outputs decrypt wrong")
    print(f"2_2 v6b: {BATCH} ciphertexts decrypt to 3x mod 16")

    # timing
    k2_ms = cuda_ms_loop(lambda: pk.body_rotate_acc32(lut.acc, ms_body),
                         K2_LAUNCHES)
    k1_ms = cuda_ms(lambda: pk.blind_rotate_bnf2_acc32(
        acc_hi, ms_mask, sk.bsk_b, p.pbs_base_log, p.pbs_level, fl), 3)
    ks_ms = cuda_ms(lambda: server_ops.keyswitch_mxu(
        ct.ct, sk.ksk_i8, p.ks_base_log, p.ks_level), 5)
    step_ms = cuda_ms(lambda: sk.apply_lookup_table(ct, lut), 5)
    print(f"keyswitch (torch._int_mm int8 GEMM) B={BATCH}: {ks_ms:.3f} ms")
    print(f"KS->PBS step B={BATCH}: {step_ms:.3f} ms = "
          f"{BATCH / step_ms * 1e3:.1f} PBS/s on {card}")
    k2_bound = bound(BATCH * R * N * 8, k2_bytes(BATCH, R, N, True, 4), rate)
    rows["body_rotate_acc32"] = dict(
        source="tfhe_tpu_torch/csrc/body_rotate.cu",
        replaces="tfhe_tpu/ops/pbs_kernel.py:1930",
        launches=launches["body_rotate_acc32"], max_abs_err=k2_err,
        ms=k2_ms, plain_ms=k2_plain, bound=k2_bound,
        shape=f"2_2 B={BATCH}", plain_shape=f"2_2 B={BATCH}")
    rows["blind_rotate_bnf2_acc32"] = dict(
        source="tfhe_tpu_torch/csrc/blind_rotate_bnf2.cu",
        replaces="tfhe_tpu/ops/pbs_kernel.py:1848",
        launches=launches["blind_rotate_bnf2_acc32"], max_abs_err=k1_err,
        ms=k1_ms, plain_ms=k1_plain,
        bound=step_bound("blind_rotate_bnf2_acc32", BATCH, n, R,
                         p.pbs_level, N, 2, 4, rate),
        shape=f"2_2 B={BATCH} n={n}", plain_shape=f"2_2 B={BATCH} n={n}")
    return ck, sk, (ct, lut, out.ct), {"ks_gemm_ms": ks_ms, "ks_pbs_ms": step_ms,
                               "pbs_per_s": BATCH / step_ms * 1e3}


def phase_boolean(card, rate, rows):
    import torch

    from tfhe_tpu_torch import boolean
    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.ops import server as server_ops
    from tfhe_tpu_torch.utils.params import BOOLEAN_DEFAULT_PARAMETERS as p

    t0 = time.perf_counter()
    ck, sk = boolean.gen_keys(p, seed=SEED)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    print(f"keygen boolean default: {keygen_s:.1f} s, bsk_scan "
          f"{tuple(sk.bsk_scan.shape)} (P={sk.num_primes}), ksk_i8 "
          f"{tuple(sk.ksk_i8.shape)}")
    rng = np.random.default_rng(SEED + 1)
    a = rng.integers(0, 2, BOOL_BATCH).astype(bool)
    b = rng.integers(0, 2, BOOL_BATCH).astype(bool)
    c = rng.integers(0, 2, BOOL_BATCH).astype(bool)
    l, r, cond = ck.encrypt(a), ck.encrypt(b), ck.encrypt(c)
    R, N, n = p.glwe_size, p.polynomial_size, p.lwe_dimension

    # K2 u64 and K3 against their plain versions at the gate's shapes
    combo = l.ct + r.ct
    combo[..., -1] += boolean.PLAINTEXT_FALSE  # the and_ gate's input
    ms_mask, ms_body = server_ops.lwe_standard_modulus_switch(
        combo, N.bit_length())
    lut = sk._true_lut()
    k2_err, k2_plain = check_equal("body_rotate_u64", pk.body_rotate_u64,
                                   pk.body_rotate_u64_plain, (lut, ms_body))
    acc = pk.body_rotate_u64(lut, ms_body)
    k3_err, k3_plain = check_equal(
        "blind_rotate_crt", pk.blind_rotate_crt, pk.blind_rotate_crt_plain,
        (acc[:PLAIN_BATCH].contiguous(), ms_mask[:PLAIN_BATCH], sk.bsk_scan,
         p.pbs_base_log, p.pbs_level))
    print(f"K2 u64 == plain at B={BOOL_BATCH}; K3 (Garner, P=3) == plain at "
          f"B={PLAIN_BATCH}, n={n}, N={N}, R={R}, l={p.pbs_level}")

    # one gate call through the entry point, launch counts around it
    pk.reset_launches()
    out = sk.and_(l, r)
    torch.cuda.synchronize()
    launches = launches_of("body_rotate_u64", "blind_rotate_crt")
    require_launched("boolean and_", launches)
    if tuple(out.ct.shape) != (BOOL_BATCH, n + 1):
        raise AssertionError(f"gate output shape {tuple(out.ct.shape)}")
    truth = {"and_": a & b, "or_": a | b, "nand": ~(a & b), "nor": ~(a | b),
             "xor": a ^ b, "xnor": ~(a ^ b)}
    outs = {"and_": out}
    for g in ("or_", "nand", "nor", "xor", "xnor"):
        outs[g] = getattr(sk, g)(l, r)
    outs["not_"], truth["not_"] = sk.not_(l), ~a
    pk.reset_launches()
    outs["mux"], truth["mux"] = sk.mux(cond, l, r), np.where(c, a, b)
    mux_launches = launches_of("body_rotate_u64", "blind_rotate_crt")
    for g, want in truth.items():
        got = ck.decrypt(outs[g])
        if not np.array_equal(got, want):
            raise AssertionError(f"boolean {g}: {int((got != want).sum())} "
                                 f"of {BOOL_BATCH} decrypt wrong")
    print(f"boolean: all 8 gates decrypt to their truth tables on "
          f"{BOOL_BATCH} random inputs; mux launches {mux_launches}")

    # timing
    k2_ms = cuda_ms_loop(lambda: pk.body_rotate_u64(lut, ms_body),
                         K2_LAUNCHES)
    k3_ms = cuda_ms(lambda: pk.blind_rotate_crt(
        acc, ms_mask, sk.bsk_scan, p.pbs_base_log, p.pbs_level), 2)
    k3_small_ms = cuda_ms(lambda: pk.blind_rotate_crt(
        acc[:PLAIN_BATCH].contiguous(), ms_mask[:PLAIN_BATCH], sk.bsk_scan,
        p.pbs_base_log, p.pbs_level), 2)
    big = sk._bootstrap(combo)
    ks_ms = cuda_ms(lambda: sk._keyswitch(big), 5)
    gate_ms = cuda_ms(lambda: sk.and_(l, r), 3)
    mux_ms = cuda_ms(lambda: sk.mux(cond, l, r), 2, warmup=False)
    print(f"boolean B={BOOL_BATCH}: and_ {gate_ms:.3f} ms = "
          f"{BOOL_BATCH / gate_ms * 1e3:.1f} gates/s; mux {mux_ms:.3f} ms = "
          f"{BOOL_BATCH / mux_ms * 1e3:.1f} mux/s on {card}")
    print(f"boolean and_ breakdown B={BOOL_BATCH}: K3 {k3_ms:.3f} ms, "
          f"K2 u64 {k2_ms:.4f} ms, keyswitch {ks_ms:.3f} ms, rest "
          f"{gate_ms - k3_ms - k2_ms - ks_ms:.3f} ms; K3 at B={PLAIN_BATCH}: "
          f"{k3_small_ms:.3f} ms")
    k2_bound = bound(BOOL_BATCH * R * N * 6,
                     k2_bytes(BOOL_BATCH, R, N, True, 8), rate)
    rows["body_rotate_u64"] = dict(
        source="tfhe_tpu_torch/csrc/body_rotate.cu",
        replaces="tfhe_tpu/ops/pbs_kernel.py:1930",
        launches=launches["body_rotate_u64"], max_abs_err=k2_err, ms=k2_ms,
        plain_ms=k2_plain, bound=k2_bound,
        shape=f"boolean B={BOOL_BATCH}", plain_shape=f"boolean B={BOOL_BATCH}")
    rows["blind_rotate_crt"] = dict(
        source="tfhe_tpu_torch/csrc/blind_rotate_crt.cu",
        replaces="tfhe_tpu/ops/pbs_kernel.py:1867",
        launches=launches["blind_rotate_crt"], max_abs_err=k3_err, ms=k3_ms,
        plain_ms=k3_plain,
        bound=step_bound("blind_rotate_crt", BOOL_BATCH, n, R, p.pbs_level,
                         N, 3, 8, rate),
        small_ms=k3_small_ms,
        shape=f"boolean B={BOOL_BATCH} n={n} P=3",
        plain_shape=f"boolean B={PLAIN_BATCH} n={n} P=3")
    return ck, sk, {"bool_keygen_s": keygen_s, "and_ms": gate_ms,
                    "gates_per_s": BOOL_BATCH / gate_ms * 1e3,
                    "mux_ms": mux_ms, "mux_per_s": BOOL_BATCH / mux_ms * 1e3,
                    "bool_ks_ms": ks_ms}


def phase_trivium(ck, sk):
    import torch

    from tfhe_tpu_torch.apps.trivium import (ClearTrivium, TriviumStream,
                                             transcipher_decrypt)

    clear = ClearTrivium(TRIVIUM_KEY, TRIVIUM_IV)
    key_ct = ck.encrypt(np.array(TRIVIUM_KEY, dtype=bool))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream = TriviumStream.new(sk, key_ct, TRIVIUM_IV)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ks = stream.next_bits(256)
    torch.cuda.synchronize()
    ks_s = time.perf_counter() - t0
    got = [int(x) for x in ck.decrypt(ks)]
    if got != clear.next_bits(256):
        raise AssertionError("FHE Trivium keystream != clear Trivium")
    msg = [int(x) for x in np.random.default_rng(SEED + 2).integers(0, 2, 64)]
    sym = [m ^ z for m, z in zip(msg, clear.next_bits(64))]
    t0 = time.perf_counter()
    fhe_msg = transcipher_decrypt(stream, sym)
    torch.cuda.synchronize()
    tc_s = time.perf_counter() - t0
    if [int(x) for x in ck.decrypt(fhe_msg)] != msg:
        raise AssertionError("transciphered bits decrypt wrong")
    print(f"trivium: 1152-round FHE warm-up {warm_s:.2f} s; 256 keystream "
          f"bits == clear in {ks_s:.3f} s = {256 / ks_s:.1f} bits/s; 64 bits "
          f"transciphered in {tc_s:.3f} s")
    return {"trivium_warmup_s": warm_s, "trivium_bits_per_s": 256 / ks_s,
            "transcipher_64_s": tc_s}


def _side_batch(ck, sk, label, launch_names):
    """A 2_2 batch of SIDE_BATCH through apply_lookup_table with the launch
    counts zeroed around it; checks 3x mod 16. Returns the launches, the
    KS -> PBS ms and the step kernels' inputs on this batch: (LUT, mask,
    body)."""
    import torch

    from tfhe_tpu_torch.ops import pbs_kernel as pk

    p = ck.params
    mod = p.message_modulus * p.carry_modulus
    f = lambda x: (3 * x) % mod
    vals = np.arange(SIDE_BATCH, dtype=np.uint64) % mod
    ct = ck.encrypt(vals)
    lut = sk.generate_lookup_table(f)
    pk.reset_launches()
    out = sk.apply_lookup_table(ct, lut)
    torch.cuda.synchronize()
    launches = launches_of(*launch_names)
    require_launched(label, launches)
    want = np.array([f(int(v)) for v in vals], dtype=np.uint64)
    if not np.array_equal(ck.decrypt_message_and_carry(out), want):
        raise AssertionError(f"{label}: batch decrypts wrong")
    ms = cuda_ms(lambda: sk.apply_lookup_table(ct, lut), 2)
    print(f"{label}: {SIDE_BATCH} ciphertexts decrypt to 3x mod 16; KS->PBS "
          f"{ms:.3f} ms = {SIDE_BATCH / ms * 1e3:.1f} PBS/s")
    return launches, ms, (lut.acc, *switched(sk, ct))


def _random_acc_mask(rng, B, n, R, N):
    import torch

    from tfhe_tpu_torch._torus import from_u64

    acc = from_u64(rng.integers(0, 1 << 64, size=(B, R, N), dtype=np.uint64),
                   DEVICE)
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(B, n))).to(DEVICE)
    return acc, mask


def _side_kernels(label, kernel, plain, key, tail_args, inputs, seed):
    """K2 u64 and one K3 entry against their plain versions on a side
    phase's own batch (K3's on its first PLAIN_BATCH ciphertexts, all n
    steps, the whole key), then K3 on random u64 accumulators over 32 steps
    (the lo words borrow); K3 timed on the whole batch. Returns
    (max_abs_err, ms, plain_ms)."""
    from tfhe_tpu_torch.ops import pbs_kernel as pk

    lut_acc, ms_mask, ms_body = inputs
    check_equal(f"body_rotate_u64 {label}", pk.body_rotate_u64,
                pk.body_rotate_u64_plain, (lut_acc, ms_body))
    acc = pk.body_rotate_u64(lut_acc, ms_body)
    B, R, N = acc.shape
    name = kernel.__name__
    err, plain_ms = check_equal(
        f"{name} {label}", kernel, plain,
        (acc[:PLAIN_BATCH].contiguous(), ms_mask[:PLAIN_BATCH], key,
         *tail_args))
    steps = min(32, key.shape[0])
    racc, rmask = _random_acc_mask(np.random.default_rng(seed), PLAIN_BATCH,
                                   steps, R, N)
    check_equal(f"{name} {label}, random acc", kernel, plain,
                (racc, rmask, key[:steps].contiguous(), *tail_args))
    ms = cuda_ms(lambda: kernel(acc, ms_mask, key, *tail_args), 2)
    print(f"{label}: K2 u64 == plain at B={B}; {name} == plain at "
          f"B={PLAIN_BATCH}, n={key.shape[0]} (plain {plain_ms:.3f} ms) and "
          f"on random accumulators, 32 steps; {name} at B={B}: {ms:.3f} ms")
    return err, ms, plain_ms


def phase_shortint_crt(ck, rate, rows):
    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.shortint.server_key import ServerKey

    p = ck.params
    R, N, n = p.glwe_size, p.polynomial_size, p.lwe_dimension
    with env(TFHE_NTT_VARIANT="crt"):
        sk = ServerKey.generate(ck)
        if sk.variant != "crt" or sk.num_primes != 4:
            raise AssertionError(f"crt key: {sk.variant}, P={sk.num_primes}")
        launches, step_ms, inputs = _side_batch(
            ck, sk, "2_2 crt (P=4)", ("body_rotate_u64", "blind_rotate_crt"))
        err, ms, plain_ms = _side_kernels(
            "2_2 crt (P=4)", pk.blind_rotate_crt, pk.blind_rotate_crt_plain,
            sk.bsk_scan, (p.pbs_base_log, p.pbs_level), inputs, SEED + 3)
    rows["blind_rotate_crt_p4"] = dict(
        source="tfhe_tpu_torch/csrc/blind_rotate_crt.cu",
        replaces="tfhe_tpu/ops/pbs_kernel.py:1867",
        launches=launches["blind_rotate_crt"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms,
        bound=step_bound("blind_rotate_crt", SIDE_BATCH, n, R, p.pbs_level,
                         N, 4, 8, rate),
        shape=f"2_2 crt B={SIDE_BATCH} n={n} P=4",
        plain_shape=f"2_2 crt B={PLAIN_BATCH} n={n} P=4")
    return sk, {"crt_pbs_ms": step_ms,
                "crt_pbs_per_s": SIDE_BATCH / step_ms * 1e3}


def phase_two_plane(ck, rate, rows):
    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.shortint.server_key import ServerKey

    p = ck.params
    R, N, n = p.glwe_size, p.polynomial_size, p.lwe_dimension
    with env(TFHE_V4_ACC="64"):
        sk = ServerKey.generate(ck)
        if sk.variant != "v6b":
            raise AssertionError(f"two-plane key variant {sk.variant}")
        launches, step_ms, inputs = _side_batch(
            ck, sk, "2_2 v6b two-plane",
            ("body_rotate_u64", "blind_rotate_bnf2_u64"))
        err, ms, plain_ms = _side_kernels(
            "2_2 v6b two-plane", pk.blind_rotate_bnf2_u64,
            pk.blind_rotate_bnf2_u64_plain, sk.bsk_b,
            (p.pbs_base_log, p.pbs_level, sk.flavor), inputs, SEED + 4)
    rows["blind_rotate_bnf2_u64"] = dict(
        source="tfhe_tpu_torch/csrc/blind_rotate_crt.cu",
        replaces="tfhe_tpu/ops/pbs_kernel.py:1867",
        launches=launches["blind_rotate_bnf2_u64"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms,
        bound=step_bound("blind_rotate_bnf2_u64", SIDE_BATCH, n, R,
                         p.pbs_level, N, 2, 8, rate),
        shape=f"2_2 B={SIDE_BATCH} n={n}",
        plain_shape=f"2_2 B={PLAIN_BATCH} n={n}")
    return {"two_plane_pbs_ms": step_ms,
            "two_plane_pbs_per_s": SIDE_BATCH / step_ms * 1e3}


def phase_shortint_v5(ck, rate, rows):
    import torch

    from tfhe_tpu_torch._torus import from_u64
    from tfhe_tpu_torch.ops import goldilocks as gl
    from tfhe_tpu_torch.ops import kernel_bench as kb
    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.shortint.server_key import ServerKey
    from tfhe_tpu_torch.utils.params import PARAM_MESSAGE_1_CARRY_1_KS_PBS

    p = ck.params
    R, N, n = p.glwe_size, p.polynomial_size, p.lwe_dimension
    bl, lv = p.pbs_base_log, p.pbs_level
    k4, k4_plain = pk.blind_rotate_goldilocks, pk.blind_rotate_goldilocks_plain
    with env(TFHE_NTT_VARIANT="v5"):
        t0 = time.perf_counter()
        sk = ServerKey.generate(ck)
        torch.cuda.synchronize()
        keygen_s = time.perf_counter() - t0
    want_shape = (n, 2, lv * R, R, N // 128, 128)
    if sk.variant != "v5" or tuple(sk.bsk_g.shape) != want_shape:
        raise AssertionError(f"v5 key: {sk.variant}, bsk_g "
                             f"{tuple(sk.bsk_g.shape)} != {want_shape}")
    print(f"keygen 2_2 v5: {keygen_s:.1f} s, bsk_g "
          f"{tuple(sk.bsk_g.shape)}, K4 key {tuple(sk.bsk_g_k.shape)}")
    mod = p.message_modulus * p.carry_modulus
    f = lambda x: (3 * x) % mod
    vals = np.arange(BATCH, dtype=np.uint64) % mod
    ct = ck.encrypt(vals)
    lut = sk.generate_lookup_table(f)

    # the path through the entry point, every kernel's count around it
    pk.reset_launches()
    out = sk.apply_lookup_table(ct, lut)
    torch.cuda.synchronize()
    launches = launches_of("body_rotate_u64", "blind_rotate_goldilocks")
    others = launches_of("body_rotate_acc32", "blind_rotate_bnf2_acc32",
                         "blind_rotate_crt", "blind_rotate_bnf2_u64")
    print(f"2_2 v5 other kernels' launches: {others}")
    require_launched("2_2 v5 main path", launches)
    if set(launches.values()) != {1} or any(others.values()):
        raise AssertionError(f"2_2 v5: launches {launches}, {others}")
    want = np.array([f(int(v)) for v in vals], dtype=np.uint64)
    if not np.array_equal(ck.decrypt_message_and_carry(out), want):
        raise AssertionError("2_2 v5: batch decrypts wrong")
    print(f"2_2 v5: {BATCH} ciphertexts decrypt to 3x mod 16")

    # K2 u64 and K4 against their plain versions on this batch's inputs
    ms_mask, ms_body = switched(sk, ct)
    check_equal("body_rotate_u64 2_2 v5", pk.body_rotate_u64,
                pk.body_rotate_u64_plain, (lut.acc, ms_body))
    acc = pk.body_rotate_u64(lut.acc, ms_body)
    # K4 reads the key in its own order, prepared once per key: the
    # ServerKey's cached bsk_g_k on the path's check, one made from each
    # extra check's own key otherwise
    err, plain_ms = check_equal(
        "blind_rotate_goldilocks 2_2 v5",
        functools.partial(k4, bsk_k=sk.bsk_g_k), k4_plain,
        (acc[:PLAIN_BATCH].contiguous(), ms_mask[:PLAIN_BATCH], sk.bsk_g, bl,
         lv))
    rng = np.random.default_rng(SEED + 5)
    steps = min(32, n)
    racc, rmask = _random_acc_mask(rng, PLAIN_BATCH, steps, R, N)
    g = sk.bsk_g[:steps].contiguous()
    check_equal("blind_rotate_goldilocks 2_2 v5, random acc",
                functools.partial(k4, bsk_k=pk.goldilocks_kernel_key(g)),
                k4_plain, (racc, rmask, g, bl, lv))
    p11 = PARAM_MESSAGE_1_CARRY_1_KS_PBS
    R11, N11 = p11.glwe_size, p11.polynomial_size
    std = rng.integers(0, 1 << 64, size=(32, p11.pbs_level, R11, R11, N11),
                       dtype=np.uint64)
    racc, rmask = _random_acc_mask(rng, PLAIN_BATCH, 32, R11, N11)
    g = gl.bootstrap_key_to_goldilocks(from_u64(std, DEVICE))
    check_equal("blind_rotate_goldilocks 1_1 geometry",
                functools.partial(k4, bsk_k=pk.goldilocks_kernel_key(g)),
                k4_plain, (racc, rmask, g, p11.pbs_base_log, p11.pbs_level))
    print(f"2_2 v5: K2 u64 == plain at B={BATCH}; K4 == plain at "
          f"B={PLAIN_BATCH}, n={n} (plain {plain_ms:.3f} ms), on random "
          f"accumulators ({steps} steps) and at 1_1 geometry (R={R11}, "
          f"N={N11}, 32 steps)")

    # timing
    k4_ms = cuda_ms(lambda: k4(acc, ms_mask, sk.bsk_g, bl, lv, sk.bsk_g_k), 3)
    step_ms = cuda_ms(lambda: sk.apply_lookup_table(ct, lut), 3)
    print(f"2_2 v5 KS->PBS B={BATCH}: {step_ms:.3f} ms = "
          f"{BATCH / step_ms * 1e3:.1f} PBS/s; K4 {k4_ms:.3f} ms "
          f"({100 * k4_ms / step_ms:.1f} %)")
    rows["blind_rotate_goldilocks"] = dict(
        source="tfhe_tpu_torch/csrc/blind_rotate_goldilocks.cu",
        replaces="tfhe_tpu/ops/pbs_kernel_g.py:667",
        launches=launches["blind_rotate_goldilocks"], max_abs_err=err,
        ms=k4_ms, plain_ms=plain_ms,
        bound=bound(kb.step_pipe_instructions(
            "blind_rotate_goldilocks", BATCH, n, R, lv, N, 1),
            step_bytes(BATCH, n, R, lv, N, 1, 8), rate),
        shape=f"2_2 v5 B={BATCH} n={n}",
        plain_shape=f"2_2 v5 B={PLAIN_BATCH} n={n}")
    return {"v5_keygen_s": keygen_s, "v5_pbs_ms": step_ms,
            "v5_pbs_per_s": BATCH / step_ms * 1e3, "v5_k4_ms": k4_ms}


def phase_boolean_acc32(ck, sk, card, rate, rows, exact_and_ms):
    """Phase 3's keys and gates under TFHE_V4_ACC=32: the same bootstrap
    key, run through K2 acc32 and K3-acc32."""
    import torch

    from tfhe_tpu_torch import boolean
    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.ops import server as server_ops

    p = sk.params
    R, N, n = p.glwe_size, p.polynomial_size, p.lwe_dimension
    rng = np.random.default_rng(SEED + 6)
    a, b, c = (rng.integers(0, 2, BOOL_BATCH).astype(bool) for _ in range(3))
    l, r, cond = ck.encrypt(a), ck.encrypt(b), ck.encrypt(c)
    combo = l.ct + r.ct
    combo[..., -1] += boolean.PLAINTEXT_FALSE  # the and_ gate's input
    ms_mask, ms_body = server_ops.lwe_standard_modulus_switch(
        combo, N.bit_length())
    lut = sk._true_lut()
    with env(TFHE_V4_ACC="32"):
        if not server_ops.crt_acc32_requested(N, p.pbs_base_log, p.pbs_level):
            raise AssertionError("TFHE_V4_ACC=32 does not select acc32")
        pk.reset_launches()
        out = sk.and_(l, r)
        torch.cuda.synchronize()
        launches = launches_of("body_rotate_acc32", "blind_rotate_crt_acc32")
        others = launches_of("body_rotate_u64", "blind_rotate_crt")
        print(f"boolean acc32 and_ launches {launches}, exact kernels "
              f"{others}")
        if set(launches.values()) != {1} or any(others.values()):
            raise AssertionError(f"boolean acc32: launches {launches}, "
                                 f"{others}")
        truth = {"and_": a & b, "or_": a | b, "nand": ~(a & b),
                 "nor": ~(a | b), "xor": a ^ b, "xnor": ~(a ^ b)}
        outs = {"and_": out}
        for g in ("or_", "nand", "nor", "xor", "xnor"):
            outs[g] = getattr(sk, g)(l, r)
        outs["not_"], truth["not_"] = sk.not_(l), ~a
        outs["mux"], truth["mux"] = sk.mux(cond, l, r), np.where(c, a, b)
        for g, want in truth.items():
            got = ck.decrypt(outs[g])
            if not np.array_equal(got, want):
                raise AssertionError(f"boolean acc32 {g}: "
                                     f"{int((got != want).sum())} of "
                                     f"{BOOL_BATCH} decrypt wrong")
        print(f"boolean acc32: all 8 gates decrypt to their truth tables on "
              f"{BOOL_BATCH} random inputs")

        # K2 acc32 and K3-acc32 against their plain versions
        k2_err, k2_plain = check_equal(
            "body_rotate_acc32 boolean", pk.body_rotate_acc32,
            pk.body_rotate_acc32_plain, (lut, ms_body))
        hi = pk.body_rotate_acc32(lut, ms_body)
        err, plain_ms = check_equal(
            "blind_rotate_crt_acc32 boolean", pk.blind_rotate_crt_acc32,
            pk.blind_rotate_crt_acc32_plain,
            (hi[:PLAIN_BATCH].contiguous(), ms_mask[:PLAIN_BATCH],
             sk.bsk_scan, p.pbs_base_log, p.pbs_level))
        print(f"K2 acc32 == plain at B={BOOL_BATCH}; K3-acc32 == plain at "
              f"B={PLAIN_BATCH}, n={n} (plain {plain_ms:.3f} ms)")

        # timing
        ms = cuda_ms(lambda: pk.blind_rotate_crt_acc32(
            hi, ms_mask, sk.bsk_scan, p.pbs_base_log, p.pbs_level), 2)
        gate_ms = cuda_ms(lambda: sk.and_(l, r), 3)
    print(f"boolean acc32 B={BOOL_BATCH}: and_ {gate_ms:.3f} ms = "
          f"{BOOL_BATCH / gate_ms * 1e3:.1f} gates/s (exact: "
          f"{exact_and_ms:.3f} ms); K3-acc32 {ms:.3f} ms on {card}")
    rows["blind_rotate_crt_acc32"] = dict(
        source="tfhe_tpu_torch/csrc/blind_rotate_crt.cu",
        replaces="tfhe_tpu/ops/pbs_kernel.py:1867",
        launches=launches["blind_rotate_crt_acc32"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms,
        bound=step_bound("blind_rotate_crt_acc32", BOOL_BATCH, n, R,
                         p.pbs_level, N, 3, 4, rate),
        shape=f"boolean B={BOOL_BATCH} n={n} P=3",
        plain_shape=f"boolean B={PLAIN_BATCH} n={n} P=3")
    return {"acc32_and_ms": gate_ms,
            "acc32_gates_per_s": BOOL_BATCH / gate_ms * 1e3,
            "acc32_k3_ms": ms, "acc32_k2_plain_ms": k2_plain}


def phase_shortint_v4_acc32(ck, sk, rate, rows):
    """Phase 5's 4-prime CRT key under TFHE_NTT_VARIANT=v4 TFHE_V4_ACC=32:
    the exact CRT path's acc32 mode (K2 acc32, K3-acc32)."""
    from tfhe_tpu_torch._torus import from_u32
    from tfhe_tpu_torch.ops import pbs_kernel as pk

    p = ck.params
    R, N, n = p.glwe_size, p.polynomial_size, p.lwe_dimension
    bl, lv = p.pbs_base_log, p.pbs_level
    k3, k3_plain = pk.blind_rotate_crt_acc32, pk.blind_rotate_crt_acc32_plain
    label = "2_2 v4 acc32 (P=4)"
    with env(TFHE_NTT_VARIANT="v4", TFHE_V4_ACC="32"):
        launches, step_ms, (lut_acc, ms_mask, ms_body) = _side_batch(
            ck, sk, label, ("body_rotate_acc32", "blind_rotate_crt_acc32"))
        others = launches_of("body_rotate_u64", "blind_rotate_crt")
        if set(launches.values()) != {1} or any(others.values()):
            raise AssertionError(f"{label}: launches {launches}, {others}")
        # K2 acc32 and K3-acc32 against their plain versions on this
        # batch's own inputs (K3-acc32's on its first PLAIN_BATCH
        # ciphertexts, all n steps, the whole key)
        check_equal(f"body_rotate_acc32 {label}", pk.body_rotate_acc32,
                    pk.body_rotate_acc32_plain, (lut_acc, ms_body))
        hi = pk.body_rotate_acc32(lut_acc, ms_body)
        err, plain_ms = check_equal(
            f"blind_rotate_crt_acc32 {label}", k3, k3_plain,
            (hi[:PLAIN_BATCH].contiguous(), ms_mask[:PLAIN_BATCH],
             sk.bsk_scan, bl, lv))
        # and on random accumulators over 32 steps
        rng = np.random.default_rng(SEED + 7)
        steps = 32
        racc = from_u32(rng.integers(0, 1 << 32, size=(PLAIN_BATCH, R, N),
                                     dtype=np.uint32), DEVICE)
        _, rmask = _random_acc_mask(rng, PLAIN_BATCH, steps, R, N)
        check_equal(f"blind_rotate_crt_acc32 {label}, random acc", k3,
                    k3_plain,
                    (racc, rmask, sk.bsk_scan[:steps].contiguous(), bl, lv))
        ms = cuda_ms(lambda: k3(hi, ms_mask, sk.bsk_scan, bl, lv), 2)
    print(f"{label}: K2 acc32 == plain at B={SIDE_BATCH}; K3-acc32 == plain "
          f"at B={PLAIN_BATCH}, n={n} (plain {plain_ms:.3f} ms) and on "
          f"random accumulators, {steps} steps; K3-acc32 at B={SIDE_BATCH}: "
          f"{ms:.3f} ms")
    rows["blind_rotate_crt_acc32_p4"] = dict(
        source="tfhe_tpu_torch/csrc/blind_rotate_crt.cu",
        replaces="tfhe_tpu/ops/pbs_kernel.py:1867",
        launches=launches["blind_rotate_crt_acc32"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms,
        bound=step_bound("blind_rotate_crt_acc32", SIDE_BATCH, n, R, lv, N,
                         4, 4, rate),
        shape=f"2_2 v4 acc32 B={SIDE_BATCH} n={n} P=4",
        plain_shape=f"2_2 v4 acc32 B={PLAIN_BATCH} n={n} P=4")
    return {"v4_acc32_pbs_ms": step_ms,
            "v4_acc32_pbs_per_s": SIDE_BATCH / step_ms * 1e3,
            "v4_acc32_k3_ms": ms}


def phase_stacked_env(sk, ct, lut, want):
    """TFHE_V6_STACKED=1 selects a TPU layout of K1's function; nothing in
    the port reads it, and the layout's parity with K1 is the CPU test
    ``test_stacked_step_equals_plain_k1``. This checks what the variable
    could change on the card: with it set, phase 2's batch takes the same
    kernels (K2 acc32 and K1 once, no other) and gives phase 2's ciphertext
    ``want`` bit for bit (so K1 also repeats its bits)."""
    import torch

    from tfhe_tpu_torch.ops import pbs_kernel as pk

    with env(TFHE_V6_STACKED="1"):
        pk.reset_launches()
        got = sk.apply_lookup_table(ct, lut)
        torch.cuda.synchronize()
    launches = launches_of(*(fn.__name__ for fn in pk.KERNELS))
    want_launches = {k: int(k in ("body_rotate_acc32",
                                  "blind_rotate_bnf2_acc32"))
                     for k in launches}
    if launches != want_launches:
        raise AssertionError(f"TFHE_V6_STACKED=1 launches {launches}")
    if not torch.equal(got.ct, want):
        raise AssertionError("TFHE_V6_STACKED=1: the ciphertext differs from "
                             "phase 2's")
    print(f"TFHE_V6_STACKED=1: 2_2 batch of {ct.ct.shape[0]} bit-equal to "
          f"phase 2's run; launches {launches}")


def phase_kernel_bench(rate, rows):
    """The micro-kernels held exactly against their plain versions at
    KB_CHECK_LOOPS passes over the bench's own rows and timed there, then
    kernel_bench.run_all(quick=True) with the launch counts around it."""
    from tfhe_tpu_torch.ops import kernel_bench as kb

    t0 = time.perf_counter()
    inputs = kb.micro_inputs(DEVICE)
    checked = {}
    for fn in kb.MICRO_KERNELS:
        name = fn.__name__
        args = inputs[name] + (KB_CHECK_LOOPS,)
        err, plain_ms = check_equal(name, fn, getattr(kb, f"{name}_plain"),
                                    args)
        ms = cuda_ms(lambda: fn(*args), 5)
        rows_n, N = args[0].shape
        nbytes = 2 * args[0].numel() * args[0].element_size()
        checked[name] = dict(
            source="tfhe_tpu_torch/csrc/kernel_bench.cu",
            replaces="tfhe_tpu/ops/kernel_bench.py:91", max_abs_err=err,
            ms=ms, plain_ms=plain_ms,
            bound=bound(kb.micro_pipe_instructions(name, rows_n, N,
                                                   KB_CHECK_LOOPS),
                        nbytes, rate),
            shape=f"{rows_n} rows x N={N}, {KB_CHECK_LOOPS} passes",
            plain_shape=f"{rows_n} rows x N={N}, {KB_CHECK_LOOPS} passes")
        print(f"{name} == plain at {rows_n} rows, {KB_CHECK_LOOPS} passes: "
              f"{ms:.4f} ms (plain {plain_ms:.3f} ms)")
    checked.update(step_references(rate))
    kb.reset_launches()
    bench_rows = kb.run_all(quick=True)
    for row in bench_rows:
        print(f"kernel bench: {json.dumps(row)}")
    for fn in kb.MICRO_KERNELS + kb.STEP_REFERENCES:
        if fn.launches < 1:
            raise AssertionError(f"kernel bench: {fn.__name__} did not "
                                 "launch")
        rows[fn.__name__] = dict(launches=fn.launches, **checked[fn.__name__])
    secs = time.perf_counter() - t0
    print(f"kernel bench phase: {secs:.1f} s")
    return {"kernel_bench_s": secs,
            "kernel_bench": {r["metric"]: r["value"] for r in bench_rows}}


def step_references(rate) -> dict:
    """The kernel bench's reference loops (K1's and K3 P = 4's function on
    the radix-2 step loop) held exactly against their plain versions on
    random 2_2 accumulators over 32 steps of a random key, and timed on
    that case."""
    from tfhe_tpu_torch._torus import from_u64
    from tfhe_tpu_torch.core import algorithms as algo
    from tfhe_tpu_torch.core.entities import LweBootstrapKey
    from tfhe_tpu_torch.ops import bnf2 as b2
    from tfhe_tpu_torch.ops import kernel_bench as kb
    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.utils.params import PARAM_MESSAGE_2_CARRY_2_KS_PBS

    p = PARAM_MESSAGE_2_CARRY_2_KS_PBS
    R, N, l, n = p.glwe_size, p.polynomial_size, p.pbs_level, 32
    rng = np.random.default_rng(SEED + 8)
    acc32, mask, bsk2 = random_k1_case(rng, PLAIN_BATCH, n, R, l, N,
                                       b2.DEFAULT)
    acc64, mask64 = _random_acc_mask(rng, PLAIN_BATCH, n, R, N)
    std = from_u64(rng.integers(0, 1 << 64, size=(n, l, R, R, N),
                                dtype=np.uint64), DEVICE)
    key4 = pk.bsk_to_scan_layout(algo.bootstrap_key_to_ntt(
        LweBootstrapKey(std, p.pbs_base_log, l), 4).residues)
    out = {}
    for fn, plain, args, entry, P, acc_bytes, site in (
            (kb.kb_step_bnf2_acc32_r2, pk.blind_rotate_bnf2_acc32_plain,
             (acc32, mask, bsk2, p.pbs_base_log, l),
             "blind_rotate_bnf2_acc32", 2, 4,
             "tfhe_tpu/ops/pbs_kernel.py:1848"),
            (kb.kb_step_crt_r2, pk.blind_rotate_crt_plain,
             (acc64, mask64, key4, p.pbs_base_log, l), "blind_rotate_crt", 4,
             8, "tfhe_tpu/ops/pbs_kernel.py:1867")):
        name = fn.__name__
        err, plain_ms = check_equal(name, fn, plain, args)
        ms = cuda_ms(lambda: fn(*args), 3)
        out[name] = dict(
            source="tfhe_tpu_torch/csrc/kernel_bench.cu", replaces=site,
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound=step_bound(entry, PLAIN_BATCH, n, R, l, N, P, acc_bytes,
                             rate),
            shape=f"2_2, B={PLAIN_BATCH}, n={n} (the radix-2 step loop)",
            plain_shape=f"2_2, B={PLAIN_BATCH}, n={n}")
        print(f"{name} == plain at 2_2, B={PLAIN_BATCH}, n={n}: {ms:.3f} ms "
              f"(plain {plain_ms:.3f} ms)")
    return out


def probe_modules() -> dict:
    from tfhe_tpu_torch.tools import (kernel_experiments, mxu_probe,
                                      ntt_v3c_experiments, ntt_variants,
                                      v4_probe, vpu_primitives)

    return {"vpu": vpu_primitives, "ntt": ntt_variants, "step": v4_probe,
            "mxu": mxu_probe, "e": kernel_experiments,
            "v3c": ntt_v3c_experiments}


def phase_probes(rows, bench):
    """The TPU design probes: every case's kernel held exactly against its
    plain version at its check trip count on its check inputs, and timed at
    its high trip count (beside ``library_ms``: that many calls of the one
    PyTorch call that computes a trip, where there is one, timed back to
    back); then each
    probe's run_all(quick=True) with the launch counts around it. ``bench``: phase 11's rows, whose step times the split of
    K1's and K3's ciphertext-step is held to. The tensor-core verdict is
    read from the rows of that run."""
    from tfhe_tpu_torch.ops import kernel_bench as kb
    from tfhe_tpu_torch.tools import _harness as h
    from tfhe_tpu_torch.tools import ntt_mxu

    t0 = time.perf_counter()
    rates = kb.card_rates()
    checked = {}
    turns = {}
    for short, mod in probe_modules().items():
        for c in mod.CASES + getattr(mod, "SYNC_CASES", ()):
            lib = mod.SASS_LOOP_TOTALS[c.kernel][0]
            src = f"tfhe_tpu_torch/csrc/{lib}.cu"
            args, check_args = c.inputs(DEVICE), c.check_inputs(DEVICE)
            err, plain_ms = h.check(c, check_args)
            trips = c.trips[1]
            if c.reference is not None:  # ref, new, new, ref
                ref = c.reference
                ms, turns[f"{short}.{ref.name}"] = in_turns(
                    lambda: c(*args, trips), lambda: ref(*args, trips))
            else:
                ms = turns.pop(f"{short}.{c.name}", None) or cuda_ms(
                    lambda: c(*args, trips), 3)
            pipes = c.pipes(h.kernel_loops(mod.SASS_LOOP_TOTALS, c.kernel),
                            args)
            nbytes = (sum(a.numel() * a.element_size() for a in args)
                      + args[0].numel() * args[0].element_size())
            *bnd, term = probe_bound(kb.busier_pipe(*pipes) * trips,
                                     c.macs(args) * trips, nbytes, rates)
            checked[f"{short}.{c.name}"] = dict(
                source=src, replaces=c.replaces, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound=tuple(bnd), bound_term=term,
                library_ms=(trips * cuda_ms_loop(lambda: c.library(*args),
                                                 64)
                            if c.library else None),
                shape=f"{tuple(args[0].shape)}, {trips} trips",
                plain_shape=f"{tuple(check_args[0].shape)}, {c.check} trips")
    print(f"probes: {len(checked)} kernels == plain at their check trips")
    measured = {}
    for k, (_, _, metric) in probe_modules()["step"].STEPS.items():
        measured[k] = 1.0 / bench[metric]
        measured[f"{k}_r2"] = 1.0 / bench[f"{metric}_r2"]
    out, by_metric = {}, {}
    for short, mod in probe_modules().items():
        mod.reset_launches()
        kw = {"measured": measured} if short == "step" else {}
        for r in mod.run_all(quick=True, device=DEVICE, **kw):
            print(f"probe {short}: {json.dumps(r)}")
            by_metric.setdefault(r["metric"], r)
            if r["metric"] in ("imad_wide_verdict", "step_split_K1",
                               "step_split_K3_P4", "pass_split_K1",
                               "pass_split_K3_P4", "mix_overlap"):
                out[r["metric"]] = r
        for c in mod.CASES + getattr(mod, "SYNC_CASES", ()):
            if c.launches < 1:
                raise AssertionError(f"probe {short}: {c.name} did not "
                                     "launch")
            rows[f"{short}.{c.name}"] = dict(launches=c.launches,
                                             **checked[f"{short}.{c.name}"])
    out["mxu_verdict"] = ntt_mxu.verdict(by_metric)
    print(f"mxu_verdict: {json.dumps(out['mxu_verdict'])}")
    secs = time.perf_counter() - t0
    print(f"probes phase: {secs:.1f} s")
    return {"probes_s": secs, **out}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import tfhe_tpu_torch  # noqa: F401  (raises outside a checkout of the repo)

    t_start = time.perf_counter()
    card = nvidia_smi("name,power.limit")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    from tfhe_tpu_torch.ops import kernel_bench as kb

    rate = kb.card_rates()["int32"]
    print(f"INT32 rate {rate / 1e12:.2f} Tops/s")

    rows: dict = {}
    summary = {"build_s": phase_build(), "card": card}
    ck22, sk22, batch22, s = phase_shortint_v6b(card, rate, rows)
    summary.update(s)
    bck, bsk, s = phase_boolean(card, rate, rows)
    summary.update(s)
    summary.update(phase_trivium(bck, bsk))
    sk_crt, s = phase_shortint_crt(ck22, rate, rows)
    summary.update(s)
    summary.update(phase_two_plane(ck22, rate, rows))
    summary.update(phase_shortint_v5(ck22, rate, rows))
    summary.update(phase_boolean_acc32(bck, bsk, card, rate, rows,
                                       summary["and_ms"]))
    summary.update(phase_shortint_v4_acc32(ck22, sk_crt, rate, rows))
    phase_stacked_env(sk22, *batch22)
    summary.update(phase_kernel_bench(rate, rows))
    summary.update(phase_probes(rows, summary["kernel_bench"]))

    order = ("body_rotate_acc32", "blind_rotate_bnf2_acc32", "body_rotate_u64",
             "blind_rotate_crt", "blind_rotate_crt_p4",
             "blind_rotate_bnf2_u64", "blind_rotate_goldilocks",
             "blind_rotate_crt_acc32", "blind_rotate_crt_acc32_p4",
             "kb_ntt_fwd", "kb_ntt_inv", "kb_mac", "kb_rotate", "kb_decompose",
             "kb_step_bnf2_acc32_r2", "kb_step_crt_r2")
    order += tuple(f"{short}.{c.name}" for short, mod in
                   probe_modules().items()
                   for c in mod.CASES + getattr(mod, "SYNC_CASES", ()))
    kernels = []
    for name in order:
        r = rows[name]
        bound_ms, bound_by = r.pop("bound")
        kernels.append(dict(
            name=name, route="cuda", source=r.pop("source"),
            replaces=r.pop("replaces"), launches=r.pop("launches"),
            max_abs_err=r["max_abs_err"], max_abs_diff=r.pop("max_abs_err"),
            ms=r.pop("ms"), plain_ms=r.pop("plain_ms"), bound_ms=bound_ms,
            bound_by=bound_by, library_ms=r.pop("library_ms", None), **r))
    summary["total_s"] = time.perf_counter() - t_start
    print(json.dumps(summary))
    print(f"total: {summary['total_s']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
