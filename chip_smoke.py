#!/usr/bin/env python3
"""Drive tfhe_tpu_torch's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. build every CUDA kernel from ``tfhe_tpu_torch/csrc`` (one nvcc per
   source, all at once) and print the build time and ptxas' register,
   spill and shared-memory report;
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
8. the card's name and power limit, a ``{"kernels": [...]}`` line, and last
   the ``{"ok": true, "device": {...}}`` line.

Times are CUDA events: a kernel's ``ms`` is the median of a few runs (K2:
the mean of 200 back-to-back launches between one pair of events). Bounds:
``bound_ms`` is the larger of the bytes the kernel must move over the
card's HBM rate (3.35 TB/s, H100 SXM data sheet) and its integer
operations over the rate of one 64-lane-per-SM integer pipe (64 lanes x
SMs x max SM clock): K1-K3 by ``step_int32_ops`` (32-bit operations
counted from the source), K4 by ``goldilocks_step_int32_ops``
(instructions per pipe counted from the SASS of the build).
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
INT32_LANES_PER_SM = 64  # Hopper SM: 64 INT32 units per SM
K2_LAUNCHES = 200  # back-to-back launches per K2 timing
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


def int32_rate() -> float:
    """INT32 operations per second of card 0 at its max SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def garner_ops(P: int) -> int:
    """int32 operations of the Garner tail per coefficient: for digit i,
    i-1 Horner Shoup multiply-adds (7) and the difference plus its Shoup
    multiply (8); P-1 u64 multiply-adds (5); the sign select (4)."""
    return sum(7 * (i - 1) + 8 for i in range(1, P)) + 5 * (P - 1) + 4


BNF2_C32_OPS = 12  # qp_to_torus32: Shoup multiply, widening multiply, adds
BNF2_C_OPS = 30  # crt2_merge + qp_to_torus on u32 pairs


def step_int32_ops(B: int, n: int, R: int, levels: int, N: int, P: int,
                   tail_ops: int) -> float:
    """int32 operations of a blind-rotation kernel: per step and
    ciphertext, P*l*R forward and P*R inverse transforms of N/2*log2(N)
    butterflies (10 ops each: a Shoup multiply of 6 and two modular
    add/subs), the twist of P*l*R*N digits and the untwist of P*R*N
    residues (6 each), P*R*l*R*N Shoup MACs (8 each) and the tail on R*N
    coefficients."""
    lR = levels * R
    log_n = N.bit_length() - 1
    per = ((P * lR + P * R) * (N // 2) * log_n * 10
           + (P * lR * N + P * R * N) * 6 + P * R * lR * N * 8
           + R * N * tail_ops)
    return float(B) * n * per


#: K4's instructions per unit of work as sm_90a runs them, (ALU pipe,
#: FMA pipe): the instructions of each loop body of
#: ``csrc/blind_rotate_goldilocks.cu`` that read the loaded data or a value
#: computed from it (index arithmetic, loads, stores and branches left
#: out), read from the SASS the build leaves in
#: ``tfhe_tpu_torch/_build/libblind_rotate_goldilocks.sass`` (the nvcc
#: that phase 1 prints, -O3). IMAD in all its forms (.WIDE, .X, .MOV,
#: .IADD) runs on the FMA pipe; IADD3, ISETP, SEL, LOP3, SHF and the
#: rest on the ALU pipe. A 64 x 64 -> 128-bit product is 7-11
#: instructions (IMAD.WIDE.U32 fuses a 32 x 32 product with a 64-bit add
#: and its carry); the reduction mod p and the canonical select take ~22
#: more, mostly 64-bit compares and selects on the ALU pipe.
K4_SASS_OPS = {
    "element": (14, 3),  # per R*N: rotate, negate, rot - acc, digit state
    "digit": (34, 10),  # per l*R*N: next digit, lift into Z_p, twist
    "fwd_butterfly": (39, 12),  # g_add, g_sub, g_mul
    "mac": (32, 15),  # per R*l*R*N: g_mul, g_add into the sum
    "inv_butterfly": (39, 16),  # g_mul, g_add, g_sub
    "untwist": (23, 12),  # per R*N: g_mul, x + (x >> 32), acc +=
}


def goldilocks_step_int32_ops(B: int, n: int, R: int, levels: int,
                              N: int) -> float:
    """K4's operations in units of one 64-lane-per-SM pipe: per step and
    ciphertext, R*N elements, l*R*N digits, l*R forward and R inverse
    transforms of N/2*log2(N) butterflies, R*l*R*N MAC products and R*N
    untwists, each at :data:`K4_SASS_OPS`. The ALU and FMA pipes each
    have 64 lanes per SM and run side by side, at most 128 instructions
    per SM and clock in all, so the count is the busier pipe's, or half
    the total when that is more."""
    lR, half_log = levels * R, (N // 2) * (N.bit_length() - 1)
    units = {"element": R * N, "digit": lR * N,
             "fwd_butterfly": lR * half_log, "mac": R * lR * N,
             "inv_butterfly": R * half_log, "untwist": R * N}
    alu = sum(units[k] * K4_SASS_OPS[k][0] for k in units)
    fma = sum(units[k] * K4_SASS_OPS[k][1] for k in units)
    return float(B) * n * max(alu, fma, (alu + fma) / 2)


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


def check_equal(name, kernel, plain, args, plain_reps: int = 3):
    """Kernel vs plain version on the same inputs, exact; returns the
    max_abs_err (0) and the plain version's time (ms), the median of
    ``plain_reps`` more runs after the comparison run warmed it up."""
    got = kernel(*args)
    want = plain(*args)
    err = max_abs_err(got, want)
    if tuple(got.shape) != tuple(want.shape) or err != 0:
        raise AssertionError(f"{name}: kernel != plain version "
                             f"(max_abs_diff {err})")
    return err, cuda_ms(lambda: plain(*args), plain_reps, warmup=False)


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

def phase_build():
    from tfhe_tpu_torch import _build
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
    for label, args in (
            ("K1 2_2", ("blind_rotate_bnf2_acc32", 2, 2, 1, 2048)),
            ("K3 boolean default (P=3)", ("blind_rotate_crt", 3, 4, 2, 512)),
            ("K3 2_2 crt (P=4)", ("blind_rotate_crt", 4, 2, 1, 2048)),
            ("K3-bnf2 2_2 two-plane", ("blind_rotate_bnf2_u64", 2, 2, 1,
                                       2048)),
            ("K4 2_2 v5", ("blind_rotate_goldilocks", 1, 2, 1, 2048)),
            ("K4 1_1 v5", ("blind_rotate_goldilocks", 1, 5, 1, 512))):
        print(f"  dynamic shared memory per block, {label}: "
              f"{pk.step_smem_bytes(*args) / 1024:.0f} KiB")
    return secs


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
    k2_err, k2_plain = check_equal("body_rotate_acc32", pk.body_rotate_acc32,
                                   pk.body_rotate_acc32_plain,
                                   (lut.acc, ms_body))
    acc_hi = pk.body_rotate_acc32(lut.acc, ms_body)
    k1_err, k1_plain = check_equal(
        "blind_rotate_bnf2_acc32", pk.blind_rotate_bnf2_acc32,
        pk.blind_rotate_bnf2_acc32_plain,
        (acc_hi, ms_mask, sk.bsk_b, p.pbs_base_log, p.pbs_level, fl),
        plain_reps=1)
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
    k1_bound = bound(step_int32_ops(BATCH, n, R, p.pbs_level, N, 2,
                                    BNF2_C32_OPS),
                     step_bytes(BATCH, n, R, p.pbs_level, N, 2, 4), rate)
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
        ms=k1_ms, plain_ms=k1_plain, bound=k1_bound,
        shape=f"2_2 B={BATCH} n={n}", plain_shape=f"2_2 B={BATCH} n={n}")
    return ck, {"ks_gemm_ms": ks_ms, "ks_pbs_ms": step_ms,
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
    k3_bound = bound(step_int32_ops(BOOL_BATCH, n, R, p.pbs_level, N, 3,
                                    garner_ops(3)),
                     step_bytes(BOOL_BATCH, n, R, p.pbs_level, N, 3, 8), rate)
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
        plain_ms=k3_plain, bound=k3_bound, small_ms=k3_small_ms,
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
         *tail_args), plain_reps=1)
    steps = min(32, key.shape[0])
    racc, rmask = _random_acc_mask(np.random.default_rng(seed), PLAIN_BATCH,
                                   steps, R, N)
    check_equal(f"{name} {label}, random acc", kernel, plain,
                (racc, rmask, key[:steps].contiguous(), *tail_args),
                plain_reps=1)
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
        bound=bound(step_int32_ops(SIDE_BATCH, n, R, p.pbs_level, N, 4,
                                   garner_ops(4)),
                    step_bytes(SIDE_BATCH, n, R, p.pbs_level, N, 4, 8), rate),
        shape=f"2_2 crt B={SIDE_BATCH} n={n} P=4",
        plain_shape=f"2_2 crt B={PLAIN_BATCH} n={n} P=4")
    return {"crt_pbs_ms": step_ms, "crt_pbs_per_s": SIDE_BATCH / step_ms * 1e3}


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
        bound=bound(step_int32_ops(SIDE_BATCH, n, R, p.pbs_level, N, 2,
                                   BNF2_C_OPS),
                    step_bytes(SIDE_BATCH, n, R, p.pbs_level, N, 2, 8), rate),
        shape=f"2_2 B={SIDE_BATCH} n={n}",
        plain_shape=f"2_2 B={PLAIN_BATCH} n={n}")
    return {"two_plane_pbs_ms": step_ms,
            "two_plane_pbs_per_s": SIDE_BATCH / step_ms * 1e3}


def phase_shortint_v5(ck, rate, rows):
    import torch

    from tfhe_tpu_torch._torus import from_u64
    from tfhe_tpu_torch.ops import goldilocks as gl
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
         lv), plain_reps=1)
    rng = np.random.default_rng(SEED + 5)
    steps = min(32, n)
    racc, rmask = _random_acc_mask(rng, PLAIN_BATCH, steps, R, N)
    g = sk.bsk_g[:steps].contiguous()
    check_equal("blind_rotate_goldilocks 2_2 v5, random acc",
                functools.partial(k4, bsk_k=pk.goldilocks_kernel_key(g)),
                k4_plain, (racc, rmask, g, bl, lv), plain_reps=1)
    p11 = PARAM_MESSAGE_1_CARRY_1_KS_PBS
    R11, N11 = p11.glwe_size, p11.polynomial_size
    std = rng.integers(0, 1 << 64, size=(32, p11.pbs_level, R11, R11, N11),
                       dtype=np.uint64)
    racc, rmask = _random_acc_mask(rng, PLAIN_BATCH, 32, R11, N11)
    g = gl.bootstrap_key_to_goldilocks(from_u64(std, DEVICE))
    check_equal("blind_rotate_goldilocks 1_1 geometry",
                functools.partial(k4, bsk_k=pk.goldilocks_kernel_key(g)),
                k4_plain, (racc, rmask, g, p11.pbs_base_log, p11.pbs_level),
                plain_reps=1)
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
        bound=bound(goldilocks_step_int32_ops(BATCH, n, R, lv, N),
                    step_bytes(BATCH, n, R, lv, N, 1, 8), rate),
        shape=f"2_2 v5 B={BATCH} n={n}",
        plain_shape=f"2_2 v5 B={PLAIN_BATCH} n={n}")
    return {"v5_keygen_s": keygen_s, "v5_pbs_ms": step_ms,
            "v5_pbs_per_s": BATCH / step_ms * 1e3, "v5_k4_ms": k4_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import tfhe_tpu_torch  # noqa: F401  (raises outside a checkout of the repo)

    t_start = time.perf_counter()
    card = nvidia_smi("name,power.limit")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    rate = int32_rate()
    print(f"INT32 rate {rate / 1e12:.2f} Tops/s")

    rows: dict = {}
    summary = {"build_s": phase_build(), "card": card}
    ck22, s = phase_shortint_v6b(card, rate, rows)
    summary.update(s)
    bck, bsk, s = phase_boolean(card, rate, rows)
    summary.update(s)
    summary.update(phase_trivium(bck, bsk))
    summary.update(phase_shortint_crt(ck22, rate, rows))
    summary.update(phase_two_plane(ck22, rate, rows))
    summary.update(phase_shortint_v5(ck22, rate, rows))

    order = ("body_rotate_acc32", "blind_rotate_bnf2_acc32", "body_rotate_u64",
             "blind_rotate_crt", "blind_rotate_crt_p4",
             "blind_rotate_bnf2_u64", "blind_rotate_goldilocks")
    kernels = []
    for name in order:
        r = rows[name]
        bound_ms, bound_by = r.pop("bound")
        kernels.append(dict(
            name=name, route="cuda", source=r.pop("source"),
            replaces=r.pop("replaces"), launches=r.pop("launches"),
            max_abs_err=r["max_abs_err"], max_abs_diff=r.pop("max_abs_err"),
            ms=r.pop("ms"), plain_ms=r.pop("plain_ms"), bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None, **r))
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
