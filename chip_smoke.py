#!/usr/bin/env python3
"""Drive tfhe_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. build every CUDA kernel of the path from ``tfhe_tpu_torch/csrc`` (one
   nvcc per source, all at once) and print the build time and ptxas'
   register / shared-memory report;
2. ``PARAM_MESSAGE_2_CARRY_2_KS_PBS`` keygen (seeded), encryption of a batch
   of 2048 covering all 16 message+carry values;
3. each kernel against its plain PyTorch version on the same inputs, exact
   equality required (integer arithmetic): at the main path's own shapes
   (the KS -> modulus-switch outputs of this batch, the full 866-step
   key), plus a 32-step DEFAULT-flavor case and a 1_1-geometry case;
4. the main path through the user entry point
   ``ServerKey.apply_lookup_table`` with every launch count zeroed just
   before and read just after; the batch must decrypt to the clear
   function and both kernels must have launched;
5. timing with CUDA events: each kernel, its plain version, the int8
   keyswitch GEMM and the whole KS -> PBS step (PBS/s);
6. the card's name and power limit, a ``{"kernels": [...]}`` line, and
   last the ``{"ok": true, "device": {...}}`` line.

Bounds: ``bound_ms`` is the larger of the bytes the kernel must move over
the card's HBM rate (3.35 TB/s, H100 SXM data sheet) and its int32
operations over the INT32 instruction rate (64 lanes per SM x SMs x max SM
clock); the operation count model is ``k1_int32_ops`` below.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0x5EED
BATCH = 2048
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT32_LANES_PER_SM = 64  # Hopper SM: 64 INT32 units per SM


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


def max_abs_err_u32(a, b) -> int:
    m = (1 << 32) - 1
    return int(((a.long() & m) - (b.long() & m)).abs().max().item())


def int32_rate() -> float:
    """INT32 operations per second of card 0 at its max SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def k1_int32_ops(B: int, n: int, R: int, levels: int, N: int) -> float:
    """int32 operations K1 needs: per step and ciphertext, 2*l*R forward
    and 2*R inverse transforms of N/2*log2(N) butterflies (10 ops each: a
    Shoup multiply of 6 and two modular add/subs), the twist of 2*l*R*N
    digits and the untwist of 2*R*N residues (6 each) and 2*R*l*R*N Shoup
    MACs (8 each)."""
    lR = levels * R
    log_n = N.bit_length() - 1
    per = ((2 * lR + 2 * R) * (N // 2) * log_n * 10
           + (2 * lR * N + 2 * R * N) * 6 + 2 * R * lR * N * 8)
    return float(B) * n * per


def k1_bytes(B: int, n: int, R: int, levels: int, N: int) -> float:
    key = n * 2 * 2 * levels * R * R * N * 4
    return key + 2 * B * R * N * 4 + B * n * 4 + 2 * 8 * N * 4


def k2_bytes(B: int, R: int, N: int, shared_lut: bool) -> float:
    lut = R * N * 8 * (1 if shared_lut else B)
    return lut + B * 4 + B * R * N * 4


def check_kernel_case(name, kernel, plain, args, reps):
    """Kernel vs plain version on the same inputs; returns the row of
    numbers (kernel: median ms of ``reps`` runs; plain: one run, after the
    comparison run warmed it up)."""
    import torch

    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = max_abs_err_u32(got, want)
    if tuple(got.shape) != tuple(want.shape) or err != 0:
        raise AssertionError(f"{name}: kernel != plain version "
                             f"(max_abs_diff {err})")
    ms = cuda_ms(lambda: kernel(*args), reps, warmup=False)
    plain_ms = cuda_ms(lambda: plain(*args), 1, warmup=False)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def random_k1_case(rng, B, n, R, levels, N, flavor, device="cuda"):
    import torch

    from tfhe_tpu_torch._torus import from_u32, from_u64
    from tfhe_tpu_torch.ops import bnf2 as b2

    std = rng.integers(0, 1 << 64, size=(n, levels, R, R, N), dtype=np.uint64)
    bsk = b2.bootstrap_key_to_bnf2(from_u64(std, device), flavor)
    acc = from_u32(rng.integers(0, 1 << 32, size=(B, R, N), dtype=np.uint32),
                   device)
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(B, n))).to(device)
    return acc, mask, bsk


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tfhe_tpu_torch import _build
    from tfhe_tpu_torch._torus import from_u64
    from tfhe_tpu_torch.ops import bnf2 as b2
    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.ops import server as server_ops
    from tfhe_tpu_torch.shortint.client_key import ClientKey
    from tfhe_tpu_torch.shortint.server_key import ServerKey
    from tfhe_tpu_torch.utils.params import (PARAM_MESSAGE_1_CARRY_1_KS_PBS,
                                             PARAM_MESSAGE_2_CARRY_2_KS_PBS)

    t_start = time.perf_counter()
    card = nvidia_smi("name,power.limit")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build
    secs = _build.build_cuda()
    print(f"build: {secs:.1f} s for {list(_build.CUDA_SOURCES)}")
    for name in _build.CUDA_SOURCES:
        with open(_build.ptxas_report_path(name)) as f:
            for line in f:
                if "registers" in line or "smem" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")

    # 2. keygen + encryption, 2_2
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
    log_mod = p.polynomial_size.bit_length()

    # 3. kernels vs plain versions at the main path's shapes
    small = server_ops.keyswitch_mxu(ct.ct, sk.ksk_i8, p.ks_base_log,
                                     p.ks_level)
    ms_mask, ms_body = server_ops.lwe_centered_binary_modulus_switch(
        small, log_mod)
    k2 = check_kernel_case("body_rotate_acc32", pk.body_rotate_acc32,
                           pk.body_rotate_acc32_plain, (lut.acc, ms_body), 20)
    acc_hi = pk.body_rotate_acc32(lut.acc, ms_body)
    k1_args = (acc_hi, ms_mask, sk.bsk_b, p.pbs_base_log, p.pbs_level, fl)
    k1 = check_kernel_case("blind_rotate_bnf2_acc32",
                           pk.blind_rotate_bnf2_acc32,
                           pk.blind_rotate_bnf2_acc32_plain, k1_args, 3)
    print(f"K2 main-path shape B={BATCH}: {k2}")
    print(f"K1 main-path shape B={BATCH}, n={p.lwe_dimension}: {k1}")

    rng = np.random.default_rng(SEED)
    extra = [("2_2 geometry, DEFAULT flavor, 32 steps", 64, 32, 2, 1,
              2048, b2.DEFAULT),
             ("2_2 geometry, FAST28 flavor, 32 steps", 64, 32, 2, 1,
              2048, b2.FAST28)]
    p11 = PARAM_MESSAGE_1_CARRY_1_KS_PBS
    extra.append(("1_1 geometry, FAST28 flavor, 32 steps", 64, 32,
                  p11.glwe_size, p11.pbs_level, p11.polynomial_size,
                  b2.FAST28))
    for label, B, n, R, levels, N, flavor in extra:
        acc, mask, bsk = random_k1_case(rng, B, n, R, levels, N, flavor)
        row = check_kernel_case(
            "blind_rotate_bnf2_acc32", pk.blind_rotate_bnf2_acc32,
            pk.blind_rotate_bnf2_acc32_plain,
            (acc, mask, bsk, 23, levels, flavor), 3)
        print(f"K1 {label}, B={B}: max_abs_diff {row['max_abs_err']}")
        lut_r = from_u64(rng.integers(0, 1 << 64, size=(B, R, N),
                                      dtype=np.uint64), "cuda")
        body = torch.from_numpy(rng.integers(0, 2 * N, size=B)).cuda()
        row = check_kernel_case("body_rotate_acc32", pk.body_rotate_acc32,
                                pk.body_rotate_acc32_plain, (lut_r, body), 3)
        print(f"K2 {label}, B={B}: max_abs_diff {row['max_abs_err']}")

    # 4. the main path through the entry point
    pk.reset_launches()
    out = sk.apply_lookup_table(ct, lut)
    torch.cuda.synchronize()
    launches = {"body_rotate_acc32": pk.body_rotate_acc32.launches,
                "blind_rotate_bnf2_acc32": pk.blind_rotate_bnf2_acc32.launches}
    print(f"main path launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path did not launch: {launches}")
    if tuple(out.ct.shape) != (BATCH, p.big_lwe_dimension + 1):
        raise AssertionError(f"output shape {tuple(out.ct.shape)}")
    got_clear = ck.decrypt_message_and_carry(out)
    if not np.array_equal(got_clear, want_clear):
        bad = int((got_clear != want_clear).sum())
        raise AssertionError(f"{bad} of {BATCH} PBS outputs decrypt wrong")
    print(f"main path: {BATCH} ciphertexts decrypt to 3x mod 16")

    # 5. timing
    ks_ms = cuda_ms(lambda: server_ops.keyswitch_mxu(
        ct.ct, sk.ksk_i8, p.ks_base_log, p.ks_level), 5)
    step_ms = cuda_ms(lambda: sk.apply_lookup_table(ct, lut), 5)
    print(f"keyswitch (torch._int_mm int8 GEMM) B={BATCH}: {ks_ms:.3f} ms")
    print(f"KS->PBS step B={BATCH}: {step_ms:.3f} ms = "
          f"{BATCH / step_ms * 1e3:.1f} PBS/s on {card}")

    rate = int32_rate()
    R, N, n = p.glwe_size, p.polynomial_size, p.lwe_dimension
    k1_ops_ms = k1_int32_ops(BATCH, n, R, p.pbs_level, N) / rate * 1e3
    k1_bytes_ms = k1_bytes(BATCH, n, R, p.pbs_level, N) / HBM_BYTES_PER_S * 1e3
    k2_bytes_ms = k2_bytes(BATCH, R, N, True) / HBM_BYTES_PER_S * 1e3
    k2_ops_ms = BATCH * R * N * 8 / rate * 1e3
    print(f"INT32 rate {rate / 1e12:.2f} Tops/s; K1 bound: ops "
          f"{k1_ops_ms:.3f} ms, bytes {k1_bytes_ms:.3f} ms")
    kernels = [
        {"name": "body_rotate_acc32", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/body_rotate.cu",
         "replaces": "tfhe_tpu/ops/pbs_kernel.py:1930",
         "launches": launches["body_rotate_acc32"],
         "max_abs_err": k2["max_abs_err"], "max_abs_diff": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": max(k2_bytes_ms, k2_ops_ms),
         "bound_by": "bytes" if k2_bytes_ms >= k2_ops_ms else "operations",
         "library_ms": None},
        {"name": "blind_rotate_bnf2_acc32", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate_bnf2.cu",
         "replaces": "tfhe_tpu/ops/pbs_kernel.py:1848",
         "launches": launches["blind_rotate_bnf2_acc32"],
         "max_abs_err": k1["max_abs_err"], "max_abs_diff": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": max(k1_ops_ms, k1_bytes_ms),
         "bound_by": "operations" if k1_ops_ms >= k1_bytes_ms else "bytes",
         "library_ms": None},
    ]
    print(json.dumps({"ks_gemm_ms": ks_ms, "ks_pbs_ms": step_ms,
                      "pbs_per_s": BATCH / step_ms * 1e3, "batch": BATCH,
                      "params": p.name, "card": card}))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
