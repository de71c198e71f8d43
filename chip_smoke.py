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
   memory, cluster size and blocks per SM, and each micro-kernel's
   threads, registers, spills and blocks per SM (a spill fails);
2. shortint ``PARAM_MESSAGE_2_CARRY_2_KS_PBS`` (v6b, acc32): seeded keygen,
   a batch of 2048 covering all 16 message+carry values; K2 acc32 and K1
   against their plain versions (exact) on the path's own inputs (K2 on
   the whole batch, K1 on its first 64 ciphertexts, all 866 steps) and at
   three 32-step cases; K2 acc32, its
   plain version and its first design ``body_rotate_acc32_r1``
   ``torch.equal`` on the path's shared LUT at B = 2048, 1 and 32, on a
   random per-ciphertext LUT at 2048 (also unaligned), on LUT tables
   beyond shared memory (N = 32768) and on the three cases' random LUTs;
   ``ServerKey.apply_lookup_table`` with the launch counts zeroed just
   before and read just after (r1 never); timings: K2 acc32 and r1 in
   turns at 2048 (shared and per-ciphertext LUT), 1 and 32 on the device
   alone (``k2_device_ms``), a 33.55 MB device-to-device ``copy_`` for
   reference;
3. boolean gates at ``BOOLEAN_DEFAULT_PARAMETERS`` (exact CRT, P = 3):
   seeded keygen, 4096 random pairs, every gate (``not_`` and ``mux``
   included) against its truth table; K2 u64 and K3 against their plain
   versions at the path's shapes (K3's on 64 ciphertexts over the first
   PLAIN_STEPS of the 805 steps);
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
   batch's own keyswitched inputs (K4's on its first 64 ciphertexts over
   the first PLAIN_STEPS of the 866 steps, as phase 16's), K4 on random
   u64 accumulators over 32 steps and at 1_1 geometry (R = 5, N = 512);
   KS -> PBS and K4 timed at B = 2048;
8. boolean gates under ``TFHE_V4_ACC=32`` with phase 3's keys (K2 acc32,
   K3-acc32: the exact CRT step on the u32 hi plane, every increment
   rounded to 2^32): every gate on the 4096 pairs against its truth table,
   the launch counts around one ``and_`` (K2 acc32 and K3-acc32 once, K2
   u64 and K3 never), K2 acc32 against its plain version on the whole
   batch and K3-acc32 on the gate's first 64 inputs over the first
   PLAIN_STEPS of the 805 steps;
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
11. the kernel bench: each micro-kernel of ``csrc/kernel_bench.cu``
    ``torch.equal`` to its plain version on the bench's rows at
    ``kernel_bench.KB_CHECK_LOOPS`` and at an odd trip count, timed there
    on the device alone; ``kb_ntt`` and ``kb_rotate`` ``torch.equal`` at
    every N from 2 to 4096 (``micro_widths_equal``); then
    ``kernel_bench.run_all(quick=True)`` with the launch counts around it,
    one JSON row per micro-benchmark (its per-trip share of the INT32
    bound by two trip counts), and the phase's seconds;
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
13. the integer layer (``tfhe_tpu_torch.integer``) on phase 2's 2_2 v6b
    keys: the README example (FheUint32 ``a * b``, ``>> b`` by the
    encrypted b, cast to FheUint8, ``min`` with c, ``& 1``) at batch 1
    (1344, 5, 7 -> 6720, 210, 210, 7, 1) and over 32 random lanes, every
    step decrypted against numpy, ms a step; the FheUint64 table of
    ``bench.py --integer``: add, mul, bitand, eq at batch 1 (ms), add,
    bitand, eq at 32 (ops/s), div at batch 1, each output against its
    numpy oracle, one JSON
    row each with its PBS rounds and bootstrapped ciphertexts (counted by
    wrapping the shortint key's ``apply_lookup_table`` here); the launch
    counts around one add (K1 and K2 acc32 once a round, K3 and K4 never)
    and K2 acc32 and K1 against their plain versions on its first round;
14. encrypted ASCII strings (``tfhe_tpu_torch.strings``) on phase 2's
    keys: on ``"ab cd"`` at capacity 8 (``" ab cd "`` for ``trim``), an
    encrypted pattern ``"cd"`` and separator ``" "``, ``eq``,
    ``to_uppercase``, ``len``, ``contains``, ``find``, ``trim``,
    ``split_once`` and two ``next()`` of ``split``: each one checked run,
    then one timed run at batch 1, every output decrypted against
    Python's ``str`` methods, one JSON row each with its PBS rounds, PBS
    and ms a round; the launch counts around one ``eq`` (K2 acc32 and K1
    once a round, K2 u64, K3 and K4 never), and K2 acc32 and K1 against
    their plain versions on its first round (the encrypted-pattern
    ``replace``, ~4,351 rounds, is left to the CPU tests);
15. the typed high-level API (``tfhe_tpu_torch.high_level_api``):
    ``generate_keys(ConfigBuilder().with_seed(SEED).build())`` (phase 2's
    2_2 keys, on the GPU) and ``set_server_key``; the reference README
    example through ``FheUint32`` / ``FheUint8`` operators (``a * b``,
    ``>> b``, ``cast_into(FheUint8)``, ``min(c)``, ``& 1`` -> 1), each step
    decrypted; a 32-lane ``FheUint8Array`` (``+``, ``&``, ``sum``); a
    4-slot ``KVStore`` of ``FheUint8`` (``get`` hit and miss,
    ``contains``, ``update``): ms at batch 1, PBS rounds and PBS each;
16. the rest of shortint (``phase_shortint_rest``): many-LUT on phase 2's
    keys (the exact CRT key, built at first use: K2 u64 and K3 P = 4 once,
    at k = 2 and 4 on 2048 ciphertexts covering every input degree; at
    512 under ``TFHE_V4_ACC=32``, K2 acc32 and K3-acc32, and on phase 7's
    v5 key, K2 u64 and K4), each output decrypted, each kernel against its
    plain version on the call's own inputs (a step kernel over its first
    MANY_LUT_PLAIN_STEPS steps), outputs/s; the shortint OPRF
    (1-4 bits) and the FheUint64 OPRF (one batched PBS, ms at batch 1, a
    chi-square of 64 seeds' 2,048 blocks); the reference's v1.5 2_2 KS32,
    KS32 + drift (v1_3) and PBS -> KS sets at full width: keygen s, a
    2048 batch through ``apply_lookup_table`` (K2 acc32 and K1 once, K2
    acc32 and K1 against their plain versions on its inputs, K1 over its
    first PLAIN_STEPS steps), PBS/s, the
    keyswitch, the drift choice and K1 alone; then add, smart_add, mul, a
    bivariate LUT and unchecked_neg on phase 2's keys, each decrypted;
17. the shortint side modules (``phase_side_modules``) on phase 2's keys:
    list compression at ``COMP_PARAM_MESSAGE_2_CARRY_2_KS_PBS`` (2048
    ciphertexts into 8 GLWEs; compress, then decompress all: K2 u64 and K3
    P = 4 once each at n = k_c*N_c = 1024, every other kernel never; K3
    against its plain version on the path's first 64 ciphertexts, all 1024
    steps; each output decrypted; ms, ciphertexts/s, stored bytes); a
    compact list of 2048 values under ``PARAM_PKE_MESSAGE_2_CARRY_2_KS_
    PBS_TUNIFORM_2M128`` expanded and cast onto the small key (4 x 4, then
    ``pbs_only``: K2 acc32 and K1 once), decrypted, casts/s; phase 2's 2048
    ciphertexts re-randomized through the 1 x 24 casting key onto the big
    key, decrypted; a 2_2 public key (131,264 encryptions of zero on the
    card), 32 values encrypted with it and decrypted; a compressed server
    key from a fresh client key of phase 2's seed, decompressed on the card
    and byte-equal to phase 2's key; the HLAPI: a compressed list of
    FheUint8, FheUint32 and FheBool (each item back and decrypted) and a
    compact list builder -> expand, decrypted; WoP-PBS (its key, then
    x -> 7x + 3 mod 16 on one value, message and carry decrypted);
18. the multi-bit PBS (``phase_multi_bit``) at three sets of the
    reference's universe by name, full width, each on its own seeded keys:
    the GPU default ``PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_2_CARRY_2_KS_PBS_
    TUNIFORM_2M128`` (n = 920, N = 2048, 230 steps) at 2048, 1, 32 and 264:
    keygen s, each batch through ``apply_lookup_table`` (K2 u64 once, K5a
    and K5b once a chunk of steps, r14 and every other kernel never),
    decrypted, at 2048 the K5 pair equal to r14 on the whole batch and
    both timed in turns (median of 5; r14 at that shape only), the pair
    alone elsewhere, K5a and K5b apart; at 2048 K2 u64, K5a (the
    first chunk, the whole batch), K5b (all steps, 64 ciphertexts) and the
    pair (64 ciphertexts, and random u64 accumulators over 32 steps)
    against their plain versions, at 1, 32 and 264 the same checks over
    the first MB_CUT_STEPS = 16 group steps; at batch 1 KS -> PBS (median of 5),
    FheUint64 add, bitand and eq (ms, rounds) against their oracles beside
    phase 13's v6b rows, the README chain at FheUint32, the FheUint64
    OPRF; then ``PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS`` (N =
    4096, 452 steps) and ``V1_5_PARAM_GPU_MULTI_BIT_GROUP_3_MESSAGE_2_
    CARRY_2_KS_PBS_TUNIFORM_2M128`` (l = 2, 293 steps) at 512, the same
    checks (plain versions on 16 ciphertexts) and timings;
19. the platform layers (``phase_platform``, ROADMAP Queue A item 9a) on
    phase 2's keys: the server key through ``safe_serialize`` and back
    onto the card (MB, ms; its output on phase 2's batch ``torch.equal``
    to phase 2's, PBS/s beside phase 2's); the thin client on the CPU (32
    FheUint64 pairs, bit-equal to the full stack's on the card, added on
    the round-tripped key, the sums decrypted on the CPU); the keycache (a
    miss, then a hit, equal keys); ``utils.trace`` spans whose PBS and KS
    counts must equal phase 13's; ROADMAP R1's first split of a batch-1
    FheUint64 add round on phase 2's key and on phase 18's group-4 key from
    a ``torch.profiler`` trace (its times printed, not gated; a trace
    without the span or the key's kernels fails); the golden test
    vectors on K2 u64 -> K3 at N = 256, and those kernel calls against
    their plain versions;
20. the u128 noise squashing (``phase_noise_squashing``, ROADMAP Queue A
    item 7, torch ops on the card: no kernel) at the reference's 2_2 squash
    and squash-compression sets, full width, on phase 2's keys: keygen s
    and MB; 64 values covering all 16 message+carry values squashed (ms,
    ms a step, launches a step from ``torch.profiler``), decrypted, the
    largest phase error below 2^72; the card ``torch.equal`` to the CPU on
    ``decompose128``, ``_reconstruct128`` and 16 rotation steps; the batch
    compressed into one list, unpacked and decrypted; the squashed
    envelope round trip; the HLAPI (``generate_keys`` with both squash
    sets, a FheUint64 ``squash_noise``, a list of two FheUint8);
21. the prime-modulus NTT64 PBS (``phase_ntt64``, ROADMAP Queue A item 8,
    on K6) at the reference's doc recipe, full width (n = 742, k = 1, N =
    2048, b = 23, l = 1, q = 2^64 - 2^32 + 1, 4-bit messages): key MB and
    keygen s; the 16 messages through f(x) = 2x with the launch counts
    around the call (K6 once), decrypted; a batch of 2048, decrypted, PBS/s
    and K6's ms (medians of 5); K6 ``torch.equal`` to ``cmux_steps_q`` on 8
    ciphertexts over 400 of the 742 steps; the card's modulus switch against
    Python ints on 2^16 values and the edges;
22. ZK-proven compact lists (``phase_zk``, ROADMAP Queue A item 9b) at
    ``PARAM_PKE_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128`` onto phase 2's
    keys: the v2 CRS for k = 128 (s, MB); the thin client proving 4
    FheUint64 on the CPU (s, bytes); the server's ``verify_and_expand`` on
    the card (verify s, expand and cast ms, K2 acc32 and K1 launched), all
    4 decrypted; a tampered body rejected; the CRS and proof envelopes
    round-tripped; the native BLS12-446 curve required;
23. the batch mesh, the C API and the reference-vector twin
    (``phase_mesh_c_api``, ROADMAP Queue A item 9c) on phase 2's keys and
    batch: ``sharded_ks_pbs`` over every device of the host and over a
    two-way split on the one card, each ``torch.equal`` to phase 2's
    output with K2 acc32 and K1 launched once a chunk, the ``B % n``
    refusal, ``scaling_sweep`` (PBS/s beside phase 2's), ``init_distributed``
    on ``nccl`` (a world of 1); the C API built with cc, ``c_api_test`` run
    on the GPU at 2_2 (its op times; its serialized sum byte-equal to the
    Python HLAPI's), the library loaded into this process for one
    encrypt-add-decrypt (K2 acc32 and K1 launched); the reference vectors'
    toy and valid_params_128 sets generated on the host (each SHA-256
    equal to the CPU run's) and their decryption contract on the card
    through K2 u64 -> K3 P = 4, both kernels held to their plain versions
    (K3 at valid_params_128 over the first PLAIN_STEPS steps);
24. tfhe-rs's 3_3 sets on K7 (``phase_wide``: the exact CRT step where K3
    and K5b exceed a block's shared memory), full width, on K7's cluster
    kernel (a cluster of 8 CTAs a ciphertext, acc and digits in
    distributed shared memory for all steps, one launch a call): the
    classic ``PARAM_MESSAGE_3_CARRY_3_KS_PBS_GAUSSIAN_2M128`` (seeded
    keygen s and MB; 512 ciphertexts over all 64 values through
    ``apply_lookup_table``, two-plane and under ``TFHE_V4_ACC=32``, with
    the launch counts around each call: K2 once, the cluster kernel once,
    K3 and K7 global never; decrypted; the cluster kernel and K7 global
    (three stage launches a step through global memory) ``torch.equal`` to
    the plain versions on 8 ciphertexts over the first PLAIN_STEPS steps,
    both modes, and timed in turns at 512 and at 1; PBS/s, the bound, KS
    -> PBS at batch 1) and the GPU group-4 ``..._MESSAGE_3_CARRY_3_KS_PBS_
    GAUSSIAN_2M128`` (keygen; 256 ciphertexts through K2 u64, K5a and the
    cluster kernel a chunk, K5b and K7 global never; decrypted; K5a and
    both designs equal to their plain versions over 16 group steps; the
    designs in turns at 256 and at 1; PBS/s, batch 1); random keys at the
    envelope's corners (classic N = 16384 on the cluster kernel, classic
    N = 32768 and multi-bit N = 32768 at l = 3, g = 4 on K7 global, and
    K5a at N = 32768, equal to their plain versions); the refusal of two
    N = 65536 sets, and the acceptance of the 23 sets with base_log *
    levels >= 32 at N <= 32768, which run on the kernels' 64-bit
    decomposer: the classic 4_4 set at 2M64 on the split (real keys; 256
    values decrypted; the split equal to its plain version on 4
    ciphertexts over 64 steps, timed at 256 and 1, PBS/s), the GPU group-4
    4_4 set at 2M128 on K5a and the split with its levels streamed
    (random keys at its shape over 16 group steps: its key exceeds the
    card; the pair, K5a, the stream and K7 global equal to their plain
    versions, the stream and K7 global in turns), random keys at the
    split, the stream, the cluster kernel, K3 and K5b at b l >= 32 (each
    equal to its plain version, the acc32 entries refusing) and at the
    stream's int8 (l = 5, 6) and hi-word (l = 4, b = 7) shapes; and the
    2_6 compact-PK set at 2M64 (N = 32768, b = 9, l = 4) on the stream,
    real keys: 256 values decrypted, the stream equal to its plain version
    on 4 ciphertexts over 64 steps, timed at 256 and 1 and in turns with
    K7 global at 8, PBS/s; each part's seconds;
25. the card's name and power limit, a ``{"kernels": [...]}`` line, and
    last the ``{"ok": true, "device": {...}}`` line.

Times are CUDA events: a kernel's ``ms`` is the median of a few runs; K2's
(acc32, r1 and u64) and the micro-kernels' (``wrapper_ms`` beside them)
are the kernel's mean device duration over 200
launches from ``torch.profiler``'s device events, each launch writing
another of 4 output buffers so that the writes reach HBM
(``k2_device_ms``; the wrapper-inclusive mean of 200 back-to-back calls
between one pair of events is printed beside it); a plain version's
``plain_ms`` is its comparison run. Bounds: ``bound_ms`` is the
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
import math
import os
import re
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
PLAIN_STEPS = 256  # phases 3, 7, 8, 16, 23's plain checks (of 805-978 steps)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
K2_LAUNCHES = 200  # back-to-back launches per K2 timing
K2_BUFFERS = 4  # outputs a K2 timing writes in turn: 4 x 33.55 MB > the L2
KB_ODD_LOOPS = 3  # micro-kernel passes of the second exactness check: odd,
# so that kb_rotate's double buffer ends swapped
KB_WIDTH_ROWS = 5  # rows of the micro-kernels' check at every N
TRIVIUM_KEY = [(i * 7 + 3) % 2 for i in range(80)]
TRIVIUM_IV = [(i * 5 + 1) % 2 for i in range(80)]
README_BLOCKS = 16  # FheUint32 at 2_2
README_C_BLOCKS = 4  # FheUint8
U64_BLOCKS = 32  # FheUint64
INT_DIV_BLOCKS = 32  # the div row's width
INT_LANES = 32  # the integer throughput rows and the README chain's lanes
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


def k2_device_ms(fn, kernel: str = "body_rotate") -> dict:
    """A µs kernel's time on the device alone: the mean duration of the
    last ``K2_LAUNCHES`` device events whose name holds ``kernel`` over
    twice as many calls of ``fn`` under ``torch.profiler`` (one such kernel
    a call; it raises when the trace holds fewer: the profiler's tracing
    misses kernels of its first milliseconds, and now and then one more),
    beside the wrapper-inclusive mean of ``K2_LAUNCHES`` back-to-back
    calls between one pair of CUDA events (the wrapper's own launches,
    allocations and host work included). Each call's result is kept until
    ``K2_BUFFERS`` later calls have run, so successive launches write
    distinct buffers and their writes reach HBM rather than staying in the
    50 MB L2. ms: {"device_ms", "wrapper_ms"}."""
    import collections

    import torch

    n = K2_LAUNCHES
    kept = collections.deque([fn()], maxlen=K2_BUFFERS)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        kept.append(fn())
    end.record()
    end.synchronize()
    wrapper_ms = start.elapsed_time(end) / n
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2 * n):
            kept.append(fn())
        torch.cuda.synchronize()
    ranges = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type.name == "CUDA" and kernel in e.name)
    if len(ranges) < n:
        raise AssertionError(f"the profiler recorded {len(ranges)} "
                             f"{kernel!r} kernels for {2 * n} calls")
    us = sum(t1 - t0 for t0, t1 in ranges[-n:])
    return {"device_ms": us / n / 1e3, "wrapper_ms": wrapper_ms}


def k2_in_turns(new, ref) -> tuple:
    """:func:`k2_device_ms` of ``new`` and ``ref`` in turns (ref, new, new,
    ref): (new, ref), each key the mean of its two turns."""
    r1, n1, n2, r2 = (k2_device_ms(fn) for fn in (ref, new, new, ref))
    return ({k: (n1[k] + n2[k]) / 2 for k in n1},
            {k: (r1[k] + r2[k]) / 2 for k in r1})


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
          f"{_build.nvcc_version()}; each library's nvcc done at (s): "
          + ", ".join(f"{n} {t:.1f}"
                      for n, t in _build.BUILD_SECONDS.items()))
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
    micro_kernel_report()
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
    smem = pk.step_smem_bytes("blind_rotate_ntt64", 1, 2, 1, 2048)
    occ = pk._occupancy(pk._k6_lib().blind_rotate_ntt64_occupancy,
                        "blind_rotate_ntt64", 2, 1, 11)
    if smem != pk.ntt64_smem_bytes(2, 1, 2048):
        raise AssertionError(f"blind_rotate_ntt64_smem {smem} != acc + "
                             "digits + MAC at the NTT64 doc recipe")
    if occ["local_bytes"]:
        spilled["K6 at the NTT64 doc recipe"] = occ["local_bytes"]
    print(f"  K6 NTT64 doc recipe (k = 1, l = 1, N = 2048): "
          f"{smem / 1024:.0f} KiB dynamic shared memory a block, "
          f"{occ['registers']} registers, {occ['local_bytes']} local bytes "
          f"a thread, {occ['blocks_per_sm']} blocks per SM")
    for label, g, R, levels, N in (("K5 group 4", 4, 2, 1, 2048),
                                   ("K5 group 2, N = 4096", 2, 2, 1, 4096),
                                   ("K5 group 3, l = 2", 3, 2, 2, 2048)):
        occ = pk.multi_bit_occupancy(R, levels, N, g)
        for kernel, entry in (("accumulate", "multi_bit_accumulate"),
                              ("r14", "blind_rotate_multi_bit_r14")):
            smem = pk.step_smem_bytes(entry, 4, R, levels, N)
            if smem != sp.step_smem_bytes(4, R, levels, N, 8):
                raise AssertionError(f"{entry} shared memory {smem} != acc "
                                     f"+ digits at {label}")
        print(f"  {label}: K5b {smem / 1024:.0f} KiB dynamic shared memory a "
              "block (r14 the same); " + "; ".join(
                  f"{k} {o['registers']} registers, {o['local_bytes']} local "
                  f"bytes a thread, {o['blocks_per_sm']} blocks per SM"
                  for k, o in occ.items()))
    # K7 where K3 and K5b cannot go: the 3_3 shapes (classic k = 1, l = 2
    # and the group-4 set at the same N and l)
    P, R, levels, N = 4, 2, 2, 8192
    k3 = pk.step_smem_bytes("blind_rotate_crt", P, R, levels, N)
    k5b = pk.step_smem_bytes("multi_bit_accumulate", P, R, levels, N)
    if not (k3 == k5b == pk.step_smem_formula(P, R, levels, N, 8)
            > pk._SMEM_LIMIT and pk.needs_wide(P, R, levels, N)):
        raise AssertionError(f"3_3: K3 {k3} B, K5b {k5b} B, the dispatch's "
                             "formula disagrees")
    occ = pk.wide_occupancy(P, R, levels, N)
    print(f"  K7 global at 3_3 (K3 and K5b would need {k3} B a block): "
          f"K7a/K7b {4 * N // 1024} KiB a block (one polynomial); " + "; ".join(
              f"{k} {o['registers']} registers, {o['local_bytes']} local "
              f"bytes a thread, {o['blocks_per_sm']} blocks per SM"
              for k, o in occ.items()))
    spilled.update({f"K7 global {k} at 3_3": o["local_bytes"]
                    for k, o in occ.items() if o["local_bytes"]})
    # K7's cluster kernel, where the 3_3 steps run: a CTA's area (held to
    # the formula of the dispatch and of step_passes), its registers,
    # spills, CTAs per SM and the clusters resident on the card
    # and at split 2 where the 4_4 steps run (N = 32768 at l = 2 and 3, N
    # = 16384 at l = 3): 16 CTAs a cluster, a non-portable size; and the
    # split with its levels streamed (N = 32768 at l = 4 to 6; no acc32
    # entry: its _smem export says 0)
    for label, lv, n_, split in (("3_3", levels, N, 1),
                                 ("N = 16384, l = 2", 2, 16384, 1),
                                 ("N = 32768, l = 2", 2, 32768, 2),
                                 ("N = 32768, l = 3", 3, 32768, 2),
                                 ("N = 16384, l = 3", 3, 16384, 2),
                                 ("N = 32768, l = 4, streamed", 4, 32768, 2),
                                 ("N = 32768, l = 5, streamed", 5, 32768, 2),
                                 ("N = 32768, l = 6, streamed", 6, 32768,
                                  2)):
        design = "cluster" if split == 1 else "split"
        streams = split == 2 and pk.split_streams(P, R, lv, n_)
        if streams != label.endswith("streamed"):
            raise AssertionError(f"the split at {label}: split_streams "
                                 f"{streams}")
        for entry, acc_bytes in ((f"blind_rotate_wide_{design}", 8),
                                 (f"blind_rotate_wide_{design}_acc32", 4),
                                 (f"multi_bit_accumulate_wide_{design}", 8)):
            smem = pk.step_smem_bytes(entry, P, R, lv, n_)
            want = 0 if streams and acc_bytes == 4 else \
                sp.cluster_smem_bytes(P, R, lv, n_, acc_bytes, split)
            if smem != want or want and smem != pk.cluster_smem_formula(
                    P, R, lv, n_, acc_bytes, split):
                raise AssertionError(f"{entry}_smem {smem} != the "
                                     f"formula's {want} at {label}")
        occ = pk.wide_cluster_occupancy(P, R, lv, n_, split)
        print(f"  K7 cluster kernel at split {split}, {label}: "
              f"{occ['smem_bytes']} B dynamic shared memory a CTA, "
              f"{occ['registers']} registers, {occ['local_bytes']} local "
              f"bytes a thread, cluster of {occ['cluster']}, "
              f"{occ['blocks_per_sm']} CTAs per SM, {occ['clusters']} "
              "clusters resident on the card")
        if occ["local_bytes"]:
            spilled[f"K7 cluster kernel at split {split}, {label}"] = \
                occ["local_bytes"]
        if occ["clusters"] < 1:
            raise AssertionError(f"K7 cluster kernel at split {split}, "
                                 f"{label}: no cluster resident")
    # the 64-bit decomposer's instantiations of K5b and K7 (K3's are
    # blind_rotate_kernel's, above), and every instantiation of the
    # streamed split (wide_cluster_kernel<..., 3>): ptxas' spills
    deep = {name: b for lib in ("blind_rotate_multi_bit", "blind_rotate_wide")
            for name, b in _ptxas_spills(lib).items()
            if "GarnerTailDeep" in name or "Decomposer64" in name}
    print(f"  the 64-bit decomposer's K5b and K7 instantiations: {len(deep)}, "
          f"spill bytes {sorted(set(deep.values()))}")
    spilled.update({name: b for name, b in deep.items() if b})
    stream = {name: b for name, b in _ptxas_spills("blind_rotate_wide").items()
              if "wide_cluster_kernel" in name and "ELi3EEEv" in name}
    print(f"  the streamed split's instantiations: {len(stream)}, spill "
          f"bytes {sorted(set(stream.values()))}")
    if not stream:
        raise AssertionError("no instantiation of the streamed split in "
                             "ptxas' report")
    spilled.update({name: b for name, b in stream.items() if b})
    if spilled:
        raise AssertionError(f"K1/K3/K6/K7 kernels spill: {spilled}")
    print("K1, K3, K5b's and K7's 64-bit decomposer, K6 and K7 (the streamed "
          "split too): no spills; K1, K3, K5b and r14: shared memory == acc "
          "+ digits; K6: acc + digits + MAC; K7 global: one polynomial; K7's "
          "cluster kernel at split 1 and 2 (levels held or streamed): its "
          "CTA area")


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


def micro_kernel_report():
    """Per micro-kernel of the kernel bench at N = 2048 (kb_mac at its 2
    rows): threads a block, registers, ptxas' spill bytes, local bytes a
    thread and resident blocks per SM; fails on a spill in any of their
    instantiations."""
    from tfhe_tpu_torch.ops import kernel_bench as kb

    spilled = {name: b for name, b in _ptxas_spills("kernel_bench").items()
               if b and any(f"{k}_kernel" in name for k in (
                   "kb_ntt", "kb_mac", "kb_rotate", "kb_decompose"))}
    for fn in kb.MICRO_KERNELS:
        occ = kb.micro_occupancy(fn.__name__)
        print(f"  {fn.__name__} (N = {kb.N_BENCH}): {occ['threads']} "
              f"threads a block, {occ['registers']} registers, "
              f"{occ['local_bytes']} local bytes a thread, "
              f"{occ['blocks_per_sm']} blocks per SM")
        if occ["local_bytes"]:
            spilled[fn.__name__] = occ["local_bytes"]
    if spilled:
        raise AssertionError(f"micro-kernels spill: {spilled}")
    print("micro-kernels: no spills (every instantiation of kb_ntt, kb_mac, "
          "kb_rotate, kb_decompose)")


def in_turns(new, ref, reps: int = 2, warmup: bool = True) -> tuple:
    """CUDA-event ms of ``new()`` and ``ref()`` timed ref, new, new, ref
    (each turn the median of ``reps`` runs, a function warmed up before its
    first turn only, unless ``warmup`` is false: both ran just before):
    (new ms, ref ms), each the mean of its two turns."""
    r1, n1 = cuda_ms(ref, reps, warmup), cuda_ms(new, reps, warmup)
    n2, r2 = cuda_ms(new, reps, False), cuda_ms(ref, reps, False)
    return (n1 + n2) / 2, (r1 + r2) / 2


def check_k2_acc32(label, lut, body):
    """K2 acc32, its plain version and its first design r1 on the same
    inputs: ``torch.equal``, else it raises."""
    import torch

    from tfhe_tpu_torch.ops import pbs_kernel as pk

    got = pk.body_rotate_acc32(lut, body)
    want = pk.body_rotate_acc32_plain(lut, body)
    ref = pk.body_rotate_acc32_r1(lut, body)
    torch.cuda.synchronize()
    for name, other in (("plain", want), ("r1", ref)):
        if not torch.equal(got, other):
            bad = int((got != other).sum())
            raise AssertionError(f"K2 acc32 {label}: {bad} words differ from "
                                 f"its {name} version")


def k2_acc32_cases(rng, lut, ms_body) -> dict:
    """Phase 2's K2 acc32 shapes, label -> (lut, body): the path's shared
    LUT at B = 2048, 1 and 32; a random per-ciphertext LUT at 2048 (u64
    words at the fold's half-way points, the edge bodies first), also at
    an address 8 bytes off 16-byte alignment; shared tables beyond a
    block's shared memory (N = 32768, R = 2)."""
    import torch

    from tfhe_tpu_torch._torus import from_u64

    R, N = lut.shape
    words = rng.integers(0, 1 << 64, size=(BATCH, R, N), dtype=np.uint64)
    flat = words.reshape(-1)
    flat[::97] = (flat[::97] & ~np.uint64((1 << 32) - 1)) | np.uint64(1 << 31)
    flat[1::1009] = np.uint64(1 << 63)
    lut_ct = from_u64(words, DEVICE)
    body = rng.integers(0, 2 * N, size=BATCH)
    body[:6] = [0, 1, N - 1, N, N + 1, 2 * N - 1]
    body = torch.from_numpy(body).to(DEVICE)
    off = torch.empty(lut_ct.numel() + 1, dtype=torch.int64, device=DEVICE)
    lut_off = off[1:].view(lut_ct.shape)
    lut_off.copy_(lut_ct)
    big_n = 32768
    lut_big = from_u64(rng.integers(0, 1 << 64, size=(2, big_n),
                                    dtype=np.uint64), DEVICE)
    body_big = torch.from_numpy(rng.integers(0, 2 * big_n, size=64)).to(DEVICE)
    return {f"{BATCH}_shared": (lut, ms_body),
            f"{BATCH}_per_ct": (lut_ct, body),
            "1_shared": (lut, ms_body[:1]),
            "32_shared": (lut, ms_body[:32]),
            f"{BATCH}_per_ct_unaligned": (lut_off, body),
            f"64_shared_n{big_n}": (lut_big, body_big)}


def k2_acc32_timings(card, rate, cases) -> dict:
    """K2 acc32 and r1 in turns on the device alone (:func:`k2_in_turns`)
    at the path's shapes (2048 with the shared and a per-ciphertext LUT, 1,
    32), each beside its bound; a 33.55 MB device-to-device ``copy_`` (the
    card's read-and-write stream, for reference). ({label: {"new", "r1":
    {"device_ms", "wrapper_ms"}, "bound": (ms, by)}}, the copy's
    {"device_ms", "wrapper_ms"})."""
    import itertools

    import torch

    from tfhe_tpu_torch.ops import pbs_kernel as pk

    out = {}
    for label in (f"{BATCH}_shared", f"{BATCH}_per_ct", "1_shared",
                  "32_shared"):
        lut, body = cases[label]
        R, N = lut.shape[-2:]
        B = body.shape[0]
        new, r1 = k2_in_turns(lambda: pk.body_rotate_acc32(lut, body),
                              lambda: pk.body_rotate_acc32_r1(lut, body))
        b = bound(B * R * N * 8, k2_bytes(B, R, N, lut.ndim == 2, 4), rate)
        out[label] = {"new": new, "r1": r1, "bound": b}
        print(f"K2 acc32 {label}: {new['device_ms']:.5f} ms on the device "
              f"({new['wrapper_ms']:.5f} ms a wrapper call), r1 "
              f"{r1['device_ms']:.5f} ms ({r1['wrapper_ms']:.5f}); bound "
              f"{b[0]:.5f} ms ({b[1]}): {b[0] / new['device_ms']:.1%} "
              f"(r1 {b[0] / r1['device_ms']:.1%}) on {card}")
    lut, body = cases[f"{BATCH}_shared"]
    src = torch.empty(BATCH * lut.numel(), dtype=torch.int32, device=DEVICE)
    dsts = itertools.cycle([torch.empty_like(src) for _ in range(K2_BUFFERS)])
    cp = k2_device_ms(lambda: next(dsts).copy_(src), kernel="Memcpy DtoD")
    nbytes = 2 * src.numel() * 4
    print(f"copy_ of {src.numel() * 4 / 1e6:.2f} MB device to device: "
          f"{cp['device_ms']:.5f} ms on the device, "
          f"{nbytes / cp['device_ms'] / 1e6:.0f} GB/s read + write "
          f"({nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms at the HBM rate) on "
          f"{card}")
    return out, cp


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
        (acc_hi[:PLAIN_BATCH].contiguous(), ms_mask[:PLAIN_BATCH],
         sk.bsk_b, p.pbs_base_log, p.pbs_level, fl))
    print(f"K2 acc32 == plain at B={BATCH}; K1 == plain on the path's first "
          f"{PLAIN_BATCH} ciphertexts, n={n}")
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
        check_k2_acc32(label, lut_r, body)
        print(f"K1, K2 acc32 == plain: {label}, B={B}, {steps} steps")
    k2_cases = k2_acc32_cases(rng, lut.acc, ms_body)
    for label, args in k2_cases.items():
        check_k2_acc32(label, *args)
    print(f"K2 acc32 == plain == r1 (torch.equal): {', '.join(k2_cases)}")

    # the main path through the entry point
    pk.reset_launches()
    out = sk.apply_lookup_table(ct, lut)
    torch.cuda.synchronize()
    launches = launches_of("body_rotate_acc32", "blind_rotate_bnf2_acc32")
    require_launched("2_2 v6b main path", launches)
    r1_launches = pk.body_rotate_acc32_r1.launches
    if r1_launches:
        raise AssertionError(f"the main path launched r1 {r1_launches} times")
    if tuple(out.ct.shape) != (BATCH, p.big_lwe_dimension + 1):
        raise AssertionError(f"output shape {tuple(out.ct.shape)}")
    got_clear = ck.decrypt_message_and_carry(out)
    if not np.array_equal(got_clear, want_clear):
        bad = int((got_clear != want_clear).sum())
        raise AssertionError(f"{bad} of {BATCH} PBS outputs decrypt wrong")
    print(f"2_2 v6b: {BATCH} ciphertexts decrypt to 3x mod 16")

    # timing
    k2, k2_copy = k2_acc32_timings(card, rate, k2_cases)
    k1_ms = cuda_ms(lambda: pk.blind_rotate_bnf2_acc32(
        acc_hi, ms_mask, sk.bsk_b, p.pbs_base_log, p.pbs_level, fl), 3)
    ks_ms = cuda_ms(lambda: server_ops.keyswitch_mxu(
        ct.ct, sk.ksk_i8, p.ks_base_log, p.ks_level), 5)
    step_ms = cuda_ms(lambda: sk.apply_lookup_table(ct, lut), 5)
    print(f"keyswitch (torch._int_mm int8 GEMM) B={BATCH}: {ks_ms:.3f} ms")
    print(f"KS->PBS step B={BATCH}: {step_ms:.3f} ms = "
          f"{BATCH / step_ms * 1e3:.1f} PBS/s on {card}")
    for name, which in (("body_rotate_acc32", "new"),
                        ("body_rotate_acc32_r1", "r1")):
        t = k2[f"{BATCH}_shared"]
        rows[name] = dict(
            source="tfhe_tpu_torch/csrc/body_rotate.cu",
            replaces="tfhe_tpu/ops/pbs_kernel.py:1930",
            launches=(launches["body_rotate_acc32"] if which == "new"
                      else r1_launches),
            max_abs_err=k2_err, ms=t[which]["device_ms"],
            plain_ms=k2_plain, bound=t["bound"],
            wrapper_ms=t[which]["wrapper_ms"],
            shapes={label: {"ms": v[which]["device_ms"],
                            "wrapper_ms": v[which]["wrapper_ms"],
                            "bound_ms": v["bound"][0]}
                    for label, v in k2.items()},
            timing="device events, 200 launches, 4 output buffers",
            shape=f"2_2 B={BATCH} shared LUT",
            plain_shape=f"2_2 B={BATCH}")
    rows["blind_rotate_bnf2_acc32"] = dict(
        source="tfhe_tpu_torch/csrc/blind_rotate_bnf2.cu",
        replaces="tfhe_tpu/ops/pbs_kernel.py:1848",
        launches=launches["blind_rotate_bnf2_acc32"], max_abs_err=k1_err,
        ms=k1_ms, plain_ms=k1_plain,
        bound=step_bound("blind_rotate_bnf2_acc32", BATCH, n, R,
                         p.pbs_level, N, 2, 4, rate),
        shape=f"2_2 B={BATCH} n={n}",
        plain_shape=f"2_2 B={PLAIN_BATCH} of {BATCH} n={n}")
    return ck, sk, (ct, lut, out.ct), {
        "ks_gemm_ms": ks_ms, "ks_pbs_ms": step_ms,
        "pbs_per_s": BATCH / step_ms * 1e3,
        "k2_copy_ms": k2_copy["device_ms"],
        "k2_acc32": {label: {"ms": v["new"]["device_ms"],
                             "r1_ms": v["r1"]["device_ms"],
                             "bound_ms": v["bound"][0]}
                     for label, v in k2.items()}}


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
    S = min(PLAIN_STEPS, n)
    k3_err, k3_plain = check_equal(
        "blind_rotate_crt", pk.blind_rotate_crt, pk.blind_rotate_crt_plain,
        (acc[:PLAIN_BATCH].contiguous(),
         ms_mask[:PLAIN_BATCH, :S].contiguous(), sk.bsk_scan[:S],
         p.pbs_base_log, p.pbs_level))
    print(f"K2 u64 == plain at B={BOOL_BATCH}; K3 (Garner, P=3) == plain at "
          f"B={PLAIN_BATCH}, the first {S} of n={n} steps, N={N}, R={R}, "
          f"l={p.pbs_level}")

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
    k2 = k2_device_ms(lambda: pk.body_rotate_u64(lut, ms_body))
    k2_ms = k2["device_ms"]
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
          f"K2 u64 {k2_ms:.5f} ms (device; {k2['wrapper_ms']:.5f} ms a "
          f"wrapper call), keyswitch {ks_ms:.3f} ms, rest "
          f"{gate_ms - k3_ms - k2_ms - ks_ms:.3f} ms; K3 at B={PLAIN_BATCH}: "
          f"{k3_small_ms:.3f} ms")
    k2_bound = bound(BOOL_BATCH * R * N * 6,
                     k2_bytes(BOOL_BATCH, R, N, True, 8), rate)
    rows["body_rotate_u64"] = dict(
        source="tfhe_tpu_torch/csrc/body_rotate.cu",
        replaces="tfhe_tpu/ops/pbs_kernel.py:1930",
        launches=launches["body_rotate_u64"], max_abs_err=k2_err, ms=k2_ms,
        plain_ms=k2_plain, bound=k2_bound, wrapper_ms=k2["wrapper_ms"],
        timing="device events, 200 launches, 4 output buffers",
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
        plain_shape=f"boolean B={PLAIN_BATCH}, the first {S} of n={n} "
                    "steps, P=3")
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
    S = PLAIN_STEPS
    err, plain_ms = check_equal(
        "blind_rotate_goldilocks 2_2 v5",
        functools.partial(k4, bsk_k=sk.bsk_g_k[:S]), k4_plain,
        (acc[:PLAIN_BATCH].contiguous(),
         ms_mask[:PLAIN_BATCH, :S].contiguous(), sk.bsk_g[:S], bl, lv))
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
          f"B={PLAIN_BATCH}, the first {S} of n={n} steps (plain "
          f"{plain_ms:.3f} ms), on random "
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
        plain_shape=f"2_2 v5 B={PLAIN_BATCH}, the first {S} of n={n} steps")
    return sk, {"v5_keygen_s": keygen_s, "v5_pbs_ms": step_ms,
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
        S = min(PLAIN_STEPS, n)
        err, plain_ms = check_equal(
            "blind_rotate_crt_acc32 boolean", pk.blind_rotate_crt_acc32,
            pk.blind_rotate_crt_acc32_plain,
            (hi[:PLAIN_BATCH].contiguous(),
             ms_mask[:PLAIN_BATCH, :S].contiguous(), sk.bsk_scan[:S],
             p.pbs_base_log, p.pbs_level))
        print(f"K2 acc32 == plain at B={BOOL_BATCH}; K3-acc32 == plain at "
              f"B={PLAIN_BATCH}, the first {S} of n={n} steps (plain "
              f"{plain_ms:.3f} ms)")

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
        plain_shape=f"boolean B={PLAIN_BATCH}, the first {S} of n={n} "
                    "steps, P=3")
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
    kernel_bench.KB_CHECK_LOOPS and KB_ODD_LOOPS passes over the bench's
    own rows, and timed at KB_CHECK_LOOPS on the device alone
    (``k2_device_ms``: the wrapper's host time would hide µs kernels), the
    templates on N held at every N (:func:`micro_widths_equal`), then
    kernel_bench.run_all(quick=True) with the launch counts around it."""
    import torch

    from tfhe_tpu_torch.ops import kernel_bench as kb

    t0 = time.perf_counter()
    inputs = kb.micro_inputs(DEVICE)
    checked = {}
    for fn in kb.MICRO_KERNELS:
        name = fn.__name__
        plain = getattr(kb, f"{name}_plain")
        args = inputs[name] + (kb.KB_CHECK_LOOPS,)
        err, plain_ms = check_equal(name, fn, plain, args)
        odd = inputs[name] + (KB_ODD_LOOPS,)
        if not torch.equal(fn(*odd), plain(*odd)):
            raise AssertionError(f"{name} != plain at {KB_ODD_LOOPS} passes")
        family = name.replace("_fwd", "").replace("_inv", "")
        dev = k2_device_ms(lambda: fn(*args), kernel=f"{family}_kernel")
        rows_n, N = args[0].shape
        nbytes = 2 * args[0].numel() * args[0].element_size()
        checked[name] = dict(
            source="tfhe_tpu_torch/csrc/kernel_bench.cu",
            replaces="tfhe_tpu/ops/kernel_bench.py:91", max_abs_err=err,
            ms=dev["device_ms"], wrapper_ms=dev["wrapper_ms"],
            plain_ms=plain_ms,
            bound=bound(kb.micro_pipe_instructions(name, rows_n, N,
                                                   kb.KB_CHECK_LOOPS),
                        nbytes, rate),
            shape=f"{rows_n} rows x N={N}, {kb.KB_CHECK_LOOPS} passes",
            plain_shape=f"{rows_n} rows x N={N}, {kb.KB_CHECK_LOOPS} passes")
        print(f"{name} == plain at {rows_n} rows, {kb.KB_CHECK_LOOPS} and "
              f"{KB_ODD_LOOPS} passes: {dev['device_ms']:.4f} ms on the "
              f"device ({dev['wrapper_ms']:.4f} ms a wrapper call; plain "
              f"{plain_ms:.3f} ms)")
    widths = micro_widths_equal()
    print(f"kb_ntt_fwd, kb_ntt_inv, kb_rotate == plain at every N in "
          f"{widths[0]}..{widths[-1]} ({KB_WIDTH_ROWS} rows, {KB_ODD_LOOPS} "
          "passes)")
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


def micro_widths_equal() -> list:
    """kb_ntt (both directions) and kb_rotate, templates on log2 N, held
    ``torch.equal`` to their plain versions at every N they take (2 ..
    4096: a plan, strides and swizzled addresses of their own each) on
    KB_WIDTH_ROWS rows at KB_ODD_LOOPS passes, the rotations by 0, N and
    2N - 1 beside random ones. Returns the widths."""
    import torch

    from tfhe_tpu_torch.ops import kernel_bench as kb

    widths = [1 << log_n for log_n in range(1, 13)]
    for N in widths:
        x = kb.micro_inputs(DEVICE, rows=KB_WIDTH_ROWS, N=N, seed=N)
        a = x["kb_rotate"][1].clone()
        a[:3] = torch.tensor([0, N, 2 * N - 1])
        for fn, args in ((kb.kb_ntt_fwd, x["kb_ntt_fwd"]),
                         (kb.kb_ntt_inv, x["kb_ntt_inv"]),
                         (kb.kb_rotate, (x["kb_rotate"][0], a))):
            plain = getattr(kb, f"{fn.__name__}_plain")
            if not torch.equal(fn(*args, KB_ODD_LOOPS),
                               plain(*args, KB_ODD_LOOPS)):
                raise AssertionError(f"{fn.__name__} != plain at N={N}")
    return widths


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


class CountingKey:
    """The shortint server key as the integer layer of the integer, string
    and HLAPI phases sees it: counts the ``apply_lookup_table`` calls (an
    op's PBS rounds) and the ciphertexts they bootstrap, and keeps each
    call's arguments while ``calls`` is a list."""

    def __init__(self, key):
        self._key = key
        self.rounds = 0
        self.pbs = 0
        self.calls = None

    def __getattr__(self, name):
        return getattr(self._key, name)

    def apply_lookup_table(self, ct, lut):
        self.rounds += 1
        self.pbs += ct.ct[..., 0].numel()
        if self.calls is not None:
            self.calls.append((ct, lut))
        return self._key.apply_lookup_table(ct, lut)


def _int_oracle(name, x, y, bits):
    """The clear result of a ``bits``-bit op of the integer table."""
    mask = np.uint64((1 << bits) - 1)
    with np.errstate(over="ignore"):
        return {"add": lambda: (x + y) & mask, "mul": lambda: (x * y) & mask,
                "bitand": lambda: x & y, "eq": lambda: x == y,
                "div": lambda: x // y}[name]()


def readme_chain(ick, isk, key, lanes, rng):
    """The README example (FheUint32 ``a * b >> b``, cast to FheUint8,
    ``min(c)``, ``& 1``) over ``lanes`` lanes (1: the README's 1344, 5, 7;
    more: drawn from ``rng``), each step decrypted against its numpy
    oracle; {step: ms, rounds and PBS that ``key`` counted}."""
    bits_per_block = int(np.log2(key.params.message_modulus))
    nb32, nb8 = README_BLOCKS, README_C_BLOCKS
    steps = (("mul", lambda x, b, c: isk.mul(x, b),
              lambda x, b, c: x * b),
             ("right_shift", lambda x, b, c: isk.right_shift(x, b),
              lambda x, b, c: x >> (b % np.uint64(nb32 * bits_per_block))),
             ("cast_to_num_blocks", lambda x, b, c: isk.cast_to_num_blocks(x, nb8),
              lambda x, b, c: x),
             ("min", lambda x, b, c: isk.min(x, c), lambda x, b, c: np.minimum(x, c)),
             ("scalar_bitand", lambda x, b, c: isk.scalar_bitand(x, 1),
              lambda x, b, c: x & np.uint64(1)))
    m32 = np.uint64((1 << (nb32 * bits_per_block)) - 1)
    m8 = np.uint64((1 << (nb8 * bits_per_block)) - 1)
    if lanes == 1:
        va, vb, vc = (np.array([v], dtype=np.uint64) for v in (1344, 5, 7))
    else:
        va, vb = (rng.integers(0, int(m32) + 1, lanes, dtype=np.uint64)
                  for _ in range(2))
        vc = rng.integers(0, int(m8) + 1, lanes, dtype=np.uint64)
    a, b = ick.encrypt_radix(va, nb32), ick.encrypt_radix(vb, nb32)
    c = ick.encrypt_radix(vc, nb8)
    x, want, row = a, va, {}
    for i, (step, fn, oracle) in enumerate(steps):
        x, ms, rounds, pbs = timed(key, fn, x, b, c)
        with np.errstate(over="ignore"):
            want = oracle(want, vb, vc) & (m32 if i < 2 else m8)
        got = ick.decrypt_radix(x)
        if not np.array_equal(got, want.astype(got.dtype)):
            raise AssertionError(f"integer README {step}, {lanes} lanes: "
                                 f"decrypts to {got}, want {want}")
        row[step] = {"ms": ms, "rounds": rounds, "pbs": pbs}
    if lanes == 1 and [int(v) for v in ick.decrypt_radix(x)] != [1]:
        raise AssertionError("README example: the chain does not end in 1")
    print(f"README chain (FheUint32 -> FheUint8), {lanes} lane(s), "
          f"decrypted at every step: " + ", ".join(
              f"{k} {v['ms']:.1f} ms ({v['rounds']} rounds, {v['pbs']} PBS)"
              for k, v in row.items()))
    return row


def expect_radix(ick, isk, label, out, want):
    """Fail unless the radix ciphertext or boolean block ``out`` decrypts
    to ``want``."""
    from tfhe_tpu_torch.integer import radix

    got = (isk.decrypt_bool(ick, out) if isinstance(out, radix.BooleanBlock)
           else ick.decrypt_radix(out))
    if not np.array_equal(got, np.asarray(want).astype(got.dtype)):
        raise AssertionError(f"integer {label}: decrypts to {got}, want "
                             f"{want}")


def phase_integer(ck, sk, card, rows):
    """The integer layer (``tfhe_tpu_torch.integer``) on phase 2's 2_2 v6b
    keys, every PBS through the shortint ``apply_lookup_table`` (KS, K2
    acc32, K1): the README example at FheUint32 (16 blocks; FheUint8, 4
    blocks, for ``c``) at batch 1 and over INT_LANES random lanes, each
    step decrypted; the FheUint64 table of ``bench.py --integer`` (32
    blocks: add, mul, bitand, eq at batch 1 (median of 3 runs after a
    checked warm-up), add, bitand, eq at INT_LANES (ops/s, one run; mul's
    run there, 24.7 s, is cut for the script's time), div at batch 1,
    INT_DIV_BLOCKS blocks, one run, timed and checked), each
    output against its numpy oracle, one JSON row each with the op's PBS
    rounds and bootstrapped ciphertexts; then the launch counts around one
    add (K1 and K2 acc32 exactly once a round, K3 and K4 never), and K2
    acc32 and K1 against their plain versions on that add's first round.
    Times: host clock around the op, ending in a synchronize."""
    from tfhe_tpu_torch.integer import radix

    t0 = time.perf_counter()
    key = CountingKey(sk)
    ick, isk = radix.ClientKey(ck), radix.ServerKey(key)
    bits_per_block = int(np.log2(sk.params.message_modulus))
    rng = np.random.default_rng(SEED)

    expect = functools.partial(expect_radix, ick, isk)

    # 1. the README example: FheUint32 a * b >> b, cast to FheUint8, min
    #    with c, & 1
    chain = {lanes: readme_chain(ick, isk, key, lanes, rng)
             for lanes in (1, INT_LANES)}

    # 2. the FheUint64 table of bench.py --integer
    table = []
    nb64 = U64_BLOCKS
    bits64 = nb64 * bits_per_block

    def row(name, kind, batch, times, rounds, pbs, bits):
        value = (statistics.median(times) if kind == "latency"
                 else batch / (statistics.median(times) / 1e3))
        r = {"metric": f"fheuint{bits}_{name}_{kind}", "value": value,
             "unit": "ms" if kind == "latency" else "ops/s", "batch": batch,
             "rounds": rounds, "pbs": pbs, "card": card, "runs_ms": times}
        print(json.dumps(r))
        table.append(r)

    ops = (("add", isk.add), ("mul", isk.mul), ("bitand", isk.bitand),
           ("eq", isk.eq))
    inputs = {}
    for batch, kind, reps in ((1, "latency", 3), (INT_LANES, "throughput", 1)):
        xs = rng.integers(0, 1 << bits64, batch, dtype=np.uint64)
        ys = rng.integers(1, 1 << bits64, batch, dtype=np.uint64)
        a, b = ick.encrypt_radix(xs, nb64), ick.encrypt_radix(ys, nb64)
        inputs[kind] = a, b
        for name, fn in ops:
            if (name, kind) == ("mul", "throughput"):  # cut for time
                continue
            want = _int_oracle(name, xs, ys, bits64)
            if kind == "latency":  # a checked warm-up run
                expect(f"FheUint{bits64} {name}", timed(key, fn, a, b)[0],
                       want)
            times = []
            for _ in range(reps):
                out, ms, rounds, pbs = timed(key, fn, a, b)
                expect(f"FheUint{bits64} {name}, batch {batch}", out, want)
                times.append(ms)
            row(name, kind, batch, times, rounds, pbs, bits64)
    div_bits = INT_DIV_BLOCKS * bits_per_block
    xs = rng.integers(0, 1 << div_bits, 1, dtype=np.uint64)
    ys = rng.integers(1, 1 << (div_bits // 2), 1, dtype=np.uint64)
    a, b = (ick.encrypt_radix(v, INT_DIV_BLOCKS) for v in (xs, ys))
    want = _int_oracle("div", xs, ys, div_bits)
    out, ms, rounds, pbs = timed(key, isk.div, a, b)
    expect(f"FheUint{div_bits} div, timed", out, want)
    row("div", "latency", 1, [ms], rounds, pbs, div_bits)

    # 3. the launch counts around one add at batch 1, and K2 acc32 and K1
    #    against their plain versions on its first round
    a, b = inputs["latency"]
    _, launches, calls = launches_around("integer add", key, isk.add, a, b)
    rounds = key.rounds
    check_first_round("integer add", sk, calls)
    for k in ("body_rotate_acc32", "blind_rotate_bnf2_acc32"):
        rows[k]["integer_add_launches"] = launches[k]
    secs = time.perf_counter() - t0
    print(f"integer phase: {secs:.1f} s")
    return {"integer_s": secs, "integer_add_rounds": rounds,
            "readme_chain": chain, "fheuint_table": table}


def timed(key, fn, *args):
    """``fn(*args)`` between two synchronizes, host clock: (output, ms, PBS
    rounds, PBS) with the rounds and PBS that ``key`` counted."""
    import torch

    key.rounds = key.pbs = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3, key.rounds, key.pbs


def check_first_round(label, sk, calls):
    """K2 acc32 and K1 against their plain versions on the first
    ``apply_lookup_table`` call of an op (the calls a CountingKey kept)."""
    from tfhe_tpu_torch.ops import pbs_kernel as pk

    p = sk.params
    ct, lut = calls[0]
    ms_mask, ms_body = switched(sk, ct)
    ms_mask, ms_body = ms_mask.reshape(-1, p.lwe_dimension), ms_body.reshape(-1)
    check_equal("body_rotate_acc32", pk.body_rotate_acc32,
                pk.body_rotate_acc32_plain, (lut.acc, ms_body))
    acc_hi = pk.body_rotate_acc32(lut.acc, ms_body)
    check_equal("blind_rotate_bnf2_acc32", pk.blind_rotate_bnf2_acc32,
                pk.blind_rotate_bnf2_acc32_plain,
                (acc_hi, ms_mask, sk.bsk_b, p.pbs_base_log, p.pbs_level,
                 sk.flavor))
    print(f"K2 acc32 and K1 == plain on the {label}'s first round "
          f"(B={ms_body.shape[0]})")


def launches_around(label, key, fn, *args):
    """The launch counts of every kernel around one run of ``fn``: K2 acc32
    and K1 exactly once a PBS round, every other kernel never. Returns the
    run's outputs, counts and the calls it made."""
    from tfhe_tpu_torch.ops import pbs_kernel as pk

    names = [f.__name__ for f in pk.KERNELS]
    path = ("body_rotate_acc32", "blind_rotate_bnf2_acc32")
    pk.reset_launches()
    key.calls = []
    out, ms, rounds, pbs = timed(key, fn, *args)
    launches = launches_of(*names)
    calls, key.calls = key.calls, None
    require_launched(f"{label} (K2 acc32, K1)", {k: launches[k] for k in path})
    want = {k: rounds if k in path else 0 for k in names}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want} "
                             f"({rounds} rounds)")
    print(f"{label}: {rounds} rounds, {pbs} PBS, launches {launches}")
    return out, launches, calls


STRING_CAPACITY = 8  # the strings of phase 14


def phase_strings(ck, sk, card, rows):
    """Encrypted ASCII strings (``tfhe_tpu_torch.strings``) on phase 2's 2_2
    v6b keys, every PBS through the shortint ``apply_lookup_table`` (KS, K2
    acc32, K1): each op on ``"ab cd"`` at capacity STRING_CAPACITY
    (``" ab cd "`` for ``trim``) with the encrypted pattern ``"cd"``
    (capacity 2) and separator ``" "`` (capacity 1): one checked run, then
    one timed run at batch 1, each output decrypted against Python's
    ``str`` methods, one JSON row each with its PBS rounds, PBS and ms a
    round; then the launch counts around one ``eq`` and K2 acc32 and K1
    against their plain versions on its first round. The encrypted-pattern
    ``replace`` (~4,351 rounds, ~95 s at batch 1) is left to the CPU tests.
    Times: host clock around the op, ending in a synchronize."""
    from tfhe_tpu_torch.integer import radix
    from tfhe_tpu_torch.strings import StringClientKey, StringServerKey

    t0 = time.perf_counter()
    key = CountingKey(sk)
    ick = radix.ClientKey(ck)
    sck, ssk = StringClientKey(ick), StringServerKey(radix.ServerKey(key))
    text, padded, pat, sep = "ab cd", " ab cd ", "cd", " "
    cap = STRING_CAPACITY
    s, t = (sck.encrypt_ascii(text, cap) for _ in range(2))
    w = sck.encrypt_ascii(padded, cap)
    p, q = sck.encrypt_ascii(pat, len(pat)), sck.encrypt_ascii(sep, len(sep))

    def clear(out):
        if isinstance(out, (tuple, list)):
            return tuple(clear(o) for o in out)
        if hasattr(out, "capacity"):
            return sck.decrypt_ascii(out)
        if isinstance(out, radix.BooleanBlock):
            return bool(ssk.key.decrypt_bool(ick, out))
        return int(ick.decrypt_radix(out))

    def split2(s, q):
        it = ssk.split(s, q)
        return it.next(), it.next()

    lo, _, hi = text.partition(sep)
    ops = (("eq", ssk.eq, (s, t), text == text),
           ("to_uppercase", ssk.to_uppercase, (s,), text.upper()),
           ("len", ssk.len, (s,), len(text)),
           ("contains", ssk.contains, (s, p), pat in text),
           ("find", ssk.find, (s, p), (text.find(pat), True)),
           ("trim", ssk.trim, (w,), padded.strip()),
           ("split_once", ssk.split_once, (s, q), (lo, hi, True)),
           ("split_next2", split2, (s, q),
            tuple((x, True) for x in text.split(sep)[:2])))
    table = []
    for name, fn, args, want in ops:
        runs = []
        for i in range(2):  # a checked run, then a timed one
            out, ms, rounds, pbs = timed(key, fn, *args)
            if clear(out) != want:
                raise AssertionError(f"string {name}: decrypts to "
                                     f"{clear(out)!r}, want {want!r}")
            if i:
                runs.append(ms)
        ms = statistics.median(runs)
        r = {"metric": f"string_{name}", "value": ms, "unit": "ms",
             "batch": 1, "capacity": cap, "rounds": rounds, "pbs": pbs,
             "ms_per_round": ms / rounds, "card": card, "runs_ms": runs}
        print(json.dumps(r))
        table.append(r)
    _, launches, calls = launches_around("string eq", key, ssk.eq, s, t)
    check_first_round("string eq", sk, calls)
    for k in ("body_rotate_acc32", "blind_rotate_bnf2_acc32"):
        rows[k]["string_eq_launches"] = launches[k]
    secs = time.perf_counter() - t0
    total = sum(r["value"] for r in table)
    rounds = sum(r["rounds"] for r in table)
    print(f"strings phase: {secs:.1f} s; one pass of the ops {total:.1f} ms, "
          f"{rounds} rounds, {total / rounds:.2f} ms a round")
    return {"strings_s": secs, "string_table": table}


KV_SLOTS = 4  # the KVStore of phase 15
ARRAY_LANES = 32  # the FheUint8Array of phase 15


def phase_hlapi(card, integer_chain):
    """The typed high-level API (``tfhe_tpu_torch.high_level_api``) at 2_2:
    ``generate_keys`` with SEED (phase 2's keys again, on the GPU),
    ``set_server_key`` with its shortint key wrapped in a CountingKey; the
    reference README example through FheUint32 / FheUint8 operators, each
    step decrypted, beside phase 13's integer-layer chain
    (``integer_chain``); an ARRAY_LANES-lane FheUint8Array (``+``, ``&``,
    ``sum``) and a KV_SLOTS-slot KVStore (``get`` hit and miss,
    ``contains``, ``update``), each output decrypted: ms at batch 1 (one
    checked run each), PBS rounds and PBS."""
    from tfhe_tpu_torch.high_level_api import (ConfigBuilder, FheUint8,
                                               FheUint32, FheUint8Array,
                                               generate_keys, set_server_key,
                                               unset_server_key)
    from tfhe_tpu_torch.high_level_api.kv_store import KVStore
    from tfhe_tpu_torch.integer import radix

    t0 = time.perf_counter()
    ck, sk = generate_keys(ConfigBuilder().with_seed(SEED).build())
    print(f"HLAPI generate_keys 2_2: {time.perf_counter() - t0:.1f} s, "
          f"variant {sk.inner.key.ntt_variant}")
    key = CountingKey(sk.inner.key)
    sk.inner = radix.ServerKey(key)
    set_server_key(sk)
    rows = []

    def step(label, fn, want, *args):
        out, ms, rounds, pbs = timed(key, fn, *args)
        got = out.decrypt(ck)
        got = [int(v) for v in got] if isinstance(got, np.ndarray) else got
        if got != want:
            raise AssertionError(f"HLAPI {label}: decrypts to {got}, want "
                                 f"{want}")
        r = {"metric": f"hlapi_{label}", "value": ms, "unit": "ms",
             "rounds": rounds, "pbs": pbs, "card": card}
        print(json.dumps(r))
        rows.append(r)
        return out

    try:
        # the reference README example
        a = FheUint32.encrypt(1344, ck)
        b = FheUint32.encrypt(5, ck)
        c = FheUint8.encrypt(7, ck)
        x = step("readme_mul", lambda: a * b, 6720)
        x = step("readme_shr", lambda: x >> b, 210)
        x = step("readme_cast", lambda: x.cast_into(FheUint8), 210)
        x = step("readme_min", lambda: x.min(c), 7)
        x = step("readme_and1", lambda: x & 1, 1)
        chain = rows[:5]
        ms = sum(r["value"] for r in chain)
        rounds = sum(r["rounds"] for r in chain)
        int_ms = sum(v["ms"] for v in integer_chain.values())
        int_rounds = sum(v["rounds"] for v in integer_chain.values())
        print(f"README chain through FheUint32: {ms:.1f} ms, {rounds} rounds "
              f"(phase 13's integer layer: {int_ms:.1f} ms, {int_rounds} "
              "rounds)")
        if rounds != int_rounds:
            raise AssertionError("the HLAPI README chain takes another round "
                                 "count than the integer layer's")

        # a FheUint8Array of ARRAY_LANES lanes
        rng = np.random.default_rng(SEED)
        u = rng.integers(0, 256, ARRAY_LANES, dtype=np.uint64)
        v = rng.integers(0, 256, ARRAY_LANES, dtype=np.uint64)
        xa, ya = FheUint8Array.encrypt(u, ck), FheUint8Array.encrypt(v, ck)
        step("array_add", lambda: xa + ya, [int(i) for i in (u + v) % 256])
        step("array_and", lambda: xa & ya, [int(i) for i in u & v])
        step("array_sum", xa.sum, int(u.sum()) % 256)

        # a KVStore of KV_SLOTS FheUint8 slots
        kv = KVStore()
        slots = [(10 * (i + 1), 100 + i) for i in range(KV_SLOTS)]
        for k, val in slots:
            kv.insert(FheUint8.encrypt(k, ck), FheUint8.encrypt(val, ck))
        hit, miss = FheUint8.encrypt(30, ck), FheUint8.encrypt(99, ck)
        step("kv_get_hit", lambda: kv.get(hit), dict(slots)[30])
        step("kv_get_miss", lambda: kv.get(miss), 0)
        step("kv_contains", lambda: kv.contains(hit), True)
        new = FheUint8.encrypt(42, ck)
        step("kv_update_get", lambda: kv.update(hit, new) or kv.get(hit), 42)
    finally:
        unset_server_key()
    secs = time.perf_counter() - t0
    print(f"HLAPI phase: {secs:.1f} s")
    return {"hlapi_s": secs, "hlapi_table": rows}



# ---------------------------------------------------------------------------
# phase 16: the rest of shortint
# ---------------------------------------------------------------------------

MANY_LUT_FUNCS = {  # k -> the functions of one many-LUT (2_2: mod_sup 16)
    2: (lambda x: x % 4, lambda x: (x * 2) % 16),
    4: (lambda x: x, lambda x: x + 1, lambda x: (3 * x) % 4,
        lambda x: 15 - x),
}
OPRF_SEEDS = 64  # the FheUint64 OPRF's chi-square sample: 64 x 32 blocks
#: steps of the many-LUT step kernels' plain checks (phases 5, 7 and 9
#: check the same kernels at the same shapes too)
MANY_LUT_PLAIN_STEPS = 64
PATTERN_SETS = ("V1_5_PARAM_MESSAGE_2_CARRY_2_KS32_PBS_TUNIFORM_2M128",
                "V1_3_PARAM_MESSAGE_2_CARRY_2_KS32_PBS_TUNIFORM_2M128",
                "V1_5_PARAM_MESSAGE_2_CARRY_2_PBS_KS_GAUSSIAN_2M128")
LUT_KERNELS = ("body_rotate_acc32", "body_rotate_u64",
               "blind_rotate_bnf2_acc32", "blind_rotate_crt",
               "blind_rotate_crt_acc32", "blind_rotate_bnf2_u64",
               "blind_rotate_goldilocks", "multi_bit_keybundle",
               "multi_bit_accumulate", "blind_rotate_multi_bit_r14",
               "body_rotate_acc32_r1", "blind_rotate_wide",
               "blind_rotate_wide_acc32", "multi_bit_accumulate_wide",
               "blind_rotate_wide_cluster", "blind_rotate_wide_cluster_acc32",
               "multi_bit_accumulate_wide_cluster", "blind_rotate_wide_split",
               "blind_rotate_wide_split_acc32",
               "multi_bit_accumulate_wide_split")


def launches_exactly(label, fn, want: dict, timed: bool = False):
    """Run ``fn`` with every launch count zeroed just before and read just
    after: the kernels of ``want`` launched exactly that often, every other
    kernel never. Returns ``fn``'s output, and with ``timed`` its CUDA-event
    ms too (a path whose tables and keys are built already: its first call
    is a timed run)."""
    import torch

    from tfhe_tpu_torch.ops import pbs_kernel as pk

    pk.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    got = launches_of(*LUT_KERNELS)
    require_launched(label, {k: got[k] for k in want})
    if got != {k: want.get(k, 0) for k in LUT_KERNELS}:
        raise AssertionError(f"{label}: launches {got}, want {want}")
    return (out, start.elapsed_time(end)) if timed else out


def chi2_sf_3(x: float) -> float:
    """P[chi^2 with 3 degrees of freedom > x], in closed form."""
    import math

    return (math.erfc(math.sqrt(x / 2))
            + math.sqrt(2 * x / math.pi) * math.exp(-x / 2))


def pbs_inputs(sk, ct):
    """The switched (mask [B, n], body [B]) that ``sk.apply_lookup_table``
    hands its step kernels under any atomic pattern: the keyswitch first
    (not under PBS -> KS), the drift technique's zero, the switch from the
    pattern's torus."""
    from tfhe_tpu_torch.ops import server as server_ops
    from tfhe_tpu_torch.utils.params import ModulusSwitchType

    p = sk.params
    x = ct.ct if sk.order == "pbs_ks" else sk.ks_only(ct.ct)
    bits, log_mod = (32 if sk.ks32 else 64), p.polynomial_size.bit_length()
    if sk.drift is not None:
        x = server_ops.improve_drift_ms(x, sk.ms_zeros, *sk.drift, log_mod,
                                        torus_bits=bits)
    if p.modulus_switch_type == ModulusSwitchType.CENTERED_MEAN_NOISE_REDUCTION:
        switch = server_ops.lwe_centered_binary_modulus_switch
    else:
        switch = server_ops.lwe_standard_modulus_switch
    mask, body = switch(x, log_mod, bits)
    return mask.reshape(-1, p.lwe_dimension), body.reshape(-1)


def _many_lut(label, ck, sk, k, batch, want, rows, plain_b):
    """One many-LUT call of ``k`` functions on ``batch`` ciphertexts that
    cover every input degree <= mod_sup/k - 1: the launch counts around it
    (``want``), every output decrypted against its function, the step
    kernel of the path (K3 P = 4, K3-acc32 P = 4 or K4) and its K2 against
    their plain versions on the call's own inputs (the step kernel on the
    first ``plain_b`` ciphertexts over the first MANY_LUT_PLAIN_STEPS
    steps), outputs/s (median of 5)."""
    import dataclasses

    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.ops import server as server_ops

    p = sk.params
    fns = MANY_LUT_FUNCS[k]
    many = sk.generate_many_lookup_table(fns)
    vals = np.arange(batch, dtype=np.uint64) % np.uint64(
        many.max_input_degree + 1)
    ct = dataclasses.replace(ck.encrypt(vals), degree=many.max_input_degree)
    outs = launches_exactly(f"{label} many-LUT k={k}",
                            lambda: sk.apply_many_lookup_table(ct, many),
                            want)
    for i, (o, f) in enumerate(zip(outs, fns)):
        expect = np.array([f(int(v)) for v in vals], dtype=np.uint64)
        if not np.array_equal(ck.decrypt_message_and_carry(o), expect):
            raise AssertionError(f"{label} many-LUT k={k}: output {i} "
                                 f"decrypts wrong")
    mask, body = switched(sk, ct)
    mask, body = mask.reshape(-1, p.lwe_dimension), body.reshape(-1)
    bl, lv, S = p.pbs_base_log, p.pbs_level, MANY_LUT_PLAIN_STEPS
    if sk.variant == "v5":
        name, step_plain, key = ("blind_rotate_goldilocks",
                                 pk.blind_rotate_goldilocks_plain,
                                 sk.bsk_g[:S])
        step = functools.partial(pk.blind_rotate_goldilocks,
                                 bsk_k=sk.bsk_g_k[:S])
    elif server_ops.crt_acc32_requested(p.polynomial_size, bl, lv):
        name, step, step_plain = ("blind_rotate_crt_acc32",
                                  pk.blind_rotate_crt_acc32,
                                  pk.blind_rotate_crt_acc32_plain)
        key = sk.bsk_scan[:S]
    else:
        name, step, step_plain = ("blind_rotate_crt", pk.blind_rotate_crt,
                                  pk.blind_rotate_crt_plain)
        key = sk.bsk_scan[:S]
    k2 = (pk.body_rotate_acc32 if name == "blind_rotate_crt_acc32"
          else pk.body_rotate_u64)
    k2_plain = (pk.body_rotate_acc32_plain if k2 is pk.body_rotate_acc32
                else pk.body_rotate_u64_plain)
    check_equal(f"{k2.__name__} {label} many-LUT", k2, k2_plain,
                (many.acc, body))
    acc = k2(many.acc, body)
    _, plain_ms = check_equal(
        f"{name} {label} many-LUT", step, step_plain,
        (acc[:plain_b].contiguous(), mask[:plain_b, :S].contiguous(), key,
         bl, lv))
    ms = cuda_ms(lambda: sk.apply_many_lookup_table(ct, many), 5)
    rate = batch * k / ms * 1e3
    print(f"{label} many-LUT k={k}: {batch} ciphertexts x {k} functions "
          f"decrypt right; K2 and the step kernel == plain (B={plain_b}, "
          f"the first {S} of n={p.lwe_dimension} steps, plain "
          f"{plain_ms:.1f} ms); {ms:.3f} ms = {rate:.1f} outputs/s")
    rows[f"many_lut_{label}_k{k}"] = dict(batch=batch, ms=ms,
                                          outputs_per_s=rate,
                                          plain_ms=plain_ms, plain_steps=S)
    return rate


def phase_shortint_rest(ck22, sk22, sk_v5, card, rate):
    """The rest of shortint (ROADMAP Queue A items 3 and 5), on kernels the
    earlier phases hold:

    a. many-LUT on phase 2's 2_2 keys: one keyswitch and one blind rotation
       on the exact CRT key (built at first use), then one extraction a
       function, at k = 2 and 4 on 2048 ciphertexts covering every input
       degree (K2 u64 and K3 P = 4 once each, K1 and K2 acc32 never); at
       512 under ``TFHE_V4_ACC=32`` (K2 acc32, K3-acc32 P = 4) and on phase
       7's v5 key (K2 u64, K4); each kernel against its plain version on
       the call's own inputs, outputs/s;
    b. the OPRF: shortint for 1-4 random bits (in range, the same seed the
       same ciphertext); FheUint64 ``generate_oblivious_pseudo_random``
       (32 blocks, one batched PBS: K2 u64 and K3 once) at batch 1 (ms,
       median of 3) and a chi-square of 64 seeds' 2,048 2-bit blocks;
    c. the atomic patterns at full width, fresh seeded keys of the
       reference's v1.5 2_2 sets: KS32 (n = 918), KS32 with the drift
       technique (v1_3, 1,449 encryptions of zero) and PBS -> KS (n = 978,
       small-key ciphertexts): keygen s, a batch of 2048 covering all 16
       values through ``apply_lookup_table`` decrypted (K2 acc32 and K1
       once), K2 acc32 and K1 against their plain versions on the batch's
       own inputs (K1 on 64 ciphertexts over the first PLAIN_STEPS steps),
       PBS/s (median of 5),
       the keyswitch, the drift choice and K1 timed alone;
    d. phase 2's keys: add, smart_add, mul, a bivariate LUT and unchecked_neg
       on a 2048 batch, each decrypted."""
    import dataclasses

    import torch

    from tfhe_tpu_torch.integer import radix
    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.ops import server as server_ops
    from tfhe_tpu_torch.shortint import oprf
    from tfhe_tpu_torch.shortint.ciphertext import ShortintCiphertext
    from tfhe_tpu_torch.shortint.client_key import ClientKey
    from tfhe_tpu_torch.shortint.server_key import ServerKey
    from tfhe_tpu_torch.utils.params import PARAMS_BY_NAME

    t_phase = time.perf_counter()
    rows, summary = {}, {}
    # a. many-LUT
    t0 = time.perf_counter()
    sk22.crt_key()
    torch.cuda.synchronize()
    print(f"2_2 CRT key at first use: {time.perf_counter() - t0:.2f} s, "
          f"{tuple(sk22.bsk_scan.shape)}")
    u64_k3 = {"body_rotate_u64": 1, "blind_rotate_crt": 1}
    for k in (2, 4):
        summary[f"many_lut_k{k}_outputs_per_s"] = _many_lut(
            "2_2 v6b", ck22, sk22, k, BATCH, u64_k3, rows, PLAIN_BATCH)
    with env(TFHE_V4_ACC="32"):
        summary["many_lut_acc32_outputs_per_s"] = _many_lut(
            "2_2 acc32", ck22, sk22, 2, SIDE_BATCH,
            {"body_rotate_acc32": 1, "blind_rotate_crt_acc32": 1}, rows,
            PLAIN_BATCH)
    summary["many_lut_v5_outputs_per_s"] = _many_lut(
        "2_2 v5", ck22, sk_v5, 2, SIDE_BATCH,
        {"body_rotate_u64": 1, "blind_rotate_goldilocks": 1}, rows, 8)

    # b. the OPRF
    for bits in range(1, 5):
        a = oprf.generate_oblivious_pseudo_random(sk22, 1000 + bits, bits)
        b = oprf.generate_oblivious_pseudo_random(sk22, 1000 + bits, bits)
        v = int(ck22.decrypt_message_and_carry(a)[0])
        if not torch.equal(a.ct, b.ct) or not 0 <= v < 1 << bits:
            raise AssertionError(f"shortint OPRF, {bits} bits: {v}")
    isk, ick = radix.ServerKey(sk22), radix.ClientKey(ck22)
    nb = U64_BLOCKS
    out = launches_exactly(
        "FheUint64 OPRF",
        lambda: isk.generate_oblivious_pseudo_random(7, nb), u64_k3)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        isk.generate_oblivious_pseudo_random(7, nb)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    oprf_ms = statistics.median(times)
    blocks = []
    for seed in range(OPRF_SEEDS):
        r = isk.generate_oblivious_pseudo_random(seed, nb)
        blocks.append(ck22.decrypt_message_and_carry(ShortintCiphertext(
            ct=r.ct, degree=3, noise_level=1, message_modulus=4,
            carry_modulus=4)))
    counts = np.bincount(np.concatenate(blocks).astype(np.int64),
                         minlength=4)
    expected = counts.sum() / 4
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    pval = chi2_sf_3(chi2)
    if counts.sum() != OPRF_SEEDS * nb or pval <= 1e-3:
        raise AssertionError(f"FheUint64 OPRF blocks {counts}: chi2 {chi2}, "
                             f"p {pval}")
    print(f"OPRF: shortint 1-4 bits in range and deterministic; FheUint64 "
          f"{oprf_ms:.2f} ms at batch 1 ({nb} blocks, one PBS call); "
          f"{OPRF_SEEDS} seeds x {nb} blocks: counts {counts.tolist()}, "
          f"chi2 {chi2:.3f}, p {pval:.4f}")
    summary.update(fheuint64_oprf_ms=oprf_ms, oprf_chi2=chi2, oprf_p=pval)

    # c. the atomic patterns at full width
    acc32_k1 = {"body_rotate_acc32": 1, "blind_rotate_bnf2_acc32": 1}
    for name in PATTERN_SETS:
        p = PARAMS_BY_NAME[name]
        t0 = time.perf_counter()
        ck = ClientKey.generate(p, seed=SEED)
        sk = ServerKey.generate(ck)
        torch.cuda.synchronize()
        keygen_s = time.perf_counter() - t0
        label = (f"{name} ({sk.order}, n={p.lwe_dimension}, "
                 f"{'KS32' if sk.ks32 else 'KS64'}"
                 f"{', drift' if sk.drift else ''})")
        if sk.variant != "v6b":
            raise AssertionError(f"{name}: variant {sk.variant}")
        mod = p.message_modulus * p.carry_modulus
        f = lambda x: (3 * x) % mod
        vals = np.arange(BATCH, dtype=np.uint64) % np.uint64(mod)
        ct = ck.encrypt(vals)
        lut = sk.generate_lookup_table(f)
        out = launches_exactly(label, lambda: sk.apply_lookup_table(ct, lut),
                               acc32_k1)
        want = np.array([f(int(v)) for v in vals], dtype=np.uint64)
        if not np.array_equal(ck.decrypt_message_and_carry(out), want):
            raise AssertionError(f"{label}: batch decrypts wrong")
        mask, body = pbs_inputs(sk, ct)
        check_equal(f"body_rotate_acc32 {name}", pk.body_rotate_acc32,
                    pk.body_rotate_acc32_plain, (lut.acc, body))
        hi = pk.body_rotate_acc32(lut.acc, body)
        args = (sk.bsk_b, p.pbs_base_log, p.pbs_level, sk.flavor)
        _, plain_ms = check_equal(
            f"blind_rotate_bnf2_acc32 {name}", pk.blind_rotate_bnf2_acc32,
            pk.blind_rotate_bnf2_acc32_plain,
            (hi[:PLAIN_BATCH].contiguous(),
             mask[:PLAIN_BATCH, :PLAIN_STEPS].contiguous(),
             sk.bsk_b[:PLAIN_STEPS], *args[1:]))
        step_ms = cuda_ms(lambda: sk.apply_lookup_table(ct, lut), 5)
        k1_ms = cuda_ms(lambda: pk.blind_rotate_bnf2_acc32(hi, mask, *args),
                        3)
        ks_in = (sk.pbs_only(ct.ct, lut.acc) if sk.order == "pbs_ks"
                 else ct.ct)
        ks_ms = cuda_ms(lambda: sk.ks_only(ks_in), 5)
        drift_ms = None
        if sk.drift is not None:
            small = sk.ks_only(ct.ct)
            drift_ms = cuda_ms(lambda: server_ops.improve_drift_ms(
                small, sk.ms_zeros, *sk.drift,
                p.polynomial_size.bit_length(), torus_bits=32), 3)
        k1_bound_ms, k1_by = step_bound(
            "blind_rotate_bnf2_acc32", BATCH, p.lwe_dimension, p.glwe_size,
            p.pbs_level, p.polynomial_size, 2, 4, rate)
        row = dict(keygen_s=keygen_s, pbs_ms=step_ms,
                   pbs_per_s=BATCH / step_ms * 1e3, k1_ms=k1_ms,
                   k1_bound_ms=k1_bound_ms, k1_bound_by=k1_by,
                   k1_plain_ms=plain_ms, k1_plain_steps=PLAIN_STEPS,
                   keyswitch_ms=ks_ms,
                   drift_ms=drift_ms)
        print(f"{label}: keygen {keygen_s:.2f} s; {BATCH} ciphertexts "
              f"decrypt to 3x mod 16; K2 acc32 and K1 == plain (K1 at "
              f"B={PLAIN_BATCH}, the first {PLAIN_STEPS} of "
              f"n={p.lwe_dimension} steps, plain {plain_ms:.1f} ms); step {step_ms:.3f} ms = {BATCH / step_ms * 1e3:.1f} "
              f"PBS/s on {card}; K1 {k1_ms:.3f} ms (bound {k1_bound_ms:.2f}, "
              f"{k1_by}), keyswitch {ks_ms:.3f} ms"
              + (f", drift choice {drift_ms:.3f} ms" if drift_ms else ""))
        rows[name] = row
        summary[f"{name}_pbs_per_s"] = BATCH / step_ms * 1e3
        del ck, sk, ct, out, hi, mask, body, ks_in
        torch.cuda.empty_cache()

    # d. the leveled and bivariate ops on phase 2's keys
    mm = sk22.params.message_modulus
    va = np.arange(BATCH, dtype=np.uint64) % np.uint64(mm)
    vb = (np.arange(BATCH, dtype=np.uint64) // np.uint64(mm)) % np.uint64(mm)
    a, b = ck22.encrypt(va), ck22.encrypt(vb)
    ops = {
        "add": (lambda: sk22.add(a, b), (va + vb) % mm),
        "smart_add": (lambda: sk22.smart_add(a, b), va + vb),
        "mul": (lambda: sk22.mul(a, b), (va * vb) % mm),
        "bivariate": (lambda: sk22.unchecked_apply_lookup_table_bivariate(
            a, b, lambda x, y: (x + 2 * y) % mm), (va + 2 * vb) % mm),
        "unchecked_neg": (lambda: sk22.unchecked_neg(a), mm - va),
    }
    for op, (fn, want) in ops.items():
        if not np.array_equal(ck22.decrypt_message_and_carry(fn()), want):
            raise AssertionError(f"2_2 {op}: {BATCH} outputs decrypt wrong")
    print(f"2_2 add, smart_add, mul, bivariate LUT, unchecked_neg: {BATCH} "
          f"ciphertexts each decrypt right")
    summary["shortint_rest_s"] = time.perf_counter() - t_phase
    for name, row in rows.items():
        print(json.dumps({"row": name, **row}))
    print(f"phase 16: {summary['shortint_rest_s']:.1f} s")
    return summary


COMP_PARAMS = "COMP_PARAM_MESSAGE_2_CARRY_2_KS_PBS"  # list_compression
COMP_BATCH = 2048  # phase 17's compressed list: 8 GLWEs of 256
CPK_PARAMS = "PARAM_PKE_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128"
CAST_PARAMS = "PARAM_KEYSWITCH_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128"
RERAND_PARAMS = ("V1_5_PARAM_KEYSWITCH_PKE_TO_BIG_MESSAGE_2_CARRY_2_KS_PBS_"
                 "TUNIFORM_2M128")
PK_VALUES = 32  # values encrypted with the public key
HL_ITEMS = (("FheUint8", 173), ("FheUint32", 3_000_000_007),
            ("FheBool", True))  # the HLAPI compressed list of phase 17
WOPBS_VALUE = 14  # the WoP-PBS input (message 2, carry 3)


def host_s(fn):
    """(fn(), seconds on the host clock, the device synchronised)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def no_launches(label, fn):
    """Run ``fn`` with the launch counts zeroed around it: no kernel may
    launch. Returns ``fn``'s output."""
    from tfhe_tpu_torch.ops import pbs_kernel as pk

    pk.reset_launches()
    out = fn()
    got = launches_of(*LUT_KERNELS)
    if any(got.values()):
        raise AssertionError(f"{label}: launches {got}, want none")
    return out


def check_clear(label, got, want):
    if not np.array_equal(np.asarray(got, dtype=np.uint64).reshape(-1),
                          np.asarray(want, dtype=np.uint64).reshape(-1)):
        raise AssertionError(f"{label}: decrypts to {got}, want {want}")


def phase_side_modules(ck22, sk22, batch22, card, rate, rows):
    """The shortint side modules (ROADMAP Queue A item 6) on phase 2's 2_2
    keys, on kernels the earlier phases hold:

    a. list compression: COMP_BATCH ciphertexts packed (torch ops, no
       kernel) and all of them decompressed (K2 u64 -> K3 P = 4 at
       n = 1024, one launch each, nothing else), decrypted; K2 u64 and K3
       against their plain versions on the call's own inputs (K3 on
       PLAIN_BATCH ciphertexts, all 1024 steps); the ms of each, K3 alone,
       ciphertexts/s, the stored bytes;
    b. a compact list of COMP_BATCH values expanded and cast onto the small
       key (keyswitch 4 x 4, then pbs_only: K2 acc32 -> K1), decrypted;
       phase 2's batch re-randomized through the 1 x 24 key onto the big
       key (no kernel), decrypted;
    c. a public key on the card, PK_VALUES values through it;
    d. a compressed server key of phase 2's seed, decompressed byte-equal
       to phase 2's key;
    e. the HLAPI's compressed and compact lists on a compression keyset;
    f. WoP-PBS: its key, and ``wopbs`` on WOPBS_VALUE."""
    import torch

    from tfhe_tpu_torch.high_level_api import api
    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.ops import server as server_ops
    from tfhe_tpu_torch.shortint import list_compression as lc
    from tfhe_tpu_torch.shortint.client_key import ClientKey
    from tfhe_tpu_torch.shortint.compact_public_key import (
        CompactPrivateKey, CompactPublicKey)
    from tfhe_tpu_torch.shortint.compressed_server_key import \
        CompressedServerKey
    from tfhe_tpu_torch.shortint.key_switching_key import (
        KeySwitchingKey, re_randomize_ciphertexts)
    from tfhe_tpu_torch.shortint.public_key import PublicKey
    from tfhe_tpu_torch.shortint.wopbs import WopbsKey
    from tfhe_tpu_torch.utils.params import PARAMS_BY_NAME

    t_phase = time.perf_counter()
    p = ck22.params
    R, N = p.glwe_size, p.polynomial_size
    mod = p.message_modulus * p.carry_modulus
    summary = {}

    # a. list compression
    cp = getattr(lc, COMP_PARAMS)
    (comp, dec), keys_s = host_s(lambda: lc.new_compression_decompression_keys(
        ck22, lc.new_compression_private_key(ck22, cp)))
    n_in = cp.packing_ks_glwe_dimension * cp.packing_ks_polynomial_size
    vals = np.arange(COMP_BATCH, dtype=np.uint64) % np.uint64(mod)
    ct = ck22.encrypt(vals)
    lst = no_launches("compress", lambda: lc.compress(comp, ct))
    out = launches_exactly("decompress", lambda: lc.decompress(lst, dec, sk22),
                           {"body_rotate_u64": 1, "blind_rotate_crt": 1})
    k3_launches = launches_of("blind_rotate_crt")["blind_rotate_crt"]
    check_clear("decompress", ck22.decrypt_message_and_carry(out), vals)
    per = min(cp.lwe_per_glwe, cp.packing_ks_polynomial_size)
    idx = torch.arange(COMP_BATCH, device=DEVICE)
    glwes = (lst.storage.to(torch.int64) & 0xFFFFFFFF) << (
        64 - cp.storage_log_modulus)
    small = server_ops.sample_extract_at(glwes[idx // per], idx % per)
    mask, body = server_ops.lwe_standard_modulus_switch(small,
                                                        N.bit_length())
    lut = sk22.generate_lookup_table(lambda x: x % mod)
    check_equal("body_rotate_u64 decompress", pk.body_rotate_u64,
                pk.body_rotate_u64_plain, (lut.acc, body))
    acc = pk.body_rotate_u64(lut.acc, body)
    args = (dec.bsk_scan, cp.br_base_log, cp.br_level)
    err, plain_ms = check_equal(
        "blind_rotate_crt decompress", pk.blind_rotate_crt,
        pk.blind_rotate_crt_plain,
        (acc[:PLAIN_BATCH].contiguous(), mask[:PLAIN_BATCH], *args))
    k3_ms = cuda_ms(lambda: pk.blind_rotate_crt(acc, mask, *args), 2)
    comp_ms = cuda_ms(lambda: lc.compress(comp, ct), 3)
    dec_ms = cuda_ms(lambda: lc.decompress(lst, dec, sk22), 3)
    stored = lst.storage.numel() * cp.storage_log_modulus / 8
    full = COMP_BATCH * ct.ct.shape[-1] * 8
    rows["blind_rotate_crt_p4_decompress"] = dict(
        source="tfhe_tpu_torch/csrc/blind_rotate_crt.cu",
        replaces="tfhe_tpu/ops/pbs_kernel.py:1867", launches=k3_launches,
        max_abs_err=err, ms=k3_ms, plain_ms=plain_ms,
        bound=step_bound("blind_rotate_crt", COMP_BATCH, n_in, R,
                         cp.br_level, N, dec.num_primes, 8, rate),
        shape=f"2_2 decompression B={COMP_BATCH} n={n_in} P=4",
        plain_shape=f"2_2 decompression B={PLAIN_BATCH} n={n_in} P=4")
    summary.update(compression_keygen_s=keys_s, compress_ms=comp_ms,
                   decompress_ms=dec_ms,
                   decompress_per_s=COMP_BATCH / dec_ms * 1e3,
                   compressed_bytes=stored, uncompressed_bytes=full)
    print(f"compression {COMP_PARAMS}: keys {keys_s:.2f} s; {COMP_BATCH} "
          f"ciphertexts -> {lst.storage.shape[0]} GLWEs, {stored:.0f} B "
          f"stored against {full} B ({full / stored:.1f}x); compress "
          f"{comp_ms:.3f} ms, decompress {dec_ms:.3f} ms = "
          f"{COMP_BATCH / dec_ms * 1e3:.1f} ciphertexts/s on {card}, each "
          f"decrypted; K3 P=4 n={n_in} == plain (B={PLAIN_BATCH}, plain "
          f"{plain_ms:.1f} ms), {k3_ms:.3f} ms at B={COMP_BATCH}")
    del comp, dec, lst, out, small, mask, body, acc, glwes

    # b. compact public key, casting, re-randomization
    priv = CompactPrivateKey.generate(PARAMS_BY_NAME[CPK_PARAMS], seed=SEED)
    cpk = CompactPublicKey.generate(priv)
    cast_key = KeySwitchingKey.generate(priv, ck22, sk22,
                                        PARAMS_BY_NAME[CAST_PARAMS])
    clist, enc_s = host_s(lambda: cpk.encrypt(vals))
    expanded, exp_s = host_s(clist.expand_to_shortint)
    check_clear("compact list", priv.decrypt_expanded(expanded.ct), vals)
    out = launches_exactly(
        "cast", lambda: cast_key.cast(expanded),
        {"body_rotate_acc32": 1, "blind_rotate_bnf2_acc32": 1})
    check_clear("cast", ck22.decrypt_message_and_carry(out), vals)
    cast_ms = cuda_ms(lambda: cast_key.cast(expanded), 3)
    rerand_key = KeySwitchingKey.generate(priv, ck22, sk22,
                                          PARAMS_BY_NAME[RERAND_PARAMS])
    ct2 = batch22[0]
    want2 = ck22.decrypt_message_and_carry(ct2)
    (rr,), rr_s = host_s(lambda: no_launches(
        "re-randomize", lambda: re_randomize_ciphertexts(
            [ct2], cpk, rerand_key, seed=SEED)))
    check_clear("re-randomized", ck22.decrypt_message_and_carry(rr), want2)
    if torch.equal(rr.ct, ct2.ct):
        raise AssertionError("re-randomization left the ciphertexts as they "
                             "were")
    summary.update(cpk_encrypt_s=enc_s, cpk_expand_s=exp_s, cast_ms=cast_ms,
                   casts_per_s=COMP_BATCH / cast_ms * 1e3,
                   rerandomize_s=rr_s)
    print(f"compact PK {CPK_PARAMS}: {COMP_BATCH} values encrypted in "
          f"{enc_s:.3f} s, expanded in {exp_s:.3f} s; cast {CAST_PARAMS} "
          f"{cast_ms:.3f} ms = {COMP_BATCH / cast_ms * 1e3:.1f} casts/s, "
          f"decrypted; phase 2's {COMP_BATCH} re-randomized ({RERAND_PARAMS}) "
          f"in {rr_s:.3f} s, decrypted")
    del cpk, priv, cast_key, rerand_key, clist, expanded, out, rr

    # c. the public key
    pub, pk_s = host_s(lambda: PublicKey.generate(ck22))
    pv = np.arange(PK_VALUES, dtype=np.uint64) % np.uint64(p.message_modulus)
    pct, pk_enc_s = host_s(lambda: pub.encrypt(pv))
    check_clear("public key", ck22.decrypt(pct), pv)
    _, pk_enc2_s = host_s(lambda: pub.encrypt(pv))
    summary.update(public_key_s=pk_s, public_key_encrypt_ms=pk_enc2_s * 1e3)
    print(f"public key: {tuple(pub.zeros.shape)} on the card in {pk_s:.2f} "
          f"s; {PK_VALUES} values encrypted in {pk_enc_s * 1e3:.1f} ms (first, "
          f"limbs built) and {pk_enc2_s * 1e3:.1f} ms, decrypted")
    del pub, pct
    torch.cuda.empty_cache()

    # d. the compressed server key
    csk, csk_s = host_s(lambda: CompressedServerKey.generate(
        ClientKey.generate(p, seed=SEED)))
    skd, dec_s = host_s(csk.decompress)
    for f in ("ksk", "ksk_i8", "bsk_b"):
        if not torch.equal(getattr(skd, f), getattr(sk22, f)):
            raise AssertionError(f"decompressed key: {f} differs")
    if not torch.equal(skd.crt_key(), sk22.crt_key()):
        raise AssertionError("decompressed key: the CRT key differs")
    body_mb = csk.serialized_size_bytes() / 1e6
    key_mb = sum(t.numel() * t.element_size()
                 for t in (sk22.bsk_b, sk22.ksk, sk22.ksk_i8)) / 1e6
    summary.update(compressed_key_s=csk_s, compressed_key_decompress_s=dec_s,
                   compressed_key_mb=body_mb, server_key_mb=key_mb)
    print(f"compressed server key: generated in {csk_s:.2f} s, "
          f"decompressed in {dec_s:.2f} s, byte-equal to phase 2's key (KSK, "
          f"limbs, BNF2 BSK, CRT key); {body_mb:.2f} MB of bodies against "
          f"{key_mb:.2f} MB of device key")
    del csk, skd

    # e. the HLAPI
    (hck, hsk), hkey_s = host_s(lambda: api.generate_keys(
        api.ConfigBuilder().use_custom_parameters(p).with_seed(SEED)
        .enable_compression(cp).build()))
    api.set_server_key(hsk)
    builder = api.CompressedCiphertextListBuilder()
    for ty, v in HL_ITEMS:
        builder.push(getattr(api, ty).encrypt(v, hck))
    hl, hl_s = host_s(builder.build)
    got = [hl.get(i).decrypt(hck) for i in range(len(hl))]
    if got != [v for _, v in HL_ITEMS]:
        raise AssertionError(f"HLAPI compressed list: {got}")
    hcpk = api.CompactPublicKey.new(hck, hsk, PARAMS_BY_NAME[CPK_PARAMS],
                                    PARAMS_BY_NAME[CAST_PARAMS], seed=SEED)
    cl = api.CompactCiphertextListBuilder(hcpk).push(201, api.FheUint8) \
        .push(False, api.FheBool).build()
    got = [v.decrypt(hck) for v in cl.expand()]
    if got != [201, False]:
        raise AssertionError(f"HLAPI compact list: {got}")
    api.unset_server_key()
    summary.update(hlapi_compression_keys_s=hkey_s,
                   hlapi_compressed_list_build_s=hl_s)
    print(f"HLAPI: generate_keys with compression {hkey_s:.2f} s; "
          f"compressed list of {', '.join(t for t, _ in HL_ITEMS)} built in "
          f"{hl_s:.3f} s, each item back and decrypted; compact list "
          f"builder -> expand decrypted")
    del hck, hsk, hl, hcpk, cl

    # f. WoP-PBS
    wk, wk_s = host_s(lambda: WopbsKey.generate(ck22, sk22))
    f = lambda x: (7 * x + 3) % mod  # noqa: E731
    v = WOPBS_VALUE
    wct = ck22.encrypt(np.array([v], dtype=np.uint64))
    wout, wopbs_s = host_s(lambda: no_launches(
        "wopbs", lambda: wk.wopbs(wct, f)))
    check_clear(f"wopbs({v})", ck22.decrypt_message_and_carry(wout), [f(v)])
    summary.update(wopbs_keygen_s=wk_s, wopbs_s=wopbs_s)
    print(f"WoP-PBS: key {wk_s:.2f} s (packing keys "
          f"{tuple(wk.pfpksk.shape)}, BSK P={wk.wopbs_num_primes}); "
          f"wopbs x -> 7x + 3 mod 16 on {v}: {wopbs_s:.2f} s, message and "
          f"carry decrypted")
    del wk
    torch.cuda.empty_cache()

    summary["side_modules_s"] = time.perf_counter() - t_phase
    print(json.dumps({"row": "side_modules", **summary}))
    print(f"phase 17: {summary['side_modules_s']:.1f} s")
    return summary


# ---------------------------------------------------------------------------
# phase 18: the multi-bit PBS
# ---------------------------------------------------------------------------

#: the multi-bit sets of phase 18 by universe name: (label, name, batch,
#: ciphertexts of the checks against the plain versions on the path's own
#: inputs (at most: a smaller batch checks all of its own), the other
#: batches timed in turns, each checked over MB_CUT_STEPS group steps)
MB_SETS = (
    ("g4", "PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
     BATCH, PLAIN_BATCH, (1, 32, 264)),
    ("g2_n4096", "PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS",
     SIDE_BATCH, 16, ()),
    ("g3", "V1_5_PARAM_GPU_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_"
     "TUNIFORM_2M128", SIDE_BATCH, 16, ()))
MB_INT_OPS = ("add", "bitand", "eq")  # FheUint64 at batch 1 on group 4
MB_CUT_STEPS = 16  # group steps of the plain checks at g4's other batches
MB_SOURCE = "tfhe_tpu_torch/csrc/blind_rotate_multi_bit.cu"
MB_REPLACES = "tfhe_tpu/ops/server.py:809"
#: the kernel rows of phase 18 at each shape: the pair (the function K5
#: computes), K5a, K5b, the single-kernel reference r14
MB_ROWS = ("blind_rotate_multi_bit", "multi_bit_keybundle",
           "multi_bit_accumulate", "blind_rotate_multi_bit_r14")
MB_SHAPES = ("g4", "g4_b1", "g4_b32", "g4_b264", "g2_n4096", "g3")


def mb_launches(B: int, mbk) -> dict:
    """The launches of one multi-bit PBS of B ciphertexts on key ``mbk``:
    K2 u64 once, K5a and K5b once a chunk of ``pk.multi_bit_chunk`` steps,
    r14 (and every other kernel) never."""
    import math

    from tfhe_tpu_torch.ops import pbs_kernel as pk

    ng, _, P, _, lR, R, N = mbk.shape
    pairs = math.ceil(ng / pk.multi_bit_chunk(B, ng, P, lR, R, N))
    return {"body_rotate_u64": 1, "multi_bit_keybundle": pairs,
            "multi_bit_accumulate": pairs}


def multi_bit_bytes(B: int, n_groups: int, grouping: int, R: int,
                    levels: int, N: int, P: int) -> float:
    """Bytes the function must move: the key's residues once (the function
    needs no Shoup duals, which K5a and r14 also read), the u64
    accumulator in and out, the mask, the constant tables and exponents."""
    key = n_groups * P * ((1 << grouping) - 1) * levels * R * R * N * 4
    return (key + 2 * B * R * N * 8 + B * n_groups * grouping * 4
            + P * 8 * N * 4 + N * 4)


def keybundle_bytes(B: int, n_groups: int, grouping: int, R: int,
                    levels: int, N: int, P: int) -> float:
    """K5a's bytes: the key's residues once, the mask, the tables and
    exponents, and the bundles written (P l R R N u32 a
    ciphertext-step)."""
    key = n_groups * P * ((1 << grouping) - 1) * levels * R * R * N * 4
    return (key + B * n_groups * grouping * 4 + P * 8 * N * 4 + N * 4
            + B * n_groups * P * levels * R * R * N * 4)


def accumulate_bytes(B: int, n_groups: int, R: int, levels: int, N: int,
                     P: int) -> float:
    """K5b's bytes: the bundles read, the u64 accumulator in and out, the
    tables."""
    return (B * n_groups * P * levels * R * R * N * 4 + 2 * B * R * N * 8
            + P * 8 * N * 4)


def median_in_turns(new, ref, reps: int = 5) -> tuple:
    """CUDA-event ms of ``new()`` and ``ref()`` run in turns (ref, new,
    ref, new, ...) after one warm-up run each: (median of new's ``reps``
    runs, median of ref's)."""
    new(), ref()
    times = {new: [], ref: []}
    for _ in range(reps):
        for fn in (ref, new):
            times[fn].append(cuda_ms(fn, 1, warmup=False))
    return statistics.median(times[new]), statistics.median(times[ref])


def _multi_bit_plain(label, sk, acc, mask, plain_b, cut=None):
    """K5a, K5b and the pair against their plain versions on a shape's own
    inputs (``acc``, ``mask``: the switched, body-rotated batch), exact:
    K5a on the call's first chunk of steps for the whole batch, K5b over
    all n/g steps of the first ``plain_b`` ciphertexts (their bundles from
    K5a), the pair on those ciphertexts and on random u64 accumulators
    over 32 steps; with ``cut``, all of it over the first ``cut`` group
    steps (a depth cut). Returns the (max_abs_err, plain ms, plain shape) of
    K5a, K5b and the pair."""
    from tfhe_tpu_torch.ops import pbs_kernel as pk

    p = sk.params
    g, R, N, lv, bl = (p.grouping_factor, p.glwe_size, p.polynomial_size,
                       p.pbs_level, p.pbs_base_log)
    mbk = sk.bsk_mb
    ng, P = mbk.shape[0], mbk.shape[2]
    B = acc.shape[0]
    C = pk.multi_bit_chunk(B, ng, P, lv * R, R, N)
    of = ""
    if cut is not None and cut < ng:
        of = f" (a cut: of {ng})"
        ng, C = cut, min(C, cut)
        mbk, mask = mbk[:ng].contiguous(), mask[:, :ng * g].contiguous()
    a = check_equal(f"multi_bit_keybundle {label}", pk.multi_bit_keybundle,
                    pk.multi_bit_keybundle_plain, (mask, mbk, 0, C, bl, lv))
    acc_b, mask_b = acc[:plain_b].contiguous(), mask[:plain_b].contiguous()
    bundles = pk.multi_bit_keybundle(mask_b, mbk, 0, ng, bl, lv)
    b = check_equal(f"multi_bit_accumulate {label}", pk.multi_bit_accumulate,
                    pk.multi_bit_accumulate_plain, (acc_b, bundles, bl, lv))
    del bundles
    f = check_equal(f"blind_rotate_multi_bit {label}",
                    pk.blind_rotate_multi_bit, pk.blind_rotate_multi_bit_plain,
                    (acc_b, mask_b, mbk, bl, lv))
    steps = min(32, ng)
    racc, rmask = _random_acc_mask(np.random.default_rng(SEED + 18),
                                   plain_b, steps * g, R, N)
    check_equal(f"blind_rotate_multi_bit {label}, random acc",
                pk.blind_rotate_multi_bit, pk.blind_rotate_multi_bit_plain,
                (racc, rmask, mbk[:steps].contiguous(), bl, lv))
    print(f"{label}: K5a == plain on steps 0..{C - 1} of B={B} (plain "
          f"{a[1]:.1f} ms); K5b == plain over {ng} steps{of} at B={plain_b} "
          f"(plain {b[1]:.1f} ms); the pair == plain at B={plain_b} (plain "
          f"{f[1]:.1f} ms) and on random accumulators, {steps} steps")
    return ((*a, f"{label} B={B} steps 0..{C - 1}"),
            (*b, f"{label} B={plain_b} n/g={ng}{of}"),
            (*f, f"{label} B={plain_b} n/g={ng}{of}"))


def _multi_bit_shape(label, ck, sk, batch, rate, rows, plain_b, cut=None):
    """One multi-bit shape: ``batch`` ciphertexts covering all message +
    carry values through ``apply_lookup_table`` with the launch counts
    zeroed just before and read just after (``mb_launches``), decrypted;
    K5a, K5b and the pair against their plain versions on that batch's
    inputs (``_multi_bit_plain``, ``plain_b`` ciphertexts, over the first
    ``cut`` group steps where it is given, which give the rows' plain
    columns); at g4 (B = 2048) alone the pair equal to r14,
    the reference no user path launches, on the whole batch and the two
    timed in turns (median of 5), elsewhere the pair alone (median of 5); K5a and K5b apart over the
    call's chunks (median of 3), KS -> PBS (median of 5); the shape's four
    kernel rows. Returns the shape's numbers."""
    import torch

    from tfhe_tpu_torch.ops import kernel_bench as kb
    from tfhe_tpu_torch.ops import pbs_kernel as pk

    p = sk.params
    g, R, N, lv, bl = (p.grouping_factor, p.glwe_size, p.polynomial_size,
                       p.pbs_level, p.pbs_base_log)
    mbk = sk.bsk_mb
    ng, P = mbk.shape[0], mbk.shape[2]
    mod = p.message_modulus * p.carry_modulus
    f = lambda x: (3 * x) % mod
    vals = np.arange(batch, dtype=np.uint64) % mod
    ct = ck.encrypt(vals)
    lut = sk.generate_lookup_table(f)
    out = launches_exactly(f"{label} main path",
                           lambda: sk.apply_lookup_table(ct, lut),
                           mb_launches(batch, mbk))
    launches = launches_of(*MB_ROWS[1:])
    want = np.array([f(int(v)) for v in vals], dtype=np.uint64)
    if not np.array_equal(ck.decrypt_message_and_carry(out), want):
        raise AssertionError(f"{label}: batch of {batch} decrypts wrong")
    mask, body = switched(sk, ct)
    mask = mask.contiguous()
    check_equal(f"body_rotate_u64 {label}", pk.body_rotate_u64,
                pk.body_rotate_u64_plain, (lut.acc, body))
    acc = pk.body_rotate_u64(lut.acc, body)
    plain = _multi_bit_plain(label, sk, acc, mask, plain_b, cut)
    pair = lambda: pk.blind_rotate_multi_bit(acc, mask, mbk, bl, lv)
    r14 = lambda: pk.blind_rotate_multi_bit_r14(acc, mask, mbk, bl, lv)
    if label == "g4":
        if not torch.equal(pair(), r14()):
            raise AssertionError(f"{label}: the K5 pair != r14 at B={batch}")
        pair_ms, r14_ms = median_in_turns(pair, r14)
    else:
        pair_ms, r14_ms = cuda_ms(pair, 5), None
    C = pk.multi_bit_chunk(batch, ng, P, lv * R, R, N)
    chunks = [(t0, min(C, ng - t0)) for t0 in range(0, ng, C)]
    k5a_ms = cuda_ms(lambda: [pk.multi_bit_keybundle(mask, mbk, t0, c, bl, lv)
                              for t0, c in chunks], 3)
    bundles = {c: pk.multi_bit_keybundle(mask, mbk, 0, c, bl, lv)
               for c in {c for _, c in chunks}}
    k5b_ms = cuda_ms(lambda: [pk.multi_bit_accumulate(acc, bundles[c], bl, lv)
                              for _, c in chunks], 3)
    del bundles
    torch.cuda.empty_cache()
    step_ms = cuda_ms(lambda: sk.apply_lookup_table(ct, lut), 5)
    r14_note = ("r14 run at g4 alone" if r14_ms is None else
                f"in turns with r14 {r14_ms:.3f} ms "
                f"({r14_ms / pair_ms:.2f}x, pair == r14)")
    print(f"{label} B={batch}: KS->PBS {step_ms:.3f} ms = "
          f"{batch / step_ms * 1e3:.1f} PBS/s; the K5 pair {pair_ms:.3f} ms, "
          f"{r14_note}; {len(chunks)} chunks of {C} steps: K5a "
          f"{k5a_ms:.3f} ms, K5b {k5b_ms:.3f} ms "
          f"({k5b_ms / ng * 1e3:.1f} us a step); launches {launches}")
    (a_err, a_plain, a_shape), (b_err, b_plain, b_shape), \
        (f_err, f_plain, f_shape) = plain
    fn_bound = bound(kb.multi_bit_pipe_instructions(batch, ng, g, R, lv, N, P),
                     multi_bit_bytes(batch, ng, g, R, lv, N, P), rate)
    common = dict(source=MB_SOURCE, replaces=MB_REPLACES,
                  shape=f"{label} B={batch} n/g={ng} g={g} C={C}",
                  note="no pallas_call: XLA in tfhe_tpu")
    rows[f"blind_rotate_multi_bit_{label}"] = dict(
        common, launches=launches["multi_bit_keybundle"]
        + launches["multi_bit_accumulate"], max_abs_err=f_err, ms=pair_ms,
        plain_ms=f_plain, plain_shape=f_shape, bound=fn_bound,
        kernel="the K5 pair (K5a + K5b a chunk)"
               + (", in turns with r14" if r14_ms is not None else ""))
    rows[f"multi_bit_keybundle_{label}"] = dict(
        common, launches=launches["multi_bit_keybundle"], max_abs_err=a_err,
        ms=k5a_ms, plain_ms=a_plain, plain_shape=a_shape,
        bound=bound(kb.multi_bit_keybundle_pipe_instructions(
            batch, ng, g, R, lv, N, P),
            keybundle_bytes(batch, ng, g, R, lv, N, P), rate),
        kernel="K5a, all chunks of the call")
    rows[f"multi_bit_accumulate_{label}"] = dict(
        common, launches=launches["multi_bit_accumulate"], max_abs_err=b_err,
        ms=k5b_ms, plain_ms=b_plain, plain_shape=b_shape,
        bound=bound(kb.multi_bit_accumulate_pipe_instructions(
            batch, ng, R, lv, N, P),
            accumulate_bytes(batch, ng, R, lv, N, P), rate),
        kernel="K5b, all chunks of the call")
    if r14_ms is not None:
        rows[f"blind_rotate_multi_bit_r14_{label}"] = dict(
            common, launches=launches["blind_rotate_multi_bit_r14"],
            max_abs_err=f_err, ms=r14_ms, plain_ms=f_plain,
            plain_shape=f_shape, bound=fn_bound,
            kernel="r14, the single-kernel reference (no user path), in "
                   "turns with the pair")
    return {f"mb_{label}_pbs_ms": step_ms,
            f"mb_{label}_pbs_per_s": batch / step_ms * 1e3,
            f"mb_{label}_k5_ms": pair_ms, f"mb_{label}_r14_ms": r14_ms,
            f"mb_{label}_k5a_ms": k5a_ms, f"mb_{label}_k5b_ms": k5b_ms,
            f"mb_{label}_chunk": C}


def _multi_bit_keys(label, name):
    """Seeded keys of a multi-bit set of the universe: (ck, sk, keygen s)."""
    import torch

    from tfhe_tpu_torch.shortint.client_key import ClientKey
    from tfhe_tpu_torch.shortint.server_key import ServerKey
    from tfhe_tpu_torch.utils.params import PARAMS_BY_NAME

    p = PARAMS_BY_NAME[name]
    t0 = time.perf_counter()
    ck = ClientKey.generate(p, seed=SEED)
    sk = ServerKey.generate(ck)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    print(f"keygen {label} ({name}): {keygen_s:.1f} s, n = {p.lwe_dimension}"
          f", g = {p.grouping_factor}, N = {p.polynomial_size}, l = "
          f"{p.pbs_level}, P = {sk.num_primes}, K5 key "
          f"{tuple(sk.bsk_mb.shape)} ({sk.bsk_mb.numel() * 4 / 1e9:.3f} GB)")
    return ck, sk, keygen_s


def phase_multi_bit(card, rate, rows, table13):
    """The multi-bit PBS (ROADMAP Queue A item 8, first half) on K2 u64 ->
    the K5 pair (K5a, K5b a chunk of steps), at three sets of the
    reference's universe by name, full width, each on its own seeded keys:
    a. the GPU default group-4 set (n = 920, N = 2048, 230 steps) at 2048
       (``_multi_bit_shape``, the plain checks on 64 ciphertexts), then at
       1, 32 and 264 (each through ``apply_lookup_table`` with its launch
       counts, decrypted, the plain checks on min(batch, 64) ciphertexts
       over the first MB_CUT_STEPS group steps, the pair timed); at batch 1
       KS -> PBS (median of 5), FheUint64 add, bitand and eq (ms, rounds)
       against their numpy oracles beside phase 13's v6b numbers, the
       README chain at FheUint32, and the FheUint64 OPRF (one batched PBS);
    b. the group-2 set at N = 4096 (452 steps; K5b's largest shared
       memory) and
    c. the v1.5 GPU group-3 set (l = 2, 293 steps), each at 512 (the plain
       checks on 16 ciphertexts)."""
    import torch

    from tfhe_tpu_torch.integer import radix

    t_phase = time.perf_counter()
    summary = {}
    for label, name, batch, plain_b, more in MB_SETS:
        ck, sk, keygen_s = _multi_bit_keys(label, name)
        summary[f"mb_{label}_keygen_s"] = keygen_s
        summary.update(_multi_bit_shape(label, ck, sk, batch, rate, rows,
                                        plain_b))
        for b in more:
            summary.update(_multi_bit_shape(f"{label}_b{b}", ck, sk, b, rate,
                                            rows, min(b, plain_b),
                                            MB_CUT_STEPS))
        if label != "g4":
            del ck, sk
            torch.cuda.empty_cache()
            continue
        # a. batch 1 on the group-4 keys: KS -> PBS, the integer ops
        ks_pbs_1 = summary["mb_g4_b1_pbs_ms"]
        k5a_1, k5b_1 = summary["mb_g4_b1_k5a_ms"], summary["mb_g4_b1_k5b_ms"]
        ng = sk.bsk_mb.shape[0]
        print(f"{label} batch 1: KS->PBS {ks_pbs_1:.3f} ms, the K5 pair "
              f"{summary['mb_g4_b1_k5_ms']:.3f} ms: K5a {k5a_1:.3f} ms, K5b "
              f"{k5b_1:.3f} ms = {k5b_1 / ng * 1e3:.1f} us a step, on {card}")
        summary["mb_g4_ks_pbs_b1_ms"] = ks_pbs_1
        p = sk.params
        key = CountingKey(sk)
        ick, isk = radix.ClientKey(ck), radix.ServerKey(key)
        rng = np.random.default_rng(SEED + 18)
        bits64 = U64_BLOCKS * int(np.log2(p.message_modulus))
        xs = rng.integers(0, 1 << bits64, 1, dtype=np.uint64)
        ys = rng.integers(1, 1 << bits64, 1, dtype=np.uint64)
        a = ick.encrypt_radix(xs, U64_BLOCKS)
        b = ick.encrypt_radix(ys, U64_BLOCKS)
        v6b = {r["metric"]: r for r in table13}
        for op in MB_INT_OPS:
            fn = getattr(isk, op)
            want = _int_oracle(op, xs, ys, bits64)
            times = []
            for _ in range(4):  # a checked warm-up run, then three
                out, ms, rounds, pbs = timed(key, fn, a, b)
                expect_radix(ick, isk, f"{label} FheUint64 {op}", out, want)
                times.append(ms)
            ms = statistics.median(times[1:])
            ref = v6b.get(f"fheuint64_{op}_latency", {})
            print(json.dumps({"metric": f"mb_{label}_fheuint64_{op}_latency",
                              "value": ms, "unit": "ms", "batch": 1,
                              "rounds": rounds, "pbs": pbs, "card": card,
                              "runs_ms": times[1:],
                              "v6b_ms": ref.get("value"),
                              "v6b_rounds": ref.get("rounds")}))
            summary[f"mb_{label}_fheuint64_{op}_ms"] = ms
            summary[f"mb_{label}_fheuint64_{op}_rounds"] = rounds
        summary[f"mb_{label}_readme_chain"] = readme_chain(ick, isk, key, 1,
                                                           rng)
        t0 = time.perf_counter()
        oprf = launches_exactly(
            f"{label} FheUint64 OPRF",
            lambda: isk.generate_oblivious_pseudo_random(
                seed=SEED, num_blocks=U64_BLOCKS),
            mb_launches(U64_BLOCKS, sk.bsk_mb))
        oprf_ms = (time.perf_counter() - t0) * 1e3
        value = int(ick.decrypt_radix(oprf))
        if not 0 <= value < 1 << bits64 or oprf.degrees.max() > 3:
            raise AssertionError(f"{label} FheUint64 OPRF: {value}")
        print(f"{label} FheUint64 OPRF at batch 1: {oprf_ms:.1f} ms (one "
              f"batched PBS of {U64_BLOCKS} blocks, host clock)")
        summary[f"mb_{label}_oprf_ms"] = oprf_ms
        g4_keys = ck, sk  # phase 19's R1 split reads a round on them
        del key, isk, ick
        torch.cuda.empty_cache()
    summary["multi_bit_s"] = time.perf_counter() - t_phase
    print(f"phase 18: {summary['multi_bit_s']:.1f} s")
    return summary, g4_keys


CLIENT_LANES = 32  # phase 19's thin-client FheUint64 pairs
R1_KERNELS = (  # (label, kernel-name part) of the R1 split, first match
    ("K2", "body_rotate"), ("K5a", "multi_bit_keybundle_kernel"),
    ("K5b", "multi_bit_accumulate_kernel"), ("K1", "blind_rotate_kernel"),
    ("H2D copy", "Memcpy HtoD"), ("keyswitch GEMM", "gemm"))


def r1_split(events, span_name: str, rounds: int, need=()) -> dict:
    """R1's first split of a traced op from the profiler's events: the
    device time by kernel class (``R1_KERNELS``, the rest "other device")
    and the host time beside it (the span's wall time minus the union of
    the device intervals inside it), each in ms a round. Raises when the
    trace holds no span or no device event of a class in ``need``."""
    span = [e for e in events if e.name == span_name
            and e.device_type.name == "CPU"]
    if not span:
        raise AssertionError(f"the trace holds no span {span_name!r}")
    t0, t1 = span[0].time_range.start, span[0].time_range.end
    dev = sorted((e for e in events if e.device_type.name == "CUDA"
                  and e.name != span_name  # the span's GPU-side range
                  and t0 <= e.time_range.start <= t1),
                 key=lambda e: e.time_range.start)
    split, counts = {}, {}
    for e in dev:
        label = next((lab for lab, part in R1_KERNELS
                      if part.lower() in e.name.lower()), "other device")
        split[label] = split.get(label, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
        counts[label] = counts.get(label, 0) + 1
    busy, end = 0.0, t0
    for e in dev:  # the union of the device intervals
        a, b = max(e.time_range.start, end), e.time_range.end
        if b > a:
            busy += b - a
            end = b
    missing = [lab for lab in need if lab not in counts]
    if missing:
        raise AssertionError(f"the profiler recorded no {missing} kernel in "
                             f"{span_name!r} (device events: {counts})")
    wall = (t1 - t0) / 1e3
    out = {k: v / rounds for k, v in split.items()}
    out["host (wall - device busy)"] = (wall - busy / 1e3) / rounds
    return {"ms_a_round": out, "events": counts, "wall_ms": wall,
            "device_busy_ms": busy / 1e3, "rounds": rounds}


def phase_platform(ck22, sk22, batch22, g4_keys, card, summary):
    """The platform layers (ROADMAP Queue A item 9a) at 2_2, full width:
    a. phase 2's server key through ``safe_serialize`` and back onto the
       card (size limit, ``conformance_params``): MB, ms; its
       ``apply_lookup_table`` on phase 2's 2048 ciphertexts
       ``torch.equal`` to phase 2's output (K2 acc32 and K1 once), PBS/s
       beside phase 2's;
    b. the thin client (``tfhe_tpu_torch.client``) on ``device="cpu"``:
       phase 2's client key from its envelope, CLIENT_LANES FheUint64
       pairs encrypted, each bit-equal to a fresh full-stack ClientKey of
       the seed on the card; their envelopes loaded onto the card as
       FheUint64, added on the round-tripped key (8 rounds), the sums'
       envelope decrypted by the client on the CPU;
    c. ``generate_keys(ConfigBuilder().build(), use_keycache=True)`` twice
       on a fresh cache under ``chiprun_out/`` (a miss: keygen and write;
       then a hit: a load), the keys' tensors equal, a FheUint64 add on the
       hit's key decrypted; the cache removed;
    d. ``utils.trace`` spans around phase 13's FheUint64 add, bitand and eq
       at batch 1: PBS and KS counts equal to what phase 13's wrapper of
       ``apply_lookup_table`` counted;
    e. ROADMAP R1's first split (its times printed, not gated):
       ``trace.profile`` around one batch-1 FheUint64 add on phase 2's key
       and on phase 18's group-4 key: device ms a round of the keyswitch
       GEMM, the H2D copies (the LUT), K2, K1 or K5a + K5b, other kernels,
       and the host time beside them; the profiler's overhead against the
       same add unprofiled. It fails when the trace holds no span or no
       K2 and K1 (K5a and K5b) event;
    f. the golden vectors (``apps.test_vectors.check(device="cuda")``: K2
       u64 -> K3 at N = 256) against ``apps/test_vectors_data/
       checksums.json``, and that K2 u64 and K3 call against their plain
       versions."""
    import shutil
    import tempfile

    import torch

    from tfhe_tpu_torch import client, integer, keycache
    from tfhe_tpu_torch.high_level_api import api as hl
    from tfhe_tpu_torch._torus import from_u64, to_u64
    from tfhe_tpu_torch.apps import test_vectors as tv
    from tfhe_tpu_torch.integer import radix
    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.utils import serialization as ser
    from tfhe_tpu_torch.utils import trace

    t_phase = time.perf_counter()
    out = {}
    p = sk22.params
    bits = U64_BLOCKS * int(np.log2(p.message_modulus))  # FheUint64
    uint = hl.fhe_uint(bits)
    v6b = {r["metric"]: r for r in summary["fheuint_table"]}
    names = [f.__name__ for f in pk.KERNELS]
    pk.reset_launches()

    def host(fn, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn(*args)
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3

    # a. the server key round trip
    ct, lut, want = batch22
    blob, ser_ms = host(hl.safe_serialize,
                        hl.ServerKey(integer.ServerKey(sk22)))
    sk_rt, de_ms = host(lambda: hl.safe_deserialize(
        blob, conformance=ser.conformance_params(p.name)))
    mb = len(blob) / 1e6
    print(f"2_2 server key envelope: {mb:.2f} MB, safe_serialize "
          f"{ser_ms:.1f} ms, safe_deserialize onto the card {de_ms:.1f} ms")
    before = launches_of("body_rotate_acc32", "blind_rotate_bnf2_acc32")
    got = sk_rt.apply_lookup_table(ct, lut)
    torch.cuda.synchronize()
    after = launches_of("body_rotate_acc32", "blind_rotate_bnf2_acc32")
    require_launched("round-tripped key", {k: after[k] - before[k]
                                           for k in after})
    if not torch.equal(got.ct, want):
        raise AssertionError("the deserialized 2_2 key's output differs "
                             "from phase 2's")
    step_ms = cuda_ms(lambda: sk_rt.apply_lookup_table(ct, lut), 5)
    rt_rate = BATCH / step_ms * 1e3
    print(f"round-tripped key: {BATCH} ciphertexts torch.equal to phase 2's;"
          f" KS->PBS {step_ms:.3f} ms = {rt_rate:.1f} PBS/s (phase 2: "
          f"{summary['pbs_per_s']:.1f}, {rt_rate / summary['pbs_per_s'] - 1:+.2%})"
          f" on {card}")
    out.update(platform_sk_mb=mb, platform_serialize_ms=ser_ms,
               platform_deserialize_ms=de_ms, platform_rt_pbs_per_s=rt_rate)
    del blob

    steps = {"a": time.perf_counter() - t_phase}

    # b. thin client (CPU) -> server (the card) -> client
    t = time.perf_counter()
    cck = ser.deserialize(client.serialize_client_key(ck22),
                          expected_type="ShortintClientKey", device="cpu")
    rng = np.random.default_rng(SEED + 19)
    xs = rng.integers(0, 1 << bits, CLIENT_LANES, dtype=np.uint64)
    ys = rng.integers(0, 1 << bits, CLIENT_LANES, dtype=np.uint64)
    ca = client.encrypt_radix(cck, xs, U64_BLOCKS)
    cb = client.encrypt_radix(cck, ys, U64_BLOCKS)
    enc_s = time.perf_counter() - t
    fck = radix.ClientKey.generate(p, seed=SEED)  # on the card
    for c, v in ((ca, xs), (cb, ys)):
        full = to_u64(fck.encrypt_radix(v, U64_BLOCKS).ct)
        if not (isinstance(c.ct, np.ndarray) and np.array_equal(c.ct, full)):
            raise AssertionError("thin-client ciphertexts differ from the "
                                 "full stack's on the card")
    blobs = [client.serialize_radix(c) for c in (ca, cb)]
    key = CountingKey(sk_rt)
    hl.set_server_key(hl.ServerKey(radix.ServerKey(key)))
    try:
        (a, b), load_ms = host(lambda: [hl.safe_deserialize(x)
                                        for x in blobs])
        if (not isinstance(a, uint)
                or a.ct.ct.device.type != torch.device(DEVICE).type):
            raise AssertionError(f"loaded {type(a).__name__} on "
                                 f"{a.ct.ct.device}")
        key.rounds = 0
        total, add_ms = host(lambda: a + b)
        rounds = key.rounds
        answer = hl.safe_serialize(total)
    finally:
        hl.unset_server_key()
    back = ser.deserialize(answer, expected_type="RadixCiphertext",
                           device="cpu")
    t = time.perf_counter()
    sums = client.decrypt_radix(cck, back)
    dec_s = time.perf_counter() - t
    want_sums = _int_oracle("add", xs, ys, bits)
    if not np.array_equal(sums, want_sums):
        raise AssertionError(f"thin client: {int((sums != want_sums).sum())}"
                             f" of {CLIENT_LANES} sums wrong")
    print(f"thin client (cpu): {CLIENT_LANES} FheUint{bits} pairs encrypted in "
          f"{enc_s:.2f} s, bit-equal to the full stack's on the card; server "
          f"loaded them in {load_ms:.1f} ms, add {add_ms:.1f} ms ({rounds} "
          f"rounds) on the round-tripped key; {CLIENT_LANES} sums decrypted "
          f"right on the CPU in {dec_s:.2f} s")
    want_rounds = v6b[f"fheuint{bits}_add_latency"]["rounds"]
    if rounds != want_rounds:
        raise AssertionError(f"FheUint{bits} add took {rounds} rounds, "
                             f"phase 13's {want_rounds}")
    out.update(platform_client_encrypt_s=enc_s, platform_client_add_ms=add_ms)
    del sk_rt, key, a, b, total, fck

    steps["b"] = time.perf_counter() - t_phase - sum(steps.values())

    # c. the keycache: a miss, then a hit
    os.makedirs("chiprun_out", exist_ok=True)
    kdir = tempfile.mkdtemp(prefix="keycache_", dir="chiprun_out")
    try:
        with env(TFHE_TPU_KEYCACHE=kdir):
            config = hl.ConfigBuilder().build()
            keycache.clear_memory_cache()
            (ck_m, sk_m), miss_ms = host(hl.generate_keys, config, True)
            keycache.clear_memory_cache()
            (ck_h, sk_h), hit_ms = host(hl.generate_keys, config, True)
            keycache.clear_memory_cache()
        km, kh = sk_m.inner.key, sk_h.inner.key
        pairs = [(f, getattr(km, f), getattr(kh, f))
                 for f in ("ksk", "ksk_i8", "bsk_b")]
        pairs.append(("CRT key", km.stored_bsk(), kh.stored_bsk()))
        for f, t_m, t_h in pairs:
            if not torch.equal(t_m, t_h):
                raise AssertionError(f"keycache: the hit's {f} differs")
        del pairs
        hl.set_server_key(sk_h)
        try:
            x, y = (int(v) for v in rng.integers(0, 1 << (bits - 1), 2))
            s = uint.encrypt(x, ck_h) + uint.encrypt(y, ck_h)
            if s.decrypt(ck_m) != (x + y) % (1 << bits):
                raise AssertionError("keycache: the hit's add decrypts wrong")
        finally:
            hl.unset_server_key()
        print(f"keycache ({config.parameters.name}, seed 0): miss (keygen "
              f"+ write) "
              f"{miss_ms / 1e3:.2f} s, hit (load) {hit_ms / 1e3:.2f} s; the "
              f"keys' tensors equal; FheUint{bits} add on the hit right")
        out.update(platform_keycache_miss_s=miss_ms / 1e3,
                   platform_keycache_hit_s=hit_ms / 1e3)
    finally:
        shutil.rmtree(kdir, ignore_errors=True)
    del ck_m, sk_m, ck_h, sk_h, km, kh
    torch.cuda.empty_cache()

    steps["c"] = time.perf_counter() - t_phase - sum(steps.values())

    # d. the trace counters against phase 13's wrapper
    ick, isk = radix.ClientKey(ck22), radix.ServerKey(sk22)
    xs1 = rng.integers(0, 1 << bits, 1, dtype=np.uint64)
    ys1 = rng.integers(1, 1 << bits, 1, dtype=np.uint64)
    a1, b1 = (ick.encrypt_radix(v, U64_BLOCKS) for v in (xs1, ys1))
    trace.reset_pbs_count()
    with trace.span("fheuint64_ops") as outer:
        for op in MB_INT_OPS:
            with trace.span(op) as sp:
                res = getattr(isk, op)(a1, b1)
            expect_radix(ick, isk, f"traced FheUint{bits} {op}", res,
                         _int_oracle(op, xs1, ys1, bits))
            want_pbs = v6b[f"fheuint{bits}_{op}_latency"]["pbs"]
            if (sp.pbs, sp.ks) != (want_pbs, want_pbs):
                raise AssertionError(f"trace {op}: {sp.pbs} PBS, {sp.ks} KS;"
                                     f" phase 13 counted {want_pbs}")
    if (outer.pbs, trace.get_ks_count()) != (
            sum(c.pbs for c in outer.children),) * 2:
        raise AssertionError(f"nested spans: {outer.report()}")
    print("trace spans == phase 13's counts:\n" + outer.report())

    steps["d"] = time.perf_counter() - t_phase - sum(steps.values())

    # e. R1's first split: one batch-1 FheUint64 add a key, profiled
    keys = [("v6b", ("K2", "K1"), ck22, sk22)]
    if g4_keys is not None:
        keys.append(("g4", ("K2", "K5a", "K5b"), *g4_keys))
    for label, need, ck_, sk_ in keys:
        key = CountingKey(sk_)
        ick_, isk_ = radix.ClientKey(ck_), radix.ServerKey(key)
        a_, b_ = (ick_.encrypt_radix(v, U64_BLOCKS) for v in (xs1, ys1))
        isk_.add(a_, b_)  # warm
        plain_ms = statistics.median(host(isk_.add, a_, b_)[1]
                                     for _ in range(3))
        log_dir = os.path.join("chiprun_out", f"r1_trace_{label}")
        key.rounds = 0
        with trace.profile(log_dir) as prof:
            with trace.span(f"fheuint64_add_{label}") as sp:
                res = isk_.add(a_, b_)
                torch.cuda.synchronize()
        rounds = key.rounds
        expect_radix(ick_, isk_, f"profiled FheUint{bits} add ({label})",
                     res, _int_oracle("add", xs1, ys1, bits))
        split = r1_split(prof.events(), sp.name, rounds, need)
        print(json.dumps({"metric": f"r1_split_fheuint{bits}_add_{label}",
                          "card": card, "plain_ms": plain_ms,
                          "profiled_wall_ms": sp.seconds * 1e3,
                          "profiler_overhead": sp.seconds * 1e3 / plain_ms
                          - 1, **split}))
        out[f"platform_r1_{label}"] = split["ms_a_round"]
    del ick_, isk_, key

    steps["e"] = time.perf_counter() - t_phase - sum(steps.values())

    # f. the golden vectors on the card (K2 u64 -> K3 at N = 256)
    if not tv.check(device=DEVICE):
        raise AssertionError("the golden test vectors do not reproduce on "
                             "the card")
    tck, tsk = tv.keys(DEVICE)
    vec = tv.vectors(tck, tsk)
    tp = tck.params
    msm = from_u64(vec["lwe_ms"][None, :-1], DEVICE)
    msb = from_u64(vec["lwe_ms"][-1:], DEVICE)
    for tag, f in tv.luts(tp.message_modulus * tp.carry_modulus):
        tlut = tsk.generate_lookup_table(f).acc
        check_equal("body_rotate_u64", pk.body_rotate_u64,
                    pk.body_rotate_u64_plain, (tlut, msb))
        acc = pk.body_rotate_u64(tlut, msb)
        check_equal("blind_rotate_crt", pk.blind_rotate_crt,
                    pk.blind_rotate_crt_plain,
                    (acc, msm, tsk.crt_key(), tp.pbs_base_log, tp.pbs_level))
    print(f"golden vectors: all of checksums.json reproduce on {card}; K2 "
          f"u64 and K3 (P={tsk.crt_key().shape[2]}, N={tp.polynomial_size}) "
          f"== plain on both LUTs")
    launches = launches_of(*names)
    print(f"phase 19 launches (with the plain checks' kernel runs): "
          f"{ {k: v for k, v in launches.items() if v} }")
    steps["f"] = time.perf_counter() - t_phase - sum(steps.values())
    out["platform_launches"] = launches
    out["platform_s"] = time.perf_counter() - t_phase
    print(f"phase 19: {out['platform_s']:.1f} s (steps a-f, s: "
          f"{ {k: round(v, 1) for k, v in steps.items()} })")
    return out


SQUASH_PARAMS = "NOISE_SQUASHING_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128"
SQUASH_COMP_PARAMS = ("NOISE_SQUASHING_COMP_PARAM_MESSAGE_2_CARRY_2_KS_PBS_"
                      "TUNIFORM_2M128")
SQUASH_BATCH = 64  # phase 20's shortint batch: one packed GLWE of 128
SQUASH_TERMS = 5  # fresh encryptions summed by unchecked_add a value
SQUASH_PROFILE_STEPS = 8  # rotation steps a profiled window
SQUASH_CHECK_STEPS = 16  # rotation steps held card == CPU
SQUASH_CHECK_CTS = 4  # ciphertexts of that rotation
SQUASH_DECOMP_VALUES = 1 << 20  # u128 values decomposed on both devices
SQUASH_RECON_VALUES = 1 << 18  # residue vectors reconstructed on both
SQUASH_MAX_ERR_LOG2 = 72  # phase errors must stay below 2^72
SQUASH_HL_U64 = 0xFEDC_BA98_7654_3210  # the squashed FheUint64
SQUASH_HL_U8 = (200, 55)  # the two FheUint8 of the squashed list


def squash_step_split(nsk, hi, lo, mask, body, steps: int) -> dict:
    """``torch.profiler`` around ``steps`` rotation steps of the u128 PBS
    (the key's first ``steps`` GGSWs) after the same steps once unprofiled
    inside the trace (the profiler misses the kernels of its first
    milliseconds): ``r1_split`` of the second run, its device events
    counted a step."""
    import torch

    from tfhe_tpu_torch.core import squash as sq
    from tfhe_tpu_torch.ops import ntt as ntt_mod

    plan = ntt_mod.get_plan(hi.shape[-1], nsk.num_primes)
    key = nsk.bsk_res[:, :steps]
    m = mask[..., :steps]

    def run():
        return sq.blind_rotate128(hi, lo, m, body, key, nsk.base_log,
                                  nsk.levels, plan)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
        with torch.profiler.record_function("squash_steps"):
            run()
            torch.cuda.synchronize()
    split = r1_split(prof.events(), "squash_steps", steps)
    split["launches_a_step"] = sum(split["events"].values()) / steps
    if not split["launches_a_step"]:
        raise AssertionError("the profiler recorded no device event of the "
                             "u128 rotation steps")
    return split


def squash_values(rng, batch: int, mod_sup: int) -> tuple:
    """``batch`` message-and-carry values covering 0 .. mod_sup-1 and their
    SQUASH_TERMS message digits (each < 4) that sum to them."""
    vals = np.arange(batch) % mod_sup
    rng.shuffle(vals)
    digits = np.zeros((SQUASH_TERMS, batch), dtype=np.uint64)
    rest = vals.copy()
    for t in range(SQUASH_TERMS):
        digits[t] = np.minimum(rest, 3)
        rest = rest - digits[t].astype(rest.dtype)
    assert not rest.any()
    return vals, digits


def phase_noise_squashing(ck22, sk22, card):
    """The u128 noise squashing (ROADMAP Queue A item 7) at the reference's
    2_2 squash sets, full width, on phase 2's keys (torch ops on the card:
    ``tfhe_tpu`` runs it in XLA, no Pallas kernel):
    a. ``NoiseSquashingPrivateKey``, ``NoiseSquashingKey`` (6 primes, n =
       866 steps, base 2^24 x 3), the compression private key and
       ``NoiseSquashingCompressionKey`` (8 primes, N_c = 1024, k_c = 6) from
       phase 2's keygen stream: seconds, MB;
    b. SQUASH_BATCH values covering all 16 message-and-carry values (sums
       of SQUASH_TERMS fresh encryptions by ``unchecked_add``) squashed: ms,
       ms a step, device launches and ms a step (``torch.profiler``, a
       window of SQUASH_PROFILE_STEPS steps); every value decrypts under the
       squash private key, the largest phase error below 2^72;
    c. the card ``torch.equal`` to the CPU: ``decompose128`` at (24, 3) and
       (61, 1) on SQUASH_DECOMP_VALUES random u128 values with edge values,
       ``_reconstruct128`` at 6 and 8 primes on random residues,
       ``blind_rotate128``'s first SQUASH_CHECK_STEPS steps on
       SQUASH_CHECK_CTS of the batch;
    d. the batch compressed into one list (one GLWE): ms; all of it unpacked
       and decrypted under the compression private key;
    e. the squashed batch through ``serialize_squashed_ciphertext`` and back
       onto the card: ``torch.equal``, decrypted; MB, ms;
    f. the HLAPI: ``generate_keys`` on phase 2's parameters with both squash
       sets (s), a FheUint64 through ``squash_noise`` (ms), two FheUint8
       into a ``CompressedSquashedNoiseCiphertextList``, each
       ``get(i).decrypt_with_compression_key`` right."""
    import torch

    from tfhe_tpu_torch._torus import from_u64
    from tfhe_tpu_torch.core import squash as sq
    from tfhe_tpu_torch.high_level_api import api as hl
    from tfhe_tpu_torch.ops import ntt as ntt_mod
    from tfhe_tpu_torch.ops import server as server_ops
    from tfhe_tpu_torch.shortint import noise_squashing as ns
    from tfhe_tpu_torch.shortint import noise_squashing_compression as nsc
    from tfhe_tpu_torch.utils import serialization as ser
    from tfhe_tpu_torch.utils.params import PARAMS_BY_NAME

    t_phase = time.perf_counter()
    out = {}
    sp, cp = PARAMS_BY_NAME[SQUASH_PARAMS], PARAMS_BY_NAME[SQUASH_COMP_PARAMS]
    p = sk22.params
    mod_sup = p.message_modulus * p.carry_modulus
    rng = np.random.default_rng(SEED + 20)

    # a. the keys
    priv, s_priv = host_s(lambda: ns.NoiseSquashingPrivateKey.generate(
        ck22, sp))
    nsk, s_bsk = host_s(lambda: ns.NoiseSquashingKey.generate(ck22, priv))
    cpriv, s_cpriv = host_s(
        lambda: nsc.NoiseSquashingCompressionPrivateKey.generate(ck22, cp))
    ckey, s_ckey = host_s(lambda: nsc.NoiseSquashingCompressionKey.generate(
        ck22, priv, cpriv))
    bsk_mb = nsk.bsk_res.numel() * nsk.bsk_res.element_size() / 1e6
    pksk_mb = ckey.pksk_hat.numel() * ckey.pksk_hat.element_size() / 1e6
    print(f"squash keys ({SQUASH_PARAMS}, {SQUASH_COMP_PARAMS}): private "
          f"{s_priv:.2f} s, BSK {s_bsk:.2f} s ({bsk_mb:.1f} MB, "
          f"{tuple(nsk.bsk_res.shape)}, P={nsk.num_primes}), compression "
          f"private {s_cpriv:.2f} s, packing key {s_ckey:.2f} s "
          f"({pksk_mb:.1f} MB, {tuple(ckey.pksk_hat.shape)}, "
          f"P={ckey.num_primes}) on {card}")
    if nsk.bsk_res.device.type != torch.device(DEVICE).type:
        raise AssertionError(f"squash key on {nsk.bsk_res.device}")
    out.update(squash_keygen_s=s_bsk, squash_comp_keygen_s=s_ckey,
               squash_bsk_mb=bsk_mb, squash_pksk_mb=pksk_mb)
    steps = {"a": time.perf_counter() - t_phase}

    # b. a shortint batch squashed
    vals, digits = squash_values(rng, SQUASH_BATCH, mod_sup)
    ct = ck22.encrypt(digits[0])
    for d in digits[1:]:
        ct = sk22.unchecked_add(ct, ck22.encrypt(d))
    nsk.squash_ciphertext_noise(sk22, ct)  # warm
    squashed, s_squash = host_s(lambda: nsk.squash_ciphertext_noise(sk22,
                                                                    ct))
    n_steps = nsk.bsk_res.shape[1]
    got = priv.decrypt(squashed)
    if got != [int(v) for v in vals]:
        bad = sum(int(g != v) for g, v in zip(got, vals))
        raise AssertionError(f"squash: {bad} of {SQUASH_BATCH} values "
                             f"decrypt wrong")
    delta = (1 << 127) // mod_sup
    errs = []
    for raw, v in zip(priv.decrypt_raw(squashed), vals):
        e = (raw - int(v) * delta) & ((1 << 128) - 1)
        errs.append(abs(e - (1 << 128) if e >> 127 else e))
    err_log2 = math.log2(max(max(errs), 1))
    if not err_log2 < SQUASH_MAX_ERR_LOG2:
        raise AssertionError(f"squash: largest phase error 2^{err_log2:.2f}")
    small = sk22.ks_only(ct.ct)
    ms_mask, ms_body = server_ops.lwe_centered_binary_modulus_switch(
        small, sp.polynomial_size.bit_length())
    lut_hi, lut_lo = nsk.identity_lut()
    shape = (SQUASH_BATCH,) + tuple(lut_hi.shape)
    split = squash_step_split(nsk, lut_hi.expand(shape), lut_lo.expand(shape),
                              ms_mask, ms_body, SQUASH_PROFILE_STEPS)
    ms = s_squash * 1e3
    row = {"metric": "squash_shortint", "batch": SQUASH_BATCH, "ms": ms,
           "ms_a_step": ms / n_steps, "steps": n_steps,
           "launches_a_step": split["launches_a_step"],
           "device_ms_a_step": split["device_busy_ms"] / SQUASH_PROFILE_STEPS,
           "profiled_wall_ms_a_step": split["wall_ms"] / SQUASH_PROFILE_STEPS,
           "events": split["events"], "max_err_log2": err_log2, "card": card}
    print(json.dumps(row))
    print(f"squash: {SQUASH_BATCH} values (all {mod_sup} message+carry) "
          f"decrypt right; largest phase error 2^{err_log2:.2f} (< "
          f"2^{SQUASH_MAX_ERR_LOG2})")
    out.update(squash_ms=ms, squash_ms_a_step=ms / n_steps,
               squash_launches_a_step=split["launches_a_step"],
               squash_max_err_log2=err_log2)
    steps["b"] = time.perf_counter() - t_phase - sum(steps.values())

    # c. the card against the CPU
    def same(label, fn, *args):
        dev = fn(*args)
        host = fn(*(a.cpu() if isinstance(a, torch.Tensor) else a
                    for a in args))
        dev = dev if isinstance(dev, tuple) else (dev,)
        host = host if isinstance(host, tuple) else (host,)
        if not all(torch.equal(d.cpu(), h) for d, h in zip(dev, host)):
            raise AssertionError(f"{label}: the card differs from the CPU")

    hi = rng.integers(0, 1 << 64, SQUASH_DECOMP_VALUES, dtype=np.uint64)
    lo = rng.integers(0, 1 << 64, SQUASH_DECOMP_VALUES, dtype=np.uint64)
    edges = np.array([0, (1 << 64) - 1, 1 << 63, (1 << 63) - 1, 1],
                     dtype=np.uint64)
    hi[:25] = np.repeat(edges, 5)
    lo[:25] = np.tile(edges, 5)
    hi_d, lo_d = from_u64(hi, DEVICE), from_u64(lo, DEVICE)
    for bl, lv in ((24, 3), (61, 1)):
        same(f"decompose128({bl}, {lv})", sq.decompose128, hi_d, lo_d, bl, lv)
    for P in (6, 8):
        plan = ntt_mod.get_plan(2048, P)
        res = np.stack([rng.integers(0, q, SQUASH_RECON_VALUES,
                                     dtype=np.uint64) for q in plan.primes])
        res[:, 0], res[:, 1] = 0, np.array(plan.primes) - 1
        same(f"_reconstruct128(P={P})", functools.partial(
            sq._reconstruct128, plan), from_u64(res, DEVICE))
    c = SQUASH_CHECK_CTS
    same(f"blind_rotate128 ({SQUASH_CHECK_STEPS} steps, {c} ciphertexts)",
         functools.partial(sq.blind_rotate128, base_log=nsk.base_log,
                           levels=nsk.levels, plan=ntt_mod.get_plan(
                               sp.polynomial_size, nsk.num_primes)),
         lut_hi.expand(shape)[:c], lut_lo.expand(shape)[:c],
         ms_mask[:c, :SQUASH_CHECK_STEPS], ms_body[:c],
         nsk.bsk_res[:, :SQUASH_CHECK_STEPS])
    print(f"card == CPU: decompose128 (24, 3) and (61, 1) on "
          f"{SQUASH_DECOMP_VALUES} values, _reconstruct128 P = 6 and 8 on "
          f"{SQUASH_RECON_VALUES}, blind_rotate128 {SQUASH_CHECK_STEPS} steps "
          f"x {c} ciphertexts")
    steps["c"] = time.perf_counter() - t_phase - sum(steps.values())

    # d. the batch compressed into one list
    nsc.compress_noise_squashed_ciphertexts_into_list(ckey, [squashed])
    packed, s_comp = host_s(
        lambda: nsc.compress_noise_squashed_ciphertexts_into_list(
            ckey, [squashed]))
    unpacked = [cpriv.decrypt(packed.unpack(i))[0] for i in range(len(packed))]
    if unpacked != [int(v) for v in vals]:
        bad = sum(int(g != v) for g, v in zip(unpacked, vals))
        raise AssertionError(f"squashed list: {bad} of {len(packed)} values "
                             f"unpack wrong")
    print(json.dumps({"metric": "squash_compress", "count": len(packed),
                      "glwes": packed.glwe_hi.shape[0], "ms": s_comp * 1e3,
                      "card": card}))
    out["squash_compress_ms"] = s_comp * 1e3
    steps["d"] = time.perf_counter() - t_phase - sum(steps.values())

    # e. the squashed envelope
    blob, s_ser = host_s(lambda: ser.serialize_squashed_ciphertext(squashed))
    back, s_de = host_s(lambda: ser.deserialize(
        blob, expected_type="SquashedNoiseCiphertext"))
    if not (torch.equal(back.hi, squashed.hi)
            and torch.equal(back.lo, squashed.lo)
            and back.hi.device.type == torch.device(DEVICE).type):
        raise AssertionError("the round-tripped squashed ciphertext differs")
    if priv.decrypt(back) != got:
        raise AssertionError("the round-tripped squashed ciphertext "
                             "decrypts wrong")
    print(f"squashed envelope: {len(blob) / 1e6:.2f} MB, serialize "
          f"{s_ser * 1e3:.1f} ms, load onto the card {s_de * 1e3:.1f} ms, "
          f"torch.equal and decrypted")
    del nsk, ckey, squashed, packed, back, blob
    torch.cuda.empty_cache()
    steps["e"] = time.perf_counter() - t_phase - sum(steps.values())

    # f. the HLAPI
    config = (hl.ConfigBuilder().use_custom_parameters(p).with_seed(SEED)
              .enable_noise_squashing(sp)
              .enable_noise_squashing_compression(cp).build())
    (ck, sk), s_keys = host_s(lambda: hl.generate_keys(config))
    hl.set_server_key(sk)
    try:
        x = hl.FheUint64.encrypt(SQUASH_HL_U64, ck)
        s64, s_u64 = host_s(x.squash_noise)
        if s64.decrypt(ck) != SQUASH_HL_U64:
            raise AssertionError("the squashed FheUint64 decrypts wrong")
        items = [hl.FheUint8.encrypt(v, ck).squash_noise()
                 for v in SQUASH_HL_U8]
        builder = hl.CompressedSquashedNoiseCiphertextList.builder()
        for it in items:
            builder.push(it)
        lst = builder.build()
        got8 = [lst.get(i).decrypt_with_compression_key(ck)
                for i in range(len(lst))]
        if got8 != list(SQUASH_HL_U8):
            raise AssertionError(f"the squashed list decrypts to {got8}")
    finally:
        hl.unset_server_key()
    print(json.dumps({"metric": "squash_fheuint64", "ms": s_u64 * 1e3,
                      "blocks": s64.squashed.hi.shape[0],
                      "hl_keygen_s": s_keys, "card": card}))
    print(f"HLAPI: generate_keys with both squash sets {s_keys:.1f} s; "
          f"FheUint64 squash_noise {s_u64 * 1e3:.1f} ms, decrypted right; "
          f"FheUint8 {SQUASH_HL_U8} through a CompressedSquashedNoise"
          f"CiphertextList right")
    out.update(squash_hl_keygen_s=s_keys, squash_fheuint64_ms=s_u64 * 1e3)
    del ck, sk, x, s64, items, lst
    torch.cuda.empty_cache()
    steps["f"] = time.perf_counter() - t_phase - sum(steps.values())
    out["noise_squashing_s"] = time.perf_counter() - t_phase
    print(f"phase 20: {out['noise_squashing_s']:.1f} s (steps a-f, s: "
          f"{ {k: round(v, 1) for k, v in steps.items()} })")
    return out


#: phase 21: the reference's NTT64 PBS doc recipe (ntt64_pbs.rs:31-176)
NTT64_N, NTT64_K, NTT64_POLY, NTT64_BASE_LOG, NTT64_LEVELS = 742, 1, 2048, 23, 1
NTT64_MM = 16  # 4-bit messages
NTT64_LWE_STD = 0.000007069849454709433  # relative to q, as the doc gives
NTT64_GLWE_STD = 0.00000000000000029403601535432533
NTT64_PLAIN_CTS = 8  # K6 against cmux_steps_q on the card, on 8 ciphertexts
#: ... over the first 400 steps: the plain version is launch-bound (≈ 1,100
#: torch kernels a step, 20.4 s for all 742 steps on an H100), so fewer
#: ciphertexts would not shorten it, and it is held to about 15 s
NTT64_PLAIN_STEPS = 400
NTT64_SWITCH_VALUES = 1 << 16  # random values of the modulus-switch check


def phase_ntt64(card, rate, rows):
    """The prime-modulus NTT64 PBS (ROADMAP Queue A item 8, second half;
    ``ops/ntt64_pbs.py`` on K6) at the reference's doc recipe, full width:
    n = 742, k = 1, N = 2048, b = 23, l = 1, q = 2^64 - 2^32 + 1, 4-bit
    messages, f(x) = 2x.
    a. the key from numpy's generator at SEED on the card: MB, keygen s;
    b. the 16 messages through ``pbs_ntt64`` with the launch counts zeroed
       just before and read just after (K6 once, every other kernel
       never), each decrypted to 2m (mod 2 * 16, the padding bit's space);
    c. a batch of 2048 (all 16 messages): decrypted, PBS/s (median of 5),
       K6 alone (median of 5 CUDA-event timings);
    d. K6 ``torch.equal`` to its plain version ``cmux_steps_q`` on the card,
       on the batch's first NTT64_PLAIN_CTS ciphertexts over the key's first
       NTT64_PLAIN_STEPS steps (the plain version's time is its comparison
       run);
    e. the card's modulus switch equal to a Python-int switch on
       NTT64_SWITCH_VALUES random values and the edges 0, 1, q//2, q//2 + 1,
       q - 1."""
    import torch

    from tfhe_tpu_torch._torus import from_u64, to_u64
    from tfhe_tpu_torch.ops import kernel_bench as kb
    from tfhe_tpu_torch.ops import ntt64_pbs as pn
    from tfhe_tpu_torch.ops import pbs_kernel as pk

    t_phase = time.perf_counter()
    Q = pn.Q
    n, k, N = NTT64_N, NTT64_K, NTT64_POLY
    bl, lv, R = NTT64_BASE_LOG, NTT64_LEVELS, NTT64_K + 1
    delta = (1 << 63) // NTT64_MM
    rng = np.random.default_rng(SEED)
    lwe_sk = rng.integers(0, 2, size=n).astype(np.uint8)
    glwe_sk = rng.integers(0, 2, size=(k, N)).astype(np.uint8)
    t0 = time.perf_counter()
    bsk_hat = pn.bootstrap_key_to_ntt64(pn.gen_bootstrap_key_ntt64(
        lwe_sk, glwe_sk, bl, lv, NTT64_GLWE_STD * Q, rng, device=DEVICE))
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    key_mb = bsk_hat.numel() * bsk_hat.element_size() / 1e6
    print(f"NTT64 key: {tuple(bsk_hat.shape)}, {key_mb:.1f} MB, keygen "
          f"{keygen_s:.2f} s")
    lut = pn.generate_lut_q(N, R, NTT64_MM, delta, lambda x: 2 * x)
    big_sk = glwe_sk.reshape(-1)

    def check_decrypts(label, out, msgs):
        dec = to_u64(pn.decode_q(pn.lwe_decrypt_q(big_sk, out), delta))
        signed = np.array([int(v) - Q if int(v) > Q // 2 else int(v)
                           for v in dec])
        want = (2 * msgs.astype(np.int64)) % (2 * NTT64_MM)
        bad = int((signed % (2 * NTT64_MM) != want).sum())
        if bad or tuple(out.shape) != (len(msgs), k * N + 1):
            raise AssertionError(f"NTT64 {label}: {bad} of {len(msgs)} "
                                 f"decrypt wrong, shape {tuple(out.shape)}")

    # b. the doc example's 16 messages through the entry point
    msgs = np.arange(NTT64_MM, dtype=np.uint64)
    cts = pn.lwe_encrypt_q(lwe_sk, (msgs * np.uint64(delta)) % np.uint64(Q),
                           NTT64_LWE_STD * Q, rng, device=DEVICE)
    pk.reset_launches()
    out = pn.pbs_ntt64(cts, lut, bsk_hat, bl, lv)
    torch.cuda.synchronize()
    launches = launches_of("blind_rotate_ntt64")
    others = {f.__name__: f.launches for f in pk.KERNELS
              if f is not pk.blind_rotate_ntt64 and f.launches}
    require_launched("NTT64 PBS main path", launches)
    if launches["blind_rotate_ntt64"] != 1 or others:
        raise AssertionError(f"NTT64 PBS: launches {launches}, {others}")
    check_decrypts("doc example", out, msgs)
    print(f"NTT64 doc example: {NTT64_MM} messages through f(x) = 2x "
          "decrypt to 2m (K6 once, no other kernel)")

    # c. a batch of 2048
    bmsgs = np.arange(BATCH, dtype=np.uint64) % NTT64_MM
    bcts = pn.lwe_encrypt_q(lwe_sk, (bmsgs * np.uint64(delta)) % np.uint64(Q),
                            NTT64_LWE_STD * Q, rng, device=DEVICE)
    check_decrypts(f"batch of {BATCH}", pn.pbs_ntt64(bcts, lut, bsk_hat, bl,
                                                     lv), bmsgs)
    pbs_ms = cuda_ms(lambda: pn.pbs_ntt64(bcts, lut, bsk_hat, bl, lv), 5)
    mask_sw = pn.modulus_switch_nonnative(bcts[:, :-1], N)
    body_sw = pn.modulus_switch_nonnative(bcts[:, -1], N)
    lut_t = from_u64(lut, DEVICE)
    acc = pn.monomial_div_q(lut_t[None].expand(BATCH, R, N),
                            body_sw[:, None]).contiguous()
    k6_ms = cuda_ms(lambda: pk.blind_rotate_ntt64(acc, mask_sw, bsk_hat, bl,
                                                  lv), 5)
    print(f"NTT64 PBS B={BATCH}: {pbs_ms:.3f} ms = "
          f"{BATCH / pbs_ms * 1e3:.1f} PBS/s on {card}; K6 {k6_ms:.3f} ms "
          f"({100 * k6_ms / pbs_ms:.1f} %)")

    # d. K6 against its plain version on the card
    b, steps = NTT64_PLAIN_CTS, min(NTT64_PLAIN_STEPS, n)
    err, plain_ms = check_equal(
        "blind_rotate_ntt64", pk.blind_rotate_ntt64,
        pk.blind_rotate_ntt64_plain,
        (acc[:b].contiguous(), mask_sw[:b, :steps].contiguous(),
         bsk_hat[:steps].contiguous(), bl, lv))
    print(f"K6 == cmux_steps_q (torch.equal) at B={b}, the first {steps} of "
          f"{n} steps (plain {plain_ms:.1f} ms)")

    # e. the modulus switch, card against Python ints
    vals = np.concatenate([
        rng.integers(0, Q, size=NTT64_SWITCH_VALUES, dtype=np.uint64),
        np.array([0, 1, Q // 2, Q // 2 + 1, Q - 1], dtype=np.uint64)])
    got = to_u64(pn.modulus_switch_nonnative(from_u64(vals, DEVICE), N))
    want = np.array([(int(v) * 2 * N + (Q >> 1)) // Q for v in vals],
                    dtype=np.uint64)
    if not np.array_equal(got, want) or int(got[-1]) != 2 * N:
        raise AssertionError("NTT64 modulus switch: card != Python ints at "
                             f"{int((got != want).sum())} values")
    print(f"NTT64 modulus switch: card == Python ints on "
          f"{len(vals)} values (q - 1 -> 2N)")

    rows["blind_rotate_ntt64"] = dict(
        source="tfhe_tpu_torch/csrc/blind_rotate_ntt64.cu",
        replaces="tfhe_tpu/ops/ntt64_pbs.py:296",
        note="no pallas_call: XLA in tfhe_tpu",
        launches=launches["blind_rotate_ntt64"], max_abs_err=err, ms=k6_ms,
        plain_ms=plain_ms,
        bound=bound(kb.step_pipe_instructions(
            "blind_rotate_ntt64", BATCH, n, R, lv, N, 1),
            step_bytes(BATCH, n, R, lv, N, 1, 8), rate),
        shape=f"NTT64 doc recipe B={BATCH} n={n}",
        plain_shape=f"NTT64 doc recipe B={b}, {steps} of {n} steps")
    del bsk_hat, acc, bcts, cts
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    print(f"phase 21: {secs:.1f} s")
    return {"ntt64_key_mb": key_mb, "ntt64_keygen_s": keygen_s,
            "ntt64_pbs_ms": pbs_ms, "ntt64_pbs_per_s": BATCH / pbs_ms * 1e3,
            "ntt64_k6_ms": k6_ms, "ntt64_plain_ms": plain_ms,
            "ntt64_s": secs}


ZK_VALUES = (0xFEDC_BA98_7654_3210, 1, 0, 0x0123_4567_89AB_CDEF)  # FheUint64
ZK_CRS_K = 128  # messages a bin of the CRS: the 4 values' 128 blocks
ZK_METADATA = b"chip_smoke phase 22"


def phase_zk(ck22, sk22, card):
    """ZK-proven compact lists (ROADMAP Queue A item 9b) at
    ``PARAM_PKE_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128`` (d = 2048,
    t-uniform 17) onto phase 2's 2_2 compute keys, through phase 17's
    casting set:
    a. the HLAPI compact public key and casting key on phase 2's keys, the
       v2 CRS for bins of 128 messages: s, MB;
    b. the thin client (``client.py``, on the CPU with a copy of the
       compact public key) builds a proven list of 4 FheUint64 (128
       blocks, one bin, one proof): encrypt-and-prove s, the proof's bytes;
    c. the server loads the list and the proof from their envelopes onto
       the card: the proofs verified alone (s, host), then
       ``HlCompactCiphertextList.verify_and_expand`` run (s; its launches
       counted), expand and cast ms (the casting keyswitch, then K2 acc32
       and K1 once each, timed apart), all 4 values decrypted;
    d. a tampered body rejected;
    e. the CRS and proof envelopes round-tripped (MB, s);
    f. the native curve (``csrc/bls446.c``) answered the CRS powers, the
       MSMs, the pairing checks and the subgroup checks."""
    from tfhe_tpu_torch import client, integer
    from tfhe_tpu_torch.high_level_api import api
    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.shortint.compact_public_key import CompactPublicKey
    from tfhe_tpu_torch.utils import serialization as ser
    from tfhe_tpu_torch.utils.params import PARAMS_BY_NAME
    from tfhe_tpu_torch.zk import curve as cv
    from tfhe_tpu_torch.zk.proven_list import ProvenCompactCiphertextList

    t_phase = time.perf_counter()
    native0 = dict(cv.NATIVE_CALLS)
    if cv._native_lib() is None:
        raise AssertionError("phase 22: the BLS12-446 library did not build")
    pke = PARAMS_BY_NAME[CPK_PARAMS]
    hck = api.ClientKey(integer.ClientKey(ck22))
    hsk = api.ServerKey(integer.ServerKey(sk22))
    hcpk, cpk_s = host_s(lambda: api.CompactPublicKey.new(
        hck, hsk, pke, PARAMS_BY_NAME[CAST_PARAMS], seed=SEED))
    crs, crs_s = host_s(lambda: client.client_crs(pke, ZK_CRS_K, seed=SEED))
    crs_blob = ser.serialize_zk_crs(crs)
    print(f"ZK: compact public key and casting key {cpk_s:.2f} s; v2 CRS (d "
          f"= {crs.d}, k = {crs.k}, n = {crs.n}: {len(crs.g_list)} G1, "
          f"{len(crs.g_hat_list)} G2) {crs_s:.2f} s, {len(crs_blob) / 1e6:.2f}"
          " MB")

    # b. the thin client, on the CPU
    blocks = api.FheUint64.num_blocks(ck22.params)
    client_pk = CompactPublicKey(mask=hcpk.pk.mask.cpu(),
                                 body=hcpk.pk.body.cpu(), params=pke)
    lst, prove_s = host_s(lambda: client.build_proven_compact_list(
        client_pk, list(ZK_VALUES), blocks, crs, metadata=ZK_METADATA))
    list_blob = client.serialize_compact_list(lst.ct_list)
    proof_blobs = [client.serialize_proof(p) for p in lst.proofs]
    proof_bytes = sum(len(p.to_bytes()) for p in lst.proofs)
    print(f"ZK thin client: {len(ZK_VALUES)} FheUint64 ({blocks * len(ZK_VALUES)}"
          f" blocks, {len(lst.proofs)} bin(s), a proof each) encrypted and "
          f"proven in "
          f"{prove_s:.2f} s; proof {proof_bytes} B ({len(proof_blobs[0])} B "
          f"envelope), list {len(list_blob) / 1e3:.1f} kB")

    # c. the server: envelopes onto the card, verify, expand and cast
    clist = ser.deserialize(list_blob, expected_type="CompactCiphertextList",
                            device=DEVICE)
    proofs = [ser.deserialize(b, expected_type="PkeV2Proof", device=DEVICE)
              for b in proof_blobs]
    entries = [(api.FheUint64, blocks, i * blocks)
               for i in range(len(ZK_VALUES))]
    hl = api.HlCompactCiphertextList(clist, entries, hcpk, proofs,
                                     ZK_METADATA)
    proven = ProvenCompactCiphertextList(ct_list=clist, proofs=proofs,
                                         metadata=ZK_METADATA)
    ok, verify_s = host_s(lambda: proven.verify(crs, hcpk.pk, ZK_METADATA))
    if not ok:
        raise AssertionError("ZK: the server refused the thin client's list")
    api.set_server_key(hsk)
    try:
        pk.reset_launches()
        vals, vexp_s = host_s(lambda: hl.verify_and_expand(
            crs, metadata=ZK_METADATA))
        launches = launches_of("body_rotate_acc32", "blind_rotate_bnf2_acc32")
        require_launched("ZK expand and cast", launches)
        got = [v.decrypt(hck) for v in vals]
        if got != list(ZK_VALUES):
            raise AssertionError(f"ZK: the list decrypts to {got}")
        expand_ms = cuda_ms(hl.expand, 3)
        print(f"ZK server: verify alone {verify_s:.2f} s; verify_and_expand "
              f"{vexp_s:.2f} s (launches {launches}); expand and cast on the "
              f"card {expand_ms:.2f} ms (median of 3, timed apart); all "
              f"{len(ZK_VALUES)} FheUint64 decrypt right")

        # d. a tampered body
        bad = _tampered(clist, 3)
        tampered = api.HlCompactCiphertextList(bad, entries, hcpk, proofs,
                                               ZK_METADATA)
        try:
            tampered.verify_and_expand(crs, metadata=ZK_METADATA)
        except ValueError:
            pass
        else:
            raise AssertionError("ZK: a tampered list was accepted")
        print("ZK: a list with one tampered body is rejected")
    finally:
        api.unset_server_key()

    # e. the envelopes round-tripped
    back, crs_load_s = host_s(lambda: ser.deserialize(
        crs_blob, expected_type="PkeV2Crs", device=DEVICE))
    if ser.serialize_zk_crs(back) != crs_blob:
        raise AssertionError("ZK: the CRS envelope does not round-trip")
    if [ser.serialize_zk_proof(p) for p in proofs] != proof_blobs:
        raise AssertionError("ZK: the proof envelope does not round-trip")
    print(f"ZK envelopes: CRS {len(crs_blob) / 1e6:.2f} MB loaded (every "
          f"point checked) in {crs_load_s:.2f} s and written back "
          f"byte-equal; proof {len(proof_blobs[0])} B round-trips")

    # f. the native curve
    native = {k: cv.NATIVE_CALLS[k] - native0[k] for k in cv.NATIVE_CALLS}
    unused = [k for k in ("fixed_powers", "msm", "pairing_product",
                          "subgroup") if native[k] < 1]
    if unused:
        raise AssertionError(f"ZK: the native curve did not answer {unused}"
                             f": {native}")
    print(f"ZK: the native BLS12-446 curve (csrc/bls446.c) answered {native}")
    secs = time.perf_counter() - t_phase
    print(f"phase 22: {secs:.1f} s")
    print(json.dumps({"metric": "zk_proven_list", "values": len(ZK_VALUES),
                      "blocks": blocks * len(ZK_VALUES), "crs_s": crs_s,
                      "crs_mb": len(crs_blob) / 1e6, "prove_s": prove_s,
                      "proof_bytes": proof_bytes, "verify_s": verify_s,
                      "verify_and_expand_s": vexp_s, "expand_ms": expand_ms, "crs_load_s": crs_load_s,
                      "card": card}))
    return {"zk_crs_s": crs_s, "zk_crs_mb": len(crs_blob) / 1e6,
            "zk_prove_s": prove_s, "zk_proof_bytes": proof_bytes,
            "zk_verify_s": verify_s, "zk_verify_and_expand_s": vexp_s,
            "zk_expand_ms": expand_ms,
            "zk_crs_load_s": crs_load_s, "zk_s": secs}


def _tampered(clist, i: int):
    """A copy of ``clist`` with body ``i`` moved by 2^60."""
    import dataclasses

    bodies = clist.bodies.clone()
    bodies[i] += 1 << 60
    return dataclasses.replace(clist, bodies=bodies)


MESH_ITERS = 3  # the scaling sweep's timed runs a mesh size
C_API_PARAMS = "PARAM_MESSAGE_2_CARRY_2_KS_PBS"  # the C program's keys
C_API_A, C_API_B = 27, 15  # the C program's FheUint8 operands
VALID_HOST_LIMIT_S = 30.0  # valid_params_128 is checked only below this


def phase_mesh_c_api(ck22, sk22, batch22, card, summary, rows):
    """ROADMAP Queue A item 9c on phase 2's 2_2 v6b keys and batch of 2048:
    a. the batch mesh (``parallel/mesh.py``): ``sharded_ks_pbs`` over
       ``make_batch_mesh()`` (every device of the host) and over a two-way
       split on the one card (``["cuda:0", "cuda:0"]``: the split and the
       gather, no scaling claimed), each output ``torch.equal`` to phase
       2's, the launch counts around each call (K2 acc32 and K1 once a
       chunk, K3 never), the split timed (median of 3) beside phase 2's
       step; the ``B % n`` ``ValueError``; ``scaling_sweep`` at
       1 .. the device count (PBS/s beside phase 2's); ``init_distributed``
       with a world of 1 over a ``file://`` store on ``nccl``, an
       all-reduce, then ``destroy_process_group``;
    b. the C API (``tfhe_tpu_torch/c_api``): the library and ``c_api_test``
       built with cc (s); the program run on the GPU at C_API_PARAMS with
       SEED (every check passes, ``c_api_test OK``; its calls' wall ms, an
       op's with the decryption of its result), its
       serialized sum byte-equal to the same keys, encryptions and add
       through the Python HLAPI on the card; then the library loaded into
       this process (``ctypes.PyDLL``) for one encrypt-add-decrypt, the
       launch counts around the add (K2 acc32 and K1), the sum's bytes
       equal again;
    c. the reference-vector twin (``apps/test_vectors_ref.py``): the toy
       set generated on the host, each artifact's SHA-256 equal to the CPU
       run's (``TOY_SHA256``); ``decrypt_contract`` on the card (K2 u64 and
       K3 P = 4 once a LUT, nothing else), K2 u64 and K3 ``torch.equal`` to
       their plain versions on its inputs; ``valid_params_128`` the same
       (digests ``VALID_SHA256``, the contract on the card, K3's plain
       check over the first PLAIN_STEPS of its 833 steps) when its host
       generation took at most VALID_HOST_LIMIT_S, else left out with the
       reason printed.
    Phase 23's launches of K2 acc32, K1, K2 u64 and K3 P = 4 go into their
    kernel rows as ``mesh_c_api_launches``."""
    import ctypes
    import sysconfig
    import tempfile

    import torch
    import torch.distributed as dist

    from tfhe_tpu_torch import _build
    from tfhe_tpu_torch.apps import test_vectors_ref as tvr
    from tfhe_tpu_torch.high_level_api import api
    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.parallel import mesh as pmesh
    from tfhe_tpu_torch.utils import serialization as ser
    from tfhe_tpu_torch.utils.params import PARAMS_BY_NAME

    t_phase = time.perf_counter()
    names = ("body_rotate_acc32", "blind_rotate_bnf2_acc32",
             "body_rotate_u64", "blind_rotate_crt")
    total = dict.fromkeys(names, 0)

    def counted(label, fn, want):
        """:func:`launches_exactly`, its launches added to ``total``."""
        out = launches_exactly(label, fn, want)
        for k in names:
            total[k] += getattr(pk, k).launches
        return out

    ct, lut, want = batch22
    out = {}

    # a. the batch mesh
    n_dev = torch.cuda.device_count()
    for label, mesh in (("mesh of every device", pmesh.make_batch_mesh()),
                        ("two-way split on one card", pmesh.make_batch_mesh(
                            devices=["cuda:0", "cuda:0"]))):
        run = pmesh.sharded_ks_pbs(sk22, mesh)
        n = len(mesh)
        got = counted(f"{label} ({n} chunks of {BATCH // n})",
                      lambda: run(ct.ct, lut.acc),
                      {"body_rotate_acc32": n, "blind_rotate_bnf2_acc32": n})
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: output != phase 2's")
    pk.reset_launches()
    split_ms = cuda_ms(lambda: run(ct.ct, lut.acc), 3, warmup=False)
    for k in names:
        total[k] += getattr(pk, k).launches
    print(f"mesh: {n_dev} device(s) {[str(d) for d in pmesh.make_batch_mesh()]}"
          f" and the two-way split on cuda:0: outputs torch.equal to phase "
          f"2's ({BATCH} ciphertexts); the split {split_ms:.3f} ms (median "
          f"of 3), phase 2's step {1e3 * BATCH / summary['pbs_per_s']:.3f} "
          f"ms")
    try:
        pmesh.sharded_ks_pbs(sk22, pmesh.make_batch_mesh(
            devices=["cuda:0"] * 3))(ct.ct, lut.acc)
    except ValueError as e:
        print(f"mesh: B % 3 refused ({e})")
    else:
        raise AssertionError("mesh: a batch of 2048 split 3 ways ran")
    pk.reset_launches()
    sweep = pmesh.scaling_sweep(sk22, lut.acc, ct.ct,
                                list(range(1, n_dev + 1)), iters=MESH_ITERS)
    for k in names:
        total[k] += getattr(pk, k).launches
    print(f"mesh scaling_sweep (B={BATCH}, {MESH_ITERS} runs): "
          f"{ {n: round(v, 1) for n, v in sweep.items()} } PBS/s; phase 2: "
          f"{summary['pbs_per_s']:.1f} PBS/s on {card}")
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        pmesh.init_distributed(f"file://{td}/store", 1, 0, device=DEVICE)
        try:
            backend = dist.get_backend()
            x = torch.ones(4, device=DEVICE)
            dist.all_reduce(x)
            if (backend != ("nccl" if DEVICE == "cuda" else "gloo")
                    or dist.get_world_size() != 1
                    or not torch.equal(x, torch.ones_like(x))):
                raise AssertionError(f"init_distributed: {backend}, world "
                                     f"of {dist.get_world_size()}")
        finally:
            dist.destroy_process_group()
        dist_s = time.perf_counter() - t0
    print(f"init_distributed: {backend}, world of 1 over a file:// store, "
          f"all-reduce, destroyed: {dist_s:.2f} s")
    out.update(mesh_pbs_per_s=sweep, mesh_split_ms=split_ms,
               mesh_dist_s=dist_s)
    t_mesh = time.perf_counter() - t_phase

    # b. the C API
    build = _build.c_api_build()
    print(f"C API: library and c_api_test built with cc in "
          f"{build['seconds']:.2f} s (the program links "
          f"{sysconfig.get_config_var('LIBDIR')}/libpython"
          f"{sysconfig.get_config_var('LDVERSION')}.so, the library no "
          f"libpython; this interpreter: Py_ENABLE_SHARED="
          f"{sysconfig.get_config_var('Py_ENABLE_SHARED')})")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as td:
        sum_path = os.path.join(td, "sum.bin")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [build["program"], "gpu" if DEVICE == "cuda" else DEVICE,
             C_API_PARAMS, sum_path, str(SEED)],
            capture_output=True, text=True, env=_build.c_api_env(),
            timeout=300)
        prog_s = time.perf_counter() - t0
        if proc.returncode != 0 or "c_api_test OK" not in proc.stdout:
            raise AssertionError(f"c_api_test failed (rc {proc.returncode}):"
                                 f"\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        with open(sum_path, "rb") as f:
            c_sum = f.read()
    op_ms = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^op (\w+) ([0-9.]+) ms$", proc.stderr, re.M)}
    print(f"c_api_test on the GPU at {C_API_PARAMS}, seed {SEED}: "
          f"{proc.stdout.strip()} in {prog_s:.1f} s (process included); "
          f"calls, ms (an op with the decryption of its result): {op_ms}")
    p22 = PARAMS_BY_NAME[C_API_PARAMS]
    hck, hsk = api.generate_keys(api.Config(p22, SEED), device=DEVICE)
    api.set_server_key(hsk)
    try:
        total_ct = (api.FheUint8.encrypt(C_API_A, hck)
                    + api.FheUint8.encrypt(C_API_B, hck))
        py_sum = ser.serialize_radix(total_ct.ct)
    finally:
        api.unset_server_key()
    del hck, hsk, total_ct
    if py_sum != c_sum:
        raise AssertionError(f"c_api_test's sum ({len(c_sum)} B) != the "
                             f"Python HLAPI's ({len(py_sum)} B)")
    print(f"C API: the program's serialized sum ({len(c_sum)} B) is "
          f"byte-equal to the Python HLAPI's on the card")
    lib = _build.c_api_lib()
    # NULL: the GPU, as tfhe_tpu_init()
    if lib.tfhe_tpu_init_on(None if DEVICE == "cuda"
                            else DEVICE.encode()) != 0:
        raise AssertionError(f"in-process tfhe_tpu_init: "
                             f"{lib.tfhe_tpu_last_error().decode()}")
    handles = [ctypes.c_void_p() for _ in range(5)]
    hk, hs, ha, hb, hsum = handles

    def ok(rc, what):
        if rc != 0:
            raise AssertionError(f"in-process {what}: "
                                 f"{lib.tfhe_tpu_last_error().decode()}")

    try:
        ok(lib.tfhe_tpu_generate_keys(C_API_PARAMS.encode(), SEED,
                                      ctypes.byref(hk), ctypes.byref(hs)),
           "generate_keys")
        ok(lib.tfhe_tpu_set_server_key(hs), "set_server_key")
        ok(lib.tfhe_tpu_fheuint_encrypt(8, C_API_A, hk, ctypes.byref(ha)),
           "encrypt")
        ok(lib.tfhe_tpu_fheuint_encrypt(8, C_API_B, hk, ctypes.byref(hb)),
           "encrypt")
        pk.reset_launches()
        t0 = time.perf_counter()
        ok(lib.tfhe_tpu_fheuint_add(ha, hb, ctypes.byref(hsum)), "add")
        torch.cuda.synchronize()
        add_ms = (time.perf_counter() - t0) * 1e3
        inproc = {f.__name__: f.launches for f in pk.KERNELS if f.launches}
        print(f"in-process C add launches: {inproc}")
        if (inproc.keys() != {"body_rotate_acc32", "blind_rotate_bnf2_acc32"}
                or min(inproc.values()) < 1):
            raise AssertionError(f"in-process C add: launches {inproc}")
        for k in names:
            total[k] += inproc.get(k, 0)
        clear = ctypes.c_uint64()
        ok(lib.tfhe_tpu_fheuint_decrypt(hsum, hk, ctypes.byref(clear)),
           "decrypt")
        if clear.value != (C_API_A + C_API_B) % 256:
            raise AssertionError(f"in-process C add decrypts to "
                                 f"{clear.value}")
        buf = ctypes.POINTER(ctypes.c_uint8)()
        size = ctypes.c_size_t()
        ok(lib.tfhe_tpu_fheuint_serialize(hsum, ctypes.byref(buf),
                                          ctypes.byref(size)), "serialize")
        inproc_sum = ctypes.string_at(buf, size.value)
        lib.tfhe_tpu_buffer_destroy(buf, size)
        if inproc_sum != c_sum:
            raise AssertionError("in-process C sum != c_api_test's")
    finally:
        for h in (ha, hb, hsum):
            lib.tfhe_tpu_fheuint_destroy(h)
        lib.tfhe_tpu_client_key_destroy(hk)
        lib.tfhe_tpu_server_key_destroy(hs)
        lib.tfhe_tpu_shutdown()
        api.unset_server_key()
    print(f"C API in this process (ctypes.PyDLL): FheUint8 {C_API_A} + "
          f"{C_API_B} = {clear.value} ({add_ms:.2f} ms, launches "
          f"{inproc}), bytes equal to the program's")
    out.update(c_api_build_s=build["seconds"], c_api_program_s=prog_s, c_api_op_ms=op_ms,
               c_api_inproc_add_ms=add_ms)
    t_c = time.perf_counter() - t_phase - t_mesh

    # c. the reference-vector twin
    gen_s = {}
    for which, p, digests in (("toy", tvr.TOY, tvr.TOY_SHA256),
                              ("valid", tvr.VALID, tvr.VALID_SHA256)):
        files, gen_s[which] = host_s(lambda: tvr.generate(p))
        if gen_s[which] > VALID_HOST_LIMIT_S:
            print(f"reference vectors: {which} left out: its host generation "
                  f"took {gen_s[which]:.1f} s > {VALID_HOST_LIMIT_S:.0f} s")
            continue
        if tvr.digests(files) != digests:
            bad = sorted(k for k, v in tvr.digests(files).items()
                         if v != digests[k])
            raise AssertionError(f"reference vectors ({which}): SHA-256 of "
                                 f"{bad} differ from the CPU run's")
        decoded = counted(f"decrypt_contract ({which})",
                          lambda: tvr.decrypt_contract(files, DEVICE),
                          {"body_rotate_u64": 2, "blind_rotate_crt": 2})
        tp = files["_internal"]["params"]
        inputs = tvr.pbs_inputs(files, DEVICE)
        steps = min(tp["n"], PLAIN_STEPS)
        for tag, tlut in inputs["luts"].items():
            check_equal(f"body_rotate_u64 ref vectors {which} {tag}",
                        pk.body_rotate_u64, pk.body_rotate_u64_plain,
                        (tlut, inputs["body"]))
            acc = pk.body_rotate_u64(tlut, inputs["body"])
            check_equal(f"blind_rotate_crt ref vectors {which} {tag}",
                        pk.blind_rotate_crt, pk.blind_rotate_crt_plain,
                        (acc, inputs["mask"][:, :steps].contiguous(),
                         inputs["key"][:steps], tp["pbs_blog"], tp["pbs_l"]))
        print(f"reference vectors ({which}, n={tp['n']}, N={tp['N']}): "
              f"generated on the host in {gen_s[which]:.2f} s, all 10 "
              f"SHA-256 equal to the CPU run's; decrypt_contract on the "
              f"card {decoded}; K2 u64 and K3 (P={tvr.CONTRACT_PRIMES}) == "
              f"plain on both LUTs (K3 over {steps} of {tp['n']} steps)")
    out["ref_vectors_gen_s"] = gen_s
    t_tv = time.perf_counter() - t_phase - t_mesh - t_c

    for k in names:
        row = "blind_rotate_crt_p4" if k == "blind_rotate_crt" else k
        rows[row]["mesh_c_api_launches"] = total[k]
    out["mesh_c_api_launches"] = total
    out["mesh_c_api_s"] = time.perf_counter() - t_phase
    print(f"phase 23 launches (the plain checks' kernel runs not counted): "
          f"{total}")
    print(f"phase 23: {out['mesh_c_api_s']:.1f} s (mesh {t_mesh:.1f}, C API "
          f"{t_c:.1f}, reference vectors {t_tv:.1f})")
    return out


WIDE_CLASSIC = "PARAM_MESSAGE_3_CARRY_3_KS_PBS_GAUSSIAN_2M128"
WIDE_MULTI_BIT = ("PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_3_CARRY_3_KS_PBS_"
                  "GAUSSIAN_2M128")
WIDE_SPLIT_CLASSIC = "V1_5_PARAM_MESSAGE_4_CARRY_4_KS_PBS_GAUSSIAN_2M40"
WIDE_BATCH = 512  # phase 24's classic 3_3 batch
WIDE_MB_BATCH = 256  # phase 24's group-4 3_3 batch
WIDE_SPLIT_BATCH = 256  # phase 24's classic 4_4 batch: all 256 values
WIDE_PLAIN_CTS = 8  # ciphertexts of phase 24's 3_3 plain checks
WIDE_MB_PLAIN_GROUPS = 16  # group steps of the 3_3 multi-bit plain checks
#: ciphertexts and steps of the classic 4_4 plain checks (of 256, 1096)
WIDE_SPLIT_PLAIN_CTS, WIDE_SPLIT_PLAIN_STEPS = 4, 64
#: the split kernel's multi-bit shapes on random group-4 keys and
#: accumulators: (label, N, levels, base_log); their batch, group steps
#: and the ciphertexts of their plain checks
WIDE_SPLIT_MB = (("mb_n32768_l3", 32768, 3, 10),
                 ("mb_n16384_l3", 16384, 3, 10))
WIDE_SPLIT_MB_B, WIDE_SPLIT_MB_GROUPS, WIDE_SPLIT_MB_PLAIN = 128, 8, 8
#: random keys at shapes that route to the other designs: (label, N,
#: levels, base_log, g): the cluster kernel at N = 16384, K7 global at N =
#: 32768, l = 1 (no set of the universe: the split takes l >= 2)
WIDE_CORNERS = (("classic_n16384", 16384, 2, 15, 0),
                ("classic_n32768_l1", 32768, 1, 22, 0),
                ("multi_bit_n32768_l1", 32768, 1, 22, 4))
WIDE_CORNER_B, WIDE_CORNER_STEPS = 4, 8
#: the sets of the universe at N = 65536, refused on the card (ROADMAP R10)
WIDE_REFUSED = ("V1_5_PARAM_MESSAGE_5_CARRY_3_KS_PBS_GAUSSIAN_2M128",
                "V1_5_PARAM_GPU_MULTI_BIT_GROUP_2_MESSAGE_4_CARRY_4_KS_PBS_"
                "GAUSSIAN_2M128")
#: base_log * levels >= 32 (the kernels' 64-bit decomposer): the classic
#: 4_4 set at 2M64 (n = 1110, N = 32768, b = 11, l = 3) on the split, real
#: keys, its batch (all 256 values), the ciphertexts and steps of its plain
#: checks
WIDE_DEEP_CLASSIC = "V1_5_PARAM_MESSAGE_4_CARRY_4_KS_PBS_GAUSSIAN_2M64"
WIDE_DEEP_BATCH = 256
WIDE_DEEP_PLAIN_CTS, WIDE_DEEP_PLAIN_STEPS = 4, 64
#: tfhe-rs's GPU group-4 4_4 set at 2M128 (n = 1132, N = 32768, b = 8, l =
#: 4) on K5a and K7 global multi-bit: its K5 key (283 group steps, 71.2 GB
#: with its duals) and the u64 key it is transformed from exceed the card,
#: so random group-4 keys at its shape, cut in depth to WIDE_DEEP_MB_GROUPS
#: group steps; the batch (its bundles fit MB_SCRATCH_BYTES in chunks of 4
#: steps) and the ciphertexts of the plain checks
WIDE_DEEP_MB = ("V1_5_PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_4_CARRY_4_KS_PBS_"
                "GAUSSIAN_2M128")
WIDE_DEEP_MB_B, WIDE_DEEP_MB_GROUPS, WIDE_DEEP_MB_PLAIN = 64, 16, 4
#: random keys at the other shapes of the 64-bit decomposer: (label, N,
#: levels, base_log, g): the split at N = 16384, l = 3 (5 classic sets of
#: the universe), the streamed split at N = 32768, b = 9, l = 4 (2 classic
#: sets), the cluster kernel at N = 8192, l = 4, K3 and K5b where acc and
#: digits fit a block (no set of the universe: their lifts' only checks on
#: the card), and the multi-bit split and cluster kernel; then the
#: streamed split's other stores and decomposer: int8 digits at the
#: multi-bit l = 5 (b = 7) and l = 6 (b = 6) shapes, and the hi word's
#: decomposer at a classic l = 4, b = 7 shape (b l = 28; its acc32 entry
#: stays on K7 global)
WIDE_DEEP_CORNERS = (("deep_classic_n16384_l3", 16384, 3, 11, 0),
                     ("deep_classic_n32768_l4", 32768, 4, 9, 0),
                     ("deep_classic_n8192_l4", 8192, 4, 8, 0),
                     ("deep_classic_n2048_l3", 2048, 3, 11, 0),
                     ("deep_multi_bit_n16384_l3", 16384, 3, 11, 4),
                     ("deep_multi_bit_n8192_l4", 8192, 4, 8, 4),
                     ("deep_multi_bit_n1024_l4", 1024, 4, 8, 4),
                     ("stream_multi_bit_n32768_l5", 32768, 5, 7, 4),
                     ("stream_multi_bit_n32768_l6", 32768, 6, 6, 4),
                     ("stream_classic_n32768_l4_b7", 32768, 4, 7, 0))
#: the streamed split on real keys: the 2_6 compact-PK set at 2M64 (n =
#: 1111, k = 1, N = 32768, b = 9, l = 4: the 2 classic sets at N = 32768
#: with 4 levels), its batch (all 256 values), the ciphertexts and steps
#: of its plain checks, and the batch of K7 global's turns beside it
WIDE_STREAM_CLASSIC = ("V1_5_PARAM_MESSAGE_2_CARRY_6_COMPACT_PK_KS_PBS_"
                       "GAUSSIAN_2M64")
WIDE_STREAM_BATCH = 256
WIDE_STREAM_PLAIN_CTS, WIDE_STREAM_PLAIN_STEPS = 4, 64
WIDE_STREAM_GLOBAL_B = 8
WIDE_SOURCE = "tfhe_tpu_torch/csrc/blind_rotate_wide.cu"
#: the universe's classes of PBS parameter sets
WIDE_PBS_KINDS = ("ClassicPBSParameters", "KeySwitch32PBSParameters",
                  "MultiBitPBSParameters")
#: K7's wrappers a design: (classic u64, classic acc32, multi-bit); the
#: split's entries pick the streamed split by shape (pk.split_streams)
WIDE_KERNELS = {"cluster": ("blind_rotate_wide_cluster",
                            "blind_rotate_wide_cluster_acc32",
                            "multi_bit_accumulate_wide_cluster"),
                "split": ("blind_rotate_wide_split",
                          "blind_rotate_wide_split_acc32",
                          "multi_bit_accumulate_wide_split"),
                "global": ("blind_rotate_wide", "blind_rotate_wide_acc32",
                           "multi_bit_accumulate_wide")}


def check_equal_all(name, kernels: dict, plain, args):
    """Each kernel of ``kernels`` ({label: wrapper}) against one run of the
    plain version on the same inputs, exact; returns ({label:
    max_abs_err}, the plain version's ms: its run between CUDA events)."""
    import torch

    got = {k: fn(*args) for k, fn in kernels.items()}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(*args)
    end.record()
    end.synchronize()
    errs = {}
    for k, g in got.items():
        errs[k] = max_abs_err(g, want)
        if tuple(g.shape) != tuple(want.shape) or errs[k] != 0:
            raise AssertionError(f"{name} {k}: kernel != plain version "
                                 f"(max_abs_diff {errs[k]})")
    return errs, start.elapsed_time(end)


def _random_multi_bit_key(N, levels, steps, g, gen):
    """A random K5 key of ``steps`` group steps at group ``g`` (residues of
    each prime with their Shoup duals, ``pk.multi_bit_key_layout``)."""
    import torch

    from tfhe_tpu_torch.ops import ntt as ntt_mod
    from tfhe_tpu_torch.ops import pbs_kernel as pk

    plan = ntt_mod.get_plan(N, 4)
    res = torch.stack([torch.randint(
        0, int(p), (steps, (1 << g) - 1, levels, 2, 2, N), generator=gen,
        device=DEVICE, dtype=torch.int64) for p in plan.primes])
    return pk.multi_bit_key_layout(ntt_mod.with_shoup_duals(res, plan))


#: the kernels of a shape that K3 or K5b hold (``pk.wide_route`` None)
BLOCK_KERNELS = ("blind_rotate_crt", "blind_rotate_crt_acc32",
                 "multi_bit_accumulate")


def _wide_corner(label, N, levels, base_log, g, rng, rate=None, rows=None):
    """K7, K3 or K5b (and at g > 0 K5a and the pair) against the plain
    versions on random keys, accumulators and masks at a corner, no
    keygen: WIDE_CORNER_B ciphertexts, WIDE_CORNER_STEPS (group) steps,
    through the dispatch; the design ``pk.wide_route`` names for the shape
    launched, the others never (the acc32 entry goes where
    ``pk.wide_route`` sends it at 4-byte acc: K7 global where the split
    streams). At base_log * levels >= 32 (the 64-bit decomposer) the acc32
    entry must refuse the shape, and with ``rows`` the launched kernel is
    timed on the same inputs (one run) and gets a row. Returns the launch
    counts of those checks."""
    import torch

    from tfhe_tpu_torch._torus import from_u32, from_u64
    from tfhe_tpu_torch.core import algorithms as algo
    from tfhe_tpu_torch.core.entities import LweBootstrapKey
    from tfhe_tpu_torch.ops import kernel_bench as kb
    from tfhe_tpu_torch.ops import pbs_kernel as pk

    R, P, B, steps = 2, 4, WIDE_CORNER_B, WIDE_CORNER_STEPS
    route = pk.wide_route(P, R, levels, N, 8, base_log)
    streams = route == "split" and pk.split_streams(P, R, levels, N)
    if label.startswith("stream") and not streams:
        raise AssertionError(f"corner {label}: the split does not stream")
    deep = base_log * levels > pk.HI_WORD_MAX_BL
    designs = {**WIDE_KERNELS, None: BLOCK_KERNELS}
    own = designs[route]
    own32 = designs[pk.wide_route(P, R, levels, N, 4, base_log)][1]
    acc = from_u64(rng.integers(0, 1 << 64, size=(B, R, N), dtype=np.uint64),
                   DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + N + g + levels)
    names = [n for d in designs.values() for n in d]
    if not g:
        std = torch.randint(-(1 << 63), (1 << 63) - 1,
                            (steps, levels, R, R, N), generator=gen,
                            device=DEVICE, dtype=torch.int64)
        key = pk.bsk_to_scan_layout(algo.bootstrap_key_to_ntt(
            LweBootstrapKey(std, base_log, levels), P).residues)
        mask = torch.from_numpy(rng.integers(0, 2 * N, size=(B, steps))).to(
            DEVICE)
        hi = from_u32(rng.integers(0, 1 << 32, size=(B, R, N),
                                   dtype=np.uint32), DEVICE)
        args = (acc, mask, key, base_log, levels)
        pk.reset_launches()
        err, plain_ms = check_equal(f"{own[0]} {label}", pk.blind_rotate_crt,
                                    pk.blind_rotate_crt_plain, args)
        if deep:
            try:
                pk.blind_rotate_crt_acc32(hi, mask, key, base_log, levels)
            except ValueError as e:
                print(f"corner {label}: acc32 refused: {e}")
            else:
                raise AssertionError(f"corner {label}: acc32 ran at b l = "
                                     f"{base_log * levels}")
        else:
            check_equal(f"{own32} {label}", pk.blind_rotate_crt_acc32,
                        pk.blind_rotate_crt_acc32_plain,
                        (hi, mask, key, base_log, levels))
        counts = launches_of(*names)
        ran = counts[own[0]] and (deep or counts[own32])
        stray = sum(counts[n] for n in {n for d in designs.values()
                                        for n in d[:2]} - {own[0], own32})
        if rows is not None:
            ms = cuda_ms(lambda: getattr(pk, own[0])(*args), 1, warmup=False)
            bnd = step_bound("blind_rotate_crt", B, steps, R, levels, N, P,
                             8, rate)
    else:
        mbk = _random_multi_bit_key(N, levels, steps, g, gen)
        mask = torch.from_numpy(rng.integers(0, 2 * N, size=(B, steps * g))
                                ).to(DEVICE)
        pk.reset_launches()
        check_equal(f"multi_bit_keybundle {label}", pk.multi_bit_keybundle,
                    pk.multi_bit_keybundle_plain,
                    (mask, mbk, 0, steps, base_log, levels))
        bundles = pk.multi_bit_keybundle_plain(mask, mbk, 0, steps, base_log,
                                               levels)
        args = (acc, bundles, base_log, levels)
        err, plain_ms = check_equal(f"{own[2]} {label}",
                                    pk.multi_bit_accumulate,
                                    pk.multi_bit_accumulate_plain, args)
        check_equal(f"the pair {label}", pk.blind_rotate_multi_bit,
                    pk.blind_rotate_multi_bit_plain,
                    (acc, mask, mbk, base_log, levels))
        counts = launches_of("multi_bit_keybundle", *names)
        ran = counts[own[2]]
        stray = sum(counts[n] for n in {d[2] for d in designs.values()}
                    - {own[2]})
        if rows is not None:
            ms = cuda_ms(lambda: getattr(pk, own[2])(*args), 1, warmup=False)
            bnd = bound(kb.multi_bit_accumulate_pipe_instructions(
                B, steps, R, levels, N, P),
                accumulate_bytes(B, steps, R, levels, N, P), rate)
        del mbk, bundles
    design = (f"K7's {route} design"
              + (", levels streamed" if streams else "")) if route else \
        "K5b" if g else "K3"
    print(f"corner {label} (N = {N}, l = {levels}, b = {base_log}, g = {g}): "
          f"{design}{' and K5a' if g else ''} == plain on {B} random "
          f"ciphertexts over {steps} steps; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if not ran or stray:
        raise AssertionError(f"corner {label}: {design} did not run, or "
                             f"another kernel did: {counts}")
    if rows is not None:
        name = own[2 if g else 0]
        print(f"corner {label}: {name} {ms:.3f} ms (bound {bnd[0]:.3f} ms, "
              f"{bnd[1]}: {bnd[0] / ms:.1%}; plain {plain_ms:.1f} ms)")
        rows[f"{name}_{label}"] = dict(
            source=MB_SOURCE if name == "multi_bit_accumulate" else
            "tfhe_tpu_torch/csrc/blind_rotate_crt.cu"
            if name == "blind_rotate_crt" else WIDE_SOURCE,
            replaces=MB_REPLACES if g else "tfhe_tpu/ops/pbs_kernel.py:1867",
            launches=counts[name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound=bnd,
            shape=f"{label} B={B} {steps} {'group ' if g else ''}steps "
                  f"N={N} l={levels} b={base_log} P={P}, random keys",
            plain_shape=f"B={B}, {steps} steps",
            kernel=f"{design}'s "
                   + ("64-bit decomposer (GarnerTailDeep)" if deep
                      else "hi word's decomposer")
                   + f", {'K5b' if g else 'K3'}'s function; launches: the "
                   "corner's dispatch")
    torch.cuda.empty_cache()
    return counts


def _wide_split_classic(card, rate, rows, summary):
    """Phase 24's classic 4_4 set on the split cluster kernel, real keys
    (see ``phase_wide``, d). Returns K7 global's rows at the set."""
    import torch

    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.shortint.client_key import ClientKey
    from tfhe_tpu_torch.shortint.server_key import ServerKey
    from tfhe_tpu_torch.utils.params import PARAMS_BY_NAME

    p = PARAMS_BY_NAME[WIDE_SPLIT_CLASSIC]
    t0 = time.perf_counter()
    ck = ClientKey.generate(p, seed=SEED)
    sk = ServerKey.generate(ck)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    R, N, lv, bl = p.glwe_size, p.polynomial_size, p.pbs_level, p.pbs_base_log
    key, n, P = sk.bsk_scan, p.lwe_dimension, sk.num_primes
    key_gb = key.numel() * 4 / 1e9
    if sk.variant != "crt" or pk.wide_route(P, R, lv, N) != "split" or \
            pk.wide_route(P, R, lv, N, 4) != "split":
        raise AssertionError(f"4_4: variant {sk.variant}, not on the split "
                             "cluster kernel")
    print(f"keygen 4_4 ({WIDE_SPLIT_CLASSIC}): {keygen_s:.1f} s, n = {n}, "
          f"N = {N}, l = {lv}, b = {bl}, P = {P}, CRT key "
          f"{tuple(key.shape)} ({key_gb:.2f} GB); a CTA of the cluster "
          f"kernel {pk.cluster_smem_formula(P, R, lv, N, 8)} B > "
          f"{pk._SMEM_LIMIT}, of the split "
          f"{pk.cluster_smem_formula(P, R, lv, N, 8, 2)} B")
    mod = p.message_modulus * p.carry_modulus
    f = lambda x: (5 * x + 3) % mod  # noqa: E731
    vals = np.arange(WIDE_SPLIT_BATCH, dtype=np.uint64) % mod
    want = np.array([f(int(v)) for v in vals], dtype=np.uint64)
    ct = ck.encrypt(vals)
    lut = sk.generate_lookup_table(f)
    out, step_ms = launches_exactly("4_4 main path",
                                    lambda: sk.apply_lookup_table(ct, lut),
                                    {"body_rotate_u64": 1,
                                     "blind_rotate_wide_split": 1},
                                    timed=True)
    launches = launches_of("blind_rotate_wide_split")[
        "blind_rotate_wide_split"]
    if not np.array_equal(ck.decrypt_message_and_carry(out), want):
        raise AssertionError("4_4: the batch decrypts wrong")
    with env(TFHE_V4_ACC="32"):
        out32 = launches_exactly("4_4 main path, TFHE_V4_ACC=32",
                                 lambda: sk.apply_lookup_table(ct, lut),
                                 {"body_rotate_acc32": 1,
                                  "blind_rotate_wide_split_acc32": 1})
    launches32 = launches_of("blind_rotate_wide_split_acc32")[
        "blind_rotate_wide_split_acc32"]
    if not np.array_equal(ck.decrypt_message_and_carry(out32), want):
        raise AssertionError("4_4, TFHE_V4_ACC=32: the batch decrypts wrong")
    mask, body = switched(sk, ct)
    mask = mask.contiguous()
    acc = pk.body_rotate_u64(lut.acc, body)
    hi = pk.body_rotate_acc32(lut.acc, body)
    cts, steps = WIDE_SPLIT_PLAIN_CTS, min(WIDE_SPLIT_PLAIN_STEPS, n)
    pre = (mask[:cts, :steps].contiguous(), key[:steps].contiguous(), bl, lv)
    errs, plain_ms = check_equal_all(
        "K7 4_4", {"split": pk.blind_rotate_wide_split,
                   "global": pk.blind_rotate_wide},
        pk.blind_rotate_crt_plain, (acc[:cts].contiguous(), *pre))
    errs32, plain32_ms = check_equal_all(
        "K7-acc32 4_4", {"split": pk.blind_rotate_wide_split_acc32,
                         "global": pk.blind_rotate_wide_acc32},
        pk.blind_rotate_crt_acc32_plain, (hi[:cts].contiguous(), *pre))
    del pre
    # the split on the batch's own inputs (it ran above: no warm-up run),
    # then the split and K7 global in turns at batch 1 (K7 global's turns
    # at a wide batch are part j's, at l = 4)
    args, args32 = (acc, mask, key, bl, lv), (hi, mask, key, bl, lv)
    k7_ms = cuda_ms(lambda: pk.blind_rotate_wide_split(*args), 1,
                    warmup=False)
    k7_32_ms = cuda_ms(lambda: pk.blind_rotate_wide_split_acc32(*args32), 1,
                       warmup=False)
    one = (acc[:1].contiguous(), mask[:1].contiguous(), key, bl, lv)
    one32 = (hi[:1].contiguous(), *one[1:])
    k7_b1, k7g_b1 = in_turns(lambda: pk.blind_rotate_wide_split(*one),
                             lambda: pk.blind_rotate_wide(*one), 2)
    k7_32_b1, k7g_32_b1 = in_turns(
        lambda: pk.blind_rotate_wide_split_acc32(*one32),
        lambda: pk.blind_rotate_wide_acc32(*one32), 2)
    del args, args32, one, one32
    ct1 = ck.encrypt(np.array([7], dtype=np.uint64))
    b1_ms = cuda_ms(lambda: sk.apply_lookup_table(ct1, lut), 5)
    B = WIDE_SPLIT_BATCH
    bnd = step_bound("blind_rotate_crt", B, n, R, lv, N, P, 8, rate)
    bnd32 = step_bound("blind_rotate_crt_acc32", B, n, R, lv, N, P, 4, rate)
    bnd1 = step_bound("blind_rotate_crt", 1, n, R, lv, N, P, 8, rate)
    bnd1_32 = step_bound("blind_rotate_crt_acc32", 1, n, R, lv, N, P, 4,
                         rate)
    occ = pk.wide_cluster_occupancy(P, R, lv, N, 2)
    print(f"4_4 B={B}: KS->PBS {step_ms:.3f} ms = {B / step_ms * 1e3:.1f} "
          f"PBS/s; the split cluster kernel {k7_ms:.3f} ms (bound "
          f"{bnd[0]:.2f} ms, {bnd[1]}: {bnd[0] / k7_ms:.1%}); acc32 "
          f"{k7_32_ms:.3f} ms; batch 1 in turns: split {k7_b1:.3f}, K7 "
          f"global {k7g_b1:.3f} ms ({k7g_b1 / k7_b1:.2f}x; acc32 "
          f"{k7_32_b1:.3f}, {k7g_32_b1:.3f}); "
          f"both designs == plain in both modes on {cts} ciphertexts, the "
          f"first {steps} of {n} steps (plain {plain_ms:.1f}, "
          f"{plain32_ms:.1f} ms); batch 1 KS->PBS {b1_ms:.3f} ms (1 "
          f"launch); the split {occ}; on {card}")
    common = dict(source=WIDE_SOURCE,
                  replaces="tfhe_tpu/ops/pbs_kernel.py:1867",
                  shape=f"4_4 B={B} n={n} N={N} l={lv} P={P}",
                  plain_shape=f"B={cts}, {steps} of {n} steps")
    rows["blind_rotate_wide_split_4_4"] = dict(
        common, launches=launches, max_abs_err=errs["split"], ms=k7_ms,
        plain_ms=plain_ms, bound=bnd, ms_b1=k7_b1, bound_b1_ms=bnd1[0],
        global_ms_b1=k7g_b1,
        kernel="K7's cluster kernel at split 2 (16 CTAs a ciphertext, each "
               "half of every transform; all steps in one launch), K3's "
               "function, u64 acc")
    rows["blind_rotate_wide_split_acc32_4_4"] = dict(
        common, launches=launches32, max_abs_err=errs32["split"],
        ms=k7_32_ms, plain_ms=plain32_ms, bound=bnd32, ms_b1=k7_32_b1,
        global_ms_b1=k7g_32_b1,
        kernel="the split cluster kernel, acc32 (GarnerTail32), "
               "K3-acc32's function")
    one_shape = f"4_4 B=1 n={n} N={N} l={lv} P={P}"
    wide_global = {
        "blind_rotate_wide_4_4": dict(
            common, shape=one_shape, max_abs_err=errs["global"], ms=k7g_b1,
            plain_ms=plain_ms, bound=bnd1, split_ms=k7_b1,
            kernel="K7 global (K7a, K7b, K7c a step), K3's function, the "
                   "reference timed in turns with the split at batch 1 (at "
                   "a wide batch: part j); launches: the N = 32768, l = 1 "
                   "corner's, where the dispatch sends it"),
        "blind_rotate_wide_acc32_4_4": dict(
            common, shape=one_shape, max_abs_err=errs32["global"],
            ms=k7g_32_b1, plain_ms=plain32_ms, bound=bnd1_32,
            split_ms=k7_32_b1,
            kernel="K7 global acc32, in turns with the split at batch 1; "
                   "launches: the N = 32768, l = 1 corner's")}
    summary.update(wide_split_keygen_s=keygen_s, wide_split_key_gb=key_gb,
                   wide_split_pbs_ms=step_ms,
                   wide_split_pbs_per_s=B / step_ms * 1e3,
                   wide_split_ms=k7_ms, wide_split_acc32_ms=k7_32_ms,
                   wide_split_global_acc32_b1_ms=k7g_32_b1,
                   wide_split_b1_ms=k7_b1, wide_split_global_b1_ms=k7g_b1,
                   wide_split_bound_ms=bnd[0], wide_split_ks_pbs_b1_ms=b1_ms,
                   wide_split_occupancy=occ)
    del ck, sk, ct, out, out32, acc, hi, mask, body, key, ct1
    torch.cuda.empty_cache()
    return wide_global


def _wide_split_multi_bit(label, N, levels, base_log, rate, rows, rng):
    """Phase 24's multi-bit shapes on the split cluster kernel (see
    ``phase_wide``, e). Returns K7 global's row at the shape."""
    import torch

    from tfhe_tpu_torch._torus import from_u64
    from tfhe_tpu_torch.ops import kernel_bench as kb
    from tfhe_tpu_torch.ops import pbs_kernel as pk

    R, P, g = 2, 4, 4
    B, G, cts = WIDE_SPLIT_MB_B, WIDE_SPLIT_MB_GROUPS, WIDE_SPLIT_MB_PLAIN
    if pk.wide_route(P, R, levels, N) != "split":
        raise AssertionError(f"{label}: not on the split cluster kernel")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + N + levels)
    mbk = _random_multi_bit_key(N, levels, G, g, gen)
    acc = from_u64(rng.integers(0, 1 << 64, size=(B, R, N), dtype=np.uint64),
                   DEVICE)
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(B, G * g))).to(
        DEVICE).contiguous()
    C = pk.multi_bit_chunk(B, G, P, levels * R, R, N)
    chunks = -(-G // C)
    pk.reset_launches()
    pk.blind_rotate_multi_bit(acc, mask, mbk, base_log, levels)
    torch.cuda.synchronize()
    got = launches_of("multi_bit_keybundle", "multi_bit_accumulate",
                      *(n for d in WIDE_KERNELS.values() for n in d))
    require_launched(f"{label} the K5a + split pair", {
        k: got[k] for k in ("multi_bit_keybundle",
                            "multi_bit_accumulate_wide_split")})
    want = {"multi_bit_keybundle": chunks,
            "multi_bit_accumulate_wide_split": chunks}
    if got != {k: want.get(k, 0) for k in got}:
        raise AssertionError(f"{label}: launches {got}, want {want}")
    launches = got["multi_bit_accumulate_wide_split"]
    check_equal(f"the pair {label}", pk.blind_rotate_multi_bit,
                pk.blind_rotate_multi_bit_plain,
                (acc[:cts].contiguous(), mask[:cts].contiguous(), mbk,
                 base_log, levels))
    bundles = pk.multi_bit_keybundle(mask, mbk, 0, G, base_log, levels)
    del mbk
    torch.cuda.empty_cache()
    errs, plain_ms = check_equal_all(
        f"K7 multi-bit {label}",
        {"split": pk.multi_bit_accumulate_wide_split,
         "global": pk.multi_bit_accumulate_wide},
        pk.multi_bit_accumulate_plain,
        (acc[:cts].contiguous(), bundles[:cts].contiguous(), base_log,
         levels))
    new_ms, ref_ms = in_turns(
        lambda: pk.multi_bit_accumulate_wide_split(acc, bundles, base_log,
                                                   levels),
        lambda: pk.multi_bit_accumulate_wide(acc, bundles, base_log, levels),
        1)
    bnd = bound(kb.multi_bit_accumulate_pipe_instructions(B, G, R, levels, N,
                                                          P),
                accumulate_bytes(B, G, R, levels, N, P), rate)
    occ = pk.wide_cluster_occupancy(P, R, levels, N, 2)
    print(f"{label} (N = {N}, l = {levels}, b = {base_log}, g = {g}, random "
          f"keys): B={B}, {G} group steps: the split {new_ms:.3f} ms (bound "
          f"{bnd[0]:.2f} ms, {bnd[1]}: {bnd[0] / new_ms:.1%}), K7 global "
          f"{ref_ms:.3f} ms in turns ({bnd[0] / ref_ms:.1%}, "
          f"{ref_ms / new_ms:.2f}x); the pair ({chunks} chunks of {C}) "
          f"launched K5a and the split {launches} times each; both designs "
          f"and the pair == plain on {cts} ciphertexts (plain "
          f"{plain_ms:.1f} ms); the classic split kernel here {occ}")
    common = dict(source=WIDE_SOURCE, replaces=MB_REPLACES,
                  shape=f"{label} B={B} g={g} {G} group steps N={N} "
                  f"l={levels}", note="no pallas_call: XLA in tfhe_tpu",
                  plain_shape=f"B={cts}, {G} group steps")
    rows[f"multi_bit_accumulate_wide_split_{label}"] = dict(
        common, launches=launches, max_abs_err=errs["split"], ms=new_ms,
        plain_ms=plain_ms, bound=bnd, global_ms=ref_ms,
        kernel="the split cluster kernel, K5b's function (Barrett MAC "
               "against the bundles), one call of all group steps; launches: "
               "the pair's (K5a + the split a chunk) on random keys")
    del bundles, acc, mask
    torch.cuda.empty_cache()
    return {f"multi_bit_accumulate_wide_{label}": dict(
        common, max_abs_err=errs["global"], ms=ref_ms, plain_ms=plain_ms,
        bound=bnd,
        kernel="K7 global, K5b's function, timed in turns with the split; "
               "launches: the N = 32768, l = 1 corner's")}, {
        f"wide_{label}_split_ms": new_ms, f"wide_{label}_global_ms": ref_ms,
        f"wide_{label}_bound_ms": bnd[0]}


def _wide_deep_classic(card, rate, rows, summary):
    """Phase 24's classic 4_4 set at 2M64 (base_log * levels = 33) on the
    split cluster kernel's 64-bit decomposer, real keys (see
    ``phase_wide``, g)."""
    import torch

    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.shortint.client_key import ClientKey
    from tfhe_tpu_torch.shortint.server_key import ServerKey
    from tfhe_tpu_torch.utils.params import PARAMS_BY_NAME

    p = PARAMS_BY_NAME[WIDE_DEEP_CLASSIC]
    t0 = time.perf_counter()
    ck = ClientKey.generate(p, seed=SEED)
    sk = ServerKey.generate(ck)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    R, N, lv, bl = p.glwe_size, p.polynomial_size, p.pbs_level, p.pbs_base_log
    key, n, P = sk.bsk_scan, p.lwe_dimension, sk.num_primes
    key_gb = key.numel() * 4 / 1e9
    if sk.variant != "crt" or bl * lv <= pk.HI_WORD_MAX_BL or \
            pk.wide_route(P, R, lv, N, 8, bl) != "split":
        raise AssertionError(f"4_4 2M64: variant {sk.variant}, b l = "
                             f"{bl * lv}, not on the split's 64-bit "
                             "decomposer")
    print(f"keygen 4_4 2M64 ({WIDE_DEEP_CLASSIC}): {keygen_s:.1f} s, n = {n}, "
          f"N = {N}, l = {lv}, b = {bl} (b l = {bl * lv}), P = {P}, CRT key "
          f"{tuple(key.shape)} ({key_gb:.2f} GB)")
    mod = p.message_modulus * p.carry_modulus
    f = lambda x: (5 * x + 3) % mod  # noqa: E731
    vals = np.arange(WIDE_DEEP_BATCH, dtype=np.uint64) % mod
    want = np.array([f(int(v)) for v in vals], dtype=np.uint64)
    ct = ck.encrypt(vals)
    lut = sk.generate_lookup_table(f)
    out, step_ms = launches_exactly("4_4 2M64 main path",
                                    lambda: sk.apply_lookup_table(ct, lut),
                                    {"body_rotate_u64": 1,
                                     "blind_rotate_wide_split": 1},
                                    timed=True)
    launches = launches_of("blind_rotate_wide_split")[
        "blind_rotate_wide_split"]
    if not np.array_equal(ck.decrypt_message_and_carry(out), want):
        raise AssertionError("4_4 2M64: the batch decrypts wrong")
    mask, body = switched(sk, ct)
    mask = mask.contiguous()
    acc = pk.body_rotate_u64(lut.acc, body)
    cts, steps = WIDE_DEEP_PLAIN_CTS, min(WIDE_DEEP_PLAIN_STEPS, n)
    errs, plain_ms = check_equal_all(
        "K7 4_4 2M64", {"split": pk.blind_rotate_wide_split},
        pk.blind_rotate_crt_plain,
        (acc[:cts].contiguous(), mask[:cts, :steps].contiguous(),
         key[:steps].contiguous(), bl, lv))
    args = (acc, mask, key, bl, lv)
    k7_ms = cuda_ms(lambda: pk.blind_rotate_wide_split(*args), 1,
                    warmup=False)
    one = (acc[:1].contiguous(), mask[:1].contiguous(), key, bl, lv)
    k7_b1 = cuda_ms(lambda: pk.blind_rotate_wide_split(*one), 2)
    del args, one
    B = WIDE_DEEP_BATCH
    ct1 = ck.encrypt(np.array([7], dtype=np.uint64))
    b1_ms = cuda_ms(lambda: sk.apply_lookup_table(ct1, lut), 5)
    bnd = step_bound("blind_rotate_crt", B, n, R, lv, N, P, 8, rate)
    bnd1 = step_bound("blind_rotate_crt", 1, n, R, lv, N, P, 8, rate)
    print(f"4_4 2M64 B={B}: KS->PBS {step_ms:.3f} ms = "
          f"{B / step_ms * 1e3:.1f} PBS/s; the split's 64-bit decomposer "
          f"{k7_ms:.3f} ms (bound {bnd[0]:.2f} ms, {bnd[1]}: "
          f"{bnd[0] / k7_ms:.1%}); batch 1 {k7_b1:.3f} ms (bound "
          f"{bnd1[0]:.3f}); == plain on {cts} ciphertexts, the first {steps} "
          f"of {n} steps (plain {plain_ms:.1f} ms); batch 1 KS->PBS "
          f"{b1_ms:.3f} ms (median of 5); on {card}")
    rows["blind_rotate_wide_split_4_4_2m64"] = dict(
        source=WIDE_SOURCE, replaces="tfhe_tpu/ops/pbs_kernel.py:1867",
        shape=f"4_4 2M64 B={B} n={n} N={N} l={lv} b={bl} P={P}",
        plain_shape=f"B={cts}, {steps} of {n} steps", launches=launches,
        max_abs_err=errs["split"], ms=k7_ms, plain_ms=plain_ms, bound=bnd,
        ms_b1=k7_b1, bound_b1_ms=bnd1[0],
        kernel="the split cluster kernel's 64-bit decomposer "
               "(GarnerTailDeep<4>), K3's function, u64 acc")
    summary.update(wide_deep_keygen_s=keygen_s, wide_deep_key_gb=key_gb,
                   wide_deep_pbs_ms=step_ms,
                   wide_deep_pbs_per_s=B / step_ms * 1e3,
                   wide_deep_split_ms=k7_ms, wide_deep_split_b1_ms=k7_b1,
                   wide_deep_bound_ms=bnd[0], wide_deep_ks_pbs_b1_ms=b1_ms)
    del ck, sk, ct, out, acc, mask, body, key, ct1
    torch.cuda.empty_cache()


def _wide_deep_multi_bit(card, rate, rows, summary, rng):
    """Phase 24's GPU group-4 4_4 set at 2M128 (b = 8, l = 4) on K5a and
    the streamed split's 64-bit decomposer, random keys at its shape cut
    to WIDE_DEEP_MB_GROUPS group steps, K7 global in turns (see
    ``phase_wide``, h). Returns K7 global's row at the shape."""
    import torch

    from tfhe_tpu_torch._torus import from_u64
    from tfhe_tpu_torch.ops import kernel_bench as kb
    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.shortint.server_key import check_supported
    from tfhe_tpu_torch.utils.params import PARAMS_BY_NAME

    p = PARAMS_BY_NAME[WIDE_DEEP_MB]
    check_supported(p, DEVICE)
    g, R, N, lv, bl = (p.grouping_factor, p.glwe_size, p.polynomial_size,
                       p.pbs_level, p.pbs_base_log)
    P, ng = 4, p.lwe_dimension // g
    B, G, cts = WIDE_DEEP_MB_B, WIDE_DEEP_MB_GROUPS, WIDE_DEEP_MB_PLAIN
    key_gb = ng * 2 * P * ((1 << g) - 1) * lv * R * R * N * 4 / 1e9
    if pk.wide_route(P, R, lv, N, 8, bl) != "split" or \
            not pk.split_streams(P, R, lv, N):
        raise AssertionError("g4 4_4 2M128: not on the streamed split")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 44)
    mbk = _random_multi_bit_key(N, lv, G, g, gen)
    acc = from_u64(rng.integers(0, 1 << 64, size=(B, R, N), dtype=np.uint64),
                   DEVICE)
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(B, G * g))).to(
        DEVICE).contiguous()
    C = pk.multi_bit_chunk(B, G, P, lv * R, R, N)
    chunks = -(-G // C)
    pk.reset_launches()
    out = pk.blind_rotate_multi_bit(acc, mask, mbk, bl, lv)
    torch.cuda.synchronize()
    got = launches_of(*LUT_KERNELS)
    want = {"multi_bit_keybundle": chunks,
            "multi_bit_accumulate_wide_split": chunks}
    require_launched("g4 4_4 2M128 the K5a + streamed split pair", {
        k: got[k] for k in want})
    if got != {k: want.get(k, 0) for k in got}:
        raise AssertionError(f"g4 4_4 2M128: launches {got}, want {want}")
    launches = got["multi_bit_accumulate_wide_split"]
    k5a_launches = got["multi_bit_keybundle"]
    m4, a4 = mask[:cts].contiguous(), acc[:cts].contiguous()
    check_equal("the pair g4 4_4 2M128", pk.blind_rotate_multi_bit,
                pk.blind_rotate_multi_bit_plain, (a4, m4, mbk, bl, lv))
    a_err, a_plain = check_equal("multi_bit_keybundle g4 4_4 2M128",
                                 pk.multi_bit_keybundle,
                                 pk.multi_bit_keybundle_plain,
                                 (m4, mbk, 0, G, bl, lv))
    b4 = pk.multi_bit_keybundle(m4, mbk, 0, G, bl, lv)
    errs, b_plain = check_equal_all(
        "K7 multi-bit g4 4_4 2M128",
        {"stream": pk.multi_bit_accumulate_wide_split,
         "global": pk.multi_bit_accumulate_wide},
        pk.multi_bit_accumulate_plain, (a4, b4, bl, lv))
    del b4, out
    scratch = torch.empty(B * C * P * lv * R * R * N, dtype=torch.int32,
                          device=DEVICE)
    k5a_ms = cuda_ms(lambda: [pk.multi_bit_keybundle(
        mask, mbk, t0, min(C, G - t0), bl, lv, out=scratch)
        for t0 in range(0, G, C)], 1)
    del scratch
    sizes = [min(C, G - t0) for t0 in range(0, G, C)]
    bundles = {c: pk.multi_bit_keybundle(mask, mbk, 0, c, bl, lv)
               for c in set(sizes)}
    k7_ms, k7g_ms = in_turns(
        lambda: [pk.multi_bit_accumulate_wide_split(acc, bundles[c], bl, lv)
                 for c in sizes],
        lambda: [pk.multi_bit_accumulate_wide(acc, bundles[c], bl, lv)
                 for c in sizes], 1)
    del bundles
    one = pk.multi_bit_keybundle(mask[:1].contiguous(), mbk, 0, G, bl, lv)
    acc1 = acc[:1].contiguous()
    k7_b1 = cuda_ms(lambda: pk.multi_bit_accumulate_wide_split(
        acc1, one, bl, lv), 2)
    pair_ms = cuda_ms(lambda: pk.blind_rotate_multi_bit(acc, mask, mbk, bl,
                                                        lv), 1)
    del one, acc1, mbk
    a_bnd = bound(kb.multi_bit_keybundle_pipe_instructions(
        B, G, g, R, lv, N, P), keybundle_bytes(B, G, g, R, lv, N, P), rate)
    b_bnd = bound(kb.multi_bit_accumulate_pipe_instructions(
        B, G, R, lv, N, P), accumulate_bytes(B, G, R, lv, N, P), rate)
    b_bnd1 = bound(kb.multi_bit_accumulate_pipe_instructions(
        1, G, R, lv, N, P), accumulate_bytes(1, G, R, lv, N, P), rate)
    print(f"g4 4_4 2M128 (n/g = {ng}, N = {N}, l = {lv}, b = {bl}; its K5 "
          f"key {key_gb:.1f} GB with its duals: random keys, {G} of {ng} "
          f"group steps): B={B}, {chunks} chunks of {C}: the pair "
          f"{pair_ms:.3f} ms; K5a {k5a_ms:.3f} ms (bound {a_bnd[0]:.2f}, "
          f"{a_bnd[1]}: {a_bnd[0] / k5a_ms:.1%}), the streamed split "
          f"{k7_ms:.3f} ms (bound {b_bnd[0]:.2f}, {b_bnd[1]}: "
          f"{b_bnd[0] / k7_ms:.1%}), K7 global {k7g_ms:.3f} ms in turns "
          f"({b_bnd[0] / k7g_ms:.1%}, {k7g_ms / k7_ms:.2f}x); batch 1, {G} "
          f"steps in one chunk: the stream {k7_b1:.3f} ms (bound "
          f"{b_bnd1[0]:.3f}); the pair, K5a, the stream and K7 global == "
          f"plain on {cts} ciphertexts over {G} group steps (plain "
          f"{a_plain:.1f}, {b_plain:.1f} ms); on {card}")
    common = dict(replaces=MB_REPLACES, note="no pallas_call: XLA in tfhe_tpu",
                  shape=f"g4 4_4 2M128 B={B} {G} of {ng} group steps N={N} "
                  f"l={lv} b={bl} C={C}, random keys",
                  plain_shape=f"B={cts}, {G} group steps")
    rows["multi_bit_accumulate_wide_split_g4_4_4_2m128"] = dict(
        common, source=WIDE_SOURCE, launches=launches,
        max_abs_err=errs["stream"], ms=k7_ms, plain_ms=b_plain, bound=b_bnd,
        ms_b1=k7_b1, bound_b1_ms=b_bnd1[0], global_ms=k7g_ms,
        kernel="the split with its levels streamed, 64-bit decomposer "
               "(GarnerTailDeep<4>), K5b's function, all chunks of the "
               "call; launches: the pair's on random keys")
    rows["multi_bit_keybundle_g4_4_4_2m128"] = dict(
        common, source=MB_SOURCE, launches=k5a_launches, max_abs_err=a_err,
        ms=k5a_ms, plain_ms=a_plain, bound=a_bnd,
        kernel="K5a at N = 32768, l = 4, all chunks of the call")
    summary.update(wide_deep_mb_key_gb=key_gb, wide_deep_mb_pair_ms=pair_ms,
                   wide_deep_mb_k5a_ms=k5a_ms, wide_deep_mb_stream_ms=k7_ms,
                   wide_deep_mb_global_ms=k7g_ms,
                   wide_deep_mb_stream_b1_ms=k7_b1)
    del acc, mask
    torch.cuda.empty_cache()
    return {"multi_bit_accumulate_wide_g4_4_4_2m128": dict(
        common, source=WIDE_SOURCE, max_abs_err=errs["global"], ms=k7g_ms,
        plain_ms=b_plain, bound=b_bnd, stream_ms=k7_ms,
        kernel="K7 global multi-bit (64-bit decomposer), K5b's function, "
               "timed in turns with the streamed split; launches: the N = "
               "32768, l = 1 corner's")}


def _wide_stream_classic(card, rate, rows, summary):
    """Phase 24's 2_6 compact-PK set at 2M64 on the split with its levels
    streamed, real keys (see ``phase_wide``, j). Returns K7 global's row
    at the set."""
    import torch

    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.shortint.client_key import ClientKey
    from tfhe_tpu_torch.shortint.server_key import ServerKey
    from tfhe_tpu_torch.utils.params import PARAMS_BY_NAME

    p = PARAMS_BY_NAME[WIDE_STREAM_CLASSIC]
    t0 = time.perf_counter()
    ck = ClientKey.generate(p, seed=SEED)
    sk = ServerKey.generate(ck)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    R, N, lv, bl = p.glwe_size, p.polynomial_size, p.pbs_level, p.pbs_base_log
    key, n, P = sk.bsk_scan, p.lwe_dimension, sk.num_primes
    key_gb = key.numel() * 4 / 1e9
    if sk.variant != "crt" or pk.wide_route(P, R, lv, N, 8, bl) != "split" \
            or not pk.split_streams(P, R, lv, N):
        raise AssertionError(f"2_6 CPK 2M64: variant {sk.variant}, not on the "
                             "streamed split")
    print(f"keygen 2_6 CPK 2M64 ({WIDE_STREAM_CLASSIC}): {keygen_s:.1f} s, n "
          f"= {n}, N = {N}, l = {lv}, b = {bl} (b l = {bl * lv}), P = {P}, "
          f"CRT key {tuple(key.shape)} ({key_gb:.2f} GB); a split CTA "
          f"holding all l transforms {pk.split_area(P, R, lv, N)} B > "
          f"{pk._SMEM_LIMIT}, streamed "
          f"{pk.cluster_smem_formula(P, R, lv, N, 8, 2)} B (digits "
          f"{pk.split_digit_bytes(P, R, lv, N)} B each)")
    mod = p.message_modulus * p.carry_modulus
    f = lambda x: (5 * x + 3) % mod  # noqa: E731
    vals = np.arange(WIDE_STREAM_BATCH, dtype=np.uint64) % mod
    want = np.array([f(int(v)) for v in vals], dtype=np.uint64)
    ct = ck.encrypt(vals)
    lut = sk.generate_lookup_table(f)
    out, step_ms = launches_exactly("2_6 CPK 2M64 main path",
                                    lambda: sk.apply_lookup_table(ct, lut),
                                    {"body_rotate_u64": 1,
                                     "blind_rotate_wide_split": 1},
                                    timed=True)
    launches = launches_of("blind_rotate_wide_split")[
        "blind_rotate_wide_split"]
    if not np.array_equal(ck.decrypt_message_and_carry(out), want):
        raise AssertionError("2_6 CPK 2M64: the batch decrypts wrong")
    mask, body = switched(sk, ct)
    mask = mask.contiguous()
    acc = pk.body_rotate_u64(lut.acc, body)
    cts, steps = WIDE_STREAM_PLAIN_CTS, min(WIDE_STREAM_PLAIN_STEPS, n)
    errs, plain_ms = check_equal_all(
        "K7 2_6 CPK 2M64", {"stream": pk.blind_rotate_wide_split,
                            "global": pk.blind_rotate_wide},
        pk.blind_rotate_crt_plain,
        (acc[:cts].contiguous(), mask[:cts, :steps].contiguous(),
         key[:steps].contiguous(), bl, lv))
    args = (acc, mask, key, bl, lv)
    k7_ms = cuda_ms(lambda: pk.blind_rotate_wide_split(*args), 1,
                    warmup=False)
    Bg = WIDE_STREAM_GLOBAL_B
    few = (acc[:Bg].contiguous(), mask[:Bg].contiguous(), key, bl, lv)
    k7_few, k7g_few = in_turns(lambda: pk.blind_rotate_wide_split(*few),
                               lambda: pk.blind_rotate_wide(*few), 1,
                               warmup=False)
    one = (acc[:1].contiguous(), mask[:1].contiguous(), key, bl, lv)
    k7_b1 = cuda_ms(lambda: pk.blind_rotate_wide_split(*one), 2)
    del args, few, one
    B = WIDE_STREAM_BATCH
    ct1 = ck.encrypt(np.array([7], dtype=np.uint64))
    b1_ms = cuda_ms(lambda: sk.apply_lookup_table(ct1, lut), 5)
    bnd = step_bound("blind_rotate_crt", B, n, R, lv, N, P, 8, rate)
    bnd_few = step_bound("blind_rotate_crt", Bg, n, R, lv, N, P, 8, rate)
    bnd1 = step_bound("blind_rotate_crt", 1, n, R, lv, N, P, 8, rate)
    occ = pk.wide_cluster_occupancy(P, R, lv, N, 2)
    print(f"2_6 CPK 2M64 B={B}: KS->PBS {step_ms:.3f} ms = "
          f"{B / step_ms * 1e3:.1f} PBS/s; the streamed split {k7_ms:.3f} ms "
          f"(bound {bnd[0]:.2f} ms, {bnd[1]}: {bnd[0] / k7_ms:.1%}); B={Bg} "
          f"in turns: the stream {k7_few:.3f} ms "
          f"({bnd_few[0] / k7_few:.1%}), K7 global {k7g_few:.3f} ms "
          f"({bnd_few[0] / k7g_few:.1%}, {k7g_few / k7_few:.2f}x); batch 1 "
          f"{k7_b1:.3f} ms (bound {bnd1[0]:.3f}); both == plain on {cts} "
          f"ciphertexts, the first {steps} of {n} steps (plain "
          f"{plain_ms:.1f} ms); batch 1 KS->PBS {b1_ms:.3f} ms (median of "
          f"5); the stream {occ}; on {card}")
    common = dict(source=WIDE_SOURCE,
                  replaces="tfhe_tpu/ops/pbs_kernel.py:1867",
                  plain_shape=f"B={cts}, {steps} of {n} steps")
    rows["blind_rotate_wide_split_2_6_cpk"] = dict(
        common, shape=f"2_6 CPK 2M64 B={B} n={n} N={N} l={lv} b={bl} P={P}",
        launches=launches, max_abs_err=errs["stream"], ms=k7_ms,
        plain_ms=plain_ms, bound=bnd, ms_b1=k7_b1, bound_b1_ms=bnd1[0],
        ms_few=k7_few, global_ms_few=k7g_few,
        kernel="the split with its levels streamed (16 CTAs a ciphertext, "
               "one transform buffer and the R partials a CTA, int16 "
               "digits), 64-bit decomposer (GarnerTailDeep<4>), K3's "
               "function, u64 acc")
    summary.update(wide_stream_keygen_s=keygen_s, wide_stream_key_gb=key_gb,
                   wide_stream_pbs_ms=step_ms,
                   wide_stream_pbs_per_s=B / step_ms * 1e3,
                   wide_stream_ms=k7_ms, wide_stream_b1_ms=k7_b1,
                   wide_stream_few_ms=k7_few,
                   wide_stream_global_few_ms=k7g_few,
                   wide_stream_bound_ms=bnd[0], wide_stream_ks_pbs_b1_ms=b1_ms,
                   wide_stream_occupancy=occ)
    del ck, sk, ct, out, acc, mask, body, key, ct1
    torch.cuda.empty_cache()
    return {"blind_rotate_wide_2_6_cpk": dict(
        common, shape=f"2_6 CPK 2M64 B={Bg} n={n} N={N} l={lv} b={bl} P={P}",
        max_abs_err=errs["global"], ms=k7g_few, plain_ms=plain_ms,
        bound=bnd_few, stream_ms=k7_few,
        kernel="K7 global (K7a, K7b, K7c a step), 64-bit decomposer, K3's "
               "function, timed in turns with the streamed split; "
               "launches: the N = 32768, l = 1 corner's")}


def phase_wide(card, rate, rows):
    """tfhe-rs's 3_3 and 4_4 sets on the card through K7
    (csrc/blind_rotate_wide.cu) at full width. The 3_3 steps run on K7's
    cluster kernel (a cluster of P R = 8 CTAs a ciphertext, acc and digits
    in distributed shared memory for all steps, one launch a call); the 4_4
    steps (N = 32768, and N = 16384 at l = 3) on the same kernel at split 2
    (2 P R = 16 CTAs a ciphertext, each holding half of every transform,
    the accumulator in global memory), with the levels streamed through
    one transform buffer where a CTA holding all l transforms exceeds a
    block (N = 32768 at l = 4 to 6); K7 global (three stage launches a
    step through global memory), the reference, is timed beside the split
    in turns and runs the N = 32768, l = 1 corners:
    a. the classic default ``PARAM_MESSAGE_3_CARRY_3_KS_PBS_GAUSSIAN_2M128``
       (n = 1006, k = 1, N = 8192, l = 2, b = 15; acc and digits 655,360 B
       a ciphertext, beyond a block): seeded keygen (s, MB); WIDE_BATCH
       ciphertexts covering all 64 values through ``apply_lookup_table``
       (K2 u64 once, the cluster kernel once, K3, the split and K7 global
       never), decrypted; the same under ``TFHE_V4_ACC=32`` (K2 acc32, the
       acc32 cluster kernel); the cluster kernel equal to the plain
       versions on the first WIDE_PLAIN_CTS ciphertexts' own inputs over
       the first PLAIN_STEPS steps, both accumulator modes, and timed at
       WIDE_BATCH and at batch 1, both modes; PBS/s at WIDE_BATCH, the
       bound; KS -> PBS at batch 1 (median of 5);
    b. the GPU group-4 default ``PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_3_
       CARRY_3_KS_PBS_GAUSSIAN_2M128`` (n = 1004, 251 steps): keygen (s,
       GB); WIDE_MB_BATCH through ``apply_lookup_table`` (K2 u64, K5a and
       the cluster kernel a chunk, K5b never), decrypted; K5a and the
       cluster kernel equal to their plain versions over the first
       WIDE_MB_PLAIN_GROUPS group steps; both timed over every chunk at
       WIDE_MB_BATCH, the cluster kernel at batch 1; PBS/s; KS -> PBS at
       batch 1;
    c. ``check_supported`` refusing WIDE_REFUSED on the card;
    d. the classic 4_4 set ``V1_5_PARAM_MESSAGE_4_CARRY_4_KS_PBS_GAUSSIAN_
       2M40`` (n = 1096, k = 1, N = 32768, l = 2, b = 15; a CTA of the
       cluster kernel 393,216 B, of the split 147,456 B): keygen (s, GB);
       WIDE_SPLIT_BATCH ciphertexts covering all 256 values through
       ``apply_lookup_table`` (K2 u64 once, the split once, K3, the
       cluster kernel and K7 global never), decrypted; the same under
       ``TFHE_V4_ACC=32``; the split and K7 global equal to the plain
       versions in both modes on WIDE_SPLIT_PLAIN_CTS ciphertexts over the
       first WIDE_SPLIT_PLAIN_STEPS steps; the split timed at
       WIDE_SPLIT_BATCH in both modes, the two in turns at batch 1, both
       modes; PBS/s (the main path's own run, timed), KS -> PBS at batch 1
       (median of 5), the bound;
    e. the multi-bit split shapes WIDE_SPLIT_MB (N = 32768 and N = 16384,
       l = 3, the GPU group-4 4_4 set's and the group-4 1_6 set's) on
       random group-4 keys and accumulators, WIDE_SPLIT_MB_B ciphertexts
       over WIDE_SPLIT_MB_GROUPS group steps (depth cut only): the pair
       (K5a, the split a chunk; K5b, the cluster kernel and K7 global
       never), the pair, the split and K7 global equal to the plain
       versions on WIDE_SPLIT_MB_PLAIN ciphertexts; the split and K7
       global in turns on all of them;
    f. random keys at WIDE_CORNERS (N = 16384 on the cluster kernel, N =
       32768 at l = 1 on K7 global);
    g. base_log * levels >= 32, the kernels' 64-bit decomposer: the classic
       4_4 set at 2M64 ``V1_5_PARAM_MESSAGE_4_CARRY_4_KS_PBS_GAUSSIAN_2M64``
       (n = 1110, N = 32768, b = 11, l = 3): keygen (s, GB); WIDE_DEEP_BATCH
       ciphertexts covering all 256 values through ``apply_lookup_table``
       (K2 u64 once, the split once, nothing else), decrypted; the split
       equal to the plain version on WIDE_DEEP_PLAIN_CTS ciphertexts over
       the first WIDE_DEEP_PLAIN_STEPS steps; timed at WIDE_DEEP_BATCH and
       1; PBS/s (the main path's own run, timed), KS -> PBS at batch 1
       (median of 5), the bound;
    h. tfhe-rs's GPU group-4 4_4 set at 2M128 (n = 1132, N = 32768, b = 8,
       l = 4) on K5a and the streamed split multi-bit: its K5 key (71.2
       GB) exceeds the card, so random group-4 keys at its shape over
       WIDE_DEEP_MB_GROUPS group steps, WIDE_DEEP_MB_B ciphertexts through
       the pair (chunks of MB_SCRATCH_BYTES), the pair, K5a, the stream
       and K7 global equal to the plain versions on WIDE_DEEP_MB_PLAIN
       ciphertexts over all those steps; K5a and the pair timed, the
       stream and K7 global in turns, the stream at batch 1;
    i. random keys at WIDE_DEEP_CORNERS (the split at N = 16384, l = 3; the
       streamed split at N = 32768, l = 4; the cluster kernel at N = 8192,
       l = 4; K3 at N = 2048, l = 3 and K5b at N = 1024, l = 4; the
       multi-bit split and cluster kernel; the streamed split's int8
       digits at the multi-bit l = 5 and 6 shapes and its hi word's
       decomposer at a classic l = 4, b = 7 shape), each equal to its plain
       version and timed, the acc32 entries refusing each deep classic one
       (and at b = 7 running on K7 global);
    j. the streamed split on real keys: the 2_6 compact-PK set at 2M64
       ``V1_5_PARAM_MESSAGE_2_CARRY_6_COMPACT_PK_KS_PBS_GAUSSIAN_2M64`` (n
       = 1111, N = 32768, b = 9, l = 4): keygen (s, GB); WIDE_STREAM_BATCH
       ciphertexts covering all 256 values through ``apply_lookup_table``
       (K2 u64 once, the split's entry once, which streams; nothing else),
       decrypted; the stream and K7 global equal to the plain version on
       WIDE_STREAM_PLAIN_CTS ciphertexts over the first
       WIDE_STREAM_PLAIN_STEPS steps; the stream timed at WIDE_STREAM_BATCH
       and 1, and in turns with K7 global at WIDE_STREAM_GLOBAL_B; PBS/s
       (the main path's own run, timed), KS -> PBS at batch 1 (median of
       5), the bound.
    Phase c also holds ``check_supported`` accepting, on the card, every
    set of the universe with base_log * levels >= 32 at N <= 32768. Each
    part's seconds are printed."""
    import torch

    from tfhe_tpu_torch.ops import kernel_bench as kb
    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.shortint.client_key import ClientKey
    from tfhe_tpu_torch.shortint.server_key import ServerKey, check_supported
    from tfhe_tpu_torch.utils import params_registry as reg
    from tfhe_tpu_torch.utils.params import PARAMS_BY_NAME

    t_phase = time.perf_counter()
    summary = {}
    parts = {}

    def part_done(name, t0):
        parts[name] = time.perf_counter() - t0
        return time.perf_counter()

    # c. the refusals, before any key; the 64-bit decomposer's sets pass
    for name in WIDE_REFUSED:
        try:
            check_supported(PARAMS_BY_NAME[name], "cuda")
        except ValueError as e:
            if "R10" not in str(e) or "N = 65536" not in str(e):
                raise
            print(f"refused on the card: {e}")
        else:
            raise AssertionError(f"{name}: check_supported accepted it")
    deep = [PARAMS_BY_NAME[name] for name, (kind, _) in reg.RAW_PARAMS.items()
            if kind in WIDE_PBS_KINDS]
    deep = [p for p in deep if p.polynomial_size <= pk.WIDE_MAX_N
            and p.pbs_base_log * p.pbs_level > pk.HI_WORD_MAX_BL]
    for p in deep:
        check_supported(p, "cuda")
    if len(deep) != 23:
        raise AssertionError(f"{len(deep)} sets with base_log * levels >= "
                             "32 at N <= 32768, not the universe's 23")
    print(f"accepted on the card: the {len(deep)} sets with base_log * "
          "levels >= 32 at N <= 32768 (the 64-bit decomposer)")
    t_part = part_done("c", t_phase)

    # a. classic 3_3
    p = PARAMS_BY_NAME[WIDE_CLASSIC]
    t0 = time.perf_counter()
    ck = ClientKey.generate(p, seed=SEED)
    sk = ServerKey.generate(ck)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    R, N, lv, bl = p.glwe_size, p.polynomial_size, p.pbs_level, p.pbs_base_log
    key, n, P = sk.bsk_scan, p.lwe_dimension, sk.num_primes
    key_mb = key.numel() * 4 / 1e6
    if sk.variant != "crt" or pk.wide_route(P, R, lv, N) != "cluster" or \
            pk.wide_route(P, R, lv, N, 4) != "cluster":
        raise AssertionError(f"3_3: variant {sk.variant}, not on K7's "
                             "cluster kernel")
    print(f"keygen 3_3 ({WIDE_CLASSIC}): {keygen_s:.1f} s, n = {n}, N = {N}, "
          f"l = {lv}, b = {bl}, P = {P}, CRT key {tuple(key.shape)} "
          f"({key_mb:.1f} MB); acc + digits "
          f"{pk.step_smem_formula(P, R, lv, N, 8)} B a block > "
          f"{pk._SMEM_LIMIT}; a cluster CTA "
          f"{pk.cluster_smem_formula(P, R, lv, N, 8)} B")
    mod = p.message_modulus * p.carry_modulus
    f = lambda x: (5 * x + 3) % mod  # noqa: E731
    vals = np.arange(WIDE_BATCH, dtype=np.uint64) % mod
    want = np.array([f(int(v)) for v in vals], dtype=np.uint64)
    ct = ck.encrypt(vals)
    lut = sk.generate_lookup_table(f)
    out = launches_exactly("3_3 main path",
                           lambda: sk.apply_lookup_table(ct, lut),
                           {"body_rotate_u64": 1,
                            "blind_rotate_wide_cluster": 1})
    launches = launches_of("blind_rotate_wide_cluster")[
        "blind_rotate_wide_cluster"]
    if not np.array_equal(ck.decrypt_message_and_carry(out), want):
        raise AssertionError("3_3: the batch decrypts wrong")
    with env(TFHE_V4_ACC="32"):
        out32 = launches_exactly("3_3 main path, TFHE_V4_ACC=32",
                                 lambda: sk.apply_lookup_table(ct, lut),
                                 {"body_rotate_acc32": 1,
                                  "blind_rotate_wide_cluster_acc32": 1})
    launches32 = launches_of("blind_rotate_wide_cluster_acc32")[
        "blind_rotate_wide_cluster_acc32"]
    if not np.array_equal(ck.decrypt_message_and_carry(out32), want):
        raise AssertionError("3_3, TFHE_V4_ACC=32: the batch decrypts wrong")
    mask, body = switched(sk, ct)
    mask = mask.contiguous()
    acc = pk.body_rotate_u64(lut.acc, body)
    hi = pk.body_rotate_acc32(lut.acc, body)
    steps = min(PLAIN_STEPS, n)
    pre = (mask[:WIDE_PLAIN_CTS, :steps].contiguous(),
           key[:steps].contiguous(), bl, lv)
    errs, plain_ms = check_equal_all(
        "K7 3_3", {"cluster": pk.blind_rotate_wide_cluster},
        pk.blind_rotate_crt_plain, (acc[:WIDE_PLAIN_CTS].contiguous(), *pre))
    errs32, plain32_ms = check_equal_all(
        "K7-acc32 3_3", {"cluster": pk.blind_rotate_wide_cluster_acc32},
        pk.blind_rotate_crt_acc32_plain,
        (hi[:WIDE_PLAIN_CTS].contiguous(), *pre))
    del pre
    # the cluster kernel on the batch's own inputs (it ran on them above:
    # no warm-up run), then at batch 1
    args, args32 = (acc, mask, key, bl, lv), (hi, mask, key, bl, lv)
    k7_ms = cuda_ms(lambda: pk.blind_rotate_wide_cluster(*args), 2,
                    warmup=False)
    k7_32_ms = cuda_ms(lambda: pk.blind_rotate_wide_cluster_acc32(*args32),
                       2, warmup=False)
    one = (acc[:1].contiguous(), mask[:1].contiguous(), key, bl, lv)
    one32 = (hi[:1].contiguous(), *one[1:])
    k7_b1 = cuda_ms(lambda: pk.blind_rotate_wide_cluster(*one), 3)
    k7_32_b1 = cuda_ms(lambda: pk.blind_rotate_wide_cluster_acc32(*one32), 3)
    del args, args32, one, one32
    step_ms = cuda_ms(lambda: sk.apply_lookup_table(ct, lut), 2,
                      warmup=False)
    ct1 = ck.encrypt(np.array([7], dtype=np.uint64))
    b1_ms = cuda_ms(lambda: sk.apply_lookup_table(ct1, lut), 5)
    bnd = step_bound("blind_rotate_crt", WIDE_BATCH, n, R, lv, N, P, 8, rate)
    bnd32 = step_bound("blind_rotate_crt_acc32", WIDE_BATCH, n, R, lv, N, P,
                       4, rate)
    bnd1 = step_bound("blind_rotate_crt", 1, n, R, lv, N, P, 8, rate)
    occ = pk.wide_cluster_occupancy(P, R, lv, N)
    print(f"3_3 B={WIDE_BATCH}: KS->PBS {step_ms:.3f} ms = "
          f"{WIDE_BATCH / step_ms * 1e3:.1f} PBS/s; K7 cluster kernel "
          f"{k7_ms:.3f} ms (bound {bnd[0]:.2f} ms, {bnd[1]}: "
          f"{bnd[0] / k7_ms:.1%}); acc32 {k7_32_ms:.3f} ms; batch 1 "
          f"{k7_b1:.3f} ms (acc32 {k7_32_b1:.3f}); == plain in both modes "
          f"on {WIDE_PLAIN_CTS} ciphertexts, the first {steps} of {n} steps "
          f"(plain {plain_ms:.1f}, {plain32_ms:.1f} ms); batch 1 KS->PBS "
          f"{b1_ms:.3f} ms (1 launch); the cluster kernel {occ}; on {card}")
    common = dict(source=WIDE_SOURCE, replaces="tfhe_tpu/ops/pbs_kernel.py:1867",
                  shape=f"3_3 B={WIDE_BATCH} n={n} N={N} l={lv} P={P}",
                  plain_shape=f"B={WIDE_PLAIN_CTS}, {steps} of {n} steps")
    rows["blind_rotate_wide_cluster_3_3"] = dict(
        common, launches=launches, max_abs_err=errs["cluster"], ms=k7_ms,
        plain_ms=plain_ms, bound=bnd, ms_b1=k7_b1, bound_b1_ms=bnd1[0],
        kernel="K7's cluster kernel (8 CTAs a ciphertext, all steps in one "
               "launch), K3's function, u64 acc")
    rows["blind_rotate_wide_cluster_acc32_3_3"] = dict(
        common, launches=launches32, max_abs_err=errs32["cluster"],
        ms=k7_32_ms, plain_ms=plain32_ms, bound=bnd32, ms_b1=k7_32_b1,
        kernel="K7's cluster kernel, acc32 (GarnerTail32), K3-acc32's "
               "function")
    summary.update(wide_keygen_s=keygen_s, wide_key_mb=key_mb,
                   wide_pbs_ms=step_ms, wide_pbs_per_s=WIDE_BATCH / step_ms
                   * 1e3, wide_k7_ms=k7_ms, wide_k7_acc32_ms=k7_32_ms,
                   wide_k7_b1_ms=k7_b1, wide_k7_bound_ms=bnd[0],
                   wide_ks_pbs_b1_ms=b1_ms, wide_k7_occupancy=occ)
    del ck, sk, ct, out, out32, acc, hi, mask, body, key, ct1
    torch.cuda.empty_cache()
    t_part = part_done("a", t_part)

    # b. group-4 3_3
    ck, sk, mb_keygen_s = _multi_bit_keys("g4_3_3", WIDE_MULTI_BIT)
    p = sk.params
    mbk = sk.bsk_mb
    g, R, N, lv, bl = (p.grouping_factor, p.glwe_size, p.polynomial_size,
                       p.pbs_level, p.pbs_base_log)
    ng, P = mbk.shape[0], mbk.shape[2]
    if pk.wide_route(P, R, lv, N) != "cluster":
        raise AssertionError("g4 3_3: not on K7's cluster kernel")
    mod = p.message_modulus * p.carry_modulus
    vals = np.arange(WIDE_MB_BATCH, dtype=np.uint64) % mod
    want = np.array([f(int(v)) for v in vals], dtype=np.uint64)
    ct = ck.encrypt(vals)
    lut = sk.generate_lookup_table(f)
    C = pk.multi_bit_chunk(WIDE_MB_BATCH, ng, P, lv * R, R, N)
    pairs = -(-ng // C)
    out = launches_exactly("g4 3_3 main path",
                           lambda: sk.apply_lookup_table(ct, lut),
                           {"body_rotate_u64": 1,
                            "multi_bit_keybundle": pairs,
                            "multi_bit_accumulate_wide_cluster": pairs})
    mb_launches = launches_of("multi_bit_keybundle",
                              "multi_bit_accumulate_wide_cluster")
    if not np.array_equal(ck.decrypt_message_and_carry(out), want):
        raise AssertionError("g4 3_3: the batch decrypts wrong")
    mask, body = switched(sk, ct)
    mask = mask.contiguous()
    acc = pk.body_rotate_u64(lut.acc, body)
    G = min(WIDE_MB_PLAIN_GROUPS, ng)
    mask8, acc8 = (mask[:WIDE_PLAIN_CTS].contiguous(),
                   acc[:WIDE_PLAIN_CTS].contiguous())
    a_err, a_plain = check_equal("multi_bit_keybundle g4 3_3",
                                 pk.multi_bit_keybundle,
                                 pk.multi_bit_keybundle_plain,
                                 (mask8, mbk, 0, G, bl, lv))
    bundles8 = pk.multi_bit_keybundle(mask8, mbk, 0, G, bl, lv)
    b_errs, b_plain = check_equal_all(
        "K7 multi-bit g4 3_3",
        {"cluster": pk.multi_bit_accumulate_wide_cluster},
        pk.multi_bit_accumulate_plain, (acc8, bundles8, bl, lv))
    del bundles8
    chunks = [(t0, min(C, ng - t0)) for t0 in range(0, ng, C)]
    scratch = torch.empty(WIDE_MB_BATCH * C * P * lv * R * R * N,
                          dtype=torch.int32, device=DEVICE)
    k5a_ms = cuda_ms(lambda: [pk.multi_bit_keybundle(
        mask, mbk, t0, c, bl, lv, out=scratch) for t0, c in chunks], 1)
    del scratch
    bundles = {c: pk.multi_bit_keybundle(mask, mbk, 0, c, bl, lv)
               for c in {c for _, c in chunks}}
    k7_mb_ms = cuda_ms(lambda: [pk.multi_bit_accumulate_wide_cluster(
        acc, bundles[c], bl, lv) for _, c in chunks], 2)
    del bundles
    torch.cuda.empty_cache()
    # batch 1: its own chunks (all ng steps in one at this shape)
    C1 = pk.multi_bit_chunk(1, ng, P, lv * R, R, N)
    one = [pk.multi_bit_keybundle(mask[:1].contiguous(), mbk, t0,
                                  min(C1, ng - t0), bl, lv)
           for t0 in range(0, ng, C1)]
    acc1 = acc[:1].contiguous()
    k7_mb_b1 = cuda_ms(lambda: [pk.multi_bit_accumulate_wide_cluster(
        acc1, b, bl, lv) for b in one], 3)
    del one, acc1
    mb_step_ms = cuda_ms(lambda: sk.apply_lookup_table(ct, lut), 2,
                         warmup=False)
    ct1 = ck.encrypt(np.array([7], dtype=np.uint64))
    mb_b1_ms = cuda_ms(lambda: sk.apply_lookup_table(ct1, lut), 5)

    a_bnd = bound(kb.multi_bit_keybundle_pipe_instructions(
        WIDE_MB_BATCH, ng, g, R, lv, N, P),
        keybundle_bytes(WIDE_MB_BATCH, ng, g, R, lv, N, P), rate)
    b_bnd = bound(kb.multi_bit_accumulate_pipe_instructions(
        WIDE_MB_BATCH, ng, R, lv, N, P),
        accumulate_bytes(WIDE_MB_BATCH, ng, R, lv, N, P), rate)
    b_bnd1 = bound(kb.multi_bit_accumulate_pipe_instructions(
        1, ng, R, lv, N, P), accumulate_bytes(1, ng, R, lv, N, P), rate)
    print(f"g4 3_3 B={WIDE_MB_BATCH}: KS->PBS {mb_step_ms:.3f} ms = "
          f"{WIDE_MB_BATCH / mb_step_ms * 1e3:.1f} PBS/s; {len(chunks)} "
          f"chunks of {C} steps: K5a {k5a_ms:.3f} ms (bound {a_bnd[0]:.2f}, "
          f"{a_bnd[1]}), K7 cluster kernel {k7_mb_ms:.3f} ms (bound "
          f"{b_bnd[0]:.2f}, {b_bnd[1]}: {b_bnd[0] / k7_mb_ms:.1%}); batch 1 "
          f"({ng} steps): cluster {k7_mb_b1:.3f} ms; K5a and the cluster "
          f"kernel == plain on {WIDE_PLAIN_CTS} ciphertexts over {G} group "
          f"steps (plain {a_plain:.1f}, {b_plain:.1f} ms); batch 1 KS->PBS "
          f"{mb_b1_ms:.3f} ms; launches {mb_launches}; on {card}")
    common = dict(source=WIDE_SOURCE, replaces=MB_REPLACES,
                  shape=f"g4 3_3 B={WIDE_MB_BATCH} n/g={ng} N={N} l={lv} "
                  f"C={C}", note="no pallas_call: XLA in tfhe_tpu",
                  plain_shape=f"B={WIDE_PLAIN_CTS}, {G} of {ng} group steps")
    rows["multi_bit_accumulate_wide_cluster_g4_3_3"] = dict(
        common, launches=mb_launches["multi_bit_accumulate_wide_cluster"],
        max_abs_err=b_errs["cluster"], ms=k7_mb_ms, plain_ms=b_plain,
        bound=b_bnd, ms_b1=k7_mb_b1, bound_b1_ms=b_bnd1[0],
        kernel="K7's cluster kernel, K5b's function (Barrett MAC against "
               "the bundles), all chunks of the call")
    rows["multi_bit_keybundle_g4_3_3"] = dict(
        common, source=MB_SOURCE,
        launches=mb_launches["multi_bit_keybundle"], max_abs_err=a_err,
        ms=k5a_ms, plain_ms=a_plain, bound=a_bnd,
        plain_shape=f"B={WIDE_PLAIN_CTS}, {G} of {ng} group steps",
        kernel="K5a at N = 8192, l = 2, all chunks of the call")
    summary.update(wide_mb_keygen_s=mb_keygen_s,
                   wide_mb_key_gb=mbk.numel() * 4 / 1e9,
                   wide_mb_pbs_ms=mb_step_ms,
                   wide_mb_pbs_per_s=WIDE_MB_BATCH / mb_step_ms * 1e3,
                   wide_mb_k5a_ms=k5a_ms, wide_mb_k7_ms=k7_mb_ms,
                   wide_mb_k7_b1_ms=k7_mb_b1, wide_mb_ks_pbs_b1_ms=mb_b1_ms)
    del ck, sk, ct, out, acc, mask, body, mbk, ct1, mask8, acc8
    torch.cuda.empty_cache()
    t_part = part_done("b", t_part)

    # d. classic 4_4 on the split; e. the multi-bit split shapes
    wide_global = _wide_split_classic(card, rate, rows, summary)
    t_part = part_done("d", t_part)
    rng = np.random.default_rng(SEED + 24)
    for shape in WIDE_SPLIT_MB:
        g_rows, s = _wide_split_multi_bit(*shape, rate, rows, rng)
        wide_global.update(g_rows)
        summary.update(s)
    t_part = part_done("e", t_part)

    # g, h, i. the 64-bit decomposer; j. the streamed split on real keys
    _wide_deep_classic(card, rate, rows, summary)
    t_part = part_done("g", t_part)
    wide_global.update(_wide_deep_multi_bit(card, rate, rows, summary, rng))
    t_part = part_done("h", t_part)
    for c in WIDE_DEEP_CORNERS:
        _wide_corner(*c, rng, rate, rows)
    t_part = part_done("i", t_part)
    wide_global.update(_wide_stream_classic(card, rate, rows, summary))
    t_part = part_done("j", t_part)

    # f. the corners; K7 global's launches are theirs
    corner = {c[0]: _wide_corner(*c, rng) for c in WIDE_CORNERS}
    for name, row in wide_global.items():
        label = "multi_bit_n32768_l1" if name.startswith("multi_bit") \
            else "classic_n32768_l1"
        wrapper = max((w for w in WIDE_KERNELS["global"]
                       if name.startswith(w + "_")), key=len)
        rows[name] = dict(row, launches=corner[label][wrapper],
                          launches_on=f"corner {label}")
    part_done("f", t_part)
    summary["wide_s"] = time.perf_counter() - t_phase
    summary["wide_part_s"] = parts
    print(f"phase 24: {summary['wide_s']:.1f} s (parts, s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(parts.items()))
          + ")")
    return summary


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
    sk_v5, s = phase_shortint_v5(ck22, rate, rows)
    summary.update(s)
    summary.update(phase_boolean_acc32(bck, bsk, card, rate, rows,
                                       summary["and_ms"]))
    summary.update(phase_shortint_v4_acc32(ck22, sk_crt, rate, rows))
    phase_stacked_env(sk22, *batch22)
    summary.update(phase_kernel_bench(rate, rows))
    summary.update(phase_probes(rows, summary["kernel_bench"]))
    summary.update(phase_integer(ck22, sk22, card, rows))
    summary.update(phase_strings(ck22, sk22, card, rows))
    summary.update(phase_hlapi(card, summary["readme_chain"][1]))
    summary.update(phase_shortint_rest(ck22, sk22, sk_v5, card, rate))
    summary.update(phase_side_modules(ck22, sk22, batch22, card, rate, rows))
    s, g4_keys = phase_multi_bit(card, rate, rows, summary["fheuint_table"])
    summary.update(s)
    summary.update(phase_platform(ck22, sk22, batch22, g4_keys, card,
                                  summary))
    del g4_keys
    summary.update(phase_noise_squashing(ck22, sk22, card))
    summary.update(phase_ntt64(card, rate, rows))
    summary.update(phase_zk(ck22, sk22, card))
    summary.update(phase_mesh_c_api(ck22, sk22, batch22, card, summary,
                                    rows))
    summary.update(phase_wide(card, rate, rows))

    order = ("body_rotate_acc32", "body_rotate_acc32_r1",
             "blind_rotate_bnf2_acc32", "body_rotate_u64",
             "blind_rotate_crt", "blind_rotate_crt_p4",
             "blind_rotate_crt_p4_decompress",
             "blind_rotate_bnf2_u64", "blind_rotate_goldilocks",
             "blind_rotate_ntt64",
             *(f"{row}_{shape}" for shape in MB_SHAPES for row in MB_ROWS
               if row != "blind_rotate_multi_bit_r14" or shape == "g4"),
             "blind_rotate_crt_acc32", "blind_rotate_crt_acc32_p4",
             "blind_rotate_wide_cluster_3_3",
             "blind_rotate_wide_cluster_acc32_3_3",
             "blind_rotate_wide_split_4_4", "blind_rotate_wide_split_acc32_4_4",
             "blind_rotate_wide_4_4", "blind_rotate_wide_acc32_4_4",
             "multi_bit_keybundle_g4_3_3",
             "multi_bit_accumulate_wide_cluster_g4_3_3",
             *(f"multi_bit_accumulate_wide{d}_{label}" for label, *_ in
               WIDE_SPLIT_MB for d in ("_split", "")),
             "blind_rotate_wide_split_4_4_2m64",
             "multi_bit_keybundle_g4_4_4_2m128",
             "multi_bit_accumulate_wide_split_g4_4_4_2m128",
             "multi_bit_accumulate_wide_g4_4_4_2m128",
             *(name for name in rows if name.endswith(tuple(
                 c[0] for c in WIDE_DEEP_CORNERS))),
             "blind_rotate_wide_split_2_6_cpk", "blind_rotate_wide_2_6_cpk",
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
