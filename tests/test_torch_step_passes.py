"""The step kernels' pass schedule (``csrc/ntt_common.cuh``, mirrored on the
CPU by ``tfhe_tpu_torch.ops.step_passes``): the transforms run pass by pass
against ``tfhe_tpu``'s ``NegacyclicNtt``, one CMUX step pass by pass
against the port's fwd -> MAC -> inv chain (``bnf2.cmux_steps``,
``server.cmux_steps_crt``), the swizzle, the schedule, the bank pattern of
every pass and the shared-memory bytes. Tolerance: exact (integer
arithmetic on canonical residues, same seeded inputs)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tfhe_tpu.ops import ntt as jntt

from tfhe_tpu_torch._torus import from_u32, from_u64, to_u64, u32_to_i64
from tfhe_tpu_torch.core import algorithms as algo
from tfhe_tpu_torch.core.entities import LweBootstrapKey
from tfhe_tpu_torch.ops import bnf2 as b2
from tfhe_tpu_torch.ops import ntt
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.ops import step_passes as sp

#: (R, levels, base_log, N) of the two shapes the step kernels run
SHAPES = {"2_2": (2, 1, 23, 2048), "boolean": (4, 2, 7, 512)}


@pytest.mark.parametrize("n", [256, 512, 2048])
@pytest.mark.parametrize("num_primes", [2, 3, 4])
def test_transforms_pass_by_pass_equal_jax(n, num_primes):
    """The forward passes (the twist, <= 4 stages a pass, the fused pass's
    forward stages) give NegacyclicNtt.fwd's DIF order; the inverse passes
    and the untwist give .inv's canonical residues."""
    rng = np.random.default_rng(n * 7 + num_primes)
    jplan = jntt.get_plan(n, num_primes)
    plan = ntt.get_plan(n, num_primes)
    x = rng.integers(0, 1 << 64, size=(3, n), dtype=np.uint64)
    res = torch.stack([ntt.urem(from_u64(x, "cpu"), p) for p in plan.primes])
    want = np.asarray(jax.jit(jplan.fwd)(jnp.asarray(x)))
    np.testing.assert_array_equal(to_u64(sp.fwd_transform(res, plan)), want)

    xhat = np.stack([rng.integers(0, p, size=(3, n), dtype=np.uint64)
                     for p in plan.primes])
    want_i = np.asarray(jax.jit(jplan.inv)(jnp.asarray(xhat)))
    got_i = sp.inv_transform(from_u64(xhat, "cpu"), plan)
    np.testing.assert_array_equal(to_u64(got_i), want_i)


def _crt_key(rng, n, levels, R, N, P, base_log):
    std = from_u64(rng.integers(0, 1 << 64, size=(n, levels, R, R, N),
                                dtype=np.uint64), "cpu")
    return pk.bsk_to_scan_layout(algo.bootstrap_key_to_ntt(
        LweBootstrapKey(std, base_log, levels), P).residues)


@pytest.mark.parametrize("entry,P,shape", [
    ("blind_rotate_bnf2_acc32", 2, "2_2"),
    ("blind_rotate_bnf2_acc32", 2, "boolean"),
    ("blind_rotate_crt", 3, "boolean"),
    ("blind_rotate_crt", 4, "2_2"),
    ("blind_rotate_crt_acc32", 3, "boolean"),
    ("blind_rotate_crt_acc32", 4, "2_2"),
    ("blind_rotate_bnf2_u64", 2, "2_2"),
])
def test_step_pass_by_pass_equals_the_chain(entry, P, shape):
    """Two CMUX steps on the kernels' passes (the lift in the first forward
    pass, the fused MAC written over the digit rows, the tail in the last
    inverse pass) equal the step kernel's plain version, the port's
    fwd -> MAC -> inv chain, on seeded accumulators, masks and keys."""
    R, levels, base_log, N = SHAPES[shape]
    rng = np.random.default_rng(len(entry) * 10 + P)
    B, n = 2, 2
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(B, n)))
    if entry.startswith("blind_rotate_bnf2"):
        std = rng.integers(0, 1 << 64, size=(n, levels, R, R, N),
                           dtype=np.uint64)
        key = b2.bootstrap_key_to_bnf2(from_u64(std, "cpu"), b2.DEFAULT)
    else:
        key = _crt_key(rng, n, levels, R, N, P, base_log)
    if entry.endswith("acc32"):
        acc = from_u32(rng.integers(0, 1 << 32, size=(B, R, N),
                                    dtype=np.uint32), "cpu")
    else:
        acc = from_u64(rng.integers(0, 1 << 64, size=(B, R, N),
                                    dtype=np.uint64), "cpu")
    plain = getattr(pk, f"{entry}_plain")
    want = plain(acc, mask, key, base_log, levels)
    got = sp.cmux_steps_passes(entry, acc, mask, key, base_log, levels)
    assert got.dtype == acc.dtype
    assert torch.equal(got, want)


def test_swizzle_is_a_bijection():
    """swz permutes every aligned 32-word row within itself and keeps each
    4-word chunk whole, so it is a bijection on any digit area."""
    i = torch.arange(1 << 16)
    s = sp.swz(i)
    assert torch.equal(torch.sort(s).values, i)
    assert torch.equal(s >> 5, i >> 5)
    assert torch.equal(s & 3, i & 3)
    assert torch.equal(sp.swz(s), i)  # an involution


@pytest.mark.parametrize("log_n", range(7, 13))
@pytest.mark.parametrize("R", range(1, 9))
def test_pass_plan_runs_every_stage_once(log_n, R):
    """Forward: stages 0 .. L-F-1 in increasing passes of <= 3, the fused
    pass the last F; inverse: the same stages in decreasing passes, the
    last (with the tail) of <= 2."""
    plan = sp.make_pass_plan(log_n, R)
    F = plan.fused
    fwd = [s for s0, k in plan.fwd for s in range(s0, s0 + k)]
    inv = [s for s0, k in plan.inv for s in reversed(range(s0, s0 + k))]
    assert fwd == list(range(log_n - F)) == inv[::-1]
    assert all(1 <= k <= 3 for _, k in plan.fwd + plan.inv)
    assert len(plan.fwd) <= 5 >= len(plan.inv) and plan.inv[-1][1] <= 2


def _warp_banks(words, width: int):
    """Per access of a group of threads, the banks (32 of 4 bytes) its
    ``width``-word accesses touch: [groups, threads * width]."""
    return ((words[..., None] + torch.arange(width)) % 32).reshape(
        words.shape[0], -1)


@pytest.mark.parametrize("shape,P", [("2_2", 2), ("2_2", 4),
                                     ("boolean", 3)])
def test_every_pass_is_bank_conflict_free(shape, P):
    """Each warp's shared-memory accesses in each pass of the step touch 32
    distinct banks: one word a thread at each m in the stage passes, the
    lift and the tail pass; 16 bytes a thread in the fused pass, each
    quarter-warp on 32 distinct banks."""
    R, levels, _, N = SHAPES[shape]
    log_n = N.bit_length() - 1
    plan = sp.make_pass_plan(log_n, R)
    lR = levels * R
    passes = [(s0, k, lR) for s0, k in plan.fwd] + \
             [(s0, k, R) for s0, k in plan.inv]
    for s0, k, rows in passes:
        pos, _, _ = sp.pass_items(log_n, s0, k)
        words = torch.cat([sp._phys([poly], N, pos)[0]
                           for poly in range(rows * P)])   # items in order
        for m in range(1 << k):
            banks = _warp_banks(words[:, m].reshape(-1, 32), 1)
            assert all(len(set(b.tolist())) == 32 for b in banks), (s0, k, m)
    F, E = plan.fused, 1 << plan.fused
    pos = (torch.arange(N >> F) << F)[:, None] + torch.arange(E)
    for row in range(lR):
        words = torch.cat([sp._phys([row * P + pi], N, pos)[0]
                           for pi in range(P)])
        for q in range(0, E, 4):
            groups = words[:, q].reshape(-1, 8 * 4 // min(E, 4))
            width = min(E, 4)
            banks = _warp_banks(groups, width)
            assert all(len(set(b.tolist())) == 32 for b in banks), (row, q)


def test_smem_bytes_formula_gives_the_table():
    """Shared memory per block of the step kernels (acc + digits; the radix-2
    loop also held the MAC rows), in KiB: K1 at 2_2 80 -> 48, K3 P = 4 at
    2_2 160 -> 96, K3 at the boolean set 88 -> 64."""
    table = {"K1 2_2": ((2, 2, 1, 2048, 4), 80, 48),
             "K3 P=4 2_2": ((4, 2, 1, 2048, 8), 160, 96),
             "K3 boolean": ((3, 4, 2, 512, 8), 88, 64)}
    for name, (args, before, after) in table.items():
        assert sp.step_smem_bytes(*args, radix2=True) == before * 1024, name
        assert sp.step_smem_bytes(*args) == after * 1024, name


@pytest.mark.parametrize("kernel", ["K1", "K3_P4"])
def test_probe_pieces_compose_to_the_step(kernel):
    """The step probes' pass pieces (tools/v4_probe.py: lift, fwd, fused,
    inv, tail, each on the kernels' shared-memory image) run in order give
    one CMUX step of the mirror, and the work-floor units of the pieces
    add up to the whole step's."""
    from tfhe_tpu_torch.ops import kernel_bench as kb
    from tfhe_tpu_torch.tools import v4_probe as vp

    entry, P = vp.PASS_KERNELS[kernel]
    x, key, a = vp._pass_inputs(kernel, lambda dev: 2)("cpu")
    y = x
    for piece in sp.PIECES:
        y = vp.pass_piece_plain(y, key, a, 1, piece=piece, kernel=kernel)
    tail = vp._pass_tail(kernel)
    acc, _ = sp.from_image(x, P, 2, 1, vp.N, tail.acc32)
    want = sp.step(acc, a.to(torch.int64), u32_to_i64(key), vp.BASE_LOG,
                   1, tail)
    got, _ = sp.from_image(y, P, 2, 1, vp.N, tail.acc32)
    assert torch.equal(got, want)
    total = {}
    for units in vp.pass_units(kernel).values():
        for k, u in units.items():
            total[k] = total.get(k, 0) + u
    whole = kb.step_pipe_instructions(entry, 1, 1, 2, 1, vp.N, P)
    ops = kb.SASS_OPS[entry if entry in kb.SASS_OPS else f"{entry}/{P}"]
    assert kb.busier_pipe(*(sum(u * ops[k][i] for k, u in total.items())
                            for i in range(3))) == whole
    assert "untwist_tail" in total and total["mac"] == P * 2 * 2 * vp.N


def test_pass_split_adds_up():
    """The new step's split: each pass piece's row is per ciphertext-step;
    their sum and the remainder against the measured step."""
    from tfhe_tpu_torch.tools import v4_probe as vp

    rows = [{"metric": c.name, "ps_per_unit": 1000.0, "card": "c"}
            for c in vp.PASS_CASES]
    k1, k3 = vp.pass_split(rows, {"K1": 1e-7, "K3_P4": 2e-7})
    assert k1["metric"] == "pass_split_K1"
    assert k1["pieces_us"] == {pc: pytest.approx(1e-3) for pc in sp.PIECES}
    assert k1["sum_us"] == pytest.approx(5e-3)
    assert k3["remainder_us"] == pytest.approx(0.2 - 5e-3)


def test_reference_loops_take_plain_versions_on_cpu():
    """The kernel bench's reference loops (the radix-2 step loop, no
    entry point runs them) take K1's and K3's plain versions on CPU
    tensors and count no launch; the bench's step rows come in pairs, the
    step kernel's and its reference's, bounded by the same SASS row."""
    from tfhe_tpu_torch.ops import kernel_bench as kb

    kb.reset_launches()
    rows = list(kb.bench_step(device="cpu")) + list(
        kb.bench_step_v6(device="cpu"))
    assert [r["metric"] for r in rows] == [
        "fused_step", "fused_step_r2", "fused_step_v6", "fused_step_v6_r2"]
    assert all(fn.launches == 0 for fn in kb.STEP_REFERENCES)
    for ref, entry, P in (("kb_step_bnf2_acc32_r2", "blind_rotate_bnf2_acc32",
                           2), ("kb_step_crt_r2", "blind_rotate_crt", 4)):
        assert kb.step_pipe_instructions(ref, 3, 5, 2, 1, 2048, P) == \
            kb.step_pipe_instructions(entry, 3, 5, 2, 1, 2048, P)
    R, levels, base_log, N = SHAPES["2_2"]
    rng = np.random.default_rng(9)
    acc = from_u32(rng.integers(0, 1 << 32, size=(2, R, N),
                                dtype=np.uint32), "cpu")
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(2, 1)))
    std = rng.integers(0, 1 << 64, size=(1, levels, R, R, N),
                       dtype=np.uint64)
    key = b2.bootstrap_key_to_bnf2(from_u64(std, "cpu"), b2.DEFAULT)
    assert torch.equal(
        kb.kb_step_bnf2_acc32_r2(acc, mask, key, base_log, levels),
        pk.blind_rotate_bnf2_acc32_plain(acc, mask, key, base_log, levels))
