"""The CPU mirror of the step kernels' pass schedule (``csrc/ntt_common.cuh``,
``brk::StepPasses``): one CMUX step of K1 and K3 pass by pass, with the
kernels' own index formulas vectorised over the items their threads own;
and K7's two designs (``csrc/blind_rotate_wide.cu``, the last sections:
K7 global's three stages, one polynomial a block on the same passes
through global memory, and the cluster kernel, P R CTAs a ciphertext
exchanging slices, digits, partials and residues over distributed shared
memory, or at split 2, 2 P R CTAs each holding half of every transform,
their levels streamed through one transform buffer where a CTA cannot hold
them all).

The step kernels run each CMUX step as a few shared-memory passes of up to
three NTT stages each, in registers (see the header of ``ntt_common.cuh``):

1. the lift (rotate, subtract, balanced digit, mod p, twist) fused into the
   first forward pass;
2. forward passes of <= 3 stages;
3. the fused pass: the last F forward stages of every digit row, the MAC
   against the GGSW row and the first F inverse stages of each MAC row,
   which is written over digit row c (no MAC buffer);
4. inverse passes of <= 3 stages;
5. the last inverse pass (<= 2 stages) with the untwist (its residues
   stored back over the row), the tail and ``acc +=``.

The digit area is stored swizzled (:func:`swz`). Here the same items, the
same positions, twiddle offsets, in-place writes and swizzled indices are
computed for every item at once, so a wrong offset in the CUDA design
shows on the CPU. This module is a rehearsal of the kernels' schedule and a
plain version of the step probes' pieces (``tools/v4_probe.py``); the plain
versions of K1 and K3 on the main path stay ``bnf2.cmux_steps`` and
``server.cmux_steps_crt``.

State: ``acc`` int64 [B, R, N] (u64 values, or u32 values for the hi-plane
accumulators); ``dig`` int64 [B, l*R*P*N], the swizzled digit area (word
``swz(i)`` holds logical word i of [l*R][P][N]). Tables: the kernels'
``pbs_kernel.plan_tables`` u32 [P, 8, N].
"""

from __future__ import annotations

import dataclasses

import torch

from .._torus import M32, i64_to_u32, srl, u32_to_i64
from . import bnf2 as bnf2_mod
from . import ntt as ntt_mod
from . import pbs_kernel as pk

T_TW, T_TW_SH, T_UTW, T_UTW_SH, T_FWD, T_FWD_SH, T_INV, T_INV_SH = range(8)
MAX_STAGES_PER_PASS = 3


def swz(i):
    """The swizzled shared-memory word of logical word ``i`` of the digit
    area (``brk::swz``): bits 2-4 XOR bits 5-7."""
    return i ^ (((i >> 5) & 7) << 2)


def fused_stages(R: int) -> int:
    """F, the stages of the fused pass: 16 / 2^F MAC rows fit an item's
    registers (``brk::fused_stages``)."""
    return 2 if R <= 4 else 1


@dataclasses.dataclass(frozen=True)
class PassPlan:
    """The passes of one step (``brk::make_pass_plan``): ``fwd`` and ``inv``
    are (first stage, stage count) per pass, the inverse ones run from their
    last stage down; ``fwd[0]`` lifts, ``inv[-1]`` untwists and runs the
    tail."""
    fused: int
    fwd: tuple
    inv: tuple


def _split(lo: int, hi: int, down: bool) -> list:
    """Stages [lo, hi) in ceil((hi - lo) / 3) passes of near-equal size,
    in increasing (or, ``down``, decreasing) stage order."""
    n = hi - lo
    if n <= 0:
        return []
    cnt = -(-n // MAX_STAGES_PER_PASS)
    sizes = [n // cnt + (i < n % cnt) for i in range(cnt)]
    out, s = [], hi if down else lo
    for sz in sizes:
        if down:
            s -= sz
        out.append((s, sz))
        if not down:
            s += sz
    return out


def make_pass_plan(log_n: int, R: int) -> PassPlan:
    """The kernels' schedule at N = 2^log_n and R rows: forward stages
    [0, a) in passes of <= 3, then the mid pass [a, L - F) of
    min(3, L - F - 1) stages, then the fused pass of F; inverse: the mid
    pass, [min(a, 2), a) in passes of <= 3, and last [0, min(a, 2))."""
    F = fused_stages(R)
    rest = log_n - F
    if rest < 1:
        raise ValueError(f"log_n={log_n} leaves no forward pass beside the "
                         f"fused pass of {F} stages")
    mid = min(MAX_STAGES_PER_PASS, rest - 1)
    a = rest - mid
    t = min(a, 2)
    return PassPlan(F, tuple(_split(0, a, False) + _split(a, rest, False)),
                    tuple(_split(a, rest, True) + _split(t, a, True)
                          + _split(0, t, True)))


def step_smem_bytes(P: int, R: int, levels: int, N: int, acc_bytes: int,
                    radix2: bool = False) -> int:
    """Dynamic shared memory of one step-kernel block (``blind_rotate_smem``):
    the accumulator [R][N] and the digits [l R][P][N] u32 (``radix2``: the
    radix-2 reference loop, with the MAC buffer [R][P][N] u32 too)."""
    return (pk.step_smem_formula(P, R, levels, N, acc_bytes)
            + (4 * P * R * N if radix2 else 0))


# ---------------------------------------------------------------------------
# items, stages and the arithmetic of one pass
# ---------------------------------------------------------------------------

def pass_items(log_n: int, s0: int, K: int):
    """Per item g < N >> K of a pass over stages s0 .. s0+K-1: its 2^K
    positions within the polynomial ([G, 2^K]: i0 + m hl, hl = N >> (s0 +
    K), i0 = (g >> log_hl << (log_hl + K)) + j), its j = g mod hl ([G])
    and log2(hl)."""
    log_hl = log_n - s0 - K
    g = torch.arange(1 << (log_n - K))
    j = g & ((1 << log_hl) - 1)
    i0 = ((g >> log_hl) << (log_hl + K)) + j
    return i0[:, None] + (torch.arange(1 << K) << log_hl), j, log_hl


def _add_mod(a, b, p):
    s = a + b
    return torch.where(s >= p, s - p, s)


def _pairs(K: int, t: int):
    """Stage t of a K-stage pass: the lower registers m (bit K-1-t clear),
    their partners and their twiddle index offsets in units of hl."""
    half = 1 << (K - 1 - t)
    lower = torch.tensor([m for m in range(1 << K) if not m & half])
    return lower, lower + half, lower & (half - 1)


def fwd_regs_with(v, tw, N: int, s0: int, K: int, j, log_hl: int, p: int):
    """Forward stages s0 .. s0+K-1 on the registers v [..., G, 2^K] of the
    items (``brk::fwd_regs_with``); tw(jj): twiddles jj and their Shoup
    duals, j: [G]."""
    v = v.clone()
    for t in range(K):
        lower, upper, k = _pairs(K, t)
        w, w_sh = tw((N - (N >> (s0 + t))) + j[:, None] + (k << log_hl))
        u0, u1 = v[..., lower], v[..., upper]
        v[..., lower] = _add_mod(u0, u1, p)
        v[..., upper] = ntt_mod.shoup_mul(u0 - u1 + p, w, w_sh, p)
    return v


def inv_regs_with(v, tw, N: int, s0: int, K: int, j, log_hl: int, p: int):
    """Inverse stages s0+K-1 .. s0 on the registers of the items
    (``brk::inv_regs_with``)."""
    v = v.clone()
    for t in reversed(range(K)):
        lower, upper, k = _pairs(K, t)
        w, w_sh = tw((N - (N >> (s0 + t))) + j[:, None] + (k << log_hl))
        u = v[..., lower]
        bw = ntt_mod.shoup_mul(v[..., upper], w, w_sh, p)
        v[..., lower] = _add_mod(u, bw, p)
        v[..., upper] = _add_mod(u, p - bw, p)
    return v


def fwd_regs(v, tb, N: int, s0: int, K: int, j, log_hl: int, p: int):
    """:func:`fwd_regs_with` on the step's twiddles (``brk::fwd_regs``); tb:
    the prime's int64 [8, N] table."""
    return fwd_regs_with(v, lambda jj: (tb[T_FWD][jj], tb[T_FWD_SH][jj]), N,
                         s0, K, j, log_hl, p)


def inv_regs(v, tb, N: int, s0: int, K: int, j, log_hl: int, p: int):
    """:func:`inv_regs_with` on the step's twiddles (``brk::inv_regs``)."""
    return inv_regs_with(v, lambda jj: (tb[T_INV][jj], tb[T_INV_SH][jj]), N,
                         s0, K, j, log_hl, p)


def _phys(polys, N: int, pos):
    """Swizzled words of positions pos [G, E] of polynomials ``polys``:
    [len(polys), G, E]."""
    return swz(torch.as_tensor(polys)[:, None, None] * N + pos)


def _next_digits(state, base_log: int, levels: int) -> list:
    """The ``levels`` balanced digits of a decomposer's initial state
    (``next``: the arithmetic shift of the signed state), level 0 first."""
    out = []
    for _ in range(levels):
        d = state & ((1 << base_log) - 1)
        state = state >> base_log
        carry = (((d - 1) | state) & d) >> (base_log - 1)
        state = state + carry
        out.append(d - (carry << base_log))
    return out


def hi_digits(hi, base_log: int, levels: int) -> list:
    """The balanced digits of the hi words ``hi`` (int64 in [0, 2^32)),
    level 0 first, formula for formula as ``brk::HiDecomposer``'s ``init``
    and ``next`` compute them in int32 (base_log * levels <= 31)."""
    rep = base_log * levels
    res = hi >> (31 - rep)
    rounding = res & 1
    res = ((res + 1) >> 1) & ((1 << rep) - 1)
    need_bal = (((res - 1) | (rounding << (rep - 1))) & res) >> (rep - 1)
    return _next_digits(res - (need_bal << rep), base_log, levels)


def deep_digits(x, base_log: int, levels: int) -> list:
    """The balanced digits of the whole u64 words ``x`` (int64 bits),
    level 0 first, formula for formula as ``brk::Decomposer64``'s
    ``init_word`` and ``next`` compute them in 64 bits (base_log * levels
    < 64; the kernels run it at 32 and above): the logical shifts of the
    u64 state are ``srl``, the state's shifts arithmetic."""
    rep = base_log * levels
    res = srl(x, 63 - rep)
    rounding = res & 1
    res = srl(res + 1, 1) & ((1 << rep) - 1)
    need_bal = srl(((res - 1) | (rounding << (rep - 1))) & res, rep - 1)
    return _next_digits(res - (need_bal << rep), base_log, levels)


def lift_digits(v, base_log: int, levels: int, acc32: bool) -> list:
    """The digits a lift takes of the accumulator words ``v`` (a rotated
    difference, or acc itself; u32 values of the hi plane when ``acc32``):
    :func:`hi_digits` of the hi word at base_log * levels <= 31, else
    :func:`deep_digits` of the whole u64 word (the u64 accumulator's
    ``GarnerTailDeep`` instantiations; the hi plane has no such kernel)."""
    if base_log * levels <= pk.HI_WORD_MAX_BL:
        return hi_digits(v & M32 if acc32 else srl(v, 32), base_log, levels)
    if acc32:
        raise ValueError(f"base_log * levels = {base_log * levels}: the hi "
                         "plane's kernels decompose the hi word (<= 31)")
    return deep_digits(v, base_log, levels)


# ---------------------------------------------------------------------------
# the tails (the specs each CUDA tail reproduces)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Tail:
    """A recombination tail: ``kind`` garner (u64 acc), garner32 (u32 hi
    plane, rounded), bnf2 (u64) or bnf2_32 (u32), over ``plan``'s primes;
    ``flavor`` for the BNF2 tails."""
    kind: str
    plan: ntt_mod.NegacyclicNtt
    flavor: bnf2_mod.Bnf2Flavor = None

    @property
    def acc32(self) -> bool:
        return self.kind in ("garner32", "bnf2_32")

    def __call__(self, res):
        """The increment of the canonical residues res [P, ...]."""
        if self.kind == "garner":
            return self.plan.reconstruct_u64(res)
        if self.kind == "garner32":
            return srl(self.plan.reconstruct_u64(res) + (1 << 31), 32)
        if self.kind == "bnf2":
            return bnf2_mod.qp_to_torus(
                bnf2_mod.crt2_merge(res[0], res[1], self.flavor), self.flavor)
        return bnf2_mod.qp_to_torus32(res[0], res[1], self.flavor)


def tail_of(entry: str, P: int, N: int, flavor=None) -> Tail:
    """The tail of step-kernel entry ``entry`` at P primes."""
    fl = flavor or bnf2_mod.DEFAULT
    if entry == "blind_rotate_bnf2_acc32":
        return Tail("bnf2_32", fl.plan(N), fl)
    if entry == "blind_rotate_bnf2_u64":
        return Tail("bnf2", fl.plan(N), fl)
    kind = "garner32" if entry == "blind_rotate_crt_acc32" else "garner"
    return Tail(kind, ntt_mod.get_plan(N, P))


def tables_of(tail: Tail) -> torch.Tensor:
    """The kernels' table of the tail's plan as int64 [P, 8, N]."""
    return u32_to_i64(torch.from_numpy(pk.plan_tables(tail.plan).view(
        "int32")))


# ---------------------------------------------------------------------------
# the passes
# ---------------------------------------------------------------------------

def lift_pass(acc, dig, a, K: int, R: int, levels: int, base_log: int,
              tail: Tail, tables):
    """The first forward pass (stages 0 .. K-1) fused with the lift
    (``StepPasses::lift_pass``): digit row j = lev R + r, prime pi, at each
    position t of each item: the balanced digit ``lev`` of the hi word of
    acc[r] X^a - acc[r] at t, lifted mod p and twisted, then the K stages.
    ``a``: [B] in [0, 2N). Returns the new digit area."""
    B, _, N = acc.shape
    log_n = N.bit_length() - 1
    P = tail.plan.num_primes
    pos, j, log_hl = pass_items(log_n, 0, K)
    s = pos[None] - a.to(torch.int64)[:, None, None]           # [B, G, E]
    s = torch.where(s < 0, s + 2 * N, s)
    neg = s >= N
    s = torch.where(neg, s - N, s)
    dig = dig.clone()
    for r in range(R):
        row = acc[:, r]
        x = torch.gather(row, 1, s.reshape(B, -1)).reshape(s.shape)
        x = torch.where(neg, -x, x)
        diff = x - row[:, pos]
        for lev, d in enumerate(lift_digits(diff, base_log, levels,
                                            tail.acc32)):
            for pi, p in enumerate(tail.plan.primes):
                tb = tables[pi]
                m = torch.where(d < 0, d + p, d)
                v = ntt_mod.shoup_mul(m, tb[T_TW][pos], tb[T_TW_SH][pos], p)
                v = fwd_regs(v, tb, N, 0, K, j, log_hl, p)
                dig[:, _phys([(lev * R + r) * P + pi], N, pos)[0]] = v
    return dig


def pass_(dig, n_rows: int, P: int, N: int, s0: int, K: int, inverse: bool,
          tables, primes):
    """Forward or inverse stages s0 .. s0+K-1 of rows 0 .. n_rows-1 of the
    digit area (``StepPasses::pass``). Returns the new digit area."""
    log_n = N.bit_length() - 1
    pos, j, log_hl = pass_items(log_n, s0, K)
    run = inv_regs if inverse else fwd_regs
    dig = dig.clone()
    for pi, p in enumerate(primes):
        ph = _phys([row * P + pi for row in range(n_rows)], N, pos)
        dig[:, ph] = run(dig[:, ph], tables[pi], N, s0, K, j, log_hl, p)
    return dig


def fused_pass(dig, key, F: int, R: int, lR: int, P: int, N: int, tables,
               primes):
    """The fused pass (``StepPasses::fused_pass``): item (pi, g) holds
    positions g 2^F .. g 2^F + 2^F - 1; per digit row j the last F forward
    stages, mac[c] += dig[j] key[j][c] mod p (Shoup, j in order), then the
    first F inverse stages of each mac[c], written over digit row c.
    ``key``: the step's int64 [2, P, l R, R, N] (residues, duals)."""
    log_n = N.bit_length() - 1
    s0, E = log_n - F, 1 << F
    pos = (torch.arange(N >> F) << F)[:, None] + torch.arange(E)
    zero = torch.zeros(N >> F, dtype=torch.int64)
    out = dig.clone()
    for pi, p in enumerate(primes):
        tb = tables[pi]
        mac = [torch.zeros(dig.shape[0], N >> F, E, dtype=torch.int64)
               for _ in range(R)]
        for jrow in range(lR):
            d = fwd_regs(dig[:, _phys([jrow * P + pi], N, pos)[0]], tb, N, s0,
                         F, zero, 0, p)
            for c in range(R):
                prod = ntt_mod.shoup_mul(d, key[0, pi, jrow, c][pos],
                                         key[1, pi, jrow, c][pos], p)
                mac[c] = _add_mod(mac[c], prod, p)
        for c in range(R):
            out[:, _phys([c * P + pi], N, pos)[0]] = inv_regs(
                mac[c], tb, N, s0, F, zero, 0, p)
    return out


def tail_pass(acc, dig, K: int, tail: Tail, tables):
    """The last inverse pass (stages K-1 .. 0) with the untwist, the tail
    and acc += (``StepPasses::tail_pass``): item (c, g) holds positions
    g + m (N >> K) of row c for every prime and adds the tail of each
    position's P canonical residues to acc; with five primes or more the
    residues are stored back over the row first. Returns the new (acc,
    dig)."""
    B, R, N = acc.shape
    log_n = N.bit_length() - 1
    P = tail.plan.num_primes
    pos, j, log_hl = pass_items(log_n, 0, K)
    acc, dig = acc.clone(), dig.clone()
    for c in range(R):
        res = []
        for pi, p in enumerate(tail.plan.primes):
            tb = tables[pi]
            ph = _phys([c * P + pi], N, pos)[0]
            v = inv_regs(dig[:, ph], tb, N, 0, K, j, log_hl, p)
            res.append(ntt_mod.shoup_mul(v, tb[T_UTW][pos],
                                         tb[T_UTW_SH][pos], p))
            if P >= 5:
                dig[:, ph] = res[-1]
        new = acc[:, c, pos] + tail(torch.stack(res))
        acc[:, c, pos] = new & M32 if tail.acc32 else new
    return acc, dig


def step(acc, a, key, base_log: int, levels: int, tail: Tail, tables=None,
         plan: PassPlan = None):
    """One CMUX step pass by pass (``StepPasses::step``): acc int64
    [B, R, N], a [B] in [0, 2N), key int64 [2, P, l R, R, N]. Returns the
    new acc."""
    B, R, N = acc.shape
    P, primes = tail.plan.num_primes, tail.plan.primes
    tables = tables_of(tail) if tables is None else tables
    plan = plan or make_pass_plan(N.bit_length() - 1, R)
    lR = levels * R
    dig = torch.zeros(B, lR * P * N, dtype=torch.int64)
    dig = lift_pass(acc, dig, a, plan.fwd[0][1], R, levels, base_log, tail,
                    tables)
    for s0, k in plan.fwd[1:]:
        dig = pass_(dig, lR, P, N, s0, k, False, tables, primes)
    dig = fused_pass(dig, key, plan.fused, R, lR, P, N, tables, primes)
    for s0, k in plan.inv[:-1]:
        dig = pass_(dig, R, P, N, s0, k, True, tables, primes)
    return tail_pass(acc, dig, plan.inv[-1][1], tail, tables)[0]


def cmux_steps_passes(entry: str, acc, msed_mask, bsk_scan, base_log: int,
                      levels: int, flavor=None):
    """All n steps of step-kernel ``entry`` (``blind_rotate_bnf2_acc32``,
    ``blind_rotate_crt``, ``blind_rotate_crt_acc32`` or
    ``blind_rotate_bnf2_u64``) on the pass schedule, with the operands of
    its wrapper in ``pbs_kernel``: acc int64 (u64) or int32 (u32 hi plane)
    [B, R, N], msed_mask [B, n], bsk_scan int32 [n, 2, P, l R, R, N].
    Returns the accumulator in the operand's dtype."""
    P, N = bsk_scan.shape[2], acc.shape[-1]
    tail = tail_of(entry, P, N, flavor)
    tables = tables_of(tail)
    plan = make_pass_plan(N.bit_length() - 1, acc.shape[1])
    x = u32_to_i64(acc) if tail.acc32 else acc
    key = u32_to_i64(bsk_scan)
    for i in range(bsk_scan.shape[0]):
        x = step(x, msed_mask[:, i], key[i], base_log, levels, tail, tables,
                 plan)
    return i64_to_u32(x) if tail.acc32 else x


# ---------------------------------------------------------------------------
# the transforms alone, on the same passes
# ---------------------------------------------------------------------------

def fwd_transform(res, plan: ntt_mod.NegacyclicNtt):
    """The forward negacyclic transform of canonical residues res
    [P, M, N] on the kernels' passes: the twist, the forward passes and the
    forward stages of the fused pass, through the swizzled area. Returns
    [P, M, N] in DIF order (``NegacyclicNtt.fwd``'s)."""
    P, M, N = res.shape
    tables = u32_to_i64(torch.from_numpy(pk.plan_tables(plan).view("int32")))
    sched = make_pass_plan(N.bit_length() - 1, 2)
    tw = torch.stack([ntt_mod.shoup_mul(res[pi], tables[pi][T_TW],
                                        tables[pi][T_TW_SH], plan.primes[pi])
                      for pi in range(P)])
    dig = torch.zeros(1, M * P * N, dtype=torch.int64)
    dig[0, swz(torch.arange(M * P * N))] = tw.permute(1, 0, 2).reshape(-1)
    s_fused = N.bit_length() - 1 - sched.fused
    for s0, k in sched.fwd + ((s_fused, sched.fused),):
        dig = pass_(dig, M, P, N, s0, k, False, tables, plan.primes)
    return dig[0, swz(torch.arange(M * P * N))].reshape(M, P, N).permute(
        1, 0, 2)


def inv_transform(xhat, plan: ntt_mod.NegacyclicNtt):
    """The inverse transform and untwist of DIF-order residues xhat
    [P, M, N] on the kernels' passes (the inverse stages of the fused pass,
    the inverse passes, the last one's untwist). Returns canonical residues
    [P, M, N] (``NegacyclicNtt.inv``'s)."""
    P, M, N = xhat.shape
    tables = u32_to_i64(torch.from_numpy(pk.plan_tables(plan).view("int32")))
    sched = make_pass_plan(N.bit_length() - 1, 2)
    dig = torch.zeros(1, M * P * N, dtype=torch.int64)
    dig[0, swz(torch.arange(M * P * N))] = xhat.permute(1, 0, 2).reshape(-1)
    s_fused = N.bit_length() - 1 - sched.fused
    for s0, k in ((s_fused, sched.fused),) + sched.inv:
        dig = pass_(dig, M, P, N, s0, k, True, tables, plan.primes)
    r = dig[0, swz(torch.arange(M * P * N))].reshape(M, P, N).permute(1, 0, 2)
    return torch.stack([ntt_mod.shoup_mul(r[pi], tables[pi][T_UTW],
                                          tables[pi][T_UTW_SH],
                                          plan.primes[pi])
                        for pi in range(P)])


# ---------------------------------------------------------------------------
# the step's pieces on the kernels' shared-memory image (the step probes)
# ---------------------------------------------------------------------------

#: the pieces of one step, in order: the lift with the first forward pass,
#: the other forward passes, the fused pass, the inverse passes but the
#: last, the last with the untwist and the tail (``v4_pass_piece``)
PIECES = ("lift", "fwd", "fused", "inv", "tail")


def from_image(x, P: int, R: int, levels: int, N: int, acc32: bool):
    """A block image int32 [B, words] (u32 storage, acc's u64 words lo
    first) -> (acc int64 [B, R, N], dig int64 [B, l R P N])."""
    w = u32_to_i64(x)
    n_acc = R * N * (1 if acc32 else 2)
    acc = w[:, :n_acc]
    if not acc32:
        acc = acc[:, 0::2] | (acc[:, 1::2] << 32)
    return acc.reshape(-1, R, N), w[:, n_acc:]


def to_image(acc, dig, acc32: bool):
    """The inverse of :func:`from_image`."""
    a = acc.reshape(acc.shape[0], -1)
    if not acc32:
        a = torch.stack([a & M32, srl(a, 32)], dim=-1).reshape(a.shape[0], -1)
    return i64_to_u32(torch.cat([a, dig], dim=1))


def run_piece(piece: str, acc, dig, a, key, base_log: int, levels: int,
              tail: Tail, tables, plan: PassPlan):
    """One piece of :func:`step` on the state (acc, dig); returns the new
    (acc, dig). ``key`` int64 [2, P, l R, R, N]."""
    R, N = acc.shape[1], acc.shape[2]
    P, primes = tail.plan.num_primes, tail.plan.primes
    if piece == "lift":
        return acc, lift_pass(acc, dig, a, plan.fwd[0][1], R, levels,
                              base_log, tail, tables)
    if piece == "fwd":
        for s0, k in plan.fwd[1:]:
            dig = pass_(dig, levels * R, P, N, s0, k, False, tables, primes)
        return acc, dig
    if piece == "fused":
        return acc, fused_pass(dig, key, plan.fused, R, levels * R, P, N,
                               tables, primes)
    if piece == "inv":
        for s0, k in plan.inv[:-1]:
            dig = pass_(dig, R, P, N, s0, k, True, tables, primes)
        return acc, dig
    return tail_pass(acc, dig, plan.inv[-1][1], tail, tables)


# ---------------------------------------------------------------------------
# K7 (csrc/blind_rotate_wide.cu): the step's three stages through global
# memory, one polynomial a block
# ---------------------------------------------------------------------------

def wide_plan(log_n: int) -> tuple:
    """K7's passes (``make_wide_plan``): the forward transform, stages [0,
    log_n) in passes of <= 3 (no lift fused: K7a lifts in its own loop),
    and the inverse, stages log_n - 1 .. 0 likewise; (fwd, inv) as
    (first stage, stage count) pairs."""
    return tuple(_split(0, log_n, False)), tuple(_split(0, log_n, True))


def _one_poly_passes(x, passes, inverse: bool, N: int, tb, p: int):
    """``passes`` of one polynomial's swizzled area x [B, N] (a K7 block
    of each ciphertext: ``StepPasses<OnePrime>::pass``, P = 1)."""
    for s0, k in passes:
        x = pass_(x, 1, 1, N, s0, k, inverse, tb[None], [p])
    return x


def wide_decompose(acc, a, base_log: int, levels: int, tail: Tail, tables,
                   rotate: bool = True):
    """K7a (``wide_decompose_kernel``) for every block (b, j = lev R + r,
    pi): at each position t the balanced digit ``lev`` of the hi word of
    acc[r] X^a - acc[r] (``rotate``; else of acc[r] itself), lifted mod p
    and twisted into the swizzled area, the forward passes, and the area
    read back in natural order. ``a``: [B] in [0, 2N) (ignored without
    ``rotate``). Returns digits int64 [B, l R, P, N]."""
    B, R, N = acc.shape
    log_n = N.bit_length() - 1
    P = tail.plan.num_primes
    fwd, _ = wide_plan(log_n)
    t = torch.arange(N)
    phys = swz(t)
    out = torch.zeros(B, levels * R, P, N, dtype=torch.int64)
    for r in range(R):
        row = acc[:, r]
        v = row
        if rotate:
            s = t[None] - a.to(torch.int64)[:, None]
            s = torch.where(s < 0, s + 2 * N, s)
            neg = s >= N
            s = torch.where(neg, s - N, s)
            y = torch.gather(row, 1, s)
            v = torch.where(neg, -y, y) - row
        for lev, d in enumerate(lift_digits(v, base_log, levels,
                                            tail.acc32)):
            for pi, p in enumerate(tail.plan.primes):
                tb = tables[pi]
                m = torch.where(d < 0, d + p, d)
                x = torch.zeros(B, N, dtype=torch.int64)
                x[:, phys] = ntt_mod.shoup_mul(m, tb[T_TW], tb[T_TW_SH], p)
                x = _one_poly_passes(x, fwd, False, N, tb, p)
                out[:, lev * R + r, pi] = x[:, phys]
    return out


def wide_mac(digits, key, R: int, tail: Tail, tables, bundle: bool = False):
    """K7b (``wide_mac_kernel``) for every block (b, c, pi): at each
    position t, sum_j digits[j] key[j][c] mod p (add_mod in j order), a
    Shoup product against the duals (``key``: the step's int64 [2, P, l R,
    R, N]) or, ``bundle``, a product mod p against the ciphertext's bundle
    (``key``: int64 [B, P, l R, R, N]); stored swizzled, the inverse
    passes, then the untwist in natural order. Returns canonical residues
    int64 [B, R, P, N]."""
    B, lR, P, N = digits.shape
    log_n = N.bit_length() - 1
    _, inv = wide_plan(log_n)
    phys = swz(torch.arange(N))
    out = torch.zeros(B, R, P, N, dtype=torch.int64)
    for c in range(R):
        for pi, p in enumerate(tail.plan.primes):
            tb = tables[pi]
            s = torch.zeros(B, N, dtype=torch.int64)
            for j in range(lR):
                d = digits[:, j, pi]
                if bundle:
                    prod = (d * key[:, pi, j, c]) % p
                else:
                    prod = ntt_mod.shoup_mul(d, key[0, pi, j, c],
                                             key[1, pi, j, c], p)
                s = _add_mod(s, prod, p)
            x = torch.zeros(B, N, dtype=torch.int64)
            x[:, phys] = s
            x = _one_poly_passes(x, inv, True, N, tb, p)
            out[:, c, pi] = ntt_mod.shoup_mul(x[:, phys], tb[T_UTW],
                                              tb[T_UTW_SH], p)
    return out


def wide_garner(acc, res, tail: Tail, replace: bool = False):
    """K7c (``wide_garner_kernel``): the tail of each coefficient's P
    residues (``res`` [B, R, P, N]) added to acc (wrapping at 2^32 for the
    hi plane) or, ``replace``, in its place."""
    v = tail(res.movedim(2, 0))
    new = v if replace else acc + v
    return new & M32 if tail.acc32 else new


def cmux_steps_wide(entry: str, acc, msed_mask, bsk_scan, base_log: int,
                    levels: int):
    """All n steps of K7's classic entries on its stages (``entry``:
    ``blind_rotate_crt`` for the u64 accumulator, ``blind_rotate_crt_acc32``
    for the u32 hi plane), with the operands of K3's wrapper: acc int64 or
    int32 [B, R, N], msed_mask [B, n], bsk_scan int32 [n, 2, P, l R, R, N].
    Returns the accumulator in the operand's dtype."""
    P, N = bsk_scan.shape[2], acc.shape[-1]
    tail = tail_of(entry, P, N)
    tables = tables_of(tail)
    x = u32_to_i64(acc) if tail.acc32 else acc
    R = acc.shape[1]
    for i in range(bsk_scan.shape[0]):
        dig = wide_decompose(x, msed_mask[:, i], base_log, levels, tail,
                             tables)
        res = wide_mac(dig, u32_to_i64(bsk_scan[i]), R, tail, tables)
        x = wide_garner(x, res, tail)
    return i64_to_u32(x) if tail.acc32 else x


def multi_bit_accumulate_wide(acc, bundles, base_log: int, levels: int):
    """K7's multi-bit entry on its stages: the ``count`` steps of
    ``bundles`` int32 [B, count, P, l R, R, N] on acc int64 [B, R, N] (the
    digits of acc itself, a product mod p against the bundle, the Garner
    value replacing acc). Returns int64 [B, R, N]."""
    B, count, P = bundles.shape[:3]
    R, N = acc.shape[1:]
    tail = Tail("garner", ntt_mod.get_plan(N, P))
    tables = tables_of(tail)
    zero = torch.zeros(B, dtype=torch.int64)
    for tt in range(count):
        dig = wide_decompose(acc, zero, base_log, levels, tail, tables,
                             rotate=False)
        res = wide_mac(dig, u32_to_i64(bundles[:, tt]), R, tail, tables,
                       bundle=True)
        acc = wide_garner(acc, res, tail, replace=True)
    return acc


# ---------------------------------------------------------------------------
# K7's cluster kernel (csrc/blind_rotate_wide.cu, wide_cluster_kernel): a
# cluster of H P R CTAs a ciphertext, its state in distributed shared
# memory (H = 2, the split: each CTA holds half of every transform, the
# accumulator stays in global memory)
# ---------------------------------------------------------------------------

def cluster_smem_bytes(P: int, R: int, levels: int, N: int,
                       acc_bytes: int, split: int = 1) -> int:
    """Dynamic shared memory of one CTA of the cluster kernel
    (``cluster_smem``). Split 1: the digit area [max(l, R)][N] u32, the
    accumulator slice [S] and its digits [l][S] i32, S = 2^ceil(log2(N /
    P)); split 2: ``pk.split_area`` of the instantiation the shape takes
    (``pk.split_streams``, ``pk.split_digit_bytes``)."""
    if split == 2:
        return pk.split_area(P, R, levels, N,
                             pk.split_streams(P, R, levels, N),
                             pk.split_digit_bytes(P, R, levels, N))
    S = 1 << cluster_log_slice(N, P, split)
    return max(levels, R) * N * 4 + S * acc_bytes + levels * S * 4


def cluster_log_slice(N: int, P: int, split: int = 1) -> int:
    """log2 S (``cluster_log_slice``): log_n - floor(log2 P), two less at
    split 2 (S pairs (t, t + N/2) a CTA)."""
    f = 0
    while (2 << f) <= P:
        f += 1
    return N.bit_length() - 1 - f - 2 * (split - 1)


def cluster_plan(log_n: int, split: int = 1) -> tuple:
    """The cluster kernel's passes (``make_cluster_plan``): forward stages
    [0, log_n - 2) in passes of <= 3 (the first lifts), then [log_n - 2,
    log_n) with the MAC; inverse [log_n - 2, log_n) with the sum of the
    partials, then stages log_n - 3 .. 0 in passes of <= 3 (the last
    untwists); (fwd, inv) as (first stage, stage count) pairs. Split 2
    (``make_split_plan``): the lift runs stages 0 .. 3, the half's passes
    [4, log_n - 2), and the inverse passes end at stage 1 (stage 0 and the
    untwist are phase D's)."""
    top = (log_n - 2, 2)
    if split == 2:
        return (((0, 4),) + tuple(_split(4, log_n - 2, False)) + (top,),
                (top,) + tuple(_split(1, log_n - 2, True)))
    return (tuple(_split(0, log_n - 2, False)) + (top,),
            (top,) + tuple(_split(0, log_n - 2, True)))


def cluster_ranks(P: int, R: int) -> list:
    """(pi, r) of each rank of a half of the cluster: rank = r P + pi."""
    return [(rank % P, rank // P) for rank in range(P * R)]


def cluster_rank(h: int, pi: int, r: int, P: int, R: int) -> int:
    """The kernel's rank of CTA (h, pi, r): h P R + r P + pi."""
    return h * P * R + r * P + pi


def cluster_slice(N: int, P: int, pi: int, split: int = 1) -> tuple:
    """(base, len) of slice ``pi`` (split 2: o = h P + pi): positions [pi
    S, pi S + S) within [0, N), empty past N; split 2: the pairs (t, t +
    N/2), t in [o S, o S + S) within [0, N/2)."""
    log_s = cluster_log_slice(N, P, split)
    base = pi << log_s
    return base, max(0, min(1 << log_s, N // split - base))


def _cluster_steps(x, count: int, levels: int, base_log: int, tail: Tail,
                   a_of, key_of, bundle: bool):
    """The cluster kernel's step loop on acc x int64 [B, R, N] (u64, or u32
    values for the hi plane): ``count`` steps, step i rotating by
    ``a_of(i)`` [B] (classic; None: multi-bit, the digits of acc itself)
    against ``key_of(i)`` (the step's int64 [2, P, l R, R, N], or the
    bundles [B, P, l R, R, N]). Each CTA's shared memory is its own tensor
    and every read of another CTA's goes through the rank the kernel
    computes."""
    B, R, N = x.shape
    P, primes = tail.plan.num_primes, tail.plan.primes
    tables = tables_of(tail)
    log_n = N.bit_length() - 1
    log_s = cluster_log_slice(N, P)
    S = 1 << log_s
    D = max(levels, R)
    fwd, inv = cluster_plan(log_n)
    ranks = cluster_ranks(P, R)
    acc = [torch.zeros(B, S, dtype=torch.int64) for _ in ranks]
    dig = [torch.zeros(B, D * N, dtype=torch.int64) for _ in ranks]
    dsl = [torch.zeros(B, levels * S, dtype=torch.int64) for _ in ranks]
    for rank, (pi, r) in enumerate(ranks):
        base, ln = cluster_slice(N, P, pi)
        acc[rank][:, :ln] = x[:, r, base:base + ln]
    for i in range(count):
        # A. the digits of each slice
        for rank, (pi, r) in enumerate(ranks):
            base, ln = cluster_slice(N, P, pi)
            u = torch.arange(ln)
            v = acc[rank][:, u]
            if a_of is not None:
                s = base + u[None] - a_of(i).to(torch.int64)[:, None]
                s = torch.where(s < 0, s + 2 * N, s)
                neg = s >= N
                s = torch.where(neg, s - N, s)
                o = s >> log_s
                owners = torch.stack([acc[r * P + q] for q in range(P)], 1)
                y = owners[torch.arange(B)[:, None], o, s - (o << log_s)]
                v = torch.where(neg, -y, y) - v
            for lev, d in enumerate(lift_digits(v, base_log, levels,
                                                tail.acc32)):
                dsl[rank][:, (lev << log_s) + u] = d
        # B. the lift with the first forward pass, the forward passes, the
        # last two forward stages with the MAC
        for rank, (pi, r) in enumerate(ranks):
            p, tb = primes[pi], tables[pi]
            K = fwd[0][1]
            pos, j, log_hl = pass_items(log_n, 0, K)
            o = pos >> log_s
            owners = torch.stack([dsl[r * P + q] for q in range(P)], 1)
            for lev in range(levels):
                d = owners[:, o, (lev << log_s) + pos - (o << log_s)]
                m = torch.where(d < 0, d + p, d)
                w = ntt_mod.shoup_mul(m, tb[T_TW][pos], tb[T_TW_SH][pos], p)
                dig[rank][:, swz(lev * N + pos)] = fwd_regs(
                    w, tb, N, 0, K, j, log_hl, p)
            for s0, k in fwd[1:-1]:
                dig[rank] = pass_(dig[rank], levels, 1, N, s0, k, False,
                                  tb[None], [p])
        _cluster_mac(dig, key_of(i), ranks, 0, levels, R, N, N, tables,
                     primes, bundle)
        # C. the partials of row r summed across CTAs (pi, .), the inverse
        # passes, the untwist
        _cluster_sum(dig, ranks, 0, R, P, N, N, tables, primes)
        for rank, (pi, r) in enumerate(ranks):
            p, tb = primes[pi], tables[pi]
            row = dig[rank][:, r * N:(r + 1) * N]
            for s0, k in inv[1:-1]:
                row = pass_(row, 1, 1, N, s0, k, True, tb[None], [p])
            K = inv[-1][1]
            pos, j, log_hl = pass_items(log_n, 0, K)
            w = inv_regs(row[:, swz(pos)], tb, N, 0, K, j, log_hl, p)
            row[:, swz(pos)] = ntt_mod.shoup_mul(w, tb[T_UTW][pos],
                                                 tb[T_UTW_SH][pos], p)
            dig[rank][:, r * N:(r + 1) * N] = row
        # D. Garner on each slice, its residues gathered from CTAs (., r)
        for rank, (pi, r) in enumerate(ranks):
            base, ln = cluster_slice(N, P, pi)
            ph = swz(r * N + base + torch.arange(ln))
            inc = tail(torch.stack([dig[r * P + q][:, ph] for q in range(P)]))
            new = inc if bundle else acc[rank][:, :ln] + inc
            acc[rank][:, :ln] = new & M32 if tail.acc32 else new
    out = x.clone()
    for rank, (pi, r) in enumerate(ranks):
        base, ln = cluster_slice(N, P, pi)
        out[:, r, base:base + ln] = acc[rank][:, :ln]
    return out


def _cluster_mac(dig, key, ranks, h: int, levels: int, R: int, N: int,
                 M: int, tables, primes, bundle: bool):
    """B's last two forward stages and the MAC (``cluster_mac``) on each
    CTA (h, pi, r) of ``ranks`` (its digit area [.][M], M = N or, split,
    N/2 from position h M on): per item of 4 positions and digit level, the
    two stages, the products against the key row lev R + r, the R partials
    written over the CTA's rows c."""
    pos4 = (torch.arange(M >> 2) << 2)[:, None] + torch.arange(4)
    zero = torch.zeros(M >> 2, dtype=torch.int64)
    log_n = N.bit_length() - 1
    for rank, (pi, r) in enumerate(ranks):
        p, tb = primes[pi], tables[pi]
        d_ = dig[rank]
        kpos = h * M + pos4
        mac = [torch.zeros(d_.shape[0], M >> 2, 4, dtype=torch.int64)
               for _ in range(R)]
        for lev in range(levels):
            d = fwd_regs(d_[:, swz(lev * M + pos4)], tb, N, log_n - 2, 2,
                         zero, 0, p)
            jrow = lev * R + r
            for c in range(R):
                if bundle:
                    prod = (d * key[:, pi, jrow, c][:, kpos]) % p
                else:
                    prod = ntt_mod.shoup_mul(d, key[0, pi, jrow, c][kpos],
                                             key[1, pi, jrow, c][kpos], p)
                mac[c] = _add_mod(mac[c], prod, p)
        for c in range(R):
            d_[:, swz(c * M + pos4)] = mac[c]


def _cluster_sum(dig, ranks, h: int, R: int, P: int, N: int, M: int,
                 tables, primes):
    """C's first inverse pass (``cluster_sum``) on each CTA (h, pi, r) of
    ``ranks``: its row r plus row r of CTAs (h, pi, q), q != r, read through
    the kernel's rank, then the first two inverse stages."""
    pos4 = (torch.arange(M >> 2) << 2)[:, None] + torch.arange(4)
    zero = torch.zeros(M >> 2, dtype=torch.int64)
    log_n = N.bit_length() - 1
    base = cluster_rank(h, 0, 0, P, R)
    for rank, (pi, r) in enumerate(ranks):
        p, tb = primes[pi], tables[pi]
        ph = swz(r * M + pos4)
        v = dig[base + rank][:, ph]
        for q in range(R):
            if q != r:
                v = _add_mod(v, dig[cluster_rank(h, pi, q, P, R)][:, ph], p)
        dig[base + rank][:, ph] = inv_regs(v, tb, N, log_n - 2, 2, zero, 0, p)


def _half_pass(x, rows, N: int, s0: int, K: int, inverse: bool, tb,
               p: int):
    """Split 2: stages s0 .. s0+K-1 (s0 >= 1) of ``rows`` of a CTA's half
    [.][N/2], swizzled as one area (``half_pass``): the items of a pass
    over N/2 positions, the N-long tables' twiddles. Returns the new
    area."""
    log_n = N.bit_length() - 1
    pos, j, log_hl = pass_items(log_n - 1, s0 - 1, K)
    run = inv_regs if inverse else fwd_regs
    x = x.clone()
    ph = _phys(list(rows), N // 2, pos)
    x[:, ph] = run(x[:, ph], tb, N, s0, K, j, log_hl, p)
    return x


def _stream_mac(d_, key, pi: int, r: int, h: int, lev: int, levels: int,
                R: int, N: int, tb, p: int, bundle: bool):
    """The streamed split's B for digit level ``lev`` (``stream_mac``) on
    one CTA's area ``d_`` [B, (R + 1) M]: per item of 4 positions the last
    two forward stages of the transform in row R, the products against key
    row lev R + r, written (lev = 0) or added mod p into the partial, row
    c."""
    M = N // 2
    log_n = N.bit_length() - 1
    pos4 = (torch.arange(M >> 2) << 2)[:, None] + torch.arange(4)
    zero = torch.zeros(M >> 2, dtype=torch.int64)
    d = fwd_regs(d_[:, swz(R * M + pos4)], tb, N, log_n - 2, 2, zero, 0, p)
    kpos = h * M + pos4
    jrow = lev * R + r
    for c in range(R):
        if bundle:
            prod = (d * key[:, pi, jrow, c][:, kpos]) % p
        else:
            prod = ntt_mod.shoup_mul(d, key[0, pi, jrow, c][kpos],
                                     key[1, pi, jrow, c][kpos], p)
        ph = swz(c * M + pos4)
        d_[:, ph] = prod if lev == 0 else _add_mod(d_[:, ph], prod, p)


def _split_steps(x, count: int, levels: int, base_log: int, tail: Tail,
                 a_of, key_of, bundle: bool):
    """The split cluster kernel's step loop (H = 2), as
    :func:`_cluster_steps`: CTA (h, pi, r) holds half h of every transform
    of row r mod p_pi; the accumulator stays in global memory (``accg``,
    read in A and written in D by the owner of each position); the digits
    of CTA o = h P + pi of row r are those of its pairs (t, t + N/2), t in
    [o S, o S + S), slot k S + i for position k N/2 + o S + i, stored as
    int16. Where the shape streams (``pk.split_streams``, as the kernel's
    entries choose), B runs a level at a time through one transform buffer
    (row R) into the R partials (rows 0 .. R-1), and the digits are stored
    in ``pk.split_digit_bytes`` (int16 or int8)."""
    B, R, N = x.shape
    P, primes = tail.plan.num_primes, tail.plan.primes
    tables = tables_of(tail)
    log_n = N.bit_length() - 1
    M = N // 2
    log_s = cluster_log_slice(N, P, 2)
    S = 1 << log_s
    stream = pk.split_streams(P, R, levels, N)
    digit_bytes = pk.split_digit_bytes(P, R, levels, N)
    half_w = 1 << (8 * digit_bytes - 1)
    D = R + 1 if stream else max(levels, R)
    fwd, inv = cluster_plan(log_n, 2)
    ranks = [(h, pi, r) for h in range(2) for pi, r in cluster_ranks(P, R)]
    assert all(cluster_rank(*c, P, R) == k for k, c in enumerate(ranks))
    accg = x.clone()
    dig = [torch.zeros(B, D * M, dtype=torch.int64) for _ in ranks]
    dsl = [torch.zeros(B, levels * 2 * S, dtype=torch.int64) for _ in ranks]
    bi = torch.arange(B)[:, None]
    for i in range(count):
        # A. the digits of each CTA's positions, acc read in global memory
        for rank, (h, pi, r) in enumerate(ranks):
            base, ln = cluster_slice(N, P, h * P + pi, 2)
            u = torch.cat([torch.arange(ln), S + torch.arange(ln)])
            t = torch.cat([base + torch.arange(ln), M + base + torch.arange(ln)])
            v = accg[:, r, t]
            if a_of is not None:
                s = t[None] - a_of(i).to(torch.int64)[:, None]
                s = torch.where(s < 0, s + 2 * N, s)
                neg = s >= N
                s = torch.where(neg, s - N, s)
                y = accg[:, r][bi, s]
                v = torch.where(neg, -y, y) - v
            for lev, d in enumerate(lift_digits(v, base_log, levels,
                                                tail.acc32)):
                # the kernel's int16 (or int8) store
                dsl[rank][:, lev * 2 * S + u] = \
                    ((d + half_w) & (2 * half_w - 1)) - half_w
        # B. the lift with stages 0 .. 3 (stage 0 across the halves, half h
        # kept), the half's passes, the last two stages with the MAC
        hl_log = log_n - 4
        g = torch.arange(1 << hl_log)
        t = g[:, None] + (torch.arange(8) << hl_log)  # [G, 8], in [0, N/2)
        o = t >> log_s
        key = key_of(i)
        for rank, (h, pi, r) in enumerate(ranks):
            p, tb = primes[pi], tables[pi]
            owners = torch.stack([dsl[cluster_rank(q // P, q % P, r, P, R)]
                                  for q in range(2 * P)], 1)
            for lev in range(levels):
                row = R if stream else lev
                lifted = []
                for k in range(2):
                    d = owners[:, o, lev * 2 * S + k * S + t - (o << log_s)]
                    m = torch.where(d < 0, d + p, d)
                    tk = t + k * M
                    lifted.append(ntt_mod.shoup_mul(m, tb[T_TW][tk],
                                                    tb[T_TW_SH][tk], p))
                if h == 0:
                    w = _add_mod(lifted[0], lifted[1], p)
                else:
                    w = ntt_mod.shoup_mul(lifted[0] - lifted[1] + p,
                                          tb[T_FWD][t], tb[T_FWD_SH][t], p)
                dig[rank][:, swz(row * M + t)] = fwd_regs(w, tb, N, 1, 3, g,
                                                          hl_log, p)
                if not stream:
                    continue
                for s0, k in fwd[1:-1]:
                    dig[rank] = _half_pass(dig[rank], [R], N, s0, k, False,
                                           tb, p)
                _stream_mac(dig[rank], key, pi, r, h, lev, levels, R, N, tb,
                            p, bundle)
            if stream:
                continue
            for s0, k in fwd[1:-1]:
                dig[rank] = _half_pass(dig[rank], range(levels), N, s0, k,
                                       False, tb, p)
        for h in range(0 if stream else 2):
            half = [dig[cluster_rank(h, pi, r, P, R)]
                    for pi, r in cluster_ranks(P, R)]
            _cluster_mac(half, key, cluster_ranks(P, R), h, levels, R, N, M,
                         tables, primes, bundle)
        # C. the partials summed across CTAs (h, pi, .), the half's inverse
        # passes down to stage 1
        for h in range(2):
            _cluster_sum(dig, cluster_ranks(P, R), h, R, P, N, M, tables,
                         primes)
        for rank, (h, pi, r) in enumerate(ranks):
            p, tb = primes[pi], tables[pi]
            for s0, k in inv[1:]:
                dig[rank] = _half_pass(dig[rank], [r], N, s0, k, True, tb, p)
        # D. each CTA's pairs: both halves' values from CTAs (0, q, r) and
        # (1, q, r), stage 0 and the untwist mod each p_q, the tail
        for rank, (h, pi, r) in enumerate(ranks):
            base, ln = cluster_slice(N, P, h * P + pi, 2)
            t = base + torch.arange(ln)
            ph = swz(r * M + t)
            ys = [[], []]
            for q, pq in enumerate(primes):
                tb = tables[q]
                x0 = dig[cluster_rank(0, q, r, P, R)][:, ph]
                x1 = dig[cluster_rank(1, q, r, P, R)][:, ph]
                bw = ntt_mod.shoup_mul(x1, tb[T_INV][t], tb[T_INV_SH][t], pq)
                for k, y in enumerate((_add_mod(x0, bw, pq),
                                       _add_mod(x0, pq - bw, pq))):
                    ys[k].append(ntt_mod.shoup_mul(
                        y, tb[T_UTW][t + k * M], tb[T_UTW_SH][t + k * M], pq))
            for k in range(2):
                inc = tail(torch.stack(ys[k]))
                tk = t + k * M
                new = inc if bundle else accg[:, r, tk] + inc
                accg[:, r, tk] = new & M32 if tail.acc32 else new
    return accg


def cmux_steps_cluster(entry: str, acc, msed_mask, bsk_scan, base_log: int,
                       levels: int, split: int = 1):
    """All n steps of the cluster kernel's classic entries (``entry``:
    ``blind_rotate_crt`` for the u64 accumulator,
    ``blind_rotate_crt_acc32`` for the u32 hi plane) at ``split`` 1 or 2,
    with the operands of K3's wrapper: acc int64 or int32 [B, R, N],
    msed_mask [B, n], bsk_scan int32 [n, 2, P, l R, R, N]. Returns the
    accumulator in the operand's dtype."""
    P, N = bsk_scan.shape[2], acc.shape[-1]
    tail = tail_of(entry, P, N)
    x = u32_to_i64(acc) if tail.acc32 else acc
    key = u32_to_i64(bsk_scan)
    steps = _split_steps if split == 2 else _cluster_steps
    x = steps(x, bsk_scan.shape[0], levels, base_log, tail,
              lambda i: msed_mask[:, i], lambda i: key[i], False)
    return i64_to_u32(x) if tail.acc32 else x


def multi_bit_accumulate_cluster(acc, bundles, base_log: int, levels: int,
                                 split: int = 1):
    """The cluster kernel's multi-bit entry at ``split`` 1 or 2: the
    ``count`` steps of ``bundles`` int32 [B, count, P, l R, R, N] on acc
    int64 [B, R, N] (the digits of acc itself, a product mod p against the
    bundle, the Garner value in acc's place). Returns int64 [B, R, N]."""
    B, count, P = bundles.shape[:3]
    N = acc.shape[-1]
    tail = Tail("garner", ntt_mod.get_plan(N, P))
    key = u32_to_i64(bundles)
    steps = _split_steps if split == 2 else _cluster_steps
    return steps(acc, count, levels, base_log, tail, None,
                 lambda i: key[:, i], True)
