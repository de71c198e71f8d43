"""The tensor-core transform cases of the probes (``csrc/ntt_mxu.cu``):
their plain versions, the kernels' wrappers and the ``Case`` builders that
``ntt_variants``, ``ntt_v3c_experiments`` and ``v4_probe`` list.

The ops with a product run ``ntt_mxu_kernel`` on ``wgmma``: a cluster of
two CTAs of two polynomials each, CTA h holding column blocks 2h and
2h + 1 of the table, copied once per launch (``tools/_wgmma.py`` mirrors
the layout, the split and the exchange). Each is timed in turns with its
``_sync`` reference, the first, ``mma.sync`` kernel (one polynomial a block,
the table through L2; bench-only), which the two ops without a product
(``split4``, ``v4_split4``) keep.

Rows of N = 2048 at prime 0 of the 4-prime plan, one polynomial per block,
seen as [16, 128] (the JAX block layout of one polynomial, and the
[G, Bt, 128] layout of one ciphertext: group g = row g). The tables are
``ops/mxu_tables.py``'s: ``v3_tables(2048, 4)`` and ``v4_tables(2048, 4,
23)``, prime 0. Each plain version is int64 wrap-around arithmetic
(``tools/_int8.py``) on int32 [polys, 2048] u32 storage, formula for
formula the JAX function named beside it, but the v3 transforms' four
stages of stride >= 128, which are the plan's exact butterflies (equal mod
p to the JAX lazy ones, and both are made canonical before the small DFT
and at the end).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .._torus import from_u32
from ..ops import kernel_bench as kb
from ..ops import mxu_tables
from ..ops import ntt as ntt_mod
from ..ops import pbs_kernel as pk
from . import _harness as h
from . import _int8 as q
from . import _wgmma as wgm

N, LOG_N, ROWS = 2048, 11, 16
PRIME = ntt_mod.PRIMES32[0]
P2 = 2 * PRIME
BASE_LOG = 23
THREADS = 512  # the _sync kernel's block
CLUSTER, POLYS_PER_CTA = wgm.NTT_CLUSTER, wgm.NTT_POLYS
OPS = {"v3_fwd": 0, "v3_inv": 1, "split4": 2, "mm4": 3, "mm1": 4,
       "v4_fold": 5, "v4_split4": 6, "v4_inv_mmr": 7, "v4_fwd": 8,
       "v4_fwd_nosplit": 9, "v4_inv": 10}
#: the product's depth K per op (None: no product)
K = {"v3_fwd": 512, "v3_inv": 512, "split4": None, "mm4": 512, "mm1": 512,
     "v4_fold": 384, "v4_split4": None, "v4_inv_mmr": 512, "v4_fwd": 384,
     "v4_fwd_nosplit": 384, "v4_inv": 512}


def v3(n: int = N):
    return mxu_tables.v3_tables(n, 4)


def v4(n: int = N):
    return mxu_tables.v4_tables(n, 4, BASE_LOG)


def _u32_const(a, device) -> torch.Tensor:
    """A u32 numpy table as int64 on ``device``."""
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64)).to(
        device)


# ---------------------------------------------------------------------------
# plain versions (y: int64 u32 values [polys, 16, 128])
# ---------------------------------------------------------------------------

def offset_split(y: torch.Tensor, n: int = 4) -> torch.Tensor:
    return torch.cat(q.offset_limbs(y, n), dim=-1)


def recombine_v3(U: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``_mxu_small_dft``'s recombination (pbs_kernel.py:538-546)."""
    t = v3(N)  # one_sh, c16 and c16_sh depend on the prime alone
    v0, v1 = q.pair_fold(U)
    r0 = q.wrap(v0 - q.mul_hi(v0, int(t.one_sh[0])) * PRIME)
    r1 = q.shoup(v1, int(t.c16[0]), int(t.c16_sh[0]), PRIME)
    s = q.condsub(q.wrap(r0 + r1), P2)
    return q.condsub(s + bias, P2)


def _stages(y: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The plan's exact stages 0..3 (forward DIF, or inverse CT in reverse
    order) of canonical rows [polys, n], prime 0."""
    M, n = y.shape
    tb = kb._plan1(n).tables(y.device)
    first = n.bit_length() - 1 - 7
    for s in (reversed(range(first)) if inverse else range(first)):
        m = n >> s
        rr = y.reshape(M, n // m, 2, m >> 1)
        a, b = rr[..., 0, :], rr[..., 1, :]
        w, ws = tb["fwd" if not inverse else "inv"][s][0], \
            tb["fwd_sh" if not inverse else "inv_sh"][s][0]
        if inverse:
            bw = ntt_mod.shoup_mul(b, w, ws, PRIME)
            pair = (q.condsub(a + bw, PRIME), q.condsub(a - bw + PRIME, PRIME))
        else:
            pair = (q.condsub(a + b, PRIME),
                    ntt_mod.shoup_mul(a - b + PRIME, w, ws, PRIME))
        y = torch.stack(pair, dim=-2).reshape(M, n)
    return y


def _twist(y: torch.Tensor, key: str) -> torch.Tensor:
    tb = kb._plan1(y.shape[-1]).tables(y.device)
    return ntt_mod.shoup_mul(y, tb[key][0], tb[f"{key}_sh"][0], PRIME)


def _table(name: str, y: torch.Tensor) -> torch.Tensor:
    """The product's int8 table of prime 0 at y's N as int64 on its
    device (y: [polys, G, 128])."""
    n = y.shape[-2] * 128
    return q.table({"v3_fwd": lambda: v3(n).fwd_w8m[0],
                    "v3_inv": lambda: v3(n).inv_w8m[0],
                    "v4_fwd": lambda: v4(n).fwd_w8[0],
                    "v4_inv": lambda: v4(n).inv_w8[0]}[name](), y.device)


def mxu_plain(x: torch.Tensor, loops: int, op: str,
              copies: int = 1) -> torch.Tensor:
    """``loops`` trips of ``op`` on each polynomial of x (int32 [polys,
    2048] u32 storage; any N >= 256 on the CPU)."""
    dev, n = x.device, x.shape[-1]
    y = h.u32(x).reshape(-1, n // 128, 128)
    polys, rows = y.shape[:2]
    t3, t4 = v3(n), v4(n)
    for _ in range(loops):
        if op == "v3_fwd":  # _fwd_ntt_v3
            z = _stages(_twist(y.reshape(polys, n), "twist"), False)
            L = offset_split(q.condsub(z, PRIME).reshape(polys, rows, 128))
            y = recombine_v3(q.matmul(L, _table("v3_fwd", y)),
                             _u32_const(t3.fwd_bias_row[0], dev))
        elif op == "v3_inv":  # _inv_ntt_v3b
            L = offset_split(q.condsub(y, PRIME))
            z = recombine_v3(q.matmul(L, _table("v3_inv", y)),
                             _u32_const(t3.inv_bias_row[0], dev))
            z = _stages(q.condsub(z, PRIME).reshape(polys, n), True)
            y = _twist(z, "untwist").reshape(polys, rows, 128)
        elif op == "split4":  # split4_only
            d = q.split4_balanced(y)
            y = q.wrap(d[0] + d[1] + y)
        elif op in ("mm4", "mm1"):  # mm4_only, mm1_only, mm1_rows256/512
            c = q.condsub(y, PRIME)
            L = (torch.cat(q.split4_balanced(c), dim=-1) if op == "mm4"
                 else offset_split(c))
            U = q.matmul(torch.cat([L] * copies, dim=1),
                         _table("v3_fwd", y)).reshape(
                polys, copies, rows, 4, 128)
            pick = {1: ((0, 0), (0, 1), (0, 2), (0, 3)),
                    2: ((0, 0), (1, 0), (0, 1), (1, 3)),
                    4: ((0, 0), (1, 0), (2, 1), (3, 3))}[copies]
            y = q.wrap(sum(U[:, r, :, j] for r, j in pick) + y)
        elif op == "v4_fold":  # v4_matmul_fold, g_matmul_fold
            U = q.matmul(torch.cat([q.i8(y)] * 3, dim=-1),
                         _table("v4_fwd", y))
            v0, v1 = q.pair_fold(U)
            y = v0 ^ v1
        elif op == "v4_split4":  # v4_split4
            y = q.wrap(y + q.offset_limbs(q.condsub(y, PRIME), 1)[0])
        elif op == "v4_inv_mmr":  # v4_inv_matmul_recombine
            y = _inv_recombine_v4(y, exact=True)
        elif op in ("v4_fwd", "v4_fwd_nosplit"):  # _fwd_ntt_v4
            if op == "v4_fwd":  # v4_fwd's digits, offset by in_offset
                u = (y & 0x3FFFFF) - (1 << 21) + t4.in_offset
                L = offset_split(u, t4.nl_in)
            else:
                L = torch.cat([q.i8(y)] * 3, dim=-1)
            y = _fwd_tail_v4(q.matmul(L, _table("v4_fwd", y)), t4)
        else:  # v4_inv: _inv_ntt_v4
            y = _group_stages(y, t4, inverse=True)
            tw = _u32_const(t4.tw_inv[0], dev)
            y = q.condsub(q.shoup(y, tw[0], tw[1], PRIME), PRIME)
            y = _inv_recombine_v4(y, exact=False)
    return h.to_storage(y.reshape(polys, n))


def _inv_recombine_v4(y: torch.Tensor, exact: bool) -> torch.Tensor:
    """condsub, the 4-limb offset split, @ inv_w8, the pair fold, q0 by
    the exact ``_mul_hi`` (``exact``, as ``v4_inv_matmul_recombine``) or
    the approx Barrett fold of ``_inv_ntt_v4``, r1 by the approx
    ``_shoup``, the bias and the condsubs."""
    t = v4(y.shape[-2] * 128)
    L = offset_split(q.condsub(y, PRIME))
    v0, v1 = q.pair_fold(q.matmul(L, _table("v4_inv", y)))
    if exact:
        r0 = q.wrap(v0 - q.mul_hi(v0, int(t.one_sh[0])) * PRIME)
    else:
        r0 = q.condsub_wide(
            q.wrap(v0 - q.mul_hi_approx(v0, int(t.one_sh[0])) * PRIME), P2)
    r1 = q.shoup(v1, int(t.c16[0]), int(t.c16_sh[0]), PRIME)
    s = q.condsub(q.wrap(r0 + r1), P2)
    s = q.condsub(s + _u32_const(t.inv_bias[0], y.device), P2)
    return q.condsub(s, PRIME)


def _fwd_tail_v4(U: torch.Tensor, t) -> torch.Tensor:
    """``_fwd_tail_v4`` (lazy=False): the twiddle scale, then the group
    DIF stages (``t``: the v4 tables)."""
    tw = _u32_const(t.tw[0], U.device)  # [5, G, 128]
    v0, v1 = q.pair_fold(U)
    s = q.shoup(v0, tw[0], tw[1], PRIME) + q.shoup(v1, tw[2], tw[3], PRIME)
    s = q.condsub(s, P2)
    s = q.condsub(s + tw[4], P2)
    return _group_stages(s, t, inverse=False)


def _group_stages(y: torch.Tensor, t, inverse: bool) -> torch.Tensor:
    """The log2(G) group-axis stages of ``_fwd_tail_v4`` /
    ``_inv_ntt_v4`` on y [polys, G, 128] (< 2p in and out)."""
    gw = _u32_const(t.gw_inv[0] if inverse else t.gw_fwd[0], y.device)
    polys = y.shape[0]
    for st in (reversed(range(t.log_g)) if inverse else range(t.log_g)):
        m = t.G >> st
        h_ = m >> 1
        yy = y.reshape(polys, t.G // m, 2, h_, 128)
        a, b = yy[:, :, 0], yy[:, :, 1]
        w = gw[st, 0].reshape(t.G // m, 2, h_, 128)[:, 1]
        wsh = gw[st, 1].reshape(t.G // m, 2, h_, 128)[:, 1]
        if inverse:
            bw = q.shoup(b, w, wsh, PRIME)
            pair = (q.condsub(a + bw, P2), q.condsub(a + P2 - bw, P2))
        else:
            pair = (q.condsub(a + b, P2), q.shoup(a + P2 - b, w, wsh, PRIME))
        y = torch.stack(pair, dim=2).reshape(polys, t.G, 128)
    return y


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from .._build import cuda_lib

    lib = cuda_lib("ntt_mxu")
    i, u, v = ctypes.c_int, ctypes.c_uint, ctypes.c_void_p
    for e in (lib.ntt_mxu, lib.ntt_mxu_sync):
        e.argtypes = [v] * 7 + [i, i, i, u, u, u, u, i, i, v]
        e.restype = ctypes.c_int
    lib.ntt_mxu_occupancy.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.ntt_mxu_occupancy.restype = ctypes.c_int
    return lib


def occupancy(op: str, copies: int = 1) -> dict:
    """``ntt_mxu_kernel``'s resources for ``op``: registers, local (spill)
    bytes a thread, dynamic shared memory, cluster size, resident blocks
    per SM, clusters on the card."""
    out = (ctypes.c_int * 6)()
    pk._raise_on(_lib().ntt_mxu_occupancy(OPS[op], copies, out), op)
    return dict(zip(("registers", "local_bytes", "smem_bytes", "cluster",
                     "blocks_per_sm", "clusters"), out))


def _dev_u32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.uint32)).view(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def device_tables(device: str) -> dict:
    """Per op family, on ``device``: the product's table transposed (the
    column-major copy the ``_sync`` kernel reads B from) and as the
    cluster image ``ntt_mxu_kernel`` copies its slice of (``*_img``), the
    bias row, the plan tables, the v4 twiddles; made once."""
    t3, t4 = v3(), v4()
    bt = lambda w: torch.from_numpy(np.ascontiguousarray(w.T)).to(device)
    img = lambda w: wgm.cluster_image(w, CLUSTER).to(device)
    return {
        "v3_fwd": bt(t3.fwd_w8m[0]), "v3_inv": bt(t3.inv_w8m[0]),
        "v4_fwd": bt(t4.fwd_w8[0]), "v4_inv": bt(t4.inv_w8[0]),
        "v3_fwd_img": img(t3.fwd_w8m[0]), "v3_inv_img": img(t3.inv_w8m[0]),
        "v4_fwd_img": img(t4.fwd_w8[0]), "v4_inv_img": img(t4.inv_w8[0]),
        "bias_fwd": _dev_u32(t3.fwd_bias_row[0], device),
        "bias_inv": _dev_u32(t3.inv_bias_row[0], device),
        "bias_v4": _dev_u32(t4.inv_bias[0], device),
        "plan": pk._plan_tables_dev(kb._plan1(N), device),
        "tw": _dev_u32(t4.tw[0], device),
        "tw_inv": _dev_u32(t4.tw_inv[0], device),
        "gw_fwd": _dev_u32(t4.gw_fwd[0], device),
        "gw_inv": _dev_u32(t4.gw_inv[0], device)}


#: per op: (table, bias, twiddles, group twiddles) keys of device_tables
_OPERANDS = {
    "v3_fwd": ("v3_fwd", "bias_fwd", None, None),
    "v3_inv": ("v3_inv", "bias_inv", None, None),
    "split4": (None, None, None, None), "mm4": ("v3_fwd", None, None, None),
    "mm1": ("v3_fwd", None, None, None),
    "v4_fold": ("v4_fwd", None, None, None),
    "v4_split4": (None, None, None, None),
    "v4_inv_mmr": ("v4_inv", "bias_v4", None, None),
    "v4_fwd": ("v4_fwd", None, "tw", "gw_fwd"),
    "v4_fwd_nosplit": ("v4_fwd", None, "tw", "gw_fwd"),
    "v4_inv": ("v4_inv", "bias_v4", "tw_inv", "gw_inv")}


def _launch(name: str, op: str, copies: int = 1, sync: bool = False):
    def launch(x, loops):
        h.cuda_operand(name, x, 2)
        if x.shape[1] != N:
            raise ValueError(f"{name}: rows of {x.shape[1]}, the kernel "
                             f"takes N = {N}")
        if not sync and x.shape[0] % (CLUSTER * POLYS_PER_CTA):
            raise ValueError(f"{name}: {x.shape[0]} polynomials, the kernel "
                             f"takes a multiple of "
                             f"{CLUSTER * POLYS_PER_CTA}")
        out = torch.empty_like(x)
        tabs = device_tables(str(x.device))
        ptr = lambda k: pk._ptr(tabs[k]) if k else ctypes.c_void_p(None)
        table, bias, tw, gw = _OPERANDS[op]
        if table and not sync:
            table += "_img"
        t3 = v3()
        entry = _lib().ntt_mxu_sync if sync else _lib().ntt_mxu
        rc = entry(
            pk._ptr(x), pk._ptr(out), ptr(table), ptr(bias),
            ptr("plan" if op.startswith("v3") else None), ptr(tw), ptr(gw),
            x.shape[0], OPS[op], copies, PRIME, int(t3.one_sh[0]),
            int(t3.c16[0]), int(t3.c16_sh[0]), loops, 0, pk._stream(x.device))
        pk._raise_on(rc, name)
        return out
    return launch


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def residues(device, seed: int = 0):
    """``kernel_bench.bench_rows`` polynomials (528 on an H100, 2 on the
    CPU) of N residues below PRIME."""
    dev = torch.device(device)
    x = np.random.default_rng(seed).integers(
        0, PRIME, (kb.bench_rows(dev), N), np.uint32)
    return (from_u32(x, dev),)


def mma_trips(op: str, copies: int = 1):
    """Runs of the K-block loop's body (4 m64n256k32 wgmma) a trip: per
    cluster of 4 polynomials, 2 CTAs, ``copies`` row tiles, K / 128
    K-blocks."""
    return lambda args: (args[0].shape[0] // (CLUSTER * POLYS_PER_CTA)
                         * CLUSTER * copies * K[op] // 128)


def mma_trips_sync(op: str):
    """The ``_sync`` kernel's runs of the k loop's body a trip: 16 warps,
    K / 32 steps, one pass a polynomial (its body holds 4 copies mma)."""
    return lambda args: args[0].shape[0] * (THREADS // 32) * K[op] // 32


#: the high trip count of the product cases' timing
TRIPS = (16, 256)


def l2_bytes(op: str):
    """A trip's share of what a launch at the high trip count reads: each
    CTA (two polynomials) its K x 256 slice of the table once, every
    polynomial in and out once."""
    return lambda args: args[0].shape[0] * (
        K[op] * 256 // POLYS_PER_CTA + 2 * N * 4) / TRIPS[1]


_MMA = "wgmma.m64n256k32.s8, the table resident in a cluster of 2"
_MMA_SYNC = "mma.sync.m16n8k32.s8"


def _macs(op: str, copies: int):
    return lambda args: args[0].shape[0] * copies * ROWS * K[op] * 512


def sync_case(name: str, op: str, *, replaces: str, mirrors: list,
              copies: int = 1) -> h.Case:
    """``op`` on the first, ``mma.sync`` kernel: a redesigned case's
    reference, bench-only."""
    return h.Case(
        f"{name}_sync", replaces=replaces, mirrors=mirrors,
        kernel=(f"{op}_{copies}" if copies > 1 else op) + "_sync",
        launch=_launch(f"{name}_sync", op, copies, sync=True),
        plain=functools.partial(mxu_plain, op=op, copies=copies),
        inputs=residues, units=lambda args: args[0].shape[0] * copies,
        unit="polynomial" if copies == 1 else "transform",
        required=("IMMA",), trips=TRIPS,
        pipes=h.glue_pipes(lambda args: args[0].numel()),
        macs=_macs(op, copies), mma_trips=mma_trips_sync(op),
        l2_bytes=lambda args: args[0].shape[0] * K[op] * 512, mma=_MMA_SYNC,
        note="the reference: mma.sync m16n8k32 s8, one polynomial a block, "
        "the table through L2")


def case(name: str, op: str, *, replaces: str, mirrors: list,
         copies: int = 1, note: str = "") -> h.Case:
    """The ``h.Case`` of ``op`` (units: polynomials, or ``copies``
    transforms' worth a polynomial for mm1 with repeated rows); an op with
    a product runs ``ntt_mxu_kernel`` and has its ``_sync`` reference."""
    mm = K[op] is not None
    kernel = f"{op}_{copies}" if copies > 1 else op
    return h.Case(
        name, replaces=replaces, mirrors=mirrors, kernel=kernel,
        launch=_launch(name, op, copies, sync=not mm),
        plain=functools.partial(mxu_plain, op=op, copies=copies),
        inputs=residues, units=lambda args: args[0].shape[0] * copies,
        unit="polynomial" if copies == 1 else "transform",
        required=("IGMMA",) if mm else ("LOP3", "IADD3", "VIADD", "SHF"),
        trips=TRIPS if mm else (256, 4096),
        pipes=h.glue_pipes(lambda args: args[0].numel()),
        macs=_macs(op, copies) if mm else None,
        mma_trips=mma_trips(op, copies) if mm else None,
        l2_bytes=l2_bytes(op) if mm else None,
        mma=_MMA if mm else _MMA_SYNC,
        reference=sync_case(name, op, replaces=replaces, mirrors=mirrors,
                            copies=copies) if mm else None,
        note=note or ("wgmma m64n256k32 s8, the table resident in a cluster "
                      "of 2 CTAs (a pair of column blocks each), only "
                      "folded terms cross" if mm else ""))


def sass_entry(op: str, copies: int = 1, sync: bool = False) -> tuple:
    """(library, parts of the mangled name) of ``op``'s kernel: the
    ``_sync`` one for the ops without a product or with ``sync``."""
    if sync or K[op] is None:
        return ("ntt_mxu", (f"19ntt_mxu_kernel_syncILi{OPS[op]}ELi{copies}E",))
    return ("ntt_mxu", (f"14ntt_mxu_kernelILi{OPS[op]}ELi{copies}E",))


def sync_totals(totals: dict) -> dict:
    """A module's ``SASS_LOOP_TOTALS`` entries of its references' kernels
    ({kernel: (op, copies, totals)})."""
    return {f"{k}_sync": (*sass_entry(op, copies, sync=True), t)
            for k, (op, copies, t) in totals.items()}


#: butterflies of one transform at N = 2048
BUTTERFLIES = (N // 2) * LOG_N


def verdict(rows: dict) -> dict:
    """Does the int8 tensor-core small DFT beat the INT32 butterflies? From
    the rows of one run ({metric: row}, as the probes print them): each
    transform's ns a polynomial at N = 2048 (the butterfly rows times
    11,264 butterflies) and, where the row has it, its ``_sync``
    reference's from the same run (in turns), the MXU transforms'
    speed-up over radix-2 and radix-4, the parts of the v3 transform (the
    product: what ``mm1_rows512``'s three more products a polynomial add
    to ``mm1_only``, a third; the rest of ``mm1_only``: the split, the
    exchange of the terms and their sum; the rest of the transform: the
    stages and the recombination), and E2's and
    ``torch._int_mm``'s shares of the dense int8 peak."""
    ns, sync_ns = {}, {}
    for m in ("fwd_r2", "fwd_r4", "inv_r2", "inv_r4"):
        ns[m] = rows[m]["ps_per_unit"] * BUTTERFLIES * 1e-3
    for m in ("v3_fwd_mxu", "v4_fwd_mxu", "v4_fwd_mxu_nosplit", "v3_inv_mxu",
              "v4_inv_mxu"):
        ns[m] = rows[m]["ps_per_unit"] * 1e-3
        if "sync_ps_per_unit" in rows[m]:
            sync_ns[m] = rows[m]["sync_ps_per_unit"] * 1e-3
    best = {d: min(ns[f"{d}_r2"], ns[f"{d}_r4"]) for d in ("fwd", "inv")}
    mxu = {"fwd": min(ns["v3_fwd_mxu"], ns["v4_fwd_mxu"]),
           "inv": min(ns["v3_inv_mxu"], ns["v4_inv_mxu"])}
    parts = None
    if "mm1_only" in rows and "mm1_rows512" in rows:
        # mm1_rows512 issues the product of mm1_only 4 times a polynomial
        # (its unit: a transform, a quarter polynomial)
        one = rows["mm1_only"]["ps_per_unit"] * 1e-3
        four = 4 * rows["mm1_rows512"]["ps_per_unit"] * 1e-3
        prod = (four - one) / 3
        parts = {d: {"product": prod, "split_exchange_sum": one - prod,
                     "stages_recombination": ns[f"v3_{d}_mxu"] - one}
                 for d in ("fwd", "inv")}
    return {
        "metric": "mxu_verdict", "ns_per_polynomial": ns,
        "sync_ns_per_polynomial": sync_ns,
        "speedup_over_r2": {m: ns[f"{m[3:6]}_r2"] / v for m, v in ns.items()
                            if "mxu" in m},
        "speedup_over_r4": {m: ns[f"{m[3:6]}_r4"] / v for m, v in ns.items()
                            if "mxu" in m},
        "tensor_dft_wins": {d: mxu[d] < best[d] for d in ("fwd", "inv")},
        "v3_parts_ns": parts,
        "e2_int8_tensor_fraction": rows["int8_matmul_128x512x128"][
            "int8_tensor_fraction"],
        "int_mm_int8_tensor_fraction": rows["int8_gemm_library"][
            "int8_tensor_fraction"],
        "l2_bytes_per_s": {m: rows[m]["l2_bytes_per_s"] for m in
                           ("v3_fwd_mxu", "v4_fwd_mxu", "v3_inv_mxu",
                            "v4_inv_mxu")},
        "mma": "wgmma.m64nNk32.s8 + cluster-resident tables",
        "card": rows["fwd_r2"]["card"]}
