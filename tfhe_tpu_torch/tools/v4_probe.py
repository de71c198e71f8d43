"""The step probes on an NVIDIA GPU: the blind-rotation step of K1 and K3
piece by piece, each piece looped on data resident in shared memory
(``csrc/v4_probe.cu``), in K1's and K3's layout (``ct``: a ciphertext per
block) and interleaved (``il``: two ciphertexts per block,
coefficient-major). The transforms (``fwd``, ``inv_untwist``) run ``ct``
through the step kernels' own loops (``brk::forward_stages`` /
``inverse_stages``) and also ``il1``: one ciphertext per block through the
C-strided loops that ``il`` runs (``csrc/probe_stages.cuh``), so that
``il1`` against ``il`` compares the layouts on one code path.

Counterpart of ``tools/v4_probe.py`` (pallas_calls at ``:80``, the
[Bt, G, 128] layout, and ``:274``, the [G, Bt, 128] layout)::

    python -m tfhe_tpu_torch.tools.v4_probe [out.jsonl]

prints one JSON row per case, then the split of K1's and K3's time per
ciphertext-step into the pieces (and appends them to ``out.jsonl``); it
runs on the GPU and raises without one, and catches nothing.

The pieces, per ciphertext-step at 2_2 (N = 2048, R = 2, l = 1), K1 with
P = 2 and K3 with P = 4 primes: ``rot`` (R*N: the u64 negacyclic rotation,
``v4_rot``/``g_rot``), ``decomp`` (l*R*N: digit 0 at base_log 23,
``g_decomp``), ``lift_twist`` (P*l*R*N: the digit lifted into Z_p and
twisted), ``fwd`` (P*l*R transforms: ``forward_stages``; ``fwd_first4`` its
first four stages, the groups-only cases), ``mac2`` (P*R*N: two Shoup terms,
``v4_mac2``), ``inv_untwist`` (P*R transforms: ``inverse_stages`` and the
untwist, ``v4_inv``/``v4_tw_recombine``/``g_tw_recombine``) and the tails
(R*N: ``garner3``/``garner4``, ``g_garner_crt_1c``; ``garner32_*``,
``bnf2_c``, ``bnf2_c32``). ``fwd`` and ``inv_untwist`` are INT32
stand-ins of the same size for ``v4_fwd_*`` and ``v4_inv``.

The pass pieces time the step K1 and K3 run (``ntt_common.cuh``'s
StepPasses, on the step's own shared-memory state, one ciphertext a
block), at 2_2 for K1 (P = 2, ``bnf2_c32``) and K3 (P = 4, ``garner4``), one
ciphertext-step a unit: ``pass_lift`` (the lift with the first forward
pass), ``pass_fwd`` (the other forward passes), ``pass_fused`` (the last
forward stages, the MAC against a step key streamed from global memory, the
first inverse stages), ``pass_inv`` (the inverse passes but the last),
``pass_tail`` (the last inverse pass, the untwist, the tail, acc +=). Their
plain versions are ``ops/step_passes.py``, the CPU mirror of the passes;
:func:`pass_split` sums them against ``fused_step_v6`` / ``fused_step``, as
:func:`step_split` sums the pieces above against the radix-2 loop
(``fused_step_v6_r2`` / ``fused_step_r2``).

The MXU pieces run on the int8 tensor cores (``csrc/ntt_mxu.cu``,
``tools/ntt_mxu.py``), one ciphertext's [G, 128] a block, at
``_get_tables_v4(2048, 4, 23)``'s prime 0: ``v4_matmul_fold`` (x as int8,
x3, @ fwd_w8 [384, 512], the pair fold, V0 ^ V1; also ``g_matmul_fold``,
which differs only in the rows' order), ``v4_split4``,
``v4_inv_matmul_recombine`` (the exact ``_mul_hi`` for q0, the approx
``_shoup`` for r1, as the case writes them), and the transforms the JAX
harness cannot run (its [Bt, G, 128] loop carry refuses their [G, Bt, 128]
output): ``v4_fwd_mxu`` / ``v4_fwd_mxu_nosplit`` (``_fwd_ntt_v4``,
lazy=False, on ``v4_fwd``'s digit limbs or ``v4_fwd_nosplit``'s int8 of
x: the lane DFT, the twiddle scale, the group stages) and ``v4_inv_mxu``
(``_inv_ntt_v4``, lazy=False, the approx Barrett fold).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .._device import resolve_device
from .._torus import M32, from_u32, from_u64, srl
from ..ops import bnf2 as bnf2_mod
from ..ops import kernel_bench as kb
from ..ops import ntt as ntt_mod
from ..ops import pbs_kernel as pk
from ..ops import step_passes as sp
from ..ops.decomp import decompose
from ..ops.polynomial import monomial_mul
from . import _harness as h
from . import ntt_mxu as nm
from .ntt_variants import fwd_stage_range

N, LOG_N = 2048, 11
P = 4            # primes of the transform pieces (K3 at 2_2)
POLYS = 8        # the transforms' P * l * R polynomials per ciphertext
BASE_LOG = 23
IL = 2           # ciphertexts per block in the interleaved layout
LAYOUTS = {"ct": 1, "il1": 1, "il": IL}
#: the pieces whose ct kernel is the step kernels' own loop, and so also
#: run as il1
BRK_PIECES = ("fwd", "inv_untwist")


def layouts_of(piece: str) -> tuple:
    return ("ct", "il1", "il") if piece in BRK_PIECES else ("ct", "il")
MASK = (1 << 29) - 1  # m_i = (x ^ i) & MASK: below every prime
LIFT_MASK, LIFT_OFFSET = 0x3FFFFF, 1 << 21
FLAVOR = bnf2_mod.DEFAULT
SRC = "tools/v4_probe.py"


def _plan(n: int = N):
    return ntt_mod.get_plan(n, P)


# ---------------------------------------------------------------------------
# plain versions: int32 [B, N] (or [B, 8, N]) u32 storage in and out
# ---------------------------------------------------------------------------

def rot_plain(x: torch.Tensor, loops: int) -> torch.Tensor:
    """x <- hi ^ lo of X^a * ((x << 32) | (x ^ 1)), a = x[0] & (2N - 1),
    the u64 negacyclic rotation of each ciphertext (``g_rot``)."""
    y = h.u32(x)
    n = y.shape[-1]
    for _ in range(loops):
        r = monomial_mul((y << 32) | (y ^ 1), y[:, 0] & (2 * n - 1))
        y = (srl(r, 32) ^ r) & M32
    return h.to_storage(y)


def decomp_plain(x: torch.Tensor, loops: int) -> torch.Tensor:
    """x <- digit 0 (mod 2^32) of the balanced decomposition of the hi
    word x at base_log 23, one level (``g_decomp``)."""
    y = h.u32(x)
    for _ in range(loops):
        y = decompose(y << 32, BASE_LOG, 1)[..., 0] & M32
    return h.to_storage(y)


def lift_twist_plain(x: torch.Tensor, loops: int) -> torch.Tensor:
    """x <- (d mod p) * psi^t mod p, d = (x & 0x3FFFFF) - 2^21, prime 0."""
    plan = _plan(x.shape[-1])
    tb, p = plan.tables(x.device), plan.primes[0]
    y = h.u32(x)
    for _ in range(loops):
        d = (y & LIFT_MASK) - LIFT_OFFSET
        y = ntt_mod.shoup_mul(torch.where(d < 0, d + p, d), tb["twist"][0],
                              tb["twist_sh"][0], p)
    return h.to_storage(y)


def _by_prime(y: torch.Tensor) -> torch.Tensor:
    """[B, 8, n] (polynomial k mod prime k % 4) -> [4, B*2, n]."""
    B, _, n = y.shape
    return y.reshape(B, POLYS // P, P, n).permute(2, 0, 1, 3).reshape(
        P, B * POLYS // P, n)


def _from_prime(r: torch.Tensor, B: int) -> torch.Tensor:
    n = r.shape[-1]
    return r.reshape(P, B, POLYS // P, n).permute(1, 2, 0, 3).reshape(
        B, POLYS, n)


def fwd_plain(x: torch.Tensor, loops: int, s0: int = 0,
              s1: int = None) -> torch.Tensor:
    """Forward stages [s0, s1) (s1 None: all) of the 8 polynomials of each
    ciphertext, polynomial k mod prime k % 4 (``forward_stages<4>``)."""
    B, plan = x.shape[0], _plan(x.shape[-1])
    r = _by_prime(h.u32(x))
    for _ in range(loops):
        r = fwd_stage_range(plan, r, s0, plan.log_n if s1 is None else s1)
    return h.to_storage(_from_prime(r, B))


def inv_untwist_plain(x: torch.Tensor, loops: int) -> torch.Tensor:
    """The inverse transforms and the untwist of the 8 polynomials."""
    B, plan = x.shape[0], _plan(x.shape[-1])
    r = _by_prime(h.u32(x))
    for _ in range(loops):
        r = plan.inv(r)
    return h.to_storage(_from_prime(r, B))


def mac2_plain(x: torch.Tensor, g2: torch.Tensor,
               loops: int) -> torch.Tensor:
    """x <- x g_0 + x g_1 mod prime 0 (``kernel_bench.kb_mac_plain``)."""
    return kb.kb_mac_plain(x, g2, loops)


def _residues(y, P_):
    return [(y ^ i) & MASK for i in range(P_)]


def _fold(v):
    return (srl(v, 32) ^ v) & M32


def tail_plain(x: torch.Tensor, loops: int, kind: str) -> torch.Tensor:
    """x <- the tail ``kind`` of the residues m_i = (x ^ i) & MASK, from the
    specs: ``NegacyclicNtt.reconstruct_u64`` (garner*), its value rounded
    to its hi word (garner32_*), ``bnf2.crt2_merge`` + ``qp_to_torus``
    (bnf2_c), ``bnf2.qp_to_torus32`` (bnf2_c32); a u64 value folded as
    hi ^ lo."""
    y = h.u32(x)
    for _ in range(loops):
        if kind.startswith("garner"):
            P_ = int(kind[-1])
            v = ntt_mod.get_plan(x.shape[-1], P_).reconstruct_u64(
                torch.stack(_residues(y, P_)))
            y = (srl(v + (1 << 31), 32) if kind.startswith("garner32")
                 else _fold(v))
        elif kind == "bnf2_c":
            m = _residues(y, 2)
            y = _fold(bnf2_mod.qp_to_torus(
                bnf2_mod.crt2_merge(m[0], m[1], FLAVOR), FLAVOR))
        else:
            m = _residues(y, 2)
            y = bnf2_mod.qp_to_torus32(m[0], m[1], FLAVOR)
    return h.to_storage(y)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from .._build import cuda_lib

    lib = cuda_lib("v4_probe")
    i, u, v = ctypes.c_int, ctypes.c_uint, ctypes.c_void_p
    lib.v4_rot.argtypes = [v, v, i, i, i, i, v]
    lib.v4_decomp.argtypes = [v, v, i, i, i, i, i, v]
    lib.v4_lift_twist.argtypes = [v, v, v, i, i, i, u, u, i, i, v]
    lib.v4_fwd.argtypes = [v, v, v, i, i, i, i, i, v, i, i, v]
    lib.v4_inv_untwist.argtypes = [v, v, v, i, i, i, v, i, i, v]
    lib.v4_mac2.argtypes = [v, v, v, i, i, i, u, i, v]
    lib.v4_tail.argtypes = [v, v, i, i, i, i, i, u, v, ctypes.c_ulonglong,
                            v, i, v]
    lib.v4_pass_piece.argtypes = [v, v, v, v, v, i, i, i, i, i, i, i, v,
                                  ctypes.c_ulonglong, v, i, v]
    for e in (lib.v4_rot, lib.v4_decomp, lib.v4_lift_twist, lib.v4_fwd,
              lib.v4_inv_untwist, lib.v4_mac2, lib.v4_tail,
              lib.v4_pass_piece):
        e.restype = ctypes.c_int
    return lib


_PRIMES = (ctypes.c_uint * P)(*ntt_mod.PRIMES32[:P])
_BNF = (ctypes.c_uint * 10)(FLAVOR.p0, FLAVOR.p1, FLAVOR.inv01,
                            FLAVOR.inv01_sh, FLAVOR.g0, FLAVOR.g1, FLAVOR.s1,
                            FLAVOR.s2, FLAVOR.c1t, FLAVOR.t32_bias)
_TAIL_KIND = {"garner": 0, "garner32": 1, "bnf2_c": 2, "bnf2_c32": 3}


def _launcher(name: str, C: int, entry: str, ndim: int, extra):
    """A launch of ``lib.<entry>(x, out, *extra(x), B, C, log_n, ...)``:
    ``extra(x)`` gives the arguments between the operands and the batch
    (tables) and after log_n (the rest), as two tuples."""
    def launch(x, *rest):
        *ops, loops = rest
        h.cuda_operand(name, x, ndim)
        if x.shape[-1] != N:
            raise ValueError(f"{name}: polynomials of {x.shape[-1]}, the "
                             f"kernel takes N = {N}")
        out = torch.empty_like(x)
        before, after = extra(x, *ops)
        rc = getattr(_lib(), entry)(pk._ptr(x), pk._ptr(out), *before,
                                    x.shape[0], C, LOG_N, *after, loops,
                                    pk._stream(x.device))
        pk._raise_on(rc, name)
        return out
    return launch


def _tab4(x):
    return pk._ptr(pk._plan_tables_dev(_plan(), str(x.device)))


def _tab1(x):
    return pk._ptr(pk._plan_tables_dev(kb._plan1(N), str(x.device)))


def _garner_args(kind):
    P_ = int(kind[-1]) if kind.startswith("garner") else 2
    plan = ntt_mod.get_plan(N, max(P_, 2))
    base = kind.rstrip("_34") if kind.startswith("garner") else kind
    return (_TAIL_KIND[base], P_, MASK, pk._garner_host(plan),
            plan.full_prod_mod64, _BNF)


_ENTRIES = {
    "rot": ("v4_rot", 2, lambda x: ((), ())),
    "decomp": ("v4_decomp", 2, lambda x: ((), (BASE_LOG,))),
    "lift_twist": ("v4_lift_twist", 2,
                   lambda x: ((_tab1(x),), (PRIME0, LIFT_MASK,
                                            LIFT_OFFSET))),
    "fwd": ("v4_fwd", 3, lambda x: ((_tab4(x),), (0, LOG_N, _PRIMES))),
    "fwd_first4": ("v4_fwd", 3, lambda x: ((_tab4(x),), (0, 4, _PRIMES))),
    "mac2": ("v4_mac2", 2, lambda x, g2: ((pk._ptr(g2),), (PRIME0,))),
    "inv_untwist": ("v4_inv_untwist", 3,
                    lambda x: ((_tab4(x),), (_PRIMES,))),
}
PRIME0 = ntt_mod.PRIMES32[0]
TAILS = ("garner3", "garner4", "garner32_3", "garner32_4", "bnf2_c",
         "bnf2_c32")
for _k in TAILS:
    _ENTRIES[_k] = ("v4_tail", 2,
                    functools.partial(lambda x, k: ((), _garner_args(k)),
                                      k=_k))


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def batch(device) -> int:
    """Ciphertexts of a probe run: ``kernel_bench.bench_rows`` on a GPU
    (4 per SM), 2 on the CPU."""
    return kb.bench_rows(torch.device(device))


def _u32_inputs(high, polys=None, seed=0):
    def inputs(device):
        dev = torch.device(device)
        shape = (batch(dev),) + ((polys,) if polys else ()) + (N,)
        x = np.random.default_rng(seed).integers(0, high, shape, np.uint32)
        return (from_u32(x, dev),)
    return inputs


def _mac_inputs(device):
    dev = torch.device(device)
    rng = np.random.default_rng(5)
    x = rng.integers(0, PRIME0, (batch(dev), N), np.uint32)
    g = torch.from_numpy(rng.integers(0, PRIME0, size=(2, N)))
    return from_u32(x, dev), kb.mac_operands(g).to(dev)


_PLAIN = {
    "rot": rot_plain, "decomp": decomp_plain,
    "lift_twist": lift_twist_plain, "fwd": fwd_plain,
    "fwd_first4": functools.partial(fwd_plain, s0=0, s1=4),
    "mac2": mac2_plain, "inv_untwist": inv_untwist_plain,
    **{k: functools.partial(tail_plain, kind=k) for k in TAILS},
}
_INPUTS = {
    "rot": _u32_inputs(PRIME0), "decomp": _u32_inputs(1 << 32),
    "lift_twist": _u32_inputs(1 << 32),
    "fwd": _u32_inputs(PRIME0, POLYS), "fwd_first4": _u32_inputs(PRIME0,
                                                                 POLYS),
    "mac2": _mac_inputs, "inv_untwist": _u32_inputs(PRIME0, POLYS),
    **{k: _u32_inputs(1 << 32) for k in TAILS},
}
#: the JAX cases each piece mirrors, and the line of the first
_MIRRORS = {
    "rot": (["v4_rot", "g_rot"], 155),
    "decomp": (["g_decomp"], 445),
    "lift_twist": (["v4_fwd_with_split - v4_fwd_nosplit"], 152),
    "fwd": (["v4_fwd_nosplit, v3_fwd: an INT32 stand-in of the same size "
             "(forward_stages<4>)"], 153),
    "fwd_first4": (["v4_groups4_fwd", "g_groups4_fwd",
                    "g_groups4_fwd_lanerep"], 254),
    "mac2": (["v4_mac2"], 156),
    "inv_untwist": (["v4_inv, v3_inv: an INT32 stand-in of the same size "
                     "(inverse_stages<4> and the untwist)", "v4_tw_recombine",
                     "g_tw_recombine"], 154),
    "garner3": (["g_garner_crt_1c"], 444),
    "garner4": (["g_garner_crt_1c"], 444),
    "garner32_3": (["g_garner_crt_1c"], 444),
    "garner32_4": (["g_garner_crt_1c"], 444),
    "bnf2_c": (["g_garner_crt_1c"], 444),
    "bnf2_c32": (["g_garner_crt_1c"], 444),
}
#: the JAX case of the interleaved layout, where it has its own
_MIRRORS_G = {"rot": 378, "fwd": 375, "inv_untwist": 376}
_REQUIRED = {"rot": ("LOP3",), "decomp": ("SHF", "LOP3", "IADD3"),
             "lift_twist": ("IMAD.HI",), "mac2": ("IMAD.HI",),
             "fwd": ("IMAD.HI",), "fwd_first4": ("IMAD.HI",),
             "inv_untwist": ("IMAD.HI",),
             **{k: ("IMAD",) for k in TAILS}}
_STAGES = {"fwd": LOG_N, "fwd_first4": 4, "inv_untwist": LOG_N}
_TRIPS = {"fwd": (4, 36), "fwd_first4": (8, 136), "inv_untwist": (4, 36),
          "rot": (16, 400)}


def _units(piece):
    if piece in _STAGES:
        return lambda args: args[0].shape[0] * POLYS * (N // 2) * _STAGES[piece]
    return lambda args: args[0].shape[0] * N


def _pipes(piece):
    """The transforms' bound at K3's SASS counts per butterfly (and the
    untwist per element); the other pieces from their own loops."""
    ops = kb.SASS_OPS["blind_rotate_crt/4"]
    if piece in ("fwd", "fwd_first4"):
        per = ops["fwd_butterfly"]
        return lambda loops, args: tuple(c * _units(piece)(args) for c in per)
    if piece == "inv_untwist":
        tw = kb.SASS_OPS["kb_ntt_inv"]["twist"]
        per = ops["inv_butterfly"]
        return lambda loops, args: tuple(
            c * _units(piece)(args) + t * args[0].numel()
            for c, t in zip(per, tw))
    return None


def _with_brk(extra, brk: int):
    """The transforms' entries take a last flag: the step kernels' loop."""
    def args(x, *ops):
        before, after = extra(x, *ops)
        return before, after + (brk,)
    return args


def _case(piece: str, layout: str) -> h.Case:
    entry, ndim, extra = _ENTRIES[piece]
    if entry in ("v4_fwd", "v4_inv_untwist"):
        extra = _with_brk(extra, int(layout == "ct" and piece in BRK_PIECES))
    mirrors, line = _MIRRORS[piece]
    if layout == "il":
        line = _MIRRORS_G.get(piece, line)
    name = f"{piece}_{layout}"
    return h.Case(
        name, replaces=f"{SRC}:{line}", mirrors=mirrors,
        kernel=f"{piece}_{layout}",
        launch=_launcher(name, LAYOUTS[layout], entry, ndim, extra),
        plain=_PLAIN[piece], inputs=_INPUTS[piece], units=_units(piece),
        unit="butterfly" if piece in _STAGES else "element",
        required=_REQUIRED[piece], trips=_TRIPS.get(piece, (64, 1024)),
        pipes=_pipes(piece),
        note="C = 1 on the interleaved layout's loop" if layout == "il1"
        else "")


PIECES = ("rot", "decomp", "lift_twist", "fwd", "fwd_first4", "mac2",
          "inv_untwist") + TAILS

# ---------------------------------------------------------------------------
# the pass pieces of the new step
# ---------------------------------------------------------------------------

#: per step kernel: its entry (for the tail and the bound) and its primes
PASS_KERNELS = {"K1": ("blind_rotate_bnf2_acc32", 2),
                "K3_P4": ("blind_rotate_crt", 4)}
_R2, _L2 = 2, 1                     # 2_2: R, l
_PASS_TRIPS = {"tail": (16, 400)}


def _pass_tail(kernel: str):
    entry, P_ = PASS_KERNELS[kernel]
    return sp.tail_of(entry, P_, N, FLAVOR)


def _pass_inputs(kernel: str, batch_of=None):
    """Seeded operands of a pass piece: the block images (acc random, the
    digit area canonical residues below the smallest prime), one step of a
    valid key (true Shoup duals) and the rotations."""
    entry, P_ = PASS_KERNELS[kernel]
    tail = _pass_tail(kernel)

    def inputs(device):
        dev = torch.device(device)
        B = (batch_of or batch)(dev)
        rng = np.random.default_rng(11 + P_)
        acc_bits = 32 if tail.acc32 else 64
        acc = rng.integers(0, 1 << acc_bits, size=(B, _R2 * N),
                           dtype=np.uint64)
        dig = rng.integers(0, min(tail.plan.primes),
                           size=(B, _L2 * _R2 * P_ * N), dtype=np.uint64)
        acc_t = torch.from_numpy(acc.view(np.int64)).reshape(B, _R2, N)
        img = sp.to_image(acc_t, torch.from_numpy(dig.view(np.int64)),
                          tail.acc32)
        std = from_u64(rng.integers(0, 1 << 64, size=(1, _L2, _R2, _R2, N),
                                    dtype=np.uint64), "cpu")
        if entry == "blind_rotate_bnf2_acc32":
            key = bnf2_mod.bootstrap_key_to_bnf2(std, FLAVOR)[0]
        else:
            from ..core import algorithms as algo
            from ..core.entities import LweBootstrapKey

            key = pk.bsk_to_scan_layout(algo.bootstrap_key_to_ntt(
                LweBootstrapKey(std, BASE_LOG, _L2), P_).residues)[0]
        a = torch.from_numpy(rng.integers(0, 2 * N, size=B)).to(torch.int32)
        return (img.to(dev), key.contiguous().to(dev), a.to(dev))
    return inputs


def pass_piece_plain(x, key, a, loops, *, piece: str, kernel: str):
    """``loops`` trips of one pass piece on the block images (the CPU
    mirror, ``ops/step_passes.py``)."""
    _, P_ = PASS_KERNELS[kernel]
    tail = _pass_tail(kernel)
    tables = sp.tables_of(tail)
    plan = sp.make_pass_plan(LOG_N, _R2)
    acc, dig = sp.from_image(x.cpu(), P_, _R2, _L2, N, tail.acc32)
    k64, a64 = h.u32(key.cpu()), a.cpu().to(torch.int64)
    for _ in range(loops):
        acc, dig = sp.run_piece(piece, acc, dig, a64, k64, BASE_LOG, _L2,
                                tail, tables, plan)
        if tail.acc32:
            acc = acc & M32
    return sp.to_image(acc, dig, tail.acc32).to(x.device)


def _pass_launch(name: str, piece: str, kernel: str):
    entry, P_ = PASS_KERNELS[kernel]

    def launch(x, key, a, loops):
        h.cuda_operand(name, x, 2)
        h.cuda_operand(name, key, 5)
        plan = _pass_tail(kernel).plan
        out = torch.empty_like(x)
        rc = _lib().v4_pass_piece(
            pk._ptr(x), pk._ptr(out), pk._ptr(key),
            pk._ptr(pk._plan_tables_dev(plan, str(x.device))), pk._ptr(a),
            x.shape[0], _R2, _L2, BASE_LOG, LOG_N, sp.PIECES.index(piece),
            0 if P_ == 2 else 1, pk._garner_host(plan), plan.full_prod_mod64,
            _BNF, loops, pk._stream(x.device))
        pk._raise_on(rc, name)
        return out
    return launch


def pass_units(kernel: str) -> dict:
    """The work-floor units of each pass piece per ciphertext-step (as
    ``kernel_bench.step_pipe_instructions`` counts the whole step)."""
    _, P_ = PASS_KERNELS[kernel]
    plan = sp.make_pass_plan(LOG_N, _R2)
    lR, half, F = _L2 * _R2, N // 2, plan.fused
    return {
        "lift": {"element": _R2 * N, "level": lR * N,
                 "fwd_butterfly": P_ * lR * half * plan.fwd[0][1]},
        "fwd": {"fwd_butterfly": P_ * lR * half
                * sum(k for _, k in plan.fwd[1:])},
        "fused": {"fwd_butterfly": P_ * lR * half * F,
                  "mac": P_ * _R2 * lR * N,
                  "inv_butterfly": P_ * _R2 * half * F},
        "inv": {"inv_butterfly": P_ * _R2 * half
                * sum(k for _, k in plan.inv[:-1])},
        "tail": {"inv_butterfly": P_ * _R2 * half * plan.inv[-1][1],
                 "untwist_tail": _R2 * N}}


def _pass_pipes(piece: str, kernel: str):
    entry, P_ = PASS_KERNELS[kernel]
    key = entry if entry in kb.SASS_OPS else f"{entry}/{P_}"
    ops, units = kb.SASS_OPS[key], pass_units(kernel)[piece]
    return lambda loops, args: tuple(
        args[0].shape[0] * sum(u * ops[k][i] for k, u in units.items())
        for i in range(3))


def _pass_case(piece: str, kernel: str) -> h.Case:
    name = f"pass_{piece}_{kernel}"
    return h.Case(
        name, replaces=f"{SRC}:80", mirrors=[
            f"none: the {piece} piece of the step K1 and K3 run "
            "(ntt_common.cuh StepPasses)"],
        kernel=name, launch=_pass_launch(name, piece, kernel),
        plain=functools.partial(pass_piece_plain, piece=piece,
                                kernel=kernel),
        inputs=_pass_inputs(kernel), units=lambda args: args[0].shape[0],
        unit="ct-step", required=("IMAD.HI",),
        trips=_PASS_TRIPS.get(piece, (4, 36)),
        check_inputs=_pass_inputs(kernel, lambda dev: 8),
        pipes=_pass_pipes(piece, kernel))


PASS_CASES = tuple(_pass_case(pc, k) for k in PASS_KERNELS
                   for pc in sp.PIECES)

_V4_STALE = ("the JAX case cannot run (its [Bt, G, 128] loop carry "
             "refuses the [G, Bt, 128] output): mirrors {} on that layout")
MXU_CASES = (
    nm.case("v4_matmul_fold", "v4_fold", replaces=f"{SRC}:255",
            mirrors=["v4_matmul_fold", "g_matmul_fold"]),
    nm.case("v4_split4", "v4_split4", replaces=f"{SRC}:257",
            mirrors=["v4_split4"]),
    nm.case("v4_inv_matmul_recombine", "v4_inv_mmr", replaces=f"{SRC}:258",
            mirrors=["v4_inv_matmul_recombine"]),
    nm.case("v4_fwd_mxu", "v4_fwd", replaces=f"{SRC}:152",
            mirrors=["v4_fwd_with_split"],
            note=_V4_STALE.format("_fwd_ntt_v4")),
    nm.case("v4_fwd_mxu_nosplit", "v4_fwd_nosplit", replaces=f"{SRC}:153",
            mirrors=["v4_fwd_nosplit"], note=_V4_STALE.format("_fwd_ntt_v4")),
    nm.case("v4_inv_mxu", "v4_inv", replaces=f"{SRC}:154",
            mirrors=["v4_inv"], note=_V4_STALE.format("_inv_ntt_v4")),
)
CASES = tuple(_case(p, lay) for p in PIECES
              for lay in layouts_of(p)) + MXU_CASES + PASS_CASES
#: the references of the redesigned cases (bench-only)
SYNC_CASES = tuple(c.reference for c in MXU_CASES if c.reference is not None)

#: per kernel: library, parts of the mangled name, (ALU, FMA) loop totals
#: (see ``vpu_primitives.SASS_LOOP_TOTALS``)
_KERNEL_PARTS = {
    "rot": ("10rot_kernel",), "decomp": ("13decomp_kernel",),
    "lift_twist": ("17lift_twist_kernel",), "fwd": ("10fwd_kernel",),
    "fwd_first4": ("10fwd_kernel",), "mac2": ("11mac2_kernel",),
    "inv_untwist": ("18inv_untwist_kernel",),
    "garner3": ("11tail_kernel", "10GarnerTailILi3E"),
    "garner4": ("11tail_kernel", "10GarnerTailILi4E"),
    "garner32_3": ("11tail_kernel", "12GarnerTail32ILi3E"),
    "garner32_4": ("11tail_kernel", "12GarnerTail32ILi4E"),
    "bnf2_c": ("11tail_kernel", "8Bnf2TailE"),
    "bnf2_c32": ("11tail_kernel", "10Bnf2Tail32E"),
}
_TOTALS = {
    "rot_ct": (10, 5), "rot_il": (11, 5), "decomp_ct": (17, 2),
    "decomp_il": (17, 2), "lift_twist_ct": (6, 5), "lift_twist_il": (6, 5),
    "fwd_ct": (5, 6), "fwd_il1": (5, 6), "fwd_il": (5, 6),
    "fwd_first4_ct": (5, 6), "fwd_first4_il": (5, 6), "mac2_ct": (7, 8),
    "mac2_il": (7, 8), "inv_untwist_ct": (9, 11), "inv_untwist_il1": (9, 11),
    "inv_untwist_il": (9, 11),
    "garner3_ct": (16, 18), "garner3_il": (17, 18), "garner4_ct": (27, 32),
    "garner4_il": (26, 33), "garner32_3_ct": (15, 19),
    "garner32_3_il": (16, 18), "garner32_4_ct": (25, 34),
    "garner32_4_il": (26, 33), "bnf2_c_ct": (14, 13), "bnf2_c_il": (14, 13),
    "bnf2_c32_ct": (8, 7), "bnf2_c32_il": (8, 7)}


def _parts(piece: str, layout: str) -> tuple:
    """The parts of the mangled name of ``piece``'s kernel in ``layout``:
    the transforms' kernels are templates on C and on the loop they run."""
    c = LAYOUTS[layout]
    if piece in ("fwd", "fwd_first4", "inv_untwist"):
        brk = int(layout == "ct" and piece in BRK_PIECES)
        return _KERNEL_PARTS[piece] + (f"ILi{c}ELb{brk}E",)
    return _KERNEL_PARTS[piece] + (f"Li{c}E",)


SASS_LOOP_TOTALS = {
    f"{p}_{lay}": ("v4_probe", _parts(p, lay), _TOTALS[f"{p}_{lay}"])
    for p in _KERNEL_PARTS for lay in layouts_of(p)}
#: the MXU kernels' (ALU, FMA, tensor)
SASS_LOOP_TOTALS.update({
    op: (*nm.sass_entry(op), totals) for op, totals in (
        ("v4_fold", (100, 29, 5)), ("v4_split4", (4, 2, 0)),
        ("v4_inv_mmr", (241, 222, 5)), ("v4_fwd", (544, 522, 5)),
        ("v4_fwd_nosplit", (470, 509, 5)), ("v4_inv", (234, 87, 5)))})
#: their references' (mma.sync)
SASS_LOOP_TOTALS.update(nm.sync_totals({
    op: (op, 1, totals) for op, totals in (
        ("v4_fold", (1, 2, 4)), ("v4_inv_mmr", (62, 38, 4)),
        ("v4_fwd", (138, 97, 4)), ("v4_fwd_nosplit", (128, 96, 4)),
        ("v4_inv", (143, 102, 4)))}))

#: the pass pieces' kernels: Tail and piece in the mangled name
_PASS_TAIL_PART = {"K1": "10Bnf2Tail32E", "K3_P4": "10GarnerTailILi4EEE"}
_PASS_TOTALS = {
    "pass_lift_K1": (546, 302), "pass_fwd_K1": (182, 136),
    "pass_fused_K1": (353, 325), "pass_inv_K1": (119, 119),
    "pass_tail_K1": (124, 166), "pass_lift_K3_P4": (602, 302),
    "pass_fwd_K3_P4": (85, 102), "pass_fused_K3_P4": (353, 325),
    "pass_inv_K3_P4": (206, 156), "pass_tail_K3_P4": (326, 404)}
SASS_LOOP_TOTALS.update({
    f"pass_{pc}_{k}": ("v4_probe", ("17pass_piece_kernel",
                                    f"{_PASS_TAIL_PART[k]}Li{i}E"),
                       _PASS_TOTALS[f"pass_{pc}_{k}"])
    for k in PASS_KERNELS for i, pc in enumerate(sp.PIECES)})

#: units of each piece per ciphertext-step at 2_2 (R = 2, l = 1, N = 2048):
#: K1 with P = 2 primes and the bnf2_c32 tail, K3 with P = 4 and garner4
_R, _L, _BF = 2, 1, (N // 2) * LOG_N


def step_units(P_: int, tail: str) -> dict:
    lR = _L * _R
    return {"rot": _R * N, "decomp": lR * N, "lift_twist": P_ * lR * N,
            "fwd": P_ * lR * _BF, "mac2": P_ * _R * N,
            "inv_untwist": P_ * _R * _BF, tail: _R * N}


STEPS = {"K1": (2, "bnf2_c32", "fused_step_v6"),
         "K3_P4": (4, "garner4", "fused_step")}
#: the pieces of a split timed on what K3 runs instead of the kernel's own
STAND_INS = {
    "K1": {"rot": "the u64 rotation (K1 rotates a u32 accumulator)",
           "fwd": "forward_stages<4> per butterfly (K1 runs <2>)",
           "inv_untwist": "inverse_stages<4> and the untwist per butterfly "
                          "(K1 runs <2>)"},
    "K3_P4": {}}


def step_split(rows, measured: dict) -> list:
    """The pieces' seconds per ciphertext-step of K1 and K3 (P = 4) at
    2_2, in the ct layout: the units of :func:`step_units` times each
    piece's seconds per unit, their sum, and the remainder against
    ``measured`` ({"K1": s, "K3_P4": s} per ciphertext-step: the radix-2
    loop, whose pieces these are, ``fused_step_v6_r2`` / ``fused_step_r2``),
    with the pieces timed on a stand-in (:data:`STAND_INS`)."""
    per = {r["metric"][:-3]: r["ps_per_unit"] * 1e-12 for r in rows
           if r["metric"].endswith("_ct")}
    out = []
    for kernel, (P_, tail, _) in STEPS.items():
        pieces = {k: u * per[k] for k, u in step_units(P_, tail).items()}
        total = sum(pieces.values())
        out.append({"metric": f"step_split_{kernel}",
                    "pieces_us": {k: v * 1e6 for k, v in pieces.items()},
                    "sum_us": total * 1e6,
                    "measured_us": measured[kernel] * 1e6,
                    "remainder_us": (measured[kernel] - total) * 1e6,
                    "stand_ins": STAND_INS[kernel],
                    "card": rows[0]["card"]})
    return out


def pass_split(rows, measured: dict) -> list:
    """The pass pieces' seconds per ciphertext-step of K1 and K3 (P = 4)
    at 2_2 (each piece's row is per ciphertext-step), their sum, and the
    remainder against ``measured`` ({"K1": s, "K3_P4": s}: the step
    kernels' own per ciphertext-step)."""
    per = {r["metric"]: r["ps_per_unit"] * 1e-12 for r in rows
           if r["metric"].startswith("pass_")}
    out = []
    for kernel in PASS_KERNELS:
        pieces = {pc: per[f"pass_{pc}_{kernel}"] for pc in sp.PIECES}
        total = sum(pieces.values())
        out.append({"metric": f"pass_split_{kernel}",
                    "pieces_us": {k: v * 1e6 for k, v in pieces.items()},
                    "sum_us": total * 1e6,
                    "measured_us": measured[kernel] * 1e6,
                    "remainder_us": (measured[kernel] - total) * 1e6,
                    "card": rows[0]["card"]})
    return out


def reset_launches():
    h.reset(CASES + SYNC_CASES)


def iter_rows(quick: bool = False, device=None, measured: dict = None):
    """Every case's row (held against its plain version first on the GPU;
    ``quick``: 3 timed runs a point instead of 5), then the split of the
    radix-2 step into its pieces against the reference loops and of the
    new step into its passes against K1 and K3 (``measured``: {"K1": s,
    "K3_P4": s, "K1_r2": s, "K3_P4_r2": s} per ciphertext-step; default:
    ``kernel_bench.bench_step_v6`` and ``bench_step`` timed here). On the
    CPU the plain versions run and nothing is timed."""
    dev = resolve_device(device)
    rows = []
    for r in h.iter_rows(CASES, SASS_LOOP_TOTALS, dev, 3 if quick else 5):
        rows.append(r)
        yield r
    if dev.type != "cuda":
        return
    if measured is None:
        it = 3 if quick else 5
        measured = {}
        for k, bench_fn in (("K1", kb.bench_step_v6),
                            ("K3_P4", kb.bench_step)):
            new, ref = bench_fn(device=dev, iters=it)
            measured[k] = new["seconds_per_ct_step"]
            measured[f"{k}_r2"] = ref["seconds_per_ct_step"]
    yield from step_split(rows, {k: measured[f"{k}_r2"] for k in STEPS})
    yield from pass_split(rows, measured)


def run_all(quick: bool = False, device=None, measured: dict = None) -> list:
    return list(iter_rows(quick, device, measured))


def main(argv=None) -> int:
    return h.main(iter_rows, argv)


if __name__ == "__main__":
    import sys

    sys.exit(main())
