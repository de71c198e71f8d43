"""The NTT-variant probes on an NVIDIA GPU: transform variants on rows of
N = 2048 mod prime 0 of the 4-prime plan, each looped on rows resident in
shared memory (``csrc/ntt_variants.cu``).

Counterpart of ``tools/ntt_variants.py`` (pallas_call at ``:68``)::

    python -m tfhe_tpu_torch.tools.ntt_variants [out.jsonl]

prints one JSON row per case (and appends it to ``out.jsonl``); it runs on
the GPU and raises without one, and catches nothing. Every variant keeps
the output order of ``ntt_common.cuh``'s ``forward_stages`` (natural in,
DIF order out) and its exact butterflies, so each equals the plain
transform exactly and could take its place in K1 and K3:

- ``fwd_r2`` / ``inv_r2``: today's transform (the twist and
  ``forward_stages<1>``; ``inverse_stages<1>`` and the untwist), a block
  barrier per stage. One Hopper baseline stands for ``fwd_v1``/``fwd_v2``
  and ``inv_v1``/``inv_v2``, which differ only in TPU layout;
- ``fwd_r4`` / ``inv_r4``: radix-4, two stages per shared-memory pass;
- ``fwd_reg`` / ``inv_reg``: the stages of stride < 32 in registers,
  exchanged with ``__shfl_xor_sync``, no block barrier between them;
- ``first4``: the first four stages (``sliced4``; ``kernel_experiments``
  E5); ``last7_r2`` / ``last7_reg``: the last seven, in shared memory or
  with the five of stride < 32 in registers (``rolled7``,
  ``subl7_with_relayout``; E3/E4);
- ``transpose_128`` / ``transpose_128_pad``: a 128 x 128 tile transposed
  through shared memory and +1 per trip, rows of 128 or 129 words
  (``relayout_only`` is two trips; E1/E1b);
- ``fwd4_primes``: the four primes' forward transforms of one row, XOR-ed
  (``fwd4_primes_v1``/``_v2``), on ``forward_stages<4>``.

The MXU cases (``fwd_v3_mxu``, ``inv_v3_mxu``, ``inv_v3b_block_stages``,
``split4_only``, ``:171-191``) need int8 tensor-core kernels and are not
here. Each row's bound counts the radix-2 code's SASS instructions per
butterfly (``kernel_bench.SASS_OPS``), which every variant needs at least.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .._device import resolve_device
from .._torus import M32, from_u32
from ..ops import kernel_bench as kb
from ..ops import ntt as ntt_mod
from ..ops import pbs_kernel as pk
from . import _harness as h

N = 2048
LOG_N = 11
PRIME = ntt_mod.PRIMES32[0]  # prime 0 of tools/ntt_variants.py's plan
ONE_SH = (1 << 32) // PRIME  # the Shoup dual of 1
SRC = "tools/ntt_variants.py"
R2, R4, REG = 0, 1, 2
TILE = 128


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def fwd_stage_range(plan: ntt_mod.NegacyclicNtt, r: torch.Tensor, s0: int,
                    s1: int) -> torch.Tensor:
    """Forward DIF stages [s0, s1) of ``plan`` on canonical residues r
    (int64 [P, M, N]), as ``NegacyclicNtt._fwd_stages`` runs them all."""
    tb = plan.tables(r.device)
    P, M, n = r.shape
    p = plan._p(tb, 3)
    for s in range(s0, s1):
        m = n >> s
        rr = r.reshape(P, M, n // m, 2, m >> 1)
        a, b = rr[..., 0, :], rr[..., 1, :]
        u = a + b
        v = ntt_mod.shoup_mul(a - b + p, tb["fwd"][s][:, None, None],
                              tb["fwd_sh"][s][:, None, None], p)
        r = torch.stack([torch.where(u >= p, u - p, u), v],
                        dim=-2).reshape(P, M, n)
    return r


def stages_plain(x: torch.Tensor, loops: int, s0: int,
                 s1: int = None) -> torch.Tensor:
    """``loops`` trips of forward stages [s0, s1) mod PRIME (no twist) on
    rows of canonical residues, int32 [rows, N]; a negative s0 counts from
    the last stage, s1 None is the last."""
    plan = kb._plan1(x.shape[-1])
    log_n = plan.log_n
    s0, s1 = s0 % log_n if s0 < 0 else s0, log_n if s1 is None else s1
    y = h.u32(x)[None]
    for _ in range(loops):
        y = fwd_stage_range(plan, y, s0, s1)
    return h.to_storage(y[0])


def transpose_plain(x: torch.Tensor, loops: int) -> torch.Tensor:
    """``loops`` trips of x <- transpose(x) + 1 on 128 x 128 tiles of u32
    (int32 [tiles * 8, 2048], each tile 8 rows)."""
    y = h.u32(x).reshape(-1, TILE, TILE)
    for _ in range(loops):
        y = (y.transpose(1, 2) + 1) & M32
    return h.to_storage(y.reshape(x.shape))


def fwd4_plain(x: torch.Tensor, loops: int) -> torch.Tensor:
    """``loops`` trips of x <- the XOR of x's forward transforms mod the
    four primes of ``get_plan(N, 4)`` (x below 2^30: canonical or less
    than 2p for each)."""
    plan = ntt_mod.get_plan(x.shape[-1], 4)
    y = h.u32(x)
    for _ in range(loops):
        r = plan.fwd_digits(y)
        y = r[0] ^ r[1] ^ r[2] ^ r[3]
    return h.to_storage(y)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from .._build import cuda_lib

    lib = cuda_lib("ntt_variants")
    i, u, v = ctypes.c_int, ctypes.c_uint, ctypes.c_void_p
    lib.nv_transform.argtypes = [v, v, v, i, i, u, u, i, i, i, v]
    lib.nv_stage_range.argtypes = [v, v, v, i, i, i, i, u, u, i, i, v]
    lib.nv_transpose128.argtypes = [v, v, i, i, u, i, v]
    lib.nv_fwd4_primes.argtypes = [v, v, v, i, i, v, i, v]
    for e in (lib.nv_transform, lib.nv_stage_range, lib.nv_transpose128,
              lib.nv_fwd4_primes):
        e.restype = ctypes.c_int
    return lib


def _rows(name, x):
    h.cuda_operand(name, x, 2)
    if x.shape[1] != N:
        raise ValueError(f"{name}: rows of {x.shape[1]}, the kernel takes "
                         f"N = {N}")
    return x.shape[0], torch.empty_like(x)


def _tables(device, num_primes: int = 1):
    plan = kb._plan1(N) if num_primes == 1 else ntt_mod.get_plan(N, 4)
    return pk._plan_tables_dev(plan, str(device))


def _launch_transform(name, variant, inverse):
    def launch(x, loops):
        rows, out = _rows(name, x)
        rc = _lib().nv_transform(pk._ptr(x), pk._ptr(out),
                                 pk._ptr(_tables(x.device)), rows, LOG_N,
                                 PRIME, ONE_SH, variant, inverse, loops,
                                 pk._stream(x.device))
        pk._raise_on(rc, name)
        return out
    return launch


def _launch_stages(name, s0, s1, variant):
    def launch(x, loops):
        rows, out = _rows(name, x)
        rc = _lib().nv_stage_range(pk._ptr(x), pk._ptr(out),
                                   pk._ptr(_tables(x.device)), rows, LOG_N,
                                   s0, s1, PRIME, ONE_SH, variant, loops,
                                   pk._stream(x.device))
        pk._raise_on(rc, name)
        return out
    return launch


def _launch_transpose(name, pad):
    def launch(x, loops):
        rows, out = _rows(name, x)
        if rows % 8:
            raise ValueError(f"{name}: {rows} rows are no whole 128 x 128 "
                             "tiles")
        rc = _lib().nv_transpose128(pk._ptr(x), pk._ptr(out), rows // 8,
                                    int(pad), 1, loops, pk._stream(x.device))
        pk._raise_on(rc, name)
        return out
    return launch


_PRIMES4 = (ctypes.c_uint * 4)(*ntt_mod.PRIMES32[:4])


def _launch_fwd4(x, loops):
    rows, out = _rows("fwd4_primes", x)
    rc = _lib().nv_fwd4_primes(pk._ptr(x), pk._ptr(out),
                               pk._ptr(_tables(x.device, 4)), rows, LOG_N,
                               _PRIMES4, loops, pk._stream(x.device))
    pk._raise_on(rc, "fwd4_primes")
    return out


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def residues(device, rows: int = None, seed: int = 0):
    """``rows`` (default ``kernel_bench.bench_rows``) rows of N residues
    below PRIME, seeded as the JAX probe draws them."""
    dev = torch.device(device)
    rows = rows or kb.bench_rows(dev)
    x = np.random.default_rng(seed).integers(0, PRIME, (rows, N), np.uint32)
    return (from_u32(x, dev),)


def tiles(device, seed: int = 1):
    """Two 128 x 128 tiles per SM (16 on the CPU) of seeded u32."""
    dev = torch.device(device)
    n_tiles = 2 * kb.bench_rows(dev) // kb.ROWS_PER_SM if dev.type == "cuda" \
        else 2
    x = np.random.default_rng(seed).integers(0, 1 << 32, (n_tiles * 8, N),
                                             np.uint32)
    return (from_u32(x, dev),)


def _butterflies(stages):
    return lambda args: args[0].shape[0] * (N // 2) * stages


def _sass_rule(*terms):
    """(ALU, FMA, flex) per trip from ``kernel_bench.SASS_OPS`` rows: terms
    of (SASS_OPS kernel, unit, units per row per trip)."""
    def pipes(loops, args):
        rows = args[0].shape[0]
        return tuple(sum(kb.SASS_OPS[k][u][i] * n for k, u, n in terms)
                     * rows for i in range(3))
    return pipes


_BF = (N // 2) * LOG_N
_FWD = _sass_rule(("kb_ntt_fwd", "twist", N),
                  ("kb_ntt_fwd", "fwd_butterfly", _BF))
_INV = _sass_rule(("kb_ntt_inv", "twist", N),
                  ("kb_ntt_inv", "inv_butterfly", _BF))
_SHOUP = ("IMAD.HI",)


def _transform_case(name, variant, inverse, mirrors, line, note=""):
    plain = kb.kb_ntt_inv_plain if inverse else kb.kb_ntt_fwd_plain
    return h.Case(name, replaces=f"{SRC}:{line}", mirrors=mirrors,
                  kernel=f"{'inv' if inverse else 'fwd'}_{variant}",
                  launch=_launch_transform(name, variant, inverse),
                  plain=plain, inputs=residues, units=_butterflies(LOG_N),
                  unit="butterfly", required=_SHOUP, trips=(16, 256),
                  pipes=_INV if inverse else _FWD, note=note)


def _range_case(name, s0, s1, variant, mirrors, line, plain_range):
    return h.Case(name, replaces=f"{SRC}:{line}", mirrors=mirrors,
                  kernel=f"stages_{variant}",
                  launch=_launch_stages(name, s0, s1, variant),
                  plain=functools.partial(stages_plain, s0=plain_range[0],
                                          s1=plain_range[1]),
                  inputs=residues, units=_butterflies(s1 - s0),
                  unit="butterfly", required=_SHOUP, trips=(16, 256),
                  pipes=_sass_rule(("kb_ntt_fwd", "fwd_butterfly",
                                    (N // 2) * (s1 - s0))))


@functools.lru_cache(maxsize=4)
def _out_like(shape: tuple, device: str) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=device)


def transpose_library(x: torch.Tensor) -> torch.Tensor:
    """One trip as one PyTorch call: each 128 x 128 tile transposed and +1
    into a contiguous buffer (the output's layout makes it a transpose in
    memory, not an add in the input's order)."""
    out = _out_like(tuple(x.shape), str(x.device)).view(-1, TILE, TILE)
    return torch.add(x.view(-1, TILE, TILE).mT, 1, out=out).view(x.shape)


_R2_NOTE = "one Hopper baseline for the TPU layouts v1 and v2"
CASES = (
    _transform_case("fwd_r2", R2, 0, ["fwd_v1", "fwd_v2"], 94, _R2_NOTE),
    _transform_case("inv_r2", R2, 1, ["inv_v1", "inv_v2"], 98, _R2_NOTE),
    _transform_case("fwd_r4", R4, 0, ["fwd_v1", "fwd_v2"], 94),
    _transform_case("inv_r4", R4, 1, ["inv_v1", "inv_v2"], 98),
    _transform_case("fwd_reg", REG, 0, ["fwd_v1", "fwd_v2"], 94),
    _transform_case("inv_reg", REG, 1, ["inv_v1", "inv_v2"], 98),
    _range_case("first4", 0, 4, R2, ["sliced4", "kernel_experiments E5"],
                111, (0, 4)),
    _range_case("last7_r2", LOG_N - 7, LOG_N, R2,
                ["rolled7", "subl7_with_relayout", "kernel_experiments E3",
                 "kernel_experiments E4"], 124, (-7, None)),
    _range_case("last7_reg", LOG_N - 7, LOG_N, REG,
                ["rolled7", "subl7_with_relayout", "kernel_experiments E3",
                 "kernel_experiments E4"], 124, (-7, None)),
    *(h.Case(name, replaces=f"{SRC}:147", mirrors=mirrors,
             kernel=f"transpose_{pad}", launch=_launch_transpose(name, pad),
             plain=transpose_plain, inputs=tiles,
             units=lambda args: args[0].numel(), unit="element",
             required=("IADD3", "VIADD", "IMAD.IADD"), trips=(64, 1024),
             divisor=TILE * TILE // 512,
             library=transpose_library,
             note="relayout_only = two trips")
      for name, pad, mirrors in (
          ("transpose_128", 0, ["relayout_only", "kernel_experiments E1"]),
          ("transpose_128_pad", 1,
           ["relayout_only", "kernel_experiments E1b"]))),
    h.Case("fwd4_primes", replaces=f"{SRC}:207",
           mirrors=["fwd4_primes_v2", "fwd4_primes_v1"], kernel="fwd4",
           launch=_launch_fwd4, plain=fwd4_plain, inputs=residues,
           units=_butterflies(4 * LOG_N), unit="butterfly", required=_SHOUP,
           trips=(4, 64),
           pipes=_sass_rule(("kb_ntt_fwd", "twist", 4 * N),
                            ("kb_ntt_fwd", "fwd_butterfly", 4 * _BF))),
)

#: per kernel: library, parts of the mangled name, (ALU, FMA) loop totals
#: (see ``vpu_primitives.SASS_LOOP_TOTALS``)
SASS_LOOP_TOTALS = {
    "fwd_0": ("ntt_variants", ("6nv_fwdILi0E",), (7, 10)),
    "fwd_1": ("ntt_variants", ("6nv_fwdILi1E",), (27, 34)),
    "fwd_2": ("ntt_variants", ("6nv_fwdILi2E",), (66, 80)),
    "inv_0": ("ntt_variants", ("6nv_invILi0E",), (9, 11)),
    "inv_1": ("ntt_variants", ("6nv_invILi1E",), (37, 39)),
    "inv_2": ("ntt_variants", ("6nv_invILi2E",), (93, 95)),
    "stages_0": ("ntt_variants", ("9nv_stagesILi0E",), (5, 6)),
    "stages_2": ("ntt_variants", ("9nv_stagesILi2E",), (67, 74)),
    "transpose_0": ("ntt_variants", ("12nv_transposeILb0E",), (32, 0)),
    "transpose_1": ("ntt_variants", ("12nv_transposeILb1E",), (32, 0)),
    "fwd4": ("ntt_variants", ("7nv_fwd4",), (9, 10)),
}


def reset_launches():
    h.reset(CASES)


def iter_rows(quick: bool = False, device=None):
    """Every case's row, held against its plain version first on the GPU
    (``quick``: 3 timed runs a point instead of 5); on the CPU the plain
    versions run and nothing is timed."""
    yield from h.iter_rows(CASES, SASS_LOOP_TOTALS, resolve_device(device),
                           3 if quick else 5)


def run_all(quick: bool = False, device=None) -> list:
    return list(iter_rows(quick, device))


def main(argv=None) -> int:
    return h.main(iter_rows, argv)


if __name__ == "__main__":
    import sys

    sys.exit(main())
