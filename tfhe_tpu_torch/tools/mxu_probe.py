"""The int8 tensor-core probes on an NVIDIA GPU: int8 products into int32
folded into a u32 tile, chained Shoup products, and the two mixed, each
looped on one [8, 2048] u32 tile per block resident in shared memory
(``csrc/mxu_probe.cu``, on ``mma.sync.m16n8k32``).

Counterpart of ``tools/mxu_probe.py`` (pallas_call at ``:60``)::

    python -m tfhe_tpu_torch.tools.mxu_probe [out.jsonl]

prints one JSON row per case (and appends it to ``out.jsonl``); it runs on
the GPU and raises without one, and catches nothing. The cases, by the
JAX names and formulas: ``matmul_512x512`` ([L L L L] @ W512, L the tile
as [128, 128] int8, then ``fold``), ``matmul_384x512``,
``matmul_256r_384x512`` (256 rows), ``shoup_x8`` / ``shoup_x16`` (the
approx ``_shoup`` chained), ``mix_matmul512_shoupx8`` and
``mix_2matmul_shoupx16`` (one kernel that issues both: does the tensor
core run beside the INT32 pipes?). Each row gives the JAX
``ns_per_loop`` (a tile-trip) and ``effective_tops``, the int8 MAC rate
and its share of the dense peak, the L2 bytes a trip reads (the 192 or
256 KiB weights, streamed by every block: 4 passes of 32 rows), and a
``library_ms`` of ``torch._int_mm`` on the same product for the three
``matmul_*`` cases (a yardstick: no path of the port calls it).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .._device import resolve_device
from .._torus import from_u32
from ..ops import kernel_bench as kb
from ..ops import pbs_kernel as pk
from . import _harness as h
from . import _int8 as q

SRC = "tools/mxu_probe.py"
TILE, ROWS, N = 128, 8, 2048
WORDS = TILE * TILE
P0 = 0x3F5A0001
W = 12345677
WSH = (W << 32) // P0
MT = 2  # row tiles of a pass of csrc/mxu_probe.cu
THREADS = 512
OPS = {"matmul_512x512": 0, "matmul_384x512": 1, "matmul_256r_384x512": 2,
       "shoup_x8": 3, "shoup_x16": 4, "mix_matmul512_shoupx8": 5,
       "mix_2matmul_shoupx16": 6}


@functools.lru_cache(maxsize=None)
def weights() -> tuple:
    """W512 [512, 512] and W384 [384, 512] int8, seeded as
    ``tools/mxu_probe.py:36-38`` draws them."""
    rng = np.random.default_rng(0)
    return (rng.integers(-128, 128, (512, 512), np.int8),
            rng.integers(-128, 128, (384, 512), np.int8))


# ---------------------------------------------------------------------------
# plain versions: int32 [tiles, 8, 2048] u32 storage in and out
# ---------------------------------------------------------------------------

def _product(y: torch.Tensor, w, copies: int, rows: int = TILE):
    """U = [L]*copies (rows ``rows``: L's rows repeated) @ w, int64
    [tiles, rows, 512]."""
    L = q.i8(y).reshape(-1, TILE, TILE)
    A = torch.cat([L] * copies, dim=-1).repeat(1, rows // TILE, 1)
    return q.matmul(A, q.table(w, y.device))


def fold(y: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """``fold``: V = U[:, :128] + (U[:, 128:256] << 8) as u32, y ^= 3 V's
    first 2048 words on every row of the tile."""
    V = q.wrap(U[:, :TILE, :TILE] + (U[:, :TILE, TILE:2 * TILE] << 8))
    return y ^ q.wrap(V.reshape(V.shape[0], 1, -1)[..., :N] * 3)


def shoup_chain(y: torch.Tensor, k: int) -> torch.Tensor:
    for _ in range(k):
        y = q.shoup(y, W, WSH, P0)
    return y


def probe_plain(x: torch.Tensor, loops: int, op: str) -> torch.Tensor:
    """``loops`` trips of case ``op`` on each tile."""
    w512, w384 = weights()
    y = h.u32(x)
    for _ in range(loops):
        if op == "matmul_512x512":
            y = fold(y, _product(y, w512, 4))
        elif op == "matmul_384x512":
            y = fold(y, _product(y, w384, 3))
        elif op == "matmul_256r_384x512":
            y = fold(y, _product(y, w384, 3, 2 * TILE))
        elif op in ("shoup_x8", "shoup_x16"):
            y = shoup_chain(y, int(op[7:]))
        elif op == "mix_matmul512_shoupx8":
            y = fold(shoup_chain(y, 8), _product(y, w512, 4))
        else:
            U, U2 = _product(y, w512, 4), _product(y, w384, 3)
            y = fold(fold(shoup_chain(y, 16), U), U2)
    return h.to_storage(y)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from .._build import cuda_lib

    lib = cuda_lib("mxu_probe")
    i, u, v = ctypes.c_int, ctypes.c_uint, ctypes.c_void_p
    lib.mxu_probe.argtypes = [v, v, v, v, i, i, u, u, u, i, i, v]
    lib.mxu_e2.argtypes = [v, v, v, i, i, v]
    for e in (lib.mxu_probe, lib.mxu_e2):
        e.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def weights_t(device: str) -> tuple:
    """W512^T [512, 512] and W384^T [512, 384] int8 on ``device``: the
    column-major copies the kernel reads B from, made once."""
    return tuple(torch.from_numpy(np.ascontiguousarray(w.T)).to(device)
                 for w in weights())


def _launch(op):
    def launch(x, loops):
        h.cuda_operand(op, x, 3)
        if tuple(x.shape[1:]) != (ROWS, N):
            raise ValueError(f"{op}: tiles of {tuple(x.shape[1:])}, the "
                             f"kernel takes ({ROWS}, {N})")
        out = torch.empty_like(x)
        w512t, w384t = weights_t(str(x.device))
        rc = _lib().mxu_probe(pk._ptr(x), pk._ptr(out), pk._ptr(w512t),
                              pk._ptr(w384t), x.shape[0], OPS[op], P0, W,
                              WSH, loops, 0, pk._stream(x.device))
        pk._raise_on(rc, op)
        return out
    return launch


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def tiles(device, seed: int = 0):
    """``kernel_bench.bench_rows`` tiles of [8, 2048] residues below P0
    (528 on an H100, 2 on the CPU)."""
    dev = torch.device(device)
    x = np.random.default_rng(seed).integers(
        0, P0, (kb.bench_rows(dev), ROWS, N), np.uint32)
    return (from_u32(x, dev),)


#: per case: (K, rows) of each product a trip
_PRODUCTS = {"matmul_512x512": ((512, 128),),
             "matmul_384x512": ((384, 128),),
             "matmul_256r_384x512": ((384, 256),),
             "shoup_x8": (), "shoup_x16": (),
             "mix_matmul512_shoupx8": ((512, 128),),
             "mix_2matmul_shoupx16": ((512, 128), (384, 128))}


def macs(op):
    return lambda args: args[0].shape[0] * sum(
        rows * k * 512 for k, rows in _PRODUCTS[op])


def mma_trips(op):
    """Runs of the k loop's body (4 MT mma) a trip: 16 warps, a pass per
    32 rows, K / 32 steps."""
    return lambda args: args[0].shape[0] * sum(
        (THREADS // 32) * (rows // (16 * MT)) * (k // 32)
        for k, rows in _PRODUCTS[op])


def l2_bytes(op):
    """Each pass reads the whole [K, 512] table."""
    return lambda args: args[0].shape[0] * sum(
        (rows // (16 * MT)) * k * 512 for k, rows in _PRODUCTS[op])


_LIB_A = {}


def int_mm_library(op):
    """One trip's product of case ``op`` as one PyTorch call:
    ``torch._int_mm`` of every tile's rows [L ...] ([tiles*rows, K]) @ W
    (the rows made once, W column-major)."""
    (k, rows), = _PRODUCTS[op]
    w = 0 if k == 512 else 1

    def library(x):
        key = (x.data_ptr(), tuple(x.shape), op)
        if key not in _LIB_A:
            L = (x.view(-1, TILE, TILE) & 0xFF).to(torch.uint8).view(
                torch.int8)
            A = torch.cat([L] * (k // TILE), dim=-1).repeat(1, rows // TILE,
                                                            1)
            _LIB_A.clear()
            _LIB_A[key] = A.reshape(-1, k).contiguous()
        return torch._int_mm(_LIB_A[key], weights_t(str(x.device))[w].T)
    return library


def _tops(case, args, row):
    """The JAX row's keys: ns a tile-trip and 2 MACs / s in T."""
    per_tile = row["ps_per_unit"] * 1e-12
    out = {"ns_per_tile_loop": per_tile * 1e9}
    if row.get("int8_macs_per_loop"):
        out["effective_tops"] = 2 * row["int8_macs_per_loop"] / row[
            "units_per_loop"] / per_tile / 1e12
    return out


_LINES = {"matmul_512x512": 105, "matmul_384x512": 107,
          "matmul_256r_384x512": 120, "shoup_x8": 123, "shoup_x16": 124,
          "mix_matmul512_shoupx8": 133, "mix_2matmul_shoupx16": 143}


def _case(op):
    mm = bool(_PRODUCTS[op])
    return h.Case(
        op, replaces=f"{SRC}:{_LINES[op]}", mirrors=[op], kernel=op,
        launch=_launch(op), plain=functools.partial(probe_plain, op=op),
        inputs=tiles, units=lambda args: args[0].shape[0], unit="tile",
        required=("IMMA",) if mm else ("IMAD",),
        trips=(64, 1024) if mm else (256, 4096),
        pipes=h.glue_pipes(lambda args: args[0].numel()),
        macs=macs(op) if mm else None, mma_trips=mma_trips(op) if mm else None,
        l2_bytes=l2_bytes(op) if mm else None,
        library=int_mm_library(op) if op.startswith("matmul") else None,
        extra=_tops,
        note="mma.sync m16n8k32 s8; B through L2, 4 passes of 32 rows"
        if mm else "")


CASES = tuple(_case(op) for op in OPS)

#: per kernel: library, parts of the mangled name, (ALU, FMA, tensor) loop
#: totals (see ``vpu_primitives.SASS_LOOP_TOTALS``)
_TOTALS = {"matmul_512x512": (20, 2, 8), "matmul_384x512": (20, 2, 8),
           "matmul_256r_384x512": (20, 2, 8), "shoup_x8": (56, 48, 0),
           "shoup_x16": (114, 94, 0), "mix_matmul512_shoupx8": (68, 58, 8),
           "mix_2matmul_shoupx16": (135, 116, 16)}
SASS_LOOP_TOTALS = {
    op: ("mxu_probe", (f"16mxu_probe_kernelILi{i}E",), _TOTALS[op])
    for op, i in OPS.items()}


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
