"""The int8 tensor-core probes on an NVIDIA GPU: int8 products into int32
folded into a u32 tile, chained Shoup products, and the two mixed, each
looped on one [8, 2048] u32 tile per block (``csrc/mxu_probe.cu``).

Counterpart of ``tools/mxu_probe.py`` (pallas_call at ``:60``)::

    python -m tfhe_tpu_torch.tools.mxu_probe [out.jsonl]

prints one JSON row per case (and appends it to ``out.jsonl``); it runs on
the GPU and raises without one, and catches nothing. The cases, by the
JAX names and formulas: ``matmul_512x512`` ([L L L L] @ W512, L the tile
as [128, 128] int8, then ``fold``), ``matmul_384x512``,
``matmul_256r_384x512`` (256 rows), ``shoup_x8`` / ``shoup_x16`` (the
approx ``_shoup`` chained), ``mix_matmul512_shoupx8`` and
``mix_2matmul_shoupx16`` (one kernel that issues both: does the tensor
core run beside the INT32 pipes?). The product and mixed cases run
``mxu_probe_kernel`` on ``wgmma`` with the tables resident in a cluster of
two CTAs (four for ``mix_2matmul_shoupx16``; ``tools/_wgmma.py`` mirrors
its layout), each timed in turns
with its ``_sync`` reference (the first, ``mma.sync`` kernel, tables
through L2; bench-only); the Shoup cases keep that kernel. Each row gives the
JAX ``ns_per_loop`` (a tile-trip) and ``effective_tops``, the int8 MAC
rate and its share of the dense peak, the L2 bytes a trip reads, and a
``library_ms`` of ``torch._int_mm`` on the same product for the three
``matmul_*`` cases (a yardstick: no path of the port calls it); a last row,
``mix_overlap``, gives each mixed case's time over the larger of its
parts'.
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
from . import _wgmma as wgm

SRC = "tools/mxu_probe.py"
TILE, ROWS, N = 128, 8, 2048
WORDS = TILE * TILE
P0 = 0x3F5A0001
W = 12345677
WSH = (W << 32) // P0
MT = 2  # row tiles of a pass of the _sync kernel
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
    for e in (lib.mxu_probe, lib.mxu_probe_sync):
        e.argtypes = [v, v, v, v, i, i, u, u, u, i, i, v]
    lib.mxu_e2.argtypes = [v, v, v, i, i, v]
    lib.mxu_probe_occupancy.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
    for e in (lib.mxu_probe, lib.mxu_probe_sync, lib.mxu_e2,
              lib.mxu_probe_occupancy):
        e.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def weights_t(device: str) -> tuple:
    """W512^T [512, 512] and W384^T [512, 384] int8 on ``device``: the
    column-major copies the ``_sync`` kernel reads B from, made once."""
    return tuple(torch.from_numpy(np.ascontiguousarray(w.T)).to(device)
                 for w in weights())


@functools.lru_cache(maxsize=None)
def weights_images(device: str, cluster: int) -> tuple:
    """W512 and W384 as ``mxu_probe_kernel``'s cluster images on
    ``device`` (rank r's slice: the K-major swizzled W^T[512 r / C ..][K],
    ``_wgmma.cluster_image``), made once."""
    return tuple(wgm.cluster_image(w, cluster).to(device) for w in weights())


def _launch(op, sync: bool = False):
    def launch(x, loops):
        name = f"{op}_sync" if sync else op
        h.cuda_operand(name, x, 3)
        if tuple(x.shape[1:]) != (ROWS, N):
            raise ValueError(f"{name}: tiles of {tuple(x.shape[1:])}, the "
                             f"kernel takes ({ROWS}, {N})")
        if not sync and x.shape[0] % CLUSTER[op]:
            raise ValueError(f"{name}: {x.shape[0]} tiles, the kernel takes "
                             f"a multiple of its cluster ({CLUSTER[op]})")
        out = torch.empty_like(x)
        w5, w3 = (weights_t(str(x.device)) if sync
                  else weights_images(str(x.device), CLUSTER[op]))
        entry = _lib().mxu_probe_sync if sync else _lib().mxu_probe
        rc = entry(pk._ptr(x), pk._ptr(out), pk._ptr(w5), pk._ptr(w3),
                   x.shape[0], OPS[op], P0, W, WSH, loops, 0,
                   pk._stream(x.device))
        pk._raise_on(rc, name)
        return out
    return launch


def occupancy(op: str) -> dict:
    """``mxu_probe_kernel``'s resources for case ``op`` (a product case):
    registers, local (spill) bytes a thread, dynamic shared memory, cluster
    size, resident blocks per SM, clusters on the card."""
    out = (ctypes.c_int * 6)()
    pk._raise_on(_lib().mxu_probe_occupancy(OPS[op], out), op)
    return dict(zip(("registers", "local_bytes", "smem_bytes", "cluster",
                     "blocks_per_sm", "clusters"), out))


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
    """Runs of the K-block loop's body (4 m64n128k32 wgmma) a trip: per
    tile, its rows / 64 row tiles times the 4 column blocks (over the
    cluster's CTAs), K / 128 K-blocks."""
    return lambda args: args[0].shape[0] * sum(
        4 * (rows // 64) * (k // 128) for k, rows in _PRODUCTS[op])


def mma_trips_sync(op):
    """The ``_sync`` kernel's runs of the k loop's body (4 MT mma) a trip:
    16 warps, a pass per 32 rows, K / 32 steps."""
    return lambda args: args[0].shape[0] * sum(
        (THREADS // 32) * (rows // (16 * MT)) * (k // 32)
        for k, rows in _PRODUCTS[op])


#: the high trip count of the product cases' timing
TRIPS = (64, 1024)


def l2_bytes(op):
    """A trip's share of what a launch at the high trip count reads: each
    CTA (one a tile) its K x 512 / C slice of every table once, every tile
    in and out once."""
    return lambda args: args[0].shape[0] * (
        sum(k * 512 // CLUSTER[op] for k, _ in _PRODUCTS[op])
        + 2 * WORDS * 4) / TRIPS[1]


def l2_bytes_sync(op):
    """The ``_sync`` kernel: each pass reads the whole [K, 512] table."""
    return lambda args: args[0].shape[0] * sum(
        (rows // (16 * MT)) * k * 512 for k, rows in _PRODUCTS[op])


#: CTAs of a cluster of mxu_probe_kernel, per product case
CLUSTER = {op: wgm.mxu_cluster(op) for op, p in _PRODUCTS.items() if p}

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


_MMA = "wgmma.m64n128k32.s8, tables resident in a cluster of {}"
_MMA_SYNC = "mma.sync.m16n8k32.s8"


def _sync_case(op):
    """``op`` on the first, ``mma.sync`` kernel: the redesigned case's
    reference, bench-only."""
    return h.Case(
        f"{op}_sync", replaces=f"{SRC}:{_LINES[op]}", mirrors=[op],
        kernel=f"{op}_sync", launch=_launch(op, sync=True),
        plain=functools.partial(probe_plain, op=op), inputs=tiles,
        units=lambda args: args[0].shape[0], unit="tile", required=("IMMA",),
        trips=TRIPS, pipes=h.glue_pipes(lambda args: args[0].numel()),
        macs=macs(op), mma_trips=mma_trips_sync(op), l2_bytes=l2_bytes_sync(op),
        extra=_tops, mma=_MMA_SYNC,
        note="the reference: mma.sync m16n8k32 s8; B through L2, 4 passes "
        "of 32 rows")


def _case(op):
    mm = bool(_PRODUCTS[op])
    return h.Case(
        op, replaces=f"{SRC}:{_LINES[op]}", mirrors=[op], kernel=op,
        launch=_launch(op, sync=not mm),
        plain=functools.partial(probe_plain, op=op),
        inputs=tiles, units=lambda args: args[0].shape[0], unit="tile",
        required=("IGMMA",) if mm else ("IMAD",),
        trips=TRIPS if mm else (256, 4096),
        pipes=(h.thread_pipes(lambda args: args[0].shape[0] * THREADS) if mm
               else h.glue_pipes(lambda args: args[0].numel())),
        macs=macs(op) if mm else None, mma_trips=mma_trips(op) if mm else None,
        l2_bytes=l2_bytes(op) if mm else None,
        library=int_mm_library(op) if op.startswith("matmul") else None,
        extra=_tops, mma=_MMA.format(CLUSTER[op]) if mm else _MMA_SYNC,
        reference=_sync_case(op) if mm else None,
        note=f"wgmma m64n128k32 s8; tables resident in a cluster of "
        f"{CLUSTER[op]} CTAs (512 / {CLUSTER[op]} columns each), L across "
        "distributed shared memory" if mm else "")


CASES = tuple(_case(op) for op in OPS)
#: the references of the redesigned cases (bench-only)
SYNC_CASES = tuple(c.reference for c in CASES if c.reference is not None)

#: per kernel: library, parts of the mangled name, (ALU, FMA, tensor) loop
#: totals (see ``vpu_primitives.SASS_LOOP_TOTALS``); the product cases'
#: kernel is mxu_probe_kernel, the Shoup cases' and the references'
#: mxu_probe_kernel_sync
_TOTALS = {"matmul_512x512": (97, 26, 10), "matmul_384x512": (97, 26, 10),
           "matmul_256r_384x512": (162, 22, 20), "shoup_x8": (56, 48, 0),
           "shoup_x16": (114, 94, 0),
           "mix_matmul512_shoupx8": (1334, 1304, 10),
           "mix_2matmul_shoupx16": (2021, 1750, 20)}
_TOTALS_SYNC = {"matmul_512x512": (20, 2, 8), "matmul_384x512": (20, 2, 8),
                "matmul_256r_384x512": (20, 2, 8),
                "mix_matmul512_shoupx8": (68, 58, 8),
                "mix_2matmul_shoupx16": (135, 116, 16)}
SASS_LOOP_TOTALS = {
    op: ("mxu_probe", (f"16mxu_probe_kernelILi{i}E",) if _PRODUCTS[op]
         else (f"21mxu_probe_kernel_syncILi{i}E",), _TOTALS[op])
    for op, i in OPS.items()}
SASS_LOOP_TOTALS.update({
    f"{op}_sync": ("mxu_probe", (f"21mxu_probe_kernel_syncILi{OPS[op]}E",),
                   totals) for op, totals in _TOTALS_SYNC.items()})


def mix_overlap(rows: dict) -> dict:
    """Do the tensor cores run beside the INT32 pipes? Each mixed case's
    ns a tile-trip over the larger of its parts' (1: fully beside; the sum
    of the parts over the larger: one after the other), from one run's
    rows ({metric: row})."""
    ns = {m: rows[m]["ps_per_unit"] * 1e-3 for m in (
        "matmul_512x512", "matmul_384x512", "shoup_x8", "shoup_x16",
        "mix_matmul512_shoupx8", "mix_2matmul_shoupx16")}
    parts = {"mix_matmul512_shoupx8": (ns["matmul_512x512"], ns["shoup_x8"]),
             "mix_2matmul_shoupx16": (ns["matmul_512x512"]
                                      + ns["matmul_384x512"],
                                      ns["shoup_x16"])}
    return {"metric": "mix_overlap", "ns_per_tile_loop": ns,
            "over_max_of_parts": {m: ns[m] / max(p) for m, p in parts.items()},
            "over_sum_of_parts": {m: ns[m] / sum(p) for m, p in parts.items()},
            "mma": rows["matmul_512x512"]["mma"],
            "card": rows["matmul_512x512"]["card"]}


def reset_launches():
    h.reset(CASES + SYNC_CASES)


def iter_rows(quick: bool = False, device=None):
    """Every case's row, held against its plain version first on the GPU
    (``quick``: 3 timed runs a point instead of 5); on the CPU the plain
    versions run and nothing is timed."""
    dev = resolve_device(device)
    rows = {}
    for r in h.iter_rows(CASES, SASS_LOOP_TOTALS, dev, 3 if quick else 5):
        rows[r["metric"]] = r
        yield r
    if dev.type != "cpu":
        yield mix_overlap(rows)


def run_all(quick: bool = False, device=None) -> list:
    return list(iter_rows(quick, device))


def main(argv=None) -> int:
    return h.main(iter_rows, argv)


if __name__ == "__main__":
    import sys

    sys.exit(main())
