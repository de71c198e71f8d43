"""The kernel-design experiments on an NVIDIA GPU: E2, the looped int8
product ``acc += L @ W`` on the tensor cores (``csrc/mxu_probe.cu``'s
``e2_kernel``, on ``mma.sync.m16n8k32``), and the rows of E1, E1b, E3, E4
and E5 from ``ntt_variants``' kernels.

Counterpart of ``tools/kernel_experiments.py`` (pallas_call at ``:108``,
E2; E1-E5 run through ``kernel_bench._looped_pallas``)::

    python -m tfhe_tpu_torch.tools.kernel_experiments [out.jsonl]

prints one JSON row per case (and appends it to ``out.jsonl``); it runs on
the GPU and raises without one, and catches nothing.

- ``int8_matmul_128x512x128`` (E2): L [128, 512] and W [512, 128] int8
  resident in shared memory (one block per SM: 135 KiB), one tile per
  block, the int32 accumulator wrapping. Its row is the card's
  ``mma.sync`` ceiling: MAC/s and ``mxu_fraction``, the share of the dense
  int8 peak. It is checked at 1 trip on the seeded tiles and, past the
  wrap, at 700 trips on a tile whose products all align (512 * 127 * 127
  a trip at most: a saturating accumulator fails there);
- ``int8_gemm_library``: ``torch._int_mm`` of every tile at once,
  [tiles*128, 512] @ [512, 128], cuBLAS's int8 rate at this width, as
  the yardstick (no path of the port calls it);
- E1, E1b, E3, E4, E5: ``ntt_variants``' ``transpose_128``,
  ``transpose_128_pad``, ``last7_r2`` (E3 and E4) and ``first4`` rows under
  the JAX metric names; no new kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._device import resolve_device
from ..ops import kernel_bench as kb
from ..ops import pbs_kernel as pk
from . import _harness as h
from . import _int8 as q
from . import ntt_variants as nv
from .mxu_probe import _lib

SRC = "tools/kernel_experiments.py"
ROWS, K, COLS = 128, 512, 128
WARPS, KSTEPS = 8, K // 32
CHECK_TRIPS = 700  # past the wrap of an aligned tile (at most 420 trips)


def e2_inputs(device, seed: int = 2):
    """``kernel_bench.bench_rows`` tiles L [128, 512] (528 on an H100, 2
    on the CPU) and one W [512, 128], int8 in [-127, 127] as the JAX case
    draws them."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    L = rng.integers(-127, 128, (kb.bench_rows(dev), ROWS, K), np.int8)
    W = rng.integers(-127, 128, (K, COLS), np.int8)
    return torch.from_numpy(L).to(dev), torch.from_numpy(W).to(dev)


def e2_aligned_inputs(device, seed: int = 3):
    """Tiles whose products all share a sign: L[r, k] = s_k m_r, W[k, c] =
    s_k n_c (m, n in [100, 127]), so each trip adds 512 m_r n_c > 5.1e6 and
    the accumulator wraps within 420 trips."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    s = rng.choice(np.array([-1, 1], np.int64), K)
    m = rng.integers(100, 128, (2, ROWS, 1))
    n = rng.integers(100, 128, (1, COLS))
    L = (m * s[None, None, :]).astype(np.int8)
    W = (s[:, None] * n).astype(np.int8)
    return torch.from_numpy(L).to(dev), torch.from_numpy(W).to(dev)


def e2_plain(L: torch.Tensor, W: torch.Tensor, loops: int) -> torch.Tensor:
    """acc after ``loops`` trips of acc += L @ W from 0, int32 wrapping:
    int32 [tiles, 128, 128]."""
    prod = q.matmul(L.long(), W.long())
    acc = q.wrap(prod * loops)
    return (((acc + q.BIAS31) & 0xFFFFFFFF) - q.BIAS31).to(torch.int32)


@functools.lru_cache(maxsize=4)
def _wt(ptr: int, W: torch.Tensor) -> torch.Tensor:
    return W.T.contiguous()


def e2_launch(L: torch.Tensor, W: torch.Tensor, loops: int) -> torch.Tensor:
    for name, t, shape in (("L", L, (ROWS, K)), ("W", W, (K, COLS))):
        if t.device.type != "cuda" or t.dtype != torch.int8:
            raise ValueError(f"E2 {name}: int8 on a CUDA device, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape[-2:]) != shape or not t.is_contiguous():
            raise ValueError(f"E2 {name}: contiguous [..., {shape}], got "
                             f"{tuple(t.shape)}")
    out = torch.empty((L.shape[0], ROWS, COLS), dtype=torch.int32,
                      device=L.device)
    rc = _lib().mxu_e2(pk._ptr(L), pk._ptr(_wt(W.data_ptr(), W)),
                       pk._ptr(out), L.shape[0], loops,
                       pk._stream(L.device))
    pk._raise_on(rc, "int8_matmul_128x512x128")
    return out


def int_mm(L: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Every tile's product as one ``torch._int_mm`` call (W column-major,
    the layout cuBLAS's int8 kernels take)."""
    return torch._int_mm(L.view(-1, K), _wt(W.data_ptr(), W).T)


def _e2_extra(case, args, row):
    """The JAX row's keys: seconds a tile-trip, MAC/s, mxu_fraction."""
    return {"sec_per_loop": row["ps_per_unit"] * 1e-12,
            "mac_per_s": row["int8_mac_per_s"],
            "mxu_fraction": row["int8_tensor_fraction"]}


E2 = h.Case(
    "int8_matmul_128x512x128", replaces=f"{SRC}:108",
    mirrors=["int8_matmul_128x512x128"], kernel="e2", launch=e2_launch,
    plain=e2_plain, inputs=e2_inputs, units=lambda args: args[0].shape[0],
    unit="tile", required=("IMMA",), trips=(64, 4096), check=1,
    more_checks=((e2_aligned_inputs, CHECK_TRIPS),),
    pipes=h.glue_pipes(lambda args: 0),
    macs=lambda args: args[0].shape[0] * ROWS * K * COLS,
    mma_trips=lambda args: args[0].shape[0] * WARPS * KSTEPS,
    library=int_mm, extra=_e2_extra,
    note="mma.sync m16n8k32 s8, L and W^T in shared memory, one block "
         "per SM")

CASES = (E2,)

#: E1, E1b, E3, E4, E5: (JAX metric, ntt_variants case, line)
E_ROWS = (("transpose_128x128_u32", "transpose_128", 70),
          ("relayout_roundtrip_8x2048", "transpose_128_pad", 85),
          ("sublane_7stages_128x128", "last7_r2", 156),
          ("rolled_7stages_8x2048", "last7_r2", 178),
          ("sliced_4stages_8x2048", "first4", 192))

#: (ALU, FMA, tensor) loop totals (see ``mxu_probe.SASS_LOOP_TOTALS``)
SASS_LOOP_TOTALS = {"e2": ("mxu_probe", ("9e2_kernel",), (0, 0, 16))}


def library_row(device, calls: int = 64, iters: int = 5) -> dict:
    """``torch._int_mm`` of all tiles in one call: ms (``calls`` calls back
    to back between one pair of CUDA events, so that no launch gap is
    counted; the median of ``iters``), MAC/s and the share of the dense
    int8 peak."""
    L, W = e2_inputs(device)

    def many():
        for _ in range(calls):
            int_mm(L, W)

    ms = kb._time_fn(many, iters) * 1e3 / calls
    macs = E2.macs((L, W))
    rates = kb.card_rates(L.device.index or 0)
    return {"metric": "int8_gemm_library", "call": "torch._int_mm",
            "shape": f"[{L.shape[0] * ROWS}, {K}] @ [{K}, {COLS}]",
            "ms": ms, "mac_per_s": macs / ms * 1e3,
            "int8_tensor_fraction": macs / ms * 1e3 / rates["int8_mac"],
            "card": rates["card"]}


def reset_launches():
    h.reset(CASES)


def iter_rows(quick: bool = False, device=None):
    """E2's row (held against its plain version first on the GPU), the
    library row, then the E rows of ``ntt_variants``' kernels; on the CPU
    the plain versions run and nothing is timed."""
    dev = resolve_device(device)
    it = 3 if quick else 5
    yield from h.iter_rows(CASES, SASS_LOOP_TOTALS, dev, it)
    if dev.type == "cuda":
        yield library_row(dev)
    cases = {c.name: c for c in nv.CASES}
    for metric, name, line in E_ROWS:
        (r,) = h.iter_rows((cases[name],), nv.SASS_LOOP_TOTALS, dev, it)
        yield dict(r, metric=metric, replaces=f"{SRC}:{line}",
                   mirrors=[metric, f"ntt_variants {name}"])


def run_all(quick: bool = False, device=None) -> list:
    return list(iter_rows(quick, device))


def main(argv=None) -> int:
    return h.main(iter_rows, argv)


if __name__ == "__main__":
    import sys

    sys.exit(main())
