"""The v3c small-DFT experiments on an NVIDIA GPU: the glue around the int8
small DFT of the v3 transforms (offset or balanced limb split, one merged
[512, 512] product or four [512, 128] ones, the pair fold), each looped on
one polynomial of N = 2048 per block on the tensor cores
(``csrc/ntt_mxu.cu``, ``tools/ntt_mxu.py``), at prime 0 of
``_get_tables(2048, 4)``.

Counterpart of ``tools/ntt_v3c_experiments.py`` (pallas_call at
``:320``)::

    python -m tfhe_tpu_torch.tools.ntt_v3c_experiments [out.jsonl]

prints one JSON row per case (and appends it to ``out.jsonl``); it runs on
the GPU and raises without one, and catches nothing.

- ``mm4_only``: the balanced split of condsub(x, p), its products with the
  four [512, 128] limb matrices summed, + x (one [16, 512] @ [512, 512]
  product, its four column blocks summed: the same MACs);
- ``mm1_only``: the offset split and the merged [512, 512] product, its
  four column blocks summed, + x;
- ``mm1_rows256`` / ``mm1_rows512``: the rows repeated 2x and 4x, every
  MAC issued, the JAX sums of the copies; their units are 2 and 4
  transforms a polynomial, as the JAX docstrings count them;
- ``fwd_v3_base``, ``fwd_v3c`` and ``inv_v3b_base``, ``inv_v3c``,
  ``inv_v3c_rolls``: the rows of ``ntt_variants``' ``v3_fwd_mxu`` and
  ``v3_inv_mxu`` (``_fwd_ntt_v3`` / ``_inv_ntt_v3b``: the v3c glue is what
  the JAX package runs today) under the JAX names. The JAX bases are stale
  (they pass the old 4-tuple constants and the unmerged [P, 4, 512, 128]
  table to ``_mxu_small_dft`` and raise ``KeyError``), so the v3c cases,
  checked against them, print an error row there.
"""

from __future__ import annotations

from .._device import resolve_device
from . import _harness as h
from . import ntt_mxu as nm
from . import ntt_variants as nv

SRC = "tools/ntt_v3c_experiments.py"

CASES = (
    nm.case("mm4_only", "mm4", replaces=f"{SRC}:375", mirrors=["mm4_only"]),
    nm.case("mm1_only", "mm1", replaces=f"{SRC}:376", mirrors=["mm1_only"]),
    nm.case("mm1_rows256", "mm1", replaces=f"{SRC}:377",
            mirrors=["mm1_rows256"], copies=2),
    nm.case("mm1_rows512", "mm1", replaces=f"{SRC}:378",
            mirrors=["mm1_rows512"], copies=4),
)

#: (JAX metric, ntt_variants case, line)
V3_ROWS = (("fwd_v3_base", "v3_fwd_mxu", 370),
           ("fwd_v3c", "v3_fwd_mxu", 371),
           ("inv_v3b_base", "v3_inv_mxu", 372),
           ("inv_v3c", "v3_inv_mxu", 373),
           ("inv_v3c_rolls", "v3_inv_mxu", 374))

#: per kernel: library, parts of the mangled name, (ALU, FMA, tensor) loop
#: totals (see ``vpu_primitives.SASS_LOOP_TOTALS``)
SASS_LOOP_TOTALS = {
    "mm4": (*nm.sass_entry("mm4"), (288, 60, 5)),
    "mm1": (*nm.sass_entry("mm1"), (180, 16, 5)),
    "mm1_2": (*nm.sass_entry("mm1", 2), (133, 80, 5)),
    "mm1_4": (*nm.sass_entry("mm1", 4), (133, 80, 5)),
}
SASS_LOOP_TOTALS.update(nm.sync_totals({
    "mm4": ("mm4", 1, (20, 4, 4)), "mm1": ("mm1", 1, (17, 1, 4)),
    "mm1_2": ("mm1", 2, (25, 1, 8)), "mm1_4": ("mm1", 4, (41, 1, 16))}))
#: the references of the redesigned cases (bench-only)
SYNC_CASES = tuple(c.reference for c in CASES)


def reset_launches():
    h.reset(CASES + SYNC_CASES)


def iter_rows(quick: bool = False, device=None):
    """Every case's row (held against its plain version first on the
    GPU), then the v3 transforms' rows under the JAX names; on the CPU the
    plain versions run and nothing is timed."""
    dev = resolve_device(device)
    it = 3 if quick else 5
    yield from h.iter_rows(CASES, SASS_LOOP_TOTALS, dev, it)
    cases = {c.name: c for c in nv.CASES}
    for metric, name, line in V3_ROWS:
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
