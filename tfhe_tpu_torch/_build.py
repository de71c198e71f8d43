"""Build-on-first-use for the port's native code, loaded with ctypes.

Two kinds of source live in ``csrc/``:

- ``aes_ctr.c`` and ``bls446.c``: host code compiled with ``cc``, the
  AES-CTR keystream and the BLS12-446 curve's hot loops (the ZK proofs'
  MSMs, CRS powers and pairings). When no compiler is present the CSPRNG
  keeps its bit-identical numpy path and ``zk/curve.py`` its pure-Python
  curve (the spec both are held to).
- ``*.cu``: the CUDA kernels, compiled with ``nvcc`` for ``sm_90a`` into a
  shared library with a plain C interface (no PyTorch headers, so a build
  takes seconds). A missing or failing nvcc raises: there is no CPU stand-in
  for a CUDA tensor.

Outputs go to ``tfhe_tpu_torch/_build/`` (git-ignored), each written to a
temporary name and renamed into place, so concurrent processes never load
a half-written library. A library is rebuilt when its source is newer, a
CUDA library also when any ``.cuh`` header under ``csrc/`` is. Beside each
CUDA library the build leaves ptxas' report and the kernels' SASS.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _cuda_headers() -> list:
    """Every CUDA header under ``csrc/`` (any ``.cu`` may include any)."""
    return [os.path.join(CSRC, f) for f in sorted(os.listdir(CSRC))
            if f.endswith(".cuh")]


def _stale(so: str, *deps: str) -> bool:
    """True when ``so`` is missing or older than any of ``deps``."""
    if not os.path.exists(so):
        return True
    built = os.path.getmtime(so)
    return any(built < os.path.getmtime(f) for f in deps)


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def ptxas_report_path(name: str) -> str:
    """Where the nvcc build of ``name`` left ptxas' register/shared-memory
    report."""
    return os.path.join(BUILD_DIR, f"lib{name}.ptxas.txt")


def sass_path(name: str) -> str:
    """Where the nvcc build of ``name`` left the SASS of its kernels."""
    return os.path.join(BUILD_DIR, f"lib{name}.sass")


# ---------------------------------------------------------------------------
# host libraries (cc): AES-CTR, the BLS12-446 curve
# ---------------------------------------------------------------------------

def _host_lib(name: str):
    """``csrc/<name>.c`` built with ``cc`` (when stale) and loaded, or None
    when it cannot be built."""
    src = os.path.join(CSRC, f"{name}.c")
    so = _so_path(name)
    if _stale(so, src):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp.{os.getpid()}"
        try:
            subprocess.run(["cc", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        except (OSError, subprocess.CalledProcessError):
            if os.path.exists(tmp):
                os.unlink(tmp)
            if not os.path.exists(so):
                return None
    return ctypes.CDLL(so)


@functools.lru_cache(maxsize=None)
def aes_lib():
    """The loaded AES-CTR library, or None when it cannot be built (the
    CSPRNG then uses its numpy AES, which gives the same bytes)."""
    lib = _host_lib("aes_ctr")
    if lib is None:
        return None
    lib.aes128_ctr_stream.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.aes128_ctr_stream.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def bls_lib():
    """The loaded BLS12-446 library (``csrc/bls446.c``: G1/G2 fixed-base
    powers and MSMs, the multi-pairing check, one pairing), or None when it
    cannot be built (``zk/curve.py`` then runs its pure-Python curve)."""
    lib = _host_lib("bls446")
    if lib is None:
        return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for pre in ("g1", "g2"):
        fp = getattr(lib, f"{pre}_fixed_powers")
        fp.argtypes = [u64p, u64p, ctypes.c_longlong, ctypes.c_int, u64p,
                       u8p]
        fp.restype = None
        ms = getattr(lib, f"{pre}_msm")
        ms.argtypes = [u64p, u8p, u64p, ctypes.c_longlong, u64p, u8p]
        ms.restype = None
    lib.pairing_product_is_one.argtypes = [u64p, u8p, u64p, u8p,
                                           ctypes.c_longlong, u64p,
                                           ctypes.c_int, u8p]
    lib.pairing_product_is_one.restype = ctypes.c_int
    lib.pairing_eval.argtypes = [u64p, u64p, u64p, ctypes.c_int, u64p]
    lib.pairing_eval.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# CUDA kernels (nvcc)
# ---------------------------------------------------------------------------

#: every CUDA source of the package, by library name (csrc/<name>.cu)
CUDA_SOURCES = ("body_rotate", "blind_rotate_bnf2", "blind_rotate_crt",
                "blind_rotate_goldilocks", "blind_rotate_multi_bit",
                "blind_rotate_ntt64",
                "kernel_bench", "vpu_primitives",
                "ntt_variants", "v4_probe", "mxu_probe", "ntt_mxu")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of tfhe_tpu_torch "
                       "are built from csrc/*.cu on the machine with the GPU")


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (its release and build)."""
    out = subprocess.run([_nvcc(), "--version"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[-1]


def _dump_sass(nvcc: str, name: str) -> None:
    """Write the SASS of ``lib<name>.so`` to ``lib<name>.sass`` beside it
    with the toolkit's cuobjdump (next to nvcc); skipped when it is
    missing."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return
    out = subprocess.run([cuobjdump, "-sass", _so_path(name)],
                         capture_output=True, text=True)
    if out.returncode == 0:
        with open(sass_path(name), "w") as f:
            f.write(out.stdout)


def build_cuda(names=CUDA_SOURCES) -> float:
    """Compile every stale ``csrc/<name>.cu`` at once (one nvcc process per
    source, all started together). Returns the wall seconds; raises with
    nvcc's output when a build fails."""
    t0 = time.perf_counter()
    headers = _cuda_headers()
    todo = [n for n in names
            if _stale(_so_path(n), os.path.join(CSRC, f"{n}.cu"), *headers)]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in todo:
        tmp = f"{_so_path(n)}.tmp.{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, tmp, proc in procs:
        out, _ = proc.communicate()
        with open(ptxas_report_path(n), "w") as f:
            f.write(out)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (rc {proc.returncode}) ---\n{out}")
            if os.path.exists(tmp):
                os.unlink(tmp)
        else:
            os.replace(tmp, _so_path(n))
            _dump_sass(nvcc, n)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def cuda_lib(name: str):
    """The loaded kernel library ``lib<name>.so``, built first if needed.
    Callers declare argtypes/restype of the entry points they use."""
    build_cuda((name,))
    return ctypes.CDLL(_so_path(name))
