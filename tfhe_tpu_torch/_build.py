"""Build-on-first-use for the port's native code, loaded with ctypes.

Two kinds of source live in ``csrc/``:

- ``aes_ctr.c``: the host AES-CTR keystream, compiled with ``cc``. When no
  compiler is present the CSPRNG keeps its bit-identical numpy path.
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


# ---------------------------------------------------------------------------
# host AES (cc)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def aes_lib():
    """The loaded AES-CTR library, or None when it cannot be built (the
    CSPRNG then uses its numpy AES, which gives the same bytes)."""
    src = os.path.join(CSRC, "aes_ctr.c")
    so = _so_path("aes_ctr")
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
    lib = ctypes.CDLL(so)
    lib.aes128_ctr_stream.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.aes128_ctr_stream.restype = None
    return lib


# ---------------------------------------------------------------------------
# CUDA kernels (nvcc)
# ---------------------------------------------------------------------------

#: every CUDA source of the package, by library name (csrc/<name>.cu)
CUDA_SOURCES = ("body_rotate", "blind_rotate_bnf2", "blind_rotate_crt",
                "blind_rotate_goldilocks")


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
        with open(os.path.join(BUILD_DIR, f"lib{name}.sass"), "w") as f:
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
