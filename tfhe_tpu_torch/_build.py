"""Build-on-first-use for the port's native code, loaded with ctypes.

Three kinds of source:

- ``csrc/aes_ctr.c`` and ``csrc/bls446.c``: host code compiled with ``cc``,
  the AES-CTR keystream and the BLS12-446 curve's hot loops (the ZK proofs'
  MSMs, CRS powers and pairings). When no compiler is present the CSPRNG
  keeps its bit-identical numpy path and ``zk/curve.py`` its pure-Python
  curve (the spec both are held to).
- ``csrc/*.cu``: the CUDA kernels, compiled with ``nvcc`` for ``sm_90a``
  into a shared library with a plain C interface (no PyTorch headers, so a
  build takes seconds). A missing or failing nvcc raises: there is no CPU
  stand-in for a CUDA tensor.
- ``c_api/``: the C API (``tfhe_tpu_c.c``, which embeds CPython) and its
  test program, compiled with ``cc`` (:func:`c_api_build`). A failing build
  raises.

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
import sysconfig
import threading
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
                "blind_rotate_wide",
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


#: wall seconds from the start of the last :func:`build_cuda` to the end
#: of each library's nvcc (only the libraries that call built)
BUILD_SECONDS: dict = {}


def build_cuda(names=CUDA_SOURCES) -> float:
    """Compile every stale ``csrc/<name>.cu`` at once (one nvcc process per
    source, all started together, each library's SASS dumped as soon as it
    is built; each one's seconds in :data:`BUILD_SECONDS`). Returns the
    wall seconds; raises with nvcc's output when a build fails."""
    t0 = time.perf_counter()
    BUILD_SECONDS.clear()
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
    outs = {}

    def wait(n, tmp, proc):
        outs[n] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, _so_path(n))
            _dump_sass(nvcc, n)
        BUILD_SECONDS[n] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=(n, tmp, proc))
               for n, tmp, proc in procs]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    failed = []
    for n, tmp, proc in procs:
        out = outs[n]
        with open(ptxas_report_path(n), "w") as f:
            f.write(out)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (rc {proc.returncode}) ---\n{out}")
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def cuda_lib(name: str):
    """The loaded kernel library ``lib<name>.so``, built first if needed.
    Callers declare argtypes/restype of the entry points they use."""
    build_cuda((name,))
    return ctypes.CDLL(_so_path(name))


# ---------------------------------------------------------------------------
# the C API (cc): c_api/tfhe_tpu_c.c and its test program
# ---------------------------------------------------------------------------

C_API = os.path.join(_PKG, "c_api")
C_API_TEST = os.path.join(BUILD_DIR, "c_api_test")
C_FLAGS = ["-O2", "-Wall", "-Wextra"]


def python_link() -> list:
    """The cc flags with which a program embeds this interpreter, read from
    ``sysconfig`` as ``c_api/Makefile`` reads it: the shared libpython of
    ``LIBDIR``. Raises when there is none."""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = sysconfig.get_config_var("LDVERSION")
    if not os.path.exists(os.path.join(libdir, f"libpython{ver}.so")):
        raise RuntimeError(f"no shared libpython{ver} in {libdir!r} to "
                           "embed")
    return [f"-L{libdir}", "-Wl,--no-as-needed", f"-lpython{ver}",
            f"-Wl,-rpath,{libdir}"]


def _cc(out: str, args: list) -> None:
    """``cc args -o out``, written to a temporary name and renamed into
    place; raises with cc's output when it fails."""
    tmp = f"{out}.tmp.{os.getpid()}"
    proc = subprocess.run(["cc", *args, "-o", tmp], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"C API build failed: cc {' '.join(args)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


@functools.lru_cache(maxsize=None)
def c_api_build() -> dict:
    """Build, when stale, the C API library ``libtfhe_tpu_c.so`` and its
    test program ``c_api_test`` (``c_api/tests/c_api_test.c``) with ``cc``
    into ``_build/``. The library does not link libpython (its Python
    symbols come from the program, or from the interpreter it is loaded
    into); the program links the interpreter's shared libpython
    (:func:`python_link`). Returns {"lib", "program", "seconds"}; a failing
    build raises: there is no fallback."""
    t0 = time.perf_counter()
    header = os.path.join(C_API, "tfhe_tpu.h")
    lib_src = os.path.join(C_API, "tfhe_tpu_c.c")
    test_src = os.path.join(C_API, "tests", "c_api_test.c")
    lib = _so_path("tfhe_tpu_c")
    os.makedirs(BUILD_DIR, exist_ok=True)
    if _stale(lib, lib_src, header):
        _cc(lib, [*C_FLAGS, "-fPIC", "-shared", f"-I{C_API}",
                  f"-I{sysconfig.get_path('include')}", lib_src])
    if _stale(C_API_TEST, test_src, header, lib):
        _cc(C_API_TEST, [*C_FLAGS, f"-I{C_API}", test_src, f"-L{BUILD_DIR}",
                         "-ltfhe_tpu_c", *python_link(),
                         "-Wl,-rpath,$ORIGIN"])
    return {"lib": lib, "program": C_API_TEST,
            "seconds": time.perf_counter() - t0}


def c_api_env() -> dict:
    """The environment of a program that embeds the port: this one, with
    ``PYTHONPATH`` led by the checkout's root (for ``tfhe_tpu_torch``) and
    this interpreter's site-packages, which an embedded interpreter does not
    find on its own outside its prefix (a virtual environment)."""
    import site

    env = dict(os.environ)
    dirs = [os.path.dirname(_PKG),
            *(d for d in site.getsitepackages() if os.path.isdir(d)),
            env.get("PYTHONPATH", "")]
    env["PYTHONPATH"] = os.pathsep.join(d for d in dirs if d)
    return env


@functools.lru_cache(maxsize=None)
def c_api_lib():
    """The C API library loaded into this interpreter with
    ``ctypes.PyDLL`` (each call holds the GIL; the library's Python symbols
    resolve against this interpreter), every prototype of ``tfhe_tpu.h``
    declared: handles are ``c_void_p``, out-handles pointers to them."""
    lib = ctypes.PyDLL(c_api_build()["lib"])
    vp, u32, u64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64
    out = ctypes.POINTER(vp)
    c_int, c_str = ctypes.c_int, ctypes.c_char_p
    protos = {
        "tfhe_tpu_init": (c_int, []),
        "tfhe_tpu_init_on": (c_int, [c_str]),
        "tfhe_tpu_shutdown": (c_int, []),
        "tfhe_tpu_last_error": (c_str, []),
        "tfhe_tpu_generate_keys": (c_int, [c_str, u64, out, out]),
        "tfhe_tpu_set_server_key": (c_int, [vp]),
        "tfhe_tpu_client_key_destroy": (None, [vp]),
        "tfhe_tpu_server_key_destroy": (None, [vp]),
        "tfhe_tpu_fheuint_encrypt": (c_int, [u32, u64, vp, out]),
        "tfhe_tpu_fheuint_decrypt": (c_int, [vp, vp,
                                             ctypes.POINTER(u64)]),
        "tfhe_tpu_fheuint_try_encrypt_trivial": (c_int, [u32, u64, out]),
        "tfhe_tpu_fheuint_destroy": (None, [vp]),
        "tfhe_tpu_fheuint_neg": (c_int, [vp, out]),
        "tfhe_tpu_fheuint_not": (c_int, [vp, out]),
        "tfhe_tpu_fheuint_serialize": (
            c_int, [vp, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                    ctypes.POINTER(ctypes.c_size_t)]),
        "tfhe_tpu_fheuint_deserialize": (
            c_int, [ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t, out]),
        "tfhe_tpu_buffer_destroy": (
            None, [ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]),
    }
    for op in ("add", "sub", "mul", "bitand", "bitor", "bitxor", "eq", "lt",
               "ne", "le", "gt", "ge", "min", "max", "div", "rem"):
        protos[f"tfhe_tpu_fheuint_{op}"] = (c_int, [vp, vp, out])
    for op in ("add", "mul", "shl", "shr"):
        protos[f"tfhe_tpu_fheuint_scalar_{op}"] = (c_int, [vp, u64, out])
    for name, (restype, argtypes) in protos.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib
