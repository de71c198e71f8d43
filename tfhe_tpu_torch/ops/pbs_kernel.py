"""The blind-rotation kernels of the PBS paths: wrappers, plain PyTorch
versions and launch counts.

Seven wrappers, each replacing a Pallas kernel of
``tfhe_tpu/ops/pbs_kernel.py`` or ``pbs_kernel_g.py``:

- K2 ``body_rotate_acc32`` and ``body_rotate_u64`` (``csrc/body_rotate.cu``)
  replace ``_build_body_rot_fn_v4`` in its two modes: lut * X^{-body} on
  the exact u64 coefficients, then (acc32) the fold to the u32 hi plane
  (round to the nearest multiple of 2^32), or (two-plane) the exact u64.
- K1 ``blind_rotate_bnf2_acc32`` (``csrc/blind_rotate_bnf2.cu``) replaces
  ``_build_step_fn_v4`` in acc32 mode with the ``bnf2_c32`` tail: all n
  CMUX steps of the v6/v6b blind rotation in one launch.
- K3 ``blind_rotate_crt`` and ``blind_rotate_bnf2_u64``
  (``csrc/blind_rotate_crt.cu``) replace ``_build_step_fn_v4`` in two-plane
  mode with the ``garner_c`` tail (exact P-prime CRT; also the legacy
  ``_build_step_fn``, the same function in another TPU layout) and with the
  ``bnf2_c`` tail: all n CMUX steps on the u64 accumulator in one launch.
- K3-acc32 ``blind_rotate_crt_acc32`` (``csrc/blind_rotate_crt.cu``)
  replaces ``_build_step_fn_v4`` in acc32 mode on the exact CRT path
  (``TFHE_V4_ACC=32``): the ``garner_c`` tail with every increment rounded
  to a multiple of 2^32, on the u32 hi-plane accumulator.
- K4 ``blind_rotate_goldilocks`` (``csrc/blind_rotate_goldilocks.cu``)
  replaces ``pbs_kernel_g.py::_build_step_fn_g`` (the v5 step over the
  Goldilocks prime): all n CMUX steps on the u64 accumulator in one launch.

A wrapper given CPU tensors runs the kernel's plain version (the same
function, written with torch ops); given CUDA tensors it launches the kernel
or raises. Each wrapper counts its launches in its ``launches`` attribute;
:func:`reset_launches` zeroes them.

The acc32 accumulator crosses between K2 and K1 (or K3-acc32) as u32 values
in int32 storage, [B, R, N] (torus value = acc * 2^32); the two-plane accumulator as
int64 [B, R, N] (the u64 bits).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .._torus import M32, i64_to_u32, srl, u32_to_i64
from . import bnf2 as bnf2_mod
from . import goldilocks as gl
from . import ntt as ntt_mod
from .polynomial import monomial_div

_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
MAX_CRT_PRIMES = 5  # GarnerTail<P> is instantiated for P = 2..5


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def _declare_smem(entry):
    """ctypes signature of a ``<kernel>_smem(P, R, levels, log_n)`` entry."""
    entry.argtypes = [ctypes.c_int] * 4
    entry.restype = ctypes.c_ulonglong


def reset_launches():
    """Zero the launch counts of every kernel wrapper."""
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# key layouts
# ---------------------------------------------------------------------------

def bsk_to_scan_layout(bsk_hat: torch.Tensor) -> torch.Tensor:
    """[2, P, n, l, R, R, N] (residues + Shoup duals) -> the scan layout
    [n, 2, P, l*R, R, N] the blind-rotation kernels read (contiguous)."""
    two, P, nlwe, l, R, R2, N = bsk_hat.shape
    return bsk_hat.movedim(2, 0).reshape(nlwe, two, P, l * R, R2,
                                         N).contiguous()


def scan_to_legacy_layout(bsk_scan: torch.Tensor,
                          levels: int) -> torch.Tensor:
    """Inverse of :func:`bsk_to_scan_layout` (a view)."""
    nlwe, two, P, lR, R, N = bsk_scan.shape
    return bsk_scan.reshape(nlwe, two, P, levels, lR // levels, R,
                            N).movedim(0, 2)


# ---------------------------------------------------------------------------
# K2: body rotation, acc32 fold or exact u64
# ---------------------------------------------------------------------------

def body_rotate_u64_plain(lut: torch.Tensor,
                          body: torch.Tensor) -> torch.Tensor:
    """monomial_div(lut, body) on the exact u64 coefficients (spec of K2's
    two-plane mode). ``lut``: int64[B, R, N] or [R, N]; ``body``: [B] in
    [0, 2N). Returns int64[B, R, N]."""
    return monomial_div(lut, body.to(torch.int64)[:, None])


def body_rotate_acc32_plain(lut: torch.Tensor,
                            body: torch.Tensor) -> torch.Tensor:
    """monomial_div(lut, body) then the acc32 fold (spec of K2's acc32
    mode). Returns the u32 hi plane in int32 storage [B, R, N]."""
    return i64_to_u32(srl(body_rotate_u64_plain(lut, body) + (1 << 31), 32))


@functools.lru_cache(maxsize=None)
def _k2_lib():
    from .._build import cuda_lib

    lib = cuda_lib("body_rotate")
    for entry in (lib.body_rotate_acc32, lib.body_rotate_u64):
        entry.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        entry.restype = ctypes.c_int
    return lib


def _body_rotate(entry: str, out_dtype, lut: torch.Tensor,
                 body: torch.Tensor) -> torch.Tensor:
    """Check the shapes and launch one K2 entry on the GPU."""
    if lut.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {lut.device}")
    if lut.ndim not in (2, 3):
        raise ValueError(f"lut: expected [R, N] or [B, R, N], got "
                         f"{tuple(lut.shape)}")
    _check(lut, "lut", torch.int64, lut.ndim, lut.device)
    B = body.shape[0]
    R, N = lut.shape[-2:]
    if lut.ndim == 3 and lut.shape[0] != B:
        raise ValueError(f"lut batch {lut.shape[0]} != body batch {B}")
    if not 0 < B <= 65535:
        raise ValueError(f"batch {B} outside the kernel grid (1..65535)")
    body32 = body.to(device=lut.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, R, N), dtype=out_dtype, device=lut.device)
    stride = R * N if lut.ndim == 3 else 0
    rc = getattr(_k2_lib(), entry)(_ptr(lut), stride, _ptr(body32),
                                   _ptr(out), B, R, N, _stream(lut.device))
    _raise_on(rc, entry)
    return out


def body_rotate_acc32(lut: torch.Tensor, body: torch.Tensor) -> torch.Tensor:
    """K2 wrapper, acc32 mode: see :func:`body_rotate_acc32_plain`."""
    if lut.device.type == "cpu":
        return body_rotate_acc32_plain(lut, body)
    out = _body_rotate("body_rotate_acc32", torch.int32, lut, body)
    body_rotate_acc32.launches += 1
    return out


def body_rotate_u64(lut: torch.Tensor, body: torch.Tensor) -> torch.Tensor:
    """K2 wrapper, two-plane mode: see :func:`body_rotate_u64_plain`."""
    if lut.device.type == "cpu":
        return body_rotate_u64_plain(lut, body)
    out = _body_rotate("body_rotate_u64", torch.int64, lut, body)
    body_rotate_u64.launches += 1
    return out


body_rotate_acc32.launches = 0
body_rotate_u64.launches = 0


# ---------------------------------------------------------------------------
# constant tables of the blind-rotation kernels
# ---------------------------------------------------------------------------

def plan_tables(plan: ntt_mod.NegacyclicNtt) -> np.ndarray:
    """The blind-rotation kernels' constant table u32[P, 8, N]: per prime,
    twist, its Shoup dual, untwist, its dual, the forward stage twiddles
    (stage s at offset N - (N >> s)), their duals, the inverse stage
    twiddles, their duals."""
    n = plan.n
    out = np.zeros((plan.num_primes, 8, n), dtype=np.uint64)
    for pi in range(plan.num_primes):
        out[pi, 0] = plan.twist[pi]
        out[pi, 1] = plan.twist_shoup[pi]
        out[pi, 2] = plan.untwist[pi]
        out[pi, 3] = plan.untwist_shoup[pi]
        for k, tabs in ((4, plan.tw_fwd), (5, plan.tw_fwd_shoup),
                        (6, plan.tw_inv), (7, plan.tw_inv_shoup)):
            out[pi, k, : n - 1] = np.concatenate([t[pi] for t in tabs])
    assert int(out.max()) <= M32
    return out.astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _plan_tables_dev(plan: ntt_mod.NegacyclicNtt, device: str) -> torch.Tensor:
    return torch.from_numpy(plan_tables(plan).view(np.int32)).to(device)


def garner_constants(plan: ntt_mod.NegacyclicNtt) -> np.ndarray:
    """K3's Garner-tail constants, u32[65] in the order the CUDA entry
    reads them (zero-padded to 5 primes): p[5], inv[5], inv_sh[5],
    pj[5][5], pj_sh[5][5]. inv[i] is (p_0...p_{i-1})^{-1} mod p_i, pj[i][j]
    is p_j mod p_i, each with its Shoup dual floor(w * 2^32 / p_i)."""
    P, K = plan.num_primes, MAX_CRT_PRIMES
    ps = [int(p) for p in plan.primes]
    p = np.zeros(K, dtype=np.uint64)
    inv = np.zeros(K, dtype=np.uint64)
    inv_sh = np.zeros(K, dtype=np.uint64)
    pj = np.zeros((K, K), dtype=np.uint64)
    pj_sh = np.zeros((K, K), dtype=np.uint64)
    p[:P] = ps
    for i in range(1, P):
        inv[i] = plan.garner_inv[i - 1]
        inv_sh[i] = (int(inv[i]) << 32) // ps[i]
        for j in range(i):
            pj[i, j] = ps[j] % ps[i]
            pj_sh[i, j] = (int(pj[i, j]) << 32) // ps[i]
    out = np.concatenate([p, inv, inv_sh, pj.reshape(-1), pj_sh.reshape(-1)])
    assert int(out.max()) <= M32
    return out.astype(np.uint32)


def step_smem_bytes(entry: str, P: int, R: int, levels: int, N: int) -> int:
    """Dynamic shared memory of one block of the blind-rotation kernel
    ``entry`` (``blind_rotate_bnf2_acc32``, ``blind_rotate_crt``,
    ``blind_rotate_crt_acc32``, ``blind_rotate_bnf2_u64`` or
    ``blind_rotate_goldilocks``, P = 1) at P
    primes, as its CUDA source lays it out (its ``<entry>_smem`` export); 0
    for a prime count the entry does not take. Needs the built library."""
    lib = {"blind_rotate_bnf2_acc32": _k1_lib,
           "blind_rotate_goldilocks": _k4_lib}.get(entry, _k3_lib)()
    return getattr(lib, f"{entry}_smem")(P, R, levels, N.bit_length() - 1)


def _step_shapes(name: str, acc: torch.Tensor, msed_mask: torch.Tensor,
                 bsk: torch.Tensor, P: int, base_log: int, levels: int,
                 acc_dtype):
    """Check a P-prime blind-rotation kernel's operands (K1, K3: the key is
    int32 [n, 2, P, l*R, R, N]); returns (B, n, R, N) and the mask as
    contiguous int32 on the accumulator's device."""
    shapes, a32 = _acc_mask_shapes(name, acc, msed_mask, bsk.shape[0], P,
                                   base_log, levels, acc_dtype)
    _, _, R, N = shapes
    want = (2, P, levels * R, R, N)
    _check(bsk, "bsk", torch.int32, len(want) + 1, acc.device)
    if tuple(bsk.shape[1:]) != want:
        raise ValueError(f"bsk shape {tuple(bsk.shape)} does not match "
                         f"P={P}, R={R}, levels={levels}, N={N}")
    return shapes, a32


def _acc_mask_shapes(name: str, acc: torch.Tensor, msed_mask: torch.Tensor,
                     n_steps: int, P: int, base_log: int, levels: int,
                     acc_dtype):
    """Check a blind-rotation kernel's accumulator, mask and geometry (P:
    the prime count its ``<entry>_smem`` export takes); returns
    (B, n, R, N) and the mask as contiguous int32 on the accumulator's
    device. The caller checks its own key."""
    dev = acc.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    _check(acc, "acc", acc_dtype, 3, dev)
    B, R, N = acc.shape
    if tuple(msed_mask.shape) != (B, n_steps):
        raise ValueError(f"msed_mask shape {tuple(msed_mask.shape)} != "
                         f"{(B, n_steps)}")
    if N & (N - 1) or N < 2:
        raise ValueError(f"N={N} is not a power of two")
    if not (base_log >= 1 and levels >= 1 and base_log * levels <= 31):
        raise ValueError(f"base_log={base_log}, levels={levels}: the "
                         "kernels decompose the hi word (base_log*levels "
                         "<= 31)")
    if not 0 < B < 2 ** 31:
        raise ValueError(f"batch {B} outside the kernel grid")
    smem = step_smem_bytes(name, P, R, levels, N)
    if not 0 < smem <= _SMEM_LIMIT:
        raise ValueError(f"{name}: P={P}, R={R}, levels={levels}, N={N} "
                         f"needs {smem} B of shared memory per block (0: "
                         f"unsupported P), outside 1..{_SMEM_LIMIT}")
    a32 = msed_mask.to(device=dev, dtype=torch.int32).contiguous()
    return (B, n_steps, R, N), a32


# ---------------------------------------------------------------------------
# K1: the n CMUX steps, acc32 + BNF2 tail
# ---------------------------------------------------------------------------

def blind_rotate_bnf2_acc32_plain(acc_hi: torch.Tensor,
                                  msed_mask: torch.Tensor,
                                  bsk_scan2: torch.Tensor, base_log: int,
                                  levels: int, flavor=None) -> torch.Tensor:
    """The blind rotation's CMUX steps on the hi-plane accumulator (spec of
    K1: ``bnf2.cmux_steps`` with ``acc_round32``). ``acc_hi``: u32 in int32
    storage [B, R, N]; ``msed_mask``: [B, n] in [0, 2N); ``bsk_scan2``:
    int32[n, 2, 2, l*R, R, N]. Returns the new hi plane, int32 [B, R, N]."""
    acc = u32_to_i64(acc_hi) << 32
    acc = bnf2_mod.cmux_steps(acc, msed_mask, bsk_scan2, base_log, levels,
                              True, flavor)
    return i64_to_u32(srl(acc, 32))


@functools.lru_cache(maxsize=None)
def _k1_lib():
    from .._build import cuda_lib

    lib = cuda_lib("blind_rotate_bnf2")
    u, i, v = ctypes.c_uint, ctypes.c_int, ctypes.c_void_p
    lib.blind_rotate_bnf2_acc32.argtypes = [
        v, v, v, v, v, i, i, i, i, i, i, u, u, u, u, u, i, u, v]
    lib.blind_rotate_bnf2_acc32.restype = ctypes.c_int
    _declare_smem(lib.blind_rotate_bnf2_acc32_smem)
    return lib


def blind_rotate_bnf2_acc32(acc_hi: torch.Tensor, msed_mask: torch.Tensor,
                            bsk_scan2: torch.Tensor, base_log: int,
                            levels: int, flavor=None) -> torch.Tensor:
    """K1 wrapper: see :func:`blind_rotate_bnf2_acc32_plain`."""
    fl = flavor or bnf2_mod.DEFAULT
    if acc_hi.device.type == "cpu":
        return blind_rotate_bnf2_acc32_plain(acc_hi, msed_mask, bsk_scan2,
                                             base_log, levels, fl)
    if not bnf2_mod.eligible(acc_hi.shape[-1], base_log, levels):
        raise ValueError(f"N={acc_hi.shape[-1]}, base_log={base_log}, "
                         f"levels={levels} outside the kernel envelope "
                         "(bnf2.eligible)")
    (B, n_steps, R, N), a32 = _step_shapes(
        "blind_rotate_bnf2_acc32", acc_hi, msed_mask, bsk_scan2, 2, base_log,
        levels, torch.int32)
    dev = acc_hi.device
    tables = _plan_tables_dev(fl.plan(N), str(dev))
    out = torch.empty_like(acc_hi)
    rc = _k1_lib().blind_rotate_bnf2_acc32(
        _ptr(acc_hi), _ptr(a32), _ptr(bsk_scan2), _ptr(tables), _ptr(out),
        B, n_steps, R, levels, base_log, N.bit_length() - 1, fl.p0, fl.p1,
        fl.inv01, fl.inv01_sh, fl.c1t, fl.s2, fl.t32_bias, _stream(dev))
    _raise_on(rc, "blind_rotate_bnf2_acc32")
    blind_rotate_bnf2_acc32.launches += 1
    return out


blind_rotate_bnf2_acc32.launches = 0


# ---------------------------------------------------------------------------
# K3: the n CMUX steps on the u64 accumulator, Garner or BNF2 tail, and
# K3-acc32 on the u32 hi plane, Garner tail rounded
# ---------------------------------------------------------------------------

def blind_rotate_crt_plain(acc: torch.Tensor, msed_mask: torch.Tensor,
                           bsk_scan: torch.Tensor, base_log: int,
                           levels: int) -> torch.Tensor:
    """The n CMUX steps of the exact CRT blind rotation on the u64
    accumulator (spec of K3, Garner tail: ``server.blind_rotate`` after its
    body rotation). ``acc``: int64[B, R, N]; ``msed_mask``: [B, n] in
    [0, 2N); ``bsk_scan``: int32[n, 2, P, l*R, R, N] over the first P
    PRIMES32. Returns int64[B, R, N]."""
    from . import server  # server imports this module

    P, N = bsk_scan.shape[2], bsk_scan.shape[-1]
    return server.cmux_steps_crt(acc, msed_mask,
                                 scan_to_legacy_layout(bsk_scan, levels),
                                 base_log, levels, ntt_mod.get_plan(N, P))


def blind_rotate_crt_acc32_plain(acc_hi: torch.Tensor,
                                 msed_mask: torch.Tensor,
                                 bsk_scan: torch.Tensor, base_log: int,
                                 levels: int) -> torch.Tensor:
    """The n CMUX steps of the CRT blind rotation in acc32 mode (spec of
    K3-acc32: ``server.blind_rotate(acc_round32=True)`` after its body
    rotation, every Garner increment rounded to a multiple of 2^32).
    ``acc_hi``: the hi plane, u32 in int32 storage [B, R, N]; the mask and
    key as :func:`blind_rotate_crt_plain`'s. Returns the new hi plane."""
    from . import server  # server imports this module

    P, N = bsk_scan.shape[2], bsk_scan.shape[-1]
    acc = server.cmux_steps_crt(u32_to_i64(acc_hi) << 32, msed_mask,
                                scan_to_legacy_layout(bsk_scan, levels),
                                base_log, levels, ntt_mod.get_plan(N, P),
                                acc_round32=True)
    return i64_to_u32(srl(acc, 32))


def blind_rotate_bnf2_u64_plain(acc: torch.Tensor, msed_mask: torch.Tensor,
                                bsk_scan2: torch.Tensor, base_log: int,
                                levels: int, flavor=None) -> torch.Tensor:
    """The BNF2 blind rotation's CMUX steps on the u64 accumulator (spec of
    K3, BNF2 tail: ``bnf2.cmux_steps`` without ``acc_round32``).
    ``bsk_scan2``: int32[n, 2, 2, l*R, R, N]. Returns int64[B, R, N]."""
    return bnf2_mod.cmux_steps(acc, msed_mask, bsk_scan2, base_log, levels,
                               False, flavor)


@functools.lru_cache(maxsize=None)
def _k3_lib():
    from .._build import cuda_lib

    lib = cuda_lib("blind_rotate_crt")
    u, i, v = ctypes.c_uint, ctypes.c_int, ctypes.c_void_p
    for entry in (lib.blind_rotate_crt, lib.blind_rotate_crt_acc32):
        entry.argtypes = [v, v, v, v, v, i, i, i, i, i, i, i, v,
                          ctypes.c_ulonglong, v]
        entry.restype = ctypes.c_int
    lib.blind_rotate_bnf2_u64.argtypes = [
        v, v, v, v, v, i, i, i, i, i, i, u, u, u, u, u, u, i, i, v]
    lib.blind_rotate_bnf2_u64.restype = ctypes.c_int
    for entry in (lib.blind_rotate_crt_smem, lib.blind_rotate_crt_acc32_smem,
                  lib.blind_rotate_bnf2_u64_smem):
        _declare_smem(entry)
    return lib


@functools.lru_cache(maxsize=None)
def _garner_host(plan: ntt_mod.NegacyclicNtt):
    """The Garner constants as a ctypes u32 array (host memory)."""
    consts = garner_constants(plan)
    return (ctypes.c_uint * consts.size)(*[int(x) for x in consts])


def _launch_crt(entry: str, acc: torch.Tensor, msed_mask: torch.Tensor,
                bsk_scan: torch.Tensor, base_log: int,
                levels: int) -> torch.Tensor:
    """Check the operands and launch one Garner-tail entry of K3 on the GPU
    (``blind_rotate_crt``: int64 accumulator; ``blind_rotate_crt_acc32``:
    int32)."""
    P = bsk_scan.shape[2] if bsk_scan.ndim == 6 else 0
    if not 2 <= P <= MAX_CRT_PRIMES:
        raise ValueError(f"bsk_scan {tuple(bsk_scan.shape)}: the kernel "
                         f"takes 2..{MAX_CRT_PRIMES} primes")
    acc_dtype = torch.int32 if entry.endswith("acc32") else torch.int64
    (B, n_steps, R, N), a32 = _step_shapes(
        entry, acc, msed_mask, bsk_scan, P, base_log, levels, acc_dtype)
    dev = acc.device
    plan = ntt_mod.get_plan(N, P)
    tables = _plan_tables_dev(plan, str(dev))
    out = torch.empty_like(acc)
    rc = getattr(_k3_lib(), entry)(
        _ptr(acc), _ptr(a32), _ptr(bsk_scan), _ptr(tables), _ptr(out),
        B, n_steps, R, levels, base_log, N.bit_length() - 1, P,
        _garner_host(plan), plan.full_prod_mod64, _stream(dev))
    _raise_on(rc, entry)
    return out


def blind_rotate_crt(acc: torch.Tensor, msed_mask: torch.Tensor,
                     bsk_scan: torch.Tensor, base_log: int,
                     levels: int) -> torch.Tensor:
    """K3 wrapper, Garner tail: see :func:`blind_rotate_crt_plain`."""
    if acc.device.type == "cpu":
        return blind_rotate_crt_plain(acc, msed_mask, bsk_scan, base_log,
                                      levels)
    out = _launch_crt("blind_rotate_crt", acc, msed_mask, bsk_scan, base_log,
                      levels)
    blind_rotate_crt.launches += 1
    return out


def blind_rotate_crt_acc32(acc_hi: torch.Tensor, msed_mask: torch.Tensor,
                           bsk_scan: torch.Tensor, base_log: int,
                           levels: int) -> torch.Tensor:
    """K3-acc32 wrapper: see :func:`blind_rotate_crt_acc32_plain`."""
    if acc_hi.device.type == "cpu":
        return blind_rotate_crt_acc32_plain(acc_hi, msed_mask, bsk_scan,
                                            base_log, levels)
    out = _launch_crt("blind_rotate_crt_acc32", acc_hi, msed_mask, bsk_scan,
                      base_log, levels)
    blind_rotate_crt_acc32.launches += 1
    return out


def blind_rotate_bnf2_u64(acc: torch.Tensor, msed_mask: torch.Tensor,
                          bsk_scan2: torch.Tensor, base_log: int,
                          levels: int, flavor=None) -> torch.Tensor:
    """K3 wrapper, BNF2 tail: see :func:`blind_rotate_bnf2_u64_plain`."""
    fl = flavor or bnf2_mod.DEFAULT
    if acc.device.type == "cpu":
        return blind_rotate_bnf2_u64_plain(acc, msed_mask, bsk_scan2,
                                           base_log, levels, fl)
    (B, n_steps, R, N), a32 = _step_shapes(
        "blind_rotate_bnf2_u64", acc, msed_mask, bsk_scan2, 2, base_log,
        levels, torch.int64)
    dev = acc.device
    tables = _plan_tables_dev(fl.plan(N), str(dev))
    out = torch.empty_like(acc)
    rc = _k3_lib().blind_rotate_bnf2_u64(
        _ptr(acc), _ptr(a32), _ptr(bsk_scan2), _ptr(tables), _ptr(out),
        B, n_steps, R, levels, base_log, N.bit_length() - 1, fl.p0, fl.p1,
        fl.inv01, fl.inv01_sh, fl.g0, fl.g1, fl.s1, fl.s2, _stream(dev))
    _raise_on(rc, "blind_rotate_bnf2_u64")
    blind_rotate_bnf2_u64.launches += 1
    return out


blind_rotate_crt.launches = 0
blind_rotate_crt_acc32.launches = 0
blind_rotate_bnf2_u64.launches = 0


# ---------------------------------------------------------------------------
# K4: the n CMUX steps of the v5 blind rotation over the Goldilocks prime
# ---------------------------------------------------------------------------

def blind_rotate_goldilocks_plain(acc: torch.Tensor, msed_mask: torch.Tensor,
                                  bsk_g: torch.Tensor, base_log: int,
                                  levels: int) -> torch.Tensor:
    """The n CMUX steps of the v5 blind rotation on the u64 accumulator
    after its body rotation (spec of K4: ``goldilocks.cmux_steps``, the
    loop of ``tfhe_tpu``'s ``goldilocks.blind_rotate_goldilocks``).
    ``acc``: int64[B, R, N]; ``msed_mask``: [B, n] in [0, 2N); ``bsk_g``:
    int32[n, 2, l*R, R, G, 128], the JAX layout. Returns int64[B, R, N]."""
    return gl.cmux_steps(acc, msed_mask, bsk_g, base_log, levels)


def goldilocks_kernel_key(bsk_g: torch.Tensor) -> torch.Tensor:
    """The v5 key as K4 reads it: the (hi, lo) planes merged into canonical
    u64 values and permuted from the (group, lane) order into the DIF order
    of K4's transform, int64 [n, l*R, R, N] (contiguous). A permutation of
    the key, so the MAC is the same sum."""
    nlwe, _, lR, R, G, _ = bsk_g.shape
    plan = gl.get_plan_g(G * 128)
    merged = gl.bsk_g_merge(bsk_g).reshape(nlwe, lR, R, G * 128)
    return merged[..., plan.tables(bsk_g.device)["from_kernel"]].contiguous()


@functools.lru_cache(maxsize=None)
def _k4_lib():
    from .._build import cuda_lib

    lib = cuda_lib("blind_rotate_goldilocks")
    i, v = ctypes.c_int, ctypes.c_void_p
    lib.blind_rotate_goldilocks.argtypes = [v, v, v, v, v, i, i, i, i, i, i,
                                            v]
    lib.blind_rotate_goldilocks.restype = ctypes.c_int
    _declare_smem(lib.blind_rotate_goldilocks_smem)
    return lib


def goldilocks_tables(plan: gl.GoldilocksPlan) -> np.ndarray:
    """K4's constant table u64[4, N]: twist, untwist, the forward stage
    twiddles (stage s at offset N - (N >> s)), the inverse ones."""
    n = plan.n
    out = np.zeros((4, n), dtype=np.uint64)
    out[0], out[1] = plan.twist, plan.untwist
    out[2, : n - 1] = np.concatenate(plan.tw_fwd)
    out[3, : n - 1] = np.concatenate(plan.tw_inv)
    return out


@functools.lru_cache(maxsize=None)
def _goldilocks_tables_dev(N: int, device: str) -> torch.Tensor:
    return torch.from_numpy(
        goldilocks_tables(gl.get_plan_g(N)).view(np.int64)).to(device)


def blind_rotate_goldilocks(acc: torch.Tensor, msed_mask: torch.Tensor,
                            bsk_g: torch.Tensor, base_log: int, levels: int,
                            bsk_k: torch.Tensor) -> torch.Tensor:
    """K4 wrapper: see :func:`blind_rotate_goldilocks_plain`. ``bsk_k``:
    the key K4 reads, :func:`goldilocks_kernel_key` of ``bsk_g``, prepared
    once by the caller (the plain version on the CPU reads ``bsk_g``)."""
    if acc.device.type == "cpu":
        return blind_rotate_goldilocks_plain(acc, msed_mask, bsk_g, base_log,
                                             levels)
    if not gl.eligible(acc.shape[-1], base_log, levels):
        raise ValueError(f"N={acc.shape[-1]}, base_log={base_log}, "
                         f"levels={levels} outside the kernel envelope "
                         "(goldilocks.eligible)")
    (B, n_steps, R, N), a32 = _acc_mask_shapes(
        "blind_rotate_goldilocks", acc, msed_mask, bsk_k.shape[0], 1,
        base_log, levels, torch.int64)
    _check(bsk_k, "bsk_k", torch.int64, 4, acc.device)
    if tuple(bsk_k.shape[1:]) != (levels * R, R, N):
        raise ValueError(f"bsk_k shape {tuple(bsk_k.shape)} != "
                         f"[n, {levels * R}, {R}, {N}]")
    dev = acc.device
    tables = _goldilocks_tables_dev(N, str(dev))
    out = torch.empty_like(acc)
    rc = _k4_lib().blind_rotate_goldilocks(
        _ptr(acc), _ptr(a32), _ptr(bsk_k), _ptr(tables), _ptr(out), B,
        n_steps, R, levels, base_log, N.bit_length() - 1, _stream(dev))
    _raise_on(rc, "blind_rotate_goldilocks")
    blind_rotate_goldilocks.launches += 1
    return out


blind_rotate_goldilocks.launches = 0


#: every kernel wrapper of this module, each with its ``launches`` count
KERNELS = (body_rotate_acc32, body_rotate_u64, blind_rotate_bnf2_acc32,
           blind_rotate_crt, blind_rotate_crt_acc32, blind_rotate_bnf2_u64,
           blind_rotate_goldilocks)
