"""The blind-rotation kernels of the v6/v6b PBS (acc32 mode): wrappers,
plain PyTorch versions and launch counts.

Two kernels carry the main path, each replacing a Pallas kernel of
``tfhe_tpu/ops/pbs_kernel.py``:

- K2 ``body_rotate_acc32`` (``csrc/body_rotate.cu``) replaces
  ``_build_body_rot_fn_v4`` in acc32 mode: lut * X^{-body} on the exact u64
  coefficients, then the fold to the u32 hi plane (round to the nearest
  multiple of 2^32).
- K1 ``blind_rotate_bnf2_acc32`` (``csrc/blind_rotate_bnf2.cu``) replaces
  ``_build_step_fn_v4``/``_make_step_kernel_v4`` (bnf2 + acc32, the
  ``bnf2_c32`` tail): all n CMUX steps of the blind rotation in one launch.

A wrapper given CPU tensors runs the kernel's plain version (the same
function, written with torch ops, in this module); given CUDA tensors it
launches the kernel or raises. Each wrapper counts its launches in its
``launches`` attribute; :func:`reset_launches` zeroes them.

The accumulator crosses between the kernels as u32 values in int32
storage, [B, R, N]: the torus value is acc * 2^32.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .._torus import M32, i64_to_u32, srl, u32_to_i64
from . import bnf2 as bnf2_mod
from .polynomial import monomial_div

_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use


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


def reset_launches():
    """Zero the launch counts of every kernel wrapper."""
    body_rotate_acc32.launches = 0
    blind_rotate_bnf2_acc32.launches = 0


# ---------------------------------------------------------------------------
# K2: body rotation + acc32 fold
# ---------------------------------------------------------------------------

def body_rotate_acc32_plain(lut: torch.Tensor,
                            body: torch.Tensor) -> torch.Tensor:
    """monomial_div(lut, body) then the acc32 fold (spec of K2).
    ``lut``: int64[B, R, N] or [R, N]; ``body``: [B] in [0, 2N).
    Returns u32 hi plane in int32 storage [B, R, N]."""
    acc = monomial_div(lut, body.to(torch.int64)[:, None])
    return i64_to_u32(srl(acc + (1 << 31), 32))


@functools.lru_cache(maxsize=None)
def _k2_lib():
    from .._build import cuda_lib

    lib = cuda_lib("body_rotate")
    lib.body_rotate_acc32.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.body_rotate_acc32.restype = ctypes.c_int
    return lib


def body_rotate_acc32(lut: torch.Tensor, body: torch.Tensor) -> torch.Tensor:
    """K2 wrapper: see :func:`body_rotate_acc32_plain` for the contract."""
    if lut.device.type == "cpu":
        return body_rotate_acc32_plain(lut, body)
    if lut.device.type != "cuda":
        raise ValueError(f"body_rotate_acc32: unsupported device {lut.device}")
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
    out = torch.empty((B, R, N), dtype=torch.int32, device=lut.device)
    stride = R * N if lut.ndim == 3 else 0
    rc = _k2_lib().body_rotate_acc32(
        _ptr(lut), stride, _ptr(body32), _ptr(out), B, R, N,
        _stream(lut.device))
    _raise_on(rc, "body_rotate_acc32")
    body_rotate_acc32.launches += 1
    return out


body_rotate_acc32.launches = 0


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


def kernel_tables(n: int, flavor) -> np.ndarray:
    """K1's constant table u32[2(P), 8, N] for one flavor: twist, its Shoup
    dual, untwist, its dual, the forward stage twiddles (stage s at offset
    N - (N >> s)), their duals, the inverse stage twiddles, their duals."""
    plan = flavor.plan(n)
    out = np.zeros((2, 8, n), dtype=np.uint64)
    for pi in range(2):
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
def _kernel_tables_dev(n: int, flavor, device: str) -> torch.Tensor:
    return torch.from_numpy(
        kernel_tables(n, flavor).view(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def _k1_lib():
    from .._build import cuda_lib

    lib = cuda_lib("blind_rotate_bnf2")
    u, i, v = ctypes.c_uint, ctypes.c_int, ctypes.c_void_p
    lib.blind_rotate_bnf2_acc32.argtypes = [
        v, v, v, v, v, i, i, i, i, i, i, u, u, u, u, u, i, u, v]
    lib.blind_rotate_bnf2_acc32.restype = ctypes.c_int
    return lib


def blind_rotate_bnf2_acc32(acc_hi: torch.Tensor, msed_mask: torch.Tensor,
                            bsk_scan2: torch.Tensor, base_log: int,
                            levels: int, flavor=None) -> torch.Tensor:
    """K1 wrapper: see :func:`blind_rotate_bnf2_acc32_plain`."""
    fl = flavor or bnf2_mod.DEFAULT
    if acc_hi.device.type == "cpu":
        return blind_rotate_bnf2_acc32_plain(acc_hi, msed_mask, bsk_scan2,
                                             base_log, levels, fl)
    dev = acc_hi.device
    if dev.type != "cuda":
        raise ValueError(f"blind_rotate_bnf2_acc32: unsupported device {dev}")
    _check(acc_hi, "acc_hi", torch.int32, 3, dev)
    _check(bsk_scan2, "bsk_scan2", torch.int32, 6, dev)
    B, R, N = acc_hi.shape
    n_steps = bsk_scan2.shape[0]
    if tuple(bsk_scan2.shape[1:]) != (2, 2, levels * R, R, N):
        raise ValueError(f"bsk_scan2 shape {tuple(bsk_scan2.shape)} does not "
                         f"match R={R}, levels={levels}, N={N}")
    if tuple(msed_mask.shape) != (B, n_steps):
        raise ValueError(f"msed_mask shape {tuple(msed_mask.shape)} != "
                         f"{(B, n_steps)}")
    if not bnf2_mod.eligible(N, base_log, levels):
        raise ValueError(f"N={N}, base_log={base_log}, levels={levels} "
                         "outside the kernel envelope (bnf2.eligible)")
    smem = (R + 2 * levels * R + 2 * R) * N * 4  # acc, digits, MAC
    if smem > _SMEM_LIMIT:
        raise ValueError(f"accumulator + transforms need {smem} B of shared "
                         f"memory, more than {_SMEM_LIMIT}")
    a32 = msed_mask.to(device=dev, dtype=torch.int32).contiguous()
    tables = _kernel_tables_dev(N, fl, str(dev))
    out = torch.empty_like(acc_hi)
    rc = _k1_lib().blind_rotate_bnf2_acc32(
        _ptr(acc_hi), _ptr(a32), _ptr(bsk_scan2), _ptr(tables), _ptr(out),
        B, n_steps, R, levels, base_log, N.bit_length() - 1, fl.p0, fl.p1,
        fl.inv01, fl.inv01_sh, fl.c1t, fl.s2, fl.t32_bias, _stream(dev))
    _raise_on(rc, "blind_rotate_bnf2_acc32")
    blind_rotate_bnf2_acc32.launches += 1
    return out


blind_rotate_bnf2_acc32.launches = 0
