"""The blind-rotation kernels of the PBS paths: wrappers, plain PyTorch
versions and launch counts.

Eighteen wrappers, twelve replacing a Pallas kernel of
``tfhe_tpu/ops/pbs_kernel.py`` or ``pbs_kernel_g.py``, five the XLA
multi-bit rotation of ``tfhe_tpu/ops/server.py`` and one the XLA rotation
of ``tfhe_tpu/ops/ntt64_pbs.py``:

- K2 ``body_rotate_acc32`` and ``body_rotate_u64`` (``csrc/body_rotate.cu``)
  replace ``_build_body_rot_fn_v4`` in its two modes: lut * X^{-body} on
  the exact u64 coefficients, then (acc32) the fold to the u32 hi plane
  (round to the nearest multiple of 2^32), or (two-plane) the exact u64.
  ``body_rotate_acc32`` copies out of a table of folded words a LUT row
  (:func:`body_rotate_acc32_table`); ``body_rotate_acc32_r1``, its first
  design, is launched by no user path: it is the reference the table
  design is timed against.
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
- K5, the n/g group steps of the multi-bit blind rotation on the u64
  accumulator (``csrc/blind_rotate_multi_bit.cu``), replaces
  ``tfhe_tpu/ops/server.py::multi_bit_blind_rotate`` (XLA, no
  ``pallas_call``) as a pair a chunk of steps (``blind_rotate_multi_bit``
  runs the chunks): K5a ``multi_bit_keybundle`` builds the chunk's key
  bundles (each step's combined GGSW a ciphertext) across the whole card,
  K5b ``multi_bit_accumulate`` runs the dependent external products
  against them. ``blind_rotate_multi_bit_r14``, the single kernel of all
  n/g steps a ciphertext the pair replaced, is launched by no user path:
  it is the reference the pair is timed against.
- K6 ``blind_rotate_ntt64`` (``csrc/blind_rotate_ntt64.cu``) replaces
  ``tfhe_tpu/ops/ntt64_pbs.py::blind_rotate_ntt64``'s step loop (XLA, no
  ``pallas_call``): all n CMUX steps of the prime-modulus PBS, ciphertexts
  mod the Goldilocks prime, in one launch (K4's loop with the rotation,
  the decomposer and the accumulate mod q).

- K7 (``csrc/blind_rotate_wide.cu``) computes K3's, K3-acc32's and K5b's
  functions at the shapes whose acc and digits exceed one block's shared
  memory (N up to :data:`WIDE_MAX_N`), in two designs:
  ``blind_rotate_wide_cluster``, ``blind_rotate_wide_cluster_acc32`` and
  ``multi_bit_accumulate_wide_cluster``, the cluster kernel (one
  thread-block cluster of P R CTAs a ciphertext, acc and digits in
  distributed shared memory for all steps, one launch a call), wherever
  its CTA fits a block (:func:`fits_cluster`: the 3_3 sets), and at split
  2 (``blind_rotate_wide_split``, ``_split_acc32``,
  ``multi_bit_accumulate_wide_split``: 2 P R = 16 CTAs a ciphertext, each
  holding half of every transform) where a CTA of split 1 does not fit
  but one of split 2 does (N = 32768, and N = 16384 at l = 3: tfhe-rs's
  4_4 sets), its levels streamed through one transform buffer where a
  split CTA holding all l digit transforms exceeds a block (the entries
  choose the instantiation from the shape, :func:`split_streams`: N =
  32768 at l = 4 to 6, tfhe-rs's sets with 4 to 6 levels); and
  ``blind_rotate_wide``, ``blind_rotate_wide_acc32`` and
  ``multi_bit_accumulate_wide``, K7 global (acc and digits in global
  memory, three stage launches a step), for the rest (P R > 8, l = 1 at N
  = 32768, the acc32 entry where the split would stream: no set of the
  universe), also the reference the cluster kernel is timed against.
  :func:`blind_rotate_crt`, :func:`blind_rotate_crt_acc32` and
  :func:`multi_bit_accumulate` choose K3 / K5b, the cluster kernel at
  split 1 or 2, or K7 global from the shape alone (:func:`wide_route`).

Every kernel decomposes the hi 32 bits of the u64 difference while
base_log * levels <= 31; K3's Garner entry, K5b and K7's u64 designs take
32..63 at 4 primes on a second instantiation whose lifts decompose all 64
bits (``GarnerTailDeep``, ``Decomposer64`` in ``csrc/ntt_common.cuh``), chosen
by the entry from base_log * levels (:func:`decomposer_refusal`).

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
from . import ntt64_pbs as n64
from .polynomial import monomial_div

_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
MAX_CRT_PRIMES = 5  # GarnerTail<P> is instantiated for P = 2..5
#: the largest base_log * levels of the hi-word decomposer (``HiDecomposer``)
HI_WORD_MAX_BL = 31
#: the prime count of the 64-bit decomposer's instantiations
#: (``GarnerTailDeep<4>``, ``Decomposer64``: base_log * levels 32..63), that
#: of every set of the universe with base_log * levels >= 32
DEEP_PRIMES = 4
#: the u64 entries whose kernels carry the 64-bit decomposer (K3's Garner
#: entry, K5b; K7's designs behind both)
DEEP_ENTRIES = ("blind_rotate_crt", "multi_bit_accumulate")


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


def _launch(name: str, entry, device, *args) -> None:
    """Call the kernel entry ``entry`` with ``args`` and ``device``'s
    current stream, with ``device`` the current CUDA device for the call
    (the launch, the entry's shared-memory opt-in and its SM count go to
    the current device, whatever device the tensors are on), and raise on
    its error code."""
    with torch.cuda.device(device):
        rc = entry(*args, _stream(device))
    _raise_on(rc, name)


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


def body_rotate_acc32_table(lut: torch.Tensor,
                            body: torch.Tensor) -> torch.Tensor:
    """K2 acc32 as its kernel indexes it (``csrc/body_rotate.cu``): each
    LUT row becomes a table of 2N folded words, ``T[s] = fold(lut[s])`` and
    ``T[N + s] = fold(-lut[s])`` (the negation on the exact u64, before the
    fold), and ``out[t] = T[(t - d) mod 2N]`` with ``d = (2N - body) mod
    2N``. Equal to :func:`body_rotate_acc32_plain`; same arguments."""
    n = lut.shape[-1]
    fold = lambda v: i64_to_u32(srl(v + (1 << 31), 32))
    table = torch.cat([fold(lut), fold(-lut)], dim=-1)  # [(B,) R, 2N]
    B, R = body.shape[0], lut.shape[-2]
    d = torch.remainder(2 * n - body.to(torch.int64), 2 * n)
    t = torch.arange(n, device=lut.device)
    idx = torch.remainder(t[None, :] - d[:, None], 2 * n)  # [B, N]
    return torch.gather(table.expand(B, R, 2 * n), 2,
                        idx[:, None, :].expand(B, R, n))


@functools.lru_cache(maxsize=None)
def _k2_lib():
    from .._build import cuda_lib

    lib = cuda_lib("body_rotate")
    # body: int64 for body_rotate_acc32, int32 for the other two entries
    for entry in (lib.body_rotate_acc32, lib.body_rotate_acc32_r1,
                  lib.body_rotate_u64):
        entry.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        entry.restype = ctypes.c_int
    return lib


def _body_rotate(entry: str, out_dtype, body_dtype, lut: torch.Tensor,
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
    if body_dtype == torch.int64:  # body_rotate_acc32: any B, N = 2^k >= 4
        if B < 1 or N < 4 or N & (N - 1):
            raise ValueError(f"{entry}: batch {B}, N {N}: needs a batch and "
                             f"N a power of two >= 4")
    elif not 0 < B <= 65535:
        raise ValueError(f"batch {B} outside the kernel grid (1..65535)")
    body = body.to(device=lut.device, dtype=body_dtype).contiguous()
    out = torch.empty((B, R, N), dtype=out_dtype, device=lut.device)
    stride = R * N if lut.ndim == 3 else 0
    _launch(entry, getattr(_k2_lib(), entry), lut.device, _ptr(lut), stride,
            _ptr(body), _ptr(out), B, R, N)
    return out


def body_rotate_acc32(lut: torch.Tensor, body: torch.Tensor) -> torch.Tensor:
    """K2 wrapper, acc32 mode: see :func:`body_rotate_acc32_plain` (the
    kernel's indexing: :func:`body_rotate_acc32_table`). ``body`` is read as
    int64, so an int64 body on the LUT's device costs no extra launch."""
    if lut.device.type == "cpu":
        return body_rotate_acc32_plain(lut, body)
    out = _body_rotate("body_rotate_acc32", torch.int32, torch.int64, lut,
                       body)
    body_rotate_acc32.launches += 1
    return out


def body_rotate_acc32_r1(lut: torch.Tensor,
                         body: torch.Tensor) -> torch.Tensor:
    """The first design of K2 acc32 (one block a ciphertext row), the
    reference :func:`body_rotate_acc32` is timed against; no user path
    calls it. Same function, same arguments."""
    if lut.device.type == "cpu":
        return body_rotate_acc32_plain(lut, body)
    out = _body_rotate("body_rotate_acc32_r1", torch.int32, torch.int32, lut,
                       body)
    body_rotate_acc32_r1.launches += 1
    return out


def body_rotate_u64(lut: torch.Tensor, body: torch.Tensor) -> torch.Tensor:
    """K2 wrapper, two-plane mode: see :func:`body_rotate_u64_plain`."""
    if lut.device.type == "cpu":
        return body_rotate_u64_plain(lut, body)
    out = _body_rotate("body_rotate_u64", torch.int64, torch.int32, lut, body)
    body_rotate_u64.launches += 1
    return out


body_rotate_acc32.launches = 0
body_rotate_acc32_r1.launches = 0
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


#: the library of each step-kernel entry other than K3's
_STEP_LIBS = {"blind_rotate_bnf2_acc32": "blind_rotate_bnf2",
              "blind_rotate_goldilocks": "blind_rotate_goldilocks",
              "blind_rotate_ntt64": "blind_rotate_ntt64",
              "multi_bit_accumulate": "blind_rotate_multi_bit",
              "blind_rotate_multi_bit_r14": "blind_rotate_multi_bit",
              "kb_step_bnf2_acc32_r2": "kernel_bench",
              "kb_step_crt_r2": "kernel_bench",
              "blind_rotate_wide_cluster": "blind_rotate_wide",
              "blind_rotate_wide_cluster_acc32": "blind_rotate_wide",
              "multi_bit_accumulate_wide_cluster": "blind_rotate_wide",
              "blind_rotate_wide_split": "blind_rotate_wide",
              "blind_rotate_wide_split_acc32": "blind_rotate_wide",
              "multi_bit_accumulate_wide_split": "blind_rotate_wide"}


def _step_lib(entry: str):
    from .._build import cuda_lib

    return cuda_lib(_STEP_LIBS.get(entry, "blind_rotate_crt"))


def step_smem_bytes(entry: str, P: int, R: int, levels: int, N: int) -> int:
    """Dynamic shared memory of one block of the blind-rotation kernel
    ``entry`` (``blind_rotate_bnf2_acc32``, ``blind_rotate_crt``,
    ``blind_rotate_crt_acc32``, ``blind_rotate_bnf2_u64``,
    ``blind_rotate_goldilocks`` at P = 1, ``multi_bit_accumulate`` (K5b),
    ``blind_rotate_multi_bit_r14``, the kernel bench's references
    ``kb_step_bnf2_acc32_r2``, ``kb_step_crt_r2``, or a CTA of K7's cluster
    kernel, ``blind_rotate_wide_cluster``, ``_acc32``,
    ``multi_bit_accumulate_wide_cluster``, or at split 2 their ``_split``
    namesakes) at P
    primes, as its CUDA source lays it out (its ``<entry>_smem`` export); 0
    for a prime count (or shape) the entry does not take. Needs the built
    library."""
    fn = getattr(_step_lib(entry), f"{entry}_smem")
    _declare_smem(fn)
    return fn(P, R, levels, N.bit_length() - 1)


def step_occupancy(entry: str, P: int, R: int, levels: int, N: int) -> dict:
    """Resident blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    at the entry's shared memory), registers and local (spill) bytes per
    thread of K1 or K3 entry ``entry`` at P primes (its ``<entry>_occupancy``
    export). Needs the built library and a GPU."""
    return _occupancy(getattr(_step_lib(entry), f"{entry}_occupancy"),
                      entry, P, R, levels, N.bit_length() - 1)


def _occupancy(fn, entry: str, *shape: int) -> dict:
    fn.argtypes = ([ctypes.c_int] * len(shape)
                   + [ctypes.POINTER(ctypes.c_int)] * 2)
    fn.restype = ctypes.c_int
    regs, local = ctypes.c_int(), ctypes.c_int()
    blocks = fn(*shape, ctypes.byref(regs), ctypes.byref(local))
    if blocks <= 0:
        raise RuntimeError(f"{entry}_occupancy: {blocks} at {shape}")
    return {"blocks_per_sm": blocks, "registers": regs.value,
            "local_bytes": local.value}


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


def decomposer_refusal(name: str, P: int, base_log: int, levels: int):
    """Why entry ``name``'s kernels cannot decompose at this base log and
    level count, or None: every kernel takes base_log * levels <=
    :data:`HI_WORD_MAX_BL` (the hi word's decomposer); the u64 entries of
    :data:`DEEP_ENTRIES` take 32..63 at :data:`DEEP_PRIMES` primes (the
    64-bit decomposer)."""
    bl = base_log * levels
    if base_log < 1 or levels < 1:
        return f"base_log = {base_log}, levels = {levels}"
    if bl <= HI_WORD_MAX_BL:
        return None
    if name not in DEEP_ENTRIES:
        return (f"base_log * levels = {bl}: its kernel decomposes the hi "
                f"word (<= {HI_WORD_MAX_BL})")
    if bl > 63:
        return f"base_log * levels = {bl}: a decomposer takes <= 63"
    if P != DEEP_PRIMES:
        return (f"base_log * levels = {bl} >= 32: the 64-bit decomposer is "
                f"instantiated at P = {DEEP_PRIMES}, not {P}")
    return None


def _acc_shapes(name: str, acc: torch.Tensor, P: int, base_log: int,
                levels: int, acc_dtype):
    """Check a blind-rotation kernel's accumulator and geometry (P: the
    prime count its ``<entry>_smem`` export takes); returns (B, R, N)."""
    dev = acc.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    _check(acc, "acc", acc_dtype, 3, dev)
    B, R, N = acc.shape
    if N & (N - 1) or N < 2:
        raise ValueError(f"N={N} is not a power of two")
    why = decomposer_refusal(name, P, base_log, levels)
    if why:
        raise ValueError(f"{name}: {why}")
    if not 0 < B < 2 ** 31:
        raise ValueError(f"batch {B} outside the kernel grid")
    smem = step_smem_bytes(name, P, R, levels, N)
    if not 0 < smem <= _SMEM_LIMIT:
        raise ValueError(f"{name}: P={P}, R={R}, levels={levels}, N={N} "
                         f"needs {smem} B of shared memory per block (0: "
                         f"unsupported P), outside 1..{_SMEM_LIMIT}")
    return B, R, N


def _acc_mask_shapes(name: str, acc: torch.Tensor, msed_mask: torch.Tensor,
                     n_steps: int, P: int, base_log: int, levels: int,
                     acc_dtype):
    """Check a blind-rotation kernel's accumulator, mask and geometry (as
    :func:`_acc_shapes`); returns (B, n, R, N) and the mask as contiguous
    int32 on the accumulator's device. The caller checks its own key."""
    B, R, N = _acc_shapes(name, acc, P, base_log, levels, acc_dtype)
    if tuple(msed_mask.shape) != (B, n_steps):
        raise ValueError(f"msed_mask shape {tuple(msed_mask.shape)} != "
                         f"{(B, n_steps)}")
    a32 = msed_mask.to(device=acc.device, dtype=torch.int32).contiguous()
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
    return lib


def launch_bnf2_acc32(lib, entry: str, acc_hi: torch.Tensor,
                      msed_mask: torch.Tensor, bsk_scan2: torch.Tensor,
                      base_log: int, levels: int, fl) -> torch.Tensor:
    """Check the operands and launch ``lib.<entry>``, K1's function on the
    GPU (K1 itself, or the kernel bench's reference loop)."""
    if not bnf2_mod.eligible(acc_hi.shape[-1], base_log, levels):
        raise ValueError(f"N={acc_hi.shape[-1]}, base_log={base_log}, "
                         f"levels={levels} outside the kernel envelope "
                         "(bnf2.eligible)")
    (B, n_steps, R, N), a32 = _step_shapes(
        entry, acc_hi, msed_mask, bsk_scan2, 2, base_log, levels,
        torch.int32)
    dev = acc_hi.device
    tables = _plan_tables_dev(fl.plan(N), str(dev))
    out = torch.empty_like(acc_hi)
    _launch(entry, getattr(lib, entry), dev,
        _ptr(acc_hi), _ptr(a32), _ptr(bsk_scan2), _ptr(tables), _ptr(out),
        B, n_steps, R, levels, base_log, N.bit_length() - 1, fl.p0, fl.p1,
        fl.inv01, fl.inv01_sh, fl.c1t, fl.s2, fl.t32_bias)
    return out


def blind_rotate_bnf2_acc32(acc_hi: torch.Tensor, msed_mask: torch.Tensor,
                            bsk_scan2: torch.Tensor, base_log: int,
                            levels: int, flavor=None) -> torch.Tensor:
    """K1 wrapper: see :func:`blind_rotate_bnf2_acc32_plain`."""
    fl = flavor or bnf2_mod.DEFAULT
    if acc_hi.device.type == "cpu":
        return blind_rotate_bnf2_acc32_plain(acc_hi, msed_mask, bsk_scan2,
                                             base_log, levels, fl)
    out = launch_bnf2_acc32(_k1_lib(), "blind_rotate_bnf2_acc32", acc_hi,
                            msed_mask, bsk_scan2, base_log, levels, fl)
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
    return lib


@functools.lru_cache(maxsize=None)
def _garner_host(plan: ntt_mod.NegacyclicNtt):
    """The Garner constants as a ctypes u32 array (host memory)."""
    consts = garner_constants(plan)
    return (ctypes.c_uint * consts.size)(*[int(x) for x in consts])


def launch_crt(entry: str, acc: torch.Tensor, msed_mask: torch.Tensor,
               bsk_scan: torch.Tensor, base_log: int, levels: int,
               lib=None) -> torch.Tensor:
    """Check the operands and launch one Garner-tail entry of K3 on the GPU
    (``blind_rotate_crt``: int64 accumulator; ``blind_rotate_crt_acc32``:
    int32), or of ``lib`` (the kernel bench's reference loop)."""
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
    _launch(entry, getattr(lib or _k3_lib(), entry), dev,
        _ptr(acc), _ptr(a32), _ptr(bsk_scan), _ptr(tables), _ptr(out),
        B, n_steps, R, levels, base_log, N.bit_length() - 1, P,
        _garner_host(plan), plan.full_prod_mod64)
    return out


def _wide_shape(acc: torch.Tensor, key: torch.Tensor, levels: int,
                acc_bytes: int, base_log: int = 1):
    """Where an operand pair of K3 (key [n, 2, P, l R, R, N]) or K5b
    (bundles [B, count, P, l R, R, N]) goes: :func:`wide_route` at its
    shape, None (K3 / K5b), "cluster", "split" or "global" (None for
    operands of another rank: K3's and K5b's own checks raise on them)."""
    if acc.ndim != 3 or key.ndim != 6:
        return None
    return wide_route(key.shape[2], acc.shape[1], levels, acc.shape[2],
                      acc_bytes, base_log)


def blind_rotate_crt(acc: torch.Tensor, msed_mask: torch.Tensor,
                     bsk_scan: torch.Tensor, base_log: int,
                     levels: int) -> torch.Tensor:
    """K3 wrapper, Garner tail: see :func:`blind_rotate_crt_plain`. A
    shape whose acc and digits exceed a block's shared memory goes to K7
    (:func:`wide_route`: :func:`blind_rotate_wide_cluster`,
    :func:`blind_rotate_wide_split` or :func:`blind_rotate_wide`), which
    counts its own launches."""
    if acc.device.type == "cpu":
        return blind_rotate_crt_plain(acc, msed_mask, bsk_scan, base_log,
                                      levels)
    route = _wide_shape(acc, bsk_scan, levels, 8, base_log)
    if route:
        return WIDE_ROUTES[route][0](acc, msed_mask, bsk_scan, base_log,
                                     levels)
    out = launch_crt("blind_rotate_crt", acc, msed_mask, bsk_scan, base_log,
                      levels)
    blind_rotate_crt.launches += 1
    return out


def blind_rotate_crt_acc32(acc_hi: torch.Tensor, msed_mask: torch.Tensor,
                           bsk_scan: torch.Tensor, base_log: int,
                           levels: int) -> torch.Tensor:
    """K3-acc32 wrapper: see :func:`blind_rotate_crt_acc32_plain`. Beyond
    a block's shared memory: K7 (:func:`blind_rotate_wide_cluster_acc32`,
    :func:`blind_rotate_wide_split_acc32` or
    :func:`blind_rotate_wide_acc32`, :func:`wide_route`)."""
    if acc_hi.device.type == "cpu":
        return blind_rotate_crt_acc32_plain(acc_hi, msed_mask, bsk_scan,
                                            base_log, levels)
    route = _wide_shape(acc_hi, bsk_scan, levels, 4, base_log)
    if route:
        return WIDE_ROUTES[route][1](acc_hi, msed_mask, bsk_scan, base_log,
                                     levels)
    out = launch_crt("blind_rotate_crt_acc32", acc_hi, msed_mask, bsk_scan,
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
    _launch("blind_rotate_bnf2_u64", _k3_lib().blind_rotate_bnf2_u64, dev,
        _ptr(acc), _ptr(a32), _ptr(bsk_scan2), _ptr(tables), _ptr(out),
        B, n_steps, R, levels, base_log, N.bit_length() - 1, fl.p0, fl.p1,
        fl.inv01, fl.inv01_sh, fl.g0, fl.g1, fl.s1, fl.s2)
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
    _launch("blind_rotate_goldilocks", _k4_lib().blind_rotate_goldilocks, dev,
        _ptr(acc), _ptr(a32), _ptr(bsk_k), _ptr(tables), _ptr(out), B,
        n_steps, R, levels, base_log, N.bit_length() - 1)
    blind_rotate_goldilocks.launches += 1
    return out


blind_rotate_goldilocks.launches = 0


# ---------------------------------------------------------------------------
# K6: the n CMUX steps of the prime-modulus NTT64 blind rotation
# ---------------------------------------------------------------------------

def ntt64_smem_bytes(R: int, levels: int, N: int) -> int:
    """Dynamic shared memory of one K6 block: acc, the l*R digit
    transforms and the R MAC results, u64 (``blind_rotate_ntt64_smem``)."""
    return (R + levels * R + R) * N * 8


def ntt64_refusal(R: int, levels: int, base_log: int, N: int) -> str:
    """Why K6 cannot run a shape ('' when it can): N a power of two in
    [256, 8192], 0 < b*l < 64, one block's shared memory within the card's
    232,448 B."""
    if not (256 <= N <= 8192 and N & (N - 1) == 0):
        return (f"NTT64 PBS: N = {N} outside K6's envelope (a power of two "
                "in [256, 8192])")
    if not (base_log >= 1 and levels >= 1 and base_log * levels < 64):
        return (f"NTT64 PBS: base_log = {base_log}, levels = {levels} "
                "outside K6's envelope (b*l < 64)")
    smem = ntt64_smem_bytes(R, levels, N)
    if smem > _SMEM_LIMIT:
        return (f"NTT64 PBS: R = {R}, l = {levels}, N = {N} needs {smem} B "
                f"of shared memory a block, above the card's {_SMEM_LIMIT}")
    return ""


def blind_rotate_ntt64_plain(acc: torch.Tensor, mask_sw: torch.Tensor,
                             bsk_hat: torch.Tensor, base_log: int,
                             levels: int) -> torch.Tensor:
    """The n CMUX steps of the mod-q blind rotation after its body rotation
    (spec of K6: ``ntt64_pbs.cmux_steps_q``, the loop of ``tfhe_tpu``'s
    ``ntt64_pbs.blind_rotate_ntt64``). ``acc``: int64[B, R, N] canonical
    mod q; ``mask_sw``: [B, n] in [0, 2N]; ``bsk_hat``: int64[n, l, R, R,
    N], ``ntt64_pbs.bootstrap_key_to_ntt64``. Returns int64[B, R, N]."""
    return n64.cmux_steps_q(acc, mask_sw, bsk_hat, base_log, levels)


@functools.lru_cache(maxsize=None)
def _k6_lib():
    from .._build import cuda_lib

    lib = cuda_lib("blind_rotate_ntt64")
    i, v = ctypes.c_int, ctypes.c_void_p
    lib.blind_rotate_ntt64.argtypes = [v, v, v, v, v, i, i, i, i, i, i, v]
    lib.blind_rotate_ntt64.restype = ctypes.c_int
    return lib


def blind_rotate_ntt64(acc: torch.Tensor, mask_sw: torch.Tensor,
                       bsk_hat: torch.Tensor, base_log: int,
                       levels: int) -> torch.Tensor:
    """K6 wrapper: see :func:`blind_rotate_ntt64_plain`. The key is read as
    it is (the transform's DIF order is K6's)."""
    if acc.device.type == "cpu":
        return blind_rotate_ntt64_plain(acc, mask_sw, bsk_hat, base_log,
                                        levels)
    dev = acc.device
    if dev.type != "cuda":
        raise ValueError(f"blind_rotate_ntt64: unsupported device {dev}")
    _check(acc, "acc", torch.int64, 3, dev)
    B, R, N = acc.shape
    why = ntt64_refusal(R, levels, base_log, N)
    if why:
        raise ValueError(why)
    n_steps = bsk_hat.shape[0]
    _check(bsk_hat, "bsk_hat", torch.int64, 5, dev)
    if tuple(bsk_hat.shape[1:]) != (levels, R, R, N):
        raise ValueError(f"bsk_hat shape {tuple(bsk_hat.shape)} != "
                         f"[n, {levels}, {R}, {R}, {N}]")
    if tuple(mask_sw.shape) != (B, n_steps):
        raise ValueError(f"mask_sw shape {tuple(mask_sw.shape)} != "
                         f"{(B, n_steps)}")
    if not 0 < B < 2 ** 31:
        raise ValueError(f"batch {B} outside the kernel grid")
    a32 = mask_sw.to(device=dev, dtype=torch.int32).contiguous()
    tables = _goldilocks_tables_dev(N, str(dev))
    out = torch.empty_like(acc)
    _launch("blind_rotate_ntt64", _k6_lib().blind_rotate_ntt64, dev,
        _ptr(acc), _ptr(a32), _ptr(bsk_hat), _ptr(tables), _ptr(out), B,
        n_steps, R, levels, base_log, N.bit_length() - 1)
    blind_rotate_ntt64.launches += 1
    return out


blind_rotate_ntt64.launches = 0


# ---------------------------------------------------------------------------
# K5: the n/g group steps of the multi-bit blind rotation
# ---------------------------------------------------------------------------

MAX_MB_LEVELS = 8  # G1's constant table holds 8 levels a prime
#: K5's instantiations: its prime count (that of every multi-bit set of the
#: universe) and groupings
MB_PRIMES = 4
MB_GROUPINGS = (2, 3, 4)
#: bytes of the key bundles one K5a/K5b pair holds (:func:`multi_bit_chunk`)
MB_SCRATCH_BYTES = 2 << 30


def multi_bit_key_layout(residues: torch.Tensor) -> torch.Tensor:
    """The multi-bit key as K5 reads it: ``tfhe_tpu``'s stored residues and
    Shoup duals [2, P, n/g, 2^g-1, l, R, R, N] -> int32 [n/g, 2, P, 2^g-1,
    l*R, R, N] (contiguous: one group step's key in one run)."""
    two, P, ng, nsub, l, R, R2, N = residues.shape
    return residues.movedim(2, 0).reshape(ng, two, P, nsub, l * R, R2,
                                          N).contiguous()


def multi_bit_legacy_layout(mbk: torch.Tensor, levels: int) -> torch.Tensor:
    """Inverse of :func:`multi_bit_key_layout` (a view)."""
    ng, two, P, nsub, lR, R, N = mbk.shape
    return mbk.reshape(ng, two, P, nsub, levels, lR // levels, R,
                       N).movedim(0, 2)


def multi_bit_grouping(mbk: torch.Tensor) -> int:
    """g of a key in K5's layout (its 2^g - 1 subsets)."""
    return (mbk.shape[3] + 1).bit_length() - 1


def multi_bit_occupancy(R: int, levels: int, N: int, grouping: int) -> dict:
    """:func:`step_occupancy` of K5's kernels at their prime count and
    ``grouping``: {"keybundle": K5a, "accumulate": K5b, "r14": the
    single-kernel reference} (their ``<entry>_occupancy`` exports)."""
    lib = _step_lib("multi_bit_accumulate")
    shape = (MB_PRIMES, R, levels, N.bit_length() - 1)
    return {"keybundle": _occupancy(lib.multi_bit_keybundle_occupancy,
                                    "multi_bit_keybundle", *shape, grouping),
            "accumulate": _occupancy(lib.multi_bit_accumulate_occupancy,
                                     "multi_bit_accumulate", *shape),
            "r14": _occupancy(lib.blind_rotate_multi_bit_r14_occupancy,
                              "blind_rotate_multi_bit_r14", *shape, grouping)}


def multi_bit_refusal(P: int, grouping: int, R: int, levels: int,
                      base_log: int, N: int):
    """Why the multi-bit kernels cannot run a shape, or None: K5's
    instantiations (P = MB_PRIMES, g in MB_GROUPINGS), G1's table (levels
    <= MAX_MB_LEVELS), then :func:`crt_refusal` (K5a takes N up to
    :data:`WIDE_MAX_N`; the external products run on K5b or, beyond a
    block's shared memory, on K7). Needs no built library."""
    if P != MB_PRIMES or grouping not in MB_GROUPINGS:
        return (f"K5 is instantiated at P = {MB_PRIMES}, g in "
                f"{MB_GROUPINGS}, not P = {P}, g = {grouping}")
    if levels > MAX_MB_LEVELS:
        return f"K5 takes levels <= {MAX_MB_LEVELS}, not {levels}"
    return crt_refusal(P, R, levels, base_log, N)


def multi_bit_chunk(B: int, n_groups: int, P: int, lR: int, R: int,
                    N: int) -> int:
    """C, the group steps of one K5a/K5b pair: as many as the bundles of
    ``B`` ciphertexts (P*lR*R*N u32 a ciphertext-step) fit in
    :data:`MB_SCRATCH_BYTES`, at least 1, at most ``n_groups``. A call
    makes ceil(n_groups / C) pairs."""
    per_step = B * P * lR * R * N * 4
    return max(1, min(n_groups, MB_SCRATCH_BYTES // per_step))


def blind_rotate_multi_bit_plain(acc: torch.Tensor, msed_mask: torch.Tensor,
                                 mbk: torch.Tensor, base_log: int,
                                 levels: int) -> torch.Tensor:
    """The n/g group steps of the multi-bit blind rotation on the u64
    accumulator after its body rotation (spec of the K5 pair and of r14:
    ``server.multi_bit_group_steps``). ``acc``: int64[B, R, N];
    ``msed_mask``: [B, n] in [0, 2N); ``mbk``: int32[n/g, 2, P, 2^g-1,
    l*R, R, N] (:func:`multi_bit_key_layout`). Returns int64[B, R, N]."""
    from . import server  # server imports this module

    P, N = mbk.shape[2], mbk.shape[-1]
    res = multi_bit_legacy_layout(mbk, levels)[0]
    return server.multi_bit_group_steps(acc, msed_mask, res, base_log, levels,
                                        multi_bit_grouping(mbk),
                                        ntt_mod.get_plan(N, P))


def multi_bit_keybundle_plain(msed_mask: torch.Tensor, mbk: torch.Tensor,
                              t0: int, count: int, base_log: int,
                              levels: int) -> torch.Tensor:
    """The key bundles of group steps t0 .. t0+count-1 (spec of K5a:
    ``server.multi_bit_keybundle_plain``) on the key in K5's layout.
    ``msed_mask``: [B, n] in [0, 2N); ``mbk``: int32[n/g, 2, P, 2^g-1,
    l*R, R, N]. Returns int32 [B, count, P, l*R, R, N] (u32 residues)."""
    from . import server  # server imports this module

    P, N = mbk.shape[2], mbk.shape[-1]
    res = multi_bit_legacy_layout(mbk, levels)[0]
    return server.multi_bit_keybundle_plain(
        msed_mask, res, t0, count, base_log, levels, multi_bit_grouping(mbk),
        ntt_mod.get_plan(N, P)).to(torch.int32)


def multi_bit_accumulate_plain(acc: torch.Tensor, bundles: torch.Tensor,
                               base_log: int, levels: int) -> torch.Tensor:
    """The external products of a chunk of group steps against their key
    bundles (spec of K5b: ``server.multi_bit_accumulate_plain``). ``acc``:
    int64[B, R, N]; ``bundles``: int32 [B, count, P, l*R, R, N]. Returns
    int64[B, R, N]."""
    from . import server  # server imports this module

    P, N = bundles.shape[2], bundles.shape[-1]
    return server.multi_bit_accumulate_plain(acc, bundles, base_log, levels,
                                             ntt_mod.get_plan(N, P))


def multi_bit_exponents(plan: ntt_mod.NegacyclicNtt) -> np.ndarray:
    """e_t, int32[N]: the transform's point t of every prime evaluates at
    psi^{e_t} (e_t = 2 bitrev(t) + 1, the DIF order), checked against the
    plan's own transform of X: NTT(X^a - 1)[t] = psi^{e_t a} - 1."""
    n, log_n = plan.n, plan.log_n
    t = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((t >> b) & 1) << (log_n - 1 - b)
    e = 2 * rev + 1
    x = torch.zeros(n, dtype=torch.int64)
    x[1] = 1
    got = plan.fwd_digits(x).numpy()
    for pi, p in enumerate(plan.primes):
        psi = int(plan.twist[pi][1])
        want = [pow(psi, int(k), p) for k in e]
        if not np.array_equal(got[pi], np.array(want, dtype=np.int64)):
            raise AssertionError(f"the transform's points at p={p} are not "
                                 "psi^(2 bitrev(t) + 1)")
    return e.astype(np.int32)


def multi_bit_constants(plan: ntt_mod.NegacyclicNtt, base_log: int,
                        levels: int, R: int):
    """K5's MAC constants: G1's gadget entries u32[5, 8] (prime, level) and
    their Shoup duals, from ``server._trivial_ggsw_one_hat``, whose only
    non-zero entries are diagonal and equal at every point (checked), and
    each prime's Barrett constant floor(2^64 / p), u64[5]."""
    from . import server  # server imports this module

    if levels > MAX_MB_LEVELS:
        raise ValueError(f"levels={levels}: K5 holds {MAX_MB_LEVELS}")
    triv = server._trivial_ggsw_one_hat(plan.n, plan.num_primes, base_log,
                                        levels, R)  # [P, l, R, R, N]
    diag = triv[:, :, 0, 0, 0]  # [P, l]
    off = triv.copy()
    for r in range(R):
        if not (triv[:, :, r, r] == diag[..., None]).all():
            raise AssertionError("G1's diagonal is not one constant")
        off[:, :, r, r] = 0
    if off.any():
        raise AssertionError("G1 is not diagonal")
    g1 = np.zeros((MAX_CRT_PRIMES, MAX_MB_LEVELS), dtype=np.uint64)
    g1_sh = np.zeros_like(g1)
    mu = np.zeros(MAX_CRT_PRIMES, dtype=np.uint64)
    for pi, p in enumerate(plan.primes):
        mu[pi] = (1 << 64) // p
        for lev in range(levels):
            g1[pi, lev] = diag[pi, lev]
            g1_sh[pi, lev] = (int(g1[pi, lev]) << 32) // p
    return g1.astype(np.uint32), g1_sh.astype(np.uint32), mu


@functools.lru_cache(maxsize=None)
def _k5_lib():
    from .._build import cuda_lib

    lib = cuda_lib("blind_rotate_multi_bit")
    i, v, ull = ctypes.c_int, ctypes.c_void_p, ctypes.c_ulonglong
    lib.blind_rotate_multi_bit_r14.argtypes = [
        v, v, v, v, v, v, i, i, i, i, i, i, i, i, v, ull, v, v, v, v]
    lib.multi_bit_keybundle.argtypes = [
        v, v, v, v, v, i, i, i, i, i, i, i, i, i, v, v, v, v]
    lib.multi_bit_accumulate.argtypes = [
        v, v, v, v, i, i, i, i, i, i, i, v, ull, v, v]
    for entry in (lib.blind_rotate_multi_bit_r14, lib.multi_bit_keybundle,
                  lib.multi_bit_accumulate):
        entry.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _k5_host(plan: ntt_mod.NegacyclicNtt, base_log: int, levels: int,
             R: int, device: str):
    """K5's constants: the exponents on ``device``, G1 and the Barrett
    constants as ctypes arrays (host memory)."""
    g1, g1_sh, mu = multi_bit_constants(plan, base_log, levels, R)
    u32 = lambda a: (ctypes.c_uint * a.size)(*[int(x) for x in a.ravel()])
    exps = torch.from_numpy(multi_bit_exponents(plan)).to(device)
    return (exps, u32(g1), u32(g1_sh),
            (ctypes.c_ulonglong * mu.size)(*[int(x) for x in mu]))


def _multi_bit_key_shapes(name: str, mbk: torch.Tensor, device):
    """Check a key in K5's layout on ``device``; returns (P, g)."""
    P = mbk.shape[2] if mbk.ndim == 7 else 0
    if P != MB_PRIMES:
        raise ValueError(f"mbk {tuple(mbk.shape)}: {name} takes "
                         f"{MB_PRIMES} primes")
    g = multi_bit_grouping(mbk)
    if g not in MB_GROUPINGS or mbk.shape[3] != (1 << g) - 1:
        raise ValueError(f"mbk {tuple(mbk.shape)}: {name} takes "
                         f"groupings {MB_GROUPINGS}")
    _check(mbk, "mbk", torch.int32, 7, device)
    return P, g


def multi_bit_keybundle(msed_mask: torch.Tensor, mbk: torch.Tensor, t0: int,
                        count: int, base_log: int, levels: int,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """K5a wrapper: see :func:`multi_bit_keybundle_plain`. ``out``: a
    buffer of at least B*count*P*l*R*R*N int32 on the key's device to
    write the bundles into (its first elements, viewed in their shape);
    allocated when None."""
    if mbk.device.type == "cpu":
        return multi_bit_keybundle_plain(msed_mask, mbk, t0, count, base_log,
                                         levels)
    dev = mbk.device
    if dev.type != "cuda":
        raise ValueError(f"multi_bit_keybundle: unsupported device {dev}")
    P, g = _multi_bit_key_shapes("multi_bit_keybundle", mbk, dev)
    ng, _, _, _, lR, R, N = mbk.shape
    if lR != levels * R or N & (N - 1) or not 8 <= N <= WIDE_MAX_N:
        raise ValueError(f"mbk shape {tuple(mbk.shape)} does not match "
                         f"levels={levels}")
    B = msed_mask.shape[0]
    if msed_mask.ndim != 2 or msed_mask.shape[1] != ng * g or B < 1:
        raise ValueError(f"msed_mask shape {tuple(msed_mask.shape)} != "
                         f"(B, {ng * g})")
    if not (0 <= t0 and 1 <= count and t0 + count <= ng):
        raise ValueError(f"steps {t0}..{t0 + count - 1} outside 0..{ng - 1}")
    a32 = msed_mask.to(device=dev, dtype=torch.int32).contiguous()
    shape = (B, count, P, lR, R, N)
    size = B * count * P * lR * R * N
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=dev)
    else:
        if out.dtype != torch.int32 or out.device != dev or \
                out.numel() < size or not out.is_contiguous():
            raise ValueError(f"out: {out.dtype} {tuple(out.shape)} on "
                             f"{out.device} cannot hold {shape} int32")
        out = out.reshape(-1)[:size].view(shape)
    plan = ntt_mod.get_plan(N, P)
    tables = _plan_tables_dev(plan, str(dev))
    exps, g1, _, mu = _k5_host(plan, base_log, levels, R, str(dev))
    _launch("multi_bit_keybundle", _k5_lib().multi_bit_keybundle, dev,
        _ptr(a32), _ptr(mbk), _ptr(tables), _ptr(exps), _ptr(out), B,
        ng * g, t0, count, g, R, levels, N.bit_length() - 1, P,
        _garner_host(plan), g1, mu)
    multi_bit_keybundle.launches += 1
    return out


def multi_bit_accumulate(acc: torch.Tensor, bundles: torch.Tensor,
                         base_log: int, levels: int) -> torch.Tensor:
    """K5b wrapper: see :func:`multi_bit_accumulate_plain`. A shape whose
    acc and digits exceed a block's shared memory goes to K7
    (:func:`multi_bit_accumulate_wide_cluster`,
    :func:`multi_bit_accumulate_wide_split` or
    :func:`multi_bit_accumulate_wide`, :func:`wide_route`), which counts
    its own launches."""
    if acc.device.type == "cpu":
        return multi_bit_accumulate_plain(acc, bundles, base_log, levels)
    route = _wide_shape(acc, bundles, levels, 8, base_log)
    if route:
        return WIDE_ROUTES[route][2](acc, bundles, base_log, levels)
    B, R, N = _acc_shapes("multi_bit_accumulate", acc, MB_PRIMES, base_log,
                          levels, torch.int64)
    _check(bundles, "bundles", torch.int32, 6, acc.device)
    count, P = bundles.shape[1:3]
    if tuple(bundles.shape) != (B, count, MB_PRIMES, levels * R, R, N):
        raise ValueError(f"bundles shape {tuple(bundles.shape)} != [{B}, "
                         f"count, {MB_PRIMES}, {levels * R}, {R}, {N}]")
    dev = acc.device
    plan = ntt_mod.get_plan(N, P)
    tables = _plan_tables_dev(plan, str(dev))
    _, _, _, mu = _k5_host(plan, base_log, levels, R, str(dev))
    out = torch.empty_like(acc)
    _launch("multi_bit_accumulate", _k5_lib().multi_bit_accumulate, dev,
        _ptr(acc), _ptr(bundles), _ptr(tables), _ptr(out), B, count, R,
        levels, base_log, N.bit_length() - 1, P, _garner_host(plan),
        plan.full_prod_mod64, mu)
    multi_bit_accumulate.launches += 1
    return out


def blind_rotate_multi_bit(acc: torch.Tensor, msed_mask: torch.Tensor,
                           mbk: torch.Tensor, base_log: int,
                           levels: int) -> torch.Tensor:
    """The K5 pair: see :func:`blind_rotate_multi_bit_plain`. Chunks of
    C = :func:`multi_bit_chunk` group steps, each one K5a launch (the
    chunk's key bundles, into one scratch buffer of the call) and one K5b
    launch, counted by their wrappers."""
    dev = acc.device
    if dev.type == "cpu":
        return blind_rotate_multi_bit_plain(acc, msed_mask, mbk, base_log,
                                            levels)
    if dev.type != "cuda":
        raise ValueError(f"blind_rotate_multi_bit: unsupported device {dev}")
    if acc.ndim != 3 or mbk.ndim != 7:
        raise ValueError(f"acc {tuple(acc.shape)}, mbk {tuple(mbk.shape)}: "
                         "expected [B, R, N] and K5's key layout")
    B, R, N = acc.shape
    ng, _, P, _, lR = mbk.shape[:5]
    chunk = multi_bit_chunk(B, ng, P, lR, R, N)
    scratch = torch.empty(B * chunk * P * lR * R * N, dtype=torch.int32,
                          device=dev)
    for t0 in range(0, ng, chunk):
        count = min(chunk, ng - t0)
        bundles = multi_bit_keybundle(msed_mask, mbk, t0, count, base_log,
                                      levels, out=scratch)
        acc = multi_bit_accumulate(acc, bundles, base_log, levels)
    return acc


def blind_rotate_multi_bit_r14(acc: torch.Tensor, msed_mask: torch.Tensor,
                               mbk: torch.Tensor, base_log: int,
                               levels: int) -> torch.Tensor:
    """r14, the single-kernel reference of the K5 pair (all n/g steps of
    a ciphertext in one block, streaming the key), launched by no user
    path: see :func:`blind_rotate_multi_bit_plain`."""
    if acc.device.type == "cpu":
        return blind_rotate_multi_bit_plain(acc, msed_mask, mbk, base_log,
                                            levels)
    name = "blind_rotate_multi_bit_r14"
    if acc.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {acc.device}")
    P, g = _multi_bit_key_shapes(name, mbk, acc.device)
    (B, n, R, N), a32 = _acc_mask_shapes(
        name, acc, msed_mask, mbk.shape[0] * g, P, base_log, levels,
        torch.int64)
    if tuple(mbk.shape[1:]) != (2, P, (1 << g) - 1, levels * R, R, N):
        raise ValueError(f"mbk shape {tuple(mbk.shape)} does not match "
                         f"P={P}, g={g}, R={R}, levels={levels}, N={N}")
    dev = acc.device
    plan = ntt_mod.get_plan(N, P)
    tables = _plan_tables_dev(plan, str(dev))
    exps, g1, g1_sh, mu = _k5_host(plan, base_log, levels, R, str(dev))
    out = torch.empty_like(acc)
    _launch(name, _k5_lib().blind_rotate_multi_bit_r14, dev,
        _ptr(acc), _ptr(a32), _ptr(mbk), _ptr(tables), _ptr(exps), _ptr(out),
        B, mbk.shape[0], g, R, levels, base_log, N.bit_length() - 1, P,
        _garner_host(plan), plan.full_prod_mod64, g1, g1_sh, mu)
    blind_rotate_multi_bit_r14.launches += 1
    return out


multi_bit_keybundle.launches = 0
multi_bit_accumulate.launches = 0
blind_rotate_multi_bit_r14.launches = 0


# ---------------------------------------------------------------------------
# K7: K3's and K5b's functions beyond a block's shared memory: the cluster
# kernel (acc and digits in a cluster's distributed shared memory) and K7
# global (acc and digits in global memory)
# ---------------------------------------------------------------------------

#: K7's largest N: one u32 polynomial (128 KiB) in a block's shared memory
WIDE_MAX_N = 32768
#: bytes of K7's digit and residue scratch a call holds (:func:`wide_chunk`)
WIDE_SCRATCH_BYTES = 1 << 30


def step_smem_formula(P: int, R: int, levels: int, N: int,
                      acc_bytes: int) -> int:
    """Bytes of a K3 / K5b block's shared memory at this shape, the
    accumulator [R][N] and the digits [l R][P][N] u32: the formula their
    ``<entry>_smem`` exports compute (``chip_smoke.py``'s build phase holds
    them equal), here without the built library."""
    return R * N * acc_bytes + 4 * P * levels * R * N


def needs_wide(P: int, R: int, levels: int, N: int,
               acc_bytes: int = 8) -> bool:
    """Whether a CRT step at this shape exceeds one block's shared memory,
    so that K7 runs it in place of K3 (``acc_bytes`` 8, or 4 for acc32) or
    K5b (8)."""
    return step_smem_formula(P, R, levels, N, acc_bytes) > _SMEM_LIMIT


#: the cluster kernel's largest P R (its cluster at split 1: the portable
#: maximum; 2 P R = 16 CTAs at split 2) and its N at each split
CLUSTER_MAX_CTAS = 8
CLUSTER_MIN_N = 256
CLUSTER_MAX_N = {1: 16384, 2: 32768}


def cluster_log_slice(N: int, P: int, split: int = 1) -> int:
    """log2 S (``cluster_log_slice`` in ``csrc/blind_rotate_wide.cu``):
    split 1, a cluster CTA's accumulator slice S = 2^ceil(log2(N / P));
    split 2, the pairs (t, t + N/2) a CTA owns, S = 2^ceil(log2(N / 4P))."""
    return (N.bit_length() - 1) - (P.bit_length() - 1) - 2 * (split - 1)


def split_area(P: int, R: int, levels: int, N: int, stream: bool = False,
               digit_bytes: int = 2) -> int:
    """Bytes of one CTA of the split (``split_area``): its half of the
    digit area, [max(l, R)][N/2] u32 holding all l digit transforms, or
    (``stream``) [R + 1][N/2], the R partials and one transform; and the
    digits of its 2 S positions [l][2 S], ``digit_bytes`` each (their
    accumulator words stay in global memory)."""
    S = 1 << cluster_log_slice(N, P, 2)
    rows = R + 1 if stream else max(levels, R)
    return rows * (N // 2) * 4 + levels * 2 * S * digit_bytes


def split_streams(P: int, R: int, levels: int, N: int) -> bool:
    """Whether the split's entries stream the levels at this shape: a CTA
    holding all l digit transforms exceeds a block's shared memory (N =
    32768 at l >= 4; ``split_streams`` in the kernel)."""
    return split_area(P, R, levels, N) > _SMEM_LIMIT


def split_digit_bytes(P: int, R: int, levels: int, N: int) -> int:
    """Bytes a digit of the split's store at this shape: 2 (int16), or 1
    (int8, so b <= 7) where the split streams and int16 digits do not fit
    a block beside its buffers (N = 32768 at l >= 5)."""
    if split_streams(P, R, levels, N) and \
            split_area(P, R, levels, N, True, 2) > _SMEM_LIMIT:
        return 1
    return 2


def cluster_smem_formula(P: int, R: int, levels: int, N: int,
                         acc_bytes: int, split: int = 1) -> int:
    """Bytes of one CTA of the cluster kernel. Split 1: its digit area
    [max(l, R)][N] u32, its accumulator slice [S] and the slice's digits
    [l][S] i32; split 2: :func:`split_area` of the instantiation the
    shape takes (levels held or streamed, :func:`split_digit_bytes`). The
    formula of the ``blind_rotate_wide_{cluster,split}*_smem`` exports,
    which ``chip_smoke.py``'s build phase holds equal, without the
    library."""
    if split == 2:
        return split_area(P, R, levels, N, split_streams(P, R, levels, N),
                          split_digit_bytes(P, R, levels, N))
    S = 1 << cluster_log_slice(N, P, split)
    return max(levels, R) * N * 4 + S * acc_bytes + levels * S * 4


def fits_cluster(P: int, R: int, levels: int, N: int,
                 acc_bytes: int = 8, split: int = 1,
                 base_log: int = 1) -> bool:
    """Whether the cluster kernel at ``split`` 1 or 2 takes this shape:
    P R at most :data:`CLUSTER_MAX_CTAS` (split P R CTAs a cluster), N in
    CLUSTER_MIN_N..CLUSTER_MAX_N[split], a CTA within a block's shared
    memory, and at split 2 l >= 2, ``base_log`` <= 15 (a balanced digit
    in its int16 store) or <= 7 (int8, :func:`split_digit_bytes`), and the
    u64 accumulator at P >= 3 where the split streams (2 primes cannot
    hold an N = 32768 product). 1, the default ``base_log``, asks about P,
    R, l and N alone. ``cluster_fits`` less its decomposer bound,
    :func:`crt_refusal`'s."""
    if not (2 <= P <= MAX_CRT_PRIMES and R >= 1
            and levels >= (2 if split == 2 else 1)
            and P * R <= CLUSTER_MAX_CTAS
            and CLUSTER_MIN_N <= N <= CLUSTER_MAX_N[split]):
        return False
    if split == 2 and (
            base_log > 8 * split_digit_bytes(P, R, levels, N) - 1
            or (acc_bytes != 8 or P < 3) and split_streams(P, R, levels, N)):
        return False
    return cluster_smem_formula(P, R, levels, N, acc_bytes, split) \
        <= _SMEM_LIMIT


def wide_route(P: int, R: int, levels: int, N: int, acc_bytes: int = 8,
               base_log: int = 1):
    """The kernel of a CRT step at this shape, from the shape alone: None
    (K3, or K5b: acc and digits fit a block), "cluster" (K7's cluster
    kernel: its CTA fits), "split" (the cluster kernel at split 2: a CTA
    of half the transforms fits, or streamed a level at a time where
    :func:`split_streams`: N = 32768 at l = 4 to 6, tfhe-rs's sets with 4
    to 6 levels, ``base_log`` <= 15 at l = 4, <= 7 beyond, u64
    accumulator) or "global" (K7 global, the three-stage design: P R > 8,
    l = 1 at N = 32768, the acc32 entry where the split would stream)."""
    if not needs_wide(P, R, levels, N, acc_bytes):
        return None
    for route, split in (("cluster", 1), ("split", 2)):
        if fits_cluster(P, R, levels, N, acc_bytes, split, base_log):
            return route
    return "global"


def crt_refusal(P: int, R: int, levels: int, base_log: int, N: int):
    """Why neither K3 (K5b) nor K7 can run an exact CRT step at this shape
    on the u64 accumulator, or None: 2..MAX_CRT_PRIMES primes, a decomposer
    (:func:`decomposer_refusal`: the hi word's at base_log * levels <= 31,
    the 64-bit one at 32..63 and :data:`DEEP_PRIMES` primes), and beyond a
    block's shared memory N <= :data:`WIDE_MAX_N` (one polynomial in a
    block). Needs no built library."""
    if not 2 <= P <= MAX_CRT_PRIMES:
        return f"the CRT kernels take 2..{MAX_CRT_PRIMES} primes, not {P}"
    why = decomposer_refusal("blind_rotate_crt", P, base_log, levels)
    if why:
        return why
    if needs_wide(P, R, levels, N) and N > WIDE_MAX_N:
        return (f"N = {N}: one u32 polynomial is {4 * N // 1024} KiB, and "
                f"acc and digits {step_smem_formula(P, R, levels, N, 8)} B, "
                f"beyond a block's {_SMEM_LIMIT} B of shared memory (K7 "
                f"holds N <= {WIDE_MAX_N})")
    return None


def wide_chunk(B: int, R: int, levels: int, P: int, N: int) -> int:
    """Ciphertexts of one K7 entry call: as many as their digits [l R, P,
    N] and residues [R, P, N] u32 fit :data:`WIDE_SCRATCH_BYTES`, at least
    1, at most ``B``."""
    per = (levels * R + R) * P * N * 4
    return max(1, min(B, WIDE_SCRATCH_BYTES // per))


@functools.lru_cache(maxsize=None)
def _k7_lib():
    from .._build import cuda_lib

    lib = cuda_lib("blind_rotate_wide")
    i, v, ull = ctypes.c_int, ctypes.c_void_p, ctypes.c_ulonglong
    for entry in (lib.blind_rotate_wide, lib.blind_rotate_wide_acc32):
        entry.argtypes = [v, v, v, v, v, v, i, i, i, i, i, i, i, v, ull, v]
        entry.restype = ctypes.c_int
    lib.multi_bit_accumulate_wide.argtypes = [
        v, v, v, v, v, i, i, i, i, i, i, i, v, ull, v, v]
    lib.multi_bit_accumulate_wide.restype = ctypes.c_int
    return lib


def wide_occupancy(P: int, R: int, levels: int, N: int) -> dict:
    """Resident blocks per SM, registers and local (spill) bytes per
    thread of K7's three stages ({"decompose": K7a, "mac": K7b, "garner":
    K7c}) at this shape (``blind_rotate_wide_occupancy``). Needs the built
    library and a GPU."""
    fn = _k7_lib().blind_rotate_wide_occupancy
    return {name: _occupancy(fn, "blind_rotate_wide", P, R, levels,
                             N.bit_length() - 1, stage)
            for stage, name in enumerate(("decompose", "mac", "garner"))}


def _wide_acc(name: str, acc: torch.Tensor, P: int, base_log: int,
              levels: int, acc_dtype):
    """Check K7's accumulator and geometry; returns (B, R, N)."""
    dev = acc.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    _check(acc, "acc", acc_dtype, 3, dev)
    B, R, N = acc.shape
    if N & (N - 1) or not 8 <= N <= WIDE_MAX_N:
        raise ValueError(f"{name}: N={N} is not a power of two in 8.."
                         f"{WIDE_MAX_N}")
    why = crt_refusal(P, R, levels, base_log, N)
    if acc_dtype == torch.int32 and not why:
        why = decomposer_refusal(name, P, base_log, levels)
    if why:
        raise ValueError(f"{name}: {why}")
    if not 0 < B < 2 ** 31 or levels * R >= 65536:
        raise ValueError(f"{name}: batch {B}, l R = {levels * R} outside "
                         "the kernel grid")
    return B, R, N


def _run_wide(name: str, entry, acc: torch.Tensor, rows: torch.Tensor,
              key_args, P: int, levels: int, chunk_args,
              extra=()) -> tuple:
    """Run K7's entry ``entry`` over chunks of :func:`wide_chunk`
    ciphertexts on a copy of ``acc`` (updated in place by the kernels);
    ``rows``: the per-ciphertext operand sliced with the chunk (the
    classic mask, or the multi-bit bundles); ``key_args``: the shared
    pointer arguments after it; ``chunk_args``: the arguments after the
    chunk size; ``extra``: those after the Garner constants. Returns (the
    new accumulator, the entry calls)."""
    dev = acc.device
    B, R, N = acc.shape
    plan = ntt_mod.get_plan(N, P)
    tables = _plan_tables_dev(plan, str(dev))
    out = acc.clone()
    Bc = wide_chunk(B, R, levels, P, N)
    digits = torch.empty(Bc * levels * R * P * N, dtype=torch.int32,
                         device=dev)
    res = torch.empty(Bc * R * P * N, dtype=torch.int32, device=dev)
    calls = 0
    for b0 in range(0, B, Bc):
        bc = min(Bc, B - b0)
        _launch(name, entry, dev, _ptr(out[b0:b0 + bc]),
                _ptr(rows[b0:b0 + bc]), *key_args, _ptr(tables),
                _ptr(digits), _ptr(res), bc, *chunk_args,
                _garner_host(plan), plan.full_prod_mod64, *extra)
        calls += 1
    return out, calls


def _wide_classic(name: str, acc: torch.Tensor, msed_mask: torch.Tensor,
                  bsk_scan: torch.Tensor, base_log: int, levels: int,
                  acc_dtype) -> tuple:
    P = bsk_scan.shape[2] if bsk_scan.ndim == 6 else 0
    B, R, N = _wide_acc(name, acc, P, base_log, levels, acc_dtype)
    n = bsk_scan.shape[0]
    _check(bsk_scan, "bsk", torch.int32, 6, acc.device)
    if tuple(bsk_scan.shape[1:]) != (2, P, levels * R, R, N):
        raise ValueError(f"bsk shape {tuple(bsk_scan.shape)} does not match "
                         f"P={P}, R={R}, levels={levels}, N={N}")
    if tuple(msed_mask.shape) != (B, n):
        raise ValueError(f"msed_mask shape {tuple(msed_mask.shape)} != "
                         f"{(B, n)}")
    a32 = msed_mask.to(device=acc.device, dtype=torch.int32).contiguous()
    return _run_wide(name, getattr(_k7_lib(), name), acc, a32,
                     (_ptr(bsk_scan),), P, levels,
                     (n, R, levels, base_log, N.bit_length() - 1, P))


def blind_rotate_wide(acc: torch.Tensor, msed_mask: torch.Tensor,
                      bsk_scan: torch.Tensor, base_log: int,
                      levels: int) -> torch.Tensor:
    """K7 global (the three-stage design), K3's function on the u64
    accumulator (see :func:`blind_rotate_crt_plain`) at any shape of K7's
    envelope; one launch counted an entry call (the 3 n stage launches of a
    chunk of :func:`wide_chunk` ciphertexts)."""
    if acc.device.type == "cpu":
        return blind_rotate_crt_plain(acc, msed_mask, bsk_scan, base_log,
                                      levels)
    out, calls = _wide_classic("blind_rotate_wide", acc, msed_mask, bsk_scan,
                               base_log, levels, torch.int64)
    blind_rotate_wide.launches += calls
    return out


def blind_rotate_wide_acc32(acc_hi: torch.Tensor, msed_mask: torch.Tensor,
                            bsk_scan: torch.Tensor, base_log: int,
                            levels: int) -> torch.Tensor:
    """K7 global, K3-acc32's function on the u32 hi plane (see
    :func:`blind_rotate_crt_acc32_plain`); launches counted as
    :func:`blind_rotate_wide`'s."""
    if acc_hi.device.type == "cpu":
        return blind_rotate_crt_acc32_plain(acc_hi, msed_mask, bsk_scan,
                                            base_log, levels)
    out, calls = _wide_classic("blind_rotate_wide_acc32", acc_hi, msed_mask,
                               bsk_scan, base_log, levels, torch.int32)
    blind_rotate_wide_acc32.launches += calls
    return out


@functools.lru_cache(maxsize=None)
def _barrett_host(plan: ntt_mod.NegacyclicNtt):
    """floor(2^64 / p) of each prime, zero-padded to 5, as a ctypes u64
    array (host memory)."""
    mu = [(1 << 64) // int(p) for p in plan.primes]
    mu += [0] * (MAX_CRT_PRIMES - len(mu))
    return (ctypes.c_ulonglong * MAX_CRT_PRIMES)(*mu)


def multi_bit_accumulate_wide(acc: torch.Tensor, bundles: torch.Tensor,
                              base_log: int, levels: int) -> torch.Tensor:
    """K7 global, K5b's function (see :func:`multi_bit_accumulate_plain`)
    at any shape of K7's envelope; launches counted as
    :func:`blind_rotate_wide`'s."""
    if acc.device.type == "cpu":
        return multi_bit_accumulate_plain(acc, bundles, base_log, levels)
    name = "multi_bit_accumulate_wide"
    B, R, N = _wide_acc(name, acc, MB_PRIMES, base_log, levels, torch.int64)
    _check(bundles, "bundles", torch.int32, 6, acc.device)
    count = bundles.shape[1]
    if tuple(bundles.shape) != (B, count, MB_PRIMES, levels * R, R, N) \
            or count < 1:
        raise ValueError(f"bundles shape {tuple(bundles.shape)} != [{B}, "
                         f"count, {MB_PRIMES}, {levels * R}, {R}, {N}]")
    out, calls = _run_wide(
        name, _k7_lib().multi_bit_accumulate_wide, acc, bundles, (),
        MB_PRIMES, levels,
        (count, R, levels, base_log, N.bit_length() - 1, MB_PRIMES),
        (_barrett_host(ntt_mod.get_plan(N, MB_PRIMES)),))
    multi_bit_accumulate_wide.launches += calls
    return out


blind_rotate_wide.launches = 0
blind_rotate_wide_acc32.launches = 0
multi_bit_accumulate_wide.launches = 0


@functools.lru_cache(maxsize=None)
def _k7c_lib():
    lib = _k7_lib()
    i, v, ull = ctypes.c_int, ctypes.c_void_p, ctypes.c_ulonglong
    for split in ("cluster", "split"):
        for entry in (getattr(lib, f"blind_rotate_wide_{split}"),
                      getattr(lib, f"blind_rotate_wide_{split}_acc32")):
            entry.argtypes = [v, v, v, v, v, i, i, i, i, i, i, i, v, ull, v]
            entry.restype = ctypes.c_int
        entry = getattr(lib, f"multi_bit_accumulate_wide_{split}")
        entry.argtypes = [v, v, v, v, i, i, i, i, i, i, i, v, ull, v, v]
        entry.restype = ctypes.c_int
        entry = getattr(lib, f"blind_rotate_wide_{split}_occupancy")
        entry.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        entry.restype = ctypes.c_int
    return lib


def wide_cluster_occupancy(P: int, R: int, levels: int, N: int,
                           split: int = 1) -> dict:
    """The classic cluster kernel at ``split`` 1 or 2 (at 2, the
    instantiation the shape takes: levels held or streamed) and this shape:
    registers and local (spill) bytes a thread, dynamic shared memory a
    CTA, cluster size, resident CTAs per SM and clusters resident on the
    card (``cudaOccupancyMaxActiveClusters``). Needs the built library and
    a GPU."""
    name = ("blind_rotate_wide_cluster_occupancy" if split == 1
            else "blind_rotate_wide_split_occupancy")
    out = (ctypes.c_int * 6)()
    rc = getattr(_k7c_lib(), name)(P, R, levels, N.bit_length() - 1, out)
    if rc != 0:
        raise RuntimeError(f"{name}: {rc} at {(P, R, levels, N)}")
    keys = ("registers", "local_bytes", "smem_bytes", "cluster",
            "blocks_per_sm", "clusters")
    return dict(zip(keys, out))


@functools.lru_cache(maxsize=None)
def split_clusters(P: int, R: int, levels: int, N: int) -> int:
    """The clusters of 2 P R CTAs the card keeps resident at this shape
    (:func:`wide_cluster_occupancy` at split 2); raises when it is 0: the
    card cannot place one (a cluster of 16 needs 16 SMs of one GPC at one
    CTA a SM), and no other kernel is run in its place."""
    n = wide_cluster_occupancy(P, R, levels, N, 2)["clusters"]
    if n < 1:
        raise RuntimeError(
            f"the split cluster kernel at P={P}, R={R}, levels={levels}, "
            f"N={N}: no cluster of {2 * P * R} CTAs can be resident on "
            "this card (cudaOccupancyMaxActiveClusters = 0)")
    return n


def _cluster_acc(name: str, acc: torch.Tensor, P: int, base_log: int,
                 levels: int, acc_dtype, split: int = 1):
    """Check the cluster kernel's accumulator and geometry at ``split``
    (at 2, that the card can hold a cluster: :func:`split_clusters`);
    returns (B, R, N)."""
    B, R, N = _wide_acc(name, acc, P, base_log, levels, acc_dtype)
    if not fits_cluster(P, R, levels, N, acc.element_size(), split,
                        base_log):
        raise ValueError(f"{name}: P={P}, R={R}, levels={levels}, N={N} "
                         f"outside the cluster kernel at split {split} "
                         "(fits_cluster)")
    if B * split * P * R >= 2 ** 31:
        raise ValueError(f"{name}: batch {B} outside the kernel grid")
    if split == 2:
        split_clusters(P, R, levels, N)
    return B, R, N


def _cluster_classic(name: str, acc: torch.Tensor, msed_mask: torch.Tensor,
                     bsk_scan: torch.Tensor, base_log: int, levels: int,
                     acc_dtype, split: int = 1) -> torch.Tensor:
    P = bsk_scan.shape[2] if bsk_scan.ndim == 6 else 0
    B, R, N = _cluster_acc(name, acc, P, base_log, levels, acc_dtype, split)
    n = bsk_scan.shape[0]
    _check(bsk_scan, "bsk", torch.int32, 6, acc.device)
    if tuple(bsk_scan.shape[1:]) != (2, P, levels * R, R, N) or n < 1:
        raise ValueError(f"bsk shape {tuple(bsk_scan.shape)} does not match "
                         f"P={P}, R={R}, levels={levels}, N={N}")
    if tuple(msed_mask.shape) != (B, n):
        raise ValueError(f"msed_mask shape {tuple(msed_mask.shape)} != "
                         f"{(B, n)}")
    dev = acc.device
    a32 = msed_mask.to(device=dev, dtype=torch.int32).contiguous()
    plan = ntt_mod.get_plan(N, P)
    tables = _plan_tables_dev(plan, str(dev))
    out = torch.empty_like(acc)
    _launch(name, getattr(_k7c_lib(), name), dev,
            _ptr(acc), _ptr(out), _ptr(a32), _ptr(bsk_scan), _ptr(tables), B,
            n, R, levels, base_log, N.bit_length() - 1, P,
            _garner_host(plan), plan.full_prod_mod64)
    return out


def blind_rotate_wide_cluster(acc: torch.Tensor, msed_mask: torch.Tensor,
                              bsk_scan: torch.Tensor, base_log: int,
                              levels: int) -> torch.Tensor:
    """K7's cluster kernel, K3's function on the u64 accumulator (see
    :func:`blind_rotate_crt_plain`) at a shape of :func:`fits_cluster`: all
    n steps of the batch in one launch, a cluster of P R CTAs a
    ciphertext."""
    if acc.device.type == "cpu":
        return blind_rotate_crt_plain(acc, msed_mask, bsk_scan, base_log,
                                      levels)
    out = _cluster_classic("blind_rotate_wide_cluster", acc, msed_mask,
                           bsk_scan, base_log, levels, torch.int64)
    blind_rotate_wide_cluster.launches += 1
    return out


def blind_rotate_wide_cluster_acc32(acc_hi: torch.Tensor,
                                    msed_mask: torch.Tensor,
                                    bsk_scan: torch.Tensor, base_log: int,
                                    levels: int) -> torch.Tensor:
    """K7's cluster kernel, K3-acc32's function on the u32 hi plane (see
    :func:`blind_rotate_crt_acc32_plain`); one launch a call."""
    if acc_hi.device.type == "cpu":
        return blind_rotate_crt_acc32_plain(acc_hi, msed_mask, bsk_scan,
                                            base_log, levels)
    out = _cluster_classic("blind_rotate_wide_cluster_acc32", acc_hi,
                           msed_mask, bsk_scan, base_log, levels, torch.int32)
    blind_rotate_wide_cluster_acc32.launches += 1
    return out


def multi_bit_accumulate_wide_cluster(acc: torch.Tensor,
                                      bundles: torch.Tensor, base_log: int,
                                      levels: int) -> torch.Tensor:
    """K7's cluster kernel, K5b's function (see
    :func:`multi_bit_accumulate_plain`): the chunk's group steps of the
    batch in one launch."""
    if acc.device.type == "cpu":
        return multi_bit_accumulate_plain(acc, bundles, base_log, levels)
    out = _cluster_multi_bit("multi_bit_accumulate_wide_cluster", acc,
                             bundles, base_log, levels)
    multi_bit_accumulate_wide_cluster.launches += 1
    return out


def _cluster_multi_bit(name: str, acc: torch.Tensor, bundles: torch.Tensor,
                       base_log: int, levels: int,
                       split: int = 1) -> torch.Tensor:
    B, R, N = _cluster_acc(name, acc, MB_PRIMES, base_log, levels,
                           torch.int64, split)
    _check(bundles, "bundles", torch.int32, 6, acc.device)
    count = bundles.shape[1]
    if tuple(bundles.shape) != (B, count, MB_PRIMES, levels * R, R, N) \
            or count < 1:
        raise ValueError(f"bundles shape {tuple(bundles.shape)} != [{B}, "
                         f"count, {MB_PRIMES}, {levels * R}, {R}, {N}]")
    dev = acc.device
    plan = ntt_mod.get_plan(N, MB_PRIMES)
    tables = _plan_tables_dev(plan, str(dev))
    out = torch.empty_like(acc)
    _launch(name, getattr(_k7c_lib(), name), dev,
            _ptr(acc), _ptr(out), _ptr(bundles), _ptr(tables), B, count, R,
            levels, base_log, N.bit_length() - 1, MB_PRIMES,
            _garner_host(plan), plan.full_prod_mod64, _barrett_host(plan))
    return out


def blind_rotate_wide_split(acc: torch.Tensor, msed_mask: torch.Tensor,
                            bsk_scan: torch.Tensor, base_log: int,
                            levels: int) -> torch.Tensor:
    """K7's cluster kernel at split 2, K3's function on the u64
    accumulator (see :func:`blind_rotate_crt_plain`) at a shape of
    ``fits_cluster(..., split=2)``: all n steps of the batch in one launch,
    a cluster of 2 P R CTAs a ciphertext, each holding half of every
    transform, its levels streamed through one transform buffer where
    :func:`split_streams` (the entry chooses the instantiation). Raises
    when the card cannot hold such a cluster (:func:`split_clusters`)."""
    if acc.device.type == "cpu":
        return blind_rotate_crt_plain(acc, msed_mask, bsk_scan, base_log,
                                      levels)
    out = _cluster_classic("blind_rotate_wide_split", acc, msed_mask,
                           bsk_scan, base_log, levels, torch.int64, 2)
    blind_rotate_wide_split.launches += 1
    return out


def blind_rotate_wide_split_acc32(acc_hi: torch.Tensor,
                                  msed_mask: torch.Tensor,
                                  bsk_scan: torch.Tensor, base_log: int,
                                  levels: int) -> torch.Tensor:
    """The cluster kernel at split 2, K3-acc32's function on the u32 hi
    plane (see :func:`blind_rotate_crt_acc32_plain`); one launch a call."""
    if acc_hi.device.type == "cpu":
        return blind_rotate_crt_acc32_plain(acc_hi, msed_mask, bsk_scan,
                                            base_log, levels)
    out = _cluster_classic("blind_rotate_wide_split_acc32", acc_hi,
                           msed_mask, bsk_scan, base_log, levels, torch.int32,
                           2)
    blind_rotate_wide_split_acc32.launches += 1
    return out


def multi_bit_accumulate_wide_split(acc: torch.Tensor, bundles: torch.Tensor,
                                    base_log: int,
                                    levels: int) -> torch.Tensor:
    """The cluster kernel at split 2, K5b's function (see
    :func:`multi_bit_accumulate_plain`): the chunk's group steps of the
    batch in one launch."""
    if acc.device.type == "cpu":
        return multi_bit_accumulate_plain(acc, bundles, base_log, levels)
    out = _cluster_multi_bit("multi_bit_accumulate_wide_split", acc, bundles,
                             base_log, levels, 2)
    multi_bit_accumulate_wide_split.launches += 1
    return out


blind_rotate_wide_cluster.launches = 0
blind_rotate_wide_cluster_acc32.launches = 0
multi_bit_accumulate_wide_cluster.launches = 0
blind_rotate_wide_split.launches = 0
blind_rotate_wide_split_acc32.launches = 0
multi_bit_accumulate_wide_split.launches = 0

#: K7's wrappers by route (:func:`wide_route`): (classic u64, classic
#: acc32, multi-bit)
WIDE_ROUTES = {
    "cluster": (blind_rotate_wide_cluster, blind_rotate_wide_cluster_acc32,
                multi_bit_accumulate_wide_cluster),
    "split": (blind_rotate_wide_split, blind_rotate_wide_split_acc32,
              multi_bit_accumulate_wide_split),
    "global": (blind_rotate_wide, blind_rotate_wide_acc32,
               multi_bit_accumulate_wide)}


#: every kernel wrapper of this module, each with its ``launches`` count
KERNELS = (body_rotate_acc32, body_rotate_acc32_r1, body_rotate_u64,
           blind_rotate_bnf2_acc32, blind_rotate_crt, blind_rotate_crt_acc32,
           blind_rotate_bnf2_u64, blind_rotate_goldilocks,
           multi_bit_keybundle, multi_bit_accumulate,
           blind_rotate_multi_bit_r14, blind_rotate_ntt64, blind_rotate_wide,
           blind_rotate_wide_acc32, multi_bit_accumulate_wide,
           blind_rotate_wide_cluster, blind_rotate_wide_cluster_acc32,
           multi_bit_accumulate_wide_cluster, blind_rotate_wide_split,
           blind_rotate_wide_split_acc32, multi_bit_accumulate_wide_split)
