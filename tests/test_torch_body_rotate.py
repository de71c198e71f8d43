"""K2 acc32's table design (``csrc/body_rotate.cu``) on the CPU: the plain
mirror of the kernel's indexing, ``pbs_kernel.body_rotate_acc32_table``,
against the plain version ``body_rotate_acc32_plain`` and against
``tfhe_tpu``'s ``_build_body_rot_fn_v4(acc32=True)`` in Pallas interpret
mode, on shared ([R, N]) and per-ciphertext ([B, R, N]) LUTs, at the edge
bodies (0, 1, N - 1, N, N + 1, 2N - 1) and random ones, with LUT words at
the fold's half-way points. The kernels themselves run on the GPU
(``chip_smoke.py`` phase 2).

Tolerance: exact (integer arithmetic)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfhe_tpu.ops import pbs_kernel as jpk

from tfhe_tpu_torch._torus import from_u64, i64_to_u32, srl, to_u32
from tfhe_tpu_torch.ops import pbs_kernel as pk

#: u64 LUT words at the fold's half-way points: low word exactly 2^31, and
#: 2^63; there fold(-v) != -fold(v)
HALFWAY = np.array([1 << 31, (5 << 32) + (1 << 31), 1 << 63,
                    (1 << 63) + (1 << 31), (1 << 64) - (1 << 31)],
                   dtype=np.uint64)


def _inputs(seed: int, B: int, R: int, N: int, shared: bool):
    """A LUT (shared [R, N] or [B, R, N]) with the half-way words and 0 at
    its start, and B bodies: the edge values first, then random ones."""
    rng = np.random.default_rng(seed)
    lut = rng.integers(0, 1 << 64, size=(R, N) if shared else (B, R, N),
                       dtype=np.uint64)
    flat = lut.reshape(-1)
    flat[:len(HALFWAY) + 1] = np.concatenate([[0], HALFWAY])
    flat[-len(HALFWAY):] = HALFWAY  # also at the row's wrap point
    body = rng.integers(0, 2 * N, size=B)
    edge = [0, 1, N - 1, N, N + 1, 2 * N - 1]
    body[:min(B, len(edge))] = edge[:B]
    return lut, body


def _pallas_acc32(lut: np.ndarray, body: np.ndarray) -> np.ndarray:
    """``_build_body_rot_fn_v4(acc32=True)`` in interpret mode on the
    transposed [R, G, B, 128] layout, back to u32 [B, R, N]."""
    B, R, n = lut.shape
    G = n // 128
    acc = jpk.to_transposed_layout(jnp.moveaxis(jnp.asarray(lut), 1, 0), G)
    hi, lo = jpk.split_u64(jnp.moveaxis(acc, 2, 1))
    a_rot = ((2 * n - jnp.asarray(body)) % (2 * n)).astype(jnp.uint32)
    out = jpk._build_body_rot_fn_v4(n, R, 2, acc32=True)(
        a_rot[None, :, None], hi, lo)
    return np.asarray(jnp.moveaxis(
        jpk.from_transposed_layout(jnp.moveaxis(out, 1, 2)), 0, 1))


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_ct"])
@pytest.mark.parametrize("R", [2, 5])
def test_table_matches_pallas_interpret(R, shared):
    """table mirror == plain == the Pallas kernel, N = 256, 8 bodies."""
    B, N = 8, 256
    lut, body = _inputs(R, B, R, N, shared)
    lut_t, body_t = from_u64(lut, "cpu"), torch.from_numpy(body)
    got = pk.body_rotate_acc32_table(lut_t, body_t)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, R, N)
    plain = pk.body_rotate_acc32_plain(lut_t, body_t)
    assert torch.equal(got, plain)
    want = _pallas_acc32(np.broadcast_to(lut, (B, R, N)).copy(), body)
    np.testing.assert_array_equal(to_u32(got), want)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_ct"])
@pytest.mark.parametrize("R", [2, 5])
def test_table_matches_plain_n2048(R, shared):
    """table mirror == plain at the 2_2 width N = 2048."""
    B, N = 10, 2048
    lut, body = _inputs(100 + R, B, R, N, shared)
    lut_t, body_t = from_u64(lut, "cpu"), torch.from_numpy(body)
    assert torch.equal(pk.body_rotate_acc32_table(lut_t, body_t),
                       pk.body_rotate_acc32_plain(lut_t, body_t))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_ct"])
def test_table_matches_plain_random_bodies(seed, shared):
    """Random bodies (int32 and int64) over every residue class mod 4, the
    kernel's 16-byte window alignment."""
    B, R, N = 64, 2, 256
    rng = np.random.default_rng(seed)
    lut = rng.integers(0, 1 << 64, size=(R, N) if shared else (B, R, N),
                       dtype=np.uint64)
    body = rng.integers(0, 2 * N, size=B)
    body[:4] = body[:4] // 4 * 4 + np.arange(4)
    lut_t = from_u64(lut, "cpu")
    want = pk.body_rotate_acc32_plain(lut_t, torch.from_numpy(body))
    for dtype in (torch.int64, torch.int32):
        body_t = torch.from_numpy(body).to(dtype)
        assert torch.equal(pk.body_rotate_acc32_table(lut_t, body_t), want)


def test_halfway_words_need_the_negation_before_the_fold():
    """At the half-way words fold(-v) != -fold(v), so a table whose second
    half negates the folded first half (-T) is wrong there, and only
    there; the table of fold(-lut) is right."""
    v = from_u64(HALFWAY, "cpu")
    fold = lambda x: i64_to_u32(srl(x + (1 << 31), 32))
    assert not torch.equal(fold(-v), -fold(v))
    B, R, N = 6, 2, 256
    lut, body = _inputs(7, B, R, N, True)
    lut_t, body_t = from_u64(lut, "cpu"), torch.from_numpy(body)
    want = pk.body_rotate_acc32_plain(lut_t, body_t)
    folded = fold(lut_t)
    wrong = torch.cat([folded, -folded], dim=-1)  # -T, not fold(-lut)
    d = torch.remainder(2 * N - body_t, 2 * N)
    idx = torch.remainder(torch.arange(N)[None, :] - d[:, None], 2 * N)
    got = torch.gather(wrong.expand(B, R, 2 * N), 2,
                       idx[:, None, :].expand(B, R, N))
    bad = got != want
    assert bad.any()
    src = torch.remainder(idx, N)[:, None, :].expand(B, R, N)
    neg = (idx >= N)[:, None, :].expand(B, R, N)
    src_word = torch.gather(lut_t.expand(B, R, N), 2, src)
    halfway = (src_word & 0xFFFFFFFF) == (1 << 31)
    assert torch.equal(bad, halfway & neg)
    assert torch.equal(pk.body_rotate_acc32_table(lut_t, body_t), want)


def test_cpu_tensors_launch_nothing():
    """CPU tensors take the plain version in both acc32 wrappers (the
    table design and its first design, r1), and no launch is counted."""
    B, R, N = 8, 2, 256
    pk.reset_launches()
    for shared in (True, False):
        lut, body = _inputs(3, B, R, N, shared)
        lut_t, body_t = from_u64(lut, "cpu"), torch.from_numpy(body)
        want = pk.body_rotate_acc32_plain(lut_t, body_t)
        assert torch.equal(pk.body_rotate_acc32(lut_t, body_t), want)
        assert torch.equal(pk.body_rotate_acc32_r1(lut_t, body_t), want)
    assert pk.body_rotate_acc32.launches == 0
    assert pk.body_rotate_acc32_r1.launches == 0
    assert not any(fn.launches for fn in pk.KERNELS)
    assert pk.body_rotate_acc32_r1 in pk.KERNELS


@pytest.mark.parametrize("entry", ["body_rotate_acc32",
                                   "body_rotate_acc32_r1"])
def test_launch_path_refuses_cpu_tensors(entry):
    """The launch path takes CUDA tensors only: it raises before it loads
    the library, so no CPU tensor reaches a kernel."""
    lut = torch.zeros((2, 256), dtype=torch.int64)
    with pytest.raises(ValueError, match="unsupported device"):
        pk._body_rotate(entry, torch.int32, torch.int64, lut,
                        torch.zeros(4, dtype=torch.int64))
