"""The CPU mirror of the int8 wgmma design (``tfhe_tpu_torch/tools/
_wgmma.py``, mirroring ``csrc/wgmma_int8.cuh``, ``mxu_probe.cu`` and
``ntt_mxu.cu``): the 128-byte swizzle of a K-major tile, the descriptor
fields, the m64nN s32 fragment map, the cluster split (which CTA holds
which column blocks, and what crosses distributed shared memory), and the
products computed through the mirror's addresses, per-CTA slices and
exchanges against the plain versions, exactly: ``mxu_probe.probe_plain``
at clusters of 2 and 4 (the kernel's 2, and 4 for MIX2), and
``ntt_mxu.mxu_plain`` at the kernel's cluster of 2 (4 would split a pair
of column blocks), each over two trips. The plain versions are held
against the JAX bodies in ``test_torch_probes_mxu.py`` and
``test_torch_probes_mxu_ntt.py``."""

import functools

import numpy as np
import pytest
import torch

from tfhe_tpu_torch._torus import from_u32
from tfhe_tpu_torch.tools import _harness as h
from tfhe_tpu_torch.tools import _wgmma as wgm
from tfhe_tpu_torch.tools import mxu_probe as mp
from tfhe_tpu_torch.tools import ntt_mxu as nm

TRIPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The mirror runs many tiny gathers and products: one intra-op thread
    each (several test workers share the cores), restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
NTT_CASES = [("v3_fwd", 1), ("v3_inv", 1), ("mm4", 1), ("mm1", 1),
             ("mm1", 2), ("mm1", 4), ("v4_fold", 1), ("v4_inv_mmr", 1),
             ("v4_fwd", 1), ("v4_fwd_nosplit", 1), ("v4_inv", 1)]


@pytest.mark.parametrize("rows,K", [(64, 128), (64, 512), (128, 384),
                                    (256, 384), (256, 512)])
def test_swizzle_is_a_bijection_on_each_tile(rows, K):
    """kmajor maps the rows x K bytes of a tile onto [0, rows K) once;
    the swizzle keeps each 16-byte chunk whole and each 8-row group (1024
    bytes) in place, and permutes the chunks of a row by row & 7."""
    r = torch.arange(rows).unsqueeze(1)
    k = torch.arange(K).unsqueeze(0)
    off = wgm.kmajor(r, k, rows).reshape(-1)
    assert torch.equal(off.sort().values, torch.arange(rows * K))
    linear = (k >> 7) * rows * 128 + r * 128 + (k & 127)
    assert torch.equal(off // 1024, linear.reshape(-1) // 1024)
    assert torch.equal(off % 16, (k % 16).expand(rows, K).reshape(-1))
    chunk = (wgm.kmajor(r, k, rows) % 128) // 16
    assert torch.equal(chunk, ((k & 127) >> 4) ^ (r & 7))
    o = torch.arange(1 << 14)
    assert torch.equal(wgm.swz(wgm.swz(o)), o)


def test_descriptor_fields():
    """Start address >> 4, the leading byte offset 16 (unused), the stride
    between 8-row groups 1024, base offset 0, the 128-byte swizzle; a
    k-step's descriptor starts 32 bytes on."""
    for addr in (0, 1024, 8192 + 64, 65536 + 96, 0x3FFF0):
        d = wgm.descriptor(addr)
        assert wgm.fields(d) == {"start": addr, "lbo": 16, "sbo": 1024,
                                 "base_offset": 0, "swizzle": 1}
        assert d & 0x3FFF == addr >> 4
        assert (d >> 32) & 0x3FFF == 64 and d >> 62 == 1
    assert wgm.descriptor(4096 + 32) - wgm.descriptor(4096) == 2


@pytest.mark.parametrize("rows", [64, 128, 256])
def test_read_through_descriptors_gives_the_matrix(rows):
    """Every k-step's operand read through its descriptor (K-block kb at
    kb rows 128, + 32 k) is the matrix's [rows, 32] slice."""
    K = 512
    M = torch.from_numpy(np.random.default_rng(rows).integers(
        -128, 128, (rows, K)))
    img = wgm.image(M)
    for kb in range(K // 128):
        for k in range(4):
            got = wgm.read(img, wgm.descriptor(kb * rows * 128 + 32 * k),
                           rows)
            assert torch.equal(got, M[:, 128 * kb + 32 * k:][:, :32])


@pytest.mark.parametrize("n", [64, 128, 256])
def test_fragment_map_covers_the_tile_once(n):
    """The m64nN s32 accumulator: every (row, column) of 64 x n once over
    128 threads x n / 2 registers; warp w holds rows 16 w .. 16 w + 15;
    registers i and i + n / 4 of a thread are columns c and c + n / 2 of
    one row (the pair fold of a CTA's two column blocks at n = 256)."""
    row, col = wgm.acc_layout(n)
    flat = (row * n + col).reshape(-1)
    assert torch.equal(flat.sort().values, torch.arange(64 * n))
    warp = torch.arange(128).unsqueeze(1) // 32
    assert bool(((row // 16) == warp).all())
    assert torch.equal(row[:, :n // 4], row[:, n // 4:])
    assert torch.equal(col[:, :n // 4] + n // 2, col[:, n // 4:])
    D = torch.arange(64 * n).reshape(64, n)
    assert torch.equal(wgm.fragments(D), row * n + col)


@pytest.mark.parametrize("cluster", [2, 4])
def test_cluster_split(cluster):
    """Rank r holds column blocks r * 4 / C ..; its slice of the cluster
    image is the K-major image of those columns of the table."""
    assert sum((wgm.owned_blocks(r, cluster) for r in range(cluster)),
               []) == [0, 1, 2, 3]
    w512, _ = mp.weights()
    img = wgm.cluster_image(w512, cluster)
    per = 512 // cluster
    assert img.numel() == 512 * 512
    for r in range(cluster):
        want = wgm.image(torch.from_numpy(
            w512[:, r * per:(r + 1) * per].T.astype(np.int64)))
        assert torch.equal(img[r * 512 * per:(r + 1) * 512 * per], want)


def test_what_crosses():
    """mxu_probe at a cluster of 4: every CTA's L goes to the other three,
    and only rows 0..15 of column blocks 0 and 1 of another tile's U
    (ranks 0 and 1) go to that tile's CTA; at 2 (the kernel's but for
    MIX2) rank 0 sends both blocks. ntt_mxu (cluster of 2): A rows to the
    other CTA, and one folded term a polynomial the other CTA owns; no
    unfolded U."""
    x = _tiles(4)
    _, log = wgm.mxu_trip(h.u32(x), "matmul_512x512", 4)
    assert sorted({(a, b) for a, b, w in log if w == "L"}) == [
        (a, b) for a in range(4) for b in range(4) if a != b]
    us = sorted((a, b, w) for a, b, w in log if w != "L")
    assert us == sorted((r, t, f"U512[:16] block {r}") for r in (0, 1)
                        for t in range(4) if t != r)
    # at the kernel's cluster of 2, rank 0 holds both blocks the fold reads
    assert wgm.mxu_cluster("matmul_512x512") == 2
    _, log = wgm.mxu_trip(h.u32(x), "matmul_512x512")
    assert sorted(log) == sorted(
        [(0, 1, "L"), (1, 0, "L")] * 2
        + [(0, 1, "U512[:16] block 0"), (0, 1, "U512[:16] block 1")] * 2)
    y = _polys(4)
    _, log = wgm.ntt_trip(h.u32(y), "v3_fwd")
    assert sorted(log) == [(0, 1, "A"), (0, 1, "term"), (0, 1, "term"),
                           (1, 0, "A"), (1, 0, "term"), (1, 0, "term")]


@functools.lru_cache(maxsize=None)
def _tiles(n):
    return from_u32(np.random.default_rng(11).integers(
        0, mp.P0, (n, mp.ROWS, mp.N), np.uint32), "cpu")


@functools.lru_cache(maxsize=None)
def _polys(n):
    return from_u32(np.random.default_rng(12).integers(
        0, nm.PRIME, (n, nm.N), np.uint32), "cpu")


@pytest.mark.parametrize("cluster", [4, 2])
@pytest.mark.parametrize("op", list(mp.CLUSTER))
def test_mxu_trip_equals_probe_plain(op, cluster):
    x = _tiles(4)
    y = h.u32(x)
    for _ in range(TRIPS):
        y, _ = wgm.mxu_trip(y, op, cluster)
    assert torch.equal(y, h.u32(mp.probe_plain(x, TRIPS, op)))


@pytest.mark.parametrize("op,copies", NTT_CASES)
def test_ntt_trip_equals_plain(op, copies):
    x = _polys(4)
    y = h.u32(x)
    for _ in range(TRIPS):
        y, _ = wgm.ntt_trip(y, op, copies)
    assert torch.equal(y, h.u32(nm.mxu_plain(x, TRIPS, op, copies)))
