"""The CPU mirror of the int8 ``wgmma`` design of the tensor-core probes
(``csrc/wgmma_int8.cuh``, ``csrc/mxu_probe.cu``, ``csrc/ntt_mxu.cu``): the
kernels' address, descriptor and fragment formulas, and their cluster
split, vectorised, so that a wrong bit shows on the CPU.

- :func:`swz`, :func:`kmajor`: the 128-byte swizzle of a K-major tile
  (K-blocks of ``rows`` x 128 bytes on a 1024-byte aligned base), which
  the threads write A in and the wrappers lay each table slice out in
  (:func:`image`, :func:`cluster_image`).
- :func:`descriptor`, :func:`fields`, :func:`read`: a shared-memory matrix
  descriptor and the [rows, 32] int8 operand of one k-step that the
  hardware reads through it (start + 8-row group * SBO + row * 128 + byte,
  then the swizzle of that address).
- :func:`acc_layout`: the m64nN s32 accumulator fragment map (thread,
  register) -> (row, column).
- :func:`owned_blocks`, :func:`mxu_trip`, :func:`ntt_trip`: which CTA of a
  cluster holds which column blocks, and one trip of each kernel computed
  through those addresses, per-CTA slices, fragments and exchanges, with a
  log of what crosses distributed shared memory. The tests hold these to
  ``mxu_probe.probe_plain`` and ``ntt_mxu.mxu_plain`` exactly.

Cluster sizes: ``mxu_probe_kernel`` runs 2 CTAs (a pair of column blocks
each), but 4 (one block each) for MIX2, whose two slices would not fit
beside the cluster's L at 2 (:func:`mxu_cluster`; both sizes are
mirrored for every case); ``ntt_mxu_kernel`` runs 2 (a pair of column
blocks each, so that only folded values cross: 4 would split a pair).
"""

from __future__ import annotations

import torch

from . import _int8 as q

#: bytes between two 8-row groups of a K-major tile (its stride byte offset)
SBO = 1024
#: the leading byte offset field (unused by a swizzled K-major operand)
LBO = 16
#: the descriptor's swizzle mode: 128 bytes
SWIZZLE_128B = 1
#: bytes of K one k-step (``m64nNk32`` s8) reads
K_STEP = 32
#: column blocks of the tables ([K, 512]: 4 of 128)
BLOCKS = 4


def swz(o):
    """The 128-byte swizzle of byte offset ``o`` (int or int tensor) from a
    1024-byte aligned base: bits 4-6 ^= bits 7-9."""
    return o ^ ((o >> 3) & 0x70)


def kmajor(row, k, rows: int):
    """Byte (row, k) of a K-major tile of ``rows`` rows: K-block k >> 7 at
    (k >> 7) * rows * 128, the row's 128 bytes swizzled within it."""
    return (k >> 7) * rows * 128 + swz(row * 128 + (k & 127))


def image(mat: torch.Tensor) -> torch.Tensor:
    """The shared-memory bytes (int8, flat) of an int8-valued [rows, K]
    matrix laid out by :func:`kmajor`."""
    rows, K = mat.shape
    r = torch.arange(rows).unsqueeze(1)
    k = torch.arange(K).unsqueeze(0)
    out = torch.zeros(rows * K, dtype=torch.int8)
    out[kmajor(r, k, rows).reshape(-1)] = mat.to(torch.int8).reshape(-1)
    return out


def owned_blocks(rank: int, cluster: int) -> list:
    """The column blocks (of 128 columns) CTA ``rank`` of a cluster of
    ``cluster`` holds."""
    per = BLOCKS // cluster
    return list(range(rank * per, (rank + 1) * per))


def cluster_image(table, cluster: int) -> torch.Tensor:
    """A [K, 512] int8 table (numpy or tensor) as the kernels' cluster
    image: per rank, the K-major image of its columns (W^T[cols][K]),
    concatenated: int8 [cluster * K * 512 / cluster]."""
    t = torch.as_tensor(table).to(torch.int64)
    per = 512 // cluster
    return torch.cat([image(t[:, r * per:(r + 1) * per].T)
                      for r in range(cluster)])


def descriptor(addr: int) -> int:
    """The 64-bit descriptor of a K-major, 128-byte swizzled operand at
    shared-memory address ``addr`` (``wg::desc``)."""
    return (((addr & 0x3FFFF) >> 4) | ((LBO >> 4) << 16)
            | ((SBO >> 4) << 32) | (SWIZZLE_128B << 62))


def fields(desc: int) -> dict:
    """A descriptor's fields, in bytes where they are addresses."""
    return {"start": (desc & 0x3FFF) << 4,
            "lbo": ((desc >> 16) & 0x3FFF) << 4,
            "sbo": ((desc >> 32) & 0x3FFF) << 4,
            "base_offset": (desc >> 49) & 7, "swizzle": desc >> 62}


def read(smem: torch.Tensor, desc: int, rows: int) -> torch.Tensor:
    """The [rows, 32] operand of one k-step read through ``desc`` from
    ``smem`` (int8, its base 1024-byte aligned), as int64."""
    f = fields(desc)
    assert f["swizzle"] == SWIZZLE_128B and f["base_offset"] == 0
    r = torch.arange(rows).unsqueeze(1)
    kk = torch.arange(K_STEP).unsqueeze(0)
    linear = f["start"] + (r // 8) * f["sbo"] + (r % 8) * 128 + kk
    return smem[swz(linear)].to(torch.int64)


def acc_layout(n: int) -> tuple:
    """(row, column) [128 threads, n / 2 registers] of the m64nN s32
    accumulator (``wg::acc_row``, ``wg::acc_col``)."""
    t = torch.arange(128).unsqueeze(1)
    i = torch.arange(n // 2).unsqueeze(0)
    row = 16 * (t // 32) + (t % 32) // 4 + 8 * ((i >> 1) & 1)
    col = 8 * (i >> 2) + 2 * (t & 3) + (i & 1)
    return row, col


def fragments(D: torch.Tensor) -> torch.Tensor:
    """A [64, n] accumulator as the warpgroup holds it: [128, n / 2]."""
    row, col = acc_layout(D.shape[1])
    return D[row, col]


def s32(v: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to s32, as the accumulator wraps."""
    return ((v + (1 << 31)) & q.M32) - (1 << 31)


def product(smem_a: torch.Tensor, a0: int, a_blocks, smem_b: torch.Tensor,
            b0: int, n: int, K: int, b_rows: int = None) -> torch.Tensor:
    """One m64 row tile's K / 32 ``wgmma.m64nNk32`` of a kernel: A's k-step
    k of K-block kb at a0 + a_blocks(kb) + 32 k, B's at b0 + kb * b_rows *
    128 + 32 k (B a slice of ``b_rows`` rows, default n); the fragments of
    D (s32) [128, n / 2]."""
    D = torch.zeros(64, n, dtype=torch.int64)
    stride = (b_rows or n) * 128
    for kb in range(K // 128):
        for k in range(4):
            A = read(smem_a, descriptor(a0 + a_blocks(kb) + K_STEP * k), 64)
            B = read(smem_b, descriptor(b0 + kb * stride + K_STEP * k), n)
            D = D + A @ B.T
    return fragments(s32(D))


# ---------------------------------------------------------------------------
# mxu_probe_kernel
# ---------------------------------------------------------------------------

L_BYTES = 128 * 128  # a tile's L: one K-block of 128 rows


def mxu_cluster(op: str) -> int:
    """``cluster_of`` of mxu_probe.cu: 2 CTAs (a pair of column blocks
    each), but 4 (one block each) for MIX2, whose two slices would not fit
    beside the cluster's L at 2."""
    return 4 if op == "mix_2matmul_shoupx16" else 2


def mxu_trip(x: torch.Tensor, op: str, cluster: int = None) -> tuple:
    """One trip of ``mxu_probe_kernel`` on tiles x (int64 u32 [tiles, 8,
    2048], tiles a multiple of the cluster, default the kernel's): (x
    after the trip, the log of what crossed, [(from rank, to rank,
    what)]). Each CTA multiplies the cluster's L by its slice in m64n128
    units: a row tile times one 128-column block of the slice."""
    from . import mxu_probe as mp

    cluster = cluster or mxu_cluster(op)
    w512, w384 = mp.weights()
    # (name, table, copies of L along k, rows) of each product
    prods = [(str(k), w512 if k == 512 else w384, k // 128, rows)
             for k, rows in mp._PRODUCTS[op]]
    nc = 512 // cluster  # columns a CTA
    images = {name: cluster_image(w, cluster) for name, w, _, _ in prods}
    row, col = acc_layout(128)
    out, log = [], []
    for g in range(0, x.shape[0], cluster):
        tiles = x[g:g + cluster]
        # each CTA writes its tile's L into slot `rank` of every CTA
        L = torch.cat([image(q.i8(t).reshape(128, 128)) for t in tiles])
        log += [(r, d, "L") for r in range(cluster) for d in range(cluster)
                if r != d]
        recv = {}  # (tile, product, block) -> [16, 128]
        for rank in range(cluster):
            for name, _, copies, rows in prods:
                K = 128 * copies
                slice_ = images[name][rank * K * nc:(rank + 1) * K * nc]
                for t in range(cluster):
                    for h in range(rows // 64):
                        for half, blk in enumerate(owned_blocks(rank,
                                                                cluster)):
                            fr = product(L, t * L_BYTES + (h & 1) * 64 * 128,
                                         lambda kb: 0, slice_,
                                         half * 128 * 128, 128, K, nc)
                            if h or blk > 1:
                                continue
                            # the warpgroup's first warp: rows 0..15
                            u = torch.zeros(16, 128, dtype=torch.int64)
                            u[row[:32], col[:32]] = fr[:32]
                            recv[t, name, blk] = u
                            if rank != t:
                                log.append((rank, t, f"U{name}[:16] block "
                                            f"{blk}"))
        for t in range(cluster):
            y = tiles[t]
            if op.startswith("mix"):
                y = mp.shoup_chain(y, 8 if "x8" in op else 16)
            for name, _, _, _ in prods:
                V = q.wrap(recv[t, name, 0] + (recv[t, name, 1] << 8))
                y = y ^ q.wrap(V.reshape(1, -1) * 3)
            out.append(y)
    return torch.stack(out), log


# ---------------------------------------------------------------------------
# ntt_mxu_kernel
# ---------------------------------------------------------------------------

NTT_CLUSTER = 2  # CTAs a cluster: a pair of column blocks each
NTT_POLYS = 2    # polynomials a CTA


def limbs_of(op: str) -> int:
    return {"v4_fold": 1, "v4_fwd_nosplit": 1, "v4_fwd": 3}.get(op, 4)


def _split(y: torch.Tensor, op: str) -> torch.Tensor:
    """The int8 limbs the kernel writes as A's K-blocks: [..., 128 * NL]."""
    from . import ntt_mxu as nm

    if op in ("v4_fold", "v4_fwd_nosplit"):
        return q.i8(y)
    if op == "v4_fwd":
        u = (y & 0x3FFFFF) - (1 << 21) + (1 << 22)
        return torch.cat(q.offset_limbs(u, 3), dim=-1)
    c = q.condsub(y, nm.PRIME)
    if op == "mm4":
        return torch.cat(q.split4_balanced(c), dim=-1)
    return torch.cat(q.offset_limbs(c, 4), dim=-1)


def _picked(copies: int, copy: int, j: int) -> bool:
    """MM1's (copy, column block) terms (``picked`` of ntt_mxu.cu)."""
    if copies == 2:
        return (copy, j) in ((0, 0), (0, 1), (1, 0), (1, 3))
    if copies == 4:
        return (copy, j) in ((0, 0), (1, 0), (2, 1), (3, 3))
    return True


def _term(op: str, lo, hi, rank: int, r, c, t4):
    """CTA ``rank``'s term of elements (r, c) (``term`` of ntt_mxu.cu)."""
    from . import ntt_mxu as nm

    v = q.wrap(lo + (hi << 8) + q.BIAS31)
    if op == "v4_fold":
        return v
    if op in ("v4_fwd", "v4_fwd_nosplit"):
        tw = nm._u32_const(t4.tw[0], v.device)
        return q.shoup(v, tw[2 * rank][r, c], tw[2 * rank + 1][r, c],
                       nm.PRIME)
    t3 = nm.v3()
    if rank == 1:
        return q.shoup(v, int(t3.c16[0]), int(t3.c16_sh[0]), nm.PRIME)
    if op == "v4_inv":
        return q.condsub_wide(q.wrap(
            v - q.mul_hi_approx(v, int(t3.one_sh[0])) * nm.PRIME), nm.P2)
    return q.wrap(v - q.mul_hi(v, int(t3.one_sh[0])) * nm.PRIME)


def _combine(op: str, t0, t1, r, c, t4):
    """The owner's output from the two terms (``combine``)."""
    from . import ntt_mxu as nm

    if op in ("mm4", "mm1"):
        return q.wrap(t0 + t1)
    if op == "v4_fold":
        return t0 ^ t1
    s = q.condsub(q.wrap(t0 + t1), nm.P2)
    if op in ("v4_fwd", "v4_fwd_nosplit"):
        tw4 = nm._u32_const(t4.tw[0], s.device)[4]
        return q.condsub(s + tw4[r, c], nm.P2)
    t3 = nm.v3()
    if op in ("v3_fwd", "v3_inv"):
        bias = nm._u32_const((t3.fwd_bias_row if op == "v3_fwd"
                              else t3.inv_bias_row)[0], s.device)
        s = q.condsub(s + bias[c], nm.P2)
        return q.condsub(s, nm.PRIME) if op == "v3_inv" else s
    bias = nm._u32_const(t4.inv_bias[0], s.device)
    s = q.condsub(s + bias[c], nm.P2)
    return q.condsub(s, nm.PRIME)


def _table(op: str):
    from . import ntt_mxu as nm

    t3, t4 = nm.v3(), nm.v4()
    return {"v3_fwd": t3.fwd_w8m, "v3_inv": t3.inv_w8m, "mm4": t3.fwd_w8m,
            "mm1": t3.fwd_w8m, "v4_fold": t4.fwd_w8, "v4_inv_mmr": t4.inv_w8,
            "v4_fwd": t4.fwd_w8, "v4_fwd_nosplit": t4.fwd_w8,
            "v4_inv": t4.inv_w8}[op][0]


def ntt_trip(x: torch.Tensor, op: str, copies: int = 1) -> tuple:
    """One trip of ``ntt_mxu_kernel<op, copies>`` on polynomials x (int64
    u32 [polys, 2048], polys a multiple of 4): (x after the trip, the log
    of what crossed)."""
    from . import ntt_mxu as nm

    polys, n = x.shape
    t4 = nm.v4()
    y = x.reshape(polys, 16, 128)
    if op == "v3_fwd":
        y = nm._stages(nm._twist(x, "twist"), False).reshape(polys, 16, 128)
    elif op == "v4_inv":
        y = nm._group_stages(y, t4, inverse=True)
        tw = nm._u32_const(t4.tw_inv[0], y.device)
        y = q.condsub(q.shoup(y, tw[0], tw[1], nm.PRIME), nm.PRIME)
    NL, K = limbs_of(op), nm.K[op]
    img = cluster_image(_table(op), NTT_CLUSTER)
    row, col = acc_layout(256)
    out, log = [], []
    per = NTT_CLUSTER * NTT_POLYS
    for g in range(0, polys, per):
        grp = y[g:g + per]  # slot s = 2 rank + p: rows 16 s + r
        A = image(_split(grp, op).reshape(64, 128 * NL))
        log += [(r, r ^ 1, "A") for r in range(NTT_CLUSTER)]
        terms = {}
        for rank in range(NTT_CLUSTER):
            slice_ = img[rank * K * 256:(rank + 1) * K * 256]
            part = 0
            for copy in range(copies):
                fr = product(A, 0, (lambda kb: 0) if NL == 1
                             else (lambda kb: kb * 64 * 128), slice_, 0, 256,
                             K)
                lo, hi = fr[:, :64], fr[:, 64:]
                if op in ("mm4", "mm1"):
                    part = (part + lo * _picked(copies, copy, 2 * rank)
                            + hi * _picked(copies, copy, 2 * rank + 1))
            r, c = row[:, :64] % 16, col[:, :64]
            slot = row[:, :64] // 16
            if op in ("mm4", "mm1"):
                t = q.wrap(part)
            else:
                t = _term(op, lo, hi, rank, r, c, t4)
            T = torch.zeros(per, 16, 128, dtype=torch.int64)
            T[slot, r, c] = t
            terms[rank] = T
            log += [(rank, s // NTT_POLYS, "term") for s in range(per)
                    if s // NTT_POLYS != rank]
        t0, t1 = terms[0], terms[1]
        if op in ("mm4", "mm1"):
            t0 = t0 + grp  # the owner adds x to its own term
        rr = torch.arange(16).reshape(16, 1)
        cc = torch.arange(128).reshape(1, 128)
        out.append(_combine(op, t0, t1, rr, cc, t4))
    y = torch.cat(out)
    if op == "v3_inv":
        z = nm._stages(y.reshape(polys, n), True)
        y = nm._twist(z, "untwist")
    elif op in ("v4_fwd", "v4_fwd_nosplit"):
        y = nm._group_stages(y, t4, inverse=False)
    return y.reshape(polys, n), log
