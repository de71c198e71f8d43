"""The int8 small-DFT tables of the tensor-core transforms (numpy only).

The port's own copy of the MXU part of ``tfhe_tpu``'s kernel tables, built
from this package's NTT plan (``ops/ntt.py``), array for array equal to
them (``tests/test_torch_probes_mxu_ntt.py``):

- :class:`V3Tables` (the v3 transform, ``_KernelTables``' MXU part): the
  composite of the seven stages of stride h < 128 as a 128 x 128 matrix
  mod p, stored as int8 limbs, so that those stages are one int8 product
  ``[rows, 512] @ [512, 512]`` (``fwd_w8m`` / ``inv_w8m``, the four output
  limbs side by side) on offset-split data limbs, recombined by a pair
  fold and two reductions, the offsets and the +2^31 biases folded into
  one bias row;
- :class:`V4Tables` (the v4 four-step transform, ``_KernelTablesV4``): the
  lane DFT ``[rows, nl_in*128] @ [nl_in*128, 512]`` straight on the split
  gadget digits, the twiddle tables of the recombination and the group
  stages, and the inverse's ``[512, 512]`` matrix.

The table-build assertions stay: every limb split leaves no residue, and
the pair fold ``U_0 + 256 U_1`` (and ``U_2 + 256 U_3``) stays inside int32
for every input (the exact per-column absolute row sums).
"""

from __future__ import annotations

import functools

import numpy as np

from . import ntt as ntt_mod

#: the bias the pair fold's two int32 values carry to become u32 (V + 2^31,
#: V1 scaled by 2^16), taken back out by the bias row
_PAIR_BIAS = -(1 << 31) * (1 + (1 << 16))


def _shoup(tbl: np.ndarray, p: int) -> np.ndarray:
    """floor(w 2^32 / p) of every w < p of ``tbl`` (int64: w < 2^30)."""
    return (np.asarray(tbl, dtype=np.int64) << 32) // p


def _balanced_limbs(v: np.ndarray, limbs: int = 4) -> list:
    """Balanced base-256 limbs (int8 values) of int64 values |v| < 2^31;
    asserts that they leave no residue."""
    out = []
    for _ in range(limbs):
        d = v & 255
        d = np.where(d > 127, d - 256, d)
        out.append(d.astype(np.int8))
        v = (v - d) >> 8
    assert np.all(v == 0), "limb split residue"
    return out


def _balanced(w: np.ndarray, p: int) -> np.ndarray:
    """The representative of w (mod p) in (-p/2, p/2]."""
    return np.where(w > p // 2, w - p, w)


def _assert_pair_fold(src: np.ndarray):
    """|U_0 + 256 U_1| and |U_2 + 256 U_3| < 2^31 - 1 for data limbs of
    magnitude <= 128: the per-column absolute row sums of each limb."""
    bnd = [int((np.abs(src[j].astype(np.int64)).sum(axis=0) * 128).max())
           for j in range(4)]
    assert bnd[0] + 256 * bnd[1] < 2**31 - 1, bnd
    assert bnd[2] + 256 * bnd[3] < 2**31 - 1, bnd


def _bias_row(colsum, off: int, p: int) -> np.ndarray:
    """Per lane k: (-2^31 (1 + 2^16) + off * colsum[k]) mod p."""
    return np.array([(_PAIR_BIAS + off * int(c)) % p for c in colsum],
                     dtype=np.uint32)


class V3Tables:
    """The v3 small-DFT tables of one plan (``_KernelTables``' MXU part):
    ``fwd_w8`` / ``inv_w8`` [P, 4, 512, 128] int8 (limb j of the stacked
    rows [2^{8i} M mod p]), ``fwd_w8m`` / ``inv_w8m`` [P, 512, 512] (the
    four limbs side by side), ``fwd_bias_row`` / ``inv_bias_row`` [P, 128]
    u32, and per prime ``c32``, ``c32_sh``, ``one_sh``, ``recomb_bias``,
    ``c16``, ``c16_sh``."""

    def __init__(self, plan: ntt_mod.NegacyclicNtt):
        assert plan.n >= 128
        self.plan = plan
        self.first_small_stage = plan.log_n - 7
        P = plan.num_primes
        primes = [int(p) for p in plan.primes]
        self.fwd_w8 = np.stack([self._dft_limb_stack(pi, False)
                                for pi in range(P)])
        self.inv_w8 = np.stack([self._dft_limb_stack(pi, True)
                                for pi in range(P)])
        u32 = lambda vals: np.array(vals, dtype=np.uint32)
        self.c32 = u32([(1 << 32) % p for p in primes])
        self.c32_sh = u32([(((1 << 32) % p) << 32) // p for p in primes])
        self.one_sh = u32([(1 << 32) // p for p in primes])
        bias = (1 << 23) * (1 + (1 << 8) + (1 << 16) + (1 << 24))
        self.recomb_bias = u32([bias % p for p in primes])
        self.c16 = u32([(1 << 16) % p for p in primes])
        self.c16_sh = u32([(((1 << 16) % p) << 32) // p for p in primes])
        fwd = [self._merged(self.fwd_w8[pi], primes[pi]) for pi in range(P)]
        inv = [self._merged(self.inv_w8[pi], primes[pi]) for pi in range(P)]
        self.fwd_w8m = np.stack([m for m, _ in fwd])
        self.inv_w8m = np.stack([m for m, _ in inv])
        self.fwd_bias_row = np.stack([b for _, b in fwd])
        self.inv_bias_row = np.stack([b for _, b in inv])

    def small_stage_matrix(self, pi: int, inverse: bool) -> np.ndarray:
        """M (mod p, uint64 [128, 128]) with out_row = in_row @ M the
        composite of the stages of stride h < 128 (or their inverse)."""
        plan = self.plan
        p = np.uint64(plan.primes[pi])
        tw = plan.tw_inv if inverse else plan.tw_fwd
        x = np.eye(128, dtype=np.uint64)
        for k in (reversed(range(7)) if inverse else range(7)):
            h = 128 >> (k + 1)
            w = np.asarray(tw[self.first_small_stage + k][pi][:h], np.uint64)
            y = x.reshape(128, 128 // (2 * h), 2, h)
            a, b = y[:, :, 0], y[:, :, 1]
            if inverse:
                bw = (b * w) % p
                pair = ((a + bw) % p, (a + p - bw) % p)
            else:
                pair = ((a + b) % p, ((a + p - b) * w) % p)
            x = np.stack(pair, axis=2).reshape(128, 128)
        return x

    def _dft_limb_stack(self, pi: int, inverse: bool) -> np.ndarray:
        """[4, 512, 128] int8: limb j of the stacked [2^{8i} M mod p]."""
        p = int(self.plan.primes[pi])
        M = self.small_stage_matrix(pi, inverse).astype(np.int64)
        out = np.zeros((4, 512, 128), dtype=np.int8)
        for i in range(4):
            wi = _balanced((M * (pow(2, 8 * i, p))) % p, p)
            for j, d in enumerate(_balanced_limbs(wi)):
                out[j, i * 128:(i + 1) * 128] = d
        return out

    @staticmethod
    def _merged(src: np.ndarray, p: int):
        """([512, 512] int8, [128] u32 bias row) of a [4, 512, 128] limb
        stack: the +2^31 biases and the data limbs' +128 offset (through
        the column sums) folded into the bias row."""
        _assert_pair_fold(src)
        colsum = src.astype(np.int64).sum(axis=1)  # [4, 128]
        lanes = [sum(int(colsum[j, k]) << (8 * j) for j in range(4))
                 for k in range(128)]
        return (np.concatenate(list(src), axis=1).astype(np.int8),
                _bias_row(lanes, 128, p))


def _merged_generic(M: np.ndarray, p: int, nl_in: int, in_offset: int,
                    max_in: int):
    """(W [nl_in*C, 512] int8, bias [128] u32) for out = in @ M mod p with
    inputs offset-split into ``nl_in`` limbs of u = v + ``in_offset``
    (``_merged_limb_matrix_generic``)."""
    C = M.shape[0]
    assert in_offset + max_in < (1 << (8 * nl_in)), (in_offset, max_in)
    src = np.zeros((4, nl_in * C, 128), dtype=np.int8)
    for a in range(nl_in):
        wa = _balanced((M << (8 * a)) % p, p)
        for j, d in enumerate(_balanced_limbs(wa)):
            src[j, a * C:(a + 1) * C] = d
    _assert_pair_fold(src)
    off = 128 * sum(1 << (8 * a) for a in range(nl_in)) - in_offset
    return (np.concatenate(list(src), axis=1),
            _bias_row(M.sum(axis=0), off, p))


class V4Tables:
    """The v4 four-step tables of one plan at ``base_log``
    (``_KernelTablesV4``): ``fwd_w8`` [P, nl_in*128, 512] int8, ``inv_w8``
    [P, 512, 512], ``inv_bias`` [P, 128], ``tw`` [P, 5, G, 128] (T, its
    dual, 2^16 T, its dual, the forward bias through T), ``tw_inv``
    [P, 2, G, 128], ``gw_fwd`` / ``gw_inv`` [P, log_g, 2, G, 128] (the
    group stages' twiddles and duals, lane-replicated), ``c16``,
    ``c16_sh``, ``one_sh``; ``nl_in`` int8 limbs of a digit offset by
    ``in_offset``."""

    def __init__(self, plan: ntt_mod.NegacyclicNtt, base_log: int):
        n = plan.n
        assert n % 128 == 0 and n >= 256
        G = self.G = n // 128
        self.log_g = G.bit_length() - 1
        self.plan, self.base_log = plan, base_log
        self.nl_in = max(1, -(-(base_log + 1) // 8))
        self.in_offset = 1 << (base_log - 1)
        jj = np.arange(128, dtype=np.int64)[:, None]
        kk = np.arange(128, dtype=np.int64)[None, :]
        e_lane = (G * jj * (1 + 2 * kk)) % (2 * n)  # [j2, k2]
        e_tw = (np.arange(G, dtype=np.int64)[:, None] * (1 + 2 * kk)) \
            % (2 * n)  # [j1, k2]
        fwd_w8, inv_w8, inv_bias, tw, tw_inv, gw_f, gw_i = ([] for _ in
                                                             range(7))
        for p in (int(q) for q in plan.primes):
            ps = ntt_mod._psi_root(p, 2 * n)
            pw = np.array([pow(ps, e, p) for e in range(2 * n)], np.int64)
            W, bias = _merged_generic(pw[e_lane], p, self.nl_in,
                                      self.in_offset, self.in_offset)
            fwd_w8.append(W)
            minv = (pw[(2 * n - e_lane.T) % (2 * n)] * pow(128, p - 2, p)) % p
            Wi, bias_i = _merged_generic(minv, p, 4, 0, p - 1)
            inv_w8.append(Wi)
            inv_bias.append(bias_i)
            T = pw[e_tw]
            T16 = (T * pow(2, 16, p)) % p
            Tinv = (pw[(2 * n - e_tw) % (2 * n)] * pow(G, p - 2, p)) % p
            biasT = (T * bias[None, :].astype(np.int64)) % p
            tw.append(np.stack([T, _shoup(T, p), T16, _shoup(T16, p),
                                biasT]))
            tw_inv.append(np.stack([Tinv, _shoup(Tinv, p)]))
            wg = pow(ps, 2 * 128, p)  # omega^128, omega = psi^2
            fs, is_ = [], []
            for s in range(self.log_g):
                m = G >> s
                h = m >> 1
                wm = pow(wg, G // m, p)
                row_f = np.zeros(G, np.int64)
                row_i = np.zeros(G, np.int64)
                for j in range(h):
                    row_f[h + j::m] = pow(wm, j, p)
                    row_i[h + j::m] = pow(wm, (p - 2) * j, p)
                fs.append(np.stack([row_f, _shoup(row_f, p)]))
                is_.append(np.stack([row_i, _shoup(row_i, p)]))
            gw_f.append(np.stack(fs) if fs else np.zeros((0, 2, G), np.int64))
            gw_i.append(np.stack(is_) if is_ else np.zeros((0, 2, G),
                                                           np.int64))
        lanes = lambda a: np.repeat(np.stack(a)[..., None], 128, axis=-1)
        self.fwd_w8 = np.stack(fwd_w8).astype(np.int8)
        self.inv_w8 = np.stack(inv_w8).astype(np.int8)
        self.inv_bias = np.stack(inv_bias).astype(np.uint32)
        self.tw = np.stack(tw).astype(np.uint32)
        self.tw_inv = np.stack(tw_inv).astype(np.uint32)
        self.gw_fwd = lanes(gw_f).astype(np.uint32)
        self.gw_inv = lanes(gw_i).astype(np.uint32)
        primes = [int(p) for p in plan.primes]
        self.c16 = np.array([(1 << 16) % p for p in primes], np.uint32)
        self.c16_sh = np.array([(((1 << 16) % p) << 32) // p
                                for p in primes], np.uint32)
        self.one_sh = np.array([(1 << 32) // p for p in primes], np.uint32)


@functools.lru_cache(maxsize=None)
def v3_tables(n: int, num_primes: int) -> V3Tables:
    """The v3 tables of ``get_plan(n, num_primes)``, built once."""
    return V3Tables(ntt_mod.get_plan(n, num_primes))


@functools.lru_cache(maxsize=None)
def v4_tables(n: int, num_primes: int, base_log: int) -> V4Tables:
    """The v4 tables of ``get_plan(n, num_primes)`` at ``base_log``, built
    once."""
    return V4Tables(ntt_mod.get_plan(n, num_primes), base_log)
