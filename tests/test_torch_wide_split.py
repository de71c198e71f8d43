"""K7's cluster kernel at split 2 (``csrc/blind_rotate_wide.cu``,
``wide_cluster_kernel<..., 2>``: a cluster of 2 P R CTAs a ciphertext, CTA
(h, pi, r) holding half h of every transform of row r mod p_pi, the
accumulator in global memory) on the CPU, through its mirror
``ops/step_passes.py`` (``cmux_steps_cluster`` and
``multi_bit_accumulate_cluster`` at ``split=2``: each CTA's shared memory
its own tensor, every read of another CTA's through the kernel's rank
h P R + r P + pi, the int16 digit store, stage 0 in the lift and in the
Garner gather):

- against the plain versions it shares with K3, K3-acc32 and K5b
  (``blind_rotate_crt_plain``, ``blind_rotate_crt_acc32_plain``,
  ``multi_bit_accumulate_plain``) at N = 256 and 512, P = 4 and P = 3
  (slices of 32, 32, 32, 32, 0, 0 pairs), l = 2 and 3; at l = 1 (refused
  by the split) the int16 digits of b = 23 show why;
- against ``tfhe_tpu`` at the classic 4_4 shape (N = 32768, l = 2,
  ``lwe_dimension`` cut to 4): the port's ``apply_lookup_table`` with its
  CRT steps forced through the mirror, bit-equal to ``tfhe_tpu``'s;
- the CTA area against its twin, the plan, the dispatch by shape
  (cluster kernel, split, K7 global) and the refusal when the card cannot
  hold a cluster of 16.

Tolerance: exact (integer arithmetic on canonical residues, the same
seeded inputs)."""

import dataclasses

import numpy as np
import pytest
import torch

from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils import params as jparams

from test_torch_strings import one_torch_thread  # noqa: F401
from test_torch_wide_step import _carry_in

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import from_u32, from_u64, to_u64
from tfhe_tpu_torch.ops import ntt
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.ops import step_passes as sp
from tfhe_tpu_torch.utils import params as pm

CLASSIC_44 = "V1_5_PARAM_MESSAGE_4_CARRY_4_KS_PBS_GAUSSIAN_2M40"
#: (P, R, levels, base_log, N) of the toy shapes
TOY = [(4, 2, 2, 15, 256), (4, 2, 3, 10, 512), (3, 2, 2, 10, 256),
       (3, 2, 3, 10, 512)]


def _acc(rng, B, R, N, acc32=False):
    if acc32:
        return from_u32(rng.integers(0, 1 << 32, size=(B, R, N),
                                     dtype=np.uint32), "cpu")
    return from_u64(rng.integers(0, 1 << 64, size=(B, R, N),
                                 dtype=np.uint64), "cpu")


def _key(rng, n, levels, R, N, P):
    """A random K3 key [n, 2, P, l R, R, N] over P primes."""
    plan = ntt.get_plan(N, P)
    res = torch.stack([torch.from_numpy(rng.integers(
        0, p, size=(n, levels * R, R, N))) for p in plan.primes])
    return ntt.with_shoup_duals(res, plan).movedim(2, 0).contiguous()


@pytest.mark.parametrize("P,R,levels,base_log,N", TOY)
@pytest.mark.parametrize("entry", ["blind_rotate_crt",
                                   "blind_rotate_crt_acc32"])
def test_classic_split_equals_the_plain_version(entry, P, R, levels,
                                                base_log, N):
    """Two CMUX steps on the split's phases (the digits of each CTA's
    pairs from the rotated difference read in global memory, stored as
    int16; the lift of both digits of a pair with stage 0 kept for the
    CTA's half; the half's passes; the partials pulled across rows; stage
    0 and the untwist in the Garner gather across halves and primes) equal
    K3's (u64) or K3-acc32's (u32 hi plane) plain version."""
    rng = np.random.default_rng(1000 * P + 10 * levels + N + len(entry))
    B, n = 2, 2
    key = _key(rng, n, levels, R, N, P)
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(B, n)))
    acc = _acc(rng, B, R, N, entry.endswith("acc32"))
    want = getattr(pk, f"{entry}_plain")(acc, mask, key, base_log, levels)
    got = sp.cmux_steps_cluster(entry, acc, mask, key, base_log, levels,
                                split=2)
    assert got.dtype == acc.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("P,R,levels,base_log,N", TOY)
def test_multi_bit_split_equals_the_plain_version(P, R, levels, base_log,
                                                  N):
    """Two group steps on the split's phases (the digits of acc itself,
    the Barrett MAC against the ciphertext's bundle at the half's
    positions, the Garner value in acc's place) equal K5b's plain
    version."""
    rng = np.random.default_rng(7 + P + levels + N)
    B, count = 2, 2
    plan = ntt.get_plan(N, P)
    bundles = torch.stack([torch.from_numpy(rng.integers(
        0, p, size=(B, count, levels * R, R, N))) for p in plan.primes],
        dim=2).to(torch.int32)
    acc = _acc(rng, B, R, N)
    want = pk.multi_bit_accumulate_plain(acc, bundles, base_log, levels)
    got = sp.multi_bit_accumulate_cluster(acc, bundles, base_log, levels,
                                          split=2)
    assert torch.equal(got, want)


def test_level_one_is_refused_for_its_digits():
    """At l = 1 a balanced digit may need more than 16 bits (b <= 31): the
    split's int16 store cannot hold b = 23 (the mirror differs from the
    plain version), so ``fits_cluster`` refuses l = 1 at split 2 and such
    a shape beyond the cluster kernel stays on K7 global."""
    rng = np.random.default_rng(23)
    P, R, N, B = 4, 2, 256, 2
    key = _key(rng, 1, 1, R, N, P)
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(B, 1)))
    acc = _acc(rng, B, R, N)
    want = pk.blind_rotate_crt_plain(acc, mask, key, 23, 1)
    assert not torch.equal(
        sp.cmux_steps_cluster("blind_rotate_crt", acc, mask, key, 23, 1,
                              split=2), want)
    assert torch.equal(
        sp.cmux_steps_cluster("blind_rotate_crt", acc, mask, key, 23, 1),
        want)
    assert not pk.fits_cluster(P, R, 1, 32768, 8, 2)
    assert pk.wide_route(P, R, 1, 32768) == "global"


def test_cta_area_ranks_slices_and_plan():
    """The split's CTA area is the kernel's formula (the half digit area
    [max(l, R)][N/2] u32 and the pairs' digits [l][2 S] i16: 147,456 B at
    N = 32768, l = 2; 221,184 B at l = 3; 110,592 B at N = 16384, l = 3),
    against the cluster kernel's 393,216, 557,056 and 278,528 B; the rank
    is h P R + r P + pi; the pairs tile [0, N/2) (P = 3: 32, 32, 32, 32,
    0, 0 at N = 256); the plan runs each stage once, the lift on stages 0
    .. 3, the half's passes of <= 3 stages from stage 4 and down to stage
    1 (stage 0 is the gather's), at most 5 passes a side up to N =
    32768."""
    for shape in ((4, 2, 2, 32768), (4, 2, 3, 32768), (4, 2, 3, 16384),
                  (3, 2, 2, 256), (2, 4, 3, 4096), (5, 1, 2, 1024)):
        for acc_bytes in (8, 4):
            assert sp.cluster_smem_bytes(*shape, acc_bytes, split=2) == \
                pk.cluster_smem_formula(*shape, acc_bytes, split=2)
    assert [pk.cluster_smem_formula(4, 2, lv, n, 8, split)
            for lv, n in ((2, 32768), (3, 32768), (3, 16384))
            for split in (2, 1)] == [147456, 393216, 221184, 557056, 110592,
                                     278528]
    assert sp.cluster_rank(1, 3, 1, 4, 2) == 15
    assert sp.cluster_rank(0, 2, 1, 4, 2) == 6
    for N, P, want in ((256, 3, [32] * 4 + [0, 0]), (256, 4, [16] * 8),
                       (1024, 5, [64] * 8 + [0, 0])):
        sl = [sp.cluster_slice(N, P, o, 2) for o in range(2 * P)]
        assert [ln for _, ln in sl] == want
        assert sp.cluster_log_slice(N, P, 2) == pk.cluster_log_slice(N, P, 2)
    for log_n in range(8, 16):
        fwd, inv = sp.cluster_plan(log_n, 2)
        assert [s for s0, k in fwd for s in range(s0, s0 + k)] == \
            list(range(log_n))
        assert [s for s0, k in inv for s in reversed(range(s0, s0 + k))] \
            == list(reversed(range(1, log_n)))
        assert fwd[0] == (0, 4) and fwd[-1] == inv[0] == (log_n - 2, 2)
        assert max(k for _, k in fwd[1:] + inv) <= 3
        assert len(fwd) <= 5 and len(inv) <= 5


def test_dispatch_by_shape_and_the_refusal(monkeypatch):
    """From the shape alone: the cluster kernel where its CTA fits (3_3, N
    = 16384 at l = 2), the split where only a CTA of half the transforms
    does (N = 32768 at l = 2 and 3, N = 16384 at l = 3, both accumulator
    modes), K7 global beyond (P R > 8, or l = 1 at N = 32768). When the
    card cannot keep a cluster of 16 resident
    (``cudaOccupancyMaxActiveClusters`` = 0) the split's check raises:
    no other kernel runs in its place. On CPU tensors the split's wrappers
    run the plain versions and count nothing."""
    route = pk.wide_route
    assert route(4, 2, 2, 8192) == route(4, 2, 2, 16384) == "cluster"
    assert route(4, 2, 2, 32768) == route(4, 2, 2, 32768, 4) == "split"
    assert route(4, 2, 3, 32768) == route(4, 2, 3, 16384) == "split"
    assert route(4, 2, 3, 16384, 4) == "split"
    assert route(5, 2, 2, 32768) == route(4, 2, 1, 32768) == "global"
    meta = dict(device="meta", dtype=torch.int64)
    acc = torch.empty(4, 2, 32768, **meta)
    key = torch.empty(1, 2, 4, 4, 2, 32768, dtype=torch.int32,
                      device="meta")
    assert pk._wide_shape(acc, key, 2, 8) == "split"
    assert pk.WIDE_ROUTES["split"] == (pk.blind_rotate_wide_split,
                                       pk.blind_rotate_wide_split_acc32,
                                       pk.multi_bit_accumulate_wide_split)
    occupancy = {"registers": 64, "local_bytes": 0, "smem_bytes": 221184,
                 "cluster": 16, "blocks_per_sm": 1, "clusters": 0}
    calls = []

    def fake(P, R, levels, N, split=1):
        calls.append((P, R, levels, N, split))
        return occupancy

    monkeypatch.setattr(pk, "wide_cluster_occupancy", fake)
    pk.split_clusters.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no cluster of 16 CTAs"):
            pk.split_clusters(4, 2, 3, 32768)
        occupancy["clusters"] = 7
        assert pk.split_clusters(4, 2, 2, 32768) == 7
        assert calls == [(4, 2, 3, 32768, 2), (4, 2, 2, 32768, 2)]
    finally:
        pk.split_clusters.cache_clear()
    rng = np.random.default_rng(5)
    N = 256
    key = _key(rng, 2, 2, 2, N, 4).to(torch.int32)
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(2, 2)))
    acc = _acc(rng, 2, 2, N)
    pk.reset_launches()
    assert torch.equal(pk.blind_rotate_wide_split(acc, mask, key, 15, 2),
                       pk.blind_rotate_crt_plain(acc, mask, key, 15, 2))
    assert not any(fn.launches for fn in pk.KERNELS)


def test_apply_lookup_table_through_the_split_mirror(monkeypatch):
    """The port's ``apply_lookup_table`` at the classic 4_4 shape (N =
    32768, l = 2, b = 15; lwe_dimension cut to 4), its CRT steps forced
    through the split's mirror (``pk.blind_rotate_crt`` replaced by it), on
    a ``tfhe_tpu`` server key carried across by ``convert``: bit-equal to
    ``tfhe_tpu``'s on its encryptions, decrypting to f(x)."""
    monkeypatch.delenv("TFHE_NTT_VARIANT", raising=False)
    monkeypatch.delenv("TFHE_V4_ACC", raising=False)

    def cut(pmod):
        return dataclasses.replace(pmod.PARAMS_BY_NAME[CLASSIC_44],
                                   lwe_dimension=4, name=f"{CLASSIC_44}_N4")

    jp, p = cut(jparams), cut(pm)
    monkeypatch.setitem(pm.PARAMS_BY_NAME, p.name, p)
    jck = JClientKey.generate(jp, seed=44)
    jsk = JServerKey.generate(jck)
    sk = convert.server_key_from_arrays(p.name, np.asarray(jsk.ksk),
                                        np.asarray(jsk.bsk_scan),
                                        jsk.num_primes, device="cpu")
    assert sk.variant == "crt" and pk.wide_route(
        sk.num_primes, p.glwe_size, p.pbs_level, p.polynomial_size) == "split"
    calls = []

    def classic(acc, mask, key, base_log, levels):
        calls.append(acc.shape)
        return sp.cmux_steps_cluster("blind_rotate_crt", acc, mask, key,
                                     base_log, levels, split=2)

    monkeypatch.setattr(pk, "blind_rotate_crt", classic)
    mod = p.message_modulus * p.carry_modulus
    f = lambda x: (7 * x + 1) % mod  # noqa: E731
    values = np.array([0, 77, 200, 255], dtype=np.uint64)
    jct = jck.encrypt(values)
    want = jsk.apply_lookup_table(jct, jsk.generate_lookup_table(f))
    got = sk.apply_lookup_table(_carry_in(jct), sk.generate_lookup_table(f))
    assert calls == [(4, 2, 32768)]
    np.testing.assert_array_equal(to_u64(got.ct), np.asarray(want.ct))
    np.testing.assert_array_equal(jck.decrypt_message_and_carry(want),
                                  [f(int(x)) for x in values])
