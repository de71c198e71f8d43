"""K7's cluster kernel (``csrc/blind_rotate_wide.cu``, ``wide_cluster_kernel``:
one thread-block cluster of P R CTAs a ciphertext, its accumulator slices,
digits, MAC partials and residues in distributed shared memory for all n
steps) on the CPU, through its mirror ``ops/step_passes.py``
(``cmux_steps_cluster``, ``multi_bit_accumulate_cluster``: the ownership
map rank -> (pi, r), the slices, the rotation reads across slices, the
pulled partials and the Garner gather, with the kernel's own index
formulas):

- against the plain versions K7 shares with K3, K3-acc32 and K5b
  (``blind_rotate_crt_plain``, ``blind_rotate_crt_acc32_plain``,
  ``multi_bit_accumulate_plain``) at toy shapes: N = 256, P = 4, R = 2,
  l = 1 and 2, and P = 3, whose slices are uneven (128, 128, 0);
- against ``tfhe_tpu`` at one forced shape: the port's
  ``apply_lookup_table`` at the 3_3 classic and group-4 3_3 shapes
  (``lwe_dimension`` cut to 8) with the CRT steps forced through the
  mirror, bit-equal to ``tfhe_tpu``'s;
- the dispatch by shape (K3 / K5b, the cluster kernel, K7 global), the
  CTA area and the plan.

Tolerance: exact (integer arithmetic on canonical residues, the same
seeded inputs)."""

import numpy as np
import pytest
import torch

from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils import params as jparams

from test_torch_strings import one_torch_thread  # noqa: F401
from test_torch_wide_step import (CLASSIC_33, MULTI_BIT_33, VALUES, _carry_in,
                                  _crt_key, _cut)

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import from_u32, from_u64, to_u64
from tfhe_tpu_torch.ops import ntt
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.ops import server
from tfhe_tpu_torch.ops import step_passes as sp
from tfhe_tpu_torch.utils import params as pm

N = 256
#: (P, R, levels, base_log) of the toy shapes
TOY = [(4, 2, 2, 15), (4, 2, 1, 23), (3, 2, 2, 10)]


def _acc(rng, B, R, acc32):
    if acc32:
        return from_u32(rng.integers(0, 1 << 32, size=(B, R, N),
                                     dtype=np.uint32), "cpu")
    return from_u64(rng.integers(0, 1 << 64, size=(B, R, N),
                                 dtype=np.uint64), "cpu")


def _key(rng, n, levels, R, base_log, P):
    """A random K3 key [n, 2, P, l R, R, N] over P primes (``_crt_key``
    is at the 3_3 files' P = 4)."""
    if P == 4:
        return _crt_key(rng, n, levels, R, N, base_log)
    plan = ntt.get_plan(N, P)
    res = torch.stack([torch.from_numpy(rng.integers(
        0, p, size=(n, levels * R, R, N))) for p in plan.primes])
    return ntt.with_shoup_duals(res, plan).movedim(2, 0).contiguous()


@pytest.mark.parametrize("P,R,levels,base_log", TOY)
@pytest.mark.parametrize("entry", ["blind_rotate_crt",
                                   "blind_rotate_crt_acc32"])
def test_classic_cluster_equals_the_plain_version(entry, P, R, levels,
                                                  base_log):
    """Three CMUX steps on the cluster kernel's phases (each slice's digits
    from the rotated difference read across slices, the lift from the
    owners' digits, the MAC partials pulled across rows, the Garner gather
    across primes) equal K3's (u64) or K3-acc32's (u32 hi plane) plain
    version on seeded accumulators, masks and keys."""
    rng = np.random.default_rng(100 * P + 10 * levels + len(entry))
    B, n = 3, 3
    key = _key(rng, n, levels, R, base_log, P)
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(B, n)))
    acc = _acc(rng, B, R, entry.endswith("acc32"))
    want = getattr(pk, f"{entry}_plain")(acc, mask, key, base_log, levels)
    got = sp.cmux_steps_cluster(entry, acc, mask, key, base_log, levels)
    assert got.dtype == acc.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("levels,base_log", [(2, 15), (1, 23)])
def test_multi_bit_cluster_equals_the_plain_version(levels, base_log):
    """Three group steps on the cluster kernel's phases (the digits of acc
    itself, the Barrett MAC against the ciphertext's bundle, the Garner
    value in acc's place) equal K5b's plain version."""
    rng = np.random.default_rng(7 + levels)
    B, count, P, R = 3, 3, 4, 2
    plan = ntt.get_plan(N, P)
    bundles = torch.stack([torch.from_numpy(rng.integers(
        0, p, size=(B, count, levels * R, R, N))) for p in plan.primes],
        dim=2).to(torch.int32)
    acc = _acc(rng, B, R, False)
    want = pk.multi_bit_accumulate_plain(acc, bundles, base_log, levels)
    got = sp.multi_bit_accumulate_cluster(acc, bundles, base_log, levels)
    assert torch.equal(got, want)


def test_ownership_slices_and_plan():
    """Rank r P + pi is CTA (pi, r); the slices tile [0, N) (P = 3: 128,
    128 and an empty one; P = 5 at N = 1024: four of 256 and an empty
    one); the CTA area is the kernel's formula (3_3: 98,304 B; N = 16384:
    196,608 B); the plan runs each transform's stages once, the MAC and
    the sum on the last two forward and first two inverse stages, the
    lift on a pass of 3 stages and the untwist on one of 2 or 3 (the only
    ones the kernel instantiates), at most 5 passes a side up to N =
    16384."""
    assert sp.cluster_ranks(4, 2)[5] == (1, 1)
    for P, n, want in ((4, 256, [64] * 4), (3, 256, [128, 128, 0]),
                       (5, 1024, [256] * 4 + [0]), (2, 512, [256, 256])):
        sl = [sp.cluster_slice(n, P, pi) for pi in range(P)]
        assert [ln for _, ln in sl] == want
        assert all(b == pi << sp.cluster_log_slice(n, P)
                   for pi, (b, _) in enumerate(sl))
        assert sp.cluster_log_slice(n, P) == pk.cluster_log_slice(n, P)
    for shape in ((4, 2, 2, 8192), (4, 2, 2, 16384), (4, 2, 1, 8192),
                  (3, 2, 2, 256), (2, 4, 3, 4096)):
        for acc_bytes in (8, 4):
            assert sp.cluster_smem_bytes(*shape, acc_bytes) == \
                pk.cluster_smem_formula(*shape, acc_bytes)
    assert pk.cluster_smem_formula(4, 2, 2, 8192, 8) == 98304
    assert pk.cluster_smem_formula(4, 2, 2, 16384, 8) == 196608
    for log_n in range(8, 15):
        fwd, inv = sp.cluster_plan(log_n)
        assert [s for s0, k in fwd for s in range(s0, s0 + k)] == \
            list(range(log_n))
        assert [s for s0, k in inv for s in reversed(range(s0, s0 + k))] \
            == list(reversed(range(log_n)))
        assert fwd[-1] == inv[0] == (log_n - 2, 2)
        assert fwd[0][1] == 3 and inv[-1][1] in (2, 3)
        assert max(k for _, k in fwd + inv) <= 3
        assert len(fwd) <= 5 and len(inv) <= 5


def test_dispatch_by_shape():
    """Which kernel each shape goes to, from the shape alone: K3 / K5b
    within a block (2_2), the cluster kernel at 3_3 (classic, both
    accumulator modes, and the group-4 shape), at N = 16384, l = 2 and at
    N = 8192, l = 1; the cluster kernel at split 2 at N = 32768 and at N =
    16384, l = 3; K7 global beyond 8 CTAs a half (P R > 8); never a
    cluster of split 1 beyond 8 CTAs. On CPU tensors every wrapper runs
    the plain version and counts nothing."""
    route = pk.wide_route
    assert route(4, 2, 1, 2048) is None
    assert route(4, 2, 2, 8192) == route(4, 2, 2, 8192, 4) == "cluster"
    assert route(4, 2, 2, 16384) == route(4, 2, 1, 8192) == "cluster"
    assert route(4, 2, 2, 32768) == route(4, 2, 3, 16384) == "split"
    assert route(4, 2, 3, 32768) == route(4, 2, 2, 32768, 4) == "split"
    assert route(5, 2, 2, 8192) == route(4, 3, 2, 8192) == "global"
    assert not pk.fits_cluster(4, 3, 1, 4096)
    meta = dict(device="meta", dtype=torch.int64)
    acc33 = torch.empty(4, 2, 8192, **meta)
    key33 = torch.empty(1, 2, 4, 4, 2, 8192, dtype=torch.int32,
                        device="meta")
    assert pk._wide_shape(acc33, key33, 2, 8) == "cluster"
    assert pk._wide_shape(torch.empty(4, 2, 32768, **meta), torch.empty(
        1, 2, 4, 4, 2, 32768, dtype=torch.int32, device="meta"), 2, 8) == \
        "split"
    assert pk._wide_shape(acc33, key33[0], 2, 8) is None
    rng = np.random.default_rng(5)
    key = _crt_key(rng, 2, 2, 2, N, 15)
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(2, 2)))
    acc = _acc(rng, 2, 2, False)
    pk.reset_launches()
    assert torch.equal(
        pk.blind_rotate_wide_cluster(acc, mask, key, 15, 2),
        pk.blind_rotate_crt_plain(acc, mask, key, 15, 2))
    assert not any(fn.launches for fn in pk.KERNELS)


@pytest.mark.parametrize("name", [CLASSIC_33, MULTI_BIT_33])
def test_apply_lookup_table_through_the_cluster_mirror(name, monkeypatch):
    """The port's ``apply_lookup_table`` at the 3_3 classic and group-4
    3_3 shapes (N = 8192, l = 2; lwe_dimension cut to 8), with its CRT
    steps forced through the cluster kernel's mirror (``pk.blind_rotate_
    crt`` or the multi-bit external products replaced by it), on a
    ``tfhe_tpu`` server key carried across by ``convert``: bit-equal to
    ``tfhe_tpu``'s on its encryptions, decrypting to f(x)."""
    monkeypatch.delenv("TFHE_NTT_VARIANT", raising=False)
    monkeypatch.delenv("TFHE_V4_ACC", raising=False)
    jp, p = _cut(jparams, name), _cut(pm, name)
    monkeypatch.setitem(pm.PARAMS_BY_NAME, p.name, p)
    jck = JClientKey.generate(jp, seed=34)
    jsk = JServerKey.generate(jck)
    sk = convert.server_key_from_arrays(p.name, np.asarray(jsk.ksk),
                                        np.asarray(jsk.bsk_scan),
                                        jsk.num_primes, device="cpu")
    assert pk.wide_route(sk.num_primes, p.glwe_size, p.pbs_level,
                         p.polynomial_size) == "cluster"
    calls = []

    def classic(acc, mask, key, base_log, levels):
        calls.append(acc.shape)
        return sp.cmux_steps_cluster("blind_rotate_crt", acc, mask, key,
                                     base_log, levels)

    def multi_bit(acc, bundles, base_log, levels, plan):
        calls.append(acc.shape)
        return sp.multi_bit_accumulate_cluster(acc, bundles, base_log,
                                               levels)

    monkeypatch.setattr(pk, "blind_rotate_crt", classic)
    monkeypatch.setattr(server, "multi_bit_accumulate_plain", multi_bit)
    mod = p.message_modulus * p.carry_modulus
    f = lambda x: (7 * x + 1) % mod  # noqa: E731
    jct = jck.encrypt(VALUES)
    want = jsk.apply_lookup_table(jct, jsk.generate_lookup_table(f))
    got = sk.apply_lookup_table(_carry_in(jct), sk.generate_lookup_table(f))
    assert calls
    np.testing.assert_array_equal(to_u64(got.ct), np.asarray(want.ct))
    np.testing.assert_array_equal(jck.decrypt_message_and_carry(want),
                                  [f(int(x)) for x in VALUES])
