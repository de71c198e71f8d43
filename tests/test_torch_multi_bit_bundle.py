"""The K5 pair's split of the multi-bit blind rotation against ``tfhe_tpu``
on the CPU, exactly: the key bundles (``multi_bit_keybundle_plain``, K5a's
spec) composed with the accumulate (``multi_bit_accumulate_plain``, K5b's)
in chunks of 1 step, a ragged chunk and all n/g steps equal
``tfhe_tpu``'s ``multi_bit_blind_rotate`` at ``PARAM_TEST_TOY_MULTI_BIT``
(g = 2) and its g = 3, 4 variants, batch 1 and 3; one bundle against an
independent sum built from ``tfhe_tpu``'s trivial GGSW and its plan's
transform of X^a - 1; the chunk rule and the pairs the wrapper runs; the
single-kernel reference's plain path against the pair's; the wrappers'
device checks. Tolerance: exact."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfhe_tpu.core import algorithms as jalgo
from tfhe_tpu.ops import ntt as jntt
from tfhe_tpu.ops import server as jserver

from test_torch_multi_bit import TOY_N, multi_bit_keys, rotation_inputs
from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch._torus import from_u64, to_u64
from tfhe_tpu_torch.core import algorithms as algo
from tfhe_tpu_torch.ops import ntt as ntt_mod
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.ops import server

N = 256
BASE_LOG, LEVELS = 23, 1  # PARAM_TEST_TOY_MULTI_BIT's PBS decomposition
#: chunk sizes by name: one step, a size that does not divide n/g (the
#: last chunk ragged), all n/g steps
CHUNKS = {"one": lambda ng: 1, "ragged": lambda ng: ng // 2 + 1,
          "all": lambda ng: ng}


@pytest.fixture(scope="module")
def keys():
    """Per grouping: the JAX and port residues [P, n/g, 2^g-1, l, R, R, N]
    of one key, and the port's key in K5's layout."""
    out = {}
    for g in (2, 3, 4):
        jb, b = multi_bit_keys(g)
        jres = jalgo.bootstrap_key_to_ntt(jb, 4).residues
        res = algo.bootstrap_key_to_ntt(b, 4).residues
        out[g] = (jres[0], res[0], pk.multi_bit_key_layout(res))
    return out


@pytest.fixture(scope="module")
def jax_rotations(keys):
    """``tfhe_tpu``'s multi_bit_blind_rotate per (g, B), computed once."""
    cache = {}

    def get(g, B):
        if (g, B) not in cache:
            lut, mask, body = rotation_inputs(g, B)
            cache[g, B] = np.asarray(jserver.multi_bit_blind_rotate(
                jnp.asarray(lut), jnp.asarray(mask), jnp.asarray(body),
                keys[g][0], BASE_LOG, LEVELS, g, jntt.get_plan(N, 4)))
        return cache[g, B]
    return get


@pytest.mark.parametrize("chunk", list(CHUNKS))
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("g", [2, 3, 4])
def test_split_equals_tfhe_tpu(keys, jax_rotations, g, B, chunk, monkeypatch):
    """The bundles of each chunk then its accumulate, chunk after chunk,
    and ``multi_bit_group_steps`` with the scratch budget set to the same
    chunk size, after the body rotation: equal to the JAX blind rotation
    bit for bit."""
    _, res, _ = keys[g]
    ng = TOY_N[g] // g
    C = CHUNKS[chunk](ng)
    monkeypatch.setattr(pk, "MB_SCRATCH_BYTES", C * B * 4 * 2 * 2 * N * 4)
    assert pk.multi_bit_chunk(B, ng, 4, 2, 2, N) == C
    lut, mask, body = rotation_inputs(g, B)
    mask_t = torch.from_numpy(mask)
    plan = ntt_mod.get_plan(N, 4)
    acc0 = pk.body_rotate_u64_plain(from_u64(lut, "cpu"),
                                    torch.from_numpy(body))
    acc = acc0
    for t0 in range(0, ng, C):
        count = min(C, ng - t0)
        bundles = server.multi_bit_keybundle_plain(
            mask_t, res, t0, count, BASE_LOG, LEVELS, g, plan)
        assert tuple(bundles.shape) == (B, count, 4, LEVELS * 2, 2, N)
        acc = server.multi_bit_accumulate_plain(acc, bundles, BASE_LOG,
                                                LEVELS, plan)
    want = jax_rotations(g, B)
    np.testing.assert_array_equal(to_u64(acc), want)
    steps = server.multi_bit_group_steps(acc0, mask_t, res, BASE_LOG, LEVELS,
                                         g, plan)
    np.testing.assert_array_equal(to_u64(steps), want)


@pytest.mark.parametrize("g", [2, 3, 4])
def test_one_bundle_independent(keys, g):
    """Bundle (b, t) = G1 + sum_v prod_{j in v} NTT(X^{a_j} - 1) (.)
    GGSW_{t,v} mod p, built from ``tfhe_tpu``'s trivial GGSW of 1 and its
    plan's ``fwd`` of X^a - 1 in Python integers, against K5a's plain
    version on the key in K5's layout."""
    jres, _, mbk = keys[g]
    lut, mask, body = rotation_inputs(g, 3)
    b, t = 2, TOY_N[g] // g - 1
    jplan = jntt.get_plan(N, 4)
    triv = jserver._trivial_ggsw_one_hat(N, 4, BASE_LOG, LEVELS, 2)
    ggsw = np.asarray(jres)[:, t]  # [P, 2^g-1, l, R, R, N]
    nh = []
    for j in range(g):
        mono = np.zeros(N, dtype=np.int64)
        a = int(mask[b, t * g + j])
        mono[a % N] = 1 if a < N else -1
        mono[0] -= 1
        nh.append(np.asarray(jplan.fwd(jnp.asarray(mono))).astype(object))
    want = triv.astype(object)
    for v in range(1, 1 << g):
        coef = 1
        for j in range(g):
            if (v >> j) & 1:
                coef = coef * nh[j]
        want = want + coef[:, None, None, None, :] * ggsw[:, v - 1].astype(
            object)
    primes = np.array([int(p) for p in jplan.primes], dtype=object)
    want = (want % primes[:, None, None, None, None]).astype(np.int64)
    got = pk.multi_bit_keybundle_plain(torch.from_numpy(mask), mbk, t, 1,
                                       BASE_LOG, LEVELS)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got[b, 0].numpy(), want.reshape(4, LEVELS * 2, 2, N))


def test_chunk_rule():
    """C fills the scratch budget with whole steps of the batch's bundles,
    at least 1, at most n/g; a call runs ceil((n/g) / C) pairs."""
    bundle = 4 * 2 * 2 * 2048 * 4  # the group-4 set: P l R R N u32
    assert bundle == 131072
    assert pk.multi_bit_chunk(1, 230, 4, 2, 2, 2048) == 230
    assert pk.multi_bit_chunk(2048, 230, 4, 2, 2, 2048) == 8
    assert pk.multi_bit_chunk(264, 230, 4, 2, 2, 2048) == \
        pk.MB_SCRATCH_BYTES // (264 * bundle)
    assert pk.multi_bit_chunk(10 ** 6, 230, 4, 2, 2, 2048) == 1
    for B in (1, 32, 264, 2048):
        C = pk.multi_bit_chunk(B, 230, 4, 2, 2, 2048)
        assert B * C * bundle <= pk.MB_SCRATCH_BYTES
        assert C == 230 or B * (C + 1) * bundle > pk.MB_SCRATCH_BYTES


@pytest.mark.parametrize("g", [2, 4])
def test_pair_runs_its_chunks(keys, g, monkeypatch):
    """On CPU tensors the wrapper runs the plain version, in the chunks the
    kernels run on the card: ceil((n/g) / C) calls of K5a's and K5b's
    plain versions, steps t0 in order, the ragged last chunk shorter; CPU
    calls count no launch."""
    _, _, mbk = keys[g]
    ng = TOY_N[g] // g
    B = 3
    bundle = 4 * 2 * 2 * N * 4
    monkeypatch.setattr(pk, "MB_SCRATCH_BYTES", 3 * B * bundle)
    C = pk.multi_bit_chunk(B, ng, 4, 2, 2, N)
    assert C == min(3, ng)
    calls = []
    keybundle = server.multi_bit_keybundle_plain
    accumulate = server.multi_bit_accumulate_plain

    def counted_keybundle(mask, mbk_, t0, count, *args):
        calls.append(("K5a", t0, count))
        return keybundle(mask, mbk_, t0, count, *args)

    def counted_accumulate(acc, bundles, *args):
        calls.append(("K5b", bundles.shape[1]))
        return accumulate(acc, bundles, *args)

    lut, mask, body = rotation_inputs(g, B)
    acc = pk.body_rotate_u64_plain(from_u64(lut, "cpu"),
                                   torch.from_numpy(body))
    want = pk.blind_rotate_multi_bit_plain(acc, torch.from_numpy(mask), mbk,
                                           BASE_LOG, LEVELS)
    monkeypatch.setattr(server, "multi_bit_keybundle_plain",
                        counted_keybundle)
    monkeypatch.setattr(server, "multi_bit_accumulate_plain",
                        counted_accumulate)
    pk.reset_launches()
    got = pk.blind_rotate_multi_bit(acc, torch.from_numpy(mask), mbk,
                                    BASE_LOG, LEVELS)
    pairs = math.ceil(ng / C)
    want_calls = []
    for t0 in range(0, ng, C):
        count = min(C, ng - t0)
        want_calls += [("K5a", t0, count), ("K5b", count)]
    assert calls == want_calls and len(calls) == 2 * pairs
    assert not any(fn.launches for fn in pk.KERNELS)
    assert torch.equal(got, want)


@pytest.mark.parametrize("g", [3, 4])
def test_r14_plain_equals_pair(keys, g, monkeypatch):
    """The single-kernel reference's wrapper on CPU tensors (its plain
    version) equals the pair's, here run in chunks of 2 steps."""
    _, _, mbk = keys[g]
    B = 3
    monkeypatch.setattr(pk, "MB_SCRATCH_BYTES", 2 * B * 4 * 2 * 2 * N * 4)
    lut, mask, body = rotation_inputs(g, B)
    acc = pk.body_rotate_u64_plain(from_u64(lut, "cpu"),
                                   torch.from_numpy(body))
    mask_t = torch.from_numpy(mask)
    pair = pk.blind_rotate_multi_bit(acc, mask_t, mbk, BASE_LOG, LEVELS)
    r14 = pk.blind_rotate_multi_bit_r14(acc, mask_t, mbk, BASE_LOG, LEVELS)
    assert torch.equal(pair, r14)
    assert pk.blind_rotate_multi_bit_r14.launches == 0


def test_keybundle_plain_layout(keys):
    """K5a's plain version writes [B, count, P, l R, R, N] u32 residues,
    each below its prime, step t0 + tt at index tt."""
    _, _, mbk = keys[4]
    lut, mask, body = rotation_inputs(4, 2)
    mask_t = torch.from_numpy(mask)
    both = pk.multi_bit_keybundle_plain(mask_t, mbk, 1, 2, BASE_LOG, LEVELS)
    assert tuple(both.shape) == (2, 2, 4, 2, 2, N)
    primes = torch.tensor([int(p) for p in ntt_mod.get_plan(N, 4).primes])
    assert (both >= 0).all()
    assert (both < primes[None, None, :, None, None, None]).all()
    second = pk.multi_bit_keybundle_plain(mask_t, mbk, 2, 1, BASE_LOG, LEVELS)
    assert torch.equal(both[:, 1:], second)


@pytest.mark.parametrize("wrapper", ["multi_bit_keybundle",
                                     "multi_bit_accumulate",
                                     "blind_rotate_multi_bit",
                                     "blind_rotate_multi_bit_r14"])
def test_wrappers_refuse_other_devices(wrapper):
    """Given no CPU tensor a wrapper launches its kernel or raises; here,
    with no card, a device that is neither raises before any launch."""
    meta = dict(device="meta")
    acc = torch.zeros((1, 2, 64), dtype=torch.int64, **meta)
    mask = torch.zeros((1, 4), dtype=torch.int64)
    mbk = torch.zeros((2, 2, 4, 3, 2, 2, 64), dtype=torch.int32)
    args = {
        "multi_bit_keybundle": (mask, mbk.to("meta"), 0, 1, 23, 1),
        "multi_bit_accumulate": (acc, torch.zeros((1, 1, 4, 2, 2, 64),
                                                  dtype=torch.int32, **meta),
                                 23, 1),
        "blind_rotate_multi_bit": (acc, mask, mbk, 23, 1),
        "blind_rotate_multi_bit_r14": (acc, mask, mbk, 23, 1),
    }[wrapper]
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(pk, wrapper)(*args)
