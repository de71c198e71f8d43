"""K7 (``csrc/blind_rotate_wide.cu``), the exact CRT step with its
accumulator and digits in global memory, on the CPU: its three stages as
``ops/step_passes.py`` mirrors them (the kernels' index formulas, one
polynomial a block on ``ntt_common.cuh``'s passes) against the plain
versions it shares with K3, K3-acc32 and K5b, at N = 8192 and N = 32768;
the dispatch by shape and the envelope; and the port's
``apply_lookup_table`` against ``tfhe_tpu``'s at the 3_3 classic and
group-4 3_3 multi-bit shapes (N = 8192, l = 2; ``lwe_dimension`` cut to 8,
everything else as published), on keys carried across by ``convert``.
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

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import from_u32, from_u64, to_u64
from tfhe_tpu_torch.core import algorithms as algo
from tfhe_tpu_torch.core.entities import LweBootstrapKey
from tfhe_tpu_torch.ops import ntt
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.ops import step_passes as sp
from tfhe_tpu_torch.shortint.ciphertext import ShortintCiphertext
from tfhe_tpu_torch.utils import params as pm

CLASSIC_33 = "PARAM_MESSAGE_3_CARRY_3_KS_PBS_GAUSSIAN_2M128"
MULTI_BIT_33 = "PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_3_CARRY_3_KS_PBS_GAUSSIAN_2M128"
#: (R, levels, base_log) of the mirror's shapes at each N: 3_3's (k = 1,
#: l = 2, b = 15)
SHAPE = (2, 2, 15)
P = 4
VALUES = np.array([0, 13, 42, 63], dtype=np.uint64)  # of the 64 of 3_3


def _crt_key(rng, n, levels, R, N, base_log):
    std = from_u64(rng.integers(0, 1 << 64, size=(n, levels, R, R, N),
                                dtype=np.uint64), "cpu")
    return pk.bsk_to_scan_layout(algo.bootstrap_key_to_ntt(
        LweBootstrapKey(std, base_log, levels), P).residues)


@pytest.mark.parametrize("N", [8192, 32768])
@pytest.mark.parametrize("entry", ["blind_rotate_crt",
                                   "blind_rotate_crt_acc32"])
def test_classic_stages_equal_the_plain_version(entry, N):
    """Two CMUX steps on K7's stages (K7a: the rotated difference's digit
    a block, the forward passes; K7b: the Shoup MAC, the inverse passes and
    the untwist; K7c: the Garner tail added) equal K3's (u64) or
    K3-acc32's (u32 hi plane) plain version on seeded accumulators, masks
    and keys."""
    R, levels, base_log = SHAPE
    rng = np.random.default_rng(N + len(entry))
    B, n = 2, 2
    key = _crt_key(rng, n, levels, R, N, base_log)
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(B, n)))
    if entry.endswith("acc32"):
        acc = from_u32(rng.integers(0, 1 << 32, size=(B, R, N),
                                    dtype=np.uint32), "cpu")
    else:
        acc = from_u64(rng.integers(0, 1 << 64, size=(B, R, N),
                                    dtype=np.uint64), "cpu")
    want = getattr(pk, f"{entry}_plain")(acc, mask, key, base_log, levels)
    got = sp.cmux_steps_wide(entry, acc, mask, key, base_log, levels)
    assert got.dtype == acc.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("N", [8192, 32768])
def test_multi_bit_stages_equal_the_plain_version(N):
    """Two group steps on K7's stages (the digits of acc itself, the
    product mod p against the ciphertext's bundle, the Garner value in
    acc's place) equal K5b's plain version on seeded bundles."""
    R, levels, base_log = SHAPE
    rng = np.random.default_rng(N)
    B, count = 2, 2
    plan = ntt.get_plan(N, P)
    bundles = torch.stack([torch.from_numpy(rng.integers(
        0, p, size=(B, count, levels * R, R, N))) for p in plan.primes],
        dim=2).to(torch.int32)
    acc = from_u64(rng.integers(0, 1 << 64, size=(B, R, N),
                                dtype=np.uint64), "cpu")
    want = pk.multi_bit_accumulate_plain(acc, bundles, base_log, levels)
    got = sp.multi_bit_accumulate_wide(acc, bundles, base_log, levels)
    assert torch.equal(got, want)


def test_wide_plan_runs_every_stage_once():
    """K7's passes: each transform's stages once, in order, <= 3 a pass, at
    most brk::kMaxPasses (5) passes up to N = 32768."""
    for log_n in range(3, 16):
        fwd, inv = sp.wide_plan(log_n)
        assert [s for s0, k in fwd for s in range(s0, s0 + k)] == \
            list(range(log_n))
        assert [s for s0, k in inv for s in reversed(range(s0, s0 + k))] \
            == list(reversed(range(log_n)))
        assert max(k for _, k in fwd + inv) <= 3
        assert len(fwd) <= 5 and len(inv) <= 5


def test_dispatch_by_shape_and_the_envelope():
    """K3 / K5b below a block's shared memory, K7 beyond it, from the shape
    alone (3_3: 655,360 B; 2_2: 98,304 B); K7's envelope ends at N = 32768
    and base_log * levels = 63 (from 32 on the 64-bit decomposer); a
    chunk's scratch is bounded; on CPU tensors every wrapper runs the
    plain version and counts nothing."""
    meta = dict(device="meta", dtype=torch.int64)
    acc33 = torch.empty(4, 2, 8192, **meta)
    key33 = torch.empty(1, 2, P, 4, 2, 8192, dtype=torch.int32,
                        device="meta")
    assert pk.step_smem_formula(P, 2, 2, 8192, 8) == 655360
    assert pk._wide_shape(acc33, key33, 2, 8)
    assert pk._wide_shape(acc33, key33, 2, 4)
    acc22 = torch.empty(4, 2, 2048, **meta)
    key22 = torch.empty(1, 2, P, 2, 2, 2048, dtype=torch.int32,
                        device="meta")
    assert pk.step_smem_formula(P, 2, 1, 2048, 8) == 98304
    assert not pk._wide_shape(acc22, key22, 1, 8)
    assert pk.crt_refusal(P, 2, 2, 15, 32768) is None
    assert "N = 65536" in pk.crt_refusal(P, 2, 2, 15, 65536)
    assert pk.crt_refusal(P, 2, 3, 11, 8192) is None
    assert "<= 63" in pk.crt_refusal(P, 2, 4, 16, 8192)
    assert pk.multi_bit_refusal(P, 4, 2, 3, 10, 32768) is None
    assert pk.wide_chunk(512, 2, 2, P, 8192) == 512
    assert pk.wide_chunk(10 ** 6, 2, 3, P, 32768) * (6 + 2) * P * 32768 * 4 \
        <= pk.WIDE_SCRATCH_BYTES
    rng = np.random.default_rng(5)
    N, (R, levels, base_log) = 256, SHAPE
    key = _crt_key(rng, 2, levels, R, N, base_log)
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(2, 2)))
    acc = from_u64(rng.integers(0, 1 << 64, size=(2, R, N),
                                dtype=np.uint64), "cpu")
    pk.reset_launches()
    assert torch.equal(pk.blind_rotate_wide(acc, mask, key, base_log, levels),
                       pk.blind_rotate_crt_plain(acc, mask, key, base_log,
                                                 levels))
    assert not any(fn.launches for fn in pk.KERNELS)


def test_key_transform_in_slices_equals_one_pass(monkeypatch):
    """``bootstrap_key_to_ntt`` transforms the key's first axis in slices
    (the bound on its temporaries that lets the group-4 3_3 key's 7.9 GB be
    drawn on an 80 GB card): slices of 1 and 3 steps give the bits of one
    pass, and ``tfhe_tpu``'s transform."""
    from tfhe_tpu.core import algorithms as jalgo
    from tfhe_tpu.core.entities import LweBootstrapKey as JLweBootstrapKey

    rng = np.random.default_rng(7)
    std = rng.integers(0, 1 << 64, size=(5, 2, 2, 2, 256), dtype=np.uint64)
    key = LweBootstrapKey(from_u64(std, "cpu"), 15, 2)
    whole = algo.bootstrap_key_to_ntt(key, P).residues
    for entries in (1, 3 * 2 * 2 * 2 * 256):
        monkeypatch.setattr(algo, "NTT_KEY_CHUNK_ENTRIES", entries)
        assert torch.equal(algo.bootstrap_key_to_ntt(key, P).residues, whole)
    want = jalgo.bootstrap_key_to_ntt(JLweBootstrapKey(std, 15, 2), P)
    np.testing.assert_array_equal(whole.numpy().view(np.uint32),
                                  np.asarray(want.residues))


def _cut(pmod, name):
    """``name`` of a params module's registry with ``lwe_dimension`` cut to
    8 (the LWE side's size only: N, k, l, b, the moduli and the grouping
    stay as published)."""
    return dataclasses.replace(pmod.PARAMS_BY_NAME[name], lwe_dimension=8,
                               name=f"{name}_N8")


def _carry_in(jct) -> ShortintCiphertext:
    return ShortintCiphertext(
        ct=from_u64(np.asarray(jct.ct), "cpu"), degree=jct.degree,
        noise_level=jct.noise_level, message_modulus=jct.message_modulus,
        carry_modulus=jct.carry_modulus, under_key=jct.under_key)


@pytest.mark.parametrize("name", [CLASSIC_33, MULTI_BIT_33])
def test_apply_lookup_table_equal_at_3_3(name, monkeypatch):
    """The port's ``apply_lookup_table`` (keyswitch, K2 u64, then K3's or
    the K5 pair's plain version: the functions K7 computes on the card) on
    a ``tfhe_tpu`` server key carried across by ``convert``, bit-equal to
    ``tfhe_tpu``'s on its encryptions of 4 of the 64 message+carry
    values, decrypting to f(x)."""
    monkeypatch.delenv("TFHE_NTT_VARIANT", raising=False)
    monkeypatch.delenv("TFHE_V4_ACC", raising=False)
    jp, p = _cut(jparams, name), _cut(pm, name)
    monkeypatch.setitem(pm.PARAMS_BY_NAME, p.name, p)
    jck = JClientKey.generate(jp, seed=33)
    jsk = JServerKey.generate(jck)
    assert jsk.ntt_variant == "crt"
    sk = convert.server_key_from_arrays(p.name, np.asarray(jsk.ksk),
                                        np.asarray(jsk.bsk_scan),
                                        jsk.num_primes, device="cpu")
    assert sk.num_primes == P and sk.variant == "crt"
    assert pk.needs_wide(P, p.glwe_size, p.pbs_level, p.polynomial_size)
    mod = p.message_modulus * p.carry_modulus
    f = lambda x: (5 * x + 3) % mod  # noqa: E731
    jct = jck.encrypt(VALUES)
    want = jsk.apply_lookup_table(jct, jsk.generate_lookup_table(f))
    pk.reset_launches()
    got = sk.apply_lookup_table(_carry_in(jct), sk.generate_lookup_table(f))
    np.testing.assert_array_equal(to_u64(got.ct), np.asarray(want.ct))
    np.testing.assert_array_equal(jck.decrypt_message_and_carry(want),
                                  [f(int(x)) for x in VALUES])
    assert got.degree == want.degree
    assert not any(fn.launches for fn in pk.KERNELS)
