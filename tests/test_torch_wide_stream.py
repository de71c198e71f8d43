"""K7's split with its levels streamed (``csrc/blind_rotate_wide.cu``,
``wide_cluster_kernel<..., 3>``, chosen inside the split's entries from
the shape: where a split CTA holding all l digit transforms exceeds a
block, N = 32768 at l = 4 to 6) on the CPU, through its mirror
``ops/step_passes.py`` (``cmux_steps_cluster`` and
``multi_bit_accumulate_cluster`` at ``split=2``, which stream where
``pk.split_streams``: each CTA's phase B a level at a time, the lift into
one transform buffer, the half's passes on it, its last two stages with
the products added into the R partials; the digits in int16 or int8 as
``pk.split_digit_bytes`` picks):

- against the plain versions it shares with K3 and K5b
  (``blind_rotate_crt_plain``, ``multi_bit_accumulate_plain``) at N = 256
  and 512, P = 4 and 3, l = 4, 5 and 6, the hi word's and the 64-bit
  decomposer, both digit stores. At these toy N a split CTA holding all l
  transforms fits a block, so the tests lower the block
  (``pk._SMEM_LIMIT``) to the streamed CTA's area, and the shape's own
  choice streams with the store it takes at N = 32768 (int16 at l = 4,
  int8 beyond); at b = 8 the int8 store shows why it takes b <= 7;
- the CTA area against its twin, and the dispatch by shape: the 13
  tfhe-rs sets at N = 32768 with 4 to 6 levels go to the split, which
  streams them, K7 global keeps P R > 8, l = 1 at N = 32768 and the acc32
  entry there;
- against ``tfhe_tpu`` at ``V1_5_PARAM_MESSAGE_2_CARRY_6_COMPACT_PK_KS_
  PBS_GAUSSIAN_2M64`` (N = 32768, b = 9, l = 4, ``lwe_dimension`` cut to
  4): the port's ``apply_lookup_table`` with its CRT steps forced through
  the mirror, bit-equal to ``tfhe_tpu``'s (b l = 36: its jnp path).

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
from test_torch_wide_split import _acc, _key
from test_torch_wide_step import _carry_in

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import to_u64
from tfhe_tpu_torch.ops import ntt
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.ops import step_passes as sp
from tfhe_tpu_torch.shortint.server_key import num_primes_for
from tfhe_tpu_torch.utils import params as pm
from tfhe_tpu_torch.utils import params_registry as reg

CPK_26 = "V1_5_PARAM_MESSAGE_2_CARRY_6_COMPACT_PK_KS_PBS_GAUSSIAN_2M64"
#: (P, R, levels, base_log, N, digit bytes) of the toy shapes: the hi
#: word's decomposer at b l <= 31 (P = 3 and 4), the 64-bit one beyond
#: (P = 4), each digit store where the split picks it (int16 at l = 4,
#: int8 at l = 5 and 6)
TOY = [(4, 2, 4, 7, 256, 2), (4, 2, 4, 9, 256, 2), (4, 2, 5, 6, 256, 1),
       (4, 2, 5, 7, 512, 1), (4, 2, 6, 6, 256, 1), (3, 2, 4, 7, 256, 2),
       (3, 2, 5, 6, 512, 1), (4, 1, 4, 7, 256, 2)]


def _stream_at(monkeypatch, P, R, levels, N, digit_bytes):
    """Lower a block's shared memory to the streamed split CTA's area with
    ``digit_bytes`` digits at this toy shape, so that the split's own
    choice (``pk.split_streams``, ``pk.split_digit_bytes``) streams with
    that store, as it does at N = 32768."""
    monkeypatch.setattr(pk, "_SMEM_LIMIT",
                        pk.split_area(P, R, levels, N, True, digit_bytes))
    assert pk.split_streams(P, R, levels, N)
    assert pk.split_digit_bytes(P, R, levels, N) == digit_bytes


@pytest.mark.parametrize("P,R,levels,base_log,N,digit_bytes", TOY)
def test_classic_stream_equals_the_plain_version(P, R, levels, base_log, N,
                                                 digit_bytes, monkeypatch):
    """Two CMUX steps of the streamed split (each level lifted into the
    one transform buffer, its passes and its last two stages with the
    products added into the R partials; the digits in int16 or int8)
    equal K3's plain version on the u64 accumulator."""
    rng = np.random.default_rng(100 * P + 10 * levels + N + digit_bytes)
    B, n = 2, 2
    key = _key(rng, n, levels, R, N, P)
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(B, n)))
    acc = _acc(rng, B, R, N)
    want = pk.blind_rotate_crt_plain(acc, mask, key, base_log, levels)
    _stream_at(monkeypatch, P, R, levels, N, digit_bytes)
    got = sp.cmux_steps_cluster("blind_rotate_crt", acc, mask, key,
                                base_log, levels, split=2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("P,R,levels,base_log,N,digit_bytes", TOY)
def test_multi_bit_stream_equals_the_plain_version(P, R, levels, base_log,
                                                   N, digit_bytes,
                                                   monkeypatch):
    """Two group steps of the streamed split (the digits of acc itself,
    the Barrett products against the bundle added into the partials a
    level at a time, the Garner value in acc's place) equal K5b's plain
    version."""
    rng = np.random.default_rng(9 + P + levels + N + digit_bytes)
    B, count = 2, 2
    plan = ntt.get_plan(N, P)
    bundles = torch.stack([torch.from_numpy(rng.integers(
        0, p, size=(B, count, levels * R, R, N))) for p in plan.primes],
        dim=2).to(torch.int32)
    acc = _acc(rng, B, R, N)
    want = pk.multi_bit_accumulate_plain(acc, bundles, base_log, levels)
    _stream_at(monkeypatch, P, R, levels, N, digit_bytes)
    got = sp.multi_bit_accumulate_cluster(acc, bundles, base_log, levels,
                                          split=2)
    assert torch.equal(got, want)


def test_int8_digits_hold_base_log_7_only(monkeypatch):
    """A balanced digit lies in [-2^(b-1), 2^(b-1)]: the int8 store holds
    b = 7 and not b = 8 (the mirror then differs from the plain version),
    so where the split's digits are int8 (N = 32768 at l >= 5) a shape
    with b = 8 is refused and stays on K7 global; at l = 4 the int16
    store takes b up to 15."""
    P, R, N, B, levels = 4, 2, 256, 2, 5
    assert pk.fits_cluster(P, R, 5, 32768, 8, 2, 7)
    assert not pk.fits_cluster(P, R, 5, 32768, 8, 2, 8)
    assert pk.wide_route(P, R, 5, 32768, 8, 8) == "global"
    assert pk.wide_route(P, R, 4, 32768, 8, 15) == "split"
    assert pk.wide_route(P, R, 4, 32768, 8, 16) == "global"
    rng = np.random.default_rng(8)
    key = _key(rng, 1, levels, R, N, P)
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(B, 1)))
    acc = _acc(rng, B, R, N)
    _stream_at(monkeypatch, P, R, levels, N, 1)
    for base_log, equal in ((7, True), (8, False)):
        want = pk.blind_rotate_crt_plain(acc, mask, key, base_log, levels)
        got = sp.cmux_steps_cluster("blind_rotate_crt", acc, mask, key,
                                    base_log, levels, split=2)
        assert torch.equal(got, want) == equal, base_log


def test_cta_area_and_its_twin():
    """The streamed split's CTA is [R + 1][N/2] u32 (the R partials and
    one transform) and the digits of its 2 S pairs' positions: at N =
    32768, R = 2, int16 229,376 B at l = 4, int8 217,088 B at l = 5 and
    221,184 B at l = 6, against the split's 294,912, 368,640 and 442,368 B
    holding all l transforms. The mirror's area and the dispatch's formula
    agree at every shape and split."""
    held = [pk.split_area(4, 2, lv, 32768) for lv in (4, 5, 6)]
    assert held == [294912, 368640, 442368]
    assert [pk.cluster_smem_formula(4, 2, lv, 32768, 8, 2)
            for lv in (4, 5, 6)] == [229376, 217088, 221184]
    assert [(pk.split_streams(4, 2, lv, 32768),
             pk.split_digit_bytes(4, 2, lv, 32768))
            for lv in (3, 4, 5, 6)] == [(False, 2), (True, 2), (True, 1),
                                        (True, 1)]
    for P in (2, 3, 4, 5):
        for R in (1, 2, 3, 4):
            for levels in range(2, 8):
                for N in (256, 4096, 16384, 32768):
                    for split in (1, 2):
                        assert sp.cluster_smem_bytes(
                            P, R, levels, N, 8, split) == \
                            pk.cluster_smem_formula(P, R, levels, N, 8,
                                                    split)


def _universe_wide_sets():
    """The universe's classic and multi-bit sets at N = 32768 with 4 to 6
    levels, the kind of each."""
    out = []
    for name, (kind, _) in reg.RAW_PARAMS.items():
        if kind not in ("ClassicPBSParameters", "KeySwitch32PBSParameters",
                        "MultiBitPBSParameters"):
            continue
        p = pm.PARAMS_BY_NAME[name]
        if p.polynomial_size == 32768 and p.pbs_level >= 4:
            out.append((kind == "MultiBitPBSParameters", p))
    return out


def test_dispatch_sends_the_13_sets_to_the_stream():
    """From the shape alone: the 13 tfhe-rs sets at N = 32768 with 4 to 6
    levels (2 classic at b = 9, l = 4; 11 multi-bit) go to the split,
    which streams them, with the digit store their b needs; K7 global
    keeps P R > 8, l = 1 at N = 32768, the acc32 entry at the streamed
    shapes and 2 primes there (which cannot hold an N = 32768 product).
    The split's shapes stay on it."""
    sets = _universe_wide_sets()
    kinds = sorted(mb for mb, _ in sets)
    assert (kinds.count(False), kinds.count(True)) == (2, 11)
    for _, p in sets:
        P, R, lv, bl = (num_primes_for(p), p.glwe_size, p.pbs_level,
                        p.pbs_base_log)
        assert pk.wide_route(P, R, lv, 32768, 8, bl) == "split", p.name
        assert pk.split_streams(P, R, lv, 32768)
        assert pk.split_digit_bytes(P, R, lv, 32768) == (2 if lv == 4
                                                         else 1)
        assert bl <= 8 * pk.split_digit_bytes(P, R, lv, 32768) - 1
        assert pk.wide_route(P, R, lv, 32768, 4) == "global"
    route = pk.wide_route
    assert route(4, 2, 1, 32768) == route(5, 2, 4, 32768) == "global"
    assert route(2, 2, 4, 32768) == "global"  # no stream at 2 primes
    assert route(4, 2, 3, 32768) == route(4, 2, 2, 32768) == "split"
    assert not pk.split_streams(4, 2, 3, 32768)
    meta = dict(device="meta", dtype=torch.int64)
    acc = torch.empty(4, 2, 32768, **meta)
    key = torch.empty(1, 2, 4, 8, 2, 32768, dtype=torch.int32,
                      device="meta")
    assert pk._wide_shape(acc, key, 4, 8, 9) == "split"
    assert pk._wide_shape(acc, key, 4, 4, 7) == "global"


def test_apply_lookup_table_through_the_stream_mirror(monkeypatch):
    """The port's ``apply_lookup_table`` at the 2_6 compact-PK 2M64 set (N
    = 32768, b = 9, l = 4: the streamed split's int16 store and the 64-bit
    decomposer; lwe_dimension cut to 4), its CRT steps forced through the
    streamed mirror (``pk.blind_rotate_crt`` replaced by it), on a
    ``tfhe_tpu`` server key carried across by ``convert``: bit-equal to
    ``tfhe_tpu``'s on its encryptions, decrypting to f(x)."""
    monkeypatch.delenv("TFHE_NTT_VARIANT", raising=False)
    monkeypatch.delenv("TFHE_V4_ACC", raising=False)

    def cut(pmod):
        return dataclasses.replace(pmod.PARAMS_BY_NAME[CPK_26],
                                   lwe_dimension=4, name=f"{CPK_26}_N4")

    jp, p = cut(jparams), cut(pm)
    assert (p.polynomial_size, p.pbs_base_log, p.pbs_level) == (32768, 9, 4)
    monkeypatch.setitem(pm.PARAMS_BY_NAME, p.name, p)
    jck = JClientKey.generate(jp, seed=26)
    jsk = JServerKey.generate(jck)
    sk = convert.server_key_from_arrays(p.name, np.asarray(jsk.ksk),
                                        np.asarray(jsk.bsk_scan),
                                        jsk.num_primes, device="cpu")
    assert sk.variant == "crt" and pk.wide_route(
        sk.num_primes, p.glwe_size, p.pbs_level, p.polynomial_size, 8,
        p.pbs_base_log) == "split" and pk.split_streams(
        sk.num_primes, p.glwe_size, p.pbs_level, p.polynomial_size)
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


def test_key_product_in_slices_equals_one_pass(monkeypatch):
    """Keygen's key product (``algorithms._binary_polymul_batch``) runs the
    masks in slices of ``NTT_KEY_CHUNK_ENTRIES`` (the bound on its
    temporaries that lets the 2_6 compact-PK 2M64 key, 8888 polynomials
    of N = 32768, be drawn beside other keys on an 80 GB card): slices of
    one polynomial and of three give the bits of one pass, and of
    ``tfhe_tpu``'s product."""
    from tfhe_tpu.core import algorithms as jalgo

    from tfhe_tpu_torch._torus import from_u64
    from tfhe_tpu_torch.core import algorithms as algo

    rng = np.random.default_rng(12)
    k, N = 2, 256
    bits = rng.integers(0, 2, size=(k, N), dtype=np.int64)
    masks = rng.integers(0, 1 << 64, size=(7, k, N), dtype=np.uint64)
    s_bits, a = torch.from_numpy(bits), from_u64(masks, "cpu")
    whole = algo._binary_polymul_batch(s_bits, a)
    for entries in (k * N, 3 * k * N):
        monkeypatch.setattr(algo, "NTT_KEY_CHUNK_ENTRIES", entries)
        assert torch.equal(algo._binary_polymul_batch(s_bits, a), whole)
    want = jalgo._binary_polymul_batch(bits.astype(np.uint64), masks)
    np.testing.assert_array_equal(to_u64(whole), np.asarray(want))
