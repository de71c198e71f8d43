"""The 64-bit gadget decomposer of the CRT step kernels (``csrc/
ntt_common.cuh``: ``Decomposer64``, run by the ``GarnerTailDeep<4>``
instantiations of K3, K5b and K7's designs at base_log * levels >= 32,
where the rounding bit 63 - b l and the low bits of the state lie in the
lo word), on the CPU:

- its formula in the mirror (``step_passes.deep_digits``) and the port's
  plain decomposer (``ops/decomp.py``), bit-exact against
  ``tfhe_tpu.ops.decomp.decompose`` on seeded u64 values, the edges and
  values on each side of the rounding bit, at b l = 32 .. 36, with two
  b l <= 31 controls where the hi word's formula (``hi_digits``) agrees;
- the mirror's K3 lift, K7 global's stages and the cluster kernel at
  split 1 and 2 at b l >= 32 against the plain versions;
- the envelope: which entries take b l >= 32, the routes by shape (the
  split only at b <= 15), ``crt_refusal`` and ``check_supported``;
- the port's ``apply_lookup_table`` at a toy classic set (b = 8, l = 4)
  and a toy multi-bit set (g = 2, b = 8, l = 4), its CRT steps through
  the plain versions and through the mirror, bit-equal to ``tfhe_tpu``'s
  ``ServerKey`` on the CPU (its jnp path), decrypting to f(x).

Tolerance: exact (integer arithmetic, the same seeded inputs)."""

import dataclasses

import numpy as np
import pytest
import torch

from tfhe_tpu.ops import decomp as jdecomp
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils import params as jparams

from test_torch_strings import one_torch_thread  # noqa: F401
from test_torch_wide_split import _acc, _key
from test_torch_wide_step import _carry_in

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import from_u64, srl, to_u64
from tfhe_tpu_torch.ops import decomp
from tfhe_tpu_torch.ops import ntt
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.ops import server
from tfhe_tpu_torch.ops import step_passes as sp
from tfhe_tpu_torch.utils import params as pm

#: (base_log, levels) at b l >= 32, and the b l <= 31 controls
DEEP = [(8, 4), (9, 4), (11, 3), (7, 5), (6, 6)]
CONTROLS = [(15, 2), (11, 2)]
P = 4


def _values(base_log, levels):
    """Seeded u64 values, the edges 0, 2^63, 2^64 - 1, and the values on
    each side of the rounding bit (63 - b l) and of the lowest kept bit."""
    rng = np.random.default_rng(base_log * 100 + levels)
    r = 63 - base_log * levels
    edges = [0, 1 << 63, (1 << 64) - 1]
    for bit in (r, r + 1):
        for v in (1 << bit, 3 << bit, (1 << 64) - (1 << bit)):
            edges += [(v - 1) % (1 << 64), v % (1 << 64), (v + 1) % (1 << 64)]
    return np.concatenate([rng.integers(0, 1 << 64, 4096, dtype=np.uint64),
                           np.array(edges, dtype=np.uint64)])


@pytest.mark.parametrize("base_log,levels", DEEP + CONTROLS)
def test_digits_equal_tfhe_tpu(base_log, levels):
    """``deep_digits`` (``brk::Decomposer64``'s formula, the state in 64
    bits) and ``ops/decomp.py::decompose`` equal ``tfhe_tpu``'s
    ``decompose`` bit for bit, level ``levels`` first, every digit in
    [-2^(b-1), 2^(b-1)]; at b l <= 31 so does the hi word's formula."""
    x = _values(base_log, levels)
    want = np.asarray(jdecomp.decompose(x, base_log, levels)).astype(np.int64)
    t = from_u64(x, "cpu")
    mirror = torch.stack(sp.deep_digits(t, base_log, levels), -1).numpy()
    np.testing.assert_array_equal(mirror, want)
    np.testing.assert_array_equal(
        decomp.decompose(t, base_log, levels).numpy(), want)
    assert np.abs(want).max() <= 1 << (base_log - 1)
    lift = torch.stack(sp.lift_digits(t, base_log, levels, False), -1)
    np.testing.assert_array_equal(lift.numpy(), want)
    if base_log * levels <= pk.HI_WORD_MAX_BL:
        hi = torch.stack(sp.hi_digits(srl(t, 32), base_log, levels), -1)
        np.testing.assert_array_equal(hi.numpy(), want)
    else:
        with pytest.raises(ValueError, match="hi word"):
            sp.lift_digits(t, base_log, levels, True)


#: (N, levels, base_log) of the mirror's deep shapes
MIRROR = [(256, 4, 8), (512, 3, 11), (256, 5, 7)]


@pytest.mark.parametrize("N,levels,base_log", MIRROR)
@pytest.mark.parametrize("design", ["passes", "wide", "cluster", "split"])
def test_classic_mirror_equals_the_plain_version(design, N, levels,
                                                 base_log):
    """Two CMUX steps of K3's passes (the lift fused into the first
    forward pass), K7 global's stages and the cluster kernel at split 1
    and 2, each lift on the 64-bit decomposer, equal K3's plain version on
    seeded u64 accumulators, masks and keys."""
    rng = np.random.default_rng(N + levels + len(design))
    B, n, R = 2, 2, 2
    key = _key(rng, n, levels, R, N, P)
    mask = torch.from_numpy(rng.integers(0, 2 * N, size=(B, n)))
    acc = _acc(rng, B, R, N)
    args = ("blind_rotate_crt", acc, mask, key, base_log, levels)
    got = {"passes": lambda: sp.cmux_steps_passes(*args),
           "wide": lambda: sp.cmux_steps_wide(*args),
           "cluster": lambda: sp.cmux_steps_cluster(*args),
           "split": lambda: sp.cmux_steps_cluster(*args, split=2)}[design]()
    assert torch.equal(got, pk.blind_rotate_crt_plain(acc, mask, key,
                                                      base_log, levels))


@pytest.mark.parametrize("N,levels,base_log", MIRROR)
@pytest.mark.parametrize("design", ["wide", "cluster", "split"])
def test_multi_bit_mirror_equals_the_plain_version(design, N, levels,
                                                   base_log):
    """Two group steps of K7 global's and the cluster kernel's multi-bit
    entries (the digits of acc itself on the 64-bit decomposer) equal
    K5b's plain version on seeded bundles."""
    rng = np.random.default_rng(7 * N + levels + len(design))
    B, count, R = 2, 2, 2
    plan = ntt.get_plan(N, P)
    bundles = torch.stack([torch.from_numpy(rng.integers(
        0, p, size=(B, count, levels * R, R, N))) for p in plan.primes],
        dim=2).to(torch.int32)
    acc = _acc(rng, B, R, N)
    args = (acc, bundles, base_log, levels)
    got = {"wide": lambda: sp.multi_bit_accumulate_wide(*args),
           "cluster": lambda: sp.multi_bit_accumulate_cluster(*args),
           "split": lambda: sp.multi_bit_accumulate_cluster(
               *args, split=2)}[design]()
    assert torch.equal(got, pk.multi_bit_accumulate_plain(*args))


def test_envelope_and_routes():
    """The u64 entries (K3's Garner entry, K5b, K7's designs behind them)
    take b l 32..63 at 4 primes; K3-acc32, K3-bnf2, K1 and r14 keep b l <=
    31. The split holds b <= 15 (its int16 digits): the 5 classic sets at
    N = 16384 and 5 at N = 32768 with b = 11, l = 3 route there, the l >= 4
    sets at N = 32768 to the split with its levels streamed (a split CTA
    holding all l transforms needs 294,912 B and more; streamed, 229,376 B
    at l = 4 and, with int8 digits, 221,184 B at l = 6).
    ``crt_refusal`` keeps only N > 32768 beyond a block and b l >= 64."""
    assert pk.decomposer_refusal("blind_rotate_crt", P, 11, 3) is None
    assert pk.decomposer_refusal("multi_bit_accumulate", P, 6, 6) is None
    assert pk.decomposer_refusal("blind_rotate_crt", P, 21, 3) is None
    for entry in ("blind_rotate_crt_acc32", "blind_rotate_bnf2_u64",
                  "blind_rotate_bnf2_acc32", "blind_rotate_multi_bit_r14",
                  "blind_rotate_wide_split_acc32"):
        assert pk.decomposer_refusal(entry, P, 15, 2) is None
        assert "hi word" in pk.decomposer_refusal(entry, P, 11, 3)
    assert "P = 4" in pk.decomposer_refusal("blind_rotate_crt", 3, 8, 4)
    assert "<= 63" in pk.decomposer_refusal("blind_rotate_crt", P, 16, 4)
    assert pk.crt_refusal(P, 2, 3, 11, 16384) is None
    assert pk.crt_refusal(P, 2, 4, 9, 32768) is None
    assert pk.multi_bit_refusal(P, 4, 2, 4, 8, 32768) is None
    assert pk.multi_bit_refusal(P, 2, 2, 6, 6, 32768) is None
    assert "N = 65536" in pk.crt_refusal(P, 2, 4, 8, 65536)
    assert "<= 63" in pk.crt_refusal(P, 2, 4, 16, 8192)
    route = pk.wide_route
    assert route(P, 2, 3, 16384, 8, 11) == route(P, 2, 3, 32768, 8, 11) \
        == "split"
    assert route(P, 2, 4, 32768, 8, 9) == route(P, 2, 5, 32768, 8, 7) \
        == route(P, 2, 6, 32768, 8, 6) == "split"
    assert all(pk.split_streams(P, 2, lv, 32768) for lv in (4, 5, 6))
    assert pk.split_area(P, 2, 4, 32768) == 294912
    assert pk.split_area(P, 2, 6, 32768) == 442368
    assert sp.cluster_smem_bytes(P, 2, 4, 32768, 8, split=2) == 229376
    assert sp.cluster_smem_bytes(P, 2, 6, 32768, 8, split=2) == 221184
    assert route(P, 2, 2, 32768, 8, 15) == "split"
    assert route(P, 2, 2, 32768, 8, 16) == "global"
    assert not pk.fits_cluster(P, 2, 2, 32768, 8, 2, 16)
    assert route(P, 2, 4, 8192, 8, 8) == "cluster"
    assert route(P, 2, 3, 2048, 8, 11) is None
    assert route(P, 2, 4, 1024, 8, 8) is None
    meta = dict(device="meta", dtype=torch.int64)
    acc = torch.empty(4, 2, 32768, **meta)
    key = torch.empty(1, 2, P, 4, 2, 32768, dtype=torch.int32, device="meta")
    assert pk._wide_shape(acc, key, 2, 8, 16) == "global"
    assert pk._wide_shape(acc, key, 2, 8, 15) == "split"


def _toy(pmod, base, name, **fields):
    return dataclasses.replace(base(pmod), name=name, pbs_base_log=8,
                               pbs_level=4, **fields)


@pytest.mark.parametrize("through", ["plain", "mirror"])
@pytest.mark.parametrize("kind", ["classic", "multi_bit"])
def test_apply_lookup_table_equal_at_b8_l4(kind, through, monkeypatch):
    """The port's ``apply_lookup_table`` at a toy set with base_log = 8,
    levels = 4 (classic; multi-bit at g = 2), on a ``tfhe_tpu`` server key
    carried across by ``convert``, its CRT steps on the plain versions
    (what K3 and K5b compute on the card) or forced through the mirror
    (K3's passes; K7 global's multi-bit stages), bit-equal to ``tfhe_tpu``'s
    jnp path on its encryptions, decrypting to f(x)."""
    monkeypatch.delenv("TFHE_NTT_VARIANT", raising=False)
    monkeypatch.delenv("TFHE_V4_ACC", raising=False)
    if kind == "classic":
        base, extra = (lambda m: m.PARAM_TEST_TOY), {}
    else:
        base, extra = (lambda m: m.PARAM_TEST_TOY_MULTI_BIT), {
            "grouping_factor": 2}
    name = f"PARAM_TEST_TOY_{kind.upper()}_B8_L4"
    jp, p = _toy(jparams, base, name, **extra), _toy(pm, base, name, **extra)
    monkeypatch.setitem(pm.PARAMS_BY_NAME, p.name, p)
    jck = JClientKey.generate(jp, seed=24)
    jsk = JServerKey.generate(jck)
    sk = convert.server_key_from_arrays(p.name, np.asarray(jsk.ksk),
                                        np.asarray(jsk.bsk_scan),
                                        jsk.num_primes, device="cpu")
    assert p.pbs_base_log * p.pbs_level == 32
    calls = []
    if through == "mirror":
        def classic(acc, mask, key, base_log, levels):
            calls.append(acc.shape)
            return sp.cmux_steps_passes("blind_rotate_crt", acc, mask, key,
                                        base_log, levels)

        def multi_bit(acc, bundles, base_log, levels, plan):
            calls.append(acc.shape)
            return sp.multi_bit_accumulate_wide(acc, bundles, base_log,
                                                levels)

        monkeypatch.setattr(pk, "blind_rotate_crt", classic)
        monkeypatch.setattr(server, "multi_bit_accumulate_plain", multi_bit)
    mod = p.message_modulus * p.carry_modulus
    f = lambda x: (7 * x + 5) % mod  # noqa: E731
    values = np.array([0, 3, 9, 14], dtype=np.uint64)
    jct = jck.encrypt(values)
    want = jsk.apply_lookup_table(jct, jsk.generate_lookup_table(f))
    got = sk.apply_lookup_table(_carry_in(jct), sk.generate_lookup_table(f))
    assert bool(calls) == (through == "mirror")
    np.testing.assert_array_equal(to_u64(got.ct), np.asarray(want.ct))
    np.testing.assert_array_equal(jck.decrypt_message_and_carry(want),
                                  [f(int(x)) for x in values])
    assert got.degree == want.degree
