"""The port's parameter classes, named sets and universe
(``tfhe_tpu_torch.utils.params``, ``params_registry``, ``params_universe``)
against tfhe_tpu's: every name of tfhe_tpu's ``UNIVERSE`` materializes in
the port to the same class and equal field values (nested sets, moduli,
distributions and drift parameters compared field by field), the
hand-written sets equal their JAX counterparts, ``PARAMS_BY_NAME`` falls
through to the universe with the constants first, the reference's v1.5 2_2
sets resolve to the variant tfhe_tpu resolves, and no set raises, the
multi-bit ones included. Tolerance: exact (the same constants)."""

import dataclasses
import enum

import numpy as np
import pytest

from tfhe_tpu.shortint.server_key import resolve_variant as jresolve
from tfhe_tpu.utils import params as jparams
from tfhe_tpu.utils import params_registry as jreg

from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch import convert
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.server_key import (ServerKey, check_supported,
                                                resolve_variant)
from tfhe_tpu_torch.utils import params
from tfhe_tpu_torch.utils import params_registry as reg
from tfhe_tpu_torch.utils import params_universe

V1_5_2_2 = ("PARAM_MESSAGE_2_CARRY_2_KS_PBS",
            "V1_5_PARAM_MESSAGE_2_CARRY_2_KS32_PBS_TUNIFORM_2M128",
            "V1_3_PARAM_MESSAGE_2_CARRY_2_KS32_PBS_TUNIFORM_2M128",
            "V1_5_PARAM_MESSAGE_2_CARRY_2_PBS_KS_GAUSSIAN_2M128")


def _plain(v):
    """A parameter object as plain data: class name and fields, nested."""
    if dataclasses.is_dataclass(v):
        return (type(v).__name__,
                {f.name: _plain(getattr(v, f.name))
                 for f in dataclasses.fields(v)})
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.value)
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    return v


def test_universe_is_a_verbatim_copy():
    assert params_universe.RAW_PARAMS == jreg.RAW_PARAMS
    assert reg.EXTRA_PARAMS == jreg.EXTRA_PARAMS
    assert len(reg.RAW_PARAMS) == len(jreg.RAW_PARAMS) > 600


def test_every_universe_name_materializes_equal():
    for name in jreg.RAW_PARAMS:
        got, want = reg.UNIVERSE[name], jreg.UNIVERSE[name]
        assert _plain(got) == _plain(want), name
        assert name in params.PARAMS_BY_NAME
    assert reg.all_names("KeySwitch32") == jreg.all_names("KeySwitch32")
    assert reg.UNIVERSE.names() == jreg.UNIVERSE.names()


def test_named_sets_equal():
    for name in ("PARAM_MESSAGE_2_CARRY_2_KS_PBS",
                 "PARAM_MESSAGE_1_CARRY_1_KS_PBS",
                 "PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM", "PARAM_TEST_TOY",
                 "PARAM_TEST_TOY_PBS_KS", "PARAM_TEST_TOY_KS32",
                 "PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS",
                 "PARAM_TEST_TOY_MULTI_BIT"):
        assert _plain(getattr(params, name)) == _plain(getattr(jparams, name))
        if name in jparams.PARAMS_BY_NAME:
            assert _plain(params.PARAMS_BY_NAME[name]) == \
                _plain(jparams.PARAMS_BY_NAME[name]), name
        # the port's registry also names the toy pattern sets, for convert
        assert params.PARAMS_BY_NAME[name] is getattr(params, name)


def test_params_by_name_falls_through_with_constants_first():
    """The constant PARAM_MESSAGE_2_CARRY_2_KS_PBS keeps its GAUSSIAN_2M128
    values (n = 866); the universe's alias of that name means TUNIFORM (n =
    918), as in tfhe_tpu (ROADMAP standing note 6)."""
    assert params.PARAMS_BY_NAME["PARAM_MESSAGE_2_CARRY_2_KS_PBS"] \
        .lwe_dimension == 866
    assert reg.UNIVERSE["PARAM_MESSAGE_2_CARRY_2_KS_PBS"].lwe_dimension == 918
    p = params.PARAMS_BY_NAME[
        "V1_5_PARAM_MESSAGE_2_CARRY_2_KS32_PBS_TUNIFORM_2M128"]
    assert isinstance(p, params.KeySwitch32PBSParameters)
    assert "NOT_A_PARAMETER_SET" not in params.PARAMS_BY_NAME
    with pytest.raises(KeyError):
        params.PARAMS_BY_NAME["NOT_A_PARAMETER_SET"]
    meta = params.PARAMS_BY_NAME["V1_5_META_PARAM_CPU_2_2_KS32_PBS_TUNIFORM_2M128"]
    assert isinstance(meta, params.MetaParameters)
    assert meta.compute_parameters == p


def test_v1_5_2_2_sets_resolve_as_tfhe_tpu(monkeypatch):
    monkeypatch.delenv("TFHE_NTT_VARIANT", raising=False)
    monkeypatch.delenv("TFHE_V4_ACC", raising=False)
    for name in V1_5_2_2:
        p, jp = params.PARAMS_BY_NAME[name], jparams.PARAMS_BY_NAME[name]
        got = resolve_variant(p.polynomial_size, p.pbs_base_log, p.pbs_level,
                              params=p)
        assert got == jresolve(jp.polynomial_size, jp.pbs_base_log,
                               jp.pbs_level, params=jp) == "v6b", name
        check_supported(p)


def test_every_set_is_supported():
    """No set of the universe raises: ``check_supported`` passes for every
    multi-bit and every other compute set, and each distinct multi-bit
    shape of the universe (grouping, k, l, base log) builds a server key at
    TOY size (``PARAM_TEST_TOY_MULTI_BIT`` with that shape, n = 2g) whose
    LUT round trip decrypts right (the plain K2 u64 -> K5)."""
    multi = [n for n, (k, _) in reg.RAW_PARAMS.items()
             if k == "MultiBitPBSParameters"]
    others = [n for n, (k, _) in reg.RAW_PARAMS.items()
              if k in ("ClassicPBSParameters", "KeySwitch32PBSParameters")]
    assert len(multi) == 253 and others
    for name in multi + ["PARAM_TEST_TOY_MULTI_BIT"] + others:
        check_supported(params.PARAMS_BY_NAME[name])
    shapes = sorted({(p.grouping_factor, p.glwe_dimension, p.pbs_level,
                      p.pbs_base_log)
                     for p in map(params.PARAMS_BY_NAME.__getitem__, multi)})
    assert {s[0] for s in shapes} == {2, 3, 4}
    vals = np.arange(16, dtype=np.uint64)
    for g, k, levels, base_log in shapes:
        p = dataclasses.replace(
            params.PARAM_TEST_TOY_MULTI_BIT, grouping_factor=g,
            lwe_dimension=2 * g, glwe_dimension=k, pbs_level=levels,
            pbs_base_log=base_log, name="PARAM_TEST_TOY_MULTI_BIT")
        ck = ClientKey.generate(p, seed=1, device="cpu")
        sk = ServerKey.generate(ck)
        assert tuple(sk.bsk_mb.shape) == (2, 2, sk.num_primes, (1 << g) - 1,
                                          levels * (k + 1), k + 1, 256)
        out = sk.apply_lookup_table(ck.encrypt(vals),
                                    sk.generate_lookup_table(
                                        lambda x: (x + 5) % 16))
        np.testing.assert_array_equal(ck.decrypt_message_and_carry(out),
                                      (vals + 5) % 16, err_msg=str(
                                          (g, k, levels, base_log)))
    bad = dataclasses.replace(params.PARAM_TEST_TOY_MULTI_BIT,
                              lwe_dimension=15)
    with pytest.raises(ValueError, match="divisible"):
        check_supported(bad)


#: kind -> (the universe's classes of that kind, sets refused on "cuda",
#: sets whose CRT steps run on K7 there: on its cluster kernel, on the
#: cluster kernel at split 2, on the split with its levels streamed, on K7
#: global)
ENVELOPE = {"classic": (("ClassicPBSParameters", "KeySwitch32PBSParameters"),
                        20, 48, 15, 2, 0),
            "multi_bit": (("MultiBitPBSParameters",), 8, 76, 45, 11, 0)}


@pytest.mark.parametrize("kind", list(ENVELOPE))
def test_sets_beyond_the_kernels_refused_on_the_gpu(kind, monkeypatch):
    """On a CUDA device ``check_supported`` refuses, naming ROADMAP R10
    and N = 65536 alone, the sets whose exact CRT steps no kernel holds:
    N = 65536 (one u32 polynomial beyond a block's shared memory, acc and
    digits beyond it too; nor has the CRT primes' transform a root of
    order 2N there, so no key can be drawn for them in either package:
    :func:`test_no_key_at_n_65536`), 20 classic and 8 multi-bit sets. The
    sets with
    base_log * levels >= 32 at N <= 32768 (12 classic, 11 multi-bit) pass:
    the kernels' 64-bit decomposer takes them. The sets whose acc and
    digits exceed a Hopper block's shared memory (the formula of K3's and
    K5b's ``_smem`` exports, ``step_passes.step_smem_bytes`` at 8-byte
    acc) but not N = 65536 run on K7: 65 classic sets on the crt variant
    (every 3_3 set, the 4_4 sets at N = 32768, the deep sets at N = 16384)
    and 132 multi-bit ones. Of them K7's cluster kernel takes those whose
    CTA fits a block (``step_passes.cluster_smem_bytes``,
    ``pbs_kernel.wide_route``): 48 classic (N <= 16384, l = 2) and 76
    multi-bit (N <= 8192, and N = 16384 at l = 2), both 3_3 GPU defaults
    among them; the cluster kernel at split 2 (a CTA of half the
    transforms, b <= 15) 15 classic and 45 multi-bit (N = 32768 at l <= 3,
    or N = 16384 at l = 3); the split with its levels streamed the l >= 4
    sets at N = 32768, 2 classic and 11 multi-bit (a split CTA holding all
    l transforms needs 294,912 B and more; streamed, at most 229,376 B);
    K7 global none. One v6b set more runs its many-LUT and OPRF on K7.
    Every set passes ``check_supported`` on the CPU (as in ``tfhe_tpu``,
    whose keygen raises at N = 65536 too). ``ServerKey.generate`` refuses
    before it draws a key (its client key here holds no key material at
    all)."""
    import types

    import torch

    from tfhe_tpu_torch.ops import pbs_kernel as pk
    from tfhe_tpu_torch.ops import step_passes as sp
    from tfhe_tpu_torch.shortint.server_key import num_primes_for

    monkeypatch.delenv("TFHE_NTT_VARIANT", raising=False)
    classes, n_refused, n_cluster, n_split, n_stream, n_global = \
        ENVELOPE[kind]
    sets = [params.PARAMS_BY_NAME[n] for n, (k, _) in reg.RAW_PARAMS.items()
            if k in classes]
    refused, wide, cluster, split, stream = [], [], [], [], []
    for p in sets:
        check_supported(p, "cpu")
        N, levels, base_log = p.polynomial_size, p.pbs_level, p.pbs_base_log
        smem = sp.step_smem_bytes(num_primes_for(p), p.glwe_size, levels,
                                  N, 8)
        if N == 65536:
            with pytest.raises(ValueError, match="R10") as e:
                check_supported(p, "cuda")
            assert "N = 65536" in str(e.value)
            assert "base_log" not in str(e.value)
            refused.append(p)
            continue
        check_supported(p, "cuda")
        variant = resolve_variant(N, base_log, levels, params=p)
        if smem > pk._SMEM_LIMIT and variant == "crt":
            assert N <= pk.WIDE_MAX_N
            wide.append(p)
            P, R = num_primes_for(p), p.glwe_size
            route = pk.wide_route(P, R, levels, N, 8, base_log)
            if sp.cluster_smem_bytes(P, R, levels, N, 8) <= pk._SMEM_LIMIT:
                assert route == "cluster"
                assert levels == 2 and N <= 16384 or N <= 8192
                cluster.append(p)
            elif not pk.split_streams(P, R, levels, N):
                assert route == "split" and base_log <= 15
                assert N == 32768 or (N == 16384 and levels == 3)
                split.append(p)
            elif sp.cluster_smem_bytes(P, R, levels, N, 8, split=2) \
                    <= pk._SMEM_LIMIT:
                assert route == "split"
                assert N == 32768 and levels >= 4
                assert base_log * levels >= 32 and P == pk.DEEP_PRIMES
                assert base_log <= (15 if levels == 4 else 7)
                stream.append(p)
            else:
                assert route == "global"
    assert len(refused) == n_refused
    assert (len(cluster), len(split), len(stream),
            len(wide) - len(cluster) - len(split) - len(stream)
            ) == (n_cluster, n_split, n_stream, n_global)
    assert all(pk.needs_wide(num_primes_for(p), p.glwe_size, p.pbs_level,
                             p.polynomial_size) for p in wide)
    names = {p.name for p in cluster}
    want = ("PARAM_MESSAGE_3_CARRY_3_KS_PBS_GAUSSIAN_2M128" if kind ==
            "classic" else
            "PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_3_CARRY_3_KS_PBS_"
            "GAUSSIAN_2M128")
    assert any(n.endswith(want) for n in names), want
    fake = types.SimpleNamespace(params=refused[0],
                                 device=torch.device("cuda"))
    with pytest.raises(ValueError, match="cannot run on the GPU"):
        ServerKey.generate(fake)


@pytest.mark.parametrize("name", [
    "V1_5_PARAM_MESSAGE_4_CARRY_4_KS_PBS_GAUSSIAN_2M128",
    "V1_5_PARAM_GPU_MULTI_BIT_GROUP_2_MESSAGE_4_CARRY_4_KS_PBS_GAUSSIAN_"
    "2M128"])
def test_no_key_at_n_65536(name):
    """Neither ``tfhe_tpu`` nor the port can draw a server key at N = 65536:
    the second CRT prime 0x3F5D0001 = 16221 * 2^16 + 1 has 2-adicity 16,
    so it has no root of order 2N = 2^17, and the negacyclic plan asserts
    while the key is drawn (``lwe_dimension`` cut to 4; one classic and
    one multi-bit set). On the CPU the port behaves as ``tfhe_tpu``:
    ``check_supported`` passes and keygen raises the same assertion."""
    from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
    from tfhe_tpu.shortint.server_key import ServerKey as JServerKey

    from tfhe_tpu_torch.ops import ntt

    assert ntt.PRIMES32[1] == 0x3F5D0001 == 16221 * 2 ** 16 + 1
    jp = dataclasses.replace(jparams.PARAMS_BY_NAME[name], lwe_dimension=4)
    p = dataclasses.replace(params.PARAMS_BY_NAME[name], lwe_dimension=4)
    assert p.polynomial_size == jp.polynomial_size == 65536
    check_supported(p, "cpu")
    with pytest.raises(AssertionError) as je:
        JServerKey.generate(JClientKey.generate(jp, seed=5))
    with pytest.raises(AssertionError) as te:
        ServerKey.generate(ClientKey.generate(p, seed=5, device="cpu"))
    assert str(je.value) == str(te.value) == str((0x3F5D0001, 2 * 65536))


def test_universe_name_carried_into_client_key():
    """A universe name carries secret-key bits into a port ClientKey that
    decrypts with that set's parameters."""
    name = "V1_5_PARAM_MESSAGE_2_CARRY_2_PBS_KS_GAUSSIAN_2M128"
    p = params.PARAMS_BY_NAME[name]
    rng = np.random.default_rng(4)
    glwe = rng.integers(0, 2, size=(p.glwe_dimension, p.polynomial_size),
                        dtype=np.uint64)
    lwe = rng.integers(0, 2, size=p.lwe_dimension, dtype=np.uint64)
    ck = convert.client_key_from_arrays(name, glwe, lwe, device="cpu")
    assert ck.params is p and ck.params.encryption_key_choice == \
        params.EncryptionKeyChoice.SMALL
    back = convert.client_key_to_arrays(ck)
    assert back[0] == name
    np.testing.assert_array_equal(back[1], glwe)
    np.testing.assert_array_equal(back[2], lwe)
