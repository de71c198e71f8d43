"""The port's drift-technique modulus switching (``ops/server.py``:
``_ms_round_error_f64``, ``choose_drift_candidate``, ``improve_drift_ms``)
against tfhe_tpu's, and the drift parameter sets end to end, on the CPU:

- the candidate choice against the JAX function and the numpy oracle of the
  reference's sequential scan of tests/test_drift_ms.py, at 32 and 64
  bits, with bounds that take the early exit, the full argmin and the
  first candidate (exact: at 32 bits every summand is an integer below
  2^53; the 64-bit cases compare the chosen indices);
- a classic 64-bit set and a KS32 set with the drift technique at the toy
  geometry: the encryptions of zero byte-equal (lwe_encrypt32 under KS32,
  drawn after the KSK), a LUT round trip and a chained second PBS
  bit-equal to tfhe_tpu (plain K2 acc32 -> plain K1), the drift
  improvement choosing a zero for some ciphertexts, and the keys carried
  both ways with their zeros;
- the registered v1_3 KS32 drift set in the port's universe."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from tfhe_tpu.ops import server as jserver
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils import params as jparams

from test_drift_ms import _oracle_choose
from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import from_u64, to_u64
from tfhe_tpu_torch.ops import server
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.server_key import ServerKey
from tfhe_tpu_torch.utils import params
from tfhe_tpu_torch.utils.params_registry import UNIVERSE

rng = np.random.default_rng(0xD21F7)


@pytest.mark.parametrize("torus_bits", [64, 32])
def test_round_error_equal(torus_bits):
    x = rng.integers(0, 1 << 64, size=(5, 33), dtype=np.uint64)
    if torus_bits == 32:
        x[0] &= np.uint64(0xFFFFFFFF)
    want = np.asarray(jserver._ms_round_error_f64(jnp.asarray(x), 8,
                                                  torus_bits))
    got = server._ms_round_error_f64(from_u64(x, "cpu"), 8, torus_bits)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("torus_bits", [64, 32])
def test_choose_candidate_matches_jax_and_oracle(torus_bits):
    n, Z, B, log_mod = 24, 37, 16, 8
    lim = 1 << torus_bits
    ct = rng.integers(0, lim, size=(B, n + 1), dtype=np.uint64)
    zeros = rng.integers(0, lim, size=(Z, n + 1), dtype=np.uint64)
    r_sigma = 3.5
    input_variance = 2.0 ** (-2 * (torus_bits - 10))
    mid = 2.0 ** (torus_bits - log_mod - 1) * np.sqrt(n) * 0.9
    for bound in (0.0, mid, np.inf):
        want = np.asarray(jserver.choose_drift_candidate(
            jnp.asarray(ct), jnp.asarray(zeros), r_sigma, float(bound),
            input_variance, log_mod, torus_bits=torus_bits, chunk=8))
        got = server.choose_drift_candidate(
            from_u64(ct, "cpu"), from_u64(zeros, "cpu"), r_sigma,
            float(bound), input_variance, log_mod, torus_bits=torus_bits,
            chunk=8).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"bound={bound}")
        oracle = [_oracle_choose(ct[b], zeros, r_sigma, bound,
                                 input_variance, log_mod, torus_bits)
                  for b in range(B)]
        np.testing.assert_array_equal(got, oracle)
        # the full scan (bound 0) picks zeros; no bound keeps every input
        assert (got.max() > 0) if bound == 0.0 else True
        assert (got.max() == 0) if bound == np.inf else True


def test_improve_equal_and_batched():
    """improve_drift_ms on a [2, 4, n+1] batch equals the JAX function and
    the flat batch's rows, at 32 bits with a bound that picks zeros."""
    n, Z = 20, 9
    ct = rng.integers(0, 1 << 32, size=(2, 4, n + 1), dtype=np.uint64)
    zeros = rng.integers(0, 1 << 32, size=(Z, n + 1), dtype=np.uint64)
    args = (3.0, 2.0 ** 22, 2.0 ** -40, 9)
    want = np.asarray(jserver.improve_drift_ms(
        jnp.asarray(ct), jnp.asarray(zeros), *args, torus_bits=32))
    got = server.improve_drift_ms(from_u64(ct, "cpu"), from_u64(zeros, "cpu"),
                                  *args, torus_bits=32)
    np.testing.assert_array_equal(to_u64(got), want)
    flat = server.improve_drift_ms(from_u64(ct.reshape(8, n + 1), "cpu"),
                                   from_u64(zeros, "cpu"), *args,
                                   torus_bits=32)
    np.testing.assert_array_equal(to_u64(flat), want.reshape(8, n + 1))
    assert not np.array_equal(want, ct)


def _drift(base, mod, bound, variance):
    return dataclasses.replace(
        base,
        modulus_switch_type=mod.ModulusSwitchType
        .DRIFT_TECHNIQUE_NOISE_REDUCTION,
        modulus_switch_noise_reduction_params=mod
        .ModulusSwitchNoiseReductionParams(
            modulus_switch_zeros_count=16, ms_bound=bound,
            ms_r_sigma_factor=3.0, ms_input_variance=variance),
        name=base.name + "_DRIFT")


#: (base set, bound, input variance): tests/test_drift_ms.py's classic toy
#: drift set, and a KS32 one whose bound lets the technique choose zeros
SETS = {"classic": ("PARAM_TEST_TOY", 2.0 ** 57, 2.0 ** -80),
        "ks32": ("PARAM_TEST_TOY_KS32", 2.0 ** 24, 2.0 ** -44)}


@pytest.mark.parametrize("kind", list(SETS))
def test_drift_set_round_trip_bit_equal(kind, monkeypatch):
    base, bound, var = SETS[kind]
    jp = _drift(getattr(jparams, base), jparams, bound, var)
    p = _drift(getattr(params, base), params, bound, var)
    jck = JClientKey.generate(jp, seed=5)
    jsk = JServerKey.generate(jck)
    ck = ClientKey.generate(p, seed=5, device="cpu")
    sk = ServerKey.generate(ck)
    assert sk.drift is not None and jsk._drift is not None
    np.testing.assert_array_equal(to_u64(sk.ms_zeros),
                                  np.asarray(jsk.ms_zeros))
    assert tuple(sk.ms_zeros.shape) == (16, p.lwe_dimension + 1)
    np.testing.assert_array_equal(to_u64(sk.ksk), np.asarray(jsk.ksk))
    msgs = np.arange(16) % 4
    jct, ct = jck.encrypt(msgs), ck.encrypt(msgs)
    f = lambda x: (3 * x + 2) % 4
    lut = sk.generate_lookup_table(f)
    jout = jsk.apply_lookup_table(jct, jsk.generate_lookup_table(f))
    out = sk.apply_lookup_table(ct, lut)
    np.testing.assert_array_equal(to_u64(out.ct), np.asarray(jout.ct))
    got = ck.decrypt(out)
    np.testing.assert_array_equal(got, [f(int(m)) for m in msgs])
    jout2 = jsk.apply_lookup_table(jout, jsk.generate_lookup_table(f))
    out2 = sk.apply_lookup_table(out, lut)
    np.testing.assert_array_equal(to_u64(out2.ct), np.asarray(jout2.ct))
    np.testing.assert_array_equal(ck.decrypt(out2), [f(int(g)) for g in got])
    if kind == "ks32":
        small = sk.ks_only(ct.ct)
        r_sigma, b, v = sk.drift
        idx = server.choose_drift_candidate(small, sk.ms_zeros, r_sigma, b,
                                            v, 9, torus_bits=32)
        assert 0 < int((idx > 0).sum()) < 16, idx
    # the key carried in with its zeros, and back out
    monkeypatch.setitem(params.PARAMS_BY_NAME, p.name, p)
    carried = convert.server_key_from_arrays(
        p.name, np.asarray(jsk.ksk), np.asarray(jsk.bsk_scan),
        jsk.num_primes, device="cpu", ms_zeros_u64=np.asarray(jsk.ms_zeros))
    out3 = carried.apply_lookup_table(ct, lut)
    np.testing.assert_array_equal(to_u64(out3.ct), to_u64(out.ct))
    *_, zeros = convert.server_key_to_arrays(carried)
    np.testing.assert_array_equal(zeros, np.asarray(jsk.ms_zeros))


def test_v1_3_drift_set_materializes():
    p = UNIVERSE["V1_3_PARAM_MESSAGE_2_CARRY_2_KS32_PBS_TUNIFORM_2M128"]
    assert isinstance(p, params.KeySwitch32PBSParameters)
    assert (p.modulus_switch_type
            == params.ModulusSwitchType.DRIFT_TECHNIQUE_NOISE_REDUCTION)
    d = p.modulus_switch_noise_reduction_params
    assert d.modulus_switch_zeros_count == 1449
    assert d.ms_bound == 67108864.0
    assert p.post_keyswitch_ciphertext_modulus.bits == 32
    assert params.PARAMS_BY_NAME[p.name] == p
