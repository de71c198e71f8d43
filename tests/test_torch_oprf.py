"""The port's oblivious PRF (``tfhe_tpu_torch.shortint.oprf``) against
``tfhe_tpu.shortint.oprf`` at PARAM_TEST_TOY, on the CPU (the kernels'
plain versions): the XOF and the seeded LWE, then the staircase PBS on the
exact CRT key, with ``TFHE_V4_ACC`` unset (plain K2 u64 -> plain K3, held
against the JAX function on the CPU), under ``TFHE_V4_ACC=32`` (plain K2
acc32 -> plain K3-acc32, held against ``programmable_bootstrap_pallas`` in
interpret mode, the JAX function's TPU path) and under
``TFHE_NTT_VARIANT=v5`` (plain K2 u64 -> plain K4). Tolerance: exact.
Also: the range, determinism and a uniformity check of the values, and the
batch of seeds equal to the single-seed calls. The integer OPRF is held
against its JAX per-block loop in ``test_torch_integer_extra.py``."""

import numpy as np
import pytest

import jax.numpy as jnp

from tfhe_tpu.ops import ntt as jntt
from tfhe_tpu.ops import server as jserver
from tfhe_tpu.shortint import oprf as joprf
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils.params import PARAM_TEST_TOY as JP

from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch._torus import to_u64
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.shortint import oprf
from tfhe_tpu_torch.shortint.ciphertext import ShortintCiphertext
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.server_key import ServerKey
from tfhe_tpu_torch.utils.params import PARAM_TEST_TOY as P

SEED = 61  # tests/test_oprf.py's key seed


def _keys():
    jck = JClientKey.generate(JP, seed=SEED)
    ck = ClientKey.generate(P, seed=SEED, device="cpu")
    return jck, JServerKey.generate(jck), ck, ServerKey.generate(ck)


@pytest.fixture(scope="module")
def keys():
    return _keys()


def test_xof_and_seeded_lwe_equal():
    for seed in (0, 1234, (1 << 64) - 1):
        np.testing.assert_array_equal(oprf.sha3_hash_u64(seed, 9),
                                      joprf.sha3_hash_u64(seed, 9))
        np.testing.assert_array_equal(
            oprf.create_random_from_seed(seed, 16),
            joprf.create_random_from_seed(seed, 16))
    assert not np.array_equal(oprf.sha3_hash_u64(1234, 8),
                              oprf.sha3_hash_u64(1235, 8))


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_oprf_bit_equal(keys, bits):
    jck, jsk, ck, sk = keys
    want = joprf.generate_oblivious_pseudo_random(jsk, seed=7,
                                                  random_bits_count=bits)
    pk.reset_launches()
    got = oprf.generate_oblivious_pseudo_random(sk, seed=7,
                                                random_bits_count=bits)
    np.testing.assert_array_equal(to_u64(got.ct), np.asarray(want.ct))
    assert (got.degree, got.noise_level, got.under_key) == (
        want.degree, want.noise_level, want.under_key)
    assert not any(fn.launches for fn in pk.KERNELS)
    value = int(ck.decrypt_message_and_carry(got)[0])
    assert 0 <= value < 1 << bits
    again = oprf.generate_oblivious_pseudo_random(sk, seed=7,
                                                  random_bits_count=bits)
    assert int(ck.decrypt_message_and_carry(again)[0]) == value


def test_oprf_rejects_too_many_bits(keys):
    with pytest.raises(ValueError, match="do not fit"):
        oprf.generate_oblivious_pseudo_random(keys[3], 1, 5)


def test_batch_equals_single_seeds_and_is_uniform(keys):
    """48 seeds in one batched PBS: each row equals its single-seed call
    (three spot rows), and the 2-bit values are spread: every bucket hit,
    none above half (tests/test_oprf.py's check)."""
    _, _, ck, sk = keys
    seeds = list(range(100, 148))
    out = oprf.oblivious_pseudo_random_batch(sk, seeds, [2] * len(seeds))
    for i in (0, 17, 47):
        one = oprf.generate_oblivious_pseudo_random(sk, seeds[i], 2)
        np.testing.assert_array_equal(to_u64(out[i]), to_u64(one.ct))
    vals = ck.decrypt_message_and_carry(ShortintCiphertext(
        ct=out, degree=3, noise_level=1, message_modulus=4, carry_modulus=4))
    counts = np.bincount(vals.astype(np.int64), minlength=4)
    assert counts.sum() == 48 and len(counts) == 4
    assert counts.min() >= 3 and counts.max() <= 24, counts


def test_oprf_acc32_matches_pallas_interpret(keys, monkeypatch):
    """TFHE_V4_ACC=32: plain K2 acc32 -> plain K3-acc32 against
    programmable_bootstrap_pallas in interpret mode on bsk_scan (the TPU
    branch of tfhe_tpu's OPRF), then the same plaintext add."""
    monkeypatch.setenv("TFHE_V4_ACC", "32")
    monkeypatch.delenv("TFHE_NTT_VARIANT", raising=False)
    jck, jsk, ck, sk = keys
    p = JP
    bits, seed = 3, 11
    full_bits = int(np.log2(p.message_modulus * p.carry_modulus)) + 1
    delta = 1 << (64 - full_bits)
    acc = oprf.staircase_accumulator(P, bits)
    ct = joprf.create_random_from_seed(seed, p.lwe_dimension)
    want = np.asarray(jserver.programmable_bootstrap_pallas(
        jnp.asarray(ct)[None], jnp.asarray(acc), jsk.bsk_scan,
        p.pbs_base_log, p.pbs_level,
        jntt.get_plan(p.polynomial_size, jsk.num_primes),
        centered_ms=False, batch_tile=1))[0].copy()
    want[-1] += np.uint64(((1 << bits) - 1) * delta // 2)
    got = oprf.generate_oblivious_pseudo_random(sk, seed, bits)
    np.testing.assert_array_equal(to_u64(got.ct), want)
    assert 0 <= int(ck.decrypt_message_and_carry(got)[0]) < 1 << bits


@pytest.fixture(scope="module")
def v5_keys():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TFHE_NTT_VARIANT", "v5")
        return _keys()


@pytest.mark.parametrize("bits", [2, 4])
def test_oprf_v5_bit_equal(v5_keys, bits, monkeypatch):
    """TFHE_NTT_VARIANT=v5: plain K2 u64 -> plain K4 on the Goldilocks key
    against the JAX function's v5 branch (its oracle on the CPU)."""
    monkeypatch.setenv("TFHE_NTT_VARIANT", "v5")
    _, jsk, ck, sk = v5_keys
    assert sk.variant == jsk.ntt_variant == "v5"
    want = joprf.generate_oblivious_pseudo_random(jsk, 5, bits)
    got = oprf.generate_oblivious_pseudo_random(sk, 5, bits)
    np.testing.assert_array_equal(to_u64(got.ct), np.asarray(want.ct))
    assert 0 <= int(ck.decrypt_message_and_carry(got)[0]) < 1 << bits
