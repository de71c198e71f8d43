"""The port's FHE Trivium against apps/trivium.py and the clear cipher, at
BOOLEAN_TEST_TOY on the CPU (the kernels' plain versions). The FHE streams
start from a clear-warmed, then encrypted state (the 1152-round FHE warm-up
runs on the GPU in chip_smoke.py); one test runs a full-FHE 64-round step
from the unwarmed state. The 128-bit keystream from a warmed state is
``test_torch_trivium_keystream.py``, so that it does not share a worker
with this file's tests. Tolerance: exact (same keys and inputs => the same
ciphertext bits as tfhe_tpu)."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from apps import trivium as jtriv
from tfhe_tpu.boolean.keys import ClientKey as JClientKey
from tfhe_tpu.boolean.keys import ServerKey as JServerKey
from tfhe_tpu.utils.params import BOOLEAN_TEST_TOY as JP

from test_torch_strings import one_torch_thread  # noqa: F401  (autouse)

from tfhe_tpu_torch import boolean
from tfhe_tpu_torch._torus import to_u64
from tfhe_tpu_torch.apps.trivium import (ClearTrivium, TriviumStream,
                                         transcipher_decrypt)
from tfhe_tpu_torch.utils.params import BOOLEAN_TEST_TOY as P

KEY = [(i * 7 + 3) % 2 for i in range(80)]
IV = [(i * 5 + 1) % 2 for i in range(80)]
SEED = 41


@pytest.fixture(scope="module")
def keys():
    jck = JClientKey.generate(JP, seed=SEED)
    jsk = JServerKey.generate(jck)
    ck = boolean.ClientKey.generate(P, seed=SEED, device="cpu")
    sk = boolean.ServerKey.generate(ck)
    return jck, jsk, ck, sk


def test_clear_trivium_matches_jax():
    for warm in (False, True):
        got, want = ClearTrivium(KEY, IV, warm), jtriv.ClearTrivium(KEY, IV,
                                                                    warm)
        assert got.s == want.s
        assert got.next_bits(300) == want.next_bits(300)


def test_one_step_from_initial_state_bit_equal(keys):
    jck, jsk, ck, sk = keys
    clear = ClearTrivium(KEY, IV, warmup=False)
    jstream = jtriv.TriviumStream.new(jsk, jck.encrypt(np.array(KEY, bool)),
                                      IV, warmed_up=False)
    stream = TriviumStream.new(sk, ck.encrypt(np.array(KEY, bool)), IV,
                               warmed_up=False)
    np.testing.assert_array_equal(to_u64(stream.state.ct),
                                  np.asarray(jstream.state.ct))
    z = stream.next_64()
    np.testing.assert_array_equal(to_u64(z.ct),
                                  np.asarray(jstream.next_64().ct))
    assert [int(b) for b in ck.decrypt(z)] == clear.next_bits(64)
    # the states stay in lockstep with the clear cipher and with tfhe_tpu
    assert [int(b) for b in ck.decrypt(stream.state)] == clear.s
    np.testing.assert_array_equal(to_u64(stream.state.ct),
                                  np.asarray(jstream.state.ct))


def test_transciphering_bit_equal(keys):
    jck, jsk, ck, sk = keys
    msg = [(i * 3 + 1) % 2 for i in range(64)]
    sym_ct = [m ^ z for m, z in zip(msg, ClearTrivium(KEY, IV).next_bits(64))]
    state_bits = np.array(ClearTrivium(KEY, IV).s, dtype=bool)
    stream = TriviumStream.from_state(sk, ck.encrypt(state_bits))
    jstream = jtriv.TriviumStream.from_state(jsk, jck.encrypt(state_bits))
    got = transcipher_decrypt(stream, sym_ct)
    np.testing.assert_array_equal(
        to_u64(got.ct), np.asarray(jtriv.transcipher_decrypt(jstream,
                                                             sym_ct).ct))
    assert [int(b) for b in ck.decrypt(got)] == msg
