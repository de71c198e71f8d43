"""The port's FHE Trivium keystream from a clear-warmed, then encrypted
state: 128 bits (two ``next_64`` rounds of gates) against apps/trivium.py
and the clear cipher, at BOOLEAN_TEST_TOY on the CPU (the kernels' plain
versions), with ``test_torch_trivium.py``'s keys. A file of its own, so
that the ``--dist loadfile`` workers do not run it behind that file's
tests. Tolerance: exact (same keys and inputs => the same ciphertext bits
as tfhe_tpu)."""

import numpy as np

from test_torch_strings import one_torch_thread  # noqa: F401  (autouse)
from test_torch_trivium import IV, KEY, jtriv, keys  # noqa: F401  (fixture)

from tfhe_tpu_torch._torus import to_u64
from tfhe_tpu_torch.apps.trivium import ClearTrivium, TriviumStream


def test_keystream_from_warmed_state_bit_equal(keys):
    jck, jsk, ck, sk = keys
    clear = ClearTrivium(KEY, IV)
    state_bits = np.array(clear.s, dtype=bool)
    jstream = jtriv.TriviumStream.from_state(jsk, jck.encrypt(state_bits))
    stream = TriviumStream.from_state(sk, ck.encrypt(state_bits))
    np.testing.assert_array_equal(to_u64(stream.state.ct),
                                  np.asarray(jstream.state.ct))
    got = stream.next_bits(128)
    np.testing.assert_array_equal(to_u64(got.ct),
                                  np.asarray(jstream.next_bits(128).ct))
    assert [int(b) for b in ck.decrypt(got)] == clear.next_bits(128)
