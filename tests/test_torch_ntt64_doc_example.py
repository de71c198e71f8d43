"""The reference's NTT64 PBS doc example (``ntt64_pbs.rs:31-176``: n = 742,
k = 1, N = 2048, b = 23, l = 1, q = 2^64 - 2^32 + 1, 4-bit messages,
f(x) = 2x) through the port alone on the CPU (no JAX): 4 messages must
decrypt to 2m. The whole recipe, at 16 messages and on K6, is
``chip_smoke.py`` phase 21."""

import numpy as np
import pytest
import torch

from tfhe_tpu_torch._torus import to_u64
from tfhe_tpu_torch.ops import ntt64_pbs as pn
from tfhe_tpu_torch.ops import pbs_kernel as pk

Q = pn.Q


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_pbs_ntt64_doc_example():
    rng = np.random.default_rng(42)
    n, k, N, base_log, levels = 742, 1, 2048, 23, 1
    mm = 16
    delta = (1 << 63) // mm
    # the doc's standard deviations are relative to q
    lwe_std = 0.000007069849454709433 * Q
    glwe_std = 0.00000000000000029403601535432533 * Q
    lwe_sk = rng.integers(0, 2, size=n).astype(np.uint8)
    glwe_sk = rng.integers(0, 2, size=(k, N)).astype(np.uint8)
    bsk = pn.gen_bootstrap_key_ntt64(lwe_sk, glwe_sk, base_log, levels,
                                     glwe_std, rng, device="cpu")
    assert tuple(bsk.shape) == (n, levels, k + 1, k + 1, N)
    bsk_hat = pn.bootstrap_key_to_ntt64(bsk)
    msgs = np.array([0, 3, 7, 15], dtype=np.uint64)
    cts = pn.lwe_encrypt_q(lwe_sk, (msgs * np.uint64(delta)) % np.uint64(Q),
                           lwe_std, rng, device="cpu")
    lut = pn.generate_lut_q(N, k + 1, mm, delta, lambda x: 2 * x)
    pk.reset_launches()
    out = pn.pbs_ntt64(cts, lut, bsk_hat, base_log, levels)
    assert tuple(out.shape) == (len(msgs), k * N + 1)
    assert pk.blind_rotate_ntt64.launches == 0
    dec = to_u64(pn.decode_q(pn.lwe_decrypt_q(glwe_sk.reshape(-1), out),
                             delta))
    # 2m needs 5 bits: the padding bit makes the space Z_{2 mm}, and a phase
    # past q/2 decodes to q - v
    signed = np.array([int(v) - Q if int(v) > Q // 2 else int(v)
                       for v in dec])
    np.testing.assert_array_equal(signed % (2 * mm),
                                  (2 * msgs.astype(int)) % (2 * mm))
