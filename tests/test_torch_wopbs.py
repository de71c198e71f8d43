"""The port's WoP-PBS (``tfhe_tpu_torch.shortint.wopbs``) against tfhe_tpu
at PARAM_TEST_TOY on the CPU: the same seed gives byte-equal packing keys
and WoP-PBS bootstrap key; on the same input ciphertext each stage equals
tfhe_tpu's bit for bit: ``extract_bits`` (keyswitches and the PBS of the
bit peeling), ``circuit_bootstrap`` (the GGSW of each bit; the port runs
all bits and levels as one batched PBS), ``generate_lut``,
``vertical_packing`` (on tfhe_tpu's own GGSWs) and the whole ``wopbs``; each
output decrypts to its clear value. The PBS is the port's torch CRT PBS
(``ops/server.py::programmable_bootstrap``), which takes no kernel.
Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from tfhe_tpu.core import algorithms as jalgo
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.shortint.wopbs import WopbsKey as JWopbsKey
from tfhe_tpu.utils.params import PARAM_TEST_TOY as JP

from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import from_u64, to_u32, to_u64
from tfhe_tpu_torch.core import algorithms as algo
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.shortint.ciphertext import ShortintCiphertext
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.server_key import ServerKey
from tfhe_tpu_torch.shortint.wopbs import WopbsKey
from tfhe_tpu_torch.utils.params import PARAM_TEST_TOY as P

SEED = 51  # tests/test_wopbs.py's key seed
NBITS = 4  # message + carry bits at TOY
F = lambda x: (7 * x + 3) % 16  # noqa: E731


@pytest.fixture(scope="module")
def keys():
    jck = JClientKey.generate(JP, seed=SEED)
    jsk = JServerKey.generate(jck)
    ck = ClientKey.generate(P, seed=SEED, device="cpu")
    sk = ServerKey.generate(ck)
    return dict(jck=jck, jsk=jsk, jwk=JWopbsKey.generate(jck, jsk), ck=ck,
                sk=sk, wk=WopbsKey.generate(ck, sk))


@pytest.fixture(scope="module")
def stages(keys):
    """tfhe_tpu's stages on an encryption of 11 (message 3, carry 2, put
    in by a trivial body shift, as tests/test_wopbs.py builds it)."""
    jck, jwk = keys["jck"], keys["jwk"]
    from tfhe_tpu.shortint.ciphertext import \
        ShortintCiphertext as JCiphertext

    zero = np.asarray(jck.encrypt(np.array([0], dtype=np.uint64)).ct)[0]
    raw = jalgo.lwe_trivial(jck.big_lwe_sk.dim, np.array(
        [11 * ((1 << 63) // 16)], dtype=np.uint64))[0]
    full = zero + np.asarray(raw)
    jct = JCiphertext(ct=full, degree=15, noise_level=1, message_modulus=4,
                      carry_modulus=4)
    ct = ShortintCiphertext(ct=from_u64(full, "cpu"), degree=15,
                            noise_level=1, message_modulus=4,
                            carry_modulus=4)
    bits = jwk.extract_bits(jct, 63 - NBITS, NBITS)
    ggsws = [jwk.circuit_bootstrap(b) for b in bits]
    lut = jwk.generate_lut(jct, F)
    return dict(jct=jct, ct=ct, bits=bits, ggsws=ggsws, lut=lut,
                out=jwk.vertical_packing(lut, ggsws))


def _decrypt_small_bit(ck, lwe):
    """The bit at 2^63 of a small-key LWE."""
    raw = int(to_u64(algo.lwe_decrypt(ck.lwe_sk, lwe[None]))[0])
    return ((raw + (1 << 62)) >> 63) & 1


def test_keys_byte_equal(keys):
    jwk, wk = keys["jwk"], keys["wk"]
    np.testing.assert_array_equal(to_u64(wk.pfpksk), jwk.pfpksk)
    np.testing.assert_array_equal(to_u32(wk.wopbs_bsk_hat),
                                  np.asarray(jwk.wopbs_bsk_hat))
    for f in ("wopbs_pbs_base_log", "wopbs_pbs_levels", "wopbs_num_primes",
              "cbs_base_log", "cbs_levels", "pf_base_log", "pf_levels"):
        assert getattr(wk, f) == getattr(jwk, f), f
    carried = convert.wopbs_key_from_arrays(
        keys["sk"], jwk.pfpksk, np.asarray(jwk.wopbs_bsk_hat),
        jwk.wopbs_pbs_base_log, jwk.wopbs_pbs_levels, jwk.cbs_base_log,
        jwk.cbs_levels, jwk.pf_base_log, jwk.pf_levels)
    assert carried.wopbs_num_primes == wk.wopbs_num_primes
    assert torch.equal(carried.wopbs_bsk_hat, wk.wopbs_bsk_hat)


def test_extract_bits(keys, stages):
    bits = keys["wk"].extract_bits(stages["ct"], 63 - NBITS, NBITS)
    assert len(bits) == NBITS
    for b, jb in zip(bits, stages["bits"]):
        np.testing.assert_array_equal(to_u64(b), jb)
    assert [_decrypt_small_bit(keys["ck"], b) for b in bits] == [1, 0, 1, 1]


def test_circuit_bootstrap(keys, stages):
    """One batched call over all bits equals tfhe_tpu's GGSW of each."""
    bits = torch.stack([from_u64(b, "cpu") for b in stages["bits"]])
    pk.reset_launches()
    ggsws = keys["wk"].circuit_bootstrap(bits)
    assert not any(fn.launches for fn in pk.KERNELS)
    assert tuple(ggsws.shape) == (NBITS,) + stages["ggsws"][0].shape
    for g, jg in zip(ggsws, stages["ggsws"]):
        np.testing.assert_array_equal(to_u64(g), jg)
    np.testing.assert_array_equal(
        to_u64(keys["wk"].circuit_bootstrap(bits[0])), stages["ggsws"][0])


def test_vertical_packing(keys, stages):
    wk = keys["wk"]
    lut = wk.generate_lut(stages["ct"], F)
    np.testing.assert_array_equal(to_u64(lut), stages["lut"])
    out = wk.vertical_packing(lut, [from_u64(g, "cpu")
                                    for g in stages["ggsws"]])
    np.testing.assert_array_equal(to_u64(out), stages["out"])
    ct = ShortintCiphertext(ct=out, degree=15, noise_level=1,
                            message_modulus=4, carry_modulus=4)
    assert keys["ck"].decrypt_message_and_carry(ct)[0] == F(11)


def test_wopbs(keys):
    """The whole WoP-PBS on a fresh JAX encryption of 3 carried in,
    x -> 7x + 3 mod 16."""
    jct = keys["jck"].encrypt(np.array([3]))
    ct = ShortintCiphertext(ct=from_u64(np.asarray(jct.ct), "cpu"),
                            degree=3, noise_level=1, message_modulus=4,
                            carry_modulus=4)
    jout = keys["jwk"].wopbs(jct, F)
    out = keys["wk"].wopbs(ct, F)
    np.testing.assert_array_equal(to_u64(out.ct), np.asarray(jout.ct))
    assert (out.degree, out.under_key) == (jout.degree, jout.under_key)
    assert keys["ck"].decrypt_message_and_carry(out)[0] == F(3)
