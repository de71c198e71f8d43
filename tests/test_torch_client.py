"""The port's thin client (``tfhe_tpu_torch.client``) against
``tfhe_tpu.client`` at PARAM_TEST_TOY on the CPU:

1. the client surface imports and runs in a subprocess where ``jax``,
   ``tfhe_tpu`` and the port's ``ops`` (the server stack: kernels, PBS,
   keyswitch) are masked;
2. its ciphertexts are bit-identical to ``tfhe_tpu``'s ``client.
   encrypt_radix`` and to both packages' full-stack encryptions of the same
   seed, and its envelopes equal ``tfhe_tpu``'s byte for byte;
3. ``tfhe_tpu``'s server and the port's both compute on what the client
   wrote (an add), and the client decrypts the port server's answer;
4. compact lists equal ``tfhe_tpu``'s client's (``secrets.randbits``
   pinned, both packages read it), and so do the ZK half's CRS, proven
   lists, proofs and their envelope (``secrets.token_bytes`` pinned too).

Tolerance: exact."""

import os
import secrets
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tfhe_tpu import client as jclient
from tfhe_tpu.integer import radix as jradix
from tfhe_tpu.utils import params as jparams
from tfhe_tpu.utils import serialization as jser

from test_torch_public_keys import toy_sets
from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch import client
from tfhe_tpu_torch._torus import to_u64
from tfhe_tpu_torch.integer import radix
from tfhe_tpu_torch.utils import params as pm
from tfhe_tpu_torch.utils import serialization as ser

ROOT = Path(__file__).resolve().parent.parent
SEED = 1234
VALUE = 173

CLIENT_SCRIPT = r"""
import importlib.abc
import sys

MASKED = ("jax", "jaxlib", "tfhe_tpu", "tfhe_tpu_torch.ops")
for m in [k for k in sys.modules if k.split(".")[0] in MASKED[:3]]:
    del sys.modules[m]


class _Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in MASKED[:3] or name.startswith(MASKED[3]):
            raise ImportError(f"masked in the thin-client test: {name}")


sys.meta_path.insert(0, _Blocker())
sys.path.insert(0, %(root)r)

import numpy as np
import torch

torch.set_num_threads(1)
from tfhe_tpu_torch import client
from tfhe_tpu_torch.utils.params import PARAM_TEST_TOY

ck = client.ClientKey.generate(PARAM_TEST_TOY, seed=%(seed)d, device="cpu")
ct = client.encrypt_radix(ck, np.uint64(%(value)d), 4)
assert isinstance(ct.ct, np.ndarray) and ct.ct.dtype == np.uint64
assert int(client.decrypt_radix(ck, ct)[0]) == %(value)d
sct = client.encrypt_signed_radix(ck, -5, 4)
assert int(client.decrypt_signed_radix(ck, sct)[0]) == -5
open(%(out)r, "wb").write(client.serialize_radix(ct))
open(%(kout)r, "wb").write(client.serialize_client_key(ck))
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "tfhe_tpu")
          or m.startswith("tfhe_tpu_torch.ops")
          or m.startswith("tfhe_tpu_torch.shortint.server_key")
          or m.startswith("tfhe_tpu_torch.integer")]
assert not loaded, loaded
print("CLIENT-OK")
"""


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The subprocess client's radix ciphertext and client key envelopes."""
    d = tmp_path_factory.mktemp("client")
    out, kout = str(d / "ct.bin"), str(d / "ck.bin")
    script = CLIENT_SCRIPT % {"root": str(ROOT), "out": out, "kout": kout,
                              "seed": SEED, "value": VALUE}
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-3000:])
    assert "CLIENT-OK" in r.stdout
    return open(out, "rb").read(), open(kout, "rb").read()


def test_masked_client_bit_equal_to_tfhe_tpu(written):
    blob, kblob = written
    jck = jclient.ClientKey.generate(jparams.PARAM_TEST_TOY, seed=SEED)
    assert blob == jclient.serialize_radix(
        jclient.encrypt_radix(jck, np.uint64(VALUE), 4))
    assert kblob == jclient.serialize_client_key(jck)
    full = jradix.ClientKey.generate(jparams.PARAM_TEST_TOY, seed=SEED)
    ct = jser.deserialize(blob, expected_type="RadixCiphertext")
    np.testing.assert_array_equal(np.asarray(ct.ct), np.asarray(
        full.encrypt_radix(np.uint64(VALUE), 4).ct))


def test_tfhe_tpu_server_computes_on_the_client_ciphertext(written):
    blob, kblob = written
    ct = jser.deserialize(blob, expected_type="RadixCiphertext")
    ick = jradix.ClientKey.generate(jparams.PARAM_TEST_TOY, seed=SEED)
    isk = jradix.ServerKey.generate(ick)
    out = isk.add(ct, ct)
    assert int(np.atleast_1d(ick.decrypt_radix(out))[0]) == (2 * VALUE) % 256
    jck = jser.deserialize(kblob, expected_type="ShortintClientKey")
    assert int(jclient.decrypt_radix(jck, ct)[0]) == VALUE


def test_port_server_round_trip(written):
    """Client -> the port's server (load, add, save) -> client decrypt."""
    blob, kblob = written
    ck = ser.deserialize(kblob, expected_type="ShortintClientKey",
                         device="cpu")
    full = radix.ClientKey.generate(pm.PARAM_TEST_TOY, seed=SEED,
                                    device="cpu")
    ct = ser.deserialize(blob, expected_type="RadixCiphertext", device="cpu")
    assert torch.equal(ct.ct, full.encrypt_radix(np.uint64(VALUE), 4).ct)
    isk = radix.ServerKey.generate(full)
    answer = ser.serialize_radix(isk.add(ct, ct))
    back = ser.deserialize(answer, expected_type="RadixCiphertext",
                           device="cpu")
    assert int(client.decrypt_radix(ck, back)[0]) == (2 * VALUE) % 256


def test_in_process_client_equals_full_stack():
    ck = client.ClientKey.generate(pm.PARAM_TEST_TOY, seed=SEED, device="cpu")
    full = radix.ClientKey.generate(pm.PARAM_TEST_TOY, seed=SEED,
                                    device="cpu")
    vals = np.array([5, 250, 0, 77], dtype=np.uint64)
    ct = client.encrypt_radix(ck, vals, 4, device="cpu")
    assert isinstance(ct.ct, torch.Tensor) and ct.num_blocks == 4
    assert torch.equal(ct.ct, full.encrypt_radix(vals, 4).ct)
    np.testing.assert_array_equal(client.decrypt_radix(ck, ct),
                                  vals)
    s = client.encrypt_signed_radix(ck, [-128, 127, -1], 4)
    jck = jclient.ClientKey.generate(jparams.PARAM_TEST_TOY, seed=SEED)
    jclient.encrypt_radix(jck, vals, 4)  # the same stream position
    js = jclient.encrypt_signed_radix(jck, [-128, 127, -1], 4)
    np.testing.assert_array_equal(s.ct, js.ct)
    np.testing.assert_array_equal(client.decrypt_signed_radix(ck, s),
                                  [-128, 127, -1])


def test_compact_list_equal_to_tfhe_tpu(monkeypatch):
    (jpke, _), (pke, _) = toy_sets(jparams), toy_sets(pm)
    bits = iter(range(11, 1000))
    monkeypatch.setattr(secrets, "randbits", lambda k: next(bits))
    jpriv, jpk = jclient.generate_compact_keys(jpke, seed=7)
    jl = jclient.build_compact_list(jpk, [9, 3], num_blocks=2)
    bits = iter(range(11, 1000))
    priv, pk = client.generate_compact_keys(pke, seed=7, device="cpu")
    lst = client.build_compact_list(pk, [9, 3], num_blocks=2)
    assert client.serialize_compact_list(lst) == \
        jclient.serialize_compact_list(jl)
    # radix digits of [9, 3] at message_modulus 4, 2 blocks each
    np.testing.assert_array_equal(priv.decrypt_expanded(lst.expand()),
                                  [1, 2, 3, 0])
    np.testing.assert_array_equal(to_u64(lst.masks), jl.masks)


@pytest.fixture(scope="module")
def zk_lists():
    """Both clients' v2 CRS for the toy compact set (k = 4) and a proven
    list of [9, 3] at 2 blocks each, ``secrets`` pinned for both."""
    (jpke, _), (pke, _) = toy_sets(jparams), toy_sets(pm)
    with pytest.MonkeyPatch.context() as mp:
        bits = iter(range(21, 1000))
        mp.setattr(secrets, "randbits", lambda k: next(bits))
        mp.setattr(secrets, "token_bytes", lambda k: b"\x07" * k)
        _, jpk = jclient.generate_compact_keys(jpke, seed=7)
        jcrs = jclient.client_crs(jpke, 4, seed=2)
        jl = jclient.build_proven_compact_list(jpk, [9, 3], 2, jcrs,
                                               metadata=b"md")
        bits = iter(range(21, 1000))
        priv, pk = client.generate_compact_keys(pke, seed=7, device="cpu")
        crs = client.client_crs(pke, 4, seed=2)
        lst = client.build_proven_compact_list(pk, [9, 3], 2, crs,
                                               metadata=b"md")
    return dict(jcrs=jcrs, jl=jl, crs=crs, lst=lst, pk=pk, priv=priv,
                jpke=jpke, pke=pke)


def _zk_client_crs(z):
    assert ser.serialize_zk_crs(z["crs"]) == jser.serialize_zk_crs(z["jcrs"])
    v1, jv1 = (client.client_crs(z["pke"], 4, seed=3, scheme="v1"),
               jclient.client_crs(z["jpke"], 4, seed=3, scheme="v1"))
    assert type(v1).__name__ == "PkeCrs"
    assert [p.to_bytes() for p in v1.g_list + v1.g_hat_list] == \
        [p.to_bytes() for p in jv1.g_list + jv1.g_hat_list]


def _zk_build_proven_compact_list(z):
    lst, jl = z["lst"], z["jl"]
    assert client.serialize_compact_list(lst.ct_list) == \
        jclient.serialize_compact_list(jl.ct_list)
    assert [p.to_bytes() for p in lst.proofs] == \
        [p.to_bytes() for p in jl.proofs]
    ct = lst.verify_and_expand(z["crs"], z["pk"], metadata=b"md")
    # radix digits of [9, 3] at message_modulus 4, 2 blocks each
    np.testing.assert_array_equal(z["priv"].decrypt_expanded(ct.ct),
                                  [1, 2, 3, 0])


def _zk_serialize_proof(z):
    blob = client.serialize_proof(z["lst"].proofs[0])
    assert blob == jclient.serialize_proof(z["jl"].proofs[0])
    back = ser.deserialize(blob, expected_type="PkeV2Proof", device="cpu")
    assert back.to_bytes() == z["lst"].proofs[0].to_bytes()


ZK_CALLS = {"build_proven_compact_list": _zk_build_proven_compact_list,
            "client_crs": _zk_client_crs,
            "serialize_proof": _zk_serialize_proof}


@pytest.mark.parametrize("fn", list(ZK_CALLS))
def test_zk_entries_byte_equal(zk_lists, fn):
    """Each ZK entry of the client works and equals ``tfhe_tpu``'s client's
    output byte for byte: the CRS (v2, and v1's points), the proven list
    and its proofs (which verify and expand to the radix digits), the proof
    envelope (read back)."""
    ZK_CALLS[fn](zk_lists)


def test_exports_match_tfhe_tpu():
    assert client.__all__ == jclient.__all__
    for name in client.__all__:
        assert hasattr(client, name), name
