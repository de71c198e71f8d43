"""The port stands alone: no module of tfhe_tpu_torch (nor chip_smoke.py)
imports jax, jaxlib or tfhe_tpu; a TOY apply_lookup_table runs in a fresh
interpreter without either being loaded; entry points without a device ask
for the GPU and raise when there is none; CPU tensors take the plain
versions of the kernels, whose launch counts stay 0; each variant runs its
own path, and unported parameter sets raise instead of running another
path."""

import ast
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.server_key import ServerKey
from tfhe_tpu_torch.utils import params as pm
from tfhe_tpu_torch.utils.params import PARAM_TEST_TOY as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "tfhe_tpu")


def _port_sources():
    pkg = os.path.join(ROOT, "tfhe_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_tfhe_tpu_imports():
    sources = list(_port_sources())
    assert len(sources) > 15
    bad = [(os.path.relpath(p, ROOT), m) for p in sources
           for m in _imported_roots(p) if m in FORBIDDEN]
    assert not bad, bad


def test_toy_pbs_runs_without_jax_loaded():
    code = (
        "import sys, numpy as np\n"
        "from tfhe_tpu_torch.shortint.client_key import ClientKey\n"
        "from tfhe_tpu_torch.shortint.server_key import ServerKey\n"
        "from tfhe_tpu_torch.utils.params import PARAM_TEST_TOY as P\n"
        "ck = ClientKey.generate(P, seed=3, device='cpu')\n"
        "sk = ServerKey.generate(ck)\n"
        "out = sk.apply_lookup_table(ck.encrypt([1, 2]),\n"
        "                            sk.generate_lookup_table(lambda x: x + 1))\n"
        "assert list(ck.decrypt_message_and_carry(out)) == [2, 3]\n"
        "loaded = [m for m in sys.modules\n"
        "          if m.split('.')[0] in ('jax', 'jaxlib', 'tfhe_tpu')]\n"
        "assert not loaded, loaded\n"
        "print('isolated ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "isolated ok" in r.stdout


def test_entry_points_without_device_need_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ClientKey.generate(P, seed=1)
    from tfhe_tpu_torch import convert

    with pytest.raises(RuntimeError, match="CUDA"):
        convert.client_key_from_arrays(P.name, np.zeros((1, 256), np.uint64),
                                       np.zeros(16, np.uint64))
    from tfhe_tpu_torch import boolean

    with pytest.raises(RuntimeError, match="CUDA"):
        boolean.ClientKey.generate(pm.BOOLEAN_TEST_TOY, seed=1)


def test_cpu_tensors_take_plain_versions():
    pk.reset_launches()
    ck = ClientKey.generate(P, seed=4, device="cpu")
    sk = ServerKey.generate(ck)
    ct = ck.encrypt(np.arange(16))
    out = sk.apply_lookup_table(ct, sk.generate_lookup_table(lambda x: x))
    np.testing.assert_array_equal(ck.decrypt_message_and_carry(out),
                                  np.arange(16))
    assert out.ct.device.type == "cpu"
    for fn in (pk.body_rotate_acc32, pk.body_rotate_u64,
               pk.blind_rotate_bnf2_acc32, pk.blind_rotate_crt,
               pk.blind_rotate_bnf2_u64, pk.blind_rotate_goldilocks):
        assert fn.launches == 0, fn.__name__


@pytest.mark.parametrize("kind", ["multi-bit", "ks32", "pbs_ks", "drift"])
def test_unported_parameter_sets_raise(kind):
    """Parameters are duck-typed: a multi-bit or KS32 set (no class in the
    port yet), or a classic set asking for an unported pattern, raises."""
    fields = {f.name: getattr(P, f.name) for f in dataclasses.fields(P)}
    fields.update({
        "multi-bit": {"grouping_factor": 2},
        "ks32": {"post_keyswitch_ciphertext_modulus":
                 pm.CiphertextModulus(0, 32)},
        "pbs_ks": {"encryption_key_choice": pm.EncryptionKeyChoice.SMALL},
        "drift": {"modulus_switch_type":
                  pm.ModulusSwitchType.DRIFT_TECHNIQUE_NOISE_REDUCTION},
    }[kind])
    ck = ClientKey.generate(P, seed=5, device="cpu")
    ck.params = types.SimpleNamespace(**fields)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServerKey.generate(ck)


@pytest.mark.parametrize("variant", ["crt", "v5"])
def test_each_variant_runs_its_own_path(variant, monkeypatch):
    """crt and v5 each run their own path: the exact CRT key and kernels,
    or the Goldilocks key and kernels, never the BNF2 ones."""
    monkeypatch.setenv("TFHE_NTT_VARIANT", variant)
    ck = ClientKey.generate(P, seed=5, device="cpu")
    sk = ServerKey.generate(ck)
    assert sk.ntt_variant == variant and sk.bsk_b is None
    if variant == "v5":
        assert sk.bsk_scan is None and sk.num_primes == 1
        assert tuple(sk.bsk_g.shape) == (P.lwe_dimension, 2, P.pbs_level * 2,
                                         2, P.polynomial_size // 128, 128)
    else:
        assert sk.bsk_g is None
        assert tuple(sk.bsk_scan.shape[:3]) == (P.lwe_dimension, 2, 4)
    out = sk.apply_lookup_table(ck.encrypt([3, 6]),
                                sk.generate_lookup_table(lambda x: x + 2))
    np.testing.assert_array_equal(ck.decrypt_message_and_carry(out), [5, 8])


def test_v6_variant_runs_default_pair(monkeypatch):
    monkeypatch.setenv("TFHE_NTT_VARIANT", "v6")
    ck = ClientKey.generate(P, seed=6, device="cpu")
    sk = ServerKey.generate(ck)
    assert sk.ntt_variant == "v6" and sk.flavor.p0 == 0x3F5A0001
    out = sk.apply_lookup_table(ck.encrypt([3, 7]),
                                sk.generate_lookup_table(lambda x: 2 * x))
    np.testing.assert_array_equal(ck.decrypt_message_and_carry(out), [6, 14])
