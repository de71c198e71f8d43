"""The port stands alone: no module of tfhe_tpu_torch (nor chip_smoke.py)
imports jax, jaxlib or tfhe_tpu, and the C API embeds only the port; a TOY
apply_lookup_table runs, and the kernel bench, the SASS counter, the batch
mesh and the reference-vector twin import, in a fresh interpreter without
either being loaded; entry points without a device ask for the GPU and
raise when there is none (the batch mesh, the distributed init and the
twin's decryption contract included); CPU tensors take the plain versions
of the kernels, whose launch counts stay 0; each variant runs its own path,
multi-bit parameter sets included; chip_smoke.py drives the mesh, the C API
and the twin in its phase 23."""

import ast
import dataclasses
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from tfhe_tpu_torch._torus import to_u64
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
    names = {os.path.relpath(p, ROOT) for p in sources}
    assert {"chip_smoke.py", "tfhe_tpu_torch/ops/kernel_bench.py",
            "tfhe_tpu_torch/sass_loops.py",
            "tfhe_tpu_torch/tools/vpu_primitives.py",
            "tfhe_tpu_torch/tools/ntt_variants.py",
            "tfhe_tpu_torch/tools/v4_probe.py",
            "tfhe_tpu_torch/tools/mxu_probe.py",
            "tfhe_tpu_torch/tools/kernel_experiments.py",
            "tfhe_tpu_torch/tools/ntt_v3c_experiments.py",
            "tfhe_tpu_torch/tools/ntt_mxu.py",
            "tfhe_tpu_torch/ops/mxu_tables.py",
            "tfhe_tpu_torch/integer/radix.py",
            "tfhe_tpu_torch/integer/ops_extra.py",
            "tfhe_tpu_torch/integer/crt.py",
            "tfhe_tpu_torch/integer/bigint.py",
            "tfhe_tpu_torch/strings/ascii.py",
            "tfhe_tpu_torch/high_level_api/api.py",
            "tfhe_tpu_torch/high_level_api/kv_store.py",
            "tfhe_tpu_torch/shortint/oprf.py",
            "tfhe_tpu_torch/shortint/public_key.py",
            "tfhe_tpu_torch/shortint/compact_public_key.py",
            "tfhe_tpu_torch/shortint/key_switching_key.py",
            "tfhe_tpu_torch/shortint/compressed_server_key.py",
            "tfhe_tpu_torch/shortint/list_compression.py",
            "tfhe_tpu_torch/shortint/wopbs.py",
            "tfhe_tpu_torch/utils/params_registry.py",
            "tfhe_tpu_torch/utils/params_universe.py",
            "tfhe_tpu_torch/utils/fork_budgets.py",
            "tfhe_tpu_torch/utils/trace.py",
            "tfhe_tpu_torch/utils/serialization.py",
            "tfhe_tpu_torch/utils/cbor.py",
            "tfhe_tpu_torch/utils/hostarray.py",
            "tfhe_tpu_torch/keycache.py",
            "tfhe_tpu_torch/client.py",
            "tfhe_tpu_torch/apps/test_vectors.py",
            "tfhe_tpu_torch/ops/ntt64_pbs.py",
            "tfhe_tpu_torch/zk/__init__.py",
            "tfhe_tpu_torch/zk/curve.py",
            "tfhe_tpu_torch/zk/four_squares.py",
            "tfhe_tpu_torch/zk/pke.py",
            "tfhe_tpu_torch/zk/pke_v2.py",
            "tfhe_tpu_torch/zk/transcript.py",
            "tfhe_tpu_torch/zk/proven_list.py",
            "tfhe_tpu_torch/parallel/__init__.py",
            "tfhe_tpu_torch/parallel/mesh.py",
            "tfhe_tpu_torch/apps/test_vectors_ref.py"} <= names
    bad = [(os.path.relpath(p, ROOT), m) for p in sources
           for m in _imported_roots(p) if m in FORBIDDEN]
    assert not bad, bad


def test_toy_pbs_runs_without_jax_loaded():
    code = (
        "import sys, numpy as np\n"
        "from tfhe_tpu_torch.shortint.client_key import ClientKey\n"
        "from tfhe_tpu_torch.shortint.server_key import ServerKey\n"
        "from tfhe_tpu_torch.utils.params import PARAM_TEST_TOY as P\n"
        "from tfhe_tpu_torch.ops import kernel_bench\n"
        "from tfhe_tpu_torch import sass_loops\n"
        "from tfhe_tpu_torch.integer import crt, gen_keys\n"
        "from tfhe_tpu_torch import high_level_api, strings\n"
        "from tfhe_tpu_torch.high_level_api import kv_store\n"
        "from tfhe_tpu_torch.shortint import oprf\n"
        "from tfhe_tpu_torch.shortint import (public_key, compact_public_key,\n"
        "    key_switching_key, compressed_server_key, list_compression,\n"
        "    wopbs)\n"
        "from tfhe_tpu_torch.utils import fork_budgets\n"
        "from tfhe_tpu_torch.utils import trace, serialization, cbor\n"
        "from tfhe_tpu_torch import keycache, client\n"
        "from tfhe_tpu_torch.apps import test_vectors\n"
        "from tfhe_tpu_torch.ops import ntt64_pbs\n"
        "from tfhe_tpu_torch import zk\n"
        "from tfhe_tpu_torch.zk import transcript, four_squares\n"
        "from tfhe_tpu_torch.parallel import mesh\n"
        "from tfhe_tpu_torch.apps import test_vectors_ref as tvr\n"
        "assert tvr.digests(tvr.generate(tvr.TOY)) == tvr.TOY_SHA256\n"
        "from tfhe_tpu_torch.utils.params import PARAMS_BY_NAME\n"
        "PARAMS_BY_NAME['V1_5_PARAM_MESSAGE_2_CARRY_2_KS32_PBS_TUNIFORM_2M128']\n"
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
    from tfhe_tpu_torch.apps import test_vectors_ref as tvr
    from tfhe_tpu_torch.parallel import mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_batch_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.init_distributed("localhost:1", 1, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvr.decrypt_contract(tvr.generate(tvr.TOY))


def test_cpu_tensors_take_plain_versions():
    pk.reset_launches()
    ck = ClientKey.generate(P, seed=4, device="cpu")
    sk = ServerKey.generate(ck)
    ct = ck.encrypt(np.arange(16))
    out = sk.apply_lookup_table(ct, sk.generate_lookup_table(lambda x: x))
    np.testing.assert_array_equal(ck.decrypt_message_and_carry(out),
                                  np.arange(16))
    assert out.ct.device.type == "cpu"
    assert len(pk.KERNELS) == 21
    for fn in pk.KERNELS:
        assert fn.launches == 0, fn.__name__


def _toy_set(kind, pmod):
    """The toy parameter set of an atomic pattern, from a params module (the
    port's or tfhe_tpu's)."""
    if kind == "ks32":
        return pmod.PARAM_TEST_TOY_KS32
    if kind == "pbs_ks":
        return pmod.PARAM_TEST_TOY_PBS_KS
    return dataclasses.replace(
        pmod.PARAM_TEST_TOY,
        modulus_switch_type=pmod.ModulusSwitchType
        .DRIFT_TECHNIQUE_NOISE_REDUCTION,
        modulus_switch_noise_reduction_params=pmod
        .ModulusSwitchNoiseReductionParams(16, 2.0 ** 57, 3.0, 2.0 ** -80),
        name="PARAM_TEST_TOY_DRIFT")


@pytest.mark.parametrize("kind", ["multi-bit", "ks32", "pbs_ks", "drift"])
def test_parameter_kinds_match_tfhe_tpu(kind):
    """Every kind of parameter set runs its own path and equals tfhe_tpu
    bit for bit on a LUT round trip: a multi-bit set (here duck-typed by its grouping
    factor) builds a multi-bit key and runs the multi-bit PBS (plain K2 u64
    -> K5), as the other atomic patterns, which raised until ROADMAP Queue
    A item 5 ported them, run theirs (KS32, PBS -> KS, the drift
    technique)."""
    from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
    from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
    from tfhe_tpu.utils import params as jparams

    if kind == "multi-bit":
        def multi_bit(pmod):
            fields = {f.name: getattr(pmod.PARAM_TEST_TOY, f.name)
                      for f in dataclasses.fields(pmod.PARAM_TEST_TOY)}
            return types.SimpleNamespace(**dict(
                fields, grouping_factor=2,
                glwe_size=pmod.PARAM_TEST_TOY.glwe_size))

        jck = JClientKey.generate(jparams.PARAM_TEST_TOY, seed=5)
        jck.params = multi_bit(jparams)
        ck = ClientKey.generate(P, seed=5, device="cpu")
        ck.params = multi_bit(pm)
    else:
        jck = JClientKey.generate(_toy_set(kind, jparams), seed=5)
        ck = ClientKey.generate(_toy_set(kind, pm), seed=5, device="cpu")
    jsk = JServerKey.generate(jck)
    sk = ServerKey.generate(ck)
    assert (sk.bsk_mb is not None) == (kind == "multi-bit")
    msgs = np.array([0, 1, 2, 3], dtype=np.uint64)
    f = lambda x: (x + 3) % 4
    jout = jsk.apply_lookup_table(jck.encrypt(msgs),
                                  jsk.generate_lookup_table(f))
    out = sk.apply_lookup_table(ck.encrypt(msgs), sk.generate_lookup_table(f))
    np.testing.assert_array_equal(to_u64(out.ct), np.asarray(jout.ct))
    np.testing.assert_array_equal(ck.decrypt(out), [3, 0, 1, 2])


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


def test_c_api_embeds_only_the_port():
    """The C API's embedded interpreter imports modules of tfhe_tpu_torch
    only (the high-level API, serialization, the parameter sets and the
    device rule), and nothing of jax or tfhe_tpu."""
    src = open(os.path.join(ROOT, "tfhe_tpu_torch", "c_api",
                            "tfhe_tpu_c.c")).read()
    modules = re.findall(r'PyImport_ImportModule\(\s*"([^"]+)"', src)
    assert sorted(modules) == [
        "tfhe_tpu_torch._device", "tfhe_tpu_torch.high_level_api.api",
        "tfhe_tpu_torch.utils.params", "tfhe_tpu_torch.utils.serialization"]
    literals = re.findall(r'"([^"\n]*)"', src)
    assert not [s for s in literals
                if re.search(r"\bjax\b|tfhe_tpu\.(?!h$)", s)]


def test_chip_smoke_drives_phase_23():
    """chip_smoke.py's phase 23 (``phase_mesh_c_api``) runs from ``main``
    on phase 2's keys and is listed in the docstring, phase 24
    (``phase_wide``, the 3_3 sets on K7) after it, the card's lines after
    that as 25."""
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    tree = ast.parse(src)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert "phase_mesh_c_api" in funcs and "phase_wide" in funcs
    called = {n.func.id for n in ast.walk(funcs["main"])
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    assert {"phase_mesh_c_api", "phase_wide"} <= called
    doc = ast.get_docstring(tree)
    assert re.search(r"^23\. the batch mesh, the C API and the "
                     r"reference-vector twin", doc, re.M)
    assert re.search(r"^24\. tfhe-rs's 3_3 sets on K7", doc, re.M)
    assert re.search(r"^25\. the card's name and power limit", doc, re.M)
