"""The port's batch mesh (``tfhe_tpu_torch.parallel.mesh``) against
tfhe_tpu at PARAM_TEST_TOY, on the CPU (the kernels' plain versions):

- ``sharded_ks_pbs`` over meshes of 1, 2, 4 and 8 ``"cpu"`` entries on keys
  carried across from tfhe_tpu: each output bit-equal to the port's
  unsharded ``ks_pbs`` and to tfhe_tpu's ``apply_lookup_table`` on the same
  16 messages, under the default variant (v6b: plain K2 acc32 -> plain K1)
  and on a ``crt`` key (plain K2 u64 -> plain K3);
- the ``B % n`` ``ValueError``, ``scaling_sweep``'s positive rates,
  ``make_batch_mesh()`` raising without a GPU, and ``init_distributed``
  with a world of 1 on ``gloo`` over a ``file://`` store.

Tolerance: exact."""

import numpy as np
import pytest
import torch

from tfhe_tpu.shortint import server_key as jserver_key
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils.params import PARAM_TEST_TOY as JP

from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import from_u64, to_u64
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.parallel import mesh as pmesh

SEED = 77
MOD = JP.message_modulus * JP.carry_modulus
MSGS = np.arange(16, dtype=np.uint64) % MOD
F = lambda x: (7 * x + 1) % MOD  # noqa: E731


def _case(variant, monkeypatch):
    """tfhe_tpu's keys and LUT output on MSGS, and the port's key carried
    across from them, with the batch and the LUT."""
    if variant != "v6b":
        monkeypatch.setenv("TFHE_NTT_VARIANT", variant)
    # tfhe_tpu's jitted KS -> PBS is cached by key shape: a fresh cache
    # keeps another variant's trace from answering
    monkeypatch.setattr(jserver_key, "_jitted_ks_pbs_cache", {})
    jck = JClientKey.generate(JP, seed=SEED)
    jsk = JServerKey.generate(jck)
    jct = jck.encrypt(MSGS)
    want = np.asarray(jsk.apply_lookup_table(
        jct, jsk.generate_lookup_table(F)).ct)
    sk = convert.server_key_from_arrays(
        JP.name, np.asarray(jsk.ksk), np.asarray(jsk.bsk_scan),
        jsk.num_primes, device="cpu")
    assert sk.variant == jsk.ntt_variant == variant
    ct = from_u64(np.asarray(jct.ct), "cpu")
    return sk, ct, sk.generate_lookup_table(F).acc, want


@pytest.fixture(scope="module")
def v6b():
    with pytest.MonkeyPatch.context() as mp:
        return _case("v6b", mp)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_ks_pbs_bit_equal(v6b, n):
    sk, ct, lut, want = v6b
    single = sk.ks_pbs(ct, lut)
    np.testing.assert_array_equal(to_u64(single), want)
    pk.reset_launches()
    mesh = pmesh.make_batch_mesh(devices=["cpu"] * n)
    out = pmesh.sharded_ks_pbs(sk, mesh)(ct, lut)
    assert torch.equal(out, single)
    assert all(f.launches == 0 for f in pk.KERNELS)  # CPU: plain versions


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_ks_pbs_crt_key(n, monkeypatch):
    sk, ct, lut, want = _case("crt", monkeypatch)
    out = pmesh.sharded_ks_pbs(sk, pmesh.make_batch_mesh(
        devices=["cpu"] * n))(ct, lut)
    np.testing.assert_array_equal(to_u64(out), want)
    assert torch.equal(out, sk.ks_pbs(ct, lut))


def test_batch_must_split_evenly(v6b):
    sk, ct, lut, _ = v6b
    run = pmesh.sharded_ks_pbs(sk, pmesh.make_batch_mesh(devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="not a multiple"):
        run(ct, lut)


def test_keys_replicated_once_a_device(v6b):
    """The key's own device takes the key itself; each other device one
    copy, shared by its mesh entries."""
    sk = v6b[0]
    (same,) = pmesh.replicate_keys(["cpu", "cpu"], sk)
    assert same[0] is sk and same[1] is sk
    (meta,) = pmesh.replicate_keys([torch.device("meta")] * 2, sk)
    assert meta[0] is meta[1] and meta[0] is not sk
    assert all(getattr(meta[0], f).device.type == "meta"
               for f in pmesh.KS_PBS_FIELDS
               if getattr(sk, f) is not None)
    chunks = pmesh.shard_ciphertext_batch(torch.arange(8).reshape(4, 2),
                                          ["cpu", "cpu"])
    assert [c.tolist() for c in chunks] == [[[0, 1], [2, 3]],
                                            [[4, 5], [6, 7]]]


def test_scaling_sweep_rates(v6b):
    sk, ct, lut, _ = v6b
    rates = pmesh.scaling_sweep(sk, lut, ct, [1, 2, 4, 8], iters=1,
                                devices=["cpu"] * 8)
    assert set(rates) == {1, 2, 4, 8} and all(v > 0 for v in rates.values())


def test_make_batch_mesh_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        pmesh.make_batch_mesh()
    with pytest.raises(ValueError):
        pmesh.make_batch_mesh(3, devices=["cpu", "cpu"])


def test_init_distributed_world_of_one(tmp_path):
    import torch.distributed as dist

    pmesh.init_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                           device="cpu")
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        t = torch.tensor([3])
        dist.all_reduce(t)
        assert t.item() == 3
    finally:
        dist.destroy_process_group()
