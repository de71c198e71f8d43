"""Ciphertext-batch data parallelism over the devices of a batch mesh.

Torch counterpart of ``tfhe_tpu/parallel/mesh.py``, with its function names.
The reference's multi-device story is scatter/gather of independent LWEs
over GPUs with replicated keys (``backends/tfhe-cuda-backend/cuda/include/
helper_multi_gpu.h:14-46``). Here the batch mesh is an ordered list of
torch devices on one axis:

- a ciphertext batch is split along dim 0 into one equal chunk a mesh entry
  (the caller pads: ``B % len(mesh) == 0``, as ``tfhe_tpu`` asks);
- the key material that ``ServerKey.ks_pbs`` reads is copied once to each
  distinct device of the mesh (never to the key's own device);
- each chunk runs KS -> PBS on its device with that device's key, and no
  collective: PBS over independent ciphertexts is embarrassingly parallel;
- the outputs are gathered on the mesh's first device, once every device's
  work has been issued, so the devices run side by side.

A mesh may name one device more than once (``["cuda:0", "cuda:0"]`` runs the
split and the gather on one card) and may name the CPU (``["cpu"] * 8``,
the tests' mesh).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from .._device import resolve_device

#: the tensors of a ``ServerKey`` that ``ks_pbs`` reads on the key's device
#: (``ksk`` too: the key reports its device from it)
KS_PBS_FIELDS = ("ksk", "ksk_i8", "bsk_b", "bsk_scan", "bsk_g", "bsk_g_k",
                 "bsk_mb", "ms_zeros")


def _norm(device) -> torch.device:
    """``device`` as a torch device with its index (``cuda`` -> the current
    CUDA device), so that equal devices compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> None:
    """Join a multi-process run: ``torch.distributed.init_process_group``
    over ``nccl`` on CUDA devices, or ``gloo`` when ``device`` is the CPU
    (the GPU when unset; it raises without one). ``coordinator_address``
    is an init method (``tcp://host:port``, ``file:///path``; a bare
    ``host:port`` means TCP), or unset for ``env://``. Nothing in the
    sharded PBS needs it: each process drives the devices of its own host's
    mesh."""
    import torch.distributed as dist

    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if coordinator_address is not None and "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=-1 if num_processes is None
                            else num_processes,
                            rank=-1 if process_id is None else process_id)


def make_batch_mesh(n_devices: Optional[int] = None, devices=None) -> list:
    """The batch mesh: ``devices`` (or every CUDA device of the host,
    ``cuda:0 .. cuda:{count-1}``, raising without a GPU), the first
    ``n_devices`` of them when given."""
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = [_norm(d) for d in devices]
    if n_devices is not None:
        if not 0 < n_devices <= len(mesh):
            raise ValueError(f"{n_devices} devices asked of a mesh of "
                             f"{len(mesh)}")
        mesh = mesh[:n_devices]
    if not mesh:
        raise ValueError("a batch mesh needs at least one device")
    return mesh


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a batch mesh: split along dim 0 into one equal
    chunk a device (``split``), or whole on each device."""

    devices: tuple
    split: bool


def batch_sharding(mesh: list) -> Sharding:
    """Ciphertext arrays: the leading (batch) dim split over the mesh."""
    return Sharding(tuple(_norm(d) for d in mesh), split=True)


def replicated(mesh: list) -> Sharding:
    """Key material: a whole copy on each device."""
    return Sharding(tuple(_norm(d) for d in mesh), split=False)


def _place(t: torch.Tensor, sharding: Sharding) -> list:
    """``t`` laid out by ``sharding``: one tensor a mesh entry. A copy is
    made once a distinct device; the tensor's own device takes it as is."""
    n = len(sharding.devices)
    if sharding.split:
        if t.shape[0] % n:
            raise ValueError(f"batch {t.shape[0]} is not a multiple of the "
                             f"mesh's {n} devices (pad it)")
        parts = t.split(t.shape[0] // n)
    else:
        parts = (t,) * n
    copies = {}
    out = []
    for part, dev in zip(parts, sharding.devices):
        if sharding.split or dev not in copies:
            copies[dev] = part.to(dev, non_blocking=True)
        out.append(copies[dev])
    return out


def shard_ciphertext_batch(ct: torch.Tensor, mesh: list) -> list:
    """The chunks of a batched ciphertext tensor, chunk i on mesh entry i
    (``ValueError`` when the batch does not split evenly)."""
    return _place(ct, batch_sharding(mesh))


def _key_on(server_key, dev: torch.device):
    """``server_key`` with the tensors ``ks_pbs`` reads copied to ``dev``."""
    if _norm(server_key.device) == dev:
        return server_key
    moved = {f: getattr(server_key, f).to(dev) for f in KS_PBS_FIELDS
             if getattr(server_key, f) is not None}
    return dataclasses.replace(server_key, bsk_std=None, **moved)


def replicate_keys(mesh: list, *keys) -> tuple:
    """Each key replicated over the mesh: a list of one key a mesh entry,
    copied once to each distinct device. A key is a tensor or a shortint
    ``ServerKey`` (its ``KS_PBS_FIELDS`` are copied)."""
    mesh = [_norm(d) for d in mesh]
    out = []
    for key in keys:
        if isinstance(key, torch.Tensor):
            out.append(_place(key, replicated(mesh)))
            continue
        by_dev = {d: _key_on(key, d) for d in dict.fromkeys(mesh)}
        out.append([by_dev[d] for d in mesh])
    return tuple(out)


def sharded_ks_pbs(server_key, mesh: list):
    """``run(ct_batch, lut_acc)``: the KS -> PBS atomic pattern with the
    batch split over the mesh, each chunk on its device with that device's
    copy of the key, the outputs gathered on the mesh's first device
    (equal, bit for bit, to ``server_key.ks_pbs(ct_batch, lut_acc)``)."""
    (keys,) = replicate_keys(mesh, server_key)

    def run(ct_batch: torch.Tensor, lut_acc: torch.Tensor) -> torch.Tensor:
        chunks = shard_ciphertext_batch(ct_batch, mesh)
        luts = _place(lut_acc, replicated(mesh))
        # issue every device's work before gathering any result
        outs = [k.ks_pbs(c, lut) for k, c, lut in zip(keys, chunks, luts)]
        return torch.cat([o.to(mesh[0], non_blocking=True) for o in outs])

    return run


def _synchronize(mesh: list) -> None:
    for dev in dict.fromkeys(mesh):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def scaling_sweep(server_key, lut_acc, ct_batch, device_counts,
                  iters: int = 3, devices=None) -> dict:
    """PBS/s of :func:`sharded_ks_pbs` at several mesh sizes: ``{n: PBS/s}``
    over the first n entries of :func:`make_batch_mesh` (or of ``devices``),
    each after one warm-up run, timed between synchronizations of every
    device of the mesh."""
    results = {}
    B = ct_batch.shape[0]
    for nd in device_counts:
        mesh = make_batch_mesh(nd, devices)
        run = sharded_ks_pbs(server_key, mesh)
        run(ct_batch, lut_acc)
        _synchronize(mesh)
        t0 = time.perf_counter()
        for _ in range(iters):
            run(ct_batch, lut_acc)
        _synchronize(mesh)
        results[nd] = B * iters / (time.perf_counter() - t0)
    return results
