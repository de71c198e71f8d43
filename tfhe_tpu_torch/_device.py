"""Device selection for the port's entry points.

Every entry point takes ``device``. ``None`` means the GPU: the port is a
GPU program, and a silent fall back to the CPU would hide a missing card
behind a run that is orders of magnitude slower. Tests pass
``device="cpu"`` explicitly, which routes every kernel wrapper to its plain
PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on; raises without a GPU when
    no device was asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tfhe_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
