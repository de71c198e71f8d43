"""Host-or-device array wrap for the thin client's outputs.

Torch counterpart of ``tfhe_tpu/utils/hostarray.py``. The thin client
(:mod:`tfhe_tpu_torch.client`, the analog of the reference's browser client
API ``tfhe/src/js_on_wasm_api/``) hands out plain numpy arrays, as
``tfhe_tpu``'s does, unless the caller names a device for them.
"""

from __future__ import annotations

import numpy as np
import torch

from .._torus import from_u64, to_u64


def asarray(x, device=None):
    """A torus array (numpy u64 or an int64 tensor holding u64 values) as
    the numpy u64 array ``tfhe_tpu`` hands out when ``device`` is None (the
    host), else as an int64 tensor on ``device`` with the same bits."""
    if device is None:
        return to_u64(x) if isinstance(x, torch.Tensor) else np.asarray(
            x, dtype=np.uint64)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return from_u64(x, device)
