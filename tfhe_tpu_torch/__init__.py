"""tfhe_tpu_torch — the PyTorch/CUDA port of tfhe_tpu for NVIDIA Hopper.

The package mirrors ``tfhe_tpu``'s module paths (``utils/``, ``core/``,
``ops/``, ``shortint/``) so each counterpart is easy to find, and is held
bit-for-bit against it by the ``tests/test_torch_*.py`` suite. It imports
``torch`` and ``numpy`` only: never ``jax`` and nothing of ``tfhe_tpu``.

Conventions:

- Torus values (mod 2^64) ride in ``torch.int64`` with wrap-around
  arithmetic; see :mod:`tfhe_tpu_torch._torus` for logical shifts, unsigned
  compares and the numpy u64 bridge.
- Entry points take a ``device``. Left unset it means the GPU, and the call
  raises when no GPU is present (:mod:`tfhe_tpu_torch._device`).
- The blind-rotation hot path runs hand-written CUDA kernels
  (``csrc/*.cu``, built with nvcc at first use by :mod:`._build`); a tensor
  on the CPU takes each kernel's plain PyTorch version instead.

Layer map (the shortint KS -> PBS main path, the boolean gates, Trivium):
    ops/       — polynomial, decomposition, NTT, BNF2 spec, exact CRT spec,
                 kernel wrappers, server-side keyswitch / modulus switch /
                 PBS (BNF2 and exact CRT)
    core/      — secret keys, LWE/GLWE encryption, KSK and BSK generation,
                 the BSK's CRT transform
    shortint/  — ClientKey, ServerKey, LUTs, ciphertexts
    boolean/   — boolean ClientKey, ServerKey, gates
    apps/      — FHE Trivium and transciphering
    utils/     — parameter sets, encoding, AES-CTR CSPRNG
    convert.py — carries tfhe_tpu key arrays into the port
"""

__version__ = "0.1.0"

from .utils.params import (  # noqa: E402,F401
    ClassicPBSParameters,
    PARAM_MESSAGE_1_CARRY_1_KS_PBS,
    PARAM_MESSAGE_2_CARRY_2_KS_PBS,
    PARAM_TEST_TOY,
)
