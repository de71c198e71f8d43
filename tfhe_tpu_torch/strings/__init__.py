"""strings — encrypted ASCII strings over the radix integer layer.

Torch counterpart of ``tfhe_tpu/strings/`` (reference ``tfhe/src/strings/``).
"""

from .ascii import FheAsciiString, StringClientKey, StringServerKey  # noqa: F401
