"""integer — multi-block radix big integers over shortint blocks.

Torch counterpart of ``tfhe_tpu/integer/`` (reference
``tfhe/src/integer/``): ``radix`` (RadixCiphertext, the client and server
keys), ``ops_extra`` (the server key's op tail), ``crt`` (residue number
system integers) and ``bigint`` (fixed-width clear integers).
"""

from .radix import BooleanBlock, ClientKey, RadixCiphertext, ServerKey  # noqa: F401


def gen_keys(params, seed: int = 0, device=None):
    """Seeded integer client and server keys on ``device`` (the GPU when
    unset; raises without one)."""
    ck = ClientKey.generate(params, seed, device=device)
    sk = ServerKey.generate(ck)
    return ck, sk
