"""Boolean layer of the port: the encrypted boolean gate API.

Reference: ``tfhe/src/boolean/``. Messages are encoded at +-q/8
(``boolean/mod.rs:72-78``); a gate is a small linear combination followed
by a sign bootstrap on the exact CRT path and a keyswitch back to the small
key (see :mod:`.keys`).
"""

from .keys import (  # noqa: F401
    PLAINTEXT_FALSE,
    PLAINTEXT_TRUE,
    BooleanCiphertext,
    ClientKey,
    ServerKey,
    gen_keys,
)
