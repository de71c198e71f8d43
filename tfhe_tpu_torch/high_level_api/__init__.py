"""high_level_api — the user-facing typed API.

Torch counterpart of ``tfhe_tpu/high_level_api/`` (reference
``tfhe/src/high_level_api/``): ``generate_keys`` (keys/mod.rs:40),
``set_server_key`` (global_state.rs:66), ``ConfigBuilder`` (config.rs:41),
``FheBool``, ``FheUint2..FheUint2048``, ``FheInt2..FheInt2048`` (extended
sizes included), operator overloading, the ``FheUint*Array`` types and
``KVStore`` (``kv_store``).

Usage (mirrors the reference README; keys on the GPU unless ``device`` says
otherwise):

    from tfhe_tpu_torch.high_level_api import *
    config = ConfigBuilder().build()
    client_key, server_key = generate_keys(config)
    set_server_key(server_key)
    a = FheUint32.encrypt(1409, client_key)
    b = FheUint32.encrypt(3, client_key)
    c = a + b
    assert c.decrypt(client_key) == 1412
"""

from . import api as _api
from .api import (  # noqa: F401
    CompressedSquashedNoiseCiphertextList,
    Config,
    ConfigBuilder,
    ClientKey,
    ServerKey,
    FheBool,
    fhe_int,
    fhe_uint,
    generate_keys,
    set_server_key,
    unset_server_key,
)

# re-export the whole FheUintN / FheIntN zoo
_zoo = [n for n in dir(_api) if n.startswith(("FheUint", "FheInt"))]
globals().update({n: getattr(_api, n) for n in _zoo})

__all__ = [
    "CompressedSquashedNoiseCiphertextList",
    "Config", "ConfigBuilder", "ClientKey", "ServerKey", "FheBool",
    "fhe_uint", "fhe_int", "generate_keys", "set_server_key",
    "unset_server_key", *_zoo,
]
