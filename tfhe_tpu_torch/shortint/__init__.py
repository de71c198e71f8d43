"""Shortint layer of the port: client and server keys, LUTs, and the side
modules (public and compact public keys, keyset casting, compressed server
keys, list compression, WoP-PBS, noise squashing and the lists of squashed
ciphertexts). The names are ``tfhe_tpu.shortint``'s."""

from importlib import import_module

from .ciphertext import (LookupTable, ManyLookupTable,  # noqa: F401
                         ShortintCiphertext)
from .client_key import ClientKey  # noqa: F401
from .compact_public_key import (CompactCiphertextList,  # noqa: F401
                                 CompactPrivateKey, CompactPublicKey)

#: the server stack's names, imported at first use, so that the client
#: side (client and compact keys, ciphertexts: the thin client,
#: ``tfhe_tpu_torch.client``) imports without the kernels' modules
_SERVER_SIDE = {
    "CompressedServerKey": "compressed_server_key",
    "KeySwitchingKey": "key_switching_key",
    "re_randomize_ciphertexts": "key_switching_key",
    "PublicKey": "public_key",
    "ServerKey": "server_key",
    "WopbsKey": "wopbs",
    "NoiseSquashingKey": "noise_squashing",
    "NoiseSquashingPrivateKey": "noise_squashing",
    "SquashedNoiseCiphertext": "noise_squashing",
    "CompressedSquashedNoiseCiphertextList": "noise_squashing_compression",
    "NoiseSquashingCompressionKey": "noise_squashing_compression",
    "NoiseSquashingCompressionPrivateKey": "noise_squashing_compression",
    "compress_noise_squashed_ciphertexts_into_list":
        "noise_squashing_compression",
}


def __getattr__(name):
    if name in _SERVER_SIDE:
        return getattr(import_module(f".{_SERVER_SIDE[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def gen_keys(params, seed: int = 0, device=None):
    """(ClientKey, ServerKey) on ``device`` (the GPU when unset): reference
    ``shortint::gen_keys``."""
    from .server_key import ServerKey

    ck = ClientKey.generate(params, seed, device=device)
    return ck, ServerKey.generate(ck)


__all__ = ["LookupTable", "ShortintCiphertext", "ClientKey",
           "CompactCiphertextList", "CompactPrivateKey", "CompactPublicKey",
           "CompressedServerKey", "KeySwitchingKey",
           "re_randomize_ciphertexts", "NoiseSquashingKey",
           "NoiseSquashingPrivateKey", "SquashedNoiseCiphertext",
           "CompressedSquashedNoiseCiphertextList",
           "NoiseSquashingCompressionKey",
           "NoiseSquashingCompressionPrivateKey",
           "compress_noise_squashed_ciphertexts_into_list", "PublicKey",
           "ServerKey", "WopbsKey", "gen_keys"]
