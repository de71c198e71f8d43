"""Shortint layer of the port: client and server keys, LUTs, and the side
modules (public and compact public keys, keyset casting, compressed server
keys, list compression, WoP-PBS). The names are ``tfhe_tpu.shortint``'s;
the noise-squashing ones raise until ROADMAP Queue A item 7 ports them."""

from importlib import import_module

from .._roadmap import not_ported, unported_class
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
}


def __getattr__(name):
    if name in _SERVER_SIDE:
        return getattr(import_module(f".{_SERVER_SIDE[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

NoiseSquashingKey = unported_class(
    "NoiseSquashingKey", "noise squashing", (7,), ("generate",))
NoiseSquashingPrivateKey = unported_class(
    "NoiseSquashingPrivateKey", "noise squashing", (7,), ("generate",))
SquashedNoiseCiphertext = unported_class(
    "SquashedNoiseCiphertext", "noise squashing", (7,))
CompressedSquashedNoiseCiphertextList = unported_class(
    "CompressedSquashedNoiseCiphertextList",
    "lists of noise-squashed ciphertexts", (7,))
NoiseSquashingCompressionKey = unported_class(
    "NoiseSquashingCompressionKey", "lists of noise-squashed ciphertexts",
    (7,), ("generate",))
NoiseSquashingCompressionPrivateKey = unported_class(
    "NoiseSquashingCompressionPrivateKey",
    "lists of noise-squashed ciphertexts", (7,), ("generate",))


def compress_noise_squashed_ciphertexts_into_list(*args, **kwargs):
    raise not_ported("lists of noise-squashed ciphertexts", 7)


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
