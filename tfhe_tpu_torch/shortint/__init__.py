"""Shortint layer of the port: client and server keys, LUTs, and the side
modules (public and compact public keys, keyset casting, compressed server
keys, list compression, WoP-PBS). The names are ``tfhe_tpu.shortint``'s;
the noise-squashing ones raise until ROADMAP Queue A item 7 ports them."""

from .._roadmap import not_ported, unported_class
from .ciphertext import (LookupTable, ManyLookupTable,  # noqa: F401
                         ShortintCiphertext)
from .client_key import ClientKey  # noqa: F401
from .compact_public_key import (CompactCiphertextList,  # noqa: F401
                                 CompactPrivateKey, CompactPublicKey)
from .compressed_server_key import CompressedServerKey  # noqa: F401
from .key_switching_key import (KeySwitchingKey,  # noqa: F401
                                re_randomize_ciphertexts)
from .public_key import PublicKey  # noqa: F401
from .server_key import ServerKey
from .wopbs import WopbsKey  # noqa: F401

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
