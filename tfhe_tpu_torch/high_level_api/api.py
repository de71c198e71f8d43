"""Typed FHE API: config, key generation, FheUintN / FheIntN / FheBool with
operator overloading dispatched through a module-global server key (the
functional analog of the reference's thread-local ``InternalServerKey``,
``high_level_api/global_state.rs:66-120``).

Torch counterpart of the typed core of ``tfhe_tpu/high_level_api/api.py``.
Type zoo mirrors ``high_level_api/integers/{unsigned,signed}/mod.rs``:
FheUint2..FheUint2048 and FheInt2..FheInt2048 (extended sizes included).
Shift/rotate amounts are taken modulo the bit width, like the reference.
Keys live on ``device`` (the GPU unless the caller asks for another); every
op runs through the integer ``ServerKey`` on the key's device.

Compression keys and compressed ciphertext lists, the compressed server
key and the XOF key set, the compact public key and compact lists run on
the shortint side modules; noise squashing (``squash_noise``,
``SquashedNoiseFheUint``) and the lists of squashed values on the shortint
squashing modules; ``safe_serialize`` / ``safe_deserialize`` write and
read ``tfhe_tpu``'s envelopes, and ``generate_keys(use_keycache=True)``
shares its key cache. The ZK half of the compact lists
(``build_with_proof``, ``verify_and_expand``) proves and verifies on the
host (``zk/``), then expands and casts on the key's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from .. import integer
from ..integer.radix import BooleanBlock, RadixCiphertext
from ..shortint import list_compression as _lc
from ..shortint.ciphertext import NOMINAL_NOISE, ShortintCiphertext
from ..shortint.compact_public_key import CompactPrivateKey
from ..shortint.compact_public_key import CompactPublicKey as _ShortintCPK
from ..shortint.compressed_server_key import (
    CompressedServerKey as _ShortintCompressed)
from ..shortint.key_switching_key import KeySwitchingKey
from ..shortint.noise_squashing import (NoiseSquashingKey,
                                        NoiseSquashingPrivateKey,
                                        SquashedNoiseCiphertext)
from ..shortint.noise_squashing_compression import (
    NoiseSquashingCompressionKey, NoiseSquashingCompressionPrivateKey,
    compress_noise_squashed_ciphertexts_into_list)
from ..utils import serialization as _ser
from ..utils.params import ClassicPBSParameters, PARAM_MESSAGE_2_CARRY_2_KS_PBS

# ---------------------------------------------------------------------------
# config + keys
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Config:
    parameters: ClassicPBSParameters = PARAM_MESSAGE_2_CARRY_2_KS_PBS
    seed: Optional[int] = None
    # optional companion parameter sets (reference Config carries the same
    # optionals: config.rs / MetaParameters)
    noise_squashing_parameters: Optional[Any] = None
    noise_squashing_compression_parameters: Optional[Any] = None
    compression_parameters: Optional[Any] = None


class ConfigBuilder:
    """Reference ``high_level_api/config.rs:41``."""

    def __init__(self):
        self._params = PARAM_MESSAGE_2_CARRY_2_KS_PBS
        self._seed = None
        self._compression = self._squash = self._squash_comp = None

    def use_custom_parameters(self, params: ClassicPBSParameters) -> "ConfigBuilder":
        self._params = params
        return self

    def with_seed(self, seed: int) -> "ConfigBuilder":
        self._seed = seed
        return self

    def enable_compression(self, comp_params) -> "ConfigBuilder":
        """config.rs enable_compression."""
        self._compression = comp_params
        return self

    def enable_noise_squashing(self, squash_params) -> "ConfigBuilder":
        self._squash = squash_params
        return self

    def enable_noise_squashing_compression(self, params) -> "ConfigBuilder":
        """config.rs enable_noise_squashing_compression (requires
        enable_noise_squashing)."""
        self._squash_comp = params
        return self

    def build(self) -> Config:
        if self._squash_comp is not None:
            assert self._squash is not None, \
                "noise squashing compression requires noise squashing"
        return Config(
            parameters=self._params,
            seed=self._seed,
            noise_squashing_parameters=self._squash,
            noise_squashing_compression_parameters=self._squash_comp,
            compression_parameters=self._compression,
        )


class Tag:
    """User metadata carried by keys and propagated into every ciphertext
    produced under them (reference ``high_level_api/tag.rs:319``)."""

    def __init__(self, data: bytes = b""):
        self.data = bytes(data)

    def __eq__(self, other):
        return isinstance(other, Tag) and self.data == other.data

    def __repr__(self):
        return f"Tag({self.data!r})"


class ClientKey:
    def __init__(self, inner: integer.ClientKey, tag: Tag = None,
                 noise_squashing_private_key=None):
        self.inner = inner
        self.tag = tag or Tag()
        self.noise_squashing_private_key = noise_squashing_private_key
        self.noise_squashing_compression_private_key = None
        self.compression_private_key = None

    @classmethod
    def generate(cls, config: Config, device=None) -> "ClientKey":
        """Seeded keygen on ``device`` (the GPU when unset; raises without
        one). A config with noise-squashing parameters draws the squashing
        private key here, before any server key is drawn, as
        ``tfhe_tpu`` does."""
        seed = config.seed if config.seed is not None else 0
        inner = integer.ClientKey.generate(config.parameters, seed,
                                           device=device)
        nspk = None
        if config.noise_squashing_parameters is not None:
            nspk = NoiseSquashingPrivateKey.generate(
                inner.key, config.noise_squashing_parameters)
        return cls(inner, noise_squashing_private_key=nspk)


class ServerKey:
    def __init__(self, inner: integer.ServerKey, tag: Tag = None,
                 noise_squashing_key=None):
        self.inner = inner
        self.tag = tag or Tag()
        self.noise_squashing_key = noise_squashing_key
        self.noise_squashing_compression_key = None
        self.compression_key = None
        self.decompression_key = None


class CompressedServerKey:
    """Seeded server key at the HLAPI level (high_level_api/keys/server.rs
    CompressedServerKey)."""

    def __init__(self, inner: _ShortintCompressed, tag: Tag = None):
        self.inner = inner
        self.tag = tag or Tag()

    @classmethod
    def generate(cls, client_key: ClientKey) -> "CompressedServerKey":
        """From the client key's keygen stream, on its device."""
        return cls(_ShortintCompressed.generate(client_key.inner.key),
                   tag=client_key.tag)

    def decompress(self) -> ServerKey:
        return ServerKey(integer.ServerKey(self.inner.decompress()),
                         tag=self.tag)


def generate_keys(config: Config, use_keycache: bool = False, device=None):
    """Reference ``high_level_api/keys/mod.rs:40``: (ClientKey, ServerKey)
    on ``device`` (the GPU when unset), with the noise-squashing keys and
    the compression keys when the config enables them, all drawn from the
    client key's keygen stream in ``tfhe_tpu``'s order. ``use_keycache``
    takes the shortint keys from the disk cache
    (``keycache.get_shortint_keys``), generating and writing them on a
    miss."""
    if use_keycache:
        from ..keycache import get_shortint_keys

        sck, ssk = get_shortint_keys(config.parameters, config.seed or 0,
                                     device)
        ck = ClientKey(integer.ClientKey(sck))
        sk = ServerKey(integer.ServerKey(ssk))
    else:
        ck = ClientKey.generate(config, device=device)
        sk = ServerKey(integer.ServerKey.generate(ck.inner))
    if config.noise_squashing_parameters is not None:
        sck = ck.inner.key
        if ck.noise_squashing_private_key is None:
            ck.noise_squashing_private_key = NoiseSquashingPrivateKey.generate(
                sck, config.noise_squashing_parameters)
        sk.noise_squashing_key = NoiseSquashingKey.generate(
            sck, ck.noise_squashing_private_key)
        if config.noise_squashing_compression_parameters is not None:
            ck.noise_squashing_compression_private_key = (
                NoiseSquashingCompressionPrivateKey.generate(
                    sck, config.noise_squashing_compression_parameters))
            sk.noise_squashing_compression_key = (
                NoiseSquashingCompressionKey.generate(
                    sck, ck.noise_squashing_private_key,
                    ck.noise_squashing_compression_private_key))
    if config.compression_parameters is not None:
        ck.compression_private_key = _lc.new_compression_private_key(
            ck.inner.key, config.compression_parameters)
        sk.compression_key, sk.decompression_key = (
            _lc.new_compression_decompression_keys(
                ck.inner.key, ck.compression_private_key))
    return ck, sk


_SERVER_KEY: Optional[ServerKey] = None


def set_server_key(key: ServerKey) -> None:
    global _SERVER_KEY
    _SERVER_KEY = key


def unset_server_key() -> None:
    global _SERVER_KEY
    _SERVER_KEY = None


def _sk() -> integer.ServerKey:
    if _SERVER_KEY is None:
        raise RuntimeError("no server key set; call set_server_key(server_key)")
    return _SERVER_KEY.inner


def _recompose(vals: list, message_modulus: int, num_bits: int) -> int:
    """The clear integer of block values, least significant first."""
    out = 0
    for digit in reversed(vals):
        out = out * message_modulus + int(digit)
    return out % (1 << num_bits)


class SquashedNoiseFheUint:
    """Noise-squashed (u128) integer awaiting threshold decryption
    (high_level_api squashed_noise types)."""

    def __init__(self, squashed: SquashedNoiseCiphertext, num_bits: int,
                 message_modulus: int):
        self.squashed = squashed  # shortint SquashedNoiseCiphertext, batched
        self.num_bits = num_bits
        self.message_modulus = message_modulus

    def decrypt(self, client_key: "ClientKey") -> int:
        priv = client_key.noise_squashing_private_key
        if priv is None:
            raise ValueError("config lacks noise_squashing_parameters")
        return _recompose(priv.decrypt(self.squashed), self.message_modulus,
                          self.num_bits)

    def decrypt_with_compression_key(self, client_key: "ClientKey") -> int:
        """Decrypt an entry unpacked from a compressed list (it lives under
        the squashing *compression* key, private_key.rs:100)."""
        priv = client_key.noise_squashing_compression_private_key
        if priv is None:
            raise ValueError(
                "config lacks noise_squashing_compression_parameters")
        return _recompose(priv.decrypt(self.squashed), self.message_modulus,
                          self.num_bits)


class CompressedSquashedNoiseCiphertextList:
    """HLAPI packed list of noise-squashed integers
    (high_level_api/compressed_noise_squashed_ciphertext_list.rs). Built
    with the server-side compression key; entries unpack WITHOUT a PBS and
    decrypt under the squashing compression private key."""

    def __init__(self, inner, items):
        self.inner = inner  # shortint CompressedSquashedNoiseCiphertextList
        self.items = items  # [(num_bits, message_modulus, n_blocks)]

    @classmethod
    def builder(cls) -> "_SquashedNoiseListBuilder":
        return _SquashedNoiseListBuilder()

    def __len__(self) -> int:
        return len(self.items)

    def get(self, index: int) -> SquashedNoiseFheUint:
        if not 0 <= index < len(self.items):
            raise IndexError(f"index {index} out of a list of "
                             f"{len(self.items)}")
        start = sum(nb for _, _, nb in self.items[:index])
        num_bits, mm, nb = self.items[index]
        blocks = [self.inner.unpack(start + j) for j in range(nb)]
        batched = SquashedNoiseCiphertext(
            hi=torch.stack([b.hi for b in blocks]),
            lo=torch.stack([b.lo for b in blocks]),
            degree=max(b.degree for b in blocks), message_modulus=mm,
            carry_modulus=blocks[0].carry_modulus)
        return SquashedNoiseFheUint(batched, num_bits, mm)


class _SquashedNoiseListBuilder:
    def __init__(self):
        self._entries = []

    def push(self, value: SquashedNoiseFheUint) -> "_SquashedNoiseListBuilder":
        self._entries.append(value)
        return self

    def build(self) -> CompressedSquashedNoiseCiphertextList:
        """Pack the pushed values with the global server key's squashing
        compression key."""
        key = (_SERVER_KEY.noise_squashing_compression_key
               if _SERVER_KEY else None)
        if key is None:
            raise RuntimeError("server key lacks a noise squashing "
                               "compression key")
        inner = compress_noise_squashed_ciphertexts_into_list(
            key, [e.squashed for e in self._entries])
        items = [(e.num_bits, e.message_modulus,
                  e.squashed.hi.reshape(-1, e.squashed.hi.shape[-1]).shape[0])
                 for e in self._entries]
        return CompressedSquashedNoiseCiphertextList(inner, items)


class CompactPublicKey:
    """HLAPI compact public key with the casting key into the compute
    keyset (high_level_api compact lists + keys/public.rs)."""

    def __init__(self, pk: _ShortintCPK, ksk: KeySwitchingKey,
                 tag: Tag = None):
        self.pk = pk
        self.ksk = ksk
        self.tag = tag or Tag()

    @classmethod
    def new(cls, client_key: "ClientKey", server_key: "ServerKey",
            pke_params, ks_params, seed: int = 0) -> "CompactPublicKey":
        """The compact keys from ``seed`` and the casting key from the
        client key's keygen stream, on the client key's device."""
        ck = client_key.inner.key
        priv = CompactPrivateKey.generate(pke_params, seed=seed,
                                          device=ck.device)
        ksk = KeySwitchingKey.generate(priv, ck, server_key.inner.key,
                                       ks_params)
        return cls(_ShortintCPK.generate(priv), ksk, tag=client_key.tag)

    def encrypt_radix(self, value: int, ty):
        """A clear integer into ``ty`` (an FheUintN class) through the
        compact-PK path: compact list -> expand -> cast blockwise."""
        sk = _sk()
        nb = ty.num_blocks(sk.params)
        clist = self.pk.encrypt(_digits(int(value), nb,
                                        sk.params.message_modulus))
        return ty(_radix(self.ksk.cast(clist.expand_to_shortint()).ct, nb))


def _digits(value: int, nb: int, mm: int) -> list:
    """The ``nb`` base-``mm`` digits of ``value``, least significant first."""
    out = []
    for _ in range(nb):
        out.append(value % mm)
        value //= mm
    return out


def _radix(ct: torch.Tensor, nb: int) -> RadixCiphertext:
    """Fresh blocks int64[nb, dim+1] under the global server key's params
    as a radix ciphertext at nominal noise."""
    p = _sk().params
    return RadixCiphertext(
        ct=ct, degrees=np.full(nb, p.message_modulus - 1, dtype=np.int64),
        noise_levels=np.ones(nb, dtype=np.int64),
        message_modulus=p.message_modulus, carry_modulus=p.carry_modulus)


# ---------------------------------------------------------------------------
# safe serialization envelope (high_level_api/safe_serialization.rs:151-300)
# ---------------------------------------------------------------------------

def safe_serialize(obj, serialized_size_limit: int = 1 << 30) -> bytes:
    """Versioned envelope with a size bound (``tfhe_tpu``'s bytes); rejects
    oversized payloads at write time like the reference's SafeSerializer.
    FheUint/FheInt values, client keys and server keys."""
    if isinstance(obj, _FheIntegerBase):
        data = _ser.serialize_radix(obj.ct)
    elif isinstance(obj, ClientKey):
        data = _ser.serialize_shortint_client_key(obj.inner.key)
    elif isinstance(obj, ServerKey):
        data = _ser.serialize_shortint_server_key(obj.inner.key)
    else:
        raise TypeError(f"safe_serialize: unsupported type {type(obj)}")
    if len(data) > serialized_size_limit:
        raise ValueError(
            f"serialized size {len(data)} exceeds limit {serialized_size_limit}"
        )
    return data


def safe_deserialize(data: bytes, serialized_size_limit: int = 1 << 30,
                     conformance=None, device=None):
    """Bounded and conformance-checked load onto ``device`` (the GPU when
    unset); an integer comes back as the FheUint type of its width, a key
    as the shortint key, as in ``tfhe_tpu``."""
    if len(data) > serialized_size_limit:
        raise ValueError(
            f"payload size {len(data)} exceeds limit {serialized_size_limit}"
        )
    obj = _ser.deserialize(data, conformance=conformance, device=device)
    if isinstance(obj, RadixCiphertext):
        return _wrap_radix(obj)
    return obj


def _wrap_radix(radix_ct: RadixCiphertext):
    """A radix ciphertext in the FheUint type of its width."""
    width = radix_ct.num_blocks * int(math.log2(radix_ct.message_modulus))
    ty = _UNSIGNED_TYPES.get(width)
    if ty is None:
        raise ValueError(f"no FheUint type for width {width}")
    return ty(radix_ct)


# ---------------------------------------------------------------------------
# FheBool
# ---------------------------------------------------------------------------


class FheBool:
    def __init__(self, block: BooleanBlock):
        self.block = block

    @classmethod
    def encrypt(cls, value, client_key: "ClientKey") -> "FheBool":
        ct = client_key.inner.encrypt_radix(
            np.asarray(value).astype(np.uint64), 1
        )
        return cls(BooleanBlock(ct=ct.ct[..., 0, :]))

    def decrypt(self, client_key: ClientKey) -> np.ndarray | bool:
        out = _sk().decrypt_bool(client_key.inner, self.block)
        return bool(out) if out.shape == () else out

    def __and__(self, other: "FheBool") -> "FheBool":
        return FheBool(_sk().boolean_bitand(self.block, other.block))

    def __or__(self, other: "FheBool") -> "FheBool":
        return FheBool(_sk().boolean_bitor(self.block, other.block))

    def __xor__(self, other: "FheBool") -> "FheBool":
        sk = _sk()
        packed = self.block.ct * 2 + other.block.ct  # wraps as u64 does
        lut = sk._lut(lambda x: (x // 2) ^ (x % 2), degree=1)
        out = sk._pbs_blocks(packed[..., None, :], 3, 3, lut)
        return FheBool(BooleanBlock(ct=out[..., 0, :]))

    def __invert__(self) -> "FheBool":
        return FheBool(_sk().boolean_bitnot(self.block))

    def select(self, t: "_FheIntegerBase", e: "_FheIntegerBase"):
        """cond ? t : e (reference FheBool::if_then_else)."""
        return t._wrap(_sk().if_then_else(self.block, t.ct, e.ct))

    if_then_else = select


# ---------------------------------------------------------------------------
# integer types
# ---------------------------------------------------------------------------


class _FheIntegerBase:
    """Shared machinery of FheUintN / FheIntN (reference
    high_level_api/integers/). N bits = N/log2(mm) radix blocks."""

    NUM_BITS: int = 0
    SIGNED: bool = False

    def __init__(self, ct: RadixCiphertext):
        self.ct = ct

    # -- encryption -----------------------------------------------------------
    @classmethod
    def num_blocks(cls, params: ClassicPBSParameters) -> int:
        bits_per_block = int(math.log2(params.message_modulus))
        return max(1, cls.NUM_BITS // bits_per_block)

    @classmethod
    def encrypt(cls, value, client_key: ClientKey):
        nb = cls.num_blocks(client_key.inner.params)
        if cls.SIGNED:
            return cls(client_key.inner.encrypt_signed_radix(value, nb))
        return cls(client_key.inner.encrypt_radix(value, nb))

    try_encrypt = encrypt

    @classmethod
    def encrypt_trivial(cls, value):
        """A trivial encryption on the server key's device."""
        sk = _sk()
        nb = cls.num_blocks(sk.params)
        v = int(value) % (1 << cls.NUM_BITS)
        dim = sk.params.glwe_dimension * sk.params.polynomial_size + 1
        like = RadixCiphertext(
            ct=torch.zeros((nb, dim), dtype=torch.int64, device=sk.key.device),
            degrees=np.zeros(nb, dtype=np.int64),
            noise_levels=np.zeros(nb, dtype=np.int64),
            message_modulus=sk.params.message_modulus,
            carry_modulus=sk.params.carry_modulus,
        )
        return cls(sk._trivial_radix(v, nb, like))

    def decrypt(self, client_key: ClientKey):
        if self.SIGNED:
            out = client_key.inner.decrypt_signed_radix(self.ct)
        else:
            out = client_key.inner.decrypt_radix(self.ct)
        return int(out) if np.asarray(out).shape == () else out

    # -- helpers ----------------------------------------------------------------
    def _wrap(self, ct: RadixCiphertext):
        return type(self)(ct)

    def _scalar_mod(self, other) -> int:
        return int(other) % (1 << self.NUM_BITS)

    def _binary(self, other, enc_name: str, scalar_name: str):
        """An op with an encrypted or a clear (mod 2^N) right operand."""
        if isinstance(other, _FheIntegerBase):
            return self._wrap(getattr(_sk(), enc_name)(self.ct, other.ct))
        return self._wrap(
            getattr(_sk(), scalar_name)(self.ct, self._scalar_mod(other)))

    # -- arithmetic ---------------------------------------------------------------
    def __add__(self, other):
        return self._binary(other, "add", "scalar_add")

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return self._binary(other, "sub", "scalar_sub")

    def __rsub__(self, other):
        return (-self).__add__(other)

    def __mul__(self, other):
        return self._binary(other, "mul", "scalar_mul")

    def __rmul__(self, other):
        return self.__mul__(other)

    def __neg__(self):
        return self._wrap(_sk().neg(self.ct))

    def __truediv__(self, other):
        return self.div(other)

    def __floordiv__(self, other):
        return self.div(other)

    def __mod__(self, other):
        return self.rem(other)

    def div(self, other):
        return self.div_rem(other)[0]

    def rem(self, other):
        return self.div_rem(other)[1]

    def div_rem(self, other):
        fn = _sk().signed_div_rem if self.SIGNED else _sk().div_rem
        q, r = fn(self.ct, other.ct)
        return self._wrap(q), self._wrap(r)

    def overflowing_add(self, other):
        res, ov = _sk().add_parallelized(self.ct, other.ct, compute_overflow=True)
        return self._wrap(res), FheBool(ov)

    def overflowing_sub(self, other):
        res, bw = _sk().sub_parallelized(self.ct, other.ct, compute_overflow=True)
        return self._wrap(res), FheBool(bw)

    # -- bitwise --------------------------------------------------------------
    def __and__(self, other):
        return self._binary(other, "bitand", "scalar_bitand")

    def __or__(self, other):
        return self._binary(other, "bitor", "scalar_bitor")

    def __xor__(self, other):
        return self._binary(other, "bitxor", "scalar_bitxor")

    def __invert__(self):
        return self._wrap(_sk().bitnot(self.ct))

    # -- shifts / rotates -------------------------------------------------------
    def __lshift__(self, other):
        if isinstance(other, _FheIntegerBase):
            return self._wrap(_sk().left_shift(self.ct, other.ct))
        return self._wrap(_sk().scalar_left_shift(self.ct, int(other)))

    def __rshift__(self, other):
        if isinstance(other, _FheIntegerBase) and self.SIGNED:
            return self._wrap(_sk().arithmetic_right_shift_encrypted(self.ct, other.ct))
        if isinstance(other, _FheIntegerBase):
            return self._wrap(_sk().right_shift(self.ct, other.ct))
        if self.SIGNED:
            return self._wrap(_sk().arithmetic_right_shift(self.ct, int(other)))
        return self._wrap(_sk().scalar_right_shift(self.ct, int(other)))

    def squash_noise(self) -> SquashedNoiseFheUint:
        """Re-encrypt with the 128-bit PBS for threshold decryption
        (high_level_api squash_noise; shortint/noise_squashing/): the
        carry-clean blocks through the global server key's squashing key,
        on its device."""
        nsk = _SERVER_KEY.noise_squashing_key if _SERVER_KEY else None
        if nsk is None:
            raise RuntimeError("server key lacks a noise squashing key")
        sk = _sk()
        clean = sk._clean(self.ct)
        blocks = ShortintCiphertext(
            ct=clean.ct, degree=int(np.max(clean.degrees)),
            noise_level=int(np.max(clean.noise_levels)),
            message_modulus=clean.message_modulus,
            carry_modulus=clean.carry_modulus)
        return SquashedNoiseFheUint(
            nsk.squash_ciphertext_noise(sk.key, blocks), self.NUM_BITS,
            clean.message_modulus)

    def rotate_left(self, amount: int):
        return self._wrap(_sk().scalar_rotate_left(self.ct, int(amount)))

    def rotate_right(self, amount: int):
        return self._wrap(_sk().scalar_rotate_right(self.ct, int(amount)))

    # -- comparisons ------------------------------------------------------------
    def _cmp(self, other, enc_name, scalar_name) -> FheBool:
        sk = _sk()
        if isinstance(other, _FheIntegerBase):
            return FheBool(getattr(sk, enc_name)(self.ct, other.ct))
        return FheBool(getattr(sk, scalar_name)(self.ct, self._scalar_mod(other)))

    def _ordered(self, other, name: str) -> FheBool:
        prefix = "signed_" if self.SIGNED else ""
        return self._cmp(other, prefix + name, f"{prefix}scalar_{name}")

    def eq(self, other) -> FheBool:
        return self._cmp(other, "eq", "scalar_eq")

    def ne(self, other) -> FheBool:
        return self._cmp(other, "ne", "scalar_ne")

    def lt(self, other) -> FheBool:
        return self._ordered(other, "lt")

    def le(self, other) -> FheBool:
        return self._ordered(other, "le")

    def gt(self, other) -> FheBool:
        return self._ordered(other, "gt")

    def ge(self, other) -> FheBool:
        return self._ordered(other, "ge")

    def min(self, other):
        fn = _sk().signed_min if self.SIGNED else _sk().min
        return self._wrap(fn(self.ct, other.ct))

    def max(self, other):
        fn = _sk().signed_max if self.SIGNED else _sk().max
        return self._wrap(fn(self.ct, other.ct))

    def abs(self):
        if not self.SIGNED:
            return self
        return self._wrap(_sk().abs(self.ct))

    def count_ones(self):
        return self._wrap(_sk().count_ones(self.ct))

    def count_zeros(self):
        return self._wrap(_sk().count_zeros(self.ct))

    def is_even(self) -> FheBool:
        return FheBool(_sk().is_even(self.ct))

    def is_odd(self) -> FheBool:
        return FheBool(_sk().is_odd(self.ct))

    def ilog2(self):
        return self._wrap(_sk().ilog2(self.ct))

    # -- casts ------------------------------------------------------------------
    def cast_into(self, target_cls):
        """FheUintA -> FheUintB / FheIntB (reference CastInto impls)."""
        sk = _sk()
        nb_out = target_cls.num_blocks(sk.params)
        if self.SIGNED and nb_out > self.ct.num_blocks:
            ct = sk.signed_cast_to_num_blocks(self.ct, nb_out)
        else:
            ct = sk.cast_to_num_blocks(self.ct, nb_out)
        return target_cls(ct)


# explicit signed/unsigned markers for isinstance checks
class _FheUintMarker:
    SIGNED = False


class _FheIntMarker:
    SIGNED = True


_SIZES = (2, 4, 6, 8, 10, 12, 14, 16, 24, 32, 40, 48, 56, 64, 72, 80, 88, 96,
          104, 112, 120, 128, 136, 144, 152, 160, 168, 176, 184, 192, 200,
          208, 216, 224, 232, 240, 248, 256, 512, 1024, 2048)

_UNSIGNED_TYPES = {}
_SIGNED_TYPES = {}

for _bits in _SIZES:
    _UNSIGNED_TYPES[_bits] = type(
        f"FheUint{_bits}", (_FheIntegerBase, _FheUintMarker),
        {"NUM_BITS": _bits, "SIGNED": False},
    )
    _SIGNED_TYPES[_bits] = type(
        f"FheInt{_bits}", (_FheIntegerBase, _FheIntMarker),
        {"NUM_BITS": _bits, "SIGNED": True},
    )

globals().update({f"FheUint{b}": c for b, c in _UNSIGNED_TYPES.items()})
globals().update({f"FheInt{b}": c for b, c in _SIGNED_TYPES.items()})


def fhe_uint(bits: int):
    """Lookup a FheUint type by bit width."""
    return _UNSIGNED_TYPES[bits]


def fhe_int(bits: int):
    return _SIGNED_TYPES[bits]


# ---------------------------------------------------------------------------
# arrays (high_level_api/array/): elementwise ops over batched radix cts
# ---------------------------------------------------------------------------

class _FheArrayBase:
    """A batch of same-width encrypted integers in ONE radix ciphertext with
    a leading batch axis — elementwise ops are a single batched KS->PBS
    pipeline, the analog of the reference's array types."""

    SCALAR_TYPE = None  # FheUintN

    def __init__(self, ct: RadixCiphertext):
        self.ct = ct

    @classmethod
    def encrypt(cls, values, client_key: ClientKey):
        nb = cls.SCALAR_TYPE.num_blocks(client_key.inner.params)
        vals = np.asarray(values, dtype=np.uint64)
        assert vals.ndim == 1, "FheArray encrypts a 1-D list of values"
        return cls(client_key.inner.encrypt_radix(vals, nb))

    def decrypt(self, client_key: ClientKey) -> np.ndarray:
        return np.atleast_1d(client_key.inner.decrypt_radix(self.ct))

    def __len__(self):
        return self.ct.ct.shape[0]

    def __getitem__(self, idx):
        """An element (a FheUintN) or a slice (an array): views of this
        array's tensor, which no op writes into."""
        sub = self.ct.with_ct(self.ct.ct[idx])
        if isinstance(idx, slice):
            return type(self)(sub)
        return self.SCALAR_TYPE(sub)

    def _wrap(self, ct):
        return type(self)(ct)

    def __add__(self, other):
        return self._wrap(_sk().add(self.ct, other.ct))

    def __sub__(self, other):
        return self._wrap(_sk().sub(self.ct, other.ct))

    def __mul__(self, other):
        return self._wrap(_sk().mul(self.ct, other.ct))

    def __and__(self, other):
        return self._wrap(_sk().bitand(self.ct, other.ct))

    def __or__(self, other):
        return self._wrap(_sk().bitor(self.ct, other.ct))

    def __xor__(self, other):
        return self._wrap(_sk().bitxor(self.ct, other.ct))

    def eq(self, other):
        return FheBool(_sk().eq(self.ct, other.ct))

    def sum(self):
        """Multi-operand parallel sum of all elements -> scalar FheUint."""
        parts = [self[i].ct for i in range(len(self))]
        return self.SCALAR_TYPE(_sk().sum_ciphertexts_parallelized(parts))


_UNSIGNED_ARRAY_TYPES = {}
for _bits in _SIZES:
    _UNSIGNED_ARRAY_TYPES[_bits] = type(
        f"FheUint{_bits}Array", (_FheArrayBase,),
        {"SCALAR_TYPE": _UNSIGNED_TYPES[_bits]},
    )
globals().update(
    {f"FheUint{b}Array": c for b, c in _UNSIGNED_ARRAY_TYPES.items()}
)


def fhe_uint_array(bits: int):
    return _UNSIGNED_ARRAY_TYPES[bits]


# ---------------------------------------------------------------------------
# compressed ciphertext lists (high_level_api/compressed_ciphertext_list.rs)
# ---------------------------------------------------------------------------

def _typed(ty, ct: torch.Tensor, nb: int):
    """Blocks int64[nb, dim+1] as a value of ``ty`` (FheBool or an
    FheUintN / FheIntN class)."""
    if ty is FheBool:
        return FheBool(BooleanBlock(ct=ct[0]))
    return ty(_radix(ct, nb))


class HlCompressedCiphertextList:
    """Packed-GLWE storage of a list of FHE values of mixed types; items
    come back by index through the decompression key."""

    def __init__(self, packed: _lc.CompressedCiphertextList, entries):
        self.packed = packed
        self.entries = entries  # [(type, num_blocks, block_offset)]

    def __len__(self):
        return len(self.entries)

    def get(self, idx: int):
        """Decompress item ``idx`` into its FHE type (the global server key
        must carry the decompression key)."""
        sk = _SERVER_KEY
        assert sk is not None and sk.decompression_key is not None, (
            "server key with compression enabled must be set")
        ty, nb, off = self.entries[idx]
        out = _lc.decompress(self.packed, sk.decompression_key,
                             sk.inner.key, indices=range(off, off + nb))
        return _typed(ty, out.ct, nb)


class CompressedCiphertextListBuilder:
    """push(FheUintN | FheIntN | FheBool) ... -> build(): all blocks packed
    into shared GLWEs (CompressedCiphertextListBuilder,
    compressed_ciphertext_list.rs)."""

    def __init__(self):
        self._items = []

    def push(self, item) -> "CompressedCiphertextListBuilder":
        self._items.append(item)
        return self

    def build(self) -> HlCompressedCiphertextList:
        sk = _SERVER_KEY
        assert sk is not None and sk.compression_key is not None, (
            "server key with compression enabled must be set")
        blocks, entries, off = [], [], 0
        for item in self._items:
            if isinstance(item, FheBool):
                blocks.append(item.block.ct[None])
                entries.append((FheBool, 1, off))
            else:
                blocks.append(item.ct.ct)
                entries.append((type(item), item.ct.ct.shape[-2], off))
            off += entries[-1][1]
        p = sk.inner.key.params
        batched = ShortintCiphertext(
            ct=torch.cat(blocks), degree=p.message_modulus - 1,
            noise_level=NOMINAL_NOISE, message_modulus=p.message_modulus,
            carry_modulus=p.carry_modulus)
        return HlCompressedCiphertextList(
            _lc.compress(sk.compression_key, batched), entries)


# ---------------------------------------------------------------------------
# compact ciphertext lists (high_level_api/compact_list.rs)
# ---------------------------------------------------------------------------

class HlCompactCiphertextList:
    """Shared-mask compact list of typed values, expanded into the compute
    keyset through the casting key."""

    def __init__(self, clist, entries, pk: CompactPublicKey, proofs=None,
                 metadata=b""):
        self.clist = clist  # shortint CompactCiphertextList
        self.entries = entries  # [(type, num_blocks, digit_offset)]
        self.pk = pk
        self.proofs = proofs
        self.metadata = metadata

    def __len__(self):
        return len(self.entries)

    def expand(self):
        """-> the list's FHE values (the whole list expanded and cast
        once)."""
        cast = self.pk.ksk.cast(self.clist.expand_to_shortint())
        return [_typed(ty, cast.ct[off:off + nb], nb)
                for ty, nb, off in self.entries]

    def verify_and_expand(self, crs, metadata: bytes = b""):
        """The ZK path (compact_list.rs:638
        ProvenCompactCiphertextList::verify_and_expand): every bin's proof
        verified on the host, then :meth:`expand` on the key's device;
        raises ``ValueError`` on a proof that does not verify."""
        from ..zk.proven_list import ProvenCompactCiphertextList

        assert self.proofs is not None, "list was built without proofs"
        proven = ProvenCompactCiphertextList(
            ct_list=self.clist, proofs=self.proofs, metadata=self.metadata)
        if not proven.verify(crs, self.pk.pk, metadata=metadata):
            raise ValueError("invalid ZK proof for compact ciphertext list")
        return self.expand()


class CompactCiphertextListBuilder:
    """push typed clear values, then build()."""

    def __init__(self, pk: CompactPublicKey):
        self.pk = pk
        self._digits = []
        self._entries = []

    def push(self, value, ty) -> "CompactCiphertextListBuilder":
        p = _sk().params
        if ty is FheBool:
            self._entries.append((FheBool, 1, len(self._digits)))
            self._digits.append(int(bool(value)))
            return self
        nb = ty.num_blocks(p)
        self._entries.append((ty, nb, len(self._digits)))
        self._digits += _digits(int(value), nb, p.message_modulus)
        return self

    def build(self) -> HlCompactCiphertextList:
        clist = self.pk.pk.encrypt(np.array(self._digits, dtype=np.uint64))
        return HlCompactCiphertextList(clist, self._entries, self.pk)

    def build_with_proof(self, crs,
                         metadata: bytes = b"") -> HlCompactCiphertextList:
        """The ZK path (ProvenCompactCiphertextList::encrypt_and_prove): the
        list encrypted on the key's device with a proof a bin, proven on
        the host."""
        from ..zk.proven_list import ProvenCompactCiphertextList

        proven = ProvenCompactCiphertextList.encrypt_and_prove(
            self.pk.pk, np.array(self._digits, dtype=np.uint64), crs,
            metadata=metadata)
        return HlCompactCiphertextList(
            proven.ct_list, self._entries, self.pk, proofs=proven.proofs,
            metadata=metadata)


# ---------------------------------------------------------------------------
# XOF key set (high_level_api/xof_key_set.rs): every key from ONE seed
# ---------------------------------------------------------------------------

class CompressedXofKeySet:
    """All key material derived from a single seed: ship the seed and the
    compressed server key's bodies, expand anywhere (xof_key_set.rs:117,
    365). Two parties holding the seed derive the same keys."""

    def __init__(self, seed: int, config: Config, compressed_server_key,
                 device=None):
        self.seed = seed
        self.config = config
        self.compressed_server_key = compressed_server_key
        self.device = device

    @classmethod
    def generate(cls, config: Config, seed: int,
                 device=None) -> "CompressedXofKeySet":
        """On ``device`` (the GPU when unset)."""
        cfg = Config(parameters=config.parameters, seed=seed,
                     noise_squashing_parameters=config
                     .noise_squashing_parameters,
                     compression_parameters=config.compression_parameters)
        ck = ClientKey.generate(cfg, device=device)
        return cls(seed=seed, config=cfg,
                   compressed_server_key=CompressedServerKey.generate(ck),
                   device=ck.inner.key.device)

    def decompress(self):
        """-> (ClientKey, ServerKey), byte-equal for equal seeds."""
        ck = ClientKey.generate(self.config, device=self.device)
        return ck, self.compressed_server_key.decompress()
