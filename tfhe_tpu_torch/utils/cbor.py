"""Minimal CBOR (RFC 8949) encoder, ciborium-compatible for the subset the
reference's serde structs produce (``ciborium::ser::into_writer`` of derived
``Serialize`` impls, see ``apps/test-vectors/src/main.rs:113``):

- serde struct        -> definite-length map with text keys in field order
- Vec<T>/slices       -> definite-length array
- unsigned ints       -> major type 0, minimal-length argument encoding
- signed negatives    -> major type 1 (not used by the entity structs)
- newtype structs     -> the inner value (PolynomialSize(usize) -> uint)

Torch counterpart of ``tfhe_tpu/utils/cbor.py``, byte for byte: the CBOR of
every core_crypto entity stored by the reference test-vector generator
(LweSecretKey, LweCiphertext, GlweCiphertext, LweKeyswitchKey,
LweBootstrapKey/GgswCiphertextList, SerializableCiphertextModulus). Every
array argument may be numpy or a torus tensor (``int64`` holding the u64
values, as the port keeps them).
"""

from __future__ import annotations

import io

import numpy as np
import torch

from .._torus import to_u64


def _write_head(out: io.BytesIO, major: int, arg: int) -> None:
    mt = major << 5
    if arg < 24:
        out.write(bytes([mt | arg]))
    elif arg < 0x100:
        out.write(bytes([mt | 24, arg]))
    elif arg < 0x10000:
        out.write(bytes([mt | 25]) + arg.to_bytes(2, "big"))
    elif arg < 0x100000000:
        out.write(bytes([mt | 26]) + arg.to_bytes(4, "big"))
    else:
        out.write(bytes([mt | 27]) + arg.to_bytes(8, "big"))


def encode_uint(out: io.BytesIO, v: int) -> None:
    assert v >= 0
    _write_head(out, 0, int(v))


def encode_text(out: io.BytesIO, s: str) -> None:
    b = s.encode("utf-8")
    _write_head(out, 3, len(b))
    out.write(b)


def encode_uint_array(out: io.BytesIO, vals) -> None:
    """Definite-length array of unsigned ints.

    Vectorized: elements are bucketed by CBOR argument size class (<24,
    u8, u16, u32, u64) and the whole byte stream is assembled with numpy
    scatter writes — no per-element Python loop (the valid_params_128 BSK
    is ~8M u64; element-wise encoding dominated generation time)."""
    if isinstance(vals, torch.Tensor):
        vals = to_u64(vals.to(torch.int64))
    a = np.asarray(vals, dtype=np.uint64).reshape(-1)
    _write_head(out, 4, a.size)
    if a.size == 0:
        return
    lens = np.full(a.size, 9, dtype=np.int64)
    lens[a < (1 << 32)] = 5
    lens[a < (1 << 16)] = 3
    lens[a < 256] = 2
    lens[a < 24] = 1
    starts = np.zeros(a.size, dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    buf = np.zeros(int(lens.sum()), dtype=np.uint8)
    be = a.astype(">u8").view(np.uint8).reshape(-1, 8)  # big-endian planes
    for ln, head, nb in ((1, None, 0), (2, 0x18, 1), (3, 0x19, 2),
                         (5, 0x1A, 4), (9, 0x1B, 8)):
        m = lens == ln
        if not m.any():
            continue
        s = starts[m]
        if head is None:
            buf[s] = a[m].astype(np.uint8)  # mt 0 | v, v < 24
        else:
            buf[s] = head
            bem = be[m][:, 8 - nb:]
            for j in range(nb):
                buf[s + 1 + j] = bem[:, j]
    out.write(buf.tobytes())


def encode_map(out: io.BytesIO, items) -> None:
    """items: list of (key_str, encoder_fn) — encoder_fn(out) writes the
    value. Definite-length map, insertion (struct field) order."""
    _write_head(out, 5, len(items))
    for k, enc in items:
        encode_text(out, k)
        enc(out)


# ---------------------------------------------------------------------------
# reference entity layouts (struct field order from entities/*.rs)
# ---------------------------------------------------------------------------

def _modulus_map(modulus: int, scalar_bits: int = 64):
    """SerializableCiphertextModulus (ciphertext_modulus.rs:48): 0 = native."""
    def enc(out):
        encode_map(out, [
            ("modulus", lambda o: encode_uint(o, modulus)),
            ("scalar_bits", lambda o: encode_uint(o, scalar_bits)),
        ])
    return enc


def lwe_secret_key_bytes(bits) -> bytes:
    """LweSecretKey { data } (entities/lwe_secret_key.rs:25)."""
    out = io.BytesIO()
    encode_map(out, [("data", lambda o: encode_uint_array(o, bits))])
    return out.getvalue()


def lwe_ciphertext_bytes(data, modulus: int = 0) -> bytes:
    """LweCiphertext { data, ciphertext_modulus }
    (entities/lwe_ciphertext.rs:534)."""
    out = io.BytesIO()
    encode_map(out, [
        ("data", lambda o: encode_uint_array(o, data)),
        ("ciphertext_modulus", _modulus_map(modulus)),
    ])
    return out.getvalue()


def glwe_ciphertext_bytes(data, polynomial_size: int, modulus: int = 0) -> bytes:
    """GlweCiphertext { data, polynomial_size, ciphertext_modulus }
    (entities/glwe_ciphertext.rs:315)."""
    out = io.BytesIO()
    encode_map(out, [
        ("data", lambda o: encode_uint_array(o, data)),
        ("polynomial_size", lambda o: encode_uint(o, polynomial_size)),
        ("ciphertext_modulus", _modulus_map(modulus)),
    ])
    return out.getvalue()


def lwe_keyswitch_key_bytes(data, base_log: int, levels: int,
                            output_lwe_size: int, modulus: int = 0) -> bytes:
    """LweKeyswitchKey { data, decomp_base_log, decomp_level_count,
    output_lwe_size, ciphertext_modulus } (entities/lwe_keyswitch_key.rs:81)."""
    out = io.BytesIO()
    encode_map(out, [
        ("data", lambda o: encode_uint_array(o, data)),
        ("decomp_base_log", lambda o: encode_uint(o, base_log)),
        ("decomp_level_count", lambda o: encode_uint(o, levels)),
        ("output_lwe_size", lambda o: encode_uint(o, output_lwe_size)),
        ("ciphertext_modulus", _modulus_map(modulus)),
    ])
    return out.getvalue()


def lwe_bootstrap_key_bytes(data, glwe_size: int, polynomial_size: int,
                            base_log: int, levels: int,
                            modulus: int = 0) -> bytes:
    """LweBootstrapKey { ggsw_list: GgswCiphertextList { data, glwe_size,
    polynomial_size, decomp_base_log, decomp_level_count, ciphertext_modulus } }
    (entities/lwe_bootstrap_key.rs:103, ggsw_ciphertext_list.rs:16)."""
    def ggsw_list(out):
        encode_map(out, [
            ("data", lambda o: encode_uint_array(o, data)),
            ("glwe_size", lambda o: encode_uint(o, glwe_size)),
            ("polynomial_size", lambda o: encode_uint(o, polynomial_size)),
            ("decomp_base_log", lambda o: encode_uint(o, base_log)),
            ("decomp_level_count", lambda o: encode_uint(o, levels)),
            ("ciphertext_modulus", _modulus_map(modulus)),
        ])
    out = io.BytesIO()
    encode_map(out, [("ggsw_list", ggsw_list)])
    return out.getvalue()
