"""Deterministic, tree-forkable AES-128-CTR CSPRNG (host-side, numpy).

The port's own copy of ``tfhe_tpu/utils/csprng.py``: the same seed gives
the same bytes and the same samples. It mirrors the reference's
``tfhe-csprng`` crate:

- The random table is the byte stream ``AES_k(0) || AES_k(1) || ...`` where
  the 128-bit counter is encrypted with AES-128 keyed by the seed (block
  input is the counter's little-endian bytes, key is the seed's bytes).
- A generator is a window ``[table_index, bound)`` into that table;
  ``try_fork(n_children, bytes_per_child)`` hands each child a consecutive
  sub-window starting at the parent's next byte and advances the parent
  past all children (``tfhe-csprng/src/generators/aes_ctr/parallel.rs``).

Sampling layers mirror ``tfhe/src/core_crypto/commons/math/random``:
uniform u64 (8 stream bytes, little-endian), uniform binary (1 byte, LSB),
gaussian pairs (Marsaglia polar over two i64-LE draws scaled by 2^-63),
t-uniform (bound_log2+2 bits, half-weight endpoints).

Randomness is drawn on the host; encryption arithmetic then runs on the
device (``core/algorithms.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np

BYTES_PER_AES_CALL = 16

# ---------------------------------------------------------------------------
# AES-128 (encrypt-only), vectorized over blocks with numpy. FIPS-197.
# ---------------------------------------------------------------------------

_SBOX = np.array(
    [
        0x63, 0x7C, 0x77, 0x7B, 0xF2, 0x6B, 0x6F, 0xC5, 0x30, 0x01, 0x67, 0x2B, 0xFE, 0xD7, 0xAB, 0x76,
        0xCA, 0x82, 0xC9, 0x7D, 0xFA, 0x59, 0x47, 0xF0, 0xAD, 0xD4, 0xA2, 0xAF, 0x9C, 0xA4, 0x72, 0xC0,
        0xB7, 0xFD, 0x93, 0x26, 0x36, 0x3F, 0xF7, 0xCC, 0x34, 0xA5, 0xE5, 0xF1, 0x71, 0xD8, 0x31, 0x15,
        0x04, 0xC7, 0x23, 0xC3, 0x18, 0x96, 0x05, 0x9A, 0x07, 0x12, 0x80, 0xE2, 0xEB, 0x27, 0xB2, 0x75,
        0x09, 0x83, 0x2C, 0x1A, 0x1B, 0x6E, 0x5A, 0xA0, 0x52, 0x3B, 0xD6, 0xB3, 0x29, 0xE3, 0x2F, 0x84,
        0x53, 0xD1, 0x00, 0xED, 0x20, 0xFC, 0xB1, 0x5B, 0x6A, 0xCB, 0xBE, 0x39, 0x4A, 0x4C, 0x58, 0xCF,
        0xD0, 0xEF, 0xAA, 0xFB, 0x43, 0x4D, 0x33, 0x85, 0x45, 0xF9, 0x02, 0x7F, 0x50, 0x3C, 0x9F, 0xA8,
        0x51, 0xA3, 0x40, 0x8F, 0x92, 0x9D, 0x38, 0xF5, 0xBC, 0xB6, 0xDA, 0x21, 0x10, 0xFF, 0xF3, 0xD2,
        0xCD, 0x0C, 0x13, 0xEC, 0x5F, 0x97, 0x44, 0x17, 0xC4, 0xA7, 0x7E, 0x3D, 0x64, 0x5D, 0x19, 0x73,
        0x60, 0x81, 0x4F, 0xDC, 0x22, 0x2A, 0x90, 0x88, 0x46, 0xEE, 0xB8, 0x14, 0xDE, 0x5E, 0x0B, 0xDB,
        0xE0, 0x32, 0x3A, 0x0A, 0x49, 0x06, 0x24, 0x5C, 0xC2, 0xD3, 0xAC, 0x62, 0x91, 0x95, 0xE4, 0x79,
        0xE7, 0xC8, 0x37, 0x6D, 0x8D, 0xD5, 0x4E, 0xA9, 0x6C, 0x56, 0xF4, 0xEA, 0x65, 0x7A, 0xAE, 0x08,
        0xBA, 0x78, 0x25, 0x2E, 0x1C, 0xA6, 0xB4, 0xC6, 0xE8, 0xDD, 0x74, 0x1F, 0x4B, 0xBD, 0x8B, 0x8A,
        0x70, 0x3E, 0xB5, 0x66, 0x48, 0x03, 0xF6, 0x0E, 0x61, 0x35, 0x57, 0xB9, 0x86, 0xC1, 0x1D, 0x9E,
        0xE1, 0xF8, 0x98, 0x11, 0x69, 0xD9, 0x8E, 0x94, 0x9B, 0x1E, 0x87, 0xE9, 0xCE, 0x55, 0x28, 0xDF,
        0x8C, 0xA1, 0x89, 0x0D, 0xBF, 0xE6, 0x42, 0x68, 0x41, 0x99, 0x2D, 0x0F, 0xB0, 0x54, 0xBB, 0x16,
    ],
    dtype=np.uint8,
)

_RCON = np.array([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36], dtype=np.uint8)

# ShiftRows on the 16-byte block in column-major (FIPS) layout:
# byte index = 4*col + row; new[4c+r] = old[4*((c+r)%4) + r]
_SHIFT_ROWS = np.array(
    [4 * ((c + r) % 4) + r for c in range(4) for r in range(4)], dtype=np.intp
)


def _xtime(x: np.ndarray) -> np.ndarray:
    return ((x << 1) ^ np.where(x & 0x80, 0x1B, 0)).astype(np.uint8)


def _key_expansion(key16: bytes) -> np.ndarray:
    """Round keys as [11, 16] uint8."""
    w = [np.frombuffer(key16, dtype=np.uint8)[i * 4 : (i + 1) * 4].copy() for i in range(4)]
    for i in range(4, 44):
        temp = w[i - 1].copy()
        if i % 4 == 0:
            temp = np.roll(temp, -1)
            temp = _SBOX[temp]
            temp[0] ^= _RCON[i // 4 - 1]
        w.append(w[i - 4] ^ temp)
    return np.concatenate(w).reshape(11, 16)


def aes128_encrypt_blocks(round_keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """Encrypt ``blocks`` [B, 16] uint8 under expanded ``round_keys``."""
    s = blocks ^ round_keys[0]
    for rnd in range(1, 10):
        s = _SBOX[s]
        s = s[:, _SHIFT_ROWS]
        cols = s.reshape(-1, 4, 4)  # [B, col, row]
        t = cols[:, :, 0] ^ cols[:, :, 1] ^ cols[:, :, 2] ^ cols[:, :, 3]
        mixed = np.empty_like(cols)
        for r in range(4):
            mixed[:, :, r] = cols[:, :, r] ^ t ^ _xtime(cols[:, :, r] ^ cols[:, :, (r + 1) % 4])
        s = mixed.reshape(-1, 16) ^ round_keys[rnd]
    s = _SBOX[s]
    s = s[:, _SHIFT_ROWS]
    return s ^ round_keys[10]


def aes128_ctr_stream_native(key16: bytes, first_block: int, n_blocks: int):
    """Keystream blocks [n_blocks, 16] from the C engine, or None when it is
    unavailable."""
    from .._build import aes_lib

    lib = aes_lib()
    if lib is None:
        return None
    out = np.empty(n_blocks * 16, dtype=np.uint8)
    lib.aes128_ctr_stream(key16, first_block, n_blocks,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.reshape(n_blocks, 16)


# ---------------------------------------------------------------------------
# CTR stream with fork semantics
# ---------------------------------------------------------------------------


class ForkError(Exception):
    pass


class AesCtrGenerator:
    """A bounded window over the AES-CTR random table. ``table_index``
    counts bytes from the start of the stream; the generator may emit bytes
    in ``[table_index, bound)``."""

    __slots__ = ("round_keys", "table_index", "bound", "_key16")

    def __init__(self, seed: int, table_index: int = 0, bound: int = 1 << 128,
                 round_keys=None, key16: bytes = None):
        if round_keys is None:
            key16 = int(seed & ((1 << 128) - 1)).to_bytes(16, "little")
            round_keys = _key_expansion(key16)
        self.round_keys = round_keys
        self.table_index = table_index
        self.bound = bound
        self._key16 = key16

    def next_bytes(self, n: int) -> np.ndarray:
        """The next ``n`` bytes of the stream (uint8 array)."""
        if n == 0:
            return np.zeros(0, dtype=np.uint8)
        if self.table_index + n > self.bound:
            raise ForkError("generator bound exceeded")
        first_block = self.table_index // BYTES_PER_AES_CALL
        offset = self.table_index % BYTES_PER_AES_CALL
        n_blocks = (offset + n + BYTES_PER_AES_CALL - 1) // BYTES_PER_AES_CALL
        if self._key16 is not None and first_block + n_blocks < (1 << 64):
            native = aes128_ctr_stream_native(self._key16, first_block, n_blocks)
            if native is not None:
                stream = native.reshape(-1)[offset : offset + n]
                self.table_index += n
                return stream.copy()
        if first_block + n_blocks < (1 << 64):
            ctr = np.zeros((n_blocks, 16), dtype=np.uint8)
            lo = np.arange(first_block, first_block + n_blocks, dtype=np.uint64)
            ctr[:, :8] = lo.view(np.uint8).reshape(n_blocks, 8)
        else:
            ctr = np.array(
                [
                    list(int(c).to_bytes(16, "little"))
                    for c in range(first_block, first_block + n_blocks)
                ],
                dtype=np.uint8,
            )
        out = aes128_encrypt_blocks(self.round_keys, ctr)
        stream = out.reshape(-1)[offset : offset + n]
        self.table_index += n
        return stream.copy()

    def try_fork(self, n_children: int, bytes_per_child: int) -> list["AesCtrGenerator"]:
        """Split into ``n_children`` bounded children over consecutive byte
        ranges; the parent jumps past all of them."""
        if n_children == 0 or bytes_per_child == 0:
            raise ForkError("zero fork")
        total = n_children * bytes_per_child
        if self.table_index + total > self.bound:
            raise ForkError("fork too large")
        first = self.table_index
        children = [
            AesCtrGenerator(
                0,
                table_index=first + i * bytes_per_child,
                bound=first + (i + 1) * bytes_per_child,
                round_keys=self.round_keys,
                key16=self._key16,
            )
            for i in range(n_children)
        ]
        self.table_index = first + total
        return children

    # -- typed sampling (reference commons/math/random semantics) ----------

    def uniform_u64(self, n: int) -> np.ndarray:
        b = self.next_bytes(8 * n)
        return b.view("<u8").copy()

    def uniform_binary(self, n: int) -> np.ndarray:
        """One byte per bit, LSB (uniform_binary.rs)."""
        b = self.next_bytes(n)
        return (b & 1).astype(np.uint64)

    def gaussian_pairs_f64(self, n_pairs: int, std: float, mean: float = 0.0) -> np.ndarray:
        """``n_pairs`` Marsaglia-polar gaussian pairs -> [2*n_pairs] f64.
        Rejected pairs redraw in order from the following stream bytes."""
        out_u = np.empty(n_pairs, dtype=np.float64)
        out_v = np.empty(n_pairs, dtype=np.float64)
        pending = np.arange(n_pairs)
        while pending.size:
            raw = self.next_bytes(16 * pending.size).view("<i8")
            u = raw[0::2].astype(np.float64) * 2.0 ** -63
            v = raw[1::2].astype(np.float64) * 2.0 ** -63
            s = u * u + v * v
            ok = (s > 0.0) & (s < 1.0)
            good = pending[ok]
            with np.errstate(divide="ignore", invalid="ignore"):
                cst = std * np.sqrt(-2.0 * np.log(s[ok]) / s[ok])
            out_u[good] = u[ok] * cst + mean
            out_v[good] = v[ok] * cst + mean
            pending = pending[~ok]
        out = np.empty(2 * n_pairs, dtype=np.float64)
        out[0::2] = out_u
        out[1::2] = out_v
        return out

    def gaussian_torus_u64(self, n: int, std: float, mean: float = 0.0) -> np.ndarray:
        """``n`` gaussian torus samples as wrapping uint64."""
        pairs = self.gaussian_pairs_f64((n + 1) // 2, std, mean)[:n]
        frac = pairs - np.round(pairs)
        return np.round(frac * 2.0 ** 64).astype(np.int64).astype(np.uint64)

    def t_uniform_torus_u64(self, n: int, bound_log2: int) -> np.ndarray:
        """T-uniform on [-2^b, 2^b] with half-weight endpoints: b+2 bits v,
        mapped to ((v >> 1) + (v & 1)) - 2^b (t_uniform.rs)."""
        needed_bytes = (bound_log2 + 2 + 7) // 8
        raw = self.next_bytes(needed_bytes * n).reshape(n, needed_bytes)
        x = np.zeros(n, dtype=np.uint64)
        for b in range(needed_bytes):
            x |= raw[:, b].astype(np.uint64) << np.uint64(8 * b)
        x &= np.uint64((1 << (bound_log2 + 2)) - 1)
        v = (x >> np.uint64(1)).astype(np.int64) + (x & np.uint64(1)).astype(np.int64) - (
            1 << bound_log2
        )
        return v.astype(np.uint64)


class SecretRandomGenerator(AesCtrGenerator):
    """Draws secret key bits (reference commons/generators/secret.rs)."""


class EncryptionRandomGenerator:
    """Two independent streams: mask (public coin) and noise (private
    coin), seeded separately (commons/generators/encryption/mod.rs)."""

    def __init__(self, seed: int, noise_seed: int):
        self.mask = AesCtrGenerator(seed)
        self.noise = AesCtrGenerator(noise_seed)

    def sample_noise(self, dist, n: int) -> np.ndarray:
        """Torus noise (uint64) from a DynamicDistribution."""
        if dist.kind == "gaussian":
            return self.noise.gaussian_torus_u64(n, dist.std_dev)
        return self.noise.t_uniform_torus_u64(n, dist.bound_log2)
