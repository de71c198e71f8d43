"""CRT (residue number system) big integers.

Torch counterpart of ``tfhe_tpu/integer/crt.py`` (reference
``tfhe/src/integer/server_key/crt_parallel/`` and
``integer/ciphertext/crt.rs``): a value lives as residues mod pairwise
coprime bases, one shortint block per basis. Add/sub/mul are blockwise and
carry-free (fully parallel, ONE batched PBS for all bases); the price: no
cheap comparisons/shifts, and the value modulus is prod(bases).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Sequence

import numpy as np
import torch

from .._torus import u64_const
from ..shortint.ciphertext import NOMINAL_NOISE, LookupTable, ShortintCiphertext
from .radix import ClientKey, ServerKey


@dataclass
class CrtCiphertext:
    """ct: int64[..., n_bases, dim]; per-base degrees/noise (LSB-free layout)."""

    ct: Any
    moduli: tuple
    degrees: np.ndarray
    noise_levels: np.ndarray
    message_modulus: int  # shortint message modulus (capacity per block)
    carry_modulus: int

    @property
    def value_modulus(self) -> int:
        return math.prod(self.moduli)


def encrypt_crt(client_key: ClientKey, values, moduli: Sequence[int]) -> CrtCiphertext:
    """Per-base residue encryption (integer/client_key CRT encrypt)."""
    p = client_key.params
    cap = p.message_modulus * p.carry_modulus
    if not all(m <= cap for m in moduli):
        raise ValueError("each basis must fit message+carry")
    if len(moduli) == 2 and math.gcd(*moduli) != 1:
        raise ValueError(f"bases {tuple(moduli)} are not coprime")
    vals = np.atleast_1d(np.asarray(values, dtype=np.uint64))
    residues = np.stack([vals % np.uint64(m) for m in moduli], axis=-1)
    ct = client_key.key.encrypt(residues.reshape(-1))
    dim = ct.ct.shape[-1]
    arr = ct.ct.reshape(vals.shape + (len(moduli), dim))
    if np.isscalar(values) or np.asarray(values).ndim == 0:
        arr = arr[0]
    return CrtCiphertext(
        ct=arr, moduli=tuple(moduli),
        degrees=np.array([m - 1 for m in moduli], dtype=np.int64),
        noise_levels=np.full(len(moduli), NOMINAL_NOISE, dtype=np.int64),
        message_modulus=p.message_modulus, carry_modulus=p.carry_modulus,
    )


def decrypt_crt(client_key: ClientKey, ct: CrtCiphertext) -> np.ndarray:
    """CRT reconstruction of the residues."""
    s = ShortintCiphertext(
        ct=ct.ct, degree=int(ct.degrees.max()), noise_level=int(ct.noise_levels.max()),
        message_modulus=ct.message_modulus, carry_modulus=ct.carry_modulus,
    )
    res = np.atleast_1d(client_key.key.decrypt_message_and_carry(s))
    res = res.reshape(ct.ct.shape[:-2] + (len(ct.moduli),))
    M = ct.value_modulus
    out = np.zeros(res.shape[:-1], dtype=np.uint64)
    for i, m in enumerate(ct.moduli):
        r = res[..., i].astype(np.int64) % m
        Mi = M // m
        out = (out + (r * Mi * pow(Mi, -1, m)) % M) % np.uint64(M)
    return out


class CrtServerKey:
    """Blockwise CRT ops over the shortint key
    (integer/server_key/crt_parallel/{add,sub,mul,neg,scalar}*.rs)."""

    def __init__(self, server_key: ServerKey):
        self.key = server_key.key  # shortint server key

    def _luts_mod(self, ct: CrtCiphertext, f) -> LookupTable:
        """Per-base stacked LUTs computing f(x, m_i) mod m_i — ONE batched
        PBS over all bases."""
        accs = [
            self.key.generate_lookup_table(lambda x, m=m: f(x, m) % m).acc
            for m in ct.moduli
        ]
        return LookupTable(acc=torch.stack(accs, dim=0), degree=max(ct.moduli) - 1)

    def _pbs(self, ct: CrtCiphertext, blocks, degree_in, noise_in, lut):
        s = ShortintCiphertext(
            ct=blocks, degree=degree_in, noise_level=noise_in,
            message_modulus=ct.message_modulus, carry_modulus=ct.carry_modulus,
        )
        out = self.key.apply_lookup_table(s, lut)
        return replace(
            ct, ct=out.ct,
            degrees=np.array([m - 1 for m in ct.moduli], dtype=np.int64),
            noise_levels=np.full(len(ct.moduli), NOMINAL_NOISE, dtype=np.int64),
        )

    def _reduce(self, ct: CrtCiphertext) -> CrtCiphertext:
        lut = self._luts_mod(ct, lambda x, m: x)
        return self._pbs(ct, ct.ct, int(ct.degrees.max()),
                         int(ct.noise_levels.max()), lut)

    def _maybe_reduce(self, ct: CrtCiphertext, extra_deg, extra_noise) -> CrtCiphertext:
        cap = ct.message_modulus * ct.carry_modulus
        if np.any(ct.degrees + extra_deg >= cap) or np.any(
            ct.noise_levels + extra_noise > self.key.params.max_noise_level - 1
        ):
            return self._reduce(ct)
        return ct

    def add(self, a: CrtCiphertext, b: CrtCiphertext) -> CrtCiphertext:
        if a.moduli != b.moduli:
            raise ValueError(f"bases differ: {a.moduli} and {b.moduli}")
        a = self._maybe_reduce(a, int(b.degrees.max()), int(b.noise_levels.max()))
        b = self._maybe_reduce(b, int(a.degrees.max()), int(a.noise_levels.max()))
        s = replace(
            a, ct=a.ct + b.ct, degrees=a.degrees + b.degrees,
            noise_levels=a.noise_levels + b.noise_levels,
        )
        return self._reduce(s)

    def neg(self, a: CrtCiphertext) -> CrtCiphertext:
        """Per-base negation: z_i*m_i - x (crt neg with degree correction)."""
        delta = self.key.encoding.delta()
        ct = -a.ct  # a fresh tensor: the writes below stay in it
        degs = np.zeros(len(a.moduli), dtype=np.int64)
        for i, m in enumerate(a.moduli):
            z = math.ceil((int(a.degrees[i]) + 1) / m) * m
            ct[..., i, -1] += u64_const(z * delta)
            degs[i] = z
        out = replace(a, ct=ct, degrees=degs)
        return self._reduce(out)

    def sub(self, a: CrtCiphertext, b: CrtCiphertext) -> CrtCiphertext:
        return self.add(a, self.neg(b))

    def mul(self, a: CrtCiphertext, b: CrtCiphertext) -> CrtCiphertext:
        """Blockwise bivariate LUT (x*y mod m_i): pack then ONE batched PBS."""
        if a.moduli != b.moduli:
            raise ValueError(f"bases differ: {a.moduli} and {b.moduli}")
        a = self._reduce(a) if np.any(a.degrees >= np.array(a.moduli)) else a
        b = self._reduce(b) if np.any(b.degrees >= np.array(b.moduli)) else b
        cap = a.message_modulus * a.carry_modulus
        accs = []
        for m in a.moduli:
            # pack with factor m: x*m + y, both < m
            accs.append(
                self.key.generate_lookup_table(
                    lambda x, m=m: ((x // m) % m) * (x % m) % m
                ).acc
            )
        if not all(m * m - 1 < cap for m in a.moduli):
            raise ValueError(
                "bivariate packing x*m+y must fit the message+carry space "
                f"(bases {a.moduli}, capacity {cap})")
        factors = torch.tensor(a.moduli, dtype=torch.int64,
                               device=a.ct.device)[:, None]
        packed = a.ct * factors + b.ct
        lut = LookupTable(acc=torch.stack(accs, dim=0), degree=max(a.moduli) - 1)
        noise = int(np.max(a.noise_levels * max(a.moduli) + b.noise_levels))
        return self._pbs(a, packed, cap - 1, noise, lut)

    def scalar_add(self, a: CrtCiphertext, scalar: int) -> CrtCiphertext:
        delta = self.key.encoding.delta()
        ct = a.ct.clone()
        degs = a.degrees.copy()
        for i, m in enumerate(a.moduli):
            d = int(scalar) % m
            if d:
                ct[..., i, -1] += u64_const(d * delta)
                degs[i] += d
        out = replace(a, ct=ct, degrees=degs)
        return self._reduce(out)

    def scalar_mul(self, a: CrtCiphertext, scalar: int) -> CrtCiphertext:
        lut = self._luts_mod(a, lambda x, m: (x % m) * (int(scalar) % m))
        a = self._reduce(a) if np.any(a.degrees >= np.array(a.moduli)) else a
        return self._pbs(a, a.ct, int(a.degrees.max()), int(a.noise_levels.max()), lut)
