"""Message <-> torus plaintext encoding.

Reference: ``tfhe/src/shortint/encoding.rs`` (``compute_delta``,
``ShortintEncoding::{encode,decode}``).
"""

from __future__ import annotations

from dataclasses import dataclass

from .params import CiphertextModulus


@dataclass(frozen=True)
class ShortintEncoding:
    ciphertext_modulus: CiphertextModulus
    message_modulus: int
    carry_modulus: int
    padding_bit: bool = True

    @property
    def cleartext_modulus(self) -> int:
        return self.message_modulus * self.carry_modulus

    def delta(self) -> int:
        """Plaintext scaling factor.

        Native modulus:  delta = 2^(B-1-pad) / (mm*cm) * 2
        Custom modulus:  delta = q / (mm*cm) / (2 if pad else 1)
        (reference encoding.rs:13-36)
        """
        cm = self.ciphertext_modulus
        cleartext = self.cleartext_modulus
        if cm.is_native:
            pad = 1 if self.padding_bit else 0
            return ((1 << (cm.bits - 1 - pad)) // cleartext) * 2
        q = cm.modulus_value
        d = q // cleartext
        if self.padding_bit:
            d //= 2
        return d

    def encode(self, value: int) -> int:
        q_mask = (1 << self.ciphertext_modulus.bits) - 1
        return (int(value) * self.delta()) & q_mask

    @property
    def full_cleartext_space(self) -> int:
        return self.cleartext_modulus * (2 if self.padding_bit else 1)

    def decode(self, plaintext: int) -> int:
        """``divide_round(pt, delta) % full_cleartext_space`` (reference
        encoding.rs ``decode``)."""
        delta = self.delta()
        bits = self.ciphertext_modulus.bits
        plaintext = int(plaintext) & ((1 << bits) - 1)
        return ((plaintext + delta // 2) // delta) % self.full_cleartext_space
