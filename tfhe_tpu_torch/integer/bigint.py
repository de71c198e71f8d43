"""Fixed-width big integers: U128/U256/U512/U1024/U2048 and I256/I512.

API parity with the reference ``integer/bigint/{u256,u512,i256,i512}.rs``
and the static_{unsigned,signed} generics: wrapping two's-complement
arithmetic at a fixed bit width, 64-bit little-endian word conversion, and
comparison — the scalar companions of FheUint256+ (scalar add/mul/cmp
against big clears).

Python ints are arbitrary-precision, so each type is a thin wrapper
enforcing the width and wrap semantics (the reference needs limb structs;
here the "limbs" appear only at the word-conversion boundary).
"""

from __future__ import annotations

from typing import Iterable, List


class _StaticInt:
    BITS: int = 0
    SIGNED: bool = False

    __slots__ = ("value",)

    def __init__(self, value: int = 0):
        self.value = self._wrap(int(value))

    # -- representation ----------------------------------------------------
    @classmethod
    def _mask(cls) -> int:
        return (1 << cls.BITS) - 1

    @classmethod
    def _wrap(cls, v: int) -> int:
        v &= cls._mask()
        if cls.SIGNED and v >> (cls.BITS - 1):
            v -= 1 << cls.BITS
        return v

    def to_unsigned_int(self) -> int:
        return self.value & self._mask()

    def __int__(self) -> int:
        return self.value

    def __index__(self) -> int:
        return self.value

    # -- word conversion (little-endian u64 words, bigint/mod.rs) ---------
    @classmethod
    def from_words(cls, words: Iterable[int]) -> "_StaticInt":
        v = 0
        for i, w in enumerate(words):
            v |= (int(w) & 0xFFFFFFFFFFFFFFFF) << (64 * i)
        return cls(v)

    def to_words(self) -> List[int]:
        v = self.to_unsigned_int()
        return [
            (v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
            for i in range(self.BITS // 64)
        ]

    @classmethod
    def from_le_bytes(cls, data: bytes) -> "_StaticInt":
        return cls(int.from_bytes(data[: cls.BITS // 8], "little"))

    def to_le_bytes(self) -> bytes:
        return self.to_unsigned_int().to_bytes(self.BITS // 8, "little")

    # -- wrapping arithmetic ----------------------------------------------
    def _coerce(self, other) -> int:
        return other.value if isinstance(other, _StaticInt) else int(other)

    def __add__(self, other):
        return type(self)(self.value + self._coerce(other))

    __radd__ = __add__

    def __sub__(self, other):
        return type(self)(self.value - self._coerce(other))

    def __rsub__(self, other):
        return type(self)(self._coerce(other) - self.value)

    def __mul__(self, other):
        return type(self)(self.value * self._coerce(other))

    __rmul__ = __mul__

    def __neg__(self):
        return type(self)(-self.value)

    def __and__(self, other):
        return type(self)(self.value & self._coerce(other))

    def __or__(self, other):
        return type(self)(self.value | self._coerce(other))

    def __xor__(self, other):
        return type(self)(self.value ^ self._coerce(other))

    def __invert__(self):
        return type(self)(~self.value)

    def __lshift__(self, n: int):
        # wrapping_shl: shift amount taken mod BITS (u256.rs:255 semantics)
        return type(self)(self.value << (int(n) % self.BITS))

    def __rshift__(self, n: int):
        n = int(n) % self.BITS
        if self.SIGNED:
            return type(self)(self.value >> n)  # arithmetic on signed value
        return type(self)(self.to_unsigned_int() >> n)

    def __floordiv__(self, other):
        return type(self)(self.value // self._coerce(other))

    def __mod__(self, other):
        return type(self)(self.value % self._coerce(other))

    # -- comparison --------------------------------------------------------
    def __eq__(self, other):
        return self.value == self._coerce(other)

    def __hash__(self):
        return hash((type(self).__name__, self.value))

    def __lt__(self, other):
        return self.value < self._coerce(other)

    def __le__(self, other):
        return self.value <= self._coerce(other)

    def __gt__(self, other):
        return self.value > self._coerce(other)

    def __ge__(self, other):
        return self.value >= self._coerce(other)

    def __repr__(self):
        return f"{type(self).__name__}({self.value})"

    # -- constants ---------------------------------------------------------
    @classmethod
    def max_value(cls):
        if cls.SIGNED:
            return cls((1 << (cls.BITS - 1)) - 1)
        return cls(cls._mask())

    @classmethod
    def min_value(cls):
        if cls.SIGNED:
            return cls(-(1 << (cls.BITS - 1)))
        return cls(0)

    ZERO = None  # filled in below
    ONE = None


def _make(name: str, bits: int, signed: bool):
    t = type(name, (_StaticInt,), {"BITS": bits, "SIGNED": signed,
                                   "__slots__": ()})
    t.ZERO = t(0)
    t.ONE = t(1)
    return t


U128 = _make("U128", 128, False)
U256 = _make("U256", 256, False)
U512 = _make("U512", 512, False)
U1024 = _make("U1024", 1024, False)
U2048 = _make("U2048", 2048, False)
I256 = _make("I256", 256, True)
I512 = _make("I512", 512, True)
