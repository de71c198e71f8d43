"""Encrypted key-value store (reference ``high_level_api/kv_store.rs:43``).

Torch counterpart of ``tfhe_tpu/high_level_api/kv_store.py``. Keys and
values are FheUint-typed; ``get`` with an encrypted key is an oblivious
linear scan (per-slot equality + zero-if-not-match + sum), and ``update``
is a per-slot cmux — the server learns nothing about which slot matched.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .api import FheBool, _FheIntegerBase, _sk


class KVStore:
    def __init__(self):
        self._slots: List[Tuple[_FheIntegerBase, _FheIntegerBase]] = []

    def __len__(self) -> int:
        return len(self._slots)

    def insert(self, key: _FheIntegerBase, value: _FheIntegerBase) -> None:
        """Appends a slot (no duplicate detection — mirroring kv_store.rs
        insert semantics where the caller manages key uniqueness)."""
        self._slots.append((key, value))

    def get(self, key: _FheIntegerBase) -> Optional[_FheIntegerBase]:
        """Oblivious lookup: sum of (slot_key == key) ? value : 0.

        Returns an encryption of 0 when the key is absent."""
        if not self._slots:
            return None
        sk = _sk()
        acc = None
        for k, v in self._slots:
            m = k.eq(key)
            zero = sk._trivial_radix(0, v.ct.num_blocks, v.ct)
            sel = sk.if_then_else(m.block, v.ct, zero)
            acc = sel if acc is None else sk.add(acc, sel)
        return type(self._slots[0][1])(acc)

    def contains(self, key: _FheIntegerBase) -> FheBool:
        sk = _sk()
        acc = None
        for k, _ in self._slots:
            m = k.eq(key)
            acc = m.block if acc is None else sk.boolean_bitor(acc, m.block)
        return FheBool(acc)

    def update(self, key: _FheIntegerBase, value: _FheIntegerBase) -> None:
        """Oblivious update: every slot becomes cmux(k == key, value, old)."""
        sk = _sk()
        self._slots = [
            (k, type(v)(sk.if_then_else(k.eq(key).block, value.ct, v.ct)))
            for k, v in self._slots
        ]
