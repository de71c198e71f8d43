"""Encrypted ASCII strings over the radix integer layer.

Torch counterpart of ``tfhe_tpu/strings/ascii.py`` (reference
``tfhe/src/strings/``: ``FheAsciiString``, one radix ciphertext per
character — 7-bit ASCII in 4 radix blocks with 2_2 params — padded with
encrypted nulls to a fixed capacity; server ops in ``strings/server_key/``).

The character axis is the leading batch axis of ONE radix ciphertext, so a
per-character operation (case mapping, per-char equality ...) is a single
batched PBS over the whole string through the integer ``ServerKey`` (on a
GPU: keyswitch, then K2 acc32 and K1 under the default variant). A
character is a view of that tensor (:meth:`StringServerKey._char_at`); no
op writes into one: every char tensor an op builds (shifts, padding,
stacks, trivial encryptions) is a new tensor on the string's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .._torus import from_u64
from ..integer.radix import (
    BooleanBlock,
    ClientKey as IntegerClientKey,
    RadixCiphertext,
    ServerKey as IntegerServerKey,
)

CHAR_BLOCKS = 4  # 8-bit chars on 2-bit blocks


@dataclass
class FheAsciiString:
    """chars: RadixCiphertext with leading batch dim = capacity (padded)."""

    chars: RadixCiphertext
    capacity: int

    @property
    def ct(self):
        return self.chars.ct


class StringClientKey:
    """Reference ``strings::ClientKey`` (strings/client_key.rs)."""

    def __init__(self, inner: IntegerClientKey):
        self.inner = inner

    def encrypt_ascii(self, s: str, capacity: Optional[int] = None) -> FheAsciiString:
        if capacity is None:
            capacity = len(s)
        assert len(s) <= capacity
        assert all(0 < ord(c) < 128 for c in s), "strict ASCII, no nulls"
        padded = np.array(
            [ord(c) for c in s] + [0] * (capacity - len(s)), dtype=np.uint64
        )
        return FheAsciiString(
            chars=self.inner.encrypt_radix(padded, CHAR_BLOCKS), capacity=capacity
        )

    def decrypt_ascii(self, s: FheAsciiString) -> str:
        vals = np.asarray(self.inner.decrypt_radix(s.chars)).reshape(-1)
        out = []
        for v in vals:
            if v == 0:
                break
            out.append(chr(int(v) & 0x7F))
        return "".join(out)


class StringServerKey:
    """Reference ``strings::ServerKey`` (strings/server_key/)."""

    def __init__(self, inner: IntegerServerKey):
        self.key = inner

    # -- helpers ------------------------------------------------------------
    def _char_at(self, s: FheAsciiString, i: int) -> RadixCiphertext:
        """Char ``i``: a view of the string's tensor (read, never written)."""
        ct = s.chars
        return ct.with_ct(ct.ct[i])

    def _from_chars(self, s: FheAsciiString, outs) -> FheAsciiString:
        """A string of ``s``'s capacity from one radix ciphertext per char
        (the bookkeeping of the first)."""
        ct = torch.stack([o.ct for o in outs], dim=0)
        return FheAsciiString(
            chars=s.chars.with_ct(
                ct, degrees=outs[0].degrees, noise_levels=outs[0].noise_levels
            ),
            capacity=s.capacity,
        )

    def _per_char_eq_scalar_bits(self, s: FheAsciiString, pattern: str, offset: int):
        """AND over pattern chars of (s[offset+k] == pattern[k])."""
        sk = self.key
        bit = None
        for k, pc in enumerate(pattern):
            c = self._char_at(s, offset + k)
            b = sk.scalar_eq(c, ord(pc))
            bit = b if bit is None else sk.boolean_bitand(bit, b)
        return bit

    # -- equality ------------------------------------------------------------
    def eq(self, a: FheAsciiString, b: FheAsciiString) -> BooleanBlock:
        """Padded-buffer equality (strings/server_key/comp.rs)."""
        sk = self.key
        cap = max(a.capacity, b.capacity)
        bit = None
        for i in range(cap):
            ca = self._char_at(a, i) if i < a.capacity else None
            cb = self._char_at(b, i) if i < b.capacity else None
            if ca is None:
                ca = sk._trivial_radix(0, CHAR_BLOCKS, cb)
            if cb is None:
                cb = sk._trivial_radix(0, CHAR_BLOCKS, ca)
            e = sk.eq(ca, cb)
            bit = e if bit is None else sk.boolean_bitand(bit, e)
        return bit

    def ne(self, a: FheAsciiString, b: FheAsciiString) -> BooleanBlock:
        return self.key.boolean_bitnot(self.eq(a, b))

    def eq_clear(self, a: FheAsciiString, s: str) -> BooleanBlock:
        sk = self.key
        bit = None
        for i in range(a.capacity):
            want = ord(s[i]) if i < len(s) else 0
            b = sk.scalar_eq(self._char_at(a, i), want)
            bit = b if bit is None else sk.boolean_bitand(bit, b)
        return bit

    # -- search --------------------------------------------------------------
    def contains_clear(self, s: FheAsciiString, pattern: str) -> BooleanBlock:
        """OR over offsets of per-offset pattern match
        (strings/server_key/contains.rs, clear-pattern path)."""
        sk = self.key
        assert pattern, "empty pattern"
        acc = None
        for off in range(0, s.capacity - len(pattern) + 1):
            m = self._per_char_eq_scalar_bits(s, pattern, off)
            acc = m if acc is None else sk.boolean_bitor(acc, m)
        if acc is None:  # pattern longer than capacity
            return self._trivial_bool(False, self._char_at(s, 0))
        return acc

    def find_clear(self, s: FheAsciiString, pattern: str):
        """(index, found): first match offset, scanned back-to-front with a
        cmux cascade (strings/server_key/find.rs)."""
        sk = self.key
        like = self._char_at(s, 0)
        idx = sk._trivial_radix(0, CHAR_BLOCKS, like)  # an 8-bit index
        found = None
        for off in range(s.capacity - len(pattern), -1, -1):
            m = self._per_char_eq_scalar_bits(s, pattern, off)
            off_ct = sk._trivial_radix(off, CHAR_BLOCKS, like)
            idx = sk.if_then_else(m, off_ct, idx)
            found = m if found is None else sk.boolean_bitor(found, m)
        return idx, found

    def starts_with_clear(self, s: FheAsciiString, pattern: str) -> BooleanBlock:
        return self._per_char_eq_scalar_bits(s, pattern, 0)

    def ends_with_clear(self, s: FheAsciiString, pattern: str) -> BooleanBlock:
        """OR over possible lengths: matches when the pattern sits right
        before the padding boundary."""
        sk = self.key
        acc = None
        for end in range(len(pattern), s.capacity + 1):
            m = self._per_char_eq_scalar_bits(s, pattern, end - len(pattern))
            # boundary: char[end] is NUL (or end == capacity)
            if end < s.capacity:
                m = sk.boolean_bitand(m, sk.scalar_eq(self._char_at(s, end), 0))
            acc = m if acc is None else sk.boolean_bitor(acc, m)
        return acc

    # -- length --------------------------------------------------------------
    def len(self, s: FheAsciiString) -> RadixCiphertext:
        """Number of non-null chars (strings/server_key/mod.rs len): sum of
        is_nonzero bits — one PBS round per char, then a radix sum."""
        sk = self.key
        like = self._char_at(s, 0)
        bits = [
            self._bool_to_radix(sk.scalar_ne(self._char_at(s, i), 0),
                                CHAR_BLOCKS, like)
            for i in range(s.capacity)
        ]
        return sk.sum_ciphertexts(bits)

    def is_empty(self, s: FheAsciiString) -> BooleanBlock:
        return self.key.scalar_eq(self._char_at(s, 0), 0)

    # -- case mapping ----------------------------------------------------------
    def _map_case(self, s: FheAsciiString, lo: str, hi: str, delta: int):
        """Batched over ALL chars at once: cond = lo <= c <= hi;
        out = cond ? c + delta : c (strings/server_key/up_low_case.rs)."""
        sk = self.key
        chars = s.chars  # batch dim = capacity
        cond = sk.boolean_bitand(sk.scalar_ge(chars, ord(lo)),
                                 sk.scalar_le(chars, ord(hi)))
        shifted = (sk.scalar_add(chars, delta) if delta > 0
                   else sk.scalar_sub(chars, -delta))
        out = sk.if_then_else(cond, shifted, chars)
        return FheAsciiString(chars=out, capacity=s.capacity)

    def to_uppercase(self, s: FheAsciiString) -> FheAsciiString:
        return self._map_case(s, "a", "z", -32)

    def to_lowercase(self, s: FheAsciiString) -> FheAsciiString:
        return self._map_case(s, "A", "Z", 32)

    # -- character-axis shifts (the splice primitive) -------------------------
    def _amount_bit(self, amount: RadixCiphertext, kbit: int):
        """Bit ``kbit`` of an encrypted amount as a boolean block (one PBS
        round), or None when the amount has no such block."""
        sk = self.key
        blk_idx, bit_idx = divmod(kbit, sk._bits_per_block())
        if blk_idx >= amount.num_blocks:
            return None
        bit_lut = sk._lut(lambda x, b=bit_idx: (x >> b) & 1, degree=1)
        bit = sk._pbs_blocks(
            amount.ct[..., blk_idx : blk_idx + 1, :],
            int(amount.degrees[blk_idx]),
            int(amount.noise_levels[blk_idx]),
            bit_lut,
        )
        return BooleanBlock(ct=bit[..., 0, :])

    def _moved(self, s: FheAsciiString, by: int) -> FheAsciiString:
        """Chars moved ``by`` positions toward higher indices (toward lower
        ones when negative) by a clear amount; trivial nulls shifted in."""
        ct = s.chars.ct
        if abs(by) >= s.capacity:
            return FheAsciiString(
                chars=s.chars.with_ct(
                    torch.zeros_like(ct),
                    degrees=np.zeros_like(s.chars.degrees),
                    noise_levels=np.zeros_like(s.chars.noise_levels),
                ),
                capacity=s.capacity,
            )
        zeros = torch.zeros_like(ct[: abs(by)])
        if by >= 0:
            out = torch.cat([zeros, ct[: s.capacity - by]], dim=0)
        else:
            out = torch.cat([ct[-by:], zeros], dim=0)
        return FheAsciiString(chars=s.chars.with_ct(out), capacity=s.capacity)

    def _barrel_shift(self, s: FheAsciiString, amount: RadixCiphertext,
                      sign: int) -> FheAsciiString:
        """Chars moved by an encrypted amount (``sign`` +1: toward higher
        indices, -1: lower), filling with nulls — the barrel shifter of
        strings/server_key/shift.rs, one cmux round per amount bit."""
        sk = self.key
        cap = s.capacity
        cur = s
        for kbit in range(max(1, cap.bit_length())):
            cond = self._amount_bit(amount, kbit)
            if cond is None:
                break
            shifted = self._moved(cur, sign * (1 << kbit))
            picked = sk.if_then_else(cond, shifted.chars, cur.chars)
            cur = FheAsciiString(chars=picked, capacity=cap)
        return cur

    def _shift_chars_right(self, s: FheAsciiString, amount: RadixCiphertext,
                           out_capacity: Optional[int] = None) -> FheAsciiString:
        """Move every char ``amount`` positions toward higher indices."""
        return self._barrel_shift(
            self._resize(s, out_capacity or s.capacity), amount, 1)

    def _shift_chars_left(self, s: FheAsciiString, amount: RadixCiphertext) -> FheAsciiString:
        """Chars moved toward LOWER indices by an encrypted amount."""
        return self._barrel_shift(s, amount, -1)

    def _resize(self, s: FheAsciiString, cap: int) -> FheAsciiString:
        if cap == s.capacity:
            return s
        if cap < s.capacity:
            return FheAsciiString(
                chars=s.chars.with_ct(s.chars.ct[:cap]), capacity=cap
            )
        ct = s.chars.ct
        pad = torch.zeros((cap - s.capacity,) + tuple(ct.shape[1:]),
                          dtype=torch.int64, device=ct.device)
        return FheAsciiString(
            chars=s.chars.with_ct(torch.cat([ct, pad], dim=0)), capacity=cap
        )

    def concat(self, a: FheAsciiString, b: FheAsciiString) -> FheAsciiString:
        """a + b: shift b right by len(a) into a combined buffer and OR the
        two (nulls are zero, so add is exact — strings/server_key/concat)."""
        sk = self.key
        cap = a.capacity + b.capacity
        la = self.len(a)
        a_ext = self._resize(a, cap)
        b_ext = self._resize(b, cap)
        b_shifted = self._shift_chars_right(b_ext, la)
        merged = sk.add_parallelized(a_ext.chars, b_shifted.chars)
        return FheAsciiString(chars=merged, capacity=cap)

    # -- encrypted-pattern search (strings/server_key/pattern/) ---------------
    def _char_or_null(self, s: FheAsciiString, i: int) -> RadixCiphertext:
        if i < s.capacity:
            return self._char_at(s, i)
        return self.key._trivial_radix(0, CHAR_BLOCKS, self._char_at(s, 0))

    def _match_at(self, s: FheAsciiString, p: FheAsciiString, off: int) -> BooleanBlock:
        """AND over pattern positions of (p_k == NUL) OR (s_{off+k} == p_k):
        the padded-pattern match predicate (pattern/contains.rs)."""
        sk = self.key
        bit = None
        for k in range(p.capacity):
            pk = self._char_at(p, k)
            sc = self._char_or_null(s, off + k)
            eq = sk.eq(sc, pk)
            is_null = sk.scalar_eq(pk, 0)
            ok = sk.boolean_bitor(eq, is_null)
            bit = ok if bit is None else sk.boolean_bitand(bit, ok)
        return bit

    def contains(self, s: FheAsciiString, p: FheAsciiString) -> BooleanBlock:
        """Encrypted-pattern containment: OR over every offset."""
        sk = self.key
        acc = None
        for off in range(s.capacity + 1):
            m = self._match_at(s, p, off)
            acc = m if acc is None else sk.boolean_bitor(acc, m)
        return acc

    def starts_with(self, s: FheAsciiString, p: FheAsciiString) -> BooleanBlock:
        return self._match_at(s, p, 0)

    def ends_with(self, s: FheAsciiString, p: FheAsciiString) -> BooleanBlock:
        """OR over offsets of exact-suffix alignment: all P chars (nulls
        included) equal s at the offset and the char after the window is
        NUL — padded-null semantics make the boundary check implicit."""
        sk = self.key
        acc = None
        for off in range(s.capacity + 1):
            bit = None
            for k in range(p.capacity):
                pk = self._char_at(p, k)
                sc = self._char_or_null(s, off + k)
                e = sk.eq(sc, pk)
                bit = e if bit is None else sk.boolean_bitand(bit, e)
            after = self._char_or_null(s, off + p.capacity)
            bit = sk.boolean_bitand(bit, sk.scalar_eq(after, 0))
            acc = bit if acc is None else sk.boolean_bitor(acc, bit)
        return acc

    def _scan_matches(self, s: FheAsciiString, p: FheAsciiString, offsets):
        """(index, found): the cmux cascade over ``offsets`` of the match
        predicate; the last matching offset visited wins."""
        sk = self.key
        like = self._char_at(s, 0)
        idx = sk._trivial_radix(0, CHAR_BLOCKS, like)
        found = None
        for off in offsets:
            m = self._match_at(s, p, off)
            off_ct = sk._trivial_radix(off, CHAR_BLOCKS, like)
            idx = sk.if_then_else(m, off_ct, idx)
            found = m if found is None else sk.boolean_bitor(found, m)
        return idx, found

    def find(self, s: FheAsciiString, p: FheAsciiString):
        """(index, found) for an encrypted pattern — back-to-front cmux."""
        return self._scan_matches(s, p, range(s.capacity, -1, -1))

    # -- lexicographic comparisons (strings/server_key/comp.rs) ---------------
    def _cmp_chain(self, a: FheAsciiString, b: FheAsciiString):
        """Returns (lt, eq) BooleanBlocks by folding from the LAST position:
        lt = (a_i < b_i) | (a_i == b_i & lt_rest)."""
        sk = self.key
        cap = max(a.capacity, b.capacity)
        lt = eq = None
        for i in range(cap - 1, -1, -1):
            ca = self._char_or_null(a, i)
            cb = self._char_or_null(b, i)
            l = sk.lt(ca, cb)
            e = sk.eq(ca, cb)
            if lt is None:
                lt, eq = l, e
            else:
                lt = sk.boolean_bitor(l, sk.boolean_bitand(e, lt))
                eq = sk.boolean_bitand(e, eq)
        return lt, eq

    def lt(self, a: FheAsciiString, b: FheAsciiString) -> BooleanBlock:
        return self._cmp_chain(a, b)[0]

    def le(self, a: FheAsciiString, b: FheAsciiString) -> BooleanBlock:
        lt, eq = self._cmp_chain(a, b)
        return self.key.boolean_bitor(lt, eq)

    def gt(self, a: FheAsciiString, b: FheAsciiString) -> BooleanBlock:
        return self.key.boolean_bitnot(self.le(a, b))

    def ge(self, a: FheAsciiString, b: FheAsciiString) -> BooleanBlock:
        return self.key.boolean_bitnot(self.lt(a, b))

    # -- trim (strings/server_key/trim.rs) ------------------------------------
    def _is_whitespace(self, c: RadixCiphertext) -> BooleanBlock:
        """ASCII whitespace: space, \\t, \\n, \\v, \\f, \\r."""
        sk = self.key
        sp = sk.scalar_eq(c, 32)
        tab_cr = sk.boolean_bitand(sk.scalar_ge(c, 9), sk.scalar_le(c, 13))
        return sk.boolean_bitor(sp, tab_cr)

    def _erased(self, s: FheAsciiString, conds) -> FheAsciiString:
        """s with char i replaced by NUL where ``conds[i]`` (one cmux each)."""
        sk = self.key
        zero = sk._trivial_radix(0, CHAR_BLOCKS, self._char_at(s, 0))
        return self._from_chars(s, [
            sk.if_then_else(conds[i], zero, self._char_at(s, i))
            for i in range(s.capacity)
        ])

    def trim_end(self, s: FheAsciiString) -> FheAsciiString:
        """Clear trailing whitespace: scanning from the end, a char is
        erased while every char after it is erased-or-null and it is
        whitespace."""
        sk = self.key
        erase = None  # so far, suffix is only whitespace/null
        cond_list = [None] * s.capacity
        for i in range(s.capacity - 1, -1, -1):
            c = self._char_at(s, i)
            ws = self._is_whitespace(c)
            nul = sk.scalar_eq(c, 0)
            removable = sk.boolean_bitor(ws, nul)
            erase = removable if erase is None else sk.boolean_bitand(
                erase, removable
            )
            cond_list[i] = erase
        return self._erased(s, cond_list)

    def trim_start(self, s: FheAsciiString) -> FheAsciiString:
        """Erase leading whitespace then compact left by the erased count."""
        sk = self.key
        # leading-whitespace prefix mask + count
        prefix = None
        bits = []
        for i in range(s.capacity):
            ws = self._is_whitespace(self._char_at(s, i))
            prefix = ws if prefix is None else sk.boolean_bitand(prefix, ws)
            bits.append(prefix)
        count = sk._sum_bool_bits(bits, self._char_at(s, 0))
        count = sk.cast_to_num_blocks(count, CHAR_BLOCKS)
        return self._shift_chars_left(s, count)

    def trim(self, s: FheAsciiString) -> FheAsciiString:
        return self.trim_start(self.trim_end(s))

    # -- splice / replace ------------------------------------------------------
    def strip_prefix_clear(self, s: FheAsciiString, prefix: str):
        """(result, stripped): when s starts with the clear prefix, shift it
        off; otherwise unchanged (pattern/strip.rs)."""
        sk = self.key
        m = self.starts_with_clear(s, prefix)
        n = sk._trivial_radix(len(prefix), CHAR_BLOCKS, self._char_at(s, 0))
        zero = sk._trivial_radix(0, CHAR_BLOCKS, self._char_at(s, 0))
        amt_ct = sk.if_then_else(m, n, zero)
        return self._shift_chars_left(s, amt_ct), m

    def strip_suffix_clear(self, s: FheAsciiString, suffix: str):
        """(result, stripped): erase the clear suffix when it terminates s."""
        sk = self.key
        L = len(suffix)
        acc_bits = []
        for off in range(s.capacity - L + 1):
            m = self._per_char_eq_scalar_bits(s, suffix, off)
            after = self._char_or_null(s, off + L)
            m = sk.boolean_bitand(m, sk.scalar_eq(after, 0))
            if off > 0:
                m = sk.boolean_bitand(
                    m, sk.scalar_ne(self._char_at(s, off), 0)
                )
            acc_bits.append((off, m))
        stripped = None
        zero = sk._trivial_radix(0, CHAR_BLOCKS, self._char_at(s, 0))
        outs = [self._char_at(s, i) for i in range(s.capacity)]
        for off, m in acc_bits:
            for k in range(L):
                if off + k < s.capacity:
                    outs[off + k] = sk.if_then_else(m, zero, outs[off + k])
            stripped = m if stripped is None else sk.boolean_bitor(stripped, m)
        return self._from_chars(s, outs), stripped

    def replace_clear(self, s: FheAsciiString, frm: str, to: str) -> FheAsciiString:
        """Replace every non-overlapping occurrence of a clear pattern with a
        clear replacement (strings/server_key/replace.rs). General lengths:
        the output is rebuilt position-by-position with encrypted write
        indices; output capacity grows by the worst-case expansion."""
        sk = self.key
        assert frm, "empty pattern"
        cap = s.capacity
        n_matches_max = cap // len(frm)
        out_cap = cap + max(0, (len(to) - len(frm))) * n_matches_max

        # 1. non-overlapping match bits, scanned left to right: a match at
        # `off` is suppressed when any match covers it already
        match = {}
        covered = [None] * cap  # covered[i] -> bit: position i inside a match
        for off in range(0, cap - len(frm) + 1):
            m = self._per_char_eq_scalar_bits(s, frm, off)
            # suppress overlaps: not covered by an earlier match
            if covered[off] is not None:
                m = sk.boolean_bitand(m, sk.boolean_bitnot(covered[off]))
            match[off] = m
            for k in range(len(frm)):
                i = off + k
                if i < cap:
                    covered[i] = (
                        m if covered[i] is None else sk.boolean_bitor(covered[i], m)
                    )

        # 2. equal lengths: in-place substitution
        if len(to) == len(frm):
            outs = [self._char_at(s, i) for i in range(cap)]
            for off, m in match.items():
                for k, ch in enumerate(to):
                    i = off + k
                    rc = sk._trivial_radix(ord(ch), CHAR_BLOCKS, outs[0])
                    outs[i] = sk.if_then_else(m, rc, outs[i])
            return self._from_chars(s, outs)

        # General lengths: sequential rebuild. Walk the string once; at each
        # offset either copy one char or (on a match) append `to` and skip
        # len(frm) chars — realized with an encrypted write position.
        result = self.encrypt_trivial("", out_cap)
        pos_like = self._char_at(s, 0)
        write_pos = sk._trivial_radix(0, CHAR_BLOCKS, pos_like)
        read_skip = [None] * cap  # bit: this source char is consumed by a match
        for off, m in match.items():
            for k in range(len(frm)):
                i = off + k
                read_skip[i] = (
                    m if read_skip[i] is None else sk.boolean_bitor(read_skip[i], m)
                )
        for i in range(cap):
            # chars written at this step: `to` when a match starts here,
            # else the source char when not consumed
            m = match.get(i)
            consumed = read_skip[i]
            # write the source char (unless consumed)
            c = self._char_at(s, i)
            zero = sk._trivial_radix(0, CHAR_BLOCKS, pos_like)
            keep = (
                sk.if_then_else(sk.boolean_bitnot(consumed), c, zero)
                if consumed is not None
                else c
            )
            result = self._scatter_char(result, write_pos, keep)
            one_if_kept = (
                sk.if_then_else(
                    sk.boolean_bitnot(consumed),
                    sk._trivial_radix(1, CHAR_BLOCKS, pos_like),
                    sk._trivial_radix(0, CHAR_BLOCKS, pos_like),
                )
                if consumed is not None
                else sk._trivial_radix(1, CHAR_BLOCKS, pos_like)
            )
            if m is not None:
                # on a match starting here, write `to` at write_pos..+len(to)
                for k, ch in enumerate(to):
                    rc = sk._trivial_radix(ord(ch), CHAR_BLOCKS, pos_like)
                    sel = sk.if_then_else(m, rc, zero)
                    wp = sk.scalar_add(write_pos, k)
                    result = self._scatter_char(result, wp, sel)
                adv_m = sk._trivial_radix(len(to), CHAR_BLOCKS, pos_like)
                advance = sk.if_then_else(m, adv_m, one_if_kept)
            else:
                advance = one_if_kept
            write_pos = sk.add_parallelized(write_pos, advance)
        return result

    def _scatter_char(self, s: FheAsciiString, pos: RadixCiphertext,
                      c: RadixCiphertext) -> FheAsciiString:
        """result[pos] += c (encrypted position): adds c at every index
        gated by an index-equality bit — O(capacity) cmux."""
        sk = self.key
        outs = []
        for j in range(s.capacity):
            here = sk.scalar_eq(pos, j)
            cur = self._char_at(s, j)
            cand = sk.add_parallelized(cur, c)
            outs.append(sk.if_then_else(here, cand, cur))
        return self._from_chars(s, outs)

    # -- generic pattern / conditional select ---------------------------------
    def _pat(self, p) -> FheAsciiString:
        """GenericPattern analog (strings/ciphertext GenericPatternRef): a
        clear ``str`` becomes a trivial encryption; an FheAsciiString passes
        through. An empty clear pattern becomes a 1-slot all-null buffer
        (the padded-null match predicate treats it as empty)."""
        if isinstance(p, FheAsciiString):
            return p
        return self.encrypt_trivial(p, max(len(p), 1))

    def _trivial_bool(self, v: bool, like: RadixCiphertext) -> BooleanBlock:
        z = self.key._trivial_radix(1 if v else 0, 1, like)
        return BooleanBlock(ct=z.ct[..., 0, :])

    def _bool_to_radix(self, b: BooleanBlock, nb: int, like: RadixCiphertext
                       ) -> RadixCiphertext:
        """0/1 radix value from a boolean block (boolean_value.rs
        into_radix)."""
        blk = self.key._trivial_radix(0, nb, like)
        ct = blk.ct  # made just now by _trivial_radix: written in place
        ct[..., 0, :] = b.ct
        degs = np.zeros(nb, dtype=np.int64)
        degs[0] = 1
        noises = np.zeros(nb, dtype=np.int64)
        noises[0] = 1
        return blk.with_ct(ct, degrees=degs, noise_levels=noises)

    def conditional_string(self, cond: BooleanBlock, a: FheAsciiString,
                           b: FheAsciiString) -> FheAsciiString:
        """cond ? a : b, capacity-aligned (server_key/mod.rs
        conditional_string)."""
        cap = max(a.capacity, b.capacity)
        a = self._resize(a, cap)
        b = self._resize(b, cap)
        out = self.key.if_then_else(cond, a.chars, b.chars)
        return FheAsciiString(chars=out, capacity=cap)

    def pat_is_empty(self, p: FheAsciiString) -> BooleanBlock:
        return self.key.scalar_eq(self._char_at(p, 0), 0)

    # -- rfind / eq_ignore_case ----------------------------------------------
    def rfind(self, s: FheAsciiString, p):
        """(index, found) of the LAST match (pattern/find.rs rfind): forward
        cmux scan keeps the last matching offset; an empty pattern's last
        match is at len(s) (not at the padded capacity)."""
        sk = self.key
        p = self._pat(p)
        idx, found = self._scan_matches(s, p, range(0, s.capacity + 1))
        empty = self.pat_is_empty(p)
        real_len = sk.cast_to_num_blocks(self.len(s), CHAR_BLOCKS)
        idx = sk.if_then_else(empty, real_len, idx)
        return idx, found

    def eq_ignore_case(self, a: FheAsciiString, b: FheAsciiString) -> BooleanBlock:
        """Case-insensitive equality (comp.rs eq_ignore_case)."""
        return self.eq(self.to_lowercase(a), self.to_lowercase(b))

    # -- splitting at an encrypted index (pattern/split/mod.rs) ---------------
    def split_pat_at_index(self, s: FheAsciiString, p, index: RadixCiphertext,
                           inclusive: bool):
        """(lhs, rhs): lhs keeps chars below ``index`` (plus the pattern when
        ``inclusive``), rhs starts after the pattern — realized with the
        right-then-left shift trick of the reference
        (split/mod.rs split_pat_at_index)."""
        sk = self.key
        p = self._pat(p)
        like = self._char_at(s, 0)
        pat_len = sk.cast_to_num_blocks(self.len(p), CHAR_BLOCKS)
        cap_ct = sk._trivial_radix(s.capacity, CHAR_BLOCKS, like)
        shift_right = sk.sub_parallelized(cap_ct, index)
        if inclusive:
            shift_right = sk.sub_parallelized(shift_right, pat_len)
        lhs = self._shift_chars_left(
            self._shift_chars_right(s, shift_right), shift_right
        )
        rhs = self._shift_chars_left(s, sk.add_parallelized(pat_len, index))
        return lhs, rhs

    def split_once(self, s: FheAsciiString, p):
        """(lhs, rhs, split_occurred) at the FIRST occurrence
        (split/mod.rs split_once)."""
        p = self._pat(p)
        idx, is_match = self.find(s, p)
        lhs, rhs = self.split_pat_at_index(s, p, idx, False)
        return lhs, rhs, is_match

    def rsplit_once(self, s: FheAsciiString, p):
        """(lhs, rhs, split_occurred) at the LAST occurrence."""
        p = self._pat(p)
        idx, is_match = self.rfind(s, p)
        lhs, rhs = self.split_pat_at_index(s, p, idx, False)
        return lhs, rhs, is_match

    # -- split iterators -------------------------------------------------------
    def split(self, s: FheAsciiString, p) -> "FheStringIterator":
        return _SplitInternal(self, s, self._pat(p), "split")

    def rsplit(self, s: FheAsciiString, p) -> "FheStringIterator":
        return _SplitInternal(self, s, self._pat(p), "rsplit")

    def splitn(self, s: FheAsciiString, p, n, max_n: Optional[int] = None):
        return _SplitN(self, s, self._pat(p), "split", n, max_n)

    def rsplitn(self, s: FheAsciiString, p, n, max_n: Optional[int] = None):
        return _SplitN(self, s, self._pat(p), "rsplit", n, max_n)

    def split_terminator(self, s: FheAsciiString, p) -> "FheStringIterator":
        return _SplitNoTrailing(self, s, self._pat(p), "split")

    def split_inclusive(self, s: FheAsciiString, p) -> "FheStringIterator":
        return _SplitNoTrailing(self, s, self._pat(p), "inclusive")

    def rsplit_terminator(self, s: FheAsciiString, p) -> "FheStringIterator":
        return _SplitNoLeading(self, s, self._pat(p))

    def split_ascii_whitespace(self, s: FheAsciiString) -> "FheStringIterator":
        return _SplitAsciiWhitespace(self, s)

    # -- encrypted-pattern strip (pattern/strip.rs) ---------------------------
    def strip_prefix(self, s: FheAsciiString, p):
        """(result, stripped) for an encrypted (or clear) prefix pattern."""
        sk = self.key
        p = self._pat(p)
        m = self.starts_with(s, p)
        like = self._char_at(s, 0)
        pat_len = sk.cast_to_num_blocks(self.len(p), CHAR_BLOCKS)
        zero = sk._trivial_radix(0, CHAR_BLOCKS, like)
        amt = sk.if_then_else(m, pat_len, zero)
        return self._shift_chars_left(s, amt), m

    def strip_suffix(self, s: FheAsciiString, p):
        """(result, stripped): erase the last len(p) real chars when the
        encrypted pattern terminates s."""
        sk = self.key
        p = self._pat(p)
        m = self.ends_with(s, p)
        slen = sk.cast_to_num_blocks(self.len(s), CHAR_BLOCKS)
        plen = sk.cast_to_num_blocks(self.len(p), CHAR_BLOCKS)
        start = sk.sub_parallelized(slen, plen)  # only used when m
        erase = [sk.boolean_bitand(m, sk.scalar_le(start, i))  # start <= i
                 for i in range(s.capacity)]
        return self._erased(s, erase), m

    # -- repeat (no_patterns.rs repeat) ---------------------------------------
    def _concat_at(self, base: FheAsciiString, piece: FheAsciiString,
                   pos: RadixCiphertext) -> FheAsciiString:
        """base with ``piece`` added at encrypted char position ``pos``
        (positions there must currently be null)."""
        sk = self.key
        shifted = self._shift_chars_right(
            self._resize(piece, base.capacity), pos
        )
        merged = sk.add_parallelized(base.chars, shifted.chars)
        return FheAsciiString(chars=merged, capacity=base.capacity)

    def repeat(self, s: FheAsciiString, n, max_n: Optional[int] = None
               ) -> FheAsciiString:
        """s repeated n times; n is a clear int or an encrypted count with a
        clear ``max_n`` bound (UIntArg::Enc semantics)."""
        sk = self.key
        like = self._char_at(s, 0)
        if isinstance(n, int):
            reps, n_ct = n, None
        else:
            assert max_n is not None, "encrypted repeat count needs max_n"
            reps, n_ct = max_n, n
        out_cap = max(1, s.capacity * max(reps, 1))
        out = self.encrypt_trivial("", out_cap)
        slen = sk.cast_to_num_blocks(self.len(s), CHAR_BLOCKS)
        pos = sk._trivial_radix(0, CHAR_BLOCKS, like)
        for k in range(reps):
            cand = self._concat_at(out, s, pos)
            npos = sk.add_parallelized(pos, slen)
            if n_ct is None:
                out, pos = cand, npos
            else:
                act = sk.scalar_gt(n_ct, k)
                out = self.conditional_string(act, cand, out)
                pos = sk.if_then_else(act, npos, pos)
        return out

    # -- encrypted-pattern replace (pattern/replace.rs) -----------------------
    def replace(self, s: FheAsciiString, frm, to,
                out_capacity: Optional[int] = None) -> FheAsciiString:
        return self.replacen(s, frm, to, None, out_capacity=out_capacity)

    def replacen(self, s: FheAsciiString, frm, to, n,
                 max_n: Optional[int] = None,
                 out_capacity: Optional[int] = None) -> FheAsciiString:
        """Replace up to n (clear int, encrypted count with clear ``max_n``,
        or None = all) non-overlapping occurrences, left to right
        (replace.rs replace_n_times): each round finds the first match past
        the replaced prefix, splices ``to`` in via shifts, and advances the
        skip index; an empty ``frm`` inserts ``to`` between chars (Rust
        semantics) and stops after len(s)+1 insertions."""
        sk = self.key
        frm = self._pat(frm)
        to = self._pat(to)
        like = self._char_at(s, 0)
        rounds = s.capacity + 1
        if isinstance(n, int):
            rounds = min(rounds, n)
            n_ct = None
        elif n is None:
            n_ct = None
        else:
            assert max_n is not None, "encrypted replace count needs max_n"
            rounds = min(rounds, max_n)
            n_ct = n
        out_cap = out_capacity or (s.capacity + to.capacity * rounds)
        state = self._resize(s, out_cap)
        frm_empty = self.pat_is_empty(frm)
        frm_empty_r = self._bool_to_radix(frm_empty, CHAR_BLOCKS, like)
        to_len = sk.cast_to_num_blocks(self.len(to), CHAR_BLOCKS)
        s_len = sk.cast_to_num_blocks(self.len(s), CHAR_BLOCKS)
        skip = sk._trivial_radix(0, CHAR_BLOCKS, like)
        enabled = self._trivial_bool(True, like)
        for r in range(rounds):
            suffix = self._shift_chars_left(state, skip)
            idx0, found = self.find(suffix, frm)
            idx = sk.add_parallelized(idx0, skip)
            act = sk.boolean_bitand(found, enabled)
            if n_ct is not None:
                act = sk.boolean_bitand(act, sk.scalar_gt(n_ct, r))
            # empty-pattern termination: at most len(s)+1 insertions
            # (replace.rs no_more_matches)
            lim = sk.boolean_bitor(
                sk.boolean_bitnot(frm_empty), sk.scalar_ge(s_len, r)
            )
            act = sk.boolean_bitand(act, lim)
            lhs, rhs = self.split_pat_at_index(state, frm, idx, False)
            cand = self._concat_at(lhs, to, idx)
            rhs_pos = sk.add_parallelized(idx, to_len)
            cand = self._concat_at(cand, rhs, rhs_pos)
            state = self.conditional_string(act, cand, state)
            nskip = sk.add_parallelized(
                sk.add_parallelized(idx, to_len), frm_empty_r
            )
            skip = sk.if_then_else(act, nskip, skip)
            enabled = act
        return state

    def encrypt_trivial(self, text: str, capacity: int) -> FheAsciiString:
        """Trivial (noiseless) encryption of a clear string — server-side
        constant (strings/server_key trivial encryptions), on the key's
        device."""
        sk = self.key
        mm = sk.params.message_modulus
        delta = sk.key.encoding.delta()
        data = np.zeros((capacity, CHAR_BLOCKS, sk.params.big_lwe_dimension + 1),
                        dtype=np.uint64)
        for i, ch in enumerate(text[:capacity]):
            v = ord(ch)
            for b in range(CHAR_BLOCKS):
                digit = (v // (mm ** b)) % mm
                data[i, b, -1] = (digit * delta) % (1 << 64)
        ct = RadixCiphertext(
            ct=from_u64(data, sk.key.device),
            degrees=np.full(CHAR_BLOCKS, mm - 1, dtype=np.int64),
            noise_levels=np.zeros(CHAR_BLOCKS, dtype=np.int64),
            message_modulus=mm,
            carry_modulus=sk.params.carry_modulus,
        )
        return FheAsciiString(chars=ct, capacity=capacity)


# ---------------------------------------------------------------------------
# split iterators (strings/server_key/pattern/split/, trim.rs)
# ---------------------------------------------------------------------------

class FheStringIterator:
    """Reference ``FheStringIterator`` (server_key/mod.rs:363): each ``next``
    returns ``(FheAsciiString, BooleanBlock)`` — the substring and an
    encrypted Some/None flag."""

    def next(self):  # pragma: no cover - interface
        raise NotImplementedError

    def collect(self, n: int):
        """Convenience: the first ``n`` (value, is_some) pairs."""
        return [self.next() for _ in range(n)]


class _SplitInternal(FheStringIterator):
    """SplitInternal (split/mod.rs:335-440): forward or reverse splitting;
    after the last match the remaining state is returned wrapped in Some."""

    def __init__(self, sk: StringServerKey, s: FheAsciiString,
                 pat: FheAsciiString, split_type: str):
        self.sk = sk
        self.split_type = split_type
        self.state = s
        self.pat = pat
        like = sk._char_at(s, 0)
        self._like = like
        self.prev_was_some = sk._trivial_bool(True, like)
        self.counter = 0
        k = sk.key
        self.max_counter = k.scalar_add(
            k.cast_to_num_blocks(sk.len(s), CHAR_BLOCKS), 1
        )
        self.counter_lt_max = sk._trivial_bool(True, like)

    def next(self):
        sk = self.sk
        k = sk.key
        rsplit = self.split_type == "rsplit"
        if rsplit:
            idx, is_some = sk.rfind(self.state, self.pat)
        else:
            idx, is_some = sk.find(self.state, self.pat)
        if self.counter > 0:
            # empty pattern: manually advance the split index (an empty
            # pattern always matches at the very start/end)
            pe = sk._bool_to_radix(
                sk.pat_is_empty(self.pat), CHAR_BLOCKS, self._like
            )
            if rsplit:
                idx = k.sub_parallelized(idx, pe)
            else:
                idx = k.add_parallelized(idx, pe)
        inclusive = self.split_type == "inclusive"
        lhs, rhs = sk.split_pat_at_index(self.state, self.pat, idx, inclusive)
        current_is_some = is_some
        if rsplit:
            result = sk.conditional_string(current_is_some, rhs, self.state)
            self.state = lhs
        else:
            result = sk.conditional_string(current_is_some, lhs, self.state)
            self.state = rhs
        is_some = k.boolean_bitor(is_some, self.prev_was_some)
        is_some = k.boolean_bitand(is_some, self.counter_lt_max)
        self.prev_was_some = current_is_some
        self.counter_lt_max = k.scalar_gt(self.max_counter, self.counter)
        self.counter += 1
        return result, is_some


class _SplitN(FheStringIterator):
    """SplitNInternal: at most n items; the n-th wraps the remaining state."""

    def __init__(self, sk, s, pat, split_type, n, max_n):
        self.internal = _SplitInternal(sk, s, pat, split_type)
        self.sk = sk
        self.n = n
        self.counter = 0
        like = sk._char_at(s, 0)
        if isinstance(n, int):
            self.not_exceeded = sk._trivial_bool(n != 0, like)
        else:
            self.not_exceeded = sk.key.scalar_ne(n, 0)

    def next(self):
        sk = self.sk
        k = sk.key
        state = self.internal.state
        result, is_some = self.internal.next()
        is_some = k.boolean_bitand(is_some, self.not_exceeded)
        if isinstance(self.n, int):
            if self.counter + 1 >= self.n:
                result = state
                self.not_exceeded = sk._trivial_bool(False, sk._char_at(state, 0))
        else:
            exceeded = k.scalar_le(k.scalar_sub(self.n, 1), self.counter)
            result = sk.conditional_string(exceeded, state, result)
            self.not_exceeded = k.boolean_bitand(
                self.not_exceeded, k.boolean_bitnot(exceeded)
            )
        self.counter += 1
        return result, is_some


class _SplitNoTrailing(FheStringIterator):
    """SplitNoTrailing: drops a trailing empty item (split_terminator,
    split_inclusive)."""

    def __init__(self, sk, s, pat, split_type):
        self.sk = sk
        self.internal = _SplitInternal(sk, s, pat, split_type)
        # max_counter = len (not len+1): the trailing item is dropped
        self.internal.max_counter = sk.key.cast_to_num_blocks(
            sk.len(s), CHAR_BLOCKS
        )

    def next(self):
        sk = self.sk
        k = sk.key
        result, is_some = self.internal.next()
        result_is_empty = sk.is_empty(result)
        prev_was_none = k.boolean_bitnot(self.internal.prev_was_some)
        trailing_empty = k.boolean_bitand(result_is_empty, prev_was_none)
        is_some = k.boolean_bitand(is_some, k.boolean_bitnot(trailing_empty))
        return result, is_some


class _SplitNoLeading(FheStringIterator):
    """SplitNoLeading: drops a leading empty item (rsplit_terminator) by
    computing one next() ahead."""

    def __init__(self, sk, s, pat):
        self.sk = sk
        self.internal = _SplitInternal(sk, s, pat, "rsplit")
        self.prev_return = self.internal.next()
        self.leading_empty = sk.is_empty(self.prev_return[0])

    def next(self):
        sk = self.sk
        k = sk.key
        result, is_some = self.internal.next()
        ret_res = sk.conditional_string(
            self.leading_empty, result, self.prev_return[0]
        )
        lhs = k.boolean_bitand(self.leading_empty, is_some)
        rhs = k.boolean_bitand(
            k.boolean_bitnot(self.leading_empty), self.prev_return[1]
        )
        ret_some = k.boolean_bitor(lhs, rhs)
        self.prev_return = (result, is_some)
        return ret_res, ret_some


class _SplitAsciiWhitespace(FheStringIterator):
    """split_ascii_whitespace (trim.rs:375): tokens between whitespace runs;
    never yields empty items."""

    def __init__(self, sk, s):
        self.sk = sk
        self.state = s

    def next(self):
        sk = self.sk
        k = sk.key
        state = sk.trim_start(self.state)
        is_some = k.boolean_bitnot(sk.is_empty(state))
        # token = chars before the first whitespace; mask out the rest
        seen = None
        conds = []
        for i in range(state.capacity):
            w = sk._is_whitespace(sk._char_at(state, i))
            seen = w if seen is None else k.boolean_bitor(seen, w)
            conds.append(seen)
        token = sk._erased(state, conds)
        tok_len = k.cast_to_num_blocks(sk.len(token), CHAR_BLOCKS)
        self.state = sk._shift_chars_left(state, tok_len)
        return token, is_some
