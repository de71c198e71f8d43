"""Integer radix op tail: parallel multi-operand sum & mul, vector find,
constant-divisor division, bit manipulation, dot products, oblivious
pseudo-random generation.

Torch counterpart of ``tfhe_tpu/integer/ops_extra.py``. Reference files
(all under tfhe/src/integer/server_key/radix_parallel/): ``sum.rs``
(unchecked_sum_ciphertexts_vec_parallelized), ``mul.rs:455-640``
(partial-product matrix + parallel reduction), ``vector_find.rs`` (match /
contains / index families), ``scalar_div_mod.rs`` (division by an invariant
clear divisor via multiply-high), ``reverse_bits.rs``, ``slice.rs``,
``scalar_dot_prod.rs``, ``rotate.rs`` (encrypted amounts), ``ilog2.rs``
(leading/trailing zeros/ones), ``mul.rs`` overflowing variant.

Implemented as a mixin so :class:`tfhe_tpu_torch.integer.radix.ServerKey`
(which provides the primitives: ``_pbs_blocks``, ``_lut``,
``add_parallelized``, ``sum_ciphertexts``, shifts, comparisons) stays the
single public type. Per-block work becomes ONE batched PBS over a widened
block axis; sequential depth only where the algorithm demands it.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from ..shortint import oprf as _oprf

NOMINAL_NOISE = 1


class RadixExtraOps:
    # ==================================================================
    # parallel multi-operand sum (carry-save compression) — sum.rs
    # ==================================================================

    def sum_ciphertexts_parallelized(self, cts: list):
        """Sum k ciphertexts in O(log k) batched-PBS rounds.

        Each round greedily packs operands into groups whose degree sums fit
        the carry budget, adds each group leveled (free), then splits every
        group sum into (message, carry) with ONE batched PBS pair — a
        generalized c:2 compressor (reference
        unchecked_sum_ciphertexts_vec_parallelized, sum.rs)."""
        from .radix import RadixCiphertext

        if not cts:
            raise ValueError("empty sum")
        mm = self.params.message_modulus
        budget = self._prop_budget
        max_noise = self.params.max_noise_level
        cur = [c for c in cts]
        while len(cur) > 2:
            groups = []
            g = [cur[0]]
            deg = cur[0].degrees.copy()
            noi = cur[0].noise_levels.copy()
            for ct in cur[1:]:
                nd = deg + ct.degrees
                nn = noi + ct.noise_levels
                if np.all(nd <= budget) and np.all(nn + 1 < max_noise):
                    g.append(ct)
                    deg, noi = nd, nn
                else:
                    groups.append(g)
                    g, deg, noi = [ct], ct.degrees.copy(), ct.noise_levels.copy()
            groups.append(g)
            nxt = []
            multi = [g for g in groups if len(g) > 1]
            nxt.extend(g[0] for g in groups if len(g) == 1)
            if not multi:
                # budgets exhausted without any packing. _clean alone is NOT
                # enough: it only fires on degree-dirty blocks, so operands
                # whose NOISE blocks packing (e.g. bool*clear terms) would
                # loop forever. Force a real reset on anything dirty; if
                # nothing is dirty the budgets are structurally too tight —
                # reduce sequentially instead.
                dirty = [
                    i for i, c in enumerate(cur)
                    if np.any(c.noise_levels > 1) or not self._max_clean(c)
                ]
                if not dirty:
                    res = cur[0]
                    for c in cur[1:]:
                        res = self.add_parallelized(res, c)
                    return res
                cur = [
                    self.full_propagate(c) if i in set(dirty) else c
                    for i, c in enumerate(cur)
                ]
                continue
            # leveled group sums, then one batched (msg, carry) PBS pair
            sums, degs, nois = [], [], []
            for g in multi:
                s = g[0].ct
                d = g[0].degrees.copy()
                n = g[0].noise_levels.copy()
                for ct in g[1:]:
                    s = s + ct.ct
                    d += ct.degrees
                    n += ct.noise_levels
                sums.append(s)
                degs.append(d)
                nois.append(n)
            big = torch.cat(sums, dim=-2)
            deg_in = int(max(int(d.max()) for d in degs))
            noise_in = int(max(int(n.max()) for n in nois))
            msg_lut = self._lut(lambda x: x % mm, degree=mm - 1)
            carry_lut = self._lut(lambda x: x // mm, degree=budget // mm)
            msgs = self._pbs_blocks(big, deg_in, noise_in, msg_lut)
            carries = self._pbs_blocks(big, deg_in, noise_in, carry_lut)
            off = 0
            nb = cur[0].num_blocks
            for g, d in zip(multi, degs):
                m_blocks = msgs[..., off : off + nb, :]
                c_blocks = self._shift_blocks_right(
                    carries[..., off : off + nb, :], 1
                )
                off += nb
                nxt.append(
                    cur[0].with_ct(
                        m_blocks,
                        degrees=np.minimum(d, mm - 1),
                        noise_levels=np.full(nb, NOMINAL_NOISE, dtype=np.int64),
                    )
                )
                cdeg = np.minimum(
                    self._np_shift_right(d // mm, 1), budget
                )
                if np.any(cdeg > 0):  # degree-0 carry is provably zero
                    nxt.append(
                        cur[0].with_ct(
                            c_blocks,
                            degrees=cdeg,
                            noise_levels=np.full(nb, NOMINAL_NOISE, dtype=np.int64),
                        )
                    )
            cur = nxt
        if len(cur) == 1:
            return self._clean(cur[0])
        return self.add_parallelized(cur[0], cur[1])

    @staticmethod
    def _np_shift_right(arr: np.ndarray, d: int) -> np.ndarray:
        out = np.zeros_like(arr)
        if d < len(arr):
            out[d:] = arr[: len(arr) - d]
        return out

    # ==================================================================
    # parallel multiplication — mul.rs:455-640
    # ==================================================================

    def mul_parallelized(self, a, b):
        """Partial-product matrix with TWO batched PBS (all (i, j) low/high
        halves at once), then the log-depth compressor sum."""
        from .radix import RadixCiphertext

        mm = self.params.message_modulus
        a, b = self._clean(a), self._clean(b)
        nb = a.num_blocks
        # packed[j, i] = a_i * mm + b_j over a widened block axis
        a_rep = torch.cat([a.ct] * nb, dim=-2)  # [..., nb*nb, dim]
        b_rep = torch.repeat_interleave(b.ct, nb, dim=-2)
        packed = a_rep * mm + b_rep
        deg_in = (mm - 1) * mm + (mm - 1)
        noise_in = int(np.max(a.noise_levels)) * mm + int(np.max(b.noise_levels))
        low_lut = self._lut(lambda x: (((x // mm) % mm) * (x % mm)) % mm)
        high_lut = self._lut(lambda x: (((x // mm) % mm) * (x % mm)) // mm)
        lows = self._pbs_blocks(packed, deg_in, noise_in, low_lut)
        highs = self._pbs_blocks(packed, deg_in, noise_in, high_lut)
        lows = lows.reshape(lows.shape[:-2] + (nb, nb) + lows.shape[-1:])
        highs = highs.reshape(lows.shape)

        terms = []
        nominal = np.full(nb, NOMINAL_NOISE, dtype=np.int64)
        for j in range(nb):
            low_j = self._shift_blocks_right(lows[..., j, :, :], j)
            degs = np.zeros(nb, dtype=np.int64)
            degs[j:] = mm - 1
            terms.append(a.with_ct(low_j, degrees=degs, noise_levels=nominal))
            if j + 1 < nb:
                high_j = self._shift_blocks_right(highs[..., j, :, :], j + 1)
                degs2 = np.zeros(nb, dtype=np.int64)
                degs2[j + 1 :] = mm - 1
                terms.append(
                    a.with_ct(high_j, degrees=degs2, noise_levels=nominal)
                )
        return self.sum_ciphertexts_parallelized(terms)

    def overflowing_add(self, a, b):
        return self.add_parallelized(a, b, compute_overflow=True)

    def overflowing_sub(self, a, b):
        return self.sub_parallelized(a, b, compute_overflow=True)

    def overflowing_mul(self, a, b):
        """(a * b mod 2^t, overflow) via the full double-width product
        (mul.rs unsigned_overflowing_mul)."""
        nb = a.num_blocks
        a2 = self.cast_to_num_blocks(self._clean(a), 2 * nb)
        b2 = self.cast_to_num_blocks(self._clean(b), 2 * nb)
        full = self.mul_parallelized(a2, b2)
        lo = self._take_blocks(full, 0, nb)
        hi = self._take_blocks(full, nb, 2 * nb)
        ov = self.scalar_ne(hi, 0)
        return lo, ov

    def _take_blocks(self, ct, start: int, end: int):
        from .radix import RadixCiphertext

        return RadixCiphertext(
            ct=ct.ct[..., start:end, :],
            degrees=ct.degrees[start:end].copy(),
            noise_levels=ct.noise_levels[start:end].copy(),
            message_modulus=ct.message_modulus,
            carry_modulus=ct.carry_modulus,
        )

    # ==================================================================
    # vector find / match — vector_find.rs
    # ==================================================================

    def _scalar_eq_many(self, a, scalars: list):
        """Equality of one ciphertext against many clear values with ONE
        batched PBS + one reduction per candidate batch (the per-(candidate,
        block) LUT stack rides the widened block axis)."""
        from .radix import BooleanBlock, LookupTable

        mm = self.params.message_modulus
        a = self._clean(a)
        nb = a.num_blocks
        k = len(scalars)
        accs = []
        for s in scalars:
            digits = self._scalar_blocks(int(s), nb)
            for b in range(nb):
                accs.append(
                    self.key.generate_lookup_table(
                        lambda x, d=digits[b]: 1 if (x % mm) == d else 0
                    ).acc
                )
        lut = LookupTable(acc=torch.stack(accs, dim=0), degree=1)
        rep = torch.cat([a.ct] * k, dim=-2)  # [..., k*nb, dim]
        bits = self._pbs_blocks(
            rep, mm - 1, int(np.max(a.noise_levels)), lut
        )  # per-(candidate, block) equality bits
        # AND-reduce each candidate's nb bits: sum then compare to the
        # width, chunked by the carry budget; the candidate axis plays the
        # block axis in each batched PBS
        budget = self._prop_budget
        cur = bits.reshape(bits.shape[:-2] + (k, nb) + bits.shape[-1:])
        width = nb
        while True:
            if width <= budget:
                total = cur.sum(dim=-2)  # [..., k, dim]
                eq_lut = self._lut(lambda x, w=width: 1 if x == w else 0, degree=1)
                final = self._pbs_blocks(total, width, width, eq_lut)
                break
            parts = []
            for off in range(0, width, budget):
                w = min(budget, width - off)
                seg = cur[..., off : off + w, :].sum(dim=-2)  # [..., k, dim]
                lutw = self._lut(lambda x, w=w: 1 if x == w else 0, degree=1)
                parts.append(self._pbs_blocks(seg, w, w, lutw))
            cur = torch.stack(parts, dim=-2)  # [..., k, n_parts, dim]
            width = len(parts)
        return [BooleanBlock(ct=final[..., i, :]) for i in range(k)]

    def match_value(self, a, matches: list):
        """MatchValues lookup: ``matches`` is a list of (input, output) clear
        pairs; returns (result, check) where check says some input matched
        (vector_find.rs match_value_parallelized)."""
        from .radix import BooleanBlock

        ins = [m[0] for m in matches]
        outs = [m[1] for m in matches]
        eqs = self._scalar_eq_many(a, ins)
        out_bits = max(max(int(o) for o in outs), 1).bit_length()
        bits = self._bits_per_block()
        nb_out = max(1, math.ceil(out_bits / bits))
        terms = []
        for eq, out in zip(eqs, outs):
            terms.append(self._bool_times_clear(eq, int(out), nb_out, a))
        result = (
            self.sum_ciphertexts_parallelized(terms)
            if terms
            else self._trivial_radix(0, nb_out, a)
        )
        check = eqs[0]
        for e in eqs[1:]:
            check = self.boolean_bitor(check, e)
        return result, check

    def match_value_or(self, a, matches: list, default: int):
        """match_value with a default when nothing matches
        (vector_find.rs match_value_or_parallelized). The output is wide
        enough for the default too, not just the match outputs."""
        result, check = self.match_value(a, matches)
        bits = self._bits_per_block()
        nb_default = max(1, math.ceil(max(int(default), 1).bit_length() / bits))
        nb = max(result.num_blocks, nb_default)
        if result.num_blocks < nb:
            result = self.cast_to_num_blocks(result, nb)
        d = self._trivial_radix(int(default), nb, a)
        return self.if_then_else(check, result, d), check

    def _bool_times_clear(self, bit, clear: int, nb: int, like):
        """bit (BooleanBlock) * clear -> radix: one LUT per block of the
        clear's digits, applied to the single bit block (batched)."""
        from .radix import RadixCiphertext

        mm = self.params.message_modulus
        digits = self._scalar_blocks(int(clear), nb)
        ct = self._trivial_zero_blocks(like, nb)
        degs = np.zeros(nb, dtype=np.int64)
        noises = np.zeros(nb, dtype=np.int64)
        for b, d in enumerate(digits):
            if d == 0:
                continue
            ct[..., b, :] = bit.ct * d
            degs[b] = d
            noises[b] = d
        return RadixCiphertext(
            ct=ct, degrees=degs, noise_levels=noises,
            message_modulus=mm, carry_modulus=like.carry_modulus,
        )

    def is_in_clears(self, a, clears: list):
        """a in {clears}: OR over the batched equality bits
        (vector_find.rs contains_clear_parallelized)."""
        eqs = self._scalar_eq_many(a, list(clears))
        out = eqs[0]
        for e in eqs[1:]:
            out = self.boolean_bitor(out, e)
        return out

    def contains(self, cts: list, value):
        """Does the encrypted vector contain the encrypted value?"""
        bits = [self.eq(c, value) for c in cts]
        out = bits[0]
        for b in bits[1:]:
            out = self.boolean_bitor(out, b)
        return out

    def contains_clear(self, cts: list, clear: int):
        bits = [self.scalar_eq(c, int(clear)) for c in cts]
        out = bits[0]
        for b in bits[1:]:
            out = self.boolean_bitor(out, b)
        return out

    def index_in_clears(self, a, clears: list):
        """(index, found) of ``a`` in a clear list — first match wins
        (vector_find.rs index_in_clears_parallelized)."""
        eqs = self._scalar_eq_many(a, list(clears))
        return self._first_index_from_bits(eqs, a)

    def first_index_in_clears(self, a, clears: list):
        return self.index_in_clears(a, clears)

    def index_of(self, cts: list, value):
        """(index, found) of an encrypted value in an encrypted vector."""
        eqs = [self.eq(c, value) for c in cts]
        return self._first_index_from_bits(eqs, cts[0])

    def _first_index_from_bits(self, eqs: list, like):
        """Convert per-candidate hit bits into (first index, found)."""
        # first-hit mask: hit_i AND NOT(any earlier hit): compute prefix ORs
        prefix = []
        cur = None
        for e in eqs:
            cur = e if cur is None else self.boolean_bitor(cur, e)
            prefix.append(cur)
        firsts = [eqs[0]]
        for i in range(1, len(eqs)):
            not_before = self.boolean_bitnot(prefix[i - 1])
            firsts.append(self.boolean_bitand(eqs[i], not_before))
        bits = self._bits_per_block()
        nb_out = max(1, math.ceil(max(1, (len(eqs) - 1).bit_length()) / bits))
        terms = [
            self._bool_times_clear(f, i, nb_out, like)
            for i, f in enumerate(firsts)
            if i > 0
        ]
        index = (
            self.sum_ciphertexts_parallelized(terms)
            if terms
            else self._trivial_radix(0, nb_out, like)
        )
        return index, prefix[-1]

    # ==================================================================
    # division by an invariant clear divisor — scalar_div_mod.rs
    # ==================================================================

    def scalar_div_rem(self, a, divisor: int):
        """floor(a / d), a mod d for a clear d >= 1 via multiply-high:
        with t total bits and M = ceil(2^(2t) / d), floor(a * M / 2^(2t))
        equals floor(a / d) for every a < 2^t (scalar_div_mod.rs
        signed/unsigned_scalar_div_mod; Granlund & Montgomery)."""
        d = int(divisor)
        if d < 1:
            raise ZeroDivisionError("division by zero")
        a = self._clean(a)
        nb = a.num_blocks
        bits = self._bits_per_block()
        t = nb * bits
        if d == 1:
            return a, self._trivial_radix(0, nb, a)
        if (d & (d - 1)) == 0:
            sh = d.bit_length() - 1
            q = self.scalar_right_shift(a, sh)
            r = self.scalar_bitand(a, d - 1)
            return q, r
        if d >= (1 << t):
            return self._trivial_radix(0, nb, a), a
        M = -(-(1 << (2 * t)) // d)  # ceil
        # widen so a * M (< 2^(3t+1)) fits, multiply by the clear M, then
        # drop 2t bits (an exact block shift since bits | 2t)
        nb_ext = math.ceil((3 * t + 1) / bits)
        a_ext = self.cast_to_num_blocks(a, nb_ext)
        prod = self.scalar_mul(a_ext, M)
        q_ext = self._take_blocks(self._clean(prod), 2 * t // bits, nb_ext)
        q = self.cast_to_num_blocks(q_ext, nb)
        qd = self.scalar_mul(q, d)
        r = self.sub_parallelized(a, qd)
        return q, r

    def scalar_div(self, a, divisor: int):
        return self.scalar_div_rem(a, divisor)[0]

    def scalar_rem(self, a, divisor: int):
        return self.scalar_div_rem(a, divisor)[1]

    # ==================================================================
    # bit manipulation — reverse_bits.rs, slice.rs, ilog2.rs
    # ==================================================================

    def reverse_bits(self, a):
        """Bit-reversal: reverse the block order and bit-reverse every block
        with one batched LUT (reverse_bits.rs)."""
        a = self._clean(a)
        bits = self._bits_per_block()
        rev_lut = self._lut(
            lambda x: int(format(x % (1 << bits), f"0{bits}b")[::-1], 2),
            degree=self.params.message_modulus - 1,
        )
        out = self._pbs_blocks(
            a.ct, self.params.message_modulus - 1,
            int(np.max(a.noise_levels)), rev_lut,
        )
        out = torch.flip(out, dims=(-2,))
        nb = a.num_blocks
        return a.with_ct(
            out,
            degrees=np.full(nb, self.params.message_modulus - 1, dtype=np.int64),
            noise_levels=np.full(nb, NOMINAL_NOISE, dtype=np.int64),
        )

    def scalar_bitslice(self, a, start: int, end: int):
        """Bits [start, end) of ``a`` as a (right-aligned) radix value
        (slice.rs scalar_bitslice_parallelized)."""
        if not 0 <= start <= end:
            raise ValueError(f"bit slice [{start}, {end}) is not a range")
        t = a.num_blocks * self._bits_per_block()
        end = min(end, t)
        shifted = self.scalar_right_shift(a, start) if start else self._clean(a)
        width = end - start
        if width >= t:
            return shifted
        return self.scalar_bitand(shifted, (1 << width) - 1)

    def leading_zeros(self, a):
        """Number of leading zero bits (ilog2.rs leading_zeros_parallelized):
        lz = sum over bit positions k of [a < 2^(t-k)] == t - (ilog2+1) for
        a > 0; computed directly as a sum of comparisons so a == 0 gives t."""
        a = self._clean(a)
        t = a.num_blocks * self._bits_per_block()
        # lz(a) = #{ m in [0, t) : a <= 2^(t-1-m) - 1 }  (a == 0 counts t)
        terms = [self.scalar_le(a, (1 << (t - 1 - m)) - 1) for m in range(t)]
        return self._sum_bool_bits(terms, a)

    def trailing_zeros(self, a):
        return self.leading_zeros(self.reverse_bits(a))

    def leading_ones(self, a):
        return self.leading_zeros(self.bitnot(a))

    def trailing_ones(self, a):
        return self.trailing_zeros(self.bitnot(a))

    def _sum_bool_bits(self, bools: list, like):
        nb_out = like.num_blocks
        terms = [self._bool_times_clear(b, 1, nb_out, like) for b in bools]
        return self.sum_ciphertexts_parallelized(terms)

    # ==================================================================
    # rotates by encrypted amounts — rotate.rs
    # ==================================================================

    def rotate_right(self, a, amount):
        """Rotate by an ENCRYPTED amount: barrel over scalar rotates."""
        return self._barrel_shift(a, amount, self.scalar_rotate_right)

    def rotate_left(self, a, amount):
        return self._barrel_shift(a, amount, self.scalar_rotate_left)

    # ==================================================================
    # dot products — scalar_dot_prod.rs
    # ==================================================================

    def scalar_dot_product(self, cts: list, clears: list):
        """sum_i ct_i * clear_i (boolean_scalar_dot_prod generalized):
        scalar multiplies are leveled; one compressor sum at the end."""
        if len(cts) != len(clears) or not cts:
            raise ValueError("scalar_dot_product needs as many clears as "
                             "ciphertexts, and at least one")
        terms = [
            self.scalar_mul(self._clean(c), int(w))
            for c, w in zip(cts, clears)
            if int(w) != 0
        ]
        if not terms:
            return self._trivial_radix(0, cts[0].num_blocks, cts[0])
        return self.sum_ciphertexts_parallelized(terms)

    # ==================================================================
    # oblivious pseudo-random generation — integer/oprf.rs
    # ==================================================================

    def generate_oblivious_pseudo_random(
        self, seed: int, num_blocks: int, random_bits_count: int = None
    ):
        """Encrypted uniform value in [0, 2^random_bits_count) the server
        cannot see (par_generate_oblivious_pseudo_random_unsigned_integer,
        integer/oprf.rs:31-105): per-block seeds derived from
        ``shake_256(b"tfhe-tpu-oprf" || seed || i)``, the seeded LWEs of
        the blocks under the bound through ONE batched PBS (each block's
        PBS is independent, so the blocks equal ``tfhe_tpu``'s per-block
        loop), trivial zero blocks above the bound."""
        from .radix import RadixCiphertext

        mm = self.key.params.message_modulus
        mbits = int(np.log2(mm))
        if random_bits_count is None:
            random_bits_count = mbits * num_blocks
        if random_bits_count > mbits * num_blocks:
            raise ValueError(f"{random_bits_count} random bits do not fit "
                             f"{num_blocks} blocks")
        seeds, bits = [], []
        for i in range(num_blocks):
            lo = i * mbits
            if lo >= random_bits_count:
                break
            seeds.append(int.from_bytes(hashlib.shake_256(
                b"tfhe-tpu-oprf" + seed.to_bytes(16, "little")
                + i.to_bytes(8, "little")).digest(8), "little"))
            bits.append(min(mbits, random_bits_count - lo))
        p = self.key.params
        dim = p.glwe_dimension * p.polynomial_size + 1
        blocks = torch.zeros((num_blocks, dim), dtype=torch.int64,
                             device=self.key.device)
        if seeds:
            blocks[:len(seeds)] = _oprf.oblivious_pseudo_random_batch(
                self.key, seeds, bits)
        degrees = [(1 << b) - 1 for b in bits] + [0] * (num_blocks
                                                        - len(bits))
        return RadixCiphertext(
            ct=blocks,
            degrees=np.array(degrees, dtype=np.int64),
            noise_levels=np.ones(num_blocks, dtype=np.int64),
            message_modulus=mm,
            carry_modulus=p.carry_modulus,
        )
