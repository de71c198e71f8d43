"""Radix big integers: vectors of shortint blocks, LSB-first.

Torch counterpart of ``tfhe_tpu/integer/radix.py`` (reference
``tfhe/src/integer/ciphertext/base.rs:23-35`` (RadixCiphertext),
``integer/server_key/radix_parallel/``). A radix ciphertext is ONE int64
tensor ``[..., num_blocks, dim+1]`` of torus values (see ``_torus.py``): the
block axis is just another batch axis, so every per-block PBS of an op is a
single batched bootstrap through the shortint ``apply_lookup_table`` (on a
GPU: keyswitch, then the K2 and step kernels of the key's variant).

Per-block degree/noise bookkeeping lives host-side as numpy arrays. Block
arithmetic wraps mod 2^64 in int64; a write into one block (the JAX
package's functional ``.at[...]``) always lands in a fresh tensor, never in
the caller's: ciphertexts share tensors through :meth:`RadixCiphertext.with_ct`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from .._torus import u64_const
from ..shortint.ciphertext import NOMINAL_NOISE, LookupTable, ShortintCiphertext
from ..shortint.client_key import ClientKey as ShortintClientKey
from ..shortint.server_key import ServerKey as ShortintServerKey
from ..utils.params import ClassicPBSParameters


def _added_to_body(ct: torch.Tensor, value: int, block=None) -> torch.Tensor:
    """A copy of ``ct`` with ``value`` (mod 2^64) added to the body of
    ``block`` (of every ciphertext of a [..., dim+1] tensor when None)."""
    out = ct.clone()
    if block is None:
        out[..., -1] += u64_const(value)
    else:
        out[..., block, -1] += u64_const(value)
    return out


@dataclass
class RadixCiphertext:
    ct: Any  # torch int64[..., nb, dim+1]
    degrees: np.ndarray  # int64[nb] — max attainable value per block
    noise_levels: np.ndarray  # int64[nb]
    message_modulus: int
    carry_modulus: int

    @property
    def num_blocks(self) -> int:
        return self.ct.shape[-2]

    @property
    def batch_shape(self):
        return tuple(self.ct.shape[:-2])

    def with_ct(self, ct, degrees=None, noise_levels=None) -> "RadixCiphertext":
        return replace(
            self,
            ct=ct,
            degrees=self.degrees if degrees is None else np.asarray(degrees),
            noise_levels=(
                self.noise_levels if noise_levels is None else np.asarray(noise_levels)
            ),
        )


@dataclass
class BooleanBlock:
    """An encrypted 0/1 value in a single shortint block (reference
    ``integer/ciphertext/boolean_value.rs``)."""

    ct: Any  # torch int64[..., dim+1]


class ClientKey:
    """Reference ``integer::ClientKey`` — wraps the shortint client key."""

    def __init__(self, shortint_key: ShortintClientKey):
        self.key = shortint_key

    @classmethod
    def generate(cls, params: ClassicPBSParameters, seed: int = 0,
                 device=None) -> "ClientKey":
        """Seeded keygen on ``device`` (the GPU when unset; raises without
        one)."""
        return cls(ShortintClientKey.generate(params, seed, device=device))

    @property
    def params(self) -> ClassicPBSParameters:
        return self.key.params

    def encrypt_radix(self, values, num_blocks: int) -> RadixCiphertext:
        """Encrypt clear integer(s) into ``num_blocks`` base-mm blocks."""
        mm = self.params.message_modulus
        vals = np.atleast_1d(np.asarray(values, dtype=np.uint64))
        shape = vals.shape
        blocks = np.zeros(shape + (num_blocks,), dtype=np.uint64)
        v = vals.copy()
        for b in range(num_blocks):
            blocks[..., b] = v % mm
            v //= mm
        ct = self.key.encrypt(blocks.reshape(-1))
        dim = ct.ct.shape[-1]
        arr = ct.ct.reshape(shape + (num_blocks, dim))
        if np.isscalar(values) or np.asarray(values).ndim == 0:
            arr = arr[0]
        return RadixCiphertext(
            ct=arr,
            degrees=np.full(num_blocks, mm - 1, dtype=np.int64),
            noise_levels=np.full(num_blocks, NOMINAL_NOISE, dtype=np.int64),
            message_modulus=mm,
            carry_modulus=self.params.carry_modulus,
        )

    def encrypt_signed_radix(self, values, num_blocks: int) -> RadixCiphertext:
        """Two's-complement encryption (reference SignedRadixCiphertext,
        integer/ciphertext/base.rs): value mod 2^(bits) as unsigned blocks."""
        bits = int(math.log2(self.params.message_modulus)) * num_blocks
        vals = np.atleast_1d(np.asarray(values, dtype=np.int64))
        wrapped = (vals.astype(np.int64) % (1 << bits)).astype(np.uint64)
        if np.isscalar(values) or np.asarray(values).ndim == 0:
            wrapped = wrapped[0]
        return self.encrypt_radix(wrapped, num_blocks)

    def decrypt_signed_radix(self, ct: RadixCiphertext) -> np.ndarray:
        bits = int(math.log2(ct.message_modulus)) * ct.num_blocks
        u = self.decrypt_radix(ct).astype(np.int64)
        sign = u >= (1 << (bits - 1))
        return np.where(sign, u - (1 << bits), u)

    def decrypt_radix(self, ct: RadixCiphertext) -> np.ndarray:
        mm = ct.message_modulus
        nb = ct.num_blocks
        sct = ShortintCiphertext(
            ct=ct.ct,
            degree=int(ct.degrees.max()),
            noise_level=int(ct.noise_levels.max()),
            message_modulus=mm,
            carry_modulus=ct.carry_modulus,
        )
        blocks = np.atleast_1d(self.key.decrypt(sct))  # [..., nb]
        blocks = blocks.reshape(ct.batch_shape + (nb,))
        out = np.zeros(ct.batch_shape, dtype=np.uint64)
        with np.errstate(over="ignore"):
            for b in reversed(range(nb)):
                out = out * np.uint64(mm) + blocks[..., b]
        total_bits = int(math.log2(mm)) * nb
        if total_bits < 64:
            out &= np.uint64((1 << total_bits) - 1)
        return out


from .ops_extra import RadixExtraOps  # noqa: E402


class ServerKey(RadixExtraOps):
    """Reference ``integer::ServerKey`` — radix ops over the shortint key.

    Every op keeps carries clean on output ("default" op semantics of the
    reference's *_parallelized ops). Ciphertexts stay on the shortint key's
    device; only decryption reads them back.
    """

    def __init__(self, shortint_key: ShortintServerKey):
        self.key = shortint_key

    @classmethod
    def generate(cls, client_key: ClientKey) -> "ServerKey":
        return cls(ShortintServerKey.generate(client_key.key))

    @property
    def params(self) -> ClassicPBSParameters:
        return self.key.params

    # -- helpers -------------------------------------------------------------
    def _shortint(self, ct: RadixCiphertext, degrees=None, noises=None):
        return ShortintCiphertext(
            ct=ct.ct,
            degree=int(np.max(degrees if degrees is not None else ct.degrees)),
            noise_level=int(np.max(noises if noises is not None else ct.noise_levels)),
            message_modulus=ct.message_modulus,
            carry_modulus=ct.carry_modulus,
            under_key="big",
        )

    def _max_clean(self, ct: RadixCiphertext) -> bool:
        return bool(np.all(ct.degrees < ct.message_modulus))

    @property
    def _prop_budget(self) -> int:
        """Max block degree that still absorbs a worst-case incoming carry
        (cm - 1) without overflowing the mm*cm plaintext space."""
        mm = self.params.message_modulus
        cm = self.params.carry_modulus
        return mm * cm - 1 - (cm - 1)

    # -- carry propagation -----------------------------------------------------
    def full_propagate(self, ct: RadixCiphertext) -> RadixCiphertext:
        """Sequential carry propagation: per block, absorb the incoming carry,
        then split into message and carry with two batched-over-batch PBS.
        """
        mm = self.params.message_modulus
        nb = ct.num_blocks
        msg_lut = self.key.generate_lookup_table(lambda x: x % mm)
        carry_lut = self.key.generate_lookup_table(lambda x: x // mm)

        cm = self.params.carry_modulus
        if not np.all(ct.degrees + (cm - 1) < mm * cm):
            raise ValueError(
                "block degree too large to absorb the incoming carry during "
                f"propagation (degrees {ct.degrees}, budget {self._prop_budget})")
        blocks = ct.ct
        carry = None
        out_blocks = []
        for b in range(nb):
            blk = blocks[..., b, :]
            if carry is not None:
                blk = blk + carry
            deg = int(ct.degrees[b]) + (0 if carry is None else cm - 1)
            s = ShortintCiphertext(
                ct=blk, degree=deg, noise_level=int(ct.noise_levels[b]) + 1,
                message_modulus=mm, carry_modulus=ct.carry_modulus,
            )
            if b < nb - 1:
                carry = self.key.apply_lookup_table(s, carry_lut).ct
            out_blocks.append(self.key.apply_lookup_table(s, msg_lut).ct)
        new = torch.stack(out_blocks, dim=-2)
        return ct.with_ct(
            new,
            degrees=np.full(nb, mm - 1, dtype=np.int64),
            noise_levels=np.full(nb, NOMINAL_NOISE, dtype=np.int64),
        )

    # -- linear ops -------------------------------------------------------------
    def unchecked_add(self, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
        return a.with_ct(
            a.ct + b.ct,
            degrees=a.degrees + b.degrees,
            noise_levels=a.noise_levels + b.noise_levels,
        )

    def add(self, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
        return self.add_parallelized(a, b)

    def unchecked_neg(self, a: RadixCiphertext) -> RadixCiphertext:
        """Per-block negation with degree-correction multiples of mm, plus
        borrow-style correction terms on higher blocks
        (integer/server_key/radix/neg.rs semantics)."""
        mm = self.params.message_modulus
        delta = self.key.encoding.delta()
        nb = a.num_blocks
        ct = -a.ct  # a fresh tensor: the writes below stay in it
        degrees = np.zeros(nb, dtype=np.int64)
        carry_in = 0  # the z-correction propagated from the previous block
        for b in range(nb):
            z = int(math.ceil((int(a.degrees[b]) + 1) / mm)) * mm
            corr = (z - carry_in) % (1 << 64)
            ct[..., b, -1] += u64_const(corr * delta)
            degrees[b] = z - carry_in
            carry_in = z // mm
        return a.with_ct(ct, degrees=degrees, noise_levels=a.noise_levels)

    def neg(self, a: RadixCiphertext) -> RadixCiphertext:
        return self.full_propagate(self.unchecked_neg(a))

    def sub(self, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
        return self.sub_parallelized(a, b)

    def scalar_add(self, a: RadixCiphertext, scalar: int) -> RadixCiphertext:
        mm = self.params.message_modulus
        delta = self.key.encoding.delta()
        nb = a.num_blocks
        ct = a.ct.clone()
        degrees = a.degrees.copy()
        s = int(scalar)
        for b in range(nb):
            digit = s % mm
            s //= mm
            if digit:
                ct[..., b, -1] += u64_const(digit * delta)
                degrees[b] += digit
        out = a.with_ct(ct, degrees=degrees)
        return self.full_propagate(out)

    # -- bitwise ops (one batched bivariate PBS) -------------------------------
    def _bitwise(self, a, b, f) -> RadixCiphertext:
        mm = self.params.message_modulus
        a = self.full_propagate(a) if not self._max_clean(a) else a
        b = self.full_propagate(b) if not self._max_clean(b) else b
        factor = mm
        packed = a.ct * factor + b.ct
        s = self._shortint(
            a.with_ct(packed, degrees=a.degrees * factor + b.degrees,
                      noise_levels=a.noise_levels * factor + b.noise_levels)
        )
        lut = self.key.generate_lookup_table(lambda x: f((x // factor) % mm, x % factor))
        out = self.key.apply_lookup_table(s, lut)
        nb = a.num_blocks
        return a.with_ct(
            out.ct,
            degrees=np.full(nb, mm - 1, dtype=np.int64),
            noise_levels=np.full(nb, NOMINAL_NOISE, dtype=np.int64),
        )

    def bitand(self, a, b):
        return self._bitwise(a, b, lambda x, y: x & y)

    def bitor(self, a, b):
        return self._bitwise(a, b, lambda x, y: x | y)

    def bitxor(self, a, b):
        return self._bitwise(a, b, lambda x, y: x ^ y)

    # -- multiplication ---------------------------------------------------------
    def mul(self, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
        """Partial-product matrix (2 batched PBS) + log-depth compressor sum
        (reference mul.rs:455-640); see ops_extra.mul_parallelized."""
        return self.mul_parallelized(a, b)

    def mul_sequential(self, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
        """Sequential schoolbook product (kept as an oracle for the parallel
        path)."""
        mm = self.params.message_modulus
        nb = a.num_blocks
        a = self.full_propagate(a) if not self._max_clean(a) else a
        b = self.full_propagate(b) if not self._max_clean(b) else b

        result = None
        for j in range(nb):
            # partial product of a with block j of b, shifted j blocks:
            # low parts: (a_i * b_j) % mm ; high parts: (a_i * b_j) // mm
            bj = b.ct[..., j : j + 1, :]  # [..., 1, dim]
            packed = a.ct * mm + torch.broadcast_to(bj, a.ct.shape)
            s = self._shortint(
                a.with_ct(packed,
                          degrees=a.degrees * mm + (mm - 1),
                          noise_levels=a.noise_levels * mm + 1)
            )
            low_lut = self.key.generate_lookup_table(
                lambda x: (((x // mm) % mm) * (x % mm)) % mm
            )
            high_lut = self.key.generate_lookup_table(
                lambda x: (((x // mm) % mm) * (x % mm)) // mm
            )
            low = self.key.apply_lookup_table(s, low_lut).ct
            high = self.key.apply_lookup_table(s, high_lut).ct

            zeros_like_block = torch.zeros_like(a.ct[..., :1, :])

            # shift low by j blocks, high by j+1 blocks, truncate to nb
            def shifted(x, by):
                cat = torch.cat([zeros_like_block] * by + [x], dim=-2)
                return cat[..., :nb, :]

            pp = shifted(low, j)
            pp_deg = np.zeros(nb, dtype=np.int64)
            pp_deg[j:] = mm - 1
            term = RadixCiphertext(
                ct=pp, degrees=pp_deg,
                noise_levels=np.full(nb, NOMINAL_NOISE, dtype=np.int64),
                message_modulus=mm, carry_modulus=a.carry_modulus,
            )
            if j + 1 < nb:
                pp2 = shifted(high, j + 1)
                pp2_deg = np.zeros(nb, dtype=np.int64)
                pp2_deg[j + 1 :] = mm - 1
                term = self.unchecked_add(
                    term,
                    RadixCiphertext(
                        ct=pp2, degrees=pp2_deg,
                        noise_levels=np.full(nb, NOMINAL_NOISE, dtype=np.int64),
                        message_modulus=mm, carry_modulus=a.carry_modulus,
                    ),
                )
            result = term if result is None else self.unchecked_add(result, term)
            # keep the degree under the propagation budget (room for the
            # incoming carry) and the noise under max
            if np.any(result.degrees + 2 * (mm - 1) > self._prop_budget) or np.any(
                result.noise_levels + 2 >= self.params.max_noise_level
            ):
                result = self.full_propagate(result)
        return self.full_propagate(result)

    # -- comparisons -------------------------------------------------------------
    def eq(self, a: RadixCiphertext, b: RadixCiphertext) -> BooleanBlock:
        """Blockwise equality then an AND-reduction tree
        (reference comparison.rs)."""
        diff_is_zero = self._bitwise(a, b, lambda x, y: 1 if x == y else 0)
        # AND-reduce the per-block bits: sum then compare to nb (bits fit the
        # carry space in chunks)
        return self._reduce_all_ones(diff_is_zero)

    def ne(self, a: RadixCiphertext, b: RadixCiphertext) -> BooleanBlock:
        blk = self.eq(a, b)
        # 1 - bit: negate then add 1
        mm = self.params.message_modulus
        delta = self.key.encoding.delta()
        ct = _added_to_body(-blk.ct, delta)
        s = ShortintCiphertext(ct=ct, degree=1, noise_level=2,
                               message_modulus=mm, carry_modulus=self.params.carry_modulus)
        lut = self.key.generate_lookup_table(lambda x: x % 2)
        return BooleanBlock(ct=self.key.apply_lookup_table(s, lut).ct)

    def _reduce_all_ones(self, bits: RadixCiphertext) -> BooleanBlock:
        """bits: radix ct whose blocks are 0/1; returns enc(1) iff all are 1."""
        mm = self.params.message_modulus
        cm = self.params.carry_modulus
        max_sum = mm * cm - 1
        # tree-reduce by summing chunks of size <= max_sum then LUT x == chunk
        cur = bits.ct  # [..., nb, dim]
        counts = np.ones(cur.shape[-2], dtype=np.int64)  # how many 1s each slot needs
        while cur.shape[-2] > 1:
            # sum up to `take` blocks whose degree sum <= max_sum
            take = 1
            tot = counts[0]
            while take < cur.shape[-2] and tot + counts[take] <= max_sum:
                tot += counts[take]
                take += 1
            summed = cur[..., :take, :].sum(dim=-2)
            need = int(np.sum(counts[:take]))
            s = ShortintCiphertext(ct=summed, degree=need, noise_level=take,
                                   message_modulus=mm, carry_modulus=cm)
            lut = self.key.generate_lookup_table(lambda x, need=need: 1 if x == need else 0)
            bit = self.key.apply_lookup_table(s, lut).ct
            rest = cur[..., take:, :]
            cur = torch.cat([bit[..., None, :], rest], dim=-2)
            counts = np.concatenate([[1], counts[take:]])
        return BooleanBlock(ct=cur[..., 0, :])

    def _reduce_at_least_one(self, bit_blocks) -> BooleanBlock:
        """OR-reduce a list of BooleanBlocks: enc(1) iff any bit is 1
        (reference is_at_least_one_comparisons_block_true)."""
        mm = self.params.message_modulus
        cm = self.params.carry_modulus
        max_sum = mm * cm - 1
        cur = torch.stack([b.ct for b in bit_blocks], dim=-2)  # [..., W, dim]
        while cur.shape[-2] > 1:
            take = min(cur.shape[-2], max_sum)
            summed = cur[..., :take, :].sum(dim=-2)
            s = ShortintCiphertext(ct=summed, degree=take, noise_level=take,
                                   message_modulus=mm, carry_modulus=cm)
            lut = self.key.generate_lookup_table(lambda x: 1 if x > 0 else 0)
            bit = self.key.apply_lookup_table(s, lut).ct
            cur = torch.cat([bit[..., None, :], cur[..., take:, :]], dim=-2)
        return BooleanBlock(ct=cur[..., 0, :])

    def _trivial_bool(self, value: bool, like: RadixCiphertext) -> BooleanBlock:
        """Trivial (noiseless, keyless) boolean block — what the reference's
        create_trivial_boolean_block returns for degenerate slice shapes."""
        ct = torch.zeros_like(like.ct[..., 0, :])
        if value:
            ct[..., -1] = u64_const(self.key.encoding.delta())
        return BooleanBlock(ct=ct)

    # ======================================================================
    # vector-slice comparisons
    # (reference integer/server_key/radix_parallel/vector_comparisons.rs)
    # ======================================================================

    def all_eq_slices(self, lhs, rhs) -> BooleanBlock:
        """enc(true) iff the two slices of radix ciphertexts are equal
        pairwise (vector_comparisons.rs:12 all_eq_slices_parallelized).

        Mismatched slice lengths or block counts return trivial false. All
        pairs' blockwise equality bits are computed in ONE batched
        bivariate-LUT pass (the blocks of every pair concatenated on the
        block axis) and AND-reduced together."""
        if len(lhs) != len(rhs) or not lhs:
            ref = (lhs or rhs)[0]
            return self._trivial_bool(False, ref)
        if any(a.num_blocks != b.num_blocks for a, b in zip(lhs, rhs)):
            return self._trivial_bool(False, lhs[0])

        def cat(xs):
            return xs[0].with_ct(
                torch.cat([x.ct for x in xs], dim=-2),
                degrees=np.concatenate([x.degrees for x in xs]),
                noise_levels=np.concatenate([x.noise_levels for x in xs]),
            )

        a, b = cat(list(lhs)), cat(list(rhs))
        bits = self._bitwise(a, b, lambda x, y: 1 if x == y else 0)
        return self._reduce_all_ones(bits)

    def contains_sub_slice(self, lhs, rhs) -> BooleanBlock:
        """enc(true) iff some window of ``lhs`` equals ``rhs``
        (vector_comparisons.rs:110 contains_sub_slice_parallelized):
        all_eq over every window of len(rhs), then an OR-reduction."""
        if len(rhs) > len(lhs):
            return self._trivial_bool(False, lhs[0] if lhs else rhs[0])
        windows = [self.all_eq_slices(lhs[i:i + len(rhs)], rhs)
                   for i in range(len(lhs) - len(rhs) + 1)]
        if len(windows) == 1:
            return windows[0]
        return self._reduce_at_least_one(windows)

    # ======================================================================
    # parallel carry propagation (Hillis–Steele prefix scan over carry
    # states) — reference integer/server_key/radix_parallel/add.rs:828-1260
    # ======================================================================
    #
    # For the sum of two carry-clean operands every block value is
    # <= 2(mm-1), so the carry into the next block is 0 or 1 and each block
    # has a state in {NONE=0, PROPAGATE=1, GENERATE=2}. The prefix scan
    # resolves all carries in ceil(log2(nb)) batched PBS rounds with the
    # operator  x (.) y = x if x != P else y  (x = more significant).

    def _trivial_zero_blocks(self, like: RadixCiphertext, count: int):
        shape = tuple(like.ct.shape[:-2]) + (count, like.ct.shape[-1])
        return torch.zeros(shape, dtype=torch.int64, device=like.ct.device)

    def _shift_blocks_right(self, blocks, d: int):
        """blocks[..., i-d, :] at position i; trivial zeros shifted in."""
        if d == 0:
            return blocks
        nb = blocks.shape[-2]
        zeros = torch.zeros_like(blocks[..., :d, :])
        return torch.cat([zeros, blocks[..., : nb - d, :]], dim=-2)

    def _shift_blocks_left(self, blocks, d: int):
        if d == 0:
            return blocks
        zeros = torch.zeros_like(blocks[..., :d, :])
        return torch.cat([blocks[..., d:, :], zeros], dim=-2)

    def _lut(self, f, degree=None):
        lut = self.key.generate_lookup_table(f)
        if degree is not None:
            lut = LookupTable(acc=lut.acc, degree=degree)
        return lut

    def _pbs_blocks(self, blocks, degree_in: int, noise_in: int, lut: LookupTable):
        """Batched PBS over raw block tensor [..., nb, dim]."""
        s = ShortintCiphertext(
            ct=blocks, degree=degree_in, noise_level=noise_in,
            message_modulus=self.params.message_modulus,
            carry_modulus=self.params.carry_modulus,
        )
        return self.key.apply_lookup_table(s, lut).ct

    def _resolve_carries(self, s_blocks, max_block_value: int, noise_in: int):
        """Returns (carry_bits [..., nb, dim], carry_out_state_blocks) for a
        block tensor whose values are <= max_block_value <= 2*mm-1 (binary
        carries). carry_bits[i] is the carry INTO block i (0 for block 0)."""
        mm = self.params.message_modulus
        assert max_block_value <= 2 * mm - 1
        nb = s_blocks.shape[-2]
        state_lut = self._lut(
            lambda x: 2 if x >= mm else (1 if x == mm - 1 else 0), degree=2
        )
        state = self._pbs_blocks(s_blocks, max_block_value, noise_in, state_lut)
        combine_lut = self._lut(
            lambda p: (p // 4) if (p // 4) != 1 else (p % 4), degree=2
        )
        d = 1
        while d < nb:
            shifted = self._shift_blocks_right(state, d)
            packed = state * 4 + shifted
            state = self._pbs_blocks(packed, 10, 5, combine_lut)
            d *= 2
        # carry into block i = (prefix_state[i-1] == GENERATE)
        carry_state_out = state[..., nb - 1, :]
        prev = self._shift_blocks_right(state, 1)
        carry_lut = self._lut(lambda x: 1 if x == 2 else 0, degree=1)
        carry_bits = self._pbs_blocks(prev, 2, 1, carry_lut)
        return carry_bits, carry_state_out

    def _clean(self, ct: RadixCiphertext) -> RadixCiphertext:
        return ct if self._max_clean(ct) else self.full_propagate(ct)

    def add_parallelized(
        self, a: RadixCiphertext, b: RadixCiphertext, compute_overflow: bool = False
    ):
        """Carry-clean add in 3 + ceil(log2(nb)) batched PBS rounds."""
        mm = self.params.message_modulus
        a, b = self._clean(a), self._clean(b)
        nb = a.num_blocks
        s = a.ct + b.ct
        noise_s = int(np.max(a.noise_levels + b.noise_levels))
        carry_bits, carry_out_state = self._resolve_carries(s, 2 * mm - 2, noise_s)
        total = s + carry_bits
        msg_lut = self._lut(lambda x: x % mm, degree=mm - 1)
        out = self._pbs_blocks(total, 2 * mm - 1, noise_s + 1, msg_lut)
        res = a.with_ct(
            out,
            degrees=np.full(nb, mm - 1, dtype=np.int64),
            noise_levels=np.full(nb, NOMINAL_NOISE, dtype=np.int64),
        )
        if not compute_overflow:
            return res
        ov_lut = self._lut(lambda x: 1 if x == 2 else 0, degree=1)
        ov = self._pbs_blocks(carry_out_state[..., None, :], 2, 1, ov_lut)
        return res, BooleanBlock(ct=ov[..., 0, :])

    def bitnot(self, a: RadixCiphertext) -> RadixCiphertext:
        """NOT x = (mm-1) - x per block — purely linear, zero PBS."""
        a = self._clean(a)
        mm = self.params.message_modulus
        delta = self.key.encoding.delta()
        ct = _added_to_body(-a.ct, (mm - 1) * delta)
        return a.with_ct(ct, degrees=np.full(a.num_blocks, mm - 1, dtype=np.int64))

    def sub_parallelized(
        self, a: RadixCiphertext, b: RadixCiphertext, compute_overflow: bool = False
    ):
        """a - b = a + ~b + 1 (carry injection on block 0); borrow = !carry.

        Reference: radix_parallel/sub.rs (advanced_sub_assign_with_borrow).
        """
        mm = self.params.message_modulus
        a, b = self._clean(a), self._clean(b)
        nb = a.num_blocks
        nb_ct = self.bitnot(b)
        delta = self.key.encoding.delta()
        s = _added_to_body(a.ct + nb_ct.ct, delta, block=0)  # the +1 carry-in
        noise_s = int(np.max(a.noise_levels + b.noise_levels))
        carry_bits, carry_out_state = self._resolve_carries(s, 2 * mm - 1, noise_s)
        total = s + carry_bits
        msg_lut = self._lut(lambda x: x % mm, degree=mm - 1)
        out = self._pbs_blocks(total, 2 * mm, noise_s + 1, msg_lut)
        res = a.with_ct(
            out,
            degrees=np.full(nb, mm - 1, dtype=np.int64),
            noise_levels=np.full(nb, NOMINAL_NOISE, dtype=np.int64),
        )
        if not compute_overflow:
            return res
        # borrow (unsigned underflow) = NOT carry_out = state != GENERATE
        bw_lut = self._lut(lambda x: 0 if x == 2 else 1, degree=1)
        bw = self._pbs_blocks(carry_out_state[..., None, :], 2, 1, bw_lut)
        return res, BooleanBlock(ct=bw[..., 0, :])

    # ======================================================================
    # comparisons — reference radix_parallel/comparison.rs
    # ======================================================================

    def _block_compare_signs(self, a: RadixCiphertext, b: RadixCiphertext):
        """Per-block sign in {0: eq, 1: lt, 2: gt} then MSB-first tree
        reduction: combine(hi, lo) = hi if hi != 0 else lo."""
        mm = self.params.message_modulus
        a, b = self._clean(a), self._clean(b)
        packed = a.ct * mm + b.ct
        noise = int(np.max(a.noise_levels * mm + b.noise_levels))
        sign_lut = self._lut(
            lambda x: 0 if (x // mm) % mm == x % mm else (1 if (x // mm) % mm < x % mm else 2),
            degree=2,
        )
        signs = self._pbs_blocks(packed, mm * mm - 1, noise, sign_lut)
        return self._reduce_signs(signs)

    def _reduce_signs(self, signs):
        """Tree-reduce per-block signs (MSB wins unless eq)."""
        comb_lut = self._lut(
            lambda p: (p // 4) if (p // 4) != 0 else (p % 4), degree=2
        )
        while signs.shape[-2] > 1:
            nbb = signs.shape[-2]
            half = nbb // 2
            lo = signs[..., 0 : 2 * half : 2, :]
            hi = signs[..., 1 : 2 * half : 2, :]
            packed = hi * 4 + lo
            merged = self._pbs_blocks(packed, 10, 5, comb_lut)
            if nbb % 2:
                merged = torch.cat([merged, signs[..., nbb - 1 :, :]], dim=-2)
            signs = merged
        return signs[..., 0, :]  # [..., dim], value in {0,1,2}

    def _sign_to_bool(self, sign, f) -> BooleanBlock:
        lut = self._lut(lambda x: 1 if f(x) else 0, degree=1)
        out = self._pbs_blocks(sign[..., None, :], 2, 1, lut)
        return BooleanBlock(ct=out[..., 0, :])

    def lt(self, a, b) -> BooleanBlock:
        return self._sign_to_bool(self._block_compare_signs(a, b), lambda s: s == 1)

    def le(self, a, b) -> BooleanBlock:
        return self._sign_to_bool(self._block_compare_signs(a, b), lambda s: s != 2)

    def gt(self, a, b) -> BooleanBlock:
        return self._sign_to_bool(self._block_compare_signs(a, b), lambda s: s == 2)

    def ge(self, a, b) -> BooleanBlock:
        return self._sign_to_bool(self._block_compare_signs(a, b), lambda s: s != 1)

    def min(self, a, b) -> RadixCiphertext:
        a, b = self._clean(a), self._clean(b)
        return self.if_then_else(self.lt(a, b), a, b)

    def max(self, a, b) -> RadixCiphertext:
        a, b = self._clean(a), self._clean(b)
        return self.if_then_else(self.gt(a, b), a, b)

    # ======================================================================
    # cmux / if_then_else — reference radix_parallel/cmux.rs
    # ======================================================================

    def if_then_else(
        self, cond: BooleanBlock, t: RadixCiphertext, e: RadixCiphertext
    ) -> RadixCiphertext:
        """out_i = cond ? t_i : e_i via two zero_if_not LUTs + linear add."""
        mm = self.params.message_modulus
        t, e = self._clean(t), self._clean(e)
        nb = t.num_blocks
        c = torch.broadcast_to(cond.ct[..., None, :], t.ct.shape)
        pt = t.ct * 2 + c
        pe = e.ct * 2 + c
        keep_lut = self._lut(
            lambda x: (x // 2) if x % 2 == 1 else 0, degree=mm - 1
        )
        drop_lut = self._lut(
            lambda x: (x // 2) if x % 2 == 0 else 0, degree=mm - 1
        )
        noise = int(np.max(t.noise_levels)) * 2 + 1
        t_sel = self._pbs_blocks(pt, 2 * mm - 1, noise, keep_lut)
        e_sel = self._pbs_blocks(pe, 2 * mm - 1, noise, drop_lut)
        out = t_sel + e_sel  # exactly one side is nonzero per block
        return t.with_ct(
            out,
            degrees=np.full(nb, mm - 1, dtype=np.int64),
            noise_levels=np.full(nb, 2 * NOMINAL_NOISE, dtype=np.int64),
        )

    def cmux(self, cond, t, e):
        return self.if_then_else(cond, t, e)

    def boolean_bitand(self, a: BooleanBlock, b: BooleanBlock) -> BooleanBlock:
        packed = a.ct * 2 + b.ct
        lut = self._lut(lambda x: 1 if x == 3 else 0, degree=1)
        out = self._pbs_blocks(packed[..., None, :], 3, 3, lut)
        return BooleanBlock(ct=out[..., 0, :])

    def boolean_bitor(self, a: BooleanBlock, b: BooleanBlock) -> BooleanBlock:
        packed = a.ct * 2 + b.ct
        lut = self._lut(lambda x: 1 if x > 0 else 0, degree=1)
        out = self._pbs_blocks(packed[..., None, :], 3, 3, lut)
        return BooleanBlock(ct=out[..., 0, :])

    def boolean_bitnot(self, a: BooleanBlock) -> BooleanBlock:
        delta = self.key.encoding.delta()
        ct = _added_to_body(-a.ct, delta)
        lut = self._lut(lambda x: x % 2, degree=1)
        out = self._pbs_blocks(ct[..., None, :], 1, 2, lut)
        return BooleanBlock(ct=out[..., 0, :])

    # ======================================================================
    # shifts / rotates — clear amount (scalar_shift.rs) and encrypted
    # amount (shift.rs: barrel shifter over cmux rounds)
    # ======================================================================

    def _bits_per_block(self) -> int:
        return int(math.log2(self.params.message_modulus))

    def scalar_right_shift(self, a: RadixCiphertext, shift: int) -> RadixCiphertext:
        """Logical >> by a clear amount: one batched bivariate-packed PBS."""
        mm = self.params.message_modulus
        bits = self._bits_per_block()
        a = self._clean(a)
        nb = a.num_blocks
        shift %= nb * bits
        q, r = divmod(shift, bits)
        cur = self._shift_blocks_left(a.ct, q)  # value >>= q blocks
        if r == 0:
            degs = np.concatenate(
                [a.degrees[q:], np.zeros(q, dtype=np.int64)]
            )
            return a.with_ct(cur, degrees=degs)
        nxt = self._shift_blocks_left(cur, 1)
        packed = nxt * mm + cur
        noise = int(np.max(a.noise_levels)) * (mm + 1)
        lut = self._lut(
            lambda x: ((x // mm) % mm * mm + x % mm) >> r & (mm - 1),
            degree=mm - 1,
        )
        out = self._pbs_blocks(packed, mm * mm - 1, noise, lut)
        return a.with_ct(
            out,
            degrees=np.full(nb, mm - 1, dtype=np.int64),
            noise_levels=np.full(nb, NOMINAL_NOISE, dtype=np.int64),
        )

    def scalar_left_shift(self, a: RadixCiphertext, shift: int) -> RadixCiphertext:
        mm = self.params.message_modulus
        bits = self._bits_per_block()
        a = self._clean(a)
        nb = a.num_blocks
        shift %= nb * bits
        q, r = divmod(shift, bits)
        cur = self._shift_blocks_right(a.ct, q)
        if r == 0:
            degs = np.concatenate([np.zeros(q, dtype=np.int64), a.degrees[: nb - q]])
            return a.with_ct(cur, degrees=degs)
        prev = self._shift_blocks_right(cur, 1)
        packed = cur * mm + prev
        noise = int(np.max(a.noise_levels)) * (mm + 1)
        lut = self._lut(
            lambda x: (((x // mm) % mm * mm + x % mm) << r >> bits) & (mm - 1),
            degree=mm - 1,
        )
        out = self._pbs_blocks(packed, mm * mm - 1, noise, lut)
        return a.with_ct(
            out,
            degrees=np.full(nb, mm - 1, dtype=np.int64),
            noise_levels=np.full(nb, NOMINAL_NOISE, dtype=np.int64),
        )

    def scalar_rotate_right(self, a: RadixCiphertext, rot: int) -> RadixCiphertext:
        bits = self._bits_per_block()
        a = self._clean(a)
        nb = a.num_blocks
        total = nb * bits
        rot %= total
        if rot == 0:
            return a
        lo = self.scalar_right_shift(a, rot)
        hi = self.scalar_left_shift(a, total - rot)
        return self.bitor(lo, hi)

    def scalar_rotate_left(self, a: RadixCiphertext, rot: int) -> RadixCiphertext:
        bits = self._bits_per_block()
        total = a.num_blocks * bits
        return self.scalar_rotate_right(a, (total - rot % total) % total)

    def right_shift(self, a: RadixCiphertext, amount: RadixCiphertext) -> RadixCiphertext:
        """>> by an ENCRYPTED amount: barrel shifter — one cmux round per bit
        of the amount (reference shift.rs)."""
        return self._barrel_shift(a, amount, self.scalar_right_shift)

    def left_shift(self, a: RadixCiphertext, amount: RadixCiphertext) -> RadixCiphertext:
        return self._barrel_shift(a, amount, self.scalar_left_shift)

    def _barrel_shift(self, a, amount, scalar_shift_fn):
        bits = self._bits_per_block()
        a = self._clean(a)
        amount = self._clean(amount)
        total_bits = a.num_blocks * bits
        n_amount_bits = max(1, (total_bits - 1).bit_length())
        cur = a
        for k in range(n_amount_bits):
            blk_idx, bit_idx = divmod(k, bits)
            if blk_idx >= amount.num_blocks:
                break
            bit_lut = self._lut(
                lambda x, b=bit_idx: (x >> b) & 1, degree=1
            )
            bit = self._pbs_blocks(
                amount.ct[..., blk_idx : blk_idx + 1, :],
                int(amount.degrees[blk_idx]),
                int(amount.noise_levels[blk_idx]),
                bit_lut,
            )
            cond = BooleanBlock(ct=bit[..., 0, :])
            shifted = scalar_shift_fn(cur, 1 << k)
            cur = self.if_then_else(cond, shifted, cur)
        return cur

    # ======================================================================
    # scalar ops — scalar_{sub,mul,comparison,bitwise}.rs
    # ======================================================================

    def _scalar_blocks(self, scalar: int, nb: int) -> list[int]:
        mm = self.params.message_modulus
        out = []
        s = int(scalar)
        for _ in range(nb):
            out.append(s % mm)
            s //= mm
        return out

    def scalar_sub(self, a: RadixCiphertext, scalar: int) -> RadixCiphertext:
        bits = self._bits_per_block()
        total = a.num_blocks * bits
        return self.scalar_add(a, ((1 << total) - scalar) % (1 << total))

    def scalar_mul(self, a: RadixCiphertext, scalar: int) -> RadixCiphertext:
        """Shifted-add over the base-mm digits of the scalar
        (scalar_mul.rs blockshift-and-add)."""
        mm = self.params.message_modulus
        a = self._clean(a)
        nb = a.num_blocks
        if scalar == 0:
            z = self._trivial_zero_blocks(a, nb)
            return a.with_ct(
                z, degrees=np.zeros(nb, dtype=np.int64),
                noise_levels=np.zeros(nb, dtype=np.int64),
            )
        terms = []
        for j, digit in enumerate(self._scalar_blocks(scalar, nb)):
            if digit == 0:
                continue
            low_lut = self._lut(lambda x, d=digit: (x % mm) * d % mm, degree=mm - 1)
            high_lut = self._lut(lambda x, d=digit: (x % mm) * d // mm, degree=mm - 1)
            noise = int(np.max(a.noise_levels))
            low = self._pbs_blocks(a.ct, mm - 1, noise, low_lut)
            high = self._pbs_blocks(a.ct, mm - 1, noise, high_lut)
            lo_ct = a.with_ct(
                self._shift_blocks_right(low, j),
                degrees=np.array([0] * j + [mm - 1] * (nb - j), dtype=np.int64),
                noise_levels=np.full(nb, NOMINAL_NOISE, dtype=np.int64),
            )
            terms.append(lo_ct)
            if j + 1 < nb:
                hi_ct = a.with_ct(
                    self._shift_blocks_right(high, j + 1),
                    degrees=np.array(
                        [0] * (j + 1) + [mm - 1] * (nb - j - 1), dtype=np.int64
                    ),
                    noise_levels=np.full(nb, NOMINAL_NOISE, dtype=np.int64),
                )
                terms.append(hi_ct)
        return self.sum_ciphertexts(terms)

    def scalar_eq(self, a: RadixCiphertext, scalar: int) -> BooleanBlock:
        return self._scalar_compare(a, scalar, lambda s: s == 0)

    def scalar_ne(self, a: RadixCiphertext, scalar: int) -> BooleanBlock:
        return self._scalar_compare(a, scalar, lambda s: s != 0)

    def scalar_lt(self, a, scalar) -> BooleanBlock:
        return self._scalar_compare(a, scalar, lambda s: s == 1)

    def scalar_le(self, a, scalar) -> BooleanBlock:
        return self._scalar_compare(a, scalar, lambda s: s != 2)

    def scalar_gt(self, a, scalar) -> BooleanBlock:
        return self._scalar_compare(a, scalar, lambda s: s == 2)

    def scalar_ge(self, a, scalar) -> BooleanBlock:
        return self._scalar_compare(a, scalar, lambda s: s != 1)

    def _scalar_compare(self, a: RadixCiphertext, scalar: int, f) -> BooleanBlock:
        """Per-block sign vs the scalar's digits (a different LUT per block,
        ONE batched PBS via stacked accumulators), then sign reduction."""
        mm = self.params.message_modulus
        a = self._clean(a)
        nb = a.num_blocks
        digits = self._scalar_blocks(scalar, nb)
        if int(scalar) >= mm ** nb:
            # scalar exceeds the type: lt always true (a PBS of a trivial
            # zero through the constant LUT f(lt))
            lut = self._lut(lambda x: 1 if f(1) else 0, degree=1)
            out = self._pbs_blocks(a.ct[..., :1, :] * 0, 0, 0, lut)
            return BooleanBlock(ct=out[..., 0, :])
        accs = []
        for b in range(nb):
            d = digits[b]
            lut = self.key.generate_lookup_table(
                lambda x, d=d: 0 if x == d else (1 if x < d else 2)
            )
            accs.append(lut.acc)
        stacked = torch.stack(accs, dim=0)  # [nb, R, N]
        lut = LookupTable(acc=stacked, degree=2)
        noise = int(np.max(a.noise_levels))
        signs = self._pbs_blocks(a.ct, mm - 1, noise, lut)
        sign = self._reduce_signs(signs)
        return self._sign_to_bool(sign, f)

    def scalar_bitand(self, a, scalar):
        return self._scalar_bitwise(a, scalar, lambda x, y: x & y)

    def scalar_bitor(self, a, scalar):
        return self._scalar_bitwise(a, scalar, lambda x, y: x | y)

    def scalar_bitxor(self, a, scalar):
        return self._scalar_bitwise(a, scalar, lambda x, y: x ^ y)

    def _scalar_bitwise(self, a: RadixCiphertext, scalar: int, f):
        mm = self.params.message_modulus
        a = self._clean(a)
        nb = a.num_blocks
        digits = self._scalar_blocks(scalar, nb)
        accs = []
        for b in range(nb):
            d = digits[b]
            accs.append(
                self.key.generate_lookup_table(lambda x, d=d: f(x % mm, d)).acc
            )
        lut = LookupTable(acc=torch.stack(accs, dim=0), degree=mm - 1)
        noise = int(np.max(a.noise_levels))
        out = self._pbs_blocks(a.ct, mm - 1, noise, lut)
        return a.with_ct(
            out,
            degrees=np.full(nb, mm - 1, dtype=np.int64),
            noise_levels=np.full(nb, NOMINAL_NOISE, dtype=np.int64),
        )

    # ======================================================================
    # multi-operand sum — radix_parallel/sum.rs
    # ======================================================================

    def sum_ciphertexts(self, cts: list) -> RadixCiphertext:
        """Sum many radix ciphertexts via the log-depth carry-save
        compressor (radix_parallel/sum.rs)."""
        if not cts:
            raise ValueError("empty sum")
        if len(cts) == 1:
            return self._clean(cts[0])
        return self.sum_ciphertexts_parallelized(cts)

    # ======================================================================
    # division — radix_parallel/div_mod.rs (restoring long division)
    # ======================================================================

    def div_rem(self, num: RadixCiphertext, den: RadixCiphertext):
        """Restoring bit-serial long division. total_bits iterations of
        [shift, compare, conditional subtract] (reference div_mod.rs)."""
        mm = self.params.message_modulus
        bits = self._bits_per_block()
        num, den = self._clean(num), self._clean(den)
        nb = num.num_blocks
        total_bits = nb * bits

        rem = self._trivial_radix(0, nb, like=num)
        quo_bits = []
        for i in range(total_bits - 1, -1, -1):
            # rem = (rem << 1) | bit_i(num)
            rem = self.scalar_left_shift(rem, 1)
            # bit 0 of block 0 was vacated by the shift: value is even, so
            # adding the numerator bit keeps the block carry-clean
            rem = rem.with_ct(
                rem.ct,
                degrees=np.concatenate(
                    [[min(int(rem.degrees[0]), mm - 2)], rem.degrees[1:]]
                ),
            )
            blk, bit = divmod(i, bits)
            bit_lut = self._lut(lambda x, b=bit: (x >> b) & 1, degree=1)
            num_bit = self._pbs_blocks(
                num.ct[..., blk : blk + 1, :],
                int(num.degrees[blk]), int(num.noise_levels[blk]), bit_lut,
            )
            rem_ct = rem.ct.clone()
            rem_ct[..., 0, :] += num_bit[..., 0, :]
            rem = rem.with_ct(
                rem_ct,
                degrees=np.concatenate([[rem.degrees[0] + 1], rem.degrees[1:]]),
                noise_levels=np.concatenate(
                    [[rem.noise_levels[0] + 1], rem.noise_levels[1:]]
                ),
            )
            ge = self.ge(rem, den)
            sub = self.sub_parallelized(rem, den)
            rem = self.if_then_else(ge, sub, rem)
            quo_bits.append((i, ge))
        terms = []
        for i, bitblk in quo_bits:
            blk, bit = divmod(i, bits)
            ct = self._trivial_zero_blocks(num, nb)
            ct[..., blk, :] = bitblk.ct * (1 << bit)
            degs = np.zeros(nb, dtype=np.int64)
            degs[blk] = 1 << bit
            noises = np.zeros(nb, dtype=np.int64)
            noises[blk] = NOMINAL_NOISE * (1 << bit)
            terms.append(
                RadixCiphertext(
                    ct=ct, degrees=degs, noise_levels=noises,
                    message_modulus=mm, carry_modulus=num.carry_modulus,
                )
            )
        quo = self.sum_ciphertexts(terms)
        return quo, rem

    def div(self, num, den):
        return self.div_rem(num, den)[0]

    def rem(self, num, den):
        return self.div_rem(num, den)[1]

    def _trivial_radix(self, value: int, nb: int, like: RadixCiphertext) -> RadixCiphertext:
        mm = self.params.message_modulus
        delta = self.key.encoding.delta()
        ct = self._trivial_zero_blocks(like, nb)
        degs = np.zeros(nb, dtype=np.int64)
        v = int(value)
        for b in range(nb):
            digit = v % mm
            v //= mm
            if digit:
                ct[..., b, -1] = u64_const(digit * delta)
                degs[b] = digit
        return RadixCiphertext(
            ct=ct, degrees=degs,
            noise_levels=np.zeros(nb, dtype=np.int64),
            message_modulus=mm, carry_modulus=like.carry_modulus,
        )

    # ======================================================================
    # bit counting / parity — radix_parallel/count_zeros_ones.rs
    # ======================================================================

    def count_ones(self, a: RadixCiphertext) -> RadixCiphertext:
        """Popcount: per-block popcount LUT (ONE batched PBS) then radix sum."""
        mm = self.params.message_modulus
        a = self._clean(a)
        nb = a.num_blocks
        pop_lut = self._lut(lambda x: bin(x % mm).count("1"), degree=mm.bit_length() - 1)
        counts = self._pbs_blocks(a.ct, mm - 1, int(np.max(a.noise_levels)), pop_lut)
        # each block's count (<= bits_per_block) becomes its own radix value
        bits = self._bits_per_block()
        terms = []
        for b in range(nb):
            ct = self._trivial_zero_blocks(a, nb)
            ct[..., 0, :] = counts[..., b, :]
            degs = np.zeros(nb, dtype=np.int64)
            degs[0] = bits
            noises = np.zeros(nb, dtype=np.int64)
            noises[0] = NOMINAL_NOISE
            terms.append(
                RadixCiphertext(
                    ct=ct, degrees=degs, noise_levels=noises,
                    message_modulus=mm, carry_modulus=a.carry_modulus,
                )
            )
        return self.sum_ciphertexts(terms)

    def count_zeros(self, a: RadixCiphertext) -> RadixCiphertext:
        total = a.num_blocks * self._bits_per_block()
        ones = self.count_ones(a)
        return self.sub_parallelized(
            self._trivial_radix(total, a.num_blocks, a), ones
        )

    def is_even(self, a: RadixCiphertext) -> BooleanBlock:
        a = self._clean(a)
        lut = self._lut(lambda x: 1 - (x & 1), degree=1)
        bit = self._pbs_blocks(
            a.ct[..., :1, :], int(a.degrees[0]), int(a.noise_levels[0]), lut
        )
        return BooleanBlock(ct=bit[..., 0, :])

    def is_odd(self, a: RadixCiphertext) -> BooleanBlock:
        a = self._clean(a)
        lut = self._lut(lambda x: x & 1, degree=1)
        bit = self._pbs_blocks(
            a.ct[..., :1, :], int(a.degrees[0]), int(a.noise_levels[0]), lut
        )
        return BooleanBlock(ct=bit[..., 0, :])

    def ilog2(self, a: RadixCiphertext) -> RadixCiphertext:
        """floor(log2(a)) for a > 0 (radix_parallel/ilog2.rs): position of
        the most significant set bit via per-bit ge-comparisons summed."""
        a = self._clean(a)
        nb = a.num_blocks
        total_bits = nb * self._bits_per_block()
        # ilog2(a) = sum_{k=1}^{bits-1} [a >= 2^k]
        terms = []
        for k in range(1, total_bits):
            bit = self.scalar_ge(a, 1 << k)
            ct = self._trivial_zero_blocks(a, nb)
            ct[..., 0, :] = bit.ct
            degs = np.zeros(nb, dtype=np.int64)
            degs[0] = 1
            noises = np.zeros(nb, dtype=np.int64)
            noises[0] = NOMINAL_NOISE
            terms.append(
                RadixCiphertext(
                    ct=ct, degrees=degs, noise_levels=noises,
                    message_modulus=a.message_modulus,
                    carry_modulus=a.carry_modulus,
                )
            )
        return self.sum_ciphertexts(terms)

    # ======================================================================
    # signed (two's complement) ops — reference tests_signed/, SignedRadix.
    # Blocks are identical to unsigned; only comparisons, right shift, abs,
    # division and sign extension differ.
    # ======================================================================

    def _flip_sign_bit(self, a: RadixCiphertext) -> RadixCiphertext:
        """XOR the top bit of the top block (maps signed order to unsigned:
        signed_lt(a,b) == unsigned_lt(a^MSB, b^MSB))."""
        mm = self.params.message_modulus
        a = self._clean(a)
        top = mm // 2
        lut = self._lut(lambda x: (x % mm) ^ top, degree=mm - 1)
        nb = a.num_blocks
        flipped = self._pbs_blocks(
            a.ct[..., nb - 1 :, :], int(a.degrees[nb - 1]),
            int(a.noise_levels[nb - 1]), lut,
        )
        ct = torch.cat([a.ct[..., : nb - 1, :], flipped], dim=-2)
        return a.with_ct(ct)

    def _signed_compare(self, a, b, f) -> BooleanBlock:
        return self._sign_to_bool(
            self._block_compare_signs(self._flip_sign_bit(a), self._flip_sign_bit(b)),
            f,
        )

    def signed_lt(self, a, b):
        return self._signed_compare(a, b, lambda s: s == 1)

    def signed_le(self, a, b):
        return self._signed_compare(a, b, lambda s: s != 2)

    def signed_gt(self, a, b):
        return self._signed_compare(a, b, lambda s: s == 2)

    def signed_ge(self, a, b):
        return self._signed_compare(a, b, lambda s: s != 1)

    def signed_min(self, a, b):
        a, b = self._clean(a), self._clean(b)
        return self.if_then_else(self.signed_lt(a, b), a, b)

    def signed_max(self, a, b):
        a, b = self._clean(a), self._clean(b)
        return self.if_then_else(self.signed_gt(a, b), a, b)

    def sign_bit(self, a: RadixCiphertext) -> BooleanBlock:
        mm = self.params.message_modulus
        a = self._clean(a)
        nb = a.num_blocks
        lut = self._lut(lambda x: 1 if (x % mm) >= mm // 2 else 0, degree=1)
        bit = self._pbs_blocks(
            a.ct[..., nb - 1 :, :], int(a.degrees[nb - 1]),
            int(a.noise_levels[nb - 1]), lut,
        )
        return BooleanBlock(ct=bit[..., 0, :])

    def abs(self, a: RadixCiphertext) -> RadixCiphertext:
        """|a| for signed radix (radix_parallel/abs.rs)."""
        a = self._clean(a)
        neg = self.sub_parallelized(self._trivial_radix(0, a.num_blocks, a), a)
        return self.if_then_else(self.sign_bit(a), neg, a)

    def signed_scalar_compare(self, a: RadixCiphertext, scalar: int, f) -> BooleanBlock:
        bits = self._bits_per_block() * a.num_blocks
        flipped_scalar = (int(scalar) % (1 << bits)) ^ (1 << (bits - 1))
        return self._scalar_compare(self._flip_sign_bit(a), flipped_scalar, f)

    def signed_scalar_lt(self, a, scalar):
        return self.signed_scalar_compare(a, scalar, lambda s: s == 1)

    def signed_scalar_le(self, a, scalar):
        return self.signed_scalar_compare(a, scalar, lambda s: s != 2)

    def signed_scalar_gt(self, a, scalar):
        return self.signed_scalar_compare(a, scalar, lambda s: s == 2)

    def signed_scalar_ge(self, a, scalar):
        return self.signed_scalar_compare(a, scalar, lambda s: s != 1)

    def arithmetic_right_shift(self, a: RadixCiphertext, shift: int) -> RadixCiphertext:
        """Signed >> by a clear amount: logical shift then OR in the sign
        fill mask (scalar_shift.rs signed path)."""
        mm = self.params.message_modulus
        bits = self._bits_per_block()
        a = self._clean(a)
        nb = a.num_blocks
        total = nb * bits
        shift %= total
        if shift == 0:
            return a
        logical = self.scalar_right_shift(a, shift)
        # fill = sign ? ~((1 << (total-shift)) - 1) : 0, blockwise
        fill_mask = (((1 << total) - 1) ^ ((1 << (total - shift)) - 1))
        digits = self._scalar_blocks(fill_mask, nb)
        sign = self.sign_bit(a)
        c = torch.broadcast_to(sign.ct[..., None, :], logical.ct.shape)
        accs = []
        for bidx in range(nb):
            d = digits[bidx]
            accs.append(
                self.key.generate_lookup_table(
                    lambda x, d=d: ((x // 2) % mm) | (d if x % 2 else 0)
                ).acc
            )
        lut = LookupTable(acc=torch.stack(accs, dim=0), degree=mm - 1)
        packed = logical.ct * 2 + c
        noise = int(np.max(logical.noise_levels)) * 2 + 1
        out = self._pbs_blocks(packed, 2 * mm - 1, noise, lut)
        return a.with_ct(
            out,
            degrees=np.full(nb, mm - 1, dtype=np.int64),
            noise_levels=np.full(nb, NOMINAL_NOISE, dtype=np.int64),
        )

    def arithmetic_right_shift_encrypted(
        self, a: RadixCiphertext, amount: RadixCiphertext
    ) -> RadixCiphertext:
        """Signed >> by an ENCRYPTED amount: barrel shifter whose per-bit
        conditional step is the sign-extending shift (reference
        shift.rs signed right_shift_parallelized)."""
        return self._barrel_shift(a, amount, self.arithmetic_right_shift)

    def signed_div_rem(self, num: RadixCiphertext, den: RadixCiphertext):
        """Signed division with C/Rust truncation semantics
        (div_mod.rs signed path): |num| / |den| with sign fixups."""
        num, den = self._clean(num), self._clean(den)
        sn, sd = self.sign_bit(num), self.sign_bit(den)
        q_abs, r_abs = self.div_rem(self.abs(num), self.abs(den))
        zero_q = self._trivial_radix(0, q_abs.num_blocks, q_abs)
        zero_r = self._trivial_radix(0, r_abs.num_blocks, r_abs)
        neg_q = self.sub_parallelized(zero_q, q_abs)
        neg_r = self.sub_parallelized(zero_r, r_abs)
        # q negative iff signs differ; r takes num's sign
        sign_diff = BooleanBlock(
            ct=self._pbs_blocks(
                (sn.ct * 2 + sd.ct)[..., None, :], 3, 3,
                self._lut(lambda x: 1 if (x // 2) ^ (x % 2) else 0, degree=1),
            )[..., 0, :]
        )
        q = self.if_then_else(sign_diff, neg_q, q_abs)
        r = self.if_then_else(sn, neg_r, r_abs)
        return q, r

    # ======================================================================
    # casts — trim/extend (integer/server_key/radix/mod.rs cast_to_*)
    # ======================================================================

    def cast_to_num_blocks(self, a: RadixCiphertext, nb_out: int) -> RadixCiphertext:
        a = self._clean(a)
        nb = a.num_blocks
        if nb_out == nb:
            return a
        if nb_out < nb:
            return a.with_ct(
                a.ct[..., :nb_out, :],
                degrees=a.degrees[:nb_out],
                noise_levels=a.noise_levels[:nb_out],
            )
        pad = self._trivial_zero_blocks(a, nb_out - nb)
        return a.with_ct(
            torch.cat([a.ct, pad], dim=-2),
            degrees=np.concatenate([a.degrees, np.zeros(nb_out - nb, dtype=np.int64)]),
            noise_levels=np.concatenate(
                [a.noise_levels, np.zeros(nb_out - nb, dtype=np.int64)]
            ),
        )

    def signed_cast_to_num_blocks(self, a: RadixCiphertext, nb_out: int) -> RadixCiphertext:
        """Sign-extending cast (reference cast_to_signed)."""
        mm = self.params.message_modulus
        a = self._clean(a)
        nb = a.num_blocks
        if nb_out <= nb:
            return self.cast_to_num_blocks(a, nb_out)
        sign = self.sign_bit(a)
        fill_lut = self._lut(lambda x: (mm - 1) if x % 2 else 0, degree=mm - 1)
        fill = self._pbs_blocks(sign.ct[..., None, :], 1, 1, fill_lut)
        fills = torch.cat([fill] * (nb_out - nb), dim=-2)
        return a.with_ct(
            torch.cat([a.ct, fills], dim=-2),
            degrees=np.concatenate(
                [a.degrees, np.full(nb_out - nb, mm - 1, dtype=np.int64)]
            ),
            noise_levels=np.concatenate(
                [a.noise_levels, np.full(nb_out - nb, NOMINAL_NOISE, dtype=np.int64)]
            ),
        )

    def decrypt_bool(self, client_key: ClientKey, blk: BooleanBlock) -> np.ndarray:
        s = ShortintCiphertext(
            ct=blk.ct, degree=1, noise_level=1,
            message_modulus=self.params.message_modulus,
            carry_modulus=self.params.carry_modulus,
        )
        out = np.asarray(client_key.key.decrypt(s)).astype(bool)
        return out.reshape(tuple(blk.ct.shape[:-1]))  # the block's batch shape
