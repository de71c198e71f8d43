"""FHE Trivium stream cipher over the port's boolean layer, and
transciphering.

Torch counterpart of ``apps/trivium.py`` (reference ``apps/trivium/``,
TriviumStream<FheBool>; spec: eSTREAM Trivium, De Canniere & Preneel).

The 288-bit state is ONE batched boolean ciphertext [288, n+1]. All taps
are at least 65 positions apart, so 64 consecutive rounds are
data-independent: each 64-round chunk is six batched gate calls over 64 or
192 lanes (:meth:`TriviumStream.next_64`), the reference's
TriviumStreamShifted 64-bit API.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..boolean.keys import (PLAINTEXT_FALSE, PLAINTEXT_TRUE,
                            BooleanCiphertext, ServerKey)

# ---------------------------------------------------------------------------
# clear reference implementation (test oracle)
# ---------------------------------------------------------------------------


class ClearTrivium:
    """Bit-exact clear Trivium (the oracle for the FHE stream)."""

    def __init__(self, key80: List[int], iv80: List[int], warmup: bool = True):
        s = [0] * 288
        s[0:80] = list(key80)
        s[93:173] = list(iv80)
        s[285] = s[286] = s[287] = 1
        self.s = s
        if warmup:
            for _ in range(4 * 288):
                self._round()

    def _round(self) -> int:
        s = self.s
        t1 = s[65] ^ s[92]
        t2 = s[161] ^ s[176]
        t3 = s[242] ^ s[287]
        z = t1 ^ t2 ^ t3
        t1n = t1 ^ (s[90] & s[91]) ^ s[170]
        t2n = t2 ^ (s[174] & s[175]) ^ s[263]
        t3n = t3 ^ (s[285] & s[286]) ^ s[68]
        self.s = [t3n] + s[0:92] + [t1n] + s[93:176] + [t2n] + s[177:287]
        return z

    def next_bits(self, n: int) -> List[int]:
        return [self._round() for _ in range(n)]


# ---------------------------------------------------------------------------
# FHE implementation
# ---------------------------------------------------------------------------

@dataclass
class TriviumStream:
    """FHE Trivium keystream generator (64 bits per batched step)."""

    sk: ServerKey
    state: BooleanCiphertext  # [288, n+1]

    #: warm-up rounds of the cipher (4 x 288), run as 18 x 64
    WARMUP_ROUNDS = 1152

    @classmethod
    def new(cls, server_key: ServerKey, key_ct: BooleanCiphertext,
            iv80: List[int], warmed_up: bool = True) -> "TriviumStream":
        """Build the initial state (key encrypted, IV and constants trivial
        ciphertexts) and run the 1152 warm-up rounds under FHE."""
        n = key_ct.ct.shape[-1] - 1
        body = torch.full((288,), PLAINTEXT_FALSE, dtype=torch.int64)
        iv = torch.as_tensor(np.asarray(iv80, dtype=bool))
        body[93:173] = torch.where(iv, PLAINTEXT_TRUE, PLAINTEXT_FALSE)
        body[285:288] = PLAINTEXT_TRUE
        state = torch.zeros((288, n + 1), dtype=torch.int64,
                            device=key_ct.ct.device)
        state[:, -1] = body.to(state.device)
        state[0:80] = key_ct.ct
        stream = cls(sk=server_key, state=BooleanCiphertext(ct=state))
        if warmed_up:
            for _ in range(cls.WARMUP_ROUNDS // 64):
                stream.next_64()
        return stream

    @classmethod
    def from_state(cls, server_key: ServerKey,
                   state: BooleanCiphertext) -> "TriviumStream":
        """Resume from an (already warmed) encrypted 288-bit state."""
        return cls(sk=server_key, state=state)

    def next_64(self) -> BooleanCiphertext:
        """64 keystream bits from six batched gate calls.

        For rounds r = 0..63 the tap at state position i reads position
        i - r, so each tap becomes a 64-wide window, in ascending r."""
        sk = self.sk
        s = self.state.ct

        def win(i):
            return s[i - 63: i + 1].flip(0)

        def cat(*parts):
            return BooleanCiphertext(ct=torch.cat(parts, dim=0))

        # t1 = s66^s93, t2 = s162^s177, t3 = s243^s288 (1-based taps)
        t123 = sk.xor(cat(win(65), win(161), win(242)),
                      cat(win(92), win(176), win(287)))
        t1, t2, t3 = (BooleanCiphertext(ct=x) for x in t123.ct.split(64))
        z = sk.xor(t1, sk.xor(t2, t3))
        # a1 = s91&s92, a2 = s175&s176, a3 = s286&s287
        ands = sk.and_(cat(win(90), win(174), win(285)),
                       cat(win(91), win(175), win(286)))
        # feedback: f1 = t1^a1^s171, f2 = t2^a2^s264, f3 = t3^a3^s69
        fb = sk.xor(sk.xor(t123, ands), cat(win(170), win(263), win(68)))
        f1, f2, f3 = fb.ct.split(64)
        # shift the three registers by 64 and insert the feedback words
        # (the newest bit at the lowest index)
        self.state = BooleanCiphertext(ct=torch.cat([
            f3.flip(0), s[0:93 - 64],
            f1.flip(0), s[93:177 - 64],
            f2.flip(0), s[177:288 - 64],
        ], dim=0))
        return z

    def next_bits(self, count: int) -> BooleanCiphertext:
        outs = [self.next_64().ct for _ in range(-(-count // 64))]
        return BooleanCiphertext(ct=torch.cat(outs, dim=0)[:count])


# ---------------------------------------------------------------------------
# transciphering: XOR an FHE keystream into Trivium-encrypted data
# ---------------------------------------------------------------------------

def transcipher_decrypt(stream: TriviumStream,
                        ciphertext_bits: List[int]) -> BooleanCiphertext:
    """Turn symmetric Trivium ciphertext into FHE ciphertext of the
    plaintext: FHE(z) XOR clear(c) = FHE(m). The clear XOR is leveled (a
    NOT where c = 1), with no extra PBS."""
    ks = stream.next_bits(len(ciphertext_bits)).ct
    flip = torch.as_tensor(np.asarray(ciphertext_bits, dtype=bool),
                           device=ks.device)[:, None]
    return BooleanCiphertext(ct=torch.where(flip, -ks, ks))
