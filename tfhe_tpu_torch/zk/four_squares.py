"""Lagrange four-square decomposition (Rabin–Shallit style).

Contract mirror of ``tfhe-zk-pok/src/four_squares.rs:193`` (used by the
pke_v2 proof to witness B^2 - ||e||^2 as v1^2+v2^2+v3^2+v4^2). The
randomized reduction is deterministic (fixed-seed RNG) like the reference.
"""

from __future__ import annotations

import random
from math import isqrt
from typing import List, Tuple

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37]


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    bases = list(_SMALL_PRIMES)
    if n >= (1 << 81):
        # the 12 fixed bases are only proven deterministic for n < 3.3e24;
        # production b^2 - ||e||^2 candidates exceed 2^80, so add seeded
        # random bases (error probability <= 4^-20 per candidate)
        rnd = random.Random(n)
        bases += [rnd.randrange(2, n - 1) for _ in range(20)]
    for a in bases:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _sqrt_minus_one(p: int, rng: random.Random) -> int:
    """s with s^2 = -1 (mod p), p prime = 1 (mod 4)."""
    while True:
        a = rng.randrange(2, p - 1)
        s = pow(a, (p - 1) // 4, p)
        if (s * s) % p == p - 1:
            return s


def _two_squares_prime(p: int, rng: random.Random) -> Tuple[int, int]:
    """p prime = 1 (mod 4) -> (x, y) with x^2 + y^2 = p (Cornacchia /
    half-gcd, four_squares.rs:16)."""
    if p == 2:
        return 1, 1
    s = _sqrt_minus_one(p, rng)
    a, b = p, min(s, p - s)
    while b * b > p:
        a, b = b, a % b
    x = b
    y2 = p - x * x
    y = isqrt(y2)
    assert y * y == y2, (p, x)
    return x, y


def _three_squares(n: int, rng: random.Random) -> List[int]:
    """n with n != 4^a (8b+7) -> [x, y, z]; may loop (randomized)."""
    if n == 0:
        return [0, 0, 0]
    r = isqrt(n)
    if r * r == n:
        return [r, 0, 0]
    while True:
        x = rng.randrange(0, r + 1)
        p = n - x * x
        if p < 0:
            continue
        if p == 0:
            return [x, 0, 0]
        if p == 1:
            return [x, 1, 0]
        if p == 2:
            return [x, 1, 1]
        pr = isqrt(p)
        if pr * pr == p:
            return [x, pr, 0]
        if p % 4 == 1 and _is_prime(p):
            a, b = _two_squares_prime(p, rng)
            return [x, a, b]
        # p = 2q with q prime = 1 mod 4: 2q = (a+b)^2 + (a-b)^2
        if p % 8 == 2 and _is_prime(p // 2) and (p // 2) % 4 == 1:
            a, b = _two_squares_prime(p // 2, rng)
            return [x, a + b, abs(a - b)]


def four_squares(v: int) -> List[int]:
    """v >= 0 -> [a, b, c, d] with a^2+b^2+c^2+d^2 == v (sorted desc)."""
    assert v >= 0
    rng = random.Random(0)
    if v == 0:
        return [0, 0, 0, 0]
    # strip factors of 4 (squares scale by 2)
    shift = 0
    while v % 4 == 0:
        v //= 4
        shift += 1
    if v % 8 == 7:
        # needs all four squares: peel one square d^2 with v - d^2 != 7 mod 8
        r = isqrt(v)
        for d in range(r, -1, -1):
            rem = v - d * d
            m = rem
            while m % 4 == 0:
                m //= 4
            if m % 8 != 7:
                out = _three_squares(rem, rng) + [d]
                break
        else:  # pragma: no cover
            raise AssertionError(v)
    else:
        out = _three_squares(v, rng) + [0]
    out = [x << shift for x in out]
    out.sort(reverse=True)
    total = sum(x * x for x in out)
    assert total == (v << (2 * shift)), (v, out)
    return out
