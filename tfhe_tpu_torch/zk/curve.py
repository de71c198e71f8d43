"""BLS12-446 pairing curve, pure Python (host-side only).

Parameters mirror the reference ``tfhe-zk-pok/src/curve_446/mod.rs``
(cryptographic constants that must match): u = -0x6008204000000020001,
E: y^2 = x^3 + 1 over Fq (446 bits), M-type twist E': y^2 = x^3 + (1+i)
over Fq2, r = 645383785691237230677916041525710377746967055506026847120930304831624105190538527824412673.

Design: arbitrary-precision int field arithmetic and a *generic* ate
Miller loop — G2 points are untwisted into E(Fq12) and lines are evaluated
in full Fq12 (numerator/denominator accumulated, one inversion per step
for the slope). This trades speed for obviousness; proofs/verification are
host-side and run in seconds, which is fine for the ZK surface (the FHE
data path never touches this code).
"""

from __future__ import annotations

from dataclasses import dataclass

# ---------------------------------------------------------------------------
# constants (curve_446/mod.rs)
# ---------------------------------------------------------------------------

P = 172824703542857155980071276579495962243492693522789898437834836356385656662277472896902502740297183690175962001546428467344062165330603
R = 645383785691237230677916041525710377746967055506026847120930304831624105190538527824412673
X_ABS = 0x6008204000000020001  # |u|; u is negative

G1_X = 143189966182216199425404656824735381247272236095050141599848381692039676741476615087722874458136990266833440576646963466074693171606778
G1_Y = 75202396197342917254523279069469674666303680671605970245803554133573745859131002231546341942288521574682619325841484506619191207488304

G2_X = (
    96453755443802578867745476081903764610578492683850270111202389209355548711427786327510993588141991264564812146530214503491136289085725,
    85346509177292795277012009839788781950274202400882571466460158277083221521663169974265433098009350061415973662678938824527658049065530,
)
G2_Y = (
    49316184343270950587272132771103279293158283984999436491292404103501221698714795975575879957605051223501287444864258801515822358837529,
    107680854723992552431070996218129928499826544031468382031848626814251381379173928074140221537929995580031433096217223703806029068859074,
)

G1_COFACTOR = 267785939737784928360481681640896166738700972


def _inv(a: int, m: int = P) -> int:
    return pow(a, -1, m)


# ---------------------------------------------------------------------------
# tower: Fq2 = Fq[i]/(i^2+1); Fq6 = Fq2[v]/(v^3-xi), xi=1+i; Fq12 = Fq6[w]/(w^2-v)
# ---------------------------------------------------------------------------

def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a, b):
    return (
        (a[0] * b[0] - a[1] * b[1]) % P,
        (a[0] * b[1] + a[1] * b[0]) % P,
    )


def f2_smul(a, s):
    return ((a[0] * s) % P, (a[1] * s) % P)


def f2_inv(a):
    d = _inv((a[0] * a[0] + a[1] * a[1]) % P)
    return ((a[0] * d) % P, (-a[1] * d) % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (1, 1)  # Fq6 nonresidue 1 + i


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f6_mul(a, b):
    # schoolbook with v^3 = XI reduction
    c = [F2_ZERO] * 5
    for i in range(3):
        if a[i] == F2_ZERO:
            continue
        for j in range(3):
            c[i + j] = f2_add(c[i + j], f2_mul(a[i], b[j]))
    return (
        f2_add(c[0], f2_mul(c[3], XI)),
        f2_add(c[1], f2_mul(c[4], XI)),
        c[2],
    )


def f6_mul_by_v(a):
    return (f2_mul(a[2], XI), a[0], a[1])


def f6_inv(a):
    # standard Fp6 inversion via the adjugate
    a0, a1, a2 = a
    t0 = f2_sub(f2_mul(a0, a0), f2_mul(XI, f2_mul(a1, a2)))
    t1 = f2_sub(f2_mul(XI, f2_mul(a2, a2)), f2_mul(a0, a1))
    t2 = f2_sub(f2_mul(a1, a1), f2_mul(a0, a2))
    norm = f2_add(
        f2_mul(a0, t0), f2_mul(XI, f2_add(f2_mul(a2, t1), f2_mul(a1, t2)))
    )
    ninv = f2_inv(norm)
    return (f2_mul(t0, ninv), f2_mul(t1, ninv), f2_mul(t2, ninv))


F6_ZERO = (F2_ZERO,) * 3
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_sub(a, b):
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def f12_neg(a):
    return (f6_neg(a[0]), f6_neg(a[1]))


def f12_mul(a, b):
    # (a0 + a1 w)(b0 + b1 w), w^2 = v
    t0 = f6_mul(a[0], b[0])
    t1 = f6_mul(a[1], b[1])
    mid = f6_sub(
        f6_sub(f6_mul(f6_add(a[0], a[1]), f6_add(b[0], b[1])), t0), t1
    )
    return (f6_add(t0, f6_mul_by_v(t1)), mid)


def f12_inv(a):
    # norm = a0^2 - v a1^2
    norm = f6_sub(f6_mul(a[0], a[0]), f6_mul_by_v(f6_mul(a[1], a[1])))
    ninv = f6_inv(norm)
    return (f6_mul(a[0], ninv), f6_neg(f6_mul(a[1], ninv)))


def f12_conj(a):
    """Conjugation a0 - a1 w = Frobenius^6 (inverse on the cyclotomic
    subgroup, used for the negative ate loop count)."""
    return (a[0], f6_neg(a[1]))


F12_ZERO = (F6_ZERO, F6_ZERO)
F12_ONE = (F6_ONE, F6_ZERO)


def f12_pow(a, e: int):
    if e < 0:
        a, e = f12_inv(a), -e
    acc = F12_ONE
    for bit in bin(e)[2:]:
        acc = f12_mul(acc, acc)
        if bit == "1":
            acc = f12_mul(acc, a)
    return acc


def fq_to_f12(x: int):
    return (((x % P, 0), F2_ZERO, F2_ZERO), F6_ZERO)


def fq2_to_f12(x):
    """Embed Fq2 via its canonical copy inside Fq12 (i -> i)."""
    return ((x, F2_ZERO, F2_ZERO), F6_ZERO)


# w and its powers, as Fq12 elements: w = (0, 1) in the (a0, a1) basis
F12_W = (F6_ZERO, F6_ONE)
F12_W2 = (
    (F2_ZERO, F2_ONE, F2_ZERO),
    F6_ZERO,
)  # w^2 = v
F12_W3 = (F6_ZERO, (F2_ZERO, F2_ONE, F2_ZERO))  # w^3 = v w


# ---------------------------------------------------------------------------
# group law (affine, generic over the three fields)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _FieldOps:
    add: callable
    sub: callable
    neg: callable
    mul: callable
    inv: callable
    zero: object
    one: object


FQ_OPS = _FieldOps(
    add=lambda a, b: (a + b) % P,
    sub=lambda a, b: (a - b) % P,
    neg=lambda a: (-a) % P,
    mul=lambda a, b: (a * b) % P,
    inv=_inv,
    zero=0,
    one=1,
)
FQ2_OPS = _FieldOps(f2_add, f2_sub, f2_neg, f2_mul, f2_inv, F2_ZERO, F2_ONE)
FQ12_OPS = _FieldOps(
    f12_add, f12_sub, f12_neg, f12_mul, f12_inv, F12_ZERO, F12_ONE
)


def _pt_double(pt, ops, a_coeff=None):
    if pt is None:
        return None
    x, y = pt
    if y == ops.zero:
        return None
    # lambda = 3x^2 / 2y   (a = 0 on both curves)
    num = ops.mul(ops.mul(x, x), _scalar_embed(3, ops))
    lam = ops.mul(num, ops.inv(ops.add(y, y)))
    x3 = ops.sub(ops.mul(lam, lam), ops.add(x, x))
    y3 = ops.sub(ops.mul(lam, ops.sub(x, x3)), y)
    return (x3, y3)


def _pt_add(p1, p2, ops):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return _pt_double(p1, ops)
        return None
    lam = ops.mul(ops.sub(y2, y1), ops.inv(ops.sub(x2, x1)))
    x3 = ops.sub(ops.sub(ops.mul(lam, lam), x1), x2)
    y3 = ops.sub(ops.mul(lam, ops.sub(x1, x3)), y1)
    return (x3, y3)


def _pt_neg(pt, ops):
    if pt is None:
        return None
    return (pt[0], ops.neg(pt[1]))


def _jac_double(j, ops):
    """a = 0 Jacobian doubling (X, Y, Z)."""
    X, Y, Z = j
    if Y == ops.zero:
        return None
    A = ops.mul(X, X)
    B = ops.mul(Y, Y)
    C = ops.mul(B, B)
    t = ops.add(X, B)
    D = ops.sub(ops.sub(ops.mul(t, t), A), C)
    D = ops.add(D, D)
    E = ops.add(ops.add(A, A), A)
    F = ops.mul(E, E)
    X3 = ops.sub(F, ops.add(D, D))
    C8 = ops.add(C, C)
    C8 = ops.add(C8, C8)
    C8 = ops.add(C8, C8)
    Y3 = ops.sub(ops.mul(E, ops.sub(D, X3)), C8)
    Z3 = ops.mul(ops.add(Y, Y), Z)
    return (X3, Y3, Z3)


def _jac_add_affine(j, a, ops):
    """Mixed Jacobian + affine addition."""
    if j is None:
        return (a[0], a[1], ops.one)
    X1, Y1, Z1 = j
    Z1Z1 = ops.mul(Z1, Z1)
    U2 = ops.mul(a[0], Z1Z1)
    S2 = ops.mul(ops.mul(a[1], Z1Z1), Z1)
    H = ops.sub(U2, X1)
    Rr = ops.sub(S2, Y1)
    if H == ops.zero:
        if Rr == ops.zero:
            return _jac_double(j, ops)
        return None
    H2 = ops.mul(H, H)
    H3 = ops.mul(H2, H)
    V = ops.mul(X1, H2)
    X3 = ops.sub(ops.sub(ops.mul(Rr, Rr), H3), ops.add(V, V))
    Y3 = ops.sub(ops.mul(Rr, ops.sub(V, X3)), ops.mul(Y1, H3))
    Z3 = ops.mul(Z1, H)
    return (X3, Y3, Z3)


def _jac_add(p, q, ops):
    """Full Jacobian + Jacobian addition (a = 0), add-2007-bl shape."""
    if p is None:
        return q
    if q is None:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = ops.mul(Z1, Z1)
    Z2Z2 = ops.mul(Z2, Z2)
    U1 = ops.mul(X1, Z2Z2)
    U2 = ops.mul(X2, Z1Z1)
    S1 = ops.mul(Y1, ops.mul(Z2, Z2Z2))
    S2 = ops.mul(Y2, ops.mul(Z1, Z1Z1))
    H = ops.sub(U2, U1)
    Rr = ops.sub(S2, S1)
    if H == ops.zero:
        if Rr == ops.zero:
            return _jac_double(p, ops)
        return None
    H2 = ops.add(H, H)
    I = ops.mul(H2, H2)
    J = ops.mul(H, I)
    r2 = ops.add(Rr, Rr)
    V = ops.mul(U1, I)
    X3 = ops.sub(ops.sub(ops.mul(r2, r2), J), ops.add(V, V))
    S1J = ops.mul(ops.add(S1, S1), J)
    Y3 = ops.sub(ops.mul(r2, ops.sub(V, X3)), S1J)
    Zs = ops.add(Z1, Z2)
    Z3 = ops.mul(ops.sub(ops.sub(ops.mul(Zs, Zs), Z1Z1), Z2Z2), H)
    return (X3, Y3, Z3)


def _jac_to_affine_batch(jacs, ops):
    """Jacobian points (or None) -> affine (or None) with ONE field
    inversion for the whole batch (Montgomery's trick)."""
    idx = [i for i, j in enumerate(jacs) if j is not None]
    if not idx:
        return [None] * len(jacs)
    # prefix products of the Z coordinates
    prefix = []
    acc = ops.one
    for i in idx:
        acc = ops.mul(acc, jacs[i][2])
        prefix.append(acc)
    inv_all = ops.inv(acc)
    out = [None] * len(jacs)
    for pos in range(len(idx) - 1, -1, -1):
        i = idx[pos]
        zinv = ops.mul(inv_all, prefix[pos - 1]) if pos else inv_all
        inv_all = ops.mul(inv_all, jacs[i][2])
        zi2 = ops.mul(zinv, zinv)
        out[i] = (ops.mul(jacs[i][0], zi2),
                  ops.mul(jacs[i][1], ops.mul(zi2, zinv)))
    return out


def _msm_pippenger(points, scalars, ops, bits: int = None):
    """Multi-scalar multiplication over affine points (bucket method).

    ``points``: affine tuples (or None); ``scalars``: non-negative ints.
    Returns a Jacobian point or None. Window size scales with the input
    so bucket setup amortizes (c ~ log2(size)).
    """
    pairs = [(p, s) for p, s in zip(points, scalars) if p is not None and s]
    if not pairs:
        return None
    if len(pairs) == 1:
        p, s = pairs[0]
        j = _pt_mul_jac(p, s, ops)
        return j
    if bits is None:
        bits = max(s.bit_length() for _, s in pairs)
    m = len(pairs)
    # window minimizing nwin*(m + ~1.2*2^c) mixed/jacobian additions
    c = min(range(2, 17),
            key=lambda w: ((bits + w - 1) // w) * (m + 1.2 * (1 << w)))
    nwin = (bits + c - 1) // c
    mask = (1 << c) - 1
    total = None
    for w in range(nwin - 1, -1, -1):
        if total is not None:
            for _ in range(c):
                total = _jac_double(total, ops)
        buckets = [None] * (mask + 1)
        sh = w * c
        for p, s in pairs:
            b = (s >> sh) & mask
            if b:
                buckets[b] = _jac_add_affine(buckets[b], p, ops)
        # running-sum trick: sum_b b * bucket[b]
        run = None
        win_sum = None
        for b in range(mask, 0, -1):
            run = _jac_add(run, buckets[b], ops)
            win_sum = _jac_add(win_sum, run, ops)
        total = _jac_add(total, win_sum, ops)
    return total


def _pt_mul_jac(pt, k: int, ops):
    """Like :func:`_pt_mul` but returns Jacobian (no final inversion)."""
    if pt is None or k == 0:
        return None
    acc = None
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = _jac_double(acc, ops)
        if bit == "1":
            acc = _jac_add_affine(acc, pt, ops)
    return acc


class _FixedBaseTable:
    """Windowed fixed-base scalar multiplication: table[i][b] holds the
    affine point (b << (w*i)) * base, so a scalar multiply is ~bits/w
    mixed additions and zero doublings. Built once per base (the CRS
    generator) with a single batch inversion."""

    def __init__(self, base_affine, ops, bits: int, window: int = 8):
        self.ops = ops
        self.window = window
        w = window
        nwin = (bits + w - 1) // w
        jacs = []
        cur = (base_affine[0], base_affine[1], ops.one)
        for _ in range(nwin):
            row = [cur]
            for _ in range((1 << w) - 2):
                row.append(_jac_add(row[-1], cur, ops))
            jacs.extend(row)
            cur = row[-1]
            cur = _jac_add(cur, row[0], ops)  # 2^w * window base
        aff = _jac_to_affine_batch(jacs, ops)
        per = (1 << w) - 1
        self.rows = [aff[i * per:(i + 1) * per] for i in range(nwin)]

    def mul_jac(self, k: int):
        """k * base as a Jacobian point (or None)."""
        ops = self.ops
        w = self.window
        mask = (1 << w) - 1
        acc = None
        i = 0
        while k:
            b = k & mask
            if b:
                if i >= len(self.rows):
                    raise ValueError("scalar exceeds table range")
                pt = self.rows[i][b - 1]
                if pt is not None:
                    acc = _jac_add_affine(acc, pt, ops)
            k >>= w
            i += 1
        return acc

    def mul_many(self, scalars):
        """[k0, k1, ...] -> affine points, one batch inversion total."""
        jacs = [self.mul_jac(int(k)) for k in scalars]
        return _jac_to_affine_batch(jacs, self.ops)


def _pt_mul(pt, k: int, ops):
    if k < 0:
        return _pt_mul(_pt_neg(pt, ops), -k, ops)
    if pt is None or k == 0:
        return None
    acc = None
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = _jac_double(acc, ops)
        if bit == "1":
            acc = _jac_add_affine(acc, pt, ops)
    if acc is None:
        return None
    zinv = ops.inv(acc[2])
    zi2 = ops.mul(zinv, zinv)
    return (ops.mul(acc[0], zi2), ops.mul(acc[1], ops.mul(zi2, zinv)))


def _scalar_embed(s: int, ops):
    if ops is FQ_OPS:
        return s % P
    if ops is FQ2_OPS:
        return (s % P, 0)
    return fq_to_f12(s)


# ---------------------------------------------------------------------------
# public group wrappers
# ---------------------------------------------------------------------------

class InvalidPointError(ValueError):
    """Raised by ``G1/G2.from_bytes`` on malformed or insecure (off-curve /
    out-of-subgroup) serialized points. A ``ValueError`` so that callers
    without serialization context can still catch it generically; the
    serialization layer re-wraps it as ``SerializationError``."""


class _GroupElement:
    __slots__ = ("pt",)
    OPS: _FieldOps = None
    GEN = None

    def __init__(self, pt):
        self.pt = pt

    @classmethod
    def generator(cls):
        return cls(cls.GEN)

    @classmethod
    def zero(cls):
        return cls(None)

    def __add__(self, other):
        return type(self)(_pt_add(self.pt, other.pt, self.OPS))

    def __sub__(self, other):
        return type(self)(
            _pt_add(self.pt, _pt_neg(other.pt, self.OPS), self.OPS)
        )

    def __neg__(self):
        return type(self)(_pt_neg(self.pt, self.OPS))

    def __mul__(self, k: int):
        return type(self)(_pt_mul(self.pt, int(k) % R, self.OPS))

    __rmul__ = __mul__

    def __eq__(self, other):
        return self.pt == other.pt

    def __hash__(self):
        return hash(("G", self.pt))

    def is_zero(self):
        return self.pt is None


class G1(_GroupElement):
    OPS = FQ_OPS
    GEN = (G1_X, G1_Y)

    def on_curve(self) -> bool:
        if self.pt is None:
            return True
        x, y = self.pt
        return (y * y - x * x * x - 1) % P == 0

    def in_subgroup(self) -> bool:
        if not self.on_curve():
            return False
        native = _native_in_subgroup(type(self), self.pt)
        if native is not None:
            return native
        return _pt_mul(self.pt, R, FQ_OPS) is None

    def to_bytes(self) -> bytes:
        if self.pt is None:
            return b"\x00" * 112
        return self.pt[0].to_bytes(56, "little") + self.pt[1].to_bytes(
            56, "little"
        )

    @classmethod
    def from_bytes(cls, b: bytes, check_subgroup: bool = True) -> "G1":
        """Deserialize an (untrusted) G1 point.

        Raises :class:`InvalidPointError` (a ``ValueError``) on bad length,
        non-canonical coordinates, off-curve points, or (by default)
        points outside the prime-order subgroup — BLS12-446 G1 has a
        nontrivial cofactor, so an on-curve check alone admits
        small-subgroup points into pairing-based verification (the
        reference validates subgroup membership on deserialization).
        ``check_subgroup=False`` is for trusted in-process round trips
        only (the R-scalar multiplication is expensive in pure Python)."""
        if len(b) != 112:
            raise InvalidPointError(f"G1: expected 112 bytes, got {len(b)}")
        if b == b"\x00" * 112:
            return cls.zero()
        x = int.from_bytes(b[:56], "little")
        y = int.from_bytes(b[56:], "little")
        if x >= P or y >= P:
            raise InvalidPointError("G1: non-canonical coordinate")
        pt = cls((x, y))
        if not pt.on_curve():
            raise InvalidPointError("G1: point not on curve")
        if check_subgroup and not pt.in_subgroup():
            raise InvalidPointError("G1: point not in prime-order subgroup")
        return pt


class G2(_GroupElement):
    OPS = FQ2_OPS
    GEN = (G2_X, G2_Y)

    def on_curve(self) -> bool:
        if self.pt is None:
            return True
        x, y = self.pt
        lhs = f2_sub(f2_mul(y, y), f2_mul(x, f2_mul(x, x)))
        return lhs == XI  # b' = 1 + i (M twist)

    def in_subgroup(self) -> bool:
        if not self.on_curve():
            return False
        native = _native_in_subgroup(type(self), self.pt)
        if native is not None:
            return native
        return _pt_mul(self.pt, R, FQ2_OPS) is None

    def to_bytes(self) -> bytes:
        if self.pt is None:
            return b"\x00" * 224
        (x0, x1), (y0, y1) = self.pt
        return b"".join(v.to_bytes(56, "little") for v in (x0, x1, y0, y1))

    @classmethod
    def from_bytes(cls, b: bytes, check_subgroup: bool = True) -> "G2":
        """Deserialize an (untrusted) G2 point — see :meth:`G1.from_bytes`
        for the validation contract (G2's cofactor is even larger)."""
        if len(b) != 224:
            raise InvalidPointError(f"G2: expected 224 bytes, got {len(b)}")
        if b == b"\x00" * 224:
            return cls.zero()
        x0, x1, y0, y1 = (int.from_bytes(b[i * 56:(i + 1) * 56], "little")
                          for i in range(4))
        if max(x0, x1, y0, y1) >= P:
            raise InvalidPointError("G2: non-canonical coordinate")
        pt = cls(((x0, x1), (y0, y1)))
        if not pt.on_curve():
            raise InvalidPointError("G2: point not on curve")
        if check_subgroup and not pt.in_subgroup():
            raise InvalidPointError("G2: point not in prime-order subgroup")
        return pt


class Fr:
    """Scalar field helpers."""

    MODULUS = R

    @staticmethod
    def rand(rng) -> int:
        return int.from_bytes(bytes(rng.integers(0, 256, 40).tolist()), "little") % R

    @staticmethod
    def from_bytes(b: bytes) -> int:
        return int.from_bytes(b, "little") % R


# ---------------------------------------------------------------------------
# pairing
# ---------------------------------------------------------------------------

def _untwist(q_pt):
    """E'(Fq2) -> E(Fq12): (x, y) -> (x / w^2, y / w^3) for the M twist
    (w^6 = xi so the twisted b maps back to b = 1)."""
    x = f12_mul(fq2_to_f12(q_pt[0]), f12_inv(F12_W2))
    y = f12_mul(fq2_to_f12(q_pt[1]), f12_inv(F12_W3))
    return (x, y)


def _line(a, b, p_eval):
    """Value of the line through a,b (tangent if a==b) at p_eval, plus the
    resulting point; all in E(Fq12). Returns (num, den, a+b)."""
    ops = FQ12_OPS
    xa, ya = a
    xp, yp = p_eval
    if a == b:
        if ya == ops.zero:
            return (f12_sub(xp, xa), F12_ONE, None)
        lam = f12_mul(
            f12_mul(f12_mul(xa, xa), fq_to_f12(3)),
            f12_inv(f12_add(ya, ya)),
        )
    else:
        xb, yb = b
        if xa == xb:
            return (f12_sub(xp, xa), F12_ONE, None)
        lam = f12_mul(f12_sub(yb, ya), f12_inv(f12_sub(xb, xa)))
    num = f12_sub(f12_sub(yp, ya), f12_mul(lam, f12_sub(xp, xa)))
    nxt = _pt_add(a, b, ops)
    if nxt is None:
        return (num, F12_ONE, None)
    # divide by the vertical at the result (full Miller function)
    den = f12_sub(xp, nxt[0])
    return (num, den, nxt)


def _miller(q12, p12, n: int):
    """f_{n,Q}(P) with the textbook double-and-add Miller loop."""
    f_num, f_den = F12_ONE, F12_ONE
    t = q12
    for bit in bin(n)[3:]:
        num, den, t = _line(t, t, p12)
        f_num = f12_mul(f12_mul(f_num, f_num), num)
        f_den = f12_mul(f12_mul(f_den, f_den), den)
        if bit == "1":
            num, den, t = _line(t, q12, p12)
            f_num = f12_mul(f_num, num)
            f_den = f12_mul(f_den, den)
    return f12_mul(f_num, f12_inv(f_den))


_FINAL_EXP = (P ** 12 - 1) // R


def pairing(p: G1, q: G2):
    """Ate pairing e(P, Q) in the order-r subgroup of Fq12*.

    Generic-Miller construction: untwist Q to E(Fq12), compute
    f_{|u|,Q}(P), raise to (p^12-1)/r. With u = t-1 = q (mod r) and q a
    primitive 12th root of unity mod r, |u| = -u = q^7 (mod r), so this is
    a generalized ate pairing (Vercauteren 2008): bilinear and
    non-degenerate (a fixed power of the optimal ate value), which is all
    the proof equations require. Pure correctness play, not speed.
    """
    if p.is_zero() or q.is_zero():
        return F12_ONE
    q12 = _untwist(q.pt)
    p12 = (fq_to_f12(p.pt[0]), fq_to_f12(p.pt[1]))
    f = _miller(q12, p12, X_ABS)
    return f12_pow(f, _FINAL_EXP)


def pairing_product_is_one(pairs) -> bool:
    """prod e(Pi, Qi) == 1 — the standard multi-pairing verification shape.

    Shares ONE final exponentiation across all pairs (the Miller values
    multiply before the (p^12-1)/r power), the textbook multi-pairing
    optimization — the final exp is the single most expensive part of a
    pure-Python pairing, so this is ~len(pairs)x cheaper than multiplying
    :func:`pairing` results. Dispatches to the native C backend
    (csrc/bls446.c pairing_product_is_one, same construction) when
    available — ~40x faster, the production verify path."""
    pairs = list(pairs)
    native = _native_pairing_product(pairs)
    if native is not None:
        return native
    acc = F12_ONE
    nontrivial = False
    for p, q in pairs:
        if p.is_zero() or q.is_zero():
            continue
        q12 = _untwist(q.pt)
        p12 = (fq_to_f12(p.pt[0]), fq_to_f12(p.pt[1]))
        acc = f12_mul(acc, _miller(q12, p12, X_ABS))
        nontrivial = True
    if not nontrivial:
        return True
    return f12_pow(acc, _FINAL_EXP) == F12_ONE


# --------------------------------------------------------------------------
# native (C) backend bridge — csrc/bls446.c implements the same Jacobian
# formulas with a 7x64-limb Montgomery field, built with cc at first use
# (_build.bls_lib); the Python code in this module is the spec and the
# fallback (tests cross-check the two). NATIVE_CALLS counts the calls the
# native library answered, by entry.
# --------------------------------------------------------------------------

NATIVE_CALLS = {"fixed_powers": 0, "msm": 0, "pairing_product": 0,
                "pairing_eval": 0, "subgroup": 0}


def _native_lib():
    from .._build import bls_lib

    return bls_lib()


def _pack_scalars(scalars) -> "np.ndarray":
    import numpy as np

    buf = b"".join((s % R).to_bytes(40, "little") for s in scalars)
    return np.frombuffer(buf, dtype=np.uint64).reshape(len(scalars), 5).copy()


def _g1_pack(pts) -> "np.ndarray":
    import numpy as np

    buf = b"".join(
        (b"\x00" * 112 if p is None else
         p[0].to_bytes(56, "little") + p[1].to_bytes(56, "little"))
        for p in pts)
    return np.frombuffer(buf, dtype=np.uint64).reshape(len(pts), 14).copy()


def _g2_pack(pts) -> "np.ndarray":
    import numpy as np

    parts = []
    for p in pts:
        if p is None:
            parts.append(b"\x00" * 224)
        else:
            (x0, x1), (y0, y1) = p
            parts.append(b"".join(v.to_bytes(56, "little")
                                  for v in (x0, x1, y0, y1)))
    return np.frombuffer(b"".join(parts),
                         dtype=np.uint64).reshape(len(pts), 28).copy()


def _g1_unpack(row) -> tuple:
    b = row.tobytes()
    return (int.from_bytes(b[:56], "little"),
            int.from_bytes(b[56:112], "little"))


def _g2_unpack(row) -> tuple:
    b = row.tobytes()
    v = [int.from_bytes(b[i * 56:(i + 1) * 56], "little") for i in range(4)]
    return ((v[0], v[1]), (v[2], v[3]))


def _exp_limbs() -> "np.ndarray":
    import numpy as np

    e = _FINAL_EXP
    nl = (e.bit_length() + 63) // 64
    return np.frombuffer(e.to_bytes(nl * 8, "little"), dtype=np.uint64).copy()


def _native_pairing_product(pairs):
    """Native multi-pairing verify, or None (missing lib / old .so /
    degenerate case — callers fall back to the Python spec)."""
    import ctypes

    import numpy as np

    lib = _native_lib()
    if lib is None or not hasattr(lib, "pairing_product_is_one"):
        return None
    g1p, g2p = [], []
    for p, q in pairs:
        g1p.append(p.pt)
        g2p.append(q.pt)
    n = len(pairs)
    g1b = _g1_pack(g1p)
    g2b = _g2_pack(g2p)
    g1i = np.array([1 if p is None else 0 for p in g1p], dtype=np.uint8)
    g2i = np.array([1 if q is None else 0 for q in g2p], dtype=np.uint8)
    exp = _exp_limbs()
    out = np.zeros(1, dtype=np.uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.pairing_product_is_one(
        g1b.ctypes.data_as(u64p), g1i.ctypes.data_as(u8p),
        g2b.ctypes.data_as(u64p), g2i.ctypes.data_as(u8p),
        ctypes.c_longlong(n), exp.ctypes.data_as(u64p),
        ctypes.c_int(len(exp)), out.ctypes.data_as(u8p))
    if rc != 0:
        return None
    NATIVE_CALLS["pairing_product"] += 1
    return bool(out[0])


def _native_pairing_eval(p: "G1", q: "G2"):
    """Native e(P, Q) as the Python f12 tuple, or None (cross-check path;
    tests compare this point-for-point against :func:`pairing`)."""
    import ctypes

    import numpy as np

    lib = _native_lib()
    if (lib is None or not hasattr(lib, "pairing_eval")
            or p.is_zero() or q.is_zero()):
        return None
    g1b = _g1_pack([p.pt])
    g2b = _g2_pack([q.pt])
    exp = _exp_limbs()
    out = np.zeros(12 * 7, dtype=np.uint64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    rc = lib.pairing_eval(
        g1b.ctypes.data_as(u64p), g2b.ctypes.data_as(u64p),
        exp.ctypes.data_as(u64p), ctypes.c_int(len(exp)),
        out.ctypes.data_as(u64p))
    if rc != 0:
        return None
    NATIVE_CALLS["pairing_eval"] += 1
    b = out.tobytes()
    fq = [int.from_bytes(b[i * 56:(i + 1) * 56], "little") for i in range(12)]
    return (((fq[0], fq[1]), (fq[2], fq[3]), (fq[4], fq[5])),
            ((fq[6], fq[7]), (fq[8], fq[9]), (fq[10], fq[11])))


def _native_fixed_powers(cls, scalars, window: int):
    import ctypes

    import numpy as np

    lib = _native_lib()
    if lib is None:
        return None
    pre = "g1" if cls is G1 else "g2"
    words2 = 14 if pre == "g1" else 28
    pack = _g1_pack if pre == "g1" else _g2_pack
    unpack = _g1_unpack if pre == "g1" else _g2_unpack
    base = pack([cls.GEN])
    ks = _pack_scalars(scalars)
    n = len(scalars)
    out = np.zeros((n, words2), dtype=np.uint64)
    inf = np.zeros(n, dtype=np.uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    getattr(lib, f"{pre}_fixed_powers")(
        base.ctypes.data_as(u64p), ks.ctypes.data_as(u64p),
        ctypes.c_longlong(n), ctypes.c_int(window),
        out.ctypes.data_as(u64p), inf.ctypes.data_as(u8p))
    NATIVE_CALLS["fixed_powers"] += 1
    return [cls.zero() if inf[i] else cls(unpack(out[i])) for i in range(n)]


def _native_msm(cls, pts, scalars):
    import ctypes

    import numpy as np

    lib = _native_lib()
    if lib is None:
        return None
    pre = "g1" if cls is G1 else "g2"
    words2 = 14 if pre == "g1" else 28
    pack = _g1_pack if pre == "g1" else _g2_pack
    unpack = _g1_unpack if pre == "g1" else _g2_unpack
    n = len(pts)
    pbuf = pack(pts)
    inf_in = np.array([1 if p is None else 0 for p in pts], dtype=np.uint8)
    ks = _pack_scalars(scalars)
    out = np.zeros(words2, dtype=np.uint64)
    out_inf = np.zeros(1, dtype=np.uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    getattr(lib, f"{pre}_msm")(
        pbuf.ctypes.data_as(u64p), inf_in.ctypes.data_as(u8p),
        ks.ctypes.data_as(u64p), ctypes.c_longlong(n),
        out.ctypes.data_as(u64p), out_inf.ctypes.data_as(u8p))
    NATIVE_CALLS["msm"] += 1
    return cls.zero() if out_inf[0] else cls(unpack(out))


def _native_in_subgroup(cls, pt):
    """r * P == O for an on-curve affine point on the native library (its
    MSM of the one point by the unreduced group order r, the product the
    Python check forms), or None without the library."""
    import ctypes

    import numpy as np

    lib = _native_lib()
    if lib is None or pt is None:
        return None
    pre = "g1" if cls is G1 else "g2"
    pbuf = (_g1_pack if pre == "g1" else _g2_pack)([pt])
    inf_in = np.zeros(1, dtype=np.uint8)
    ks = np.frombuffer(R.to_bytes(40, "little"), dtype=np.uint64).reshape(
        1, 5).copy()
    out = np.zeros(14 if pre == "g1" else 28, dtype=np.uint64)
    out_inf = np.zeros(1, dtype=np.uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    getattr(lib, f"{pre}_msm")(
        pbuf.ctypes.data_as(u64p), inf_in.ctypes.data_as(u8p),
        ks.ctypes.data_as(u64p), ctypes.c_longlong(1),
        out.ctypes.data_as(u64p), out_inf.ctypes.data_as(u8p))
    NATIVE_CALLS["subgroup"] += 1
    return bool(out_inf[0])


def check_subgroup_many(points) -> None:
    """Raise :class:`InvalidPointError` unless every point (G1 or G2, on the
    curve) lies in the prime-order subgroup: ``from_bytes``'s subgroup
    check for a whole list, the native checks spread over threads (ctypes
    releases the GIL; one check runs first on this thread, so the
    library's lazy constants are set before any thread reads them)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    points = [p for p in points if p.pt is not None]
    workers = min(32, os.cpu_count() or 1)
    if not points or _native_lib() is None or workers == 1:
        ok = [p.in_subgroup() for p in points]
    else:
        ok = [points[0].in_subgroup()]
        with ThreadPoolExecutor(workers) as ex:
            ok += list(ex.map(lambda p: p.in_subgroup(), points[1:]))
    for p, good in zip(points, ok):
        if not good:
            raise InvalidPointError(f"{type(p).__name__}: point not in "
                                    "prime-order subgroup")


def fixed_base_powers(cls, alpha: int, count: int, skip=frozenset(),
                      window: int = 8):
    """[alpha^1 * G, ..., alpha^count * G] for the group's generator, via
    a windowed fixed-base table (one build + one batch inversion). The
    CRS power lists are exactly this shape; 1-based indices in ``skip``
    come back as ``cls.zero()`` (the punctured KZG slot)."""
    scalars = []
    cur = alpha % R
    for j in range(1, count + 1):
        scalars.append(0 if j in skip else cur)
        cur = cur * alpha % R
    native = _native_fixed_powers(cls, scalars, window)
    if native is not None:
        return native
    tbl = _FixedBaseTable(cls.GEN, cls.OPS, bits=R.bit_length(),
                          window=window)
    aff = tbl.mul_many(scalars)
    return [cls.zero() if a is None else cls(a) for a in aff]


def group_sum(elements) -> "_GroupElement":
    """Plain sum of group elements with Jacobian accumulation and a single
    final inversion (the affine __add__ inverts per addition)."""
    acc = None
    cls = None
    for e in elements:
        if cls is None:
            cls = type(e)
        if e.pt is not None:
            acc = _jac_add_affine(acc, e.pt, cls.OPS)
    if cls is None:
        raise ValueError("group_sum of an empty sequence")
    if acc is None:
        return cls.zero()
    (aff,) = _jac_to_affine_batch([acc], cls.OPS)
    return cls(aff)


def msm(terms) -> "_GroupElement":
    """sum(k_i * P_i) over (scalar, group-element) pairs via Pippenger.

    All elements must be of one group (G1 or G2). Scalars are reduced
    mod the group order; affine normalization happens once at the end."""
    terms = list(terms)
    cls = None
    pts, ks = [], []
    for k, p in terms:
        if cls is None:
            cls = type(p)
        pts.append(p.pt)
        ks.append(int(k) % R)
    if cls is None:
        raise ValueError("msm of an empty sequence")
    if len(pts) >= 32:  # native pays off past the ctypes/packing overhead
        native = _native_msm(cls, pts, ks)
        if native is not None:
            return native
    ops = cls.OPS
    j = _msm_pippenger(pts, ks, ops, bits=R.bit_length())
    if j is None:
        return cls.zero()
    (aff,) = _jac_to_affine_batch([j], ops)
    return cls(aff)
