"""Plain Ed25519 (RFC 8032 PureEdDSA) on Python ints and hashlib: key
generation, signing and the cofactorless verifier, the benchmark's
yardstick for every Ed25519 verdict.

Written for this benchmark alone: it imports nothing of the program. Points
are extended twisted-Edwards coordinates (X, Y, Z, T) with x = X/Z,
y = Y/Z, xy = T/Z; the fixed base goes through a comb of [j 16^i]B.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, -1, P) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

IDENTITY = (0, 1, 1, 0)


def _recover_x(y: int, sign: int):
    """x with x^2 = (y^2 - 1) / (d y^2 + 1) and x mod 2 = sign, or None
    (no square root, or x = 0 with the sign bit set: RFC 8032 5.1.3 step 4)."""
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = u * pow(v, P - 2, P) % P
    r = pow(x, (P + 3) // 8, P)
    if (r * r - x) % P:
        r = r * SQRT_M1 % P
        if (r * r - x) % P:
            return None
    if r == 0 and sign:
        return None
    if r & 1 != sign:
        r = P - r
    return r


_BY = 4 * pow(5, P - 2, P) % P
_BX = _recover_x(_BY, 0)
BASE = (_BX, _BY, 1, _BX * _BY % P)


def add(p, q):
    """p + q (add-2008-hwcd-3, a = -1): complete on the whole group."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def double(p):
    """2p (dbl-2008-hwcd, a = -1)."""
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = a + b
    e = h - (x1 + y1) * (x1 + y1)
    g = a - b
    f = c + g
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def neg(p):
    x, y, z, t = p
    return (-x % P, y, z, -t % P)


def equal(p, q) -> bool:
    return (p[0] * q[2] - q[0] * p[2]) % P == 0 and (p[1] * q[2] - q[1] * p[2]) % P == 0


def mul(k: int, p):
    """[k]p for k >= 0, 4-bit windows, most significant first."""
    table = [IDENTITY, p]
    for _ in range(14):
        table.append(add(table[-1], p))
    acc = IDENTITY
    for shift in range(4 * ((k.bit_length() + 3) // 4) - 4, -1, -4):
        for _ in range(4):
            acc = double(acc)
        acc = add(acc, table[(k >> shift) & 15])
    return acc


def _comb():
    rows, base = [], BASE
    for _ in range(64):
        row, q = [IDENTITY], base
        for _ in range(15):
            row.append(q)
            q = add(q, base)
        rows.append(row)
        base = q                                   # 16^(i+1) B
    return rows


_COMB = _comb()


def mul_base(k: int):
    """[k]B for 0 <= k < 2^256 through the comb (64 additions)."""
    acc = IDENTITY
    for i in range(64):
        acc = add(acc, _COMB[i][(k >> (4 * i)) & 15])
    return acc


def compress(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | (x & 1) << 255).to_bytes(32, "little")


def decompress(b: bytes):
    """The point of a 32-byte encoding, or None where RFC 8032 5.1.3 refuses
    it: y >= p (non-canonical), no square root, or x = 0 with the sign bit."""
    if len(b) != 32:
        return None
    n = int.from_bytes(b, "little")
    y, sign = n & ((1 << 255) - 1), n >> 255
    if y >= P:
        return None
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def _h(data: bytes) -> int:
    return int.from_bytes(hashlib.sha512(data).digest(), "little")


def expand(sk: bytes):
    """(clamped secret scalar a, prefix) of a 32-byte secret key."""
    h = hashlib.sha512(sk).digest()
    a = int.from_bytes(h[:32], "little")
    a = (a & ((1 << 254) - 8)) | 1 << 254
    return a, h[32:]


def public_key(sk: bytes) -> bytes:
    return compress(mul_base(expand(sk)[0]))


def sign(sk: bytes, msg: bytes, pk: bytes | None = None) -> bytes:
    a, prefix = expand(sk)
    pk = compress(mul_base(a)) if pk is None else pk
    r = _h(prefix + msg) % L
    R = compress(mul_base(r))
    k = _h(R + pk + msg) % L
    return R + ((r + k * a) % L).to_bytes(32, "little")


def verify(pk: bytes, msg: bytes, sig: bytes, check_s: bool = True) -> bool:
    """RFC 8032 5.1.7, cofactorless: A and R decode canonically, S < l, and
    [S]B = R + [k]A. ``check_s=False`` drops the S < l check (S is then
    taken mod l): a verifier that breaks the canonical-S guarantee."""
    if len(sig) != 64:
        return False
    A, R = decompress(pk), decompress(sig[:32])
    if A is None or R is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        if check_s:
            return False
        s %= L
    k = _h(sig[:32] + pk + msg) % L
    return equal(add(mul_base(s), neg(mul(k, A))), R)
