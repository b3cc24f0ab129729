"""Textbook Ed25519 (RFC 8032 PureEdDSA), X25519/X448 (RFC 7748) and
short-Weierstrass arithmetic with SEC1 point compression, on Python ints
and hashlib.

An independent signer, verifier, Diffie-Hellman and curve for making and
checking test vectors; it shares no code with the batched engines."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, -1, P)) % P

_t = (4 * pow(5, -1, P)) % P  # gy = 4/5
_xx = (_t * _t - 1) * pow(D * _t * _t + 1, -1, P) % P
_gx = pow(_xx, (P + 3) // 8, P)
if (_gx * _gx - _xx) % P:
    _gx = _gx * pow(2, (P - 1) // 4, P) % P
if _gx % 2:
    _gx = P - _gx
G = (_gx, _t)


def _add(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    dxy = D * x1 * x2 * y1 * y2 % P
    x3 = (x1 * y2 + y1 * x2) * pow(1 + dxy, -1, P) % P
    y3 = (y1 * y2 + x1 * x2) * pow(1 - dxy, -1, P) % P
    return x3, y3


def _mul(k, pt):
    acc = (0, 1)
    while k:
        if k & 1:
            acc = _add(acc, pt)
        pt = _add(pt, pt)
        k >>= 1
    return acc


def _compress(pt) -> bytes:
    x, y = pt
    b = bytearray(y.to_bytes(32, "little"))
    if x & 1:
        b[31] |= 0x80
    return bytes(b)


def _decompress(b: bytes):
    y = int.from_bytes(b, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, -1, P) % P
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * pow(2, (P - 1) // 4, P) % P
        if (x * x - x2) % P:
            return None
    if x & 1 != sign:
        x = P - x
    if x == 0 and sign:
        return None
    return (x, y)


def _h(data: bytes) -> int:
    return int.from_bytes(hashlib.sha512(data).digest(), "little")


def _expand(sk: bytes):
    h = hashlib.sha512(sk).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_key(sk: bytes) -> bytes:
    a, _ = _expand(sk)
    return _compress(_mul(a, G))


def sign(sk: bytes, msg: bytes) -> bytes:
    a, prefix = _expand(sk)
    A = _compress(_mul(a, G))
    r = _h(prefix + msg) % L
    R = _compress(_mul(r, G))
    k = _h(R + A + msg) % L
    s = (r + k * a) % L
    return R + s.to_bytes(32, "little")


def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    if len(sig) != 64:
        return False
    A = _decompress(pk)
    R = _decompress(sig[:32])
    if A is None or R is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = _h(sig[:32] + pk + msg) % L
    return _mul(s, G) == _add(R, _mul(k, A))


# ---------------------------------------------------------------------------
# RFC 7748
# ---------------------------------------------------------------------------

P448 = 2**448 - 2**224 - 1


def _ladder(p: int, a24: int, u: int, k: int, n_bits: int) -> int:
    """RFC 7748 section 5 ladder (a24 = (A - 2) / 4 as the RFC has it)."""
    x2, z2, x3, z3, swap = 1, 0, u, 1, 0
    for t in range(n_bits - 1, -1, -1):
        kt = (k >> t) & 1
        if swap ^ kt:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = kt
        a, b = x2 + z2, x2 - z2
        aa, bb = a * a % p, b * b % p
        e = aa - bb
        c, d = x3 + z3, x3 - z3
        da, cb = d * a % p, c * b % p
        x3, z3 = (da + cb) ** 2 % p, u * (da - cb) ** 2 % p
        x2, z2 = aa * bb % p, e * (aa + a24 * e) % p
    if swap:
        x2, z2 = x3, z3
    return x2 * pow(z2, p - 2, p) % p


def x25519(scalar: bytes, u: bytes) -> bytes:
    k = int.from_bytes(scalar, "little")
    k = (k & ~7 & ((1 << 255) - 1)) | 1 << 254
    uu = (int.from_bytes(u, "little") & ((1 << 255) - 1)) % P
    return _ladder(P, 121665, uu, k, 255).to_bytes(32, "little")


def x448(scalar: bytes, u: bytes) -> bytes:
    k = int.from_bytes(scalar, "little")
    k = (k & ~3) | 1 << 447
    uu = int.from_bytes(u, "little") % P448
    return _ladder(P448, 39081, uu, k, 448).to_bytes(56, "little")


# ---------------------------------------------------------------------------
# short Weierstrass y^2 = x^3 + a x + b; points: None = infinity, else (x, y)
# (the JAX package's oracle/curve.py WCurve), and SEC1 compression
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WCurve:
    p: int
    a: int
    b: int
    gx: int
    gy: int
    order: int

    def on_curve(self, pt):
        if pt is None:
            return True
        x, y = pt
        return (y * y - (x * x * x + self.a * x + self.b)) % self.p == 0

    def add(self, p1, p2):
        p = self.p
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            lam = (3 * x1 * x1 + self.a) * pow(2 * y1, -1, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (lam * lam - x1 - x2) % p
        y3 = (lam * (x1 - x3) - y1) % p
        return (x3, y3)

    def mul(self, k, pt):
        acc = None
        while k:
            if k & 1:
                acc = self.add(acc, pt)
            pt = self.add(pt, pt)
            k >>= 1
        return acc

    def mul_base(self, k):
        return self.mul(k, (self.gx, self.gy))

    @property
    def n_bytes(self) -> int:
        return (self.p.bit_length() + 7) // 8

    def compress(self, pt) -> bytes:
        """SEC1 compressed form: 0x02 | 0x03 (parity of y), then x big-endian."""
        x, y = pt
        return bytes([2 + (y & 1)]) + x.to_bytes(self.n_bytes, "big")

    def decompress(self, by: bytes):
        """The point of a SEC1 compressed encoding, or None where the tag is
        not 2 or 3, x >= p, or x is not the abscissa of a point."""
        if len(by) != 1 + self.n_bytes or by[0] not in (2, 3):
            return None
        x = int.from_bytes(by[1:], "big")
        if x >= self.p:
            return None
        rhs = (x * x * x + self.a * x + self.b) % self.p
        y = _sqrt_mod(rhs, self.p)
        if y is None:
            return None
        if y & 1 != by[0] & 1:
            y = (self.p - y) % self.p
        return (x, y)


def _sqrt_mod(v: int, p: int):
    """A square root of v mod an odd prime p (textbook Tonelli-Shanks), or
    None for a non-square."""
    v %= p
    if v == 0:
        return 0
    if pow(v, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0
    while q % 2 == 0:
        q, s = q // 2, s + 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(v, q, p), pow(v, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2, i = t2 * t2 % p, i + 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


def sec2_curve(name: str) -> WCurve:
    """The oracle curve of a SEC2 curve by name (``params/sec2_params.py``)."""
    from .params.sec2_params import CURVES

    c = CURVES[name]
    return WCurve(c["p"], c["a"] % c["p"], c["b"] % c["p"], c["gx"], c["gy"], c["order"])
