"""Textbook Ed25519 (RFC 8032 PureEdDSA) and X25519/X448 (RFC 7748) on
Python ints and hashlib.

An independent signer, verifier and Diffie-Hellman for making and checking
test vectors; it shares no code with the batched engines."""

from __future__ import annotations

import hashlib

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
