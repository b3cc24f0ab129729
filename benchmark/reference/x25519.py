"""Plain X25519 (RFC 7748 sections 5 and 6.1) on Python ints, the
benchmark's yardstick for every shared secret. Written for this benchmark
alone: it imports nothing of the program."""

from __future__ import annotations

P = 2**255 - 19
A24 = 121665                     # (A - 2) / 4 for A = 486662, as RFC 7748 has it

# u-coordinates of the points of order 1, 2, 4 and 8 on the curve and its
# twist (canonical encodings): every clamped scalar is a multiple of 8, so
# each gives the all-zero shared secret that RFC 7748 6.1 and RFC 8446
# 7.4.2 make a peer refuse.
LOW_ORDER_U = (
    0,
    1,
    325606250916557431795983626356110631294008115727848805560023387167927233504,
    39382357235489614581723060781553021112529911719440698176882885853963445705823,
    P - 1,
)


def clamp(scalar: bytes) -> int:
    k = int.from_bytes(scalar, "little")
    return (k & ~7 & ((1 << 255) - 1)) | 1 << 254


def decode_u(u: bytes, mask: bool = True) -> int:
    """RFC 7748 5: the top bit masked, a value >= p taken mod p. ``mask=False``
    keeps the top bit: a decoder that breaks that guarantee."""
    n = int.from_bytes(u, "little")
    if mask:
        n &= (1 << 255) - 1
    return n % P


def ladder(k: int, u: int) -> int:
    """u([k]P) by the RFC 7748 5 Montgomery ladder over 255 bits."""
    x2, z2, x3, z3, swap = 1, 0, u, 1, 0
    for t in range(254, -1, -1):
        kt = (k >> t) & 1
        if swap ^ kt:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = kt
        a, b = x2 + z2, x2 - z2
        aa, bb = a * a % P, b * b % P
        e = aa - bb
        c, d = x3 + z3, x3 - z3
        da, cb = d * a % P, c * b % P
        x3, z3 = (da + cb) ** 2 % P, u * (da - cb) ** 2 % P
        x2, z2 = aa * bb % P, e * (aa + A24 * e) % P
    if swap:
        x2, z2 = x3, z3
    return x2 * pow(z2, P - 2, P) % P


def x25519(scalar: bytes, u: bytes, mask: bool = True) -> bytes:
    return ladder(clamp(scalar), decode_u(u, mask)).to_bytes(32, "little")


def public_key(scalar: bytes) -> bytes:
    return x25519(scalar, (9).to_bytes(32, "little"))
