"""Curve25519 constants, the edwards25519 group and the X25519 ladder of
the port. Counterpart of the JAX package's ``curves/curve25519.py``.
"""

from __future__ import annotations

import torch

from ..field import FL, FQ, L, P, SQRT_M1
from .edwards import EdwardsCurve
from .montgomery import MontgomeryCurveSpec, ladder

__all__ = ["P", "L", "D", "ED_GX", "ED_GY", "FQ", "FL", "EDWARDS", "MONT",
           "MAP_C", "SQRT_M1", "decode_u", "x25519_ladder"]

# Montgomery form: y^2 = x^3 + 486662 x^2 + x, base u = 9
MONT = MontgomeryCurveSpec(
    name="curve25519", field=FQ, A=486662, B=1, base_u=9, n_bits=255)

# Edwards form: -x^2 + y^2 = 1 + d x^2 y^2, d = -121665/121666, base point
# (x, 4/5) with the even x
D = (-121665 * pow(121666, -1, P)) % P
ED_GY = (4 * pow(5, -1, P)) % P
_t = (ED_GY * ED_GY - 1) * pow(D * ED_GY * ED_GY + 1, -1, P) % P
_gx = pow(_t, (P + 3) // 8, P)
if (_gx * _gx - _t) % P != 0:
    _gx = _gx * pow(2, (P - 1) // 4, P) % P
if _gx % 2 == 1:
    _gx = P - _gx
ED_GX = _gx

EDWARDS = EdwardsCurve(
    name="edwards25519", field=FQ, scalar=FL, d=D, gx=ED_GX, gy=ED_GY,
    cofactor=8,
)

# birational map constant c = sqrt(-(A + 2)) = sqrt(-486664), even root
_c = pow(-486664 % P, (P + 3) // 8, P)
if (_c * _c + 486664) % P != 0:
    _c = _c * SQRT_M1 % P
if _c % 2 == 1:
    _c = P - _c
MAP_C = _c


def decode_u(by: torch.Tensor) -> torch.Tensor:
    """RFC 7748 u decode for X25519: (32, *batch) bytes, bit 255 masked,
    reduced mod p. A u in [p, 2^255) is never rejected: its strict limbs
    are a TIGHT representative of u mod p."""
    by = torch.cat([by[:31], (by[31] & 0x7F)[None]])
    u, _ = FQ.from_bytes_le(by)
    return u


def x25519_ladder(u_limbs, k_bits):
    return ladder(MONT, u_limbs, k_bits)
