"""Curve25519 constants and the edwards25519 group of the port.

Counterpart of the constants and specs of
the JAX package's ``curves/curve25519.py`` (no Montgomery ladder yet).
"""

from __future__ import annotations

from ..field import FL, FQ, L, P
from .edwards import EdwardsCurve

__all__ = ["P", "L", "D", "ED_GX", "ED_GY", "FQ", "FL", "EDWARDS"]

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
