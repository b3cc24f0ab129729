"""Curve448: FQ448 = GF(2^448 - 2^224 - 1) and the X448 Montgomery ladder.

Counterpart of the JAX package's ``curves/curve448.py``: like it, no Edwards
group and no scalar field, only what X448 needs.
"""

from __future__ import annotations

import torch

from ..field448 import FQ448, P
from .montgomery import MontgomeryCurveSpec, ladder

FQ = FQ448

# y^2 = x^3 + 156326 x^2 + x, base u = 5, a24 = 39082
MONT = MontgomeryCurveSpec(
    name="curve448", field=FQ, A=156326, B=1, base_u=5, n_bits=448)
assert MONT.a24 == 39082


def decode_u(by: torch.Tensor) -> torch.Tensor:
    """RFC 7748 u decode for X448: all 56 bytes, reduced mod p. A u in
    [p, 2^448) is never rejected: its strict limbs are a TIGHT
    representative of u mod p."""
    u, _ = FQ.from_bytes_le(by)
    return u


def x448_ladder(u_limbs, k_bits):
    return ladder(MONT, u_limbs, k_bits)
