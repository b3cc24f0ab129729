"""x-only Montgomery-curve ladder, batched, generic over the field.

Counterpart of the JAX package's ``curves/montgomery.py``: ``n_bits`` steps
of the RFC 7748 differential add-and-double in plain torch on the field's
operations (the JAX package also runs it outside any Pallas kernel), the
conditional swap as a masked select of both coordinate pairs, then one
inverse: a launch of the pow kernel of the field on the card. X25519 (FQ)
and X448 (FQ448) share it.

Constant time: the scalar's bits reach the arithmetic only as the masks of
``torch.where``; the sequence of operations and shapes is the same for
every scalar and every u.

Spans (``spans.py``, off by default): ``montgomery.steps`` around the
steps' issue and the final swap (fields ``lanes``, ``steps`` and
``curve``, the spec's name), ``montgomery.inverse`` around the inverse and
the product that ends the ladder.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..spans import span


@dataclass(frozen=True, eq=False)
class MontgomeryCurveSpec:
    """B y^2 = x^3 + A x^2 + x over ``field``."""

    name: str
    field: object
    A: int
    B: int
    base_u: int
    n_bits: int          # scalar bits the ladder processes

    @property
    def a24(self) -> int:
        return (self.A + 2) // 4


def ladder(spec: MontgomeryCurveSpec, u: torch.Tensor, k_bits: torch.Tensor):
    """u-coordinate of [k]P for u (n, *batch) field limbs and k_bits
    (n_bits, *batch) of 0/1 (bit i the coefficient of 2^i). Returns x2 / z2,
    which is 0 where z2 = 0 (the inverse of 0 is 0), so a low-order u gives
    0."""
    f = spec.field
    batch, dev = u.shape[1:], u.device
    x2, z2 = f.one(batch, dev), f.zero(batch, dev)
    x3, z3 = u, f.one(batch, dev)
    swap = torch.zeros(batch, dtype=torch.bool, device=dev)
    with span("montgomery.steps") as s:
        s.set(lanes=swap.numel(), steps=spec.n_bits, curve=spec.name)
        for i in range(spec.n_bits - 1, -1, -1):
            kt = k_bits[i] != 0
            m = swap ^ kt
            x2, x3 = f.select(m, x3, x2), f.select(m, x2, x3)
            z2, z3 = f.select(m, z3, z2), f.select(m, z2, z3)
            swap = kt
            a = f.add(x2, z2)
            aa = f.square(a)
            b = f.sub(x2, z2)
            bb = f.square(b)
            e = f.sub(aa, bb)
            c = f.add(x3, z3)
            d = f.sub(x3, z3)
            da = f.mul(d, a)
            cb = f.mul(c, b)
            x3 = f.square(f.add(da, cb))
            z3 = f.mul(u, f.square(f.sub(da, cb)))
            x2 = f.mul(aa, bb)
            # a24 = (A + 2) / 4: z2 = E (BB + a24 E)
            z2 = f.mul(e, f.add(bb, f.mul_small(e, spec.a24)))
        x2 = f.select(swap, x3, x2)
        z2 = f.select(swap, z3, z2)
    with span("montgomery.inverse"):
        return f.mul(x2, f.inverse(z2))
