"""Twisted Edwards arithmetic on Python ints, affine with one inverse per
addition. Used only to generate tables; it shares no code with the batched
group law it feeds."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ECurve:
    """a x^2 + y^2 = 1 + d x^2 y^2 over GF(p); points are affine (x, y)."""

    p: int
    a: int
    d: int
    gx: int
    gy: int
    order: int

    def on_curve(self, pt):
        x, y = pt
        return (self.a * x * x + y * y) % self.p == (1 + self.d * x * x * y * y) % self.p

    def add(self, p1, p2):
        p = self.p
        x1, y1 = p1
        x2, y2 = p2
        dxy = self.d * x1 * x2 * y1 * y2 % p
        x3 = (x1 * y2 + y1 * x2) * pow(1 + dxy, -1, p) % p
        y3 = (y1 * y2 - self.a * x1 * x2) * pow(1 - dxy, -1, p) % p
        return (x3, y3)

    def mul(self, k, pt):
        acc = (0, 1)
        while k:
            if k & 1:
                acc = self.add(acc, pt)
            pt = self.add(pt, pt)
            k >>= 1
        return acc

    def mul_base(self, k):
        return self.mul(k, (self.gx, self.gy))
