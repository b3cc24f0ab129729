"""Twisted Edwards group (a = -1) in extended coordinates, batched.

Counterpart of the JAX package's ``curves/edwards.py`` for edwards25519. A
point is one packed int32 tensor ``(4, 10, *batch)`` (X|Y|Z|T over FQ).
Every addition and doubling goes through the wrappers of ``ops/group.py``:
the CUDA kernels on a CUDA tensor, their plain versions on a CPU tensor.
"""

from __future__ import annotations

import torch

from ..ops import group


class ExtPoint:
    """Extended coordinates (X:Y:Z:T), T = XY/Z, packed as ``xyzt``.

    ``has_t`` is False for a point made with ``need_t=False``: its T is not
    the point's T (an addition or a doubling leaves zeros, on the card and
    on the CPU alike), and ``with_t()`` refuses it, so an addition can never
    consume it. Doubling and equality read no T."""

    __slots__ = ("xyzt", "has_t")

    def __init__(self, xyzt: torch.Tensor, has_t: bool = True):
        self.xyzt = xyzt
        self.has_t = has_t

    @property
    def x(self):
        return self.xyzt[0]

    @property
    def y(self):
        return self.xyzt[1]

    @property
    def z(self):
        return self.xyzt[2]

    @property
    def t(self):
        return self.with_t()[3]

    def with_t(self) -> torch.Tensor:
        if not self.has_t:
            raise ValueError("T of a need_t=False point consumed")
        return self.xyzt


class EdwardsCurve:
    """-x^2 + y^2 = 1 + d x^2 y^2 over ``field``."""

    def __init__(self, name, field, scalar, d, gx, gy, cofactor):
        self.name = name
        self.field = field
        self.scalar = scalar
        self.d = d
        self.gx = gx
        self.gy = gy
        self.cofactor = cofactor

    def identity(self, batch, device) -> ExtPoint:
        f = self.field
        zero, one = f.zero(batch, device), f.one(batch, device)
        return ExtPoint(torch.stack([zero, one, one, zero]))

    def add(self, p: ExtPoint, q: ExtPoint, need_t: bool = True) -> ExtPoint:
        return ExtPoint(group.ed_add(p.with_t(), q.with_t(), need_t), need_t)

    def add_mixed(self, p: ExtPoint, q_xyt: torch.Tensor) -> ExtPoint:
        """p + q for an affine q packed as (3, 10, *batch) = x|y|t (Z2 = 1,
        t = xy): one launch of the add kernel in its mixed mode."""
        return ExtPoint(group.ed_add_mixed(p.with_t(), q_xyt))

    def double(self, p: ExtPoint, need_t: bool = True, k: int = 1) -> ExtPoint:
        """[2^k]p in one kernel launch on the card; T as need_t says."""
        return ExtPoint(group.ed_double(p.xyzt, need_t, k), need_t)

    def neg(self, p: ExtPoint) -> ExtPoint:
        f = self.field
        x, y, z, t = p.xyzt.unbind(0)
        return ExtPoint(torch.stack([f.neg(x), y, z, f.neg(t)]), p.has_t)

    def select(self, mask, p: ExtPoint, q: ExtPoint) -> ExtPoint:
        return ExtPoint(torch.where(mask[None, None], p.xyzt, q.xyzt),
                        p.has_t and q.has_t)

    def eq(self, p: ExtPoint, q: ExtPoint):
        """Projective equality by cross-multiplication."""
        f = self.field
        ex = f.eq(f.mul(p.x, q.z), f.mul(q.x, p.z))
        ey = f.eq(f.mul(p.y, q.z), f.mul(q.y, p.z))
        return ex & ey

    def decompress(self, by):
        """(32, *batch) bytes -> (ExtPoint, valid). Rejects a non-canonical
        y, a non-square x^2, and x = 0 with the sign bit set."""
        f = self.field
        sign = (by[31] >> 7) & 1
        by = torch.cat([by[:31], (by[31] & 0x7F)[None]])
        y, valid = f.from_bytes_le(by)
        batch = y.shape[1:]
        one = f.one(batch, y.device)
        y2 = f.square(y)
        u = f.sub(y2, one)
        v = f.add(f.mul(f.const(self.d, batch, y.device), y2), one)
        x, is_sq = f.sqrt_ratio(u, v)
        valid = valid & is_sq
        x = f.select(f.sgn0(x) == sign, x, f.neg(x))
        valid = valid & ~(f.is_zero(x) & (sign == 1))
        return ExtPoint(torch.stack([x, y, one, f.mul(x, y)])), valid

    def window_table(self, p: ExtPoint, w: int = 4) -> torch.Tensor:
        """[0]P .. [2^w - 1]P as int32 (2^w, 4, 10, *batch)."""
        tab = [self.identity(p.xyzt.shape[2:], p.xyzt.device), p]
        for _ in range(2, 1 << w):
            tab.append(self.add(tab[-1], p))
        return torch.stack([e.with_t() for e in tab])
