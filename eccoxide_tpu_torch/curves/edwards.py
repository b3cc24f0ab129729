"""Twisted Edwards group (a = -1) in extended coordinates, batched.

Counterpart of the JAX package's ``curves/edwards.py`` for edwards25519. A
point is one packed int32 tensor ``(4, 10, *batch)`` (X|Y|Z|T over FQ).
Every addition and doubling goes through the wrappers of ``ops/group.py``:
the CUDA kernels on a CUDA tensor, their plain versions on a CPU tensor.

Secret-dependent work (``scalar_mul``, ``compress`` of a secret point) is
constant-time in the data: lookups by a secret digit are masked sums over
the whole table, selects are ``torch.where``, and no branch, index or
shape depends on a limb value.
"""

from __future__ import annotations

import torch

from ..limbs import ct_lookup
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
    def coords(self):
        """The packed tensor under the name every point class of the port
        shares (``ProjPoint.coords``), for code generic over the group."""
        return self.xyzt

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

    def generator(self, batch, device) -> ExtPoint:
        f = self.field
        gx, gy = f.const(self.gx, batch, device), f.const(self.gy, batch, device)
        return ExtPoint(torch.stack([gx, gy, f.one(batch, device), f.mul(gx, gy)]))

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

    def on_curve(self, p: ExtPoint):
        """(-X^2 + Y^2) Z^2 == Z^4 + d X^2 Y^2 and T Z == X Y."""
        f = self.field
        x2, y2, z2 = f.square(p.x), f.square(p.y), f.square(p.z)
        lhs = f.mul(f.sub(y2, x2), z2)
        d = f.const(self.d, x2.shape[1:], x2.device)
        rhs = f.add(f.square(z2), f.mul(d, f.mul(x2, y2)))
        return f.eq(lhs, rhs) & f.eq(f.mul(p.t, p.z), f.mul(p.x, p.y))

    def to_affine(self, p: ExtPoint):
        """(x, y) = (X/Z, Y/Z), one inverse (a launch of the pow kernel on
        the card); (0, 0) for Z = 0, which no valid point has."""
        f = self.field
        zi = f.inverse(p.z)
        return f.mul(p.x, zi), f.mul(p.y, zi)

    def compress(self, p: ExtPoint):
        """(32, *batch) bytes: canonical y, sgn0(x) in bit 255."""
        f = self.field
        ax, ay = self.to_affine(p)
        by = f.to_bytes_le(ay)
        top = by[-1] | (f.sgn0(ax) << 7)
        return torch.cat([by[:-1], top[None]])

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

    @staticmethod
    def _ct_lookup(table: torch.Tensor, idx: torch.Tensor, ids=None) -> ExtPoint:
        """table[idx] for a secret (*batch,) digit of an (entries, 4, 10,
        *batch) table: the masked sum of ``limbs.ct_lookup``, never a
        gather."""
        return ExtPoint(ct_lookup(table, idx, ids))

    def scalar_mul(self, p: ExtPoint, windows: torch.Tensor) -> ExtPoint:
        """[k]p in constant time for (64, *batch) 4-bit digits of k, most
        significant first: per digit one run of 4 doublings (one launch), a
        masked lookup of [0]p .. [15]p, one full addition."""
        table = self.window_table(p, 4)
        ids = torch.arange(table.shape[0], device=table.device)
        acc = self.identity(p.xyzt.shape[2:], p.xyzt.device)
        for dig in windows:
            acc = self.double(acc, k=4)
            acc = self.add(acc, self._ct_lookup(table, dig, ids))
        return acc
