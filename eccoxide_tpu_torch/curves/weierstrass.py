"""Short-Weierstrass groups in homogeneous projective coordinates, batched.

Counterpart of the JAX package's ``curves/weierstrass.py:32-466``: the
complete Renes-Costello-Batina 2015 (RCB15) addition and doubling in its
three shapes (generic a: Algorithms 1 and 3; a = 0: Algorithms 7 and 9;
a = -3: Algorithms 4 and 6), constant-time fixed-window scalar
multiplication, the comb fixed-base path (``params/comb.py``) and SEC1
point compression. The formulas are complete: the identity, equal and
opposite inputs take no branch, which is what a batch wants.

A point is one packed int32 tensor ``(3, n, *batch)`` (X|Y|Z over the
curve's ``field_sec2.Field``, limbs in the port's 28-bit format). The
point arithmetic is plain torch on the card, as the JAX package runs it as
plain XLA outside any Pallas kernel; the field's inverse and square root
are one launch each of the SEC2 pow kernel. Independent products of a
formula go through one field multiplication over a stacked axis
(``_batched``), so a complete addition is three or four multiplications'
worth of torch launches, not twelve to fifteen.

Constant time: ``scalar_mul`` looks up its table by a masked sum over all
16 entries (never a gather by a secret digit), selects are
``torch.where``, and no branch, index or shape depends on a limb value.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..field import _Consts
from ..field_sec2 import Field
from ..limbs import ct_lookup


def _batched(op, *pairs):
    """op(a, b) for independent pairs, in one call over a stacked axis 1
    (after the limbs); returns the results in order."""
    if len(pairs) == 1:
        return (op(*pairs[0]),)
    shape = torch.broadcast_shapes(*(t.shape for pr in pairs for t in pr))
    xs = torch.stack([a.expand(shape) for a, _ in pairs], 1)
    ys = torch.stack([b.expand(shape) for _, b in pairs], 1)
    return op(xs, ys).unbind(1)


class ProjPoint:
    """(X : Y : Z), packed as ``xyz`` (3, n, *batch); the identity has Z = 0.
    ``coords`` is the packed tensor under the name every point class of the
    port shares (``ExtPoint.coords``), for code generic over the group."""

    __slots__ = ("xyz",)

    def __init__(self, xyz: torch.Tensor):
        self.xyz = xyz

    @property
    def coords(self):
        return self.xyz

    @property
    def x(self):
        return self.xyz[0]

    @property
    def y(self):
        return self.xyz[1]

    @property
    def z(self):
        return self.xyz[2]

    @property
    def batch(self):
        return self.xyz.shape[2:]


@dataclass(frozen=True, eq=False)
class WeierstrassCurveSpec:
    """y^2 = x^3 + a x + b over ``field`` (JAX weierstrass.py:36-59);
    ``scalar`` is the field of the group order."""

    name: str
    field: Field
    scalar: Field
    a: int
    b_coeff: int
    gx: int
    gy: int
    shape: str  # "generic" | "a0" | "am3"

    def __post_init__(self):
        p = self.field.p
        assert self.shape in ("generic", "a0", "am3")
        if self.shape == "a0":
            assert self.a % p == 0
        if self.shape == "am3":
            assert self.a % p == p - 3
        f = self.field

        def build(dev):
            def col(v):
                return f.const(v, (1,), dev)
            return {"a": col(self.a), "b": col(self.b_coeff), "b3": col(3 * self.b_coeff)}

        object.__setattr__(self, "_k", _Consts(build))

    # -- constants -----------------------------------------------------------

    def _c(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """The constant a, b or 3b as (n, 1, ..., 1) against a field batch."""
        t = self._k.get(like.device)[name]
        return t.view((t.shape[0],) + (1,) * (like.dim() - 1))

    def identity(self, batch, device="cuda") -> ProjPoint:
        f = self.field
        zero, one = f.zero(batch, device), f.one(batch, device)
        return ProjPoint(torch.stack([zero, one, zero]))

    def generator(self, batch, device="cuda") -> ProjPoint:
        f = self.field
        return ProjPoint(torch.stack([f.const(self.gx, batch, device),
                                      f.const(self.gy, batch, device),
                                      f.one(batch, device)]))

    def from_affine(self, x, y) -> ProjPoint:
        return ProjPoint(torch.stack([x, y, self.field.one(x.shape[1:], x.device)]))

    # -- complete group law --------------------------------------------------

    def add(self, P: ProjPoint, Q: ProjPoint) -> ProjPoint:
        if self.shape == "a0":
            return self._add_a0(P, Q)
        if self.shape == "am3":
            return self._add_am3(P, Q)
        return self._add_generic(P, Q)

    def double(self, P: ProjPoint, k: int = 1) -> ProjPoint:
        """[2^k]P by k doublings (the signature of ``EdwardsCurve.double``,
        whose run of k is one kernel launch; here each is plain torch)."""
        dbl = {"a0": self._dbl_a0, "am3": self._dbl_am3}.get(self.shape, self._dbl_generic)
        for _ in range(k):
            P = dbl(P)
        return P

    def _add_common(self, P, Q):
        """The first steps of Algorithms 1, 4 and 7: t0 = X1 X2, t1 = Y1 Y2,
        t2 = Z1 Z2 and the three cross sums (X1+Y1)(X2+Y2) - t0 - t1,
        (Y1+Z1)(Y2+Z2) - t1 - t2, (X1+Z1)(X2+Z2) - t0 - t2."""
        f = self.field
        X1, Y1, Z1 = P.xyz
        X2, Y2, Z2 = Q.xyz
        s = _batched(f.add, (X1, Y1), (X2, Y2), (Y1, Z1), (Y2, Z2), (X1, Z1), (X2, Z2))
        t0, t1, t2, mxy, myz, mxz = _batched(
            f.mul, (X1, X2), (Y1, Y2), (Z1, Z2), (s[0], s[1]), (s[2], s[3]), (s[4], s[5]))
        u01, u12, u02 = _batched(f.add, (t0, t1), (t1, t2), (t0, t2))
        cxy, cyz, cxz = _batched(f.sub, (mxy, u01), (myz, u12), (mxz, u02))
        return t0, t1, t2, cxy, cyz, cxz

    def _add_generic(self, P, Q):
        """RCB15 Algorithm 1 (JAX weierstrass.py:109-141)."""
        f = self.field
        t0, t1, t2, t3, t5, t4 = self._add_common(P, Q)
        a, b3 = self._c("a", t0), self._c("b3", t0)
        Z3, X3, t2a, t4b = _batched(f.mul, (a, t4), (b3, t2), (a, t2), (b3, t4))
        Z3 = f.add(X3, Z3)
        X3 = f.sub(t1, Z3)
        Z3 = f.add(t1, Z3)
        t1 = f.add(f.add(f.double(t0), t0), t2a)
        Y3, t2 = _batched(f.mul, (X3, Z3), (a, f.sub(t0, t2a)))
        t4b = f.add(t4b, t2)
        m1, m2, m3, m4, m5 = _batched(f.mul, (t1, t4b), (t3, X3), (t5, t4b), (t5, Z3), (t3, t1))
        return ProjPoint(torch.stack([f.sub(m2, m3), f.add(Y3, m1), f.add(m4, m5)]))

    def _dbl_generic(self, P):
        """RCB15 Algorithm 3 (JAX weierstrass.py:143-170)."""
        f = self.field
        X, Y, Z = P.xyz
        t0, t1, t2, xy, xz, yz = _batched(f.mul, (X, X), (Y, Y), (Z, Z), (X, Y), (X, Z), (Y, Z))
        t3, Z3, t2b = _batched(f.add, (xy, xy), (xz, xz), (yz, yz))
        a, b3 = self._c("a", t0), self._c("b3", t0)
        X3, b3t2, Z3, t2a = _batched(f.mul, (a, Z3), (b3, t2), (b3, Z3), (a, t2))
        Y3 = f.add(X3, b3t2)
        X3 = f.sub(t1, Y3)
        Y3 = f.add(t1, Y3)
        Y3, X3, au = _batched(f.mul, (X3, Y3), (t3, X3), (a, f.sub(t0, t2a)))
        t3b = f.add(au, Z3)
        Z3b = f.add(f.double(t0), t0)
        t0b, w, v = _batched(f.mul, (f.add(Z3b, t2a), t3b), (t2b, t3b), (t2b, t1))
        return ProjPoint(torch.stack([f.sub(X3, w), f.add(Y3, t0b),
                                      f.double(f.double(v))]))

    def _add_a0(self, P, Q):
        """RCB15 Algorithm 7 (JAX weierstrass.py:172-197)."""
        f = self.field
        t0, t1, t2, t3, t4, Y3 = self._add_common(P, Q)
        b3 = self._c("b3", t0)
        t0 = f.add(f.double(t0), t0)
        t2, Y3 = _batched(f.mul, (b3, t2), (b3, Y3))
        Z3 = f.add(t1, t2)
        t1 = f.sub(t1, t2)
        m1, m2, m3, m4, m5, m6 = _batched(
            f.mul, (t3, t1), (t4, Y3), (t1, Z3), (Y3, t0), (Z3, t4), (t0, t3))
        return ProjPoint(torch.stack([f.sub(m1, m2), f.add(m3, m4), f.add(m5, m6)]))

    def _dbl_a0(self, P):
        """RCB15 Algorithm 9 (JAX weierstrass.py:199-216)."""
        f = self.field
        X, Y, Z = P.xyz
        t0, t1, zz, xy = _batched(f.mul, (Y, Y), (Y, Z), (Z, Z), (X, Y))
        Z3 = f.double(f.double(f.double(t0)))
        t2 = f.mul(self._c("b3", t0), zz)
        X3, Z3 = _batched(f.mul, (t2, Z3), (t1, Z3))
        Y3 = f.add(t0, t2)
        t0 = f.sub(t0, f.add(f.double(t2), t2))
        m1, m2 = _batched(f.mul, (t0, Y3), (t0, xy))
        return ProjPoint(torch.stack([f.double(m2), f.add(X3, m1), Z3]))

    def _add_am3(self, P, Q):
        """RCB15 Algorithm 4 (JAX weierstrass.py:218-255)."""
        f = self.field
        t0, t1, t2, t3, t4, Y3 = self._add_common(P, Q)
        b = self._c("b", t0)
        Z3, bY3 = _batched(f.mul, (b, t2), (b, Y3))
        X3 = f.sub(Y3, Z3)
        X3 = f.add(X3, f.double(X3))
        Z3 = f.sub(t1, X3)
        X3 = f.add(t1, X3)
        t2b = f.add(f.double(t2), t2)
        Y3 = f.sub(f.sub(bY3, t2b), t0)
        Y3 = f.add(f.double(Y3), Y3)
        t0 = f.sub(f.add(f.double(t0), t0), t2b)
        m1, m2, m3, m4, m5, m6 = _batched(
            f.mul, (t4, Y3), (t0, Y3), (X3, Z3), (t3, X3), (t4, Z3), (t3, t0))
        return ProjPoint(torch.stack([f.sub(m4, m1), f.add(m3, m2), f.add(m5, m6)]))

    def _dbl_am3(self, P):
        """RCB15 Algorithm 6 (JAX weierstrass.py:257-289)."""
        f = self.field
        X, Y, Z = P.xyz
        t0, t1, t2, xy, xz, yz = _batched(f.mul, (X, X), (Y, Y), (Z, Z), (X, Y), (X, Z), (Y, Z))
        t3, Z3, t0b = _batched(f.add, (xy, xy), (xz, xz), (yz, yz))
        b = self._c("b", t0)
        bt2, Z3b = _batched(f.mul, (b, t2), (b, Z3))
        Y3 = f.sub(bt2, Z3)
        Y3 = f.add(f.double(Y3), Y3)
        X3 = f.sub(t1, Y3)
        Y3 = f.add(t1, Y3)
        t2b = f.add(t2, f.double(t2))
        Z3 = f.sub(f.sub(Z3b, t2b), t0)
        Z3 = f.add(Z3, f.double(Z3))
        t0 = f.sub(f.add(f.double(t0), t0), t2b)
        m1, m2, m3, m4, m5 = _batched(
            f.mul, (X3, Y3), (X3, t3), (t0, Z3), (t0b, Z3), (t0b, t1))
        return ProjPoint(torch.stack([f.sub(m2, m4), f.add(m3, m1),
                                      f.double(f.double(m5))]))

    # -- point utilities -----------------------------------------------------

    def neg(self, P: ProjPoint) -> ProjPoint:
        return ProjPoint(torch.stack([P.x, self.field.neg(P.y), P.z]))

    def select(self, mask, P: ProjPoint, Q: ProjPoint) -> ProjPoint:
        return ProjPoint(torch.where(mask[None, None], P.xyz, Q.xyz))

    def eq(self, P: ProjPoint, Q: ProjPoint):
        """Projective equality by cross-multiplication (JAX
        weierstrass.py:305-315); two identities compare equal."""
        f = self.field
        l1, r1, l2, r2 = _batched(f.mul, (P.x, Q.z), (Q.x, P.z), (P.y, Q.z), (Q.y, P.z))
        return f.eq(torch.stack([l1, l2], 1), torch.stack([r1, r2], 1)).all(0)

    def is_identity(self, P: ProjPoint):
        return self.field.is_zero(P.z)

    def on_curve(self, P: ProjPoint):
        """y^2 z == x^3 + a x z^2 + b z^3, or the identity."""
        f = self.field
        x2, y2, z2 = _batched(f.mul, (P.x, P.x), (P.y, P.y), (P.z, P.z))
        lhs, x3, xz2, z3 = _batched(f.mul, (y2, P.z), (x2, P.x), (P.x, z2), (z2, P.z))
        ax, bz = _batched(f.mul, (self._c("a", xz2), xz2), (self._c("b", z3), z3))
        rhs = f.add(x3, f.add(ax, bz))
        return f.eq(lhs, rhs) | self.is_identity(P)

    def to_affine(self, P: ProjPoint):
        """(x, y) = (X/Z, Y/Z), one inverse (a launch of the pow kernel on
        the card); (0, 0) for the identity."""
        f = self.field
        zi = f.inverse(P.z)
        return _batched(f.mul, (P.x, zi), (P.y, zi))

    # -- affine arithmetic (JAX weierstrass.py:341-375) ----------------------

    def _rhs(self, x):
        """x^3 + a x + b."""
        f = self.field
        x2 = f.square(x)
        x3, ax = _batched(f.mul, (x2, x), (self._c("a", x), x))
        return f.add(x3, f.add(ax, self._c("b", x)))

    def from_coordinate(self, x, y):
        """(x, y) -> (ProjPoint, mask), the mask False where
        y^2 != x^3 + a x + b."""
        f = self.field
        return self.from_affine(x, y), f.eq(f.square(y), self._rhs(x))

    def affine_double(self, x, y):
        """lambda = (3 x^2 + a) / (2 y); garbage where y = 0."""
        f = self.field
        num = f.add(f.mul_small(f.square(x), 3), self._c("a", x))
        lam = f.mul(num, f.inverse(f.double(y)))
        x3 = f.sub(f.square(lam), f.double(x))
        y3 = f.sub(f.mul(lam, f.sub(x, x3)), y)
        return x3, y3

    def affine_add_different(self, x1, y1, x2, y2):
        """lambda = (y2 - y1) / (x2 - x1); garbage where x1 = x2."""
        f = self.field
        lam = f.mul(f.sub(y2, y1), f.inverse(f.sub(x2, x1)))
        x3 = f.sub(f.sub(f.square(lam), x1), x2)
        y3 = f.sub(f.mul(lam, f.sub(x1, x3)), y1)
        return x3, y3

    # -- scalar multiplication -----------------------------------------------

    def _window_table(self, P: ProjPoint, w: int = 4) -> torch.Tensor:
        """[0]P .. [2^w - 1]P as int32 (2^w, 3, n, *batch)."""
        tab = [self.identity(P.batch, P.xyz.device), P]
        for _ in range(2, 1 << w):
            tab.append(self.add(tab[-1], P))
        return torch.stack([e.xyz for e in tab])

    @staticmethod
    def _ct_lookup(table: torch.Tensor, idx: torch.Tensor, ids=None) -> ProjPoint:
        """table[idx] for a secret (*batch,) digit of an (entries, 3, n,
        *batch) table: the masked sum of ``limbs.ct_lookup``, never a
        gather (JAX weierstrass.py:393-403)."""
        return ProjPoint(ct_lookup(table, idx, ids))

    def scalar_mul(self, P: ProjPoint, windows: torch.Tensor, w: int = 4) -> ProjPoint:
        """[k]P in constant time (JAX weierstrass.py:405-424) for
        (n_windows, *batch) 4-bit digits of k, most significant first
        (``limbs.windows_from_bytes_le`` of k's bytes): per
        digit four doublings, a masked lookup of [0]P .. [15]P, one
        addition."""
        table = self._window_table(P, w)
        ids = torch.arange(table.shape[0], device=table.device)
        acc = self.identity(P.batch, P.xyz.device)
        for dig in windows:
            for _ in range(w):
                acc = self.double(acc)
            acc = self.add(acc, self._ct_lookup(table, dig, ids))
        return acc

    def mul_base(self, scalar_bytes_le: torch.Tensor, tables=None) -> ProjPoint:
        """[k]G by the comb (``params/comb.py``) for (scalar n_bytes,
        *batch) LE scalar bytes; ``tables`` as ``WeierstrassComb.tables``
        gives them, on the scalars' device by default."""
        from ..params.comb import get_weierstrass_comb

        return get_weierstrass_comb(self).mul_base(scalar_bytes_le, tables)

    # -- SEC1 compressed wire format (JAX weierstrass.py:438-466) -------------

    def compress(self, P: ProjPoint) -> torch.Tensor:
        """(1 + n_bytes, *batch) bytes: 0x02 | 0x03 (parity of y), then x
        big-endian."""
        f = self.field
        ax, ay = self.to_affine(P)
        return torch.cat([(f.sgn0(ay) + 2)[None], f.to_bytes_be(ax)])

    def decompress(self, by: torch.Tensor):
        """Inverse of ``compress`` -> (ProjPoint, valid). valid is False
        where x >= p, where x^3 + a x + b is not a square, or where the tag
        is not 2 or 3."""
        f = self.field
        tag = by[0]
        x, okx = f.from_bytes_be(by[1:])
        y, oky = f.sqrt(self._rhs(x))
        y = f.select(f.sgn0(y) == (tag & 1), y, f.neg(y))
        valid = okx & oky & ((tag == 2) | (tag == 3))
        return self.from_affine(x, y), valid

