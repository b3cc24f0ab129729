"""Batched prime-field arithmetic for FQ = 2^255-19 and FL = l, in PyTorch.

Counterpart of the JAX package's ``field.py`` restricted to the two fields of
edwards25519. Values are int32 tensors ``(n, *batch)`` (see ``limbs.py``);
every operation keeps the batch shape and the device of its inputs.

FQ format: 10 limbs of alternating 26 and 25 bits (radix 2^25.5), the
format of ref10. Limb products are accumulated in int64; the CUDA kernels
(``ops/csrc/fe25519.cuh``) use the same format and the same carry schedule,
so the plain version and the kernels agree limb for limb.

Overflow argument for FQ (all limbs are kept non-negative, so ``>>`` and
``&`` are exact floor division and remainder):

- ``TIGHT`` is the per-limb bound that every public FQ operation returns
  (the output of ``_carry``). It is computed below as the fixed point of
  the bounds that ``add``, ``sub`` and ``mul`` produce from inputs within
  ``TIGHT`` and that ``mul`` produces from two ``LAZY`` operands: limb 1
  may exceed its 25 bits by the carry out of limb 0 after the 19-fold (the
  carry is one ripple, ``CARRY_STEPS``); every other limb is strict.
- ``add_lazy``/``sub_lazy`` skip the carry: ``x + y`` or ``x + PAD - y``
  of TIGHT inputs, limbs within ``LAZY`` (below 2^28), valid only as an
  operand of ``mul`` (the kernels' sums for a product, fe25519.cuh
  ``add_or_sub_lazy``).
- ``mul`` takes limbs <= ``LAZY`` (TIGHT values included), ``square``
  limbs <= ``TIGHT``; a product column is a sum of 10 products with
  factors 1, 2, 19 or 38 (2 for odd*odd limbs, 19 for the wrap past
  2^255), bounded by ``MUL_COL`` < 2^63. The kernels fold the factors into
  32-bit operands (``mul_terms``; ``sq_terms`` for the 55-product square),
  each below 2^32, giving the same columns.
- ``add`` takes limbs <= ``TIGHT``, its sums stay below 2^31 (the kernels
  add in int32).
- ``sub`` computes ``x + PAD - y`` with ``PAD`` the limbs of 2p; every PAD
  limb dominates the TIGHT limb below it, so the difference is
  non-negative limb-wise, and below 2^31.
- ``canon`` takes TIGHT input. TIGHT values are below 2^256, so the first
  ripple's carry out of limb 9 is 0 or 1; folding it (times 19) and
  rippling again gives strict limbs of a value below 2^255, and one
  conditional subtraction of p (via ``v + 19 >= 2^255``) makes it
  canonical.

The module asserts all of this at import, on Python ints.

FL format: 16 limbs of 16 bits in the Montgomery domain with R = 2^256.
FL values are canonical (< l, strict limbs) at every operation boundary.
A Montgomery product of canonical inputs (or of any value < R with a
constant < l) is below 2l before its single conditional subtraction; its
int64 columns stay below 2^38. FL runs no kernel.
"""

from __future__ import annotations

import torch

from .limbs import bytes_to_limbs, int_to_limbs, limbs_to_bytes, offsets

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493

# ---------------------------------------------------------------------------
# FQ format and its overflow argument
# ---------------------------------------------------------------------------

WIDTHS = (26, 25) * 5
OFFS = offsets(WIDTHS)
MASKS = [(1 << w) - 1 for w in WIDTHS]
assert OFFS[-1] + WIDTHS[-1] == 255

_I31 = 1 << 31
_I63 = 1 << 63


def _factor(i: int, j: int) -> int:
    """Multiplier of a_i*b_j in column (i+j) mod 10: 2 when both limbs are
    25-bit (their offsets sum one bit past the column's), 19 on the wrap."""
    return (2 if i % 2 and j % 2 else 1) * (19 if i + j >= 10 else 1)


def mul_col_bounds(xb, yb) -> list[int]:
    """Upper bounds of the 10 product columns for limb bounds xb, yb."""
    cols = [0] * 10
    for i in range(10):
        for j in range(10):
            cols[(i + j) % 10] += _factor(i, j) * xb[i] * yb[j]
    return cols


def mul_terms() -> list[tuple]:
    """The 100 products of fe25519.cuh ``mul`` as (column, i, factor of
    a_i, j, factor of b_j): 2 on a_i for two odd limbs, 19 on b_j on the
    wrap, so each product is one multiply of two premultiplied operands."""
    return [((i + j) % 10, i, 2 if i % 2 and j % 2 else 1,
             j, 19 if i + j >= 10 else 1)
            for i in range(10) for j in range(10)]


def sq_terms() -> list[tuple]:
    """The 55 products a_i a_j (i <= j) of fe25519.cuh ``sq``: 2 on a_i
    for a cross term, the odd-odd 2 and the wrap's 19 on a_j."""
    return [((i + j) % 10, i, 2 if i != j else 1,
             j, (2 if i % 2 and j % 2 else 1) * (19 if i + j >= 10 else 1))
            for i in range(10) for j in range(i, 10)]


def term_columns(terms, xs, ys) -> tuple[list[int], int]:
    """(columns, largest operand) of a product list on limbs xs, ys."""
    cols, top = [0] * 10, 0
    for k, i, fi, j, fj in terms:
        a, b = fi * xs[i], fj * ys[j]
        cols[k] += a * b
        top = max(top, a, b)
    return cols, top


# The carry schedule of ``_carry`` and of fe25519.cuh ``carry``: step i
# moves the bits of limb i above its width into limb i + 1 (into limb 0
# times 19 for i = 9, since 2^255 = 19 mod p). One ripple 0->1 .. 9->0,
# then 0->1 again: 11 steps. ref10's two interleaved chains (0->1 beside
# 4->5, ...) shorten the dependent path to 7 steps but run 12, and on the
# H100 every kernel measured slower with them: the kernels are bound by
# issued instructions, not by the carry's latency (PERF.md).
CARRY_STEPS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 0)


def carry_bounds(h) -> list[int]:
    """Upper bounds after ``_carry`` for non-negative columns bounded by h.
    Mirrors ``_carry`` step by step and asserts no int64 overflow."""
    h = list(h)
    for v in h:
        assert 0 <= v < _I63
    for i in CARRY_STEPS:
        c = h[i] >> WIDTHS[i]
        h[i] = min(h[i], MASKS[i])
        h[(i + 1) % 10] += 19 * c if i == 9 else c
        assert h[(i + 1) % 10] < _I63
    return h


# 2p limb-wise (2^256 - 38 does not fit the 255-bit format, so each limb of
# p is doubled instead of normalizing 2p)
PAD = [2 * v for v in int_to_limbs(P, WIDTHS)]


def lazy_bounds(t) -> list[int]:
    """Limb bounds of ``add_lazy``/``sub_lazy`` for inputs within t
    (x + PAD - y; it dominates x + y, since PAD >= t)."""
    return [a + b for a, b in zip(t, PAD)]


def _tight_fixed_point() -> list[int]:
    t = list(MASKS)
    while True:
        add_in = [2 * a for a in t]
        sub_in = lazy_bounds(t)
        outs = [
            carry_bounds(mul_col_bounds(t, t)),
            carry_bounds(mul_col_bounds(sub_in, sub_in)),
            carry_bounds(add_in),
            carry_bounds(sub_in),
        ]
        new = [max(col) for col in zip(t, *outs)]
        if new == t:
            return t
        t = new


TIGHT = _tight_fixed_point()
LAZY = lazy_bounds(TIGHT)
MUL_COL = max(mul_col_bounds(LAZY, LAZY))
assert MUL_COL < _I63 and max(LAZY) < _I31
assert max(2 * a for a in TIGHT) < _I31
assert all(PAD[i] >= TIGHT[i] for i in range(10))
assert max(a + b for a, b in zip(TIGHT, PAD)) < _I31
assert sum(t << o for t, o in zip(TIGHT, OFFS)) < 2**256
# the kernels' product lists give the plain version's columns (so each is
# below MUL_COL < 2^63) from premultiplied operands below 2^32: squares of
# TIGHT input, products of LAZY (or TIGHT, which LAZY dominates) operands
for _terms, _bound in ((mul_terms(), LAZY), (sq_terms(), TIGHT)):
    _cols, _top = term_columns(_terms, _bound, _bound)
    assert _cols == mul_col_bounds(_bound, _bound) and _top < 2**32

SQRT_M1 = pow(2, (P - 1) // 4, P)


def _carry(h: torch.Tensor) -> torch.Tensor:
    """int64 (10, *batch) non-negative columns -> int32 TIGHT limbs (same
    value mod p), by ``CARRY_STEPS`` as ``carry`` in fe25519.cuh."""
    h = list(h.unbind(0))
    for i in CARRY_STEPS:
        c = h[i] >> WIDTHS[i]
        h[i] = h[i] & MASKS[i]
        h[(i + 1) % 10] = h[(i + 1) % 10] + (19 * c if i == 9 else c)
    return torch.stack(h).to(torch.int32)


def _ripple(h: list) -> tuple[list, torch.Tensor]:
    """Strict ripple over int64 limb rows; returns (limbs, carry out)."""
    h = list(h)
    c = None
    for i in range(10):
        if c is not None:
            h[i] = h[i] + c
        c = h[i] >> WIDTHS[i]
        h[i] = h[i] & MASKS[i]
    return h, c


def _bview(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(n,) constant -> (n, 1, ..., 1) broadcastable against x."""
    return t.view((t.shape[0],) + (1,) * (x.dim() - 1))


class _Consts:
    """Per-device constant tensors of a field (built once per device)."""

    def __init__(self, build):
        self._build = build
        self._by_dev: dict = {}

    def get(self, device):
        key = torch.device(device)
        c = self._by_dev.get(key)
        if c is None:
            c = self._build(key)
            self._by_dev[key] = c
        return c


class Fe25519:
    """FQ = GF(2^255 - 19) on (10, *batch) int32 TIGHT limbs."""

    p = P
    n = 10
    n_bytes = 32

    def __init__(self):
        def build(dev):
            ii = torch.arange(10).view(10, 1).expand(10, 10)
            kk = torch.arange(10).view(1, 10).expand(10, 10)
            # column k gathers a_i * b_{(k-i) mod 10}; rows i, cols k
            jj = (kk - ii) % 10
            fac = torch.tensor(
                [[_factor(i, (k - i) % 10) for k in range(10)]
                 for i in range(10)], dtype=torch.int64)
            return {
                "i": ii.to(dev), "j": jj.to(dev), "fac": fac.to(dev),
                "pad": torch.tensor(PAD, dtype=torch.int64, device=dev),
            }

        self._c = _Consts(build)

    # -- construction ------------------------------------------------------

    def const(self, v: int, batch, device) -> torch.Tensor:
        col = torch.tensor(int_to_limbs(v % P, WIDTHS), dtype=torch.int32,
                           device=device)
        return col.view((10,) + (1,) * len(batch)).expand(
            (10,) + tuple(batch)).contiguous()

    def zero(self, batch, device):
        return torch.zeros((10,) + tuple(batch), dtype=torch.int32,
                           device=device)

    def one(self, batch, device):
        return self.const(1, batch, device)

    # -- ring ops ----------------------------------------------------------

    def add(self, x, y):
        return _carry(x.to(torch.int64) + y)

    def add_lazy(self, x, y):
        """x + y without the carry: only an operand of ``mul`` (LAZY)."""
        return x + y

    def sub_lazy(self, x, y):
        """x + 2p - y without the carry: only an operand of ``mul`` (LAZY)."""
        pad = _bview(self._c.get(x.device)["pad"], x)
        return (x.to(torch.int64) + pad - y).to(torch.int32)

    def sub(self, x, y):
        pad = _bview(self._c.get(x.device)["pad"], x)
        return _carry(x.to(torch.int64) + pad - y)

    def neg(self, y):
        pad = _bview(self._c.get(y.device)["pad"], y)
        return _carry(pad - y.to(torch.int64))

    def mul(self, x, y):
        """x * y for TIGHT or LAZY operands; TIGHT limbs out."""
        c = self._c.get(x.device)
        x, y = torch.broadcast_tensors(x, y)
        prod = x.to(torch.int64)[:, None] * y.to(torch.int64)[None, :]
        prod = prod[c["i"], c["j"]]                     # (i, k, *batch)
        h = (prod * c["fac"].view(c["fac"].shape + (1,) * (x.dim() - 1))
             ).sum(0)
        return _carry(h)

    def square(self, x):
        return self.mul(x, x)

    # -- canonical form / comparison ---------------------------------------

    def canon(self, x):
        """TIGHT limbs -> canonical strict limbs (value in [0, p))."""
        h, c = _ripple(list(x.to(torch.int64).unbind(0)))   # c in {0, 1}
        h[0] = h[0] + 19 * c
        h, c = _ripple(h)                      # c == 0: value < 2^255
        t = list(h)
        t[0] = t[0] + 19
        t, ge = _ripple(t)                     # ge: v + 19 >= 2^255, i.e. v >= p
        out = [torch.where(ge == 1, a, b) for a, b in zip(t, h)]
        return torch.stack(out).to(torch.int32)

    def is_zero(self, x):
        return (self.canon(x) == 0).all(0)

    def eq(self, x, y):
        return (self.canon(x) == self.canon(y)).all(0)

    def select(self, mask, x, y):
        return torch.where(mask[None], x, y)

    def sgn0(self, x):
        return self.canon(x)[0] & 1

    # -- bytes -------------------------------------------------------------

    def from_bytes_le(self, by):
        """(32, *batch) bytes -> (limbs, valid); valid is False where the
        256-bit encoding is >= p. The limbs hold the low 255 bits."""
        top = by[31] >> 7
        v = bytes_to_limbs(by, WIDTHS)
        rows = list(v.to(torch.int64).unbind(0))
        _, ge = _ripple([rows[0] + 19] + rows[1:])   # v + 19 >= 2^255
        valid = (top == 0) & (ge == 0)
        return v, valid

    def to_bytes_le(self, x):
        return limbs_to_bytes(self.canon(x), WIDTHS, 32)

    def from_wide_bytes_le(self, by):
        """(64, *batch) bytes -> value mod p: 2^255 = 19, 2^510 = 361."""
        w = bytes_to_limbs(by, WIDTHS * 2 + (2,)).to(torch.int64)
        h = w[:10] + 19 * w[10:20]
        h[0] = h[0] + 361 * w[20]
        return _carry(h)

    def reduce_wide_bytes_le(self, by):
        return self.to_bytes_le(self.from_wide_bytes_le(by))

    # -- exponentiation / square roots -------------------------------------

    def pow_const(self, x, e: int):
        """x^e for a public constant e >= 0 (4-bit fixed windows). On a CUDA
        tensor this is one launch of the pow kernel (ops/group.py)."""
        from .ops.group import pow_const_kernel

        return pow_const_kernel(x, e)

    def sqrt_ratio(self, u, v):
        """(r, ok) with r^2 == u/v where ok: r = u v^3 (u v^7)^((p-5)/8),
        times sqrt(-1) when v r^2 == -u (one pow chain)."""
        v3 = self.mul(self.square(v), v)
        v7 = self.mul(self.square(v3), v)
        r = self.mul(self.mul(u, v3),
                     self.pow_const(self.mul(u, v7), (P - 5) // 8))
        check = self.mul(v, self.square(r))
        i = self.const(SQRT_M1, u.shape[1:], u.device)
        correct = self.eq(check, u)
        flipped = self.eq(check, self.neg(u))
        r = self.select(flipped, self.mul(r, i), r)
        return r, correct | flipped


# ---------------------------------------------------------------------------
# FL: Montgomery, 16 limbs of 16 bits, R = 2^256
# ---------------------------------------------------------------------------

FL_WIDTHS = (16,) * 16
_M16 = 0xFFFF
R_FL = 1 << 256
N0INV = (-pow(L, -1, 1 << 16)) % (1 << 16)
R2_FL = R_FL * R_FL % L
R3_FL = R_FL * R2_FL % L
# school column <= 16 (2^16-1)^2, plus <= 16 reduction products and a carry
assert 16 * _M16 * _M16 + 16 * _M16 * _M16 + (1 << 22) < (1 << 38)


class MontScalarField:
    """FL = GF(l), canonical Montgomery limbs (16, *batch) int32."""

    p = L
    n = 16
    n_bytes = 32

    def __init__(self):
        def build(dev):
            kk = torch.arange(32).view(1, 32)
            ii = torch.arange(16).view(16, 1)
            jj = kk - ii
            jj = torch.where((jj >= 0) & (jj < 16), jj, torch.full_like(jj, 16))
            lv = torch.tensor(int_to_limbs(L, FL_WIDTHS), dtype=torch.int64)

            def col(v):
                return torch.tensor(int_to_limbs(v, FL_WIDTHS),
                                    dtype=torch.int32, device=dev)

            return {"i": ii.expand(16, 32).to(dev), "j": jj.to(dev),
                    "l": lv.to(dev), "r2": col(R2_FL), "r3": col(R3_FL),
                    "one": col(1)}

        self._c = _Consts(build)

    def _cond_sub(self, h: list):
        """Strict int64 limb rows of v < 2l -> int32 canonical limbs."""
        lv = int_to_limbs(L, FL_WIDTHS)
        t, b = [], None
        for i in range(16):
            d = h[i] - lv[i] if b is None else h[i] - lv[i] + b
            b = d >> 16                       # arithmetic: 0 or -1
            t.append(d & _M16)
        ge = b == 0
        return torch.stack([torch.where(ge, a, c) for a, c in zip(t, h)]
                           ).to(torch.int32)

    @staticmethod
    def _strict(h: list) -> list:
        h = list(h)
        for i in range(15):
            h[i + 1] = h[i + 1] + (h[i] >> 16)
            h[i] = h[i] & _M16
        return h

    def _const_col(self, name, x):
        return self._c.get(x.device)[name].view((16,) + (1,) * (x.dim() - 1))

    def mul(self, x, y):
        """Montgomery product x*y/R mod l; needs x*y < l*R."""
        c = self._c.get(x.device)
        x, y = torch.broadcast_tensors(x, y)
        y64 = torch.cat([y.to(torch.int64), torch.zeros_like(y[:1], dtype=torch.int64)])
        prod = x.to(torch.int64)[:, None] * y64[None, :]   # (16, 17, *batch)
        h = prod[c["i"], c["j"]].sum(0)                     # (32, *batch)
        lcol = c["l"].view((16,) + (1,) * (x.dim() - 1))
        for i in range(16):
            m = ((h[i] & _M16) * N0INV) & _M16
            h[i:i + 16] += m[None] * lcol
            h[i + 1] += h[i] >> 16
        return self._cond_sub(self._strict(list(h[16:32].unbind(0))))

    def square(self, x):
        return self.mul(x, x)

    def add(self, x, y):
        h = (x.to(torch.int64) + y).unbind(0)
        return self._cond_sub(self._strict(h))

    def neg(self, y):
        lcol = self._c.get(y.device)["l"].view((16,) + (1,) * (y.dim() - 1))
        # l - y in (0, l]; the ripple's arithmetic shifts carry the borrows
        return self._cond_sub(self._strict((lcol - y).unbind(0)))

    def sub(self, x, y):
        return self.add(x, self.neg(y))

    def canon(self, x):
        return x

    def is_zero(self, x):
        return (x == 0).all(0)

    def eq(self, x, y):
        return (x == y).all(0)

    def select(self, mask, x, y):
        return torch.where(mask[None], x, y)

    def from_mont(self, x):
        return self.mul(x, self._const_col("one", x))

    def sgn0(self, x):
        return self.from_mont(x)[0] & 1

    def from_bytes_le(self, by):
        """(32, *batch) bytes -> (Montgomery value, valid); valid is False
        where the encoding is >= l."""
        v = bytes_to_limbs(by, FL_WIDTHS)
        lv = int_to_limbs(L, FL_WIDTHS)
        b = None
        for i in range(16):
            d = v[i].to(torch.int64) - lv[i] + (0 if b is None else b)
            b = d >> 16
        return self.mul(v, self._const_col("r2", v)), b < 0

    def to_bytes_le(self, x):
        return limbs_to_bytes(self.from_mont(x), FL_WIDTHS, 32)

    def from_wide_bytes_le(self, by):
        """(64, *batch) bytes -> Montgomery value of (v0 + v1 2^256) mod l."""
        v = bytes_to_limbs(by, FL_WIDTHS * 2)
        a = self.mul(v[:16], self._const_col("r2", v))     # v0 R
        b = self.mul(v[16:], self._const_col("r3", v))     # v1 R^2
        return self.add(a, b)

    def reduce_wide_bytes_le(self, by):
        return self.to_bytes_le(self.from_wide_bytes_le(by))


FQ = Fe25519()
FL = MontScalarField()
