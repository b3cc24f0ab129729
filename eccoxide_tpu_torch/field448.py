"""Batched arithmetic for FQ448 = GF(2^448 - 2^224 - 1), the field of X448,
in PyTorch.

Counterpart of the JAX package's ``curve448.FQ`` (38 limbs of 12 bits
there). Values are int32 tensors ``(16, *batch)`` (layout of ``limbs.py``);
every operation keeps the batch shape and the device of its inputs.

Format: 16 non-negative limbs of 28 bits (limb i holds bits [28 i,
28 i + 28)), products accumulated in int64. With 2^448 = 2^224 + 1 mod p
and 224 = 8 x 28, the fold of a high column c >= 16 is two adds of whole
columns: into c - 16 and c - 8. The CUDA kernel (``ops/csrc/fe448.cuh``)
computes the same folded columns (by 8-limb halves, ``mul_cols_by_halves``)
and the same carry, so the plain version and the kernel agree limb for
limb.

Overflow argument (all limbs non-negative, so ``>>`` and ``&`` are exact
floor division and remainder):

- ``TIGHT`` is the per-limb bound that every public operation returns (the
  output of ``_carry``). It is computed below as the fixed point of the
  bounds that ``add``, ``sub``, ``neg``, ``mul`` and ``mul_small`` produce
  from inputs within ``TIGHT``: each limb may exceed its 28 bits by the
  carry of the carry's second round (a few hundred at most).
- ``mul`` takes TIGHT limbs. The 31 schoolbook columns hold at most 16
  products each; the fold adds column c + 8 and twice column c + 16 into
  column c (for 8 <= c < 16), so a folded column sums at most 38 products
  and is bounded by ``MUL_COL`` < 2^63. The kernel's square doubles one
  operand of each cross product (``2 a_i``), below 2^32.
- ``_carry`` runs ``CARRY_ROUNDS`` parallel rounds: every limb keeps its
  low 28 bits and receives the bits above them from the limb below (limb
  0 and limb 8 both receive limb 15's, since 2^448 = 2^224 + 1). A round
  takes a handful of torch launches where a ripple of 16 steps would take
  48; two rounds bring 2^62 columns to TIGHT. Every intermediate stays
  below 2^63.
- ``sub`` computes ``x + PAD - y`` with ``PAD`` the limbs of 2p; every PAD
  limb dominates the TIGHT limb below it, so the difference is
  non-negative limb-wise.
- ``canon`` takes TIGHT input. TIGHT values are below 2^449, so the first
  ripple's carry out of limb 15 is 0 or 1; folding it (into limbs 0 and 8)
  and rippling again gives strict limbs of a value below 2^448, and one
  conditional subtraction of p (via ``v + 2^224 + 1 >= 2^448``) makes it
  canonical.

The module asserts all of this at import, on Python ints.
"""

from __future__ import annotations

import torch

from .field import FieldAPI, _Consts, _check_wide
from .limbs import bytes_to_limbs, int_to_limbs, limbs_to_bytes

P = 2**448 - 2**224 - 1

N = 16
W = 28
WIDTHS = (W,) * N
M = (1 << W) - 1
HALF = 8                              # 2^224 = limb 8
CARRY_ROUNDS = 2
_I63 = 1 << 63


def mul_col_bounds(xb, yb) -> list[int]:
    """Upper bounds of the 16 folded product columns for limb bounds xb, yb:
    the 31 schoolbook columns, then every column c >= 16, from the top down,
    added into c - 16 and c - 8 (the order of ``_fold`` and fe448.cuh)."""
    raw = [0] * (2 * N - 1)
    for i in range(N):
        for j in range(N):
            raw[i + j] += xb[i] * yb[j]
    assert max(raw) < _I63
    for c in range(2 * N - 2, N - 1, -1):
        raw[c - N] += raw[c]
        raw[c - HALF] += raw[c]
    return raw[:N]


def mul_cols_by_halves(x, y) -> list[int]:
    """The 16 folded columns as fe448.cuh computes them, by 8-limb halves
    (t = 2^224, t^2 = t + 1 mod p): with A = x0 y0, X = x0 y1 + x1 y0 and
    M = x1 y1 as 8x8 column products, column k is A_k + s and column
    8 + k is A_{8+k} + X_k + s + M_{8+k}, where s = M_k + X_{8+k} +
    M_{8+k}. On limb bounds this is the kernel's largest partial sum."""
    def col(a, b, c):
        return sum(a[i] * b[c - i] for i in range(HALF) if 0 <= c - i < HALF)

    x0, x1, y0, y1 = x[:HALF], x[HALF:], y[:HALF], y[HALF:]
    out = [0] * N
    for k in range(HALF):
        m2 = col(x1, y1, HALF + k)
        s = m2 + col(x0, y1, HALF + k) + col(x1, y0, HALF + k) + col(x1, y1, k)
        out[k] = col(x0, y0, k) + s
        out[HALF + k] = col(x0, y0, HALF + k) + col(x0, y1, k) + col(x1, y0, k) + s + m2
    return out


def carry_bounds(h, rounds: int = CARRY_ROUNDS) -> list[int]:
    """Upper bounds after ``rounds`` rounds of ``_carry`` for non-negative
    columns bounded by h; asserts that no intermediate reaches 2^63."""
    h = list(h)
    for _ in range(rounds):
        assert all(0 <= v < _I63 for v in h)
        c = [v >> W for v in h]
        h = [min(v, M) for v in h]
        for i in range(1, N):
            h[i] += c[i - 1]
        h[0] += c[N - 1]
        h[HALF] += c[N - 1]
    assert all(v < _I63 for v in h)
    return h


PAD = [2 * v for v in int_to_limbs(P, WIDTHS)]     # 2p limb-wise
A24 = 39082                                       # (156326 + 2) / 4


def _tight_fixed_point() -> list[int]:
    t = [M] * N
    while True:
        outs = [
            carry_bounds(mul_col_bounds(t, t)),
            carry_bounds([2 * a for a in t]),
            carry_bounds([a + b for a, b in zip(t, PAD)]),
            carry_bounds([a * A24 for a in t]),
        ]
        new = [max(col) for col in zip(t, *outs)]
        if new == t:
            return t
        t = new


TIGHT = _tight_fixed_point()
MUL_COL = max(mul_col_bounds(TIGHT, TIGHT))
assert MUL_COL < _I63
# fe448.cuh: the columns by halves are the fold's (the same sums of the same
# products, so also on these bounds), and after the first carry round every
# limb is below 2^35, so the second round runs in 32 bits
assert mul_cols_by_halves(TIGHT, TIGHT) == mul_col_bounds(TIGHT, TIGHT)
assert max(carry_bounds(mul_col_bounds(TIGHT, TIGHT), 1)) < 2**35
assert all(PAD[i] >= TIGHT[i] for i in range(N))
assert max(a + b for a, b in zip(TIGHT, PAD)) < 2**31
assert 2 * max(TIGHT) < 2**32                      # the kernel's 2 a_i
_TIGHT_VALUE = sum(t << (W * i) for i, t in enumerate(TIGHT))
assert _TIGHT_VALUE < 2**449 and _TIGHT_VALUE - 2**448 + 2**224 + 1 < 2**448
# from_wide_bytes_le: 32 strict limbs folded into 16, each limb of the fold
# a sum of at most four of them; the carry returns TIGHT limbs
assert all(a <= t for a, t in zip(carry_bounds([4 * M] * N), TIGHT))


def _carry(h: torch.Tensor) -> torch.Tensor:
    """int64 (16, *batch) non-negative columns -> int32 TIGHT limbs of the
    same value mod p, in ``CARRY_ROUNDS`` parallel rounds (fe448.cuh
    ``fold_carry``)."""
    for _ in range(CARRY_ROUNDS):
        c = h >> W
        h = h & M
        h[1:].add_(c[:-1])
        h[0].add_(c[N - 1])
        h[HALF].add_(c[N - 1])
    return h.to(torch.int32)


def _fold(raw: torch.Tensor) -> torch.Tensor:
    """(31, *batch) schoolbook columns -> (16, *batch) columns of the same
    value mod p. Column c >= 16 goes to c - 16 and c - 8; the columns that
    land at 16..22 (from 24..30) fold once more, into 0..6 and 8..14."""
    lo, hi = raw[:N].clone(), raw[N:]
    lo[:N - 1].add_(hi)
    lo[HALF:].add_(hi[:HALF])
    lo[:N - 1 - HALF].add_(hi[HALF:])
    lo[HALF:N - 1].add_(hi[HALF:])
    return lo


def _ripple(h: list) -> tuple[list, torch.Tensor]:
    """Strict ripple over int64 limb rows; returns (limbs, carry out)."""
    h = list(h)
    c = None
    for i in range(N):
        if c is not None:
            h[i] = h[i] + c
        c = h[i] >> W
        h[i] = h[i] & M
    return h, c


class Fe448(FieldAPI):
    """FQ448 = GF(2^448 - 2^224 - 1) on (16, *batch) int32 TIGHT limbs; the
    rest of the JAX ``Field`` API from ``field.FieldAPI``."""

    p = P
    n = N
    n_bytes = 56
    widths = WIDTHS

    def __init__(self):
        def build(dev):
            ij = torch.arange(N)
            return {"col": (ij[:, None] + ij[None, :]).reshape(-1).to(dev),
                    "pad": torch.tensor(PAD, dtype=torch.int64, device=dev)}

        self._c = _Consts(build)

    def _pad(self, x):
        return self._c.get(x.device)["pad"].view((N,) + (1,) * (x.dim() - 1))

    # -- construction ------------------------------------------------------

    def const(self, v: int, batch, device) -> torch.Tensor:
        col = torch.tensor(int_to_limbs(v % P, WIDTHS), dtype=torch.int32,
                           device=device)
        return col.view((N,) + (1,) * len(batch)).expand(
            (N,) + tuple(batch)).contiguous()

    def zero(self, batch, device):
        return torch.zeros((N,) + tuple(batch), dtype=torch.int32, device=device)

    def one(self, batch, device):
        return self.const(1, batch, device)

    # -- ring ops ----------------------------------------------------------

    def add(self, x, y):
        return _carry(x.to(torch.int64) + y)

    def sub(self, x, y):
        return _carry(x.to(torch.int64) + self._pad(x) - y)

    def neg(self, y):
        return _carry(self._pad(y) - y.to(torch.int64))

    def mul_small(self, x, k: int):
        """x * k for a constant 0 <= k <= A24 (the ladder's a24)."""
        if not 0 <= k <= A24:
            raise ValueError(f"mul_small takes 0 <= k <= {A24}, got {k}")
        return _carry(x.to(torch.int64) * k)

    def mul(self, x, y):
        """x * y for TIGHT operands; TIGHT limbs out."""
        x, y = torch.broadcast_tensors(x, y)
        prod = x.to(torch.int64)[:, None] * y.to(torch.int64)[None, :]
        raw = torch.zeros((2 * N - 1,) + x.shape[1:], dtype=torch.int64,
                          device=x.device)
        raw.index_add_(0, self._c.get(x.device)["col"], prod.reshape((N * N,) + x.shape[1:]))
        return _carry(_fold(raw))

    def square(self, x):
        return self.mul(x, x)

    def select(self, mask, x, y):
        return torch.where(mask[None], x, y)

    # -- canonical form / comparison ---------------------------------------

    def canon(self, x):
        """TIGHT limbs -> canonical strict limbs (value in [0, p))."""
        h, c = _ripple(list(x.to(torch.int64).unbind(0)))   # c in {0, 1}
        h[0] = h[0] + c
        h[HALF] = h[HALF] + c
        h, _ = _ripple(h)                      # carry 0: value < 2^448
        t = list(h)
        t[0] = t[0] + 1
        t[HALF] = t[HALF] + 1
        t, ge = _ripple(t)                     # v + 2^224 + 1 >= 2^448: v >= p
        out = [torch.where(ge == 1, a, b) for a, b in zip(t, h)]
        return torch.stack(out).to(torch.int32)

    def is_zero(self, x):
        return (self.canon(x) == 0).all(0)

    def eq(self, x, y):
        return (self.canon(x) == self.canon(y)).all(0)

    def sgn0(self, x):
        """Parity of the canonical value."""
        return self.canon(x)[0] & 1

    # -- bytes -------------------------------------------------------------

    def from_bytes_le(self, by):
        """(56, *batch) bytes -> (limbs, valid). The limbs are the strict
        limbs of the 448-bit value, a TIGHT representative of it mod p
        whether or not it is below p; valid is False where it is >= p."""
        v = bytes_to_limbs(by, WIDTHS)
        t = list(v.to(torch.int64).unbind(0))
        t[0] = t[0] + 1
        t[HALF] = t[HALF] + 1
        _, ge = _ripple(t)
        return v, ge == 0

    def to_bytes_le(self, x):
        return limbs_to_bytes(self.canon(x), WIDTHS, self.n_bytes)

    def from_wide_bytes_le(self, by):
        """(up to 112, *batch) bytes -> their value mod p. Limb 16 + j
        (2^(448 + 28 j) = 2^(28 j) + 2^(28 (j + 8))) goes into limbs j and
        j + 8; for j >= 8 limb j + 8 wraps once more, into j - 8 and j."""
        _check_wide(by, 2 * self.n_bytes)
        w = bytes_to_limbs(by, WIDTHS * 2).to(torch.int64)
        h = w[:N] + w[N:]
        h[HALF:].add_(w[N:N + HALF])
        h[HALF:].add_(w[N + HALF:])
        h[:HALF].add_(w[N + HALF:])
        return _carry(h)

    # -- exponentiation ----------------------------------------------------

    def pow_const(self, x, e: int):
        """x^e for a public constant e >= 0 (4-bit fixed windows). On a CUDA
        tensor this is one launch of the pow448 kernel (ops/group.py)."""
        from .ops.group import pow448_kernel

        return pow448_kernel(x, e)


FQ448 = Fe448()
