"""Batched arithmetic over the SEC2 coordinate primes, in PyTorch: one field
engine for every prime.

Counterpart of the JAX package's ``field.Field`` (``field.py:220-1350``),
restricted to what the SEC2 curves use. The JAX package runs three engines
there (a sparse solinas fold, a dense matrix fold and word-serial
Montgomery, ``field.py:242-303, 845-910``), on 12- or 13-bit limbs because
the TPU's vector unit has no widening multiply. The port runs one format
for all 15 primes, shared by the plain version and the pow kernel
(``ops/csrc/fe_sec2.cuh``), so the two agree limb for limb. Values are
int32 tensors ``(n, *batch)`` (layout of ``limbs.py``) in the standard
domain; every operation keeps the batch shape and the device of its
inputs, and broadcasts over extra batch axes.

Format: n non-negative limbs of 28 bits (limb i holds bits [28 i,
28 i + 28)), the top limb may hold more; products are accumulated in
int64. n is the least with 28 n >= bits + ``SPARE``: one spare limb and a
few bits, so that one pass of a fold matrix reduces a product of any odd
prime (p112's random-looking prime, p256r1's dense 2^256 - p and P-521
alike). Row j of the fold matrix ``FOLD`` holds the limbs of
2^(28 (n + j)) mod p.

Overflow argument (all limbs non-negative, so ``>>`` and ``&`` are exact
floor division and remainder; the value bound of a tensor bounds its top
limb, since the others are non-negative):

- ``mul``: the 2n schoolbook columns (the last one empty) of two TIGHT
  operands stay below 2^63; two parallel carry rounds (every limb but the
  top keeps its low 28 bits and passes the rest up, the top limb keeps
  everything) bring every limb below 2^28 + 2^6 without changing the
  value; the fold adds limb n + j times row j into the low n columns (each
  term below 2^58); two more carry rounds over the n columns give TIGHT
  limbs. The value after the fold is below 2^(28 n) + n 2^29 p, which the
  spare limb keeps below 2^(28 n + 1).
- ``add``, ``sub``, ``neg``, ``double``, ``mul_small``: the limb-wise
  result (``x + PAD - y`` for a subtraction, with ``PAD`` a multiple of p
  whose limbs dominate TIGHT's) has its top limb's bits above 28 folded
  by row 0 (2^(28 n) mod p) and runs one carry round.
- ``TIGHT`` (limb bounds) and ``V_TIGHT`` (value bound) are the fixed
  point of those bounds, computed per prime at construction; every
  operation takes and returns values within both. Every bound above and
  every int64 intermediate is asserted there, on Python ints, and so are
  the kernel square's ``2 a_i`` and the folded limbs below 2^32.
  ``LARGEST`` is the largest limb vector within both bounds.
- ``from_wide_bytes_le`` (up to 2 n_bytes bytes): 2n strict limbs, limb
  n + j folded by row j into the low n and two carry rounds, as ``mul``
  does with its columns; the result is asserted TIGHT and within V_TIGHT.
- ``canon`` estimates the quotient q = V // p from the top 62 bits of the
  value (``V_top // (p_top + 1)``, never above the true quotient),
  subtracts q p limb-wise (q in 28-bit digits, each term below 2^57) and
  ripples; a few such rounds, their count fixed per prime at construction,
  leave a value below 2p, and one conditional subtraction of p makes it
  canonical.

The Montgomery-engine fields of the JAX package (p112r1 and p112r2,
R = 2^120, and every group order) hold x R; the port holds x, and
``convert.py`` carries values across.

The same engine serves any odd prime: the SEC2 group orders (the curves'
``scalar`` fields) and, through ``field_of``, the fields of the port with
their own formats where they need this one (FL's pow on the card, the
binary-GCD inverse). The rest of the JAX ``Field`` API comes from
``field.FieldAPI``.
"""

from __future__ import annotations

import functools

import torch

from .device import resolve_device
from .field import FieldAPI, _Consts, _check_wide
from .limbs import bytes_to_limbs, int_to_limbs, limbs_to_bytes

W = 28
M = (1 << W) - 1
SPARE = 34                # 28 n >= bits + SPARE: room for one fold pass
CARRY_ROUNDS = 2          # parallel carry rounds before and after the fold
MUL_SMALL_MAX = 16
_I63 = 1 << 63


def limb_count(bits: int) -> int:
    return -(-(bits + SPARE) // W)


# ---------------------------------------------------------------------------
# bounds on Python ints: (limb bounds, value bound) through every step
# ---------------------------------------------------------------------------


def _clip_top(lb: list, v: int) -> list:
    lb = list(lb)
    lb[-1] = min(lb[-1], v >> (W * (len(lb) - 1)))
    return lb


def carry_bounds(lb, v: int, rounds: int) -> list:
    """Limb bounds after ``rounds`` parallel rounds over non-negative
    columns bounded by lb, the top limb unmasked (``_carry_rounds``)."""
    lb = _clip_top(lb, v)
    for _ in range(rounds):
        assert all(0 <= b < _I63 for b in lb)
        c = [b >> W for b in lb[:-1]]
        lb = [min(b, M) for b in lb[:-1]] + [lb[-1]]
        for i, ci in enumerate(c):
            lb[i + 1] += ci
        assert all(b < _I63 for b in lb)
        lb = _clip_top(lb, v)
    return lb


def _value(lb) -> int:
    return sum(b << (W * i) for i, b in enumerate(lb))


class _Format:
    """The limb format of one prime and its asserted overflow argument."""

    def __init__(self, p: int):
        self.p = p
        self.bits = p.bit_length()
        n = self.n = limb_count(self.bits)
        assert (1 << (W * (n - 1))) > p              # p and FOLD rows: n - 1 limbs
        self.P = int_to_limbs(p, (W,) * n)
        self.fold_vals = [(1 << (W * (n + j))) % p for j in range(n)]
        self.FOLD = [int_to_limbs(v, (W,) * n) for v in self.fold_vals]
        # PAD: 2 m p with every limb >= 2 M (JAX field.py SUBPAD)
        m = -(-((1 << (W * n)) - 1) // p)
        d = int_to_limbs(m * p - ((1 << (W * n)) - 1), (W,) * n)
        self.PAD = [2 * (M + di) for di in d]
        assert _value(self.PAD) == 2 * m * p
        self.np = -(-self.bits // W)                 # the limbs of p
        self.CFOLD = [int_to_limbs((1 << (W * j)) % p, (W,) * self.np) for j in range(self.np, n)]
        self.TIGHT, self.V_TIGHT = self._tight_fixed_point()
        t = self.TIGHT
        assert all(self.PAD[i] >= t[i] for i in range(n))
        assert 2 * max(t) < 2**32                    # the kernel square's 2 a_i
        assert all(b >= M for b in t)                # strict limbs are TIGHT
        assert self.V_TIGHT < 1 << (W * n + 1)
        # the largest limbs within both bounds: TIGHT below the top limb, the
        # top limb as large as the value bound leaves it
        self.LARGEST = t[:-1] + [(self.V_TIGHT - _value(t[:-1])) >> (W * (n - 1))]
        assert M <= self.LARGEST[-1] <= t[-1]
        self.canon_rounds = self._canon_rounds()
        wb, wv = self.wide_bounds()
        assert all(a <= b for a, b in zip(wb, t)) and wv <= self.V_TIGHT

    # -- the steps of mul and of the linear ops, as bounds ------------------

    def _columns(self, xb, xv, yb, yv):
        """Bounds of the 2n product columns after their carry rounds, and
        of the product's value."""
        n = self.n
        raw = [0] * (2 * n)
        for i in range(n):
            for j in range(n):
                raw[i + j] += xb[i] * yb[j]
        assert max(raw) < _I63
        v = xv * yv
        return carry_bounds(raw, v, CARRY_ROUNDS), v

    def mul_bounds(self, xb, xv, yb, yv):
        n = self.n
        h, v = self._columns(xb, xv, yb, yv)
        assert max(h) < 2**32                        # the kernel keeps them as uint32
        out = list(h[:n])
        for j in range(n):
            for i in range(n):
                out[i] += h[n + j] * self.FOLD[j][i]
        assert max(out) < _I63
        v2 = min(_value(h[:n]), v) + sum(h[n + j] * self.fold_vals[j] for j in range(n))
        return carry_bounds(out, v2, CARRY_ROUNDS), v2

    def linear_bounds(self, lb, v):
        """``_reduce_linear`` of non-negative limbs bounded by lb, value v."""
        n = self.n
        lb = _clip_top(lb, v)
        assert max(lb) < _I63
        t = lb[-1] >> W
        low = list(lb[:-1]) + [min(lb[-1], M)]
        out = [a + t * f for a, f in zip(low, self.FOLD[0])]
        assert max(out) < _I63
        v2 = min(_value(low), v) + t * self.fold_vals[0]
        return carry_bounds(out, v2, 1), v2

    def wide_bounds(self):
        """(limb bounds, value bound) of ``from_wide_bytes_le`` on 2 n_bytes
        bytes: the strict limbs n.. folded by the rows of ``FOLD`` into the
        low n, then the carry rounds of ``mul``."""
        n = self.n
        vmax = (1 << (16 * ((self.bits + 7) // 8))) - 1
        lb = [min(M, vmax >> (W * k)) for k in range(2 * n)]
        out = [lb[i] + sum(lb[n + j] * self.FOLD[j][i] for j in range(n)) for i in range(n)]
        assert max(out) < _I63
        v = min(_value(lb[:n]), vmax) + sum(lb[n + j] * self.fold_vals[j] for j in range(n))
        return carry_bounds(out, v, CARRY_ROUNDS), v

    def madds(self, square: bool = False) -> int:
        """The limb multiply-adds one product (or squaring) of TIGHT values
        needs: the schoolbook terms (every TIGHT limb can be nonzero), then
        the nonzero entries of the fold rows whose column can be nonzero.
        The count behind the pow kernel's bound in chip_smoke.py."""
        n, t = self.n, self.TIGHT
        h, _ = self._columns(t, self.V_TIGHT, t, self.V_TIGHT)
        school = n * (n + 1) // 2 if square else n * n
        return school + sum(1 for j in range(n) if h[n + j] for a in self.FOLD[j] if a)

    def _tight_fixed_point(self):
        t, v = [M] * self.n, self.p - 1
        for _ in range(64):
            outs = [
                self.mul_bounds(t, v, t, v),
                self.linear_bounds([2 * a for a in t], 2 * v),                      # add
                self.linear_bounds([a + b for a, b in zip(t, self.PAD)],
                                   v + _value(self.PAD)),                            # sub
                self.linear_bounds([MUL_SMALL_MAX * a for a in t], MUL_SMALL_MAX * v),
            ]
            new_t = [max(c) for c in zip(t, *(o[0] for o in outs))]
            new_v = max([v] + [o[1] for o in outs])
            if (new_t, new_v) == (t, v):
                return t, v
            t, v = new_t, new_v
        raise AssertionError(f"no TIGHT fixed point for p = {self.p:#x}")

    def _canon_rounds(self):
        """[(sh, digits, used limbs)] of the quotient rounds of ``canon``, after its fold
        of limbs np.. (np = the limbs of p) by ``CFOLD`` and its carry: each
        round leaves a value below the next bound, the last below 2p."""
        n, p, t, np_ = self.n, self.p, self.TIGHT, self.np
        out = list(t[:np_]) + [0] * (n - np_)
        for j in range(np_, n):
            for i in range(np_):
                out[i] += t[j] * self.CFOLD[j - np_][i]
        assert max(out) < _I63
        vb = min(_value(t[:np_]), self.V_TIGHT) + sum(
            t[j] * ((1 << (W * j)) % p) for j in range(np_, n))
        lb = carry_bounds(out, vb, CARRY_ROUNDS)
        rounds = []
        while vb >= 2 * p:
            sh = max(0, vb.bit_length() - 62)
            assert (p >> sh) >= 1 and (vb >> sh) < 2**62
            digits = -(-(vb // p).bit_length() // W)
            assert np_ + digits - 1 <= n and digits * M * M < 2**62
            # the limbs whose share of the value can reach 2^sh; each share,
            # and their sum, is at most vb / 2^sh < 2^62
            used = tuple(i for i, b in enumerate(lb) if b << (W * i) >= 1 << sh)
            rounds.append((sh, digits, used))
            vb = (vb << sh) // p + n * (1 << sh) + p
            lb = [M] * (n - 1) + [vb >> (W * (n - 1))]     # strict after the ripple
            assert len(rounds) <= 3
        return rounds


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _carry_rounds(h: torch.Tensor, rounds: int) -> torch.Tensor:
    """Parallel carry rounds over int64 columns (k, *batch), in place: every
    limb but the top keeps its low 28 bits and passes the rest to the limb
    above; the top limb keeps everything (fe_sec2.cuh ``Carry2``)."""
    for _ in range(rounds):
        c = h[:-1] >> W
        h[:-1].bitwise_and_(M)       # in place on the views: no copy back
        h[1:].add_(c)
    return h


def _ripple(h: list) -> list:
    """Strict signed ripple over int64 limb rows: every limb but the top in
    [0, 2^28) (arithmetic shifts carry the borrows), the top keeps the
    rest."""
    h = list(h)
    for i in range(len(h) - 1):
        h[i + 1] = h[i + 1] + (h[i] >> W)
        h[i] = h[i] & M
    return h


class Field(FieldAPI):
    """GF(p) for an odd prime p, on (n, *batch) int32 TIGHT limbs."""

    def __init__(self, name: str, p: int):
        assert p > 2 and p % 2 == 1
        self.name = name
        self.p = p
        fmt = self.fmt = _Format(p)
        self.bits = fmt.bits
        self.n = fmt.n
        self.n_bytes = (self.bits + 7) // 8
        self.widths = (W,) * self.n
        if p % 4 == 3:
            self.sqrt_kind = "p3mod4"
        elif p % 8 == 5:
            self.sqrt_kind = "p5mod8"
        else:
            self.sqrt_kind = "tonelli"
            q, s = p - 1, 0
            while q % 2 == 0:
                q, s = q // 2, s + 1
            self.ts_q, self.ts_s = q, s
            z = 2
            while pow(z, (p - 1) // 2, p) != p - 1:
                z += 1
            self.ts_z = z

        n = self.n

        def build(dev):
            ij = torch.arange(n)
            i64 = dict(dtype=torch.int64, device=dev)
            return {"col": (ij[:, None] + ij[None, :]).reshape(-1).to(dev),
                    "fold": torch.tensor(fmt.FOLD, **i64),
                    "fold0": torch.tensor(fmt.FOLD[0], **i64),
                    "cfold": torch.tensor(fmt.CFOLD, **i64),
                    "pad": torch.tensor(fmt.PAD, **i64),
                    "p": torch.tensor(fmt.P, **i64)}

        self._c = _Consts(build)

    def _col(self, name, x):
        t = self._c.get(x.device)[name]
        return t.view((t.shape[0],) + (1,) * (x.dim() - 1))

    # -- construction / host conversion ------------------------------------

    def const(self, v: int, batch, device="cuda") -> torch.Tensor:
        col = torch.tensor(int_to_limbs(v % self.p, self.widths), dtype=torch.int32,
                           device=resolve_device(device))
        return col.view((self.n,) + (1,) * len(batch)).expand(
            (self.n,) + tuple(batch)).contiguous()

    def bcast(self, x: torch.Tensor, batch) -> torch.Tensor:
        """An (n,) or (n, 1) column -> (n, *batch)."""
        x = x.reshape((self.n,) + (1,) * len(tuple(batch)))
        return x.expand((self.n,) + tuple(batch)).to(torch.int32).contiguous()

    def zero(self, batch, device="cuda"):
        return torch.zeros((self.n,) + tuple(batch), dtype=torch.int32,
                           device=resolve_device(device))

    def one(self, batch, device="cuda"):
        return self.const(1, batch, device)

    # -- ring ops ----------------------------------------------------------

    def _reduce_linear(self, h: torch.Tensor) -> torch.Tensor:
        """int64 non-negative limbs -> TIGHT int32: the top limb's bits
        above 28 folded by 2^(28 n) mod p, then one carry round."""
        t = h[-1] >> W
        h[-1].bitwise_and_(M)
        h.add_(t[None] * self._col("fold0", h))
        return _carry_rounds(h, 1).to(torch.int32)

    def add(self, x, y):
        return self._reduce_linear(x.to(torch.int64) + y)

    def sub(self, x, y):
        return self._reduce_linear(x.to(torch.int64) + self._col("pad", x) - y)

    def neg(self, y):
        return self._reduce_linear(self._col("pad", y) - y.to(torch.int64))

    def mul_small(self, x, k: int):
        if not 0 <= k <= MUL_SMALL_MAX:
            raise ValueError(f"mul_small takes 0 <= k <= {MUL_SMALL_MAX}, got {k}")
        return self._reduce_linear(x.to(torch.int64) * k)

    def mul(self, x, y):
        """x * y for TIGHT operands (broadcast against each other)."""
        n = self.n
        x, y = torch.broadcast_tensors(x, y)
        prod = x.to(torch.int64)[:, None] * y.to(torch.int64)[None, :]
        raw = torch.zeros((2 * n,) + x.shape[1:], dtype=torch.int64, device=x.device)
        raw.index_add_(0, self._c.get(x.device)["col"], prod.reshape((n * n,) + x.shape[1:]))
        _carry_rounds(raw, CARRY_ROUNDS)
        fold = self._c.get(x.device)["fold"].view((n, n) + (1,) * (x.dim() - 1))
        lo = raw[:n] + (raw[n:, None] * fold).sum(0)
        return _carry_rounds(lo, CARRY_ROUNDS).to(torch.int32)

    def square(self, x):
        return self.mul(x, x)

    def select(self, mask, x, y):
        """mask ? x : y, a (*batch,) bool mask over the limbs."""
        return torch.where(mask[None], x, y)

    # -- canonical form / comparison ---------------------------------------

    def _sub_p(self, h: list) -> list:
        """Strict rows of h - p (the top row negative where h < p)."""
        return _ripple([a - b for a, b in zip(h, self.fmt.P)])

    def canon(self, x):
        """TIGHT limbs -> canonical strict limbs (value in [0, p)): limbs
        np.. folded by 2^(28 j) mod p and two carry rounds (the value is
        now within about 2^35 p), then quotient rounds and one conditional
        subtraction of p."""
        p, fmt, n, np_ = self.p, self.fmt, self.n, self.fmt.np
        h = x.to(torch.int64)
        lo = torch.zeros_like(h)
        cf = self._c.get(x.device)["cfold"].view((n - np_, np_) + (1,) * (x.dim() - 1))
        lo[:np_] = h[:np_] + (h[np_:, None] * cf).sum(0)
        h = list(_carry_rounds(lo, CARRY_ROUNDS).unbind(0))
        for sh, digits, used in fmt.canon_rounds:
            top = None
            for i in used:
                a, off = h[i], W * i
                part = a << (off - sh) if off >= sh else a >> (sh - off)
                top = part if top is None else top + part
            q = torch.div(top, (p >> sh) + 1, rounding_mode="floor")
            for k in range(digits):
                qk = (q >> (W * k)) & M
                for i in range(k, n):
                    if fmt.P[i - k]:
                        h[i] = h[i] - qk * fmt.P[i - k]
            h = _ripple(h)
        if not fmt.canon_rounds:
            h = _ripple(h)
        t = self._sub_p(h)
        ge = t[-1] >= 0
        return torch.stack([torch.where(ge, a, b) for a, b in zip(t, h)]).to(torch.int32)

    def is_zero(self, x):
        return (self.canon(x) == 0).all(0)

    def eq(self, x, y):
        return (self.canon(x) == self.canon(y)).all(0)

    def sgn0(self, x):
        """Parity of the canonical value."""
        return self.canon(x)[0] & 1

    # -- bytes -------------------------------------------------------------

    def to_bytes_le(self, x):
        return limbs_to_bytes(self.canon(x), self.widths, self.n_bytes)

    def from_bytes_le(self, by):
        """(n_bytes, *batch) bytes -> (limbs, valid): the strict limbs of
        the value (TIGHT whether or not it is below p); valid is False where
        the encoding is >= p (JAX field.py:1269-1284)."""
        v = bytes_to_limbs(by, self.widths)
        t = self._sub_p(list(v.to(torch.int64).unbind(0)))
        return v, t[-1] < 0

    def from_wide_bytes_le(self, by):
        """(up to 2 n_bytes, *batch) bytes -> their value mod p, TIGHT (JAX
        field.py:1287-1305): limb n + j of the wide value times row j of
        the fold matrix into the low n limbs, then the carry rounds of
        ``mul``."""
        n = self.n
        _check_wide(by, 2 * self.n_bytes)
        w = bytes_to_limbs(by, (W,) * (2 * n)).to(torch.int64)
        fold = self._c.get(by.device)["fold"].view((n, n) + (1,) * (by.dim() - 1))
        lo = w[:n] + (w[n:, None] * fold).sum(0)
        return _carry_rounds(lo, CARRY_ROUNDS).to(torch.int32)

    # -- exponentiation / inverse / square roots ---------------------------

    def pow_const(self, x, e: int):
        """x^e for a public constant e >= 0 (4-bit fixed windows). On a CUDA
        tensor this is one launch of the SEC2 pow kernel (ops/group.py)."""
        from .ops.group import pow_sec2_kernel

        return pow_sec2_kernel(self, x, e)

    def path_exponents(self) -> dict:
        """The public exponents ``inverse``, ``is_square`` and ``sqrt`` raise
        to, by name: the SEC2 path's calls of the pow kernel."""
        p = self.p
        e = {"p-2": p - 2, "(p-1)/2": (p - 1) // 2}
        if self.sqrt_kind == "p3mod4":
            e["(p+1)/4"] = (p + 1) // 4
        elif self.sqrt_kind == "p5mod8":
            e["(p-5)/8"] = (p - 5) // 8
        else:
            e["q"], e["(q+1)/2"] = self.ts_q, (self.ts_q + 1) // 2
        return e

    def sqrt_ratio(self, u, v):
        """(r, ok) with r^2 == u/v where ok (JAX field.py:1147-1174): one
        fused chain for p = 5 mod 8, else inverse then sqrt."""
        if self.sqrt_kind != "p5mod8":
            r, ok = self.sqrt(self.mul(u, self.inverse(v)))
            return r, ok & ~self.is_zero(v)
        v3 = self.mul(self.square(v), v)
        v7 = self.mul(self.square(v3), v)
        r = self.mul(self.mul(u, v3), self.pow_const(self.mul(u, v7), (self.p - 5) // 8))
        check = self.mul(v, self.square(r))
        i = self.const(pow(2, (self.p - 1) // 4, self.p), u.shape[1:], u.device)
        correct = self.eq(check, u)
        flipped = self.eq(check, self.neg(u))
        r = self.select(flipped, self.mul(r, i), r)
        return r, correct | flipped

    def _tonelli_shanks(self, x):
        """Constant-time Tonelli-Shanks (JAX field.py:1176-1198): with
        c = z^q of order 2^s and x^q = c^e, sqrt(x) = x^((q+1)/2) c^(-e/2);
        the bits of e come from a divide-and-conquer discrete log
        (``_dlog_pow2``), each applied as a masked multiply by a public
        constant. The recursion runs in Python, so the sequence of torch
        operations is the same for every x."""
        q, s, p = self.ts_q, self.ts_s, self.p
        c_int = pow(self.ts_z, q, p)
        cnegs = [pow(c_int, -(1 << m), p) for m in range(s)]
        t0 = self.pow_const(x, q)
        r = self.pow_const(x, (q + 1) // 2)
        bits = self._dlog_pow2(t0, s, 0, c_int, cnegs)
        return self._masked_mul_chain(r, [cnegs[j - 1] for j in range(1, s)], bits[1:])

    def _masked_mul_chain(self, w, const_ints, bits):
        """w times the product of const_ints[j] where bits[j] (JAX
        field.py:1200-1215): every product computed, kept by a select."""
        batch = w.shape[1:]
        for v, bit in zip(const_ints, bits):
            w = self.select(bit, self.mul(w, self.const(v, (1,) * len(batch), w.device)), w)
        return w

    _DLOG_LEAF = 4

    def _dlog_pow2(self, v, k, m, c_int, cnegs):
        """Bits (LSB first) of e where v = g^e, g = c^(2^m) of order 2^k
        (JAX field.py:1217-1254): leaves of at most 4 bits compare the
        canonical v with the 2^k public powers of g."""
        batch, dev = v.shape[1:], v.device
        if k <= self._DLOG_LEAF:
            g = pow(c_int, 1 << m, self.p)
            vc = self.canon(v)
            bits = [torch.zeros(batch, dtype=torch.bool, device=dev) for _ in range(k)]
            for i in range(1 << k):
                ci = self.const(pow(g, i, self.p), (1,) * len(batch), dev)
                hit = (vc == ci).all(0)
                for j in range(k):
                    if (i >> j) & 1:
                        bits[j] = bits[j] | hit
            return bits
        k1 = k // 2
        k2 = k - k1
        vlo = v
        for _ in range(k2):
            vlo = self.square(vlo)
        bits_lo = self._dlog_pow2(vlo, k1, m + k2, c_int, cnegs)
        w = self._masked_mul_chain(v, [cnegs[m + j] for j in range(k1)], bits_lo)
        return bits_lo + self._dlog_pow2(w, k2, m + k1, c_int, cnegs)

    # -- a second, independent inverse --------------------------------------

    @staticmethod
    def _sr1(t: torch.Tensor, c_out=None) -> torch.Tensor:
        """Halve strict rows (n, ...); c_out: an overflow bit above the top
        row."""
        top = t[-1:] >> 1
        if c_out is not None:
            top = top | (c_out[None] << (W - 1))
        return torch.cat([(t[:-1] >> 1) | ((t[1:] & 1) << (W - 1)), top])

    @staticmethod
    def _chain(t: torch.Tensor):
        """Signed ripple over every row of (n, ...); returns (strict rows,
        carry out: -1, 0 or 1)."""
        out, cr = [], None
        for v in t.unbind(0):
            v = v if cr is None else v + cr
            cr = v >> W
            out.append(v & M)
        return torch.stack(out), cr

    def inverse_bingcd(self, x):
        """x^-1 by a fixed-trip masked binary extended GCD (JAX
        field.py:1049-1123), an algorithm independent of the Fermat chain
        for cross-checks; 0 for 0. State (a, g, u, w) with a = u x and
        g = w x mod p; every trip halves a or g, so 2 bits + 2 masked trips
        end with g = 1 and w = x^-1. Rows of 28 bits, values below p; the
        four differences, the two modular corrections and the four modular
        halvings of a trip each run as one ripple over a stacked axis."""
        n = self.n
        batch, dev = x.shape[1:], x.device
        tail = (1,) * len(batch)
        pc = self._c.get(dev)["p"].view((n, 1) + tail)
        a = self.canon(x).to(torch.int64)
        g = pc[:, 0].expand_as(a)
        u = torch.zeros_like(a)
        u[0] = 1
        w = torch.zeros_like(a)

        def sel(mask, r1, r2):
            return torch.where(mask[None], r1, r2)

        for _ in range(2 * self.bits + 2):
            alive = (a != 0).any(0)
            a_even = (a[0] & 1) == 0
            g_even = (g[0] & 1) == 0
            d, cr = self._chain(torch.stack([a - g, g - a, u - w, w - u], 1))
            a_ge_g = cr[0] == 0
            m, _ = self._chain(d[:, 2:] + torch.where(cr[2:] < 0, pc, 0))      # u - w, w - u mod p
            hin = torch.stack([u, w, m[:, 0], m[:, 1]], 1)
            ht, hcr = self._chain(hin + torch.where((hin[0] & 1) == 1, pc, 0))
            hu, hw, huw, hwu = self._sr1(ht, hcr).unbind(1)
            ha, hg, hag, hga = self._sr1(torch.stack([a, g, d[:, 0], d[:, 1]], 1)).unbind(1)
            c1 = alive & a_even
            c2 = alive & ~a_even & g_even
            c34 = alive & ~a_even & ~g_even
            c3 = c34 & a_ge_g
            c4 = c34 & ~a_ge_g
            a, g, u, w = (sel(c1, ha, sel(c3, hag, a)), sel(c2, hg, sel(c4, hga, g)),
                          sel(c1, hu, sel(c3, huw, u)), sel(c2, hw, sel(c4, hwu, w)))
        is_inv = (g[0] == 1) & (g[1:] == 0).all(0)
        return torch.where(is_inv[None], w, 0).to(torch.int32)


@functools.cache
def field_of(p: int) -> Field:
    """The ``Field`` of p in this format, built once and named after its
    instance of the pow kernel (``build.POW_SEC2_INSTANCES``: ``<curve>_n``
    for a SEC2 group order, ``l25519`` for l), else ``gf(0x...)``: the SEC2
    curves' scalar fields, FL's pow on the card and the binary-GCD inverse
    of the fields with other formats."""
    from .ops.build import POW_SEC2_INSTANCES

    return Field(POW_SEC2_INSTANCES.get(p, f"gf({p:#x})"), p)
