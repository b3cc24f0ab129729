"""ristretto255: the RFC 9496 prime-order group over edwards25519, batched.

Counterpart of the JAX package's ``curves/ristretto255.py``: ``compress``
(RFC 9496 4.3.2), ``decompress`` (4.3.1) with every rejection as a
validity mask over the batch, representative-independent ``eq`` (4.3.3),
the Elligator 2 map ``elligator`` (4.3.4) and ``from_uniform_bytes``
(4.3.4). A point is an edwards25519 ``ExtPoint``; the group operations are
``EDWARDS``'s, so on CUDA tensors each addition or doubling is a launch of
the group kernels (``ops/group.py``). ``sqrt_ratio_m1`` raises to
(p-5)/8 once, one launch of the pow kernel on the card: ``compress``,
``decompress`` and ``from_uniform_bytes`` take one each, and
``from_uniform_bytes`` runs its two maps on one stacked (10, 2B) batch and
adds the halves with one launch of the add kernel.

Constant time: every branch of the RFC's pseudocode is a select over the
batch; no shape, index or branch depends on a limb value.
"""

from __future__ import annotations

import torch

from ..field import FQ, MASKS, P, SQRT_M1, TIGHT
from ..params.comb import edwards_comb
from ..params.comb import mul_base as _comb_mul_base
from .curve25519 import D, EDWARDS
from .edwards import ExtPoint


def _even_sqrt(x: int) -> int:
    """The square root of x with the ristretto sign convention (even)."""
    x %= P
    r = pow(x, (P + 3) // 8, P)
    if (r * r - x) % P:
        r = r * SQRT_M1 % P
    assert (r * r - x) % P == 0, "not a square"
    return r if r % 2 == 0 else P - r


# RFC 9496 section 4.1 (a = -1). SQRT_AD_MINUS_ONE is the ODD root of
# a d - 1: the even root maps the A.3 inputs to other points.
SQRT_AD_MINUS_ONE = P - _even_sqrt(-1 - D)
INVSQRT_A_MINUS_D = _even_sqrt(pow((-1 - D) % P, -1, P))
ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = ((D - 1) * (D - 1)) % P
# from_uniform_bytes keeps the low 255 bits as strict limbs, without
# reducing below p: they must be a TIGHT operand of every field operation
assert all(m <= t for m, t in zip(MASKS, TIGHT))


def _k(v: int, like: torch.Tensor) -> torch.Tensor:
    """The constant v as (10, 1, ..., 1) against a field batch."""
    return FQ.const(v, (1,) * (like.dim() - 1), like.device)


def sqrt_ratio_m1(u, v):
    """(was_square, r): r = sqrt(u/v), or sqrt(i u/v) where u/v is not a
    square, always the even root (RFC 9496 4.2; JAX ristretto255.py:50-68).
    One pow, (p-5)/8."""
    f = FQ
    v3 = f.mul(f.square(v), v)
    v7 = f.mul(f.square(v3), v)
    r = f.mul(f.mul(u, v3), f.pow_const(f.mul(u, v7), (P - 5) // 8))
    check = f.mul(v, f.square(r))
    i = _k(SQRT_M1, u)
    correct = f.eq(check, u)
    flipped = f.eq(check, f.neg(u))
    flipped_i = f.eq(check, f.neg(f.mul(u, i)))
    r = f.select(flipped | flipped_i, f.mul(r, i), r)
    r = f.select(f.sgn0(r) == 1, f.neg(r), r)
    return correct | flipped, r


def compress(pt: ExtPoint) -> torch.Tensor:
    """RFC 9496 4.3.2: a point -> (32, *batch) bytes (JAX
    ristretto255.py:71-95)."""
    f = FQ
    x, y, z, t = pt.with_t().unbind(0)
    u1 = f.mul(f.add(z, y), f.sub(z, y))
    u2 = f.mul(x, y)
    _, invsqrt = sqrt_ratio_m1(f.one(x.shape[1:], x.device), f.mul(u1, f.square(u2)))
    den1 = f.mul(invsqrt, u1)
    den2 = f.mul(invsqrt, u2)
    z_inv = f.mul(f.mul(den1, den2), t)
    i = _k(SQRT_M1, x)
    rotate = f.sgn0(f.mul(t, z_inv)) == 1
    x_ = f.select(rotate, f.mul(y, i), x)
    y_ = f.select(rotate, f.mul(x, i), y)
    den_inv = f.select(rotate, f.mul(den1, _k(INVSQRT_A_MINUS_D, x)), den2)
    y_ = f.select(f.sgn0(f.mul(x_, z_inv)) == 1, f.neg(y_), y_)
    s = f.mul(den_inv, f.sub(z, y_))
    s = f.select(f.sgn0(s) == 1, f.neg(s), s)
    return f.to_bytes_le(s)


def decompress(by: torch.Tensor):
    """RFC 9496 4.3.1: (32, *batch) bytes -> (ExtPoint, valid) (JAX
    ristretto255.py:98-122). valid is False for a non-canonical or
    negative s, a non-square, a negative t or y = 0; the point of an
    invalid lane is garbage."""
    f = FQ
    s, canonical = f.from_bytes_le(by)
    one = f.one(s.shape[1:], s.device)
    valid = canonical & (f.sgn0(s) == 0)
    ss = f.square(s)
    u1 = f.sub(one, ss)
    u2 = f.add(one, ss)
    u2_sqr = f.square(u2)
    v = f.sub(f.neg(f.mul(_k(D, s), f.square(u1))), u2_sqr)
    was_square, invsqrt = sqrt_ratio_m1(one, f.mul(v, u2_sqr))
    den_x = f.mul(invsqrt, u2)
    den_y = f.mul(f.mul(invsqrt, den_x), v)
    x = f.mul(f.add(s, s), den_x)
    x = f.select(f.sgn0(x) == 1, f.neg(x), x)
    y = f.mul(u1, den_y)
    t = f.mul(x, y)
    valid = valid & was_square & (f.sgn0(t) == 0) & ~f.is_zero(y)
    return ExtPoint(torch.stack([x, y, one, t])), valid


def eq(p: ExtPoint, q: ExtPoint):
    """x1 y2 == y1 x2 or y1 y2 == x1 x2 (RFC 9496 4.3.3; JAX
    ristretto255.py:125-131): equal group elements, whatever their
    representatives."""
    f = FQ
    a = f.eq(f.mul(p.x, q.y), f.mul(p.y, q.x))
    b = f.eq(f.mul(p.y, q.y), f.mul(p.x, q.x))
    return a | b


def elligator(r0):
    """RFC 9496 4.3.4 MAP: field elements (10, *batch) -> points (JAX
    ristretto255.py:134-162)."""
    f = FQ
    one = f.one(r0.shape[1:], r0.device)
    r = f.mul(_k(SQRT_M1, r0), f.square(r0))
    n_s = f.mul(f.add(r, one), _k(ONE_MINUS_D_SQ, r0))
    c = f.neg(one)
    d = _k(D, r0)
    d_ = f.mul(f.sub(c, f.mul(d, r)), f.add(r, d))
    was_square, s = sqrt_ratio_m1(n_s, d_)
    s_prime = f.mul(s, r0)
    s_prime = f.select(f.sgn0(s_prime) == 0, f.neg(s_prime), s_prime)
    s = f.select(was_square, s, s_prime)
    c = f.select(was_square, c, r)
    n_t = f.sub(f.mul(f.mul(c, f.sub(r, one)), _k(D_MINUS_ONE_SQ, r0)), d_)
    w0 = f.mul(f.add(s, s), d_)
    w1 = f.mul(n_t, _k(SQRT_AD_MINUS_ONE, r0))
    ss = f.square(s)
    w2 = f.sub(one, ss)
    w3 = f.add(one, ss)
    return ExtPoint(torch.stack([f.mul(w0, w3), f.mul(w2, w1), f.mul(w1, w3), f.mul(w0, w2)]))


def from_uniform_bytes(by: torch.Tensor) -> ExtPoint:
    """(64, B) uniform bytes -> B points (RFC 9496 4.3.4; JAX
    ristretto255.py:165-177): each half with bit 255 masked is a field
    element (reduced mod p, never rejected: its strict 255-bit limbs are a
    TIGHT representative, and the map ignores ``from_bytes_le``'s flag),
    both maps run on one (10, 2B) stack, and one addition sums the
    halves."""
    B = by.shape[-1]
    halves = torch.cat([by[:32], by[32:]], dim=-1)
    halves = torch.cat([halves[:31], (halves[31] & 0x7F)[None]])
    r0, _ = FQ.from_bytes_le(halves)
    pts = elligator(r0).xyzt
    return EDWARDS.add(ExtPoint(pts[..., :B]), ExtPoint(pts[..., B:]))


# the group operations are edwards25519's (JAX ristretto255.py:181-186)
add = EDWARDS.add
double = EDWARDS.double
neg = EDWARDS.neg
identity = EDWARDS.identity
generator = EDWARDS.generator
scalar_mul = EDWARDS.scalar_mul



def mul_base(scalar_bytes: torch.Tensor) -> ExtPoint:
    """[s]B for (32, B) LE scalar bytes by the constant-time comb of the
    scalars' device (``params.comb.mul_base``: 64 mixed additions, no
    doubling; JAX ristretto255.py:189-192)."""
    return _comb_mul_base(scalar_bytes, edwards_comb(scalar_bytes.device))
