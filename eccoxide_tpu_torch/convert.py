"""Carry state across between the JAX package's limb formats and the port's.

The JAX package stores FQ as 20 limbs of 13 bits (standard domain), FL as
22 limbs of 12 bits in the Montgomery domain with R = 2^264, and FQ448
(curve448's field) as 38 limbs of 12 bits; the port stores FQ as 10 limbs
of radix 2^25.5, FL as 16 limbs of 16 bits in the Montgomery domain with
R = 2^256, and FQ448 as 16 limbs of 28 bits. The SEC2 coordinate fields
are 12- or 13-bit limbs there (``JAX_SEC2``: standard domain, except the
Montgomery domain of p112r1 and p112r2 with R = 2^120) and the port's
28-bit format here (``field_sec2.py``). Both sides are numpy/torch
``(n, B)`` int32 arrays; the conversion goes through Python ints, so it is
for tests and one-off tables, not for a hot path.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field448
from .curves.weierstrass import ProjPoint
from .field import FL, FL_WIDTHS, FQ, L, P, R_FL, WIDTHS
from .field448 import FQ448
from .limbs import ints_to_limbs, limbs_to_ints

JAX_FQ = (20, 13)                 # (limbs, bits)
JAX_FL = (22, 12)
JAX_FQ448 = (38, 12)
R_JAX_FL = 1 << 264
# the JAX package's SEC2 coordinate fields: (limbs, bits, Montgomery R or None)
JAX_SEC2 = {
    "p112r1": (10, 12, 1 << 120), "p112r2": (10, 12, 1 << 120),
    "p128r1": (10, 13, None), "p128r2": (10, 13, None),
    "p160k1": (13, 13, None), "p160r1": (13, 13, None), "p160r2": (13, 13, None),
    "p192k1": (15, 13, None), "p192r1": (15, 13, None),
    "p224k1": (18, 13, None), "p224r1": (18, 13, None),
    "p256k1": (20, 13, None), "p256r1": (20, 13, None),
    "p384r1": (30, 13, None), "p521r1": (44, 12, None),
}


def _jax_ints(arr, b: int) -> list[int]:
    a = np.asarray(arr)
    return [sum(int(a[i, j]) << (b * i) for i in range(a.shape[0]))
            for j in range(a.shape[1])]


def from_jax_limbs(field, arr) -> torch.Tensor:
    """A JAX limb array (n_jax, B) of FQ, FL, FQ448 or a SEC2 field -> the
    port's (n, B) int32 tensor for the same field elements (canonical
    limbs)."""
    if field is FQ:
        vals = [v % P for v in _jax_ints(arr, JAX_FQ[1])]
        return torch.from_numpy(ints_to_limbs(vals, WIDTHS))
    if field is FQ448:
        vals = [v % field448.P for v in _jax_ints(arr, JAX_FQ448[1])]
        return torch.from_numpy(ints_to_limbs(vals, field448.WIDTHS))
    if getattr(field, "name", None) in JAX_SEC2:
        _, b, r = JAX_SEC2[field.name]
        vals = _jax_ints(arr, b)
        if r is not None:
            vals = [v * pow(r, -1, field.p) for v in vals]
        return field.encode_ints(vals, "cpu")
    if field is FL:
        inv = pow(R_JAX_FL, -1, L)
        vals = [v * inv % L * R_FL % L for v in _jax_ints(arr, JAX_FL[1])]
        return torch.from_numpy(ints_to_limbs(vals, FL_WIDTHS))
    raise ValueError(f"no JAX format for field {field!r}")


def to_jax_limbs(field, arr) -> np.ndarray:
    """The port's (n, B) limbs of FQ, FL, FQ448 or a SEC2 field -> the JAX
    package's (n_jax, B) int32 limbs of the same elements (canonical)."""
    if field is FQ:
        vals = [v % P for v in limbs_to_ints(arr, WIDTHS)]
        return ints_to_limbs(vals, (JAX_FQ[1],) * JAX_FQ[0])
    if field is FQ448:
        vals = [v % field448.P for v in limbs_to_ints(arr, field448.WIDTHS)]
        return ints_to_limbs(vals, (JAX_FQ448[1],) * JAX_FQ448[0])
    if getattr(field, "name", None) in JAX_SEC2:
        n, b, r = JAX_SEC2[field.name]
        vals = [v * (r or 1) % field.p for v in limbs_to_ints(arr, field.widths)]
        return ints_to_limbs(vals, (b,) * n)
    if field is FL:
        inv = pow(R_FL, -1, L)
        vals = [v * inv % L * R_JAX_FL % L for v in limbs_to_ints(arr, FL_WIDTHS)]
        return ints_to_limbs(vals, (JAX_FL[1],) * JAX_FL[0])
    raise ValueError(f"no JAX format for field {field!r}")


def tables_from_jax(xs, ys, ts):
    """JAX point tables (..., 20) int32 -> the port's (..., 10) int32, for
    ``edwards_byte_table()`` (256, n) and the comb tables (64, 16, n)."""
    out = []
    for a in (xs, ys, ts):
        a = np.asarray(a)
        flat = a.reshape(-1, a.shape[-1]).T                 # (20, N)
        conv = from_jax_limbs(FQ, flat).numpy().T           # (N, 10)
        out.append(conv.reshape(a.shape[:-1] + (FQ.n,)))
    return tuple(out)


def point_from_jax(field, xyz) -> ProjPoint:
    """A JAX ``ProjPoint`` (X, Y, Z), each (n_jax, B), of a SEC2 curve ->
    the port's ``ProjPoint`` (3, n, B)."""
    return ProjPoint(torch.stack([from_jax_limbs(field, c) for c in xyz]))


def point_to_jax(field, P: ProjPoint):
    """The port's ``ProjPoint`` -> (X, Y, Z) JAX limb arrays (n_jax, B)."""
    return tuple(to_jax_limbs(field, c) for c in P.xyz)


def weierstrass_comb_from_jax(field, xs, ys) -> torch.Tensor:
    """JAX ``WeierstrassComb.tables()`` (each (NW, 16, n_jax) int32) -> the
    port's ``WeierstrassComb.tables`` layout (NW, 16, 2, n) int32."""
    out = []
    for a in (xs, ys):
        a = np.asarray(a)
        flat = a.reshape(-1, a.shape[-1]).T                 # (n_jax, N)
        conv = from_jax_limbs(field, flat).numpy().T        # (N, n)
        out.append(conv.reshape(a.shape[:-1] + (field.n,)))
    return torch.from_numpy(np.ascontiguousarray(np.stack(out, axis=2)))
