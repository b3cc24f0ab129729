"""Carry state across between the JAX package's limb formats and the port's.

The JAX package stores FQ as 20 limbs of 13 bits (standard domain), FL as
22 limbs of 12 bits in the Montgomery domain with R = 2^264, and FQ448
(curve448's field) as 38 limbs of 12 bits; the port stores FQ as 10 limbs
of radix 2^25.5, FL as 16 limbs of 16 bits in the Montgomery domain with
R = 2^256, and FQ448 as 16 limbs of 28 bits. Both sides are numpy/torch ``(n, B)``
int32 arrays; the conversion goes through Python ints, so it is for tests
and one-off tables, not for a hot path.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field448
from .field import FL, FL_WIDTHS, FQ, L, P, R_FL, WIDTHS
from .field448 import FQ448
from .limbs import ints_to_limbs, limbs_to_ints

JAX_FQ = (20, 13)                 # (limbs, bits)
JAX_FL = (22, 12)
JAX_FQ448 = (38, 12)
R_JAX_FL = 1 << 264


def _jax_ints(arr, b: int) -> list[int]:
    a = np.asarray(arr)
    return [sum(int(a[i, j]) << (b * i) for i in range(a.shape[0]))
            for j in range(a.shape[1])]


def from_jax_limbs(field, arr) -> torch.Tensor:
    """A JAX limb array (n_jax, B) of FQ, FL or FQ448 -> the port's (n, B)
    int32 tensor for the same field elements (canonical limbs)."""
    if field is FQ:
        vals = [v % P for v in _jax_ints(arr, JAX_FQ[1])]
        return torch.from_numpy(ints_to_limbs(vals, WIDTHS))
    if field is FQ448:
        vals = [v % field448.P for v in _jax_ints(arr, JAX_FQ448[1])]
        return torch.from_numpy(ints_to_limbs(vals, field448.WIDTHS))
    if field is FL:
        inv = pow(R_JAX_FL, -1, L)
        vals = [v * inv % L * R_FL % L for v in _jax_ints(arr, JAX_FL[1])]
        return torch.from_numpy(ints_to_limbs(vals, FL_WIDTHS))
    raise ValueError(f"no JAX format for field {field!r}")


def to_jax_limbs(field, arr) -> np.ndarray:
    """The port's (n, B) limbs of FQ, FL or FQ448 -> the JAX package's
    (n_jax, B) int32 limbs of the same elements (canonical)."""
    if field is FQ:
        vals = [v % P for v in limbs_to_ints(arr, WIDTHS)]
        return ints_to_limbs(vals, (JAX_FQ[1],) * JAX_FQ[0])
    if field is FQ448:
        vals = [v % field448.P for v in limbs_to_ints(arr, field448.WIDTHS)]
        return ints_to_limbs(vals, (JAX_FQ448[1],) * JAX_FQ448[0])
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
