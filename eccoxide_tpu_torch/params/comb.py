"""Fixed-base tables of edwards25519, generated on first use from Python
ints (``_intcurve.py``), and the constant-time comb ``mul_base`` over them.
Counterpart of the JAX package's ``params/comb.py``.

Entries are affine points (x, y, t = xy) encoded as canonical FQ limbs of
the port's format, int32 numpy arrays whose last axis is the 10 limbs.
They are built in a few milliseconds and cached read-only; a caller moves
them to its device (``protocol.ed25519.VerifyTables``, ``SignTables``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..curves.curve25519 import D, ED_GX, ED_GY, EDWARDS, L, P
from ..curves.edwards import ExtPoint
from ..field import WIDTHS
from ..limbs import int_to_limbs
from ._intcurve import ECurve

_CURVE = ECurve(p=P, a=P - 1, d=D, gx=ED_GX, gy=ED_GY, order=L)
N_WINDOWS = -(-L.bit_length() // 4)   # 64 windows of 4 bits


def _enc(v: int) -> list[int]:
    return int_to_limbs(v % P, WIDTHS)


def _frozen(*arrays):
    for a in arrays:
        a.setflags(write=False)
    return arrays


@functools.cache
def edwards_byte_table():
    """[k]B for k = 0..255 (entry 0 the identity (0, 1), t = 0), for the
    8-bit windows of the verify-side Straus chain. Returns (xs, ys, ts),
    each (256, 10) int32."""
    xs = np.zeros((256, 10), dtype=np.int32)
    ys = np.zeros_like(xs)
    ts = np.zeros_like(xs)
    ys[0] = _enc(1)
    acc = (0, 1)
    for k in range(1, 256):
        acc = _CURVE.add(acc, (ED_GX, ED_GY))
        xs[k], ys[k], ts[k] = _enc(acc[0]), _enc(acc[1]), _enc(acc[0] * acc[1])
    return _frozen(xs, ys, ts)


@functools.cache
def comb_tables():
    """Window i, entry j: [j * 16^i]B (entry 0 the identity), for the
    fixed-base gather of the batch verifier. Returns (xs, ys, ts), each
    (64, 16, 10) int32."""
    xs = np.zeros((N_WINDOWS, 16, 10), dtype=np.int32)
    ys = np.zeros_like(xs)
    ts = np.zeros_like(xs)
    base = (ED_GX, ED_GY)
    for i in range(N_WINDOWS):
        ys[i, 0] = _enc(1)
        acc = base
        for j in range(1, 16):
            xs[i, j], ys[i, j] = _enc(acc[0]), _enc(acc[1])
            ts[i, j] = _enc(acc[0] * acc[1])
            acc = _CURVE.add(acc, base)
        base = acc                          # [16] * window base
    return _frozen(xs, ys, ts)


def mul_base(scalar_bytes: torch.Tensor, comb: torch.Tensor) -> ExtPoint:
    """[s]B for (32, B) LE scalar bytes s, in constant time: 64 windows of
    4 bits, window i (bits 4i..4i+3) adding [digit 16^i]B with one mixed
    addition (one launch of the add kernel on the card), no doublings.

    ``comb`` is ``comb_tables()`` as (64, 16, 3, 10) int32 x|y|t rows on
    the scalar's device. The digit is secret: each window's entry is the
    sum of all 16 entries, each masked by its own equality with the digit,
    in int32 (never a gather, and never a float product, which would round
    limbs). Entry 0 is the affine identity (0, 1, 0), which the complete
    mixed addition absorbs."""
    B = scalar_bytes.shape[1]
    dev = scalar_bytes.device
    nib = torch.arange(N_WINDOWS, device=dev)
    digits = (scalar_bytes[nib // 2] >> (4 * (nib % 2))[:, None]) & 0xF   # (64, B)
    ids = torch.arange(16, device=dev).view(16, 1, 1, 1)
    acc = EDWARDS.identity((B,), dev)
    for i in range(N_WINDOWS):
        sel = ids == digits[i]                                     # (16, 1, 1, B)
        q = torch.where(sel, comb[i, :, :, :, None], 0).sum(0, dtype=torch.int32)
        acc = EDWARDS.add_mixed(acc, q)
    return acc
