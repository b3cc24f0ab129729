"""Fixed-base tables of edwards25519 and of the SEC2 curves, generated on
first use from Python ints (``_intcurve.py``, ``oracle.WCurve``), and the
constant-time comb ``mul_base`` over them. Counterpart of the JAX
package's ``params/comb.py``.

Edwards entries are affine points (x, y, t = xy) encoded as canonical FQ
limbs of the port's format, int32 numpy arrays whose last axis is the 10
limbs. They are built in a few milliseconds and cached read-only; a caller
moves them to its device (``protocol.ed25519.VerifyTables``,
``SignTables``). A ``WeierstrassComb`` keeps its affine (x, y) entries the
same way and moves them to a device on request.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..curves.curve25519 import D, ED_GX, ED_GY, EDWARDS, L, P
from ..curves.edwards import ExtPoint
from ..field import WIDTHS
from ..device import resolve_device
from ..limbs import ct_lookup, int_to_limbs
from ..oracle import WCurve
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
    masked sum of all 16 entries (``limbs.ct_lookup``). Entry 0 is the affine identity (0, 1, 0), which the complete
    mixed addition absorbs."""
    B = scalar_bytes.shape[1]
    dev = scalar_bytes.device
    nib = torch.arange(N_WINDOWS, device=dev)
    digits = (scalar_bytes[nib // 2] >> (4 * (nib % 2))[:, None]) & 0xF   # (64, B)
    ids = torch.arange(16, device=dev)
    acc = EDWARDS.identity((B,), dev)
    for i in range(N_WINDOWS):
        acc = EDWARDS.add_mixed(acc, ct_lookup(comb[i, :, :, :, None], digits[i], ids))
    return acc


# ---------------------------------------------------------------------------
# short Weierstrass (JAX params/comb.py:59-80, 148-212, 263)
# ---------------------------------------------------------------------------


def _gen_table_weierstrass(spec) -> list:
    """n_windows x 16 affine entries: window i, entry j is [j 16^i]G, entry
    0 None (the identity)."""
    p = spec.field.p
    o = WCurve(p=p, a=spec.a % p, b=spec.b_coeff % p, gx=spec.gx, gy=spec.gy,
               order=spec.scalar.p)
    n_windows = -(-spec.scalar.bits // 4)
    win, base = [], (spec.gx, spec.gy)
    for _ in range(n_windows):
        entries, acc = [None], base
        for _ in range(15):
            entries.append(acc)
            acc = o.add(acc, base)
        win.append(entries)
        base = acc                          # [16] * window base
    return win


class WeierstrassComb:
    """Comb fixed-base multiplier of a short-Weierstrass curve: one complete
    addition per 4-bit window of the scalar, no doublings. Entry 0 of every
    window is the identity, realised as (0 : 1 : 0) by a masked Z."""

    def __init__(self, spec):
        self.spec = spec
        f = spec.field
        tbl = _gen_table_weierstrass(spec)
        self.n_windows = len(tbl)
        xs = np.zeros((self.n_windows, 16, f.n), dtype=np.int32)
        ys = np.zeros_like(xs)
        for i, entries in enumerate(tbl):
            for j, e in enumerate(entries):
                x, y = (0, 1) if e is None else e
                xs[i, j] = int_to_limbs(x, f.widths)
                ys[i, j] = int_to_limbs(y, f.widths)
        self.xs, self.ys = _frozen(xs, ys)
        self._on: dict = {}

    def tables(self, device="cuda") -> torch.Tensor:
        """The entries as int32 (n_windows, 16, 2, n) x|y rows on device."""
        dev = resolve_device(device)
        if dev not in self._on:
            self._on[dev] = torch.from_numpy(np.stack([self.xs, self.ys], axis=2)).to(dev)
        return self._on[dev]

    def mul_base(self, scalar_bytes: torch.Tensor, tables=None):
        """[k]G for (scalar n_bytes, *batch) LE scalar bytes k, in constant
        time: window i (bits 4i..4i+3) adds the entry of its digit. The
        digit is secret: the entry is the masked sum of all 16 entries
        (``limbs.ct_lookup``); Z is 1, or 0 for digit 0."""
        from ..curves.weierstrass import ProjPoint

        spec, f = self.spec, self.spec.field
        batch, dev = scalar_bytes.shape[1:], scalar_bytes.device
        if tables is None:
            tables = self.tables(dev)
        nib = torch.arange(self.n_windows, device=dev)
        shift = (4 * (nib % 2)).view((-1,) + (1,) * len(batch))
        digits = (scalar_bytes[nib // 2] >> shift) & 0xF          # (n_windows, *batch)
        tail = (1,) * len(batch)
        ids = torch.arange(16, device=dev)
        one, zero = f.one(batch, dev), f.zero(batch, dev)
        acc = spec.identity(batch, dev)
        for i in range(self.n_windows):
            q = ct_lookup(tables[i].view(tables.shape[1:] + tail), digits[i], ids)
            z = f.select(digits[i] != 0, one, zero)
            acc = spec.add(acc, ProjPoint(torch.cat([q, z[None]])))
        return acc


_combs: dict = {}


def get_weierstrass_comb(spec) -> WeierstrassComb:
    if spec.name not in _combs:
        _combs[spec.name] = WeierstrassComb(spec)
    return _combs[spec.name]
