"""Limb <-> integer/byte conversions for the port's field formats.

A batch of field elements is an int32 tensor of shape ``(n_limbs, *batch)``:
limbs on the leading axis, the batch contiguous on the last axis, so a CUDA
thread per lane reads limb ``i`` of lane ``j`` at ``i * W + j`` and
neighbouring threads read neighbouring words.

A format is a tuple of limb widths in bits, little-endian: limb ``i`` holds
bits ``[off_i, off_i + w_i)`` of the value. FQ uses ``(26, 25) * 5``
(radix 2^25.5), FL uses ``(16,) * 16``. Byte columns are int32 ``(n_bytes,
*batch)`` with values in [0, 256), the layout the protocol functions take.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch


def offsets(widths) -> list[int]:
    """Bit offset of every limb of a format."""
    out, o = [], 0
    for w in widths:
        out.append(o)
        o += w
    return out


def int_to_limbs(v: int, widths) -> list[int]:
    """Non-negative int -> strict limbs (each < 2^w_i); raises if v does not
    fit the format."""
    if v < 0:
        raise ValueError("int_to_limbs expects a non-negative value")
    out = []
    for o, w in zip(offsets(widths), widths):
        out.append((v >> o) & ((1 << w) - 1))
    if v >> sum(widths):
        raise ValueError(f"value does not fit in {sum(widths)} bits")
    return out


def ints_to_limbs(vals, widths) -> np.ndarray:
    """B ints -> (n, B) int32 numpy limbs."""
    out = np.zeros((len(widths), len(vals)), dtype=np.int32)
    for j, v in enumerate(vals):
        out[:, j] = int_to_limbs(int(v), widths)
    return out


def limbs_to_ints(arr, widths) -> list[int]:
    """(n, B) limbs (any non-negative limb values) -> B Python ints."""
    a = np.asarray(arr.cpu() if isinstance(arr, torch.Tensor) else arr)
    a = a.reshape(a.shape[0], -1)
    offs = offsets(widths)
    return [
        sum(int(a[i, j]) << offs[i] for i in range(a.shape[0]))
        for j in range(a.shape[1])
    ]


def bytes_to_limbs(by: torch.Tensor, widths) -> torch.Tensor:
    """(n_bytes, *batch) LE byte columns -> (n, *batch) int32 strict limbs.

    Bits beyond the last byte read as zero; bits beyond the format are
    dropped."""
    nb = by.shape[0]
    b64 = by.to(torch.int64)
    rows = []
    for o, w in zip(offsets(widths), widths):
        q, r = divmod(o, 8)
        v = torch.zeros_like(b64[0])
        k, got = 0, -r
        while got < w and q + k < nb:
            v = v | (b64[q + k] << (8 * k))
            got += 8
            k += 1
        rows.append((v >> r) & ((1 << w) - 1))
    return torch.stack(rows).to(torch.int32)


def limbs_to_bytes(x: torch.Tensor, widths, n_bytes: int) -> torch.Tensor:
    """(n, *batch) strict limbs -> (n_bytes, *batch) int32 LE byte columns."""
    offs = offsets(widths)
    x64 = x.to(torch.int64)
    rows = []
    for j in range(n_bytes):
        bit = 8 * j
        if bit >= sum(widths):
            rows.append(torch.zeros_like(x64[0]))
            continue
        q = bisect.bisect_right(offs, bit) - 1      # the limb holding `bit`
        r = bit - offs[q]
        v = x64[q] >> r
        if widths[q] - r < 8 and q + 1 < len(widths):
            v = v | (x64[q + 1] << (widths[q] - r))
        rows.append(v & 0xFF)
    return torch.stack(rows).to(torch.int32)


def windows_from_bytes_le(by: torch.Tensor, n_windows: int) -> torch.Tensor:
    """(n_bytes, B) LE scalar bytes -> (n_windows, B) 4-bit digits, most
    significant first (the operand of a window scalar multiplication)."""
    bits = 4 * (n_windows - 1 - np.arange(n_windows))
    q = torch.as_tensor(bits // 8, device=by.device)
    r = torch.as_tensor(bits % 8, device=by.device)
    return (by[q] >> r[:, None]) & 0xF


def ct_lookup(table: torch.Tensor, idx: torch.Tensor, ids=None) -> torch.Tensor:
    """table[idx] for a secret (*batch,) index into an int32 table of shape
    (entries, *row, *batch), its batch axes of size 1 where every lane reads
    the same entries: the sum over all entries, each masked by its own
    equality with idx, in int32. No gather and no float product: every
    entry is read for every lane, and limbs are summed exactly. ``ids`` is
    ``torch.arange(entries)`` on the table's device, made once by a caller
    that looks up many times."""
    if ids is None:
        ids = torch.arange(table.shape[0], device=table.device)
    sel = ids.view((-1,) + (1,) * idx.dim()) == idx[None]
    sel = sel.view((table.shape[0],) + (1,) * (table.dim() - 1 - idx.dim()) + tuple(idx.shape))
    return torch.where(sel, table, 0).sum(0, dtype=torch.int32)
