"""Pippenger multi-scalar multiplication for the batch verifier.

Counterpart of ``msm_multi_prefix`` and its helpers in
the JAX package's ``parallel/msm.py``. Inputs are public (signature data), so
the digits may drive sorts and gathers. Completeness of the addition law
makes any order of additions and identity padding safe.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.edwards import ExtPoint


def _window_digits(scalar_bytes, c: int, n_windows: int):
    """(nbytes, B) LE bytes -> (n_windows, B) int64 c-bit digits, LSB
    window first."""
    if not 1 <= c <= 16:
        raise ValueError("window width out of range")
    dev = scalar_bytes.device
    by = torch.cat([scalar_bytes.to(torch.int64),
                    torch.zeros((3,) + scalar_bytes.shape[1:],
                                dtype=torch.int64, device=dev)])
    bits = np.arange(n_windows) * c
    q = torch.as_tensor(bits // 8, device=dev)
    r = torch.as_tensor(bits % 8, device=dev)
    v = by[q] | (by[q + 1] << 8) | (by[q + 2] << 16)
    return (v >> r[:, None]) & ((1 << c) - 1)


def _rev_bits(x, nb: int):
    """Bit-reverse the low nb bits of an integer tensor or numpy array."""
    v = x * 0
    for i in range(nb):
        v = v | (((x >> i) & 1) << (nb - 1 - i))
    return v


def _horner_fold(group, ws: ExtPoint, n_windows: int, c: int) -> ExtPoint:
    """acc = [2^c] acc + S_w from the top window down (one doubling launch
    per window); ws has batch (n_windows,), the result batch (1,)."""
    acc = group.identity((1,), ws.xyzt.device)
    for w in range(n_windows - 1, -1, -1):
        acc = group.double(acc, k=c)
        acc = group.add(acc, ExtPoint(ws.xyzt[..., w:w + 1]))
    return acc


def _tree_reduce_points_ops(group, pts: ExtPoint, axis_size: int) -> ExtPoint:
    """Sum the last batch axis (padded with identity to a power of two) by
    halving: log2 additions, each over the full remaining width."""
    size = 1
    while size < axis_size:
        size *= 2
    x = pts.xyzt
    if size != axis_size:
        ident = group.identity((size - axis_size,), x.device).xyzt
        x = torch.cat([x, ident], dim=-1)
    while size > 1:
        half = size // 2
        x = group.add(ExtPoint(x[..., :half]), ExtPoint(x[..., half:])).xyzt
        size = half
    return ExtPoint(x)


def msm_multi_prefix(group, terms, c: int = 12) -> ExtPoint:
    """sum_t sum_i [s_ti] P_ti for ``terms`` = [(points (B,), scalar bytes
    (nbytes_t, B)), ...] sharing B; byte lengths may differ.

    Per window w of every term (windows of all terms stacked on one axis,
    NW in all), with digits d_i:

    1. sort the points by digit and lay them out in bit-reversed order of
       the sorted position (identity in the padding up to B2 = 2^k >= B);
    2. Blelloch up-sweep: level l holds the sums of aligned 2^l blocks,
       each level one addition of the two contiguous halves;
    3. Blelloch down-sweep to the exclusive prefix sum of every sorted
       position, still bit-reversed: D <- concat(D, D + left half of the
       level below), freeing each level as it is consumed;
    4. S_j, the sum of the points with digit <= j, is the exclusive prefix
       at t_j = searchsorted(digits, j, right) (the window total when
       t_j = B2), fetched with one gather for all j < 2^c - 1;
    5. sum_j j B_j = (2^c - 1) total - sum_{j < 2^c - 1} S_j, with the
       first term as one run of c doublings and one subtraction and the
       second as a halving tree.

    Equal-index windows of the terms carry the same weight 2^(c w) and are
    added before one Horner fold. Every addition and doubling is
    ``group``'s, so on CUDA tensors each one is a kernel launch.
    """
    m = 1 << c
    B = terms[0][0].xyzt.shape[-1]
    dev = terms[0][0].xyzt.device
    B2 = 1 << max(0, (B - 1).bit_length())
    nlev = B2.bit_length() - 1
    brev = _rev_bits(np.arange(B2), nlev)
    pad_tail = torch.as_tensor(brev >= B, device=dev)
    brev_src = torch.as_tensor(np.minimum(brev, B - 1), device=dev)
    ident1 = group.identity((1,), dev).xyzt                 # (4, 10, 1)

    ds_all, pts_all, nw_list = [], [], []
    for pts, scalar_bytes in terms:
        nw = -(-scalar_bytes.shape[0] * 8 // c)
        nw_list.append(nw)
        digits = _window_digits(scalar_bytes, c, nw)        # (nw, B)
        ds, order = torch.sort(digits, dim=-1, stable=True)
        g = pts.xyzt[:, :, order[:, brev_src]]              # (4, 10, nw, B2)
        if B2 != B:
            g = torch.where(pad_tail, ident1[..., None], g)
        ds_all.append(ds)
        pts_all.append(g)
    ds = torch.cat(ds_all).contiguous()                     # (NW, B)
    x = torch.cat(pts_all, dim=2)                           # (4, 10, NW, B2)
    NW = ds.shape[0]
    del pts_all

    levels = [x]
    width = B2
    for _ in range(nlev):
        half = width // 2
        x = group.add(ExtPoint(x[..., :half]), ExtPoint(x[..., half:])).xyzt
        levels.append(x)
        width = half
    total = levels[-1]                                      # (4, 10, NW, 1)

    D = ident1[..., None].expand(4, 10, NW, 1).contiguous()
    for lev in range(nlev - 1, -1, -1):
        half = B2 >> (lev + 1)
        left = levels[lev][..., :half]
        levels[lev] = None
        grown = group.add(ExtPoint(D), ExtPoint(left)).xyzt
        D = torch.cat([D, grown], dim=-1)
    del levels

    j = torch.arange(m - 1, device=dev).expand(NW, m - 1).contiguous()
    t = torch.searchsorted(ds, j, right=True)               # (NW, m-1) in [0, B]
    pos = _rev_bits(t.clamp(max=B2 - 1), nlev)
    S = D.gather(-1, pos[None, None].expand(4, 10, NW, m - 1))
    S = torch.where((t == B2)[None, None], total, S)
    del D

    acc = group.double(ExtPoint(total), k=c)
    acc = group.add(acc, group.neg(ExtPoint(total)))
    ssum = S
    size = m - 1
    while size > 1:
        half = size // 2
        merged = group.add(ExtPoint(ssum[..., :half]),
                         ExtPoint(ssum[..., half:2 * half])).xyzt
        ssum = torch.cat([merged, ssum[..., 2 * half:]], dim=-1)
        size = half + (size - 2 * half)
    ws = group.add(acc, group.neg(ExtPoint(ssum))).xyzt         # (4, 10, NW, 1)

    max_nw = max(nw_list)
    per_w = None
    off = 0
    for nw in nw_list:
        cur = ws[:, :, off:off + nw, 0]
        if nw < max_nw:
            cur = torch.cat([cur, group.identity((max_nw - nw,), dev).xyzt], -1)
        per_w = ExtPoint(cur) if per_w is None else group.add(per_w, ExtPoint(cur))
        off += nw
    return _horner_fold(group, per_w, max_nw, c)
