"""Pippenger multi-scalar multiplication over any group of the port, on one
device or batch-sharded over a world of ranks.

Counterpart of ``msm_local``, ``msm_local_window_sums``,
``msm_local_prefix``, ``msm_local_window_sums_prefix``,
``msm_multi_prefix``, ``make_sharded_msm``, ``msm_sharded_example`` and
their helpers in the JAX package's ``parallel/msm.py``. A group is a curve
object (``curves.curve25519.EDWARDS``, a SEC2 ``WeierstrassCurveSpec``) with ``identity``, ``add``, ``neg`` and
``double(p, k=...)``; its points (``ExtPoint``, ``ProjPoint``) keep their
packed coordinates, (coordinates, limbs, *batch), in ``coords``, and
``type(p)(tensor)`` makes a point of the same class. On edwards25519 a
run of k doublings is one kernel launch; on a SEC2 curve it is k plain
doublings. Inputs are public (signature data, public points), so the
digits may drive sorts and gathers. Completeness of the addition laws
makes any order of additions and identity padding safe.
"""

from __future__ import annotations

import random

import numpy as np
import torch
import torch.distributed as dist

from ..spans import span
from . import world


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


def _horner_fold(group, ws, n_windows: int, c: int):
    """acc = [2^c] acc + S_w from the top window down (one doubling run
    per window); ws has batch (n_windows,), the result batch (1,)."""
    acc = group.identity((1,), ws.coords.device)
    for w in range(n_windows - 1, -1, -1):
        acc = group.double(acc, k=c)
        acc = group.add(acc, type(ws)(ws.coords[..., w:w + 1]))
    return acc


def _tree_reduce_points_ops(group, pts, axis_size: int):
    """Sum the last batch axis (padded with identity to a power of two) by
    halving: log2 additions, each over the full remaining width."""
    size = 1
    while size < axis_size:
        size *= 2
    x, wrap = pts.coords, type(pts)
    if size != axis_size:
        ident = group.identity((size - axis_size,), x.device).coords
        x = torch.cat([x, ident], dim=-1)
    while size > 1:
        half = size // 2
        x = group.add(wrap(x[..., :half]), wrap(x[..., half:])).coords
        size = half
    return wrap(x)


def _sorted_windows(group, pts, digits):
    """Step 1 of the bucket machinery for (nw, B) digits of the points
    ``pts`` (batch (B,)): per window, the digits sorted and the points
    sorted by digit, laid out in bit-reversed order of the sorted position
    with the identity in the padding up to B2 = 2^k >= B. Returns (sorted
    digits (nw, B), coords (k, n, nw, B2))."""
    B = digits.shape[-1]
    dev = digits.device
    B2 = 1 << max(0, (B - 1).bit_length())
    brev = _rev_bits(np.arange(B2), B2.bit_length() - 1)
    ds, order = torch.sort(digits, dim=-1, stable=True)
    g = pts.coords[:, :, order[:, torch.as_tensor(np.minimum(brev, B - 1), device=dev)]]
    if B2 != B:
        ident1 = group.identity((1,), dev).coords
        g = torch.where(torch.as_tensor(brev >= B, device=dev), ident1[..., None], g)
    return ds, g


def _bucket_sums(group, wrap, ds, x, c: int):
    """Steps 2-5 over NW stacked windows: sorted digits ds (NW, B), their
    points x (k, n, NW, B2) from ``_sorted_windows``; returns sum_j j B_j of
    every window, coords (k, n, NW, 1). ``wrap`` makes a point of the
    group's class from coords."""
    m = 1 << c
    NW, B2 = ds.shape[0], x.shape[-1]
    nlev = B2.bit_length() - 1
    dev = x.device
    ident1 = group.identity((1,), dev).coords               # (k, n, 1)

    with span("msm.sweeps"):
        levels = [x]
        width = B2
        for _ in range(nlev):
            half = width // 2
            x = group.add(wrap(x[..., :half]), wrap(x[..., half:])).coords
            levels.append(x)
            width = half
        total = levels[-1]                                  # (k, n, NW, 1)

        D = ident1[..., None].expand(*ident1.shape[:2], NW, 1).contiguous()
        for lev in range(nlev - 1, -1, -1):
            half = B2 >> (lev + 1)
            left = levels[lev][..., :half]
            levels[lev] = None
            grown = group.add(wrap(D), wrap(left)).coords
            D = torch.cat([D, grown], dim=-1)
        del levels

    j = torch.arange(m - 1, device=dev).expand(NW, m - 1).contiguous()
    t = torch.searchsorted(ds, j, right=True)               # (NW, m-1) in [0, B]
    pos = _rev_bits(t.clamp(max=B2 - 1), nlev)
    S = D.gather(-1, pos[None, None].expand(*D.shape[:2], NW, m - 1))
    S = torch.where((t == B2)[None, None], total, S)
    del D

    acc = group.double(wrap(total), k=c)
    acc = group.add(acc, group.neg(wrap(total)))
    ssum = S
    size = m - 1
    while size > 1:
        half = size // 2
        merged = group.add(wrap(ssum[..., :half]), wrap(ssum[..., half:2 * half])).coords
        ssum = torch.cat([merged, ssum[..., 2 * half:]], dim=-1)
        size = half + (size - 2 * half)
    return group.add(acc, group.neg(wrap(ssum))).coords


def msm_local_window_sums(group, pts, digits, c: int):
    """Per-window weighted bucket sums sum_j j B_j as a point batch of
    width nw (JAX parallel/msm.py:167-207) for (nw, B) c-bit digits of the
    points ``pts`` (batch (B,)), on the bucket machinery of
    ``msm_multi_prefix``. Returns the same group elements as the JAX
    function (not the same projective coordinates)."""
    ds, x = _sorted_windows(group, pts, digits)
    return type(pts)(_bucket_sums(group, type(pts), ds.contiguous(), x, c)[..., 0])


def _window_sums(group, pts, scalar_bytes, c: int):
    """The c-bit windows' bucket sums of the points ``pts`` (batch (B,))
    and their (nbytes, B) LE scalar bytes: a point batch of width
    n_windows."""
    n_windows = -(-scalar_bytes.shape[0] * 8 // c)
    return msm_local_window_sums(group, pts, _window_digits(scalar_bytes, c, n_windows), c)


def msm_local(group, pts, scalar_bytes, c: int = 8):
    """sum_i [s_i] P_i (batch (1,)) for points ``pts`` of batch (B,) and
    (nbytes, B) LE scalar bytes (JAX parallel/msm.py:114-123): the c-bit
    windows' bucket sums, then one Horner fold."""
    ws = _window_sums(group, pts, scalar_bytes, c)
    return _horner_fold(group, ws, ws.coords.shape[-1], c)


def msm_local_window_sums_prefix(group, pts, digits, c: int):
    """The JAX prefix-scan form of the window sums (JAX
    parallel/msm.py:209-262): per window, sum_j j B_j = (2^c - 1) S_total -
    sum_{j < 2^c - 1} S_j, S_j the sum of the points with digit <= j, read
    from a prefix sum of the points sorted by digit. That is the form
    ``msm_local_window_sums`` already computes (``_sorted_windows``,
    ``_bucket_sums``), so this is the same computation: the same group
    elements as JAX's, not the same projective coordinates. JAX's ``ops``
    argument (``PallasGroup`` on the TPU) has no counterpart: on CUDA
    tensors the Edwards adds and doubling runs are the port's kernels."""
    return msm_local_window_sums(group, pts, digits, c)


def msm_local_prefix(group, pts, scalar_bytes, c: int = 12):
    """sum_i [s_i] P_i (batch (1,)) by the prefix-scan window sums (JAX
    parallel/msm.py:305-313): ``msm_local``'s contract, with JAX's default
    window c = 12 (ceil(8 nbytes / 12) windows of 2^12 - 1 partial sums,
    a Horner fold of runs of 12 doublings). ``msm_local`` already runs on
    the prefix-scan window sums, so this is ``msm_local`` at JAX's c."""
    return msm_local(group, pts, scalar_bytes, c)


def make_sharded_msm(grp, c: int = 8):
    """The batch-sharded MSM over the world (JAX parallel/msm.py:125-165):
    ``call(pts, scalar_bytes)`` on this rank's shard (points of batch
    (B/D,), (nbytes, B/D) LE scalar bytes, from ``batch_verify.shard_batch``)
    returns sum_i [s_i] P_i over the whole batch, batch (1,). Every rank
    calls it at once. It is ``msm_local`` with the D ranks' window sums
    gathered and added in rank order between the bucket sums and the
    Horner fold, so every rank ends with the same coordinates. Raises
    without a process group, and when its backend does not serve the
    points' device."""

    def call(pts, scalar_bytes):
        world.check_group(pts.coords.device)
        local = _window_sums(grp, pts, scalar_bytes, c)
        # Summed from the identity, as JAX's fori_loop does: D adds of
        # width n_windows, one more than a start from the first part would
        # take, so that the launches are JAX's.
        acc = grp.identity(local.coords.shape[-1:], local.coords.device)
        for part in world.gathered(local.coords):
            acc = grp.add(acc, type(local)(part))
        return _horner_fold(grp, acc, acc.coords.shape[-1], c)

    return call


def msm_sharded_example(device="cuda") -> bool:
    """The multichip dry run's sharded MSM (JAX parallel/msm.py:510-552): on
    p192k1, B = 2D points [b_i]G with scalars k_i from random.Random(5), c =
    4. Every rank of the world makes the whole input from the seed, takes
    its shard and runs ``make_sharded_msm``; the affine sum must equal the
    integer oracle's, else it raises. Returns True."""
    from .. import oracle
    from ..curves import sec2
    from .batch_verify import shard_batch

    dev = world.check_group(device)
    name = "p192k1"
    spec, o = sec2.get_curve(name), oracle.sec2_curve(name)
    rng = random.Random(5)
    B = 2 * dist.get_world_size()
    ks = [rng.randrange(1, o.order) for _ in range(B)]
    base_pts = [o.mul_base(rng.randrange(1, o.order)) for _ in range(B)]
    f = spec.field
    pts = spec.from_affine(f.encode_ints([pt[0] for pt in base_pts], dev),
                           f.encode_ints([pt[1] for pt in base_pts], dev))
    nb = spec.scalar.n_bytes
    sc = np.array([list(k.to_bytes(nb, "little")) for k in ks], dtype=np.int32).T
    out = make_sharded_msm(spec, c=4)(type(pts)(shard_batch(pts.coords)), shard_batch(sc))
    ax, ay = spec.to_affine(out)
    exp = None
    for k, pt in zip(ks, base_pts):
        exp = o.add(exp, o.mul(k, pt))
    if (f.decode_ints(ax)[0], f.decode_ints(ay)[0]) != exp:
        raise RuntimeError("sharded MSM differs from the oracle")
    return True


def msm_multi_prefix(group, terms, c: int = 12):
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
    ``group``'s, so on CUDA tensors each one on edwards25519 is a kernel
    launch.
    """
    with span("msm.multi_prefix"):
        wrap = type(terms[0][0])
        dev = terms[0][0].coords.device
        ds_all, pts_all, nw_list = [], [], []
        for pts, scalar_bytes in terms:
            nw = -(-scalar_bytes.shape[0] * 8 // c)
            nw_list.append(nw)
            ds, g = _sorted_windows(group, pts, _window_digits(scalar_bytes, c, nw))
            ds_all.append(ds)
            pts_all.append(g)
        ds = torch.cat(ds_all).contiguous()                 # (NW, B)
        x = torch.cat(pts_all, dim=2)                       # (k, n, NW, B2)
        del pts_all
        ws = _bucket_sums(group, wrap, ds, x, c)            # (k, n, NW, 1)

        max_nw = max(nw_list)
        per_w = None
        off = 0
        for nw in nw_list:
            cur = ws[:, :, off:off + nw, 0]
            if nw < max_nw:
                cur = torch.cat([cur, group.identity((max_nw - nw,), dev).coords], -1)
            per_w = wrap(cur) if per_w is None else group.add(per_w, wrap(cur))
            off += nw
        return _horner_fold(group, per_w, max_nw, c)
