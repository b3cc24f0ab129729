"""Ed25519 random-linear-combination (RLC) batch verification.

Counterpart of the JAX package's ``protocol/ed25519_batch.py``. A batch is
checked with one equation,

    [sum_i z_i S_i] B  -  sum_i [z_i k_i] A_i  -  sum_i [z_i] R_i  ==  0,

for random nonzero 128-bit z_i: if every signature is valid the sum is the
identity; if any is not, the check fails except with probability <= 2^-128
over the z_i. The two variable-base sums run as one window-stacked MSM
(``parallel/msm.py``), the fixed-base term as a gather of comb entries.
When the batch is rejected, ``verify_batch_host`` runs the per-signature
verifier to find out which signatures failed, so each signature gets the
answer the per-signature verifier gives (w.h.p.).
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.curve25519 import EDWARDS as ED
from ..curves.curve25519 import FL, FQ
from ..curves.edwards import ExtPoint
from ..parallel.msm import _tree_reduce_points_ops, msm_multi_prefix
from . import ed25519 as base

Z_BYTES = 16  # 128-bit randomizers


def _mul_base_gather(c_bytes, tables: base.VerifyTables) -> ExtPoint:
    """[c]B for ONE public scalar (32, 1): gather T_w[d_w] = [d_w 16^w]B
    for the 64 4-bit digits and sum them with a halving tree."""
    dev = c_bytes.device
    nw = tables.comb.shape[1]
    w = torch.arange(nw, device=dev)
    d = (c_bytes[w // 2, 0] >> (4 * (w % 2))) & 0xF
    px, py, pt = tables.comb[:, w, d.long()].permute(0, 2, 1)   # (10, nw) each
    pts = ExtPoint(torch.stack([px, py, FQ.one((nw,), dev), pt]).contiguous())
    return _tree_reduce_points_ops(ED, pts, nw)


def _fold_sum_scalar(x):
    """Sum a (16, B) batch of FL elements over the batch axis with a halving
    tree of FL.add calls."""
    B = x.shape[1]
    while B > 1:
        h = (B + 1) // 2
        lo, hi = x[:, :h], x[:, h:]
        if hi.shape[1] < h:
            hi = torch.cat([hi, torch.zeros_like(lo[:, : h - hi.shape[1]])], 1)
        x = FL.add(lo, hi)
        B = h
    return x


def rlc_verify_core(pk_bytes, r_bytes, s_bytes, k_wide_bytes, z_bytes,
                    tables: base.VerifyTables, msm_c: int = 8):
    """0-d bool: every encoding decodes and is canonical AND the RLC
    equation holds. z: (Z_BYTES, B) nonzero random byte columns."""
    A, ok_a = ED.decompress(pk_bytes)
    R, ok_r = ED.decompress(r_bytes)
    s, ok_s = FL.from_bytes_le(s_bytes)
    k = FL.from_wide_bytes_le(k_wide_bytes)
    zpad = torch.cat([z_bytes, torch.zeros_like(z_bytes[:FL.n_bytes - Z_BYTES])])
    z, _ = FL.from_bytes_le(zpad)          # < 2^128 < l: always canonical

    zk_bytes = FL.to_bytes_le(FL.mul(z, k))
    c_bytes = FL.to_bytes_le(_fold_sum_scalar(FL.mul(z, s)))

    fixed = _mul_base_gather(c_bytes, tables)               # [sum z_i s_i] B
    m = msm_multi_prefix(
        ED, [(ED.neg(A), zk_bytes), (ED.neg(R), z_bytes)], c=msm_c,
    )                                  # -[sum z_i k_i A_i] - [sum z_i R_i]
    total = ED.add(fixed, m)
    is_id = FQ.is_zero(total.x) & FQ.eq(total.y, total.z)
    return (ok_a & ok_r & ok_s).all() & is_id[0]


def sample_z(B: int, rng: np.random.Generator | None = None) -> np.ndarray:
    """(Z_BYTES, B) int32 nonzero random byte columns."""
    if rng is None:
        rng = np.random.default_rng()
    z = rng.integers(0, 256, size=(Z_BYTES, B), dtype=np.int64)
    # z_i == 0 (prob 2^-128) would void the soundness bound: force nonzero
    zero = (z == 0).all(axis=0)
    z[0] = np.where(zero, 1, z[0])
    return z.astype(np.int32)


def verify_batch_host(pks: list[bytes], msgs: list[bytes], sigs: list[bytes],
                      rng: np.random.Generator | None = None, device="cuda",
                      tables: base.VerifyTables | None = None) -> list[bool]:
    """Batch verify on ``device``; on rejection, the per-signature verifier
    on the same device says which signatures failed."""
    dev = base.resolve_device(device)
    tables = tables if tables is not None else base.VerifyTables(dev)
    B = len(pks)
    pkc, rc, sc, kwc = base.host_inputs(pks, msgs, sigs, dev)
    z = torch.from_numpy(sample_z(B, rng)).to(dev)
    # 2^c buckets pay off once each window has ~2^c points to amortize them
    msm_c = 8 if B >= 4096 else 4
    if bool(rlc_verify_core(pkc, rc, sc, kwc, z, tables, msm_c=msm_c)):
        return [True] * B
    return base.verify_core(pkc, rc, sc, kwc, tables).cpu().tolist()
