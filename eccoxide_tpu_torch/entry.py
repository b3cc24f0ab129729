"""The multichip dry run: the sharded verifier and the sharded MSM driven
over a world of n ranks, and the rank functions it and the tests spawn.

Counterpart of the host half of the JAX entry module at the repository's
root (``_example_verify_batch``, ``dryrun_multichip``). Its weak-scaling harness
is not ported: it means something only with two cards or more.

    from eccoxide_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(torch.cuda.device_count())     # NCCL, one rank a card
    dryrun_multichip(4, device="cpu")               # gloo, four processes
"""

from __future__ import annotations

import random

import numpy as np
import torch

from . import oracle
from .device import resolve_device
from .ops.sha512 import sha512_batch
from .parallel.batch_verify import make_sharded_verify, shard_batch
from .parallel.msm import make_sharded_msm, msm_sharded_example
from .parallel.world import gathered, spawn


def example_verify_batch(B: int):
    """B valid Ed25519 signatures as int32 byte columns (pk (32, B), R (32,
    B), S (32, B), H(R || A || M) (64, B)) from random.Random(1234): the
    bytes of the JAX entry module's example batch."""
    rng = random.Random(1234)
    sks = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(B)]
    msgs = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(B)]
    pks = [oracle.public_key(sk) for sk in sks]
    sigs = [oracle.sign(sk, m) for sk, m in zip(sks, msgs)]
    rs = [s[:32] for s in sigs]
    ss = [s[32:] for s in sigs]
    k_wide = sha512_batch([r + pk + m for r, pk, m in zip(rs, pks, msgs)])

    def cols(bs):
        return np.stack([np.frombuffer(b, np.uint8) for b in bs], axis=1).astype(np.int32)

    return cols(pks), cols(rs), cols(ss), k_wide.astype(np.int32)


def sharded_verify_rank(device, pk, r, s, kw) -> dict:
    """One rank's part of a sharded verify of the whole batch (numpy byte
    columns, every rank the same): its shard through
    ``make_sharded_verify``, then every rank's mask and count gathered.
    Returns {"ok": B bools in batch order, "counts": the count each rank
    holds}."""
    verify = make_sharded_verify(device)
    ok, count = verify(*(shard_batch(a) for a in (pk, r, s, kw)))
    return {"ok": torch.cat(gathered(ok.to(torch.int32))).bool().tolist(),
            "counts": torch.cat(gathered(count.view(1))).tolist()}


def sharded_msm_rank(device, curve: str, xs, ys, ks, c: int) -> dict:
    """One rank's part of a sharded MSM of the whole batch: the affine
    points (xs, ys) of ``curve`` ("edwards25519" or a SEC2 name) and the
    scalars ks as Python ints, every rank the same. Returns {"coords":
    every rank's output coordinates (numpy, rank order), "affine": this
    rank's sum as (x, y) ints}."""
    from .curves import sec2
    from .curves.curve25519 import EDWARDS
    from .curves.edwards import ExtPoint

    dev = resolve_device(device)
    if curve == "edwards25519":
        grp, f = EDWARDS, EDWARDS.field
        x, y = f.encode_ints(xs, dev), f.encode_ints(ys, dev)
        pts = ExtPoint(torch.stack([x, y, f.one(x.shape[1:], dev), f.mul(x, y)]))
        nb = 32
    else:
        grp = sec2.get_curve(curve)
        f = grp.field
        pts = grp.from_affine(f.encode_ints(xs, dev), f.encode_ints(ys, dev))
        nb = grp.scalar.n_bytes
    sc = np.array([list(k.to_bytes(nb, "little")) for k in ks], dtype=np.int32).T
    out = make_sharded_msm(grp, c=c)(type(pts)(shard_batch(pts.coords)), shard_batch(sc))
    ax, ay = grp.to_affine(out)
    return {"coords": [p.cpu().numpy() for p in gathered(out.coords)],
            "affine": (f.decode_ints(ax)[0], f.decode_ints(ay)[0])}


def dryrun_rank(device, n: int) -> dict:
    """One rank of ``dryrun_multichip``: the sharded verify of
    ``example_verify_batch(2n)``, which every rank must count as 2n, then
    ``msm_sharded_example``."""
    B = 2 * n
    report = sharded_verify_rank(device, *example_verify_batch(B))
    if report["counts"] != [B] * n:
        raise RuntimeError(f"sharded verify rejected a valid batch: {report['counts']} of {B}")
    return {"counts": report["counts"], "msm": msm_sharded_example(device)}


def dryrun_multichip(n: int, device="cuda") -> dict:
    """Spawn a world of n ranks on ``device`` (one card a rank on NCCL, n
    CPU processes on gloo) and run ``dryrun_rank`` on each; returns rank 0's
    report. Raises before any process starts when the card or NCCL is
    missing."""
    return spawn(dryrun_rank, n, device, n)
