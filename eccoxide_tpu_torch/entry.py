"""The JAX entry module's counterpart: the verify with its example
arguments, the multichip dry run, the weak-scaling harness, and the rank
functions they and the tests spawn.

Counterpart of the JAX entry module at the repository's root
(``_example_verify_batch``, ``entry``, ``dryrun_multichip``,
``weak_scaling``). The JAX functions run over a device mesh in one
process; here a world of n ranks is n processes (``parallel.world.spawn``),
one card a rank on NCCL, one CPU process a rank on gloo.

    from eccoxide_tpu_torch.entry import dryrun_multichip, entry, weak_scaling
    fn, args = entry()                              # fn(*args): 8 x True
    dryrun_multichip(torch.cuda.device_count())     # NCCL, one rank a card
    dryrun_multichip(4, device="cpu")               # gloo, four processes
    weak_scaling(torch.cuda.device_count(), b_per_device=32768)
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch
import torch.distributed as dist

from . import oracle
from .device import resolve_device
from .ops.sha512 import sha512_batch
from .parallel.batch_verify import make_sharded_verify, shard_batch
from .parallel.msm import make_sharded_msm, msm_sharded_example
from .parallel.world import gathered, spawn
from .protocol.ed25519 import VerifyTables, public_keys_host, sign_host, verify_core


def example_verify_batch(B: int, device=None):
    """B valid Ed25519 signatures as int32 byte columns (pk (32, B), R (32,
    B), S (32, B), H(R || A || M) (64, B)) from random.Random(1234): the
    bytes of the JAX entry module's example batch. The keys and signatures
    come from the integer oracle, or, given a ``device``, from the port's
    ``public_keys_host`` and ``sign_host`` there: the same bytes (Ed25519
    signing is deterministic) at the batch sizes of a timing run, where
    the oracle takes milliseconds a signature."""
    rng = random.Random(1234)
    sks = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(B)]
    msgs = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(B)]
    if device is None:
        pks = [oracle.public_key(sk) for sk in sks]
        sigs = [oracle.sign(sk, m) for sk, m in zip(sks, msgs)]
    else:
        pks = public_keys_host(sks, device)
        sigs = sign_host(sks, msgs, device)
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


def entry(device="cuda"):
    """``(fn, args)``: the batched Ed25519 verify and its example arguments
    (JAX entry module, ``entry``). ``fn`` is ``verify_core``; ``args`` are
    the byte columns of ``example_verify_batch(8)`` on ``device`` and the
    verifier's tables there, and ``fn(*args)`` is eight True."""
    dev = resolve_device(device)
    cols = (torch.from_numpy(a).to(dev) for a in example_verify_batch(8))
    return verify_core, (*cols, VerifyTables(dev))


def weak_scaling_rank(device, b_per_device: int, reps: int) -> float:
    """One rank of ``weak_scaling``: the sharded verify of
    ``example_verify_batch(b_per_device * D)`` (signed on this rank's
    device), one call that must count the whole batch, then ``reps`` timed
    calls after a barrier, ending in ``torch.cuda.synchronize()`` on a
    card. Returns the seconds a call, the largest over the ranks."""
    B = b_per_device * dist.get_world_size()
    verify = make_sharded_verify(device)
    args = [shard_batch(a) for a in example_verify_batch(B, device)]
    ok, count = verify(*args)
    if int(count) != B:
        raise RuntimeError(f"sharded verify rejected a valid batch: {int(count)} of {B}")
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        ok, count = verify(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = torch.tensor([(time.perf_counter() - t0) / reps], dtype=torch.float64, device=device)
    dist.all_reduce(secs, op=dist.ReduceOp.MAX)
    return float(secs)


def weak_scaling(n_devices: int, b_per_device: int = 64, reps: int = 4, device="cuda") -> dict:
    """The weak-scaling harness (JAX entry module, ``weak_scaling``): the
    sharded verify timed in a world of one rank and in a world of
    ``n_devices`` ranks (``spawn``) with the same batch a rank; the
    efficiency is t(1) / t(n). Returns JAX's keys and rounding: ``t1_s``,
    ``t{n}_s`` (4 places), ``weak_scaling_efficiency`` (3). On the card
    each rank needs a card of its own: more ranks than cards raise
    ``ValueError`` before any run. With one rank the efficiency is 1 and
    says nothing of scaling; gloo ranks share the host's cores, so their
    number says nothing of the cards either."""
    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"weak scaling over {n_devices} ranks needs {n_devices} cards, "
                         f"this machine has {torch.cuda.device_count()}")
    times = {nd: spawn(weak_scaling_rank, nd, dev, b_per_device, reps)
             for nd in sorted({1, n_devices})}
    return {"t1_s": round(times[1], 4),
            f"t{n_devices}_s": round(times[n_devices], 4),
            "weak_scaling_efficiency": round(times[1] / times[n_devices], 3)}
