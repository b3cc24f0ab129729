"""The port's sharded layer (parallel/world.py, parallel/batch_verify.py,
make_sharded_msm, entry.py) in gloo worlds of CPU processes, against the
unsharded verify_core, msm_local and the port's integer oracle: the cases
of the JAX package's tests/test_parallel.py and tests/test_msm.py
(test_msm_sharded). Each world is a fresh set of spawned processes that
meet at a file:// rendezvous, so xdist workers never share an address.
The comparison with the JAX package is in test_torch_parity_sharded.py.
(Three tests: see test_torch_sign.py for why.)"""

import random
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from eccoxide_tpu_torch import entry, oracle
from eccoxide_tpu_torch.curves import sec2
from eccoxide_tpu_torch.parallel import world
from eccoxide_tpu_torch.parallel.batch_verify import make_sharded_verify, shard_batch
from eccoxide_tpu_torch.parallel.msm import msm_local, msm_sharded_example
from eccoxide_tpu_torch.protocol import ed25519 as pe
from test_torch_msm_local import _affine, _case, _cols, _sum
from world_limit import world_limited

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

# a world of n CPU ranks spawns n interpreters that import torch and the
# port (about 3 s) before a rank verifies 2n signatures and runs the
# example MSM (about 2 s more here)
DRYRUN_BUDGET_S = 60


def tampered_batch():
    """example_verify_batch(16) with the low bit of lane 3's S flipped (JAX
    tests/test_parallel.py)."""
    pk, r, s, kw = entry.example_verify_batch(16)
    s = s.copy()
    s[0, 3] ^= 1
    return pk, r, s, kw


@world_limited
def test_sharded_verify_counts_over_every_rank(monkeypatch, tmp_path):
    pk, r, s, kw = tampered_batch()
    unsharded = pe.verify_core(*(torch.from_numpy(a) for a in (pk, r, s, kw)), pe.VerifyTables("cpu"))
    assert unsharded.tolist() == [i != 3 for i in range(16)]
    for n in (2, 4):
        report = world.spawn(entry.sharded_verify_rank, n, "cpu", pk, r, s, kw)
        assert report["counts"] == [15] * n
        assert report["ok"] == unsharded.tolist()
    # a rank's exception fails the call and carries the rank's traceback
    with pytest.raises(mp.ProcessRaisedException, match="ValueError: a batch of 6 does not split"):
        world.spawn(entry.sharded_verify_rank, 4, "cpu", *(a[:, :6] for a in (pk, r, s, kw)))
    # a gloo rank refuses a tensor of another device instead of moving it
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="cannot shard a tensor on meta"):
            shard_batch(torch.zeros((32, 4), dtype=torch.int32, device="meta"))
        assert shard_batch(pk).device == torch.device("cpu")
    finally:
        dist.destroy_process_group()
    # no group, then a group whose backend does not serve the device
    with pytest.raises(RuntimeError, match="no process group"):
        make_sharded_verify("cpu")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda: "nccl")
    with pytest.raises(RuntimeError, match="cannot serve"):
        make_sharded_verify("cpu")
    # a card without NCCL has no backend
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="no NCCL"):
        world.backend_for("cuda")
    assert world.backend_for("cpu") == "gloo"


def _p192k1_case():
    """JAX tests/test_msm.py's _setup("p192k1", 16, seed=7) on the port's
    oracle, in test_torch_msm_local._case's order."""
    grp, o = sec2.get_curve("p192k1"), oracle.sec2_curve("p192k1")
    rng = random.Random(7)
    ks = [rng.randrange(0, o.order) for _ in range(16)]
    aff = [o.mul_base(rng.randrange(1, o.order)) for _ in range(16)]
    f = grp.field
    pts = grp.from_affine(f.encode_ints([a[0] for a in aff], "cpu"),
                          f.encode_ints([a[1] for a in aff], "cpu"))
    return grp, o, pts, aff, ks, grp.scalar.n_bytes


@world_limited
def test_sharded_msm_equal_on_every_rank():
    """p192k1 in a world of 4 with c = 4; edwards25519 in a world of 2 with
    c = 8, zero scalars and a repeated point (lanes 0, 5 and 2, 3), and
    every scalar of rank 1 zero. The output coordinates are the same on
    every rank; in affine form they equal the oracle's sum and msm_local's
    over the whole batch."""
    ed = _case("edwards25519", 16, seed=11)
    ed[4][8:] = [0] * 8
    for curve, n, c, (grp, o, pts, aff, ks, nb) in (("p192k1", 4, 4, _p192k1_case()),
                                                    ("edwards25519", 2, 8, ed)):
        want = tuple(_sum(o, aff, ks))
        assert _affine(grp, msm_local(grp, pts, _cols(ks, nb), c=c)) == want, curve
        report = world.spawn(entry.sharded_msm_rank, n, "cpu", curve,
                             [a[0] for a in aff], [a[1] for a in aff], ks, c)
        coords = report["coords"]
        assert len(coords) == n and all((x == coords[0]).all() for x in coords), curve
        assert tuple(report["affine"]) == want, curve


@world_limited
def test_dryrun_multichip_on_cpu_ranks(monkeypatch):
    """The dry run in worlds of 1, 2 and 4, each under a wall budget: every
    rank counts the 2n signatures, and the example MSM equals the oracle's.
    The example MSM needs a world: outside one it raises. On the card a
    world larger than the cards raises before any process starts."""
    for n in (1, 2, 4):
        t0 = time.perf_counter()
        assert entry.dryrun_multichip(n, device="cpu") == {"counts": [2 * n] * n, "msm": True}
        dt = time.perf_counter() - t0
        assert dt < DRYRUN_BUDGET_S, f"dry run of {n} ranks took {dt:.0f} s"
    with pytest.raises(RuntimeError, match="no process group"):
        msm_sharded_example("cpu")
    monkeypatch.setattr(world, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="a world of 2 NCCL ranks needs 2 cards"):
        entry.dryrun_multichip(2, device="cuda")
