"""Batch-sharded Ed25519 verification over a world of ranks.

Counterpart of the JAX package's ``parallel/batch_verify.py``. Every
verify is independent of the others, so the batch axis is split over the
ranks (``shard_batch``) and only the accept count crosses between them,
summed by ``all_reduce`` (JAX: ``psum`` over the mesh axis). The ranks are
a ``torch.distributed`` world (``parallel.world``): NCCL between cards,
gloo between CPU processes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..protocol.ed25519 import VerifyTables, verify_core
from . import world


def shard_batch(arr) -> torch.Tensor:
    """This rank's contiguous columns of a (rows, B) array (numpy or
    tensor; any leading axes) as an int32 tensor on the rank's device. A B
    that the world size does not divide raises ``ValueError``; a tensor on
    a device of another kind than the rank's (a card's tensor in a gloo
    world) raises ``RuntimeError`` instead of moving."""
    dev = world.rank_device()
    if isinstance(arr, torch.Tensor) and arr.device.type != dev.type:
        raise RuntimeError(f"a {dist.get_backend()} rank cannot shard a tensor on {arr.device}: "
                           f"its device is {dev}")
    return world.columns(torch.as_tensor(arr)).to(device=dev, dtype=torch.int32)


def make_sharded_verify(device="cuda"):
    """A verifier of this rank's shard: ``call(pk, r, s, kw)`` on (32, B/D),
    (32, B/D), (32, B/D) and (64, B/D) int32 byte columns (``shard_batch``)
    returns ``(ok, count)``: the shard's (B/D,) bool mask from
    ``verify_core``, and the accept count of the whole batch, a 0-d int64
    tensor on the device, equal on every rank. Every rank calls it at
    once. The verifier's tables are built once here, on the device, as JAX
    passes them to every call as a replicated argument.

    Raises without a card when ``device`` is one, without a process group,
    and when the group's backend does not serve ``device``."""
    dev = world.check_group(device)
    tables = VerifyTables(dev)

    def call(pk, r, s, kw):
        if any(t.device != dev for t in (pk, r, s, kw)):
            raise ValueError(f"the shard must lie on {dev}")
        ok = verify_core(pk, r, s, kw, tables)
        count = ok.sum(dtype=torch.int64)
        dist.all_reduce(count)
        return ok, count

    return call
