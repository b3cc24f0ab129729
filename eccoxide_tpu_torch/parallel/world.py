"""A world of ranks, one device each: the port's counterpart of the JAX
package's device ``Mesh``.

A rank is a process with a ``torch.distributed`` process group and one
device: a card on NCCL, or the CPU on gloo. The batch axis is the data
axis: a rank holds its contiguous columns of every (..., B) input
(``batch_verify.shard_batch``), and the collectives combine what the ranks
computed (the accept count by ``all_reduce``, the MSM's window sums by
``all_gather``). Nothing falls back: a card without NCCL raises, and a
group never runs on tensors of the other backend's device.

``spawn`` runs a function of the port in a world of n processes, each
rank in its own process; ``init_world`` joins the calling process to a
world (a world of one in a script's own process).
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve_device


def backend_for(device) -> str:
    """The collectives' backend for tensors on ``device``: NCCL on a card,
    gloo on the CPU. A card without NCCL raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL: no process group for a CUDA device")
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no collectives backend for device {dev}")


def init_world(rank: int, world_size: int, device, init_method: str) -> torch.device:
    """Join this process to a world as ``rank`` of ``world_size`` and return
    its device: card ``rank % device_count`` on NCCL, the CPU on gloo (one
    intra-op thread per rank, so n ranks do not share the cores n times
    over)."""
    dev = resolve_device(device)
    backend = backend_for(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, device_id=dev)
    else:
        torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    return dev


def check_group(device) -> torch.device:
    """The device of this rank's tensors, ``device`` resolved (a bare
    "cuda" is the current card), after checking that a process group exists
    and that its backend serves that device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        raise RuntimeError("no process group: join a world first (parallel.world)")
    backend = dist.get_backend()
    if backend != backend_for(dev):
        raise RuntimeError(f"a {backend} process group cannot serve tensors on {dev}")
    return dev


def rank_device() -> torch.device:
    """This rank's device: the current card on NCCL, the CPU on gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def columns(t: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous share of the last axis of ``t``; a batch that
    the world size does not divide raises ``ValueError``."""
    D, r = dist.get_world_size(), dist.get_rank()
    B = t.shape[-1]
    if B % D:
        raise ValueError(f"a batch of {B} does not split over {D} ranks")
    n = B // D
    return t[..., r * n:(r + 1) * n].contiguous()


def gathered(t: torch.Tensor) -> list:
    """Every rank's ``t`` (the same shape on each) in rank order, by the
    list form of ``all_gather`` (gloo refuses a (world, ...) output of
    ``all_gather_into_tensor``)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return parts


def _rank_main(rank, fn, world_size, device, tmp, args):
    """One rank of ``spawn``: join the world, run fn(device, *args), leave.
    Rank 0 writes its result under tmp."""
    dev = init_world(rank, world_size, device, "file://" + os.path.join(tmp, "rendezvous"))
    try:
        out = fn(dev, *args)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, "result"), "wb") as f:
            pickle.dump(out, f)


def spawn(fn, world_size: int, device, *args):
    """Run ``fn(rank_device, *args)`` on every rank of a new world of
    ``world_size`` processes (start method spawn: a fork after CUDA is
    initialised fails) and return rank 0's result. ``fn`` is a module-level
    function of the port, so a child imports it by name. The ranks meet at
    a file in a fresh temporary directory, so worlds started at once never
    share an address. On the card each rank needs a card of its own (NCCL
    refuses two ranks on one): a larger world raises ``ValueError`` before
    any process starts. A rank that raises fails the call with
    ``mp.ProcessRaisedException``, which carries the rank's traceback (the
    others are stopped)."""
    dev = resolve_device(device)
    backend_for(dev)
    if dev.type == "cuda" and world_size > torch.cuda.device_count():
        raise ValueError(f"a world of {world_size} NCCL ranks needs {world_size} cards, "
                         f"this machine has {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(fn, world_size, str(dev), tmp, args),
                 nprocs=world_size, join=True)
        with open(os.path.join(tmp, "result"), "rb") as f:
            return pickle.load(f)
