"""The sharded Straus verifier, one rank of a world: each rank takes its
contiguous share of every batch (the columns ``parallel.batch_verify.
shard_batch`` would give it), hashes it with ``protocol.ed25519.host_inputs``
and calls the verifier of ``parallel.batch_verify.make_sharded_verify``,
whose accept count is summed over the ranks by ``all_reduce``. The rank's
verdicts and the count come back to the host."""

from __future__ import annotations

from eccoxide_tpu_torch.parallel import batch_verify
from eccoxide_tpu_torch.protocol import ed25519

from .verify_host import lists

SHARDED = True


def prepare(dev, pool: dict, slots: list) -> dict:
    return {"dev": dev, "verify": batch_verify.make_sharded_verify(dev),
            "ring": [lists(pool, idx) for idx in slots], "counts": []}


def call(state: dict, k: int) -> list:
    pks, msgs, sigs = state["ring"][k]
    ok, count = state["verify"](*ed25519.host_inputs(pks, msgs, sigs, state["dev"]))
    out = ok.cpu().tolist()
    state["counts"].append(int(count))
    return out
