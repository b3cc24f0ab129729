"""The Straus verifier's host entry, ``protocol.ed25519.verify_host``: one
call a batch, on Python byte lists, the verifier tables built once in
set-up as a deployment keeps them."""

from __future__ import annotations

from eccoxide_tpu_torch.protocol import ed25519

SHARDED = False


def lists(pool: dict, idx) -> tuple:
    """(pks, msgs, sigs) of the pool items ``idx``, as the entry takes them."""
    items = pool["items"]
    return tuple(list(col) for col in zip(*(items[i] for i in idx)))


def prepare(dev, pool: dict, slots: list) -> dict:
    return {"dev": dev, "tables": ed25519.VerifyTables(dev),
            "ring": [lists(pool, idx) for idx in slots]}


def call(state: dict, k: int) -> list:
    pks, msgs, sigs = state["ring"][k]
    return ed25519.verify_host(pks, msgs, sigs, device=state["dev"], tables=state["tables"])
