"""The RLC batch verifier's host entry,
``protocol.ed25519_batch.verify_batch_host``: one call a batch, on Python
byte lists, the verifier tables built once in set-up; the randomizers
fresh on every call, as the entry draws them."""

from __future__ import annotations

from eccoxide_tpu_torch.protocol import ed25519, ed25519_batch

from .verify_host import lists

SHARDED = False


def prepare(dev, pool: dict, slots: list) -> dict:
    return {"dev": dev, "tables": ed25519.VerifyTables(dev),
            "ring": [lists(pool, idx) for idx in slots]}


def call(state: dict, k: int) -> list:
    pks, msgs, sigs = state["ring"][k]
    return ed25519_batch.verify_batch_host(pks, msgs, sigs, device=state["dev"],
                                           tables=state["tables"])
