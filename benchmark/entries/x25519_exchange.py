"""A TLS 1.3 terminator's ECDHE through the server's batched host entry,
``protocol.x25519.exchange_host``: one call a batch, on Python byte lists
(the server's ephemeral scalars and the clients' key shares); the key
shares and the shared secrets come back as byte lists, None where a secret
is refused. A program without that entry fails in ``prepare`` with
AttributeError, before any device work."""

from __future__ import annotations

from eccoxide_tpu_torch.protocol import x25519

from .verify_host import lists

SHARDED = False


def prepare(dev, pool: dict, slots: list) -> dict:
    return {"dev": dev, "exchange": x25519.exchange_host,
            "ring": [lists(pool, idx) for idx in slots]}


def call(state: dict, k: int) -> tuple:
    scalars, us = state["ring"][k]
    return state["exchange"](scalars, us, device=state["dev"])
