"""core.decode_ms: the verifier cores' decoding a window batch, in ms, as
the host issues it: A and R decompressed (the pow kernel and plain torch),
S's canonical check and k's reduction, with the randomizers in the RLC
core (the program's spans ``ed25519.decode`` and
``ed25519_batch.decode``)."""

from __future__ import annotations

from benchmark.program_spans import ms_per_batch


def read(ctx: dict):
    return ms_per_batch(ctx, "ed25519.decode", "ed25519_batch.decode")
