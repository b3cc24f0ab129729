"""protocol.copy_ms: the host entry's copies of its columns to the card a
window batch, in ms, as the host issues them (the program's span
``ed25519.copy``: pk, R, S and the digests, and in the RLC entry the
randomizers)."""

from __future__ import annotations

from benchmark.program_spans import ms_per_batch


def read(ctx: dict):
    return ms_per_batch(ctx, "ed25519.copy")
