"""protocol.columns_ms: the host entry's packing into int32 byte columns a
window batch, in ms: the digests to (64, B) (the program's span
``sha512.columns``) and pk, R and S to (32, B) on the host
(``ed25519.columns``)."""

from __future__ import annotations

from benchmark.program_spans import ms_per_batch


def read(ctx: dict):
    return ms_per_batch(ctx, "ed25519.columns", "sha512.columns")
