"""protocol.sha512_ms: the native SHA-512 call over the batch's R || A || M
a window batch, in ms (the program's span ``sha512.hash``)."""

from __future__ import annotations

from benchmark.program_spans import ms_per_batch


def read(ctx: dict):
    return ms_per_batch(ctx, "sha512.hash")
