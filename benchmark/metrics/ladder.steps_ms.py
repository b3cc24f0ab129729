"""ladder.steps_ms: the Montgomery ladder's steps a window batch, in ms, as
the host issues them: n_bits differential add-and-double steps of
plain-torch field operations and the final swap (the program's span
``montgomery.steps``; 255 steps over 2B lanes in the X25519 exchange)."""

from __future__ import annotations

from benchmark.program_spans import ms_per_batch


def read(ctx: dict):
    return ms_per_batch(ctx, "montgomery.steps")
