"""x25519.inputs_ms: the X25519 host entry's inputs a window batch, in ms,
as the host issues them: the widths checked, the byte lists packed into
(64, B) int32 columns and copied to the card (the program's span
``x25519.inputs``)."""

from __future__ import annotations

from benchmark.program_spans import ms_per_batch


def read(ctx: dict):
    return ms_per_batch(ctx, "x25519.inputs")
