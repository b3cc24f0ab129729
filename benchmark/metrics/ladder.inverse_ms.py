"""ladder.inverse_ms: the Montgomery ladder's final inverse and product a
window batch, in ms, as the host issues them: one launch of the field's
pow kernel on the card (the program's span ``montgomery.inverse``)."""

from __future__ import annotations

from benchmark.program_spans import ms_per_batch


def read(ctx: dict):
    return ms_per_batch(ctx, "montgomery.inverse")
