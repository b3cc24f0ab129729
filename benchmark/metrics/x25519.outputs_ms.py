"""x25519.outputs_ms: the X25519 host entry's outputs a window batch, in
ms: the shares, secrets and contributory mask to uint8 and to the host
(which waits for the card to finish the batch), the refusals and the byte
lists (the program's span ``x25519.outputs``)."""

from __future__ import annotations

from benchmark.program_spans import ms_per_batch


def read(ctx: dict):
    return ms_per_batch(ctx, "x25519.outputs")
