"""protocol.concat_ms: the host entry's per-lane Python work a window
batch, in ms: R and S sliced out of the signatures and the R || A || M
list built (the program's span ``ed25519.concat``), joined into one
buffer with its offsets for the hasher (``sha512.join``), and the
per-lane strings released once the columns are on the card
(``ed25519.release``)."""

from __future__ import annotations

from benchmark.program_spans import ms_per_batch


def read(ctx: dict):
    return ms_per_batch(ctx, "ed25519.concat", "sha512.join", "ed25519.release")
