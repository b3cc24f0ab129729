"""protocol.copy_mb: the bytes the host entry copies to the card a window
batch, in MB (10^6 B): the ``bytes`` counted on the program's span
``ed25519.copy``. A count: 160 int32 rows a lane in the Straus entry, 176
with the RLC entry's randomizers."""

from __future__ import annotations

from benchmark.program_spans import per_batch


def read(ctx: dict):
    n = per_batch(ctx, ("ed25519.copy",), lambda r: r.fields.get("bytes", 0))
    return None if n is None else n / 1e6
