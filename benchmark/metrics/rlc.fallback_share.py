"""rlc.fallback_share: the share, in %, of window batches whose RLC check
failed, so that the per-signature verifier ran to find the forged lanes
(the program's span ``ed25519_batch.fallback``, counted)."""

from __future__ import annotations

from benchmark.program_spans import per_batch


def read(ctx: dict):
    share = per_batch(ctx, ("ed25519_batch.fallback",), lambda r: 1)
    return None if share is None else 100.0 * share
