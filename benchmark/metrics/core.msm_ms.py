"""core.msm_ms: the RLC core's window-stacked MSM a window batch, in ms, as
the host issues it (the program's span ``msm.multi_prefix``: sorting by
digit, the bucket sums, the Horner fold)."""

from __future__ import annotations

from benchmark.program_spans import ms_per_batch


def read(ctx: dict):
    return ms_per_batch(ctx, "msm.multi_prefix")
