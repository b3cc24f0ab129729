"""core.msm_sweeps_ms: the MSM's up-sweep and down-sweep over the sorted
points a window batch, in ms, as the host issues them (the program's span
``msm.sweeps``)."""

from __future__ import annotations

from benchmark.program_spans import ms_per_batch


def read(ctx: dict):
    return ms_per_batch(ctx, "msm.sweeps")
