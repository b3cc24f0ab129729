"""sharding.rank_skew_ms: per window batch, the slowest rank's time (its
inputs and its sharded call, to its answers on the host) minus the
fastest rank's; the mean over batches, in ms. Nothing to read in a world
of one."""

from __future__ import annotations

import numpy as np


def read(ctx: dict):
    ranks = ctx["ranks"]
    if len(ranks) < 2:
        return None
    t = np.array([r["end"] for r in ranks]) - np.array([r["start"] for r in ranks])
    return float(np.mean(t.max(0) - t.min(0))) * 1e3
