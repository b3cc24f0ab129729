"""launches_per_batch: the device's kernel events (copies and sets left
out) over the profiled batches, divided by those batches; the mean over
ranks. A count: it repeats exactly while the path is unchanged."""

from __future__ import annotations

import numpy as np

from benchmark.readers import profiles


def read(ctx: dict):
    ps = [p for p in profiles(ctx) if p["kernels"]]
    if not ps:
        return None
    return float(np.mean([sum(n for _, n in p["kernels"].values()) / p["batches"] for p in ps]))
