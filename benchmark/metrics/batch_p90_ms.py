"""batch_p90_ms: the 90th percentile (numpy's linear interpolation) of
every window batch's time, from the call's start to its answers on the
host as Python objects, in ms; across ranks, from the first rank's start
to the last rank's answers."""

from __future__ import annotations

import numpy as np

from benchmark.readers import batch_seconds


def read(ctx: dict):
    return float(np.percentile(batch_seconds(ctx), 90)) * 1e3
