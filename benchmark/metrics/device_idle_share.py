"""device_idle_share: the share of the profiled batches' wall time in
which no operation ran on the device, 100 (1 - busy / wall), the mean over
ranks. Taken under torch.profiler, which slows the host's issue, so it
reads higher than an unprofiled batch would."""

from __future__ import annotations

from benchmark import trace
from benchmark.readers import profiles


def read(ctx: dict):
    ps = [p for p in profiles(ctx) if p["busy_s"] > 0]
    if not ps:
        return None
    return 100.0 * (1.0 - trace.busy_share(ps))
