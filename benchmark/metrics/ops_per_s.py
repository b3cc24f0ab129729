"""ops_per_s: operations answered in the window (every lane of every batch:
a verdict or a shared secret) over the window's time, from the first
batch's start to the last batch's end, on the host's clock."""

from __future__ import annotations


def read(ctx: dict):
    ranks = ctx["ranks"]
    t0 = min(r["start"][0] for r in ranks)
    t1 = max(r["end"][-1] for r in ranks)
    lanes = ctx["lanes_per_rank"] * sum(len(r["start"]) for r in ranks)
    return lanes / (t1 - t0)
