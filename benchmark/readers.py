"""Arithmetic that several metric readers share."""

from __future__ import annotations

import re

import numpy as np

from .roofline.formula import bound_s


def span_mean_ms(ctx: dict, span: str):
    """The mean of a span's calls over every rank's window, in ms; None
    where the span never ran."""
    times = [t for r in ctx["ranks"] for t in r["spans"].get(span, [])]
    return float(np.mean(times)) * 1e3 if times else None


def batch_seconds(ctx: dict) -> np.ndarray:
    """Each window batch's time: from the first rank's call to the last
    rank's answers on the host."""
    starts = np.array([r["start"] for r in ctx["ranks"]])
    ends = np.array([r["end"] for r in ctx["ranks"]])
    return ends.max(0) - starts.min(0)


def profiles(ctx: dict) -> list:
    return [r["profile"] for r in ctx["ranks"] if r["profile"]]


def roofline_share(ctx: dict, family) -> float | None:
    """The share, in %, of a kernel family's device time that its launches'
    bound accounts for, over every rank's profiled batches: the sum of each
    launch's bound (its operations and bytes, ``roofline/formula.py``) over
    the sum of the device times of the trace's kernels of the family.
    None where the family did not launch, or where the trace's kernels and
    the recorded launches differ in number (they cannot be matched)."""
    bound = dev_s = 0.0
    launches = kernels = 0
    pattern = re.compile(family.TRACE)
    name = family.__name__.rsplit(".", 1)[1]
    for p in profiles(ctx):
        recs = p["launches"].get(name, [])
        launches += len(recs)
        bound += sum(bound_s(*family.work(r)) for r in recs)
        for k, (secs, count) in p["kernels"].items():
            if pattern.search(k):
                dev_s += secs
                kernels += count
    if launches == 0 or kernels != launches or dev_s <= 0:
        return None
    return 100.0 * bound / dev_s
