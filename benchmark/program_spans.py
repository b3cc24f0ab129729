"""The program's own spans (``eccoxide_tpu_torch.spans``), as the per-layer
readers of ``metrics/`` read them. Importing this module turns the
program's recorder on: the harness loads the per-layer readers, and so
this module, in the process that runs the cell just before a traced
window, and never in an untraced run.

A reader takes the records whose root span starts inside the window
(the first batch's start to the last batch's end, on the window's
``perf_counter`` clock), sums a quantity over its spans and divides by
the window's batches. Where the program has no recorder (a tree from
before it) or nothing was recorded in this process (the main process of
a world of ranks), a reader reads None."""

from __future__ import annotations

import collections

try:
    from eccoxide_tpu_torch import spans
except ImportError:
    spans = None
else:
    spans.enable()

# every record drained so far in this process, so that each reader sees them
_kept: collections.deque = collections.deque(maxlen=1 << 20)


def in_window(ctx: dict) -> list | None:
    """The records whose root starts inside the first rank's window; None
    where no record was kept."""
    if spans is not None:
        _kept.extend(spans.drain())
    if not _kept:
        return None
    r0 = ctx["ranks"][0]
    lo, hi = r0["start"][0] * 1e9, r0["end"][-1] * 1e9
    roots = {r.id: r.start_ns for r in _kept if r.parent is None}
    return [r for r in _kept if r.root in roots and lo <= roots[r.root] <= hi]


def per_batch(ctx: dict, names, value):
    """The sum of ``value(record)`` over the window's spans named in
    ``names``, over the window's batches; None where nothing was kept."""
    recs = in_window(ctx)
    if recs is None:
        return None
    return sum(value(r) for r in recs if r.name in names) / len(ctx["ranks"][0]["start"])


def ms_per_batch(ctx: dict, *names):
    """The time of the spans ``names`` a window batch, in ms."""
    return per_batch(ctx, names, lambda r: (r.end_ns - r.start_ns) / 1e6)
