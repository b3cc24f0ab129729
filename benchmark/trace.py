"""Reading a profiled stretch of batches: device busy time and idle share
(the arithmetic of ``chip_smoke.py``'s ``device_profile``: the trace's
device events summed straight, since ``key_averages()`` takes minutes to
parse 10^5 launches), kernel time by name, and the idle gaps named by what
the host was doing meanwhile.

The trace stays in memory and no trace file is written."""

from __future__ import annotations

import numpy as np

BATCH_SPAN = "bench.batch"
SPAN_PREFIX = "bench."
_NOT_KERNELS = ("Memcpy", "Memset")


def _is_device(e) -> bool:
    """A device operation: a kernel, copy or set on the card, not the
    device-side copy of a host annotation (``record_function``)."""
    return ("CUDA" in str(e.device_type()) and not e.is_user_annotation()
            and not e.name().startswith(SPAN_PREFIX))


def _is_host(e) -> bool:
    return "CUDA" not in str(e.device_type())


def is_kernel(name: str) -> bool:
    return not name.startswith(_NOT_KERNELS)


def merged(intervals):
    """The union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps_within(busy, lo, hi):
    """The idle (start, end) intervals of [lo, hi] outside the sorted
    disjoint ``busy`` intervals."""
    out, t = [], lo
    for s, e in busy:
        if e <= lo or s >= hi:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def name_gaps(gaps, host):
    """{name: idle seconds}: each gap named by the innermost host event
    (start, end, name) open at its midpoint, after the innermost benchmark
    span around it ("span > event"). Host events of one thread nest, so a
    stack swept in time order holds the open ones."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out, stack, j = {}, [], 0
    for s, e in sorted(gaps):
        mid = (s + e) / 2
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] <= host[j][0]:      # closed before it opened
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        spans = [h[2] for h in stack if h[2].startswith(SPAN_PREFIX) and h[2] != BATCH_SPAN]
        inner = stack[-1][2] if stack else "(no host event)"
        name = inner if not spans or spans[-1] == inner else f"{spans[-1]} > {inner}"
        out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out


def summarize(events, batches: int) -> dict:
    """A profiled stretch of ``batches`` batches, each inside a
    ``bench.batch`` host span, as plain numbers (seconds):

    - ``wall_s``: first batch span's start to the last one's end;
    - ``busy_s``: the union of device events inside it;
    - ``kernels``: {kernel name: [seconds, launches]};
    - ``ops``: {device event name: [seconds, count]}, copies and sets too;
    - ``gaps``: {host activity: idle seconds} (``name_gaps``)."""
    dev, host, batch_spans, thread = [], [], [], None
    for e in events:
        if _is_device(e):
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif _is_host(e) and e.name() == BATCH_SPAN:
            batch_spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            thread = e.start_thread_id()
    if len(batch_spans) != batches:
        raise RuntimeError(f"the trace holds {len(batch_spans)} batch spans, not {batches}")
    for e in events:
        if _is_host(e) and e.start_thread_id() == thread:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    lo = min(s for s, _ in batch_spans)
    hi = max(e for _, e in batch_spans)
    inside = [(max(s, lo), min(e, hi)) for s, e, _ in dev if e > lo and s < hi]
    busy = merged(inside)
    ops, kernels = {}, {}
    for s, e, name in dev:
        row = ops.setdefault(name, [0.0, 0])
        row[0] += (e - s) / 1e9
        row[1] += 1
        if is_kernel(name):
            kernels[name] = row
    return {"batches": batches, "wall_s": (hi - lo) / 1e9,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "kernels": kernels, "ops": ops,
            "gaps": name_gaps(gaps_within(busy, lo, hi), host)}


def top(d: dict, n: int = 10, width: int = 160) -> list:
    """The n largest entries of {name: seconds or [seconds, count]} as
    [name, seconds], largest first, each name cut to ``width`` characters."""
    secs = {k: (v[0] if isinstance(v, list) else v) for k, v in d.items()}
    return [[k[:width], secs[k]] for k in sorted(secs, key=lambda k: -secs[k])[:n]]


def merge_ranks(summaries: list, key: str) -> dict:
    """{name: seconds} summed over the ranks' ``key`` tables."""
    out = {}
    for s in summaries:
        for k, v in s[key].items():
            out[k] = out.get(k, 0.0) + (v[0] if isinstance(v, list) else v)
    return out


def busy_share(summaries: list) -> float:
    """The mean over ranks of busy / wall."""
    return float(np.mean([s["busy_s"] / s["wall_s"] for s in summaries]))
