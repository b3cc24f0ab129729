"""setup_s: from the start of the process to the first timed batch's
start: imports, the CUDA context, the kernel libraries' build or load,
the inputs, the ranks' start and the warm-up."""

from __future__ import annotations


def read(ctx: dict):
    return min(r["start"][0] for r in ctx["ranks"]) - ctx["t_start"]
