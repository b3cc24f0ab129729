"""ed_add_roofline: the share, in %, of the device time of ``ed_add``'s
launches in the profiled batches that their bound accounts for
(``roofline/kernels/ed_add.py``: the operation's field products and
squarings and its canonical bytes, against the card's peaks)."""

from __future__ import annotations

from benchmark.readers import roofline_share
from benchmark.roofline.kernels import ed_add as FAMILY


def read(ctx: dict):
    return roofline_share(ctx, FAMILY)
