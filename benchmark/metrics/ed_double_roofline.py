"""ed_double_roofline: the share, in %, of the device time of ``ed_double``'s
launches in the profiled batches that their bound accounts for
(``roofline/kernels/ed_double.py``: the operation's field products and
squarings and its canonical bytes, against the card's peaks)."""

from __future__ import annotations

from benchmark.readers import roofline_share
from benchmark.roofline.kernels import ed_double as FAMILY


def read(ctx: dict):
    return roofline_share(ctx, FAMILY)
