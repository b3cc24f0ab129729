"""pow_kernel_roofline: the share, in %, of the device time of ``pow_kernel``'s
launches in the profiled batches that their bound accounts for
(``roofline/kernels/pow_kernel.py``: the operation's field products and
squarings and its canonical bytes, against the card's peaks)."""

from __future__ import annotations

from benchmark.readers import roofline_share
from benchmark.roofline.kernels import pow_kernel as FAMILY


def read(ctx: dict):
    return roofline_share(ctx, FAMILY)
