"""core_ms.rlc: the mean time of a call into the RLC batch check
(decompress, the window-stacked MSM, the fixed-base gather), as
verify_batch_host calls it, over every call of the traced window (a span
ended by torch.cuda.synchronize()), in ms."""

from __future__ import annotations

from benchmark.readers import span_mean_ms

SPANS = {"core.rlc": [
    "eccoxide_tpu_torch.protocol.ed25519_batch:rlc_verify_core",
]}


def read(ctx: dict):
    return span_mean_ms(ctx, "core.rlc")
