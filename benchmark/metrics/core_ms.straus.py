"""core_ms.straus: the mean time of a call into the Straus verifier core
(decompress, the Straus chain), as verify_host and the sharded verifier
call it, over every call of the traced window (a span ended by
torch.cuda.synchronize()), in ms."""

from __future__ import annotations

from benchmark.readers import span_mean_ms

SPANS = {"core.straus": [
    "eccoxide_tpu_torch.protocol.ed25519:verify_core",
    "eccoxide_tpu_torch.parallel.batch_verify:verify_core",
]}


def read(ctx: dict):
    return span_mean_ms(ctx, "core.straus")
