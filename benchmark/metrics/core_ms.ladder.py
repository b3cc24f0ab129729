"""core_ms.ladder: the mean time of a call into the X25519 exchange core
(``protocol.x25519.exchange_core``: the clamped scalar's bits, the u's
decoded, one Montgomery ladder over 2B lanes, the bytes and the
contributory mask), as exchange_host calls it, over every call of the
traced window (a span ended by torch.cuda.synchronize()), in ms."""

from __future__ import annotations

from benchmark.readers import span_mean_ms

SPANS = {"core.ladder": ["eccoxide_tpu_torch.protocol.x25519:exchange_core"]}


def read(ctx: dict):
    return span_mean_ms(ctx, "core.ladder")
