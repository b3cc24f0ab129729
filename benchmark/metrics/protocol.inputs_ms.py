"""protocol.inputs_ms: the mean time of a call into the host entry's inputs
(SHA-512 of R || A || M on the host, the byte columns to the card), as
verify_host, verify_batch_host and the sharded verifier's entry module
call it, over every call of the traced window (a span ended by
torch.cuda.synchronize()), in ms."""

from __future__ import annotations

from benchmark.readers import span_mean_ms

SPANS = {"protocol.inputs": [
    "eccoxide_tpu_torch.protocol.ed25519:host_inputs",
]}


def read(ctx: dict):
    return span_mean_ms(ctx, "protocol.inputs")
