"""The port's batched X25519 server exchange (``protocol/x25519.py``
``exchange_host`` and ``exchange_core``) on the CPU: lane by lane against
the benchmark's plain reference and `cryptography`, on a batch that holds
every low-order u, a u with bit 255 set and u = p + 9; its errors; its
spans; and its dispatch trace, which no secret changes. (Three tests: see
test_torch_sign.py for why.)"""

import dataclasses
import random

import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives import serialization as ser
from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey, X25519PublicKey

from benchmark.reference import x25519 as ref
from eccoxide_tpu_torch import spans
from eccoxide_tpu_torch.curves import curve25519 as c255
from eccoxide_tpu_torch.protocol import x25519 as tx
from test_torch_ct import _trace

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

aten = torch.ops.aten
_rng = random.Random(8446)
_client = [bytes(_rng.randrange(256) for _ in range(32)) for _ in range(5)]
_valid = [ref.public_key(k) for k in _client]
# the five low-order u's (refused), then valid client key shares: one with
# bit 255 set (masked), one as p + 9 (taken mod p), three as sent
US = [u.to_bytes(32, "little") for u in ref.LOW_ORDER_U] + [
    _valid[0][:31] + bytes([_valid[0][31] | 0x80]), (ref.P + 9).to_bytes(32, "little")] + _valid[1:]
SCALARS = [bytes(_rng.randrange(256) for _ in range(32)) for _ in US]
REFUSED = len(ref.LOW_ORDER_U)


@pytest.fixture
def recorder():
    spans.disable()
    spans.drain()
    try:
        yield spans
    finally:
        spans.disable()
        spans.drain()


def _raises_before_device_work(monkeypatch, scalars, us):
    def no_device_work(*args):
        raise AssertionError("the device core ran")

    with monkeypatch.context() as m:
        m.setattr(tx, "exchange_core", no_device_work)
        with pytest.raises(ValueError):
            tx.exchange_host(scalars, us, device="cpu")


def test_exchange_host_against_the_reference_and_cryptography(monkeypatch):
    """Lane by lane, with spans off (nothing recorded); bytes-like values
    taken as bytes; empty lists; errors before any device work."""
    spans.disable()
    spans.drain()
    scalars = SCALARS[:-1] + [bytearray(SCALARS[-1])]
    us = US[:-1] + [memoryview(US[-1])]
    shares, secrets = tx.exchange_host(scalars, us, device="cpu")
    assert spans.drain() == []
    assert shares == [ref.public_key(k) for k in SCALARS]
    want = [ref.x25519(k, u) for k, u in zip(SCALARS, US)]
    assert secrets == [w if w != bytes(32) else None for w in want]
    assert secrets[:REFUSED] == [None] * REFUSED and None not in secrets[REFUSED:]
    assert secrets[REFUSED + 1] == shares[REFUSED + 1]            # u = p + 9 is u = 9
    for k, u, share, secret in zip(SCALARS[REFUSED:], US[REFUSED:], shares[REFUSED:],
                                   secrets[REFUSED:]):
        sk = X25519PrivateKey.from_private_bytes(k)
        assert share == sk.public_key().public_bytes(ser.Encoding.Raw, ser.PublicFormat.Raw)
        masked = u[:31] + bytes([u[31] & 0x7F])
        assert secret == sk.exchange(X25519PublicKey.from_public_bytes(masked))
    assert tx.exchange_host([], [], device="cpu") == ([], [])
    _raises_before_device_work(monkeypatch, SCALARS, US[:-1])
    _raises_before_device_work(monkeypatch, SCALARS[:2], [US[0], US[1][:31]])
    _raises_before_device_work(monkeypatch, [SCALARS[0] + b"\0"], US[:1])


def test_spans_of_one_call(recorder):
    """One call records the root and its four children once each, in
    order; the ladder's lanes are twice the call's."""
    scalars, us = SCALARS[:REFUSED + 2], US[:REFUSED + 2]
    want_refused = sum(ref.x25519(k, u) == bytes(32) for k, u in zip(scalars, us))
    b = len(us)
    spans.enable()
    tx.exchange_host(scalars, us, device="cpu")
    recs = spans.drain()
    by_name = {r.name: r for r in recs}
    assert sorted(by_name) == sorted(r.name for r in recs) == sorted((
        "x25519.exchange_host", "x25519.inputs", "montgomery.steps", "montgomery.inverse",
        "x25519.outputs"))
    root = by_name["x25519.exchange_host"]
    assert root.parent is None and all(r.root == root.id for r in recs)
    assert all(r.parent == root.id for r in recs if r is not root)
    assert by_name["x25519.inputs"].fields == {"lanes": b, "bytes": 64 * 4 * b}
    assert by_name["montgomery.steps"].fields == {"lanes": 2 * b, "steps": 255,
                                                  "curve": "curve25519"}
    assert by_name["x25519.outputs"].fields == {"refused": want_refused} and want_refused == REFUSED
    order = ("x25519.inputs", "montgomery.steps", "montgomery.inverse", "x25519.outputs")
    for r, nxt in zip(order, order[1:]):
        assert by_name[r].end_ns <= by_name[nxt].start_ns
    assert root.start_ns <= by_name[order[0]].start_ns and by_name[order[-1]].end_ns <= root.end_ns


def test_exchange_core_trace_is_independent_of_the_secret(monkeypatch):
    """As test_torch_ct.py holds the ladders: two runs with other scalars
    and other peer u's (bit 255 set in some) make the same ops on the same
    shapes, with the same index values, and read nothing back to the host.
    The ladder runs its top 16 steps here: test_torch_ct.py holds all 255
    of the same loop, and a whole exchange_core under the recorder takes
    about 8 s a run on one CPU thread (215,587 ops)."""
    def cols(rng):
        return torch.from_numpy(rng.integers(0, 256, size=(32, 3), dtype=np.int32))

    monkeypatch.setattr(c255, "MONT", dataclasses.replace(c255.MONT, n_bits=16))
    c255.FQ.inverse(c255.FQ.one((1,), "cpu"))      # the field's constants, cached on first use
    runs = []
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        scalar_cols, u_cols = cols(rng), cols(rng)
        runs.append(_trace(lambda: tx.exchange_core(scalar_cols, u_cols)))
    a, b = runs
    assert len(a.ops) > 1000
    assert aten._local_scalar_dense.default not in {op[0] for op in a.ops}
    assert a.ops == b.ops
    assert len(a.indices) == len(b.indices)
    for ia, ib in zip(a.indices, b.indices):
        assert len(ia) == len(ib) and all(torch.equal(x, y) for x, y in zip(ia, ib))
