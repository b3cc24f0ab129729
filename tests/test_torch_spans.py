"""The port's span recorder (``eccoxide_tpu_torch/spans.py``) in the host
entries and verifier cores, on the CPU: off, it is one shared no-op and
records nothing; on, each entry call records its spans once, nested under
the call's root, with the bytes copied to the device, and the verdicts do
not change; the records lie on torch.profiler's clock after the offset."""

import os

import pytest
import torch

from eccoxide_tpu_torch import oracle, spans
from eccoxide_tpu_torch.protocol import ed25519, ed25519_batch

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

B = 4
SKS = [bytes([i + 1]) * 32 for i in range(B)]
MSGS = [b"span %d" % i for i in range(B)]
PKS = [oracle.public_key(sk) for sk in SKS]
SIGS = [oracle.sign(sk, m) for sk, m in zip(SKS, MSGS)]
FORGED = MSGS[:2] + [b"forged"] + MSGS[3:]          # lane 2 fails
WANT = [True, True, False, True]

HOST = ("ed25519.concat", "sha512.hash", "ed25519.copy")


@pytest.fixture
def recorder():
    spans.disable()
    spans.drain()
    try:
        yield spans
    finally:
        spans.disable()
        spans.drain()


def _tree(recs):
    by_id = {r.id: r for r in recs}
    names = [r.name for r in recs]
    parent = {r.name: by_id[r.parent].name if r.parent else None for r in recs}
    return names, parent, by_id


def test_off_records_nothing_and_on_records_each_span_once(recorder):
    assert spans.span("x") is spans.OFF and not spans.enabled()
    with spans.span("x") as s:
        s.set(bytes=1)
    assert ed25519.verify_host(PKS, FORGED, SIGS, device="cpu") == WANT
    assert spans.drain() == []

    spans.enable()
    assert spans.enabled() and spans.span("x") is not spans.OFF
    assert ed25519.verify_host(PKS, FORGED, SIGS, device="cpu") == WANT
    recs = spans.drain()
    names, parent, _ = _tree(recs)
    assert sorted(names) == sorted(("ed25519.verify_host", "ed25519.host_inputs",
                                    "ed25519.decode") + HOST)
    assert parent["ed25519.verify_host"] is None
    assert parent["ed25519.host_inputs"] == parent["ed25519.decode"] == "ed25519.verify_host"
    assert all(parent[n] == "ed25519.host_inputs" for n in HOST)
    root = next(r.id for r in recs if r.parent is None)
    assert all(r.root == root and r.start_ns <= r.end_ns for r in recs)
    copy = next(r for r in recs if r.name == "ed25519.copy")
    assert copy.fields == {"bytes": 160 * 4 * B}
    # the native pass: every lane hashed, R || A || M its bytes; one thread
    # below 512 lanes
    hashed = next(r for r in recs if r.name == "sha512.hash")
    assert hashed.fields == {"lanes": B, "bytes": sum(64 + len(m) for m in FORGED),
                             "threads": 1}
    # from 512 lanes on, the pass splits the lanes across the host's cores
    ed25519.host_inputs(PKS * 128, FORGED * 128, SIGS * 128, "cpu")
    hashed = next(r for r in spans.drain() if r.name == "sha512.hash")
    assert hashed.fields["lanes"] == 512
    assert hashed.fields["threads"] == min(64, os.cpu_count())
    # a child lies inside its parent
    by_name = {r.name: r for r in recs}
    for r in recs:
        if r.parent:
            p = by_name[parent[r.name]]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_batch_verifier_spans_and_fallback(recorder):
    spans.enable()
    assert ed25519_batch.verify_batch_host(PKS, FORGED, SIGS, device="cpu") == WANT
    recs = spans.drain()
    names, parent, _ = _tree(recs)
    assert names.count("ed25519_batch.fallback") == 1
    assert names.count("ed25519_batch.decode") == names.count("ed25519.decode") == 1
    assert names.count("msm.multi_prefix") == names.count("msm.sweeps") == 1
    assert parent["msm.sweeps"] == "msm.multi_prefix"
    assert parent["ed25519.decode"] == "ed25519_batch.fallback"
    assert parent["ed25519_batch.fallback"] == "ed25519_batch.verify_batch_host"
    assert sum(r.fields["bytes"] for r in recs if r.name == "ed25519.copy") == 176 * 4 * B
    assert ed25519_batch.verify_batch_host(PKS, MSGS, SIGS, device="cpu") == [True] * B
    assert "ed25519_batch.fallback" not in [r.name for r in spans.drain()]


def test_records_on_the_profilers_clock(recorder):
    from torch.profiler import ProfilerActivity, profile

    # the host entry alone: a whole verify_host issues some 10^5 plain-torch
    # ops on the CPU, each a profiler event
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ed25519.host_inputs(PKS, FORGED, SIGS, "cpu")
    recs = spans.drain()
    off = spans.trace_offset_ns()
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    assert sorted(r.name for r in recs) == sorted(("ed25519.host_inputs",) + HOST)
    for r in recs:
        (e,) = events[r.name]
        assert abs(e.start_ns() - (r.start_ns + off)) < 1_000_000, r.name
        assert abs(e.start_ns() + e.duration_ns() - (r.end_ns + off)) < 1_000_000, r.name
