"""The verifiers' host entry, ``protocol.ed25519.host_inputs``, on the CPU:
the native pass (``ops/csrc/ed25519_inputs.cpp``) against the plain
composition written out here (R || A || M hashed by hashlib, every column
packed by numpy), at the message lengths around SHA-512's block edges and
the batch sizes around the one-thread rule; other bytes-like inputs; and
the errors the Python composition raised."""

import hashlib
import random

import numpy as np
import pytest
import torch

from eccoxide_tpu_torch.protocol import ed25519

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

# 64 + len(M) at and around the 128-byte block's edges and its 112-byte
# padding limit, a Solana packet's message, and a long one
MSG_LENS = (0, 1, 47, 48, 63, 64, 111, 112, 127, 128, 1167, 5000)


def _plain(pks, msgs, sigs):
    def cols(bs, width):
        a = np.frombuffer(b"".join(bytes(b) for b in bs), np.uint8).reshape(len(bs), width)
        return torch.from_numpy(np.ascontiguousarray(a.T).astype(np.int32))

    rs, ss = [bytes(s[:32]) for s in sigs], [bytes(s[32:]) for s in sigs]
    ks = [hashlib.sha512(r + bytes(pk) + bytes(m)).digest() for r, pk, m in zip(rs, pks, msgs)]
    return cols(pks, 32), cols(rs, 32), cols(ss, 32), cols(ks, 64)


def _batch(rng, n):
    pks = [rng.randbytes(32) for _ in range(n)]
    msgs = [rng.randbytes(MSG_LENS[i % len(MSG_LENS)]) for i in range(n)]
    sigs = [rng.randbytes(64) for _ in range(n)]
    return pks, msgs, sigs


def _assert_same(got, want):
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.is_contiguous() and g.device.type == "cpu"
        assert g.shape == w.shape and torch.equal(g, w)


def test_columns_equal_the_plain_composition():
    """Every message length at every batch size: the empty batch, one lane,
    one thread (below 512 lanes) and the split across threads."""
    rng = random.Random(15)
    for n in (0, 1, 511, 512, 1000):
        pks, msgs, sigs = _batch(rng, n)
        got = ed25519.host_inputs(pks, msgs, sigs, "cpu")
        _assert_same(got, _plain(pks, msgs, sigs))
        assert [t.shape for t in got] == [(32, n), (32, n), (32, n), (64, n)]


def test_other_bytes_like_inputs():
    """bytearray and memoryview elements, tuples for lists, and one object
    repeated in many lanes (as a pool tiled to the batch gives)."""
    rng = random.Random(16)
    pks, msgs, sigs = _batch(rng, 600)
    want = _plain(pks, msgs, sigs)
    mixed = ([bytearray(p) if i % 3 == 0 else p for i, p in enumerate(pks)],
             tuple(memoryview(m) if i % 5 == 0 else bytearray(m) if i % 5 == 1 else m
                   for i, m in enumerate(msgs)),
             tuple(bytearray(s) if i % 2 else s for i, s in enumerate(sigs)))
    _assert_same(ed25519.host_inputs(*mixed, "cpu"), want)
    one = (pks[:1] * 600, msgs[10:11] * 600, sigs[:1] * 600)
    _assert_same(ed25519.host_inputs(*one, "cpu"), _plain(*one))


def test_errors_as_the_python_composition_raised():
    rng = random.Random(17)
    pks, msgs, sigs = _batch(rng, 700)
    for i, bad in ((0, rng.randbytes(31)), (699, rng.randbytes(33))):
        with pytest.raises(ValueError, match="every input must be 32 bytes"):
            ed25519.host_inputs(pks[:i] + [bad] + pks[i + 1:], msgs, sigs, "cpu")
    for bad in (rng.randbytes(63), rng.randbytes(65), b""):
        with pytest.raises(ValueError, match="every input must be 32 bytes"):
            ed25519.host_inputs(pks, msgs, sigs[:-1] + [bad], "cpu")
    with pytest.raises(ValueError, match="differ in length"):
        ed25519.host_inputs(pks, msgs[:-1], sigs, "cpu")
    with pytest.raises(ValueError, match="differ in length"):
        ed25519.host_inputs(pks[:1], msgs[:1], sigs[:2], "cpu")
    for column, bad in ((0, "x" * 32), (1, "message"), (1, None), (2, 7), (2, [0] * 64)):
        args = [list(pks), list(msgs), list(sigs)]
        args[column][350] = bad
        with pytest.raises(TypeError):
            ed25519.host_inputs(*args, "cpu")
    # a type error anywhere is raised before a width error earlier in the batch
    with pytest.raises(TypeError):
        ed25519.host_inputs([b"short"] + pks[1:], msgs[:-1] + ["text"], sigs, "cpu")
    # and the pass still gives the plain columns after every refusal
    _assert_same(ed25519.host_inputs(pks, msgs, sigs, "cpu"), _plain(pks, msgs, sigs))
