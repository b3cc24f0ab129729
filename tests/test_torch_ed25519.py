"""The port's verify side as a whole: verify_host (Straus) and
verify_batch_host (RLC with its per-signature fallback) on the CPU, against
the JAX package's integer oracle and RFC 8032 vectors. The comparisons with
the JAX package's own verifiers, which compile its graphs, are in
test_torch_parity_verify.py."""

import hashlib
import random

import numpy as np
import pytest

from eccoxide_tpu.oracle import ed25519 as jorc
from eccoxide_tpu_torch import oracle as torc
from eccoxide_tpu_torch.ops.sha512 import hasher, sha512_batch
from eccoxide_tpu_torch.protocol import ed25519 as tpe
from eccoxide_tpu_torch.protocol import ed25519_batch as tpb
from test_ed25519 import RFC_VECTORS

P, L = torc.P, torc.L
CASES = ["valid", "forged S", "wrong message", "non-canonical pk",
         "non-canonical S", "R with x=0, sign=1", "valid", "valid"]


@pytest.fixture(scope="module")
def batch():
    """B=8 lanes, one per case of CASES, signed by the JAX package's oracle."""
    rng = random.Random(2024)
    sks = [bytes(rng.randrange(256) for _ in range(32)) for _ in CASES]
    msgs = [bytes(rng.randrange(256) for _ in range(rng.randrange(1, 80)))
            for _ in CASES]
    pks = [jorc.public_key(sk) for sk in sks]
    sigs = [jorc.sign(sk, m) for sk, m in zip(sks, msgs)]
    s1 = sigs[1]
    sigs[1] = s1[:32] + bytes([s1[32] ^ 4]) + s1[33:]
    msgs[2] = msgs[2] + b"?"
    pks[3] = (P + 3).to_bytes(32, "little")
    s4 = int.from_bytes(sigs[4][32:], "little") + L
    sigs[4] = sigs[4][:32] + s4.to_bytes(32, "little")
    sigs[5] = (1 | 1 << 255).to_bytes(32, "little") + sigs[5][32:]
    expected = [jorc.verify(pk, m, s) for pk, m, s in zip(pks, msgs, sigs)]
    assert expected == [c == "valid" for c in CASES]
    return pks, msgs, sigs, expected


def test_verify_host_matches_oracle(batch):
    pks, msgs, sigs, expected = batch
    assert tpe.verify_host(pks, msgs, sigs, device="cpu") == expected


def test_verify_batch_host_isolates_every_bad_lane(batch):
    pks, msgs, sigs, expected = batch
    got = tpb.verify_batch_host(pks, msgs, sigs, rng=np.random.default_rng(5),
                                device="cpu")
    assert got == expected


def test_rlc_accepts_valid_batch_and_rejects_one_forgery(batch):
    pks, msgs, sigs, expected = batch
    good = [i for i, e in enumerate(expected) if e]
    tables = tpe.VerifyTables("cpu")
    args = tpe.host_inputs([pks[i] for i in good], [msgs[i] for i in good],
                           [sigs[i] for i in good], "cpu")
    z = tpb.sample_z(len(good), np.random.default_rng(1))
    import torch

    assert bool(tpb.rlc_verify_core(*args, torch.from_numpy(z), tables, msm_c=4))
    bad_s = args[2].clone()
    bad_s[0, 1] ^= 1
    assert not bool(tpb.rlc_verify_core(args[0], args[1], bad_s, args[3],
                                        torch.from_numpy(z), tables, msm_c=4))


def test_rfc8032_tests_1_2_3():
    pks = [v[1] for v in RFC_VECTORS]
    msgs = [v[2] for v in RFC_VECTORS]
    sigs = [v[3] for v in RFC_VECTORS]
    assert [torc.public_key(v[0]) for v in RFC_VECTORS] == pks
    assert [torc.sign(v[0], v[2]) for v in RFC_VECTORS] == sigs
    tampered = [s[:63] + bytes([s[63] ^ 1]) for s in sigs]
    got = tpe.verify_host(pks * 2, msgs * 2, sigs + tampered, device="cpu")
    assert got == [True] * 3 + [False] * 3
    assert tpb.verify_batch_host(pks, msgs, sigs, device="cpu") == [True] * 3


def test_message_length_sweep():
    """Lengths across the SHA-512 block edges (111/112, 127/128, 239/240),
    signed by the JAX package's oracle; every other lane's message altered."""
    lengths = list(range(0, 8)) + [31, 32, 33, 63, 64, 65, 111, 112, 113,
                                   127, 128, 129, 239, 240, 241, 300]
    rng = random.Random(7)
    sk = bytes(rng.randrange(256) for _ in range(32))
    pk = jorc.public_key(sk)
    msgs = [bytes(rng.randrange(256) for _ in range(n)) for n in lengths]
    sigs = [jorc.sign(sk, m) for m in msgs]
    assert [torc.sign(sk, m) for m in msgs[:4]] == sigs[:4]
    altered = [m + b"\x00" if i % 2 else m for i, m in enumerate(msgs)]
    want = [jorc.verify(pk, m, s) for m, s in zip(altered, sigs)]
    assert want == [i % 2 == 0 for i in range(len(msgs))]
    assert tpe.verify_host([pk] * len(msgs), altered, sigs, device="cpu") == want


def test_sha512_batch_matches_hashlib():
    rng = random.Random(3)
    msgs = [bytes(rng.randrange(256) for _ in range(n))
            for n in (0, 1, 111, 112, 127, 128, 300)]
    got = sha512_batch(msgs)
    assert got.shape == (64, len(msgs))
    assert [bytes(got[:, i].astype(np.uint8)) for i in range(len(msgs))] == [
        hashlib.sha512(m).digest() for m in msgs]
    assert hasher() in ("openssl libcrypto.so.3", "openssl libcrypto.so.1.1",
                        "portable")
