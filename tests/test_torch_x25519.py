"""The port's X25519 on the CPU, without the JAX package's graphs: the RFC
7748 section 5.2 vectors, the iterated-once case and the section 6.1
exchange through x25519_host/x25519_base_host; batches against the port's
integer oracle and `cryptography`, with non-canonical u; low-order u.
(Three tests: see test_torch_sign.py for why.)"""

import random

import numpy as np
import torch
from cryptography.hazmat.primitives import serialization as ser
from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey

from eccoxide_tpu_torch import oracle
from eccoxide_tpu_torch.protocol import x25519 as tx
from test_x25519 import (ALICE_PRIV, ALICE_PUB, BOB_PRIV, BOB_PUB, IT1_K, IT1_OUT,
                         SHARED, V1_OUT, V1_SCALAR, V1_U, V2_OUT, V2_SCALAR, V2_U)

P = 2**255 - 19
# u of low order (0, 1, the two points of order 8, p - 1) and the
# non-canonical encodings p, p + 1 and 2^255 + 1 (bit 255 is masked)
LOW_ORDER = [0, 1,
             325606250916557431795983626356110631294008115727848805560023387167927233504,
             39382357235489614581723060781553021112529911719440698176882885853963445705823,
             P - 1, P, P + 1, 2**255 + 1]


def _cols(bs):
    return torch.from_numpy(np.array([list(b) for b in bs], np.int32).T.copy())


def _rows(cols):
    return [bytes(r) for r in cols.T.tolist()]


def test_rfc7748_vectors_and_exchange():
    """Section 5.2 vector 1 and Alice's public key through the host
    functions; vector 2, both ways of the section 6.1 exchange, Bob's
    public key and the iterated-once case in one batch each."""
    assert tx.x25519_host(V1_SCALAR, V1_U, device="cpu") == V1_OUT
    assert tx.x25519_base_host(ALICE_PRIV, device="cpu") == ALICE_PUB
    out = tx.x25519(_cols([V2_SCALAR, ALICE_PRIV, BOB_PRIV]), _cols([V2_U, BOB_PUB, ALICE_PUB]))
    assert _rows(out) == [V2_OUT, SHARED, SHARED]
    assert _rows(tx.x25519_base(_cols([BOB_PRIV, IT1_K]))) == [BOB_PUB, IT1_OUT]


def test_batches_against_oracle_and_cryptography():
    """Random scalars and u (bit 255 set in some), u in [p, 2^255) and
    2^255 - 1: x25519 against the oracle; x25519_base against
    `cryptography`'s public keys."""
    rng = random.Random(7748)
    B = 10
    scs = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(B)]
    us = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(B - 3)]
    us += [(P + 5).to_bytes(32, "little"), (2**255 - 1).to_bytes(32, "little"),
           (2**256 - 1).to_bytes(32, "little")]
    got = _rows(tx.x25519(_cols(scs), _cols(us)))
    assert got == [oracle.x25519(s, u) for s, u in zip(scs, us)]
    pubs = _rows(tx.x25519_base(_cols(scs)))
    assert pubs == [X25519PrivateKey.from_private_bytes(s).public_key().public_bytes(
        ser.Encoding.Raw, ser.PublicFormat.Raw) for s in scs]


def test_low_order_u_gives_zero():
    rng = random.Random(3)
    us = [v.to_bytes(32, "little") for v in LOW_ORDER] + [V1_U]
    scs = [bytes(rng.randrange(256) for _ in range(32)) for _ in us]
    out = tx.x25519(_cols(scs), _cols(us))
    assert _rows(out)[:-1] == [bytes(32)] * len(LOW_ORDER)
    assert [oracle.x25519(s, u) for s, u in zip(scs, us)][:-1] == [bytes(32)] * len(LOW_ORDER)
    assert tx.was_contributory(out).tolist() == [False] * len(LOW_ORDER) + [True]
