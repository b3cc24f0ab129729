"""The port's X448 on the CPU, without the JAX package's graphs: the RFC
7748 section 5.2 vectors and the section 6.2 exchange through
x448_host/x448_base_host; batches against the port's integer oracle and
`cryptography`, with non-canonical u; low-order u. (Three tests: see
test_torch_sign.py for why.)"""

import random

import numpy as np
import torch
from cryptography.hazmat.primitives import serialization as ser
from cryptography.hazmat.primitives.asymmetric.x448 import X448PrivateKey

from eccoxide_tpu_torch import oracle
from eccoxide_tpu_torch.protocol import x448 as tx
from test_x448 import (DH_A_PRIV, DH_A_PUB, DH_B_PRIV, DH_B_PUB, DH_SHARED, V1_OUT,
                       V1_SCALAR, V1_U, V2_OUT, V2_SCALAR, V2_U)

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

P = 2**448 - 2**224 - 1
# u of low order (0, 1, p - 1) and the non-canonical encodings p, p + 1
LOW_ORDER = [0, 1, P - 1, P, P + 1]


def _cols(bs):
    return torch.from_numpy(np.array([list(b) for b in bs], np.int32).T.copy())


def _rows(cols):
    return [bytes(r) for r in cols.T.tolist()]


def test_rfc7748_vectors_and_exchange():
    """Section 5.2 vector 1 and A's public key through the host functions;
    vector 2, both ways of the section 6.2 exchange and B's public key in
    one batch each."""
    assert tx.x448_host(V1_SCALAR, V1_U, device="cpu") == V1_OUT
    assert tx.x448_base_host(DH_A_PRIV, device="cpu") == DH_A_PUB
    out = tx.x448(_cols([V2_SCALAR, DH_A_PRIV, DH_B_PRIV]), _cols([V2_U, DH_B_PUB, DH_A_PUB]))
    assert _rows(out) == [V2_OUT, DH_SHARED, DH_SHARED]
    assert _rows(tx.x448_base(_cols([DH_B_PRIV]))) == [DH_B_PUB]


def test_batches_against_oracle_and_cryptography():
    rng = random.Random(448)
    B = 8
    scs = [bytes(rng.randrange(256) for _ in range(56)) for _ in range(B)]
    us = [bytes(rng.randrange(256) for _ in range(56)) for _ in range(B - 2)]
    us += [(P + 5).to_bytes(56, "little"), (2**448 - 1).to_bytes(56, "little")]
    got = _rows(tx.x448(_cols(scs), _cols(us)))
    assert got == [oracle.x448(s, u) for s, u in zip(scs, us)]
    pubs = _rows(tx.x448_base(_cols(scs)))
    assert pubs == [X448PrivateKey.from_private_bytes(s).public_key().public_bytes(
        ser.Encoding.Raw, ser.PublicFormat.Raw) for s in scs]


def test_low_order_u_gives_zero():
    rng = random.Random(4)
    us = [v.to_bytes(56, "little") for v in LOW_ORDER] + [V1_U]
    scs = [bytes(rng.randrange(256) for _ in range(56)) for _ in us]
    out = tx.x448(_cols(scs), _cols(us))
    assert _rows(out)[:-1] == [bytes(56)] * len(LOW_ORDER)
    assert [oracle.x448(s, u) for s, u in zip(scs, us)][:-1] == [bytes(56)] * len(LOW_ORDER)
    assert tx.was_contributory(out).tolist() == [False] * len(LOW_ORDER) + [True]
