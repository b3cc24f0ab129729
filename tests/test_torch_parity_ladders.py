"""The port's x25519_host and x448_host against the JAX package's on the
same random scalars and u (a non-canonical u among them). The JAX ladders
take tens of seconds to compile on the CPU, so they sit in a file of few
tests (see test_torch_parity_verify.py); the base-point forms are held
against `cryptography`, the oracle and RFC 7748 in test_torch_x25519.py
and test_torch_x448.py."""

import random

import torch

from eccoxide_tpu.protocol import x448 as jx448
from eccoxide_tpu.protocol import x25519 as jx25519
from eccoxide_tpu_torch.protocol import x448 as tx448
from eccoxide_tpu_torch.protocol import x25519 as tx25519

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _case(n: int, p: int, seed: int):
    rng = random.Random(seed)
    scalars = [bytes(rng.randrange(256) for _ in range(n)) for _ in range(2)]
    us = [bytes(rng.randrange(256) for _ in range(n)), (p + 2).to_bytes(n, "little")]
    return scalars, us


def test_x25519_host_identical_to_jax():
    for s, u in zip(*_case(32, 2**255 - 19, 1)):
        assert tx25519.x25519_host(s, u, device="cpu") == jx25519.x25519_host(s, u)


def test_x448_host_identical_to_jax():
    for s, u in zip(*_case(56, 2**448 - 2**224 - 1, 2)):
        assert tx448.x448_host(s, u, device="cpu") == jx448.x448_host(s, u)
