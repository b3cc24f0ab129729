"""The port's CUDA kernels on the card. Marked ``cuda``; every test skips
inside its body when no CUDA device is present. Run on a machine with the
card:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import random

import numpy as np
import pytest
import torch

from eccoxide_tpu_torch import oracle
from eccoxide_tpu_torch.field import FQ, P, TIGHT
from eccoxide_tpu_torch.ops import group
from eccoxide_tpu_torch.protocol import ed25519 as tpe
from eccoxide_tpu_torch.protocol import ed25519_batch as tpb

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand_fe(gen, W):
    r = torch.randint(0, 1 << 62, (10, W), generator=gen)
    return (r % (torch.tensor(TIGHT).view(10, 1) + 1)).to(torch.int32)


def _points(gen, W):
    tables = tpe.VerifyTables("cpu")
    k = torch.randint(0, 256, (W,), generator=gen)
    x, y, t = tables.byte[:, :, k]
    lam = _rand_fe(gen, W)
    return torch.stack([FQ.mul(x, lam), FQ.mul(y, lam), lam, FQ.mul(t, lam)])


@pytest.mark.parametrize("W", [0, 1, 511, 512, 513, 768])
def test_kernels_equal_plain_versions(W):
    dev = _card()
    gen = torch.Generator().manual_seed(W)
    p, q = _points(gen, W), _points(gen, W)
    if W >= 3:
        q[:, :, 1] = p[:, :, 1]
        q[:, :, 2] = torch.stack([FQ.neg(p[0, :, 2]), p[1, :, 2], p[2, :, 2],
                                  FQ.neg(p[3, :, 2])])
    x = _rand_fe(gen, W)
    got = [group.ed_add(p.to(dev), q.to(dev)), group.ed_double(p.to(dev)),
           group.pow_const_kernel(x.to(dev), (P - 5) // 8),
           group.pow_const_kernel(x.to(dev), P - 2)]
    torch.cuda.synchronize()
    want = [group.ed_add_plain(p, q), group.ed_double_plain(p),
            group.pow_const_plain(x, (P - 5) // 8), group.pow_const_plain(x, P - 2)]
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)


def test_zero_width_launches_nothing():
    dev = _card()
    group.reset_launches()
    p = torch.zeros((4, 10, 0), dtype=torch.int32, device=dev)
    assert group.ed_add(p, p) is p and group.ed_double(p) is p
    x = p[0].contiguous()
    assert group.pow_const_kernel(x, 5) is x
    assert group.launches() == {"pow_const_kernel": 0, "ed_add": 0, "ed_double": 0}


def test_verifiers_on_the_card_match_the_cpu():
    _card()
    rng = random.Random(9)
    sks = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(6)]
    msgs = [bytes(rng.randrange(256) for _ in range(20)) for _ in range(6)]
    pks = [oracle.public_key(s) for s in sks]
    sigs = [oracle.sign(s, m) for s, m in zip(sks, msgs)]
    sigs[2] = sigs[2][:40] + bytes([sigs[2][40] ^ 1]) + sigs[2][41:]
    group.reset_launches()
    on_card = tpe.verify_host(pks, msgs, sigs)
    batch = tpb.verify_batch_host(pks, msgs, sigs, rng=np.random.default_rng(3))
    assert min(group.launches().values()) > 0
    cpu = tpe.verify_host(pks, msgs, sigs, device="cpu")
    assert on_card == batch == cpu == [True, True, False, True, True, True]
