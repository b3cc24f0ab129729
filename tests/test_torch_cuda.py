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


WIDTHS = [0, 1, 511, 512, 513, 768, 32768]


def _operands(W):
    """p, q: random points with, among the lanes, the identity (p), P + P,
    P + (-P) and the largest TIGHT limbs in every coordinate; q_xyt: random
    affine points x|y|t with the largest TIGHT limbs in lane 3; x: random
    field elements with 0 and the largest TIGHT limbs."""
    gen = torch.Generator().manual_seed(W)
    p, q = _points(gen, W), _points(gen, W)
    x = _rand_fe(gen, W)
    k = torch.randint(0, 256, (W,), generator=gen)
    q_xyt = tpe.VerifyTables("cpu").byte[:, :, k]
    top = torch.tensor(TIGHT, dtype=torch.int32)
    if W >= 4:
        p[:, :, 0] = torch.stack([FQ.zero((), "cpu"), FQ.one((), "cpu"),
                                  FQ.one((), "cpu"), FQ.zero((), "cpu")])
        q[:, :, 1] = p[:, :, 1]
        q[:, :, 2] = torch.stack([FQ.neg(p[0, :, 2]), p[1, :, 2], p[2, :, 2],
                                  FQ.neg(p[3, :, 2])])
        p[:, :, 3] = top.view(1, 10)
        q[:, :, 3] = top.view(1, 10)
        q_xyt[:, :, 3] = top.view(1, 10)
        x[:, 0] = 0
        x[:, 1] = top
    return p, q, q_xyt, x


@pytest.mark.parametrize("mode", ["full", "need_t=False", "mixed"])
@pytest.mark.parametrize("W", WIDTHS)
def test_add_modes_equal_plain_versions(W, mode):
    """ed_add with and without T, and ed_add_mixed, limb for limb; the
    widths 0, 1, 511 and 513 leave tail lanes in a block of 32."""
    dev = _card()
    p, q, q_xyt, _ = _operands(W)
    group.reset_launches()
    if mode == "mixed":
        got, want = group.ed_add_mixed(p.to(dev), q_xyt.to(dev)), group.ed_add_mixed_plain(p, q_xyt)
    else:
        need_t = mode == "full"
        got, want = group.ed_add(p.to(dev), q.to(dev), need_t), group.ed_add_plain(p, q, need_t)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    assert group.ed_add.launches_by_mode == {m: int(m == mode and W > 0) for m in
                                             ("full", "need_t=False", "mixed")}


@pytest.mark.parametrize("W", WIDTHS)
def test_kernels_equal_plain_versions(W):
    dev = _card()
    _, _, _, x = _operands(W)
    got = [group.pow_const_kernel(x.to(dev), (P - 5) // 8),
           group.pow_const_kernel(x.to(dev), P - 2)]
    torch.cuda.synchronize()
    want = [group.pow_const_plain(x, (P - 5) // 8), group.pow_const_plain(x, P - 2)]
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("need_t", [True, False])
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("W", WIDTHS)
def test_double_runs_equal_plain_versions(W, k, need_t):
    dev = _card()
    p, _, _, _ = _operands(W)
    got = group.ed_double(p.to(dev), need_t, k)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), group.ed_double_plain(p, need_t, k))


def test_zero_width_launches_nothing():
    dev = _card()
    group.reset_launches()
    p = torch.zeros((4, 10, 0), dtype=torch.int32, device=dev)
    assert group.ed_add(p, p) is p and group.ed_double(p) is p
    assert group.ed_add(p, p, need_t=False) is p and group.ed_add_mixed(p, p[:3]) is p
    assert group.ed_double(p, need_t=False, k=8) is p
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
