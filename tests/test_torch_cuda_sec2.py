"""The SEC2 pow kernel on the card: every prime's instance (coordinate
primes, group orders, l) against its plain version limb for limb, on the
exponents the SEC2 path uses, and the
SEC2 path on the card against the CPU. Marked ``cuda``; every test skips
inside its body when no CUDA device is present. Run on a machine with the
card:

    python -m pytest -m cuda tests/test_torch_cuda_sec2.py --noconftest
"""

import pytest
import torch

from eccoxide_tpu_torch.curves import sec2
from eccoxide_tpu_torch.field import L
from eccoxide_tpu_torch.field_sec2 import field_of
from eccoxide_tpu_torch.limbs import windows_from_bytes_le
from eccoxide_tpu_torch.ops import group

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_pow_sec2_equals_plain_for_every_field():
    """Widths 0, 1 and 129 (a tail of one lane in the second block), for
    every instance: the 15 coordinate fields, the 15 group orders (the
    curves' scalar fields) and l; a prime with no instance raises."""
    dev = _card()
    seen = set()
    fields = ([sec2.get_curve(name).field for name in sec2.ALL]
              + [sec2.get_curve(name).scalar for name in sec2.ALL] + [field_of(L)])
    for W in (0, 1, 129):
        gen = torch.Generator().manual_seed(W)
        for f in fields:
            name = f.name
            seen.add(group.build.POW_SEC2_INSTANCES[f.p])
            top = torch.tensor(f.fmt.LARGEST, dtype=torch.int64)
            x = (torch.randint(0, 1 << 62, (f.n, W), generator=gen) % (top[:, None] + 1)).to(torch.int32)
            if W > 1:
                x[:, 0] = top.to(torch.int32)
            group.reset_launches()
            for tag, e in {**f.path_exponents(), "0x1234": 0x1234, "0": 0}.items():
                got = group.pow_sec2_kernel(f, x.to(dev), e)
                assert got.device.type == "cuda"
                assert torch.equal(got.cpu(), group.pow_sec2_plain(f, x, e)), (name, W, tag)
            launched = group.launches()["pow_sec2_kernel"]
            assert launched == (len(f.path_exponents()) + 1 if W else 0), (name, W)
    assert seen == set(group.build.POW_SEC2_INSTANCES.values())
    m127 = field_of(2**127 - 1)
    with pytest.raises(ValueError, match="no pow_sec2 kernel"):
        group.pow_sec2_kernel(m127, m127.encode_ints([3], "cpu").to(dev), 5)


def test_sec2_path_on_the_card_matches_the_cpu():
    """mul_base, compress, decompress and CT scalar_mul of p256r1 on the
    card equal the CPU's, with one pow launch per compress (the inverse of
    to_affine) and one per decompress (the square root): 3 in all."""
    dev = _card()
    spec = sec2.get_curve("p256r1")
    ks = [1, 2, 3, spec.scalar.p - 1, 12345]
    sb = torch.tensor([list(k.to_bytes(32, "little")) for k in ks], dtype=torch.int32).T.contiguous()
    out = {}
    for d in ("cpu", dev):
        group.reset_launches()
        P = spec.mul_base(sb.to(d))
        by = spec.compress(P)
        Q, ok = spec.decompress(by)
        R = spec.scalar_mul(Q, windows_from_bytes_le(sb.to(d), 64))
        out[str(d)] = (by.cpu(), ok.cpu(), spec.compress(R).cpu(), group.launches()["pow_sec2_kernel"])
    cpu, card = out["cpu"], out[str(dev)]
    assert torch.equal(cpu[0], card[0]) and torch.equal(cpu[2], card[2]) and card[1].all()
    assert cpu[3] == 0 and card[3] == 3
