"""The port's ristretto255 (curves/ristretto255.py) on the CPU against RFC
9496 and the port's integer oracle, byte for byte: the A.1 multiples by
the comb and by CT scalar_mul and their round trip, the 17 A.2 encodings
rejected, the A.3 one-way-map literals, the group law under the
representative-independent eq, random encodings and maps against the
oracle, and the empty batch. The comparison with the JAX package's
ristretto255 is in test_torch_parity_ristretto.py. (Three tests: see
test_torch_sign.py for why.)"""

import random

import torch

from eccoxide_tpu_torch import oracle
from eccoxide_tpu_torch.curves import ristretto255 as rz
from eccoxide_tpu_torch.field import FQ, L
from eccoxide_tpu_torch.limbs import windows_from_bytes_le
from eccoxide_tpu_torch.ops import group
from kats_rfc9496 import A1_MULTIPLES, A2_BAD, A3_UNIFORM


def cols(bs):
    return torch.tensor([list(b) for b in bs], dtype=torch.int32).T.contiguous()


def rows(t):
    return [bytes(r) for r in t.T.tolist()]


def _scalars(ks):
    return cols([k.to_bytes(32, "little") for k in ks])


def test_rfc9496_vectors():
    """A.1 by mul_base and by CT scalar_mul, their round trip, A.2 all
    rejected, A.3 byte-equal; decompress of the empty batch."""
    group.reset_launches()
    a1 = [bytes.fromhex(h) for h in A1_MULTIPLES]
    sb = _scalars(range(16))
    comb = rz.mul_base(sb)
    ct = rz.scalar_mul(rz.generator((16,), "cpu"), windows_from_bytes_le(sb, 64))
    assert rows(rz.compress(comb)) == a1
    assert rows(rz.compress(ct)) == a1
    pt, ok = rz.decompress(cols(a1))
    assert ok.all() and rows(rz.compress(pt)) == a1
    assert rz.eq(pt, comb).all() and rz.eq(pt, ct).all()
    _, ok = rz.decompress(cols([bytes.fromhex(h) for h in A2_BAD]))
    assert not ok.any(), ok.tolist()
    outs = rows(rz.compress(rz.from_uniform_bytes(cols([bytes.fromhex(i) for i, _ in A3_UNIFORM]))))
    assert outs == [bytes.fromhex(o) for _, o in A3_UNIFORM]
    empty, ok = rz.decompress(torch.zeros((32, 0), dtype=torch.int32))
    assert empty.xyzt.shape == (4, 10, 0) and ok.shape == (0,)
    assert sum(group.launches().values()) == 0


def test_group_law_and_eq():
    """[k]G + [j]G == [k + j]G under eq, equal for any representative of a
    point (its coordinates scaled, or plus a point of order 4) and unequal
    for different elements; neg, double and the identity."""
    rng = random.Random(7)
    ks = [rng.randrange(1, L) for _ in range(6)]
    js = [rng.randrange(1, L) for _ in range(6)]
    Pk, Pj = rz.mul_base(_scalars(ks)), rz.mul_base(_scalars(js))
    Ps = rz.mul_base(_scalars([(k + j) % L for k, j in zip(ks, js)]))
    assert rz.eq(rz.add(Pk, Pj), Ps).all()
    assert rz.eq(rz.double(Pk), rz.mul_base(_scalars([2 * k % L for k in ks]))).all()
    assert rz.eq(rz.add(Pk, rz.neg(Pk)), rz.identity((6,), "cpu")).all()
    assert not rz.eq(Pk, Pj).any()
    # another representative of the same element: scaled coordinates, and
    # the coset's other members P + T4 for the point T4 = (i, 0) of order 4
    lam = FQ.encode_ints([rng.randrange(1, FQ.p) for _ in range(6)], "cpu")
    scaled = rz.ExtPoint(torch.stack([FQ.mul(c, lam) for c in Pk.xyzt]))
    i = FQ.const(FQ.p - pow(2, (FQ.p - 1) // 4, FQ.p), (6,), "cpu")
    t4 = rz.ExtPoint(torch.stack([i, FQ.zero((6,), "cpu"), FQ.one((6,), "cpu"), FQ.zero((6,), "cpu")]))
    coset = rz.add(Pk, t4)
    assert rz.eq(scaled, Pk).all() and rz.eq(coset, Pk).all()
    assert rows(rz.compress(scaled)) == rows(rz.compress(Pk)) == rows(rz.compress(coset))


def test_random_encodings_and_maps_against_the_oracle():
    """compress of random multiples, decompress of their encodings and of
    odd, non-canonical and non-square ones, and from_uniform_bytes on
    random inputs (values of the 255 bits at and above p among them), all
    against the oracle."""
    rng = random.Random(9496)
    ks = [rng.randrange(L) for _ in range(8)]
    enc = rows(rz.compress(rz.mul_base(_scalars(ks))))
    assert enc == [oracle.ristretto_compress(oracle.ristretto_mul(k)) for k in ks]
    p = FQ.p
    odd = next(e for e in enc if e[0] & 1 == 0)
    probe = enc + [bytes([odd[0] | 1]) + odd[1:], (p + 2).to_bytes(32, "little"),
                   (2**255 + 4).to_bytes(32, "little")]
    probe += [v.to_bytes(32, "little") for v in range(2, 40, 2)
              if oracle.ristretto_decompress(v.to_bytes(32, "little")) is None][:3]
    pt, ok = rz.decompress(cols(probe))
    assert ok.tolist() == [oracle.ristretto_decompress(b) is not None for b in probe]
    assert rows(rz.compress(pt))[:8] == enc
    ins = [rng.randbytes(64) for _ in range(8)]
    ins[0] = (p + 5).to_bytes(32, "little") + (2**255 - 1).to_bytes(32, "little")
    ins[1] = (2**256 - 1).to_bytes(32, "little") * 2
    got = rows(rz.compress(rz.from_uniform_bytes(cols(ins))))
    assert got == [oracle.ristretto_compress(oracle.ristretto_from_uniform_bytes(b)) for b in ins]
