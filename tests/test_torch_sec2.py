"""The port's 15 SEC2 curves (curves/weierstrass.py, curves/sec2.py, the
comb of params/comb.py) on the CPU, against the NIST and sage KATs, the
port's integer oracle and `cryptography`: CT scalar_mul and the comb,
the completeness properties of the JAX package's tests/test_sec2.py,
SEC1 compress and decompress with their rejections, the affine API, and
the card as the default device. Each curve's vectors go through one
batched call per operation. (Three tests: see test_torch_sign.py for
why.)"""

import random

import pytest
import torch
from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric import ec

from eccoxide_tpu_torch import oracle
from eccoxide_tpu_torch.curves import sec2
from eccoxide_tpu_torch.limbs import windows_from_bytes_le
from eccoxide_tpu_torch.params.comb import get_weierstrass_comb
from kats_nist import KATS
from kats_sage_p256k1 import SAGE_P256K1

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

CRYPTOGRAPHY_CURVES = {"p192r1": ec.SECP192R1, "p224r1": ec.SECP224R1,
                       "p256k1": ec.SECP256K1, "p256r1": ec.SECP256R1,
                       "p384r1": ec.SECP384R1, "p521r1": ec.SECP521R1}


def _scalar_bytes(spec, ks):
    nb = spec.scalar.n_bytes
    return torch.tensor([list(k.to_bytes(nb, "little")) for k in ks],
                        dtype=torch.int32).T.contiguous()


def _windows(spec, ks):
    return windows_from_bytes_le(_scalar_bytes(spec, ks), -(-spec.scalar.bits // 4))


def _affine(spec, P):
    ax, ay = spec.to_affine(P)
    return list(zip(spec.field.decode_ints(ax), spec.field.decode_ints(ay)))


def _cols(rows):
    return torch.tensor([list(r) for r in rows], dtype=torch.int32).T.contiguous()


def test_kats_through_the_comb_and_ct_scalar_mul():
    """All 52 NIST vectors of each NIST curve through mul_base, eight of
    them through CT scalar_mul; the 100 sage p256k1 multiples through
    both."""
    sets = {name: [(int(k, 16), (int(x, 16), int(y, 16))) for k, x, y in vecs]
            for name, vecs in KATS.items()}
    sets["p256k1"] = [(k, (int(x, 16), int(y, 16))) for k, x, y in SAGE_P256K1]
    assert set(sets) == {"p192r1", "p224r1", "p256r1", "p384r1", "p521r1", "p256k1"}
    for name, vecs in sets.items():
        spec = sec2.get_curve(name)
        ks, want = [k for k, _ in vecs], [pt for _, pt in vecs]
        assert _affine(spec, spec.mul_base(_scalar_bytes(spec, ks))) == want, name
        sub = vecs if name == "p256k1" else vecs[:6] + vecs[-2:]
        ks, want = [k for k, _ in sub], [pt for _, pt in sub]
        G = spec.generator((len(ks),), "cpu")
        assert _affine(spec, spec.scalar_mul(G, _windows(spec, ks))) == want, name


def test_every_curve_against_the_oracle():
    """For each of the 15 curves: [k]G by CT scalar_mul and by the comb
    against the oracle ([a]G + [b]G == [a+b]G in the same call), P + P ==
    2P, P + (-P) == O, P + O == P, on_curve; compress against the oracle's
    SEC1 bytes (and `cryptography`'s where it has the curve), decompress
    back, and the rejection of x >= p, of an x off the curve and of tags
    other than 2 and 3; the affine API."""
    shapes = set()
    for name in sec2.ALL:
        spec, o = sec2.get_curve(name), oracle.sec2_curve(name)
        f, q, nb = spec.field, o.order, spec.field.n_bytes
        shapes.add(spec.shape)
        rng = random.Random(name)
        ab = [(rng.randrange(1, q), rng.randrange(1, q)) for _ in range(2)]
        ks = [1, 2, 15, 16, q - 1] + [a for a, _ in ab] + [b for _, b in ab] + [
            (a + b) % q for a, b in ab]
        if name in CRYPTOGRAPHY_CURVES:
            ks.append(rng.randrange(1, q))
        B = len(ks)
        want = [o.mul_base(k) for k in ks]
        P = spec.scalar_mul(spec.generator((B,), "cpu"), _windows(spec, ks))
        assert _affine(spec, P) == want, name
        assert spec.eq(spec.mul_base(_scalar_bytes(spec, ks)), P).all(), name
        a_, b_, s_ = (P.xyz[:, :, 5 + 2 * i:5 + 2 * i + 2] for i in range(3))
        Pa, Pb, Ps = (type(P)(t) for t in (a_, b_, s_))
        assert spec.eq(spec.add(Pa, Pb), Ps).all(), name
        ident = spec.identity((B,), "cpu")
        assert spec.eq(spec.double(P), spec.add(P, P)).all(), name
        assert spec.is_identity(spec.add(P, spec.neg(P))).all(), name
        assert spec.eq(spec.add(P, ident), P).all() and spec.eq(spec.add(ident, P), P).all()
        assert spec.is_identity(spec.double(ident)).all() and spec.on_curve(P).all(), name
        by = spec.compress(P)
        enc = [bytes(c) for c in by.T.tolist()]
        assert enc == [o.compress(pt) for pt in want], name
        if name in CRYPTOGRAPHY_CURVES:
            key = ec.derive_private_key(ks[-1], CRYPTOGRAPHY_CURVES[name]())
            assert enc[-1] == key.public_key().public_bytes(
                serialization.Encoding.X962, serialization.PublicFormat.CompressedPoint), name
        Q, ok = spec.decompress(by)
        assert ok.all() and spec.eq(Q, P).all(), name
        # rejections: x = p, x = 2^(8 nb) - 1, an x with no point, tags 0, 1, 4
        x_off = next(x for x in range(2, 1000) if o.decompress(bytes([2]) + x.to_bytes(nb, "big")) is None)
        bad = [bytes([2]) + o.p.to_bytes(nb, "big"), bytes([3]) + (2 ** (8 * nb) - 1).to_bytes(nb, "big"),
               bytes([2]) + x_off.to_bytes(nb, "big"), bytes([0]) + enc[0][1:],
               bytes([1]) + enc[0][1:], bytes([4]) + enc[0][1:]]
        assert all(o.decompress(e) is None for e in bad)
        assert spec.decompress(_cols(bad))[1].tolist() == [False] * len(bad), name
        # affine API: from_coordinate, affine_double, affine_add_different
        (x1, y1), (x2, y2) = o.mul_base(5), o.mul_base(9)
        X1, Y1, X2, Y2 = (f.encode_ints([v], "cpu") for v in (x1, y1, x2, y2))
        Pc, okc = spec.from_coordinate(X1, Y1)
        assert okc.all() and not spec.from_coordinate(X1, Y2)[1].any(), name
        assert _affine(spec, Pc) == [(x1, y1)], name
        dx, dy = spec.affine_double(X1, Y1)
        sx, sy = spec.affine_add_different(X1, Y1, X2, Y2)
        assert (f.decode_ints(dx)[0], f.decode_ints(dy)[0]) == o.mul_base(10), name
        assert (f.decode_ints(sx)[0], f.decode_ints(sy)[0]) == o.mul_base(14), name
    assert shapes == {"generic", "a0", "am3"}


def test_constructors_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    spec = sec2.get_curve("p256r1")
    f = spec.field
    calls = [lambda: spec.identity((1,)), lambda: spec.generator((1,)),
             lambda: f.encode_ints([1]), lambda: f.const(1, (1,)),
             lambda: f.zero((1,)), lambda: f.one((1,)),
             lambda: get_weierstrass_comb(spec).tables()]
    for call in calls:
        with pytest.raises(RuntimeError):
            call()
    # the same calls run on the CPU when asked
    assert spec.identity((1,), "cpu").xyz.shape == (3, f.n, 1)
    assert get_weierstrass_comb(spec).tables("cpu").shape == (64, 16, 2, f.n)
