"""The port's SEC2 group law against the JAX package's, for the slice as a
whole: the complete addition and doubling of one curve of each RCB15
shape (p112r2 generic a, p256k1 a = 0, p256r1 a = -3), one CT scalar_mul
(p256r1, B = 4) and one comb mul_base (p256r1), its tables carried across
from the JAX package's ``WeierstrassComb.tables()`` by convert.py. The
same seeded inputs go through both; the results must be equal as affine
ints. (Three tests: see test_torch_parity_verify.py.)"""

import random

import jax
import numpy as np
import torch

from eccoxide_tpu.curves import sec2 as jsec2
from eccoxide_tpu.curves.weierstrass import ProjPoint as JProjPoint
from eccoxide_tpu.params.comb import get_weierstrass_comb as jax_comb
from eccoxide_tpu_torch import convert, oracle
from eccoxide_tpu_torch.curves import sec2
from eccoxide_tpu_torch.curves.weierstrass import ProjPoint
from eccoxide_tpu_torch.limbs import windows_from_bytes_le
from eccoxide_tpu_torch.params.comb import get_weierstrass_comb

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _points(name, seed):
    """Projective points (X, Y, Z) as ints: random [k]G scaled by random
    lambdas, with the identity, P and P, P and -P among the lanes of the
    (p, q) pair."""
    o = oracle.sec2_curve(name)
    rng = random.Random(seed)
    ks = [rng.randrange(1, o.order) for _ in range(5)]
    pts = [o.mul_base(k) for k in ks]

    def proj(pt):
        lam = rng.randrange(1, o.p)
        return (0, lam, 0) if pt is None else (pt[0] * lam % o.p, pt[1] * lam % o.p, lam)

    ps = [None] + pts[:4]
    qs = [pts[4], pts[0], (pts[1][0], -pts[1][1] % o.p), pts[2], None]
    return [proj(pt) for pt in ps], [proj(pt) for pt in qs]


def _port_point(f, pts):
    return ProjPoint(torch.stack([f.encode_ints([pt[i] for pt in pts], "cpu") for i in range(3)]))


def _affine(spec, P):
    ax, ay = spec.to_affine(P)
    return list(zip(spec.field.decode_ints(ax), spec.field.decode_ints(ay)))


def _jax_affine(spec, P):
    """A JAX ProjPoint's affine ints, through convert.py and the port's
    to_affine (no JAX inverse to compile)."""
    return _affine(spec, convert.point_from_jax(spec.field, tuple(np.asarray(c) for c in P)))


def test_add_and_double_match_jax():
    shapes = set()
    for name in ("p112r2", "p256k1", "p256r1"):
        spec, jspec = sec2.get_curve(name), jsec2.get_curve(name)
        shapes.add(spec.shape)
        ps, qs = _points(name, len(name))
        P, Q = _port_point(spec.field, ps), _port_point(spec.field, qs)
        jP, jQ = (JProjPoint(*convert.point_to_jax(spec.field, t)) for t in (P, Q))
        jsum, jdbl = jax.jit(lambda a, b: (jspec.add(a, b), jspec.double(a)))(jP, jQ)
        for got, want in ((spec.add(P, Q), jsum), (spec.double(P), jdbl)):
            assert _affine(spec, got) == _jax_affine(spec, want), name
            back = convert.point_from_jax(spec.field, tuple(np.asarray(c) for c in want))
            assert spec.eq(back, got).all(), name
        assert spec.is_identity(spec.add(P, Q)).tolist() == [False, False, True, False, False]
    assert shapes == {"generic", "a0", "am3"}


def test_scalar_mul_matches_jax():
    spec, jspec = sec2.get_curve("p256r1"), jsec2.get_curve("p256r1")
    o = oracle.sec2_curve("p256r1")
    rng = random.Random(4)
    ks = [1, o.order - 1] + [rng.randrange(1, o.order) for _ in range(2)]
    ps, _ = _points("p256r1", 5)
    P = _port_point(spec.field, ps[1:])                   # four random points
    sb = torch.tensor([list(k.to_bytes(32, "little")) for k in ks], dtype=torch.int32).T
    w = windows_from_bytes_le(sb.contiguous(), 64)
    jP = JProjPoint(*convert.point_to_jax(spec.field, P))
    want = jax.jit(jspec.scalar_mul)(jP, w.numpy())
    assert _affine(spec, spec.scalar_mul(P, w)) == _jax_affine(spec, want)


def test_mul_base_matches_jax():
    """The comb on the JAX package's own tables, carried across."""
    spec, jspec = sec2.get_curve("p256r1"), jsec2.get_curve("p256r1")
    o = oracle.sec2_curve("p256r1")
    rng = random.Random(6)
    ks = [0, 1, 15, 16, o.order - 1] + [rng.randrange(1, o.order) for _ in range(3)]
    sb = torch.tensor([list(k.to_bytes(32, "little")) for k in ks], dtype=torch.int32).T.contiguous()
    jtab = jax_comb(jspec).tables()
    tab = convert.weierstrass_comb_from_jax(spec.field, *jtab)
    assert torch.equal(tab, get_weierstrass_comb(spec).tables("cpu"))
    want = jax.jit(jspec.mul_base)(sb.numpy(), jtab)
    got = spec.mul_base(sb, tab)
    assert _affine(spec, got) == _jax_affine(spec, want)
    assert _affine(spec, got)[1:] == [o.mul_base(k) for k in ks[1:]]
    assert spec.is_identity(got).tolist() == [True] + [False] * (len(ks) - 1)
