"""The port's msm_local and msm_multi_prefix (parallel/msm.py), generic over
the group, against the port's integer oracle, exact in affine
coordinates: msm_local on edwards25519, p256r1 and p192k1 (the curves of
the JAX package's tests/test_msm.py) at B = 17 with c = 4 and c = 8, zero
scalars and a repeated point among them, a batch of one point, and
msm_multi_prefix on p256r1 with two terms of different scalar lengths. The
comparison with the JAX package's msm_local is in
test_torch_parity_msm_local.py (marked slow). (Three tests: see
test_torch_sign.py for why.)"""

import random

import torch

from eccoxide_tpu_torch import oracle
from eccoxide_tpu_torch.curves import curve25519 as tc
from eccoxide_tpu_torch.curves import sec2
from eccoxide_tpu_torch.curves.edwards import ExtPoint
from eccoxide_tpu_torch.parallel.msm import msm_local, msm_local_window_sums, msm_multi_prefix, _window_digits
from eccoxide_tpu_torch.params._intcurve import ECurve

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

ED_ORACLE = ECurve(p=tc.P, a=tc.P - 1, d=tc.D, gx=tc.ED_GX, gy=tc.ED_GY, order=tc.L)


def _cols(ks, nb):
    return torch.tensor([list(k.to_bytes(nb, "little")) for k in ks], dtype=torch.int32).T.contiguous()


def _case(curve, B, seed, nb=None):
    """(group, oracle, points P_i = [a_i]G (a repeated point in lanes 2 and
    3), their affine ints, scalars with zeros in lanes 0 and 5, the scalar
    byte width)."""
    rng = random.Random(seed)
    if curve == "edwards25519":
        grp, o, order = tc.EDWARDS, ED_ORACLE, tc.L
        aff = [o.mul(rng.randrange(1, order), (tc.ED_GX, tc.ED_GY)) for _ in range(B)]
        f = grp.field
        xs, ys = f.encode_ints([a[0] for a in aff], "cpu"), f.encode_ints([a[1] for a in aff], "cpu")
        pts = ExtPoint(torch.stack([xs, ys, f.one((B,), "cpu"), f.mul(xs, ys)]))
        nb = nb or 32
    else:
        grp, o = sec2.get_curve(curve), oracle.sec2_curve(curve)
        order = o.order
        aff = [o.mul_base(rng.randrange(1, order)) for _ in range(B)]
        f = grp.field
        pts = grp.from_affine(f.encode_ints([a[0] for a in aff], "cpu"),
                              f.encode_ints([a[1] for a in aff], "cpu"))
        nb = nb or grp.scalar.n_bytes
    if B > 3:
        aff[3] = aff[2]
        pts.coords[..., 3] = pts.coords[..., 2]
    ks = [rng.randrange(1 << (8 * nb)) for _ in range(B)]
    for j in (0, 5):
        if j < B:
            ks[j] = 0
    return grp, o, pts, aff, ks, nb


def _sum(o, aff, ks, start=None):
    acc = o.mul(0, aff[0]) if start is None else start     # the identity
    for k, a in zip(ks, aff):
        acc = o.add(acc, o.mul(k, a))
    return acc


def _affine(grp, P):
    ax, ay = grp.to_affine(P)
    f = grp.field
    return f.decode_ints(ax)[0], f.decode_ints(ay)[0]


def test_msm_local_against_the_oracle():
    for curve in ("edwards25519", "p256r1", "p192k1"):
        grp, o, pts, aff, ks, nb = _case(curve, 17, seed=len(curve))
        want = _sum(o, aff, ks)
        for c in (4, 8):
            out = msm_local(grp, pts, _cols(ks, nb), c=c)
            assert type(out) is type(pts) and out.coords.shape[-1] == 1
            assert _affine(grp, out) == want, (curve, c)
        # the window sums are the group elements sum_j j B_j of each window
        digits = _window_digits(_cols(ks, nb), 8, nb)
        ws = msm_local_window_sums(grp, pts, digits, 8)
        for w in (0, nb - 1):
            dw = [int(d) for d in digits[w]]
            got = _affine(grp, type(ws)(ws.coords[..., w:w + 1]))
            assert got == _sum(o, aff, dw), (curve, w)


def test_msm_local_zero_scalars_repeated_points_and_one_point():
    """Every scalar 0 (the identity, Z = 0 on P-256), all points equal with
    small scalars (JAX test_msm.py's duplicates case), and B = 1."""
    for curve in ("p256r1", "edwards25519"):
        grp, o, pts, aff, ks, nb = _case(curve, 6, seed=3)
        zero = msm_local(grp, pts, _cols([0] * 6, nb), c=4)
        assert bool(grp.eq(zero, grp.identity((1,), "cpu")).all()), curve
        same = type(pts)(pts.coords[..., :1].expand(pts.coords.shape).contiguous())
        small = [0, 1, 1, 2, 0, 5]
        out = msm_local(grp, same, _cols(small, nb), c=4)
        assert _affine(grp, out) == o.mul(sum(small), aff[0]), curve
        one = msm_local(grp, type(pts)(pts.coords[..., 1:2]), _cols(ks[1:2], nb), c=8)
        assert _affine(grp, one) == o.mul(ks[1], aff[1]), curve


def test_msm_multi_prefix_on_p256r1():
    """Two terms over the same points: 32-byte scalars beside 9-byte ones
    (zeros among both), c = 5 (a window that does not divide a byte)."""
    grp, o, pts, aff, ks, nb = _case("p256r1", 11, seed=8)
    rng = random.Random(21)
    ks2 = [rng.randrange(2**70) for _ in range(11)]
    ks2[0] = 0
    out = msm_multi_prefix(grp, [(pts, _cols(ks, nb)), (pts, _cols(ks2, 9))], c=5)
    assert _affine(grp, out) == _sum(o, aff, ks2, _sum(o, aff, ks))
