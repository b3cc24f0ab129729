"""The port's window-stacked Pippenger MSM (parallel/msm.py) against Python
ints, with c=4 and two terms of different scalar lengths (the RLC
verifier's shape: 32-byte z*k beside 16-byte z), and its digit helpers
against the JAX package's. The comparison with the JAX package's
msm_multi_prefix is in test_torch_parity_msm.py."""

import random

import numpy as np
import pytest
import torch

from eccoxide_tpu.oracle.curve import ECurve
from eccoxide_tpu.parallel import msm as jmsm
from eccoxide_tpu_torch.curves import curve25519 as tc
from eccoxide_tpu_torch.curves.edwards import ExtPoint
from eccoxide_tpu_torch.field import WIDTHS
from eccoxide_tpu_torch.limbs import ints_to_limbs, limbs_to_ints
from eccoxide_tpu_torch.parallel import msm as tmsm

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

P = tc.P
CURVE = ECurve(p=P, a=P - 1, d=tc.D, gx=tc.ED_GX, gy=tc.ED_GY, order=tc.L)


def _case(B: int, seed: int, nbytes=(32, 16)):
    """Points [k_i]G in random projective coordinates, two scalar columns
    of nbytes[0] and nbytes[1] bytes (a few zero scalars and repeated
    digits), the expected affine sum."""
    rng = random.Random(seed)
    ks = [rng.randrange(1, 1000) for _ in range(B)]
    pts = [CURVE.mul(k, (tc.ED_GX, tc.ED_GY)) for k in ks]
    n1, n2 = nbytes
    s1 = [rng.randrange(2**(8 * n1)) for _ in range(B)]
    s2 = [rng.randrange(2**(8 * n2)) for _ in range(B)]
    s1[0] = 0
    s2[-1] = s2[0]
    coords = []
    for x, y in pts:
        lam = rng.randrange(1, P)
        coords.append([x * lam % P, y * lam % P, lam, x * y % P * lam % P])
    exp = (0, 1)
    for p, a, b in zip(pts, s1, s2):
        exp = CURVE.add(exp, CURVE.mul(a + b, p))
    by1 = np.array([list(v.to_bytes(n1, "little")) for v in s1], np.int32).T
    by2 = np.array([list(v.to_bytes(n2, "little")) for v in s2], np.int32).T
    return coords, by1, by2, exp


def _affine_ints(X, Y, Z):
    zi = pow(Z, -1, P)
    return (X * zi % P, Y * zi % P)


@pytest.mark.parametrize("B", [8, 5, 1])
def test_msm_multi_prefix_against_ints(B):
    coords, by1, by2, exp = _case(B, seed=B)
    cols = [ints_to_limbs([c[i] for c in coords], WIDTHS) for i in range(4)]
    pts = ExtPoint(torch.from_numpy(np.stack(cols)))
    out = tmsm.msm_multi_prefix(
        tc.EDWARDS, [(pts, torch.from_numpy(by1)), (pts, torch.from_numpy(by2))],
        c=4)
    assert out.xyzt.shape == (4, 10, 1)
    X, Y, Z, T = (limbs_to_ints(c, WIDTHS)[0] for c in out.xyzt.unbind(0))
    assert T * Z % P == X * Y % P
    assert _affine_ints(X, Y, Z) == exp


def test_window_digits_and_rev_bits():
    rng = np.random.default_rng(3)
    by = rng.integers(0, 256, size=(17, 6), dtype=np.int32)
    for c, nw in [(4, 34), (5, 28), (8, 17), (12, 12)]:
        got = tmsm._window_digits(torch.from_numpy(by), c, nw).numpy()
        want = np.stack([np.asarray(d) for d in jmsm._window_digits(by, c, nw)])
        assert np.array_equal(got, want)
    x = np.arange(64)
    assert np.array_equal(tmsm._rev_bits(x, 6), np.asarray(jmsm._rev_bits(x, 6)))
    assert tmsm._rev_bits(torch.arange(8), 3).tolist() == [0, 4, 2, 6, 1, 5, 3, 7]
