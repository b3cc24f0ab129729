"""The port's msm_local_prefix and msm_local_window_sums_prefix
(parallel/msm.py) against the port's integer oracle and msm_local, exact in
affine coordinates: p192k1 at B = 11 with c = 5 on the inputs of the JAX
package's tests/test_msm.py (test_msm_prefix_and_multi: _setup with seed
8), and edwards25519 at c = 12, JAX's default window (22 windows of 4095
partial sums, a Horner fold of runs of 12 doublings), on the inputs of
test_torch_msm_local.py (a repeated point, zero scalars). The comparison with
the JAX msm_local_prefix graph is in test_torch_parity_prefix.py. (Two
tests: see test_torch_sign.py for why the port's files stay small.)"""

import random

from eccoxide_tpu_torch import oracle
from eccoxide_tpu_torch.curves import sec2
from eccoxide_tpu_torch.parallel.msm import (_window_digits, msm_local, msm_local_prefix,
                                             msm_local_window_sums, msm_local_window_sums_prefix)
from test_torch_msm_local import _affine, _case, _cols, _sum


def _jax_setup_p192k1(B, seed):
    """The JAX tests' _setup("p192k1", B, seed): scalars first, then the
    points [b_i]G, from one random.Random(seed)."""
    grp, o = sec2.get_curve("p192k1"), oracle.sec2_curve("p192k1")
    rng = random.Random(seed)
    ks = [rng.randrange(0, o.order) for _ in range(B)]
    aff = [o.mul_base(rng.randrange(1, o.order)) for _ in range(B)]
    f = grp.field
    pts = grp.from_affine(f.encode_ints([a[0] for a in aff], "cpu"),
                          f.encode_ints([a[1] for a in aff], "cpu"))
    return grp, o, pts, aff, ks, grp.scalar.n_bytes


def test_msm_local_prefix_against_the_oracle_and_msm_local():
    """p192k1, B = 11, c = 5 (JAX test_msm.py:99-105) and edwards25519, B =
    11, at JAX's default c = 12: the sum equals the oracle's and
    msm_local's (c = 8) as a group element."""
    for grp, o, pts, aff, ks, nb, c in (
            (*_jax_setup_p192k1(11, seed=8), 5),
            (*_case("edwards25519", 11, seed=12), None)):
        sc = _cols(ks, nb)
        out = msm_local_prefix(grp, pts, sc) if c is None else msm_local_prefix(grp, pts, sc, c=c)
        assert type(out) is type(pts) and out.coords.shape[-1] == 1
        want = _sum(o, aff, ks)
        assert _affine(grp, out) == want, c
        assert bool(grp.eq(out, msm_local(grp, pts, sc, c=8)).all()), c


def test_window_sums_prefix_equal_window_sums():
    """Window for window, the prefix form's sums sum_j j B_j are the group
    elements of msm_local_window_sums (c = 5 on p192k1, c = 12 on
    edwards25519), and the oracle's for the top and bottom windows."""
    for grp, o, pts, aff, ks, nb, c in (
            (*_jax_setup_p192k1(11, seed=8), 5),
            (*_case("edwards25519", 11, seed=12), 12)):
        nw = -(-nb * 8 // c)
        digits = _window_digits(_cols(ks, nb), c, nw)
        ws_p = msm_local_window_sums_prefix(grp, pts, digits, c)
        ws = msm_local_window_sums(grp, pts, digits, c)
        assert ws_p.coords.shape[-1] == ws.coords.shape[-1] == nw
        assert bool(grp.eq(ws_p, ws).all()), c
        for w in (0, nw - 1):
            got = _affine(grp, type(ws_p)(ws_p.coords[..., w:w + 1]))
            assert got == _sum(o, aff, [int(d) for d in digits[w]]), (c, w)
