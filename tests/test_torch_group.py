"""The port's edwards25519 group (curves/edwards.py) and the plain versions
of its kernels (ops/group.py) against the JAX package's EDWARDS and against
Python ints. Exact comparison on canonical coordinates."""

import random

import jax
import numpy as np
import pytest
import torch

from eccoxide_tpu.curves import curve25519 as jc
from eccoxide_tpu.curves.edwards import ExtPoint as JExt
from eccoxide_tpu.oracle.curve import ECurve
from eccoxide_tpu.params import comb as jcomb
from eccoxide_tpu_torch import convert, oracle
from eccoxide_tpu_torch.curves import curve25519 as tc
from eccoxide_tpu_torch.curves.edwards import ExtPoint
from eccoxide_tpu_torch.field import FQ, SQRT_M1, WIDTHS
from eccoxide_tpu_torch.limbs import ints_to_limbs, limbs_to_ints
from eccoxide_tpu_torch.ops import group
from eccoxide_tpu_torch.params import comb as tcomb

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

P = tc.P
JED, TED = jc.EDWARDS, tc.EDWARDS
CURVE = ECurve(p=P, a=P - 1, d=tc.D, gx=tc.ED_GX, gy=tc.ED_GY, order=tc.L)
_jits: dict = {}


def J(name, fn):
    if name not in _jits:
        _jits[name] = jax.jit(fn)
    return _jits[name]


def _multiples(n: int) -> list:
    """[k]G for k = 0..n-1 as affine ints."""
    out, acc = [(0, 1)], (0, 1)
    for _ in range(1, n):
        acc = CURVE.add(acc, (tc.ED_GX, tc.ED_GY))
        out.append(acc)
    return out


MULT = _multiples(256)


def _proj(pts, seed):
    """Affine int points -> extended coordinates scaled by random lambdas,
    as (X, Y, Z, T) int lists."""
    rng = random.Random(seed)
    out = []
    for x, y in pts:
        lam = rng.randrange(1, P)
        out.append((x * lam % P, y * lam % P, lam, x * y % P * lam % P))
    return out


def _port_pt(coords) -> ExtPoint:
    cols = [ints_to_limbs([c[i] for c in coords], WIDTHS) for i in range(4)]
    return ExtPoint(torch.from_numpy(np.stack(cols)))


def _jax_ext(coords):
    return JExt(*(jc.FQ.encode_ints([c[i] for c in coords]) for i in range(4)))


def _canon_port(pt: ExtPoint) -> list:
    return [convert.to_jax_limbs(FQ, c) for c in pt.xyzt.unbind(0)]


def _canon_jax(pt) -> list:
    return [np.asarray(J("canon", jc.FQ.canon)(c)) for c in pt]


def _affine(pt: ExtPoint) -> list:
    X, Y, Z, T = (limbs_to_ints(c, WIDTHS) for c in pt.xyzt.unbind(0))
    out = []
    for x, y, z, t in zip(X, Y, Z, T):
        zi = pow(z, -1, P)
        assert t * z % P == x * y % P
        out.append((x * zi % P, y * zi % P))
    return out


def _operands(seed):
    """8 lanes: identity, P+P, P+(-P), then random multiples."""
    rng = random.Random(seed)
    ps = [MULT[rng.randrange(256)] for _ in range(8)]
    qs = [MULT[rng.randrange(256)] for _ in range(8)]
    ps[0] = (0, 1)
    qs[1] = ps[1]
    qs[2] = ((-ps[2][0]) % P, ps[2][1])
    return ps, qs


def test_add_double_add_mixed_match_jax():
    ps, qs = _operands(1)
    pc, qc = _proj(ps, 2), _proj(qs, 3)
    tp, tq = _port_pt(pc), _port_pt(qc)
    jp, jq = _jax_ext(pc), _jax_ext(qc)
    for name, tout, jout in [
        ("add", TED.add(tp, tq), J("add", JED.add)(jp, jq)),
        ("double", TED.double(tp), J("double", JED.double)(jp)),
    ]:
        for a, b in zip(_canon_port(tout), _canon_jax(jout)):
            assert np.array_equal(a, b), name
    aff = [(x, y, 1, x * y % P) for x, y in qs]
    ta = _port_pt(aff)
    ja = _jax_ext(aff)
    tout = TED.add_mixed(tp, ta.xyzt[[0, 1, 3]])
    jout = J("add_mixed", JED.add_mixed)(jp, ja.x, ja.y, ja.t)
    for a, b in zip(_canon_port(tout), _canon_jax(jout)):
        assert np.array_equal(a, b)
    assert _affine(tout) == [CURVE.add(p, q) for p, q in zip(ps, qs)]
    assert _affine(tout)[0] == qs[0] and _affine(tout)[2] == (0, 1)


def _encodings():
    rng = random.Random(4)
    encs = []
    for k in (1, 2, 77, 200):
        x, y = MULT[k]
        encs.append((y | (x & 1) << 255).to_bytes(32, "little"))
    encs += [
        (P + 3).to_bytes(32, "little"),                 # non-canonical y
        P.to_bytes(32, "little"),                       # y = p
        (1 | 1 << 255).to_bytes(32, "little"),          # x = 0, sign 1
        (1).to_bytes(32, "little"),                     # identity
        ((P - 1) | 1 << 255).to_bytes(32, "little"),    # y = -1, x = 0, sign 1
        (P - 1).to_bytes(32, "little"),                 # y = -1, x = 0
    ]
    encs += [bytes(rng.randrange(256) for _ in range(32)) for _ in range(6)]
    return encs


def test_decompress_matches_jax_with_rejections():
    encs = _encodings()
    by = np.array([list(e) for e in encs], np.int32).T
    tpt, tok = TED.decompress(torch.from_numpy(by))
    jpt, jok = J("decompress", JED.decompress)(by)
    assert tok.tolist() == np.asarray(jok).tolist()
    assert tok.tolist()[:10] == [True] * 4 + [False, False, False, True, False, True]
    # the port's oracle decides as the device packages do, negative zero
    # (x = 0 with the sign bit) included
    assert [oracle._decompress(e) is not None for e in encs] == tok.tolist()
    okm = np.asarray(jok)
    for a, b in zip(_canon_port(tpt), _canon_jax(jpt)):
        assert np.array_equal(a[:, okm], b[:, okm])


@pytest.mark.parametrize("W", [0, 1, 511, 512, 513, 768])
def test_plain_versions_against_ints(W):
    """ed_add in its three modes (full, need_t=False: the same X, Y, Z and
    T = 0, mixed with an affine q = x|y|t) and ed_double on Python ints."""
    rng = random.Random(W)
    ps = [MULT[rng.randrange(256)] for _ in range(W)]
    qs = [MULT[rng.randrange(256)] for _ in range(W)]
    if W >= 3:
        ps[0] = (0, 1)
        qs[1] = ps[1]
        qs[2] = ((-ps[2][0]) % P, ps[2][1])
    tp, tq = _port_pt(_proj(ps, 1)), _port_pt(_proj(qs, 2))
    s = group.ed_add(tp.xyzt, tq.xyzt)
    s_no_t = group.ed_add(tp.xyzt, tq.xyzt, need_t=False)
    q_xyt = _port_pt([(x, y, 1, x * y % P) for x, y in qs]).xyzt[[0, 1, 3]]
    m = group.ed_add_mixed(tp.xyzt, q_xyt)
    d = group.ed_double(tp.xyzt)
    assert s.shape == s_no_t.shape == m.shape == d.shape == (4, 10, W)
    sums = [CURVE.add(p, q) for p, q in zip(ps, qs)]
    assert _affine(ExtPoint(s)) == sums
    assert torch.equal(s_no_t[:3], s[:3]) and not s_no_t[3].any()
    assert _affine(ExtPoint(m)) == sums
    assert _affine(ExtPoint(d)) == [CURVE.add(p, p) for p in ps]


def test_tables_equal_jax():
    for ours, theirs in [(tcomb.edwards_byte_table(), jcomb.edwards_byte_table()),
                         (tcomb.comb_tables(), jcomb.get_comb("edwards25519").tables())]:
        for a, b in zip(ours, convert.tables_from_jax(*theirs)):
            assert np.array_equal(a, b)


def test_window_table_neg_select_and_need_t_guard():
    pts = [MULT[5], MULT[99], (0, 1)]
    p = _port_pt(_proj(pts, 7))
    tab = TED.window_table(p)
    assert tab.shape == (16, 4, 10, 3)
    for j in range(16):
        assert _affine(ExtPoint(tab[j])) == [CURVE.mul(j, q) for q in pts]
    n = TED.neg(p)
    assert TED.eq(TED.add(p, n), TED.identity((3,), "cpu")).all()
    sel = TED.select(torch.tensor([True, False, True]), p, n)
    assert _affine(sel) == [pts[0], ((-pts[1][0]) % P, pts[1][1]), pts[2]]
    half = TED.double(p, need_t=False)
    assert not half.has_t
    with pytest.raises(ValueError):
        TED.add(half, p)
    assert _affine(ExtPoint(TED.double(half).xyzt)) == [CURVE.mul(4, q) for q in pts]


@pytest.mark.parametrize("need_t", [True, False])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_double_runs_match_jax_and_ints(k, need_t):
    """ed_double(p, need_t, k) is k applications of the JAX package's
    EDWARDS.double, and [2^k]P on Python ints; T (zeros without need_t)
    and has_t follow need_t. Lanes: the identity, points of order 2 and
    4, then random multiples."""
    rng = random.Random(100 + k)
    pts = [(0, 1), (0, P - 1), (SQRT_M1, 0)] + [MULT[rng.randrange(1, 256)] for _ in range(5)]
    pc = _proj(pts, k)
    got = TED.double(_port_pt(pc), need_t=need_t, k=k)
    assert got.has_t is need_t and got.xyzt.shape == (4, 10, 8)
    jout = _jax_ext(pc)
    for _ in range(k):
        jout = J("double", JED.double)(jout)
    want = _canon_jax(jout)
    ours = _canon_port(got)
    for a, b in zip(ours[:3], want[:3]):
        assert np.array_equal(a, b)
    if need_t:
        assert np.array_equal(ours[3], want[3])
        assert _affine(got) == [CURVE.mul(1 << k, q) for q in pts]
    else:
        assert not got.xyzt[3].any()
        assert _affine(ExtPoint(TED.double(got, k=1).xyzt)) == [CURVE.mul(2 << k, q) for q in pts]
    one_by_one = _port_pt(pc)
    for _ in range(k):
        one_by_one = TED.double(one_by_one)
    assert torch.equal(got.xyzt[:3], one_by_one.xyzt[:3])


def test_double_run_rejects_bad_k():
    p = _port_pt(_proj([MULT[3]], 1)).xyzt
    for k in (0, -1, 1 << 16, 2.0):
        with pytest.raises(ValueError):
            group.ed_double(p, k=k)
