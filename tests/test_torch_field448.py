"""The port's FQ448 (field448.py) and the plain version of its pow kernel
against Python ints: ring ops on random, edge and largest-TIGHT limbs,
bytes and the canonical mask, x^e and the inverse. (Three tests: see
test_torch_sign.py for why.)"""

import random

import numpy as np
import pytest
import torch

from eccoxide_tpu_torch import field448 as f448
from eccoxide_tpu_torch.field448 import FQ448, P, TIGHT, WIDTHS
from eccoxide_tpu_torch.limbs import ints_to_limbs, limbs_to_ints
from eccoxide_tpu_torch.ops import group

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _operands(seed, B=24):
    """(x, y) limbs: random values, 0, 1, p - 1, p, 2^448 - 1 in strict
    limbs, random limbs within TIGHT, and the largest TIGHT limbs."""
    rng = random.Random(seed)
    xs = [rng.randrange(P) for _ in range(B - 8)] + [0, 1, P - 1, P, 2**448 - 1]
    ys = [rng.randrange(2**448) for _ in range(B)]
    x = torch.from_numpy(np.concatenate(
        [ints_to_limbs(xs, WIDTHS),
         np.array([[rng.randrange(t + 1) for _ in range(2)] for t in TIGHT], np.int32),
         np.array(TIGHT, np.int32)[:, None]], axis=1))
    y = torch.from_numpy(ints_to_limbs(ys, WIDTHS))
    y[:, -2:] = torch.tensor(TIGHT, dtype=torch.int32)[:, None]
    return x, y


def _ints(t):
    return limbs_to_ints(t, WIDTHS)


def _tight(t):
    return bool(((t >= 0) & (t <= torch.tensor(TIGHT, dtype=torch.int32)[:, None])).all())


def test_ring_ops_against_ints():
    x, y = _operands(1)
    xi, yi = _ints(x), _ints(y)
    cases = {
        "add": (FQ448.add(x, y), [a + b for a, b in zip(xi, yi)]),
        "sub": (FQ448.sub(x, y), [a - b for a, b in zip(xi, yi)]),
        "neg": (FQ448.neg(y), [-b for b in yi]),
        "mul": (FQ448.mul(x, y), [a * b for a, b in zip(xi, yi)]),
        "square": (FQ448.square(x), [a * a for a in xi]),
        "mul_small": (FQ448.mul_small(x, f448.A24), [a * f448.A24 for a in xi]),
    }
    for name, (got, want) in cases.items():
        assert _tight(got), name
        assert [v % P for v in _ints(got)] == [w % P for w in want], name
        canon = FQ448.canon(got)
        assert _ints(canon) == [w % P for w in want], name
        assert bool((canon >= 0).all() and (canon <= f448.M).all()), name
    assert FQ448.is_zero(FQ448.sub(x, x)).all()
    assert FQ448.eq(FQ448.add(x, y), FQ448.add(y, x)).all()
    with pytest.raises(ValueError):
        FQ448.mul_small(x, f448.A24 + 1)


def test_bytes_and_canonical_mask():
    vals = [0, 1, P - 1, P, P + 1, 2**448 - 2**224, 2**448 - 1, 12345]
    by = torch.from_numpy(np.array([list(v.to_bytes(56, "little")) for v in vals],
                                   np.int32).T.copy())
    x, valid = FQ448.from_bytes_le(by)
    assert valid.tolist() == [v < P for v in vals]
    assert _ints(x) == vals
    out = FQ448.to_bytes_le(x)
    assert [bytes(r) for r in out.T.tolist()] == [(v % P).to_bytes(56, "little") for v in vals]
    mask = torch.tensor([True, False] * 4)
    assert _ints(FQ448.select(mask, x, FQ448.zero((8,), "cpu"))) == [
        v if i % 2 == 0 else 0 for i, v in enumerate(vals)]


def test_pow448_plain_and_inverse():
    """x^(p-2), a short exponent and one with zero digits (no product on
    them) on the CPU (the plain version, no launch), TIGHT and equal to
    Python's pow; x x^(p-2) = 1 except for 0, whose inverse is 0. The
    kernel's columns by halves equal the fold's on these limbs."""
    x, y = _operands(2, B=10)
    for a, b in zip(x.T.tolist(), y.T.tolist()):
        assert f448.mul_cols_by_halves(a, b) == f448.mul_col_bounds(a, b)
        assert f448.mul_cols_by_halves(a, a) == f448.mul_col_bounds(a, a)
    group.reset_launches()
    for e in (P - 2, 0x1234, 0x1000F):
        got = FQ448.pow_const(x, e)
        assert torch.equal(got, group.pow448_plain(x, e)) and _tight(got)
        assert [v % P for v in _ints(got)] == [pow(v, e, P) for v in _ints(x)]
    assert group.launches()["pow448_kernel"] == 0
    inv = FQ448.inverse(x)
    assert [v % P for v in _ints(FQ448.mul(x, inv))] == [int(v % P != 0) for v in _ints(x)]
    assert _ints(FQ448.pow_const(x, 0)) == [1] * x.shape[1]
    with pytest.raises(ValueError):
        group.pow448_kernel(x[:10], e)
    with pytest.raises(ValueError):
        group.pow448_kernel(x, -1)
