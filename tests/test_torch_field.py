"""The port's FQ and FL (eccoxide_tpu_torch/field.py) against the JAX
package's fields and against Python ints.

Inputs are made from a seed with numpy/random, carried into both packages
(the port's side through ``convert.from_jax_limbs``), and compared exactly
on canonical values: this is integer arithmetic, the tolerance is zero.
"""

import random

import jax
import numpy as np
import pytest
import torch

from eccoxide_tpu.curves import curve25519 as jc
from eccoxide_tpu_torch import convert
from eccoxide_tpu_torch import field as tf
from eccoxide_tpu_torch.limbs import ints_to_limbs, limbs_to_ints

P, L = tf.P, tf.L
FIELDS = {"FQ": (jc.FQ, tf.FQ, P), "FL": (jc.FL, tf.FL, L)}
_jits: dict = {}


def J(fld, name):
    key = (fld.name, name)
    if key not in _jits:
        _jits[key] = jax.jit(getattr(fld, name))
    return _jits[key]


def _values(p: int, seed: int, n: int = 13) -> list[int]:
    rng = random.Random(seed)
    return [0, 1, p - 1, p - 2, 2] + [rng.randrange(p) for _ in range(n)]


def _pair(jf, tfld, vals):
    """The same field elements in both packages."""
    ja = jf.encode_ints(vals)
    return ja, convert.from_jax_limbs(tfld, np.asarray(ja))


def _canon_jax(jf, x) -> np.ndarray:
    return np.asarray(J(jf, "canon")(x))


@pytest.mark.parametrize("fname", ["FQ", "FL"])
@pytest.mark.parametrize("op", ["add", "sub", "mul", "square", "neg"])
def test_ring_ops_match_jax(fname, op):
    jf, tfld, p = FIELDS[fname]
    xv, yv = _values(p, 1), _values(p, 2)[::-1]
    jx, tx = _pair(jf, tfld, xv)
    jy, ty = _pair(jf, tfld, yv)
    if op in ("square", "neg"):
        jout, tout = J(jf, op)(jx), getattr(tfld, op)(tx)
    else:
        jout, tout = J(jf, op)(jx, jy), getattr(tfld, op)(tx, ty)
    assert tout.dtype == torch.int32 and tout.shape == (tfld.n, len(xv))
    assert np.array_equal(convert.to_jax_limbs(tfld, tout), _canon_jax(jf, jout))
    want = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
            "mul": lambda a, b: a * b, "square": lambda a, b: a * a,
            "neg": lambda a, b: -a}[op]
    got = [jv for jv in jf.decode_ints(convert.to_jax_limbs(tfld, tout))]
    assert got == [want(a, b) % p for a, b in zip(xv, yv)]


@pytest.mark.parametrize("fname", ["FQ", "FL"])
def test_bytes_roundtrip_and_canonical_mask(fname):
    """from_bytes_le's mask for encodings >= p, to_bytes_le, and both wide
    reductions, against the JAX package on the same byte columns."""
    jf, tfld, p = FIELDS[fname]
    rng = np.random.default_rng(3)
    enc = _values(p, 4) + [p, p + 1, 2**255 - 1, 2**256 - 1, 2**255 + 5]
    by = np.array([list(v.to_bytes(32, "little")) for v in enc], np.int32).T
    jv, jok = J(jf, "from_bytes_le")(by)
    tv, tok = tfld.from_bytes_le(torch.from_numpy(by))
    assert tok.tolist() == np.asarray(jok).tolist()
    assert tok.tolist() == [v < p for v in enc]
    okl = np.asarray(jok)
    assert np.array_equal(convert.to_jax_limbs(tfld, tv)[:, okl], _canon_jax(jf, jv)[:, okl])
    assert np.array_equal(tfld.to_bytes_le(tv).numpy()[:, okl], by[:, okl])
    wide = rng.integers(0, 256, size=(64, 9), dtype=np.int32)
    wide[:, 0] = 255
    wide[:, 1] = 0
    assert np.array_equal(tfld.reduce_wide_bytes_le(torch.from_numpy(wide)).numpy(),
                          np.asarray(J(jf, "reduce_wide_bytes_le")(wide)))
    assert np.array_equal(
        convert.to_jax_limbs(tfld, tfld.from_wide_bytes_le(torch.from_numpy(wide))),
        _canon_jax(jf, J(jf, "from_wide_bytes_le")(wide)))


@pytest.mark.parametrize("fname", ["FQ", "FL"])
def test_empty_batch(fname):
    jf, tfld, _ = FIELDS[fname]
    x = torch.zeros((tfld.n, 0), dtype=torch.int32)
    for out in (tfld.mul(x, x), tfld.add(x, x), tfld.canon(x)):
        assert out.shape == (tfld.n, 0)
    assert tfld.to_bytes_le(x).shape == (32, 0)
    assert np.asarray(jf.mul(jf.zero((0,)), jf.zero((0,)))).shape == (jf.n, 0)


@pytest.mark.parametrize("e_name", ["(p-5)/8", "p-2"])
def test_pow_const_plain_matches_jax(e_name):
    e = {"(p-5)/8": (P - 5) // 8, "p-2": P - 2}[e_name]
    vals = _values(P, 5, n=5)
    jx, tx = _pair(jc.FQ, tf.FQ, vals)
    tout = tf.FQ.pow_const(tx, e)
    jout = jax.jit(lambda x: jc.FQ.pow_const(x, e))(jx)
    assert np.array_equal(convert.to_jax_limbs(tf.FQ, tout), _canon_jax(jc.FQ, jout))
    assert jc.FQ.decode_ints(convert.to_jax_limbs(tf.FQ, tout)) == [pow(v, e, P) for v in vals]


def test_sqrt_ratio_and_sgn0_match_jax():
    rng = random.Random(6)
    us = [0, 1, 4, P - 1] + [rng.randrange(P) for _ in range(4)]
    vs = [1, 1, 1, 1] + [rng.randrange(1, P) for _ in range(3)] + [0]
    ju, tu = _pair(jc.FQ, tf.FQ, us)
    jv, tv = _pair(jc.FQ, tf.FQ, vs)
    tr, tok = tf.FQ.sqrt_ratio(tu, tv)
    jr, jok = jax.jit(jc.FQ.sqrt_ratio)(ju, jv)
    assert tok.tolist() == np.asarray(jok).tolist()
    assert np.array_equal(convert.to_jax_limbs(tf.FQ, tr), _canon_jax(jc.FQ, jr))
    for u, v, r, ok in zip(us, vs, limbs_to_ints(tf.FQ.canon(tr), tf.WIDTHS), tok.tolist()):
        if ok:
            assert r * r * v % P == u % P
    assert tf.FQ.sgn0(tr).tolist() == np.asarray(jax.jit(jc.FQ.sgn0)(jr)).tolist()


def test_worst_case_limb_bounds():
    """The overflow argument: products of the largest TIGHT inputs, and of
    the largest uncarried (LAZY) sums, stay below 2^63 per column with
    operands below 2^32, sums below 2^31, and every operation returns
    limbs within TIGHT with the right value."""
    assert tf.MUL_COL < 2**63
    assert max(2 * t for t in tf.TIGHT) < 2**31
    assert all(pd >= t for pd, t in zip(tf.PAD, tf.TIGHT))
    cols, top = tf.term_columns(tf.mul_terms(), tf.LAZY, tf.LAZY)
    assert max(cols) < 2**63 and top < 2**32 and max(tf.LAZY) < 2**31
    worst = torch.tensor(tf.TIGHT, dtype=torch.int32).view(10, 1)
    zero = torch.zeros_like(worst)
    wv = limbs_to_ints(worst, tf.WIDTHS)[0]
    lazy = tf.FQ.sub_lazy(worst, zero)
    assert lazy[:, 0].tolist() == tf.LAZY
    cases = {
        "mul": (tf.FQ.mul(worst, worst), wv * wv),
        "mul_lazy": (tf.FQ.mul(lazy, tf.FQ.add_lazy(worst, worst)), 2 * wv * wv),
        "add": (tf.FQ.add(worst, worst), 2 * wv),
        "sub": (tf.FQ.sub(worst, worst), 0),
        "sub0": (tf.FQ.sub(zero, worst), -wv),
        "neg": (tf.FQ.neg(worst), -wv),
    }
    for name, (out, want) in cases.items():
        limbs = out[:, 0].tolist()
        assert all(0 <= a <= t for a, t in zip(limbs, tf.TIGHT)), name
        assert limbs_to_ints(out, tf.WIDTHS)[0] % P == want % P, name
    assert limbs_to_ints(tf.FQ.canon(worst), tf.WIDTHS)[0] == wv % P
    big = torch.tensor(ints_to_limbs([2**255 - 1, P, P - 1], tf.WIDTHS))
    assert limbs_to_ints(tf.FQ.canon(big), tf.WIDTHS) == [18, 0, P - 1]


@pytest.mark.parametrize("limbs", ["random", "max"])
@pytest.mark.parametrize("form", ["mul", "sq"])
def test_kernel_product_lists_give_the_plain_columns(form, limbs):
    """The products of fe25519.cuh as field.py models them (factors folded
    into 32-bit operands: 2 a_i for two odd limbs, 19 b_j on the wrap; the
    square as 55 products with the cross terms doubled) sum to the
    100-term columns of mul_col_bounds, with every operand below 2^32."""
    rng = random.Random(11)
    terms = tf.mul_terms() if form == "mul" else tf.sq_terms()
    assert len(terms) == (100 if form == "mul" else 55)
    assert len({(i, j) for _, i, _, j, _ in terms}) == len(terms)

    def limbs_of():
        return list(tf.TIGHT) if limbs == "max" else [rng.randint(0, t) for t in tf.TIGHT]

    for _ in range(1 if limbs == "max" else 50):
        xs = limbs_of()
        ys = xs if form == "sq" else limbs_of()
        cols, top = tf.term_columns(terms, xs, ys)
        assert cols == tf.mul_col_bounds(xs, ys)
        assert top < 2**32 and max(cols) < 2**63
