"""The port's FQ448 against the JAX package's curve448.FQ (38 limbs of 12
bits there), carried across by convert.py: ring ops on random values and
on the port's largest TIGHT limbs, pow_const(p - 2) and the bytes. The JAX
graphs compile in seconds each; the root conftest.py's scheduler sends
this file out after the JAX package's slow units."""

import random

import jax
import numpy as np
import torch

from eccoxide_tpu.curves import curve448 as j448
from eccoxide_tpu_torch import convert
from eccoxide_tpu_torch.field448 import A24, FQ448, P, TIGHT, WIDTHS
from eccoxide_tpu_torch.limbs import ints_to_limbs, limbs_to_ints

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

JF = j448.FQ


def _operands():
    rng = random.Random(448)
    xs = [rng.randrange(P) for _ in range(5)] + [0, 1, P - 1]
    ys = [rng.randrange(P) for _ in range(8)]
    x = torch.from_numpy(ints_to_limbs(xs, WIDTHS))
    y = torch.from_numpy(ints_to_limbs(ys, WIDTHS))
    x[:, -1] = torch.tensor(TIGHT, dtype=torch.int32)      # largest TIGHT limbs
    y[:, -2] = torch.tensor(TIGHT, dtype=torch.int32)
    return x, y


def _same(port, jax_out):
    return torch.equal(FQ448.canon(port), convert.from_jax_limbs(FQ448, np.asarray(jax_out)))


def _jax_ring_ops(x, y):
    return (JF.add(x, y), JF.sub(x, y), JF.mul(x, y), JF.square(x), JF.neg(y),
            JF.mul_small(x, A24))


def _jax_inverse_and_bytes(x):
    return JF.inverse(x), JF.to_bytes_le(x)


def test_ring_ops_match_jax():
    """add, sub, mul, square, neg and mul_small by a24, one JAX graph."""
    x, y = _operands()
    jx, jy = (convert.to_jax_limbs(FQ448, t) for t in (x, y))
    assert limbs_to_ints(convert.from_jax_limbs(FQ448, jx), WIDTHS) == [
        v % P for v in limbs_to_ints(x, WIDTHS)]
    want = jax.jit(_jax_ring_ops)(jx, jy)
    got = (FQ448.add(x, y), FQ448.sub(x, y), FQ448.mul(x, y), FQ448.square(x),
           FQ448.neg(y), FQ448.mul_small(x, A24))
    for name, g, w in zip(("add", "sub", "mul", "square", "neg", "mul_small"), got, want):
        assert _same(g, w), name


def test_inverse_and_bytes_match_jax():
    x, _ = _operands()
    inv, by = jax.jit(_jax_inverse_and_bytes)(convert.to_jax_limbs(FQ448, x))
    assert _same(FQ448.pow_const(x, P - 2), inv)
    assert np.array_equal(FQ448.to_bytes_le(x).numpy(), np.asarray(by))
