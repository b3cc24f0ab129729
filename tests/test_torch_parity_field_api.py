"""The port's new ``Field`` API methods against the JAX package's ``Field``
on the same numpy-seeded values, exact on decoded ints and bytes: FQ
against the JAX f25519 (solinas), FL against l25519 (Montgomery), and,
under ``-m slow`` as the JAX suite runs it, FQ448 against f448. One JAX
graph per field: the square root (of squares) and Euler's test (of
random values, which the port's square root flags alike), the binary-GCD
inverse, the Fermat inverse, doubling,
bytes both ways, and the wide reductions. With l25519, convert.py carries
values of three SEC2 curves' scalar fields to and from the JAX package's
Montgomery scalar fields (``curves/sec2.py:56``), host side."""

import jax
import numpy as np
import pytest
import torch

from eccoxide_tpu.curves import sec2 as jsec2
from eccoxide_tpu.field import Field
from eccoxide_tpu_torch import convert
from eccoxide_tpu_torch.curves import sec2
from eccoxide_tpu_torch.field import FL, FQ, L, P
from eccoxide_tpu_torch.field448 import FQ448
from eccoxide_tpu_torch.field448 import P as P448

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

CASES = [pytest.param(("f25519", P, "solinas", FQ), id="f25519"),
         pytest.param(("l25519", L, "mont", FL), id="l25519"),
         pytest.param(("f448", P448, "solinas", FQ448), id="f448", marks=pytest.mark.slow)]


def _ops(f):
    def ops(x, sq, by_be, wide):
        r, ok = f.sqrt(sq)
        fb, valid = f.from_bytes_be(by_be)
        return (r, ok, f.is_square(x), f.inverse_bingcd(x), f.inverse(x), f.double(x),
                f.to_bytes_be(x), fb, valid, f.from_wide_bytes_le(wide),
                f.from_wide_bytes_be(wide), f.reduce_wide_bytes_le(wide))
    return ops


@pytest.mark.parametrize("case", CASES)
def test_field_api_matches_jax(case):
    name, p, kind, f = case
    jf = Field(name, p, kind)
    rng = np.random.default_rng(len(name))
    nb = f.n_bytes
    xs = [int.from_bytes(rng.bytes(nb + 8), "little") % p for _ in range(9)] + [0, 1, p - 1]
    sqs = [v * v % p for v in xs]
    byvals = xs[:6] + [p, (1 << (8 * nb)) - 1]
    by_be = np.array([list(v.to_bytes(nb, "big")) for v in byvals], np.int32).T.copy()
    wide = rng.integers(0, 256, (2 * nb, 5), dtype=np.int32)
    want = jax.jit(_ops(jf))(jf.encode_ints(xs), jf.encode_ints(sqs), by_be, wide)
    jr, jok, jis, jbin, jinv, jdbl, jbe, jfb, jvalid, jwl, jwb, jred = want
    x, sq = f.encode_ints(xs, "cpu"), f.encode_ints(sqs, "cpu")
    r, ok = f.sqrt(sq)
    assert ok.tolist() == np.asarray(jok).tolist() == [True] * len(xs)
    # both roots square to the input; the same root where both pick one
    assert [v * v % p for v in f.decode_ints(r)] == [v * v % p for v in jf.decode_ints(jr)] == sqs
    assert f.sqrt(x)[1].tolist() == f.is_square(x).tolist() == np.asarray(jis).tolist()
    assert f.decode_ints(f.inverse_bingcd(x)) == jf.decode_ints(jbin) == jf.decode_ints(jinv) == f.decode_ints(f.inverse(x))
    assert f.decode_ints(f.double(x)) == jf.decode_ints(jdbl)
    assert np.array_equal(f.to_bytes_be(x).numpy(), np.asarray(jbe))
    fb, valid = f.from_bytes_be(torch.from_numpy(by_be))
    assert valid.tolist() == np.asarray(jvalid).tolist() == [True] * 6 + [False] * 2
    assert f.decode_ints(fb)[:6] == jf.decode_ints(jfb)[:6] == byvals[:6]
    tw = torch.from_numpy(wide)
    assert f.decode_ints(f.from_wide_bytes_le(tw)) == jf.decode_ints(jwl)
    assert f.decode_ints(f.from_wide_bytes_be(tw)) == jf.decode_ints(jwb)
    assert np.array_equal(f.reduce_wide_bytes_le(tw).numpy(), np.asarray(jred))
    if name == "l25519":
        for curve in ("p256r1", "p112r1", "p521r1"):
            n, jn = sec2.get_curve(curve).scalar, jsec2.get_curve(curve).scalar
            vals = xs[:6] + [n.p - 1]
            vals = [v % n.p for v in vals]
            assert convert.jax_sec2_format(n) == (jn.n, jn.b, jn.R)
            mine = n.encode_ints(vals, "cpu")
            assert np.array_equal(convert.to_jax_limbs(n, mine), np.asarray(jn.encode_ints(vals)))
            assert torch.equal(convert.from_jax_limbs(n, np.asarray(jn.encode_ints(vals))), mine)
