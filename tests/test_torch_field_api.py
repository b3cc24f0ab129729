"""The JAX ``Field`` API on every field of the port, against Python ints:
the cases of the JAX package's tests/test_field.py (inverse with 0 -> 0,
square roots and non-residues, Euler's test, bytes both ways with the
>= p rejection, wide reduction both ways, the binary-GCD inverse against
Fermat) on FQ, FL, FQ448, l in the SEC2 format (FL's pow on the card) and
the 15 SEC2 group orders (the curves' scalar fields), the wide reduction
also on the 15 coordinate fields. Exact. The comparison with the JAX
package's Field is in test_torch_parity_field_api.py. (Three tests: see
test_torch_sign.py for why.)"""

import random

import pytest
import torch

from eccoxide_tpu_torch.curves import sec2
from eccoxide_tpu_torch.field import FL, FQ, L, R_FL
from eccoxide_tpu_torch.field448 import FQ448
from eccoxide_tpu_torch.field_sec2 import field_of
from eccoxide_tpu_torch.limbs import limbs_to_ints
from eccoxide_tpu_torch.ops import build, group

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

FIELDS = {"FQ": FQ, "FL": FL, "FQ448": FQ448, "l25519": field_of(L),
          **{f"{c}_n": sec2.get_curve(c).scalar for c in sec2.ALL}}
WIDE = {**FIELDS, **{c: sec2.get_curve(c).field for c in sec2.ALL}}


def _vals(p, B, seed):
    rng = random.Random(seed)
    return [0, 1, 2, p - 1, p - 2] + [rng.randrange(p) for _ in range(B - 5)]


def _cols(vals, width, order="little"):
    return torch.tensor([list(v.to_bytes(width, order)) for v in vals], dtype=torch.int32).T.contiguous()


def test_inverse_sqrt_is_square_and_bingcd_against_ints():
    group.reset_launches()
    for name, f in FIELDS.items():
        p = f.p
        xs = _vals(p, 8, len(name))
        x = f.encode_ints(xs, "cpu")
        inv = f.decode_ints(f.inverse(x))
        assert inv == [pow(v, p - 2, p) for v in xs] and inv[0] == 0, name
        assert f.decode_ints(f.inverse_bingcd(x)) == inv, name
        rng = random.Random(4)
        squares = [rng.randrange(p) ** 2 % p for _ in range(6)] + [0]
        r, ok = f.sqrt(f.encode_ints(squares, "cpu"))
        assert ok.all(), name
        assert [v * v % p for v in f.decode_ints(r)] == squares, name
        assert f.is_square(f.encode_ints(squares, "cpu")).all(), name
        nr = [v for v in range(2, 400) if pow(v, (p - 1) // 2, p) == p - 1][:4]
        assert not f.sqrt(f.encode_ints(nr, "cpu"))[1].any(), name
        assert not f.is_square(f.encode_ints(nr, "cpu")).any(), name
        assert f.decode_ints(f.double(x)) == [2 * v % p for v in xs], name
        assert f.decode_ints(f.pow_const(x, 0)) == [1] * len(xs), name
        assert f.decode_ints(f.pow_const(x, 0x1F)) == [pow(v, 0x1F, p) for v in xs], name
    assert sum(group.launches().values()) == 0


def test_bytes_and_wide_reduction_against_ints():
    """LE and BE round trips, the >= p rejection, and from_wide_bytes_le/be
    and reduce_wide_bytes_le at widths up to 2 n_bytes."""
    rng = random.Random(55)
    for name, f in FIELDS.items():
        p, nb = f.p, f.n_bytes
        xs = _vals(p, 10, 6)
        x = f.encode_ints(xs, "cpu")
        for order, to, frm in (("little", f.to_bytes_le, f.from_bytes_le),
                               ("big", f.to_bytes_be, f.from_bytes_be)):
            by = to(x)
            assert by.shape[0] == nb and [bytes(c) for c in by.T.tolist()] == [
                v.to_bytes(nb, order) for v in xs], (name, order)
            back, valid = frm(by)
            assert valid.all() and f.decode_ints(back) == xs, (name, order)
            top = (1 << (8 * nb)) - 1
            bad = [v for v in (p, p + 1, top) if v.bit_length() <= 8 * nb and v >= p]
            if name == "FQ":
                bad += [2**255 + 3]          # bit 255 set, the low bits < p
            _, valid = frm(_cols(bad, nb, order))
            assert not valid.any(), (name, order)
    for name, f in WIDE.items():
        p, nb = f.p, f.n_bytes
        for w in (2 * nb, nb + 1, 3):
            vals = [rng.randrange(1 << (8 * w)) for _ in range(5)] + [(1 << (8 * w)) - 1, 0]
            want = [v % p for v in vals]
            assert f.decode_ints(f.from_wide_bytes_le(_cols(vals, w))) == want, (name, w)
            assert f.decode_ints(f.from_wide_bytes_be(_cols(vals, w, "big"))) == want, (name, w)
            red = f.reduce_wide_bytes_le(_cols(vals, w))
            assert [int.from_bytes(bytes(c), "little") for c in red.T.tolist()] == want, (name, w)
        with pytest.raises(ValueError):
            f.from_wide_bytes_le(torch.zeros((2 * nb + 1, 1), dtype=torch.int32))


def test_encodings_fl_route_and_the_plain_chain_for_any_prime():
    """encode_ints/decode_ints (FL in its Montgomery domain), FL's pow
    route and mul_small, the pow kernel's 28 instances, and the plain chain
    on a CPU tensor for a prime with no instance (which a CUDA tensor
    refuses: here ``group._on_cuda`` is made to answer yes)."""
    xs = _vals(L, 8, 9)
    x = FL.encode_ints(xs, "cpu")
    assert limbs_to_ints(x, FL.widths) == [v * R_FL % L for v in xs]
    assert FL.decode_ints(x) == xs and FQ.decode_ints(FQ.encode_ints(xs, "cpu")) == xs
    for e in (1, 2, 15, 16, 0x10001, L - 2, (L - 1) // 2):
        assert FL.decode_ints(FL.pow_const(x, e)) == [pow(v, e, L) for v in xs], e
    assert FL.decode_ints(FL.mul_small(x, 12345)) == [12345 * v % L for v in xs]
    with pytest.raises(ValueError):
        FL.mul_small(x, L)
    with pytest.raises(ValueError):
        FL.pow_const(x, -1)
    assert len(build.POW_SEC2_INSTANCES) == 28
    assert build.POW_SEC2_INSTANCES[L] == "l25519"
    assert {build.POW_SEC2_INSTANCES[sec2.get_curve(c).scalar.p] for c in sec2.ALL} == {
        f"{c}_n" for c in sec2.ALL}
    m127 = field_of(2**127 - 1)
    assert m127.p not in build.POW_SEC2_INSTANCES
    y = m127.encode_ints(xs, "cpu")
    assert m127.decode_ints(m127.inverse(y)) == [pow(v, m127.p - 2, m127.p) for v in xs]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(group, "_on_cuda", lambda *ts: True)
        with pytest.raises(ValueError, match="no pow_sec2 kernel"):
            group.pow_sec2_kernel(m127, y, 5)
    assert group.launches()["pow_sec2_kernel"] == 0
