"""The port's SEC2 field engine (field_sec2.py) and the plain version of its
pow kernel against Python ints, for all 15 coordinate primes: ring ops on
random values, on 0, 1 and p - 1 and on the largest limbs the format
allows (``LARGEST``); x^e, the
inverse and the independent binary-GCD inverse; square roots of every
kind on squares and non-squares; bytes and the canonical mask. The
overflow assertions of each prime run when its field is built. (Three
tests, each over all 15 primes: see test_torch_sign.py for why.)"""

import random
import re

import pytest
import torch

from eccoxide_tpu_torch.curves import sec2
from eccoxide_tpu_torch.field_sec2 import MUL_SMALL_MAX, M, W, _Format
from eccoxide_tpu_torch.limbs import limbs_to_ints
from eccoxide_tpu_torch.ops import build, group


def _field(name):
    return sec2.get_curve(name).field


def _operands(f, seed, B=12):
    """(x, y): random values, 0, 1, p - 1, and the largest limbs the format
    allows in the last lane."""
    rng = random.Random(seed)
    p = f.p
    xs = [rng.randrange(p) for _ in range(B - 3)] + [0, 1, p - 1]
    ys = [rng.randrange(p) for _ in range(B)]
    top = torch.tensor(f.fmt.LARGEST, dtype=torch.int32)[:, None]
    return (torch.cat([f.encode_ints(xs, "cpu"), top], 1),
            torch.cat([f.encode_ints(ys, "cpu"), top], 1))


def _tight(f, t):
    """Limbs within TIGHT and values within V_TIGHT."""
    limbs = ((t >= 0) & (t <= torch.tensor(f.fmt.TIGHT, dtype=torch.int32)[:, None])).all()
    return bool(limbs) and max(limbs_to_ints(t, f.widths)) <= f.fmt.V_TIGHT


def _kernel_folds():
    """{instance name: fold matrix} as compiled into the pow_sec2 kernels,
    read back from the generated sources."""
    out = {}
    for n in build.POW_SEC2_LIMBS:
        src = build.pow_sec2_source(n)
        for name, body in re.findall(r"struct (\w+) \{(.*?)\};\nPOW_SEC2_ENTRY\(\1\)", src, re.S):
            assert f"static constexpr int N = {n};" in body
            rows = re.findall(r"\{([^{}]*)\}", body)
            out[name] = [[int(v.rstrip("u"), 16) for v in r.split(",")] for r in rows]
    return out


def _scan_mul(f, a, b):
    """fe_sec2.cuh's product on Python ints: columns in product-scanning
    order through the two-round carry window (Carry2), then the fold and
    its carry the same way over the n output limbs."""
    n, fold = f.n, f.fmt.FOLD

    def window(cols):
        out, c1, c2 = [], 0, 0
        for col in cols[:-1]:
            h1 = (col & M) + c1
            c1 = col >> W
            out.append((h1 & M) + c2)
            c2 = h1 >> W
        return out + [cols[-1] + c1 + c2]

    h = window([sum(a[i] * b[k - i] for i in range(n) if 0 <= k - i < n)
                for k in range(2 * n)])
    assert max(h) < 2**32
    return window([h[i] + sum(h[n + j] * fold[j][i] for j in range(n)) for i in range(n)])


def _nonsquares(p, k=3):
    return [v for v in range(2, 200) if pow(v, (p - 1) // 2, p) == p - 1][:k]


def test_ring_ops_and_canonical_form_against_ints():
    for curve in sec2.ALL:
        f = _field(curve)
        p = f.p
        x, y = _operands(f, len(curve))
        xi, yi = limbs_to_ints(x, f.widths), limbs_to_ints(y, f.widths)
        cases = {
            "add": (f.add(x, y), [a + b for a, b in zip(xi, yi)]),
            "sub": (f.sub(x, y), [a - b for a, b in zip(xi, yi)]),
            "neg": (f.neg(y), [-b for b in yi]),
            "double": (f.double(x), [2 * a for a in xi]),
            "mul": (f.mul(x, y), [a * b for a, b in zip(xi, yi)]),
            "square": (f.square(x), [a * a for a in xi]),
            "mul_small": (f.mul_small(x, MUL_SMALL_MAX), [MUL_SMALL_MAX * a for a in xi]),
        }
        for op, (got, want) in cases.items():
            assert _tight(f, got), (curve, op)
            canon = f.canon(got)
            assert limbs_to_ints(canon, f.widths) == [w % p for w in want], (curve, op)
        assert limbs_to_ints(f.canon(x), f.widths) == [v % p for v in xi], curve
        assert f.is_zero(f.sub(x, x)).all() and f.eq(f.add(x, y), f.add(y, x)).all(), curve
        assert f.sgn0(x).tolist() == [v % p & 1 for v in xi], curve
        mask = torch.arange(x.shape[1]) % 2 == 0
        assert f.decode_ints(f.select(mask, x, y)) == [
            (a if i % 2 == 0 else b) % p for i, (a, b) in enumerate(zip(xi, yi))], curve
        assert torch.equal(f.bcast(f.const(5, (1,), "cpu"), (2, 3)), f.const(5, (2, 3), "cpu"))
        with pytest.raises(ValueError):
            f.mul_small(x, MUL_SMALL_MAX + 1)


def test_pow_inverse_and_square_roots_against_ints():
    """The plain pow chain (no launch on the CPU) on the path's exponents,
    whose zero digits take no product, the Fermat inverse against the
    binary-GCD inverse, and sqrt / is_square of every kind: p = 3 mod 4,
    Atkin for p224k1, Tonelli-Shanks for p224r1. The pow kernel's compiled
    fold constants equal the format's, and its product schedule (a Python
    model of fe_sec2.cuh) equals Field.mul limb for limb."""
    group.reset_launches()
    kinds = set()
    folds = _kernel_folds()
    assert set(folds) == set(build.POW_SEC2_INSTANCES.values())
    for p, name in build.POW_SEC2_INSTANCES.items():     # primes, group orders and l
        assert folds[name] == _Format(p).FOLD, name
    for curve in sec2.ALL:
        f = _field(curve)
        p = f.p
        assert folds[build.POW_SEC2_INSTANCES[p]] == f.fmt.FOLD, curve
        x, y = _operands(f, 2 * len(curve), B=6)
        xl, yl = x.T.tolist(), y.T.tolist()
        assert f.mul(x, y).T.tolist() == [_scan_mul(f, a, b) for a, b in zip(xl, yl)], curve
        assert f.square(x).T.tolist() == [_scan_mul(f, a, a) for a in xl], curve
        xi = limbs_to_ints(x, f.widths)
        for e in (*f.path_exponents().values(), 0x1234):
            got = f.pow_const(x, e)
            assert torch.equal(got, group.pow_sec2_plain(f, x, e)) and _tight(f, got)
            assert f.decode_ints(got) == [pow(v, e, p) for v in xi], curve
        assert f.decode_ints(f.pow_const(x, 0)) == [1] * x.shape[1]
        inv = f.inverse(x)
        assert f.decode_ints(inv) == [pow(v, p - 2, p) for v in xi], curve
        assert torch.equal(f.inverse_bingcd(x), f.canon(inv)), curve
        sq = f.square(x)
        r, ok = f.sqrt(sq)
        assert ok.all() and f.eq(f.square(r), sq).all(), curve
        ns = f.encode_ints(_nonsquares(p), "cpu")
        assert not f.sqrt(ns)[1].any(), curve
        assert f.is_square(sq).all() and not f.is_square(ns).any(), curve
        v = x[:, 1:]
        u = f.mul(sq[:, 1:], v)
        r, ok = f.sqrt_ratio(u, v)
        # v = 0 (so u = 0) fails the fallback's is_zero(v) check; the fused
        # chain of p = 5 mod 8 accepts 0/0, as the JAX package's does
        assert ok.tolist() == [w % p != 0 or f.sqrt_kind == "p5mod8"
                               for w in limbs_to_ints(v, f.widths)], curve
        assert f.eq(f.mul(f.square(r), v), u)[ok].all(), curve
        kinds.add(f.sqrt_kind)
    assert kinds == {"p3mod4", "p5mod8", "tonelli"}
    assert group.launches()["pow_sec2_kernel"] == 0
    with pytest.raises(ValueError):
        group.pow_sec2_kernel(f, x[:3], 5)
    with pytest.raises(ValueError):
        group.pow_sec2_kernel(f, x, -1)


def test_bytes_round_trip_and_canonical_mask():
    for curve in sec2.ALL:
        f = _field(curve)
        p, nb = f.p, f.n_bytes
        vals = [0, 1, p - 1, p, p + 1, 2 ** (8 * nb) - 1, 12345]
        by = torch.tensor([list(v.to_bytes(nb, "big")) for v in vals], dtype=torch.int32).T
        x, valid = f.from_bytes_be(by.contiguous())
        assert valid.tolist() == [v < p for v in vals], curve
        assert limbs_to_ints(x, f.widths) == vals and _tight(f, x), curve
        le, valid_le = f.from_bytes_le(by.flip(0).contiguous())
        assert torch.equal(le, x) and torch.equal(valid_le, valid), curve
        assert [bytes(c) for c in f.to_bytes_be(x).T.tolist()] == [
            (v % p).to_bytes(nb, "big") for v in vals], curve
        assert [bytes(c) for c in f.to_bytes_le(x).T.tolist()] == [
            (v % p).to_bytes(nb, "little") for v in vals], curve
