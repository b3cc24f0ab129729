"""The port's SEC2 field engine against the JAX package's ``Field`` on five
primes that cover its engines: p256r1 (dense fold), p256k1 (sparse
solinas), p521r1 (12-bit limbs), p112r1 (Montgomery domain, R = 2^120)
and p224r1 (Tonelli-Shanks). The same seeded inputs, carried across by
convert.py, go through one JAX graph per prime (mul, square, the inverse
and sqrt through the JAX pow_const chain, bytes both ways) and through the
port; canonical values must be equal.

For p224r1 the first test compares the two pow chains of Tonelli-Shanks
(x^q and x^((q+1)/2)); the second the rest of it, piece by piece (the
whole JAX Tonelli-Shanks graph takes minutes to compile on the CPU)."""

import jax
import numpy as np
import torch

from eccoxide_tpu.curves import sec2 as jsec2
from eccoxide_tpu_torch import convert
from eccoxide_tpu_torch.curves import sec2

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

PRIMES = ["p256r1", "p256k1", "p521r1", "p112r1", "p224r1"]


def _jax_ops(f):
    def ops(x, y, by):
        if f.sqrt_kind == "tonelli":
            r, ok = f.pow_const(x, f.ts_q), f.pow_const(x, (f.ts_q + 1) // 2)
        else:
            r, ok = f.sqrt(x)
        fb, valid = f.from_bytes_be(by)
        return (f.mul(x, y), f.square(x), f.inverse(x), r, ok, f.to_bytes_be(x), fb, valid)
    return ops


def _inputs(f, rng):
    """x (three squares first, then random values, 0, 1, p - 1) and y."""
    p = f.p
    xs = [int.from_bytes(rng.bytes(f.n_bytes), "big") % p for _ in range(6)] + [0, 1, p - 1]
    ys = [int.from_bytes(rng.bytes(f.n_bytes), "big") % p for _ in range(9)]
    xs[:3] = [v * v % p for v in xs[:3]]
    return xs, f.encode_ints(xs, "cpu"), f.encode_ints(ys, "cpu")


def test_field_ops_match_jax():
    rng = np.random.default_rng(256)
    for name in PRIMES:
        f, jf = sec2.get_curve(name).field, jsec2.get_curve(name).field
        assert convert.JAX_SEC2[name][:2] == (jf.n, jf.b)
        p = f.p
        xs, x, y = _inputs(f, rng)
        jx, jy = convert.to_jax_limbs(f, x), convert.to_jax_limbs(f, y)
        assert np.array_equal(jx, np.asarray(jf.encode_ints(xs)))
        byvals = [0, 1, p - 1, p, 2 ** (8 * f.n_bytes) - 1] + xs[3:7]
        by = torch.tensor([list(v.to_bytes(f.n_bytes, "big")) for v in byvals],
                          dtype=torch.int32).T.contiguous()
        want = jax.jit(_jax_ops(jf))(jx, jy, by.numpy())
        fb, valid = f.from_bytes_be(by)
        if f.sqrt_kind == "tonelli":
            r, ok = f.pow_const(x, f.ts_q), f.pow_const(x, (f.ts_q + 1) // 2)
            assert torch.equal(f.canon(ok), convert.from_jax_limbs(f, np.asarray(want[4])))
        else:
            r, ok = f.sqrt(x)
            assert ok.tolist() == np.asarray(want[4]).tolist(), name
            assert ok[:3].all() and ok[6:8].all(), name
        got = (f.mul(x, y), f.square(x), f.inverse(x), r)
        for op, g, w in zip(("mul", "square", "inverse", "sqrt"), got, want[:4]):
            assert torch.equal(f.canon(g), convert.from_jax_limbs(f, np.asarray(w))), (name, op)
        assert np.array_equal(f.to_bytes_be(x).numpy(), np.asarray(want[5])), name
        assert valid.tolist() == np.asarray(want[7]).tolist() == [v < p for v in byvals], name
        ok_lanes = valid.nonzero().flatten()
        assert torch.equal(f.canon(fb)[:, ok_lanes],
                           convert.from_jax_limbs(f, np.asarray(want[6]))[:, ok_lanes]), name


def _dlog_ints(p, c, s, v):
    """e with v = c^e (c of order 2^s mod p), bit by bit on Python ints; 0
    for v = 0."""
    e = 0
    for i in range(s if v else 0):
        if pow(v * pow(c, -e, p) % p, 1 << (s - 1 - i), p) != 1:
            e |= 1 << i
    return e


def test_tonelli_shanks_sqrt_matches_jax():
    """p224r1's whole Tonelli-Shanks (s = 96), piece by piece against the
    JAX package's code in one small graph (the whole JAX graph compiles for
    minutes on the CPU): the port's 96-bit dlog of x^q equals the dlog on
    Python ints; the JAX and the port's divide-and-conquer dlog agree on an
    8-bit subgroup (one split: its squarings, masked chain and two leaves);
    and the JAX
    masked multiply chain, applied to x^((q+1)/2) (held equal to JAX's in
    the test above) with those 96 bits, gives the port's root and its
    mask."""
    f, jf = sec2.get_curve("p224r1").field, jsec2.get_curve("p224r1").field
    p, q, s, k = f.p, f.ts_q, f.ts_s, 8
    assert (jf.ts_q, jf.ts_s, jf.ts_z) == (q, s, f.ts_z) and s == 96
    c = pow(f.ts_z, q, p)
    cnegs = [pow(c, -(1 << m), p) for m in range(s)]
    rng = np.random.default_rng(224)
    xs, x, _ = _inputs(f, rng)
    e_true = [_dlog_ints(p, c, s, pow(v, q, p)) for v in xs]
    bits_true = np.array([[(e >> j) & 1 for e in e_true] for j in range(s)], dtype=bool)
    g = pow(c, 1 << (s - k), p)
    es = [0, 1, (1 << k) - 1] + rng.integers(0, 1 << k, 6).tolist()
    v8 = f.encode_ints([pow(g, e, p) for e in es], "cpu")

    def jax_pieces(x, r, v, bits):
        dl = jf._dlog_pow2(v, k, s - k, c, cnegs)
        root = jf._masked_mul_chain(r, [cnegs[j - 1] for j in range(1, s)],
                                    [bits[j] for j in range(1, s)])
        return dl, root, jf.eq(jf.square(root), x)

    r_half = f.pow_const(x, (q + 1) // 2)
    dl_j, root_j, ok_j = jax.jit(jax_pieces)(convert.to_jax_limbs(f, x), convert.to_jax_limbs(f, r_half),
                                             convert.to_jax_limbs(f, v8), bits_true)
    bits = f._dlog_pow2(f.pow_const(x, q), s, 0, c, cnegs)
    assert torch.stack(bits).numpy().tolist() == bits_true.tolist()
    dl = torch.stack(f._dlog_pow2(v8, k, s - k, c, cnegs)).numpy()
    assert dl.tolist() == np.asarray(dl_j).tolist() == [[(e >> j) & 1 for e in es] for j in range(k)]
    r, ok = f.sqrt(x)
    assert torch.equal(f.canon(r), convert.from_jax_limbs(f, np.asarray(root_j)))
    assert ok.tolist() == np.asarray(ok_j).tolist() == [pow(v, (p - 1) // 2, p) in (0, 1) for v in xs]
