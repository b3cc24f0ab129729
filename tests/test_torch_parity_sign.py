"""The port's sign side against the JAX package's on the same inputs:
sign_host and public_keys_host byte for byte; compress, to_affine, CT
scalar_mul and the comb mul_base on canonical coordinates. The JAX graphs
take about a minute to compile on the CPU, so they sit in a file of few
tests (see test_torch_parity_verify.py)."""

import random

import jax
import numpy as np
import torch

from eccoxide_tpu.curves import curve25519 as jc
from eccoxide_tpu.curves.edwards import ExtPoint as JExt
from eccoxide_tpu.params.comb import get_comb
from eccoxide_tpu.protocol import ed25519 as jpe
from eccoxide_tpu_torch.curves import curve25519 as tc
from eccoxide_tpu_torch.curves.edwards import ExtPoint
from eccoxide_tpu_torch.field import WIDTHS
from eccoxide_tpu_torch.limbs import ints_to_limbs, limbs_to_ints
from eccoxide_tpu_torch.params._intcurve import ECurve
from eccoxide_tpu_torch.protocol import ed25519 as tpe
from test_ed25519 import RFC_VECTORS

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

P, L = tc.P, tc.L
CURVE = ECurve(p=P, a=P - 1, d=tc.D, gx=tc.ED_GX, gy=tc.ED_GY, order=L)


def test_sign_host_and_public_keys_identical_to_jax():
    rng = random.Random(95)
    sks = [RFC_VECTORS[0][0]] + [bytes(rng.randrange(256) for _ in range(32)) for _ in range(3)]
    msgs = [b"", b"x", bytes(range(111)), bytes(rng.randrange(256) for _ in range(200))]
    assert tpe.public_keys_host(sks, device="cpu") == jpe.public_keys_host(sks)
    assert tpe.sign_host(sks, msgs, device="cpu") == jpe.sign_host(sks, msgs)


def test_compress_scalar_mul_and_mul_base_match_jax():
    """Points [k]B in random projective coordinates (the identity among
    them); scalars 0, l - 1, 2^256 - 1 and random ones."""
    rng = random.Random(96)
    B = 5
    pts = [(0, 1)] + [CURVE.mul_base(rng.randrange(1, L)) for _ in range(B - 1)]
    coords = []
    for x, y in pts:
        lam = rng.randrange(1, P)
        coords.append([x * lam % P, y * lam % P, lam, x * y % P * lam % P])
    cols = [[c[i] for c in coords] for i in range(4)]
    tp = ExtPoint(torch.from_numpy(np.stack([ints_to_limbs(c, WIDTHS) for c in cols])))
    jp = JExt(*(jc.FQ.encode_ints(c) for c in cols))
    ks = [0, L - 1, 2**256 - 1] + [rng.randrange(2**256) for _ in range(B - 3)]
    by = np.array([list(k.to_bytes(32, "little")) for k in ks], np.int32).T.copy()
    ED, JED = tc.EDWARDS, jc.EDWARDS

    jcomp, (jx, jy) = jax.jit(lambda p: (JED.compress(p), JED.to_affine(p)))(jp)
    assert np.array_equal(ED.compress(tp).numpy(), np.asarray(jcomp))
    tx, ty = ED.to_affine(tp)
    assert limbs_to_ints(tc.FQ.canon(tx), WIDTHS) == jc.FQ.decode_ints(jx)
    assert limbs_to_ints(tc.FQ.canon(ty), WIDTHS) == jc.FQ.decode_ints(jy)

    def affine(X, Y, Z):
        return [(x * pow(z, -1, P) % P, y * pow(z, -1, P) % P) for x, y, z in zip(X, Y, Z)]

    tm = tpe.scalar_mul(tp, torch.from_numpy(by))
    jm = jax.jit(lambda p, s: JED.scalar_mul(p, jpe.windows_from_bytes_le(s, 64)))(jp, by)
    want = affine(*(jc.FQ.decode_ints(c) for c in (jm.x, jm.y, jm.z)))
    assert affine(*(limbs_to_ints(c, WIDTHS) for c in tm.xyzt.unbind(0)[:3])) == want

    comb = get_comb("edwards25519")
    tb = tpe.scalar_mul_base(torch.from_numpy(by), tpe.SignTables("cpu"))
    jb = jax.jit(comb.mul_base)(by, comb.tables())
    want = affine(*(jc.FQ.decode_ints(c) for c in (jb.x, jb.y, jb.z)))
    assert affine(*(limbs_to_ints(c, WIDTHS) for c in tb.xyzt.unbind(0)[:3])) == want
    assert want == [CURVE.mul_base(k % L) for k in ks]
