"""The port's sign side on the CPU, without the JAX package's graphs:
public_keys_host and sign_host byte for byte against `cryptography` and
the RFC 8032 vectors; comb mul_base, CT scalar_mul, compress, to_affine and
on_curve against Python ints; the key types of protocol/api.py round
trip. (Three tests: pytest-xdist's --dist loadfile hands out the files
with the most tests first, and a file of at most three runs beside the
slow JAX test_msm.py instead of ahead of it.)"""

import random

import numpy as np
import torch
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey
from cryptography.hazmat.primitives.asymmetric.x448 import X448PrivateKey
from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey

from eccoxide_tpu_torch import oracle
from eccoxide_tpu_torch.curves import curve25519 as tc
from eccoxide_tpu_torch.curves.edwards import ExtPoint
from eccoxide_tpu_torch.field import WIDTHS
from eccoxide_tpu_torch.limbs import ints_to_limbs, limbs_to_ints
from eccoxide_tpu_torch.params._intcurve import ECurve
from eccoxide_tpu_torch.protocol import api
from eccoxide_tpu_torch.protocol import ed25519 as tpe
from test_ed25519 import RFC_VECTORS

P, L = tc.P, tc.L
CURVE = ECurve(p=P, a=P - 1, d=tc.D, gx=tc.ED_GX, gy=tc.ED_GY, order=L)
ED = tc.EDWARDS


def _raw(key) -> bytes:
    from cryptography.hazmat.primitives import serialization as ser

    return key.public_bytes(ser.Encoding.Raw, ser.PublicFormat.Raw)


def test_sign_host_equals_cryptography_and_rfc8032():
    """RFC 8032 tests 1-3, then 12 random keys with messages across the
    SHA-512 block edges; every signature byte-equal to `cryptography`, and
    the port's own verifier takes them and refuses a tampered one."""
    rng = random.Random(8032)
    sks = [v[0] for v in RFC_VECTORS]
    msgs = [v[2] for v in RFC_VECTORS]
    for n in (0, 1, 31, 32, 33, 63, 64, 111, 112, 127, 128, 240):
        sks.append(bytes(rng.randrange(256) for _ in range(32)))
        msgs.append(bytes(rng.randrange(256) for _ in range(n)))
    pks = tpe.public_keys_host(sks, device="cpu")
    sigs = tpe.sign_host(sks, msgs, device="cpu")
    assert pks[:3] == [v[1] for v in RFC_VECTORS]
    assert sigs[:3] == [v[3] for v in RFC_VECTORS]
    keys = [Ed25519PrivateKey.from_private_bytes(sk) for sk in sks]
    assert pks == [_raw(k.public_key()) for k in keys]
    assert sigs == [k.sign(m) for k, m in zip(keys, msgs)]
    assert sigs[5] == oracle.sign(sks[5], msgs[5])
    tampered = sigs[4][:40] + bytes([sigs[4][40] ^ 1]) + sigs[4][41:]
    assert tpe.verify_host(pks + pks[4:5], msgs + msgs[4:5], sigs + [tampered],
                           device="cpu") == [True] * len(sks) + [False]


def _scalar_cols(ks):
    return torch.from_numpy(np.array([list(k.to_bytes(32, "little")) for k in ks],
                                     np.int32).T.copy())


def _affine(pt):
    X, Y, Z, T = (limbs_to_ints(c, WIDTHS) for c in pt.xyzt.unbind(0))
    out = []
    for x, y, z, t in zip(X, Y, Z, T):
        zi = pow(z, -1, P)
        assert t * z % P == x * y % P
        out.append((x * zi % P, y * zi % P))
    return out


def test_comb_mul_base_scalar_mul_and_compress_against_ints():
    """[s]B by the comb and [s]P by the CT windows for scalars 0, 1, l-1,
    l, 2^256-1 and random ones (P = [7]B in random projective
    coordinates); compress, to_affine and on_curve of the results."""
    rng = random.Random(5)
    ks = [0, 1, L - 1, L, 2**256 - 1] + [rng.randrange(2**256) for _ in range(3)]
    tables = tpe.SignTables("cpu")
    by = _scalar_cols(ks)
    got = tpe.scalar_mul_base(by, tables)
    assert _affine(got) == [CURVE.mul_base(k % L) for k in ks]
    base = CURVE.mul_base(7)
    lam = rng.randrange(1, P)
    coords = [base[0] * lam % P, base[1] * lam % P, lam, base[0] * base[1] % P * lam % P]
    P7 = ExtPoint(torch.from_numpy(np.stack(
        [ints_to_limbs([c] * len(ks), WIDTHS) for c in coords])))
    mul = tpe.scalar_mul(P7, by)
    want = [CURVE.mul(k * 7 % L, (tc.ED_GX, tc.ED_GY)) for k in ks]
    assert _affine(mul) == want
    ax, ay = ED.to_affine(mul)
    assert list(zip(limbs_to_ints(tc.FQ.canon(ax), WIDTHS),
                    limbs_to_ints(tc.FQ.canon(ay), WIDTHS))) == want
    assert ED.on_curve(mul).all() and ED.on_curve(ED.generator((2,), "cpu")).all()
    bad = mul.xyzt.clone()
    bad[0, 0, 1] += 1
    assert not ED.on_curve(ExtPoint(bad))[1]
    comp = [bytes(c) for c in ED.compress(mul).T.tolist()]
    assert comp == [oracle._compress(w) for w in want]


def test_api_key_types_round_trip():
    """Each key type through its methods on the CPU, against `cryptography`
    and the oracle."""
    rng = random.Random(124)
    a, b = (bytes(rng.randrange(256) for _ in range(32)) for _ in range(2))
    sa = api.X25519SecretKey(a, "cpu")
    pa = sa.public_key()
    pb = api.X25519PublicKey(_raw(X25519PrivateKey.from_private_bytes(b).public_key()))
    assert pa.bytes == _raw(X25519PrivateKey.from_private_bytes(a).public_key())
    shared = sa.exchange(pb)
    assert shared.was_contributory() and shared == api.X25519SharedSecret(
        X25519PrivateKey.from_private_bytes(b).exchange(
            X25519PrivateKey.from_private_bytes(a).public_key()))
    assert not sa.exchange(api.X25519PublicKey(bytes(32))).was_contributory()
    c, d = (bytes(rng.randrange(256) for _ in range(56)) for _ in range(2))
    pc = api.X448SecretKey(c, "cpu").public_key()
    assert pc.bytes == _raw(X448PrivateKey.from_private_bytes(c).public_key())
    shared = api.X448SecretKey(d, "cpu").exchange(pc)
    assert shared.was_contributory() and shared.bytes == X448PrivateKey.from_private_bytes(
        d).exchange(X448PrivateKey.from_private_bytes(c).public_key())
    assert not api.X448SharedSecret(bytes(56)).was_contributory()
    kp = api.Ed25519Keypair(a, device="cpu")
    sk = api.Ed25519SecretKey(a, "cpu")
    assert kp.public == sk.public_key() == api.Ed25519PublicKey(oracle.public_key(a))
    sig = kp.sign(b"round trip")
    assert sig == sk.sign(b"round trip") == oracle.sign(a, b"round trip")
    assert kp.verify(b"round trip", sig) and not kp.verify(b"round trip!", sig)
