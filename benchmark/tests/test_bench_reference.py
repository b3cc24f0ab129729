"""The benchmark's plain reference against the RFC vectors, typed in here:
RFC 8032 7.1 TESTs 1-3 (Ed25519), RFC 7748 5.2 (both X25519 vectors and
one iteration of the base-point recurrence) and 6.1 (the Diffie-Hellman
exchange); and the refusals the verdicts rest on. CPU only.

    python -m pytest benchmark/tests -q
"""

import hashlib

import pytest

from benchmark.reference import ed25519 as ed
from benchmark.reference import x25519 as x

h = bytes.fromhex

RFC8032 = [
    (h("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60"),
     h("d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a"),
     b"",
     h("e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555f"
       "b8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b")),
    (h("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb"),
     h("3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c"),
     h("72"),
     h("92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
       "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00")),
    (h("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7"),
     h("fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025"),
     h("af82"),
     h("6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
       "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a")),
]

RFC7748 = [
    (h("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4"),
     h("e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c"),
     h("c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552")),
    (h("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d"),
     h("e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493"),
     h("95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957")),
    (h("0900000000000000000000000000000000000000000000000000000000000000"),
     h("0900000000000000000000000000000000000000000000000000000000000000"),
     h("422c8e7a6227d7bca1350b3e2bb7279f7897b87bb6854b783c60e80311ae3079")),
]

ALICE = (h("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a"),
         h("8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"))
BOB = (h("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb"),
       h("de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"))
SHARED = h("4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742")


@pytest.mark.parametrize("sk, pk, msg, sig", RFC8032)
def test_ed25519_rfc8032(sk, pk, msg, sig):
    assert ed.public_key(sk) == pk
    assert ed.sign(sk, msg) == sig
    assert ed.verify(pk, msg, sig)
    assert not ed.verify(pk, msg + b"!", sig)
    assert not ed.verify(pk, msg, sig[:32] + bytes([sig[32] ^ 1]) + sig[33:])


def test_ed25519_refusals():
    """What the verdicts of the planted lanes rest on: S >= l, a key with
    y >= p and negative zero (x = 0 with the sign bit, RFC 8032 5.1.3 step
    4) are refused; S + l passes only the verifier that drops the S < l
    rule; the identity's equation without the sign bit holds."""
    sk, pk, msg, sig = RFC8032[1]
    s_plus_l = sig[:32] + (int.from_bytes(sig[32:], "little") + ed.L).to_bytes(32, "little")
    assert not ed.verify(pk, msg, s_plus_l)
    assert ed.verify(pk, msg, s_plus_l, check_s=False)
    assert not ed.verify((ed.P + 1).to_bytes(32, "little"), msg, sig)
    identity, neg_zero = (1).to_bytes(32, "little"), (1 | 1 << 255).to_bytes(32, "little")
    assert ed.verify(identity, msg, identity + bytes(32))
    assert not ed.verify(neg_zero, msg, identity + bytes(32))
    assert not ed.verify(identity, msg, neg_zero + bytes(32))
    assert ed.decompress(neg_zero) is None and ed.decompress(identity) is not None


def test_ed25519_arithmetic():
    """The comb and the windowed ladder agree, and [l]B is the identity."""
    k = int.from_bytes(hashlib.sha512(b"k").digest(), "little") % ed.L
    assert ed.equal(ed.mul_base(k), ed.mul(k, ed.BASE))
    assert ed.equal(ed.mul(ed.L, ed.BASE), ed.IDENTITY)
    assert ed.equal(ed.add(ed.mul_base(k), ed.neg(ed.mul_base(k))), ed.IDENTITY)


@pytest.mark.parametrize("scalar, u, out", RFC7748)
def test_x25519_rfc7748(scalar, u, out):
    assert x.x25519(scalar, u) == out


def test_x25519_exchange_and_guarantees():
    """RFC 7748 6.1, the low-order u's giving the all-zero secret, and the
    top bit of u: masked it changes nothing, kept (the control) it does."""
    assert x.public_key(ALICE[0]) == ALICE[1] and x.public_key(BOB[0]) == BOB[1]
    assert x.x25519(ALICE[0], BOB[1]) == x.x25519(BOB[0], ALICE[1]) == SHARED
    for u in x.LOW_ORDER_U:
        assert x.x25519(ALICE[0], u.to_bytes(32, "little")) == bytes(32)
    top = BOB[1][:31] + bytes([BOB[1][31] | 0x80])
    assert x.x25519(ALICE[0], top) == SHARED
    assert x.x25519(ALICE[0], top, mask=False) != SHARED
