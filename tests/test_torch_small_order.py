"""Edwards25519 encodings and keys with a small-order part, on the CPU,
without the JAX package's graphs.

- Negative zero: x = 0 with the sign bit set (y = 1, the identity, and y =
  p - 1, the point of order 2) is rejected by RFC 8032 5.1.3 step 4, by
  the JAX package's device decompress (curves/edwards.py:361-365), and by
  the port's oracle, device decompress and both verifiers alike. The JAX
  mask is held against the oracle's in test_torch_group.py.
- The RLC batch verifier's pitfall, which the port keeps because the
  reference has it: a key A' = [a]B + T with T of order 8, signed as for
  [a]B, fails the per-signature equation, but the batch equation
  accepts it whenever 8 divides z k mod l, about one z in eight.

(Two tests: see test_torch_sign.py for why the port's files stay small.)"""

import numpy as np
import torch

from eccoxide_tpu_torch import oracle
from eccoxide_tpu_torch.curves import curve25519 as tc
from eccoxide_tpu_torch.protocol import ed25519 as tpe
from eccoxide_tpu_torch.protocol import ed25519_batch as tpb

P, L = tc.P, tc.L
IDENTITY = (1).to_bytes(32, "little")
ORDER2 = (P - 1).to_bytes(32, "little")
SIGN = 1 << 255
# y = 1 and y = p - 1, each without and with the sign bit
ENCODINGS = [IDENTITY, (1 | SIGN).to_bytes(32, "little"),
             ORDER2, (P - 1 | SIGN).to_bytes(32, "little")]


def test_negative_zero_is_rejected_everywhere():
    want = [True, False, True, False]
    assert [oracle._decompress(e) is not None for e in ENCODINGS] == want
    pts, ok = tc.EDWARDS.decompress(tpe.cols(ENCODINGS, 32, "cpu"))
    assert ok.tolist() == want
    assert bool(tc.EDWARDS.eq(type(pts)(pts.coords[..., :1]), tc.EDWARDS.identity((1,), "cpu")).all())
    # (A = -0, R = identity, S = 0) and (A = identity, R = -0, S = 0) are
    # refused; with both encodings plain, [0]B = R + [k]A holds and all accept
    msg = b"negative zero"
    zero_s = bytes(32)
    pks = [ENCODINGS[1], IDENTITY, IDENTITY]
    sigs = [IDENTITY + zero_s, ENCODINGS[1] + zero_s, IDENTITY + zero_s]
    want_v = [False, False, True]
    tables = tpe.VerifyTables("cpu")
    assert [oracle.verify(pk, msg, s) for pk, s in zip(pks, sigs)] == want_v
    assert tpe.verify_host(pks, [msg] * 3, sigs, device="cpu", tables=tables) == want_v
    assert tpb.verify_batch_host(pks, [msg] * 3, sigs, rng=np.random.default_rng(0),
                                 device="cpu", tables=tables) == want_v


def _torsion_point():
    """A point of order 8 of edwards25519: [l]Q of a decodable Q."""
    y = 2
    while True:
        q = oracle._decompress(y.to_bytes(32, "little"))
        if q is not None:
            t = oracle._mul(L, q)
            if oracle._mul(4, t) != (0, 1):
                return t
        y += 1


def test_rlc_accepts_a_torsioned_key_when_8_divides_zk():
    """A' = [a]B + T (T of order 8), R = [r]B, S = r + k a mod l with k =
    H(R || A' || M) mod l odd: [S]B - R - [k]A' = -[k]T is not the
    identity, so verify_host and the oracle refuse it. At B = 1 the batch
    equation leaves -[z k mod l]T, the identity exactly when 8 divides z k
    mod l. For 16 fixed seeds the port's batch equation (rlc_verify_core
    on z from sample_z under the seed) is that test, and verify_batch_host
    under the first seed of each answer gives it: it accepts what the
    equation accepts. (verify_batch_host on all 16 seeds would add the
    Straus fallback to every rejection: 37 s alone on a CPU, against 26.)"""
    a, r = 0x1234567 * 8 + (1 << 254), 0xC0FFEE
    T = _torsion_point()
    A = oracle._compress(oracle._add(oracle._mul(a, oracle.G), T))
    R = oracle._compress(oracle._mul(r, oracle.G))
    n = 0
    while True:
        msg = b"torsion %d" % n
        k = oracle._h(R + A + msg) % L
        if k % 2:
            break
        n += 1
    sig = R + ((r + k * a) % L).to_bytes(32, "little")
    tables = tpe.VerifyTables("cpu")
    assert not oracle.verify(A, msg, sig)
    assert tpe.verify_host([A], [msg], [sig], device="cpu", tables=tables) == [False]
    cols = tpe.host_inputs([A], [msg], [sig], "cpu")
    accepted = []
    for seed in range(16):
        z = tpb.sample_z(1, np.random.default_rng(seed))
        want = int.from_bytes(z.astype(np.uint8).tobytes(), "little") * k % L % 8 == 0
        assert bool(tpb.rlc_verify_core(*cols, torch.from_numpy(z), tables, msm_c=4)) == want, seed
        accepted.append(want)
    # both answers occur among the seeds: some z hide T and some do not
    assert 0 < sum(accepted) < 16
    for seed in (accepted.index(True), accepted.index(False)):
        assert tpb.verify_batch_host([A], [msg], [sig], rng=np.random.default_rng(seed),
                                     device="cpu", tables=tables) == [accepted[seed]], seed
