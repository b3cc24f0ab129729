"""The port's ristretto255 against the JAX package's on the same
numpy-seeded inputs, one JAX graph each: ``decompress`` (bytes equal after
``compress``, validity masks equal, the decompressed points equal through
convert.py) and ``compress`` after ``from_uniform_bytes`` (bytes equal).
The JAX graphs take tens of seconds to compile on the CPU; the root
conftest.py's scheduler sends this file out after the JAX package's slow
units."""

import jax
import numpy as np
import torch

from eccoxide_tpu.curves import ristretto255 as jrz
from eccoxide_tpu_torch import convert, oracle
from eccoxide_tpu_torch.curves import ristretto255 as rz
from eccoxide_tpu_torch.field import FQ
from kats_rfc9496 import A2_BAD

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _canon(P):
    return FQ.canon(P.xyzt.transpose(0, 1)).transpose(0, 1)


def test_decompress_matches_jax():
    """Random multiples' encodings, random bytes (mostly rejected) and the
    A.2 encodings: masks, points (valid lanes) and re-encodings equal."""
    rng = np.random.default_rng(9496)
    good = [oracle.ristretto_compress(oracle.ristretto_mul(int.from_bytes(rng.bytes(32), "little")))
            for _ in range(6)]
    ins = good + [rng.bytes(32) for _ in range(4)] + [bytes.fromhex(h) for h in A2_BAD[:4]]
    by = np.stack([np.frombuffer(b, np.uint8) for b in ins], axis=1).astype(np.int32)
    jpt, jok = jax.jit(jrz.decompress)(by)
    pt, ok = rz.decompress(torch.from_numpy(by))
    assert ok.tolist() == np.asarray(jok).tolist()
    assert ok.tolist()[:6] == [True] * 6 and not any(ok.tolist()[10:])
    valid = torch.tensor(np.asarray(jok))
    back = convert.ext_point_from_jax(jpt)                  # canonical limbs
    assert torch.equal(_canon(back)[..., valid], _canon(pt)[..., valid])
    assert torch.equal(_canon(convert.ext_point_from_jax(convert.ext_point_to_jax(pt))), _canon(pt))
    assert [bytes(c) for c in rz.compress(pt).T.tolist()][:6] == good


def test_from_uniform_bytes_matches_jax():
    rng = np.random.default_rng(4)
    by = rng.integers(0, 256, (64, 8), dtype=np.int32)
    by[:32, 0] = 0xFF                                    # the 255 bits above p
    want = jax.jit(lambda b: jrz.compress(jrz.from_uniform_bytes(b)))(by)
    got = rz.compress(rz.from_uniform_bytes(torch.from_numpy(by)))
    assert np.array_equal(got.numpy(), np.asarray(want))
