"""The port's msm_multi_prefix against the JAX package's (ops=None) on the
same points and scalars (test_torch_msm.py's case). The JAX graph takes
about a minute to compile on the CPU, so it sits in a file of few tests:
pytest-xdist's --dist loadfile hands out the files with the most tests
first, and this one runs beside the slow JAX test_msm.py instead of ahead
of it."""

import jax
import numpy as np
import torch

from eccoxide_tpu.curves import curve25519 as jc
from eccoxide_tpu.curves.edwards import ExtPoint as JExt
from eccoxide_tpu.parallel import msm as jmsm
from eccoxide_tpu_torch.curves import curve25519 as tc
from eccoxide_tpu_torch.curves.edwards import ExtPoint
from eccoxide_tpu_torch.field import WIDTHS
from eccoxide_tpu_torch.limbs import ints_to_limbs, limbs_to_ints
from eccoxide_tpu_torch.parallel import msm as tmsm
from test_torch_msm import _affine_ints, _case


def test_msm_multi_prefix_matches_jax():
    """B=5 (not a power of two: identity padding to 8)."""
    coords, by1, by2, exp = _case(5, seed=11)
    cols = [ints_to_limbs([c[i] for c in coords], WIDTHS) for i in range(4)]
    pts = ExtPoint(torch.from_numpy(np.stack(cols)))
    out = tmsm.msm_multi_prefix(
        tc.EDWARDS, [(pts, torch.from_numpy(by1)), (pts, torch.from_numpy(by2))], c=4)
    jpts = JExt(*(jc.FQ.encode_ints([c[i] for c in coords]) for i in range(4)))
    jout = jax.jit(lambda p, a, b: jmsm.msm_multi_prefix(
        jc.EDWARDS, [(p, a), (p, b)], c=4, ops=None))(jpts, by1, by2)
    jX, jY, jZ = (jc.FQ.decode_ints(c)[0] for c in (jout.x, jout.y, jout.z))
    X, Y, Z = (limbs_to_ints(c, WIDTHS)[0] for c in out.xyzt.unbind(0)[:3])
    assert _affine_ints(X, Y, Z) == _affine_ints(jX, jY, jZ) == exp

