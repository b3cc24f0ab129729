"""The port's msm_local against the JAX package's on the same points and
scalars (test_torch_msm_local.py's cases), compared in affine coordinates:
the two sum in different orders, so their projective coordinates differ.
The JAX msm_local graph takes minutes to compile on the CPU, so the file is
marked slow (run it with ``-m slow``)."""

import jax
import numpy as np
import pytest
import torch

from eccoxide_tpu.curves import curve25519 as jc
from eccoxide_tpu.curves import sec2 as jsec2
from eccoxide_tpu.curves.edwards import ExtPoint as JExt
from eccoxide_tpu.parallel import msm as jmsm
from eccoxide_tpu_torch.parallel.msm import msm_local
from test_torch_msm_local import _affine, _case, _cols, _sum

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

pytestmark = pytest.mark.slow


@pytest.mark.parametrize("curve", ["p256r1", "edwards25519"])
def test_msm_local_matches_jax(curve):
    grp, o, pts, aff, ks, nb = _case(curve, 17, seed=len(curve))
    sc = _cols(ks, nb)
    out = msm_local(grp, pts, sc, c=4)
    if curve == "edwards25519":
        jgrp, f = jc.EDWARDS, jc.FQ
        jpts = JExt(*(f.encode_ints(v) for v in ([a[0] for a in aff], [a[1] for a in aff], [1] * 17,
                                                 [a[0] * a[1] % jc.P for a in aff])))
    else:
        jgrp = jsec2.get_curve(curve)
        f = jgrp.field
        jpts = jgrp.from_affine(f.encode_ints([a[0] for a in aff]), f.encode_ints([a[1] for a in aff]))
    jout = jax.jit(lambda p, s: jmsm.msm_local(jgrp, p, s, c=4))(jpts, sc.numpy())
    jx, jy = jgrp.to_affine(jout)
    want = _sum(o, aff, ks)
    assert (f.decode_ints(jx)[0], f.decode_ints(jy)[0]) == _affine(grp, out) == tuple(want)
    assert np.asarray(jx).shape[-1] == 1
