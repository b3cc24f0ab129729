"""The ninth slice of the port against the JAX package on the same inputs:
the JAX msm_local_prefix graph on p192k1 (B = 11, c = 5, the inputs of
tests/test_msm.py:99-105) against the port's (the same group element: the
affine sum), and the port's entry arguments against the bytes of the JAX
entry's example batch (no JAX graph). The JAX msm_local_prefix graph
compiles for 113 s alone on the CPU, so its comparison is marked slow (run
it with ``-m slow``). The JAX decompress mask on the negative-zero
encodings is held against the port's oracle and device decompress in
test_torch_group.py, which compiles that graph already."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import __graft_entry__ as ge
from eccoxide_tpu.curves import sec2 as jsec2
from eccoxide_tpu.parallel.msm import msm_local_prefix as jax_msm_local_prefix
from eccoxide_tpu_torch import entry
from eccoxide_tpu_torch.parallel.msm import msm_local_prefix
from test_torch_msm_prefix import _affine, _cols, _jax_setup_p192k1


@pytest.mark.slow
def test_msm_local_prefix_matches_jax():
    grp, o, pts, aff, ks, nb = _jax_setup_p192k1(11, seed=8)
    spec = jsec2.get_curve("p192k1")
    f = spec.field
    jpts = spec.from_affine(f.encode_ints([a[0] for a in aff]), f.encode_ints([a[1] for a in aff]))
    sc = _cols(ks, nb)
    out = jax.jit(lambda p, s: jax_msm_local_prefix(spec, p, s, c=5))(jpts, jnp.asarray(sc.numpy()))
    ax, ay = spec.to_affine(out)
    assert (f.decode_ints(ax)[0], f.decode_ints(ay)[0]) == _affine(grp, msm_local_prefix(grp, pts, sc, c=5))


def test_entry_arguments_are_the_jax_entrys():
    _, args = entry.entry(device="cpu")
    for a, b in zip(args[:4], ge._example_verify_batch(8)):
        assert np.array_equal(a.numpy(), b)
