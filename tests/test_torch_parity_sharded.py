"""The port's sharded layer against the JAX package's on the same inputs:
the JAX entry module's example batch byte for byte, the JAX make_sharded_verify on
the conftest's 8-device CPU mesh against the port's gloo world of 4 (mask
and count), and the JAX make_sharded_msm on 4 devices against the port's
world of 4 (the affine sum: the two add in different orders, so their
projective coordinates differ). The two JAX comparisons compile the JAX
sharded graphs, 83 s and 132 s alone on the CPU, and are marked slow (run
them with ``-m slow``): with them the new tier-1 tests of the sharded
layer would take more than their 120 s."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import __graft_entry__ as ge
from eccoxide_tpu.curves import sec2 as jsec2
from eccoxide_tpu.parallel.batch_verify import make_sharded_verify, shard_batch
from eccoxide_tpu.parallel.msm import make_sharded_msm
from eccoxide_tpu_torch import entry
from eccoxide_tpu_torch.parallel import world
from test_torch_sharded import _p192k1_case, tampered_batch

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def test_example_batch_is_the_jax_entrys():
    ours, theirs = entry.example_verify_batch(16), ge._example_verify_batch(16)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


@pytest.mark.slow
def test_sharded_verify_matches_jax():
    pk, r, s, kw = tampered_batch()
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    ok, count = make_sharded_verify(mesh)(*(shard_batch(mesh, jnp.asarray(a)) for a in (pk, r, s, kw)))
    report = world.spawn(entry.sharded_verify_rank, 4, "cpu", pk, r, s, kw)
    assert np.asarray(ok).tolist() == report["ok"]
    assert report["counts"] == [int(count)] * 4 == [15] * 4


@pytest.mark.slow
def test_sharded_msm_matches_jax():
    _, o, _, aff, ks, nb = _p192k1_case()
    spec = jsec2.get_curve("p192k1")
    f = spec.field
    pts = spec.from_affine(f.encode_ints([a[0] for a in aff]), f.encode_ints([a[1] for a in aff]))
    sc = np.array([list(k.to_bytes(nb, "little")) for k in ks], dtype=np.int32).T
    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    sharding = NamedSharding(mesh, P(None, "dp"))
    out = make_sharded_msm(spec, mesh, c=4, axis="dp")(
        jax.tree.map(lambda a: jax.device_put(a, sharding), pts), jax.device_put(jnp.asarray(sc), sharding))
    ax, ay = spec.to_affine(out)
    report = world.spawn(entry.sharded_msm_rank, 4, "cpu", "p192k1",
                         [a[0] for a in aff], [a[1] for a in aff], ks, 4)
    assert tuple(report["affine"]) == (f.decode_ints(ax)[0], f.decode_ints(ay)[0])
