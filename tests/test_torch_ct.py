"""Constant time of the port's secret-dependent cores, on the CPU: each core
runs twice, with two different secrets, under a TorchDispatchMode that
records every aten op with the shapes and non-tensor values of its
arguments. The two records must be identical, and every index tensor that
an indexing op is given (aten.index, gather, index_select, take,
embedding, and the index_add/index_put/scatter family) must hold the same
values in both runs: no secret picks an address, a shape or an op. No op
reads a tensor's value back to the host (aten._local_scalar_dense).
(Three tests: see test_torch_sign.py for why.)"""

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from eccoxide_tpu_torch.curves import sec2
from eccoxide_tpu_torch.limbs import windows_from_bytes_le
from eccoxide_tpu_torch.protocol import ed25519 as tpe
from eccoxide_tpu_torch.protocol import x448 as tx448
from eccoxide_tpu_torch.protocol import x25519 as tx25519

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

aten = torch.ops.aten
INDEXING = {aten.index, aten.gather, aten.index_select, aten.take, aten.embedding,
            aten.index_add, aten.index_add_, aten.index_put, aten.index_put_,
            aten.scatter, aten.scatter_, aten.scatter_add, aten.scatter_add_}


class _Record(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops, self.indices = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((func, tuple(_sig(a) for a in args),
                         tuple((k, _sig(v)) for k, v in kwargs.items())))
        if func.overloadpacket in INDEXING:
            bound = dict(zip((a.name for a in func._schema.arguments), args), **kwargs)
            idx = bound.get("index", bound.get("indices"))
            self.indices.append([t.clone() for t in torch.utils._pytree.tree_leaves(idx)
                                 if isinstance(t, torch.Tensor)])
        return func(*args, **kwargs)


def _sig(a):
    """A tensor's shape and dtype; a list's items' signatures; any other
    argument as it is."""
    if isinstance(a, torch.Tensor):
        return a.shape, a.dtype
    if isinstance(a, (list, tuple)):
        return tuple(_sig(x) for x in a)
    return a


def _trace(fn):
    with _Record() as rec:
        fn()
    return rec


def _bytes(rng, n, B=2):
    return torch.from_numpy(rng.integers(0, 256, size=(n, B), dtype=np.int32))


def _warm_caches():
    """Build the per-device constants that the fields cache on first use,
    so that both recorded runs find them built."""
    tx25519.x25519_base(_bytes(np.random.default_rng(0), 32, 1)[:, :0])
    tx448.x448_base(_bytes(np.random.default_rng(0), 56, 1)[:, :0])
    tpe.sign_core(*(_bytes(np.random.default_rng(0), n, 0) for n in (32, 64, 64)))


def _assert_same_trace(run):
    """run(seed) calls the cores on secrets drawn from seed."""
    _warm_caches()
    a, b = _trace(lambda: run(1)), _trace(lambda: run(2))
    assert len(a.ops) > 1000
    assert aten._local_scalar_dense.default not in {op[0] for op in a.ops}
    assert a.ops == b.ops
    assert len(a.indices) == len(b.indices)
    for ia, ib in zip(a.indices, b.indices):
        assert len(ia) == len(ib) and all(torch.equal(x, y) for x, y in zip(ia, ib))


def test_sign_cores_trace_is_independent_of_the_secret():
    tables = tpe.SignTables("cpu")

    def run(seed):
        rng = np.random.default_rng(seed)
        a = torch.from_numpy(tpe.clamp_scalar_bytes(_bytes(rng, 32).numpy()))
        r_wide, k_wide = _bytes(rng, 64), _bytes(rng, 64)
        tpe.public_key_core(a, tables)
        tpe.r_point_core(r_wide, tables)
        tpe.sign_core(a, r_wide, k_wide)

    _assert_same_trace(run)


def test_scalar_mul_trace_is_independent_of_the_secret():
    """Both the scalar and the point differ between the runs: edwards25519's
    CT scalar_mul, and a P-256 key generation (comb, compress) and ECDH
    (decompress of the peer's key, CT scalar_mul, to_affine, bytes)."""
    tables = tpe.SignTables("cpu")
    points = {seed: tpe.scalar_mul_base(_bytes(np.random.default_rng(seed), 32), tables)
              for seed in (1, 2)}
    p256 = sec2.get_curve("p256r1")
    peers = {seed: p256.compress(p256.mul_base(_bytes(np.random.default_rng(seed + 20), 32)))
             for seed in (1, 2)}

    def run(seed):
        k = _bytes(np.random.default_rng(seed + 10), 32)
        tpe.scalar_mul(points[seed], k)
        p256.compress(p256.mul_base(k))
        Q, _ = p256.decompress(peers[seed])
        sx, _ = p256.to_affine(p256.scalar_mul(Q, windows_from_bytes_le(k, 64)))
        p256.field.to_bytes_be(sx)

    _assert_same_trace(run)


def test_ladders_trace_is_independent_of_the_secret():
    def run(seed):
        rng = np.random.default_rng(seed)
        tx25519.x25519(_bytes(rng, 32), _bytes(rng, 32))
        tx448.x448(_bytes(rng, 56), _bytes(rng, 56))

    _assert_same_trace(run)
