"""The port's verifiers against the JAX package's own verify_host and
verify_batch_host on the same batch (test_torch_ed25519.py's), with the
same numpy generator for z. The JAX graphs take about a minute (Straus)
and nearly four minutes (RLC, under -m slow) to compile on the CPU, so
they sit in a file of few tests: pytest-xdist's --dist loadfile hands out
the files with the most tests first, and this one runs beside the slow
JAX test_msm.py instead of ahead of it."""

import numpy as np
import pytest

from eccoxide_tpu_torch.protocol import ed25519 as tpe
from eccoxide_tpu_torch.protocol import ed25519_batch as tpb
from test_torch_ed25519 import batch  # noqa: F401  (the fixture)


@pytest.fixture(scope="module")
def jax_verify_host(batch):  # noqa: F811
    """The JAX package's verify_host on the same batch, computed once."""
    from eccoxide_tpu.protocol import ed25519 as jpe

    pks, msgs, sigs, _ = batch
    return jpe.verify_host(pks, msgs, sigs)


def test_verify_host_identical_to_jax(batch, jax_verify_host):  # noqa: F811
    pks, msgs, sigs, expected = batch
    assert tpe.verify_host(pks, msgs, sigs, device="cpu") == jax_verify_host
    assert jax_verify_host == expected


@pytest.mark.slow
def test_verify_batch_host_identical_to_jax(batch):  # noqa: F811
    from eccoxide_tpu.protocol import ed25519_batch as jpb

    pks, msgs, sigs, _ = batch
    want = jpb.verify_batch_host(pks, msgs, sigs, rng=np.random.default_rng(5))
    got = tpb.verify_batch_host(pks, msgs, sigs, rng=np.random.default_rng(5),
                                device="cpu")
    assert got == want
