"""Rules of the port: it stands alone from the JAX package, it runs on the
card unless the caller asks for the CPU, and its kernels never fall back."""

import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

from eccoxide_tpu_torch.entry import dryrun_multichip
from eccoxide_tpu_torch.field448 import FQ448
from eccoxide_tpu_torch.ops import build, group
from eccoxide_tpu_torch.parallel.batch_verify import make_sharded_verify
from eccoxide_tpu_torch.protocol import api
from eccoxide_tpu_torch.protocol import ed25519 as tpe
from eccoxide_tpu_torch.protocol import ed25519_batch as tpb
from eccoxide_tpu_torch.protocol import x448 as tx448
from eccoxide_tpu_torch.protocol import x25519 as tx25519

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "eccoxide_tpu_torch"
SOURCES = sorted(p for ext in ("*.py", "*.cu", "*.cuh") for p in PKG.rglob(ext))


def test_no_file_of_the_port_names_jax_or_the_jax_package():
    assert len(SOURCES) > 15
    bad = re.compile(r"\bjax\b|eccoxide_tpu(?!_torch)")
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in SOURCES
            for i, line in enumerate(p.read_text().splitlines(), 1) if bad.search(line)]
    assert hits == []


def test_chip_smoke_imports_nothing_of_the_jax_package():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in ("jax", "eccoxide_tpu")]


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import eccoxide_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'eccoxide_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) > 15, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'eccoxide_tpu' or m.startswith('eccoxide_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    pk, sig = bytes(32), bytes(64)
    calls = [
        lambda: tpe.verify_host([pk], [b""], [sig]),
        lambda: tpb.verify_batch_host([pk], [b""], [sig]),
        tpe.VerifyTables, tpe.SignTables,
        lambda: tpe.public_keys_host([pk]),
        lambda: tpe.sign_host([pk], [b""]),
        lambda: tx25519.x25519_host(pk, pk), lambda: tx25519.x25519_base_host(pk),
        lambda: tx448.x448_host(bytes(56), bytes(56)), lambda: tx448.x448_base_host(bytes(56)),
        lambda: api.X25519SecretKey(pk).public_key(),
        lambda: api.X448SecretKey(bytes(56)).public_key(),
        lambda: api.Ed25519SecretKey(pk).sign(b""),
        lambda: api.Ed25519Keypair(pk),
        lambda: make_sharded_verify(), lambda: dryrun_multichip(1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError):
            call()


def test_cpu_tensors_never_launch():
    group.reset_launches()
    p = tpe.ED.identity((3,), "cpu").xyzt
    group.ed_add(p, p)
    group.ed_add(p, p, need_t=False)
    group.ed_add_mixed(p, p[[0, 1, 3]])
    group.ed_double(p)
    group.pow_const_kernel(p[1], 2**255 - 21)
    group.pow448_kernel(FQ448.one((3,), "cpu"), FQ448.p - 2)
    tpe.verify_host([bytes(32)], [b""], [bytes(64)], device="cpu")
    assert group.launches() == {"pow_const_kernel": 0, "ed_add": 0, "ed_double": 0,
                                "pow448_kernel": 0, "pow_sec2_kernel": 0}
    assert group.ed_add.launches_by_mode == {"full": 0, "need_t=False": 0, "mixed": 0}


def test_no_kernel_for_other_devices_and_no_build_without_nvcc():
    p = torch.zeros((4, 10, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        group.ed_add(p, p)
    with pytest.raises(ValueError):
        group.ed_add(p.to(torch.int64), p.to(torch.int64))
    with pytest.raises(ValueError):
        group.pow448_kernel(p[0, :, :].repeat(2, 1)[:16], 5)
    if shutil.which("nvcc") or torch.cuda.is_available():
        pytest.skip("nvcc is present: the build can run here")
    for name in build.KERNEL_SOURCES:
        with pytest.raises(build.BuildError):
            build.kernels(name)


def test_add_mixed_checks_its_operands():
    """ed_add_mixed takes an int32 (3, 10, *batch) q of p's batch, on p's
    device, and raises on anything else before any launch. (The test count
    of this file does not move the JAX package's slow units: the root
    conftest.py sends those out first.)"""
    group.reset_launches()
    p = tpe.ED.identity((3,), "cpu").xyzt
    for q in (p, p[[0, 1, 3], :, :2], p[[0, 1, 3]].to(torch.int64), p[[0, 1, 3]].to("meta")):
        with pytest.raises(ValueError):
            group.ed_add_mixed(p, q)
    assert group.launches()["ed_add"] == 0
